"""The fused Method-II keyswitch core (port of
heongpu_tpu/ops/keyswitch_pallas.py, whose Pallas kernel runs it on the TPU).

For each output limb l of the level's Q·P basis (kqp limbs):

    out[c, l] = INTT_l( Σ_j NTT_l( Σ_t z[g_j,t] · mat[j·α+t, l] · R^-1 ) · k_c[j, l] · R^-1 )

with every sum exact and reduced once, c ∈ {0, 1}: the FastBconv digit
build, the forward transform, the MAC against both key halves and the inverse
transform, in one call.  The scaled digits z, the ÷P stages and the output
transform stay outside the core, as in the reference.

`keyswitch2_fused_core` launches K5, the hand-written CUDA kernel
(kernels/csrc/keyswitch.cu), for CUDA tensors and runs the plain torch
composition `keyswitch2_fused_core_plain` for CPU tensors.  Both are exact,
so they agree bit for bit with each other and with the staged path.
"""

from __future__ import annotations

import torch

from . import modmath as mm
from . import ntt as nttm
from . import rns


def build_fused_mat(ks2, kqp: int):
    """(d̃ · alpha_max, kqp) int32: mat[j·alpha_max + t, l] =
    |D_j/q_{g_t}|_{p_l} · 2^32 mod p_l, zero rows for a short last group."""
    alpha_max = max(len(g) for g in ks2.groups)
    rows = []
    for conv in ks2.convs:
        m = conv.mat_mont
        pad = alpha_max - m.shape[0]
        if pad:
            m = torch.cat([m, m.new_zeros((pad, kqp))])
        rows.append(m)
    return torch.cat(rows)


def keyswitch2_fused_core_plain(z, mat, k0, k1, tb: nttm.NttTables, groups):
    """Plain torch: digits by lazy_mac_mont, ntt_fwd_plain, the key MAC,
    ntt_inv_plain.  z (ka, N) scaled digits, mat from build_fused_mat, k0/k1
    (d̃, kqp, N) NTT + Montgomery -> (2, kqp, N) coefficient domain."""
    base = rns.Base.build(tb.primes, tb.device)
    alpha = mat.shape[0] // len(groups)
    digits = torch.stack([
        rns.lazy_mac_mont(z[g[0]: g[-1] + 1, None, :],
                          mat[j * alpha: j * alpha + len(g), :, None], base)
        for j, g in enumerate(groups)])
    d_ntt = nttm.ntt_fwd_plain(digits, tb)
    acc = torch.stack([rns.lazy_mac_mont(d_ntt, k0, base), rns.lazy_mac_mont(d_ntt, k1, base)])
    return nttm.ntt_inv_plain(acc, tb)


_TABLES = ("p", "pinv", "mu", "tw_mat", "tw_mat_sh", "itw_mat", "itw_mat_sh",
           "tw1p", "tw1p_sh", "tw2p", "tw2p_sh", "itw1p", "itw1p_sh", "itw2p", "itw2p_sh")


def keyswitch2_fused_cuda(z, mat, k0, k1, tb: nttm.NttTables, groups):
    """Launch K5 (kernels/csrc/keyswitch.cu) on the same arguments as
    keyswitch2_fused_core_plain.  Raises on what the kernel does not take,
    non-contiguous key slices included (the caller makes them contiguous)."""
    from .. import kernels
    tabs = [getattr(tb, name) for name in _TABLES]
    for t in (z, mat, k0, k1, *tabs):
        if not t.is_cuda or t.dtype != mm.I32 or not t.is_contiguous():
            raise ValueError("keyswitch2_fused_cuda takes contiguous int32 CUDA tensors")
    ka, n = z.shape
    kqp, d = tb.num_limbs, len(groups)
    alpha = mat.shape[0] // d
    if (n != tb.n or mat.shape != (d * alpha, kqp) or k0.shape != (d, kqp, n)
            or k1.shape != k0.shape):
        raise ValueError(f"z {tuple(z.shape)}, mat {tuple(mat.shape)}, keys "
                         f"{tuple(k0.shape)}/{tuple(k1.shape)} do not fit {d} digits "
                         f"over {kqp} limbs of N={tb.n}")
    if tuple(groups) != tuple(tuple(range(j, min(j + alpha, ka))) for j in range(0, ka, alpha)):
        raise ValueError(f"groups {groups} are not consecutive runs of {alpha} of {ka} limbs")
    if not 1 <= alpha <= 16:
        raise ValueError("the exact 64-bit digit sum takes at most 16 terms")
    if max(tb.primes) >= 1 << 30 or tb.n2 > 256:
        raise ValueError("the kernel takes primes < 2**30 and N <= 2^16")
    if tb.n < 256:
        raise ValueError(f"the kernel takes N >= 2^8 (a column of n1 >= 16 points), got N={tb.n}")
    out = torch.empty((2, kqp, n), dtype=mm.I32, device=z.device)
    s1 = torch.empty((d, kqp, n), dtype=mm.I32, device=z.device)
    s2 = torch.empty_like(out)
    err = kernels.library().hf_keyswitch2_fused(
        z.data_ptr(), mat.data_ptr(), k0.data_ptr(), k1.data_ptr(), s1.data_ptr(),
        s2.data_ptr(), out.data_ptr(), ka, kqp, d, alpha, tb.n1, tb.n2,
        *(t.data_ptr() for t in tabs), kernels.stream_of(z))
    kernels.check(err, "keyswitch2_fused")
    kernels.launches["keyswitch2_fused"] += 1
    return out


def keyswitch2_fused_core(z, mat, k0, k1, tb: nttm.NttTables, groups):
    """The core on z's device: K5 for CUDA tensors, the plain version for CPU
    tensors."""
    if z.is_cuda:
        return keyswitch2_fused_cuda(z, mat, k0, k1, tb, groups)
    if z.device.type != "cpu":
        raise ValueError(f"no fused keyswitch for tensors on {z.device}")
    return keyswitch2_fused_core_plain(z, mat, k0, k1, tb, groups)


def keyswitch2_fused(poly_q, k0, k1, ks2, ntt_qp_level: nttm.NttTables,
                     base_qp_level: rns.Base, in_ntt: bool, out_ntt: bool,
                     ntt_q_level: nttm.NttTables):
    """Method-II keyswitch of one 2-D poly (ka, N) through the fused core;
    the same arguments and results as keyswitch2.keyswitch2."""
    if in_ntt:
        poly_q = nttm.ntt_inv(poly_q, ntt_q_level)
    z = torch.cat([conv.scaled_digits(poly_q[g[0]: g[-1] + 1])
                   for conv, g in zip(ks2.convs, ks2.groups)])
    mat = build_fused_mat(ks2, ntt_qp_level.num_limbs)
    acc = ks2.div_stages(keyswitch2_fused_core(z, mat, k0, k1, ntt_qp_level, ks2.groups))
    if out_ntt:
        acc = nttm.ntt_fwd(acc, ntt_q_level)   # both halves in one transform
    return acc[0], acc[1]
