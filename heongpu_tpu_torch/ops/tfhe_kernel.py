"""The TFHE blind rotation: the whole CMux chain of a batch of gate
bootstraps (port of heongpu_tpu/ops/tfhe_kernel.py::blind_rotate and
blind_rotate2).

Both wrappers take the prologue's NTT-domain accumulator (B, 2, 2, N) and the
mod-switched rotation amounts a_t (B, n), and return the final NTT-domain
accumulator.  For CUDA tensors they launch the hand-written kernels of
kernels/csrc/tfhe.cu (K3 `blind_rotate`, K4 `blind_rotate2`); for CPU tensors
they run the plain chains of models/tfhe.py (`blind_rotate_plain`,
`blind_rotate2_plain`).  Both are exact mod p, so they agree bit for bit.

The TPU kernel's lane layouts (prep_acc, prep_a, prep_bk, prep_bk2,
prep_tables, the key broadcast over a batch tile) are not ported: the CUDA
kernels read the natural layouts.
"""

from __future__ import annotations

import torch

from . import modmath as mm


def _check(acc, a_t, key, ctx, unrolled: bool):
    """Shapes, dtypes, contiguity, device and parameters the chain takes."""
    N = ctx.N
    B, n = a_t.shape if a_t.ndim == 2 else (-1, -1)
    want_key = ((n // 2, 3) if unrolled else (n,)) + (2 * ctx.l, ctx.k + 1, 2, N)
    if acc.shape != (B, 2, 2, N) or tuple(key.shape) != want_key:
        raise ValueError(f"expected acc (B, 2, 2, {N}), a_t (B, n) and key {want_key}; got "
                         f"{tuple(acc.shape)}, {tuple(a_t.shape)}, {tuple(key.shape)}")
    if n % 8 != 0:
        raise ValueError(f"the chain renormalises every 8 key bits: n={n} is not a multiple of 8")
    for x in (acc, a_t, key):
        if x.dtype != mm.I32 or not x.is_contiguous():
            raise ValueError("the blind rotation takes contiguous int32 tensors")
        if x.device != ctx.device:
            raise ValueError(f"tensor on {x.device}, context on {ctx.device}")
    if ((N, ctx.k, ctx.l, ctx.bg_bit) != (1024, 1, 2, 10)
            or not all(1 << 29 < p < 1 << 30 for p in ctx.primes)):
        raise ValueError("the blind rotation takes the STD128 shape (N=1024, k=1, l=2, "
                         "bg_bit=10) over primes in (2**29, 2**30)")


def launch_args(acc, out, a_t, key, ctx, unrolled: bool):
    """The arguments of the C entry point hf_blind_rotate but the stream."""
    tb = ctx.ntt
    tabs = (tb.p, tb.pinv, tb.r1, ctx.omega_pows, ctx.omega_exps,
            tb.tw1p, tb.tw1p_sh, tb.tw2p, tb.tw2p_sh, tb.itw1p, tb.itw1p_sh,
            tb.itw2p, tb.itw2p_sh, tb.tw_mat, tb.tw_mat_sh, tb.itw_mat, tb.itw_mat_sh)
    inv_sh = (ctx.p1_inv_p2 << 32) // ctx.primes[1]
    return (int(unrolled), acc.data_ptr(), out.data_ptr(), a_t.data_ptr(), key.data_ptr(),
            acc.shape[0], a_t.shape[1], *(t.data_ptr() for t in tabs), ctx.p1_inv_p2, inv_sh)


def blind_rotate_cuda(acc, a_t, key, ctx, unrolled: bool = False):
    """Launch K3 (unrolled=False, key = BootKey.bk) or K4 (unrolled=True,
    key = BootKey2.bk2): one block per gate runs the whole chain."""
    from .. import kernels
    _check(acc, a_t, key, ctx, unrolled)
    if not acc.is_cuda:
        raise ValueError("blind_rotate_cuda takes CUDA tensors")
    if key.data_ptr() % 16:
        raise ValueError("the kernel copies the key in 16-byte pieces: it must be 16-byte aligned")
    out = torch.empty_like(acc)
    err = kernels.library().hf_blind_rotate(*launch_args(acc, out, a_t, key, ctx, unrolled),
                                            kernels.stream_of(acc))
    kernels.check(err, "blind_rotate")
    kernels.launches["blind_rotate2" if unrolled else "blind_rotate"] += 1
    return out


def _dispatch(acc, a_t, key, ctx, unrolled: bool):
    if acc.is_cuda:
        return blind_rotate_cuda(acc, a_t, key, ctx, unrolled)
    if acc.device.type != "cpu":
        raise ValueError(f"no blind rotation for tensors on {acc.device}")
    _check(acc, a_t, key, ctx, unrolled)
    from ..models import tfhe
    plain = tfhe.blind_rotate2_plain if unrolled else tfhe.blind_rotate_plain
    return plain(acc, a_t, key, ctx)


def blind_rotate(acc, a_t, bk, ctx):
    """The n-step CMux chain over BootKey.bk (n, 4, 2, 2, N)."""
    return _dispatch(acc, a_t, bk, ctx, unrolled=False)


def blind_rotate2(acc, a_t, bk2, ctx):
    """The key-unrolled chain: n/2 pair steps over BootKey2.bk2
    (n/2, 3, 4, 2, 2, N)."""
    return _dispatch(acc, a_t, bk2, ctx, unrolled=True)
