"""RNS machinery: exact lazy MAC, fast base conversion, divide-round-by-last
modulus (port of heongpu_tpu/ops/rns.py).

Conversion matrices and keys are stored in Montgomery form (M·2^32 mod p),
so the MAC result is Σ d·k·2^-32 mod p = Σ d·M mod p.  `mac_keys` and
`BaseConv.convert_from_digits` launch the hand-written CUDA kernels
(kernels/csrc/mac.cu) for CUDA tensors and run the plain `lazy_mac_mont`
for CPU tensors; both are exact, so they agree bit for bit.
"""

from __future__ import annotations

import dataclasses
from functools import reduce
from typing import Sequence

import numpy as np
import torch

from . import modmath as mm


@dataclasses.dataclass(frozen=True, eq=False)
class Base:
    """Per-modulus constants for a list of RNS primes, shape (L,) each, as
    int32 tensors: p; pinv = -p^-1 mod 2^32 (a uint32 bit pattern) and
    mu = floor(2^32/p) for the kernels' REDC and Barrett steps; r1 = 2^32
    mod p and rinv = 2^-32 mod p for the plain Montgomery conversions."""
    p: torch.Tensor
    pinv: torch.Tensor
    mu: torch.Tensor
    r1: torch.Tensor
    rinv: torch.Tensor

    @staticmethod
    def build(primes: Sequence[int], device="cpu") -> "Base":
        t = lambda f: mm.u32_to_i32([f(int(q)) for q in primes]).to(device)
        return Base(p=t(int), pinv=t(mm.mont_pinv), mu=t(mm.barrett_mu),
                    r1=t(mm.mont_r1), rinv=t(mm.mont_rinv))

    def col(self, name: str = "p"):
        """A constant as an int64 (L, 1) column, broadcasting over (..., L, N)."""
        return getattr(self, name).to(mm.I64)[:, None]

    def take(self, idx) -> "Base":
        """Constants at limb positions `idx` (a slice or an index list)."""
        return Base(*(getattr(self, f.name)[idx] for f in dataclasses.fields(self)))

    def __len__(self):
        return int(self.p.shape[0])


def lazy_mac_mont(d_ntt, karr, base: Base, axis: int = -3):
    """Σ_j d_j · k_j · 2^-32 mod p along `axis`, with k in Montgomery form —
    the keyswitch hot MAC (plain version: exact per-term reduction)."""
    p = base.col()
    prod = torch.remainder(d_ntt.to(mm.I64) * karr.to(mm.I64), p)
    s = torch.remainder(prod.sum(dim=axis), p)
    return torch.remainder(s * base.col("rinv"), p).to(mm.I32)


def _check_cpu(x):
    if x.device.type != "cpu":
        raise ValueError(f"no MAC kernel for tensors on {x.device}")


def _check_cuda(*xs):
    for x in xs:
        if not x.is_cuda or x.dtype != mm.I32 or not x.is_contiguous():
            raise ValueError("the MAC kernels take contiguous int32 CUDA tensors")


def mac_keys_cuda(d_ntt, k0, k1, base: Base):
    """Launch the key-MAC kernel: (D, L, N) digits and key halves ->
    (2, L, N), each digit read once for both halves."""
    from .. import kernels
    _check_cuda(d_ntt, k0, k1, base.p)
    D, L, N = d_ntt.shape
    if k0.shape != d_ntt.shape or k1.shape != d_ntt.shape or len(base) != L:
        raise ValueError(f"digits {tuple(d_ntt.shape)}, keys {tuple(k0.shape)}/"
                         f"{tuple(k1.shape)}, {len(base)} limbs do not match")
    out = torch.empty((2, L, N), dtype=mm.I32, device=d_ntt.device)
    err = kernels.library().hf_mac_keys(
        d_ntt.data_ptr(), k0.data_ptr(), k1.data_ptr(), out.data_ptr(),
        base.p.data_ptr(), base.pinv.data_ptr(), base.mu.data_ptr(),
        D, L, N, kernels.stream_of(d_ntt))
    kernels.check(err, "mac_keys")
    kernels.launches["mac_keys"] += 1
    return out


def mac_keys(d_ntt, k0, k1, base: Base):
    """(Σ_j d_j·k0_j, Σ_j d_j·k1_j) · 2^-32 mod p as one (2, L, N) tensor."""
    if d_ntt.is_cuda:
        return mac_keys_cuda(d_ntt, k0, k1, base)
    _check_cpu(d_ntt)
    return torch.stack([lazy_mac_mont(d_ntt, k0, base),
                        lazy_mac_mont(d_ntt, k1, base)])


def base_conv_cuda(z, mat_mont, obase: Base):
    """Launch the base-conversion kernel: z (..., k_in, N), mat (k_in, k_out)
    -> (..., k_out, N)."""
    from .. import kernels
    _check_cuda(z, mat_mont, obase.p)
    k_in, k_out = mat_mont.shape
    N = z.shape[-1]
    if z.shape[-2] != k_in or len(obase) != k_out:
        raise ValueError(f"digits {tuple(z.shape)} do not match a "
                         f"{k_in}x{k_out} conversion into {len(obase)} limbs")
    B = z.numel() // (k_in * N)
    out = torch.empty(z.shape[:-2] + (k_out, N), dtype=mm.I32, device=z.device)
    err = kernels.library().hf_base_conv(
        z.data_ptr(), mat_mont.data_ptr(), out.data_ptr(), obase.p.data_ptr(),
        obase.pinv.data_ptr(), obase.mu.data_ptr(), B, k_in, k_out, N,
        kernels.stream_of(z))
    kernels.check(err, "base_conv")
    kernels.launches["base_conv"] += 1
    return out


@dataclasses.dataclass(frozen=True, eq=False)
class BaseConv:
    """Fast base conversion q -> m (Bajard FastBconv):
    x̂_m = Σ_i |x_i q̂_i^{-1}|_{q_i} · |q/q_i|_m, equal to [x]_m + α·q with
    0 ≤ α < k (callers correct α per scheme)."""
    ibase: Base
    obase: Base
    qhat_inv: torch.Tensor     # (k_in,)  |(q/q_i)^{-1}|_{q_i}
    mat_mont: torch.Tensor     # (k_in, k_out)  |q/q_i|_m * 2^32 mod m

    @staticmethod
    def build(in_primes: Sequence[int], out_primes: Sequence[int],
              device="cpu") -> "BaseConv":
        q = reduce(lambda a, b: a * b, in_primes, 1)
        qh_inv = [pow(q // qi, -1, qi) for qi in in_primes]
        mat = np.empty((len(in_primes), len(out_primes)), np.uint32)
        for i, qi in enumerate(in_primes):
            for mj, m in enumerate(out_primes):
                mat[i, mj] = ((q // qi) % m) * (1 << 32) % m
        return BaseConv(
            ibase=Base.build(in_primes, device), obase=Base.build(out_primes, device),
            qhat_inv=mm.u32_to_i32(qh_inv).to(device),
            mat_mont=mm.u32_to_i32(mat).to(device))

    def scaled_digits(self, x):
        """z_i = |x_i * (q/q_i)^{-1}|_{q_i}."""
        return mm.shoup_mul(x, self.qhat_inv.to(mm.I64)[:, None], self.ibase.col())

    def convert_from_digits(self, z):
        """z (..., k_in, N) -> x̂ (..., k_out, N) in the out base."""
        if z.is_cuda:
            return base_conv_cuda(z, self.mat_mont, self.obase)
        _check_cpu(z)
        return lazy_mac_mont(z[..., :, None, :], self.mat_mont[:, :, None],
                             self.obase, axis=-3)

    def __call__(self, x):
        return self.convert_from_digits(self.scaled_digits(x))


@dataclasses.dataclass(frozen=True, eq=False)
class DivRoundLastq:
    """Exact rounding division by the last modulus (a special prime or a
    dropped CKKS level): out_j = (x_j + h_j - [x_P + h]_P) * P^{-1} mod q_j."""
    qbase: Base                # remaining moduli
    half: int                  # floor(P/2)
    half_mod: torch.Tensor     # (k,) floor(P/2) mod q_j
    pinv_mod: torch.Tensor     # (k,) P^{-1} mod q_j
    p_last: int                # P

    @staticmethod
    def build(q_primes: Sequence[int], p_last: int, device="cpu") -> "DivRoundLastq":
        half = p_last // 2
        pin = [pow(p_last, -1, qj) for qj in q_primes]
        return DivRoundLastq(
            qbase=Base.build(q_primes, device), half=half,
            half_mod=mm.u32_to_i32([half % qj for qj in q_primes]).to(device),
            pinv_mod=mm.u32_to_i32(pin).to(device),
            p_last=int(p_last))

    def __call__(self, x):
        """x: (..., k+1, N) coeff-domain over q_0..q_{k-1}, P -> (..., k, N)."""
        pj = self.qbase.col()
        r = torch.remainder(x[..., -1:, :].to(mm.I64) + self.half, self.p_last)
        num = x[..., :-1, :].to(mm.I64) + self.half_mod.to(mm.I64)[:, None] - r
        return mm.mul_mod(torch.remainder(num, pj), self.pinv_mod.to(mm.I64)[:, None], pj)
