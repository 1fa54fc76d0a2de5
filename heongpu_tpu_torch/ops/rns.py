"""RNS machinery: exact lazy MAC, fast base conversion, divide-round-by-last
modulus (port of heongpu_tpu/ops/rns.py).

Conversion matrices and keys are stored in Montgomery form (M·2^32 mod p),
so the MAC result is Σ d·k·2^-32 mod p = Σ d·M mod p.  `mac_keys` and
`BaseConv` (its call and `convert_from_digits`) launch the hand-written CUDA
kernels of kernels/csrc/mac.cu (K2) for CUDA tensors, and `DivRoundLastq` /
`DivRoundChain` the ÷P kernel of kernels/csrc/divround.cu (K6); CPU tensors
take the plain versions (`lazy_mac_mont`, `base_conv_plain`,
`div_round_chain_plain`).  All are exact, so they agree bit for bit.
"""

from __future__ import annotations

import dataclasses
import functools
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
    def build(primes: Sequence[int], device) -> "Base":
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


def sum_u32_axis64(vals, axis: int):
    """Exact sum of 32-bit words (read as unsigned) along `axis`, as int64
    (the reference returns the same sum as a (hi, lo) pair of words)."""
    return mm.as_u32(vals).sum(dim=axis)


def decompose_to_base(x, obase: Base):
    """RNS-digit broadcast: x (..., k, N) residues (digit i = limb i's value)
    reduced into every modulus of `obase` -> (..., k, k_out, N)."""
    return torch.remainder(x.to(mm.I64)[..., :, None, :], obase.col()).to(mm.I32)


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


def base_conv_plain(z, mat_mont, obase: Base, scale=None):
    """The plain version of base_conv_cuda: z (..., k_in, N) -> (..., k_out, N),
    Σ_i z_i·mat[i, o]·2^-32 mod p_o, each z_i first multiplied by scale[1, i]
    mod scale[0, i] where a scale table is given."""
    if scale is not None:
        z = mm.shoup_mul(z, scale[1].to(mm.I64)[:, None], scale[0].to(mm.I64)[:, None])
    return lazy_mac_mont(z[..., :, None, :], mat_mont[:, :, None], obase)


@functools.lru_cache(maxsize=None)
def _sm_count(device) -> int:
    """The card's SM count, which sizes base_conv's wave of blocks."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def base_conv_cuda(z, mat_mont, obase: Base, scale=None):
    """Launch the base-conversion kernel: z (..., k_in, N), mat (k_in, k_out)
    -> (..., k_out, N).  With a scale table (3, k_in) of rows (q_i, w_i,
    floor(w_i·2^32/q_i)) the kernel first multiplies each input word by w_i
    mod q_i (BaseConv.scaled_digits) as it loads it."""
    from .. import kernels
    _check_cuda(z, mat_mont, obase.p, *(() if scale is None else (scale,)))
    k_in, k_out = mat_mont.shape
    N = z.shape[-1]
    if z.shape[-2] != k_in or len(obase) != k_out or (
            scale is not None and tuple(scale.shape) != (3, k_in)):
        raise ValueError(f"digits {tuple(z.shape)} do not match a "
                         f"{k_in}x{k_out} conversion into {len(obase)} limbs")
    if N % 2 or z.data_ptr() % 8:
        raise ValueError("base_conv takes an even N and 8-byte aligned digits "
                         "(two columns a thread)")
    B = z.numel() // (k_in * N)
    out = torch.empty(z.shape[:-2] + (k_out, N), dtype=mm.I32, device=z.device)
    err = kernels.library().hf_base_conv(
        z.data_ptr(), mat_mont.data_ptr(), out.data_ptr(), obase.p.data_ptr(),
        obase.pinv.data_ptr(), obase.mu.data_ptr(), None if scale is None else scale.data_ptr(),
        B, k_in, k_out, N, _sm_count(z.device), kernels.stream_of(z))
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
    scale: torch.Tensor        # (3, k_in)  q_i, qhat_inv, its Shoup companion (K2's scaling)

    @staticmethod
    def build(in_primes: Sequence[int], out_primes: Sequence[int],
              device) -> "BaseConv":
        q = functools.reduce(lambda a, b: a * b, in_primes, 1)
        qh_inv = [pow(q // qi, -1, qi) for qi in in_primes]
        mat = np.empty((len(in_primes), len(out_primes)), np.uint32)
        for i, qi in enumerate(in_primes):
            for mj, m in enumerate(out_primes):
                mat[i, mj] = ((q // qi) % m) * (1 << 32) % m
        qi = [int(v) for v in in_primes]
        return BaseConv(
            ibase=Base.build(in_primes, device), obase=Base.build(out_primes, device),
            qhat_inv=mm.u32_to_i32(qh_inv).to(device),
            mat_mont=mm.u32_to_i32(mat).to(device),
            scale=mm.u32_to_i32([qi, qh_inv, [mm.shoup(w, q) for w, q in zip(qh_inv, qi)]])
            .to(device))

    def scaled_digits(self, x):
        """z_i = |x_i * (q/q_i)^{-1}|_{q_i}."""
        return mm.shoup_mul(x, self.qhat_inv.to(mm.I64)[:, None], self.ibase.col())

    def convert_from_digits(self, z):
        """z (..., k_in, N) -> x̂ (..., k_out, N) in the out base."""
        if z.is_cuda:
            return base_conv_cuda(z, self.mat_mont, self.obase)
        _check_cpu(z)
        return base_conv_plain(z, self.mat_mont, self.obase)

    def __call__(self, x):
        """x (..., k_in, N) -> x̂: scaled_digits and the conversion, one K2
        launch on the card."""
        if x.is_cuda:
            return base_conv_cuda(x.contiguous(), self.mat_mont, self.obase, self.scale)
        return self.convert_from_digits(self.scaled_digits(x))


@dataclasses.dataclass(frozen=True, eq=False)
class DivRoundLastq:
    """Exact rounding division by the last modulus (a special prime or a
    dropped CKKS level): out_j = (x_j + h_j - [x_P + h]_P) * P^{-1} mod q_j.
    On the card it runs as a chain of one (K6)."""
    qbase: Base                # remaining moduli
    half: int                  # floor(P/2)
    half_mod: torch.Tensor     # (k,) floor(P/2) mod q_j
    pinv_mod: torch.Tensor     # (k,) P^{-1} mod q_j
    p_last: int                # P

    @staticmethod
    def build(q_primes: Sequence[int], p_last: int, device) -> "DivRoundLastq":
        half = p_last // 2
        pin = [pow(p_last, -1, qj) for qj in q_primes]
        return DivRoundLastq(
            qbase=Base.build(q_primes, device), half=half,
            half_mod=mm.u32_to_i32([half % qj for qj in q_primes]).to(device),
            pinv_mod=mm.u32_to_i32(pin).to(device),
            p_last=int(p_last))

    def plain(self, x):
        """x: (..., k+1, N) coeff-domain over q_0..q_{k-1}, P -> (..., k, N),
        as int64 torch passes."""
        pj = self.qbase.col()
        r = torch.remainder(x[..., -1:, :].to(mm.I64) + self.half, self.p_last)
        num = x[..., :-1, :].to(mm.I64) + self.half_mod.to(mm.I64)[:, None] - r
        return mm.mul_mod(torch.remainder(num, pj), self.pinv_mod.to(mm.I64)[:, None], pj)

    @functools.cached_property
    def chain(self) -> "DivRoundChain":
        """This stage as K6's chain of one, packed at first use."""
        return DivRoundChain.build((self,))

    def __call__(self, x):
        if x.is_cuda:
            return div_round_cuda(x.contiguous(), self.chain)
        _check_cpu(x)
        return self.plain(x)


@dataclasses.dataclass(frozen=True, eq=False)
class DivExactT:
    """BGV's t-exact division by the last modulus q_last (a special prime or a
    dropped level): out_j = (x_j + t·v) · q_last^-1 mod q_j with v =
    [-x_last · t^-1]_{q_last}, centered.  x + t·v is divisible by q_last, so
    the division is exact and the phase stays congruent to the message mod t
    up to the factor q_last^-1 mod t.  On the card it runs as a chain of one
    in K6's t-exact mode."""
    qbase: Base                # remaining moduli
    t: int
    half: int                  # floor(q_last/2)
    neg_tinv: int              # [-t^-1]_{q_last}
    t_mod: torch.Tensor        # (k,) t mod q_j
    pinv_mod: torch.Tensor     # (k,) q_last^-1 mod q_j
    p_last: int                # q_last

    @staticmethod
    def build(q_primes: Sequence[int], p_last: int, t: int, device) -> "DivExactT":
        return DivExactT(
            qbase=Base.build(q_primes, device), t=int(t), half=int(p_last) // 2,
            neg_tinv=(-pow(int(t), -1, int(p_last))) % int(p_last),
            t_mod=mm.u32_to_i32([int(t) % qj for qj in q_primes]).to(device),
            pinv_mod=mm.u32_to_i32([pow(int(p_last), -1, qj) for qj in q_primes]).to(device),
            p_last=int(p_last))

    def plain(self, x):
        """x: (..., k+1, N) coeff-domain over q_0..q_{k-1}, q_last -> (..., k, N),
        as int64 torch passes."""
        pj = self.qbase.col()
        v = torch.remainder(x[..., -1:, :].to(mm.I64) * self.neg_tinv, self.p_last)
        v = torch.where(v > self.half, v - self.p_last, v)
        num = x[..., :-1, :].to(mm.I64) + torch.remainder(v * self.t, pj)
        return mm.mul_mod(torch.remainder(num, pj), self.pinv_mod.to(mm.I64)[:, None], pj)

    @functools.cached_property
    def chain(self) -> "DivRoundChain":
        """This stage as K6's t-exact chain of one, packed at first use."""
        return DivRoundChain.build((self,))

    def __call__(self, x):
        if x.is_cuda:
            return div_round_cuda(x.contiguous(), self.chain)
        _check_cpu(x)
        return self.plain(x)


# The most stages one K6 launch runs (a template parameter of divround.cu).
DIV_ROUND_MAX_STAGES = 16


@dataclasses.dataclass(frozen=True, eq=False)
class DivRoundChain:
    """p_count DivRoundLastq stages in a row: x (..., k+p, N) over q_0..q_{k-1}
    and the special primes P_0..P_{p-1} -> (..., k, N), dividing by P_{p-1}
    first, then by each earlier one (the exact ÷P of a keyswitch or an
    encryption).  One K6 launch on the card (one a piece of 16 stages for a
    longer chain).

    `tab` is K6's table, packed on the host as int32 words: P_s and floor(P_s/2)
    for each stage s (2p words), the W = k+p-1 primes q_j of stage 0's
    remaining basis, zeros up to a multiple of 4, then for each limb j and
    stage s (j-major) the four words (h_sj, P_s^-1 mod q_j, its Shoup
    companion, 0), zero where limb j is gone by stage s.  h_sj is
    floor(P_s/2) mod q_j plus the least multiple of q_j that is at least P_s,
    so that x_j + h_sj - r_s is never negative for a rounding term r_s < P_s.

    A chain of DivExactT stages (`exact_t`) runs K6's t-exact mode: its head
    holds [-t^-1]_{P_s} and its Shoup companion for each stage after P_s and
    floor(P_s/2), and its four words per limb and stage are ([t]_{q_j}, its
    Shoup companion, P_s^-1 mod q_j, its Shoup companion)."""
    stages: tuple
    tab: torch.Tensor
    max_prime: int
    exact_t: bool = False

    @staticmethod
    def build(stages) -> "DivRoundChain":
        stages = tuple(stages)
        exact_t = isinstance(stages[0], DivExactT)
        if any(isinstance(st, DivExactT) != exact_t for st in stages):
            raise ValueError("a chain takes rounding stages or t-exact stages, not both")
        q = [int(v) for v in stages[0].qbase.p.tolist()]
        for s, (a, b) in enumerate(zip(stages, stages[1:])):
            if len(b.qbase) != len(a.qbase) - 1 or b.p_last != q[len(a.qbase) - 1]:
                raise ValueError(f"stage {s + 1} does not divide by the last limb that "
                                 f"stage {s} leaves")
        p, w = len(stages), len(q)
        head = [st.p_last for st in stages] + [st.half for st in stages]
        if exact_t:
            head += [st.neg_tinv for st in stages]
            head += [mm.shoup(st.neg_tinv, st.p_last) for st in stages]
        head += q
        head += [0] * (-len(head) % 4)
        body = np.zeros((w, p, 4), np.uint32)
        for s, st in enumerate(stages):
            for j, qj in enumerate(q[:w - s]):
                inv = pow(st.p_last, -1, qj)
                if exact_t:
                    tq = st.t % qj
                    body[j, s] = (tq, mm.shoup(tq, qj), inv, mm.shoup(inv, qj))
                else:
                    body[j, s] = (st.half % qj + -(-st.p_last // qj) * qj, inv,
                                  mm.shoup(inv, qj), 0)
        tab = mm.u32_to_i32(np.concatenate([np.array(head, np.uint32), body.ravel()]))
        return DivRoundChain(stages=stages, tab=tab.to(stages[0].qbase.p.device),
                             max_prime=max(q + [st.p_last for st in stages]), exact_t=exact_t)

    @functools.cached_property
    def pieces(self) -> tuple:
        """The chain cut into runs of at most DIV_ROUND_MAX_STAGES stages, one K6
        launch each (the chain itself where it is short enough)."""
        m = DIV_ROUND_MAX_STAGES
        if len(self.stages) <= m:
            return (self,)
        return tuple(DivRoundChain.build(self.stages[i:i + m])
                     for i in range(0, len(self.stages), m))

    @property
    def k(self) -> int:
        """Limbs left after the last stage."""
        return len(self.stages[-1].qbase)

    def __len__(self):
        return len(self.stages)

    def __iter__(self):
        return iter(self.stages)

    def __call__(self, x):
        if x.is_cuda:
            return div_round_cuda(x.contiguous(), self)
        _check_cpu(x)
        return div_round_chain_plain(x, self)


def div_round_chain_plain(x, chain: DivRoundChain):
    """The plain version of div_round_cuda: the stages one after another."""
    for stage in chain.stages:
        x = stage.plain(x)
    return x


def div_round_cuda(x, chain: DivRoundChain):
    """Launch K6: every stage of the chain in one pass over x (..., k+p, N)
    -> (..., k, N); a chain of more than DIV_ROUND_MAX_STAGES stages in one
    launch for each of its pieces.  A chain of DivExactT stages runs the
    t-exact mode (counted as `div_exact_t`)."""
    from .. import kernels
    _check_cuda(x, chain.tab)
    p, k, N = len(chain), chain.k, x.shape[-1]
    if x.shape[-2] != k + p:
        raise ValueError(f"{tuple(x.shape)} does not hold the {k} + {p} limbs of the chain")
    if chain.max_prime >= 1 << 30:
        raise ValueError(f"div_round takes primes below 2^30, not one of "
                         f"{chain.max_prime.bit_length()} bits")
    B = x.numel() // ((k + p) * N)
    for piece in chain.pieces:
        kp = piece.k
        out = torch.empty(x.shape[:-2] + (kp, N), dtype=mm.I32, device=x.device)
        name = "div_exact_t" if chain.exact_t else "div_round"
        err = getattr(kernels.library(), f"hf_{name}")(
            x.data_ptr(), out.data_ptr(), piece.tab.data_ptr(), B, kp, len(piece), N,
            kernels.stream_of(x))
        kernels.check(err, name)
        kernels.launches[name] += 1
        x = out
    return x
