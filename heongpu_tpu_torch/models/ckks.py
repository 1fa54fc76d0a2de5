"""CKKS scheme, the main-path subset (port of heongpu_tpu/models/ckks.py).

Context, keygen, host encoder, encrypt / decrypt and the leveled arithmetic
of the multiply -> relinearize -> rescale path, on one torch device.
Ciphertexts live in the NTT domain over the level's prime prefix, exactly as
in the reference, and every op returns the reference's residues.  On a CUDA
context every NTT and every keyswitch MAC / base conversion runs the
hand-written kernels; the tensor product, the divide-by-P stages, rescale and
the encrypt pass are plain torch.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from functools import lru_cache, reduce
from typing import Optional, Sequence

import numpy as np
import torch

from ..ops import keyswitch2, polyops, rns
from ..ops import modmath as mm
from ..ops import ntt as nttm
from ..utils import errors, nt, rng
from ..utils.params import validate_security
from . import ringkit
from .ringkit import KSKey, PublicKey, RingView, SecretKey

_prod = lambda xs: reduce(lambda a, b: a * b, xs, 1)


# =========================================================================
# Context
# =========================================================================

@dataclasses.dataclass(frozen=True, eq=False)
class CkksContext:
    """Precomputed tables for a CKKS chain, on `device`."""
    n: int
    logn: int
    k: int                      # number of Q primes (level 0 uses all)
    q_primes: tuple
    p_primes: tuple
    default_scale: float
    sec_level: str
    ks_type: str                # "II" (hybrid groups) on the ported path
    alpha: int                  # primes per keyswitch digit
    device: torch.device
    ntt_qp: nttm.NttTables      # over Q ∪ P
    base_q: rns.Base
    base_qp: rns.Base
    div_p: rns.DivRoundLastq    # ÷(first special) at level 0
    div_level: tuple            # div_level[lvl] = DivRoundLastq dropping q_{k-1-lvl}
    enc_div: tuple              # sequential ÷p stages over Q·P (encrypt path)
    ks2: tuple                  # per-level keyswitch2.KS2Level (Method II)
    slot_to_ntt: torch.Tensor   # (n/2,) int32: NTT index of slot j
    conj_perm: torch.Tensor     # (n,) NTT-domain permutation for conjugation
    _level_tables: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def qp_primes(self):
        return tuple(self.q_primes) + tuple(self.p_primes)

    def active(self, level: int) -> int:
        """Number of active Q limbs at `level`."""
        return self.k - level

    def ntt_q(self, level: int) -> nttm.NttTables:
        return self.ntt_qp.slice_limbs(0, self.active(level))

    def base_q_at(self, level: int) -> rns.Base:
        return self.base_q.take(slice(0, self.active(level)))

    def _qp_index(self, level: int):
        ka = self.active(level)
        return list(range(ka)) + list(range(self.k, self.k + len(self.p_primes)))

    def ntt_qp_at(self, level: int) -> nttm.NttTables:
        """Level basis + special primes: limbs [0..active) ∪ [k..k+p)."""
        if level == 0:
            return self.ntt_qp
        key = ("ntt_qp", level)
        if key not in self._level_tables:
            ka = self.active(level)
            self._level_tables[key] = self.ntt_qp.slice_limbs(0, ka).concat(
                self.ntt_qp.slice_limbs(self.k, self.k + len(self.p_primes)))
        return self._level_tables[key]

    def base_qp_at(self, level: int) -> rns.Base:
        if level == 0:
            return self.base_qp
        return self.base_qp.take(self._qp_index(level))

    def div_p_at(self, level: int) -> rns.DivRoundLastq:
        """÷(first special prime) over the level's active Q limbs."""
        if level == 0:
            return self.div_p
        ka = self.active(level)
        d = self.div_p
        return dataclasses.replace(
            d, qbase=d.qbase.take(slice(0, ka)), half_mod=d.half_mod[:ka],
            pinv_mod=d.pinv_mod[:ka])


def make_context(n: int,
                 q_bits: Sequence[int],
                 scale_bits: Optional[int] = None,
                 sec_level: str = "none",
                 ks_type: str = "II",
                 alpha: int = 1,
                 p_count: Optional[int] = None,
                 pair_scale_primes: Optional[bool] = None,
                 device="cpu") -> CkksContext:
    """q_bits: bit sizes of the Q chain, q_bits[0] = base prime; `p_count`
    (default alpha) 30-bit special primes are appended; keyswitching is
    Method II with digits of `alpha` grouped primes.  Prime generation,
    scale-prime pairing and default_scale follow the reference exactly (see
    heongpu_tpu/models/ckks.py:make_context); every table is built on
    `device`."""
    if ks_type != "II":
        raise errors.ParameterError(
            "the port runs Method-II keyswitching (ks_type='II'); Method I "
            "is not ported yet")
    device = torch.device(device)
    logn = n.bit_length() - 1
    assert 1 << logn == n
    if p_count is None:
        p_count = alpha
    assert p_count >= alpha, "P must cover at least one digit"
    q_primes = []
    used = set()
    for b in q_bits:
        pr = nt.generate_ntt_primes(b, 1, n, exclude=used)[0]
        used.add(pr)
        q_primes.append(pr)
    p_primes = nt.generate_ntt_primes(30, p_count, n, exclude=used)
    validate_security(n, q_primes + p_primes, sec_level)
    if scale_bits is None:
        scale_bits = q_bits[1] if len(q_bits) > 1 else q_bits[0] - 1

    # Deep-chain scale stability (reference ckks.py:194-231): complementary
    # pairing of the scale primes, consumed in reverse chain order, anchors
    # default_scale at their geometric mean.  Index 0 (the decrypt base
    # prime) is never consumed by rescale and never joins the pairing.
    sgroup = [i for i, b in enumerate(q_bits) if b == scale_bits and i > 0]
    if pair_scale_primes is None:
        pair_scale_primes = len(sgroup) >= 4
    if pair_scale_primes and len(sgroup) >= 4:
        sprimes = [q_primes[i] for i in sgroup]
        logs = sorted(math.log2(p) for p in sprimes)
        anchor = sum(logs) / len(logs)
        bylog = sorted(sprimes, key=math.log2)
        consume = []
        lo, hi = 0, len(bylog) - 1
        while lo < hi:
            consume += [bylog[lo], bylog[hi]]
            lo, hi = lo + 1, hi - 1
        if lo == hi:
            consume.append(bylog[lo])
        consume.reverse()          # chain order: last prime consumed first
        for i, pr in zip(sgroup, consume):
            q_primes[i] = pr
        default_scale = float(2.0 ** anchor)
    else:
        default_scale = float(2.0 ** scale_bits)
    if len(q_bits) > 2 and any(abs(b - scale_bits) > 1 for b in q_bits[1:]):
        warnings.warn(
            f"scale 2^{scale_bits} vs scale-prime sizes {sorted(set(q_bits[1:]))}: "
            "rescale multiplies the working scale by 2^(scale_bits - prime_bits) "
            "per level; a mismatch decays the scale geometrically and deep "
            "circuits (bootstrapping) lose the message below the noise floor. "
            "Choose scale primes within 1 bit of scale_bits.")
    k = len(q_primes)

    ieo = nttm.inv_eval_order(n)
    slot_to_ntt = ieo[_slot_eval_nat(n)].astype(np.int32)
    div_level = tuple(
        rns.DivRoundLastq.build(q_primes[:k - lvl - 1], q_primes[k - lvl - 1], device)
        for lvl in range(k - 1))
    enc_div = []
    remaining = list(q_primes) + list(p_primes)
    for sp in reversed(p_primes):
        remaining = remaining[:-1]
        enc_div.append(rns.DivRoundLastq.build(remaining, sp, device))
    ks2 = tuple(keyswitch2.build_ks2_level(q_primes, p_primes, k - lvl, alpha, device)
                for lvl in range(k))

    return CkksContext(
        n=n, logn=logn, k=k,
        q_primes=tuple(q_primes), p_primes=tuple(p_primes),
        default_scale=default_scale, sec_level=sec_level,
        ks_type=ks_type, alpha=alpha, device=device,
        ntt_qp=nttm.build_ntt_tables(q_primes + p_primes, n, device=device),
        base_q=rns.Base.build(q_primes, device),
        base_qp=rns.Base.build(q_primes + p_primes, device),
        div_p=rns.DivRoundLastq.build(q_primes, p_primes[0], device),
        div_level=div_level,
        enc_div=tuple(enc_div),
        ks2=ks2,
        slot_to_ntt=torch.from_numpy(slot_to_ntt).to(device),
        conj_perm=polyops.galois_perm_ntt(2 * n - 1, n, device),
    )


def _ring(ctx: CkksContext) -> RingView:
    return RingView(ctx.n, ctx.q_primes, ctx.p_primes, ctx.base_q,
                    ctx.base_qp, ctx.ntt_qp, ctx.div_p)


def _groups(ctx, level: int = 0):
    ka = ctx.active(level)
    return tuple(tuple(range(j, min(j + ctx.alpha, ka)))
                 for j in range(0, ka, ctx.alpha))


def keygen_secret(ctx, key, hamming_weight=None) -> SecretKey:
    return ringkit.keygen_secret(_ring(ctx), key, hamming_weight)


def keygen_public(ctx, key, sk) -> PublicKey:
    return ringkit.keygen_public(_ring(ctx), key, sk)


def keygen_relin(ctx, key, sk) -> KSKey:
    return ringkit.keygen_relin(_ring(ctx), key, sk, groups=_groups(ctx))


# =========================================================================
# Ciphertext / Plaintext
# =========================================================================

@dataclasses.dataclass(frozen=True, eq=False)
class Ciphertext:
    """NTT-domain ciphertext: c (size, k-level, n) int32; scale is float
    metadata."""
    c: torch.Tensor
    size: int
    level: int
    scale: float


@dataclasses.dataclass(frozen=True, eq=False)
class Plaintext:
    m: torch.Tensor  # (k-level, n), NTT domain
    level: int
    scale: float


# =========================================================================
# Encoder (canonical embedding — host float64 numpy path)
# =========================================================================

@lru_cache(maxsize=None)
def _slot_eval_nat(n: int) -> np.ndarray:
    """Natural evaluation index of slot j (the 5^j orbit): point psi^(2e+1)
    with 2e+1 = 5^j mod 2n."""
    m2 = 2 * n
    out = np.empty(n // 2, np.int64)
    g5 = 1
    for j in range(n // 2):
        out[j] = (g5 - 1) // 2
        g5 = g5 * 5 % m2
    return out


def _embed_coeffs_from_slots(ctx: CkksContext, z: np.ndarray) -> np.ndarray:
    """slots (n/2 complex) -> real coefficient vector (float, unscaled)."""
    n = ctx.n
    m2 = 2 * n
    spec = np.zeros(n, np.complex128)
    idx = _slot_eval_nat(n)
    spec[idx] = z
    conj_idx = (m2 - (2 * idx + 1) - 1) // 2        # point psi^{-(2e+1)}
    spec[conj_idx] = np.conj(z)
    u = np.fft.fft(spec) / n
    tw = np.exp(-1j * np.pi * np.arange(n) / n)
    return (u * tw).real


def _slots_from_embed_coeffs(ctx: CkksContext, a: np.ndarray) -> np.ndarray:
    n = ctx.n
    tw = np.exp(1j * np.pi * np.arange(n) / n)
    spec = np.fft.ifft(a * tw) * n
    return spec[_slot_eval_nat(n)]


def coeffs_to_rns(a: np.ndarray, primes) -> np.ndarray:
    """Rounded float coefficients -> (L, n) uint32 RNS residues; int64 fast
    path when the magnitudes allow, exact object-int path otherwise."""
    res = np.empty((len(primes), a.shape[-1]), np.uint32)
    if a.size and np.max(np.abs(a)) < 2 ** 62:
        c = np.round(a).astype(np.int64)
        for i, q in enumerate(primes):
            res[i] = (c % int(q)).astype(np.uint32)
    else:
        c = np.round(a).astype(object)
        for i, q in enumerate(primes):
            res[i] = (c % int(q)).astype(np.uint64).astype(np.uint32)
    return res


def encode_host(ctx: CkksContext, values, scale: Optional[float] = None,
                level: int = 0) -> Plaintext:
    """Host float64 path (numpy FFT + int64/bigint RNS), then the forward
    NTT on the context's device."""
    scale = float(scale or ctx.default_scale)
    z = np.zeros(ctx.n // 2, np.complex128)
    v = np.asarray(values)
    z[: v.size] = v
    a = _embed_coeffs_from_slots(ctx, z) * scale
    res = coeffs_to_rns(a, ctx.q_primes[:ctx.active(level)])
    m = nttm.ntt_fwd(mm.u32_to_i32(res).to(ctx.device), ctx.ntt_q(level))
    return Plaintext(m, level, scale)


def decode_host(ctx: CkksContext, pt: Plaintext) -> np.ndarray:
    """Host big-int path: inverse NTT on the device, CRT and the inverse
    embedding on the host."""
    ka = ctx.active(pt.level)
    coeffs = nttm.ntt_inv(pt.m, ctx.ntt_q(pt.level)).cpu().numpy().view(np.uint32)
    primes = [int(q) for q in ctx.q_primes[:ka]]
    Q = _prod(primes)
    acc = np.zeros(ctx.n, object)
    for i, q in enumerate(primes):
        Mi = Q // q
        acc += coeffs[i].astype(object) * ((pow(Mi, -1, q) * Mi) % Q)
    acc %= Q
    acc = np.where(acc >= Q // 2, acc - Q, acc)
    a = (acc / pt.scale).astype(np.float64)
    return _slots_from_embed_coeffs(ctx, a)


def encode(ctx: CkksContext, values, scale: Optional[float] = None,
           level: int = 0) -> Plaintext:
    """values: up to n/2 real or complex numbers.  Until the device encoder
    is ported this is the host float64 path, `encode_host`."""
    return encode_host(ctx, values, scale, level)


def decode(ctx: CkksContext, pt: Plaintext) -> np.ndarray:
    """Plaintext -> n/2 complex slot values.  Until the device decoder is
    ported this is the host big-int path, `decode_host`."""
    return decode_host(ctx, pt)


# =========================================================================
# Encrypt / Decrypt
# =========================================================================

def _encrypt_zero_ntt(ctx: CkksContext, pk: PublicKey, key):
    """(c0, c1) encrypting 0 over Q, NTT domain (level 0).  Draw order as in
    the reference: ternary u, then e0, then e1."""
    ku, k0, k1 = rng.split(key, 3)
    qp = ctx.base_qp
    p, rinv = qp.col(), qp.col("rinv")
    u = nttm.ntt_fwd(rng.ternary_rns(ku, ctx.qp_primes, (ctx.n,), ctx.device),
                     ctx.ntt_qp)
    c = nttm.ntt_inv(mm.mont_mul(torch.stack([pk.pk0, pk.pk1]), u, p, rinv),
                     ctx.ntt_qp)
    for stage in ctx.enc_div:
        c = stage(c)
    e0 = rng.gaussian_rns(k0, ctx.q_primes, (ctx.n,), ctx.device)
    e1 = rng.gaussian_rns(k1, ctx.q_primes, (ctx.n,), ctx.device)
    c = mm.add_mod(c, torch.stack([e0, e1]), ctx.base_q.col())
    return nttm.ntt_fwd(c, ctx.ntt_q(0))


def encrypt(ctx: CkksContext, pk: PublicKey, pt: Plaintext, key) -> Ciphertext:
    if pt.level != 0:
        raise errors.LevelMismatchError(
            "encrypt expects a level-0 plaintext (mod_drop the ciphertext "
            "afterwards if a lower level is needed)")
    z = _encrypt_zero_ntt(ctx, pk, key)
    c0 = mm.add_mod(z[0], pt.m, ctx.base_q.col())
    return Ciphertext(torch.stack([c0, z[1]]), 2, 0, pt.scale)


def decrypt(ctx: CkksContext, sk: SecretKey, ct: Ciphertext) -> Plaintext:
    ka = ctx.active(ct.level)
    qb = ctx.base_q_at(ct.level)
    p, rinv = qb.col(), qb.col("rinv")
    s = sk.s_ntt_mont_qp[:ka]
    acc = mm.add_mod(ct.c[0], mm.mont_mul(ct.c[1], s, p, rinv), p)
    if ct.size == 3:
        s2 = mm.mont_mul(s, s, p, rinv)
        acc = mm.add_mod(acc, mm.mont_mul(ct.c[2], s2, p, rinv), p)
    return Plaintext(acc, ct.level, ct.scale)


# =========================================================================
# Leveled arithmetic
# =========================================================================

def _p_at(ctx, level):
    return ctx.base_q_at(level).col()


def _check_compat(a: Ciphertext, b: Ciphertext):
    errors.check_level(a.level, b.level)
    errors.check_scale(a.scale, b.scale)


def add(ctx, a: Ciphertext, b: Ciphertext) -> Ciphertext:
    _check_compat(a, b)
    sz = max(a.size, b.size)
    ca, cb = a.c, b.c
    if a.size < sz:  # pad the shorter with zeros
        ca = torch.cat([ca, torch.zeros_like(cb[a.size:])])
    elif b.size < sz:
        cb = torch.cat([cb, torch.zeros_like(ca[b.size:])])
    return Ciphertext(mm.add_mod(ca, cb, _p_at(ctx, a.level)), sz, a.level, a.scale)


def sub(ctx, a: Ciphertext, b: Ciphertext) -> Ciphertext:
    _check_compat(a, b)
    errors.check_size(b.size, a.size, "sub")
    return Ciphertext(mm.sub_mod(a.c, b.c, _p_at(ctx, a.level)),
                      a.size, a.level, a.scale)


def negate(ctx, a: Ciphertext) -> Ciphertext:
    return Ciphertext(mm.neg_mod(a.c, _p_at(ctx, a.level)), a.size, a.level, a.scale)


def add_plain(ctx, a: Ciphertext, pt: Plaintext) -> Ciphertext:
    errors.check_level(a.level, pt.level, "ciphertext/plaintext")
    errors.check_scale(a.scale, pt.scale)
    c0 = mm.add_mod(a.c[0], pt.m, _p_at(ctx, a.level))
    return Ciphertext(torch.cat([c0[None], a.c[1:]]), a.size, a.level, a.scale)


def multiply(ctx, a: Ciphertext, b: Ciphertext) -> Ciphertext:
    """(2,k,n) x (2,k,n) -> (3,k,n): the NTT-domain tensor product."""
    errors.check_level(a.level, b.level)
    errors.check_size(a.size, 2, "multiply")
    errors.check_size(b.size, 2, "multiply")
    p = _p_at(ctx, a.level)
    a0, a1 = a.c[0].to(mm.I64), a.c[1].to(mm.I64)
    b0, b1 = b.c[0].to(mm.I64), b.c[1].to(mm.I64)
    c = torch.stack([torch.remainder(a0 * b0, p),
                     torch.remainder(torch.remainder(a0 * b1, p) + a1 * b0, p),
                     torch.remainder(a1 * b1, p)]).to(mm.I32)
    return Ciphertext(c, 3, a.level, a.scale * b.scale)


def multiply_plain(ctx, a: Ciphertext, pt: Plaintext) -> Ciphertext:
    errors.check_level(a.level, pt.level, "ciphertext/plaintext")
    return Ciphertext(mm.mul_mod(a.c, pt.m[None], _p_at(ctx, a.level)),
                      a.size, a.level, a.scale * pt.scale)


def rescale(ctx, a: Ciphertext) -> Ciphertext:
    """Drop the last active limb with rounding, in the NTT domain."""
    ka = ctx.active(a.level)
    if ka <= 1:
        raise errors.LevelMismatchError(
            "no limb left to rescale (ciphertext already at the last level)")
    dv = ctx.div_level[a.level]
    pj = dv.qbase.col()
    # (r - half) per coefficient, reduced into each remaining limb, then NTT:
    # out = (c - NTT(r - half)) * q_last^{-1}; the +half/-half pair rounds,
    # and it must act per coefficient, hence before the transform back.
    last = nttm.ntt_inv(a.c[:, ka - 1: ka, :].contiguous(),
                        ctx.ntt_qp.slice_limbs(ka - 1, ka))
    r = torch.remainder(last.to(mm.I64) + dv.half, dv.p_last)
    r_mod = mm.sub_mod(torch.remainder(r, pj), dv.half_mod.to(mm.I64)[:, None], pj)
    lift = nttm.ntt_fwd(r_mod, ctx.ntt_qp.slice_limbs(0, ka - 1))
    num = mm.sub_mod(a.c[:, : ka - 1, :], lift, pj)
    out = mm.mul_mod(num, dv.pinv_mod.to(mm.I64)[:, None], pj)
    return Ciphertext(out, a.size, a.level + 1, a.scale / int(ctx.q_primes[ka - 1]))


def mod_drop(ctx, a: Ciphertext, levels: int = 1) -> Ciphertext:
    ka = ctx.active(a.level)
    return Ciphertext(a.c[:, : ka - levels, :].contiguous(), a.size,
                      a.level + levels, a.scale)


# =========================================================================
# Relinearize (Method-II keyswitch)
# =========================================================================

def _slice_key2(ctx, k_arr, ka: int, d_lvl: int):
    """Method-II key slice: first d_lvl digits, active Q limbs + all
    specials (the key's own Q extent is derived from its shape)."""
    k_gen = k_arr.shape[1] - len(ctx.p_primes)
    if ka > k_gen:
        raise errors.LevelMismatchError(
            f"key generated at a {k_gen}-limb basis used at a level with "
            f"{ka} active limbs; regenerate the key at level <= "
            f"{ctx.k - k_gen}")
    if ka == k_gen and d_lvl == k_arr.shape[0]:
        return k_arr
    return torch.cat([k_arr[:d_lvl, :ka], k_arr[:d_lvl, k_gen:]], dim=1)


def _keyswitch_poly(ctx, poly_ntt, k0, k1, level):
    """Keyswitch one NTT-domain poly at `level`; returns (d0, d1) NTT-domain."""
    ka = ctx.active(level)
    d_lvl = -(-ka // ctx.alpha)
    return keyswitch2.keyswitch2(
        poly_ntt, _slice_key2(ctx, k0, ka, d_lvl), _slice_key2(ctx, k1, ka, d_lvl),
        ctx.ks2[level], ctx.ntt_qp_at(level), ctx.base_qp_at(level),
        in_ntt=True, out_ntt=True, ntt_q_level=ctx.ntt_q(level))


def relinearize(ctx, a: Ciphertext, rk: KSKey) -> Ciphertext:
    errors.check_size(a.size, 3, "relinearize")
    d0, d1 = _keyswitch_poly(ctx, a.c[2], rk.k0, rk.k1, a.level)
    p = _p_at(ctx, a.level)
    return Ciphertext(mm.add_mod(a.c[:2], torch.stack([d0, d1]), p),
                      2, a.level, a.scale)
