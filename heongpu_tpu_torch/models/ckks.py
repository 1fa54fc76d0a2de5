"""CKKS scheme (port of heongpu_tpu/models/ckks.py): the multiply ->
relinearize -> rescale path, the rotation path and the surface that
bootstrapping calls.

Context, keygen (secret, public, relinearization and Galois keys at a level
basis, switching keys), the device encoder (float64 special FFT, exact RNS
reduction; exact constants; coefficient mode) with the host oracles,
encrypt / decrypt, the leveled arithmetic, rotations, conjugation, key
switching, hoisted rotations and monomial products, on one torch device.
Ciphertexts live in the NTT domain over the level's prime prefix, exactly as
in the reference, and every op returns the reference's residues (the float
encoder agrees with the reference's df64 one within ±2 per centered
coefficient at the default scales).  Keyswitching is Method I (one digit per
Q prime, one special prime; the default, as in the reference) or Method II
(digits of alpha grouped primes).  On a CUDA context every NTT runs K1; a
Method-II keyswitch of one poly (relinearize, apply_galois, rotate,
conjugate, switch_key) runs the fused core K5, a Method-I one runs K1 and K2
(the key MAC), and hoisting runs K1 and K2 (base conversion under Method
II, key MAC); the tensor product, the digit broadcast, the Galois gathers,
the divide-by-P stages, rescale, the encoder's FFT and the encrypt pass are
plain torch.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from functools import lru_cache, reduce
from typing import Optional, Sequence

import numpy as np
import torch

from ..ops import compose, keyswitch2, polyops, rns, sfft
from ..ops import modmath as mm
from ..ops import ntt as nttm
from ..utils import errors, nt, rng
from ..utils.params import validate_security
from . import ringkit
from .ringkit import GaloisKey, GaloisKeyOne, KSKey, PublicKey, RingView, SecretKey

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
    ks_type: str                # "I" (one digit per Q prime) or "II" (hybrid groups)
    alpha: int                  # primes per keyswitch digit (1 under Method I)
    device: torch.device
    ntt_qp: nttm.NttTables      # over Q ∪ P
    base_q: rns.Base
    base_qp: rns.Base
    div_p: rns.DivRoundLastq    # ÷(first special) at level 0
    div_level: tuple            # div_level[lvl] = DivRoundLastq dropping q_{k-1-lvl}
    enc_div: rns.DivRoundChain  # sequential ÷p stages over Q·P (encrypt path; one K6 launch)
    ks2: tuple                  # per-level keyswitch2.KS2Level (Method II; empty under I)
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
        key = ("div_p", level)
        if key not in self._level_tables:
            ka = self.active(level)
            d = self.div_p
            self._level_tables[key] = dataclasses.replace(
                d, qbase=d.qbase.take(slice(0, ka)), half_mod=d.half_mod[:ka],
                pinv_mod=d.pinv_mod[:ka])
        return self._level_tables[key]


def make_context(n: int,
                 q_bits: Sequence[int],
                 scale_bits: Optional[int] = None,
                 sec_level: str = "none",
                 ks_type: str = "I",
                 alpha: int = 1,
                 p_count: Optional[int] = None,
                 pair_scale_primes: Optional[bool] = None,
                 device="cuda") -> CkksContext:
    """q_bits: bit sizes of the Q chain, q_bits[0] = base prime; `p_count`
    (default alpha) 30-bit special primes are appended.  ks_type "I" (the
    default) keyswitches with one digit per Q prime and forces alpha to 1;
    "II" uses digits of `alpha` grouped primes.  Prime generation,
    scale-prime pairing and default_scale follow the reference exactly (see
    heongpu_tpu/models/ckks.py:make_context); every table is built on
    `device`."""
    if ks_type not in ("I", "II"):
        raise errors.ParameterError(f"unknown keyswitching method {ks_type!r} (use 'I' or 'II')")
    device = torch.device(device)
    logn = n.bit_length() - 1
    assert 1 << logn == n
    if ks_type == "I":
        alpha = 1
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
    ks2 = ()
    if ks_type == "II":
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
        enc_div=rns.DivRoundChain.build(enc_div),
        ks2=ks2,
        slot_to_ntt=torch.from_numpy(slot_to_ntt).to(device),
        conj_perm=polyops.galois_perm_ntt(2 * n - 1, n, device),
    )


def _ring(ctx: CkksContext) -> RingView:
    return RingView(ctx.n, ctx.q_primes, ctx.p_primes, ctx.base_q,
                    ctx.base_qp, ctx.ntt_qp, ctx.div_p)


def _ring_at(ctx: CkksContext, level: int) -> RingView:
    """Ring view over the level basis (active Q prefix + specials), so keys
    can be generated at their use level."""
    if level == 0:
        return _ring(ctx)
    ka = ctx.active(level)
    return RingView(ctx.n, ctx.q_primes[:ka], ctx.p_primes, ctx.base_q_at(level),
                    ctx.base_qp_at(level), ctx.ntt_qp_at(level), ctx.div_p_at(level))


def _sk_at(ctx: CkksContext, sk: SecretKey, level: int) -> SecretKey:
    """Secret key restricted to the level basis (limb rows sliced)."""
    if level == 0:
        return sk
    ka = ctx.active(level)
    s = torch.cat([sk.s_ntt_mont_qp[:ka], sk.s_ntt_mont_qp[ctx.k:]])
    return SecretKey(sk.s_coeff, s, sk.hamming_weight)


def _groups(ctx, level: int = 0):
    """Method II's digit groups at the level basis; None (one digit per
    prime) under Method I."""
    if ctx.ks_type != "II":
        return None
    ka = ctx.active(level)
    return tuple(tuple(range(j, min(j + ctx.alpha, ka)))
                 for j in range(0, ka, ctx.alpha))


def keygen_secret(ctx, key, hamming_weight=None) -> SecretKey:
    return ringkit.keygen_secret(_ring(ctx), key, hamming_weight)


def keygen_public(ctx, key, sk, a_seed=None) -> PublicKey:
    return ringkit.keygen_public(_ring(ctx), key, sk, a_seed=a_seed)


def keygen_relin(ctx, key, sk, a_seed=None, level: int = 0) -> KSKey:
    """level > 0: generate at the level basis (usable at levels >= level
    only; the key's limb extent encodes its generation level)."""
    return ringkit.keygen_relin(_ring_at(ctx, level), key, _sk_at(ctx, sk, level),
                                groups=_groups(ctx, level), a_seed=a_seed)


def keygen_galois(ctx, key, sk, steps=None, max_shift: int = 8, elts=None,
                  a_seed=None, store_a: bool = True, include_conj: bool = True,
                  level: int = 0, inv_form: bool = False) -> GaloisKey:
    """Galois keys (ringkit.keygen_galois) at the level basis; a key made at
    `level` serves levels >= level.  a_seed seed-expands them, and
    store_a=False stores them stripped (ringkit.keygen_galois)."""
    return ringkit.keygen_galois(_ring_at(ctx, level), key, _sk_at(ctx, sk, level),
                                 steps, max_shift, include_conj=include_conj,
                                 groups=_groups(ctx, level), elts=elts, a_seed=a_seed,
                                 store_a=store_a, inv_form=inv_form)


def keygen_switch(ctx, key, sk_old, sk_new) -> KSKey:
    return ringkit.keygen_switch(_ring(ctx), key, sk_old, sk_new, groups=_groups(ctx))


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
# Encoder (canonical embedding): the float64 device path, and the host
# numpy / big-int oracles
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


def _slots(ctx: CkksContext, values) -> np.ndarray:
    z = np.zeros(ctx.n // 2, np.complex128)
    v = np.asarray(values)
    z[: v.size] = v.ravel()
    return z


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
    """Host float64 oracle (numpy FFT + int64/bigint RNS), then the forward
    NTT on the context's device; equal to the reference's encode_host."""
    scale = float(scale or ctx.default_scale)
    a = _embed_coeffs_from_slots(ctx, _slots(ctx, values)) * scale
    res = coeffs_to_rns(a, ctx.q_primes[:ctx.active(level)])
    m = nttm.ntt_fwd(mm.u32_to_i32(res).to(ctx.device), ctx.ntt_q(level))
    return Plaintext(m, level, scale)


def decode_host(ctx: CkksContext, pt: Plaintext) -> np.ndarray:
    """Host big-int oracle: inverse NTT on the device, CRT and the inverse
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


@lru_cache(maxsize=None)
def _sfft_tabs(n: int, device) -> sfft.SfftTables:
    return sfft.build_tables(n, device)


@lru_cache(maxsize=None)
def _compose_tabs(primes: tuple, device) -> compose.SmallComposeTables:
    return compose.build_tables(primes, device)


def _rns_from_f64(a, primes):
    """float64 coefficients (..., n) -> (..., L, n) int32 residues: round
    half to even, the exact int64 value (|a| < 2^63; above 2^53 a float64 is
    an integer already), then reduced per prime."""
    c = torch.round(a).to(mm.I64)
    p = torch.tensor([int(q) for q in primes], dtype=mm.I64, device=a.device)
    return torch.remainder(c[..., None, :], p[:, None]).to(mm.I32)


def encode_batch_rns(n: int, zs: np.ndarray, primes, scale: float, device="cuda") -> torch.Tensor:
    """Batch device encode: (B, n/2) complex slots -> (B, L, n) int32 residues
    (coefficient domain), the float64 special FFT on `device`.  Used by the
    bootstrapping diagonal builder."""
    zs = np.asarray(zs, np.complex128)
    zr = torch.from_numpy(np.ascontiguousarray(zs.real)).to(device)
    zi = torch.from_numpy(np.ascontiguousarray(zs.imag)).to(device)
    a = sfft.embed_from_slots(zr, zi, _sfft_tabs(n, torch.device(device)))
    return _rns_from_f64(a * float(scale), primes)


def encode(ctx: CkksContext, values, scale: Optional[float] = None,
           level: int = 0) -> Plaintext:
    """values: up to n/2 real or complex numbers.  Runs on the context's
    device (float64 special FFT + exact RNS reduction, ops/sfft.py);
    encode_host is the numpy oracle."""
    scale = float(scale or ctx.default_scale)
    primes = ctx.q_primes[:ctx.active(level)]
    res = encode_batch_rns(ctx.n, _slots(ctx, values)[None], primes, scale, ctx.device)[0]
    return Plaintext(nttm.ntt_fwd(res, ctx.ntt_q(level)), level, scale)


def encode_const(ctx: CkksContext, value, scale: float, level: int = 0) -> Plaintext:
    """Exact encode of a constant (all slots equal `value`): the embedding of
    a constant vector is m(X) = a + b·X^(n/2) with a = round(Re v · S),
    b = round(Im v · S) (X^(n/2) evaluates to i on every slot of the 5^j
    half-orbit).  The integers are computed exactly (Fraction), so the
    residues are exact at any scale, past the float64 mantissa too (the
    composite-scale EvalMod's working scale drifts beyond 2^52)."""
    from fractions import Fraction
    v = complex(value)
    S = Fraction(scale)
    a = int(round(Fraction(v.real) * S))
    b = int(round(Fraction(v.imag) * S))
    primes = [int(q) for q in ctx.q_primes[:ctx.active(level)]]
    m = torch.zeros((len(primes), ctx.n), dtype=mm.I32, device=ctx.device)
    m[:, 0] = mm.u32_to_i32([a % q for q in primes]).to(ctx.device)
    if b:
        m[:, ctx.n // 2] = mm.u32_to_i32([b % q for q in primes]).to(ctx.device)
    m_ntt = nttm.ntt_fwd(m, ctx.ntt_q(level))
    return Plaintext(m_ntt, level, float(scale))


def encode_coeff(ctx: CkksContext, values, scale: Optional[float] = None,
                 level: int = 0) -> Plaintext:
    """Coefficient-mode encoding: up to n real values placed directly as
    polynomial coefficients (no canonical embedding), rounded and reduced on
    the context's device."""
    scale = float(scale or ctx.default_scale)
    v = np.zeros(ctx.n, np.float64)
    vv = np.asarray(values, np.float64)
    v[: vv.size] = vv.ravel()
    a = torch.from_numpy(v).to(ctx.device) * scale
    res = _rns_from_f64(a, ctx.q_primes[:ctx.active(level)])
    return Plaintext(nttm.ntt_fwd(res, ctx.ntt_q(level)), level, scale)


def _centered_coeffs(ctx: CkksContext, pt: Plaintext):
    """The exact centered coefficients of pt as float64 (n,) on the device
    (|value| < 2^59)."""
    primes = tuple(int(q) for q in ctx.q_primes[:ctx.active(pt.level)])
    coeffs = nttm.ntt_inv(pt.m, ctx.ntt_q(pt.level))
    return compose.compose_small(coeffs, _compose_tabs(primes, ctx.device))


def decode_coeff(ctx: CkksContext, pt: Plaintext) -> np.ndarray:
    """Coefficient-mode decoding: n real coefficient values (the gamma-pair
    compose on the device)."""
    return (_centered_coeffs(ctx, pt) * (1.0 / pt.scale)).cpu().numpy()


def decode(ctx: CkksContext, pt: Plaintext) -> np.ndarray:
    """Plaintext -> n/2 complex slot values.  Runs on the context's device
    (exact gamma-pair compose + float64 special FFT); decode_host is the
    big-int host oracle."""
    a = _centered_coeffs(ctx, pt) * (1.0 / pt.scale)
    zr, zi = sfft.slots_from_embed(a, _sfft_tabs(ctx.n, ctx.device))
    return zr.cpu().numpy() + 1j * zi.cpu().numpy()


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
    c = ctx.enc_div(nttm.ntt_inv(mm.mont_mul(torch.stack([pk.pk0, pk.pk1]), u, p, rinv),
                                   ctx.ntt_qp))
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


def sub_plain(ctx, a: Ciphertext, pt: Plaintext) -> Ciphertext:
    errors.check_level(a.level, pt.level, "ciphertext/plaintext")
    errors.check_scale(a.scale, pt.scale)
    c0 = mm.sub_mod(a.c[0], pt.m, _p_at(ctx, a.level))
    return Ciphertext(torch.cat([c0[None], a.c[1:]]), a.size, a.level, a.scale)


def multiply(ctx, a: Ciphertext, b: Ciphertext) -> Ciphertext:
    """(2,k,n) x (2,k,n) -> (3,k,n): the NTT-domain tensor product."""
    errors.check_level(a.level, b.level)
    errors.check_size(a.size, 2, "multiply")
    errors.check_size(b.size, 2, "multiply")
    c = polyops.tensor_product(a.c, b.c, _p_at(ctx, a.level))
    return Ciphertext(c, 3, a.level, a.scale * b.scale)


def _mul_plain_core(ctx, c, m, level):
    """c · m pointwise over the level's limbs (NTT domain): the exact product
    mod each prime, as the reference's Montgomery route gives it."""
    return mm.mul_mod(c, m[None], _p_at(ctx, level))


def multiply_plain(ctx, a: Ciphertext, pt: Plaintext) -> Ciphertext:
    errors.check_level(a.level, pt.level, "ciphertext/plaintext")
    return Ciphertext(_mul_plain_core(ctx, a.c, pt.m, a.level),
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


def mod_drop_plain(ctx, pt: Plaintext, levels: int = 1) -> Plaintext:
    ka = ctx.active(pt.level)
    return Plaintext(pt.m[: ka - levels].contiguous(), pt.level + levels, pt.scale)


# =========================================================================
# Relinearize (Method-I or Method-II keyswitch)
# =========================================================================

def _check_key_level(ctx, ka: int, k_gen: int):
    """A key generated at a deeper level (fewer limbs) than the use level
    cannot serve it, under either method."""
    if ka > k_gen:
        raise errors.LevelMismatchError(
            f"key generated at a {k_gen}-limb basis used at a level with "
            f"{ka} active limbs; regenerate the key at level <= "
            f"{ctx.k - k_gen}")


def _key_ring(ctx, kk) -> RingView:
    """Ring view of the basis a key was generated in (read from its shape)."""
    return _ring_at(ctx, ctx.k - (kk.k0.shape[1] - len(ctx.p_primes)))


def _key_slices(ctx, kk, level: int):
    """Both halves of a KSKey or GaloisKeyOne sliced to the level basis:
    ceil(ka/alpha) digits (ka under Method I), the active Q limbs and the
    specials.  The key's own Q extent is read from its shape, so a key made
    at a deeper level slices the same way.  A stripped key's k1 is
    regenerated first (ringkit.ensure_k1: one K7 launch on the card)."""
    ka = ctx.active(level)
    k_gen = kk.k0.shape[1] - len(ctx.p_primes)
    _check_key_level(ctx, ka, k_gen)
    d_lvl = -(-ka // ctx.alpha)
    k1 = ringkit.ensure_k1(lambda: _key_ring(ctx, kk), kk)
    return (ringkit.slice_key_level(kk.k0, ka, k_gen, d_lvl),
            ringkit.slice_key_level(k1, ka, k_gen, d_lvl))


def _keyswitch_poly(ctx, poly_ntt, kk, level):
    """Keyswitch one NTT-domain poly at `level` with the key kk; returns
    (d0, d1) NTT-domain."""
    k0s, k1s = _key_slices(ctx, kk, level)
    if ctx.ks_type == "II":
        return keyswitch2.keyswitch2(
            poly_ntt, k0s, k1s, ctx.ks2[level], ctx.ntt_qp_at(level), ctx.base_qp_at(level),
            in_ntt=True, out_ntt=True, ntt_q_level=ctx.ntt_q(level))
    return ringkit.keyswitch_core(
        poly_ntt, k0s, k1s, ctx.base_qp_at(level), ctx.ntt_qp_at(level), ctx.div_p_at(level),
        in_ntt=True, out_ntt=True, ntt_q=ctx.ntt_q(level))


def relinearize(ctx, a: Ciphertext, rk: KSKey) -> Ciphertext:
    errors.check_size(a.size, 3, "relinearize")
    d0, d1 = _keyswitch_poly(ctx, a.c[2], rk, a.level)
    p = _p_at(ctx, a.level)
    return Ciphertext(mm.add_mod(a.c[:2], torch.stack([d0, d1]), p),
                      2, a.level, a.scale)


# =========================================================================
# Rotation, conjugation and key switching (one keyswitch each)
# =========================================================================

def apply_galois(ctx, a: Ciphertext, gk1: GaloisKeyOne) -> Ciphertext:
    errors.check_size(a.size, 2, "apply_galois")
    p = _p_at(ctx, a.level)
    if gk1.inv_form:
        # sigma applied once to the combined pair: sigma(c0 + KS'(c1)) = sigma(c0) + KS(sigma(c1))
        d0, d1 = _keyswitch_poly(ctx, a.c[1], gk1, a.level)
        out = torch.stack([mm.add_mod(a.c[0], d0, p), d1])
        return Ciphertext(polyops.apply_galois_ntt(out, gk1.perm_ntt), 2, a.level, a.scale)
    g0 = polyops.apply_galois_ntt(a.c[0], gk1.perm_ntt)
    g1 = polyops.apply_galois_ntt(a.c[1], gk1.perm_ntt)
    d0, d1 = _keyswitch_poly(ctx, g1, gk1, a.level)
    return Ciphertext(torch.stack([mm.add_mod(g0, d0, p), d1]), 2, a.level, a.scale)


def rotate(ctx, a: Ciphertext, gk: GaloisKey, step: int) -> Ciphertext:
    """Rotate slots left by `step` using the stored power-of-two key chain."""
    return ringkit.rotate_by_steps(a, gk, step, ctx.n, lambda c, k: apply_galois(ctx, c, k))


def conjugate(ctx, a: Ciphertext, gk: GaloisKey) -> Ciphertext:
    return apply_galois(ctx, a, gk.keys[polyops.GALOIS_CONJ])


def switch_key(ctx, a: Ciphertext, swk: KSKey) -> Ciphertext:
    errors.check_size(a.size, 2, "switch_key")
    d0, d1 = _keyswitch_poly(ctx, a.c[1], swk, a.level)
    p = _p_at(ctx, a.level)
    return Ciphertext(torch.stack([mm.add_mod(a.c[0], d0, p), d1]), 2, a.level, a.scale)


# =========================================================================
# Hoisted rotations (decompose once, rotate many) on the staged kernels
# =========================================================================

def hoist(ctx, a: Ciphertext):
    """The keyswitch digits of a.c[1] over Q̃ (NTT domain, (d̃, ka+p, n)),
    shared by many rotations.  Method I: the per-prime digit broadcast;
    Method II: FastBconv per group (K2 base_conv on the card).  Then the
    forward transform (K1)."""
    errors.check_size(a.size, 2, "hoist")
    lvl = a.level
    if ctx.ks_type != "II":
        return ringkit.hoist_digits(a.c[1], ctx.base_qp_at(lvl), ctx.ntt_qp_at(lvl),
                                    in_ntt=True, ntt_q=ctx.ntt_q(lvl))
    ks2 = ctx.ks2[lvl]
    poly = nttm.ntt_inv(a.c[1], ctx.ntt_q(lvl))
    digs = [conv(poly[g[0]: g[-1] + 1]) for conv, g in zip(ks2.convs, ks2.groups)]
    return nttm.ntt_fwd(torch.stack(digs), ctx.ntt_qp_at(lvl))


def ks_finish_at(ctx, acc, level: int, out_ntt: bool = True):
    """INTT over Q̃ + exact ÷P (one stage under Method I, one per special
    prime under II; one K6 launch on the card) + NTT over Q."""
    div = ctx.ks2[level].div_stages if ctx.ks_type == "II" else ctx.div_p_at(level)
    return ringkit.ks_finish(acc, ctx.ntt_qp_at(level), div, out_ntt, ctx.ntt_q(level))


def rotate_hoisted(ctx, a: Ciphertext, d_ntt, gk1: GaloisKeyOne) -> Ciphertext:
    """sigma_g(a) from digits precomputed by `hoist`."""
    lvl = a.level
    pc0 = p_scale_to_qtilde(ctx, a.c[0], lvl)
    t0, t1 = rotate_hoisted_qtilde(ctx, d_ntt, gk1, pc0, lvl)
    return Ciphertext(ks_finish_at(ctx, torch.stack([t0, t1]), lvl), 2, lvl, a.scale)


def rotate_hoisted_qtilde(ctx, d_ntt, gk1: GaloisKeyOne, pc0, level: int):
    """The P-scaled sigma_g-rotated pair over Q̃ (NTT domain) before ÷P:
    t0 = sigma(P·c0) + MAC0, t1 = MAC1, the MAC on K2 mac_keys on the card.
    pc0 = p_scale_to_qtilde(ctx, c0, level).  inv_form keys MAC the
    unpermuted digits and permute only the pair."""
    base_qp = ctx.base_qp_at(level)
    p = base_qp.col()
    k0s, k1s = _key_slices(ctx, gk1, level)
    if gk1.inv_form:
        acc = rns.mac_keys(d_ntt, k0s, k1s, base_qp)
        t0 = mm.add_mod(acc[0], pc0, p)
        return (polyops.apply_galois_ntt(t0, gk1.perm_ntt),
                polyops.apply_galois_ntt(acc[1], gk1.perm_ntt))
    acc = rns.mac_keys(polyops.apply_galois_ntt(d_ntt, gk1.perm_ntt), k0s, k1s, base_qp)
    return mm.add_mod(acc[0], polyops.apply_galois_ntt(pc0, gk1.perm_ntt), p), acc[1]


def p_scale_to_qtilde(ctx, poly_q, level: int):
    """P·x over the Q̃ basis from x over Q: (P mod q_i) on the Q limbs,
    zeros on the special limbs."""
    qs = ctx.q_primes[:ctx.active(level)]
    P = _prod(int(p) for p in ctx.p_primes)
    fac = torch.tensor([P % int(q) for q in qs], dtype=mm.I64, device=poly_q.device)
    scaled = mm.shoup_mul(poly_q, fac[:, None], _p_at(ctx, level))
    zeros = scaled.new_zeros(poly_q.shape[:-2] + (len(ctx.p_primes), ctx.n))
    return torch.cat([scaled, zeros], dim=-2)


# =========================================================================
# Monomial products
# =========================================================================

def monomial_mult_tables(ctx, k_exp: int):
    """NTT-domain pointwise tables for multiplication by X^k over all QP
    limbs: tab[l, p] = psi_l^((2j+1)k mod 2n) at storage position p (j =
    eval_order[p]), negated past n; and its Shoup companion.  X^(n/2)
    multiplies every slot by i."""
    n = ctx.n
    psi = ctx.ntt_qp.psi.cpu().numpy().view(np.uint32).astype(np.uint64)
    primes = np.asarray(ctx.qp_primes, np.uint64)
    eo = nttm.eval_order(n).astype(np.int64)
    e = ((2 * eo + 1) * (k_exp % (2 * n))) % (2 * n)
    wrap = e >= n
    vals = psi[:, np.where(wrap, e - n, e)]
    vals = np.where(wrap[None, :], primes[:, None] - vals, vals)
    sh = (vals << np.uint64(32)) // primes[:, None]
    return (mm.u32_to_i32(vals.astype(np.uint32)).to(ctx.device),
            mm.u32_to_i32(sh.astype(np.uint32)).to(ctx.device))


def multiply_by_monomial(ctx, a: Ciphertext, tables) -> Ciphertext:
    """Multiply by X^k with tables from monomial_mult_tables (scale-free)."""
    tab = tables[0]
    ka = ctx.active(a.level)
    return Ciphertext(mm.mul_mod(a.c, tab[:ka], _p_at(ctx, a.level)), a.size, a.level, a.scale)


def multiply_power_of_x(ctx: CkksContext, a: Ciphertext, k: int) -> Ciphertext:
    """a · X^k, an NTT-domain pointwise product with the monomial tables."""
    return multiply_by_monomial(ctx, a, monomial_mult_tables(ctx, k))


def print_parameters(ctx: CkksContext):
    """The reference's HEContext::print_parameters analog."""
    total = sum(int(q).bit_length() for q in ctx.q_primes)
    ptotal = sum(int(q).bit_length() for q in ctx.p_primes)
    print(f"/ CKKS parameters\n"
          f"| poly_modulus_degree: {ctx.n} (slots: {ctx.n // 2})\n"
          f"| coeff_modulus: {total}+{ptotal} bits "
          f"({ctx.k} Q + {len(ctx.p_primes)} P primes)\n"
          f"| default scale: 2^{int(math.log2(ctx.default_scale))}\n"
          f"| keyswitching: METHOD_{ctx.ks_type} (alpha={ctx.alpha})\n"
          f"\\ security: {ctx.sec_level}")
