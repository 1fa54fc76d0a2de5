"""BGV scheme, exact integer SIMD over Z_t with the noise in the low bits
(port of heongpu_tpu/models/bgv.py).

The reference's design, on the ring machinery BFV and CKKS share
(models/ringkit.py), with BGV's two twists:

  * the phase is m + t·e: keys and encryption draw t-scaled gaussians
    (ringkit's noise_scale=t) and plaintexts lift as plain centered m;
  * every division (encryption's ÷P, a keyswitch's ÷P, the leveled mod
    switch by q_last) is the t-exact division `rns.DivExactT`: it keeps the
    phase congruent to m mod t up to the factor q_last^-1 mod t, which each
    ciphertext tracks as `factor` and decryption folds out.

Leveled like CKKS (mod_switch where CKKS rescales), coefficient-domain
ciphertexts, Method-I keyswitching with one special prime.  Residues are
int32 tensors on the context's device and the plain path is exact int64
torch arithmetic, so every entry point returns the reference's residues.  On
a CUDA context the transforms run K1, a keyswitch runs K1, K2 `mac_keys` and
K6 in its t-exact mode (one launch for its ÷P), encryption's ÷P and each
mod switch one t-exact K6 launch each, and a seed-expanded key stored
stripped regenerates its uniform half with K7 just before its keyswitch.
"""

from __future__ import annotations

import dataclasses
import math
from functools import reduce
from typing import Optional, Sequence

import numpy as np
import torch

from ..ops import compose, polyops, rns
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
class BgvContext:
    """Precomputed tables for one BGV parameter set, on `device`."""
    n: int
    logn: int
    k: int
    t: int
    q_primes: tuple
    p_primes: tuple
    sec_level: str
    p_inv_t: int                # [P^-1]_t
    device: torch.device
    ntt_qp: nttm.NttTables
    ntt_t: nttm.NttTables
    base_q: rns.Base
    base_qp: rns.Base
    slot_index: torch.Tensor    # (n,) slot j -> NTT storage position
    enc_div: rns.DivRoundChain  # the t-exact ÷P stages over Q·P (encryption; one K6 launch)
    div_p_lvl: tuple            # div_p_lvl[l]: the t-exact ÷P of a keyswitch at level l
    mod_sw: tuple               # mod_sw[l]: the t-exact ÷q_last dropping level l's last limb
    _level_tables: dict = dataclasses.field(default_factory=dict, repr=False)

    def active(self, level: int) -> int:
        return self.k - level

    @property
    def qp_primes(self):
        return tuple(self.q_primes) + tuple(self.p_primes)

    def ntt_q(self, level: int) -> nttm.NttTables:
        return self.ntt_qp.slice_limbs(0, self.active(level))

    def base_q_at(self, level: int) -> rns.Base:
        return self.base_q.take(slice(0, self.active(level)))

    def ntt_qp_at(self, level: int) -> nttm.NttTables:
        """The level's Q limbs and the special limb, contiguous."""
        if level == 0:
            return self.ntt_qp
        key = ("ntt_qp", level)
        if key not in self._level_tables:
            self._level_tables[key] = self.ntt_q(level).concat(
                self.ntt_qp.slice_limbs(self.k, self.k + len(self.p_primes)))
        return self._level_tables[key]

    def base_qp_at(self, level: int) -> rns.Base:
        if level == 0:
            return self.base_qp
        key = ("base_qp", level)
        if key not in self._level_tables:
            ka = self.active(level)
            self._level_tables[key] = self.base_qp.take(
                list(range(ka)) + list(range(self.k, self.k + len(self.p_primes))))
        return self._level_tables[key]

    def compose_tables(self, level: int) -> compose.SmallComposeTables:
        key = ("compose", level)
        if key not in self._level_tables:
            self._level_tables[key] = compose.build_tables(self.q_primes[:self.active(level)],
                                                           self.device)
        return self._level_tables[key]


def make_context(n: int, plain_modulus: int, q_bits: Optional[Sequence[int]] = None,
                 sec_level: str = "none", device="cuda") -> BgvContext:
    """A BGV context: Q primes of `q_bits` (default [29, 29, 29]) and one
    30-bit special prime, generated as the reference generates them (t
    excluded), every table on `device`."""
    device = torch.device(device)
    logn = n.bit_length() - 1
    if (1 << logn) != n:
        raise errors.ParameterError("poly degree must be a power of two")
    t = int(plain_modulus)
    if not (t % (2 * n) == 1 and nt.is_prime(t)):
        raise errors.ParameterError(
            "plain modulus must be an NTT-friendly prime (t = 1 mod 2n)")
    if q_bits is None:
        q_bits = [29, 29, 29]
    q_primes, used = [], {t}
    for b in q_bits:
        pr = nt.generate_ntt_primes(b, 1, n, exclude=used)[0]
        used.add(pr)
        q_primes.append(pr)
    p_primes = nt.generate_ntt_primes(30, 1, n, exclude=used)
    validate_security(n, q_primes + p_primes, sec_level)
    k = len(q_primes)

    # slot j -> NTT storage position (the 5^j orbit and its conjugate half, as BFV)
    m2 = 2 * n
    slot_eval = np.empty(n, np.int64)
    g5 = 1
    for j in range(n // 2):
        slot_eval[j] = (g5 - 1) // 2
        slot_eval[j + n // 2] = (m2 - g5 - 1) // 2
        g5 = g5 * 5 % m2
    slot = nttm.inv_eval_order(n)[slot_eval].astype(np.int64)

    enc_div, remaining = [], list(q_primes) + list(p_primes)
    for sp in reversed(p_primes):
        remaining = remaining[:-1]
        enc_div.append(rns.DivExactT.build(remaining, sp, t, device))
    div_p_lvl = tuple(rns.DivExactT.build(q_primes[:k - lv], p_primes[-1], t, device)
                      for lv in range(k))
    mod_sw = tuple(rns.DivExactT.build(q_primes[:k - lv - 1], q_primes[k - lv - 1], t, device)
                   for lv in range(k - 1))
    return BgvContext(
        n=n, logn=logn, k=k, t=t, q_primes=tuple(q_primes), p_primes=tuple(p_primes),
        sec_level=sec_level, p_inv_t=pow(_prod(p_primes) % t, -1, t), device=device,
        ntt_qp=nttm.build_ntt_tables(q_primes + p_primes, n, device=device),
        ntt_t=nttm.build_ntt_tables([t], n, device=device),
        base_q=rns.Base.build(q_primes, device),
        base_qp=rns.Base.build(q_primes + p_primes, device),
        slot_index=torch.from_numpy(slot).to(device),
        enc_div=rns.DivRoundChain.build(enc_div), div_p_lvl=div_p_lvl, mod_sw=mod_sw)


def _ring(ctx: BgvContext) -> RingView:
    return RingView(ctx.n, ctx.q_primes, ctx.p_primes, ctx.base_q, ctx.base_qp, ctx.ntt_qp,
                    None)


# =========================================================================
# Objects and keys
# =========================================================================

@dataclasses.dataclass(frozen=True, eq=False)
class Ciphertext:
    """Coefficient-domain leveled ciphertext c (size, k - level, n); `factor`
    is the accumulated [Π divisors^-1]_t the phase carries (phase ≡ m·factor
    mod t)."""
    c: torch.Tensor
    size: int
    level: int
    factor: int = 1


def keygen_secret(ctx: BgvContext, key, hamming_weight=None) -> SecretKey:
    return ringkit.keygen_secret(_ring(ctx), key, hamming_weight)


def keygen_public(ctx: BgvContext, key, sk: SecretKey, a_seed=None) -> PublicKey:
    return ringkit.keygen_public(_ring(ctx), key, sk, a_seed=a_seed, noise_scale=ctx.t)


def keygen_relin(ctx: BgvContext, key, sk: SecretKey, a_seed=None) -> KSKey:
    return ringkit.keygen_relin(_ring(ctx), key, sk, a_seed=a_seed, noise_scale=ctx.t)


def keygen_galois(ctx: BgvContext, key, sk: SecretKey, steps=None, max_shift: int = 8,
                  elts=None, a_seed=None, inv_form: bool = False) -> GaloisKey:
    return ringkit.keygen_galois(_ring(ctx), key, sk, steps, max_shift, elts=elts,
                                 a_seed=a_seed, noise_scale=ctx.t, inv_form=inv_form)


def keygen_switch(ctx: BgvContext, key, sk_old: SecretKey, sk_new: SecretKey,
                  a_seed=None) -> KSKey:
    return ringkit.keygen_switch(_ring(ctx), key, sk_old, sk_new, a_seed=a_seed,
                                 noise_scale=ctx.t)


# =========================================================================
# Encoder (BFV's slot map)
# =========================================================================

def encode(ctx: BgvContext, values) -> torch.Tensor:
    """Up to n integers -> plaintext poly (n,) int32 mod t (K1 over t on the
    card)."""
    v = np.asarray(values)
    if v.size > ctx.n:
        raise errors.ParameterError("too many slots")
    buf = np.zeros(ctx.n, np.int64)
    buf[: v.size] = np.asarray(v, np.int64).ravel()
    buf %= ctx.t
    e = torch.zeros(ctx.n, dtype=mm.I32, device=ctx.device)
    e[ctx.slot_index] = torch.from_numpy(buf.astype(np.int32)).to(ctx.device)
    return nttm.ntt_inv(e[None], ctx.ntt_t)[0]


def decode(ctx: BgvContext, plain) -> np.ndarray:
    """Plaintext poly -> the n slot values as numpy uint32."""
    e = nttm.ntt_fwd(plain[None], ctx.ntt_t)[0]
    return e[ctx.slot_index].cpu().numpy().astype(np.uint32)


# =========================================================================
# Encrypt / decrypt
# =========================================================================

def _lift_m(ctx: BgvContext, plain_t, level: int):
    """plain (n,) mod t -> its centered value's residues over the level's Q
    limbs."""
    m = plain_t.to(mm.I64)
    m = torch.where(m > ctx.t // 2, m - ctx.t, m)
    return torch.remainder(m[None], ctx.base_q_at(level).col()).to(mm.I32)


def _scaled(ctx: BgvContext, plain, factor: int):
    """plain · factor mod t."""
    return mm.mul_mod(plain, int(factor), ctx.t)


def encrypt(ctx: BgvContext, pk: PublicKey, plain, key) -> Ciphertext:
    """plain: (n,) mod t (from encode).  The public-key product over Q·P, the
    t-scaled errors, the t-exact ÷P (one K6 launch on the card), then m added
    over Q: the fresh factor is 1."""
    ku, k0, k1 = rng.split(key, 3)
    qp = ctx.base_qp
    u = nttm.ntt_fwd(rng.ternary_rns(ku, ctx.qp_primes, (ctx.n,), ctx.device), ctx.ntt_qp)
    c = nttm.ntt_inv(mm.mont_mul(torch.stack([pk.pk0, pk.pk1]), u, qp.col(), qp.col("rinv")),
                     ctx.ntt_qp)
    e = torch.stack([rng.gaussian_rns(k, ctx.qp_primes, (ctx.n,), ctx.device, noise_scale=ctx.t)
                     for k in (k0, k1)])
    c = ctx.enc_div(mm.add_mod(c, e, qp.col()))
    p = ctx.base_q.col()
    c0 = mm.add_mod(c[0], _lift_m(ctx, plain, 0), p)
    return Ciphertext(torch.stack([c0, c[1]]), 2, 0, 1)


def _phase(ctx: BgvContext, sk: SecretKey, ct: Ciphertext):
    """c0 + c1·s + c2·s^2 + ... over the level's Q limbs, coefficient domain."""
    ka = ctx.active(ct.level)
    tb = ctx.ntt_q(ct.level)
    b = ctx.base_q_at(ct.level)
    p, rinv = b.col(), b.col("rinv")
    s = sk.s_ntt_mont_qp[:ka]
    c_ntt = nttm.ntt_fwd(ct.c[1:], tb)
    cur = s
    out = mm.mont_mul(c_ntt[0], cur, p, rinv)
    for j in range(1, ct.size - 1):
        cur = mm.mont_mul(cur, s, p, rinv)
        out = mm.add_mod(out, mm.mont_mul(c_ntt[j], cur, p, rinv), p)
    return mm.add_mod(ct.c[0], nttm.ntt_inv(out, tb), p)


def decrypt(ctx: BgvContext, sk: SecretKey, ct: Ciphertext) -> torch.Tensor:
    """-> (n,) int32 mod t (feed to decode): [phase]_Q centered mod t, the
    factor folded out."""
    primes = ctx.q_primes[:ctx.active(ct.level)]
    raw = compose.mod_prime_centered(_phase(ctx, sk, ct), primes, ctx.t,
                                     ctx.compose_tables(ct.level))
    return _scaled(ctx, raw, pow(int(ct.factor), -1, ctx.t))


def noise_budget(ctx: BgvContext, sk: SecretKey, ct: Ciphertext) -> float:
    """log2(Q_l / 2|phase|): bits until decryption fails.  As in the
    reference, log2|phase| comes from the fractional CRT sum
    (compose.frac_log2_norm), which resolves a phase down to about Q·2^-44:
    below that the budget reads a floor set by the sum's rounding (about 50
    bits on a fresh ciphertext over four 29-bit primes), whatever the noise."""
    primes = ctx.q_primes[:ctx.active(ct.level)]
    logq = math.log2(_prod(int(q) for q in primes))
    big = float(compose.frac_log2_norm(_phase(ctx, sk, ct), primes, ctx.compose_tables(ct.level)))
    return max(0.0, logq - 1.0 - big)


# =========================================================================
# Arithmetic
# =========================================================================

def _check(a: Ciphertext, b: Ciphertext):
    errors.check_level(a.level, b.level)
    if a.factor != b.factor:
        raise errors.ScaleMismatchError(
            f"BGV correction factors differ ({a.factor} vs {b.factor}); "
            f"align levels the same way on both operands")


def add(ctx, a: Ciphertext, b: Ciphertext) -> Ciphertext:
    _check(a, b)
    return Ciphertext(mm.add_mod(a.c, b.c, ctx.base_q_at(a.level).col()), a.size, a.level,
                      a.factor)


def sub(ctx, a: Ciphertext, b: Ciphertext) -> Ciphertext:
    _check(a, b)
    return Ciphertext(mm.sub_mod(a.c, b.c, ctx.base_q_at(a.level).col()), a.size, a.level,
                      a.factor)


def negate(ctx, a: Ciphertext) -> Ciphertext:
    return Ciphertext(mm.neg_mod(a.c, ctx.base_q_at(a.level).col()), a.size, a.level, a.factor)


def _with_c0(a: Ciphertext, c0) -> Ciphertext:
    return Ciphertext(torch.cat([c0[None], a.c[1:]]), a.size, a.level, a.factor)


def add_plain(ctx, a: Ciphertext, plain) -> Ciphertext:
    """plain: (n,) mod t, scaled by the ciphertext's factor so that the sum
    stays consistent."""
    lift = _lift_m(ctx, _scaled(ctx, plain, a.factor), a.level)
    return _with_c0(a, mm.add_mod(a.c[0], lift, ctx.base_q_at(a.level).col()))


def sub_plain(ctx, a: Ciphertext, plain) -> Ciphertext:
    lift = _lift_m(ctx, _scaled(ctx, plain, a.factor), a.level)
    return _with_c0(a, mm.sub_mod(a.c[0], lift, ctx.base_q_at(a.level).col()))


def multiply_plain(ctx, a: Ciphertext, plain) -> Ciphertext:
    """Pointwise NTT-domain product with the plaintext polynomial (the factor
    is unchanged)."""
    tb = ctx.ntt_q(a.level)
    b = ctx.base_q_at(a.level)
    p, rinv = b.col(), b.col("rinv")
    m_ntt = mm.to_mont(nttm.ntt_fwd(_lift_m(ctx, plain, a.level), tb), p, b.col("r1"))
    out = nttm.ntt_inv(mm.mont_mul(nttm.ntt_fwd(a.c, tb), m_ntt, p, rinv), tb)
    return Ciphertext(out, a.size, a.level, a.factor)


def multiply(ctx, a: Ciphertext, b: Ciphertext) -> Ciphertext:
    """(c0, c1) x (d0, d1) -> 3 polys by the NTT-domain cross product; the
    factors multiply."""
    _check(a, b)
    errors.check_size(a.size, 2, "multiply")
    errors.check_size(b.size, 2, "multiply")
    tb = ctx.ntt_q(a.level)
    base = ctx.base_q_at(a.level)
    p, rinv = base.col(), base.col("rinv")
    A = nttm.ntt_fwd(a.c, tb)
    B = mm.to_mont(nttm.ntt_fwd(b.c, tb), p, base.col("r1"))
    c0 = mm.mont_mul(A[0], B[0], p, rinv)
    c1 = mm.add_mod(mm.mont_mul(A[0], B[1], p, rinv), mm.mont_mul(A[1], B[0], p, rinv), p)
    c2 = mm.mont_mul(A[1], B[1], p, rinv)
    out = nttm.ntt_inv(torch.stack([c0, c1, c2]), tb)
    return Ciphertext(out, 3, a.level, a.factor * b.factor % ctx.t)


def _ks(ctx, poly, kk, level: int):
    """Method-I keyswitch of one coefficient-domain poly at `level` with the
    t-exact ÷P: the digits and their transform (K1), the MAC (K2 mac_keys),
    the inverse transform (K1) and the division (K6, t-exact) on the card.
    A stripped key regenerates its k1 (K7) first."""
    ka = ctx.active(level)
    k1 = ringkit.ensure_k1(_ring(ctx), kk)
    base, tb = ctx.base_qp_at(level), ctx.ntt_qp_at(level)
    d_ntt = ringkit.hoist_digits(poly, base, tb, in_ntt=False)
    acc = ringkit.hoisted_mac(d_ntt, ringkit.slice_key_level(kk.k0, ka, ctx.k),
                              ringkit.slice_key_level(k1, ka, ctx.k), base)
    out = ringkit.ks_finish(acc, tb, ctx.div_p_lvl[level], out_ntt=False)
    return out[0], out[1]


def relinearize(ctx, a: Ciphertext, rk: KSKey) -> Ciphertext:
    errors.check_size(a.size, 3, "relinearize")
    d0, d1 = _ks(ctx, a.c[2], rk, a.level)
    p = ctx.base_q_at(a.level).col()
    return Ciphertext(mm.add_mod(a.c[:2], torch.stack([d0, d1]), p), 2, a.level, a.factor)


def mod_switch(ctx, a: Ciphertext) -> Ciphertext:
    """Drop the last active limb with the t-exact division (one K6 launch on
    the card); the factor takes q_dropped^-1 mod t."""
    if ctx.active(a.level) <= 1:
        raise errors.LevelMismatchError("no limb left to switch away")
    q_dropped = int(ctx.q_primes[ctx.active(a.level) - 1])
    f = a.factor * pow(q_dropped % ctx.t, -1, ctx.t) % ctx.t
    return Ciphertext(ctx.mod_sw[a.level](a.c), a.size, a.level + 1, f)


def apply_galois(ctx, a: Ciphertext, gk1: GaloisKeyOne) -> Ciphertext:
    errors.check_size(a.size, 2, "apply_galois")
    p = ctx.base_q_at(a.level).col()
    src, neg = gk1.perm_coeff_src, gk1.perm_coeff_neg
    if gk1.inv_form:
        d0, d1 = _ks(ctx, a.c[1], gk1, a.level)
        out = torch.stack([mm.add_mod(a.c[0], d0, p), d1])
        return Ciphertext(polyops.apply_galois_coeff(out, src, neg, p), 2, a.level, a.factor)
    g = polyops.apply_galois_coeff(a.c, src, neg, p)
    d0, d1 = _ks(ctx, g[1], gk1, a.level)
    return Ciphertext(torch.stack([mm.add_mod(g[0], d0, p), d1]), 2, a.level, a.factor)


def rotate_rows(ctx, a: Ciphertext, gk: GaloisKey, step: int) -> Ciphertext:
    """Rotate both slot rows by `step`: the step's own key where the set has
    it, else the binary power-of-two chain."""
    g = polyops.steps_to_galois_elt(step, ctx.n)
    if g in gk.keys:
        return apply_galois(ctx, a, gk.keys[g])
    out, remaining, j = a, step % (ctx.n // 2), 0
    while remaining:
        if remaining & 1:
            out = apply_galois(ctx, out, gk.keys[polyops.steps_to_galois_elt(1 << j, ctx.n)])
        remaining >>= 1
        j += 1
    return out


def print_parameters(ctx: BgvContext):
    total = sum(int(q).bit_length() for q in ctx.q_primes)
    print(f"/ BGV parameters\n"
          f"| poly_modulus_degree: {ctx.n}\n"
          f"| coeff_modulus: {total} bits ({ctx.k} Q + "
          f"{len(ctx.p_primes)} P primes)\n"
          f"| plain_modulus: {ctx.t}\n"
          f"\\ security: {ctx.sec_level}")
