"""BFV scheme, exact integer SIMD over Z_t (port of heongpu_tpu/models/bfv.py).

The reference's design, table for table: RNS primes below 2^30, the public
and evaluation keys over Q·P in the NTT domain and in Montgomery form (so
every table that the reference holds in Montgomery form is held so here, and
the plain path multiplies it with `mm.mont_mul`), the BEHZ ciphertext
multiply over the auxiliary base Bsk = B ∪ {m_sk} with the power-of-two
m̃ = 2^16 row, and decryption by the {t, γ} scaled remainder.  Keyswitching
is Method I (one digit per Q prime, one special prime; the default) or
Method II (digits of alpha grouped primes).

Residues are int32 tensors on the context's device and the plain path is
exact int64 torch arithmetic, so every entry point returns the reference's
residues.  Where the reference works in wrapping uint32 words (the m̃ row,
the plaintext lift's exact quotient, the 64-bit sums of decryption and of
the Shenoy-Kumaresan correction) the port computes the same value exactly in
int64.  On a CUDA context the transforms run K1 (over Q, Q·P, Bsk and the
1-row plaintext table over t), the base conversions q -> Bsk and B -> q run
K2 `base_conv`, a Method-I keyswitch runs K1 and K2 `mac_keys`, and a
Method-II keyswitch of one poly runs K5; the rest is plain torch.

Plaintexts are (n,) int32 tensors mod t.  Ciphertexts are in the
coefficient domain unless `in_ntt`.  Seed-expanded keys (`a_seed`) are
made and used as in ringkit: a stripped key regenerates its k1 (K7 on the
card) just before the keyswitch that uses it.
"""

from __future__ import annotations

import dataclasses
import math
from functools import reduce
from typing import Optional, Sequence

import numpy as np
import torch

from ..ops import compose, keyswitch2, polyops, rns
from ..ops import modmath as mm
from ..ops import ntt as nttm
from ..utils import errors, nt, rng
from ..utils.params import default_coeff_modulus, validate_security
from . import ringkit
from .ringkit import GaloisKey, GaloisKeyOne, KSKey, PublicKey, RingView, SecretKey

RelinKey = KSKey  # the reference API's name

_prod = lambda xs: reduce(lambda a, b: a * b, xs, 1)
I64 = mm.I64


# =========================================================================
# Context
# =========================================================================

@dataclasses.dataclass(frozen=True, eq=False)
class BfvContext:
    """Precomputed tables for one BFV parameter set, on `device`.  Per-limb
    tables are int32 tensors; scalars mod t, γ, m̃ or m_sk are ints."""
    n: int
    logn: int
    k: int                     # number of Q primes
    t: int                     # plain modulus
    gamma: int
    mt_bits: int               # m̃ = 2^mt_bits
    bsk_k: int                 # number of B primes (Bsk = B + m_sk)
    q_primes: tuple
    p_primes: tuple
    bsk_primes: tuple          # B primes + (m_sk,)
    sec_level: str
    ks_type: str
    alpha: int
    device: torch.device
    # NTT / base tables
    ntt_qp: nttm.NttTables     # over Q ∪ P
    ntt_q: nttm.NttTables      # its first k limbs
    ntt_t: nttm.NttTables      # over [t] (the encoder)
    base_q: rns.Base
    base_qp: rns.Base
    # plaintext lift (encrypt, add_plain): round(Q·m/t)
    delta_mont: torch.Tensor   # (k,) Δ = floor(Q/t) mod q_i, Montgomery form
    q_mod_t: int
    half_t: int
    # {t, γ} decryption
    gt_qhatinv_mont: torch.Tensor  # (k,) [γt(Q/q_i)^-1]_{q_i}, Montgomery form
    gt_half_qhatinv: torch.Tensor  # (k,) [floor(Q/2)(Q/q_i)^-1]_{q_i}
    dec_mat_mont: torch.Tensor     # (k, 2) [-(Q/q_i)Q^-1]_s, s in {t, γ}, Montgomery form
    dec_off: torch.Tensor          # (2,) [floor(Q/2) Q^-1]_s
    gamma_inv_t: int
    # keyswitch P-drop
    div_p: rns.DivRoundLastq
    enc_div: rns.DivRoundChain  # sequential ÷p stages over Q·P (encrypt; one K6 launch)
    ks2: tuple                 # (KS2Level,) under Method II, else ()
    # encoder slot map
    slot_index: torch.Tensor   # (n,) int64 NTT-domain position of slot j
    # BEHZ multiply
    ntt_bsk: nttm.NttTables        # over Bsk
    conv_q_bsk: rns.BaseConv       # q -> Bsk
    conv_q_mt_mat: torch.Tensor    # (k,) [Q/q_i]_{m̃}
    neg_qinv_mt: int               # [-Q^-1]_{m̃}
    mt_inv_bsk: torch.Tensor       # (k_bsk+1,) m̃^-1 mod b
    q_mod_bsk_mont: torch.Tensor   # (k_bsk+1,) Q mod b, Montgomery form
    t_mont_qbsk: torch.Tensor      # (k + k_bsk+1,) t in Montgomery form per limb
    qinv_bsk: torch.Tensor         # (k_bsk+1,) Q^-1 mod b
    conv_b_q: rns.BaseConv         # B -> q (Shenoy-Kumaresan main part)
    conv_b_msk_mat: torch.Tensor   # (k_bsk,) [B/b]_{m_sk}, Montgomery form
    binv_msk: int                  # B^-1 mod m_sk
    b_mod_q: torch.Tensor          # (k,) B mod q_j
    msk_half: int                  # floor(m_sk/2)

    @property
    def qp_primes(self):
        return tuple(self.q_primes) + tuple(self.p_primes)


def make_context(n: int,
                 plain_modulus: int,
                 q_bits: Optional[Sequence[int]] = None,
                 q_primes: Optional[Sequence[int]] = None,
                 sec_level: str = "none",
                 ks_type: str = "I",
                 alpha: int = 1,
                 device="cuda") -> BfvContext:
    """A BFV context.  `q_bits` like [29, 29, 29] (no special prime), or
    `q_primes`, or neither: the default chain (params.default_coeff_modulus,
    the tc128 budget filled with 29-bit primes).  `alpha` 30-bit special
    primes are appended; Method I forces alpha to 1.  Prime generation and
    every table follow the reference exactly; the tables are built on
    `device`."""
    if ks_type not in ("I", "II"):
        raise errors.ParameterError(f"unknown keyswitching method {ks_type!r} (use 'I' or 'II')")
    device = torch.device(device)
    logn = n.bit_length() - 1
    assert 1 << logn == n
    if ks_type == "I":
        alpha = 1

    if q_primes is None:
        if q_bits is None:
            q_primes = default_coeff_modulus(n, sec_level)
        else:
            q_primes = []
            used = set()
            for b in q_bits:
                pr = nt.generate_ntt_primes(b, 1, n, exclude=used)[0]
                used.add(pr)
                q_primes.append(pr)
    q_primes = [int(q) for q in q_primes]
    used = set(q_primes)
    p_primes = nt.generate_ntt_primes(30, alpha, n, exclude=used)
    used |= set(p_primes)
    validate_security(n, q_primes + p_primes, sec_level)

    t = int(plain_modulus)
    if not (t % (2 * n) == 1 and nt.is_prime(t)):
        raise errors.ParameterError(
            "plain modulus must be an NTT-friendly prime (t = 1 mod 2n) "
            "for batching; use params.plain_modulus_for(n, bits)")
    if t >= min(q_primes):
        raise errors.ParameterError("plain modulus must be below every Q prime")
    k = len(q_primes)
    Q = _prod(q_primes)

    # gamma for decryption: a prime coprime to t and Q, ~2^29
    gamma = nt.generate_ntt_primes(29, 1, n, exclude=used | {t})[0]
    used.add(gamma)

    # BEHZ auxiliary base: B primes (enough to hold N·t·4·Q) + m_sk
    extra_bits = logn + t.bit_length() + 3
    bsk_b = k + max(1, math.ceil(extra_bits / 29))
    bsk_primes = nt.generate_ntt_primes(30, bsk_b, n, exclude=used)
    used |= set(bsk_primes)
    m_sk = nt.generate_ntt_primes(29, 1, n, exclude=used)[0]
    bsk_all = list(bsk_primes) + [m_sk]
    mt_bits = 16
    mt = 1 << mt_bits
    qp = q_primes + p_primes
    B = _prod(bsk_primes)

    i32 = lambda vals: mm.u32_to_i32(vals).to(device)
    mont = lambda vals, ps: i32([v * (1 << 32) % p for v, p in zip(vals, ps)])

    qh = [Q // qi for qi in q_primes]
    qh_inv = [pow(h, -1, qi) for h, qi in zip(qh, q_primes)]
    half_q = Q // 2
    gt = gamma * t
    dec_mat = np.empty((k, 2), np.uint32)
    for i in range(k):
        for si, s in enumerate((t, gamma)):
            dec_mat[i, si] = (-(qh[i] % s) * pow(Q % s, -1, s)) % s * (1 << 32) % s

    # slot j -> NTT storage position (the 5^j orbit and its conjugate half)
    m2 = 2 * n
    slot_eval = np.empty(n, np.int64)
    g5 = 1
    for j in range(n // 2):
        slot_eval[j] = (g5 - 1) // 2
        slot_eval[j + n // 2] = (m2 - g5 - 1) // 2
        g5 = g5 * 5 % m2
    slot_index = nttm.inv_eval_order(n)[slot_eval].astype(np.int64)

    ks2 = ()
    if ks_type == "II":
        ks2 = (keyswitch2.build_ks2_level(q_primes, p_primes, k, alpha, device),)
    ntt_qp = nttm.build_ntt_tables(qp, n, device=device)

    return BfvContext(
        n=n, logn=logn, k=k, t=t, gamma=gamma, mt_bits=mt_bits, bsk_k=bsk_b,
        q_primes=tuple(q_primes), p_primes=tuple(p_primes), bsk_primes=tuple(bsk_all),
        sec_level=sec_level, ks_type=ks_type, alpha=alpha, device=device,
        ntt_qp=ntt_qp, ntt_q=ntt_qp.slice_limbs(0, k),
        ntt_t=nttm.build_ntt_tables([t], n, device=device),
        base_q=rns.Base.build(q_primes, device), base_qp=rns.Base.build(qp, device),
        delta_mont=mont([Q // t % qi for qi in q_primes], q_primes),
        q_mod_t=Q % t, half_t=t // 2,
        gt_qhatinv_mont=mont([gt % qi * hi % qi for qi, hi in zip(q_primes, qh_inv)], q_primes),
        gt_half_qhatinv=i32([half_q % qi * hi % qi for qi, hi in zip(q_primes, qh_inv)]),
        dec_mat_mont=i32(dec_mat),
        dec_off=i32([half_q % s * pow(Q % s, -1, s) % s for s in (t, gamma)]),
        gamma_inv_t=pow(gamma % t, -1, t),
        div_p=rns.DivRoundLastq.build(q_primes, p_primes[0], device),
        enc_div=keyswitch2.div_chain(q_primes, p_primes, device), ks2=ks2,
        slot_index=torch.from_numpy(slot_index).to(device),
        ntt_bsk=nttm.build_ntt_tables(bsk_all, n, device=device),
        conv_q_bsk=rns.BaseConv.build(q_primes, bsk_all, device),
        conv_q_mt_mat=i32([qi_hat % mt for qi_hat in qh]),
        neg_qinv_mt=(-pow(Q % mt, -1, mt)) % mt,
        mt_inv_bsk=i32([pow(mt, -1, b) for b in bsk_all]),
        q_mod_bsk_mont=mont([Q % b for b in bsk_all], bsk_all),
        t_mont_qbsk=mont([t % p for p in q_primes + bsk_all], q_primes + bsk_all),
        qinv_bsk=i32([pow(Q % b, -1, b) for b in bsk_all]),
        conv_b_q=rns.BaseConv.build(list(bsk_primes), q_primes, device),
        conv_b_msk_mat=i32([(B // b) % m_sk * (1 << 32) % m_sk for b in bsk_primes]),
        binv_msk=pow(B % m_sk, -1, m_sk),
        b_mod_q=i32([B % qj for qj in q_primes]),
        msk_half=m_sk // 2,
    )


@dataclasses.dataclass(frozen=True, eq=False)
class Ciphertext:
    c: torch.Tensor  # (size, k, n) int32, coefficient domain unless in_ntt
    size: int
    in_ntt: bool


def _col(t):
    """A per-limb table as an int64 (L, 1) column."""
    return t.to(I64)[:, None]


# =========================================================================
# Encoder (batched slots over Z_t)
# =========================================================================

def encode(ctx: BfvContext, values) -> torch.Tensor:
    """Up to n integers (signed allowed) -> plaintext poly (n,) int32 mod t:
    the slots placed at their NTT positions, then the inverse transform over
    t (K1 on the card)."""
    v = np.asarray(values)
    if v.size > ctx.n:
        raise ValueError(f"{v.size} values do not fit {ctx.n} slots")
    buf = np.zeros(ctx.n, np.int64)
    buf[: v.size] = v.ravel()
    buf %= ctx.t
    e = torch.zeros(ctx.n, dtype=mm.I32, device=ctx.device)
    e[ctx.slot_index] = torch.from_numpy(buf.astype(np.int32)).to(ctx.device)
    return nttm.ntt_inv(e[None], ctx.ntt_t)[0]


def decode(ctx: BfvContext, plain) -> np.ndarray:
    """Plaintext poly -> the n slot values as numpy uint32."""
    e = nttm.ntt_fwd(plain[None], ctx.ntt_t)[0]
    return e[ctx.slot_index].cpu().numpy().astype(np.uint32)


def decode_signed(ctx: BfvContext, plain) -> np.ndarray:
    """Slots as centered signed integers in [-t/2, t/2)."""
    v = decode(ctx, plain).astype(np.int64)
    return np.where(v > (ctx.t - 1) // 2, v - ctx.t, v)


# =========================================================================
# Keygen (ringkit on the context's ring)
# =========================================================================

def _ring(ctx: BfvContext) -> RingView:
    return RingView(ctx.n, ctx.q_primes, ctx.p_primes, ctx.base_q, ctx.base_qp,
                    ctx.ntt_qp, ctx.div_p)


def _groups(ctx: BfvContext):
    if ctx.ks_type == "II":
        return tuple(tuple(range(j, min(j + ctx.alpha, ctx.k)))
                     for j in range(0, ctx.k, ctx.alpha))
    return None


def keygen_secret(ctx: BfvContext, key, hamming_weight=None) -> SecretKey:
    return ringkit.keygen_secret(_ring(ctx), key, hamming_weight)


def keygen_public(ctx: BfvContext, key, sk: SecretKey, a_seed=None) -> PublicKey:
    return ringkit.keygen_public(_ring(ctx), key, sk, a_seed=a_seed)


def keygen_relin(ctx: BfvContext, key, sk: SecretKey, a_seed=None) -> KSKey:
    return ringkit.keygen_relin(_ring(ctx), key, sk, groups=_groups(ctx), a_seed=a_seed)


def keygen_galois(ctx: BfvContext, key, sk: SecretKey, steps=None, max_shift: int = 8,
                  elts=None, a_seed=None, inv_form: bool = False) -> GaloisKey:
    return ringkit.keygen_galois(_ring(ctx), key, sk, steps, max_shift, groups=_groups(ctx),
                                 elts=elts, a_seed=a_seed, inv_form=inv_form)


def keygen_switch(ctx: BfvContext, key, sk_old: SecretKey, sk_new: SecretKey) -> KSKey:
    return ringkit.keygen_switch(_ring(ctx), key, sk_old, sk_new, groups=_groups(ctx))


# =========================================================================
# Encrypt / decrypt
# =========================================================================

def _plain_lift(ctx: BfvContext, m):
    """round(Q·m/t) over the Q limbs: Δ·m + floor(((Q mod t)·m + floor(t/2))/t)
    (the reference's exact quotient by uint32 wrap, here an int64 division;
    the second term is below t < q_i)."""
    qb = ctx.base_q
    p = qb.col()
    dm = mm.mont_mul(m[None, :], _col(ctx.delta_mont), p, qb.col("rinv"))
    fix = torch.div(m.to(I64) * ctx.q_mod_t + ctx.half_t, ctx.t, rounding_mode="floor")
    return mm.add_mod(dm, fix[None, :], p)


def encrypt(ctx: BfvContext, pk: PublicKey, plain, key) -> Ciphertext:
    """plain: (n,) int32 mod t.  Draw order as in the reference: ternary u,
    then e0, then e1."""
    ku, k0, k1 = rng.split(key, 3)
    qp = ctx.base_qp
    u = nttm.ntt_fwd(rng.ternary_rns(ku, ctx.qp_primes, (ctx.n,), ctx.device), ctx.ntt_qp)
    c = ctx.enc_div(nttm.ntt_inv(
        mm.mont_mul(torch.stack([pk.pk0, pk.pk1]), u, qp.col(), qp.col("rinv")), ctx.ntt_qp))
    e = torch.stack([rng.gaussian_rns(k0, ctx.q_primes, (ctx.n,), ctx.device),
                     rng.gaussian_rns(k1, ctx.q_primes, (ctx.n,), ctx.device)])
    p = ctx.base_q.col()
    c = mm.add_mod(c, e, p)
    c0 = mm.add_mod(c[0], _plain_lift(ctx, plain), p)
    return Ciphertext(torch.stack([c0, c[1]]), 2, False)


def _ct_dot_sk(ctx: BfvContext, ct: Ciphertext, sk: SecretKey):
    """c0 + c1·s (+ c2·s^2) mod Q, coefficient domain."""
    qb = ctx.base_q
    p, rinv = qb.col(), qb.col("rinv")
    s = sk.s_ntt_mont_qp[: ctx.k]
    c_ntt = nttm.ntt_fwd(ct.c[1:], ctx.ntt_q)
    acc = mm.mont_mul(c_ntt[0], s, p, rinv)
    if ct.size == 3:
        s2 = mm.mont_mul(s, s, p, rinv)
        acc = mm.add_mod(acc, mm.mont_mul(c_ntt[1], s2, p, rinv), p)
    return mm.add_mod(ct.c[0], nttm.ntt_inv(acc, ctx.ntt_q), p)


def decrypt(ctx: BfvContext, sk: SecretKey, ct: Ciphertext) -> torch.Tensor:
    """Plaintext poly (n,) mod t by the {t, γ} scaled remainder."""
    return decrypt_phase(ctx, _ct_dot_sk(ctx, ct, sk))


def decrypt_phase(ctx: BfvContext, y) -> torch.Tensor:
    """round(t·y/Q) mod t of a phase y = c0 + c1·s (+ c2·s^2) mod Q, (k, n)
    in the coefficient domain, by the {t, γ} scaled remainder: decryption's
    last step, which MPC's fuse runs on c0 plus the parties' shares."""
    qb = ctx.base_q
    p = qb.col()
    z = mm.add_mod(mm.mont_mul(y, _col(ctx.gt_qhatinv_mont), p, qb.col("rinv")),
                   _col(ctx.gt_half_qhatinv), p)
    # (k,) x (k, 2) -> (2,) over {t, γ}: exact products, an exact int64 sum
    t, g = ctx.t, ctx.gamma
    s = torch.tensor([[t], [g]], dtype=I64, device=ctx.device)
    s_rinv = torch.tensor([[mm.mont_rinv(t)], [mm.mont_rinv(g)]], dtype=I64, device=ctx.device)
    terms = mm.mont_mul(z[:, None, :], ctx.dec_mat_mont.to(I64)[:, :, None], s, s_rinv)
    w = torch.remainder(rns.sum_u32_axis64(terms, axis=0) + _col(ctx.dec_off), s)
    w_t, w_g = w[0], w[1]
    # center w_g mod γ, fold into w_t
    neg = w_g > (g >> 1)
    mag_t = torch.remainder(torch.where(neg, g - w_g, w_g), t)
    diff = torch.remainder(torch.where(neg, w_t + mag_t, w_t - mag_t), t)
    return mm.mul_mod(diff, ctx.gamma_inv_t, t)


def noise_budget(ctx: BfvContext, sk: SecretKey, ct: Ciphertext) -> float:
    """Bits of remaining noise budget: the log-magnitude of the largest
    coefficient of [y - round(Q·m/t)]_Q, from the fractional CRT sum while it
    is large (compose.frac_log2_norm), from the exact compose once it is
    small (compose.compose_small; the reference's df64 value as float64)."""
    y = _ct_dot_sk(ctx, ct, sk)
    diff = mm.sub_mod(y, _plain_lift(ctx, decrypt(ctx, sk, ct)), ctx.base_q.col())
    primes = tuple(int(q) for q in ctx.q_primes)
    tabs = compose.build_tables(primes, ctx.device)
    logq = math.log2(_prod(primes))
    big = float(compose.frac_log2_norm(diff, primes, tabs))
    if big > logq - 44:
        return max(0.0, logq - 1.0 - big)
    max_norm = float(torch.max(torch.abs(compose.compose_small(diff, tabs))))
    if max_norm == 0:
        return float(logq - 1.0)
    return max(0.0, logq - 1.0 - math.log2(max_norm))


# =========================================================================
# Arithmetic
# =========================================================================

def add(ctx: BfvContext, a: Ciphertext, b: Ciphertext) -> Ciphertext:
    errors.check_size(b.size, a.size, "add")
    return Ciphertext(mm.add_mod(a.c, b.c, ctx.base_q.col()), a.size, a.in_ntt)


def sub(ctx: BfvContext, a: Ciphertext, b: Ciphertext) -> Ciphertext:
    errors.check_size(b.size, a.size, "sub")
    return Ciphertext(mm.sub_mod(a.c, b.c, ctx.base_q.col()), a.size, a.in_ntt)


def negate(ctx: BfvContext, a: Ciphertext) -> Ciphertext:
    return Ciphertext(mm.neg_mod(a.c, ctx.base_q.col()), a.size, a.in_ntt)


def add_plain(ctx: BfvContext, a: Ciphertext, plain) -> Ciphertext:
    c0 = mm.add_mod(a.c[0], _plain_lift(ctx, plain), ctx.base_q.col())
    return Ciphertext(torch.cat([c0[None], a.c[1:]]), a.size, False)


def sub_plain(ctx: BfvContext, a: Ciphertext, plain) -> Ciphertext:
    c0 = mm.sub_mod(a.c[0], _plain_lift(ctx, plain), ctx.base_q.col())
    return Ciphertext(torch.cat([c0[None], a.c[1:]]), a.size, False)


def multiply_plain(ctx: BfvContext, a: Ciphertext, plain) -> Ciphertext:
    """ct × encoded plaintext: pointwise in the NTT domain over Q."""
    p = ctx.base_q.col()
    m_ntt = nttm.ntt_fwd(torch.remainder(plain.to(I64)[None, :], p).to(mm.I32), ctx.ntt_q)
    prod = mm.mul_mod(nttm.ntt_fwd(a.c, ctx.ntt_q), m_ntt[None], p)
    return Ciphertext(nttm.ntt_inv(prod, ctx.ntt_q), a.size, False)


def _behz_lift_to_bsk(ctx: BfvContext, x):
    """[x]_q -> a representative of x in Bsk (SmMRq'), x: (..., k, n)."""
    mt = 1 << ctx.mt_bits
    conv = ctx.conv_q_bsk
    z = conv.scaled_digits(mm.mul_mod(x, mt, ctx.base_q.col()))
    x_bsk = conv.convert_from_digits(z)                      # (..., k_bsk+1, n)
    # the m̃ row: a power-of-two modulus, exact products masked to mt_bits
    x_mt = (z.to(I64) * _col(ctx.conv_q_mt_mat)).sum(dim=-2) & (mt - 1)
    r = (x_mt * ctx.neg_qinv_mt) & (mt - 1)                  # [-x/Q]_m̃
    # center r, then x'' = (x' + Q·r) · m̃^-1 mod b
    r_neg = r > mt // 2
    r_mag = torch.where(r_neg, mt - r, r)
    ob = conv.obase
    pb = ob.col()
    q_r = mm.mont_mul(r_mag[..., None, :], _col(ctx.q_mod_bsk_mont), pb, ob.col("rinv"))
    x_corr = torch.where(r_neg[..., None, :], mm.sub_mod(x_bsk, q_r, pb),
                         mm.add_mod(x_bsk, q_r, pb))
    return mm.mul_mod(x_corr, _col(ctx.mt_inv_bsk), pb)


def _behz_scale_floor(ctx: BfvContext, u_q, u_bsk):
    """floor(t·u/Q) in Bsk, given u over q and over Bsk."""
    kq = ctx.k
    qb, ob = ctx.base_q, ctx.conv_q_bsk.obase
    pb = ob.col()
    t_mont = _col(ctx.t_mont_qbsk)
    tu_q = mm.mont_mul(u_q, t_mont[:kq], qb.col(), qb.col("rinv"))
    tu_b = mm.mont_mul(u_bsk, t_mont[kq:], pb, ob.col("rinv"))
    num = mm.sub_mod(tu_b, ctx.conv_q_bsk(tu_q), pb)         # [tu]_q lifted to Bsk (+αQ)
    return mm.mul_mod(num, _col(ctx.qinv_bsk), pb)


def _behz_bsk_to_q(ctx: BfvContext, w):
    """The exact Shenoy-Kumaresan conversion Bsk -> q, w: (..., k_bsk+1, n)."""
    kb = ctx.bsk_k
    w_b, w_msk = w[..., :kb, :], w[..., kb, :]
    z = ctx.conv_b_q.scaled_digits(w_b)       # also read by the m_sk row below
    w_q = ctx.conv_b_q.convert_from_digits(z)                # (..., k, n)
    # alpha_sk = [(conv_msk - w_msk) · B^-1]_{m_sk}, centered
    msk = int(ctx.bsk_primes[-1])
    terms = mm.mont_mul(z, _col(ctx.conv_b_msk_mat), msk, mm.mont_rinv(msk))
    conv_msk = torch.remainder(rns.sum_u32_axis64(terms, axis=-2), msk)
    alpha = torch.remainder((conv_msk - w_msk) * ctx.binv_msk, msk)
    a_neg = alpha > ctx.msk_half
    a_mag = torch.where(a_neg, msk - alpha, alpha)
    p = ctx.base_q.col()
    corr = mm.mul_mod(torch.remainder(a_mag[..., None, :], p), _col(ctx.b_mod_q), p)
    return torch.where(a_neg[..., None, :], mm.add_mod(w_q, corr, p), mm.sub_mod(w_q, corr, p))


def multiply(ctx: BfvContext, a: Ciphertext, b: Ciphertext) -> Ciphertext:
    """BEHZ ct × ct: (2-poly) × (2-poly) -> 3-poly; relinearize after."""
    errors.check_size(a.size, 2, "multiply")
    errors.check_size(b.size, 2, "multiply")
    a_bsk = _behz_lift_to_bsk(ctx, a.c)
    b_bsk = _behz_lift_to_bsk(ctx, b.c)
    a_q = nttm.ntt_fwd(a.c, ctx.ntt_q)
    b_q = nttm.ntt_fwd(b.c, ctx.ntt_q)
    a_b = nttm.ntt_fwd(a_bsk, ctx.ntt_bsk)
    b_b = nttm.ntt_fwd(b_bsk, ctx.ntt_bsk)
    u_q = nttm.ntt_inv(polyops.tensor_product(a_q, b_q, ctx.base_q.col()), ctx.ntt_q)
    u_bsk = nttm.ntt_inv(polyops.tensor_product(a_b, b_b, ctx.conv_q_bsk.obase.col()),
                         ctx.ntt_bsk)
    w = _behz_scale_floor(ctx, u_q, u_bsk)
    return Ciphertext(_behz_bsk_to_q(ctx, w), 3, False)


# =========================================================================
# Keyswitch-based ops
# =========================================================================

def _ks_dispatch(ctx: BfvContext, poly_q, kk):
    """Keyswitch one coefficient-domain poly over Q with key kk (a KSKey or
    GaloisKeyOne): Method I's keyswitch_core or Method II's keyswitch2.  A
    stripped seeded key regenerates its k1 first (ringkit.ensure_k1)."""
    k1 = ringkit.ensure_k1(_ring(ctx), kk)
    if ctx.ks_type == "II":
        return keyswitch2.keyswitch2(poly_q, kk.k0, k1, ctx.ks2[0], ctx.ntt_qp, ctx.base_qp,
                                     in_ntt=False, out_ntt=False, ntt_q_level=ctx.ntt_q)
    return ringkit.keyswitch_core(poly_q, kk.k0, k1, ctx.base_qp, ctx.ntt_qp, ctx.div_p,
                                  in_ntt=False, out_ntt=False)


def relinearize(ctx: BfvContext, ct: Ciphertext, rk: RelinKey) -> Ciphertext:
    errors.check_size(ct.size, 3, "relinearize")
    d0, d1 = _ks_dispatch(ctx, ct.c[2], rk)
    return Ciphertext(mm.add_mod(ct.c[:2], torch.stack([d0, d1]), ctx.base_q.col()), 2, False)


def apply_galois(ctx: BfvContext, ct: Ciphertext, gk1: GaloisKeyOne) -> Ciphertext:
    errors.check_size(ct.size, 2, "apply_galois")
    p = ctx.base_q.col()
    src, neg = gk1.perm_coeff_src, gk1.perm_coeff_neg
    if gk1.inv_form:
        # sigma once on the combined pair: sigma(c0 + KS'(c1)) = sigma(c0) + KS(sigma(c1))
        d0, d1 = _ks_dispatch(ctx, ct.c[1], gk1)
        out = torch.stack([mm.add_mod(ct.c[0], d0, p), d1])
        return Ciphertext(polyops.apply_galois_coeff(out, src, neg, p), 2, False)
    g = polyops.apply_galois_coeff(ct.c, src, neg, p)
    d0, d1 = _ks_dispatch(ctx, g[1], gk1)
    return Ciphertext(torch.stack([mm.add_mod(g[0], d0, p), d1]), 2, False)


def rotate_rows(ctx: BfvContext, ct: Ciphertext, gk: GaloisKey, step: int) -> Ciphertext:
    """Rotate the row slots by `step` (power-of-two walk over the stored keys)."""
    return ringkit.rotate_by_steps(ct, gk, step, ctx.n, lambda c, k: apply_galois(ctx, c, k))


def rotate_columns(ctx: BfvContext, ct: Ciphertext, gk: GaloisKey) -> Ciphertext:
    return apply_galois(ctx, ct, gk.keys[polyops.GALOIS_CONJ])


def switch_key(ctx: BfvContext, ct: Ciphertext, swk: RelinKey) -> Ciphertext:
    """Re-encrypt a size-2 ct from the old key to the new (swk encrypts s_old)."""
    errors.check_size(ct.size, 2, "switch_key")
    d0, d1 = _ks_dispatch(ctx, ct.c[1], swk)
    return Ciphertext(torch.stack([mm.add_mod(ct.c[0], d0, ctx.base_q.col()), d1]), 2, False)


def multiply_power_of_x(ctx: BfvContext, ct: Ciphertext, k: int) -> Ciphertext:
    """ct · X^k (negacyclic monomial product, coefficient domain)."""
    errors.check_ntt_domain(ct.in_ntt, False, "multiply_power_of_x")
    src, neg = polyops.negacyclic_shift_tables(k, ctx.n, ctx.device)
    return Ciphertext(polyops.negacyclic_shift(ct.c, src, neg, ctx.base_q.col()), ct.size, False)


def transform_to_ntt(ctx: BfvContext, ct: Ciphertext) -> Ciphertext:
    """Coefficient -> NTT domain."""
    errors.check_ntt_domain(ct.in_ntt, False, "transform_to_ntt")
    return Ciphertext(nttm.ntt_fwd(ct.c, ctx.ntt_q), ct.size, True)


def transform_from_ntt(ctx: BfvContext, ct: Ciphertext) -> Ciphertext:
    errors.check_ntt_domain(ct.in_ntt, True, "transform_from_ntt")
    return Ciphertext(nttm.ntt_inv(ct.c, ctx.ntt_q), ct.size, False)


def print_parameters(ctx: BfvContext):
    """The reference's HEContext::print_parameters analog."""
    total = sum(int(q).bit_length() for q in ctx.q_primes)
    ptotal = sum(int(q).bit_length() for q in ctx.p_primes)
    print(f"/ BFV parameters\n"
          f"| poly_modulus_degree: {ctx.n}\n"
          f"| coeff_modulus: {total}+{ptotal} bits "
          f"({len(ctx.q_primes)} Q + {len(ctx.p_primes)} P primes)\n"
          f"| plain_modulus: {ctx.t}\n"
          f"| keyswitching: METHOD_{ctx.ks_type} (alpha={ctx.alpha})\n"
          f"\\ security: {ctx.sec_level}")


# =========================================================================
# Hoisted rotations (decompose once, rotate many)
# =========================================================================

def hoist(ctx: BfvContext, ct: Ciphertext):
    """The keyswitch digits of ct.c[1] over Q·P (NTT domain) shared by many
    rotations.  Method I: the per-prime broadcast digits; Method II: the
    grouped FastBconv digits (K2 base_conv on the card)."""
    errors.check_size(ct.size, 2, "hoist")
    errors.check_ntt_domain(ct.in_ntt, False, "hoist")
    if ctx.ks_type == "II":
        ks2 = ctx.ks2[0]
        digs = [conv(ct.c[1][g[0]: g[-1] + 1]) for conv, g in zip(ks2.convs, ks2.groups)]
        return nttm.ntt_fwd(torch.stack(digs), ctx.ntt_qp)
    return ringkit.hoist_digits(ct.c[1], ctx.base_qp, ctx.ntt_qp, in_ntt=False)


def rotate_rows_hoisted(ctx: BfvContext, ct: Ciphertext, d_ntt,
                        gk1: GaloisKeyOne) -> Ciphertext:
    """One Galois rotation reusing hoisted digits: the automorphism is an
    NTT-domain gather on the digits; inverse-form keys MAC the unpermuted
    digits and permute only the finished pair.  The MAC is one K2 mac_keys
    launch on the card under either method."""
    p = ctx.base_q.col()
    k1 = ringkit.ensure_k1(_ring(ctx), gk1)
    dp = d_ntt if gk1.inv_form else polyops.apply_galois_ntt(d_ntt, gk1.perm_ntt)
    acc = ringkit.hoisted_mac(dp, gk1.k0, k1, ctx.base_qp)
    div = ctx.ks2[0].div_stages if ctx.ks_type == "II" else ctx.div_p
    out = ringkit.ks_finish(acc, ctx.ntt_qp, div, out_ntt=False)
    src, neg = gk1.perm_coeff_src, gk1.perm_coeff_neg
    if gk1.inv_form:
        comb = torch.stack([mm.add_mod(ct.c[0], out[0], p), out[1]])
        return Ciphertext(polyops.apply_galois_coeff(comb, src, neg, p), 2, False)
    g0 = polyops.apply_galois_coeff(ct.c[0], src, neg, p)
    return Ciphertext(torch.stack([mm.add_mod(g0, out[0], p), out[1]]), 2, False)
