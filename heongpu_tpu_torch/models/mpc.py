"""N-out-of-N multiparty computation for BFV and CKKS (port of
heongpu_tpu/models/mpc.py): collective public keys, the 2-round collective
relinearization key, single-round collective Galois keys, threshold (fuse)
decryption with noise flooding, single-round collective bootstrapping, and
t-out-of-N threshold decryption over Shamir shares of a secret key.

The protocols are the reference's, function for function, and from the
same keys they return its residues bit for bit:

  * the common reference string (the 'a' polynomials) is the uniform RNS
    draw of the public Threefry key `rng.new_key(seed)`, one K7 launch on
    the card (`crs_uniform`, `relin_crs`);
  * the collective keys are Method-I keys (one digit per Q prime, P·s on
    that prime's limb only), so the contexts' Method-I keyswitch uses them
    as it uses a key of one party (K1, K2 `mac_keys` and K6 on the card);
  * shares are ordinary tensors: parties exchange them out of band, for
    instance as bytes of utils/serializer.py, which the JAX package's
    serializer reads too.

Where the reference asserts on a caller's error (a threshold outside
[1, n_parties], too few participants, a party outside its group) the port
raises errors.ParameterError.
"""

from __future__ import annotations

import dataclasses
from functools import reduce
from typing import List

import torch

from ..ops import modmath as mm
from ..ops import ntt as nttm
from ..ops import polyops
from ..utils import errors, rng
from . import bfv, ckks, ringkit
from .ringkit import GaloisKeyOne, KSKey, PublicKey, RingView, SecretKey

SMUDGE_BITS = 40  # noise-flooding magnitude for BFV threshold decryption
CKKS_SMUDGE_BITS = 13  # CKKS's: the flooding lands in the decoded values

_prod = lambda xs: reduce(lambda a, b: a * b, xs, 1)


def _col(vals, device):
    """Per-limb integers as an int64 (L, 1) column."""
    return torch.tensor([int(v) for v in vals], dtype=mm.I64, device=device)[:, None]


def _sum_mod(xs, p):
    acc = xs[0]
    for x in xs[1:]:
        acc = mm.add_mod(acc, x, p)
    return acc


# ---------------------------------------------------------------------
# Common reference strings
# ---------------------------------------------------------------------

def crs_uniform(ring: RingView, seed: int, shape) -> torch.Tensor:
    """Common 'a' polynomial(s) over QP (NTT domain) from a shared seed:
    (k+p,) + shape."""
    return rng.uniform_rns(rng.new_key(seed, ring.device), ring.qp_primes, shape, ring.device)


def _crs_q(ctx, seed: int) -> torch.Tensor:
    """crs_uniform(ring, seed, (n,))[:k], drawn over the Q primes alone: a
    limb's words depend only on its position in the draw, so the first k
    limbs of the QP draw are this draw."""
    return rng.uniform_rns(rng.new_key(seed, ctx.device), ctx.q_primes, (ctx.n,), ctx.device)


def relin_crs(ring: RingView, seed: int) -> torch.Tensor:
    """The CRS of the key protocols: crs_uniform(ring, seed, (k, n)) with its
    limb axis moved behind the digit axis, (k, k+p, n), drawn in that layout
    (one K7 launch on the card)."""
    return ringkit._seeded_a(ring, seed, ring.k, mont=False)


# ---------------------------------------------------------------------
# Collective public key
# ---------------------------------------------------------------------

def _gaussian_ntt(key, ring: RingView, digits: int = 0):
    """A gaussian error over QP in the NTT domain: (k+p, n), or with
    `digits` a (digits, n) draw with its limb axis moved behind the digit
    axis, (digits, k+p, n)."""
    if not digits:
        e = rng.gaussian_rns(key, ring.qp_primes, (ring.n,), ring.device)
    else:
        e = rng.gaussian_rns(key, ring.qp_primes, (digits, ring.n), ring.device)
        e = e.transpose(0, 1).contiguous()
    return nttm.ntt_fwd(e, ring.ntt_qp)


def pk_share(ring: RingView, sk: SecretKey, a, key) -> torch.Tensor:
    """Party share: -(a·s_i + e_i) (reference threshold_pk_addition)."""
    b = ring.base_qp
    p = b.col()
    e = _gaussian_ntt(key, ring)
    return mm.neg_mod(mm.add_mod(mm.mont_mul(a, sk.s_ntt_mont_qp, p, b.col("rinv")), e, p), p)


def pk_assemble(ring: RingView, shares: List[torch.Tensor], a) -> PublicKey:
    b = ring.base_qp
    p, r1 = b.col(), b.col("r1")
    return PublicKey(mm.to_mont(_sum_mod(shares, p), p, r1), mm.to_mont(a, p, r1))


# ---------------------------------------------------------------------
# Collective relinearization key (2-round protocol)
# ---------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class RelinEphemeral:
    u_mont: torch.Tensor  # ephemeral secret (NTT + Montgomery over QP)


def _gadget(ring: RingView, s_ntt_mont):
    """s·g of the Method-I gadget: P mod q_i · s on limb i of digit i, zero
    elsewhere; (k, k+p, n), Montgomery form."""
    P = _prod(ring.p_primes)
    sel = torch.zeros((ring.k, len(ring.qp_primes)), dtype=mm.I64)
    for i, q in enumerate(ring.q_primes):
        sel[i, i] = P % q
    b = ring.base_qp
    return mm.mont_mul(s_ntt_mont[None], sel.to(ring.device)[:, :, None], b.col(), b.col("rinv"))


def relin_round1(ring: RingView, sk: SecretKey, a_d, key):
    """Round 1: d0_i = -u_i·a + s_i·g + e0, d1_i = s_i·a + e1.
    a_d: the CRS (k, k+p, n) of relin_crs.  Returns ((d0_i, d1_i), the
    party's ephemeral secret)."""
    ke_u, ke0, ke1 = rng.split(key, 3)
    b = ring.base_qp
    p, rinv = b.col(), b.col("rinv")
    u = rng.ternary_rns(ke_u, ring.qp_primes, (ring.n,), ring.device)
    u_mont = mm.to_mont(nttm.ntt_fwd(u, ring.ntt_qp), p, b.col("r1"))
    e0 = _gaussian_ntt(ke0, ring, ring.k)
    e1 = _gaussian_ntt(ke1, ring, ring.k)
    d0 = mm.neg_mod(mm.mont_mul(a_d, u_mont[None], p, rinv), p)
    d0 = mm.add_mod(mm.add_mod(d0, _gadget(ring, sk.s_ntt_mont_qp), p), e0, p)
    d1 = mm.add_mod(mm.mont_mul(a_d, sk.s_ntt_mont_qp[None], p, rinv), e1, p)
    return (d0, d1), RelinEphemeral(u_mont)


def relin_round2(ring: RingView, sk: SecretKey, eph: RelinEphemeral, d0_sum, d1_sum, key):
    """Round 2: b_i = s_i·d0 + e2, c_i = (u_i - s_i)·d1 + e3 over the sums of
    the round-1 shares."""
    ke0, ke1 = rng.split(key)
    b = ring.base_qp
    p, rinv = b.col(), b.col("rinv")
    e2 = _gaussian_ntt(ke0, ring, ring.k)
    e3 = _gaussian_ntt(ke1, ring, ring.k)
    bb = mm.add_mod(mm.mont_mul(d0_sum, sk.s_ntt_mont_qp[None], p, rinv), e2, p)
    u_minus_s = mm.sub_mod(eph.u_mont, sk.s_ntt_mont_qp, p)
    c = mm.add_mod(mm.mont_mul(d1_sum, u_minus_s[None], p, rinv), e3, p)
    return bb, c


def relin_assemble(ring: RingView, round1_shares, round2_shares) -> KSKey:
    b = ring.base_qp
    p, r1 = b.col(), b.col("r1")
    d1 = _sum_mod([s[1] for s in round1_shares], p)
    k0 = mm.add_mod(_sum_mod([s[0] for s in round2_shares], p),
                    _sum_mod([s[1] for s in round2_shares], p), p)
    return KSKey(mm.to_mont(k0, p, r1), mm.to_mont(d1, p, r1))


# ---------------------------------------------------------------------
# Collective Galois keys (single round)
# ---------------------------------------------------------------------

def galois_share(ring: RingView, sk: SecretKey, g: int, a_d, key) -> torch.Tensor:
    """share_i = -(a·s_i + e_i) + gamma_g(s_i)·gadget."""
    b = ring.base_qp
    p = b.col()
    src, neg = polyops.galois_perm_coeff(g, ring.n, ring.device)
    sg_mont = ringkit._galois_target(ring, sk, src, neg)
    e = _gaussian_ntt(key, ring, ring.k)
    h = mm.neg_mod(mm.add_mod(mm.mont_mul(a_d, sk.s_ntt_mont_qp[None], p, b.col("rinv")), e, p), p)
    return mm.add_mod(h, _gadget(ring, sg_mont), p)


def galois_assemble(ring: RingView, g: int, shares, a_d) -> GaloisKeyOne:
    b = ring.base_qp
    p, r1 = b.col(), b.col("r1")
    src, neg = polyops.galois_perm_coeff(g, ring.n, ring.device)
    perm_ntt = polyops.galois_perm_ntt(g, ring.n, ring.device)
    return GaloisKeyOne(mm.to_mont(_sum_mod(shares, p), p, r1), mm.to_mont(a_d, p, r1),
                        src, neg, perm_ntt, g)


# ---------------------------------------------------------------------
# Threshold decryption (partial decrypt + fuse)
# ---------------------------------------------------------------------

def _smudge_noise(key, primes, n: int, device, bits: int = SMUDGE_BITS):
    """Flooding noise, uniform in ±2^bits, in RNS form (L, n).  Above 30
    bits: a draw in ±2^30 plus 2^30 times a draw in [0, 2^(bits-30)) from
    fold_in(key, 1), as the reference splits it."""
    if bits <= 30:
        return rng.signed_to_rns(rng.randint(key, (n,), -(1 << bits), 1 << bits, device), primes)
    lo = rng.signed_to_rns(rng.randint(key, (n,), -(1 << 30), 1 << 30, device), primes)
    hi = rng.signed_to_rns(rng.randint(rng.fold_in(key, 1), (n,), 0, 1 << (bits - 30), device),
                           primes)
    p = _col(primes, device)
    return mm.add_mod(lo, mm.mul_mod(hi, _col([(1 << 30) % q for q in primes], device), p), p)


def _c1_times(ctx: bfv.BfvContext, ct, s_ntt_mont):
    """c1·s over Q in the coefficient domain, s (k, n) NTT + Montgomery."""
    qb = ctx.base_q
    prod = mm.mont_mul(nttm.ntt_fwd(ct.c[1], ctx.ntt_q), s_ntt_mont, qb.col(), qb.col("rinv"))
    return nttm.ntt_inv(prod, ctx.ntt_q)


def bfv_decrypt_partial(ctx: bfv.BfvContext, sk: SecretKey, ct, key) -> torch.Tensor:
    """p_i = c1·s_i + e_smudge (reference decrypt_partial)."""
    c1s = _c1_times(ctx, ct, sk.s_ntt_mont_qp[: ctx.k])
    return mm.add_mod(c1s, _smudge_noise(key, ctx.q_primes, ctx.n, ctx.device), ctx.base_q.col())


def bfv_decrypt_fuse(ctx: bfv.BfvContext, ct, partials) -> torch.Tensor:
    """Combine c0 + Σ p_i and decode mod t (reference decrypt fuse): the
    plaintext poly (n,)."""
    return bfv.decrypt_phase(ctx, _sum_mod([ct.c[0]] + list(partials), ctx.base_q.col()))


def ckks_decrypt_partial(ctx: ckks.CkksContext, sk: SecretKey, ct, key) -> torch.Tensor:
    ka = ctx.active(ct.level)
    qb = ctx.base_q_at(ct.level)
    p = qb.col()
    c1s = mm.mont_mul(ct.c[1], sk.s_ntt_mont_qp[:ka], p, qb.col("rinv"))
    sm = nttm.ntt_fwd(_smudge_noise(key, ctx.q_primes[:ka], ctx.n, ctx.device, CKKS_SMUDGE_BITS),
                      ctx.ntt_q(ct.level))
    return mm.add_mod(c1s, sm, p)


def ckks_decrypt_fuse(ctx: ckks.CkksContext, ct, partials) -> ckks.Plaintext:
    acc = _sum_mod([ct.c[0]] + list(partials), ctx.base_q_at(ct.level).col())
    return ckks.Plaintext(acc, ct.level, ct.scale)


# ---------------------------------------------------------------------
# Collective (distributed) bootstrapping — BFV
# ---------------------------------------------------------------------

def bfv_colboot_participant(ctx: bfv.BfvContext, sk: SecretKey, ct, common_seed: int, key):
    """Stage 1 (each party): the decryption share of c1 masked by a random
    plaintext M_i, h0 = c1·s_i + e - Δ·M_i, and a fresh encryption share of
    M_i under the common 'a', h1 = -a·s_i + e' + Δ·M_i (reference
    distributed_bootstrapping_participant)."""
    k_m, k_e1, k_e2 = rng.split(key, 3)
    a = _crs_q(ctx, common_seed)
    p = ctx.base_q.col()
    s = sk.s_ntt_mont_qp[: ctx.k]
    m = rng.randint(k_m, (ctx.n,), 0, ctx.t, ctx.device)
    lift = bfv._plain_lift(ctx, m)
    h0 = mm.add_mod(_c1_times(ctx, ct, s), _smudge_noise(k_e1, ctx.q_primes, ctx.n, ctx.device), p)
    h0 = mm.sub_mod(h0, lift, p)
    a_s = nttm.ntt_inv(mm.mont_mul(a, s, p, ctx.base_q.col("rinv")), ctx.ntt_q)
    e2 = rng.gaussian_rns(k_e2, ctx.q_primes, (ctx.n,), ctx.device)
    h1 = mm.add_mod(mm.sub_mod(e2, a_s, p), lift, p)
    return h0, h1


def bfv_colboot_coordinator(ctx: bfv.BfvContext, ct, shares, common_seed: int) -> bfv.Ciphertext:
    """Stage 2: decode c0 + Σ h0 to m - Σ M_i mod t, re-encrypt it with
    Σ h1 under the common 'a' (reference distributed_bootstrapping_
    coordinator)."""
    p = ctx.base_q.col()
    m_prime = bfv.decrypt_phase(ctx, _sum_mod([ct.c[0]] + [h0 for h0, _ in shares], p))
    c0 = mm.add_mod(_sum_mod([h1 for _, h1 in shares], p), bfv._plain_lift(ctx, m_prime), p)
    c1 = nttm.ntt_inv(_crs_q(ctx, common_seed), ctx.ntt_q)
    return bfv.Ciphertext(torch.stack([c0, c1]), 2, False)


# ---------------------------------------------------------------------
# Collective (distributed) bootstrapping — CKKS
# ---------------------------------------------------------------------

def ckks_colboot_participant(ctx: ckks.CkksContext, sk: SecretKey, ct, common_seed: int, key):
    """CKKS variant: the mask is a random integer polynomial in ±2^30, far
    larger than the message (statistical hiding); h0 at the ciphertext's
    level, h1 at level 0, where the coordinator re-encrypts."""
    k_m, k_e1, k_e2 = rng.split(key, 3)
    lvl = ct.level
    ka = ctx.active(lvl)
    qb = ctx.base_q_at(lvl)
    p = qb.col()
    mask_int = rng.randint(k_m, (ctx.n,), -(1 << 30), 1 << 30, ctx.device)
    # the mask at level 0; its first ka limbs are the mask at the ciphertext's level
    mask = nttm.ntt_fwd(rng.signed_to_rns(mask_int, ctx.q_primes), ctx.ntt_q(0))
    c1s = mm.mont_mul(ct.c[1], sk.s_ntt_mont_qp[:ka], p, qb.col("rinv"))
    sm = nttm.ntt_fwd(_smudge_noise(k_e1, ctx.q_primes[:ka], ctx.n, ctx.device,
                                    CKKS_SMUDGE_BITS), ctx.ntt_q(lvl))
    h0 = mm.sub_mod(mm.add_mod(c1s, sm, p), mask[:ka], p)
    pf = ctx.base_q.col()
    a_s = mm.mont_mul(_crs_q(ctx, common_seed), sk.s_ntt_mont_qp[: ctx.k], pf,
                      ctx.base_q.col("rinv"))
    e2 = nttm.ntt_fwd(rng.gaussian_rns(k_e2, ctx.q_primes, (ctx.n,), ctx.device), ctx.ntt_q(0))
    h1 = mm.add_mod(mm.sub_mod(e2, a_s, pf), mask, pf)
    return h0, h1


def crt_relift(x, in_primes, out_primes) -> torch.Tensor:
    """The exact centered CRT lift of residues x (k, n) over in_primes,
    reduced mod each of out_primes: (len(out_primes), n) int32.  X in [0, Q)
    is held as Garner's mixed-radix digits v_i (X = v_0 + q_0·(v_1 + q_1·
    (v_2 + ...))), compared with floor(Q/2) digit by digit from the top, so
    X - Q replaces X where X >= floor(Q/2) (the reference's big-integer CRT on
    the host); each output residue by Horner's rule.  Exact int64 passes on
    x's device."""
    dev = x.device
    in_primes = [int(q) for q in in_primes]
    v = []
    for i, qi in enumerate(in_primes):
        t = x[i].to(mm.I64)
        for j in range(i):
            t = torch.remainder((t - v[j]) * pow(in_primes[j], -1, qi), qi)
        v.append(t)
    Q = _prod(in_primes)
    half, digits = Q // 2, []
    for qi in in_primes:
        digits.append(half % qi)
        half //= qi
    gt = torch.zeros_like(v[0], dtype=torch.bool)
    eq = torch.ones_like(gt)
    for vi, hi in zip(reversed(v), reversed(digits)):
        gt |= eq & (vi > hi)
        eq &= vi == hi
    r = _col(out_primes, dev)
    acc = torch.remainder(v[-1][None], r)
    for qi, vi in zip(reversed(in_primes[:-1]), reversed(v[:-1])):
        acc = torch.remainder(acc * qi + vi[None], r)
    acc = torch.where(gt | eq, acc - _col([Q % int(q) for q in out_primes], dev), acc)
    return torch.remainder(acc, r).to(mm.I32)


def ckks_colboot_coordinator(ctx: ckks.CkksContext, ct, shares, common_seed: int) -> ckks.Ciphertext:
    """Decode c0 + Σ h0 to the masked message's integers (the exact centered
    CRT of crt_relift, on the ciphertext's device), lift them to the full
    chain and re-encrypt with Σ h1 under the common 'a' at level 0."""
    lvl = ct.level
    ka = ctx.active(lvl)
    pf = ctx.base_q.col()
    acc0 = _sum_mod([ct.c[0]] + [h0 for h0, _ in shares], ctx.base_q_at(lvl).col())
    coeffs = nttm.ntt_inv(acc0, ctx.ntt_q(lvl))
    m_full = nttm.ntt_fwd(crt_relift(coeffs, ctx.q_primes[:ka], ctx.q_primes), ctx.ntt_q(0))
    c0 = mm.add_mod(_sum_mod([h1 for _, h1 in shares], pf), m_full, pf)
    return ckks.Ciphertext(torch.stack([c0, _crs_q(ctx, common_seed)]), 2, 0, ct.scale)


# ---------------------------------------------------------------------
# t-out-of-N threshold decryption (Shamir over each RNS limb field)
# ---------------------------------------------------------------------
# Every RNS limb lives in the field Z_q, and the NTT and Montgomery maps are
# Z_q-linear bijections, so the key is shared in its stored (NTT, Montgomery)
# domain: f(x) = s + a_1 x + ... + a_{t-1} x^{t-1} with uniform a_k over QP,
# share_i = f(i); any t parties fuse Lagrange-weighted partial decryptions.

@dataclasses.dataclass(frozen=True, eq=False)
class ThresholdShare:
    """Party `index`'s Shamir share of a secret key (x-coordinate = index)."""
    index: int
    threshold: int
    s_ntt_mont_qp: torch.Tensor      # (L, n) f(index), NTT + Montgomery domain


def shamir_share_secret(ctx, key, sk: SecretKey, n_parties: int,
                        threshold: int) -> List[ThresholdShare]:
    """Dealer-side split of `sk` into n_parties shares, any `threshold` of
    which decrypt; a_k is the uniform draw of fold_in(key, k) (one K7 launch
    each on the card).  Shares cover the full QP basis, as the key does."""
    if not 1 <= threshold <= n_parties:
        raise errors.ParameterError(
            f"threshold {threshold} outside [1, {n_parties}] for {n_parties} parties")
    primes = tuple(int(q) for q in ctx.q_primes) + tuple(int(q) for q in ctx.p_primes)
    pb = _col(primes, ctx.device)
    coeffs = [rng.uniform_rns(rng.fold_in(key, k), primes, (ctx.n,), ctx.device)
              for k in range(1, threshold)]
    shares = []
    for i in range(1, n_parties + 1):
        acc = sk.s_ntt_mont_qp
        for k, a in enumerate(coeffs, start=1):
            acc = mm.add_mod(acc, mm.mul_mod(a, _col([pow(i, k, q) for q in primes], ctx.device),
                                             pb), pb)
        shares.append(ThresholdShare(i, threshold, acc))
    return shares


def _lagrange0(indices, q: int) -> dict:
    """{i: lambda_i^S mod q} with sum_i lambda_i f(i) = f(0) over Z_q."""
    lams = {}
    for i in indices:
        num, den = 1, 1
        for j in indices:
            if j != i:
                num = num * j % q
                den = den * ((j - i) % q) % q
        lams[i] = num * pow(den, -1, q) % q
    return lams


def _lam_share(ctx, share: ThresholdShare, participants, kq: int):
    """The share's rows over the first kq Q limbs times lambda_i^S."""
    participants = tuple(sorted(participants))
    if len(participants) < share.threshold:
        raise errors.ParameterError(
            f"need {share.threshold} participants, got {len(participants)}")
    if share.index not in participants:
        raise errors.ParameterError(f"party {share.index} is not among {participants}")
    primes = [int(q) for q in ctx.q_primes[:kq]]
    lam = [_lagrange0(participants, q)[share.index] for q in primes]
    return mm.mul_mod(share.s_ntt_mont_qp[:kq], _col(lam, ctx.device), _col(primes, ctx.device))


def bfv_decrypt_partial_threshold(ctx: bfv.BfvContext, share: ThresholdShare, ct,
                                  participants, key) -> torch.Tensor:
    """p_i = c1·(lambda_i^S·f(i)) + e_smudge; fuse any `threshold` of them
    with bfv_decrypt_fuse."""
    c1s = _c1_times(ctx, ct, _lam_share(ctx, share, participants, ctx.k))
    return mm.add_mod(c1s, _smudge_noise(key, ctx.q_primes, ctx.n, ctx.device), ctx.base_q.col())


def ckks_decrypt_partial_threshold(ctx: ckks.CkksContext, share: ThresholdShare, ct,
                                   participants, key) -> torch.Tensor:
    """The CKKS analog (the ciphertext is in the NTT domain); fuse with
    ckks_decrypt_fuse."""
    ka = ctx.active(ct.level)
    s_lam = _lam_share(ctx, share, participants, ka)
    qb = ctx.base_q_at(ct.level)
    p = qb.col()
    sm = nttm.ntt_fwd(_smudge_noise(key, ctx.q_primes[:ka], ctx.n, ctx.device, CKKS_SMUDGE_BITS),
                      ctx.ntt_q(ct.level))
    return mm.add_mod(mm.mont_mul(ct.c[1], s_lam, p, qb.col("rinv")), sm, p)
