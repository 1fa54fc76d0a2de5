"""Shared RNS-ring key machinery for BFV, CKKS and BGV (port of
heongpu_tpu/models/ringkit.py: secret, public, relinearization, switching
and Galois keys, seed-expanded keys, and the Method-I keyswitch).

Key layout as in the reference: the secret key as ternary coefficients plus
its NTT-domain Montgomery form over Q·P; public and keyswitch keys in the NTT
domain over Q·P, Montgomery form.  The Method-I gadget has one digit per Q
prime and carries P·target on that prime's limb only; the Method-II grouped
gadget puts P·target on every limb of digit j's group.  Either way one key
serves every level by prefix slicing.  Draw order follows the reference
(uniform half first, then the gaussian), so DRBG-seeded keys are
bit-identical to the JAX package's.

Seed-expanded keys (`a_seed`): the uniform half is drawn from the public
Threefry key `rng.new_key(a_seed)` (utils/threefry.py, the reference's
jax.random bits), so it can be dropped (`strip_seeded`, `store_a=False`)
and regenerated (`expand_seeded`, or `ensure_k1` just before a keyswitch
uses the key): one K7 launch on the card.  `noise_scale` multiplies the
gaussian error (BGV's t-scaled noise).
"""

from __future__ import annotations

import dataclasses
from functools import reduce
from typing import Optional

import torch

from ..ops import modmath as mm
from ..ops import ntt as nttm
from ..ops import polyops, rns
from ..utils import errors, rng, threefry

_prod = lambda xs: reduce(lambda a, b: a * b, xs, 1)


@dataclasses.dataclass(frozen=True, eq=False)
class SecretKey:
    s_coeff: torch.Tensor        # (n,) int32 in {-1,0,1}
    s_ntt_mont_qp: torch.Tensor  # (k+p, n) NTT domain, Montgomery form
    hamming_weight: int


@dataclasses.dataclass(frozen=True, eq=False)
class PublicKey:
    """pk1 (the uniform half) is regenerable from `a_seed` when the key was
    made seed-expanded: strip_seeded drops it, expand_seeded rebuilds it."""
    pk0: torch.Tensor  # (k+p, n) NTT, Montgomery form
    pk1: Optional[torch.Tensor]
    a_seed: Optional[int] = None


@dataclasses.dataclass(frozen=True, eq=False)
class KSKey:
    """Keyswitch key: (d, k+p, n) NTT + Montgomery per half; k1 (uniform) is
    seed-expandable like PublicKey.pk1."""
    k0: torch.Tensor
    k1: Optional[torch.Tensor]
    a_seed: Optional[int] = None


@dataclasses.dataclass(frozen=True, eq=False)
class GaloisKeyOne:
    """The keyswitch key of one Galois element g, with its gather tables.
    inv_form=True stores the key inverse-permuted (k' = sigma_g^-1(k)), so
    hoisted rotations MAC the unpermuted digits and permute only the 2-poly
    result.  k1 is seed-expandable like PublicKey.pk1."""
    k0: torch.Tensor
    k1: Optional[torch.Tensor]
    perm_coeff_src: torch.Tensor
    perm_coeff_neg: torch.Tensor
    perm_ntt: torch.Tensor
    galois_elt: int
    inv_form: bool = False
    a_seed: Optional[int] = None


class GaloisKey:
    """Bundle of per-element Galois keys: `keys` maps a Galois element (int)
    or "conj" to its GaloisKeyOne."""

    def __init__(self, keys: dict):
        self.keys = keys


@dataclasses.dataclass(frozen=True, eq=False)
class RingView:
    """The ring tables keygen needs; a scheme context builds one."""
    n: int
    q_primes: tuple
    p_primes: tuple
    base_q: rns.Base
    base_qp: rns.Base
    ntt_qp: nttm.NttTables
    div_p: rns.DivRoundLastq

    @property
    def qp_primes(self):
        return tuple(self.q_primes) + tuple(self.p_primes)

    @property
    def k(self):
        return len(self.q_primes)

    @property
    def device(self):
        return self.base_qp.p.device


def keygen_secret(ring: RingView, key, hamming_weight: Optional[int] = None) -> SecretKey:
    hw = ring.n // 2 if hamming_weight is None else hamming_weight
    s = rng.ternary_hw(key, ring.n, hw, ring.device)
    s_ntt = nttm.ntt_fwd(rng.signed_to_rns(s, ring.qp_primes), ring.ntt_qp)
    b = ring.base_qp
    return SecretKey(s, mm.to_mont(s_ntt, b.col(), b.col("r1")), hw)


def _seeded_a(ring: RingView, a_seed: int, d: Optional[int], mont: bool):
    """The uniform NTT-domain half of a seed-expanded key, from its public
    seed: (k+p, n), or (d, k+p, n) from a (d, n) draw with the limb axis
    moved behind the digit axis; in Montgomery form when `mont`.  One K7
    launch on the card."""
    shape = (ring.n,) if d is None else (d, ring.n)
    return threefry.uniform_rns(threefry.key_from_seed(a_seed), ring.qp_primes, shape,
                                ring.device, moved=d is not None, mont=mont)


def _draw_a(ring: RingView, key, a_seed: Optional[int], d: Optional[int]):
    """(the uniform half of a new key, NTT domain, not yet in Montgomery
    form; the key to draw its error from).  With a_seed the half comes from
    that public seed and the error from `key`; without, both are split from
    `key`."""
    if a_seed is not None:
        return _seeded_a(ring, a_seed, d, mont=False), key
    ka, ke = rng.split(key)
    a = rng.uniform_rns(ka, ring.qp_primes, (ring.n,) if d is None else (d, ring.n),
                        ring.device)
    return (a if d is None else a.transpose(0, 1).contiguous()), ke


def keygen_public(ring: RingView, key, sk: SecretKey, a_seed: Optional[int] = None,
                  noise_scale: int = 1) -> PublicKey:
    """a_seed: draw the uniform half from this public seed so the key is
    seed-expandable; noise_scale=t gives BGV's t-scaled noise."""
    a, ke = _draw_a(ring, key, a_seed, None)  # NTT domain
    e = nttm.ntt_fwd(rng.gaussian_rns(ke, ring.qp_primes, (ring.n,), ring.device,
                                      noise_scale=noise_scale), ring.ntt_qp)
    b = ring.base_qp
    p, r1 = b.col(), b.col("r1")
    a_s = mm.mont_mul(a, sk.s_ntt_mont_qp, p, b.col("rinv"))
    pk0 = mm.neg_mod(mm.add_mod(a_s, e, p), p)
    return PublicKey(mm.to_mont(pk0, p, r1), mm.to_mont(a, p, r1),
                     None if a_seed is None else int(a_seed))


def ks_keygen(ring: RingView, key, sk: SecretKey, target_ntt_mont, groups=None,
              a_seed: Optional[int] = None, noise_scale: int = 1) -> KSKey:
    """Keyswitch key encrypting `target` (NTT + Montgomery over QP) under s.
    groups=None: one digit per Q prime (Method I); groups=((0,1),(2,3),...):
    Method-II grouped gadget.  a_seed: seed-expand the uniform half (see
    PublicKey)."""
    if groups is None:
        groups = tuple((i,) for i in range(ring.k))
    d, n = len(groups), ring.n
    a, ke = _draw_a(ring, key, a_seed, d)
    b = ring.base_qp
    p, r1, rinv = b.col(), b.col("r1"), b.col("rinv")
    e = nttm.ntt_fwd(rng.gaussian_rns(ke, ring.qp_primes, (d, n), ring.device,
                                      noise_scale=noise_scale)
                     .transpose(0, 1).contiguous(), ring.ntt_qp)
    a_s = mm.mont_mul(a, sk.s_ntt_mont_qp[None], p, rinv)
    k0 = mm.neg_mod(mm.add_mod(a_s, e, p), p)
    P = _prod(ring.p_primes)
    sel = torch.zeros((d, len(ring.qp_primes)), dtype=mm.I64)
    for j, g in enumerate(groups):
        for i in g:
            sel[j, i] = P % ring.q_primes[i]
    pt = mm.mont_mul(target_ntt_mont[None], sel.to(ring.device)[:, :, None], p, rinv)
    k0 = mm.add_mod(k0, pt, p)
    return KSKey(mm.to_mont(k0, p, r1), mm.to_mont(a, p, r1),
                 None if a_seed is None else int(a_seed))


def keygen_relin(ring: RingView, key, sk: SecretKey, groups=None,
                 a_seed: Optional[int] = None, noise_scale: int = 1) -> KSKey:
    b = ring.base_qp
    s2_mont = mm.mont_mul(sk.s_ntt_mont_qp, sk.s_ntt_mont_qp, b.col(), b.col("rinv"))
    return ks_keygen(ring, key, sk, s2_mont, groups=groups, a_seed=a_seed,
                     noise_scale=noise_scale)


def keygen_switch(ring: RingView, key, sk_old: SecretKey, sk_new: SecretKey,
                  groups=None, a_seed: Optional[int] = None, noise_scale: int = 1) -> KSKey:
    """Key switching from sk_old to sk_new."""
    return ks_keygen(ring, key, sk_new, sk_old.s_ntt_mont_qp, groups=groups, a_seed=a_seed,
                     noise_scale=noise_scale)


def _galois_target(ring: RingView, sk: SecretKey, src, neg):
    """sigma(s) over QP, NTT domain, Montgomery form."""
    b = ring.base_qp
    s_g = polyops.apply_galois_coeff(rng.signed_to_rns(sk.s_coeff, ring.qp_primes),
                                     src, neg, b.col())
    return mm.to_mont(nttm.ntt_fwd(s_g, ring.ntt_qp), b.col(), b.col("r1"))


def keygen_galois_one(ring: RingView, key, sk: SecretKey, g: int, groups=None,
                      a_seed: Optional[int] = None, noise_scale: int = 1,
                      inv_form: bool = False) -> GaloisKeyOne:
    n, dev = ring.n, ring.device
    src, neg = polyops.galois_perm_coeff(g, n, dev)
    perm_ntt = polyops.galois_perm_ntt(g, n, dev)
    if inv_form:
        # k' = sigma^-1(k) generated directly: k'0 = -a·sigma^-1(s) + e + P·g_j·s
        src_i, neg_i = polyops.galois_perm_coeff(pow(g, -1, 2 * n), n, dev)
        under = dataclasses.replace(sk, s_ntt_mont_qp=_galois_target(ring, sk, src_i, neg_i))
        kk = ks_keygen(ring, key, under, sk.s_ntt_mont_qp, groups=groups, a_seed=a_seed,
                       noise_scale=noise_scale)
    else:
        kk = ks_keygen(ring, key, sk, _galois_target(ring, sk, src, neg), groups=groups,
                       a_seed=a_seed, noise_scale=noise_scale)
    return GaloisKeyOne(kk.k0, kk.k1, src, neg, perm_ntt, g, inv_form, kk.a_seed)


def rotate_by_steps(ct, gk: GaloisKey, step: int, n: int, apply_galois):
    """Rotate by `step` slots (mod n/2) with the stored power-of-two keys:
    from the largest power of two down, each stored key whose step still
    fits is applied (apply_galois(ct, key_one)) while it fits.  Raises
    ValueError when the stored keys cannot reach the step."""
    step %= n // 2
    remaining = step
    for j in reversed(range(16)):
        sz = 1 << j
        while remaining >= sz:
            g = polyops.steps_to_galois_elt(sz, n)
            if g not in gk.keys:
                break
            ct = apply_galois(ct, gk.keys[g])
            remaining -= sz
        if remaining == 0:
            return ct
    raise ValueError(f"no galois key chain reaches step {step}")


def keygen_galois(ring: RingView, key, sk: SecretKey, steps=None, max_shift: int = 8,
                  include_conj: bool = True, groups=None, elts=None,
                  a_seed: Optional[int] = None, noise_scale: int = 1, store_a: bool = True,
                  inv_form: bool = False) -> GaloisKey:
    """Default: the power-of-two chain ±2^0..±2^(max_shift-1); `steps` gives
    a custom rotation list, `elts` raw Galois elements.  Draw order as in the
    reference: one sub-key per listed element (a repeated element draws
    nothing), the conjugation key last.  a_seed: the i-th listed element's
    key draws its uniform half from a_seed + i, the conjugation key's from
    a_seed + (the number listed).  store_a=False (requires a_seed) strips
    each key's uniform half as it is made, so the set holds only the k0
    halves and consumers regenerate k1 per use (ensure_k1)."""
    if not store_a and a_seed is None:
        raise errors.ParameterError("store_a=False requires a_seed (seed-expanded keys)")
    n = ring.n
    if steps is None and elts is None:
        steps = [s for j in range(max_shift) for s in (1 << j, -(1 << j))]
    gl = [polyops.steps_to_galois_elt(s, n) for s in (steps or [])]
    gl += [int(g) for g in (elts or [])]
    subkeys = rng.split(key, len(gl) + 1)
    seed = lambda i: None if a_seed is None else a_seed + i
    keep = (lambda kk: kk) if store_a else strip_seeded
    keys = {}
    for i, (sub, g) in enumerate(zip(subkeys[:-1], gl)):
        if g not in keys:
            keys[g] = keep(keygen_galois_one(ring, sub, sk, g, groups=groups, a_seed=seed(i),
                                             noise_scale=noise_scale, inv_form=inv_form))
    if include_conj:
        keys[polyops.GALOIS_CONJ] = keep(keygen_galois_one(
            ring, subkeys[-1], sk, 2 * n - 1, groups=groups, a_seed=seed(len(gl)),
            noise_scale=noise_scale, inv_form=inv_form))
    return GaloisKey(keys)


# =========================================================================
# Seed-expanded keys: the uniform halves dropped and regenerated from a_seed
# =========================================================================

def strip_seeded(obj):
    """Drop the regenerable uniform halves of seed-expanded keys (PublicKey,
    KSKey, GaloisKeyOne, GaloisKey); anything else passes through."""
    if isinstance(obj, PublicKey) and obj.a_seed is not None:
        return dataclasses.replace(obj, pk1=None)
    if isinstance(obj, (KSKey, GaloisKeyOne)) and obj.a_seed is not None:
        return dataclasses.replace(obj, k1=None)
    if isinstance(obj, GaloisKey):
        return GaloisKey({k: strip_seeded(v) for k, v in obj.keys.items()})
    return obj


def ensure_k1(ring, kk):
    """The uniform half k1 of a KSKey or GaloisKeyOne: the stored one, or
    for a stripped key (k1=None) the one regenerated from its a_seed on the
    ring's device (one K7 launch on the card).  `ring` is the RingView of
    the basis the key was made in, or a function of no arguments that
    returns it, called only for a stripped key.  A stripped key with no
    seed raises."""
    if kk.k1 is not None:
        return kk.k1
    if kk.a_seed is None:
        raise errors.ParameterError("key has no stored k1 and no a_seed to regenerate it")
    if callable(ring):
        ring = ring()
    if tuple(kk.k0.shape[-2:]) != (len(ring.qp_primes), ring.n):
        raise errors.ParameterError(
            f"a {tuple(kk.k0.shape)} key regenerated on a ring of {len(ring.qp_primes)} limbs "
            f"and N={ring.n}: pass the ring of the basis the key was made in")
    return _seeded_a(ring, kk.a_seed, int(kk.k0.shape[0]), mont=True)


def expand_seeded(obj, ring: RingView):
    """Inverse of strip_seeded: regenerate the dropped halves."""
    if isinstance(obj, PublicKey) and obj.pk1 is None:
        return dataclasses.replace(obj, pk1=_seeded_a(ring, obj.a_seed, None, mont=True))
    if isinstance(obj, (KSKey, GaloisKeyOne)) and obj.k1 is None:
        return dataclasses.replace(obj, k1=ensure_k1(ring, obj))
    if isinstance(obj, GaloisKey):
        return GaloisKey({k: expand_seeded(v, ring) for k, v in obj.keys.items()})
    return obj


# =========================================================================
# Method-I keyswitch: one digit per Q prime
# =========================================================================

def slice_key_level(k_arr, k_lvl: int, k_full: int, digits: Optional[int] = None):
    """Restrict a (d, k_full+p, n) key to the level basis: the first `digits`
    digits (default k_lvl, one per prime as in Method I; Method II passes
    ceil(k_lvl/alpha)) and the limbs of the first k_lvl Q primes and the
    special prime(s), contiguous as the kernels take it."""
    d = k_lvl if digits is None else digits
    if k_lvl == k_full and d == k_arr.shape[0]:
        return k_arr
    return torch.cat([k_arr[:d, :k_lvl], k_arr[:d, k_full:]], dim=1)


def hoist_digits(poly_q, base_qp: rns.Base, ntt_qp: nttm.NttTables, in_ntt: bool,
                 ntt_q: Optional[nttm.NttTables] = None):
    """Phase 1: the RNS-digit broadcast of poly_q (k, n) into every limb of
    Q·P, then the forward transform (K1 on the card) -> (k, k+p, n).  Shared
    by many rotations of one ciphertext."""
    if in_ntt:
        poly_q = nttm.ntt_inv(poly_q, ntt_q)
    return nttm.ntt_fwd(rns.decompose_to_base(poly_q, base_qp), ntt_qp)


def hoisted_mac(d_ntt, k0, k1, base_qp: rns.Base):
    """Phase 2: Σ_d digit × key over Q·P for both key halves, one
    `rns.mac_keys` call (K2 on the card): the P-scaled pair (2, k+p, n)
    before the ÷P step."""
    return rns.mac_keys(d_ntt, k0, k1, base_qp)


def ks_finish(acc, ntt_qp: nttm.NttTables, div_p, out_ntt: bool,
              ntt_q: Optional[nttm.NttTables] = None):
    """Phase 3: INTT over Q·P, exact ÷P with rounding (div_p: a DivRoundLastq,
    or a Method-II DivRoundChain; one K6 launch on the card), optional NTT
    over Q.  acc: (..., k+p, n) NTT domain."""
    out = div_p(nttm.ntt_inv(acc, ntt_qp))
    return nttm.ntt_fwd(out, ntt_q) if out_ntt else out


def keyswitch_core(poly_q, k0, k1, base_qp: rns.Base, ntt_qp: nttm.NttTables,
                   div_p: rns.DivRoundLastq, in_ntt: bool, out_ntt: bool,
                   ntt_q: Optional[nttm.NttTables] = None):
    """Method-I keyswitch of one poly over the (possibly leveled) basis.
    poly_q: (k, n) over the Q part of base_qp.  Returns (d0, d1) over Q."""
    d_ntt = hoist_digits(poly_q, base_qp, ntt_qp, in_ntt, ntt_q)
    out = ks_finish(hoisted_mac(d_ntt, k0, k1, base_qp), ntt_qp, div_p, out_ntt, ntt_q)
    return out[0], out[1]
