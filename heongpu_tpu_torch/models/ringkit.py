"""Shared RNS-ring key machinery (port of the full-key subset of
heongpu_tpu/models/ringkit.py).

Key layout as in the reference: the secret key as ternary coefficients plus
its NTT-domain Montgomery form over Q·P; public and keyswitch keys in the NTT
domain over Q·P, Montgomery form.  The Method-II grouped gadget puts P·target
on every limb of digit j's group, so one key serves every level by prefix
slicing.  Draw order follows the reference (uniform half first, then the
gaussian), so DRBG-seeded keys are bit-identical to the JAX package's.
"""

from __future__ import annotations

import dataclasses
from functools import reduce
from typing import Optional

import torch

from ..ops import modmath as mm
from ..ops import ntt as nttm
from ..ops import rns
from ..utils import rng

_prod = lambda xs: reduce(lambda a, b: a * b, xs, 1)


@dataclasses.dataclass(frozen=True, eq=False)
class SecretKey:
    s_coeff: torch.Tensor        # (n,) int32 in {-1,0,1}
    s_ntt_mont_qp: torch.Tensor  # (k+p, n) NTT domain, Montgomery form
    hamming_weight: int


@dataclasses.dataclass(frozen=True, eq=False)
class PublicKey:
    pk0: torch.Tensor  # (k+p, n) NTT, Montgomery form
    pk1: torch.Tensor


@dataclasses.dataclass(frozen=True, eq=False)
class KSKey:
    """Keyswitch key: (d, k+p, n) NTT + Montgomery per half."""
    k0: torch.Tensor
    k1: torch.Tensor


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


def keygen_public(ring: RingView, key, sk: SecretKey) -> PublicKey:
    ka, ke = rng.split(key)
    a = rng.uniform_rns(ka, ring.qp_primes, (ring.n,), ring.device)  # NTT domain
    e = nttm.ntt_fwd(rng.gaussian_rns(ke, ring.qp_primes, (ring.n,), ring.device),
                     ring.ntt_qp)
    b = ring.base_qp
    p, r1 = b.col(), b.col("r1")
    a_s = mm.mont_mul(a, sk.s_ntt_mont_qp, p, b.col("rinv"))
    pk0 = mm.neg_mod(mm.add_mod(a_s, e, p), p)
    return PublicKey(mm.to_mont(pk0, p, r1), mm.to_mont(a, p, r1))


def ks_keygen(ring: RingView, key, sk: SecretKey, target_ntt_mont,
              groups=None) -> KSKey:
    """Keyswitch key encrypting `target` (NTT + Montgomery over QP) under s.
    groups=None: one digit per Q prime (Method I); groups=((0,1),(2,3),...):
    Method-II grouped gadget."""
    if groups is None:
        groups = tuple((i,) for i in range(ring.k))
    d, n = len(groups), ring.n
    ka, ke = rng.split(key)
    b = ring.base_qp
    p, r1, rinv = b.col(), b.col("r1"), b.col("rinv")
    a = rng.uniform_rns(ka, ring.qp_primes, (d, n), ring.device)
    a = a.transpose(0, 1).contiguous()
    e = nttm.ntt_fwd(rng.gaussian_rns(ke, ring.qp_primes, (d, n), ring.device)
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
    return KSKey(mm.to_mont(k0, p, r1), mm.to_mont(a, p, r1))


def keygen_relin(ring: RingView, key, sk: SecretKey, groups=None) -> KSKey:
    b = ring.base_qp
    s2_mont = mm.mont_mul(sk.s_ntt_mont_qp, sk.s_ntt_mont_qp, b.col(), b.col("rinv"))
    return ks_keygen(ring, key, sk, s2_mont, groups=groups)
