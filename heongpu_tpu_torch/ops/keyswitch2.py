"""Method-II (hybrid) keyswitching (port of heongpu_tpu/ops/keyswitch2.py).

The k Q-primes split into d̃ = ceil(k/alpha) consecutive groups; each digit
is the exact value [c]_{D_j} carried into the full Q·P basis by FastBconv,
transformed, MAC'd against the key halves, transformed back, and divided by
P = Π special primes, one prime after another (one K6 launch on the card).

A 2-D poly with at most 16 digits (the reference's condition for its fused
route) goes through the fused core (ops/keyswitch_fused.py: K5 on the card,
its plain composition on the CPU); batched input takes the staged path
(K1 and K2 on the card).  Both routes are exact and return the same residues.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import torch

from . import keyswitch_fused
from . import ntt as nttm
from . import rns


@dataclasses.dataclass(frozen=True, eq=False)
class KS2Level:
    """Method-II tables for one level (a fixed active-prime prefix)."""
    alpha: int
    groups: Tuple[Tuple[int, ...], ...]   # active prime indices per digit
    num_active: int
    convs: Tuple[rns.BaseConv, ...]       # group primes -> active Q + P basis
    div_stages: rns.DivRoundChain         # divide by each special prime (one K6 launch)


def build_ks2_level(q_primes: Sequence[int], p_primes: Sequence[int],
                    ka: int, alpha: int, device) -> KS2Level:
    """Tables for the level with active primes q_primes[:ka]."""
    active = [int(q) for q in q_primes[:ka]]
    specials = [int(q) for q in p_primes]
    groups = tuple(tuple(range(j, min(j + alpha, ka))) for j in range(0, ka, alpha))
    target_basis = active + specials
    convs = tuple(rns.BaseConv.build([active[i] for i in g], target_basis, device)
                  for g in groups)
    stages = []
    remaining = list(target_basis)
    for sp in reversed(specials):
        remaining = remaining[:-1]
        stages.append(rns.DivRoundLastq.build(remaining, sp, device))
    return KS2Level(alpha=alpha, groups=groups, num_active=ka,
                    convs=convs, div_stages=rns.DivRoundChain.build(stages))


def keyswitch2(poly_q, k0, k1, ks2: KS2Level, ntt_qp_level: nttm.NttTables,
               base_qp_level: rns.Base, in_ntt: bool, out_ntt: bool,
               ntt_q_level: nttm.NttTables):
    """Method-II keyswitch of one poly over the level basis.

    poly_q: (ka, n) or batched (..., ka, n); k0/k1: (d̃, ka+alpha, n) NTT +
    Montgomery (already sliced to the level).  Returns (d0, d1) over the
    active Q primes."""
    if poly_q.ndim == 2 and len(ks2.groups) <= 16:
        return keyswitch_fused.keyswitch2_fused(poly_q, k0, k1, ks2, ntt_qp_level,
                                                base_qp_level, in_ntt, out_ntt, ntt_q_level)
    if in_ntt:
        poly_q = nttm.ntt_inv(poly_q, ntt_q_level)
    digits = torch.stack([conv(poly_q[..., g[0]: g[-1] + 1, :])
                          for conv, g in zip(ks2.convs, ks2.groups)], dim=-3)
    d_ntt = nttm.ntt_fwd(digits, ntt_qp_level)            # (d̃, ka+alpha, n)
    acc = ks2.div_stages(nttm.ntt_inv(rns.mac_keys(d_ntt, k0, k1, base_qp_level), ntt_qp_level))
    if out_ntt:
        acc = nttm.ntt_fwd(acc, ntt_q_level)   # both halves in one transform
    return acc[0], acc[1]
