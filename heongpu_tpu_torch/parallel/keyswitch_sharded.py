"""Digit-parallel sharded Method-II keyswitch (port of
heongpu_tpu/parallel/keyswitch_sharded.py).

The evaluation keys are what fills a device at large N (8.9 GiB at N=2^16
depth 48), so the multi-device answer is to shard the KEYS, with the one
collective placed by hand, as in a row-parallel matrix product:

  * mesh axis 'limb' = DIGIT shards: rank i of k owns d̃/k consecutive digit
    groups: its slice of the ciphertext's Q limbs (group-aligned), its
    groups' base-conversion tables, and its (d̃/k, QP, n) slice of the key.
    Key memory per device falls by 1/k.
  * per rank, locally: the digits (the Shoup scale and the base conversion
    to the full Q̃ basis, one K2 base_conv launch a digit with the scaling
    fused), their forward NTT over Q̃ (K1) and the MAC against its own key
    slice (K2 mac_keys): a partial accumulator pair (2, QP, n).
  * ONE collective: a log2(k)-round XOR-butterfly all-reduce with modular
    adds (batch_isend_irecv with rank ^ step, then add_mod): values stay
    below p < 2^30, where a raw sum of k int32 partials would overflow.
  * the tail (INTT over Q̃, the ÷P chain, NTT over Q) is per limb, so each
    rank runs it on its own Q limbs and the p special limbs (K1 inverse, K6,
    K1 forward) and returns its limb slice, the JAX package's output
    sharding.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..ops import modmath as mm
from ..ops import ntt as nttm
from ..ops import rns
from ..ops.keyswitch2 import KS2Level, div_chain


@dataclasses.dataclass(frozen=True, eq=False)
class StackedConv:
    """The per-group base-conversion tables of one KS2Level, stacked on a
    leading digit axis so that a rank takes its digits' rows."""
    alpha: int
    d: int                      # number of digits
    ka: int                     # active Q limbs (= d * alpha, group-aligned)
    qhat_inv: torch.Tensor      # (d, alpha)
    qhat_inv_sh: torch.Tensor   # (d, alpha) Shoup companions
    mat_mont: torch.Tensor      # (d, alpha, qp)
    gp: torch.Tensor            # (d, alpha) group primes


def stack_convs(ks2: KS2Level) -> StackedConv:
    convs = ks2.convs
    alpha = len(ks2.groups[0])
    assert all(len(g) == alpha for g in ks2.groups), \
        "digit sharding needs alpha | ka (uniform groups)"
    return StackedConv(
        alpha=alpha, d=len(convs), ka=ks2.num_active,
        qhat_inv=torch.stack([c.scale[1] for c in convs]),
        qhat_inv_sh=torch.stack([c.scale[2] for c in convs]),
        mat_mont=torch.stack([c.mat_mont for c in convs]),
        gp=torch.stack([c.scale[0] for c in convs]))


def _allreduce_mod(acc, p, group, k: int):
    """XOR-butterfly all-reduce with per-round modular adds: after log2(k)
    rounds every rank holds Σ partials mod p, values never leave [0, p)."""
    me = dist.get_rank(group)
    step = 1
    while step < k:
        peer = dist.get_global_rank(group, me ^ step)
        other = torch.empty_like(acc)
        for w in dist.batch_isend_irecv([dist.P2POp(dist.isend, acc, peer, group),
                                         dist.P2POp(dist.irecv, other, peer, group)]):
            w.wait()
        acc = mm.add_mod(acc, other, p)
        step *= 2
    return acc


@functools.lru_cache(maxsize=32)
def tail_tables(ntt_qp: nttm.NttTables, ntt_q: nttm.NttTables, ka: int, lo: int, hi: int):
    """A rank's tail tables: of the level's Q̃ tables ntt_qp (ka Q limbs, then
    the specials), those over Q limbs [lo, hi) and the specials, the ÷P chain
    over that basis, and the Q tables of [lo, hi)."""
    qp = ntt_qp.slice_limbs(lo, hi).concat(ntt_qp.slice_limbs(ka, ntt_qp.num_limbs))
    chain = div_chain(qp.primes[:hi - lo], qp.primes[hi - lo:], ntt_qp.device)
    return qp, chain, ntt_q.slice_limbs(lo, hi)


def keyswitch2_sharded(mesh: DeviceMesh, poly_q, k0, k1, ks2: KS2Level,
                       sc: StackedConv, ntt_qp: nttm.NttTables,
                       base_qp: rns.Base, ntt_q: nttm.NttTables,
                       out_ntt: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """poly_q: this rank's (ka/k, n) COEFF-domain Q limbs, group-aligned (ka/k
    a multiple of alpha); k0/k1: its (d̃/k, qp, n) NTT + Montgomery key
    slices.  Each may instead be a DTensor sharded on its first axis over the
    mesh's 'limb' axis.  Returns (d0, d1), this rank's ka/k limbs of the
    result over the active Q primes (DTensors of the whole, sharded the same
    way, where poly_q is one)."""
    group = mesh.get_group("limb")
    k = mesh.size(mesh.mesh_dim_names.index("limb"))
    rank = mesh.get_local_rank("limb")
    assert sc.d % k == 0, f"digits {sc.d} must divide over limb={k}"
    assert sc.ka % (k * sc.alpha) == 0, "Q limbs must split group-aligned"
    dt = isinstance(poly_q, DTensor)
    loc = lambda t: t.to_local() if isinstance(t, DTensor) else t
    poly, k0, k1 = loc(poly_q), loc(k0), loc(k1)
    D, m = sc.d // k, sc.ka // k
    if poly.shape[0] != m or k0.shape[0] != D or k1.shape[0] != D:
        raise ValueError(f"rank {rank} of {k} takes {m} Q limbs and {D} digits of the keys, "
                         f"got {tuple(poly.shape)}, {tuple(k0.shape)}, {tuple(k1.shape)}")
    # digits: one fused scale + conversion a digit, then K1 and K2's key MAC
    x = poly.reshape(D, sc.alpha, -1)
    digits = torch.stack([ks2.convs[rank * D + i](x[i]) for i in range(D)])
    acc = rns.mac_keys(nttm.ntt_fwd(digits, ntt_qp), k0, k1, base_qp)   # (2, qp, n)
    acc = _allreduce_mod(acc, base_qp.col(), group, k)
    # tail over this rank's Q limbs and the specials: per limb, as the reference's
    # tail partitioned under its output sharding
    qp_loc, chain, q_loc = tail_tables(ntt_qp, ntt_q, ks2.num_active, rank * m, (rank + 1) * m)
    ka = ks2.num_active
    part = torch.cat([acc[:, rank * m:(rank + 1) * m], acc[:, ka:]], dim=1)
    out = chain(nttm.ntt_inv(part.contiguous(), qp_loc))
    if out_ntt:
        out = nttm.ntt_fwd(out, q_loc)
    d0, d1 = out[0], out[1]
    if not dt:
        return d0, d1
    place = [Shard(0) if a == "limb" else Replicate() for a in mesh.mesh_dim_names]
    return (DTensor.from_local(d0, mesh, place, run_check=False),
            DTensor.from_local(d1, mesh, place, run_check=False))
