"""The CKKS step on limb-sharded ciphertexts: multiply, relinearize and
rescale over a ('dp', 'limb') mesh, the keys sharded by QP limb.

The JAX package runs its ordinary entry points on such inputs under `jit`
and lets GSPMD insert the collectives (tests/test_parallel.py, the dry run
of __graft_entry__.py).  Torch has no GSPMD, so these entry points take the
same arguments as models/ckks.py's, with the ciphertext's `c` a DTensor, and
run every rank on its own rows with the exchanges written out:

  * a ciphertext (size, L, N), or a batch (B, size, L, N), is placed by
    mesh.ct_sharding (the batch on 'dp'): each of the k ranks of a 'limb'
    group holds L/k consecutive Q limbs, or all of them where it is
    replicated on 'limb' (shard_array_limb_axis's rule: L not a multiple of
    k).  Keys (d, k_gen + p, N) are placed by mesh.shard_array_limb_axis /
    shard_pytree_limb_axis: a rank holds a block of QP rows, or all rows;
  * multiply is limb-local;
  * relinearize: each rank MACs the key rows it holds that are active at the
    level (where the keys are replicated: its own Q limbs and the specials).
    It needs every digit at those rows, so the coefficient rows of c2 are
    gathered first; the digits are built straight into the rank's rows (K2
    base_conv a digit with out_primes the rank's limbs under Method II, the
    digit broadcast under Method I), transformed (K1), MAC'd (K2 mac_keys) and
    transformed back (K1).  The special rows go to every rank and the Q rows
    from the key's blocks to the ciphertext's, where each rank divides by P
    (one K6 launch over its Q limbs and the specials,
    keyswitch_sharded.tail_tables), transforms (K1) and adds;
  * rescale: the last limb's coefficients go to every rank, the rows are
    laid out for the output's limb count, and each rank rounds its own rows.

No rank receives a row of a key: the exchanges move rows of ciphertext
polys only (c2, the MAC'd pair's rows, the last limb, re-laid rows), each
between two ranks in one batch_isend_irecv.  Every rank's shard equals the
same rows of the unsharded ckks entry points' results.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..models import ckks
from ..models.ckks import Ciphertext
from ..ops import modmath as mm
from ..ops import ntt as nttm
from ..ops import polyops, rns
from ..utils import errors
from .keyswitch_sharded import tail_tables


@dataclasses.dataclass(frozen=True)
class _Layout:
    """Where a sharded ciphertext's rows live on the mesh's 'limb' axis."""
    c: DTensor
    k: int            # ranks of a 'limb' group
    rank: int         # this rank's place in it
    sharded: bool     # Q limbs split L/k a rank (else every rank holds all)

    @property
    def group(self):
        return self.c.device_mesh.get_group("limb")

    def block(self, rows: int, r: int, sharded=None):
        """Rank r's [lo, hi) of `rows` limbs, sharded as this layout (or as
        `sharded` says)."""
        if not (self.sharded if sharded is None else sharded):
            return 0, rows
        m = rows // self.k
        return r * m, (r + 1) * m

    def wrap(self, local, sharded: bool):
        """A DTensor of this layout's mesh from this rank's rows: the limb axis
        sharded or replicated on 'limb', every other mesh axis as before."""
        mesh, axis = self.c.device_mesh, local.ndim - 2
        li = mesh.mesh_dim_names.index("limb")
        place = list(self.c.placements)
        place[li] = Shard(axis) if sharded else Replicate()
        return DTensor.from_local(local, mesh, place, run_check=False)


def _layout(c) -> _Layout:
    if not isinstance(c, DTensor):
        raise TypeError("the sharded CKKS step takes a ciphertext whose c is a DTensor "
                        "(parallel.mesh.ct_sharding or shard_array_limb_axis)")
    mesh = c.device_mesh
    li = mesh.mesh_dim_names.index("limb")
    k, pl, axis = mesh.size(li), c.placements[li], c.ndim - 2
    if pl.is_shard(axis) and c.shape[axis] % k == 0:
        sharded = True
    elif pl.is_replicate():
        sharded = False
    else:
        raise ValueError(f"a ciphertext of {c.shape[axis]} limbs placed {pl} on a limb axis of "
                         f"{k}: shard its limb axis evenly or replicate it")
    return _Layout(c, k, mesh.get_local_rank("limb"), sharded)


def _runs(pos):
    """(start, length) of each run of consecutive numbers in the list pos."""
    out, start = [], 0
    for i in range(1, len(pos) + 1):
        if i == len(pos) or pos[i] != pos[i - 1] + 1:
            out.append((pos[start], i - start))
            start = i
    return out


def _rows(x, pos):
    """x's rows at positions pos along axis -2, cut as slices of its runs: an
    index tensor would be a host-to-device copy, which waits for the card."""
    if pos == list(range(x.shape[-2])):
        return x
    parts = [x.narrow(-2, a, m) for a, m in _runs(pos)] or [x.narrow(-2, 0, 0)]
    return torch.cat(parts, dim=-2) if len(parts) > 1 else parts[0].contiguous()


def _move_rows(x, have, want, lay: _Layout):
    """Rows of x (..., rows, N) moved between two layouts of one 'limb' group:
    x holds this rank's rows have[rank] (global row numbers, in order); the
    result holds its rows want[rank], in order.  A row comes from this rank
    where it holds it, else from the lowest rank that does; at most one
    message each way between two ranks, all in one batch_isend_irecv."""
    k, rank, group = lay.k, lay.rank, lay.group

    def src(r, row):
        return r if row in have[r] else min(s for s in range(k) if row in have[s])

    ops, got = [], []
    for peer in range(k):
        if peer == rank:
            continue
        out = [have[rank].index(row) for row in want[peer] if src(peer, row) == rank]
        if out:
            ops.append(dist.P2POp(dist.isend, _rows(x, out).contiguous(),
                                  dist.get_global_rank(group, peer), group))
        inc = [row for row in want[rank] if src(rank, row) == peer]
        if inc:
            buf = x.new_empty(x.shape[:-2] + (len(inc), x.shape[-1]))
            got.append((inc, buf))
            ops.append(dist.P2POp(dist.irecv, buf, dist.get_global_rank(group, peer), group))
    if ops:
        for w in dist.batch_isend_irecv(ops):
            w.wait()
    pos = {row: i for i, row in enumerate(have[rank])}
    for inc, _ in got:
        base = len(pos)
        pos.update((row, base + j) for j, row in enumerate(inc))
    full = torch.cat([x] + [buf for _, buf in got], dim=-2) if got else x
    return _rows(full, [pos[row] for row in want[rank]])


def multiply(ctx, a: Ciphertext, b: Ciphertext) -> Ciphertext:
    """ckks.multiply on two ciphertexts of the same layout: the tensor product
    of each rank's rows."""
    errors.check_level(a.level, b.level)
    errors.check_size(a.size, 2, "multiply")
    errors.check_size(b.size, 2, "multiply")
    lay = _layout(a.c)
    if a.c.shape != b.c.shape or a.c.placements != b.c.placements:
        raise ValueError(f"operands placed apart: {a.c.shape} {a.c.placements} and "
                         f"{b.c.shape} {b.c.placements}")
    lo, hi = lay.block(ctx.active(a.level), lay.rank)
    p = ctx.base_q_at(a.level).col()[lo:hi]
    x, y = a.c.to_local().movedim(-3, 0), b.c.to_local().movedim(-3, 0)
    c = polyops.tensor_product(x, y, p).movedim(0, -3).contiguous()
    return Ciphertext(lay.wrap(c, lay.sharded), 3, a.level, a.scale * b.scale)


def _key_local(kt, lay: _Layout):
    """(this rank's rows of a key half, the first key row they hold, whether
    the key is sharded): a DTensor sharded on its QP axis over 'limb' gives
    its block, a replicated one all rows."""
    if not isinstance(kt, DTensor):
        raise TypeError("the sharded step takes keys placed by parallel.mesh."
                        "shard_pytree_limb_axis (DTensors)")
    pl = kt.placements[kt.device_mesh.mesh_dim_names.index("limb")]
    if pl.is_replicate():
        return kt.to_local(), 0, False
    if not pl.is_shard(1) or kt.shape[1] % lay.k:
        raise ValueError(f"a key of {kt.shape[1]} QP rows placed {pl}: place it with "
                         "parallel.mesh.shard_array_limb_axis")
    return kt.to_local(), lay.rank * (kt.shape[1] // lay.k), True


def _key_rows(kl, d: int, sel):
    """The first d digits of a local key half at local rows sel, contiguous."""
    return _rows(kl if d == kl.shape[0] else kl[:d], sel).contiguous()


def _memo(ctx, key, make):
    """ctx._level_tables[key], made by make() at first use: a rank's tables
    live as long as the context."""
    key = ("sharded",) + key
    if key not in ctx._level_tables:
        ctx._level_tables[key] = make()
    return ctx._level_tables[key]


def _limbs(ctx, lo: int, hi: int) -> nttm.NttTables:
    """The context's NTT tables over Q·P limbs [lo, hi)."""
    return _memo(ctx, ("limbs", lo, hi), lambda: ctx.ntt_qp.slice_limbs(lo, hi))


def _mac_tables(ctx, level: int, pos: tuple):
    """The rank's MAC rows' tables at positions `pos` of the level basis (its
    active Q limbs, then the specials): NTT tables, RNS constants and, under
    Method II, each digit's base conversion into those limbs."""
    def make():
        tq = ctx.ntt_qp_at(level)
        runs = [tq.slice_limbs(a, a + m) for a, m in _runs(list(pos))]
        ntt = runs[0]
        for r in runs[1:]:
            ntt = ntt.concat(r)
        convs = ()
        if ctx.ks_type == "II":
            q = ctx.q_primes
            convs = tuple(rns.BaseConv.build([q[i] for i in g], ntt.primes, ctx.device)
                          for g in ctx.ks2[level].groups)
        return ntt, ctx.base_qp_at(level).take(list(pos)), convs
    return _memo(ctx, ("mac", level, pos), make)


def _mac(d_ntt, k0, k1, base):
    """rns.mac_keys over the digit axis of d_ntt (..., d, m, N): one launch a
    batch element."""
    if d_ntt.ndim == 3:
        return rns.mac_keys(d_ntt, k0, k1, base)
    flat = d_ntt.reshape((-1,) + tuple(d_ntt.shape[-3:]))
    return torch.stack([rns.mac_keys(x, k0, k1, base) for x in flat]).reshape(
        d_ntt.shape[:-3] + (2,) + tuple(d_ntt.shape[-2:]))


def relinearize(ctx, a: Ciphertext, rk) -> Ciphertext:
    """ckks.relinearize on a sharded size-3 ciphertext with a relinearization
    key placed by parallel.mesh.shard_pytree_limb_axis: the result keeps the
    input's layout."""
    errors.check_size(a.size, 3, "relinearize")
    lay = _layout(a.c)
    if rk.k1 is None:
        raise errors.ParameterError("the sharded step takes keys with both halves stored "
                                    "(expand a stripped key with ringkit.expand_seeded)")
    ka, p, k = ctx.active(a.level), len(ctx.p_primes), lay.k
    if a.c.shape[-2] != ka:
        raise errors.LevelMismatchError(f"{a.c.shape[-2]} limbs at level {a.level}, not {ka}")
    kl0, k_lo, k_sharded = _key_local(rk.k0, lay)
    kl1, _, _ = _key_local(rk.k1, lay)
    rows_all = rk.k0.shape[1]
    k_gen = rows_all - p
    ckks._check_key_level(ctx, ka, k_gen)
    d = -(-ka // ctx.alpha)
    c = a.c.to_local()
    q_block = lambda r: list(range(*lay.block(ka, r)))
    specials = list(range(k_gen, rows_all))

    def mac_rows(r):
        """The key rows (QP rows of the key's own basis) that rank r MACs."""
        if k_sharded:
            m = rows_all // k
            return [row for row in range(r * m, (r + 1) * m) if row < ka or row >= k_gen]
        return q_block(r) + specials

    # c2's coefficient rows, all of them on every rank: each MAC row needs every digit
    lo, hi = lay.block(ka, lay.rank)
    c2 = nttm.ntt_inv(c.select(-3, 2).contiguous(), _limbs(ctx, lo, hi))
    c2 = _move_rows(c2, [q_block(r) for r in range(k)], [list(range(ka))] * k, lay)
    rows = mac_rows(lay.rank)
    if rows:
        pos = tuple(row if row < k_gen else ka + row - k_gen for row in rows)
        ntt_r, base_r, convs = _mac_tables(ctx, a.level, pos)
        if convs:
            digits = torch.stack([conv(c2[..., g[0]: g[-1] + 1, :])
                                  for conv, g in zip(convs, ctx.ks2[a.level].groups)], dim=-3)
        else:
            digits = rns.decompose_to_base(c2, base_r)
        sel = [row - k_lo for row in rows]
        acc = _mac(nttm.ntt_fwd(digits, ntt_r), _key_rows(kl0, d, sel),
                   _key_rows(kl1, d, sel), base_r)
        acc = nttm.ntt_inv(acc, ntt_r)
    else:
        acc = c2.new_empty(c2.shape[:-2] + (2, 0, c2.shape[-1]))
    # the specials to every rank, the Q rows to the ciphertext's blocks; ÷P, NTT, add
    part = _move_rows(acc, [mac_rows(r) for r in range(k)],
                      [q_block(r) + specials for r in range(k)], lay)
    _, chain, ntt_q = tail_tables(ctx.ntt_qp_at(a.level), ctx.ntt_q(a.level), ka, lo, hi)
    delta = nttm.ntt_fwd(chain(part), ntt_q)
    out = mm.add_mod(c.narrow(-3, 0, 2), delta, ctx.base_q_at(a.level).col()[lo:hi])
    return Ciphertext(lay.wrap(out, lay.sharded), 2, a.level, a.scale)


def rescale(ctx, a: Ciphertext) -> Ciphertext:
    """ckks.rescale on a sharded ciphertext: the output's ka - 1 limbs are
    sharded where they divide the 'limb' axis and replicated where they do not
    (shard_array_limb_axis's rule)."""
    ka = ctx.active(a.level)
    if ka <= 1:
        raise errors.LevelMismatchError(
            "no limb left to rescale (ciphertext already at the last level)")
    lay = _layout(a.c)
    k, c = lay.k, a.c.to_local()
    out_sharded = (ka - 1) % k == 0
    inb = [lay.block(ka, r) for r in range(k)]
    outb = [lay.block(ka - 1, r, out_sharded) for r in range(k)]
    dv = ctx.div_level[a.level]
    # the last limb in the coefficient domain, on every rank
    lo, hi = inb[lay.rank]
    if lo <= ka - 1 < hi:
        last = nttm.ntt_inv(c.narrow(-2, ka - 1 - lo, 1).contiguous(), _limbs(ctx, ka - 1, ka))
    else:
        last = c.narrow(-2, 0, 0)
    last = _move_rows(last, [[ka - 1] if b[0] <= ka - 1 < b[1] else [] for b in inb],
                      [[ka - 1]] * k, lay)
    # this rank's output rows, moved from the input's layout
    olo, ohi = outb[lay.rank]
    x = _move_rows(c, [list(range(*b)) for b in inb], [list(range(*b)) for b in outb], lay)
    pj = dv.qbase.col()[olo:ohi]
    r = torch.remainder(last.to(mm.I64) + dv.half, dv.p_last)
    r_mod = mm.sub_mod(torch.remainder(r, pj), dv.half_mod.to(mm.I64)[olo:ohi, None], pj)
    lift = nttm.ntt_fwd(r_mod, _limbs(ctx, olo, ohi))
    out = mm.mul_mod(mm.sub_mod(x, lift, pj), dv.pinv_mod.to(mm.I64)[olo:ohi, None], pj)
    return Ciphertext(lay.wrap(out, out_sharded), a.size, a.level + 1,
                      a.scale / int(ctx.q_primes[ka - 1]))
