"""The CKKS ops on limb-sharded ciphertexts over a ('dp', 'limb') mesh, the
keys sharded by QP limb: the step (multiply, relinearize, rescale), the
rotations and key switches, the limb-local ops, the layout changes and the
hoisted rotations that bootstrapping runs (parallel/boot_sharded.py).

The JAX package runs its ordinary entry points on such inputs under `jit`
and lets GSPMD insert the collectives (tests/test_parallel.py,
tests/test_boot_sharded.py, the dry run of __graft_entry__.py).  Torch has
no GSPMD, so these entry points take the same arguments as models/ckks.py's,
with the ciphertext's `c` a DTensor, and run every rank on its own rows with
the exchanges written out:

  * a ciphertext (size, L, N), or a batch (B, size, L, N), is placed by
    mesh.ct_sharding (the batch on 'dp'): each of the k ranks of a 'limb'
    group holds L/k consecutive Q limbs, or all of them where it is
    replicated on 'limb' (shard_array_limb_axis's rule: L not a multiple of
    k).  Every op that changes the limb count (rescale, mod_drop) lays its
    output out by that rule.  Keys (d, k_gen + p, N) are placed by
    mesh.shard_array_limb_axis / shard_pytree_limb_axis: a rank holds a
    block of QP rows, or all rows;
  * multiply, add, sub, negate, add_plain, multiply_plain,
    multiply_by_monomial and p_scale_to_qtilde are limb-local; the Galois
    gather permutes along N, so it is limb-local too.  A plaintext, a
    monomial table or a diagonal is not a key: a rank takes its rows of one,
    and where they lie on other ranks (a constant placed by its own extent)
    they come over as rows;
  * a keyswitch of one poly (relinearize, apply_galois in both key forms,
    rotate, conjugate, switch_key): each rank MACs the key rows it holds
    that are active at the level (where the key is replicated: its own Q
    limbs and the specials).  It needs every digit at those rows, so the
    poly's coefficient rows are gathered first; the digits are built
    straight into the rank's rows (K2 base_conv a digit with out_primes the
    rank's limbs under Method II, the digit broadcast under Method I),
    transformed (K1), MAC'd (K2 mac_keys) and transformed back (K1).  The
    special rows go to every rank and the Q rows from the key's blocks to
    the ciphertext's, where each rank divides by P (one K6 launch over its Q
    limbs and the specials, keyswitch_sharded.tail_tables), transforms (K1)
    and adds;
  * hoisting: `hoist` builds c1's digits once, on the union of the rows the
    rank's Galois keys need (their blocks differ from key to key);
    `rotate_hoisted_qtilde` gathers the digits by the Galois element, MACs
    the rank's key rows and moves the P-scaled pair to the rows the caller
    names, where the pair takes sigma(P c0).  `ks_finish_at` divides a pair
    on the rank's Q~ rows (its Q rows of the ciphertext's layout and every
    special row) by P locally (one K6 launch, then K1);
  * rescale: the last limb's coefficients go to every rank, the rows are
    laid out for the output's limb count, and each rank rounds its own rows.

No rank receives a row of a key: the exchanges move rows of ciphertext
polys (coefficient rows, MAC'd pairs, the last limb, re-laid rows) and of
plaintext constants, each between two ranks in one batch_isend_irecv.  A
stripped (seeded) key raises ParameterError: regenerating its uniform half
would need the whole key on a rank.  Every rank's shard equals the same rows
of the unsharded ckks entry points' results.
"""

from __future__ import annotations

import dataclasses
from fractions import Fraction

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..models import ckks, ringkit
from ..models.ckks import Ciphertext, Plaintext
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

    def q_rows(self, ka: int, r: int) -> list:
        """Rank r's Q limbs of a ka-limb poly of this layout."""
        return list(range(*self.block(ka, r)))

    def qt_rows(self, ka: int, p: int, r: int) -> list:
        """Rank r's Q~ rows (positions in the level's basis: ka Q limbs, then
        the p specials): its Q limbs and every special."""
        return self.q_rows(ka, r) + list(range(ka, ka + p))

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
        raise TypeError("the sharded CKKS ops take a ciphertext whose c is a DTensor "
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


def _ct_layout(ctx, a: Ciphertext) -> _Layout:
    """a's layout, its limb count checked against its level."""
    lay = _layout(a.c)
    if a.c.shape[-2] != ctx.active(a.level):
        raise errors.LevelMismatchError(
            f"{a.c.shape[-2]} limbs at level {a.level}, not {ctx.active(a.level)}")
    return lay


def _same_layout(a: Ciphertext, b: Ciphertext):
    if a.c.shape[-2:] != b.c.shape[-2:] or a.c.placements != b.c.placements:
        raise ValueError(f"operands placed apart: {a.c.shape} {a.c.placements} and "
                         f"{b.c.shape} {b.c.placements}")


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
    held = [set(h) for h in have]

    def src(r, row):
        return r if row in held[r] else min(s for s in range(k) if row in held[s])

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


def _local(t):
    return t.to_local() if isinstance(t, DTensor) else t


def _held(t, lay: _Layout):
    """The rows (axis -2) each rank holds of a constant placed by its own
    extent (shard_array_limb_axis): each rank's block where t is sharded on
    'limb', None where every rank holds every row (a whole tensor, or a
    DTensor replicated on 'limb')."""
    if not isinstance(t, DTensor):
        return None
    pl = t.placements[t.device_mesh.mesh_dim_names.index("limb")]
    if pl.is_replicate():
        return None
    rows = t.shape[-2]
    if not pl.is_shard(t.ndim - 2) or rows % lay.k:
        raise ValueError(f"a constant of {rows} rows placed {pl}: place it with "
                         "parallel.mesh.shard_array_limb_axis")
    m = rows // lay.k
    return [list(range(r * m, (r + 1) * m)) for r in range(lay.k)]


def _const_rows(t, lay: _Layout, want):
    """Rows want[r] (along axis -2) of a constant on each rank r: a plaintext's
    rows, a monomial table's or a diagonal's.  Where every rank holds every
    row they are cut; a constant sharded by its own extent sends the rows a
    rank lacks."""
    held = _held(t, lay)
    if held is None:
        return _rows(_local(t), want[lay.rank])
    return _move_rows(t.to_local(), held, want, lay)


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


def _q_mod(ctx, level: int, lay: _Layout):
    """The moduli of this rank's Q limbs at `level`, as an (m, 1) column."""
    lo, hi = lay.block(ctx.active(level), lay.rank)
    return ctx.base_q_at(level).col()[lo:hi]


def _basis(ctx, level: int, pos: tuple):
    """NTT tables and RNS constants of positions `pos` of the level's Q~
    basis (its active Q limbs, then the specials)."""
    def make():
        tq = ctx.ntt_qp_at(level)
        runs = [tq.slice_limbs(a, a + m) for a, m in _runs(list(pos))]
        ntt = runs[0]
        for r in runs[1:]:
            ntt = ntt.concat(r)
        return ntt, ctx.base_qp_at(level).take(list(pos))
    return _memo(ctx, ("basis", level, pos), make)


def _convs(ctx, level: int, pos: tuple):
    """Under Method II, each digit's base conversion into positions `pos`."""
    def make():
        primes = _basis(ctx, level, pos)[0].primes
        q = ctx.q_primes
        return tuple(rns.BaseConv.build([q[i] for i in g], primes, ctx.device)
                     for g in ctx.ks2[level].groups)
    return _memo(ctx, ("convs", level, pos), make)


def _mac(d_ntt, k0, k1, base):
    """rns.mac_keys over the digit axis of d_ntt (..., d, m, N): one launch a
    batch element."""
    if d_ntt.ndim == 3:
        return rns.mac_keys(d_ntt, k0, k1, base)
    flat = d_ntt.reshape((-1,) + tuple(d_ntt.shape[-3:]))
    return torch.stack([rns.mac_keys(x, k0, k1, base) for x in flat]).reshape(
        d_ntt.shape[:-3] + (2,) + tuple(d_ntt.shape[-2:]))


# =========================================================================
# Limb-local ops and layout changes
# =========================================================================

def multiply(ctx, a: Ciphertext, b: Ciphertext) -> Ciphertext:
    """ckks.multiply on two ciphertexts of the same layout: the tensor product
    of each rank's rows."""
    errors.check_level(a.level, b.level)
    errors.check_size(a.size, 2, "multiply")
    errors.check_size(b.size, 2, "multiply")
    lay = _layout(a.c)
    _same_layout(a, b)
    p = _q_mod(ctx, a.level, lay)
    x, y = a.c.to_local().movedim(-3, 0), b.c.to_local().movedim(-3, 0)
    c = polyops.tensor_product(x, y, p).movedim(0, -3).contiguous()
    return Ciphertext(lay.wrap(c, lay.sharded), 3, a.level, a.scale * b.scale)


def add(ctx, a: Ciphertext, b: Ciphertext) -> Ciphertext:
    """ckks.add on each rank's rows (the shorter operand padded with zeros)."""
    ckks._check_compat(a, b)
    lay = _layout(a.c)
    _same_layout(a, b)
    sz = max(a.size, b.size)
    x, y = a.c.to_local(), b.c.to_local()
    if a.size < sz:
        x = torch.cat([x, torch.zeros_like(y.narrow(-3, a.size, sz - a.size))], dim=-3)
    elif b.size < sz:
        y = torch.cat([y, torch.zeros_like(x.narrow(-3, b.size, sz - b.size))], dim=-3)
    out = mm.add_mod(x, y, _q_mod(ctx, a.level, lay))
    return Ciphertext(lay.wrap(out, lay.sharded), sz, a.level, a.scale)


def sub(ctx, a: Ciphertext, b: Ciphertext) -> Ciphertext:
    ckks._check_compat(a, b)
    errors.check_size(b.size, a.size, "sub")
    lay = _layout(a.c)
    _same_layout(a, b)
    out = mm.sub_mod(a.c.to_local(), b.c.to_local(), _q_mod(ctx, a.level, lay))
    return Ciphertext(lay.wrap(out, lay.sharded), a.size, a.level, a.scale)


def negate(ctx, a: Ciphertext) -> Ciphertext:
    lay = _layout(a.c)
    out = mm.neg_mod(a.c.to_local(), _q_mod(ctx, a.level, lay))
    return Ciphertext(lay.wrap(out, lay.sharded), a.size, a.level, a.scale)


def encode_const(ctx, value, scale: float, like: Ciphertext) -> Plaintext:
    """ckks.encode_const at like's level, placed as like's c: each rank
    encodes its own rows only (the exact a + b·X^(n/2), then K1 over its
    limbs)."""
    lay = _layout(like.c)
    lo, hi = lay.block(ctx.active(like.level), lay.rank)
    v, s = complex(value), Fraction(scale)
    a, b = int(round(Fraction(v.real) * s)), int(round(Fraction(v.imag) * s))
    primes = [int(q) for q in ctx.q_primes[lo:hi]]
    dev = like.c.to_local().device
    m = torch.zeros((hi - lo, ctx.n), dtype=mm.I32, device=dev)
    m[:, 0] = mm.u32_to_i32([a % q for q in primes]).to(dev)
    if b:
        m[:, ctx.n // 2] = mm.u32_to_i32([b % q for q in primes]).to(dev)
    mesh = like.c.device_mesh
    place = [Shard(0) if name == "limb" and lay.sharded else Replicate()
             for name in mesh.mesh_dim_names]
    m = DTensor.from_local(nttm.ntt_fwd(m, _limbs(ctx, lo, hi)), mesh, place, run_check=False)
    return Plaintext(m, like.level, float(scale))


def _pt_rows(ctx, pt: Plaintext, lay: _Layout):
    """This rank's rows of a plaintext (a whole tensor on every rank, as
    ckks.encode_const makes it, or a DTensor)."""
    ka = ctx.active(pt.level)
    return _const_rows(pt.m, lay, [lay.q_rows(ka, r) for r in range(lay.k)])


def add_plain(ctx, a: Ciphertext, pt: Plaintext) -> Ciphertext:
    errors.check_level(a.level, pt.level, "ciphertext/plaintext")
    errors.check_scale(a.scale, pt.scale)
    lay = _layout(a.c)
    c = a.c.to_local()
    c0 = mm.add_mod(c.select(-3, 0), _pt_rows(ctx, pt, lay), _q_mod(ctx, a.level, lay))
    out = torch.cat([c0.unsqueeze(-3), c.narrow(-3, 1, a.size - 1)], dim=-3)
    return Ciphertext(lay.wrap(out, lay.sharded), a.size, a.level, a.scale)


def multiply_plain(ctx, a: Ciphertext, pt: Plaintext) -> Ciphertext:
    errors.check_level(a.level, pt.level, "ciphertext/plaintext")
    lay = _layout(a.c)
    out = mm.mul_mod(a.c.to_local(), _pt_rows(ctx, pt, lay), _q_mod(ctx, a.level, lay))
    return Ciphertext(lay.wrap(out, lay.sharded), a.size, a.level, a.scale * pt.scale)


def multiply_by_monomial(ctx, a: Ciphertext, tables) -> Ciphertext:
    """ckks.multiply_by_monomial with tables from ckks.monomial_mult_tables
    (whole on every rank or placed on the mesh): each rank takes the table's
    rows of its limbs."""
    lay = _layout(a.c)
    ka = ctx.active(a.level)
    tab = _const_rows(tables[0], lay, [lay.q_rows(ka, r) for r in range(lay.k)])
    out = mm.mul_mod(a.c.to_local(), tab, _q_mod(ctx, a.level, lay))
    return Ciphertext(lay.wrap(out, lay.sharded), a.size, a.level, a.scale)


def mod_drop(ctx, a: Ciphertext, levels: int = 1) -> Ciphertext:
    """ckks.mod_drop: the first ka - levels limbs, re-laid for their count
    (shard_array_limb_axis's rule, as rescale)."""
    if levels == 0:
        return a
    lay = _ct_layout(ctx, a)
    ka = ctx.active(a.level)
    kb, out_sharded = ka - levels, (ka - levels) % lay.k == 0
    x = _move_rows(a.c.to_local(), [lay.q_rows(ka, r) for r in range(lay.k)],
                   [list(range(*lay.block(kb, r, out_sharded))) for r in range(lay.k)], lay)
    return Ciphertext(lay.wrap(x, out_sharded), a.size, a.level + levels, a.scale)


def p_scale_to_qtilde(ctx, poly_q, level: int, pos):
    """ckks.p_scale_to_qtilde on positions pos of the level's Q~ basis (in
    order): poly_q holds x's rows at pos's Q limbs; the result P·x at pos
    (P mod q_i on the Q limbs, zeros on the specials)."""
    ka = ctx.active(level)
    qs = [q for q in pos if q < ka]

    def make():
        P = ckks._prod(int(p) for p in ctx.p_primes)
        return torch.tensor([P % int(ctx.q_primes[q]) for q in qs], dtype=mm.I64,
                            device=poly_q.device)[:, None]
    fac = _memo(ctx, ("p_scale", level, tuple(qs)), make)
    scaled = mm.shoup_mul(poly_q, fac, _basis(ctx, level, tuple(qs))[1].col()) if qs else poly_q
    zeros = scaled.new_zeros(poly_q.shape[:-2] + (len(pos) - len(qs), ctx.n))
    return torch.cat([scaled, zeros], dim=-2)


# =========================================================================
# The keyswitch of one poly, and the ops on it
# =========================================================================

@dataclasses.dataclass(frozen=True, eq=False)
class _Key:
    """A placed keyswitch key seen from one rank."""
    k0: torch.Tensor      # this rank's rows of each half
    k1: torch.Tensor
    lo: int               # the first key row they hold
    sharded: bool
    rows_all: int         # k_gen + p
    k_gen: int
    ka: int               # active Q limbs at the level of use

    def pos(self, lay: _Layout, r: int) -> list:
        """Positions in the level's Q~ basis of the key rows rank r MACs: its
        block's rows active at the level, or, where the key is replicated,
        the rank's Q~ rows."""
        p = self.rows_all - self.k_gen
        if not self.sharded:
            return lay.qt_rows(self.ka, p, r)
        m = self.rows_all // lay.k
        return [row if row < self.k_gen else self.ka + row - self.k_gen
                for row in range(r * m, (r + 1) * m) if row < self.ka or row >= self.k_gen]

    def halves(self, d: int, pos) -> tuple:
        """The first d digits of both halves at the level positions pos (this
        rank's), contiguous."""
        sel = [(q if q < self.ka else self.k_gen + q - self.ka) - self.lo for q in pos]
        cut = lambda kl: _rows(kl if d == kl.shape[0] else kl[:d], sel).contiguous()
        return cut(self.k0), cut(self.k1)


def _key_local(kt, lay: _Layout):
    """(this rank's rows of a key half, the first key row they hold, whether
    the key is sharded): a DTensor sharded on its QP axis over 'limb' gives
    its block, a replicated one all rows."""
    if not isinstance(kt, DTensor):
        raise TypeError("the sharded ops take keys placed by parallel.mesh."
                        "shard_pytree_limb_axis (DTensors)")
    pl = kt.placements[kt.device_mesh.mesh_dim_names.index("limb")]
    if pl.is_replicate():
        return kt.to_local(), 0, False
    if not pl.is_shard(1) or kt.shape[1] % lay.k:
        raise ValueError(f"a key of {kt.shape[1]} QP rows placed {pl}: place it with "
                         "parallel.mesh.shard_array_limb_axis")
    return kt.to_local(), lay.rank * (kt.shape[1] // lay.k), True


def _key(ctx, kk, lay: _Layout, level: int) -> _Key:
    """A KSKey or GaloisKeyOne placed on the mesh, checked for use at `level`."""
    if kk.k1 is None:
        raise errors.ParameterError("the sharded ops take keys with both halves stored "
                                    "(expand a stripped key with ringkit.expand_seeded)")
    kl0, lo, sharded = _key_local(kk.k0, lay)
    kl1, _, _ = _key_local(kk.k1, lay)
    rows_all = kk.k0.shape[1]
    k_gen, ka = rows_all - len(ctx.p_primes), ctx.active(level)
    ckks._check_key_level(ctx, ka, k_gen)
    return _Key(kl0, kl1, lo, sharded, rows_all, k_gen, ka)


def _digit_count(ctx, ka: int) -> int:
    return -(-ka // ctx.alpha)


def _gather_coeffs(ctx, poly, level: int, lay: _Layout):
    """All ka coefficient rows of a poly (NTT domain, this rank's Q limbs of
    `lay`) on every rank: each digit touches every row a rank MACs."""
    ka = ctx.active(level)
    lo, hi = lay.block(ka, lay.rank)
    c = nttm.ntt_inv(poly.contiguous(), _limbs(ctx, lo, hi))
    return _move_rows(c, [lay.q_rows(ka, r) for r in range(lay.k)], [list(range(ka))] * lay.k,
                      lay)


def _digits(ctx, level: int, coeffs, pos: tuple):
    """The keyswitch digits of all ka coefficient rows at positions pos of the
    level's Q~ basis, NTT domain (K2 base_conv a digit under Method II, the
    digit broadcast under Method I; then K1)."""
    ntt_r, base_r = _basis(ctx, level, pos)
    if ctx.ks_type == "II":
        digits = torch.stack([conv(coeffs[..., g[0]: g[-1] + 1, :]) for conv, g in
                              zip(_convs(ctx, level, pos), ctx.ks2[level].groups)], dim=-3)
    else:
        digits = rns.decompose_to_base(coeffs, base_r)
    return nttm.ntt_fwd(digits, ntt_r)


def _tail(ctx, part, level: int, lay: _Layout):
    """÷P of a coefficient-domain pair on the rank's Q~ rows (one K6 launch),
    then K1 over its Q limbs."""
    ka = ctx.active(level)
    lo, hi = lay.block(ka, lay.rank)
    _, chain, ntt_q = tail_tables(ctx.ntt_qp_at(level), ctx.ntt_q(level), ka, lo, hi)
    return nttm.ntt_fwd(chain(part), ntt_q)


def _keyswitch(ctx, poly, kk, level: int, lay: _Layout):
    """The keyswitch of one poly (NTT domain, this rank's Q limbs of `lay`)
    with a placed key: (..., 2, its Q limbs, N), NTT domain."""
    key = _key(ctx, kk, lay, level)
    ka, p = ctx.active(level), len(ctx.p_primes)
    coeffs = _gather_coeffs(ctx, poly, level, lay)
    pos = key.pos(lay, lay.rank)
    if pos:
        ntt_r, base_r = _basis(ctx, level, tuple(pos))
        acc = _mac(_digits(ctx, level, coeffs, tuple(pos)),
                   *key.halves(_digit_count(ctx, ka), pos), base_r)
        acc = nttm.ntt_inv(acc, ntt_r)
    else:
        acc = coeffs.new_empty(coeffs.shape[:-2] + (2, 0, coeffs.shape[-1]))
    # the specials to every rank, the Q rows to the ciphertext's blocks; ÷P, NTT
    part = _move_rows(acc, [key.pos(lay, r) for r in range(lay.k)],
                      [lay.qt_rows(ka, p, r) for r in range(lay.k)], lay)
    return _tail(ctx, part, level, lay)


def relinearize(ctx, a: Ciphertext, rk) -> Ciphertext:
    """ckks.relinearize on a sharded size-3 ciphertext with a relinearization
    key placed by parallel.mesh.shard_pytree_limb_axis: the result keeps the
    input's layout."""
    errors.check_size(a.size, 3, "relinearize")
    lay = _ct_layout(ctx, a)
    c = a.c.to_local()
    delta = _keyswitch(ctx, c.select(-3, 2), rk, a.level, lay)
    out = mm.add_mod(c.narrow(-3, 0, 2), delta, _q_mod(ctx, a.level, lay))
    return Ciphertext(lay.wrap(out, lay.sharded), 2, a.level, a.scale)


def _pair(c0, d, p):
    """(c0 + d0, d1) over the ciphertext axis."""
    return torch.stack([mm.add_mod(c0, d.select(-3, 0), p), d.select(-3, 1)], dim=-3)


def apply_galois(ctx, a: Ciphertext, gk1) -> Ciphertext:
    """ckks.apply_galois with a placed GaloisKeyOne, in either key form: the
    gather is limb-local, the keyswitch as relinearize's."""
    errors.check_size(a.size, 2, "apply_galois")
    lay = _ct_layout(ctx, a)
    c, perm, p = a.c.to_local(), _local(gk1.perm_ntt), _q_mod(ctx, a.level, lay)
    if gk1.inv_form:
        d = _keyswitch(ctx, c.select(-3, 1), gk1, a.level, lay)
        out = polyops.apply_galois_ntt(_pair(c.select(-3, 0), d, p), perm)
    else:
        g = polyops.apply_galois_ntt(c, perm)
        out = _pair(g.select(-3, 0), _keyswitch(ctx, g.select(-3, 1), gk1, a.level, lay), p)
    return Ciphertext(lay.wrap(out, lay.sharded), 2, a.level, a.scale)


def rotate(ctx, a: Ciphertext, gk, step: int) -> Ciphertext:
    """ckks.rotate: the stored power-of-two keys, one sharded apply_galois each."""
    return ringkit.rotate_by_steps(a, gk, step, ctx.n, lambda c, k: apply_galois(ctx, c, k))


def conjugate(ctx, a: Ciphertext, gk) -> Ciphertext:
    return apply_galois(ctx, a, gk.keys[polyops.GALOIS_CONJ])


def switch_key(ctx, a: Ciphertext, swk) -> Ciphertext:
    errors.check_size(a.size, 2, "switch_key")
    lay = _ct_layout(ctx, a)
    c = a.c.to_local()
    out = _pair(c.select(-3, 0), _keyswitch(ctx, c.select(-3, 1), swk, a.level, lay),
                _q_mod(ctx, a.level, lay))
    return Ciphertext(lay.wrap(out, lay.sharded), 2, a.level, a.scale)


# =========================================================================
# Hoisted rotations
# =========================================================================

@dataclasses.dataclass(frozen=True, eq=False)
class Hoisted:
    """A ciphertext's c1 digits (NTT domain) on the Q~ rows that this rank's
    Galois keys need: ckks.hoist's result, cut to those rows."""
    d_ntt: torch.Tensor   # (d, len(pos), N)
    pos: tuple            # their positions in the level's Q~ basis
    level: int
    lay: _Layout


def hoist(ctx, a: Ciphertext, keys) -> Hoisted:
    """ckks.hoist for rotations by the placed GaloisKeyOnes `keys`: c1's
    coefficient rows gathered once, its digits built once, on the union of
    the rows the rank MACs for any of those keys."""
    errors.check_size(a.size, 2, "hoist")
    lay = _ct_layout(ctx, a)
    pos = sorted(set().union(*(_key(ctx, kk, lay, a.level).pos(lay, lay.rank) for kk in keys)))
    coeffs = _gather_coeffs(ctx, a.c.to_local().select(-3, 1), a.level, lay)
    if pos:
        d_ntt = _digits(ctx, a.level, coeffs, tuple(pos))
    else:
        d_ntt = coeffs.new_empty((_digit_count(ctx, ctx.active(a.level)), 0, ctx.n))
    return Hoisted(d_ntt, tuple(pos), a.level, lay)


def rotate_hoisted_qtilde(ctx, h: Hoisted, gk1, pc0, level: int, want):
    """ckks.rotate_hoisted_qtilde on rows of the level's Q~ basis: the digits'
    rows of this key gathered by its Galois element (inv_form: the MAC'd
    pair), K2 mac_keys on the rank's key rows, the pair moved to rows want[r]
    on each rank r, plus sigma(pc0) there (pc0: p_scale_to_qtilde of c0 at
    those rows)."""
    lay = h.lay
    key = _key(ctx, gk1, lay, level)
    perm = _local(gk1.perm_ntt)
    mine = key.pos(lay, lay.rank)
    if mine:
        at = {q: i for i, q in enumerate(h.pos)}
        d = _rows(h.d_ntt, [at[q] for q in mine])
        if not gk1.inv_form:
            d = polyops.apply_galois_ntt(d, perm)
        acc = rns.mac_keys(d, *key.halves(h.d_ntt.shape[0], mine),
                           _basis(ctx, level, tuple(mine))[1])
        if gk1.inv_form:
            acc = polyops.apply_galois_ntt(acc, perm)
    else:
        acc = h.d_ntt.new_empty((2, 0, ctx.n))
    acc = _move_rows(acc, [key.pos(lay, r) for r in range(lay.k)], want, lay)
    pq = _basis(ctx, level, tuple(want[lay.rank]))[1].col()
    return mm.add_mod(acc[0], polyops.apply_galois_ntt(pc0, perm), pq), acc[1]


def ks_finish_at(ctx, acc, level: int, lay: _Layout):
    """ckks.ks_finish_at on a pair held on the rank's Q~ rows (NTT domain):
    K1 inverse, ÷P (one K6 launch), K1 over its Q limbs."""
    ka = ctx.active(level)
    lo, hi = lay.block(ka, lay.rank)
    qp = tail_tables(ctx.ntt_qp_at(level), ctx.ntt_q(level), ka, lo, hi)[0]
    return _tail(ctx, nttm.ntt_inv(acc, qp), level, lay)


# =========================================================================
# Rescale
# =========================================================================

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
