"""CKKS regular bootstrapping on a limb-sharded ciphertext: mod_raise,
CoeffToSlot, EvalMod, SlotToCoeff and regular_bootstrap over a ('dp',
'limb') mesh with the bootstrap key set placed by
parallel.mesh.shard_pytree_limb_axis.

The JAX package runs models/ckks_boot.py's functions on limb-sharded
inputs under `jit` and GSPMD inserts the collectives
(tests/test_boot_sharded.py).  These functions take the same arguments as
the port's models/ckks_boot.py, with the ciphertext's `c` a DTensor (one
ciphertext: 'dp' of size 1) and `keys` placed on the same mesh, and run
every rank on its own rows on the ops of parallel/ckks_sharded.py.  The
point is memory: a rank holds 1/k of every key whose QP extent divides k
(generate the set with limb_align=k), and the rest whole.  Every rank's
shard equals, bit for bit, the same rows of the unsharded result.

  * mod_raise: the base_count rows' coefficients on every rank (replicated
    where base_count does not divide k, as at k = 4; else sent over), and
    each rank lifts them into its own rows of the full chain, the centered
    residue (base_count 1) or compose.mod_primes_centered (base_count 2);
  * the layouts change level by level: every op that changes the limb count
    lays its output out by shard_array_limb_axis's rule, so a bootstrap
    walks from sharded levels into replicated ones and back (mod_raise);
  * matvec_piece: one `hoist` (c1's digits on the union of the rows the
    rank's baby keys need), each baby's P-scaled pair MAC'd on the rank's
    rows of its key, one diagonal MAC per giant on K2 mac_keys,
    ks_finish_at (÷P on K6, K1) on the rank's Q~ rows (its Q limbs of the
    ciphertext's layout and every special), the giant's rotation, `depth`
    rescales.  The Galois keys' blocks differ from key to key and from the
    diagonals' (each placed by its own extent).  The diagonal MAC runs where
    the rank's diagonal rows lie (its block where the piece's diagonals are
    split, else its Q~ rows): no diagonal row moves, the baby pairs come
    over to those rows, and each giant's MAC'd pair goes on to the Q~ rows.
    Where the ciphertext is replicated and the diagonals split, the ranks
    share the MAC instead of each doing all of it.  Per piece a rank
    receives, besides its giants' keyswitches and the rescales: the rows of
    c at the Q limbs of its MAC rows that it lacks (2 polys), c1's
    coefficient rows it lacks (ka - ka/k rows), each baby's pair rows on
    its MAC rows that its key block did not give it (at most 2 rows a MAC
    row), and each giant's pair rows on its Q~ rows that its MAC rows did
    not give it (at most 2 (ka/k + p) rows); N int32 words a row;
  * the keys never move: a stripped (seeded) key, compress_keys=True's
    set among them, regenerates the rank's own rows of its uniform half at
    each use (ckks_sharded._key: one K7 launch over a row range).
"""

from __future__ import annotations

import math

import torch

from ..models import ckks, ckks_boot
from ..models.ckks import Ciphertext
from ..ops import compose, polyops, rns
from ..ops import modmath as mm
from ..ops import ntt as nttm
from ..utils import errors
from . import ckks_sharded as cks


def mod_raise(ctx, ct: Ciphertext, base_count: int = 1) -> Ciphertext:
    """ckks_boot.mod_raise: the base's coefficients on every rank, each rank's
    own rows of the lifted ciphertext, laid out for the full chain."""
    if ctx.active(ct.level) != base_count:
        raise errors.LevelMismatchError(
            f"mod_raise expects {base_count} remaining limb(s), got {ctx.active(ct.level)}")
    lay = cks._ct_layout(ctx, ct)
    lo, hi = lay.block(base_count, lay.rank)
    coeff = nttm.ntt_inv(ct.c.to_local(), cks._limbs(ctx, lo, hi))
    coeff = cks._move_rows(coeff, [lay.q_rows(base_count, r) for r in range(lay.k)],
                           [list(range(base_count))] * lay.k, lay)
    out_sharded = ctx.k % lay.k == 0
    olo, ohi = lay.block(ctx.k, lay.rank, out_sharded)
    primes = tuple(int(q) for q in ctx.q_primes)
    if base_count == 1:
        q0 = primes[0]
        v = coeff[:, 0, :].to(mm.I64)
        centered = torch.where(v > (q0 >> 1), v - q0, v)
        p = cks._memo(ctx, ("q_col", olo, ohi), lambda: torch.tensor(
            primes[olo:ohi], dtype=mm.I64, device=coeff.device)[:, None])
        raised = torch.remainder(centered[:, None, :], p).to(mm.I32)
    else:
        base = primes[:base_count]
        raised = compose.mod_primes_centered(coeff, base, primes[olo:ohi],
                                             ckks._compose_tabs(base, ctx.device))
    out = nttm.ntt_fwd(raised, cks._limbs(ctx, olo, ohi))
    return Ciphertext(lay.wrap(out, out_sharded), 2, 0, ct.scale)


def rotate_exact(ctx, ct: Ciphertext, gk, step: int) -> Ciphertext:
    """ckks_boot.rotate_exact: the key made for `step`, or, where there is none
    (less-key mode), the power-of-two chain (ckks_sharded.rotate)."""
    if step % (ctx.n // 2) == 0:
        return ct
    g = polyops.steps_to_galois_elt(step, ctx.n)
    if g in gk.keys:
        return cks.apply_galois(ctx, ct, gk.keys[g])
    return cks.rotate(ctx, ct, gk, step)


def matvec_piece(ctx, ct: Ciphertext, piece: ckks_boot.Piece, gk) -> Ciphertext:
    """ckks_boot.matvec_piece: one hoist for all babies, their pairs on the
    rows of the rank's diagonals, one diagonal MAC there and one ÷P per
    giant, `depth` rescales."""
    if ct.level < piece.level:
        ct = cks.mod_drop(ctx, ct, piece.level - ct.level)
    lvl = ct.level
    if lvl != piece.level:
        raise errors.LevelMismatchError(f"piece expects level {piece.level}, got {lvl}")
    lay = cks._ct_layout(ctx, ct)
    ka, p, k = ctx.active(lvl), len(ctx.p_primes), lay.k
    qt = [lay.qt_rows(ka, p, r) for r in range(k)]
    # the MAC rows: the diagonals' block where they are split, else the Q~ rows
    mac = cks._held(piece.giants[0][2], lay) or qt
    all_babies = sorted({b for _, babies, _ in piece.giants for b in babies})
    keys = {b: gk.keys[polyops.steps_to_galois_elt(b, ctx.n)] for b in all_babies if b}
    h = cks.hoist(ctx, ct, keys.values())
    # P·c0 and P·c1 on the MAC rows, from c's rows at their Q limbs
    c = cks._move_rows(ct.c.to_local(), [lay.q_rows(ka, r) for r in range(k)],
                       [[q for q in rows if q < ka] for rows in mac], lay)
    pc = cks.p_scale_to_qtilde(ctx, c, lvl, mac[lay.rank])
    reps = {b: cks.rotate_hoisted_qtilde(ctx, h, kk, pc[0], lvl, mac) for b, kk in keys.items()}
    if 0 in all_babies:
        reps[0] = (pc[0], pc[1])
    base = cks._basis(ctx, lvl, tuple(mac[lay.rank]))[1]
    out = None
    for g, babies, pts in piece.giants:
        # Σ_b pts[b]·reps[b]·2^-32 for both halves on the MAC rows, then to the Q~ rows
        pair = rns.mac_keys(cks._const_rows(pts, lay, mac),
                            torch.stack([reps[b][0] for b in babies]),
                            torch.stack([reps[b][1] for b in babies]), base)
        pair = cks._move_rows(pair, mac, qt, lay)
        ct_g = Ciphertext(lay.wrap(cks.ks_finish_at(ctx, pair, lvl, lay), lay.sharded), 2, lvl,
                          ct.scale * piece.pt_scale)
        if g:
            ct_g = rotate_exact(ctx, ct_g, gk, g)
        out = ct_g if out is None else cks.add(ctx, out, ct_g)
    for _ in range(piece.depth):
        out = cks.rescale(ctx, out)
    return out


def _const_pt(ctx, ct, value, scale):
    return cks.encode_const(ctx, value, scale, ct)


def _mul_ct(ctx, a, b, rk, times: int = 1) -> Ciphertext:
    out = cks.relinearize(ctx, cks.multiply(ctx, a, b), rk)
    for _ in range(times):
        out = cks.rescale(ctx, out)
    return out


def eval_exp_sin(ctx, x: Ciphertext, keys: ckks_boot.BootKeys) -> Ciphertext:
    """ckks_boot.eval_exp_sin: the Horner Taylor series of exp(i x), r
    squarings, u - conj(u), and with arcsin_order the v (1 - v^2/24) term;
    base_count plain-constant rescales a step."""
    d, r, bc = keys.cfg.taylor_degree, keys.cfg.exp_squarings, keys.cfg.base_count
    coefs = [(1j ** j) / math.factorial(j) for j in range(d + 1)]

    def _next_primes(ct):
        ka = ctx.active(ct.level)
        s = 1.0
        for j in range(bc):
            s *= float(ctx.q_primes[ka - 1 - j])
        return s

    acc = cks.multiply_plain(ctx, x, _const_pt(ctx, x, coefs[d], _next_primes(x)))
    for _ in range(bc):
        acc = cks.rescale(ctx, acc)
    acc = cks.add_plain(ctx, acc, _const_pt(ctx, acc, coefs[d - 1], acc.scale))
    for j in range(d - 2, -1, -1):
        xj = cks.mod_drop(ctx, x, acc.level - x.level)
        acc = _mul_ct(ctx, acc, xj, keys.rk, times=bc)
        acc = cks.add_plain(ctx, acc, _const_pt(ctx, acc, coefs[j], acc.scale))
    for _ in range(r):
        acc = _mul_ct(ctx, acc, acc, keys.rk, times=bc)
    uc = cks.conjugate(ctx, acc, keys.gk)
    v = cks.sub(ctx, acc, uc)
    if keys.cfg.arcsin_order:
        v2 = _mul_ct(ctx, v, v, keys.rk, times=bc)
        inner = cks.multiply_plain(ctx, v2, _const_pt(ctx, v2, -1.0 / 24.0, _next_primes(v2)))
        for _ in range(bc):
            inner = cks.rescale(ctx, inner)
        inner = cks.add_plain(ctx, inner, _const_pt(ctx, inner, 1.0, inner.scale))
        vd = cks.mod_drop(ctx, v, inner.level - v.level)
        v = _mul_ct(ctx, vd, inner, keys.rk, times=bc)
    return v


def ctos_finish(ctx, w: Ciphertext, keys: ckks_boot.BootKeys):
    """t0 = w + conj(w), t1 = u + conj(u) with u = -i·w."""
    t0 = cks.add(ctx, w, cks.conjugate(ctx, w, keys.gk))
    u = cks.multiply_by_monomial(ctx, w, keys.mult_neg_i)
    return t0, cks.add(ctx, u, cks.conjugate(ctx, u, keys.gk))


def coeff_to_slot(ctx, ct: Ciphertext, keys: ckks_boot.BootKeys):
    """The CtoS pieces, then ctos_finish: (t0, t1)."""
    w = ct
    for piece in keys.ctos_pieces:
        w = matvec_piece(ctx, w, piece, keys.gk)
    return ctos_finish(ctx, w, keys)


def stoc_entry(ctx, s0: Ciphertext, s1: Ciphertext, keys: ckks_boot.BootKeys):
    """m = s0 + i·s1."""
    return cks.add(ctx, s0, cks.multiply_by_monomial(ctx, s1, keys.mult_i))


def slot_to_coeff(ctx, s0: Ciphertext, s1: Ciphertext, keys: ckks_boot.BootKeys):
    """stoc_entry, then the StoC pieces."""
    m = stoc_entry(ctx, s0, s1, keys)
    for piece in keys.stoc_pieces:
        m = matvec_piece(ctx, m, piece, keys.gk)
    return m


def regular_bootstrap(ctx, ct: Ciphertext, keys: ckks_boot.BootKeys) -> Ciphertext:
    """ckks_boot.regular_bootstrap on a sharded ciphertext at its last
    base_count limbs with a placed key set."""
    raised = mod_raise(ctx, ct, keys.cfg.base_count)
    t0, t1 = coeff_to_slot(ctx, raised, keys)
    s0 = eval_exp_sin(ctx, t0, keys)
    s1 = eval_exp_sin(ctx, t1, keys)
    return slot_to_coeff(ctx, s0, s1, keys)
