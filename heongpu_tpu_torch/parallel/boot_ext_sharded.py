"""The CKKS bootstrapping variants on a limb-sharded ciphertext: the
Chebyshev-cosine EvalMod through a sharded baby-step/giant-step, regular v2,
slim, bit and gate bootstrapping, the sparse-secret switch around the
mod-raise and less-key mode, over a ('dp', 'limb') mesh with the BootKeysV2
set placed by parallel.mesh.shard_pytree_limb_axis.

The JAX package runs models/ckks_boot_ext.py's functions on limb-sharded
inputs under `jit` and GSPMD inserts the collectives.  These functions take
the same arguments as the port's models/ckks_boot_ext.py, with the
ciphertext's `c` a DTensor (one ciphertext: 'dp' of size 1) and `keys` placed
on the same mesh, and run every rank on its own rows on the ops of
parallel/ckks_sharded.py and the pieces of parallel/boot_sharded.py.  A rank
holds 1/k of every key whose QP extent divides k (generate the set with
limb_align=k) and the rest whole.  Every rank's shard equals, bit for bit,
the same rows of the unsharded result.

  * EvalMod: poly_eval's recursion with ckks_sharded as its op set (the
    constants encoded at any level on each rank's own rows, the leaf
    products limb-local, the constant-only block a zero ciphertext laid out
    for its level), then the double angles (multiply, relinearize, rescale,
    add, sub_plain);
  * CtoS and StoC: boot_sharded's matvec_piece, ctos_finish and stoc_entry;
    in less-key mode a giant step without its own key composes from the
    power-of-two chain (boot_sharded.rotate_exact);
  * the sparse switch: ckks_sharded.switch_key to the temporary sparse key,
    boot_sharded.mod_raise, switch_key back.  Both switch keys are made at
    level 0 with k + p QP rows (25 on the v2 chain of nineteen Q primes and
    six specials), which 4 does not divide: they stay whole on every rank,
    and each rank MACs its own Q~ rows of them;
  * the affine map of bit and gate bootstrapping is scale metadata, a
    negation and one add_plain; slim's exit constant goes into the scale.

What a rank receives, for the NAND gate on a 4-way mesh: nothing in the
input sum, the negation, the constants or the final recombination (each
rank adds, encodes and multiplies its own rows); in each StoC and CtoS piece
what boot_sharded.matvec_piece lists; nothing in the mod-raise (the one base
row is replicated, so every rank lifts it itself) and, for each keyswitch
(every relinearization of the power basis and the double angles, the two
conjugations of ctos_finish), the coefficient rows of the switched poly that
it lacks (ka - ka/k rows where the ciphertext is split, none where it is
replicated), and the MAC'd pair's special rows and its own Q rows from the
ranks whose key block holds them (at most 2 (ka/k + p) rows); in each
rescale the last limb's coefficient row of every poly, and the rows of the
output's layout that it lacks when the limb count stops or starts dividing
4 (a mod_drop too); N int32 words a row.  No rank receives a row of a key;
a stripped (seeded) key regenerates the rank's own rows of its uniform half
at each use (ckks_sharded._key: one K7 launch over a row range).
"""

from __future__ import annotations

import math

from ..models import poly_eval
from ..models.ckks import Ciphertext
from ..models.ckks_boot_ext import GATE_TABLE, BootKeysV2, _q0
from . import boot_sharded as bs
from . import ckks_sharded as cks


def eval_poly_bsgs(ctx, y: Ciphertext, coeffs, rk, n1=None) -> Ciphertext:
    """poly_eval.eval_poly_bsgs on a sharded ciphertext with a placed
    relinearization key: the recursion on ckks_sharded's ops."""
    return poly_eval.eval_poly_bsgs(ctx, y, coeffs, rk, n1, ops=cks)


# =========================================================================
# The cosine EvalMod engine
# =========================================================================

def eval_cos_engine(ctx, t: Ciphertext, keys: BootKeysV2, phase: float) -> Ciphertext:
    """ckks_boot_ext.eval_cos_engine: the phase shift, the BSGS cosine, r
    double angles."""
    cfg = keys.cfg
    r = cfg.double_angles
    shift = phase / ((1 << r) * cfg.R)
    y = t
    if abs(shift) > 1e-30:
        y = cks.add_plain(ctx, t, cks.encode_const(ctx, shift, t.scale, t))
    c = eval_poly_bsgs(ctx, y, keys.cos_coeffs, keys.rk)
    for _ in range(r):
        sq = cks.rescale(ctx, cks.relinearize(ctx, cks.multiply(ctx, c, c), keys.rk))
        two_sq = cks.add(ctx, sq, sq)
        c = cks.sub_plain(ctx, two_sq, cks.encode_const(ctx, 1.0, two_sq.scale, two_sq))
    return c


def eval_mod_sin(ctx, t: Ciphertext, keys: BootKeysV2) -> Ciphertext:
    return eval_cos_engine(ctx, t, keys, phase=-math.pi / 2)


# =========================================================================
# Entry points
# =========================================================================

def regular_bootstrap_v2(ctx, ct: Ciphertext, keys: BootKeysV2) -> Ciphertext:
    """ckks_boot_ext.regular_bootstrap_v2 on a sharded ciphertext at its last
    base_count limbs with a placed key set (sparse switch keys and less-key
    mode too)."""
    assert keys.variant == "regular"
    raised = _raise_maybe_sparse(ctx, ct, keys)
    t0, t1 = _coeff_to_slot(ctx, raised, keys)
    return _slot_to_coeff(ctx, eval_mod_sin(ctx, t0, keys), eval_mod_sin(ctx, t1, keys), keys)


def _raise_maybe_sparse(ctx, m: Ciphertext, keys: BootKeysV2) -> Ciphertext:
    """The mod-raise, under the temporary sparse key where keys has one."""
    if keys.swk_to_sparse is not None:
        m = cks.switch_key(ctx, m, keys.swk_to_sparse)
    raised = bs.mod_raise(ctx, m, keys.cfg.base_count)
    if keys.swk_to_dense is not None:
        raised = cks.switch_key(ctx, raised, keys.swk_to_dense)
    return raised


def _apply_stoc(ctx, m: Ciphertext, keys: BootKeysV2) -> Ciphertext:
    for piece in keys.stoc_pieces:
        m = bs.matvec_piece(ctx, m, piece, keys.gk)
    return m


def slim_bootstrap(ctx, ct: Ciphertext, keys: BootKeysV2) -> Ciphertext:
    """ckks_boot_ext.slim_bootstrap: StoC at the chain's tail, mod-raise, CtoS,
    EvalMod, recombine; the exit constant goes into the scale."""
    assert keys.variant == "slim"
    m = _apply_stoc(ctx, ct, keys)
    assert ctx.active(m.level) == keys.cfg.base_count, \
        "slim StoC must end on the boot base limbs"
    t0, t1 = _coeff_to_slot(ctx, _raise_maybe_sparse(ctx, m, keys), keys)
    out = bs.stoc_entry(ctx, eval_mod_sin(ctx, t0, keys), eval_mod_sin(ctx, t1, keys), keys)
    out_scale = out.scale * 2 * math.pi * keys.msg_scale / _q0(ctx, keys.cfg.base_count)
    return Ciphertext(out.c, out.size, out.level, out_scale)


def _cos_affine_pair(ctx, m: Ciphertext, keys: BootKeysV2, phase: float, mul: float,
                     add: float) -> Ciphertext:
    """mul·cos(2π·raw/q0 + phase) + add of the StoC'd m, slot-wise."""
    raised = _raise_maybe_sparse(ctx, _apply_stoc(ctx, m, keys), keys)
    t0, t1 = _coeff_to_slot(ctx, raised, keys)
    outs = [_affine(ctx, eval_cos_engine(ctx, t, keys, phase=phase), mul=mul, add=add)
            for t in (t0, t1)]
    return bs.stoc_entry(ctx, outs[0], outs[1], keys)


def bit_bootstrap(ctx, ct: Ciphertext, keys: BootKeysV2) -> Ciphertext:
    """ckks_boot_ext.bit_bootstrap: b = (1 − cos(2π·raw/q0))/2."""
    assert keys.variant == "bit"
    return _cos_affine_pair(ctx, ct, keys, phase=0.0, mul=-0.5, add=0.5)


def gate_bootstrap(ctx, ct1: Ciphertext, ct2: Ciphertext, gate: str,
                   keys: BootKeysV2) -> Ciphertext:
    """ckks_boot_ext.gate_bootstrap: the gate's affine map of
    cos(2π(I + s/3) + φ_gate), s = b1 + b2 (GATE_TABLE)."""
    assert keys.variant == "gate"
    phase, mul, add = GATE_TABLE[gate.upper()]
    return _cos_affine_pair(ctx, cks.add(ctx, ct1, ct2), keys, phase=phase, mul=mul, add=add)


def _affine(ctx, c: Ciphertext, mul: float, add: float) -> Ciphertext:
    """mul·c + add: the scale metadata takes |mul|, a negation its sign, and
    one add_plain the constant."""
    out = cks.negate(ctx, c) if mul < 0 else c
    out = Ciphertext(out.c, out.size, out.level, out.scale / abs(mul))
    if abs(add) > 1e-30:
        out = cks.add_plain(ctx, out, cks.encode_const(ctx, add, out.scale, out))
    return out


def _coeff_to_slot(ctx, ct: Ciphertext, keys: BootKeysV2):
    w = ct
    for piece in keys.ctos_pieces:
        w = bs.matvec_piece(ctx, w, piece, keys.gk)
    return bs.ctos_finish(ctx, w, keys)


def _slot_to_coeff(ctx, s0: Ciphertext, s1: Ciphertext, keys: BootKeysV2) -> Ciphertext:
    return _apply_stoc(ctx, bs.stoc_entry(ctx, s0, s1, keys), keys)
