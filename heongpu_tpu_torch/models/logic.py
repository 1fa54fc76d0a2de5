"""Boolean logic over BFV and CKKS ciphertexts (port of
heongpu_tpu/models/logic.py).

Gates are ring arithmetic on {0, 1} messages: NOT = 1 - x, AND = x·y,
OR = x + y - x·y, XOR = x + y - 2·x·y, and the negated variants.  BFV gates
are exact (mod t); CKKS gates are approximate and rescale after each
multiplication.  Both ciphertext-ciphertext and ciphertext-plaintext
variants are given, as in the reference.
"""

from __future__ import annotations

import numpy as np

from . import bfv as bfv_m
from . import ckks as ckks_m


# =========================================================================
# BFV (exact, mod t)
# =========================================================================

def bfv_not(ctx, a, *_):
    """NOT x = 1 - x, computed as -x - (-1)."""
    return bfv_m.sub_plain(ctx, bfv_m.negate(ctx, a), _neg_one_plain(ctx))


def _neg_one_plain(ctx):
    return bfv_m.encode(ctx, np.full(ctx.n, ctx.t - 1, np.int64))


def bfv_and(ctx, a, b, rk):
    return bfv_m.relinearize(ctx, bfv_m.multiply(ctx, a, b), rk)


def bfv_or(ctx, a, b, rk):
    s = bfv_m.add(ctx, a, b)
    return bfv_m.sub(ctx, s, bfv_and(ctx, a, b, rk))


def bfv_xor(ctx, a, b, rk):
    s = bfv_m.add(ctx, a, b)
    ab = bfv_and(ctx, a, b, rk)
    return bfv_m.sub(ctx, s, bfv_m.add(ctx, ab, ab))


def bfv_nand(ctx, a, b, rk):
    return bfv_not(ctx, bfv_and(ctx, a, b, rk))


def bfv_nor(ctx, a, b, rk):
    return bfv_not(ctx, bfv_or(ctx, a, b, rk))


def bfv_xnor(ctx, a, b, rk):
    return bfv_not(ctx, bfv_xor(ctx, a, b, rk))


def bfv_and_plain(ctx, a, pt, rk=None):
    return bfv_m.multiply_plain(ctx, a, pt)


def bfv_or_plain(ctx, a, pt, rk=None):
    s = bfv_m.add_plain(ctx, a, pt)
    return bfv_m.sub(ctx, s, bfv_m.multiply_plain(ctx, a, pt))


def bfv_xor_plain(ctx, a, pt, rk=None):
    s = bfv_m.add_plain(ctx, a, pt)
    ab = bfv_m.multiply_plain(ctx, a, pt)
    return bfv_m.sub(ctx, s, bfv_m.add(ctx, ab, ab))


# =========================================================================
# CKKS (approximate; one rescale per multiplication)
# =========================================================================

def _ckks_mul(ctx, a, b, rk):
    return ckks_m.rescale(ctx, ckks_m.relinearize(ctx, ckks_m.multiply(ctx, a, b), rk))


def _ckks_align(ctx, a, b):
    """mod_drop the shallower ciphertext so both sit at the same level."""
    if a.level < b.level:
        a = ckks_m.mod_drop(ctx, a, b.level - a.level)
    elif b.level < a.level:
        b = ckks_m.mod_drop(ctx, b, a.level - b.level)
    return a, b


def _ckks_one(ctx, like):
    return ckks_m.encode_const(ctx, 1.0, like.scale, level=like.level)


def ckks_not(ctx, a, *_):
    """NOT x = 1 - x."""
    return ckks_m.add_plain(ctx, ckks_m.negate(ctx, a), _ckks_one(ctx, a))


def ckks_and(ctx, a, b, rk):
    a, b = _ckks_align(ctx, a, b)
    return _ckks_mul(ctx, a, b, rk)


def ckks_or(ctx, a, b, rk):
    """x + y - x·y; the linear terms are brought to the product's exact
    (level, scale) with the plaintext-scale knob."""
    a, b = _ckks_align(ctx, a, b)
    ab = _ckks_mul(ctx, a, b, rk)
    s = _align_to(ctx, ckks_m.add(ctx, a, b), ab.level, ab.scale)
    return ckks_m.sub(ctx, s, ab)


def ckks_xor(ctx, a, b, rk):
    a, b = _ckks_align(ctx, a, b)
    ab = _ckks_mul(ctx, a, b, rk)
    s = _align_to(ctx, ckks_m.add(ctx, a, b), ab.level, ab.scale)
    return ckks_m.sub(ctx, s, ckks_m.add(ctx, ab, ab))


def ckks_nand(ctx, a, b, rk):
    return ckks_not(ctx, ckks_and(ctx, a, b, rk))


def ckks_nor(ctx, a, b, rk):
    return ckks_not(ctx, ckks_or(ctx, a, b, rk))


def ckks_xnor(ctx, a, b, rk):
    return ckks_not(ctx, ckks_xor(ctx, a, b, rk))


def _align_to(ctx, a, level: int, scale: float):
    """Bring `a` to exactly (level, scale): mod_drop to level - 1, multiply by
    a 1-encoding at the ratio that lands on `scale`, rescale.  Costs one of
    the levels the ciphertext was going to lose anyway."""
    if a.level == level and abs(a.scale - scale) <= 1e-9 * scale:
        return ckks_m.Ciphertext(a.c, a.size, a.level, scale)
    assert a.level < level, "operand deeper than target"
    if a.level < level - 1:
        a = ckks_m.mod_drop(ctx, a, level - 1 - a.level)
    q_drop = float(ctx.q_primes[ctx.active(a.level) - 1])
    pt = ckks_m.encode_const(ctx, 1.0, scale * q_drop / a.scale, level=a.level)
    out = ckks_m.rescale(ctx, ckks_m.multiply_plain(ctx, a, pt))
    return ckks_m.Ciphertext(out.c, out.size, out.level, scale)
