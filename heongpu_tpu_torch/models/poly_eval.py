"""Homomorphic polynomial evaluation (BSGS power basis) and Chebyshev
interpolation helpers (port of heongpu_tpu/models/poly_eval.py).

  * The power basis with baby-step/giant-step recursion: depth
    ceil(log2(d)) + 1 instead of Horner's d.
  * Exact scale threading: a rescale divides by a prime that is only
    approximately the scale, so every branch is given a target scale from
    the top down and realises it exactly through the encoding scale of its
    plaintext coefficients; every ciphertext addition is then between equal
    scales.

The coefficient helpers are numpy, copied from the reference; the
evaluation runs on the port's multiply / relinearize / rescale / mod_drop /
add_plain and exact constants (ckks.encode_const), so it returns the
reference's residues for the same input ciphertext and relinearization key.
The op set is an argument (CKKS_OPS by default): parallel/boot_ext_sharded.py
runs the same recursion on parallel/ckks_sharded.py's limb-sharded ops.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..ops import modmath as mm
from . import ckks
from .ckks import Ciphertext, CkksContext


# =========================================================================
# Host-side approximation helpers (numpy)
# =========================================================================

def chebyshev_interp_coeffs(f, degree: int, a: float = -1.0, b: float = 1.0):
    """Chebyshev interpolation coefficients of f on [a, b] at the Chebyshev
    nodes."""
    k = degree + 1
    nodes = np.cos((2 * np.arange(k) + 1) * np.pi / (2 * k))
    x = 0.5 * (b - a) * nodes + 0.5 * (b + a)
    y = np.array([f(v) for v in x], dtype=np.float64)
    return np.polynomial.chebyshev.chebfit(nodes, y, degree)


def cheb_to_monomial(cheb_coeffs) -> np.ndarray:
    """Chebyshev-basis -> power-basis coefficients (stable to degree ~31)."""
    return np.polynomial.chebyshev.cheb2poly(cheb_coeffs)


def cosine_approx_coeffs(R: float, degree: int, phase: float = 0.0) -> np.ndarray:
    """Power-basis coefficients of cos(R*y + phase) on y in [-1, 1]."""
    return cheb_to_monomial(
        chebyshev_interp_coeffs(lambda y: math.cos(R * y + phase), degree))


# =========================================================================
# Homomorphic power basis
# =========================================================================

class CkksOps:
    """The ciphertext ops the evaluation runs on: models/ckks.py's, each looked
    up when it is called (a wrapper put on a ckks function sees the call).
    mod_drop, multiply, relinearize, rescale, add and add_plain take ckks's
    arguments; encode_const, mul_plain_core and zeros take those of
    parallel/ckks_sharded.py, whose module is the op set of the sharded
    path."""

    def __getattr__(self, name):
        return getattr(ckks, name)

    @staticmethod
    def encode_const(ctx, value, scale, like, level):
        return ckks.encode_const(ctx, value, scale, level=level)

    @staticmethod
    def mul_plain_core(ctx, t: Ciphertext, pt, scale) -> Ciphertext:
        return Ciphertext(ckks._mul_plain_core(ctx, t.c, pt.m, t.level), t.size, t.level, scale)

    @staticmethod
    def zeros(ctx, like, level, scale) -> Ciphertext:
        z = torch.zeros((2, ctx.active(level), ctx.n), dtype=mm.I32, device=ctx.device)
        return Ciphertext(z, 2, level, scale)


CKKS_OPS = CkksOps()


def _square_up(ctx, a: Ciphertext, b: Ciphertext, rk, ops=CKKS_OPS) -> Ciphertext:
    """a·b at the deeper of the two levels, relinearized and rescaled."""
    lvl = max(a.level, b.level)
    a = ops.mod_drop(ctx, a, lvl - a.level) if a.level < lvl else a
    b = ops.mod_drop(ctx, b, lvl - b.level) if b.level < lvl else b
    return ops.rescale(ctx, ops.relinearize(ctx, ops.multiply(ctx, a, b), rk))


def _power(ctx, pows: Dict[int, Ciphertext], j: int, rk, ops=CKKS_OPS) -> Ciphertext:
    """y^j from y^(j//2) and y^(j - j//2), memoised in pows."""
    if j not in pows:
        half = j // 2
        a = _power(ctx, pows, half, rk, ops)
        b = _power(ctx, pows, j - half, rk, ops)
        pows[j] = _square_up(ctx, a, b, rk, ops)
    return pows[j]


def gen_powers(ctx: CkksContext, y: Ciphertext, max_pow: int, rk,
               ops=CKKS_OPS) -> Dict[int, Ciphertext]:
    """All powers y^1..y^max_pow built with log-depth squaring chains.
    Power j sits at level(y) + ceil(log2(j)); callers mod_drop to align."""
    pows = {1: y}
    for j in range(2, max_pow + 1):
        _power(ctx, pows, j, rk, ops)
    return pows


def _leaf_block(ctx: CkksContext, coeffs: Sequence[complex], pows: Dict[int, Ciphertext],
                level: int, target_scale: float, ops=CKKS_OPS) -> Optional[Ciphertext]:
    """Sum_j coeffs[j] * y^j for j < n1, returned at exactly (level,
    target_scale).  The products run one level up at scale target_scale·q so
    the plaintext coefficients keep ~q bits of precision, then one rescale
    lands the block on target_scale exactly.  The constant term goes in by
    add_plain."""
    lvl_in = level - 1
    q_drop = float(ctx.q_primes[ctx.active(lvl_in) - 1])
    acc = None
    for j, c in enumerate(coeffs):
        if j == 0 or abs(c) < 1e-30:
            continue
        t = pows[j]
        t = ops.mod_drop(ctx, t, lvl_in - t.level) if t.level < lvl_in else t
        assert t.level == lvl_in, "power deeper than evaluation level"
        pt = ops.encode_const(ctx, c, target_scale * q_drop / t.scale, t, lvl_in)
        term = ops.mul_plain_core(ctx, t, pt, target_scale * q_drop)
        acc = term if acc is None else ops.add(ctx, acc, term)
    if acc is None:  # constant-only block
        acc = ops.zeros(ctx, pows[1], level, target_scale)
    else:
        acc = ops.rescale(ctx, acc)
        acc = Ciphertext(acc.c, acc.size, acc.level, target_scale)
    if abs(coeffs[0]) > 1e-30:
        acc = ops.add_plain(ctx, acc, ops.encode_const(ctx, coeffs[0], target_scale, acc, level))
    return acc


def _eval_rec(ctx: CkksContext, coeffs: List[complex], pows: Dict[int, Ciphertext],
              giants: Dict[int, Ciphertext], n1: int, level: int, target_scale: float,
              rk, ops=CKKS_OPS) -> Ciphertext:
    """Sum_j coeffs[j] y^j at exactly (level, target_scale): split at the
    largest giant power <= len - 1."""
    if len(coeffs) <= n1:
        return _leaf_block(ctx, coeffs, pows, level, target_scale, ops)
    g = n1
    while g * 2 < len(coeffs):
        g *= 2
    Tg = giants[g]
    lo, hi = coeffs[:g], coeffs[g:]
    # the hi branch runs one level up so that (hi · Tg) rescales into `level`
    q_drop = float(ctx.q_primes[ctx.active(level - 1) - 1])
    assert max(Tg.level, level - 1) == level - 1, "giant power deeper than evaluation level"
    Tg_a = ops.mod_drop(ctx, Tg, level - 1 - Tg.level) if Tg.level < level - 1 else Tg
    tau_q = target_scale * q_drop / Tg_a.scale
    q_ct = _eval_rec(ctx, hi, pows, giants, n1, level - 1, tau_q, rk, ops)
    prod = ops.rescale(ctx, ops.relinearize(ctx, ops.multiply(ctx, q_ct, Tg_a), rk))
    # float rounding: the computed scale equals target_scale by construction
    prod = Ciphertext(prod.c, prod.size, prod.level, target_scale)
    r_ct = _eval_rec(ctx, lo, pows, giants, n1, level, target_scale, rk, ops)
    return ops.add(ctx, prod, r_ct)


def eval_poly_bsgs(ctx: CkksContext, y: Ciphertext, coeffs, rk,
                   n1: Optional[int] = None, ops=CKKS_OPS) -> Ciphertext:
    """p(y) = sum_j coeffs[j] · y^j by baby-step/giant-step, at the context's
    default scale.  Depth: ceil(log2(deg + 1)) + 1 levels from y's level.
    `ops` is the op set it runs on (CkksOps)."""
    coeffs = list(np.asarray(coeffs, np.complex128))
    while len(coeffs) > 1 and abs(coeffs[-1]) < 1e-30:
        coeffs.pop()
    deg = len(coeffs) - 1
    if deg == 0:
        raise ValueError("constant polynomial")
    m = max(1, deg.bit_length())            # 2^m > deg
    if n1 is None:
        n1 = 1 << ((m + 1) // 2)
    pows = gen_powers(ctx, y, min(n1 - 1, deg), rk, ops)
    giants = {}
    g = n1
    while g <= deg:
        giants[g] = _power(ctx, pows, g, rk, ops)
        g *= 2
    # output level: the deepest hi-branch leaf sits (m - l0) splits below the
    # top and still needs one level for its block products above the babies
    max_lvl = max(p.level for p in list(pows.values()) + list(giants.values()))
    out_level = max(max_lvl + 1, y.level + m + 1)
    return _eval_rec(ctx, coeffs, pows, giants, n1, out_level, float(ctx.default_scale), rk, ops)
