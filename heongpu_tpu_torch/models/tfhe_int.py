"""Encrypted integers (huint8..huint256, hint) over TFHE gate bootstrapping
(port of heongpu_tpu/models/tfhe_int.py).

Composition over `tfhe._bootstrap`: every two-input gate is a linear
pre-computation followed by a shared bootstrap, so heterogeneous gate mixes
concatenate into one batched blind rotation.  Addition is Kogge-Stone:
depth 2 + ceil(log2 W) bootstrap rounds for W bits, each prefix level one
3-input carry-gate round.  The batch axis holds (count x width) bits, LSB
first within each integer.  add/sub return (result, carry/borrow).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from . import tfhe

I32, I64 = tfhe.I32, tfhe.I64
MU = tfhe.MU
_wrap = tfhe._wrap


@dataclasses.dataclass(frozen=True, eq=False)
class HUint:
    """count integers of `width` bits each; the bits' ciphertext batch is
    (count*width,), LSB-first within each integer."""
    bits: tfhe.Ciphertext
    width: int
    count: int


def _cat(*cts: tfhe.Ciphertext) -> tfhe.Ciphertext:
    return tfhe.Ciphertext(torch.cat([c.a for c in cts]), torch.cat([c.b for c in cts]),
                           variance=max(c.variance for c in cts))


def _slc(ct: tfhe.Ciphertext, lo: int, hi: int) -> tfhe.Ciphertext:
    return tfhe.Ciphertext(ct.a[lo:hi], ct.b[lo:hi], variance=ct.variance)


def _trivial(nbits: int, value: bool, n: int, device) -> tfhe.Ciphertext:
    """Noise-free LWE encoding of a constant bit (a=0, b=±mu)."""
    b = MU if value else -MU
    return tfhe.Ciphertext(torch.zeros((nbits, n), dtype=I32, device=device),
                           torch.full((nbits,), b, dtype=I32, device=device))


def _like(ct: tfhe.Ciphertext, nbits: int, value: bool) -> tfhe.Ciphertext:
    """_trivial with the LWE dimension and device of `ct`."""
    return _trivial(nbits, value, ct.a.shape[-1], ct.a.device)


# ---- batched linear pre-computations (reference tfhe_*_pre_comp kernels) ----
# Linear combines sum variances; the XOR pre-comp's x2 coefficients quadruple them.

def _pre_and(c1, c2):
    return tfhe._lin(c1, c2, 1, 1, -MU, 1)


def _pre_or(c1, c2):
    return tfhe._lin(c1, c2, 1, 1, MU, 1)


def _pre_xor(c1, c2):
    return tfhe._lin(c1, c2, 2, 2, 2 * MU, 4)


def _pre_carry(g, p, gs):
    """3-input carry-combine gate: g OR (p AND gs) in ONE bootstrap, valid
    under the Kogge-Stone invariant g AND p = 0.  Phase = 2g + p + gs + mu.
    Variance: 4Vg + Vp + Vgs."""
    a = 2 * g.a.to(I64) + p.a + gs.a
    b = 2 * g.b.to(I64) + p.b + gs.b + MU
    return tfhe.Ciphertext(_wrap(a), _wrap(b),
                           variance=4 * g.variance + p.variance + gs.variance)


def _carry_margin_bits(variance: float) -> float:
    """log2(mu / 4 sigma) of the carry gate's pre-bootstrap phase noise."""
    sigma = max(math.sqrt(variance), 1e-30)
    return math.log2((1.0 / 8.0) / (4.0 * sigma))


def _check_same(x: HUint, y: HUint):
    if (x.width, x.count) != (y.width, y.count):
        raise ValueError(f"operands differ: {x.count} x huint{x.width} and "
                         f"{y.count} x huint{y.width}")


def encrypt_huint(ctx, sk, values, width: int, key) -> HUint:
    """values: int or sequence of ints; width in {8,16,32,64,128,256,...}."""
    vals = np.atleast_1d(np.asarray(values, object))
    bits = np.zeros((len(vals), width), np.int64)
    for i, v in enumerate(vals):
        for j in range(width):
            bits[i, j] = (int(v) >> j) & 1
    ct = tfhe.encrypt(ctx, sk, bits.reshape(-1), key)
    return HUint(ct, width, len(vals))


def decrypt_huint(ctx, sk, x: HUint) -> np.ndarray:
    bits = tfhe.decrypt(ctx, sk, x.bits).reshape(x.count, x.width)
    out = np.zeros(x.count, object)
    for j in range(x.width):
        out += bits[:, j].astype(object) << j
    return out


def _per_int(ct: tfhe.Ciphertext, count: int, width: int):
    """(a, b) viewed per integer: (count, width, n) and (count, width)."""
    return ct.a.reshape(count, width, -1), ct.b.reshape(count, width)


def _shift_bits(ct: tfhe.Ciphertext, count: int, width: int, offset: int,
                pad: tfhe.Ciphertext) -> tfhe.Ciphertext:
    """Bits moved up by `offset` positions within each integer; `pad`
    ((count*offset,) samples) fills the low positions."""
    a, b = _per_int(ct, count, width)
    pa, pb = _per_int(pad, count, offset)
    return tfhe.Ciphertext(torch.cat([pa, a[:, :width - offset]], dim=1).reshape(ct.a.shape),
                           torch.cat([pb, b[:, :width - offset]], dim=1).reshape(ct.b.shape),
                           variance=ct.variance)


def _shift_gp(g: tfhe.Ciphertext, p: tfhe.Ciphertext, count: int, width: int,
              offset: int):
    """(g, p) shifted up by `offset` bit positions within each integer,
    padding with the prefix-identity (g=0, p=arbitrary->0)."""
    pad = _like(g, count * offset, False)
    return (_shift_bits(g, count, width, offset, pad),
            _shift_bits(p, count, width, offset, pad))


def _set_bit0(ct: tfhe.Ciphertext, count: int, width: int, v: tfhe.Ciphertext,
              variance: float) -> tfhe.Ciphertext:
    """ct with position 0 of every integer replaced by v ((count,) samples)."""
    a, b = _per_int(ct, count, width)
    a, b = a.clone(), b.clone()
    a[:, 0] = v.a
    b[:, 0] = v.b
    return tfhe.Ciphertext(a.reshape(ct.a.shape), b.reshape(ct.b.shape), variance=variance)


def _add_core(ctx, bk, xbits: tfhe.Ciphertext, ybits: tfhe.Ciphertext,
              count: int, width: int,
              carry_in: Optional[tfhe.Ciphertext] = None):
    """Kogge-Stone addition on bit ciphertexts.  Returns (sum bits, carry out).

    Rounds: 1 (g,p) + ceil(log2(width)) (prefix, one carry-gate round per
    level) + 1 (sum) batched bootstraps; +1 with a carry-in."""
    B = count * width
    # round 1: g = a AND b, p = a XOR b — one fused bootstrap
    gp = tfhe._bootstrap(ctx, bk, _cat(_pre_and(xbits, ybits), _pre_xor(xbits, ybits)))
    g, p = _slc(gp, 0, B), _slc(gp, B, 2 * B)
    p_orig = p  # the sum bits need a XOR b after the prefix consumes p

    # carry-in as a virtual position -1, OR-ed into g_0: (g0', p0') =
    # (g0 OR (p0 AND cin), p0) — one carry-gate round when the noise budget
    # allows, else two 2-input rounds
    if carry_in is not None:
        ga, gb = _per_int(g, count, width)
        pa, pb = _per_int(p, count, width)
        g0 = tfhe.Ciphertext(ga[:, 0], gb[:, 0], variance=g.variance)
        p0 = tfhe.Ciphertext(pa[:, 0], pb[:, 0], variance=p.variance)
        pre0 = _pre_carry(g0, p0, carry_in)
        if _carry_margin_bits(pre0.variance) >= 1.0:
            g0n = tfhe._bootstrap(ctx, bk, pre0)
        else:
            t = tfhe._bootstrap(ctx, bk, _pre_and(p0, carry_in))
            g0n = tfhe._bootstrap(ctx, bk, _pre_or(g0, t))
        g = _set_bit0(g, count, width, g0n, max(g.variance, g0n.variance))

    # Kogge-Stone prefix: after the loop, g[i] = carry OUT of position i.
    # Each level is one batched bootstrap (the 3-input carry gate beside
    # p' = p AND ps), falling back to two rounds if the tracked variance
    # leaves the carry gate's 2x-weighted phase short of margin.
    offset = 1
    while offset < width:
        gs, ps = _shift_gp(g, p, count, width, offset)
        pre_c = _pre_carry(g, p, gs)
        if _carry_margin_bits(pre_c.variance) >= 1.0:
            t = tfhe._bootstrap(ctx, bk, _cat(pre_c, _pre_and(p, ps)))
            g, p = _slc(t, 0, B), _slc(t, B, 2 * B)
        else:
            t = tfhe._bootstrap(ctx, bk, _cat(_pre_and(p, gs), _pre_and(p, ps)))
            t1, t2 = _slc(t, 0, B), _slc(t, B, 2 * B)
            g = tfhe._bootstrap(ctx, bk, _pre_or(g, t1))
            p = t2
        offset *= 2

    # carries into each position: c_i = g[i-1] (c_0 = carry_in handled above)
    carries = _shift_bits(g, count, width, 1, _like(g, count, False))
    if carry_in is not None:
        carries = _set_bit0(carries, count, width, carry_in,
                            max(carries.variance, carry_in.variance))
    s = tfhe._bootstrap(ctx, bk, _pre_xor(p_orig, carries))
    ga, gb = _per_int(g, count, width)
    carry_out = tfhe.Ciphertext(ga[:, width - 1], gb[:, width - 1], variance=g.variance)
    return s, carry_out


def add(ctx, bk, x: HUint, y: HUint) -> Tuple[HUint, tfhe.Ciphertext]:
    """x + y mod 2^width, plus the carry-out bit (reference huint add)."""
    _check_same(x, y)
    s, cout = _add_core(ctx, bk, x.bits, y.bits, x.count, x.width)
    return HUint(s, x.width, x.count), cout


def sub(ctx, bk, x: HUint, y: HUint) -> Tuple[HUint, tfhe.Ciphertext]:
    """x - y mod 2^width; second return is the NO-borrow bit (1 if x >= y)."""
    _check_same(x, y)
    ynot = tfhe.NOT(ctx, y.bits)
    one = _like(x.bits, x.count, True)
    s, cout = _add_core(ctx, bk, x.bits, ynot, x.count, x.width, carry_in=one)
    return HUint(s, x.width, x.count), cout


def bootstrap_rounds(width: int) -> int:
    """Number of batched blind-rotation rounds one addition costs on the
    fast path (fresh standard-key inputs: each Kogge-Stone prefix level is
    one 3-input-carry-gate round)."""
    return 1 + max(1, math.ceil(math.log2(width))) + 1


def ge(ctx, bk, x: HUint, y: HUint) -> tfhe.Ciphertext:
    """Encrypted (x >= y) per integer: the no-borrow bit of x - y."""
    _, noborrow = sub(ctx, bk, x, y)
    return noborrow


def eq(ctx, bk, x: HUint, y: HUint) -> tfhe.Ciphertext:
    """Encrypted (x == y): NOR-reduce the XOR difference bits, one batched
    bootstrap per tree level (depth ceil(log2 W))."""
    _check_same(x, y)
    C = x.count
    cur = tfhe._bootstrap(ctx, bk, _pre_xor(x.bits, y.bits))  # diff bits
    width = x.width
    while width > 1:
        half = width // 2
        a_, b_ = _per_int(cur, C, width)
        n = a_.shape[-1]
        lo = tfhe.Ciphertext(a_[:, :half].reshape(-1, n), b_[:, :half].reshape(-1),
                             variance=cur.variance)
        hi = tfhe.Ciphertext(a_[:, half:2 * half].reshape(-1, n),
                             b_[:, half:2 * half].reshape(-1), variance=cur.variance)
        merged = tfhe._bootstrap(ctx, bk, _pre_or(lo, hi))
        if width % 2:
            ma, mb = _per_int(merged, C, half)
            merged = tfhe.Ciphertext(
                torch.cat([ma, a_[:, -1:]], dim=1).reshape(-1, n),
                torch.cat([mb, b_[:, -1:]], dim=1).reshape(-1),
                variance=max(merged.variance, cur.variance))
            width = half + 1
        else:
            width = half
        cur = merged
    return tfhe.NOT(ctx, cur)


# =========================================================================
# Shifts, MUX, multiply
# =========================================================================

def shift_left(x: HUint, k: int) -> HUint:
    """x << k (mod 2^width): free — bit ciphertexts move positions."""
    if k == 0:
        return x
    if k >= x.width:
        return HUint(_like(x.bits, x.count * x.width, False), x.width, x.count)
    pad = _like(x.bits, x.count * k, False)
    return HUint(_shift_bits(x.bits, x.count, x.width, k, pad), x.width, x.count)


def shift_right(x: HUint, k: int) -> HUint:
    """x >> k (logical): free."""
    if k == 0:
        return x
    if k >= x.width:
        return HUint(_like(x.bits, x.count * x.width, False), x.width, x.count)
    a, b = _per_int(x.bits, x.count, x.width)
    pa, pb = _per_int(_like(x.bits, x.count * k, False), x.count, k)
    ct = tfhe.Ciphertext(torch.cat([a[:, k:], pa], dim=1).reshape(x.bits.a.shape),
                         torch.cat([b[:, k:], pb], dim=1).reshape(x.bits.b.shape),
                         variance=x.bits.variance)
    return HUint(ct, x.width, x.count)


def mux(ctx, bk, sel: tfhe.Ciphertext, x: HUint, y: HUint) -> HUint:
    """Per-integer select: sel_i ? x_i : y_i (sel: (count,) bit batch).
    One batched MUX over all count*width bits (2 blind rotations)."""
    _check_same(x, y)
    sel_b = tfhe.Ciphertext(torch.repeat_interleave(sel.a, x.width, dim=0),
                            torch.repeat_interleave(sel.b, x.width), variance=sel.variance)
    return HUint(tfhe.MUX(ctx, bk, sel_b, x.bits, y.bits), x.width, x.count)


def mul(ctx, bk, x: HUint, y: HUint) -> HUint:
    """x * y mod 2^width (schoolbook partial products + batched adder tree).

    Bootstrap rounds: 1 (all W^2 partial-product ANDs in one batched blind
    rotation) + ceil(log2 W) adder-tree levels, each level ONE batched
    Kogge-Stone add over all pairs at that level."""
    _check_same(x, y)
    W, C = x.width, x.count
    xa, xb = _per_int(x.bits, C, W)
    ya, yb = _per_int(y.bits, C, W)
    n = xa.shape[-1]
    # partial product j: (x AND broadcast(y_j)) << j, all C*W*W ANDs in one bootstrap
    xs = tfhe.Ciphertext(xa[:, None].expand(C, W, W, n).reshape(-1, n),
                         xb[:, None].expand(C, W, W).reshape(-1), variance=x.bits.variance)
    ys = tfhe.Ciphertext(ya[:, :, None].expand(C, W, W, n).reshape(-1, n),
                         yb[:, :, None].expand(C, W, W).reshape(-1), variance=y.bits.variance)
    pp = tfhe._bootstrap(ctx, bk, _pre_and(xs, ys))     # (C*W*W,)
    ppa = pp.a.reshape(C, W, W, n)
    ppb = pp.b.reshape(C, W, W)

    rows = []
    for j in range(W):
        row = tfhe.Ciphertext(ppa[:, j].reshape(-1, n), ppb[:, j].reshape(-1),
                              variance=pp.variance)
        if j:
            row = _shift_bits(row, C, W, j, _like(row, C * j, False))
        rows.append(HUint(row, W, C))

    # adder tree: each level adds pairs in ONE batched Kogge-Stone call by
    # stacking the pairs along the count axis
    while len(rows) > 1:
        pairs = [(rows[i], rows[i + 1]) for i in range(0, len(rows) - 1, 2)]
        tail = rows[-1] if len(rows) % 2 else None
        lhs = _cat(*[p[0].bits for p in pairs])
        rhs = _cat(*[p[1].bits for p in pairs])
        s, _ = _add_core(ctx, bk, lhs, rhs, C * len(pairs), W)
        rows = [HUint(_slc(s, i * C * W, (i + 1) * C * W), W, C) for i in range(len(pairs))]
        if tail is not None:
            rows.append(tail)
    return rows[0]


# =========================================================================
# Signed integers (hint8..hint256): two's complement over the same bit
# layout — add/sub/mul-mod-2^W and equality are representation-identical;
# only encode/decode, ordering, shifts and negation differ.
# =========================================================================

def encrypt_hint(ctx, sk, values, width: int, key) -> HUint:
    """Signed values in [-2^(W-1), 2^(W-1)); two's complement bits."""
    vals = np.atleast_1d(np.asarray(values, object))
    mask = (1 << width) - 1
    return encrypt_huint(ctx, sk, [int(v) & mask for v in vals], width, key)


def decrypt_hint(ctx, sk, x: HUint) -> np.ndarray:
    v = decrypt_huint(ctx, sk, x)
    half = 1 << (x.width - 1)
    full = 1 << x.width
    return np.array([int(u) - full if int(u) >= half else int(u) for u in v], object)


def _msb(x: HUint) -> tfhe.Ciphertext:
    a, b = _per_int(x.bits, x.count, x.width)
    return tfhe.Ciphertext(a[:, -1], b[:, -1], variance=x.bits.variance)


def neg(ctx, bk, x: HUint) -> HUint:
    """-x (two's complement): NOT then +1 via the carry-in path."""
    xnot = tfhe.NOT(ctx, x.bits)
    zero = _like(x.bits, x.count * x.width, False)
    one = _like(x.bits, x.count, True)
    s, _ = _add_core(ctx, bk, xnot, zero, x.count, x.width, carry_in=one)
    return HUint(s, x.width, x.count)


def abs_(ctx, bk, x: HUint) -> HUint:
    """|x| per integer (MUX on the sign bit)."""
    return mux(ctx, bk, _msb(x), neg(ctx, bk, x), x)


def ge_signed(ctx, bk, x: HUint, y: HUint) -> tfhe.Ciphertext:
    """Encrypted signed (x >= y): same-sign -> unsigned compare; different
    signs -> x >= y iff y is the negative one."""
    _check_same(x, y)
    geu = ge(ctx, bk, x, y)                      # no-borrow of x - y
    sx, sy = _msb(x), _msb(y)
    same = tfhe.XNOR(ctx, bk, sx, sy)
    return tfhe.MUX(ctx, bk, same, geu, sy)


def shift_right_arith(ctx, x: HUint, k: int) -> HUint:
    """x >> k replicating the sign bit (free — bit positions move)."""
    if k == 0:
        return x
    k = min(k, x.width - 1)
    a, b = _per_int(x.bits, x.count, x.width)
    ct = tfhe.Ciphertext(
        torch.cat([a[:, k:], a[:, -1:].expand(x.count, k, a.shape[-1])], dim=1)
        .reshape(x.bits.a.shape),
        torch.cat([b[:, k:], b[:, -1:].expand(x.count, k)], dim=1).reshape(x.bits.b.shape),
        variance=x.bits.variance)
    return HUint(ct, x.width, x.count)
