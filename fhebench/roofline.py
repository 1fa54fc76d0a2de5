"""The least time an H100 could take for the port's heavy operations, from
their shapes alone: the larger of the int32 operations over the int32 rate
and the bytes (each input read once, each output written once) over HBM3's
bandwidth.  A frozen copy of the arithmetic in the repository's
`chip_smoke.py` (`bound`, `transform_ops`, `keyswitch_bound`, the blind
rotation's bound and their constants), computed from shape counts rather than
from the port's objects, so that no later change to the program moves it.

Peaks of one H100 SXM (NVIDIA's data sheet, at its 700 W power limit):
3.35 TB/s of HBM3, and the int32 rate taken as the published 67 TFLOP/s of
float32 over 4 (an FMA counts as 2 flops, and an SM has 64 INT32 lanes
against 128 FP32 lanes).
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 4
WORD = 4             # bytes of a residue or a torus word (int32)
# Lower counts of int32 instructions per unit of work.
BUTTERFLY_OPS = 6    # Shoup butterfly: a*w, umulhi(a, w'), the -q*p multiply-add, add, sub, select
SHOUP_OPS = 3        # Shoup product by a table constant
MAC_OPS = 2          # 32x32 -> 64-bit multiply-accumulate
FOLD_OPS = 10        # REDC of a 64-bit sum with the Barrett pre-reduction


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    """(least ms, "bytes" or "operations") for moving nbytes and doing ops."""
    o_ms = ops / INT32_OPS_PER_S * 1e3
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")


def split_n(n: int) -> tuple[int, int]:
    """The four-step transform's N1 * N2 = n, N1 = 2^(log n // 2) <= N2."""
    n1 = 1 << ((n.bit_length() - 1) // 2)
    return n1, n // n1


def transform_ops(rows: int, n: int) -> int:
    """Butterflies and cross-twiddle products of `rows` n-point transforms."""
    return rows * (n // 2 * (n.bit_length() - 1) * BUTTERFLY_OPS + n * SHOUP_OPS)


def ntt_table_words(limbs: int, n: int) -> int:
    """Words of one limb set's transform tables that a fused keyswitch reads:
    the per-limb constants (p, pinv, mu), the forward and inverse cross
    twiddles with their Shoup companions (n each), and the packed stage
    tables of both sizes and directions with their companions."""
    n1, n2 = split_n(n)
    return limbs * (3 + 4 * n + 4 * n1 + 4 * n2)


def keyswitch_bound(n: int, ka: int, kqp: int, digits: int, alpha: int) -> tuple[float, str]:
    """The hybrid (Method II) keyswitch of one polynomial of `ka` limbs into
    `kqp` = ka + specials limbs with `digits` digits of `alpha` primes: reads
    the input, the digits' conversion matrix, both key halves and the tables
    once, writes the two output halves; transforms the digits' and the two
    halves' rows, builds the digits (a product a term, a fold a digit) and
    MACs (a product a digit and half, a fold a half), over every limb."""
    words = (ka * n + digits * alpha * kqp + 2 * digits * kqp * n + ntt_table_words(kqp, n)
             + 2 * kqp * n)
    ops = (transform_ops(digits * kqp + 2 * kqp, n) + kqp * n * (ka * MAC_OPS + digits * FOLD_OPS)
           + 2 * digits * kqp * n * MAC_OPS + 2 * kqp * n * FOLD_OPS)
    return bound_ms(words * WORD, ops)


def keyswitch_shapes(n: int, limbs: int, specials: int, alpha: int) -> dict:
    """The keyswitch's shape at a level with `limbs` active Q limbs."""
    return {"n": n, "ka": limbs, "kqp": limbs + specials, "digits": -(-limbs // alpha),
            "alpha": alpha}


def blind_rotate_bound(batch: int, lwe_n: int, big_n: int, rows: int = 4,
                       comps: int = 2, crt_limbs: int = 2) -> tuple[float, str]:
    """The gate bootstrap's blind rotation of `batch` gates: lwe_n CMux steps
    a gate, each transforming the accumulator's comps rows back and the
    digits' `rows` rows forward, over each limb of the CRT pair (12
    transforms of big_n points at STD128); reads the bootstrapping key (lwe_n, rows, comps, limbs,
    big_n) once and the accumulator and rotation amounts, writes the
    accumulator."""
    key = lwe_n * rows * comps * crt_limbs * big_n
    acc = batch * comps * crt_limbs * big_n
    words = key + 2 * acc + batch * lwe_n
    return bound_ms(words * WORD, batch * lwe_n * transform_ops((comps + rows) * crt_limbs, big_n))
