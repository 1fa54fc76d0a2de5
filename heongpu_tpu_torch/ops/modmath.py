"""Modular arithmetic on residue tensors (port of heongpu_tpu/ops/modmath.py).

Residues are stored as torch.int32 (canonical values < p < 2^30, so the bits
equal the reference's uint32 arrays).  These plain versions upcast to int64
and compute exactly with `*` and `%`: a product of two residues is below
2^60, and every function returns the canonical residue the reference returns,
as torch.int32.  Constants broadcast like the operands, usually (L, 1)
against (..., L, N).

Montgomery form uses R = 2^32 as in the reference; since the plain versions
are exact, `mont_mul` needs R^{-1} mod p (`mont_rinv`) in place of the
REDC constant -p^{-1} mod 2^32.  A word that may use all 32 bits (a raw
random draw, the high half of a 64-bit sum) arrives as int32 with its top
bit set or as int64; `barrett32` and `reduce64` read it as unsigned.
"""

from __future__ import annotations

import numpy as np
import torch

I32 = torch.int32
I64 = torch.int64
_U32_MASK = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# host-side constant builders (verbatim from the reference)
# ---------------------------------------------------------------------------

def mont_pinv(p: int) -> int:
    """-p^{-1} mod 2**32 (Montgomery n')."""
    return (-pow(p, -1, 1 << 32)) % (1 << 32)


def mont_r1(p: int) -> int:
    """R = 2**32 mod p."""
    return (1 << 32) % p


def mont_r2(p: int) -> int:
    """R^2 = 2**64 mod p."""
    return (1 << 64) % p


def mont_rinv(p: int) -> int:
    """R^{-1} = 2**-32 mod p."""
    return pow(1 << 32, -1, p)


def shoup(w: int, p: int) -> int:
    """floor(w * 2**32 / p) — Shoup precomputation for fixed multiplicand w."""
    return (w << 32) // p


def barrett_mu(p: int) -> int:
    """floor(2**32 / p) for the 32-bit Barrett reduction."""
    return (1 << 32) // p


def u32_to_i32(a):
    """uint32 bit patterns (numpy or python ints < 2^32) -> torch.int32 with
    the same bits (values >= 2^31 wrap negative)."""
    return torch.from_numpy(np.array(a, np.uint32).view(np.int32))


def as_u32(x):
    """Read a residue tensor's 32-bit words as unsigned int64 values."""
    return x.to(I64) & _U32_MASK


# ---------------------------------------------------------------------------
# modular primitives (canonical inputs < p; results canonical, int32)
# ---------------------------------------------------------------------------

def add_mod(a, b, p):
    return torch.remainder(a.to(I64) + b, p).to(I32)


def sub_mod(a, b, p):
    return torch.remainder(a.to(I64) - b, p).to(I32)


def neg_mod(a, p):
    return torch.remainder(-a.to(I64), p).to(I32)


def cond_sub(a, p):
    """Reduce a in [0, 2p) to [0, p)."""
    a = a.to(I64)
    return torch.where(a >= p, a - p, a).to(I32)


def mul_mod(a, b, p):
    """Exact a*b mod p."""
    return torch.remainder(a.to(I64) * b, p).to(I32)


def mont_mul(a, b, p, rinv):
    """a*b*2^-32 mod p (the reference's Montgomery REDC product)."""
    ab = torch.remainder(a.to(I64) * b, p)
    return torch.remainder(ab * rinv, p).to(I32)


def to_mont(a, p, r1):
    """a*2^32 mod p; r1 = 2^32 mod p."""
    return torch.remainder(a.to(I64) * r1, p).to(I32)


def from_mont(a, p, rinv):
    """a*2^-32 mod p."""
    return torch.remainder(a.to(I64) * rinv, p).to(I32)


def shoup_mul(a, w, p):
    """a*w mod p for a fixed multiplicand w (the reference's Shoup product;
    the exact version needs no companion)."""
    return torch.remainder(a.to(I64) * w, p).to(I32)


def barrett32(x, p):
    """x mod p for any 32-bit word x."""
    return torch.remainder(as_u32(x), p).to(I32)


def reduce64(hi, lo, p):
    """(hi*2^32 + lo) mod p exactly, hi and lo 32-bit words."""
    hi_m = torch.remainder(as_u32(hi), p)          # < 2^30, so hi_m·2^32 < 2^62
    return torch.remainder(hi_m * (1 << 32) + as_u32(lo), p).to(I32)
