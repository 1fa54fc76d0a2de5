"""Plain TFHE on the 32-bit torus: the phase of an LWE sample under the LWE
secret key, the bit it encodes, and its distance from the encoding.

A sample (a, b) of dimension n under the binary key s has the phase
b - <a, s> mod 2^32; a bit is encoded as +1/8 of the torus (true) or -1/8
(false), so its sign decides the bit, and its distance from the nearest
encoding is the sample's noise.  Circuits are given by what they compute on
plain bits and integers.
"""

from __future__ import annotations

import numpy as np
import torch

MU = 1 << 29          # 1/8 of the torus
TORUS = 1 << 32


def phases(a: torch.Tensor, b: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """(B,) phases in [0, 2^32) of B samples: a (B, n), b (B,) and s (n,)
    as integers of any sign (torus words read mod 2^32)."""
    a, b, s = a.to(torch.int64), b.to(torch.int64), s.to(torch.int64).to(a.device)
    return torch.remainder(b - (a * s).sum(-1), TORUS)


def bits_and_gaps(ph: torch.Tensor):
    """(bits as a bool numpy array, each phase's distance from its bit's
    encoding as a share of the torus)."""
    ph = ph.cpu().numpy().astype(np.int64)
    bits = ph < TORUS // 2
    want = np.where(bits, MU, TORUS - MU)
    d = (ph - want) % TORUS
    return bits, np.minimum(d, TORUS - d) / TORUS


def gate(name: str, x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """A two-input boolean gate on plain bits."""
    x, y = np.asarray(x, bool), np.asarray(y, bool)
    table = {"NAND": lambda: ~(x & y), "AND": lambda: x & y, "OR": lambda: x | y,
             "NOR": lambda: ~(x | y), "XOR": lambda: x ^ y, "XNOR": lambda: ~(x ^ y)}
    return table[name]()


def to_ints(bits: np.ndarray, width: int) -> np.ndarray:
    """Integers from their bits, `width` bits an integer, least significant first."""
    b = np.asarray(bits, np.int64).reshape(-1, width)
    return (b << np.arange(width)).sum(-1)
