"""Plain CKKS: decrypt and decode a ciphertext with the secret key's
coefficients, and the slot values a program of CKKS operations should give.

A ciphertext (c0, c1) over the active Q primes, stored in the evaluation
domain (ring.py), decrypts to m = c0 + c1 * s.  Its coefficients are small
(below q0 * q1 / 2, the product of the first two primes), so the first two
limbs fix each one by the Chinese remainder theorem, and every other limb
must agree with it: a coefficient where one does not is counted, never
decoded.  Decoding is the canonical embedding: slot j is m(zeta^(5^j mod 2n))
divided by the scale, zeta = exp(i pi / n).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from . import steps
from .ring import I64, Ring


@lru_cache(maxsize=8)
def _ring(primes: tuple, n: int, device: str) -> Ring:
    return Ring(primes, n, device)


def ring_of(primes, n: int, device) -> Ring:
    """The Ring of these primes at n on device, built once."""
    return _ring(tuple(int(q) for q in primes), n, str(device))


def decrypt_coeffs(c: torch.Tensor, s_coeff: torch.Tensor, primes):
    """(centered coefficients of c0 + c1 * s as float64 numpy, number of
    coefficients whose limbs disagree).  c: (2, L, n) over the first L of
    `primes`, L >= 2."""
    limbs, n = c.shape[1], c.shape[2]
    if limbs < 2 or c.shape[0] != 2:
        raise ValueError(f"expected a two-part ciphertext of two or more limbs, got "
                         f"{tuple(c.shape)}")
    ring = ring_of(primes[:limbs], n, c.device)
    p = ring.p[:, None]
    s_ev = ring.to_eval(s_coeff.to(c.device)[None].expand(limbs, -1))
    m = ring.to_coeffs((c[0].to(I64) + c[1].to(I64) * s_ev) % p)
    q0, q1 = ring.primes[0], ring.primes[1]
    # x = r0 + q0 * ((r1 - r0) * q0^-1 mod q1), then centered mod q0 * q1
    t = (m[1] - m[0]) % q1 * pow(q0, -1, q1) % q1
    x = m[0] + q0 * t
    x = torch.where(x > q0 * q1 // 2, x - q0 * q1, x)
    bad = (torch.remainder(x[None], p) != m).any(0).sum()
    return x.cpu().numpy().astype(np.float64), int(bad)


def decode(coeffs: np.ndarray, scale: float) -> np.ndarray:
    """The n/2 complex slots of a real coefficient vector."""
    n = coeffs.size
    spec = np.fft.ifft(coeffs / scale * np.exp(1j * np.pi * np.arange(n) / n)) * n
    idx = np.empty(n // 2, np.int64)
    g = 1
    for j in range(n // 2):
        idx[j] = (g - 1) // 2
        g = g * 5 % (2 * n)
    return spec[idx]


def expected_slots(program, plain: dict) -> np.ndarray:
    """The slots a request's program gives: `plain` maps "input" to the
    input's slots and step k to that step's own plain inputs; each entry of
    `program` is (k, op, args), one part of step k, replayed by the plain
    operation steps/ckks/<op>.py."""
    z = np.asarray(plain["input"], np.complex128)
    for k, op, args in program:
        z = steps.load("ckks", op).slots(z, args, plain.get(k))
    return z
