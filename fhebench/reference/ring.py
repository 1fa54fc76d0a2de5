"""Plain arithmetic of the negacyclic rings Z_p[X]/(X^n + 1): the storage
format of an evaluation-domain polynomial, and a textbook radix-2 transform
in int64 torch (values below 2^30, so every product fits in 63 bits).

The evaluation domain is the one the ciphertexts are stored in: for each
prime p, psi is the smallest primitive 2n-th root of unity among the first
odd powers of w = g^((p-1)/2n), g the least generator of Z_p^*, and storage
position a * n1 + b (n = n1 * n2, n1 = 2^(log n // 2)) holds the evaluation
at psi^(2j+1) with j = bitrev(a) * n1 + bitrev(b).  Everything here is worked
out from the primes and n alone.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

I64 = torch.int64


def is_prime(p: int) -> bool:
    if p < 2:
        return False
    d = 2
    while d * d <= p:
        if p % d == 0:
            return False
        d += 1
    return True


def ntt_primes(bits: int, count: int, n: int, exclude=()) -> list:
    """The `count` largest primes p = 1 (mod 2n) below 2^bits, not in exclude."""
    out, c = [], (1 << bits) - 1
    c -= (c - 1) % (2 * n)
    while len(out) < count and c > 1 << (bits - 1):
        if c not in exclude and is_prime(c):
            out.append(c)
        c -= 2 * n
    if len(out) < count:
        raise ValueError(f"fewer than {count} {bits}-bit primes for n={n}")
    return out


def _prime_factors(m: int) -> list:
    fs, d = [], 2
    while d * d <= m:
        if m % d == 0:
            fs.append(d)
            while m % d == 0:
                m //= d
        d += 1
    return fs + ([m] if m > 1 else [])


@lru_cache(maxsize=None)
def psi(p: int, n: int) -> int:
    """The format's primitive 2n-th root of unity mod p."""
    fs = _prime_factors(p - 1)
    g = 2
    while any(pow(g, (p - 1) // f, p) == 1 for f in fs):
        g += 1
    w = pow(g, (p - 1) // (2 * n), p)
    best, x = w, w
    for _ in range(3, min(2 * n, 512), 2):
        x = x * w * w % p
        if pow(x, n, p) == p - 1 and x < best:
            best = x
    return best


def _bitrev(bits: int) -> np.ndarray:
    idx = np.arange(1 << bits)
    out = np.zeros_like(idx)
    for b in range(bits):
        out |= ((idx >> b) & 1) << (bits - 1 - b)
    return out


@lru_cache(maxsize=None)
def eval_index(n: int) -> np.ndarray:
    """eval_index(n)[pos] = j: storage position pos holds a(psi^(2j+1))."""
    logn = n.bit_length() - 1
    n1 = 1 << (logn // 2)
    b1, b2 = logn // 2, logn - logn // 2
    return (_bitrev(b2)[:, None] * n1 + _bitrev(b1)[None, :]).reshape(-1)


def _powers(base: torch.Tensor, p: torch.Tensor, n: int) -> torch.Tensor:
    """(L, n): base^i mod p for i < n, by doubling."""
    out = torch.ones((base.shape[0], n), dtype=I64, device=base.device)
    k, step = 1, base.clone()
    while k < n:
        out[:, k:2 * k] = out[:, :k] * step[:, None] % p[:, None]
        step = step * step % p
        k *= 2
    return out


def _dft(x: torch.Tensor, root: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """(L, n) cyclic DFT mod p: X_k = sum_j x_j root^(jk), iterative radix 2."""
    L, n = x.shape
    pc = p[:, None, None]
    x = x[:, torch.from_numpy(_bitrev(n.bit_length() - 1)).to(x.device)]
    pw = _powers(root, p, n)
    m = 1
    while m < n:
        tw = pw[:, (n // (2 * m)) * torch.arange(m, device=x.device)][:, None, :]
        y = x.reshape(L, n // (2 * m), 2, m)
        u, v = y[:, :, 0, :], y[:, :, 1, :] * tw % pc
        x = torch.stack([(u + v) % pc, (u - v) % pc], dim=2).reshape(L, n)
        m *= 2
    return x


class Ring:
    """The transforms of one prime set at one n, on one torch device."""

    def __init__(self, primes, n: int, device):
        self.primes, self.n = [int(q) for q in primes], n
        self.p = torch.tensor(self.primes, dtype=I64, device=device)
        psis = [psi(q, n) for q in self.primes]
        self.psi = torch.tensor(psis, dtype=I64, device=device)
        self.ipsi = torch.tensor([pow(s, -1, q) for s, q in zip(psis, self.primes)],
                                 dtype=I64, device=device)
        self.n_inv = torch.tensor([pow(n, -1, q) for q in self.primes], dtype=I64, device=device)
        self.psi_pows = _powers(self.psi, self.p, n)
        self.ipsi_pows = _powers(self.ipsi, self.p, n)
        self.eval_index = torch.from_numpy(eval_index(n)).to(device)   # position -> j
        self.pos_of = self.eval_index.argsort()                       # j -> position

    def to_eval(self, coeffs: torch.Tensor) -> torch.Tensor:
        """(L, n) coefficients (any integers) -> evaluations in storage order."""
        p = self.p[:, None]
        x = torch.remainder(coeffs.to(I64), p) * self.psi_pows % p
        ev = _dft(x, self.psi * self.psi % self.p, self.p)      # natural order j
        return ev[:, self.eval_index]

    def to_coeffs(self, ev: torch.Tensor) -> torch.Tensor:
        """(L, n) evaluations in storage order -> coefficients in [0, p)."""
        p = self.p[:, None]
        nat = torch.remainder(ev.to(I64), p)[:, self.pos_of]
        a = _dft(nat, self.ipsi * self.ipsi % self.p, self.p)
        return a * self.ipsi_pows % p * self.n_inv[:, None] % p
