"""Host-side number theory: primes and primitive roots for NTT parameters.

Python integers, run once at context build time (a copy of
heongpu_tpu/utils/nt.py).  Prime generation and the minimal primitive root
take the native C++ engine (utils/native.py) when it is available, as the JAX
package does; both paths give the same numbers, which the tests hold.
"""

from __future__ import annotations

from typing import List

# Deterministic Miller-Rabin witnesses valid for all n < 3.3e24
_MR_WITNESSES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)


def is_prime(n: int) -> bool:
    if n < 2:
        return False
    for p in _MR_WITNESSES:
        if n % p == 0:
            return n == p
    d = n - 1
    r = 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in _MR_WITNESSES:
        x = pow(a, d, n)
        if x == 1 or x == n - 1:
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def generate_ntt_primes(bit_size: int, count: int, n: int,
                        exclude: set | None = None) -> List[int]:
    """`count` primes p ≡ 1 (mod 2n) below 2**bit_size, largest first."""
    assert bit_size <= 31, "residues are held in 32-bit lanes: primes < 2**31"
    from . import native
    if native.available():
        return native.generate_ntt_primes(bit_size, count, n, exclude)
    m = 2 * n
    exclude = exclude or set()
    out: List[int] = []
    c = (1 << bit_size) - 1
    c -= (c - 1) % m
    while len(out) < count and c > (1 << (bit_size - 1)):
        if c not in exclude and is_prime(c):
            out.append(c)
        c -= m
    if len(out) < count:
        raise ValueError(
            f"not enough {bit_size}-bit NTT primes for n={n} (found {len(out)}/{count})")
    return out


def _factorize(n: int) -> List[int]:
    fs = []
    d = 2
    while d * d <= n:
        if n % d == 0:
            fs.append(d)
            while n % d == 0:
                n //= d
        d += 1
    if n > 1:
        fs.append(n)
    return fs


def primitive_root(p: int) -> int:
    """Smallest generator of (Z/p)*."""
    phi = p - 1
    factors = _factorize(phi)
    g = 2
    while True:
        if all(pow(g, phi // f, p) != 1 for f in factors):
            return g
        g += 1


def root_of_unity(order: int, p: int) -> int:
    """A primitive `order`-th root of unity mod p; requires order | p-1."""
    assert (p - 1) % order == 0
    g = primitive_root(p)
    w = pow(g, (p - 1) // order, p)
    assert pow(w, order, p) == 1 and pow(w, order // 2, p) == p - 1
    return w


def minimal_primitive_root_2n(n2: int, p: int) -> int:
    """Smallest primitive 2n-th root of unity mod p among the first odd
    powers (deterministic tables)."""
    from . import native
    if native.available():
        return native.minimal_primitive_root_2n(n2, p)
    w = root_of_unity(n2, p)
    best = w
    x = w
    for k in range(3, min(n2, 512), 2):
        x = x * pow(w, 2, p) % p
        if pow(x, n2 // 2, p) == p - 1 and x < best:
            best = x
    return best


def bit_reverse(x: int, bits: int) -> int:
    r = 0
    for _ in range(bits):
        r = (r << 1) | (x & 1)
        x >>= 1
    return r


def crt_garner_coeffs(primes: List[int]):
    """Mixed-radix (Garner) coefficients for CRT composition on host."""
    k = len(primes)
    inv = [[0] * k for _ in range(k)]
    for i in range(k):
        for j in range(i + 1, k):
            inv[i][j] = pow(primes[i], -1, primes[j])
    return inv


def crt_compose(residues: List[int], primes: List[int]) -> int:
    """CRT compose to the centered integer in [-Q/2, Q/2)."""
    q = 1
    for p in primes:
        q *= p
    x = 0
    for r, p in zip(residues, primes):
        qi = q // p
        x = (x + r * qi * pow(qi, -1, p)) % q
    if x >= q // 2:
        x -= q
    return x
