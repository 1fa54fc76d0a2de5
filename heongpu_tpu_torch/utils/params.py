"""Security-standard parameter table (max log2(Q·P) per ring degree) and the
default modulus chains, copied from heongpu_tpu/utils/params.py."""

from __future__ import annotations

from typing import List

from . import nt

# max log2(Q*P) for ternary secret, sigma=3.2 (HE standard tables; the
# N=65536 row follows the reference library's extension of the table).
MAX_LOGQP = {
    "tc128": {1024: 27, 2048: 54, 4096: 109, 8192: 218, 16384: 438,
              32768: 881, 65536: 1792},
    "tc192": {1024: 19, 2048: 37, 4096: 75, 8192: 152, 16384: 305,
              32768: 611, 65536: 1243},
    "tc256": {1024: 14, 2048: 29, 4096: 58, 8192: 118, 16384: 237,
              32768: 476, 65536: 968},
}

MAX_POLY_DEGREE = 65536   # the reference library's largest ring (kernel/defines.h:14)
MIN_POLY_DEGREE = 1024
MAX_PRIME_BITS = 30       # residues are held in 32-bit lanes (the reference library allows 61)


def validate_security(n: int, qp_primes: List[int], sec_level: str = "tc128"):
    """Raise if the modulus chain exceeds the security budget for ring size n.
    sec_level: 'tc128' | 'tc192' | 'tc256' | 'none'."""
    if sec_level in (None, "none"):
        return
    table = MAX_LOGQP.get(sec_level)
    if table is None:
        raise ValueError(f"unknown security level {sec_level!r}")
    if n not in table:
        raise ValueError(f"unsupported poly degree {n}")
    total = sum(p.bit_length() for p in qp_primes)
    if total > table[n]:
        raise ValueError(
            f"modulus chain {total} bits exceeds {table[n]}-bit budget for "
            f"n={n} at {sec_level}")


def default_coeff_modulus(n: int, sec_level: str = "tc128") -> List[int]:
    """Default Q chain: fill the security budget with 29-bit primes, leaving
    room for one 30-bit special prime."""
    level = sec_level if sec_level not in (None, "none") else "tc128"
    budget = MAX_LOGQP[level][n] - 30  # reserve the special prime
    count = max(1, budget // 29)
    return nt.generate_ntt_primes(29, count, n)


def plain_modulus_for(n: int, bits: int = 20) -> int:
    """An NTT-friendly plaintext modulus (t = 1 mod 2n) for BFV batching."""
    return nt.generate_ntt_primes(bits, 1, n)[0]
