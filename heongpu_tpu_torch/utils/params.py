"""Security-standard parameter table (max log2(Q·P) per ring degree), copied
from heongpu_tpu/utils/params.py."""

from __future__ import annotations

from typing import List

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
