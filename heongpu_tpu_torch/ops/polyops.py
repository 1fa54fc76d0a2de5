"""Polynomial-ring structural ops: Galois automorphisms and negacyclic shifts
(port of heongpu_tpu/ops/polyops.py).

Both domains reduce to a fixed gather along the last axis, plus a sign fixup
in the coefficient domain.  Negation masks are int32 {0, 1} here (uint32 in
the reference); the values are the same.

NTT-domain convention (ops/ntt.py): storage position p holds the evaluation
at psi^(2j+1) with j = eval_order(n)[p], so sigma_g acts on natural
evaluation indices as j -> j' with 2j'+1 = g·(2j+1) mod 2n.
"""

from __future__ import annotations

import numpy as np
import torch

from . import modmath as mm

GALOIS_CONJ = "conj"  # key of the conjugation element 2n - 1 in a GaloisKey


def steps_to_galois_elt(step: int, n: int) -> int:
    """Rotation step -> Galois element 5^step mod 2n (negative steps wrap)."""
    return pow(5, step % (n // 2), 2 * n)


def _signed_perm(r, n: int, device):
    """(src, neg) with out[dst] = (-1)^wrap · in[i], where r[i] = the image
    of X^i's exponent mod 2n, dst = r mod n and wrap = r >= n."""
    wrap = r >= n
    dst = np.where(wrap, r - n, r)
    src = np.empty(n, np.int32)
    neg = np.empty(n, np.int32)
    src[dst] = np.arange(n, dtype=np.int32)
    neg[dst] = wrap
    return torch.from_numpy(src).to(device), torch.from_numpy(neg).to(device)


def galois_perm_coeff(g: int, n: int, device):
    """Coefficient-domain automorphism tables: (src_index int32,
    negate int32 in {0, 1}) with out[j] = (-1)^negate[j] * in[src_index[j]]."""
    return _signed_perm(np.arange(n, dtype=np.int64) * g % (2 * n), n, device)


def galois_perm_ntt(g: int, n: int, device):
    """NTT-domain automorphism gather table in storage order:
    out[p] = in[perm[p]]."""
    from . import ntt as nttm
    eo = nttm.eval_order(n).astype(np.int64)
    ieo = nttm.inv_eval_order(n).astype(np.int64)
    src_nat = ((g * (2 * eo + 1)) % (2 * n) - 1) // 2
    return torch.from_numpy(ieo[src_nat].astype(np.int32)).to(device)


def apply_galois_coeff(x, src, neg, p):
    """x: (..., L, N) coefficient domain; p broadcastable (L, 1)."""
    y = torch.index_select(x, -1, src)
    return torch.where(neg.bool(), mm.neg_mod(y, p), y)


def apply_galois_ntt(x, perm):
    """x: (..., L, N) NTT domain, gathered by a galois_perm_ntt table."""
    return torch.index_select(x, -1, perm)


def tensor_product(a, b, p):
    """(a0 + a1·s)(b0 + b1·s) pointwise: two (2, L, N) ciphertexts in the NTT
    domain -> the (3, L, N) product, each term exact mod p (L, 1)."""
    a0, a1, b0, b1 = (x.to(mm.I64) for x in (a[0], a[1], b[0], b[1]))
    return torch.stack([torch.remainder(a0 * b0, p),
                        torch.remainder(torch.remainder(a0 * b1, p) + a1 * b0, p),
                        torch.remainder(a1 * b1, p)]).to(mm.I32)


def negacyclic_shift_tables(k: int, n: int, device):
    """Tables for multiplication by X^k (k may be negative)."""
    return _signed_perm((np.arange(n, dtype=np.int64) + k % (2 * n)) % (2 * n), n, device)


def negacyclic_shift(x, src, neg, p):
    """x · X^k in the coefficient domain, with negacyclic_shift_tables."""
    return apply_galois_coeff(x, src, neg, p)
