"""Galois automorphism tables (port of the table builders in
heongpu_tpu/ops/polyops.py that the CKKS context needs).

NTT-domain convention (ops/ntt.py): storage position p holds the evaluation
at psi^(2j+1) with j = eval_order(n)[p], so sigma_g acts on natural
evaluation indices as j -> j' with 2j'+1 = g·(2j+1) mod 2n.
"""

from __future__ import annotations

import numpy as np
import torch


def galois_perm_coeff(g: int, n: int, device="cpu"):
    """Coefficient-domain automorphism tables: (src_index int32,
    negate int32 in {0, 1}) with out[j] = (-1)^negate[j] * in[src_index[j]]."""
    m = 2 * n
    i = np.arange(n, dtype=np.int64)
    r = (i * g) % m
    wrap = r >= n
    dst = np.where(wrap, r - n, r)
    src = np.empty(n, np.int32)
    neg = np.empty(n, np.int32)
    src[dst] = i
    neg[dst] = wrap
    return torch.from_numpy(src).to(device), torch.from_numpy(neg).to(device)


def galois_perm_ntt(g: int, n: int, device="cpu"):
    """NTT-domain automorphism gather table in storage order:
    out[p] = in[perm[p]]."""
    from . import ntt as nttm
    eo = nttm.eval_order(n).astype(np.int64)
    ieo = nttm.inv_eval_order(n).astype(np.int64)
    src_nat = ((g * (2 * eo + 1)) % (2 * n) - 1) // 2
    return torch.from_numpy(ieo[src_nat].astype(np.int32)).to(device)
