"""Carry keys, ciphertexts and plaintexts between the JAX package and the
port as numpy arrays.

Keys and ciphertexts are this system's state: the reference's objects,
handed over as numpy uint32 arrays (`np.asarray` of its jax arrays), become
the port's int32 tensors with the same bits, and `to_numpy` turns them back.
Contexts are not carried: both packages rebuild theirs from the same
parameters, and the tests assert that the tables agree.
"""

from __future__ import annotations

import numpy as np
import torch

from .models import ckks, ringkit
from .ops import modmath as mm


def _t(a, device):
    a = np.asarray(a)
    if a.dtype == np.uint32:
        return mm.u32_to_i32(a).to(device)
    return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """Residues -> the reference's numpy uint32 layout (int32 tensors are
    reinterpreted bit for bit)."""
    a = t.detach().cpu().contiguous().numpy()
    return a.view(np.uint32) if a.dtype == np.int32 else a


def secret_key_from_numpy(s_coeff, s_ntt_mont_qp, hw: int, device="cpu"):
    return ringkit.SecretKey(
        torch.from_numpy(np.asarray(s_coeff, np.int32).copy()).to(device),
        _t(s_ntt_mont_qp, device), int(hw))


def public_key_from_numpy(pk0, pk1, device="cpu"):
    return ringkit.PublicKey(_t(pk0, device), _t(pk1, device))


def ks_key_from_numpy(k0, k1, device="cpu"):
    return ringkit.KSKey(_t(k0, device), _t(k1, device))


def ciphertext_from_numpy(c, size: int, level: int, scale: float, device="cpu"):
    return ckks.Ciphertext(_t(c, device), int(size), int(level), float(scale))


def plaintext_from_numpy(m, level: int, scale: float, device="cpu"):
    return ckks.Plaintext(_t(m, device), int(level), float(scale))
