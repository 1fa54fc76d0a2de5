"""Carry keys, ciphertexts and plaintexts between the JAX package and the
port as numpy arrays.

Keys and ciphertexts are this system's state: the reference's objects,
handed over as numpy uint32 arrays (`np.asarray` of its jax arrays), become
the port's int32 tensors with the same bits, and `to_numpy` turns them back.
Contexts are not carried: both packages rebuild theirs from the same
parameters, and the tests assert that the tables agree.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .models import ckks, ckks_boot, ringkit, tfhe, tfhe_int
from .ops import modmath as mm


def _t(a, device):
    a = np.asarray(a)
    if a.dtype == np.uint32:
        return mm.u32_to_i32(a).to(device)
    return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)


def to_numpy(t):
    """Residues -> the reference's numpy uint32 layout (int32 tensors are
    reinterpreted bit for bit).  A key, ciphertext or HUint becomes a dict of
    its fields, each converted the same way; a GaloisKey a dict of those, by
    Galois element."""
    if isinstance(t, ringkit.GaloisKey):
        return {elt: to_numpy(k) for elt, k in t.keys.items()}
    if dataclasses.is_dataclass(t) and not isinstance(t, type):
        return {f.name: to_numpy(getattr(t, f.name)) for f in dataclasses.fields(t)}
    if not isinstance(t, torch.Tensor):
        return t
    a = t.detach().cpu().contiguous().numpy()
    return a.view(np.uint32) if a.dtype == np.int32 else a


def secret_key_from_numpy(s_coeff, s_ntt_mont_qp, hw: int, device="cuda"):
    return ringkit.SecretKey(
        torch.from_numpy(np.asarray(s_coeff, np.int32).copy()).to(device),
        _t(s_ntt_mont_qp, device), int(hw))


def public_key_from_numpy(pk0, pk1, device="cuda"):
    return ringkit.PublicKey(_t(pk0, device), _t(pk1, device))


def ks_key_from_numpy(k0, k1, device="cuda"):
    return ringkit.KSKey(_t(k0, device), _t(k1, device))


_GALOIS_TENSORS = ("k0", "k1", "perm_coeff_src", "perm_coeff_neg", "perm_ntt")


def galois_key_from_numpy(keys: dict, device="cuda"):
    """A GaloisKey from {Galois element or "conj": {field: value}}, the
    reference's GaloisKey carried element by element (its keys' k0, k1,
    perm_coeff_src, perm_coeff_neg, perm_ntt, galois_elt, inv_form)."""
    return ringkit.GaloisKey({
        elt: ringkit.GaloisKeyOne(*(_t(f[name], device) for name in _GALOIS_TENSORS),
                                  galois_elt=int(f["galois_elt"]),
                                  inv_form=bool(f["inv_form"]))
        for elt, f in keys.items()})


def ciphertext_from_numpy(c, size: int, level: int, scale: float, device="cuda"):
    return ckks.Ciphertext(_t(c, device), int(size), int(level), float(scale))


def plaintext_from_numpy(m, level: int, scale: float, device="cuda"):
    return ckks.Plaintext(_t(m, device), int(level), float(scale))


def tfhe_secret_key_from_numpy(lwe, rlwe, device="cuda"):
    return tfhe.SecretKey(_t(lwe, device), _t(rlwe, device))


def tfhe_boot_key_from_numpy(bk, ksk_a, ksk_b, device="cuda"):
    return tfhe.BootKey(_t(bk, device), _t(ksk_a, device), _t(ksk_b, device))


def tfhe_boot_key2_from_numpy(bk2, ksk_a, ksk_b, device="cuda"):
    return tfhe.BootKey2(_t(bk2, device), _t(ksk_a, device), _t(ksk_b, device))


def tfhe_ciphertext_from_numpy(a, b, variance: float = 0.0, device="cuda"):
    return tfhe.Ciphertext(_t(a, device), _t(b, device), float(variance))


def huint_from_numpy(a, b, variance: float, width: int, count: int, device="cuda"):
    return tfhe_int.HUint(tfhe_ciphertext_from_numpy(a, b, variance, device),
                          int(width), int(count))


def boot_keys_from_numpy(gk: dict, rk: dict, cfg: dict, msg_scale: float,
                         ctos_pieces, stoc_pieces, mult_i, mult_neg_i, device="cuda"):
    """The reference's BootKeys as the port's: gk as for galois_key_from_numpy;
    rk {"k0", "k1"}; cfg the BootConfig fields; each piece a dict of its
    level, n1, giants ((g, babies, uint32 diagonals), ...), pt_scale and
    depth; mult_i / mult_neg_i the (table, Shoup table) pairs."""
    def piece(p):
        return ckks_boot.Piece(
            level=int(p["level"]), n1=int(p["n1"]), pt_scale=float(p["pt_scale"]),
            depth=int(p["depth"]),
            giants=tuple((int(g), tuple(int(b) for b in babies), _t(pts, device))
                         for g, babies, pts in p["giants"]))

    return ckks_boot.BootKeys(
        gk=galois_key_from_numpy(gk, device), rk=ks_key_from_numpy(rk["k0"], rk["k1"], device),
        cfg=ckks_boot.BootConfig(**cfg), msg_scale=float(msg_scale),
        ctos_pieces=[piece(p) for p in ctos_pieces], stoc_pieces=[piece(p) for p in stoc_pieces],
        mult_i=tuple(_t(t, device) for t in mult_i),
        mult_neg_i=tuple(_t(t, device) for t in mult_neg_i))
