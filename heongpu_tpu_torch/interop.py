"""Carry keys, ciphertexts and plaintexts between the JAX package and the
port as numpy arrays.

Keys and ciphertexts are this system's state: the reference's objects
(BFV keys are ringkit's key types, so the key converters carry them too),
handed over as numpy uint32 arrays (`np.asarray` of its jax arrays), become
the port's int32 tensors with the same bits, and `to_numpy` turns them back.
Contexts are not carried: both packages rebuild theirs from the same
parameters, and the tests assert that the tables agree.  A seed-expanded
key carries its `a_seed`, and a stripped one (its uniform half None) stays
stripped: the port regenerates that half from the seed where it is used.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .models import bfv, bgv, ckks, ckks_boot, ckks_boot_ext, ringkit, tfhe, tfhe_int
from .ops import modmath as mm


def _t(a, device):
    """A residue array as an int32 tensor with the same bits; None (a key's
    stripped half, also as np.asarray(None)) stays None."""
    if a is None or (isinstance(a, np.ndarray) and a.dtype == object and a.ndim == 0
                     and a.item() is None):
        return None
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


def _seed(a_seed):
    return None if a_seed is None else int(a_seed)


def public_key_from_numpy(pk0, pk1, a_seed=None, device="cuda"):
    return ringkit.PublicKey(_t(pk0, device), _t(pk1, device), _seed(a_seed))


def ks_key_from_numpy(k0, k1, a_seed=None, device="cuda"):
    return ringkit.KSKey(_t(k0, device), _t(k1, device), _seed(a_seed))


_GALOIS_TENSORS = ("k0", "k1", "perm_coeff_src", "perm_coeff_neg", "perm_ntt")


def galois_key_from_numpy(keys: dict, device="cuda"):
    """A GaloisKey from {Galois element or "conj": {field: value}}, the
    reference's GaloisKey carried element by element (its keys' k0, k1 (None
    when stripped), perm_coeff_src, perm_coeff_neg, perm_ntt, galois_elt,
    inv_form and, where given, a_seed)."""
    return ringkit.GaloisKey({
        elt: ringkit.GaloisKeyOne(*(_t(f[name], device) for name in _GALOIS_TENSORS),
                                  galois_elt=int(f["galois_elt"]),
                                  inv_form=bool(f["inv_form"]), a_seed=_seed(f.get("a_seed")))
        for elt, f in keys.items()})


def ciphertext_from_numpy(c, size: int, level: int, scale: float, device="cuda"):
    return ckks.Ciphertext(_t(c, device), int(size), int(level), float(scale))


def plaintext_from_numpy(m, level: int, scale: float, device="cuda"):
    return ckks.Plaintext(_t(m, device), int(level), float(scale))


def bfv_ciphertext_from_numpy(c, size: int, in_ntt: bool = False, device="cuda"):
    return bfv.Ciphertext(_t(c, device), int(size), bool(in_ntt))


def bgv_ciphertext_from_numpy(c, size: int, level: int, factor: int, device="cuda"):
    return bgv.Ciphertext(_t(c, device), int(size), int(level), int(factor))


def bfv_plaintext_from_numpy(m, device="cuda"):
    """A BFV plaintext poly (n,) mod t."""
    return _t(m, device)


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


def _boot_piece(p, device):
    return ckks_boot.Piece(
        level=int(p["level"]), n1=int(p["n1"]), pt_scale=float(p["pt_scale"]),
        depth=int(p["depth"]),
        giants=tuple((int(g), tuple(int(b) for b in babies), _t(pts, device))
                     for g, babies, pts in p["giants"]))


def _rk(k: dict, device):
    return ks_key_from_numpy(k["k0"], k["k1"], k.get("a_seed"), device=device)


def boot_keys_from_numpy(gk: dict, rk: dict, cfg: dict, msg_scale: float,
                         ctos_pieces, stoc_pieces, mult_i, mult_neg_i, device="cuda"):
    """The reference's BootKeys as the port's: gk as for galois_key_from_numpy;
    rk {"k0", "k1"} and, where given, "a_seed"; cfg the BootConfig fields; each piece a dict of its
    level, n1, giants ((g, babies, uint32 diagonals), ...), pt_scale and
    depth; mult_i / mult_neg_i the (table, Shoup table) pairs."""
    return ckks_boot.BootKeys(
        gk=galois_key_from_numpy(gk, device), rk=_rk(rk, device),
        cfg=ckks_boot.BootConfig(**cfg), msg_scale=float(msg_scale),
        ctos_pieces=[_boot_piece(p, device) for p in ctos_pieces],
        stoc_pieces=[_boot_piece(p, device) for p in stoc_pieces],
        mult_i=tuple(_t(t, device) for t in mult_i),
        mult_neg_i=tuple(_t(t, device) for t in mult_neg_i))


def boot_keys_v2_from_numpy(gk: dict, rk: dict, cfg: dict, msg_scale: float, variant: str,
                            ctos_pieces, stoc_pieces, mult_i, mult_neg_i, cos_coeffs,
                            swk_to_sparse: dict = None, swk_to_dense: dict = None,
                            device="cuda"):
    """The reference's BootKeysV2 as the port's: the fields as for
    boot_keys_from_numpy, cfg the BootConfigV2 fields, cos_coeffs the
    power-basis cosine coefficients, and each switch key {"k0", "k1"} or
    None (no sparse-secret switching)."""
    swk = lambda k: None if k is None else _rk(k, device)
    return ckks_boot_ext.BootKeysV2(
        gk=galois_key_from_numpy(gk, device), rk=_rk(rk, device),
        cfg=ckks_boot_ext.BootConfigV2(**cfg), msg_scale=float(msg_scale), variant=str(variant),
        ctos_pieces=[_boot_piece(p, device) for p in ctos_pieces],
        stoc_pieces=[_boot_piece(p, device) for p in stoc_pieces],
        mult_i=tuple(_t(t, device) for t in mult_i),
        mult_neg_i=tuple(_t(t, device) for t in mult_neg_i),
        cos_coeffs=np.asarray(cos_coeffs, np.float64),
        swk_to_sparse=swk(swk_to_sparse), swk_to_dense=swk(swk_to_dense))
