"""Binary serialization with zlib compression, on the JAX package's wire
format (port of heongpu_tpu/utils/serializer.py).

Format, as the reference writes it:
zlib( b"HTPU" | <II version, header length> | JSON header | <I array count> |
for each array: <Q byte length> + its raw C-order bytes ).  The header
describes the object: scalars, tuples, lists, dicts, arrays (dtype and
shape) and objects ({"cls": "module:Class", "fields": {...}}).

Keys, ciphertexts, plaintexts, MPC shares, the bootstrapping key sets
(BootKeys, BootKeysV2 and their configs and pieces), TFHE's boot keys and
HUint integers cross between the packages both ways.  The port writes them
under the reference's class paths (`heongpu_tpu.models.ringkit:SecretKey`,
`heongpu_tpu.models.ckks_boot_ext:BootKeysV2`, ...) with the reference's
field order, residues as uint32 blobs holding the int32 tensors' bits, and
numpy arrays (BootKeysV2.cos_coeffs) with their own dtype, so it writes the
reference's bytes for the same object; on load it maps such a path to its
own class by a table (`wire_table`), without importing the reference.  A
bare residue tensor (a BFV plaintext, an MPC share) is written as uint32
too.  So a key, key set, ciphertext, plaintext or share saved by either
package loads in the other.

The reference's contexts (CkksContext, BfvContext, BgvContext,
TfheContext) load too, but are rebuilt, not unpacked (`context_table`): the
port reads their parameter fields, builds its own context from them with
its make_context on `device`, and checks every stored prime, the default
scale and every table that the port also builds against the rebuilt one,
bit for bit; a mismatch raises ValueError naming the field.  The
reference's tables that the port does not build (the MXU tables, the
per-stage division tables it keeps in another form) are skipped.  The port
writes its own contexts under its own class paths only: they round-trip
within the port, and the reference cannot load them.  Loading rebuilds
every tensor on `device` (the card unless the caller asks for the CPU), the
context's device field included.

Loading builds only classes of the tables: a reference path through
`wire_table` or `context_table`, a port path through `port_table` (the
dataclasses defined in PORT_MODULES, by exact path).  Any other path raises
ValueError, so bytes from another party cannot name a function
(`...rng:os.system`) for the loader to call with fields of their choosing.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib
import io
import json
import struct
import zlib
from typing import Any

import numpy as np
import torch

MAGIC = b"HTPU"
VERSION = 1
REF_PREFIX = "heongpu_tpu."
PORT_PREFIX = "heongpu_tpu_torch."


@functools.lru_cache(maxsize=None)
def wire_table() -> dict:
    """{port class: (the reference's class path, its fields in the
    reference's order, the fields it keeps as signed int32, the fields it
    holds as numpy arrays)} for the objects that cross between the
    packages."""
    from ..models import bfv, bgv, ckks, ckks_boot, ckks_boot_ext, mpc, ringkit, tfhe, tfhe_int
    ref = "heongpu_tpu.models."
    return {
        ringkit.SecretKey: (ref + "ringkit:SecretKey",
                            ("s_coeff", "s_ntt_mont_qp", "hamming_weight"), ("s_coeff",), ()),
        ringkit.PublicKey: (ref + "ringkit:PublicKey", ("pk0", "pk1", "a_seed"), (), ()),
        ringkit.KSKey: (ref + "ringkit:KSKey", ("k0", "k1", "a_seed"), (), ()),
        ringkit.GaloisKeyOne: (ref + "ringkit:GaloisKeyOne",
                               ("k0", "k1", "perm_coeff_src", "perm_coeff_neg", "perm_ntt",
                                "galois_elt", "a_seed", "inv_form"),
                               ("perm_coeff_src", "perm_ntt"), ()),
        ringkit.GaloisKey: (ref + "ringkit:GaloisKey", ("keys",), (), ()),
        bfv.Ciphertext: (ref + "bfv:Ciphertext", ("c", "size", "in_ntt"), (), ()),
        ckks.Ciphertext: (ref + "ckks:Ciphertext", ("c", "size", "level", "scale"), (), ()),
        ckks.Plaintext: (ref + "ckks:Plaintext", ("m", "level", "scale"), (), ()),
        bgv.Ciphertext: (ref + "bgv:Ciphertext", ("c", "size", "level", "factor"), (), ()),
        mpc.RelinEphemeral: (ref + "mpc:RelinEphemeral", ("u_mont",), (), ()),
        mpc.ThresholdShare: (ref + "mpc:ThresholdShare",
                             ("index", "threshold", "s_ntt_mont_qp"), (), ()),
        tfhe.SecretKey: (ref + "tfhe:SecretKey", ("lwe", "rlwe"), (), ()),
        tfhe.Ciphertext: (ref + "tfhe:Ciphertext", ("a", "b", "variance"), (), ()),
        tfhe.BootKey: (ref + "tfhe:BootKey", ("bk", "ksk_a", "ksk_b"), (), ()),
        tfhe.BootKey2: (ref + "tfhe:BootKey2", ("bk2", "ksk_a", "ksk_b"), (), ()),
        tfhe_int.HUint: (ref + "tfhe_int:HUint", ("bits", "width", "count"), (), ()),
        ckks_boot.BootConfig: (ref + "ckks_boot:BootConfig",
                               ("taylor_degree", "exp_squarings", "ctos_pieces", "stoc_pieces",
                                "base_count", "arcsin_order", "piece_depth"), (), ()),
        # giants: ((giant step, babies, diagonals), ...), nested tuples on the wire
        ckks_boot.Piece: (ref + "ckks_boot:Piece", ("level", "n1", "giants", "pt_scale", "depth"),
                          (), ()),
        ckks_boot.BootKeys: (ref + "ckks_boot:BootKeys",
                             ("gk", "rk", "cfg", "msg_scale", "ctos_pieces", "stoc_pieces",
                              "mult_i", "mult_neg_i"), (), ()),
        ckks_boot_ext.BootConfigV2: (ref + "ckks_boot_ext:BootConfigV2",
                                     ("cos_degree", "double_angles", "K", "ctos_pieces",
                                      "stoc_pieces", "base_count"), (), ()),
        ckks_boot_ext.BootKeysV2: (ref + "ckks_boot_ext:BootKeysV2",
                                   ("gk", "rk", "cfg", "msg_scale", "variant", "ctos_pieces",
                                    "stoc_pieces", "mult_i", "mult_neg_i", "cos_coeffs",
                                    "swk_to_sparse", "swk_to_dense"), (), ("cos_coeffs",)),
    }


def _ckks_context(f: dict, device):
    from ..models import ckks
    return ckks.make_context(f["n"], [int(q).bit_length() for q in f["q_primes"]],
                             sec_level=f["sec_level"], ks_type=f["ks_type"], alpha=f["alpha"],
                             p_count=len(f["p_primes"]), device=device)


def _bfv_context(f: dict, device):
    from ..models import bfv
    return bfv.make_context(f["n"], f["t"], q_primes=list(f["q_primes"]),
                            sec_level=f["sec_level"], ks_type=f["ks_type"], alpha=f["alpha"],
                            device=device)


def _bgv_context(f: dict, device):
    from ..models import bgv
    return bgv.make_context(f["n"], f["t"], q_bits=[int(q).bit_length() for q in f["q_primes"]],
                            sec_level=f["sec_level"], device=device)


def _tfhe_context(f: dict, device):
    from ..models import tfhe
    return tfhe.make_context(f["n"], device=device)


@functools.lru_cache(maxsize=None)
def context_table() -> dict:
    """{the reference's context class path: a function of its parameter
    fields and a device that builds the port's context}.  Load-only: the
    port writes its own contexts under its own paths."""
    ref = "heongpu_tpu.models."
    return {ref + "ckks:CkksContext": _ckks_context, ref + "bfv:BfvContext": _bfv_context,
            ref + "bgv:BgvContext": _bgv_context, ref + "tfhe:TfheContext": _tfhe_context}


# the port's modules whose dataclasses (contexts, their tables, keys) may be
# written and loaded under the port's own class paths
PORT_MODULES = ("models.bfv", "models.bgv", "models.ckks", "models.ckks_boot",
                "models.ckks_boot_ext", "models.mpc", "models.ringkit", "models.tfhe",
                "models.tfhe_int", "ops.compose", "ops.keyswitch2", "ops.ntt", "ops.rns",
                "ops.sfft", "utils.precision")


@functools.lru_cache(maxsize=None)
def port_table() -> dict:
    """{"module:QualName": class} of every dataclass defined in PORT_MODULES
    (a class a module only imports is not its own)."""
    table = {}
    for name in PORT_MODULES:
        mod = importlib.import_module(PORT_PREFIX + name)
        for cls in vars(mod).values():
            if (isinstance(cls, type) and dataclasses.is_dataclass(cls)
                    and cls.__module__ == mod.__name__):
                table[f"{cls.__module__}:{cls.__qualname__}"] = cls
    return table


@functools.lru_cache(maxsize=None)
def _classes_by_path() -> dict:
    return {row[0]: cls for cls, row in wire_table().items()}


def _encode_meta(v):
    if isinstance(v, (int, float, str, bool)) or v is None:
        return v
    if isinstance(v, tuple):
        return {"__tuple__": [_encode_meta(x) for x in v]}
    raise TypeError(f"unsupported static field {type(v)}")


def _decode_meta(v):
    if isinstance(v, dict) and "__tuple__" in v:
        return tuple(_decode_meta(x) for x in v["__tuple__"])
    return v


def _flatten(obj, arrays, signed: bool = False):
    """Describe obj, appending its arrays to `arrays`.  An int32 tensor is
    written as uint32 with the same bits (the reference's residues) unless
    `signed`; other tensors keep their dtype, and numpy arrays and scalars
    are written as they are, as the reference writes them."""
    if obj is None:
        return {"t": "none"}
    if isinstance(obj, (int, float, str, bool)):
        return {"t": "scalar", "v": obj}
    if isinstance(obj, tuple):
        return {"t": "tuple", "items": [_flatten(x, arrays) for x in obj]}
    if isinstance(obj, list):
        return {"t": "list", "items": [_flatten(x, arrays) for x in obj]}
    if isinstance(obj, dict):
        return {"t": "dict", "keys": [_encode_meta(k) for k in obj.keys()],
                "vals": [_flatten(v, arrays) for v in obj.values()]}
    if isinstance(obj, torch.Tensor):
        a = obj.detach().cpu().contiguous().numpy()
        if a.dtype == np.int32 and not signed:
            a = a.view(np.uint32)
        arrays.append(a)
        return {"t": "array", "dtype": str(a.dtype), "shape": list(a.shape)}
    if isinstance(obj, np.ndarray) or (np.isscalar(obj) and hasattr(obj, "dtype")):
        a = np.asarray(obj)
        arrays.append(a)
        return {"t": "array", "dtype": str(a.dtype), "shape": list(a.shape)}
    if isinstance(obj, torch.device):
        return {"t": "device"}
    cls = type(obj)
    if cls in wire_table():
        path, names, signed_fields, _ = wire_table()[cls]
        return {"t": "obj", "cls": path,
                "fields": {k: _flatten(getattr(obj, k), arrays, k in signed_fields)
                           for k in names}}
    path = f"{cls.__module__}:{cls.__qualname__}"
    if port_table().get(path) is cls:
        return {"t": "obj", "cls": path,
                "fields": {k: _flatten(getattr(obj, k), arrays)
                           for k in obj.__dataclass_fields__}}
    raise TypeError(f"cannot serialize {cls}")


def _port_class(path: str):
    """The port's class for a path: a reference path through `wire_table`,
    a port path through `port_table`; nothing else."""
    if path.startswith(REF_PREFIX):
        if path not in _classes_by_path():
            raise ValueError(f"no port class for the reference's {path}")
        return _classes_by_path()[path]
    if not path.startswith(PORT_PREFIX):
        raise ValueError(f"{path} is neither the reference's nor the port's")
    if path not in port_table():
        raise ValueError(f"{path} is not a class the port loads")
    return port_table()[path]


def _array(desc, blobs, it) -> np.ndarray:
    return np.frombuffer(blobs[next(it)], dtype=np.dtype(desc["dtype"])).reshape(desc["shape"])


def _unflatten(desc, blobs, it, device, as_numpy: bool = False):
    """The object `desc` describes, its arrays taken from blobs in order:
    uint32 residues as int32 tensors on `device`, or numpy arrays of the
    written dtype when `as_numpy` (a field the port holds as numpy)."""
    t = desc["t"]
    if t == "none":
        return None
    if t == "scalar":
        return desc["v"]
    if t == "tuple":
        return tuple(_unflatten(d, blobs, it, device) for d in desc["items"])
    if t == "list":
        return [_unflatten(d, blobs, it, device) for d in desc["items"]]
    if t == "dict":
        return {_decode_meta(k): _unflatten(v, blobs, it, device)
                for k, v in zip(desc["keys"], desc["vals"])}
    if t == "device":
        return torch.device(device)
    if t == "array":
        a = _array(desc, blobs, it)
        if as_numpy:
            return a.copy()
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        return torch.from_numpy(a.copy()).to(device)
    if t == "obj":
        if desc["cls"] in context_table():
            return _rebuild_context(desc, blobs, it, device)
        cls = _port_class(desc["cls"])
        as_np = wire_table()[cls][3] if cls in wire_table() else ()
        return cls(**{k: _unflatten(v, blobs, it, device, k in as_np)
                      for k, v in desc["fields"].items()})
    raise ValueError(f"unknown entry {t!r}")


# =========================================================================
# The reference's contexts: rebuilt from their parameters, checked
# =========================================================================

def _static(desc):
    """A scalar or a tuple of scalars of a header, as a value."""
    if desc["t"] == "scalar":
        return desc["v"]
    if desc["t"] == "tuple":
        return tuple(_static(d) for d in desc["items"])
    raise ValueError(f"a context parameter written as {desc['t']!r}")


def _same_array(a: np.ndarray, b) -> bool:
    """The stored array a equals the port's value b (a tensor holding the
    same bits or the same integers, or a Python number)."""
    if isinstance(b, torch.Tensor):
        b = b.detach().cpu().numpy()
        if b.dtype == np.int32 and a.dtype == np.uint32:
            b = b.view(np.uint32)
        return a.shape == b.shape and np.array_equal(a, b)
    if isinstance(b, (int, float, bool, np.integer, np.floating)):
        return a.size == 1 and a.reshape(()).item() == b
    return False


_SKIP = object()   # a stored value the port does not build: read past, not compared


def _check_context(desc, blobs, it, port, where: str):
    """Walk the reference context's entry `desc` beside the port's value
    `port`, taking every array from blobs in order, and raise ValueError at
    the first stored value that the port also builds and that differs.  A
    field the port lacks, or holds in another structure (a DivRoundChain for
    a tuple of stages), is read past (`_SKIP`)."""
    t, skip = desc["t"], port is _SKIP
    if t == "array":
        a = _array(desc, blobs, it)
        if not skip and not _same_array(a, port):
            raise ValueError(f"{where}: the stored table differs from the port's rebuilt one")
    elif t == "scalar":
        v = port.item() if isinstance(port, torch.Tensor) and port.numel() == 1 else port
        if not skip and v != desc["v"]:
            raise ValueError(f"{where}: stored {desc['v']!r}, the port rebuilt {v!r}")
    elif t in ("tuple", "list"):
        items = desc["items"]
        seq = port if isinstance(port, (tuple, list)) else None
        if seq is not None and len(seq) != len(items):
            raise ValueError(f"{where}: {len(items)} stored entries, the port rebuilt {len(seq)}")
        for i, d in enumerate(items):
            _check_context(d, blobs, it, _SKIP if seq is None else seq[i], f"{where}[{i}]")
    elif t == "dict":
        for k, v in zip(desc["keys"], desc["vals"]):
            k = _decode_meta(k)
            sub = port.get(k, _SKIP) if isinstance(port, dict) else _SKIP
            _check_context(v, blobs, it, sub, f"{where}[{k!r}]")
    elif t == "obj":
        for k, v in desc["fields"].items():
            _check_context(v, blobs, it, _SKIP if skip else getattr(port, k, _SKIP),
                           f"{where}.{k}")
    elif t == "none":
        if not skip and port is not None:
            raise ValueError(f"{where}: stored None, the port rebuilt a value")
    else:
        raise ValueError(f"unknown entry {t!r}")


def _rebuild_context(desc, blobs, it, device):
    """The port's context for a reference context's entry: built from its
    parameter fields, then checked field by field against what was stored."""
    path, fields = desc["cls"], desc["fields"]
    params = {k: _static(v) for k, v in fields.items() if v["t"] in ("scalar", "tuple")
              and k in ("n", "t", "q_primes", "p_primes", "sec_level", "ks_type", "alpha")}
    ctx = context_table()[path](params, torch.device(device))
    _check_context(desc, blobs, it, ctx, path.rsplit(":", 1)[1])
    return ctx


def serialize(obj: Any, level: int = 6) -> bytes:
    """Object -> compressed bytes (reference serializer::serialize)."""
    arrays: list = []
    header = json.dumps(_flatten(obj, arrays)).encode()
    buf = io.BytesIO()
    buf.write(MAGIC)
    buf.write(struct.pack("<II", VERSION, len(header)))
    buf.write(header)
    buf.write(struct.pack("<I", len(arrays)))
    for a in arrays:
        raw = np.ascontiguousarray(a).tobytes()
        buf.write(struct.pack("<Q", len(raw)))
        buf.write(raw)
    return zlib.compress(buf.getvalue(), level)


def deserialize(data: bytes, device="cuda") -> Any:
    """Bytes of either package -> the port's object, its tensors on `device`."""
    buf = io.BytesIO(zlib.decompress(data))
    if buf.read(4) != MAGIC:
        raise ValueError("not a serialized object: bad magic")
    version, hlen = struct.unpack("<II", buf.read(8))
    if version != VERSION:
        raise ValueError(f"serializer version {version}, this one reads {VERSION}")
    desc = json.loads(buf.read(hlen).decode())
    (n_arr,) = struct.unpack("<I", buf.read(4))
    blobs = []
    for _ in range(n_arr):
        (ln,) = struct.unpack("<Q", buf.read(8))
        blobs.append(buf.read(ln))
    return _unflatten(desc, blobs, iter(range(n_arr)), device)


def save_to_file(obj: Any, path: str, level: int = 6):
    data = serialize(obj, level=level)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(data)))
        f.write(data)


def load_from_file(path: str, device="cuda") -> Any:
    with open(path, "rb") as f:
        (ln,) = struct.unpack("<Q", f.read(8))
        return deserialize(f.read(ln), device)
