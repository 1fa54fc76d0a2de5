"""Binary serialization with zlib compression, on the JAX package's wire
format (port of heongpu_tpu/utils/serializer.py).

Format, as the reference writes it:
zlib( b"HTPU" | <II version, header length> | JSON header | <I array count> |
for each array: <Q byte length> + its raw C-order bytes ).  The header
describes the object: scalars, tuples, lists, dicts, arrays (dtype and
shape) and objects ({"cls": "module:Class", "fields": {...}}).

Keys, ciphertexts, plaintexts and MPC shares cross between the packages.
The port writes them under the reference's class paths
(`heongpu_tpu.models.ringkit:SecretKey`, `heongpu_tpu.models.mpc:
ThresholdShare`, ...) with the reference's field order, and residues as
uint32 blobs holding the int32 tensors' bits, so it writes the reference's
bytes for the same object; on load it maps such a path to its own class by a
table (`wire_table`), without importing the reference.  A bare residue tensor (a
BFV plaintext, an MPC share) is written as uint32 too.  So a key,
ciphertext, plaintext or share saved by either package loads in the other.

Contexts and other objects outside the table (the port's tables) round-trip
within the port only, under the port's own class paths: both packages
rebuild their contexts from parameters and never carry them across
(interop.py).  Loading rebuilds every tensor on `device`
(the card unless the caller asks for the CPU), the context's device field
included.

Loading builds only classes of the two tables: a reference path through
`wire_table`, a port path through `port_table` (the dataclasses defined in
PORT_MODULES, by exact path).  Any other path raises ValueError, so bytes
from another party cannot name a function (`...rng:os.system`) for the
loader to call with fields of their choosing.
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
    reference's order, the fields it keeps as signed int32)} for the objects
    that cross between the packages."""
    from ..models import bfv, bgv, ckks, mpc, ringkit, tfhe
    ref = "heongpu_tpu.models."
    return {
        ringkit.SecretKey: (ref + "ringkit:SecretKey",
                            ("s_coeff", "s_ntt_mont_qp", "hamming_weight"), ("s_coeff",)),
        ringkit.PublicKey: (ref + "ringkit:PublicKey", ("pk0", "pk1", "a_seed"), ()),
        ringkit.KSKey: (ref + "ringkit:KSKey", ("k0", "k1", "a_seed"), ()),
        ringkit.GaloisKeyOne: (ref + "ringkit:GaloisKeyOne",
                               ("k0", "k1", "perm_coeff_src", "perm_coeff_neg", "perm_ntt",
                                "galois_elt", "a_seed", "inv_form"),
                               ("perm_coeff_src", "perm_ntt")),
        ringkit.GaloisKey: (ref + "ringkit:GaloisKey", ("keys",), ()),
        bfv.Ciphertext: (ref + "bfv:Ciphertext", ("c", "size", "in_ntt"), ()),
        ckks.Ciphertext: (ref + "ckks:Ciphertext", ("c", "size", "level", "scale"), ()),
        ckks.Plaintext: (ref + "ckks:Plaintext", ("m", "level", "scale"), ()),
        bgv.Ciphertext: (ref + "bgv:Ciphertext", ("c", "size", "level", "factor"), ()),
        mpc.RelinEphemeral: (ref + "mpc:RelinEphemeral", ("u_mont",), ()),
        mpc.ThresholdShare: (ref + "mpc:ThresholdShare",
                             ("index", "threshold", "s_ntt_mont_qp"), ()),
        tfhe.SecretKey: (ref + "tfhe:SecretKey", ("lwe", "rlwe"), ()),
        tfhe.Ciphertext: (ref + "tfhe:Ciphertext", ("a", "b", "variance"), ()),
    }


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
    return {path: cls for cls, (path, _, _) in wire_table().items()}


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
    `signed`; other tensors keep their dtype."""
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
    if isinstance(obj, torch.device):
        return {"t": "device"}
    cls = type(obj)
    if cls in wire_table():
        path, names, signed_fields = wire_table()[cls]
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


def _unflatten(desc, blobs, it, device):
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
        a = np.frombuffer(blobs[next(it)], dtype=np.dtype(desc["dtype"])).reshape(desc["shape"])
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        return torch.from_numpy(a.copy()).to(device)
    if t == "obj":
        cls = _port_class(desc["cls"])
        return cls(**{k: _unflatten(v, blobs, it, device) for k, v in desc["fields"].items()})
    raise ValueError(f"unknown entry {t!r}")


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
