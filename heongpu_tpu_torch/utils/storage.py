"""Host/device residency management (port of heongpu_tpu/utils/storage.py):
the reference library's ExecutionOptions with its input and output storage
managers.

Torch tensors carry their placement, so the manager reduces to moving whole
trees of them (ciphertexts, keys, contexts) at once:

    opts = ExecutionOptions(storage="device")
    ct = to_storage(ct, opts)            # move before an op
    cold = to_host(galois_keys)          # park cold keys in host RAM

"Host" means CPU tensors here (the JAX package holds numpy arrays there);
"device" means the card unless the caller names another device, or a
parallel.mesh.Sharding, which places each tensor as a DTensor.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from ..models import ringkit

HOST = "host"
DEVICE = "device"


@dataclasses.dataclass(frozen=True)
class ExecutionOptions:
    """Where results should live and whether inputs keep their residency."""
    storage: str = DEVICE                 # HOST | DEVICE
    keep_initial_condition: bool = True   # restore inputs' residency after use
    device: Optional[Any] = None          # a torch device or a parallel.mesh.Sharding


def map_tensors(tree, fn):
    """`tree` with fn applied to each of its tensors: the fields of the port's
    dataclasses (ciphertexts, keys, BootKeys and their pieces, contexts), the
    keys of a GaloisKey, and the items of dicts, lists and tuples, walked in
    order."""
    walk = lambda t: map_tensors(t, fn)
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, ringkit.GaloisKey):
        return ringkit.GaloisKey(walk(tree.keys))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: walk(getattr(tree, f.name))
                                            for f in dataclasses.fields(tree) if f.init})
    if isinstance(tree, dict):
        return {k: walk(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(walk(v) for v in tree)
    return tree


def _tensors(tree) -> list:
    out = []
    map_tensors(tree, out.append)
    return out


def to_host(tree: Any) -> Any:
    """Every tensor of a tree moved to host RAM (CPU tensors)."""
    return map_tensors(tree, lambda x: x.cpu())


def to_device(tree: Any, device=None) -> Any:
    """Every tensor of a tree moved onto `device` (default the card), or
    placed by a parallel.mesh.Sharding (each tensor, the same on every rank,
    as a DTensor of that layout)."""
    if device is None:
        device = "cuda"
    if hasattr(device, "place"):
        return map_tensors(tree, device.place)
    return map_tensors(tree, lambda x: x.to(device))


def to_storage(tree: Any, opts: ExecutionOptions) -> Any:
    return to_host(tree) if opts.storage == HOST else to_device(tree, opts.device)


def storage_of(tree: Any) -> str:
    """HOST if every tensor of the tree is on the CPU, DEVICE otherwise."""
    return HOST if all(x.device.type == "cpu" for x in _tensors(tree)) else DEVICE


def run_with_storage(fn, inputs, opts: ExecutionOptions = ExecutionOptions()):
    """The input/output storage managers: move the inputs to the device, run,
    place the output as `opts` says.  The caller's inputs are never moved in
    place, so they keep their residency: the reference library's
    keep_initial_condition=True.  False (convert the inputs in place) is
    refused, as in the JAX package; drop the host copy after the call
    instead."""
    if not opts.keep_initial_condition:
        raise ValueError(
            "keep_initial_condition=False is not supported: inputs are never "
            "converted in place.  Drop your host copy after the call instead.")
    dev_inputs = [to_device(t, opts.device) for t in inputs]
    out = fn(*dev_inputs)
    return to_storage(out, opts)
