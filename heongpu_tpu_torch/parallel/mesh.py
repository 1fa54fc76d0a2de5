"""Device-mesh layer (port of heongpu_tpu/parallel/mesh.py) on
torch.distributed.

The reference is single-GPU; this layer is the scale-out story of the JAX
package, which lays its devices out as a ('dp', 'limb') mesh:

  * ``limb``  — RNS limbs: NTTs and pointwise ops are independent per limb;
    base conversions and keyswitch MACs contract over the limb axis.
  * ``dp``    — a batch of ciphertexts, embarrassingly parallel.

One rank of a torch.distributed process group is one device here (a card
with NCCL, or a CPU process with gloo).  The JAX package annotates
NamedShardings and lets GSPMD place the collectives; torch has no GSPMD, so
the port places tensors as DTensors (`Sharding.place`) and its sharded
operators (ntt_sharded.py, keyswitch_sharded.py) run on their local shards
with the collectives written out.  A rank's local shard of a tensor placed
here equals the JAX array's shard on the device of the same mesh position.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

from ..utils.storage import map_tensors


def make_mesh(n_devices: Optional[int] = None, limb_shards: Optional[int] = None,
              device="cuda") -> DeviceMesh:
    """Mesh with axes ('dp', 'limb') over ranks 0 .. n_devices-1 of the
    process group (multihost.init_process); n_devices defaults to the world
    size and limb_shards to n_devices.  Every rank of the group calls it."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call parallel.multihost.init_process first")
    n = n_devices or dist.get_world_size()
    if limb_shards is None:
        limb_shards = n
    dp = n // limb_shards
    assert dp * limb_shards == n, "n_devices must factor into dp*limb"
    return DeviceMesh(torch.device(device).type, torch.arange(n).view(dp, limb_shards),
                      mesh_dim_names=("dp", "limb"))


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A mesh and one placement per mesh axis (a NamedSharding's counterpart)."""
    mesh: DeviceMesh
    placements: tuple

    def place(self, x: torch.Tensor):
        """x, the same full tensor on every rank, as a DTensor of this layout."""
        return distribute_tensor(x, self.mesh, list(self.placements))


def _sharding(mesh: DeviceMesh, dims: dict) -> Sharding:
    """Shard tensor dim dims[name] over mesh axis `name`, replicate the rest."""
    return Sharding(mesh, tuple(Shard(dims[a]) if a in dims else Replicate()
                                for a in mesh.mesh_dim_names))


def ct_sharding(mesh: DeviceMesh, batched: bool = False) -> Sharding:
    """Ciphertext (size, L, N): shard the limb axis; batched (B, size, L, N)
    also shards the batch over 'dp'."""
    return _sharding(mesh, {"dp": 0, "limb": 2} if batched else {"limb": 1})


def key_sharding(mesh: DeviceMesh) -> Sharding:
    """Keyswitch keys (d, L, N): shard the output-limb axis; the digit axis d
    stays local so the MAC contraction reduces over it without resharding."""
    return _sharding(mesh, {"limb": 1})


def replicated(mesh: DeviceMesh) -> Sharding:
    return _sharding(mesh, {})


def shard_array_limb_axis(x, mesh: DeviceMesh, limb_axis: int = -2):
    """Place one tensor: shard limb_axis if its length divides the mesh's
    'limb' size, else replicate.  A bootstrap chain moves through levels whose
    limb counts do not all divide the mesh (the last level has 1 limb); those
    stay replicated rather than failing placement.  Anything but a tensor is
    returned as it is."""
    if not isinstance(x, torch.Tensor):
        return x
    nl = mesh.size(mesh.mesh_dim_names.index("limb"))
    if x.ndim >= 2 and x.shape[limb_axis] % nl == 0:
        return _sharding(mesh, {"limb": limb_axis % x.ndim}).place(x)
    return replicated(mesh).place(x)


def shard_pytree_limb_axis(tree, mesh: DeviceMesh, limb_axis: int = -2):
    """shard_array_limb_axis on every tensor of `tree` (map_tensors)."""
    return map_tensors(tree, lambda x: shard_array_limb_axis(x, mesh, limb_axis))
