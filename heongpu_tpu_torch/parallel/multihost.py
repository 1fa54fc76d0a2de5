"""Multi-process layer (port of heongpu_tpu/parallel/multihost.py): process
initialization, global meshes, and the cross-process collective of MPC share
aggregation, on torch.distributed.

One process is one rank and drives one device: a card with the NCCL backend
(the default, device="cuda"), or the CPU with gloo (device="cpu", as the
tests run it).  Nothing falls back: a "cuda" process group on a host with no
card fails where torch does.  The serializer path (utils/serializer.py)
remains the byte-exact share exchange over files or sockets.
"""

from __future__ import annotations

import socket
import time
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..ops import modmath as mm

_U32 = 0xFFFFFFFF


def _backend(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_process(coordinator: str, process_id: int, num_processes: int,
                 local_device_count: Optional[int] = None, device="cuda") -> None:
    """Join the process group of `num_processes` ranks whose rendezvous is
    tcp://<coordinator> (host:port), as rank `process_id`; idempotent.  On the
    card the rank drives card process_id mod local_device_count (default: the
    cards this host has)."""
    if dist.is_initialized():
        return
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(process_id % (local_device_count or torch.cuda.device_count()))
    dist.init_process_group(_backend(device), init_method=f"tcp://{coordinator}",
                            rank=process_id, world_size=num_processes)


def _ranks_per_host() -> int:
    """The ranks on the host of rank 0."""
    hosts = [None] * dist.get_world_size()
    dist.all_gather_object(hosts, socket.gethostname())
    return hosts.count(hosts[0])


def global_mesh(limb_shards: Optional[int] = None, device="cuda") -> DeviceMesh:
    """('dp', 'limb') mesh over all ranks, laid out so the limb axis stays
    within a host where possible (limb traffic stays on the host's links;
    the dp axis spans hosts and only crosses them at batch boundaries).
    limb_shards defaults to the ranks of one host and halves until it
    divides the world."""
    n = dist.get_world_size()
    if limb_shards is None:
        limb_shards = _ranks_per_host()
    while n % limb_shards:
        limb_shards //= 2
    return DeviceMesh(torch.device(device).type, torch.arange(n).view(n // limb_shards,
                                                                       limb_shards),
                      mesh_dim_names=("dp", "limb"))


def party_mesh(device="cuda") -> DeviceMesh:
    """One mesh axis across all ranks, 'party', for N-out-of-N share
    aggregation (each party's share on its own rank; the sum is one
    all-reduce)."""
    return DeviceMesh(torch.device(device).type, torch.arange(dist.get_world_size()),
                      mesh_dim_names=("party",))


def allreduce_shares(local_share: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """Σ over the 'party' axis of every rank's share.  The raw sum, taken mod
    2^32 on int32 residue words as the reference's uint32 psum wraps (the
    caller reduces mod its primes afterwards): the words are summed as
    unsigned in int64 and the sum masked to 32 bits.  Other dtypes are summed
    as they are."""
    group = mesh.get_group("party")
    if local_share.dtype != mm.I32:
        out = local_share.clone()
        dist.all_reduce(out, group=group)
        return out
    acc = mm.as_u32(local_share)
    dist.all_reduce(acc, group=group)
    acc &= _U32
    return (acc - ((acc >> 31) << 32)).to(mm.I32)     # the same 32 bits as int32


def weak_scaling_efficiency(op, make_args, sizes: Sequence[int], mesh_builder=None,
                            reps: int = 3, device="cuda") -> dict:
    """Weak-scaling efficiency of `op` over growing meshes: make_args(n, mesh)
    scales the work with n, so efficiency_n = t_1 / t_n.  Times on the card
    wait for it (torch.cuda.synchronize).  Returns {n: (seconds, efficiency)}."""
    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" else (lambda: None)

    def timed(args):
        t0 = time.perf_counter()
        op(*args)
        sync()
        return time.perf_counter() - t0

    out = {}
    t1 = None
    for n in sizes:
        mesh = mesh_builder(n) if mesh_builder else None
        args = make_args(n, mesh)
        timed(args)
        best = min(timed(args) for _ in range(reps))
        if t1 is None:
            t1 = best
        out[n] = (best, t1 / best)
    return out
