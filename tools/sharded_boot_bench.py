#!/usr/bin/env python3
"""The limb-sharded bootstrap (heongpu_tpu_torch/parallel/boot_sharded.py)
across the cards of one host, against the unsharded bootstrap on one card.

One process a card (NCCL, a ('dp', 'limb') mesh of dp = 1): chip_smoke.py's
depth-48 configuration at N=2^16 (BOOT_Q_BITS, BOOT_CTX, BOOT_CFG, BOOT_HW) with
keys made with limb_align = the number of ranks, so that every key splits,
from one seed on every rank (chip_smoke.boot_setup).  Each rank first runs the
unsharded regular_bootstrap on its card with the whole key set (wall ms, median
of `rounds`, and its peak memory_allocated), then places the set by
shard_pytree_limb_axis, frees the whole set and runs the sharded bootstrap on
the placed input: its shard held against the same rows of the unsharded
output, its error, the key bytes it holds against the set's, its resident and
peak memory_allocated, the bytes it receives in one bootstrap, its wall ms
(between a barrier and a synchronize, median of `rounds`) and a torch.profiler
trace of one bootstrap (device busy, the NCCL SendRecv kernels' time, the
leading kernels and host ops).  Rank 0 prints one JSON line with every rank's
numbers, the card's name and power limit.

    python3 tools/sharded_boot_bench.py [--ranks R] [--rounds 3]
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time

import torch
import torch.multiprocessing as mp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N = 1 << 16


def _card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0].strip()


def _profile(fn) -> dict:
    """torch.profiler over one call of fn: the device busy ms (the union of the
    card's events), the NCCL kernels' ms, the card's ms by kernel and the
    host's self ms by op, the leading few of each."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    busy, end, dev = 0.0, float("-inf"), {}
    evts = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    for e in sorted(evts, key=lambda e: e.time_range.start):
        if e.time_range.end > end:
            busy += e.time_range.end - max(e.time_range.start, end)
            end = e.time_range.end
        dev[e.name[:60]] = dev.get(e.name[:60], 0.0) + e.time_range.elapsed_us() / 1e3
    host = {a.key[:60]: a.self_cpu_time_total / 1e3 for a in prof.key_averages()}
    top = lambda d: dict(sorted(d.items(), key=lambda kv: -kv[1])[:8])
    return {"device_busy_ms": busy / 1e3 if evts else None,
            "nccl_ms": sum(v for k, v in dev.items() if "nccl" in k.lower()),
            "device_ms": top(dev), "host_self_ms": top(host)}


def _device():
    return torch.device("cuda", torch.cuda.current_device())


def _bytes(tree, local: bool) -> int:
    from heongpu_tpu_torch.utils.storage import map_tensors
    out = []
    map_tensors(tree, lambda t: out.append((t.to_local() if local else t).nbytes))
    return sum(out)


def _rank(rank: int, world: int, port: int, args, out_path: str):
    import torch.distributed as dist

    import chip_smoke as cs
    from heongpu_tpu_torch.models import ckks, ckks_boot
    from heongpu_tpu_torch.parallel import boot_sharded as bs
    from heongpu_tpu_torch.parallel import mesh as meshlib
    from heongpu_tpu_torch.parallel import multihost

    multihost.init_process(f"127.0.0.1:{port}", rank, world)
    dev = _device()
    try:
        ctx, sk, keys, ct, z, keygen_s = cs.boot_setup(N, cs.BOOT_Q_BITS, cs.BOOT_CTX,
                                                       cs.BOOT_CFG, cs.BOOT_HW, 23, dev,
                                                       limb_align=world)

        def timed(fn):
            fn()
            runs = []
            for _ in range(args.rounds):
                torch.cuda.synchronize()
                dist.barrier()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                runs.append((time.perf_counter() - t0) * 1e3)
            return sorted(runs)[len(runs) // 2], runs

        whole_bytes = {"keys": _bytes((keys.gk, keys.rk), False), "all": _bytes(keys, False)}
        torch.cuda.reset_peak_memory_stats(dev)
        want = ckks_boot.regular_bootstrap(ctx, ct, keys)
        whole = timed(lambda: ckks_boot.regular_bootstrap(ctx, ct, keys))
        whole_peak = torch.cuda.max_memory_allocated(dev)
        mesh = meshlib.make_mesh(world)
        skeys = meshlib.shard_pytree_limb_axis(keys, mesh)
        sct = ckks.Ciphertext(meshlib.shard_array_limb_axis(ct.c, mesh), ct.size, ct.level,
                              ct.scale)
        del keys
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        resident = torch.cuda.memory_allocated(dev)
        received = []
        post = dist.batch_isend_irecv

        def spy(ops):
            received.extend(op.tensor.nbytes for op in ops if op.op is dist.irecv)
            return post(ops)

        dist.batch_isend_irecv = spy
        torch.cuda.reset_peak_memory_stats(dev)
        got = bs.regular_bootstrap(ctx, sct, skeys)
        torch.cuda.synchronize()
        dist.batch_isend_irecv = post
        rows = want.c.shape[-2]
        m = rows // world if rows % world == 0 else rows
        lo = rank * m if rows % world == 0 else 0
        same = torch.equal(got.c.to_local(), want.c[:, lo:lo + m])
        err, _ = cs.boot_error(ctx, sk, want, z)
        sharded = timed(lambda: bs.regular_bootstrap(ctx, sct, skeys))
        rec = {"rank": rank, "identical": same, "max_abs_err_unsharded": err,
               "keygen_s": keygen_s, "received_bytes": sum(received),
               "key_bytes_local": _bytes((skeys.gk, skeys.rk), True),
               "key_bytes_whole": whole_bytes["keys"],
               "set_bytes_local": _bytes(skeys, True), "set_bytes_whole": whole_bytes["all"],
               "resident_bytes_sharded": resident,
               "peak_bytes_sharded": torch.cuda.max_memory_allocated(dev),
               "peak_bytes_unsharded": whole_peak,
               "sharded_ms": sharded[0], "sharded_runs_ms": sharded[1],
               "unsharded_ms": whole[0], "unsharded_runs_ms": whole[1]}
        dist.barrier()
        rec["sharded_profile"] = _profile(lambda: bs.regular_bootstrap(ctx, sct, skeys))
        torch.save(rec, f"{out_path}.{rank}")
        dist.barrier()
    finally:
        dist.destroy_process_group()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=None, help="cards (default: all of them)")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("sharded_boot_bench: no CUDA device")
    from heongpu_tpu_torch import kernels
    from heongpu_tpu_torch.kernels import build
    build.build()
    kernels.library()
    world = args.ranks or torch.cuda.device_count()
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    out_path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "heongpu_tpu_torch",
                            "_build", f"sharded_boot_{os.getpid()}")
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    mp.start_processes(_rank, args=(world, port, args, out_path), nprocs=world, join=True,
                       start_method="spawn")
    recs = []
    for r in range(world):
        recs.append(torch.load(f"{out_path}.{r}"))
        os.remove(f"{out_path}.{r}")
    print(json.dumps({"card": _card(), "ranks": world, "n": N, "per_rank": recs}))
    return 0 if all(r["identical"] for r in recs) else 1


if __name__ == "__main__":
    sys.exit(main())
