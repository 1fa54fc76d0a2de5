#!/usr/bin/env python3
"""Where the stripped-key draws of the limb-sharded bootstrap spend their time,
across the cards of one host.

One process a card (NCCL, a ('dp', 'limb') mesh of dp = 1), chip_smoke.py's
depth-48 configuration at N=2^16 with its compressed key set (compress_keys=True,
limb_align = the number of ranks; tools/sharded_boot_bench.py's set-up).  Each
rank times `rounds` sharded bootstraps (between a barrier and a synchronize) in
each of three variants, in turn, twice:
  * tree: the code as it is (each use of a stripped key regenerates the rank's
    rows of its uniform half: ringkit.ensure_k1 with a row range, one K7 launch);
  * fresh_ring: the same with the key's ring built afresh at each use
    (ckks._ring_at without its per-level cache, as before it kept one);
  * no_draw: every draw served from a cache filled by one earlier run (no K7
    launch, no host work for the draws: the full-key run's work).
For each it records the wall ms of each run, the host ms spent inside the draws
a run, and the synchronizing CUDA calls of one run (torch.cuda's sync debug
mode, which counts the calls it can see).  Rank 0 prints one JSON line with
every rank's numbers, the card's name and power limit.

    python3 tools/stripped_draw_bench.py [--ranks R] [--rounds 3]
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import sys
import time
import warnings

import torch
import torch.multiprocessing as mp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

VARIANTS = ("tree", "fresh_ring", "no_draw")


def _rank(rank: int, world: int, port: int, rounds: int, out_path: str):
    import torch.distributed as dist

    import sharded_boot_bench as sbb
    from heongpu_tpu_torch.models import ckks, ringkit
    from heongpu_tpu_torch.parallel import mesh as meshlib
    from heongpu_tpu_torch.parallel import multihost

    multihost.init_process(f"127.0.0.1:{port}", rank, world)
    dev = sbb._device()
    try:
        ctx, _, keys, inputs, _, _, _, sharded_fn = sbb._setup("regular", dev, world, True)
        mesh = meshlib.make_mesh(world)
        skeys = meshlib.shard_pytree_limb_axis(keys, mesh)
        sin = [ckks.Ciphertext(meshlib.shard_array_limb_axis(c.c, mesh), c.size, c.level,
                               c.scale) for c in inputs]
        del keys
        torch.cuda.empty_cache()

        def run():
            return sharded_fn(ctx, *sin, skeys)

        ensure, ring_at = ringkit.ensure_k1, ckks._ring_at
        host, drawn = [0.0], {}

        def timed_draw(ring, kk, rows=None):
            t0 = time.perf_counter()
            out = ensure(ring, kk, rows)
            host[0] += time.perf_counter() - t0
            return out

        def cached_draw(ring, kk, rows=None):
            if kk.k1 is None:
                key = (id(kk.k0), rows)
                if key not in drawn:
                    drawn[key] = ensure(ring, kk, rows)
                return drawn[key]
            return ensure(ring, kk, rows)

        def fresh_ring(c, level):
            c._level_tables.pop(("ring", level), None)
            return ring_at(c, level)

        def use(variant):
            ringkit.ensure_k1 = cached_draw if variant == "no_draw" else timed_draw
            ckks._ring_at = fresh_ring if variant == "fresh_ring" else ring_at

        rec = {"rank": rank}
        for variant in VARIANTS * 2:
            use(variant)
            run()
            runs, host[0] = [], 0.0
            for _ in range(rounds):
                torch.cuda.synchronize()
                dist.barrier()
                t0 = time.perf_counter()
                run()
                torch.cuda.synchronize()
                runs.append((time.perf_counter() - t0) * 1e3)
            rec.setdefault(f"{variant}_runs_ms", []).extend(runs)
            rec.setdefault(f"{variant}_draw_host_ms", []).append(host[0] * 1e3 / rounds)
        for variant in VARIANTS:
            use(variant)
            torch.cuda.synchronize()
            dist.barrier()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode(1)
                run()
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode(0)
            rec[f"{variant}_syncs"] = sum("synchronizing" in str(w.message) for w in caught)
        ringkit.ensure_k1, ckks._ring_at = ensure, ring_at
        rec["draws_cached"] = len(drawn)
        torch.save(rec, f"{out_path}.{rank}")
        dist.barrier()
    finally:
        dist.destroy_process_group()


def main() -> int:
    import sharded_boot_bench as sbb
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=None, help="cards (default: all of them)")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("stripped_draw_bench: no CUDA device")
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
                            "_build", f"stripped_draw_{os.getpid()}")
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    mp.start_processes(_rank, args=(world, port, args.rounds, out_path), nprocs=world,
                       join=True, start_method="spawn")
    recs = []
    for r in range(world):
        recs.append(torch.load(f"{out_path}.{r}"))
        os.remove(f"{out_path}.{r}")
    print(json.dumps({"card": sbb._card(), "ranks": world, "n": sbb.N, "per_rank": recs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
