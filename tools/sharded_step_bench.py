#!/usr/bin/env python3
"""The limb-sharded CKKS step (heongpu_tpu_torch/parallel/ckks_sharded.py)
across the cards of one host, against the unsharded step on one card.

One process a card (NCCL, a ('dp', 'limb') mesh of dp = 1): the main path's
context (N=2^16, twelve 29-bit Q primes) under Method II (alpha 4, four
special primes: 16 QP rows, 4 a rank at four ranks) or Method I (one special
prime), a relinearization key and a ciphertext pair of random residues made
from one seed on every rank, the key placed by shard_pytree_limb_axis and the
pair by ct_sharding.  Each rank runs multiply -> relinearize -> rescale ->
multiply -> relinearize and holds its shard of every result against the same
rows of the unsharded entry points run on its own card; then both steps are
timed (mult+relin+rescale; wall ms of `reps` calls between a barrier and a
synchronize, median of `rounds` rounds), with the bytes a rank receives in a
sharded step and its key bytes; a torch.profiler trace of `reps` steps of
each kind gives each rank's device busy ms and its leading kernels and host
ops.
Rank 0 prints one JSON line with every rank's numbers, the card's name and
power limit.

    python3 tools/sharded_step_bench.py [--ranks R] [--method I|II] [--reps 10] [--rounds 5]
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
Q_BITS = [29] * 12
ALPHA = 4


def _card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0].strip()


def _residues(primes, lead, gen):
    p = torch.tensor(primes, dtype=torch.int64).view(-1, 1)
    x = torch.randint(0, 1 << 62, lead + (len(primes), N), generator=gen, dtype=torch.int64)
    return torch.remainder(x, p).to(torch.int32)


def _profile(fn, reps: int) -> dict:
    """torch.profiler over `reps` calls of fn: the device busy ms a call (the
    union of the card's events), the card's ms a call by kernel and the host's
    self ms a call by op, the leading few of each."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    busy, end, dev = 0.0, float("-inf"), {}
    evts = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    for e in sorted(evts, key=lambda e: e.time_range.start):
        if e.time_range.end > end:
            busy += e.time_range.end - max(e.time_range.start, end)
            end = e.time_range.end
        dev[e.name[:60]] = dev.get(e.name[:60], 0.0) + e.time_range.elapsed_us() / 1e3 / reps
    host = {a.key[:60]: a.self_cpu_time_total / 1e3 / reps for a in prof.key_averages()}
    top = lambda d: dict(sorted(d.items(), key=lambda kv: -kv[1])[:8])
    return {"device_busy_ms": busy / 1e3 / reps if evts else None, "device_ms": top(dev),
            "host_self_ms": top(host)}


def _rank(rank: int, world: int, port: int, args, out_path: str):
    import torch.distributed as dist

    from heongpu_tpu_torch.models import ckks
    from heongpu_tpu_torch.parallel import ckks_sharded as cks
    from heongpu_tpu_torch.parallel import mesh as meshlib
    from heongpu_tpu_torch.parallel import multihost

    multihost.init_process(f"127.0.0.1:{port}", rank, world)
    dev = torch.device("cuda", torch.cuda.current_device())
    try:
        kw = dict(ks_type="II", alpha=ALPHA) if args.method == "II" else {}
        ctx = ckks.make_context(N, Q_BITS, device=dev, **kw)
        gen = torch.Generator().manual_seed(18)
        d = ctx.k if ctx.ks_type == "I" else -(-ctx.k // ctx.alpha)
        c1, c2 = (_residues(list(ctx.q_primes), (2,), gen).to(dev) for _ in range(2))
        k0, k1 = (_residues(list(ctx.qp_primes), (d,), gen).to(dev) for _ in range(2))
        rk = ckks.KSKey(k0, k1)
        mesh = meshlib.make_mesh(world)
        rks = meshlib.shard_pytree_limb_axis(rk, mesh)
        place = meshlib.ct_sharding(mesh).place
        sa = ckks.Ciphertext(place(c1), 2, 0, ctx.default_scale)
        sb = ckks.Ciphertext(place(c2), 2, 0, ctx.default_scale)
        ua = ckks.Ciphertext(c1, 2, 0, ctx.default_scale)
        ub = ckks.Ciphertext(c2, 2, 0, ctx.default_scale)

        def step(mod, a, b, key):
            out = {"mult0": mod.multiply(ctx, a, b)}
            out["relin0"] = mod.relinearize(ctx, out["mult0"], key)
            out["rescale"] = mod.rescale(ctx, out["relin0"])
            out["mult1"] = mod.multiply(ctx, out["rescale"], out["rescale"])
            out["relin1"] = mod.relinearize(ctx, out["mult1"], key)
            return out

        received = []
        post = dist.batch_isend_irecv

        def spy(ops):
            received.extend(op.tensor.nbytes for op in ops if op.op is dist.irecv)
            return post(ops)

        dist.batch_isend_irecv = spy
        got = step(cks, sa, sb, rks)
        torch.cuda.synchronize()
        dist.batch_isend_irecv = post
        want = step(ckks, ua, ub, rk)
        same = {}
        for op, ct in got.items():
            loc, full = ct.c.to_local(), want[op].c
            rows = full.shape[-2]
            m = rows // world if rows % world == 0 else rows
            lo = rank * m if rows % world == 0 else 0
            same[op] = torch.equal(loc, full[:, lo:lo + m])

        def timed(fn):
            fn()
            runs = []
            for _ in range(args.rounds):
                torch.cuda.synchronize()
                dist.barrier()
                t0 = time.perf_counter()
                for _ in range(args.reps):
                    fn()
                torch.cuda.synchronize()
                runs.append((time.perf_counter() - t0) * 1e3 / args.reps)
            return sorted(runs)[len(runs) // 2], runs

        sharded_fn = lambda: cks.rescale(ctx, cks.relinearize(ctx, cks.multiply(ctx, sa, sb), rks))
        sharded = timed(sharded_fn)
        whole_fn = lambda: ckks.rescale(ctx, ckks.relinearize(ctx, ckks.multiply(ctx, ua, ub), rk))
        whole = timed(whole_fn)
        rec = {"rank": rank, "identical": same, "received_bytes_step": sum(received),
               "sharded_profile": _profile(sharded_fn, args.reps),
               "unsharded_profile": _profile(whole_fn, args.reps),
               "key_bytes_local": rks.k0.to_local().nbytes + rks.k1.to_local().nbytes,
               "key_bytes_whole": k0.nbytes + k1.nbytes,
               "sharded_ms": sharded[0], "sharded_runs_ms": sharded[1],
               "unsharded_ms": whole[0], "unsharded_runs_ms": whole[1]}
        torch.save(rec, f"{out_path}.{rank}")
        dist.barrier()
    finally:
        dist.destroy_process_group()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=None, help="cards (default: all of them)")
    ap.add_argument("--method", choices=("I", "II"), default="II")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("sharded_step_bench: no CUDA device")
    world = args.ranks or torch.cuda.device_count()
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    out_path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "heongpu_tpu_torch",
                            "_build", f"sharded_step_{os.getpid()}")
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    mp.start_processes(_rank, args=(world, port, args, out_path), nprocs=world, join=True,
                       start_method="spawn")
    recs = []
    for r in range(world):
        recs.append(torch.load(f"{out_path}.{r}"))
        os.remove(f"{out_path}.{r}")
    print(json.dumps({"card": _card(), "ranks": world, "method": args.method, "n": N,
                      "q_primes": len(Q_BITS), "per_rank": recs}))
    ok = all(all(r["identical"].values()) for r in recs)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
