#!/usr/bin/env python3
"""The limb-sharded bootstrap (heongpu_tpu_torch/parallel/boot_sharded.py) and
its variants (parallel/boot_ext_sharded.py) across the cards of one host,
against the unsharded bootstrap on one card.

One process a card (NCCL, a ('dp', 'limb') mesh of dp = 1), keys made with
limb_align = the number of ranks, from one seed on every rank.  --variant
regular (the default): chip_smoke.py's depth-48 configuration at N=2^16
(BOOT_Q_BITS, BOOT_CTX, BOOT_CFG, BOOT_HW; chip_smoke.boot_setup) and
regular_bootstrap; regular_v2 and nand: phase 14's v2 chain at N=2^16
(V2_Q_BITS, V2_CTX, V2_CFG, V2_HW; chip_smoke.v2_runs' inputs) and
regular_bootstrap_v2 or the NAND gate_bootstrap.  Each rank first runs the
unsharded entry point on its card with the whole key set (wall ms, median of
`rounds`, and its peak memory_allocated), then places the set by
shard_pytree_limb_axis, frees the whole set and runs the sharded entry point
on the placed inputs: its shard held against the same rows of the unsharded
output, the unsharded output's error, the key bytes it holds against the
set's, its resident and peak memory_allocated, the bytes it receives in one
run, its wall ms (between a barrier and a synchronize, median of `rounds`)
and a torch.profiler trace of one run (device busy, the NCCL SendRecv
kernels' time, K7's time, the leading kernels and host ops).  --compress
makes the set with compress_keys=True (every Galois and relin key stripped
to k0 and its a_seed): each rank regenerates its own rows of a key's
uniform half at each use (K7 over a row range), and the record adds K7's
launches in one sharded and one unsharded run, K7's device ms in an
unsharded run's trace, and the bytes the same keys take whole (k1 as large
as k0).  Rank 0 prints one JSON line with every rank's numbers, the card's
name and power limit.

    python3 tools/sharded_boot_bench.py [--ranks R] [--rounds 3]
                                        [--variant regular|regular_v2|nand] [--compress]
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
            "threefry_ms": sum(v for k, v in dev.items() if "threefry_uniform" in k),
            "device_ms": top(dev), "host_self_ms": top(host)}


def _device():
    return torch.device("cuda", torch.cuda.current_device())


def _bytes(tree, local: bool) -> int:
    from heongpu_tpu_torch.utils.storage import map_tensors
    out = []
    map_tensors(tree, lambda t: out.append((t.to_local() if local else t).nbytes))
    return sum(out)


VARIANTS = {"regular_v2": "regular", "nand": "NAND"}   # --variant -> chip_smoke.v2_runs' run


def _whole_key_bytes(keys) -> int:
    """The bytes of a set's Galois and relin keys with both halves stored (a
    stripped key's k1 takes its k0's bytes)."""
    ks = list(keys.gk.keys.values()) + [keys.rk]
    return sum(2 * k.k0.nbytes for k in ks)


def _setup(variant: str, dev, world: int, compress: bool = False):
    """(ctx, secret key, key set with limb_align=world (compressed when
    `compress`), inputs, expected slots, keygen s, unsharded fn, sharded fn);
    fn(ctx, *inputs, keys) is the entry point."""
    import chip_smoke as cs
    from heongpu_tpu_torch.models import ckks, ckks_boot
    from heongpu_tpu_torch.models import ckks_boot_ext as ext
    from heongpu_tpu_torch.parallel import boot_ext_sharded as bes
    from heongpu_tpu_torch.parallel import boot_sharded as bs
    from heongpu_tpu_torch.utils import rng
    if variant == "regular":
        ctx, sk, keys, ct, z, keygen_s = cs.boot_setup(N, cs.BOOT_Q_BITS, cs.BOOT_CTX,
                                                       cs.BOOT_CFG, cs.BOOT_HW, 23, dev,
                                                       limb_align=world, compress=compress)
        return (ctx, sk, keys, (ct,), z, keygen_s, ckks_boot.regular_bootstrap,
                bs.regular_bootstrap)
    ctx = ckks.make_context(N, cs.V2_Q_BITS, device=dev, **cs.V2_CTX)
    gen = rng.new_generator(41, dev)
    sk = ckks.keygen_secret(ctx, gen, hamming_weight=cs.V2_HW)
    pk = ckks.keygen_public(ctx, gen, sk)
    skd = ckks.keygen_secret(ctx, gen)
    name = VARIANTS[variant]
    kw, fn, inputs, want, _ = cs.v2_runs(ctx, sk, pk, gen, N, skd,
                                         ckks.keygen_public(ctx, gen, skd))[name]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    keys = ext.generate_bootstrap_keys_v2(ctx, gen, sk, ext.BootConfigV2(**cs.V2_CFG),
                                          limb_align=world, compress_keys=compress, **kw)
    torch.cuda.synchronize()
    return (ctx, sk, keys, inputs, want, time.perf_counter() - t0, fn,
            cs.v2_entry(name, bes))


def _rank(rank: int, world: int, port: int, args, out_path: str):
    import torch.distributed as dist

    import chip_smoke as cs
    from heongpu_tpu_torch import kernels
    from heongpu_tpu_torch.models import ckks
    from heongpu_tpu_torch.parallel import mesh as meshlib
    from heongpu_tpu_torch.parallel import multihost

    multihost.init_process(f"127.0.0.1:{port}", rank, world)
    dev = _device()
    try:
        ctx, sk, keys, inputs, z, keygen_s, unsharded, sharded_fn = _setup(
            args.variant, dev, world, args.compress)

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

        whole_bytes = {"keys": _bytes((keys.gk, keys.rk), False), "all": _bytes(keys, False),
                       "keys_both_halves": _whole_key_bytes(keys)}
        torch.cuda.reset_peak_memory_stats(dev)
        kernels.reset_launches()
        want = unsharded(ctx, *inputs, keys)
        torch.cuda.synchronize()
        k7_unsharded = kernels.launches["threefry_uniform"]
        whole = timed(lambda: unsharded(ctx, *inputs, keys))
        whole_peak = torch.cuda.max_memory_allocated(dev)
        unsharded_profile = (_profile(lambda: unsharded(ctx, *inputs, keys))
                             if args.compress else None)
        mesh = meshlib.make_mesh(world)
        skeys = meshlib.shard_pytree_limb_axis(keys, mesh)
        sin = [ckks.Ciphertext(meshlib.shard_array_limb_axis(ct.c, mesh), ct.size, ct.level,
                               ct.scale) for ct in inputs]
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
        kernels.reset_launches()
        got = sharded_fn(ctx, *sin, skeys)
        torch.cuda.synchronize()
        k7_sharded = kernels.launches["threefry_uniform"]
        dist.batch_isend_irecv = post
        rows = want.c.shape[-2]
        m = rows // world if rows % world == 0 else rows
        lo = rank * m if rows % world == 0 else 0
        same = (torch.equal(got.c.to_local(), want.c[:, lo:lo + m])
                and (got.level, got.scale) == (want.level, want.scale))
        err, _ = cs.boot_error(ctx, sk, want, z)
        sharded = timed(lambda: sharded_fn(ctx, *sin, skeys))
        rec = {"rank": rank, "identical": same, "max_abs_err_unsharded": err,
               "keygen_s": keygen_s, "received_bytes": sum(received),
               "key_bytes_local": _bytes((skeys.gk, skeys.rk), True),
               "key_bytes_whole": whole_bytes["keys"],
               "key_bytes_both_halves": whole_bytes["keys_both_halves"],
               "compressed": args.compress, "k7_launches_sharded": k7_sharded,
               "k7_launches_unsharded": k7_unsharded, "unsharded_profile": unsharded_profile,
               "set_bytes_local": _bytes(skeys, True), "set_bytes_whole": whole_bytes["all"],
               "resident_bytes_sharded": resident,
               "peak_bytes_sharded": torch.cuda.max_memory_allocated(dev),
               "peak_bytes_unsharded": whole_peak,
               "sharded_ms": sharded[0], "sharded_runs_ms": sharded[1],
               "unsharded_ms": whole[0], "unsharded_runs_ms": whole[1]}
        dist.barrier()
        rec["sharded_profile"] = _profile(lambda: sharded_fn(ctx, *sin, skeys))
        torch.save(rec, f"{out_path}.{rank}")
        dist.barrier()
    finally:
        dist.destroy_process_group()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=None, help="cards (default: all of them)")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--variant", choices=("regular", *VARIANTS), default="regular")
    ap.add_argument("--compress", action="store_true",
                    help="the compressed key set (compress_keys=True)")
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
    print(json.dumps({"card": _card(), "ranks": world, "n": N, "variant": args.variant,
                      "compress": args.compress, "per_rank": recs}))
    return 0 if all(r["identical"] for r in recs) else 1


if __name__ == "__main__":
    sys.exit(main())
