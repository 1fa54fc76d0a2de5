#!/usr/bin/env python3
"""The limb-sharded depth-48 bootstrap on the compressed key set, on one card:
build the kernels, make phase 13 (c)'s context, secret key and input (seed
23, its full key set made and freed first so that the input is drawn as
phase 13 draws it) and phase 13 (c')'s compressed set (compress_keys=True
from seed 24: every Galois and relin key stripped to k0 and its a_seed), run
the unsharded regular_bootstrap on it, then the sharded one
(parallel/boot_sharded.py) on a one-rank NCCL group with the set placed by
shard_pytree_limb_axis, launches counted from 0 and held against plain.  The
sharded residues, level and scale must equal the unsharded output's, K7 must
launch once a stripped-key use (as chip_smoke.stripped_key_uses predicts),
K5 never and K6 once a ÷P site, and the error stay within
chip_smoke.TOL_BOOT_PRECISE.  Then the device busy ms, wall ms and idle
share of one sharded and one unsharded bootstrap, and K7's device ms in each
(torch.profiler).  Prints a record, the card's name and power limit.

    python3 tools/chip_phase23.py
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from heongpu_tpu_torch import kernels  # noqa: E402
from heongpu_tpu_torch.kernels import build  # noqa: E402


def main() -> int:
    import torch.distributed as dist
    from heongpu_tpu_torch.models import ckks, ckks_boot
    from heongpu_tpu_torch.parallel import boot_sharded as bs
    from heongpu_tpu_torch.parallel import mesh as meshlib
    from heongpu_tpu_torch.utils import rng
    if not torch.cuda.is_available():
        raise SystemExit("chip_phase23: no CUDA device")
    card = cs.card_line()
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    build.build()
    kernels.library()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    dev = torch.device("cuda")
    errs = dict.fromkeys(kernels.launches, 0)
    t0 = time.perf_counter()
    ctx, sk, full, ct, z, _ = cs.boot_setup(cs.N, cs.BOOT_Q_BITS, cs.BOOT_CTX, cs.BOOT_CFG,
                                            cs.BOOT_HW, 23, dev)
    del full
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    keys = ckks_boot.generate_bootstrap_keys(ctx, rng.new_generator(24, dev), sk,
                                             ckks_boot.BootConfig(**cs.BOOT_CFG),
                                             compress_keys=True)
    torch.cuda.synchronize()
    keygen_s = time.perf_counter() - t1
    predicted = cs.stripped_key_uses(keys)
    with cs.stripped_key_draws() as uses_u:
        kernels.reset_launches()
        want = ckks_boot.regular_bootstrap(ctx, ct, keys)
        torch.cuda.synchronize()
        launches_u = dict(kernels.launches)
    print(f"phase 13 (c') again: context, keys and input in {time.perf_counter() - t0:.1f} s "
          f"(compressed keygen {keygen_s:.1f} s); unsharded bootstrap launches {launches_u}, "
          f"{uses_u[0]} stripped-key uses (predicted {predicted})", flush=True)
    mesh = cs.one_rank_group()
    try:
        skeys = meshlib.shard_pytree_limb_axis(keys, mesh)
        sct = ckks.Ciphertext(meshlib.shard_array_limb_axis(ct.c, mesh), ct.size, ct.level,
                              ct.scale)
        what = f"sharded compressed bootstrap N={cs.N} one-rank NCCL group"
        with cs.stripped_key_draws() as uses:
            kernels.reset_launches()
            t1 = time.perf_counter()
            with cs.held_against_plain(what, errs), cs.div_round_sites(what) as sites:
                out = bs.regular_bootstrap(ctx, sct, skeys)
                torch.cuda.synchronize()
                launches = dict(kernels.launches)
            held_s = time.perf_counter() - t1
        local = out.c.to_local()
        same = (torch.equal(local, want.c)
                and (out.level, out.scale) == (want.level, want.scale))
        err, p99 = cs.boot_error(ctx, sk, ckks.Ciphertext(local, out.size, out.level, out.scale),
                                 z)
        k7 = launches["threefry_uniform"]
        print(f"{what}: residues, level and scale identical to the unsharded output on the "
              f"same keys: {same}; max error {err:.3e} (limit {cs.TOL_BOOT_PRECISE}), p99 "
              f"{p99:.3e}; K7 launched {k7} times for {uses[0]} stripped-key uses (predicted "
              f"{predicted}); launches {launches}; ÷P sites {dict(sites)}; held against plain "
              f"{held_s:.1f} s [{card}]", flush=True)
        ok = (same and err < cs.TOL_BOOT_PRECISE and k7 == uses[0] == predicted
              and not launches["keyswitch2_fused"])
        timed = {}
        for label, fn in (("sharded", lambda: bs.regular_bootstrap(ctx, sct, skeys)),
                          ("unsharded", lambda: ckks_boot.regular_bootstrap(ctx, ct, keys))):
            torch.cuda.reset_peak_memory_stats(dev)
            busy, wall, idle, per_kernel = cs.device_idle_share(fn, 1)
            timed[label] = {"busy_ms": busy, "wall_ms": wall, "idle_share": idle,
                            "kernel_ms": cs.own_kernels(per_kernel),
                            "peak_bytes": torch.cuda.max_memory_allocated(dev)}
            print(f"time {label} compressed bootstrap: busy {cs.fmt_ms(busy)} ms, wall "
                  f"{wall:.3f} ms, idle share {cs.fmt_ms(idle)}; hand-written kernels, device "
                  f"ms {timed[label]['kernel_ms']} [{card}]", flush=True)
    finally:
        dist.destroy_process_group()
    print(json.dumps({"identical": same, "max_abs_err": err, "p99_abs_err": p99,
                      "launches": launches, "unsharded_launches": launches_u,
                      "stripped_key_uses": uses[0], "predicted_uses": predicted,
                      "keygen_s": keygen_s, "held_s": held_s, "timed": timed,
                      "max_errors": errs}))
    print(card)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
