#!/usr/bin/env python3
"""Phase 21 of chip_smoke.py alone on one card: build the kernels, run phase 13
(c)'s unsharded depth-48 bootstrap at N=2^16 (its keys and input from seed 23,
its peak memory_allocated over one bootstrap), free its keys, then run the
limb-sharded bootstrap phase (chip_smoke.boot_sharded_phase: N=256 card against
CPU, the misuses, and the sharded depth-48 bootstrap on a one-rank NCCL group
held against that output), printing its record.

    python3 tools/chip_phase21.py
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from heongpu_tpu_torch import kernels  # noqa: E402
from heongpu_tpu_torch.kernels import build  # noqa: E402
from heongpu_tpu_torch.models import ckks_boot  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_phase21: no CUDA device")
    card = cs.card_line()
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    build.build()
    kernels.library()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    dev = torch.device("cuda")
    errs = dict.fromkeys(kernels.launches, 0)
    t13 = time.perf_counter()
    ctx, _, keys, ct, _, _ = cs.boot_setup(cs.N, cs.BOOT_Q_BITS, cs.BOOT_CTX, cs.BOOT_CFG,
                                           cs.BOOT_HW, 23, dev)
    ckks_boot.regular_bootstrap(ctx, ct, keys)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    out = ckks_boot.regular_bootstrap(ctx, ct, keys)
    torch.cuda.synchronize()
    boot_rec = {f"n{cs.N}": {"peak_bytes": torch.cuda.max_memory_allocated(dev)}}
    boot_c = out.c
    del ctx, keys, ct, out
    torch.cuda.empty_cache()
    print(f"phase 13 (c)'s unsharded bootstrap: {time.perf_counter() - t13:.1f} s", flush=True)
    t21 = time.perf_counter()
    launches, rec = cs.boot_sharded_phase(dev, card, errs, boot_c, boot_rec)
    print(rec, flush=True)
    print(f"phase 21: {time.perf_counter() - t21:.1f} s; launches {launches}; max errors {errs}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
