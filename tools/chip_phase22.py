#!/usr/bin/env python3
"""Phase 22 of chip_smoke.py alone on one card: build the kernels, run phase 14
(the bootstrapping variants, unsharded: N=256 card against CPU, then every run
at N=2^16, whose regular v2, NAND and less-key runs leave their generator
states, inputs and outputs for phase 22), then the sharded variants phase
(chip_smoke.boot_v2_sharded_phase: N=256 card against CPU, the misuses, and
those three runs at N=2^16 on a one-rank NCCL group held against phase 14's
outputs; chip_smoke.py itself runs regular v2 and NAND there), printing its
record.

    python3 tools/chip_phase22.py
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from heongpu_tpu_torch import kernels  # noqa: E402
from heongpu_tpu_torch.kernels import build  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_phase22: no CUDA device")
    card = cs.card_line()
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    build.build()
    kernels.library()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    dev = torch.device("cuda")
    errs = dict.fromkeys(kernels.launches, 0)
    t14 = time.perf_counter()
    _, v2_rec = cs.bootstrap_v2_phases(dev, card, errs)
    print(f"phase 14: {time.perf_counter() - t14:.1f} s", flush=True)
    t22 = time.perf_counter()
    launches, rec = cs.boot_v2_sharded_phase(dev, card, errs, v2_rec.pop("sharded_refs"), v2_rec,
                                             full=cs.V2_SHARDED_KEPT)
    print(rec, flush=True)
    print(f"phase 22: {time.perf_counter() - t22:.1f} s; launches {launches}; max errors {errs}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
