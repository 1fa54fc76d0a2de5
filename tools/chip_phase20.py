#!/usr/bin/env python3
"""Phase 20 of chip_smoke.py alone on one card: build the kernels, make the
main path's context (N=2^16, twelve 29-bit Q primes, Method II, alpha 4),
keys and ciphertext pair as phase 5 does, then run (a) the host utilities,
(b) the native parameter engine and (c) the limb-sharded CKKS step on a
one-rank NCCL group (chip_smoke.utilities_phase, native_phase,
ckks_sharded_phase), printing their records.

    python3 tools/chip_phase20.py
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from heongpu_tpu_torch import kernels  # noqa: E402
from heongpu_tpu_torch.kernels import build  # noqa: E402
from heongpu_tpu_torch.models import ckks  # noqa: E402
from heongpu_tpu_torch.utils import rng  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_phase20: no CUDA device")
    card = cs.card_line()
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    build.build()
    kernels.library()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(2024)
    errs = dict.fromkeys(kernels.launches, 0)
    ctx = ckks.make_context(cs.N, cs.Q_BITS, ks_type="II", alpha=cs.ALPHA, device=dev)
    g = rng.new_generator(1, dev)
    sk = ckks.keygen_secret(ctx, g)
    pk = ckks.keygen_public(ctx, g, sk)
    rk = ckks.keygen_relin(ctx, g, sk)
    z = np.linspace(-1.0, 1.0, cs.N // 2)
    ct1 = ckks.encrypt(ctx, pk, ckks.encode(ctx, z), g)
    ct2 = ckks.encrypt(ctx, pk, ckks.encode(ctx, z[::-1].copy()), g)
    torch.cuda.synchronize()
    t20 = time.perf_counter()
    print(cs.utilities_phase(card, ctx, rk, ct1, ct2), flush=True)
    print(cs.native_phase(card), flush=True)
    _, rec = cs.ckks_sharded_phase(dev, card, errs, gen, ctx, rk, ct1, ct2)
    print(rec, flush=True)
    print(f"phase 20: {time.perf_counter() - t20:.1f} s; max errors {errs}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
