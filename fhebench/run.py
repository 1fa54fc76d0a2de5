"""Run one cell of the benchmark once, on the card, and print its result.

    python3 fhebench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is one JSON object (correct, attempted,
failed, metrics, device, with --trace 1 breakdown, and last the numbers
compared with their limits); the last lines of standard error name each
compared number beside its limit.  It exits non-zero and prints no result
where there is no card (or fewer than the cell asks for), and where the
process holds JAX or the JAX package once the window has closed.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # kernel caches at fixed places inside the checkout (the port builds its
    # own library into heongpu_tpu_torch/_build/, keyed by its sources)
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(ROOT / ".fhebench_cache" / sub)
    sys.path.insert(0, str(ROOT))
    t0 = time.perf_counter()
    import torch

    from fhebench import harness, spec
    t1 = time.perf_counter()
    bench = spec.Bench(ROOT)
    chips = bench.workload(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"fhebench: the cell needs {chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    parts = {"start": t0 - T_PROCESS, "torch": t1 - t0, "driver": time.perf_counter() - t1}
    result, lines = harness.run(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                                torch.device("cuda", 0), T_PROCESS, parts=parts)
    bad = spec.forbidden_modules(list(sys.modules))
    if bad:
        print(f"fhebench: the process holds forbidden modules: {bad}", file=sys.stderr)
        return 3
    print(json.dumps(result))
    sys.stdout.flush()
    print("\n".join(lines), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
