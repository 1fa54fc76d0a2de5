"""Readings of a cell's compared numbers over many seeds in one process, for
setting its limits: the program as the configuration states it, or with one
of the cell's controls (fhebench/limits/<cell>.json, "controls") switched on.

    python3 fhebench/readings.py --workload <cell> --seeds 11,12,13 --seconds 5 [--control NAME]

Each seed is a whole run of the cell (set-up, warm-up, a window of
--seconds at the cell's load, the check) without its result line; one JSON
line a seed goes to standard output.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from fhebench import harness, spec
    if not torch.cuda.is_available():
        print("fhebench: readings are taken on the card", file=sys.stderr)
        return 2
    bench = spec.Bench(ROOT)
    overrides = (bench.limits(args.workload)["controls"][args.control] if args.control else {})
    for seed in (int(s) for s in args.seeds.split(",")):
        result, _ = harness.run(bench, args.workload, seed, args.seconds, False,
                                torch.device("cuda", 0), time.perf_counter(), overrides)
        print(json.dumps({"workload": args.workload, "control": args.control, "seed": seed,
                          "correct": result["correct"], "attempted": result["attempted"],
                          "checks": {k: v["value"] for k, v in result["checks"].items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
