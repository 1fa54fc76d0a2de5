"""Test-only cells: the real cells' traffic, limits and controls on tiny
configurations the CPU runs in seconds (N=256 CKKS on the depth-48 chain's
bit sizes, TFHE with a 16-bit LWE key).  Never a benchmark cell."""

from __future__ import annotations

import time

from fhebench import harness, spec
from heongpu_tpu_torch.models import ckks

PREFIX = "tiny."


def ckks_config(base: dict) -> dict:
    """The depth-48 configuration at N=256, with that ring's primes."""
    n = 256
    ctx = ckks.make_context(n, base["q_bits"], scale_bits=base["scale_bits"],
                            ks_type=base["ks_type"], alpha=base["alpha"],
                            p_count=base["p_count"], device="cpu")
    return dict(base, n=n, q_primes=list(ctx.q_primes), p_primes=list(ctx.p_primes))


class TinyBench(spec.Bench):
    """BENCHMARK.json with a tiny twin "tiny.<cell>" of every cell: the same
    traffic, limits and metrics on a tiny configuration, and traffic
    overrides (a smaller pool) that keep the CPU's warm-up short."""

    TRAFFIC = {"pool": 1, "keep": 4}

    def __init__(self):
        super().__init__()
        cells = [dict(w, name=PREFIX + w["name"], config=PREFIX + w["config"])
                 for w in self.spec["workloads"]]
        self.spec = dict(self.spec, workloads=self.spec["workloads"] + cells)
        for m in self.spec["end_to_end"] + self.spec["per_layer"]:
            if "workloads" in m:
                m["workloads"] = m["workloads"] + [PREFIX + c for c in m["workloads"]]
        self._tiny = {}

    def config(self, name: str) -> dict:
        if not name.startswith(PREFIX):
            return super().config(name)
        if name not in self._tiny:
            base = super().config(name[len(PREFIX):])
            self._tiny[name] = (ckks_config(base) if base["scheme"] == "ckks"
                                else dict(base, lwe_n=16))
        return self._tiny[name]

    def traffic(self, name: str) -> dict:
        return dict(super().traffic(name), **self.TRAFFIC)

    def limits(self, cell: str) -> dict:
        return super().limits(cell.removeprefix(PREFIX))


def run(bench: TinyBench, cell: str, seed: int = 2 ** 31 + 7, seconds: float = 0.2,
        traced: bool = False, overrides: dict | None = None) -> dict:
    """One run of a tiny cell on the CPU: its result object."""
    result, _ = harness.run(bench, PREFIX + cell, seed, seconds, traced, "cpu",
                            time.perf_counter(), overrides)
    return result
