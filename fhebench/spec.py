"""Finding a cell's pieces by name: BENCHMARK.json at the root of the
checkout names the cells, configurations and metrics; each configuration is
the file BENCHMARK.json gives, each traffic mix fhebench/traffic/<mix>.json,
each cell's limits fhebench/limits/<cell>.json, each end-to-end metric
fhebench/end_to_end/<metric>.json and each per-layer metric a reader
fhebench/metrics/<metric>.py.  The configuration's "scheme" names its
generator, fhebench/schemes/<scheme>.py, and the traffic's operations are
fhebench/steps/<scheme>/<op>.py, each with its plain meaning in
fhebench/reference/steps/<scheme>/<op>.py.  A new cell, operation, scheme or
metric is new files and entries only."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# Top-level module names no process of the benchmark may hold: the JAX
# package this port was made from, and JAX itself.
FORBIDDEN = ("jax", "jaxlib", "flax", "heongpu_tpu")


def forbidden_modules(names) -> list:
    """The names whose top-level part (before the first dot) is forbidden,
    compared whole: heongpu_tpu_torch is not heongpu_tpu."""
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def _json(path: Path):
    with open(path) as f:
        return json.load(f)


class Bench:
    """BENCHMARK.json and the files it leads to."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.spec = _json(self.root / "BENCHMARK.json")

    def workload(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return _json(self.root / c["file"])
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return _json(self.root / "fhebench" / "traffic" / f"{name}.json")

    def limits(self, cell: str) -> dict:
        return _json(self.root / "fhebench" / "limits" / f"{cell}.json")

    @staticmethod
    def _applies(metric: dict, cell: str) -> bool:
        return cell in metric.get("workloads", [cell])

    def end_to_end(self, cell: str) -> list:
        """The cell's end-to-end metrics, each with its definition
        (fhebench/end_to_end/<name>.json) under "how"."""
        return [dict(m, how=_json(self.root / "fhebench" / "end_to_end" / f"{m['name']}.json"))
                for m in self.spec["end_to_end"] if self._applies(m, cell)]

    def per_layer(self, cell: str) -> list:
        """The cell's per-layer metrics: those that list it, and those that list
        no cells and move an end-to-end metric the cell reports (the
        benchmark's contract gives an entry without "workloads" to every cell
        that reports the metric it moves, cells added later too)."""
        e2e = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.spec["per_layer"]
                if cell in m.get("workloads", ()) or ("workloads" not in m and m["moves"] in e2e)]

    def reader(self, metric: str):
        """The module fhebench/metrics/<metric>.py, whose read(trace) gives the
        metric's value, or None where the trace holds nothing to read."""
        path = self.root / "fhebench" / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(f"fhebench_metric_{metric}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
