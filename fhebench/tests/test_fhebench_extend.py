"""A new operation, traffic mix, cell, metric and scheme are new files and
entries only.  In a copy of the benchmark, files are added and entries are
appended to BENCHMARK.json; no file that was there changes, and the copy's
own harness runs the new cells (tiny twins on the CPU) correct."""

import hashlib
import json
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

from fhebench import spec

ROOT = spec.ROOT

NEW_FILES = {
    # an operation of the CKKS scheme the harness has not seen
    "fhebench/steps/ckks/square.py": '''
        """Square, relinearize, rescale: one keyswitch."""
        from heongpu_tpu_torch.models import ckks


        def keys(cell, step, g, sk):
            if "relin" not in cell.keys:
                cell.keys["relin"] = ckks.keygen_relin(cell.ctx, g, sk)


        def run(cell, step, x, prepared, i, warm):
            with cell.spans("square"):
                x = ckks.rescale(cell.ctx, ckks.relinearize(
                    cell.ctx, ckks.multiply(cell.ctx, x, x), cell.keys["relin"]))
            return x, [()], {"squarings": 1}


        def limbs_out(cell, step, limbs):
            return limbs - 1
        ''',
    "fhebench/reference/steps/ckks/square.py": '''
        def slots(z, args, plain):
            return z * z
        ''',
    "fhebench/traffic/square.json": {
        "scheme": "ckks", "why": "a square, then a rotate-add", "pool": 1,
        "slots": "unit_circle", "keep": 4, "trace_requests": 2,
        "program": [{"op": "square"}, {"op": "rotate_add", "steps": [1]}]},
    "fhebench/limits/d48.square.json": {
        "checks": {"slot_err_max": {"limit": 1.3e-3}, "violations": {"limit": 0}}},
    "fhebench/end_to_end/squares_per_s.json": {"kind": "rate", "work": "squarings"},
    "fhebench/metrics/host_ms.square.py": '''
        def read(t):
            return t.host_ms_per("squarings", "square")
        ''',
    # another gate at another batch: data alone
    "fhebench/traffic/and-b4.json": {
        "scheme": "tfhe", "why": "one AND over 4 bit pairs", "pool": 1, "op": "gate",
        "gate": "AND", "batch": 4, "keep": 4, "trace_requests": 2},
    "fhebench/limits/std128.and-b4.json": {
        "checks": {"wrong_bits": {"limit": 0}, "violations": {"limit": 0},
                   "phase_rms": {"limit": 0.012}}},
    # a scheme the harness has not seen
    "fhebench/schemes/echo.py": '''
        """Adds one to a row of integers drawn from the seed."""
        import torch

        from . import draws


        class Cell:
            def __init__(self, config, traffic, seed, devices, spans):
                self.spans = spans
                rows = draws(seed, 2).integers(0, 100, (traffic["pool"], config["width"]))
                self.rows = torch.from_numpy(rows).to(devices[0])

            def warm_requests(self):
                return [0]

            def trace_meta(self):
                return {}

            def request(self, i, warm=False):
                with self.spans("echo"):
                    out = self.rows[i % len(self.rows)] + 1
                return out, {"pool": i % len(self.rows), "work": {"echoes": 1}}

            def release(self):
                pass

            def judge(self, kept, limits):
                wrong = sum(int((out != self.rows[rec["pool"]] + 1).any()) for out, rec in kept)
                return {"wrong": wrong}, wrong
        ''',
    "fhebench/configs/echo.json": {"scheme": "echo", "reduced": [], "width": 8},
    "fhebench/traffic/echo.json": {"scheme": "echo", "why": "one row a request", "pool": 2,
                                   "keep": 4, "trace_requests": 2},
    "fhebench/limits/echo.add.json": {"checks": {"wrong": {"limit": 0}}},
    "fhebench/end_to_end/echoes_per_s.json": {"kind": "rate", "work": "echoes"},
}

ENTRIES = {
    "configs": [{"name": "echo", "source": "a test", "file": "fhebench/configs/echo.json",
                 "reduced": [], "why": "a test"}],
    "workloads": [
        {"name": "d48.square", "config": "ckks-n16-d48", "traffic": "square", "chips": 1,
         "why": "a test"},
        {"name": "std128.and-b4", "config": "tfhe-std128", "traffic": "and-b4", "chips": 1,
         "why": "a test"},
        {"name": "echo.add", "config": "echo", "traffic": "echo", "chips": 1, "why": "a test"}],
    "end_to_end": [
        {"name": "squares_per_s", "unit": "ops/s", "better": "higher", "bound": 0.05,
         "source": "host_clock", "workloads": ["d48.square"]},
        {"name": "echoes_per_s", "unit": "ops/s", "better": "higher", "bound": 0.05,
         "source": "host_clock", "workloads": ["echo.add"]}],
    "per_layer": [
        {"name": "host_ms.square", "unit": "ms", "better": "lower", "source": "program_span",
         "layer": "host dispatch", "moves": "squares_per_s", "workloads": ["d48.square"]}],
}

DRIVE = '''
import json, sys, time
import fhebench
from fhebench import harness, spec
from fhebench.tests import tiny
bench = tiny.TinyBench()
out = {"package": fhebench.__file__}
for cell in ("d48.square", "std128.and-b4"):
    out[cell] = tiny.run(bench, cell)
    out[cell + ".per_layer"] = [m["name"] for m in bench.per_layer(tiny.PREFIX + cell)]
    out[cell + ".readers"] = [callable(bench.reader(m).read) for m in out[cell + ".per_layer"]]
out["echo.add"] = harness.run(spec.Bench(), "echo.add", 2 ** 31 + 5, 0.2, False, "cpu",
                              time.perf_counter())[0]
print(json.dumps(out, default=str))
'''


def _digests(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file() and "__pycache__" not in p.parts}


def test_new_cells_are_new_files_and_entries_only(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "fhebench", root / "fhebench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    before = _digests(root)
    for rel, body in NEW_FILES.items():
        path = root / rel
        assert not path.exists(), rel
        path.write_text(json.dumps(body) if isinstance(body, dict)
                        else textwrap.dedent(body).lstrip())
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for key, entries in ENTRIES.items():
        bench[key] += entries
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    after = _digests(root)
    assert {k for k in before if before[k] != after[k]} == {"BENCHMARK.json"}

    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(root), str(ROOT)]))
    got = subprocess.run([sys.executable, "-c", DRIVE], cwd=root, env=env, capture_output=True,
                         text=True, timeout=600)
    assert got.returncode == 0, got.stderr[-4000:]
    out = json.loads(got.stdout.strip().splitlines()[-1])
    assert Path(out["package"]).resolve().is_relative_to(root.resolve())
    square, gate, echo = out["d48.square"], out["std128.and-b4"], out["echo.add"]
    for result in (square, gate, echo):
        assert result["correct"] and result["failed"] == 0 and result["attempted"] >= 1, result
    assert set(square["metrics"]) == {"setup_s", "squares_per_s"}
    assert out["d48.square.per_layer"] == ["host_ms.square"] and all(out["d48.square.readers"])
    assert set(gate["metrics"]) == {"setup_s"}
    assert set(echo["metrics"]) == {"setup_s", "echoes_per_s"}
