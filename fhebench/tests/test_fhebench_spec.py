"""BENCHMARK.json and the files it names: every piece is found by name, the
contract's limits hold, nothing imports JAX or the JAX package, and the
result line has the contract's keys."""

import ast
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from fhebench import roofline, spec

from . import tiny

ROOT = spec.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = spec.Bench()


def test_every_piece_is_found_by_name():
    b = BENCH
    for w in b.spec["workloads"]:
        cfg = b.config(w["config"])
        traffic = b.traffic(w["traffic"])
        assert cfg["scheme"] == traffic["scheme"]
        assert b.limits(w["name"])["checks"]
        assert any(m["name"] == "setup_s" for m in b.end_to_end(w["name"]))
        assert len(b.end_to_end(w["name"])) >= 2
        layer = b.per_layer(w["name"])
        assert layer
        reported = {m["name"] for m in b.end_to_end(w["name"])}
        for m in layer:
            assert m["moves"] in reported
            assert callable(b.reader(m["name"]).read)
    for m in b.spec["end_to_end"]:
        for cell in m.get("workloads", ()):
            b.workload(cell)


def test_a_per_layer_metric_without_cells_goes_to_each_cell_reporting_what_it_moves():
    b = spec.Bench()
    b.spec = dict(b.spec, per_layer=b.spec["per_layer"] + [
        {"name": "any_share", "unit": "%", "better": "lower", "source": "device_trace",
         "layer": "device", "moves": "request_p95_ms"}])
    reporting = [w["name"] for w in b.spec["workloads"]
                 if "request_p95_ms" in {m["name"] for m in b.end_to_end(w["name"])}]
    assert reporting and len(reporting) < len(b.spec["workloads"])
    for w in b.spec["workloads"]:
        names = {m["name"] for m in b.per_layer(w["name"])}
        assert ("any_share" in names) == (w["name"] in reporting)


def test_contract_limits():
    s = BENCH.spec
    assert set(s) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert s["paths"] == ["fhebench"] and s["command"] == ["python3", "fhebench/run.py"]
    runs = 2 + 14 * 24
    assert runs * (s["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in s[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in s["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("fhebench/") and 0 < len(c["why"]) <= 200
        assert BENCH.config(c["name"])["reduced"] == c["reduced"]
    pairs = [(w["config"], w["traffic"]) for w in s["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in s["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and 0 < len(w["why"]) <= 200
    for m in s["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in s["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert UNIT.match(m["unit"]) and "\n" not in m["layer"]
    assert len(json.dumps(s)) < 64 * 1024


def test_forbidden_modules_compare_top_level_names_whole():
    names = ["heongpu_tpu_torch", "heongpu_tpu_torch.models.ckks", "jax.numpy", "jaxlib",
             "heongpu_tpu", "heongpu_tpu.ops.ntt", "flax", "jaxtyping", "heongpu_tpux", "numpy"]
    assert spec.forbidden_modules(names) == ["flax", "heongpu_tpu", "heongpu_tpu.ops.ntt",
                                             "jax.numpy", "jaxlib"]


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module)
    return out


@pytest.mark.parametrize("path", sorted((ROOT / "fhebench").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_file_imports_jax_or_the_jax_package(path):
    mods = _imports(path)
    assert not spec.forbidden_modules(mods)
    if "reference" in path.parts:
        assert not {m for m in mods if m.split(".")[0] in ("heongpu_tpu_torch", "fhebench")}


def test_roofline_reproduces_the_recorded_bounds():
    main = roofline.keyswitch_bound(**roofline.keyswitch_shapes(1 << 16, 12, 4, 4))
    deep = roofline.keyswitch_bound(**roofline.keyswitch_shapes(1 << 16, 48, 6, 4))
    k3 = roofline.blind_rotate_bound(8, 512, 1024)
    assert (round(main[0], 4), round(deep[0], 4), round(k3[0], 4)) == (0.0213, 0.2109, 0.0992)
    assert main[1] == deep[1] == k3[1] == "operations"


def test_result_line_has_the_contract_keys():
    result = tiny.run(tiny.TinyBench(), "std128.nand-b128")
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert result["correct"] and result["attempted"] >= 1
    assert set(result["metrics"]) == {"setup_s", "tfhe_gates_per_s", "request_p95_ms"}
    assert all(set(v) == {"value", "unit"} for v in result["metrics"].values())
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(result["device"])
    assert result["device"]["count"] == 1


def test_run_refuses_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for a machine without one")
    got = subprocess.run([sys.executable, "fhebench/run.py", "--workload", "d48.boot", "--seed",
                          "2147483700", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert got.returncode != 0 and got.stdout == ""
