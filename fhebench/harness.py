"""One run of one cell: set-up from the seed, warm-up of every shape the
cell's traffic uses, the measured window (a closed loop: one client, one
request in flight), with --trace 1 a profiled slice of requests after it,
the check of a seeded sample of the window's outputs against the plain
reference, and the result line.

End-to-end metrics are defined by data (fhebench/end_to_end/<name>.json):
  {"kind": "setup"}                         seconds from process start to the
                                            first timed request
  {"kind": "rate", "work": W}               W completed over the window's seconds
  {"kind": "ms_per", "work": W}             window ms over W completed
  {"kind": "latency_percentile", "q": Q}    the Q-th percentile of all request
                                            latencies, ms
"""

from __future__ import annotations

import gc
import subprocess
import time
from collections import Counter

import numpy as np
import torch

from . import schemes
from . import trace as tr
from .schemes import draws

TRACE_TRIES = 3
# kernels one count of the port's launch counter stands for (a K1 transform
# is its two pass kernels)
KERNELS_PER_COUNT = {"ntt_fwd": 2, "ntt_inv": 2}


def _sync(devices):
    for device in devices:
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)


def _merge(base: dict, over: dict) -> dict:
    """base with over's entries, dicts merged key by key."""
    out = dict(base)
    for k, v in over.items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


class Sample:
    """A uniform sample of at most k of the window's outputs, drawn from the
    seed (reservoir sampling), so the window keeps few outputs alive."""

    def __init__(self, k: int, draw: np.random.Generator):
        self.k, self.draw, self.items = k, draw, []

    def offer(self, i: int, item):
        if len(self.items) < self.k:
            self.items.append(item)
        elif (j := int(self.draw.integers(0, i + 1))) < self.k:
            self.items[j] = item


def end_to_end(how: dict, win: dict) -> float:
    kind = how["kind"]
    if kind == "setup":
        return win["setup_s"]
    if kind == "rate":
        return win["work"][how["work"]] / win["window_s"]
    if kind == "ms_per":
        return 1e3 * win["window_s"] / win["work"][how["work"]]
    if kind == "latency_percentile":
        return float(np.percentile(np.asarray(win["latencies_s"]) * 1e3, how["q"]))
    raise ValueError(f"unknown end-to-end metric kind {kind!r}")


def device_info(devices, cell) -> dict:
    """The devices the run used: their kind, how many, the peak on the fullest
    (a cell whose work runs outside this process reports its own peak, as
    cell.memory_peak_bytes()) and the first one's power limit."""
    device = devices[0]
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": len(devices), "memory_peak_bytes": 0}
    peak = (cell.memory_peak_bytes() if hasattr(cell, "memory_peak_bytes")
            else max(torch.cuda.max_memory_allocated(d) for d in devices))
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": len(devices),
            "memory_peak_bytes": int(peak)}
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits",
                              "-i", str(torch.device(device).index or 0)],
                             capture_output=True, text=True, timeout=30)
        info["power_limit_w"] = float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        info["power_limit_w"] = None
    return info


def _window(cell, spans, seconds: float, devices, sample: Sample, start: int) -> dict:
    lat, work, i = [], Counter(), start
    t_start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        with spans("request"):
            out, rec = cell.request(i)
        _sync(devices)
        t1 = time.perf_counter()
        lat.append(t1 - t0)
        work.update(rec["work"])
        sample.offer(i - start, (out, rec))
        i += 1
        if t1 - t_start >= seconds:
            return {"latencies_s": lat, "work": work, "window_s": t1 - t_start, "requests": i - start}


def _traced_slice(cell, spans, count: int, start: int, devices):
    """(events, wall s, marked spans) of `count` requests under torch.profiler,
    traced again (up to TRACE_TRIES times) while the trace holds fewer of the
    port's kernels than its launch counter made."""
    from torch.profiler import ProfilerActivity, profile
    from heongpu_tpu_torch import kernels
    best = None
    for _ in range(TRACE_TRIES):
        spans.marked = []
        before = dict(kernels.launches)
        spans.profiling = True
        try:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for j in range(count):
                    with spans("request"):
                        cell.request(start + j)
                    _sync(devices)
                wall = time.perf_counter() - t0
        finally:
            spans.profiling = False
        events = tr.profile_events(prof)
        made = sum(KERNELS_PER_COUNT.get(k, 1) * (v - before.get(k, 0))
                   for k, v in kernels.launches.items())
        got = (events, wall, list(spans.marked))
        if best is None or tr.own_launches(events) > tr.own_launches(best[0]):
            best = got
        if tr.own_launches(events) >= made and any(dev for _, dev, _, _ in events):
            return got
    return best


def _by_fifth(latencies: list) -> list:
    """Requests a second in each fifth of the window: whether a run's pace
    drifts within it or holds from start to end."""
    ends = np.cumsum(latencies)
    edges = np.linspace(0.0, ends[-1], 6)
    counts = np.histogram(ends, edges)[0]
    return [round(float(c / (edges[1] - edges[0])), 2) for c in counts]


def _card(devices) -> dict:
    """Seconds to reach each card (its context) and to load the port's kernel
    library (built from its sources at a checkout's first run): set-up
    the cell's first call would otherwise pay unseen."""
    parts = {}
    if torch.device(devices[0]).type != "cuda":
        return parts
    t0 = time.perf_counter()
    for d in devices:
        torch.zeros(1, device=d)
    _sync(devices)
    parts["card"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    from heongpu_tpu_torch import kernels
    kernels.library()
    parts["library"] = time.perf_counter() - t0
    return parts


def run(bench, cell_name: str, seed: int, seconds: float, traced: bool, device,
        t_process: float, overrides: dict | None = None,
        parts: dict | None = None) -> tuple[dict, list]:
    """(the result object, the lines naming each compared number and its
    limit).  device: the first of the cell's devices, which follow it in
    order.  overrides: {"config": {...}, "traffic": {...}} merged into the
    cell's files (the controls of fhebench/readings.py).  parts: seconds of
    set-up spent before the call, by name (the rest since t_process is
    "other")."""
    overrides = overrides or {}
    parts = dict(parts or {})
    parts["other"] = time.perf_counter() - t_process - sum(parts.values())
    w = bench.workload(cell_name)
    device = torch.device(device)
    devices = ([torch.device("cuda", (device.index or 0) + k) for k in range(w["chips"])]
               if device.type == "cuda" else [device])
    config = _merge(bench.config(w["config"]), overrides.get("config", {}))
    traffic = _merge(bench.traffic(w["traffic"]), overrides.get("traffic", {}))
    limits = {k: v["limit"] for k, v in bench.limits(cell_name)["checks"].items()}
    spans = tr.Spans()
    parts |= _card(devices)
    cell = schemes.load(config["scheme"]).Cell(config, traffic, seed, devices, spans)
    parts |= getattr(cell, "setup_parts", {})
    t0 = time.perf_counter()
    for i in cell.warm_requests():
        cell.request(i, warm=True)
        _sync(devices)
    parts["warm-up"] = time.perf_counter() - t0
    spans.host_s.clear()
    spans.calls.clear()
    setup_s = time.perf_counter() - t_process
    sample = Sample(traffic["keep"], draws(seed, 4))
    win = _window(cell, spans, seconds, devices, sample, len(cell.warm_requests()))
    win["setup_s"] = setup_s
    result = {"correct": False, "attempted": win["requests"], "failed": 0, "metrics": {}}
    if traced:
        events, wall, marked = _traced_slice(cell, spans, traffic["trace_requests"],
                                             len(cell.warm_requests()) + win["requests"], devices)
        t = tr.Trace(spans, dict(win["work"]), cell.trace_meta(), events, wall, marked)
        for m in bench.per_layer(cell_name):
            value = bench.reader(m["name"]).read(t)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
        result["breakdown"] = t.breakdown()
    else:
        for m in bench.end_to_end(cell_name):
            result["metrics"][m["name"]] = {"value": end_to_end(m["how"], win), "unit": m["unit"]}
    _sync(devices)
    result["device"] = device_info(devices, cell)
    if traced:
        result["device"]["busy_s"] = t.busy_s()
        result["device"]["window_s"] = t.slice_wall_s
    cell.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_judge = time.perf_counter()
    numbers, wrong = cell.judge(sample.items, limits)
    times = (f"fhebench: set-up {setup_s:.3f} s ("
             + ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
             + f"), window {win['window_s']:.3f} s ({win['requests']} requests; by fifth of it, "
             f"requests a second {_by_fifth(win['latencies_s'])}), reference "
             f"check of {len(sample.items)} outputs {time.perf_counter() - t_judge:.3f} s")
    result["failed"] = wrong
    result["correct"] = all(numbers.get(k, np.inf) <= lim for k, lim in limits.items())
    result["checks"] = {k: {"value": numbers.get(k), "limit": limits[k]} for k in limits}
    lines = [times] + [f"check {k}: {numbers.get(k)!r} (limit {lim!r})" for k, lim in limits.items()]
    return result, lines
