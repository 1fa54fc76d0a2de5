"""Spans around the benchmark's calls into the port, and the reduction of a
torch.profiler trace of a slice of requests to what the per-layer readers
(fhebench/metrics/) read.

Outside the profiled slice a span only adds its host time (the Python that
issues the call, with no synchronization) to its name's total.  Inside it,
each span is a record_function range "fhe.<name>", and a span opened with
marked=True launches a spin kernel (torch.cuda._sleep, which the port never
launches) before and after its call: the device runs one stream in order, so
every kernel between the two markers is the call's, whether the port
launched it through PyTorch or through its own library.
"""

from __future__ import annotations

import contextlib
import re
import time
from collections import Counter, defaultdict

MARKER = "spin_kernel"
# The port's hand-written kernels (the anonymous namespaces of
# heongpu_tpu_torch/kernels/csrc/*.cu) as the profiler names them.
OWN_KERNEL = re.compile(r"\(anonymous namespace\)::((?:ntt_(?:fwd|inv)[12]|mac_keys_kernel|"
                        r"base_conv_kernel|div_round_(?:column_|tile_)?kernel|"
                        r"keyswitch2_fused_kernel|blind_rotate_kernel|threefry_uniform_kernel|"
                        r"threefry_bits_kernel)(?:<[^>]*>)?)\(")
NAME_CHARS = 160     # a device op's name in the breakdown is cut to this many characters


def kind(name: str) -> str:
    """"own" for the port's hand-written kernels, "marker" for the spans'
    markers, "plain" for PyTorch's kernels (at::), "other" for the rest
    (copies, fills)."""
    if MARKER in name:
        return "marker"
    if OWN_KERNEL.search(name):
        return "own"
    return "plain" if "at::" in name else "other"


class Spans:
    """Host spans of one run: totals of host seconds and calls by name over
    the unprofiled requests; in the profiled slice, ranges and markers."""

    def __init__(self):
        self.host_s = defaultdict(float)
        self.calls = Counter()
        self.profiling = False
        self.marked = []          # (name, meta) of each marked span in the slice

    @contextlib.contextmanager
    def __call__(self, name: str, marked: bool = False, **meta):
        if not self.profiling:
            t0 = time.perf_counter()
            yield
            self.host_s[name] += time.perf_counter() - t0
            self.calls[name] += 1
            return
        import torch
        from torch.profiler import record_function
        with record_function("fhe." + name):
            if marked:
                torch.cuda._sleep(1)
            yield
            if marked:
                torch.cuda._sleep(1)
                self.marked.append((name, meta))


def _union(intervals):
    """Merged, sorted (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Trace:
    """What the readers read: the window's host spans, work and calls, and
    the profiled slice's device events (us), host spans (us), its wall
    seconds and the marked spans' device time."""

    def __init__(self, spans: Spans, work: dict, meta: dict, events=None, slice_wall_s=None,
                 marked=()):
        self.host_s, self.calls, self.work, self.meta = spans.host_s, spans.calls, work, meta
        self.slice_wall_s = slice_wall_s
        self.device, self.host, self.slice_calls = [], [], Counter()
        for name, dev, s, e in events or ():
            if dev:
                self.device.append((s, e, name))
            elif name.startswith("fhe."):
                self.host.append((s, e, name[4:]))
                self.slice_calls[name[4:]] += 1
        self.device.sort()
        self.marked = self._marked(list(marked))

    def _marked(self, marked):
        """[(name, meta, device ms)] of the marked spans, or [] where the
        markers do not pair up with them (events lost)."""
        out, inside, acc = [], False, 0.0
        for s, e, name in self.device:
            if kind(name) == "marker":
                if inside:
                    out.append(acc / 1e3)
                inside, acc = not inside, 0.0
            elif inside:
                acc += e - s
        if inside or len(out) != len(marked):
            return []
        return [(n, m, ms) for (n, m), ms in zip(marked, out)]

    # -- the slice --------------------------------------------------------
    def has_device(self) -> bool:
        return bool(self.device) and bool(self.slice_wall_s)

    def busy_s(self) -> float:
        return sum(e - s for s, e in _union((s, e) for s, e, n in self.device
                                            if kind(n) != "marker")) / 1e6

    def idle_share_pct(self):
        if not self.has_device():
            return None
        return 100.0 * (1.0 - self.busy_s() / self.slice_wall_s)

    def device_ms(self, *kinds) -> float:
        """Summed device ms of the slice's events of these kinds (all but the
        markers where none is named)."""
        kinds = kinds or ("own", "plain", "other")
        return sum(e - s for s, e, n in self.device if kind(n) in kinds) / 1e3

    def per_call(self, value, call: str):
        """value per call of `call` in the slice; None where there is none or
        nothing was traced."""
        n = self.slice_calls.get(call, 0)
        return value / n if n and self.has_device() else None

    # -- the window -------------------------------------------------------
    def host_ms_per(self, per: str, *names) -> float | None:
        """Host ms inside the spans `names` over the window, per unit of
        `per`: a work count or, where the work has none, calls of that span."""
        count = self.work.get(per, self.calls.get(per, 0))
        if not count:
            return None
        return 1e3 * sum(self.host_s.get(n, 0.0) for n in names) / count

    # -- the breakdown ----------------------------------------------------
    def breakdown(self) -> dict:
        """The ten device ops that took most time, and idle time on the device
        summed by the span open on the host while it waited (innermost first;
        "harness" outside every span)."""
        ops = defaultdict(float)
        for s, e, n in self.device:
            if kind(n) != "marker":
                ops[n[:NAME_CHARS]] += (e - s) / 1e6
        gaps = defaultdict(float)
        busy = _union((s, e) for s, e, n in self.device if kind(n) != "marker")
        for (_, a), (b, _) in zip(busy, busy[1:]):
            mid = (a + b) / 2
            open_ = [h for h in self.host if h[0] <= mid <= h[1]]
            label = max(open_)[2] if open_ else "harness"
            gaps[label] += (b - a) / 1e6
        top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
        return {"device_ops": top(ops), "idle_gaps": top(gaps)}


def profile_events(prof):
    """(name, on the device, start us, end us) of a torch.profiler run."""
    from torch.autograd import DeviceType
    out = []
    for e in prof.events():
        if getattr(e, "is_user_annotation", False) and not e.name.startswith("fhe."):
            continue
        dev = e.device_type == DeviceType.CUDA
        if dev and getattr(e, "is_user_annotation", False):
            continue
        out.append((e.name, dev, e.time_range.start, e.time_range.end))
    return out


def own_launches(events) -> int:
    """The port's hand-written kernels among the device events."""
    return sum(1 for n, dev, _, _ in events if dev and kind(n) == "own")
