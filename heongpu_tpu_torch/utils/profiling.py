"""Profiling helpers (port of heongpu_tpu/utils/profiling.py).  The reference
library times with cudaEvents; here: torch.profiler traces (Chrome trace
files, viewable in Perfetto), a device-synchronized wall timer, and CUDA
allocator snapshots.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(logdir: str):
    """Trace the block with torch.profiler (CPU and, where there is a card,
    CUDA activities) and write trace_<pid>_<n>.json into `logdir`:
    with profiling.trace("traces"): run()."""
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(logdir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
        _sync()
    n = len([f for f in os.listdir(logdir) if f.startswith(f"trace_{os.getpid()}_")])
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}_{n}.json"))


def time_op(fn, *args, iters: int = 10, warmup: int = 1) -> float:
    """Mean seconds per call of fn(*args), the device synchronized before
    each reading of the clock (where there is a card)."""
    for _ in range(max(warmup, 1)):
        fn(*args)
    _sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    _sync()
    return (time.perf_counter() - t0) / iters


def device_memory_profile(path: str):
    """Write a snapshot of the CUDA caching allocator (its segments and the
    blocks in use) to `path`, a pickle that PyTorch's memory_viz reads.  With
    no card it raises RuntimeError and writes nothing."""
    if not torch.cuda.is_available():
        raise RuntimeError("device_memory_profile needs a CUDA device: torch.cuda is not available")
    torch.cuda.memory._dump_snapshot(path)
