"""Device memory observability (port of heongpu_tpu/utils/memory.py): the
reference library's MemoryPool status API (print_memory_pool_status,
get_current_device_pool_memory_usage, get_free_device_pool_memory).

PyTorch's caching allocator plays the pool's role; its knobs are
environment variables (PYTORCH_CUDA_ALLOC_CONF), not runtime calls, so this
module gives the observing half with live statistics.  On a device without
allocator statistics (the CPU) every field and getter is None.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class MemoryPoolStatus:
    device: str
    bytes_in_use: Optional[int]
    peak_bytes_in_use: Optional[int]
    bytes_limit: Optional[int]
    num_allocs: Optional[int]

    @property
    def free_bytes(self) -> Optional[int]:
        if self.bytes_limit is None or self.bytes_in_use is None:
            return None
        return self.bytes_limit - self.bytes_in_use

    def __str__(self):
        gb = lambda b: f"{b / 2**30:.3f} GiB" if b is not None else "n/a"
        return (f"[{self.device}] in_use={gb(self.bytes_in_use)} "
                f"peak={gb(self.peak_bytes_in_use)} "
                f"limit={gb(self.bytes_limit)} free={gb(self.free_bytes)}")


def device_pool_status(device=None) -> MemoryPoolStatus:
    """Live allocator statistics of one device (default: the current card;
    all None where there is none).  bytes_in_use, peak_bytes_in_use and
    num_allocs are torch.cuda.memory_stats' allocated_bytes.all.current,
    allocated_bytes.all.peak and allocation.all.current: the tensors the
    caching allocator has handed out.  bytes_limit is the card's total
    memory, the second value of torch.cuda.mem_get_info."""
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device()) \
            if torch.cuda.is_available() else torch.device("cpu")
    device = torch.device(device)
    if device.type != "cuda":
        return MemoryPoolStatus(str(device), None, None, None, None)
    s = torch.cuda.memory_stats(device)
    return MemoryPoolStatus(
        device=str(device),
        bytes_in_use=s.get("allocated_bytes.all.current", 0),
        peak_bytes_in_use=s.get("allocated_bytes.all.peak", 0),
        bytes_limit=torch.cuda.mem_get_info(device)[1],
        num_allocs=s.get("allocation.all.current", 0),
    )


def print_memory_pool_status():
    """The status of every CUDA device (of the CPU where there is none)."""
    devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    for d in devices or [torch.device("cpu")]:
        print(device_pool_status(d))


def get_free_device_pool_memory(device=None) -> Optional[int]:
    return device_pool_status(device).free_bytes


def get_current_device_pool_memory_usage(device=None) -> Optional[int]:
    return device_pool_status(device).bytes_in_use
