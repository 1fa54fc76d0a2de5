"""The schemes the harness drives, one module a scheme, found by the
configuration's "scheme": fhebench/schemes/<scheme>.py.  Its Cell(config,
traffic, seed, devices, spans) sets up a cell from its configuration, traffic
and seed, issues its requests and judges its outputs; the operations its
requests are made of are fhebench/steps/<scheme>/<op>.py."""

import contextlib
import importlib
import re
import time

import numpy as np

NAME = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*$")


def load(scheme: str):
    """The module of scheme `scheme`."""
    if not NAME.match(scheme):
        raise ValueError(f"not a scheme's module name: {scheme!r}")
    return importlib.import_module(f"{__name__}.{scheme}")


def draws(seed: int, stream: int) -> np.random.Generator:
    """The benchmark's own draws from the seed (secrets, messages, the sample
    of outputs checked), one stream a use."""
    return np.random.default_rng([seed % (1 << 64), stream])


@contextlib.contextmanager
def timed(parts: dict, name: str, device):
    """Adds the seconds of the block, the device's work in it included, to
    parts[name]: the set-up's parts, which the run reports."""
    import torch
    t0 = time.perf_counter()
    yield
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    parts[name] = parts.get(name, 0.0) + time.perf_counter() - t0
