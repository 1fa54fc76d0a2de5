"""Hand-written CUDA kernels for Hopper, bound with ctypes.

The wrappers live beside their plain torch versions (ops/ntt.py:
`ntt_cuda`; ops/rns.py: `mac_keys_cuda`, `base_conv_cuda`, `div_round_cuda`
(K6, counted as `div_round` or, in its t-exact mode, `div_exact_t`);
utils/threefry.py: `uniform_rns_cuda` (K7);
ops/keyswitch_fused.py: `keyswitch2_fused_cuda`; ops/tfhe_kernel.py:
`blind_rotate_cuda`); this module
builds and loads the library (kernels/build.py) and keeps the launch counts:
each wrapper adds one to its entry of `launches` where it launches its kernel,
so a run can show that the main path went through the kernels.
"""

from __future__ import annotations

import torch

from . import build

launches = {"ntt_fwd": 0, "ntt_inv": 0, "mac_keys": 0, "base_conv": 0,
            "blind_rotate": 0, "blind_rotate2": 0, "keyswitch2_fused": 0, "div_round": 0,
            "div_exact_t": 0, "threefry_uniform": 0}

_lib = None


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def library():
    """The loaded kernel library, built from csrc/ at first use."""
    global _lib
    if _lib is None:
        path, _ = build.build()
        _lib = build.load(path)
    return _lib


def stream_of(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")
