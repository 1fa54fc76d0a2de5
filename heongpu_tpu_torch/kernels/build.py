"""Build the CUDA kernels in csrc/ into one shared library and load it.

Every csrc/*.cu is compiled by its own `nvcc -gencode
arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC -c`, all started
together, and the objects are linked by `nvcc -shared` into
heongpu_tpu_torch/_build/libhf_kernels_<hash>.so, where <hash> covers the
sources, the shared headers (csrc/*.cuh) and the flags, so a changed source
builds anew at first use and an unchanged one is loaded as it is.  The
sources share csrc/ntt_common.cuh (every source) and csrc/ntt_cols.cuh, the
register-resident column transform of the NTT K1 (ntt.cu) and the fused
keyswitch K5 (keyswitch.cu); mac.cu holds K2, divround.cu K6 (both of its
modes) and threefry.cu K7.  They have
a plain C interface and are bound with ctypes (no PyTorch headers, so a build
takes seconds).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
LINK_FLAGS = ARCH_FLAGS + ["-shared"]
NVCC_TIMEOUT = 600

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
# C signatures: every pointer and the stream as c_void_p, every size as c_int, every
# uint32 constant as c_uint
SIGNATURES = {
    "hf_ntt": [_I, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P],
    "hf_mac_keys": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "hf_base_conv": [_P] * 7 + [_I] * 5 + [_P],
    "hf_div_round": [_P, _P, _P, _I, _I, _I, _I, _P],
    "hf_div_exact_t": [_P, _P, _P, _I, _I, _I, _I, _P],
    "hf_threefry_uniform": [_P, _P, _U, _U, _U, _U, _I, _I, _I, _I, _I, _P],
    "hf_blind_rotate": [_I, _P, _P, _P, _P, _I, _I] + [_P] * 17 + [_U, _U, _P],
    "hf_keyswitch2_fused": [_P] * 7 + [_I] * 6 + [_P] * 15 + [_P],
}


def sources():
    return sorted(CSRC.glob("*.cu"))


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "are built from heongpu_tpu_torch/kernels/csrc at first use")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    for src in sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libhf_kernels_{h.hexdigest()[:16]}.so"


def _run(cmd) -> str:
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=NVCC_TIMEOUT)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}) on {cmd[-1]}:\n{res.stderr}")
    return res.stdout + res.stderr


def build() -> tuple[Path, str]:
    """Compile the library if it is missing; returns (path, compiler log)."""
    path = library_path()
    if path.exists():
        return path, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    srcs = sources()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, src.stem + ".o") for src in srcs]
        with ThreadPoolExecutor(len(srcs)) as pool:
            log = list(pool.map(lambda src, obj: _run([nvcc(), *COMPILE_FLAGS, "-c", "-o", obj,
                                                       str(src)]), srcs, objs))
        so = os.path.join(tmp, "lib.so")
        log.append(_run([nvcc(), *LINK_FLAGS, "-o", so, *objs]))
        os.replace(so, path)
    return path, "".join(log)


def load(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for name, args in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return lib
