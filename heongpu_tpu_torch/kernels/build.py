"""Build the CUDA kernels in csrc/ into one shared library and load it.

`nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
-Xcompiler -fPIC` compiles every csrc/*.cu into
heongpu_tpu_torch/_build/libhf_kernels_<hash>.so, where <hash> covers the
sources and the flags, so a changed source builds anew at first use and an
unchanged one is loaded as it is.  The sources have a plain C interface and
are bound with ctypes (no PyTorch headers, so a build takes seconds).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures: every pointer and the stream as c_void_p, every size as c_int
SIGNATURES = {
    "hf_ntt": [_I, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P],
    "hf_mac_keys": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "hf_base_conv": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
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
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libhf_kernels_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, str]:
    """Compile the library if it is missing; returns (path, compiler log)."""
    path = library_path()
    if path.exists():
        return path, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, sources())]
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path, res.stdout + res.stderr


def load(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for name, args in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return lib
