"""ctypes bridge to the native C++ parameter engine (port of
heongpu_tpu/utils/native.py; the source is the port's own copy,
heongpu_tpu_torch/native/paramgen.cpp).

The shared library is built at first use with the system g++ (`g++ -O2
-shared -fPIC`, as the JAX package builds it) into heongpu_tpu_torch/_build/
and rebuilt when the source is newer.  utils/nt.py and ops/ntt.py's
build_ntt_tables take it when `available()`, and their pure-Python path
otherwise; both give the same primes and tables.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "native", "paramgen.cpp")
_BUILD = os.path.join(_PKG, "_build")
_SO = os.path.join(_BUILD, "libparamgen.so")

_lock = threading.Lock()
_lib = None
_error = None     # why the library is not available, once a load has failed


def _build():
    """Compile the source into _SO (through a temporary file renamed into place,
    so processes that build at once never load a half-written library)."""
    os.makedirs(_BUILD, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
    os.close(fd)
    try:
        subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-o", tmp, _SRC],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, _SO)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load():
    global _lib, _error
    with _lock:
        if _lib is not None or _error is not None:
            return _lib
        try:
            if not (os.path.exists(_SO) and os.path.getmtime(_SO) >= os.path.getmtime(_SRC)):
                _build()
            lib = ctypes.CDLL(_SO)
        except (OSError, subprocess.SubprocessError) as e:
            detail = getattr(e, "stderr", None)
            _error = f"{type(e).__name__}: {e}" + (f"\n{detail.decode()}" if detail else "")
            return None
        u64, u32 = ctypes.c_uint64, ctypes.c_uint32
        p64 = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
        p32 = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
        lib.pg_is_prime.argtypes = [u64]
        lib.pg_is_prime.restype = ctypes.c_int
        lib.pg_generate_ntt_primes.argtypes = [u32, u32, u64, p64, u32, p64]
        lib.pg_generate_ntt_primes.restype = ctypes.c_int
        lib.pg_minimal_primitive_root_2n.argtypes = [u64, u64]
        lib.pg_minimal_primitive_root_2n.restype = u64
        lib.pg_pow_series.argtypes = [u64, u64, u64, p32]
        lib.pg_pow_series.restype = None
        lib.pg_shoup.argtypes = [p32, u64, u64, p32]
        lib.pg_shoup.restype = None
        lib.pg_psi_tables.argtypes = [u64, u64, u64, p32, p32, p32, p32]
        lib.pg_psi_tables.restype = None
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def unavailable_reason():
    """Why the engine could not be built or loaded (None while it is available)."""
    _load()
    return _error


def is_prime(n: int):
    lib = _load()
    if lib is None or n >= (1 << 63):
        return None
    return bool(lib.pg_is_prime(n))


def generate_ntt_primes(bit_size: int, count: int, n: int, exclude=None):
    lib = _load()
    if lib is None:
        return None
    ex = np.asarray(sorted(exclude) if exclude else [], np.uint64)
    out = np.zeros(count, np.uint64)
    got = lib.pg_generate_ntt_primes(bit_size, count, n, ex, len(ex), out)
    if got < count:
        raise ValueError(
            f"not enough {bit_size}-bit NTT primes for n={n} (found {got}/{count})")
    return [int(v) for v in out]


def minimal_primitive_root_2n(n2: int, p: int):
    lib = _load()
    if lib is None:
        return None
    return int(lib.pg_minimal_primitive_root_2n(n2, p))


def pow_series(base: int, n: int, p: int):
    lib = _load()
    if lib is None:
        return None
    out = np.empty(n, np.uint32)
    lib.pg_pow_series(base % p, n, p, out)
    return out


def psi_tables(psi: int, n: int, p: int):
    """(psi_pows, psi_sh, ipsi_n, ipsi_n_sh) uint32 arrays, or None."""
    lib = _load()
    if lib is None:
        return None
    a = np.empty(n, np.uint32)
    b = np.empty(n, np.uint32)
    c = np.empty(n, np.uint32)
    d = np.empty(n, np.uint32)
    lib.pg_psi_tables(psi, n, p, a, b, c, d)
    return a, b, c, d
