"""Port of tests/test_native.py: the port's native C++ parameter engine
(heongpu_tpu_torch/utils/native.py, its own copy of paramgen.cpp) against
its pure-Python path and against the JAX package's engine and number theory,
bit for bit.  Skips where the engine cannot be built (no g++), as the JAX
package's test does.

The JAX package builds its engine in place (`g++ -o` straight onto the
library's path) the first time a process asks for it, and latches a failed
load for the rest of the process.  Several pytest-xdist workers collect its
tests/test_native.py at once, so one of them can open a half-written library
and see no engine.  Where the port's engine loads and the reference's does
not, `reference_engine` waits for the library to stop changing, clears the
latch and loads again, a few times, and fails with the reason if it still
cannot."""

import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from heongpu_tpu.ops import ntt as jntt  # noqa: E402
from heongpu_tpu.utils import native as jnative  # noqa: E402
from heongpu_tpu.utils import nt as jnt  # noqa: E402
from heongpu_tpu_torch import interop  # noqa: E402
from heongpu_tpu_torch.ops import ntt as nttm  # noqa: E402
from heongpu_tpu_torch.utils import native, nt  # noqa: E402


@pytest.fixture(autouse=True)
def engine():
    if not native.available():
        pytest.skip(f"no native engine (no C++ toolchain?): {native.unavailable_reason()}")


REFERENCE_LOAD_TRIES = 20
SETTLE_SECONDS = 0.5


def _so_state():
    """(size, mtime) of the reference engine's library, or None while absent."""
    try:
        st = os.stat(jnative._SO)
    except FileNotFoundError:
        return None
    return st.st_size, st.st_mtime_ns


@pytest.fixture
def reference_engine(monkeypatch):
    """The JAX package's engine, loaded: after a load that another worker's
    in-place build spoilt, wait until its library is present and unchanged
    over SETTLE_SECONDS, clear the latch (`_tried`) and load again."""
    if jnative.available():
        return jnative
    for _ in range(REFERENCE_LOAD_TRIES):
        before = _so_state()
        time.sleep(SETTLE_SECONDS)
        if before is None or _so_state() != before:
            continue
        monkeypatch.setattr(jnative, "_tried", False)
        if jnative.available():
            return jnative
    pytest.fail(f"the JAX package's native engine did not load ({jnative._SO}: "
                f"{_so_state()}) while the port's did")


@pytest.fixture
def python_path(monkeypatch):
    """The port's pure-Python path: the engine reported unavailable."""
    monkeypatch.setattr(native, "available", lambda: False)


def test_is_prime_matches():
    for n in [1, 2, 3, 4, 561, 7919, (1 << 29) - 3, 536903681, 2147483647]:
        want = nt.is_prime(n)
        assert want == jnt.is_prime(n), n
        assert native.is_prime(n) == want, n


def test_generate_primes_match(monkeypatch):
    cases = [(29, 1024, None), (30, 4096, None), (25, 256, None), (29, 1024, {536903681})]
    nat = [nt.generate_ntt_primes(bits, 4, n, exclude=ex) for bits, n, ex in cases]
    assert nat == [native.generate_ntt_primes(bits, 4, n, ex) for bits, n, ex in cases]
    assert nat == [jnt.generate_ntt_primes(bits, 4, n, exclude=ex) for bits, n, ex in cases]
    monkeypatch.setattr(native, "available", lambda: False)
    assert nat == [nt.generate_ntt_primes(bits, 4, n, exclude=ex) for bits, n, ex in cases]


def test_roots_and_tables_match(monkeypatch, reference_engine):
    """The minimal primitive root, the power series and the psi tables of both
    engines and of the pure-Python path, and the port's whole NTT tables built
    on either path against the JAX package's."""
    n = 1024
    primes = nt.generate_ntt_primes(29, 2, n)
    roots = [native.minimal_primitive_root_2n(2 * n, p) for p in primes]
    assert roots == [jnative.minimal_primitive_root_2n(2 * n, p) for p in primes]
    for p, w in zip(primes, roots):
        ps = native.pow_series(w, n, p)
        np.testing.assert_array_equal(ps, jnative.pow_series(w, n, p))
        np.testing.assert_array_equal(ps, nttm.pow_series(w, n, p))
        for got, want in zip(native.psi_tables(w, n, p), jnative.psi_tables(w, n, p)):
            np.testing.assert_array_equal(got, want)
    tb_native = nttm.build_ntt_tables(primes, n, device="cpu")
    monkeypatch.setattr(native, "available", lambda: False)
    assert [nt.minimal_primitive_root_2n(2 * n, p) for p in primes] == roots
    tb_python = nttm.build_ntt_tables(primes, n, device="cpu")
    want = jntt.build_ntt_tables(primes, n, use_mxu=False)
    for name in ("psi", "psi_sh", "ipsi_n", "ipsi_n_sh", "tw_mat", "tw_mat_sh", "itw_mat",
                 "itw_mat_sh"):
        a, b = getattr(tb_native, name), getattr(tb_python, name)
        assert torch.equal(a, b), name
        ref = getattr(want, name)
        np.testing.assert_array_equal(interop.to_numpy(a), np.asarray(ref), err_msg=name)
