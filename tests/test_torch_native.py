"""Port of tests/test_native.py: the port's native C++ parameter engine
(heongpu_tpu_torch/utils/native.py, its own copy of paramgen.cpp) against
its pure-Python path and against the JAX package's engine and number theory,
bit for bit.  Skips where the engine cannot be built (no g++), as the JAX
package's test does."""

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


def test_roots_and_tables_match(monkeypatch):
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
