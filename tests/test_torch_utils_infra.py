"""Port of tests/test_utils_infra.py: the port's host utilities (utils/
storage.py, memory.py, profiling.py) on the CPU, where "host" and "device" are
both the CPU: the round trips and the HOST verdict are held here, the DEVICE
verdict and the card's statistics by chip_smoke.py's phase 20.  A ciphertext
and a keyswitch key go through to_host / to_device with the same residues as
through the JAX package's storage."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from heongpu_tpu.utils import storage as jstorage  # noqa: E402
from heongpu_tpu_torch import interop  # noqa: E402
from heongpu_tpu_torch.models import ckks  # noqa: E402
from heongpu_tpu_torch.utils import memory, profiling, storage  # noqa: E402


def test_storage_roundtrip():
    tree = {"a": torch.arange(8, dtype=torch.int32), "meta": 7, "b": [torch.zeros((2, 2))]}
    h = storage.to_host(tree)
    assert storage.storage_of(h) == storage.HOST
    assert isinstance(h["a"], torch.Tensor) and h["meta"] == 7
    d = storage.to_device(h, "cpu")
    assert storage.storage_of(d) == storage.HOST     # the CPU is the only device here
    out = storage.run_with_storage(
        lambda t: {"c": t["a"] + 1}, [h],
        storage.ExecutionOptions(storage=storage.HOST, device="cpu"))
    assert out["c"].device.type == "cpu"
    np.testing.assert_array_equal(out["c"].numpy(), np.arange(8) + 1)


def test_memory_status_api():
    st = memory.device_pool_status("cpu")
    assert "in_use" in str(st)
    memory.print_memory_pool_status()
    # the CPU keeps no allocator statistics: every getter is None there
    assert (st.bytes_in_use, st.peak_bytes_in_use, st.bytes_limit, st.num_allocs,
            st.free_bytes) == (None,) * 5
    assert memory.get_free_device_pool_memory("cpu") is None
    assert memory.get_current_device_pool_memory_usage("cpu") is None


def test_profiling_timer(tmp_path):
    f = lambda x: x * 2
    dt = profiling.time_op(f, torch.ones((4,)), iters=3)
    assert dt >= 0.0
    with profiling.trace(str(tmp_path)):
        f(torch.ones((4,)))
    assert [n for n in os.listdir(tmp_path) if n.endswith(".json")]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            profiling.device_memory_profile(str(tmp_path / "snapshot.pickle"))
        assert not (tmp_path / "snapshot.pickle").exists()


def test_ciphertext_and_key_roundtrip():
    """A port Ciphertext and KSKey parked on the host and brought back keep
    their residues and their other fields, the JAX package's storage giving
    the same residues for the same arrays."""
    R = np.random.default_rng(5)
    c = R.integers(0, 2 ** 29, (2, 4, 64)).astype(np.uint32)
    k0, k1 = (R.integers(0, 2 ** 29, (4, 5, 64)).astype(np.uint32) for _ in range(2))
    tree = {"ct": ckks.Ciphertext(interop._t(c, "cpu"), 2, 1, 2.0 ** 25),
            "rk": ckks.KSKey(interop._t(k0, "cpu"), interop._t(k1, "cpu"), a_seed=9)}
    back = storage.to_device(storage.to_host(tree), "cpu")
    assert storage.storage_of(back) == storage.HOST
    ct, rk = back["ct"], back["rk"]
    assert (type(ct), ct.size, ct.level, ct.scale) == (ckks.Ciphertext, 2, 1, 2.0 ** 25)
    assert (type(rk), rk.a_seed) == (ckks.KSKey, 9)
    want = jstorage.to_host({"c": c, "k0": k0, "k1": k1})
    np.testing.assert_array_equal(interop.to_numpy(ct.c), want["c"])
    np.testing.assert_array_equal(interop.to_numpy(rk.k0), want["k0"])
    np.testing.assert_array_equal(interop.to_numpy(rk.k1), want["k1"])
