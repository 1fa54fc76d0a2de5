"""The source of the seeded-key draw kernel K7 (kernels/csrc/threefry.cu),
compiled for the host and run on the CPU as tests/test_torch_rns_host_kernel.py
runs K2 and K6: each CUDA thread of a block is a std::thread and the launch
walks its whole grid.  The kernel's counters, Threefry rounds, exact reduction,
Montgomery step and output layouts must give the plain version's bits
(threefry.uniform_rns_plain): one row and d rows, in the draw layout and with
the limb axis moved behind the digit axis, with and without the Montgomery
form, over seeds whose keys differ in both words.  No jax.  Skips where no
C++20 host compiler with <barrier> is installed."""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from heongpu_tpu_torch.kernels import build  # noqa: E402
from heongpu_tpu_torch.utils import nt as tnt  # noqa: E402
from heongpu_tpu_torch.utils import threefry as ttf  # noqa: E402
from test_torch_rns_host_kernel import SHIMS, host_source  # noqa: E402

torch.set_num_threads(2)

SOURCES = {"threefry": ("int launch_threefry(", 'extern "C" int hf_threefry_uniform', """
int launch_threefry(const DrawParams& A, unsigned blocks, cudaStream_t) {
  run_grid(dim3{blocks, 1u, 1u}, [&] { threefry_uniform_kernel(A); });
  return 0;
}
""")}


@pytest.fixture(scope="module")
def host_k7(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    d = tmp_path_factory.mktemp("host_k7")
    cpp, so = d / "threefry_host.cpp", d / "libthreefry_host.so"
    cpp.write_text(host_source("threefry", SOURCES))
    res = subprocess.run([cxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-w",
                          f"-I{SHIMS}", f"-I{build.CSRC}", "-o", str(so), str(cpp)],
                         capture_output=True, text=True, timeout=600)
    if res.returncode and "barrier" in res.stderr:
        pytest.skip("the host compiler has no C++20 <barrier>")
    assert res.returncode == 0, res.stderr[-4000:]
    fn = ctypes.CDLL(str(so)).host_threefry_uniform
    fn.argtypes = build.SIGNATURES["hf_threefry_uniform"]
    fn.restype = ctypes.c_int
    return fn


def run_k7(fn, key, primes, shape, moved, mont):
    """The host-compiled K7 with the C arguments uniform_rns_cuda passes."""
    L, (d, n) = len(primes), ttf._draw_dims(shape)
    tab = ttf._k7_table(tuple(primes), "cpu")
    (h0, h1), (l0, l1) = ttf.split_np(key, 2)
    out = torch.empty((d, L, n) if moved else (L,) + tuple(shape), dtype=torch.int32)
    err = fn(out.data_ptr(), tab.data_ptr(), h0, h1, l0, l1, L, d, n, int(moved), int(mont),
             None)
    return err, out


# (limbs, draw shape): a public key's one row, a keyswitch key's d rows (d > 1, so
# the moved layout's counters differ from its output positions), a row of n not a
# multiple of the block
CASES = [(3, (256,)), (5, (4, 256)), (7, (3, 100))]


@pytest.mark.parametrize("L,shape", CASES, ids=[f"L{a}_{'x'.join(map(str, s))}"
                                                for a, s in CASES])
@pytest.mark.parametrize("seed", [0, 2 ** 31 + 5, -3])
def test_threefry_source_on_host_matches_plain(host_k7, L, shape, seed):
    primes = tnt.generate_ntt_primes(29, L - 1, 4096) + tnt.generate_ntt_primes(30, 1, 4096)
    key = ttf.key_from_seed(seed)
    for moved in ((False, True) if len(shape) == 2 else (False,)):
        for mont in (False, True):
            err, got = run_k7(host_k7, key, primes, shape, moved, mont)
            assert err == 0
            want = ttf.uniform_rns_plain(key, primes, shape, "cpu", moved, mont)
            torch.testing.assert_close(got, want, rtol=0, atol=0)
    p = torch.tensor(primes, dtype=torch.int64).view((-1,) + (1,) * len(shape))
    raw = ttf.uniform_rns_plain(key, primes, shape, "cpu")
    assert bool((raw.long() < p).all()) and bool((raw >= 0).all())


def test_threefry_source_rejects_empty_and_oversized_draws(host_k7):
    out = torch.empty(4, dtype=torch.int32)
    tab = ttf._k7_table((536608769,), "cpu")
    for L, d, n in ((0, 1, 4), (1, 0, 4), (1 << 12, 1 << 10, 1 << 10)):
        assert host_k7(out.data_ptr(), tab.data_ptr(), 1, 2, 3, 4, L, d, n, 0, 0, None) != 0
    # a moved draw's limb axis really moves: the same words, transposed
    primes = tnt.generate_ntt_primes(29, 3, 4096)
    key = ttf.key_from_seed(81)
    _, flat = run_k7(host_k7, key, primes, (2, 64), False, False)
    _, moved = run_k7(host_k7, key, primes, (2, 64), True, False)
    torch.testing.assert_close(moved, flat.transpose(0, 1).contiguous(), rtol=0, atol=0)
    assert not np.array_equal(moved.numpy().ravel(), flat.numpy().ravel())
