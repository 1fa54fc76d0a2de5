"""The source of the seeded-key draw kernel K7 (kernels/csrc/threefry.cu),
compiled for the host and run on the CPU as tests/test_torch_rns_host_kernel.py
runs K2 and K6: each CUDA thread of a block is a fiber on one OS thread and
the launch walks its whole grid.  The kernel's counters, Threefry rounds, exact reduction,
Montgomery step and output layouts must give the plain version's bits
(threefry.uniform_rns_plain): one row and d rows, in the draw layout and with
the limb axis moved behind the digit axis, with and without the Montgomery
form, over seeds whose keys differ in both words.  No jax.  Skips where no
C++20 host compiler with <ucontext.h> is installed."""

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
int launch_threefry(const DrawParams& A, dim3 grid, cudaStream_t) {
  run_grid(grid, [&] { threefry_uniform_kernel(A); });
  return 0;
}

int launch_threefry_bits(const BitsParams& A, unsigned blocks, cudaStream_t) {
  run_grid(dim3{blocks, 1u, 1u}, [&] { threefry_bits_kernel(A); }, kBitsThreads);
  return 0;
}
""")}


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    d = tmp_path_factory.mktemp("host_k7")
    cpp, so = d / "threefry_host.cpp", d / "libthreefry_host.so"
    cpp.write_text(host_source("threefry", SOURCES))
    res = subprocess.run([cxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-w",
                          f"-I{SHIMS}", f"-I{build.CSRC}", "-o", str(so), str(cpp)],
                         capture_output=True, text=True, timeout=600)
    if res.returncode and "ucontext" in res.stderr:
        pytest.skip("the host compiler has no <ucontext.h>")
    assert res.returncode == 0, res.stderr[-4000:]
    lib = ctypes.CDLL(str(so))
    for name in ("threefry_uniform", "threefry_bits"):
        fn = getattr(lib, f"host_{name}")
        fn.argtypes = build.SIGNATURES[f"hf_{name}"]
        fn.restype = ctypes.c_int
    return lib.host_threefry_uniform, lib.host_threefry_bits


@pytest.fixture(scope="module")
def host_k7(host_lib):
    return host_lib[0]


@pytest.fixture(scope="module")
def host_k7_bits(host_lib):
    return host_lib[1]


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
# the moved layout's counters differ from its output positions), rows of n not a
# multiple of the block or of the words a thread (K7's blocks take 1024 words of a
# row, 4 a thread), a single limb in one row and in a moved (1, n) draw, and the 54
# limbs of a depth-48 key over d > 1 rows
CASES = [(3, (256,)), (5, (4, 256)), (7, (3, 100)), (1, (2053,)), (1, (1, 1029)),
         (2, (2, 1027)), (54, (3, 301))]
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


def _primes_above(bits, count):
    """The `count` least primes above 2^bits whose 2^64 mod p is at least 0.9 p:
    floor(2^32/p) falls just short of 2^(32-bits) and the Shoup companion of
    2^32 mod p rounds down by most of a unit, so Barrett's and Shoup's quotients
    are each one short for about half the words, and about 4% of the lazy sums
    reach [3p, 4p)."""
    out, v = [], (1 << bits) + 1
    while len(out) < count:
        if 10 * ((1 << 64) % v) >= 9 * v and all(v % d for d in range(3, int(v ** 0.5) + 1, 2)):
            out.append(v)
        v += 2
    return out


@pytest.mark.parametrize("mont", [False, True], ids=["plain", "mont"])
def test_threefry_source_on_host_matches_plain_above_powers_of_two(host_k7, mont):
    """Primes just above 2^28 and 2^29 (no NTT primes: K7 takes any prime below
    2^30) where the Shoup and Barrett results are each in [p, 2p) for about half
    the words, so the reduction's sum reaches [3p, 4p) and every conditional
    subtraction counts."""
    primes = _primes_above(29, 3) + _primes_above(28, 2)
    key = ttf.key_from_seed(5)
    for moved in (False, True):
        err, got = run_k7(host_k7, key, primes, (2, 1100), moved, mont)
        assert err == 0
        want = ttf.uniform_rns_plain(key, primes, (2, 1100), "cpu", moved, mont)
        torch.testing.assert_close(got, want, rtol=0, atol=0)


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


# raw-words draws: odd counts (a partial last block, counts that are not a multiple
# of the words a thread), the 2^16 words of one sort round at n = 2^16 and 3 past
# them, and a multi-axis draw
BITS_SHAPES = [(1,), (5,), (7,), (255, 3), (21000,), (1 << 16,), ((1 << 16) + 3,),
               (3, 4, 256)]


@pytest.mark.parametrize("shape", BITS_SHAPES, ids=["x".join(map(str, s)) for s in BITS_SHAPES])
@pytest.mark.parametrize("seed", [0, 2 ** 31 + 5, -3])
def test_threefry_bits_source_on_host_matches_numpy(host_k7_bits, shape, seed):
    key = ttf.key_from_seed(seed)
    for k in (key, ttf.fold_in_np(key, 1)):
        out = torch.empty(shape, dtype=torch.int32)
        assert host_k7_bits(out.data_ptr(), k[0], k[1], out.numel(), None) == 0
        np.testing.assert_array_equal(out.numpy().view(np.uint32), ttf.bits32_np(k, shape))
        torch.testing.assert_close(out, ttf.bits32_plain(k, shape, "cpu"), rtol=0, atol=0)


def test_threefry_bits_source_rejects_empty_draws(host_k7_bits):
    out = torch.full((4,), 7, dtype=torch.int32)
    for count in (0, -1):
        assert host_k7_bits(out.data_ptr(), 1, 2, count, None) != 0
    assert out.tolist() == [7] * 4
