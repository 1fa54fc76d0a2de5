"""The source of the fused keyswitch kernel K5 (kernels/csrc/keyswitch.cu),
compiled for the host and run on the CPU: each CUDA thread of a block is a
fiber on one OS thread, __syncthreads and __syncwarp are barriers between
them (tests/host_cuda/fibers.h), and the grid is one block (gridDim 1), so
each phase's work-item loop covers every item and the grid-wide barrier
between phases is the block barrier.
The kernel's register transforms, column exchanges, swizzled tiles, index
arithmetic and MAC must give keyswitch2_fused_core_plain's bits: at N=256
(n1 = n2 = 16) and N=2048 (32 x 64) for two digit structures, at N=4096
(64 x 64) with 3 digits over 16 limbs, and at N=2^16 (256 x 256) with a short
last digit group.  No jax.  Skips where no C++20 host compiler with
<ucontext.h> is installed."""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from heongpu_tpu_torch.kernels import build  # noqa: E402
from heongpu_tpu_torch.kernels import keyswitch_phases  # noqa: E402
from heongpu_tpu_torch.ops import keyswitch2 as tks2  # noqa: E402
from heongpu_tpu_torch.ops import keyswitch_fused as tksf  # noqa: E402
from heongpu_tpu_torch.ops import modmath as tm  # noqa: E402
from heongpu_tpu_torch.ops import ntt as tntt  # noqa: E402
from heongpu_tpu_torch.utils import nt as tnt  # noqa: E402

torch.set_num_threads(2)

SHIMS = Path(__file__).resolve().parent / "host_cuda"
HARNESS = """#include <cuda_runtime.h>
#include <fibers.h>
#include <memory>
#include <vector>
namespace { alignas(16) uint32_t sm[1 << 16]; }
thread_local dim3 threadIdx, blockIdx, blockDim, gridDim;
static Barrier* g_block;
static Barrier* g_warp[32];
void __syncthreads() { g_block->arrive_and_wait(); }
void __syncwarp(unsigned) { g_warp[threadIdx.x >> 5]->arrive_and_wait(); }
"""
LAUNCH = """
template <int L1, int L2>
int host_launch(const Params& P, cudaStream_t) {
  static_assert(Layout<L1, L2>::kWords <= (1 << 16), "shared memory stand-in too small");
  memset(sm, 0xAB, sizeof(sm));
  Barrier block(kThreads);
  std::vector<std::unique_ptr<Barrier>> warps;
  for (int w = 0; w < kThreads / 32; ++w) {
    warps.emplace_back(new Barrier(32));
    g_warp[w] = warps.back().get();
  }
  g_block = &block;
  run_threads(kThreads, [=](int t) {
    threadIdx.x = t;
    blockIdx.x = 0;
    blockDim.x = kThreads;
    gridDim.x = 1;
    keyswitch2_fused_kernel<L1, L2>(P);
  });
  return 0;
}
"""


def host_source(src: str) -> str:
    """keyswitch.cu's text with its cooperative launch replaced by host_launch."""
    launch = src.index("template <int L1, int L2>\nint launch(")
    ns_end = src.index("}  // namespace")
    entry = src.index('extern "C" int hf_keyswitch2_fused')
    tail = src[entry:].replace("hf_keyswitch2_fused", "host_keyswitch2_fused")
    tail = tail.replace("launch<", "host_launch<")
    return HARNESS + src[:launch] + LAUNCH + src[ns_end:entry] + tail


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    d = tmp_path_factory.mktemp("host_keyswitch")
    probe = d / "probe.cpp"
    probe.write_text("#include <ucontext.h>\n"
                     "int main() { ucontext_t c; return getcontext(&c); }\n")
    if subprocess.run([cxx, "-std=c++20", "-pthread", "-o", str(d / "probe"), str(probe)],
                      capture_output=True).returncode:
        pytest.skip("the host compiler has no C++20 or no <ucontext.h>")
    cpp = d / "keyswitch_host.cpp"
    cpp.write_text(host_source((build.CSRC / "keyswitch.cu").read_text()))
    so = d / "libkeyswitch_host.so"
    res = subprocess.run([cxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-w",
                          f"-I{SHIMS}", f"-I{build.CSRC}", "-o", str(so), str(cpp)],
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    lib = ctypes.CDLL(str(so))
    lib.host_keyswitch2_fused.argtypes = build.SIGNATURES["hf_keyswitch2_fused"]
    lib.host_keyswitch2_fused.restype = ctypes.c_int
    return lib


def _residues(rng, primes, shape):
    p = np.array(primes, np.uint64)[:, None]
    x = (rng.integers(0, 1 << 62, size=shape, dtype=np.uint64) % p).astype(np.uint32)
    return tm.u32_to_i32(x)


def _inputs(n, ka, alpha, p_count):
    primes = tnt.generate_ntt_primes(29, ka + p_count, n)
    lvl = tks2.build_ks2_level(primes[:ka], primes[ka:], ka, alpha, "cpu")
    tb = tntt.build_ntt_tables(primes, n, device="cpu")
    rng = np.random.default_rng(n + ka)
    d, kqp = len(lvl.groups), ka + p_count
    z = torch.cat([_residues(rng, primes[g[0]: g[-1] + 1], (len(g), n)) for g in lvl.groups])
    k0, k1 = (_residues(rng, primes * d, (d * kqp, n)).view(d, kqp, n) for _ in range(2))
    return z, tksf.build_fused_mat(lvl, kqp), k0, k1, tb, lvl.groups


def run_host(lib, z, mat, k0, k1, tb, groups):
    """The host-compiled K5 on CPU tensors, with the C arguments the wrapper
    keyswitch2_fused_cuda passes."""
    ka, n = z.shape
    kqp, d = tb.num_limbs, len(groups)
    out = torch.empty((2, kqp, n), dtype=tm.I32)
    s1, s2 = torch.empty((d, kqp, n), dtype=tm.I32), torch.empty_like(out)
    tabs = [getattr(tb, name) for name in tksf._TABLES]
    err = lib.host_keyswitch2_fused(
        z.data_ptr(), mat.data_ptr(), k0.data_ptr(), k1.data_ptr(), s1.data_ptr(),
        s2.data_ptr(), out.data_ptr(), ka, kqp, d, mat.shape[0] // d, tb.n1, tb.n2,
        *(t.data_ptr() for t in tabs), None)
    return err, out


@pytest.mark.parametrize("n,ka,alpha,p_count", [
    (256, 4, 2, 2), (256, 5, 2, 3), (2048, 4, 2, 2), (2048, 5, 2, 3),
    (4096, 12, 4, 4), (65536, 11, 4, 4)])
def test_kernel_source_on_host_matches_plain(host_lib, n, ka, alpha, p_count):
    args = _inputs(n, ka, alpha, p_count)
    err, out = run_host(host_lib, *args)
    assert err == 0
    torch.testing.assert_close(out, tksf.keyswitch2_fused_core_plain(*args), rtol=0, atol=0)


def test_kernel_source_on_host_rejects_other_shapes(host_lib):
    """The entry returns an error for a shape outside its nine instantiations."""
    z, mat, k0, k1, tb, groups = _inputs(256, 4, 2, 2)
    for n1, n2 in ((8, 32), (16, 64), (512, 512)):
        fake = type("T", (), {"num_limbs": tb.num_limbs, "n1": n1, "n2": n2,
                              **{name: getattr(tb, name) for name in tksf._TABLES}})
        assert run_host(host_lib, z, mat, k0, k1, fake, groups)[0] != 0


def test_phase_instrumentation_finds_its_markers():
    """kernels/keyswitch_phases.py patches keyswitch.cu at text markers that must
    each occur once: its instrumented copy holds all six stamps and the readout."""
    src = keyswitch_phases.instrumented_source()
    assert all(f"STAMP({k});" in src for k in range(keyswitch_phases.STAMPS))
    assert src.count("g_stamp[blockIdx.x][k] = now;") == 1 and "hf_stamp_read" in src
