"""The source of the blind-rotation kernels K3/K4 (kernels/csrc/tfhe.cu),
compiled for the host and run on the CPU: each CUDA thread of a block is a
std::thread, __syncthreads and __syncwarp are std::barriers, and the
asynchronous key copy is a memcpy (tests/host_cuda/).  The kernels' index
arithmetic, warp transforms, lookups and reductions must give the plain
chains' bits at lwe_n=16: on the prologue's accumulator, and on uniform
random residues with the X^a edges 0, 1, N-1, N, 2N-1 among the rotation
amounts.  No jax.  Skips where no C++20 host compiler with <barrier> is
installed."""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from heongpu_tpu_torch.kernels import build  # noqa: E402
from heongpu_tpu_torch.models import tfhe  # noqa: E402
from heongpu_tpu_torch.ops import tfhe_kernel as tk  # noqa: E402
from heongpu_tpu_torch.utils import rng  # noqa: E402

torch.set_num_threads(2)

SHIMS = Path(__file__).resolve().parent / "host_cuda"
HARNESS = """#include <cuda_runtime.h>
#include <barrier>
#include <memory>
#include <thread>
#include <vector>
namespace { alignas(16) uint32_t sm[1 << 16]; }
thread_local dim3 threadIdx, blockIdx, blockDim;
static std::barrier<>* g_block;
static std::barrier<>* g_warp[32];
void __syncthreads() { g_block->arrive_and_wait(); }
void __syncwarp(unsigned) { g_warp[threadIdx.x >> 5]->arrive_and_wait(); }
"""
LAUNCH = """
template <bool UNROLLED>
int host_launch(const u32* acc_in, u32* acc_out, const int* a_t, const u32* key, int B, int n,
                const Tables& T, cudaStream_t) {
  static_assert(kSmemWords <= (1 << 16), "shared memory stand-in too small");
  for (int g = 0; g < B; ++g) {
    memset(sm, 0xAB, sizeof(sm));
    std::barrier<> block(kThreads);
    std::vector<std::unique_ptr<std::barrier<>>> warps;
    for (int w = 0; w < kThreads / 32; ++w) {
      warps.emplace_back(new std::barrier<>(32));
      g_warp[w] = warps.back().get();
    }
    g_block = &block;
    std::vector<std::thread> threads;
    for (int t = 0; t < kThreads; ++t)
      threads.emplace_back([=] {
        threadIdx.x = t;
        blockIdx.x = g;
        blockDim.x = kThreads;
        blind_rotate_kernel<UNROLLED>(acc_in, acc_out, a_t, key, n, T);
      });
    for (auto& th : threads) th.join();
  }
  return 0;
}
"""


def host_source() -> str:
    """tfhe.cu with its CUDA launch replaced by host_launch."""
    src = (build.CSRC / "tfhe.cu").read_text()
    launch = src.index("template <bool UNROLLED>\nint launch(")
    ns_end = src.index("}  // namespace")
    entry = src.index('extern "C" int hf_blind_rotate')
    tail = src[entry:].replace("hf_blind_rotate", "host_blind_rotate")
    tail = tail.replace("launch<", "host_launch<")
    return HARNESS + src[:launch] + LAUNCH + src[ns_end:entry] + tail


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    d = tmp_path_factory.mktemp("host_kernel")
    probe = d / "probe.cpp"
    probe.write_text("#include <barrier>\n"
                     "int main() { std::barrier<> b(1); b.arrive_and_wait(); }\n")
    if subprocess.run([cxx, "-std=c++20", "-pthread", "-o", str(d / "probe"), str(probe)],
                      capture_output=True).returncode:
        pytest.skip("the host compiler has no C++20 <barrier>")
    cpp = d / "tfhe_host.cpp"
    cpp.write_text(host_source())
    so = d / "libtfhe_host.so"
    res = subprocess.run([cxx, "-std=c++20", "-O2", "-shared", "-fPIC", "-pthread", "-w",
                          f"-I{SHIMS}", f"-I{build.CSRC}", "-o", str(so), str(cpp)],
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    lib = ctypes.CDLL(str(so))
    lib.host_blind_rotate.argtypes = build.SIGNATURES["hf_blind_rotate"]
    lib.host_blind_rotate.restype = ctypes.c_int
    return lib


@pytest.fixture(scope="module")
def keys():
    ctx = tfhe.make_context(16, device="cpu")
    g = rng.new_generator(7, "cpu")
    sk = tfhe.keygen_secret(g, ctx.n, device="cpu")
    return ctx, g, sk, tfhe.keygen_boot(ctx, g, sk), tfhe.keygen_boot_unrolled(ctx, g, sk)


def _inputs(case, ctx, g, sk):
    r = np.random.default_rng(3)
    if case == "prologue":
        return tfhe._boot_prologue(ctx, tfhe.encrypt(ctx, sk, r.integers(0, 2, 3), g))
    p = np.array(ctx.primes, np.int64)[:, None]
    acc = torch.from_numpy((r.integers(0, 1 << 62, (3, 2, 2, ctx.N)) % p).astype(np.int32))
    N = ctx.N
    a = np.resize(np.array([0, 1, N - 1, N, 2 * N - 1], np.int32), (3, ctx.n))
    a[1] = r.integers(0, 2 * N, ctx.n)
    return acc, torch.from_numpy(a)


@pytest.mark.parametrize("case", ["prologue", "random"])
@pytest.mark.parametrize("unrolled", [False, True])
def test_kernel_source_on_host_matches_plain(host_lib, keys, unrolled, case):
    ctx, g, sk, bk, bk2 = keys
    acc, a_t = _inputs(case, ctx, g, sk)
    key = bk2.bk2 if unrolled else bk.bk
    out = torch.empty_like(acc)
    assert host_lib.host_blind_rotate(*tk.launch_args(acc, out, a_t, key, ctx, unrolled), None) == 0
    plain = tfhe.blind_rotate2_plain if unrolled else tfhe.blind_rotate_plain
    torch.testing.assert_close(out, plain(acc, a_t, key, ctx), rtol=0, atol=0)
