"""The source of the NTT kernel K1 (kernels/csrc/ntt.cu), compiled for the host
and run on the CPU: each CUDA thread of a block is a fiber on one OS thread,
__syncthreads and __syncwarp are barriers between them
(tests/host_cuda/fibers.h), and each of the four pass
kernels runs over its whole grid, the 256 threads walking the blocks in turn
with a block barrier between two blocks.  The kernels' register transforms,
column exchanges, swizzled tiles, transposed writes and index arithmetic must
give ntt_fwd_plain's and ntt_inv_plain's bits, and the inverse must undo the
forward, at each of the nine shapes of the kernel: N = 2^8 and 2^9 (3 limbs,
2 polys), the TFHE table (N = 2^10, 2 limbs, 2 polys), N = 2^11 (4 limbs), a
leveled concatenated table at N = 2^12 (limbs 0-2 and 4-5, 2 polys), and
N = 2^13 .. 2^16 (2 limbs).  No jax.  Skips where no C++20 host compiler with
<ucontext.h> is installed."""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from heongpu_tpu_torch.kernels import build  # noqa: E402
from heongpu_tpu_torch.models import tfhe  # noqa: E402
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
// Runs kern over `blocks` blocks: kThreads fibers walk the blocks in turn, and
// between two blocks thread 0 fills the shared memory with a pattern.
template <class F>
void run_grid(int blocks, F kern) {
  Barrier block(kThreads);
  std::vector<std::unique_ptr<Barrier>> warps;
  for (int w = 0; w < kThreads / 32; ++w) {
    warps.emplace_back(new Barrier(32));
    g_warp[w] = warps.back().get();
  }
  g_block = &block;
  run_threads(kThreads, [=, &block](int t) {
    threadIdx.x = t;
    blockDim.x = kThreads;
    gridDim.x = blocks;
    for (int b = 0; b < blocks; ++b) {
      if (t == 0) memset(sm, 0xAB, sizeof(sm));
      block.arrive_and_wait();
      blockIdx.x = b;
      kern();
      block.arrive_and_wait();
    }
  });
}

template <int L1, int L2>
int host_launch(int inverse, const Params& P, int rows, cudaStream_t) {
  using Y = Tiles<L1, L2>;
  static_assert(3 * Y::kTile + 2 * (1 << L2) <= (1 << 16), "shared memory stand-in too small");
  const int ga = rows << Y::kLogTilesA, gb = rows << Y::kLogTilesB;
  if (!inverse) {
    run_grid(ga, [&] { ntt_fwd1<L1, L2, false>(P); });
    run_grid(gb, [&] { ntt_fwd2<L1, L2, false>(P); });
  } else {
    run_grid(gb, [&] { ntt_inv1<L1, L2, false>(P); });
    run_grid(ga, [&] { ntt_inv2<L1, L2, false>(P); });
  }
  return 0;
}

template <int L1, int L2>
int host_launch_pass(int inverse, int pass, const Params& P, int rows, cudaStream_t) {
  using Y = Tiles<L1, L2>;
  if (!whole_tiles<L1, L2>(P.ld)) return cudaErrorInvalidValue;
  const int ga = rows << (Y::kLogTilesA - P.ld), gb = rows << (Y::kLogTilesB - P.ld);
  if (!inverse && pass == 1) run_grid(ga, [&] { ntt_fwd1<L1, L2, true>(P); });
  else if (!inverse) run_grid(gb, [&] { ntt_fwd2<L1, L2, true>(P); });
  else if (pass == 1) run_grid(gb, [&] { ntt_inv1<L1, L2, true>(P); });
  else run_grid(ga, [&] { ntt_inv2<L1, L2, true>(P); });
  return 0;
}
"""


def host_source(src: str) -> str:
    """ntt.cu's text with its launches replaced by host_launch and
    host_launch_pass."""
    launch = src.index("template <int L1, int L2>\nint launch(")
    ns_end = src.index("}  // namespace")
    entry = src.index('extern "C" int hf_ntt')
    tail = (src[entry:].replace("hf_ntt", "host_ntt").replace("launch<", "host_launch<")
            .replace("launch_pass<", "host_launch_pass<"))
    return HARNESS + src[:launch] + LAUNCH + src[ns_end:entry] + tail


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    d = tmp_path_factory.mktemp("host_ntt")
    probe = d / "probe.cpp"
    probe.write_text("#include <ucontext.h>\n"
                     "int main() { ucontext_t c; return getcontext(&c); }\n")
    if subprocess.run([cxx, "-std=c++20", "-pthread", "-o", str(d / "probe"), str(probe)],
                      capture_output=True).returncode:
        pytest.skip("the host compiler has no C++20 or no <ucontext.h>")
    cpp = d / "ntt_host.cpp"
    cpp.write_text(host_source((build.CSRC / "ntt.cu").read_text()))
    so = d / "libntt_host.so"
    res = subprocess.run([cxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-w",
                          f"-I{SHIMS}", f"-I{build.CSRC}", "-o", str(so), str(cpp)],
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    lib = ctypes.CDLL(str(so))
    for name in ("ntt", "ntt_pass"):
        fn = getattr(lib, f"host_{name}")
        fn.argtypes = build.SIGNATURES[f"hf_{name}"]
        fn.restype = ctypes.c_int
    return lib


def run_host(lib, x, tb, inverse, n1=None, n2=None):
    """The host-compiled K1 on CPU tensors, with the C arguments ntt_cuda passes;
    n1, n2 override the tables' split.  Returns (error code, output)."""
    out, tmp = torch.empty_like(x), torch.empty_like(x)
    pre = "itw" if inverse else "tw"
    tabs = [getattr(tb, pre + name) for name in ("_mat", "_mat_sh", "1p", "1p_sh", "2p", "2p_sh")]
    err = lib.host_ntt(int(inverse), x.data_ptr(), tmp.data_ptr(), out.data_ptr(),
                       x.numel() // tb.n, tb.num_limbs, n1 or tb.n1, n2 or tb.n2,
                       tb.p.data_ptr(), *(t.data_ptr() for t in tabs), None)
    return err, out


def _tables(case):
    """(tables, polys) of a test case."""
    if case == "tfhe":
        return tfhe.make_context(16, device="cpu").ntt, 2
    n, limbs, polys = case
    if limbs == "leveled":
        full = tntt.build_ntt_tables(tnt.generate_ntt_primes(29, 6, n), n, device="cpu")
        return full.slice_limbs(0, 3).concat(full.slice_limbs(4, 6)), polys
    return tntt.build_ntt_tables(tnt.generate_ntt_primes(29, limbs, n), n, device="cpu"), polys


@pytest.mark.parametrize("case", [(256, 3, 2), (512, 3, 2), "tfhe", (2048, 4, 1),
                                  (4096, "leveled", 2), (8192, 2, 1), (16384, 2, 1),
                                  (32768, 2, 1), (65536, 2, 1)],
                         ids=["n256", "n512", "n1024_tfhe", "n2048", "n4096_leveled", "n8192",
                              "n16384", "n32768", "n65536"])
def test_kernel_source_on_host_matches_plain(host_lib, case):
    tb, polys = _tables(case)
    rng = np.random.default_rng(tb.n + tb.num_limbs)
    p = np.array(tb.primes * polys, np.uint64)[:, None]
    x = tm.u32_to_i32((rng.integers(0, 1 << 62, size=(polys * tb.num_limbs, tb.n),
                                    dtype=np.uint64) % p).astype(np.uint32))
    x = x.view(polys, tb.num_limbs, tb.n)
    err, f = run_host(host_lib, x, tb, inverse=False)
    assert err == 0
    torch.testing.assert_close(f, tntt.ntt_fwd_plain(x, tb), rtol=0, atol=0)
    err, i = run_host(host_lib, f, tb, inverse=True)
    assert err == 0
    torch.testing.assert_close(i, tntt.ntt_inv_plain(f, tb), rtol=0, atol=0)
    torch.testing.assert_close(i, x, rtol=0, atol=0)


def test_kernel_source_on_host_rejects_other_shapes(host_lib):
    """The entry returns an error for a shape outside its nine instantiations."""
    tb, _ = _tables((256, 3, 2))
    x = torch.zeros((3, 256), dtype=tm.I32)
    for n1, n2 in ((8, 32), (16, 64), (32, 16), (512, 512), (24, 24)):
        for inverse in (False, True):
            assert run_host(host_lib, x, tb, inverse, n1, n2)[0] != 0
