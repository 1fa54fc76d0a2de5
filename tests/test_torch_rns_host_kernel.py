"""The sources of the base-conversion kernel K2 (kernels/csrc/mac.cu, base_conv)
and of the ÷P kernel K6 (kernels/csrc/divround.cu), compiled for the host and run
on the CPU: each CUDA thread of a block is a fiber on one OS thread,
__syncthreads a barrier between them (tests/host_cuda/fibers.h), and each
launch runs over its whole grid, the 256 threads walking the blocks in turn
with a block barrier between two.  The
kernels' shared-memory tables, register columns, folds, output-limb split and
index arithmetic must give the plain versions' bits (rns.base_conv_plain,
rns.div_round_chain_plain): base_conv at every chunk width it is built for, at
k_in short of each and at k_in of two and three chunks, with and without the
fused scaling, B = 1 and 3, at N = 256 and 4096, and at N = 2^16 where a block
takes several output limbs; K6 with p = 1 to 16 special primes over k = 1 to 48
Q limbs (every remainder of k by the 8 Q limbs a block takes) at N = 256 and
4096, with primes just under 2^30, and a chain of 20 in two pieces.  No jax.  Skips
where no C++20 host compiler with <ucontext.h> is installed."""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from heongpu_tpu_torch.kernels import build  # noqa: E402
from heongpu_tpu_torch.ops import modmath as tm  # noqa: E402
from heongpu_tpu_torch.ops import rns as trns  # noqa: E402
from heongpu_tpu_torch.utils import nt as tnt  # noqa: E402

torch.set_num_threads(2)

SHIMS = Path(__file__).resolve().parent / "host_cuda"
HARNESS = """#include <cuda_runtime.h>
#include <fibers.h>
#include <memory>
#include <vector>
namespace { alignas(16) uint32_t sm[1 << 14]; }
thread_local dim3 threadIdx, blockIdx, blockDim, gridDim;
static Barrier* g_block;
static Barrier* g_warp[32];
void __syncthreads() { g_block->arrive_and_wait(); }
void __syncwarp(unsigned) { g_warp[threadIdx.x >> 5]->arrive_and_wait(); }
"""
RUN_GRID = """
// Runs kern over the grid: `threads` fibers (a block's, whole warps) walk the
// blocks in turn, and between two blocks thread 0 fills the shared memory with a
// pattern.
template <class F>
void run_grid(dim3 grid, F kern, int threads = kThreads) {
  Barrier block(threads);
  g_block = &block;
  std::vector<std::unique_ptr<Barrier>> warps;
  for (int w = 0; w < threads / 32; ++w) {
    warps.emplace_back(new Barrier(32));
    g_warp[w] = warps.back().get();
  }
  const unsigned blocks = grid.x * grid.y * grid.z;
  run_threads(threads, [=, &block](int t) {
      threadIdx.x = t;
      blockDim.x = threads;
      gridDim = grid;
      for (unsigned b = 0; b < blocks; ++b) {
        if (t == 0) memset(sm, 0xAB, sizeof(sm));
        block.arrive_and_wait();
        blockIdx.x = b % grid.x;
        blockIdx.y = b / grid.x % grid.y;
        blockIdx.z = b / (grid.x * grid.y);
        kern();
        block.arrive_and_wait();
      }
    });
}
"""
SOURCES = {
    "mac": ("template <int KP, bool CHUNKED>\nint launch_base_conv(", 'extern "C" int hf_base_conv', """
template <int KP, bool CHUNKED>
int launch_base_conv(const ConvParams& P, dim3 grid, cudaStream_t) {
  if (conv_smem_bytes(P.per, P.stride) > sizeof(sm)) return 1;
  if (P.scale)
    run_grid(grid, [&] { base_conv_kernel<KP, true, CHUNKED>(P); });
  else
    run_grid(grid, [&] { base_conv_kernel<KP, false, CHUNKED>(P); });
  return 0;
}
"""),
    "divround": ("template <int P, bool EXACT>\nint launch_div_round(",
                 "template <bool EXACT>\nint div_chain(", """
template <int P, bool EXACT>
int launch_div_round(const DivParams& A, int B, cudaStream_t) {
  const unsigned by = static_cast<unsigned>(B);
  if constexpr (column_rows(P) > 0) {
    if (A.k <= column_rows(P)) {
      run_grid(dim3{static_cast<unsigned>((A.N + kThreads - 1) / kThreads), by, 1u},
               [&] { div_round_column_kernel<P, EXACT>(A); });
      return 0;
    }
  }
  const int groups = kWarps / A.warps, cols = 32 * groups;
  if (smem_bytes(groups, A.k, P) > sizeof(sm)) return 1;
  run_grid(dim3{static_cast<unsigned>((A.N + cols - 1) / cols), by, 1u},
           [&] { div_round_tile_kernel<P, EXACT>(A); }, 32 * A.warps * groups);
  return 0;
}
"""),
}


def host_source(stem: str, sources=None) -> str:
    """The source's text with its launch function replaced by a host run of the
    grid, and the rest of the source kept from `keep_from` on (entry points
    renamed host_*; a tail that starts outside the anonymous namespace gets the
    namespace closed before it)."""
    launch_at, keep_from, launch = (sources or SOURCES)[stem]
    src = (build.CSRC / f"{stem}.cu").read_text()
    keep = src.index(keep_from)
    tail = src[keep:].replace("hf_", "host_")
    close = "}  // namespace\n\n" if keep > src.index("}  // namespace") else ""
    return HARNESS + src[:src.index(launch_at)] + RUN_GRID + launch + close + tail


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    d = tmp_path_factory.mktemp("host_rns")
    probe = d / "probe.cpp"
    probe.write_text("#include <ucontext.h>\n"
                     "int main() { ucontext_t c; return getcontext(&c); }\n")
    if subprocess.run([cxx, "-std=c++20", "-pthread", "-o", str(d / "probe"), str(probe)],
                      capture_output=True).returncode:
        pytest.skip("the host compiler has no C++20 or no <ucontext.h>")
    libs = {}
    for stem, names in (("mac", ("hf_base_conv",)),
                        ("divround", ("hf_div_round", "hf_div_exact_t"))):
        cpp = d / f"{stem}_host.cpp"
        cpp.write_text(host_source(stem))
        so = d / f"lib{stem}_host.so"
        res = subprocess.run([cxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-w",
                              f"-I{SHIMS}", f"-I{build.CSRC}", "-o", str(so), str(cpp)],
                             capture_output=True, text=True, timeout=600)
        assert res.returncode == 0, res.stderr[-4000:]
        lib = ctypes.CDLL(str(so))
        for name in names:
            fn = getattr(lib, name.replace("hf_", "host_"))
            fn.argtypes = build.SIGNATURES[name]
            fn.restype = ctypes.c_int
            libs[name[3:]] = fn
    libs["mac"], libs["divround"] = libs["base_conv"], libs["div_round"]
    return libs


def _residues(rng, primes, shape):
    """shape (..., L, n) with limb axis -2 over `primes`."""
    p = np.array(primes, np.uint64)[:, None]
    x = (rng.integers(0, 1 << 62, size=shape, dtype=np.uint64) % p).astype(np.uint32)
    return tm.u32_to_i32(x)


# The SM count of an H100 SXM, which sizes the wave that base_conv's output-limb
# split fills
SMS = 132


def run_base_conv(fn, z, conv, scale, sms=SMS):
    """The host-compiled base_conv on CPU tensors, with the C arguments
    base_conv_cuda passes.  Returns (error code, output)."""
    k_in, k_out = conv.mat_mont.shape
    n = z.shape[-1]
    out = torch.empty(z.shape[:-2] + (k_out, n), dtype=tm.I32)
    ob = conv.obase
    err = fn(z.data_ptr(), conv.mat_mont.data_ptr(), out.data_ptr(), ob.p.data_ptr(),
             ob.pinv.data_ptr(), ob.mu.data_ptr(), conv.scale.data_ptr() if scale else None,
             z.numel() // (k_in * n), k_in, k_out, n, sms, None)
    return err, out


# (k_in, k_out): the alpha groups into the CKKS Q̃ bases (16 limbs, the
# bootstrap's 54), BFV's Bsk conversions (6 -> 4 and 8 -> 11 at small N, 16 -> 14
# at N = 2^14, 29 -> 32 and 31 -> 29 on the default 128-bit chain), a width in
# each chunk instance short of its multiple of 4, and k_in of two and three chunks
CONV_CASES = [(1, 5), (2, 14), (3, 15), (4, 16), (4, 54), (5, 7), (6, 4), (8, 11), (10, 8),
              (14, 16), (16, 14), (19, 5), (23, 6), (27, 4), (29, 32), (31, 29), (32, 3),
              (40, 12), (70, 5)]


def test_conv_cases_cover_every_instance():
    """Every chunk width the kernel is built for (4 to 32 words), each also at a
    k_in short of it, and k_in of one, two and three chunks."""
    width = lambda k: min(-(-k // 4) * 4, 32)
    assert {width(k) for k, _ in CONV_CASES} == set(range(4, 33, 4))
    assert {width(k) for k, _ in CONV_CASES if k % 4 and k < 32} == set(range(4, 33, 4))
    assert {-(-k // 32) for k, _ in CONV_CASES} == {1, 2, 3}


@pytest.mark.parametrize("k_in,k_out", CONV_CASES, ids=[f"{a}to{b}" for a, b in CONV_CASES])
@pytest.mark.parametrize("n", [256, 4096])
def test_base_conv_source_on_host_matches_plain(host_libs, k_in, k_out, n):
    primes = tnt.generate_ntt_primes(29, k_in + k_out, n)
    conv = trns.BaseConv.build(primes[:k_in], primes[k_in:], "cpu")
    rng = np.random.default_rng(k_in * 100 + k_out + n)
    for batch in (1, 3):
        z = _residues(rng, primes[:k_in] * batch, (batch * k_in, n)).view(batch, k_in, n)
        z[0, :, :2] = torch.tensor(primes[:k_in], dtype=tm.I32)[:, None] - 1
        for scale in (False, True):
            err, got = run_base_conv(host_libs["mac"], z, conv, scale)
            assert err == 0
            want = trns.base_conv_plain(z, conv.mat_mont, conv.obase,
                                        conv.scale if scale else None)
            torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(got, conv(z), rtol=0, atol=0)


@pytest.mark.parametrize("sms", [132, 114], ids=["sxm", "pcie"])
@pytest.mark.parametrize("k_in,k_out", [(4, 16), (4, 54)], ids=["4to16", "4to54"])
def test_base_conv_source_on_host_splits_output_limbs(host_libs, k_in, k_out, sms):
    """At N=2^16 and B=1 a block takes several output limbs (4 and 11 here on
    132 SMs), as on the main path; at N <= 4096 each block takes one to three."""
    n = 1 << 16
    primes = tnt.generate_ntt_primes(29, k_in + k_out, n)
    conv = trns.BaseConv.build(primes[:k_in], primes[k_in:], "cpu")
    z = _residues(np.random.default_rng(k_out), primes[:k_in], (k_in, n))
    for scale in (False, True):
        err, got = run_base_conv(host_libs["mac"], z, conv, scale, sms)
        assert err == 0
        torch.testing.assert_close(got, trns.base_conv_plain(
            z, conv.mat_mont, conv.obase, conv.scale if scale else None), rtol=0, atol=0)


def test_base_conv_source_rejects_a_row_wider_than_shared_memory(host_libs):
    """A k_in whose one matrix row and scale table outgrow the 48 KB of shared
    memory is refused before anything is read."""
    z = torch.zeros((4, 256), dtype=tm.I32)
    assert host_libs["mac"](z.data_ptr(), z.data_ptr(), z.data_ptr(), z.data_ptr(),
                            z.data_ptr(), z.data_ptr(), None, 1, 4000, 1, 256, SMS, None) != 0


def _chain(k, p, q_bits):
    """A DivRoundChain over k Q primes of q_bits bits and p 30-bit special
    primes, built the way the contexts build their encryption chains.  At
    q_bits = 30 the special primes are the p largest 30-bit primes and the Q
    primes the next k, so every product of the folded sum nears 2^60."""
    n = 4096
    if q_bits == 30:
        primes = tnt.generate_ntt_primes(30, p + k, n)
        q, specials = primes[p:], primes[:p]
    else:
        q = tnt.generate_ntt_primes(q_bits, k, n)
        specials = tnt.generate_ntt_primes(30, p, n)
    stages, remaining = [], q + specials
    for sp in reversed(specials):
        remaining = remaining[:-1]
        stages.append(trns.DivRoundLastq.build(remaining, sp, "cpu"))
    return trns.DivRoundChain.build(stages), q + specials


def run_div_round(fn, x, chain):
    """The host-compiled K6 on CPU tensors, with the C arguments div_round_cuda
    passes.  Returns (error code, output)."""
    p, k, n = len(chain), chain.k, x.shape[-1]
    out = torch.empty(x.shape[:-2] + (k, n), dtype=tm.I32)
    err = fn(x.data_ptr(), out.data_ptr(), chain.tab.data_ptr(), x.numel() // ((k + p) * n),
             k, p, n, None)
    return err, out


# (k, p, q_bits): BFV's p = 1, the main path's p = 4 and depth 48's p = 6 at k = 12
# and 48, and every p from 2 to 16 once more (p = 15 and 16 reduce the folded sum
# midway), at k of one partial chunk of K6's 8 Q limbs a block and of several with
# a partial last one; q_bits = 30 puts every prime just under 2^30
DIV_CASES = [(1, 1, 29), (12, 1, 29), (30, 1, 29), (1, 4, 29), (12, 4, 29), (48, 4, 28),
             (1, 6, 29), (12, 6, 28), (48, 6, 28), (5, 8, 29), (40, 16, 28), (3, 2, 30),
             (9, 3, 29), (17, 5, 30), (2, 7, 29), (23, 9, 28), (7, 10, 30), (11, 11, 29),
             (13, 12, 28), (33, 13, 29), (6, 14, 30), (19, 15, 30), (47, 16, 30),
             (48, 6, 30)]


def test_div_cases_cover_every_stage_count():
    assert {p for _, p, _ in DIV_CASES} == set(range(1, trns.DIV_ROUND_MAX_STAGES + 1))
    assert {k % 8 for k, _, _ in DIV_CASES} == set(range(8))


@pytest.mark.parametrize("k,p,q_bits", DIV_CASES)
@pytest.mark.parametrize("n", [256, 4096])
def test_div_round_source_on_host_matches_plain(host_libs, k, p, q_bits, n):
    chain, primes = _chain(k, p, q_bits)
    rng = np.random.default_rng(k * 10 + p + n)
    batch = 2
    x = _residues(rng, primes * batch, (batch * (k + p), n)).view(batch, k + p, n)
    top = torch.tensor(primes, dtype=tm.I32)[:, None] - 1
    x[0, :, :2] = 0          # r = floor(P/2) at every stage
    x[0, :, 2:4] = top       # every residue at its prime's top
    x[1, -1, :3] = top[-1]   # the last special prime's top under random Q limbs
    # the first rounding term at its largest, P_(p-1) - 1, under Q limbs at their top
    x[1, :k, 3:5] = top[:k]
    x[1, -1, 3:5] = int(top[-1]) - primes[-1] // 2
    err, got = run_div_round(host_libs["divround"], x, chain)
    assert err == 0
    torch.testing.assert_close(got, trns.div_round_chain_plain(x, chain), rtol=0, atol=0)
    torch.testing.assert_close(got, chain(x), rtol=0, atol=0)


@pytest.mark.parametrize("k,p", [(3, 1), (12, 4), (29, 1), (48, 6)])
def test_div_round_source_on_host_takes_a_partial_block(host_libs, k, p):
    """N = 388, no multiple of the 32 columns of a group: the last block's groups
    hold 4 columns or none (a block takes 1, 2 or 8 groups of 32 columns as k
    gives 8, 4 or 1 warps to each), in both modes; an N that is no multiple of
    4 (K6 copies 16 bytes at a time) is refused."""
    n = 388
    for exact in (False, True):
        chain, primes = (_exact_chain(k, p, 29, 65537) if exact else _chain(k, p, 29))
        x = _residues(np.random.default_rng(k + p), primes * 2, (2 * (k + p), n)).view(2, k + p, n)
        err, got = run_div_round(host_libs["div_exact_t" if exact else "div_round"], x, chain)
        assert err == 0
        torch.testing.assert_close(got, trns.div_round_chain_plain(x, chain), rtol=0, atol=0)
    err, _ = run_div_round(host_libs["div_round"], x[..., :n - 2].contiguous(), chain)
    assert err != 0


def test_div_round_source_on_host_runs_a_long_chain_in_pieces(host_libs):
    """A chain of 20 stages runs as div_round_cuda runs it: a piece of 16 stages,
    then one of 4, each a launch, equal to the whole chain's stage loop."""
    chain, primes = _chain(6, 20, 29)
    assert [len(c) for c in chain.pieces] == [16, 4]
    n = 256
    x = _residues(np.random.default_rng(20), primes * 2, (2 * 26, n)).view(2, 26, n)
    got = x
    for piece in chain.pieces:
        err, got = run_div_round(host_libs["divround"], got, piece)
        assert err == 0
    torch.testing.assert_close(got, trns.div_round_chain_plain(x, chain), rtol=0, atol=0)


@pytest.mark.parametrize("p", [7, 10, 15, 16])
def test_div_round_source_on_host_reduces_the_folded_sum_midway(host_libs, p):
    """A table built by hand, with every folded constant at q - 1 and every
    rounding term at P_s - 1 (the special chain's words zero, the special words
    0 and floor(P_s/2) replaced by P_s - 1): x A + sum r_s B + C passes 2^64 at
    p = 16, so only its reduction after the fifteenth product keeps the result,
    and from p = 7 on it leaves the REDC above 3q unless its high word is
    reduced first; the kernel must give (x A + sum r_s B + C) 2^-32 mod q, in
    both of its kernels (k = 3 and 20 Q limbs)."""
    for k in (3, 20):
        _check_folded_sum_at_its_top(host_libs, p, k)


def _check_folded_sum_at_its_top(host_libs, p, k):
    n = 256
    primes = tnt.generate_ntt_primes(30, p + k, 4096)
    q, specials = primes[p:], primes[:p]
    lw = -(-(p + 5) // 4) * 4
    head = specials + [s - 1 for s in specials]
    head += [0] * (-len(head) % 4)
    limbs = np.zeros((k, lw), np.uint32)
    for j, qj in enumerate(q):
        limbs[j, :p + 5] = [qj, tm.mont_pinv(qj), tm.barrett_mu(qj)] + [qj - 1] * (p + 2)
    tab = tm.u32_to_i32(np.concatenate([np.array(head, np.uint32),
                                        np.zeros(4 * (p - 1) ** 2, np.uint32), limbs.ravel()]))
    x = torch.zeros((1, k + p, n), dtype=tm.I32)
    x[0, :k] = torch.tensor(q, dtype=tm.I32)[:, None] - 1
    out = torch.empty((1, k, n), dtype=tm.I32)
    assert host_libs["divround"](x.data_ptr(), out.data_ptr(), tab.data_ptr(), 1, k, p, n,
                                 None) == 0
    for j, qj in enumerate(q):
        total = (qj - 1) * (qj - 1) + sum((ps - 1) * (qj - 1) for ps in specials) + qj - 1
        assert (total >= 1 << 64) == (p == 16)
        assert set(out[0, j].tolist()) == {total * pow(1 << 32, -1, qj) % qj}


def test_div_round_source_rejects_more_than_sixteen_stages(host_libs):
    chain, primes = _chain(2, 6, 29)
    x = torch.zeros((9, 256), dtype=tm.I32)
    out = torch.empty((2, 256), dtype=tm.I32)
    assert host_libs["divround"](x.data_ptr(), out.data_ptr(), chain.tab.data_ptr(), 1, 2, 17,
                                 256, None) != 0


def _exact_chain(k, p, q_bits, t):
    """A chain of p DivExactT stages over k Q primes of q_bits bits and p 30-bit
    special primes (BGV's encryption chain when p = 1), plain modulus t."""
    n = 4096
    q = tnt.generate_ntt_primes(q_bits, k, n)
    specials = tnt.generate_ntt_primes(30, p, n)
    stages, remaining = [], q + specials
    for sp in reversed(specials):
        remaining = remaining[:-1]
        stages.append(trns.DivExactT.build(remaining, sp, t, "cpu"))
    return trns.DivRoundChain.build(stages), q + specials


@pytest.mark.parametrize("k,p,q_bits", [(1, 1, 29), (4, 1, 29), (29, 1, 29), (12, 3, 28),
                                        (5, 16, 29)])
@pytest.mark.parametrize("n", [256, 4096])
def test_div_exact_t_source_on_host_matches_plain(host_libs, k, p, q_bits, n):
    """K6's t-exact mode (BGV's ÷P and mod switch) against the plain stage loop,
    with columns whose centered v is 0, floor(q_last/2) (the largest kept
    positive), floor(q_last/2) + 1 (the first negative) and q_last - 1."""
    t = tnt.generate_ntt_primes(20, 1, 4096)[0]
    chain, primes = _exact_chain(k, p, q_bits, t)
    assert chain.exact_t
    rng = np.random.default_rng(k * 10 + p + n + 7)
    x = _residues(rng, primes * 2, (2 * (k + p), n)).view(2, k + p, n)
    ql = primes[-1]
    for col, v in enumerate((0, ql // 2, ql // 2 + 1, ql - 1)):
        x[1, -1, col] = (-t * v) % ql      # v = [-x_last t^-1]_{q_last}
    x[0, :, :2] = torch.tensor(primes, dtype=tm.I32)[:, None] - 1
    err, got = run_div_round(host_libs["div_exact_t"], x, chain)
    assert err == 0
    want = trns.div_round_chain_plain(x, chain)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(got, chain(x), rtol=0, atol=0)
    # the rounding mode over the same primes computes another function: it must differ
    stages, remaining = [], list(primes)
    for sp in reversed(primes[k:]):
        remaining = remaining[:-1]
        stages.append(trns.DivRoundLastq.build(remaining, sp, "cpu"))
    err, other = run_div_round(host_libs["div_round"], x, trns.DivRoundChain.build(stages))
    assert err == 0 and not torch.equal(other, want)
