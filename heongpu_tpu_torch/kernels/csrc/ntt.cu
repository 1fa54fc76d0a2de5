// K1: the negacyclic four-step NTT / INTT over RNS primes p < 2^30, for Hopper (sm_90a).
//
// Replaces the TPU kernel heongpu_tpu/ops/ntt_pallas.py::ntt_pallas (_fwd_kernel /
// _inv_kernel).  Same algorithm, same tables, same storage order
// (heongpu_tpu_torch/ops/ntt.py): a row of N = n1*n2 residues is viewed as an
// (n1, n2) matrix,
//   forward: merged-negacyclic CT stages down each column (size n1), Shoup cross
//            twiddle tw_mat, transpose, cyclic GS stages down each column of the
//            (n2, n1) matrix (size n2), reduction to [0, p);
//   inverse: cyclic CT stages on the (n2, n1) view, transpose, cross twiddle itw_mat
//            (n^-1 psi^-i folded in), merged GS stages, reduction.
// Row r of the input uses limb r % L of the tables.  Values stay Harvey-lazy in
// [0, 2p) between stages; the lazy Shoup product a*w - umulhi(a, w_sh)*p in 32-bit
// wraparound needs 4p < 2^32.
//
// Why the TPU design does not carry over: the Pallas kernel holds a whole row in
// VMEM, and a 2^16 row (256 KB) is above the 227 KB a block may hold.  So each
// transform is two launches through a scratch row: the first pass runs the first
// sub-transform on tiles of columns and writes them transposed, the second runs the
// second sub-transform on tiles of the scratch.  At the main-path shapes (12 to 48
// rows of 256 KB) the scratch stays in the 50 MB L2.
//
// What bounds it on this card: device memory.  A forward transform of 12 rows of
// 2^16 must read the rows and the tw_mat pair (12.6 MB with the output: 3.8 us at
// 3.35 TB/s) and do ~40 M int32 operations (2.4 us at ~16.7 T/s).
//
// Design: the four pass bodies are those of the fused keyswitch K5 (keyswitch.cu),
// built on the column transform of ntt_cols.cuh: a column of up to 256 points in the
// registers of T = S/16 threads of one warp, every stage there, one exchange through
// the warp's own columns of the tile behind a __syncwarp.  Block barriers remain only
// around the coalesced tile copies (two per pass, one in inverse pass 1, which writes
// from registers).  n1 and n2 are template parameters (hf_ntt dispatches on
// (log n1, log n2) over the nine shapes split_n gives for N = 2^8 .. 2^16), so no
// butterfly or element copy divides at run time; a block decodes its row and tile by
// shifts and its limb by one row % L.  A tile holds min(N, 4096) words (16 columns at
// 2^16): 192 blocks a pass at 12 rows, 768 at 48.  Shared memory is one swizzled tile
// and one stage table of (w, w_sh) pairs (forward pass 1 stages the tw_mat tile and
// its Shoup companion beside it: 51,200 bytes at 2^16), and __launch_bounds__(256, 2)
// allows two blocks a SM at no more than 128 registers.

#include "ntt_cols.cuh"   // Cols, Tiles, column_fwd, column_inv; shoup_lazy, Kind

namespace {

struct Params {
  const u32* x;                 // (rows, N) input
  u32* tmp;                     // (rows, N) scratch between the two passes
  u32* out;                     // (rows, N)
  const u32* p;                 // (L,)
  const u32 *mat, *mat_sh;      // (L, N): tw_mat forward, itw_mat inverse
  const u32 *t1, *t1_sh;        // (L, n1) packed stages of the n1-point sub-transform
  const u32 *t2, *t2_sh;        // (L, n2) packed stages of the n2-point sub-transform
  int L;
};

// Forward pass 1, block = row << kLogTilesA | tile: columns [c0, c0 + C) of the row
// viewed as (n1, n2), merged CT, the cross twiddle tw_mat, and the transposed write to
// the scratch row viewed as (n2, n1), where the tile's columns are consecutive rows:
// one contiguous run of C*n1 words.
template <int L1, int L2>
__global__ void __launch_bounds__(kThreads, 2) ntt_fwd1(const Params P) {
  using Y = Tiles<L1, L2>;
  using Sh = typename Y::A;
  constexpr int n2 = 1 << L2, N = 1 << (L1 + L2);
  extern __shared__ __align__(16) u32 sm[];
  u32* x = sm;
  u32* w = sm + Y::kTile;
  u32* wsh = w + Y::kTile;
  uint2* tw = reinterpret_cast<uint2*>(sm + 3 * Y::kTile);
  const int row = blockIdx.x >> Y::kLogTilesA;
  const int c0 = (blockIdx.x & ((1 << Y::kLogTilesA) - 1)) << Sh::LC;
  const int l = row % P.L;
  const u32 p = P.p[l];
  const u32* src = P.x + (size_t)row * N + c0;
  const size_t lo = (size_t)l * N + c0;
  load_table<1 << L1>(tw, P.t1, P.t1_sh, l);
#pragma unroll
  for (int q = 0; q < Sh::kPer; ++q) {
    const int e = threadIdx.x + q * kThreads;
    const int r = e >> Sh::LC, c = e & (Sh::C - 1), at = Sh::at(r, c);
    x[at] = src[r * n2 + c];
    w[at] = P.mat[lo + r * n2 + c];
    wsh[at] = P.mat_sh[lo + r * n2 + c];
  }
  __syncthreads();
  if (threadIdx.x < Sh::kActive) {
    const int k = threadIdx.x & (Sh::T - 1), col = threadIdx.x >> Sh::LT;
    u32 v[kVals];
    get<Sh, true>(v, x, k, col);
    column_fwd<kMergedCT, Sh>(v, x, tw, k, col, p);
#pragma unroll
    for (int i = 0; i < kVals; ++i) {
      const int at = Sh::at(Sh::template pos<false>(k, i), col);
      v[i] = shoup_lazy(v[i], w[at], wsh[at], p);
    }
    put<Sh, false>(v, x, k, col);
  }
  __syncthreads();
  u32* dst = P.tmp + (size_t)row * N + (size_t)c0 * Sh::S;
#pragma unroll
  for (int q = 0; q < Sh::kPer; ++q) {
    const int e = threadIdx.x + q * kThreads;
    dst[e] = x[Sh::at(e & (Sh::S - 1), e >> L1)];
  }
}

// Forward pass 2, block = row << kLogTilesB | tile: columns [c0, c0 + C) of the scratch
// row viewed as (n2, n1), cyclic GS, reduction to [0, p), and the same positions of
// the output.
template <int L1, int L2>
__global__ void __launch_bounds__(kThreads, 2) ntt_fwd2(const Params P) {
  using Y = Tiles<L1, L2>;
  using Sh = typename Y::B;
  constexpr int n1 = 1 << L1, N = 1 << (L1 + L2);
  extern __shared__ __align__(16) u32 sm[];
  u32* x = sm;
  uint2* tw = reinterpret_cast<uint2*>(sm + Y::kTile);
  const int row = blockIdx.x >> Y::kLogTilesB;
  const int c0 = (blockIdx.x & ((1 << Y::kLogTilesB) - 1)) << Sh::LC;
  const int l = row % P.L;
  const u32 p = P.p[l];
  const size_t off = (size_t)row * N + c0;
  load_table<1 << L2>(tw, P.t2, P.t2_sh, l);
#pragma unroll
  for (int q = 0; q < Sh::kPer; ++q) {
    const int e = threadIdx.x + q * kThreads;
    const int r = e >> Sh::LC, c = e & (Sh::C - 1);
    x[Sh::at(r, c)] = P.tmp[off + r * n1 + c];
  }
  __syncthreads();
  if (threadIdx.x < Sh::kActive) {
    const int k = threadIdx.x & (Sh::T - 1), col = threadIdx.x >> Sh::LT;
    u32 v[kVals];
    get<Sh, true>(v, x, k, col);
    column_fwd<kCyclicGS, Sh>(v, x, tw, k, col, p);
#pragma unroll
    for (int i = 0; i < kVals; ++i) v[i] = cred(v[i], p);
    put<Sh, false>(v, x, k, col);
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < Sh::kPer; ++q) {
    const int e = threadIdx.x + q * kThreads;
    const int r = e >> Sh::LC, c = e & (Sh::C - 1);
    P.out[off + r * n1 + c] = x[Sh::at(r, c)];
  }
}

// Inverse pass 1, block = row << kLogTilesB | tile: columns [c0, c0 + C) of the row
// viewed as (n2, n1), cyclic CT, and the write with itw_mat to the scratch row viewed
// as (n1, n2) straight from registers: the thread's value i at row c0 + col, column
// k + T*i there, T consecutive words a column.
template <int L1, int L2>
__global__ void __launch_bounds__(kThreads, 2) ntt_inv1(const Params P) {
  using Y = Tiles<L1, L2>;
  using Sh = typename Y::B;
  constexpr int n1 = 1 << L1, n2 = 1 << L2, N = 1 << (L1 + L2);
  extern __shared__ __align__(16) u32 sm[];
  u32* x = sm;
  uint2* tw = reinterpret_cast<uint2*>(sm + Y::kTile);
  const int row = blockIdx.x >> Y::kLogTilesB;
  const int c0 = (blockIdx.x & ((1 << Y::kLogTilesB) - 1)) << Sh::LC;
  const int l = row % P.L;
  const u32 p = P.p[l];
  const u32* src = P.x + (size_t)row * N + c0;
  load_table<n2>(tw, P.t2, P.t2_sh, l);
#pragma unroll
  for (int q = 0; q < Sh::kPer; ++q) {
    const int e = threadIdx.x + q * kThreads;
    const int r = e >> Sh::LC, c = e & (Sh::C - 1);
    x[Sh::at(r, c)] = src[r * n1 + c];
  }
  __syncthreads();
  if (threadIdx.x >= Sh::kActive) return;
  const int k = threadIdx.x & (Sh::T - 1), col = threadIdx.x >> Sh::LT;
  u32 v[kVals];
  get<Sh, false>(v, x, k, col);
  column_inv<kCyclicCT, Sh>(v, x, tw, k, col, p);
  const int g = (c0 + col) * n2 + k;
  u32* dst = P.tmp + (size_t)row * N + g;
  const u32* im = P.mat + (size_t)l * N + g;
  const u32* im_sh = P.mat_sh + (size_t)l * N + g;
#pragma unroll
  for (int i = 0; i < kVals; ++i)
    dst[i << Sh::LT] = shoup_lazy(v[i], im[i << Sh::LT], im_sh[i << Sh::LT], p);
}

// Inverse pass 2, block = row << kLogTilesA | tile: columns [c0, c0 + C) of the scratch
// row viewed as (n1, n2), merged GS, reduction to [0, p), and the same positions of
// the output.
template <int L1, int L2>
__global__ void __launch_bounds__(kThreads, 2) ntt_inv2(const Params P) {
  using Y = Tiles<L1, L2>;
  using Sh = typename Y::A;
  constexpr int n2 = 1 << L2, N = 1 << (L1 + L2);
  extern __shared__ __align__(16) u32 sm[];
  u32* x = sm;
  uint2* tw = reinterpret_cast<uint2*>(sm + Y::kTile);
  const int row = blockIdx.x >> Y::kLogTilesA;
  const int c0 = (blockIdx.x & ((1 << Y::kLogTilesA) - 1)) << Sh::LC;
  const int l = row % P.L;
  const u32 p = P.p[l];
  const size_t off = (size_t)row * N + c0;
  load_table<1 << L1>(tw, P.t1, P.t1_sh, l);
#pragma unroll
  for (int q = 0; q < Sh::kPer; ++q) {
    const int e = threadIdx.x + q * kThreads;
    const int r = e >> Sh::LC, c = e & (Sh::C - 1);
    x[Sh::at(r, c)] = P.tmp[off + r * n2 + c];
  }
  __syncthreads();
  if (threadIdx.x < Sh::kActive) {
    const int k = threadIdx.x & (Sh::T - 1), col = threadIdx.x >> Sh::LT;
    u32 v[kVals];
    get<Sh, false>(v, x, k, col);
    column_inv<kMergedGS, Sh>(v, x, tw, k, col, p);
#pragma unroll
    for (int i = 0; i < kVals; ++i) v[i] = cred(v[i], p);
    put<Sh, true>(v, x, k, col);
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < Sh::kPer; ++q) {
    const int e = threadIdx.x + q * kThreads;
    const int r = e >> Sh::LC, c = e & (Sh::C - 1);
    P.out[off + r * n2 + c] = x[Sh::at(r, c)];
  }
}

// The two launches of one shape.  Pass 1's tiles cut the input's columns, pass 2's the
// scratch's; forward pass 1 also holds the tw_mat tile pair.
template <int L1, int L2>
int launch(int inverse, const Params& P, int rows, cudaStream_t st) {
  using Y = Tiles<L1, L2>;
  constexpr size_t one = (Y::kTile + 2 * (1 << L2)) * sizeof(u32);      // n2 >= n1
  constexpr size_t three = (3 * Y::kTile + 2 * (1 << L1)) * sizeof(u32);
  const dim3 ga(rows << Y::kLogTilesA), gb(rows << Y::kLogTilesB);
  if (!inverse) {
    const cudaError_t err = cudaFuncSetAttribute(
        ntt_fwd1<L1, L2>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(three));
    if (err != cudaSuccess) return static_cast<int>(err);
    ntt_fwd1<L1, L2><<<ga, kThreads, three, st>>>(P);
    ntt_fwd2<L1, L2><<<gb, kThreads, one, st>>>(P);
  } else {
    ntt_inv1<L1, L2><<<gb, kThreads, one, st>>>(P);
    ntt_inv2<L1, L2><<<ga, kThreads, one, st>>>(P);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One transform of `rows` rows (row r uses limb r % L) of N = n1*n2 residues.
// fwd: mat = tw_mat, t1 = tw1 packed (L, n1), t2 = tw2 packed (L, n2);
// inv: mat = itw_mat, t1 = itw1 packed, t2 = itw2 packed.
// tmp: scratch of the size of x.  Returns cudaErrorInvalidValue for a shape outside
// n1 = 2^4 .. 2^8 with n2 in {n1, 2*n1}, or for rows < 1 or L < 1, else
// cudaGetLastError().
extern "C" int hf_ntt(int inverse, const void* x, void* tmp, void* out, int rows, int L,
                      int n1, int n2, const void* p, const void* mat, const void* mat_sh,
                      const void* t1, const void* t1_sh, const void* t2, const void* t2_sh,
                      void* stream) {
  auto c = [](const void* v) { return static_cast<const u32*>(v); };
  const Params P{c(x), static_cast<u32*>(tmp), static_cast<u32*>(out), c(p), c(mat),
                 c(mat_sh), c(t1), c(t1_sh), c(t2), c(t2_sh), L};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int l1 = ilog2(n1), l2 = ilog2(n2);
  if (rows < 1 || L < 1 || n1 != 1 << l1 || n2 != 1 << l2) return cudaErrorInvalidValue;
  switch (l1 * 16 + l2) {
    case 4 * 16 + 4: return launch<4, 4>(inverse, P, rows, st);
    case 4 * 16 + 5: return launch<4, 5>(inverse, P, rows, st);
    case 5 * 16 + 5: return launch<5, 5>(inverse, P, rows, st);
    case 5 * 16 + 6: return launch<5, 6>(inverse, P, rows, st);
    case 6 * 16 + 6: return launch<6, 6>(inverse, P, rows, st);
    case 6 * 16 + 7: return launch<6, 7>(inverse, P, rows, st);
    case 7 * 16 + 7: return launch<7, 7>(inverse, P, rows, st);
    case 7 * 16 + 8: return launch<7, 8>(inverse, P, rows, st);
    case 8 * 16 + 8: return launch<8, 8>(inverse, P, rows, st);
    default: return cudaErrorInvalidValue;
  }
}
