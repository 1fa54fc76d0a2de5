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
//
// A transform sharded over D ranks (parallel/ntt_sharded.py) runs the same two passes
// apart, with an all-to-all between them: hf_ntt_pass launches one pass on one rank's
// block of columns.  The SPLIT instance of each pass body reads and writes the
// exchange buffer's layout (its chunk for rank j holds what rank j needs, so the
// all-to-all moves equal contiguous chunks and nothing is transposed outside the
// kernel) and takes its block's offset into tw_mat / itw_mat; hf_ntt runs the other
// instance, the whole-row transform, whose addressing has no run-time term.

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
  // One pass of a sharded transform (hf_ntt_pass; unused by hf_ntt): log2 of the ranks
  // D, the words of one rank's chunk of the exchange buffer, and the offset of this
  // rank's block in tw_mat / itw_mat.
  int ld;
  size_t chunk;
  size_t moff;
};

// Forward pass 1, block = row << kLogTilesA | tile: columns [c0, c0 + C) of the row
// viewed as (n1, n2), merged CT, the cross twiddle tw_mat, and the transposed write to
// the scratch row viewed as (n2, n1), where the tile's columns are consecutive rows:
// one contiguous run of C*n1 words.
// SPLIT (hf_ntt_pass): a row is one rank's block of W = n2/D columns, and the write goes
// to the exchange buffer (D, rows, W, n1/D), reduced to [0, p): point r of a column to
// the chunk of rank r / (n1/D).
template <int L1, int L2, bool SPLIT>
__global__ void __launch_bounds__(kThreads, 2) ntt_fwd1(const Params P) {
  using Y = Tiles<L1, L2>;
  using Sh = typename Y::A;
  constexpr int n2 = 1 << L2, N = 1 << (L1 + L2);
  const int ld = SPLIT ? P.ld : 0, lw = L2 - ld, lc = L1 - ld, lt = Y::kLogTilesA - ld;
  extern __shared__ __align__(16) u32 sm[];
  u32* x = sm;
  u32* w = sm + Y::kTile;
  u32* wsh = w + Y::kTile;
  uint2* tw = reinterpret_cast<uint2*>(sm + 3 * Y::kTile);
  const int row = blockIdx.x >> lt;
  const int c0 = (blockIdx.x & ((1 << lt) - 1)) << Sh::LC;
  const int l = row % P.L;
  const u32 p = P.p[l];
  const u32* src = P.x + (size_t)row * (N >> ld) + c0;
  const size_t lo = (size_t)l * N + (SPLIT ? P.moff : 0) + c0;
  load_table<1 << L1>(tw, P.t1, P.t1_sh, l);
#pragma unroll
  for (int q = 0; q < Sh::kPer; ++q) {
    const int e = threadIdx.x + q * kThreads;
    const int r = e >> Sh::LC, c = e & (Sh::C - 1), at = Sh::at(r, c);
    x[at] = src[(r << lw) + c];
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
      if constexpr (SPLIT) v[i] = cred(v[i], p);
    }
    put<Sh, false>(v, x, k, col);
  }
  __syncthreads();
  if constexpr (SPLIT) {
    u32* dst = P.tmp + ((size_t)row << (L1 + L2 - 2 * ld)) + ((size_t)c0 << lc);
#pragma unroll
    for (int q = 0; q < Sh::kPer; ++q) {
      const int e = threadIdx.x + q * kThreads;
      const int r = e & (Sh::S - 1), c = e >> L1;
      dst[(r >> lc) * P.chunk + (c << lc) + (r & ((1 << lc) - 1))] = x[Sh::at(r, c)];
    }
  } else {
    u32* dst = P.tmp + (size_t)row * N + (size_t)c0 * Sh::S;
#pragma unroll
    for (int q = 0; q < Sh::kPer; ++q) {
      const int e = threadIdx.x + q * kThreads;
      dst[e] = x[Sh::at(e & (Sh::S - 1), e >> L1)];
    }
  }
}

// Forward pass 2, block = row << kLogTilesB | tile: columns [c0, c0 + C) of the scratch
// row viewed as (n2, n1), cyclic GS, reduction to [0, p), and the same positions of
// the output.  SPLIT: the scratch is the exchange buffer (D, rows, n2/D, C = n1/D) as it
// arrived, point r of a column in the chunk of rank r / (n2/D), and the output one
// rank's block (rows, n2, C).
template <int L1, int L2, bool SPLIT>
__global__ void __launch_bounds__(kThreads, 2) ntt_fwd2(const Params P) {
  using Y = Tiles<L1, L2>;
  using Sh = typename Y::B;
  constexpr int n1 = 1 << L1, N = 1 << (L1 + L2);
  const int ld = SPLIT ? P.ld : 0, lw = L2 - ld, lc = L1 - ld, lt = Y::kLogTilesB - ld;
  extern __shared__ __align__(16) u32 sm[];
  u32* x = sm;
  uint2* tw = reinterpret_cast<uint2*>(sm + Y::kTile);
  const int row = blockIdx.x >> lt;
  const int c0 = (blockIdx.x & ((1 << lt) - 1)) << Sh::LC;
  const int l = row % P.L;
  const u32 p = P.p[l];
  const size_t off = (size_t)row * (N >> ld) + c0;
  load_table<1 << L2>(tw, P.t2, P.t2_sh, l);
#pragma unroll
  for (int q = 0; q < Sh::kPer; ++q) {
    const int e = threadIdx.x + q * kThreads;
    const int r = e >> Sh::LC, c = e & (Sh::C - 1);
    if constexpr (SPLIT)
      x[Sh::at(r, c)] = P.tmp[((size_t)row << (L1 + L2 - 2 * ld)) + (r >> lw) * P.chunk +
                              ((r & ((1 << lw) - 1)) << lc) + c0 + c];
    else
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
    P.out[off + (r << lc) + c] = x[Sh::at(r, c)];
  }
}

// Inverse pass 1, block = row << kLogTilesB | tile: columns [c0, c0 + C) of the row
// viewed as (n2, n1), cyclic CT, and the write with itw_mat to the scratch row viewed
// as (n1, n2) straight from registers: the thread's value i at row c0 + col, column
// k + T*i there, T consecutive words a column.  SPLIT: a row is one rank's block (n2,
// C = n1/D), and the write goes to the exchange buffer (D, rows, C, W = n2/D), reduced to
// [0, p): point j of a column to the chunk of rank j / W.
template <int L1, int L2, bool SPLIT>
__global__ void __launch_bounds__(kThreads, 2) ntt_inv1(const Params P) {
  using Y = Tiles<L1, L2>;
  using Sh = typename Y::B;
  constexpr int n2 = 1 << L2, N = 1 << (L1 + L2);
  const int ld = SPLIT ? P.ld : 0, lw = L2 - ld, lc = L1 - ld, lt = Y::kLogTilesB - ld;
  extern __shared__ __align__(16) u32 sm[];
  u32* x = sm;
  uint2* tw = reinterpret_cast<uint2*>(sm + Y::kTile);
  const int row = blockIdx.x >> lt;
  const int c0 = (blockIdx.x & ((1 << lt) - 1)) << Sh::LC;
  const int l = row % P.L;
  const u32 p = P.p[l];
  const u32* src = P.x + (size_t)row * (N >> ld) + c0;
  load_table<n2>(tw, P.t2, P.t2_sh, l);
#pragma unroll
  for (int q = 0; q < Sh::kPer; ++q) {
    const int e = threadIdx.x + q * kThreads;
    const int r = e >> Sh::LC, c = e & (Sh::C - 1);
    x[Sh::at(r, c)] = src[(r << lc) + c];
  }
  __syncthreads();
  if (threadIdx.x >= Sh::kActive) return;
  const int k = threadIdx.x & (Sh::T - 1), col = threadIdx.x >> Sh::LT;
  u32 v[kVals];
  get<Sh, false>(v, x, k, col);
  column_inv<kCyclicCT, Sh>(v, x, tw, k, col, p);
  const int g = (c0 + col) * n2 + k;
  const size_t mo = (size_t)l * N + (SPLIT ? P.moff : 0) + g;
  const u32* im = P.mat + mo;
  const u32* im_sh = P.mat_sh + mo;
  if constexpr (SPLIT) {
    u32* dst = P.tmp + ((size_t)row << (L1 + L2 - 2 * ld)) + ((size_t)(c0 + col) << lw);
#pragma unroll
    for (int i = 0; i < kVals; ++i) {
      const int j = k + (i << Sh::LT);
      dst[(j >> lw) * P.chunk + (j & ((1 << lw) - 1))] =
          cred(shoup_lazy(v[i], im[i << Sh::LT], im_sh[i << Sh::LT], p), p);
    }
  } else {
    u32* dst = P.tmp + (size_t)row * N + g;
#pragma unroll
    for (int i = 0; i < kVals; ++i)
      dst[i << Sh::LT] = shoup_lazy(v[i], im[i << Sh::LT], im_sh[i << Sh::LT], p);
  }
}

// Inverse pass 2, block = row << kLogTilesA | tile: columns [c0, c0 + C) of the scratch
// row viewed as (n1, n2), merged GS, reduction to [0, p), and the same positions of
// the output.  SPLIT: the scratch is the exchange buffer (D, rows, C = n1/D, W = n2/D) as
// it arrived, point r of a column in the chunk of rank r / C, and the output one rank's
// block (rows, n1, W).
template <int L1, int L2, bool SPLIT>
__global__ void __launch_bounds__(kThreads, 2) ntt_inv2(const Params P) {
  using Y = Tiles<L1, L2>;
  using Sh = typename Y::A;
  constexpr int n2 = 1 << L2, N = 1 << (L1 + L2);
  const int ld = SPLIT ? P.ld : 0, lw = L2 - ld, lc = L1 - ld, lt = Y::kLogTilesA - ld;
  extern __shared__ __align__(16) u32 sm[];
  u32* x = sm;
  uint2* tw = reinterpret_cast<uint2*>(sm + Y::kTile);
  const int row = blockIdx.x >> lt;
  const int c0 = (blockIdx.x & ((1 << lt) - 1)) << Sh::LC;
  const int l = row % P.L;
  const u32 p = P.p[l];
  const size_t off = (size_t)row * (N >> ld) + c0;
  load_table<1 << L1>(tw, P.t1, P.t1_sh, l);
#pragma unroll
  for (int q = 0; q < Sh::kPer; ++q) {
    const int e = threadIdx.x + q * kThreads;
    const int r = e >> Sh::LC, c = e & (Sh::C - 1);
    if constexpr (SPLIT)
      x[Sh::at(r, c)] = P.tmp[((size_t)row << (L1 + L2 - 2 * ld)) + (r >> lc) * P.chunk +
                              ((r & ((1 << lc) - 1)) << lw) + c0 + c];
    else
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
    P.out[off + (r << lw) + c] = x[Sh::at(r, c)];
  }
}

// Whether a rank's block of a row split over 2^ld ranks is whole tiles of both passes.
template <int L1, int L2>
bool whole_tiles(int ld) {
  return ld <= Tiles<L1, L2>::kLogTilesA && ld <= Tiles<L1, L2>::kLogTilesB;
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
        ntt_fwd1<L1, L2, false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(three));
    if (err != cudaSuccess) return static_cast<int>(err);
    ntt_fwd1<L1, L2, false><<<ga, kThreads, three, st>>>(P);
    ntt_fwd2<L1, L2, false><<<gb, kThreads, one, st>>>(P);
  } else {
    ntt_inv1<L1, L2, false><<<gb, kThreads, one, st>>>(P);
    ntt_inv2<L1, L2, false><<<ga, kThreads, one, st>>>(P);
  }
  return static_cast<int>(cudaGetLastError());
}

// One pass of a sharded transform over blocks of 1/D of each row, D = 2^ld; only whole
// tiles, else cudaErrorInvalidValue.
template <int L1, int L2>
int launch_pass(int inverse, int pass, const Params& P, int rows, cudaStream_t st) {
  using Y = Tiles<L1, L2>;
  if (!whole_tiles<L1, L2>(P.ld)) return cudaErrorInvalidValue;
  constexpr size_t one = (Y::kTile + 2 * (1 << L2)) * sizeof(u32);
  constexpr size_t three = (3 * Y::kTile + 2 * (1 << L1)) * sizeof(u32);
  const dim3 ga(rows << (Y::kLogTilesA - P.ld)), gb(rows << (Y::kLogTilesB - P.ld));
  if (!inverse && pass == 1) {
    const cudaError_t err = cudaFuncSetAttribute(
        ntt_fwd1<L1, L2, true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(three));
    if (err != cudaSuccess) return static_cast<int>(err);
    ntt_fwd1<L1, L2, true><<<ga, kThreads, three, st>>>(P);
  } else if (!inverse) {
    ntt_fwd2<L1, L2, true><<<gb, kThreads, one, st>>>(P);
  } else if (pass == 1) {
    ntt_inv1<L1, L2, true><<<gb, kThreads, one, st>>>(P);
  } else {
    ntt_inv2<L1, L2, true><<<ga, kThreads, one, st>>>(P);
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

// One pass of a transform whose rows are split over D = d ranks (the sharded four-step
// NTT of parallel/ntt_sharded.py, with the exchange between the two passes), on rank
// `rank`'s block of each of `rows` rows (row r uses limb r % L).  Layouts, C = n1/D and
// W = n2/D, every buffer contiguous:
//   forward pass 1: x (rows, n1, W), columns [rank*W, rank*W + W) of the (n1, n2) view
//                   -> out (D, rows, W, C): chunk j holds rows [j*C, j*C + C) of the
//                   block, transposed, for rank j;
//   forward pass 2: x (D, rows, W, C), chunk j from rank j -> out (rows, n2, C), columns
//                   [rank*C, rank*C + C) of the (n2, n1) output view;
//   inverse pass 1: x (rows, n2, C), that block -> out (D, rows, C, W): chunk j holds
//                   rows [j*W, j*W + W), transposed, for rank j;
//   inverse pass 2: x (D, rows, C, W), chunk j from rank j -> out (rows, n1, W).
// So an all-to-all of equal chunks (torch.distributed.all_to_all_single) between the
// two passes is the whole exchange: no transpose outside the kernel.  Pass 1 writes
// residues reduced to [0, p).  Tables as for hf_ntt.  Takes only D whose blocks are
// whole tiles: D <= 16 at N = 2^16, 8 at 2^15, 4 at 2^14, 2 at 2^13, 1 below.  Returns
// cudaErrorInvalidValue for another (N, D), a D that is no power of two, a rank
// outside [0, D), a pass other than 1 or 2, rows < 1 or L < 1, else
// cudaGetLastError().
extern "C" int hf_ntt_pass(int inverse, int pass, const void* x, void* out, int rows,
                           int L, int n1, int n2, int d, int rank, const void* p,
                           const void* mat, const void* mat_sh, const void* t1,
                           const void* t1_sh, const void* t2, const void* t2_sh,
                           void* stream) {
  auto c = [](const void* v) { return static_cast<const u32*>(v); };
  const int l1 = ilog2(n1), l2 = ilog2(n2), ld = ilog2(d);
  if (rows < 1 || L < 1 || n1 != 1 << l1 || n2 != 1 << l2 || d != 1 << ld || rank < 0 ||
      rank >= d || ld > l1 || (pass != 1 && pass != 2))
    return cudaErrorInvalidValue;
  const size_t chunk = (size_t)rows << (l1 + l2 - 2 * ld);
  const size_t moff = inverse ? (size_t)rank << (l1 - ld + l2) : (size_t)rank << (l2 - ld);
  const bool first = pass == 1;
  const Params P{first ? c(x) : nullptr, first ? static_cast<u32*>(out) : const_cast<u32*>(c(x)),
                 first ? nullptr : static_cast<u32*>(out), c(p), c(mat), c(mat_sh), c(t1),
                 c(t1_sh), c(t2), c(t2_sh), L, ld, chunk, moff};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (l1 * 16 + l2) {
    case 4 * 16 + 4: return launch_pass<4, 4>(inverse, pass, P, rows, st);
    case 4 * 16 + 5: return launch_pass<4, 5>(inverse, pass, P, rows, st);
    case 5 * 16 + 5: return launch_pass<5, 5>(inverse, pass, P, rows, st);
    case 5 * 16 + 6: return launch_pass<5, 6>(inverse, pass, P, rows, st);
    case 6 * 16 + 6: return launch_pass<6, 6>(inverse, pass, P, rows, st);
    case 6 * 16 + 7: return launch_pass<6, 7>(inverse, pass, P, rows, st);
    case 7 * 16 + 7: return launch_pass<7, 7>(inverse, pass, P, rows, st);
    case 7 * 16 + 8: return launch_pass<7, 8>(inverse, pass, P, rows, st);
    case 8 * 16 + 8: return launch_pass<8, 8>(inverse, pass, P, rows, st);
    default: return cudaErrorInvalidValue;
  }
}
