// Negacyclic four-step NTT / INTT over RNS primes p < 2^30, for Hopper (sm_90a).
//
// Replaces the TPU kernel heongpu_tpu/ops/ntt_pallas.py::ntt_pallas
// (_fwd_kernel / _inv_kernel).  Same algorithm, same tables, same storage
// order (heongpu_tpu_torch/ops/ntt.py): a row of N = N1*N2 residues is viewed
// as an (N1, N2) matrix,
//   forward: merged-negacyclic CT stages down each column (size N1), Shoup
//            cross twiddle tw_mat, transpose, cyclic GS stages down each
//            column of the (N2, N1) matrix (size N2), final reduction;
//   inverse: cyclic CT stages on the (N2, N1) view, transpose, cross twiddle
//            itw_mat (n^-1 psi^-i folded in), merged GS stages, reduction.
// Values stay Harvey-lazy in [0, 2p) between stages; the lazy Shoup product
// a*w - umulhi(a, w_sh)*p in 32-bit wraparound needs 4p < 2^32.
//
// What bounds it on this card: memory traffic and shared-memory latency.  A
// 2^16 row is 256 KB, above the 227 KB a block may hold, so the TPU design
// (whole row resident in VMEM) does not carry over.  Each transform is two
// passes through global memory instead: pass 1 runs the N1-point column
// transforms on an N1 x C column tile in shared memory and writes the tile
// back transposed into a scratch buffer; pass 2 runs the N2-point column
// transforms on N2 x C tiles of that buffer.  The data crosses device memory
// twice per direction (read, write, read, write); at the main-path shapes
// (12..48 rows of 256 KB) the scratch buffer stays in the 50 MB L2.  Tiles
// keep a row pitch of C+1 words so both the column butterflies and the
// transposed accesses hit distinct shared-memory banks.  Per-stage twiddles
// for the block's limb are staged in shared memory once per block.  The stage
// and pass bodies live in ntt_common.cuh, shared with the fused keyswitch K5.

#include "ntt_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTile = 32;   // columns per tile

// Pass 1.  Input row viewed as (R, K) = (N1, N2) forward or (N2, N1) inverse.
// Block (tile, row) loads columns [c0, c0+C) of all R rows, runs the first
// sub-transform down the columns, and writes the tile transposed into the
// scratch row viewed as (K, R) (pass1_tile, ntt_common.cuh).
template <bool INV>
__global__ void __launch_bounds__(kThreads)
ntt_pass1(const u32* __restrict__ x, u32* __restrict__ tmp, const u32* __restrict__ pv,
          const u32* __restrict__ mat, const u32* __restrict__ mat_sh,
          const u32* __restrict__ tw, const u32* __restrict__ tw_sh,
          int L, int R, int logR, int K, int C) {
  extern __shared__ u32 sm[];
  const int pitch = C + 1;
  u32* tile = sm;
  u32* twl = sm + R * pitch;
  u32* twl_sh = twl + R;
  const int row = blockIdx.y;
  const int limb = row % L;
  const int c0 = blockIdx.x * C;
  const size_t N = (size_t)R * K;
  const u32* xr = x + (size_t)row * N;

  load_twiddles(twl, twl_sh, tw, tw_sh, limb, R);
  for (int i = threadIdx.x; i < R * C; i += blockDim.x) {
    const int r = i / C, c = i - (i / C) * C;
    tile[r * pitch + c] = xr[(size_t)r * K + c0 + c];
  }
  __syncthreads();
  pass1_tile<INV>(tile, R, logR, K, C, c0, twl, twl_sh, mat + (size_t)limb * N,
                  mat_sh + (size_t)limb * N, pv[limb], tmp + (size_t)row * N);
}

// Pass 2.  Scratch row viewed as (S, K); block (tile, row) runs the second
// sub-transform on columns [c0, c0+C), reduces to [0, p) and writes the same (S, K)
// positions of the output (pass2_tile, ntt_common.cuh).
template <bool INV>
__global__ void __launch_bounds__(kThreads)
ntt_pass2(const u32* __restrict__ tmp, u32* __restrict__ out, const u32* __restrict__ pv,
          const u32* __restrict__ tw, const u32* __restrict__ tw_sh,
          int L, int S, int logS, int K, int C) {
  extern __shared__ u32 sm[];
  const int row = blockIdx.y;
  const int limb = row % L;
  const size_t N = (size_t)S * K;
  pass2_tile<INV>(sm, tmp + (size_t)row * N, out + (size_t)row * N, tw, tw_sh, limb,
                  pv[limb], S, logS, K, C, blockIdx.x * C);
}

}  // namespace

// One transform of `rows` rows (row r uses limb r % L) of N = n1*n2 residues.
// fwd: mat = tw_mat, t1 = tw1 packed (L, n1), t2 = tw2 packed (L, n2);
// inv: mat = itw_mat, t1 = itw1 packed, t2 = itw2 packed.
// tmp: scratch of the size of x.  Returns cudaGetLastError().
extern "C" int hf_ntt(int inverse, const void* x, void* tmp, void* out, int rows, int L,
                      int n1, int n2, const void* p, const void* mat, const void* mat_sh,
                      const void* t1, const void* t1_sh, const void* t2, const void* t2_sh,
                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int C = n1 < kMaxTile ? n1 : kMaxTile;   // n1 <= n2, so C divides both
  const int log1 = ilog2(n1), log2 = ilog2(n2);
  const u32* X = static_cast<const u32*>(x);
  u32* T = static_cast<u32*>(tmp);
  u32* O = static_cast<u32*>(out);
  const u32* P = static_cast<const u32*>(p);
  const u32* M = static_cast<const u32*>(mat);
  const u32* Msh = static_cast<const u32*>(mat_sh);
  const u32* A = static_cast<const u32*>(t1);
  const u32* Ash = static_cast<const u32*>(t1_sh);
  const u32* B = static_cast<const u32*>(t2);
  const u32* Bsh = static_cast<const u32*>(t2_sh);
  auto smem = [C](int S) { return (size_t)(S * (C + 1) + 2 * S) * sizeof(u32); };
  if (!inverse) {
    // pass 1: (n1, n2) columns, tiles across n2; pass 2: (n2, n1), tiles across n1
    ntt_pass1<false><<<dim3(n2 / C, rows), kThreads, smem(n1), st>>>(
        X, T, P, M, Msh, A, Ash, L, n1, log1, n2, C);
    ntt_pass2<false><<<dim3(n1 / C, rows), kThreads, smem(n2), st>>>(
        T, O, P, B, Bsh, L, n2, log2, n1, C);
  } else {
    ntt_pass1<true><<<dim3(n1 / C, rows), kThreads, smem(n2), st>>>(
        X, T, P, M, Msh, B, Bsh, L, n2, log2, n1, C);
    ntt_pass2<true><<<dim3(n2 / C, rows), kThreads, smem(n1), st>>>(
        T, O, P, A, Ash, L, n1, log1, n2, C);
  }
  return static_cast<int>(cudaGetLastError());
}
