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
// for the block's limb are staged in shared memory once per block.

#include <cstdint>
#include <cuda_runtime.h>

typedef uint32_t u32;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTile = 32;   // columns per tile

__device__ __forceinline__ u32 csub(u32 a, u32 m) { return a >= m ? a - m : a; }

// a*w mod p in [0, 2p) for any 32-bit a, w < p, w_sh = floor(w*2^32/p).
__device__ __forceinline__ u32 shoup_lazy(u32 a, u32 w, u32 w_sh, u32 p) {
  return a * w - __umulhi(a, w_sh) * p;
}

enum Kind { kMergedCT = 0, kCyclicGS = 1, kCyclicCT = 2, kMergedGS = 3 };

// Column butterfly stages on a tile of S rows (pitch `pitch`) and C columns.
// tw / tw_sh: the limb's packed stage table, stage s at [2^(s-1), 2^s).
//  merged stage s: group i < 2^(s-1), span t = S/2^s, pairs (i*2t + j, i*2t + t + j),
//                  twiddle tw[2^(s-1) + i];
//  cyclic stage s: blocks of m = 2^s, pairs (k*m + j, k*m + m/2 + j), twiddle
//                  tw[m/2 + j] indexed by the position j inside the block.
// CT kinds run stages 1..logS, GS kinds logS..1.
template <int KIND>
__device__ void column_stages(u32* tile, int S, int logS, int C, int pitch,
                              const u32* tw, const u32* tw_sh, u32 p) {
  const u32 p2 = p + p;
  const int nb = (S >> 1) * C;
  const bool ct = (KIND == kMergedCT || KIND == kCyclicCT);
  const bool merged = (KIND == kMergedCT || KIND == kMergedGS);
  for (int step = 0; step < logS; ++step) {
    const int s = ct ? step + 1 : logS - step;
    for (int b = threadIdx.x; b < nb; b += blockDim.x) {
      const int col = b % C;
      const int k = b / C;
      int iu, half, widx;
      if (merged) {
        const int t = S >> s;
        const int i = k / t;
        iu = i * 2 * t + (k - i * t);
        half = t;
        widx = (1 << (s - 1)) + i;
      } else {
        const int hm = 1 << (s - 1);
        const int blk = k / hm;
        const int j = k - blk * hm;
        iu = blk * 2 * hm + j;
        half = hm;
        widx = hm + j;
      }
      u32* pu = tile + iu * pitch + col;
      u32* pv = pu + half * pitch;
      const u32 u = *pu, v = *pv, w = tw[widx], wsh = tw_sh[widx];
      if (ct) {
        const u32 tt = shoup_lazy(v, w, wsh, p);
        *pu = csub(u + tt, p2);
        *pv = csub(u + p2 - tt, p2);
      } else {
        *pu = csub(u + v, p2);
        *pv = shoup_lazy(u + p2 - v, w, wsh, p);
      }
    }
    __syncthreads();
  }
}

__device__ void load_twiddles(u32* dst, u32* dst_sh, const u32* tw, const u32* tw_sh,
                              int limb, int S) {
  for (int i = threadIdx.x; i < S; i += blockDim.x) {
    dst[i] = tw[(size_t)limb * S + i];
    dst_sh[i] = tw_sh[(size_t)limb * S + i];
  }
}

// Pass 1.  Input row viewed as (R, K) = (N1, N2) forward or (N2, N1) inverse.
// Block (tile, row) loads columns [c0, c0+C) of all R rows, runs the first
// sub-transform down the columns, and writes the tile transposed into the
// scratch row viewed as (K, R).  Forward applies tw_mat (indexed in the
// (N1, N2) input order) before the transpose; inverse applies itw_mat
// (indexed in the (N1, N2) output order) during the transposed write.
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
  const u32 p = pv[limb];
  const u32* xr = x + (size_t)row * N;
  const u32* mr = mat + (size_t)limb * N;
  const u32* mr_sh = mat_sh + (size_t)limb * N;
  u32* tr = tmp + (size_t)row * N;

  load_twiddles(twl, twl_sh, tw, tw_sh, limb, R);
  for (int i = threadIdx.x; i < R * C; i += blockDim.x) {
    const int r = i / C, c = i - (i / C) * C;
    tile[r * pitch + c] = xr[(size_t)r * K + c0 + c];
  }
  __syncthreads();
  column_stages<INV ? kCyclicCT : kMergedCT>(tile, R, logR, C, pitch, twl, twl_sh, p);
  if (!INV) {
    for (int i = threadIdx.x; i < R * C; i += blockDim.x) {
      const int r = i / C, c = i - (i / C) * C;
      const size_t g = (size_t)r * K + c0 + c;
      tile[r * pitch + c] = shoup_lazy(tile[r * pitch + c], mr[g], mr_sh[g], p);
    }
    __syncthreads();
  }
  // transposed write: scratch row is (K, R); consecutive threads walk r
  for (int i = threadIdx.x; i < R * C; i += blockDim.x) {
    const int c = i / R, r = i - (i / R) * R;
    const size_t g = (size_t)(c0 + c) * R + r;
    u32 v = tile[r * pitch + c];
    if (INV) v = shoup_lazy(v, mr[g], mr_sh[g], p);
    tr[g] = v;
  }
}

// Pass 2.  Scratch row viewed as (S, K); block (tile, row) loads columns
// [c0, c0+C), runs the second sub-transform down the columns, reduces to
// [0, p) and writes the same (S, K) positions of the output.
template <bool INV>
__global__ void __launch_bounds__(kThreads)
ntt_pass2(const u32* __restrict__ tmp, u32* __restrict__ out, const u32* __restrict__ pv,
          const u32* __restrict__ tw, const u32* __restrict__ tw_sh,
          int L, int S, int logS, int K, int C) {
  extern __shared__ u32 sm[];
  const int pitch = C + 1;
  u32* tile = sm;
  u32* twl = sm + S * pitch;
  u32* twl_sh = twl + S;
  const int row = blockIdx.y;
  const int limb = row % L;
  const int c0 = blockIdx.x * C;
  const size_t N = (size_t)S * K;
  const u32 p = pv[limb];
  const u32* tr = tmp + (size_t)row * N;
  u32* orow = out + (size_t)row * N;

  load_twiddles(twl, twl_sh, tw, tw_sh, limb, S);
  for (int i = threadIdx.x; i < S * C; i += blockDim.x) {
    const int r = i / C, c = i - (i / C) * C;
    tile[r * pitch + c] = tr[(size_t)r * K + c0 + c];
  }
  __syncthreads();
  column_stages<INV ? kMergedGS : kCyclicGS>(tile, S, logS, C, pitch, twl, twl_sh, p);
  for (int i = threadIdx.x; i < S * C; i += blockDim.x) {
    const int r = i / C, c = i - (i / C) * C;
    orow[(size_t)r * K + c0 + c] = csub(tile[r * pitch + c], p);
  }
}

int ilog2(int v) {
  int l = 0;
  while ((1 << l) < v) ++l;
  return l;
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
