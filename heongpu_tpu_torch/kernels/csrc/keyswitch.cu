// K5: the fused Method-II keyswitch core for Hopper (sm_90a).
//
// Replaces the TPU kernel heongpu_tpu/ops/keyswitch_pallas.py::keyswitch2_fused
// (_kernel, _fold_mac).  For each output limb l < kqp of the level's Q*P basis and
// c in {0, 1}:
//   out[c, l] = INTT_l( fold( sum_j NTT_l( fold( sum_t z[g_j,t] * mat[j*a+t, l] ) )
//                                  * k_c[j, l] ) )
// where fold is the exact REDC of a 64-bit sum (X -> X*2^-32 mod p), z (ka, N) the
// scaled digits, mat (d*a, kqp) the Montgomery conversion factors (zero rows for a
// short last group, never read), k0/k1 (d, kqp, N) the key halves in the NTT domain
// and Montgomery form, out (2, kqp, N) canonical, coefficient domain.  Every sum is
// exact and every result canonical, so it equals the plain composition
// (ops/keyswitch_fused.py::keyswitch2_fused_core_plain) and the staged path bit for
// bit.  The MAC folds each digit's product at once and adds the canonical terms mod
// p: the same residue as one fold of the lazy 64-bit sum.
//
// Why the TPU design does not carry over.  The Pallas grid is one program per output
// limb with the whole 2^16-word row in VMEM: 16 programs would fill 16 of 132 SMs,
// and a 256 KB row is above the 227 KB a block may hold (K1's note, ntt.cu).
//
// Design.  The transform's own structure gives the fusion: in K1's four-step layout
// the forward transform's second pass, the pointwise MAC and the inverse's first
// pass all act on the same columns of the (N2, N1) view.  One cooperative launch
// runs three phases, each block looping over work items, with a grid-wide barrier
// (cooperative_groups grid sync) between them:
//   A  per (digit j, limb l, column tile of the (N1, N2) view): build the digit
//      tile from z and mat (exact 64-bit sum, one fold), forward pass 1 (merged CT
//      stages, tw_mat) and the transposed write to scratch s1 (d, kqp, N);
//   B  per (limb l, column tile of the (N2, N1) view): for each digit, forward pass
//      2 (cyclic GS stages), reduction to [0, p), and the MAC with k0[j, l] and
//      k1[j, l] into two canonical accumulators in shared memory; then for each
//      half the inverse pass 1 (cyclic CT stages) and the transposed write with
//      itw_mat to scratch s2 (2, kqp, N);
//   C  per (half, limb, column tile): inverse pass 2 (merged GS stages) to out.
// The stage and pass bodies are K1's (ntt_common.cuh).  The digits in the NTT domain
// never reach device memory: the staged route (K2 base_conv, K1 forward, K2
// mac_keys, K1 inverse) writes and reads them twice.  s1 and s2 (12.6 + 8.4 MB at
// N = 2^16, kqp = 16, d = 3) stay in the 50 MB L2; the key rows are read once.
// The grid is the occupancy limit times the SM count; a cooperative launch refused
// for its size returns its error, which the wrapper raises.
//
// What bounds it on this card: the work and how it spreads, not the bytes.  At
// N = 2^16, kqp = 16, d = 3 the call must move ~54 MB (keys 25.2, twiddle matrices
// 16.8, output 8.4, z 3.1: 16 us at 3.35 TB/s) and runs 80 row transforms of 16 Shoup
// butterfly stages plus the digit build and the MAC (~0.4 G int32 ops: ~24 us at
// ~16.7 T int32 ops/s); a barrier per stage and the spread of the work items over
// the SMs set its time.  Phase B holds a limb's serial chain (three digits' pass 2,
// the MAC, two inverse passes) per tile, so its tiles are narrower (8 columns:
// kqp * N1 / 8 = 512 items at the bench shape, for ~5 resident blocks per SM) than
// those of phases A and C (32 columns, as K1).  Its index math (run-time division)
// and the barrier per stage are where later work starts.

#include <cooperative_groups.h>

#include "ntt_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTile = 32;   // columns per tile of phases A and C, as K1
constexpr int kMaxTileB = 8;   // columns per tile of phase B: 4x the items of a 32-wide tile

struct Params {
  const u32* z;     // (ka, N)
  const u32* mat;   // (d*alpha, kqp)
  const u32* k0;    // (d, kqp, N)
  const u32* k1;
  u32* s1;          // (d, kqp, N) scratch: forward pass 1 of every digit
  u32* s2;          // (2, kqp, N) scratch: inverse pass 1 of both halves
  u32* out;         // (2, kqp, N)
  int ka, kqp, d, alpha, n1, n2, log1, log2, C, Cb;
  const u32 *p, *pinv, *mu;
  const u32 *tw_mat, *tw_mat_sh, *itw_mat, *itw_mat_sh;   // (kqp, N)
  const u32 *tw1p, *tw1p_sh, *tw2p, *tw2p_sh;              // (kqp, n1), (kqp, n2)
  const u32 *itw1p, *itw1p_sh, *itw2p, *itw2p_sh;
};

// Phase A, item = (j*kqp + l) * (n2/C) + tile.
__device__ void phase_a(const Params& P, u32* sm, int item) {
  const int C = P.C, pitch = C + 1, n1 = P.n1, n2 = P.n2;
  const int tiles = n2 / C;
  const int c0 = (item % tiles) * C;
  const int row = item / tiles;
  const int j = row / P.kqp, l = row - j * P.kqp;
  const size_t N = (size_t)n1 * n2;
  u32* tile = sm;
  u32* twl = sm + n1 * pitch;
  u32* twl_sh = twl + n1;
  const u32 p = P.p[l], pinv = P.pinv[l], mu = P.mu[l];
  int terms = P.ka - j * P.alpha;            // a short last group has fewer
  if (terms > P.alpha) terms = P.alpha;
  const u32* zj = P.z + (size_t)j * P.alpha * N;
  const u32* mj = P.mat + (size_t)j * P.alpha * P.kqp + l;
  load_twiddles(twl, twl_sh, P.tw1p, P.tw1p_sh, l, n1);
  for (int i = threadIdx.x; i < n1 * C; i += blockDim.x) {
    const int r = i / C, c = i - (i / C) * C;
    const size_t pos = (size_t)r * n2 + c0 + c;
    u64 acc = 0;
    for (int t = 0; t < terms; ++t) acc += (u64)zj[(size_t)t * N + pos] * mj[t * P.kqp];
    tile[r * pitch + c] = fold(acc, p, pinv, mu);
  }
  __syncthreads();
  pass1_tile<false>(tile, n1, P.log1, n2, C, c0, twl, twl_sh, P.tw_mat + l * N,
                    P.tw_mat_sh + l * N, p, P.s1 + (size_t)row * N);
  __syncthreads();   // the block's next item reuses the shared memory
}

// Phase B, item = l * (n1/Cb) + tile.  Shared memory: tile n2*(Cb+1), four stage
// tables of n2, two accumulators of n2*Cb.
__device__ void phase_b(const Params& P, u32* sm, int item) {
  const int C = P.Cb, pitch = C + 1, n1 = P.n1, n2 = P.n2;
  const int tiles = n1 / C;
  const int c0 = (item % tiles) * C;
  const int l = item / tiles;
  const size_t N = (size_t)n1 * n2;
  const size_t LN = (size_t)P.kqp * N;
  const int E = n2 * C;
  u32* tile = sm;
  u32* tw = sm + n2 * pitch;
  u32* tw_sh = tw + n2;
  u32* itw = tw_sh + n2;
  u32* itw_sh = itw + n2;
  u32* acc0 = itw_sh + n2;
  u32* acc1 = acc0 + E;
  const u32 p = P.p[l], pinv = P.pinv[l], mu = P.mu[l];
  load_twiddles(tw, tw_sh, P.tw2p, P.tw2p_sh, l, n2);
  load_twiddles(itw, itw_sh, P.itw2p, P.itw2p_sh, l, n2);
  for (int j = 0; j < P.d; ++j) {
    const size_t off = (size_t)j * LN + (size_t)l * N;
    for (int i = threadIdx.x; i < E; i += blockDim.x) {
      const int r = i / C, c = i - (i / C) * C;
      tile[r * pitch + c] = P.s1[off + (size_t)r * n1 + c0 + c];
    }
    __syncthreads();
    column_stages<kCyclicGS>(tile, n2, P.log2, C, pitch, tw, tw_sh, p);
    for (int i = threadIdx.x; i < E; i += blockDim.x) {
      const int r = i / C, c = i - (i / C) * C;
      const size_t pos = off + (size_t)r * n1 + c0 + c;
      const u64 v = csub(tile[r * pitch + c], p);   // the digit's NTT value, < p
      const u32 m0 = fold(v * P.k0[pos], p, pinv, mu);
      const u32 m1 = fold(v * P.k1[pos], p, pinv, mu);
      acc0[i] = j ? csub(acc0[i] + m0, p) : m0;
      acc1[i] = j ? csub(acc1[i] + m1, p) : m1;
    }
    __syncthreads();
  }
  for (int half = 0; half < 2; ++half) {
    const u32* acc = half ? acc1 : acc0;
    for (int i = threadIdx.x; i < E; i += blockDim.x) {
      const int r = i / C, c = i - (i / C) * C;
      tile[r * pitch + c] = acc[i];
    }
    __syncthreads();
    pass1_tile<true>(tile, n2, P.log2, n1, C, c0, itw, itw_sh, P.itw_mat + l * N,
                     P.itw_mat_sh + l * N, p, P.s2 + half * LN + l * N);
    __syncthreads();
  }
}

// Phase C, item = (half*kqp + l) * (n2/C) + tile.
__device__ void phase_c(const Params& P, u32* sm, int item) {
  const int C = P.C, tiles = P.n2 / C;
  const int row = item / tiles;
  const int l = row % P.kqp;
  const size_t N = (size_t)P.n1 * P.n2;
  pass2_tile<true>(sm, P.s2 + row * N, P.out + row * N, P.itw1p, P.itw1p_sh, l, P.p[l],
                   P.n1, P.log1, P.n2, C, (item % tiles) * C);
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads) keyswitch2_fused_kernel(const Params P) {
  extern __shared__ u32 sm[];
  cg::grid_group grid = cg::this_grid();
  const int na = P.d * P.kqp * (P.n2 / P.C);
  for (int it = blockIdx.x; it < na; it += gridDim.x) phase_a(P, sm, it);
  grid.sync();
  const int nb = P.kqp * (P.n1 / P.Cb);
  for (int it = blockIdx.x; it < nb; it += gridDim.x) phase_b(P, sm, it);
  grid.sync();
  const int nc = 2 * P.kqp * (P.n2 / P.C);
  for (int it = blockIdx.x; it < nc; it += gridDim.x) phase_c(P, sm, it);
}

}  // namespace

// The fused core on one level: see the note above for the layouts.  The tables are
// NttTables' fields for the level's Q*P basis (p, pinv, mu; tw_mat, itw_mat and
// their Shoup companions; the packed stage tables).  s1 (d, kqp, N) and s2 (2, kqp, N)
// are scratch.  Returns the error of the cooperative launch, else cudaGetLastError().
extern "C" int hf_keyswitch2_fused(
    const void* z, const void* mat, const void* k0, const void* k1, void* s1, void* s2,
    void* out, int ka, int kqp, int d, int alpha, int n1, int n2, const void* p,
    const void* pinv, const void* mu, const void* tw_mat, const void* tw_mat_sh,
    const void* itw_mat, const void* itw_mat_sh, const void* tw1p, const void* tw1p_sh,
    const void* tw2p, const void* tw2p_sh, const void* itw1p, const void* itw1p_sh,
    const void* itw2p, const void* itw2p_sh, void* stream) {
  auto c = [](const void* v) { return static_cast<const u32*>(v); };
  Params P;
  P.z = c(z); P.mat = c(mat); P.k0 = c(k0); P.k1 = c(k1);
  P.s1 = static_cast<u32*>(s1); P.s2 = static_cast<u32*>(s2);
  P.out = static_cast<u32*>(out);
  P.ka = ka; P.kqp = kqp; P.d = d; P.alpha = alpha; P.n1 = n1; P.n2 = n2;
  P.log1 = ilog2(n1); P.log2 = ilog2(n2);
  P.C = n1 < kMaxTile ? n1 : kMaxTile;   // n1 <= n2, so C and Cb divide both
  P.Cb = n1 < kMaxTileB ? n1 : kMaxTileB;
  P.p = c(p); P.pinv = c(pinv); P.mu = c(mu);
  P.tw_mat = c(tw_mat); P.tw_mat_sh = c(tw_mat_sh);
  P.itw_mat = c(itw_mat); P.itw_mat_sh = c(itw_mat_sh);
  P.tw1p = c(tw1p); P.tw1p_sh = c(tw1p_sh); P.tw2p = c(tw2p); P.tw2p_sh = c(tw2p_sh);
  P.itw1p = c(itw1p); P.itw1p_sh = c(itw1p_sh); P.itw2p = c(itw2p);
  P.itw2p_sh = c(itw2p_sh);

  const size_t smem_ac = (size_t)(n1 * (P.C + 1) + 2 * n1) * sizeof(u32);
  const size_t smem_b = (size_t)(n2 * (P.Cb + 1) + 4 * n2 + 2 * n2 * P.Cb) * sizeof(u32);
  const size_t smem = smem_ac > smem_b ? smem_ac : smem_b;
  cudaError_t err = cudaFuncSetAttribute(keyswitch2_fused_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, keyswitch2_fused_kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  // no more blocks than the phase with the most work items has items
  const int na = d * kqp * (n2 / P.C), nb = kqp * (n1 / P.Cb), nc = 2 * kqp * (n2 / P.C);
  const int items = na > nb ? (na > nc ? na : nc) : (nb > nc ? nb : nc);
  const int grid = per_sm * sms < items ? per_sm * sms : items;
  void* args[] = {&P};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(keyswitch2_fused_kernel),
                                    dim3(grid), dim3(kThreads), args, smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
