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
// bit.  The MAC reduces each digit's product at once and adds the canonical terms
// mod p: the same residue as one fold of the lazy 64-bit sum.
//
// Why the TPU design does not carry over.  The Pallas grid is one program per output
// limb with the whole 2^16-word row in VMEM: 16 programs would fill 16 of 132 SMs,
// and a 256 KB row is above the 227 KB a block may hold (K1's note, ntt.cu).
//
// Structure.  In K1's four-step layout (N = n1*n2, ops/ntt.py::split_n) the forward
// transform's second pass, the pointwise MAC and the inverse's first pass act on the
// same columns of the (n2, n1) view.  One cooperative launch runs three phases, each
// block looping over work items, with a grid-wide barrier between them:
//   A  per (digit j, limb l, tile of columns of the (n1, n2) view): the digit tile
//      from z and mat (exact 64-bit sum, one fold), forward pass 1 (merged CT), the
//      cross twiddle tw_mat, the transposed write to scratch s1 (d, kqp, N);
//   B  per (limb l, tile of columns of the (n2, n1) view): for each digit, forward
//      pass 2 (cyclic GS), reduction to [0, p) and the MAC with k0[j, l] and k1[j, l]
//      into two accumulators held in registers; then for each half inverse pass 1
//      (cyclic CT) and the transposed write with itw_mat to scratch s2 (2, kqp, N);
//   C  per (half, limb, tile): inverse pass 2 (merged GS) to out.
// The digits in the NTT domain never reach device memory (the staged route, K2
// base_conv, K1 forward, K2 mac_keys, K1 inverse, writes and reads them twice); s1
// and s2 (12.6 + 8.4 MB at N = 2^16, kqp = 16, d = 3) stay in the 50 MB L2.
//
// What bounds it on this card: at N = 2^16, kqp = 16, d = 3 the call must move
// ~54 MB (keys 25.2, twiddle matrices 16.8, output 8.4, z 3.1: 16 us at 3.35 TB/s)
// and do ~0.4 G int32 operations (80 row transforms of 16 Shoup butterfly stages,
// the digit build and the MAC: ~24 us at ~16.7 T int32 ops/s).  So the operations,
// and how evenly they spread over the SMs, set the floor.
//
// What the first body of this kernel spent its time on, at 0.29 ms (13.7x the
// bound), and what this body does about each:
//  - a block barrier after every butterfly stage, with 4 (phase B, 8-column tiles)
//    to 16 butterflies a thread between two: ~50 barriers per phase-B item.  Now a
//    column of S <= 256 points is held in registers by T = S/16 threads of one
//    warp, 16 values each, and every stage runs there (ntt_cols.cuh, shared with
//    K1).  Forward kinds (spans S/2 .. 1): thread k holds positions k + T*i and
//    runs the four stages of span >= T; the values pass once through the warp's own
//    columns of the shared tile behind a __syncwarp, after which thread k holds
//    [16k, 16k + 16) and runs the log T stages of span < T.  Inverse kinds run the
//    same schedule backwards.  Block barriers remain only around the coalesced
//    tile loads and stores: 3 per item of phases A and C, 2 per digit of phase B.
//  - run-time integer division in every butterfly and element copy (b % C, k / t,
//    i / C with C and t run-time ints).  Now n1, n2, the tile widths and the thread
//    counts are template parameters (hf_keyswitch2_fused dispatches on (log n1,
//    log n2) over the nine shapes split_n gives for N = 2^8 .. 2^16), every index
//    into a thread's 16 values is a constant, a stage twiddle index comes from the
//    lane and the register index by shifts and masks, work items are decoded by
//    shifts (tile counts are powers of two) and the digit of a phase-A row by a
//    multiply-high with ceil(2^32 / kqp).
//  - four shared loads and two stores per butterfly.  Now none: a value is loaded
//    from the tile once per transform, exchanged once, stored once.  The tile is
//    XOR-swizzled inside each 32-word group (swz in ntt_cols.cuh, found by
//    exhaustive search per shape) so that the coalesced row copies, the strided and
//    contiguous column reads and phase A's transposed read are all free of bank
//    conflicts.
//  - phase B's chain through shared memory.  Now the MAC reads the staged key tiles
//    at the thread's own positions and adds into two register accumulators; the
//    forward GS pass ends on distance-1 pairs and the inverse CT pass begins with
//    them, so inverse pass 1 starts on the accumulators where they are and its
//    strided layout writes s2 (with itw_mat) straight from registers, T consecutive
//    words a column.
//  - the spread over the card.  Each tile holds 4096 words (min(N, 4096)): 256
//    threads hold 256/T columns.  At the bench shape (n1 = n2 = 256, T = 16, tiles
//    of 16 columns, kqp = 16, d = 3): phase A 768 items, phase B 256, phase C 512;
//    53,248 bytes of shared memory per block (three tiles and two stage tables),
//    __launch_bounds__(256, 2) for two blocks a SM (at most 128 registers), so the
//    grid is 264 blocks and phase B runs in one wave.
// Measured on one H100 (PERF.md, kernels/keyswitch_phases.py): ~0.08 ms at the
// bench shape, phases A / B / C ~24 / 30 / 7.5 us and ~12 us of waits at the two
// grid barriers.  Cutting int32 instructions (Harvey-lazy CT butterflies, no
// product where a cyclic twiddle is 1) made it slower, so the int32 issue rate is
// not its limit; latency at 16 warps a SM and the tile loads that no work overlaps
// are the likelier ones (not measured: no hardware counters on that machine).

#include <cooperative_groups.h>

#include "ntt_cols.cuh"   // the column transform; shoup_lazy, fold, Kind

namespace cg = cooperative_groups;

namespace {

struct Params {
  const u32* z;     // (ka, N)
  const u32* mat;   // (d*alpha, kqp)
  const u32* k0;    // (d, kqp, N)
  const u32* k1;
  u32* s1;          // (d, kqp, N) scratch: forward pass 1 of every digit
  u32* s2;          // (2, kqp, N) scratch: inverse pass 1 of both halves
  u32* out;         // (2, kqp, N)
  int ka, kqp, d, alpha;
  u32 kqp_recip;    // ceil(2^32 / kqp): row / kqp = umulhi(row, kqp_recip) for row < 2^16
  const u32 *p, *pinv, *mu;
  const u32 *tw_mat, *tw_mat_sh, *itw_mat, *itw_mat_sh;   // (kqp, N)
  const u32 *tw1p, *tw1p_sh, *tw2p, *tw2p_sh;              // (kqp, n1), (kqp, n2)
  const u32 *itw1p, *itw1p_sh, *itw2p, *itw2p_sh;
};

// a*b*2^-32 mod p, canonical, for a < p < 2^30 and any 32-bit b: the REDC of a
// product below p*2^32, whose quotient is below 2p.
__device__ __forceinline__ u32 mont_mul(u32 a, u32 b, u32 p, u32 pinv) {
  const u32 lo = a * b, hi = __umulhi(a, b);
  const u32 m = lo * pinv;
  return cred(hi + __umulhi(m, p) + (lo != 0u), p);
}

// Shared memory, in words: three tiles of min(N, 4096) words and two stage tables.
// Phases A and C work on columns of n1 points (Tiles::A), phase B on columns of n2
// points (Tiles::B).
template <int L1, int L2>
struct Layout : Tiles<L1, L2> {
  static constexpr int kTabOff = 3 * Tiles<L1, L2>::kTile;
  static constexpr int kWords = kTabOff + 4 * (1 << L2);   // n2 >= n1
};

// Phase A, item = (j*kqp + l) << kLogTilesA | tile.
template <int L1, int L2>
__device__ void phase_a(const Params& P, u32* sm, int item) {
  using Y = Layout<L1, L2>;
  using Sh = typename Y::A;
  constexpr int n2 = 1 << L2, N = 1 << (L1 + L2);
  const int row = item >> Y::kLogTilesA;
  const int c0 = (item & ((1 << Y::kLogTilesA) - 1)) << Sh::LC;
  const int j = __umulhi(row, P.kqp_recip), l = row - j * P.kqp;
  u32* x = sm;
  u32* w = sm + Y::kTile;
  u32* wsh = w + Y::kTile;
  uint2* tw = reinterpret_cast<uint2*>(sm + Y::kTabOff);
  const u32 p = P.p[l], pinv = P.pinv[l], mu = P.mu[l];
  int terms = P.ka - j * P.alpha;            // a short last group has fewer
  if (terms > P.alpha) terms = P.alpha;
  const u32* zj = P.z + (size_t)j * P.alpha * N + c0;
  const u32* mj = P.mat + j * P.alpha * P.kqp + l;
  const size_t lo = (size_t)l * N + c0;
  __syncthreads();   // the block's previous item is done with the shared memory
  load_table<1 << L1>(tw, P.tw1p, P.tw1p_sh, l);
  u64 acc[Sh::kPer];
#pragma unroll
  for (int q = 0; q < Sh::kPer; ++q) acc[q] = 0;
  for (int t = 0; t < terms; ++t) {
    const u32 m = mj[t * P.kqp];
    const u32* zt = zj + (size_t)t * N;
#pragma unroll
    for (int q = 0; q < Sh::kPer; ++q) {
      const int e = threadIdx.x + q * kThreads;
      acc[q] += (u64)zt[(e >> Sh::LC) * n2 + (e & (Sh::C - 1))] * m;
    }
  }
#pragma unroll
  for (int q = 0; q < Sh::kPer; ++q) {
    const int e = threadIdx.x + q * kThreads;
    const int r = e >> Sh::LC, c = e & (Sh::C - 1), at = Sh::at(r, c);
    x[at] = fold(acc[q], p, pinv, mu);
    w[at] = P.tw_mat[lo + r * n2 + c];
    wsh[at] = P.tw_mat_sh[lo + r * n2 + c];
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
  // transposed write: s1 row viewed as (n2, n1); the tile's columns are consecutive
  // rows there, so thread e writes word c0*n1 + e
  u32* dst = P.s1 + (size_t)row * N + (size_t)c0 * Sh::S;
#pragma unroll
  for (int q = 0; q < Sh::kPer; ++q) {
    const int e = threadIdx.x + q * kThreads;
    dst[e] = x[Sh::at(e & (Sh::S - 1), e >> L1)];
  }
}

// Phase B, item = l << kLogTilesB | tile.
template <int L1, int L2>
__device__ void phase_b(const Params& P, u32* sm, int item) {
  using Y = Layout<L1, L2>;
  using Sh = typename Y::B;
  constexpr int n1 = 1 << L1, n2 = 1 << L2, N = 1 << (L1 + L2);
  const int l = item >> Y::kLogTilesB;
  const int c0 = (item & ((1 << Y::kLogTilesB) - 1)) << Sh::LC;
  const size_t LN = (size_t)P.kqp * N;
  u32* x = sm;
  u32* y0 = sm + Y::kTile;
  u32* y1 = y0 + Y::kTile;
  uint2* tw = reinterpret_cast<uint2*>(sm + Y::kTabOff);
  uint2* itw = tw + n2;
  const u32 p = P.p[l], pinv = P.pinv[l];
  const int k = threadIdx.x & (Sh::T - 1), col = threadIdx.x >> Sh::LT;
  const bool active = threadIdx.x < Sh::kActive;
  u32 acc0[kVals], acc1[kVals];
  for (int j = 0; j < P.d; ++j) {
    const size_t off = (size_t)j * LN + (size_t)l * N + c0;
    __syncthreads();   // the tiles' previous contents are read
    if (j == 0) {
      load_table<n2>(tw, P.tw2p, P.tw2p_sh, l);
      load_table<n2>(itw, P.itw2p, P.itw2p_sh, l);
    }
#pragma unroll
    for (int q = 0; q < Sh::kPer; ++q) {
      const int e = threadIdx.x + q * kThreads;
      const int r = e >> Sh::LC, c = e & (Sh::C - 1), at = Sh::at(r, c);
      const size_t g = off + r * n1 + c;
      x[at] = P.s1[g];
      y0[at] = P.k0[g];
      y1[at] = P.k1[g];
    }
    __syncthreads();
    if (active) {
      u32 v[kVals];
      get<Sh, true>(v, x, k, col);
      column_fwd<kCyclicGS, Sh>(v, x, tw, k, col, p);
#pragma unroll
      for (int i = 0; i < kVals; ++i) {
        const int at = Sh::at(Sh::template pos<false>(k, i), col);
        const u32 e = cred(v[i], p);   // the digit's NTT value, < p
        const u32 m0 = mont_mul(e, y0[at], p, pinv), m1 = mont_mul(e, y1[at], p, pinv);
        acc0[i] = j ? cred(acc0[i] + m0, p) : m0;
        acc1[i] = j ? cred(acc1[i] + m1, p) : m1;
      }
    }
  }
  if (!active) return;
  // inverse pass 1 on the accumulators, then the transposed write with itw_mat: s2
  // viewed as (n1, n2), the thread's value i at row c0 + col, column k + T*i
  const size_t g0 = (size_t)l * N + (size_t)(c0 + col) * n2 + k;
  const u32* im = P.itw_mat + g0;
  const u32* im_sh = P.itw_mat_sh + g0;
  column_inv<kCyclicCT, Sh>(acc0, x, itw, k, col, p);
#pragma unroll
  for (int i = 0; i < kVals; ++i)
    P.s2[g0 + (i << Sh::LT)] = shoup_lazy(acc0[i], im[i << Sh::LT], im_sh[i << Sh::LT], p);
  if (Sh::LT > 0) __syncwarp();   // the warp's strided reads of half 0 are done
  column_inv<kCyclicCT, Sh>(acc1, x, itw, k, col, p);
#pragma unroll
  for (int i = 0; i < kVals; ++i)
    P.s2[LN + g0 + (i << Sh::LT)] = shoup_lazy(acc1[i], im[i << Sh::LT], im_sh[i << Sh::LT], p);
}

// Phase C, item = (half*kqp + l) << kLogTilesA | tile.
template <int L1, int L2>
__device__ void phase_c(const Params& P, u32* sm, int item) {
  using Y = Layout<L1, L2>;
  using Sh = typename Y::A;
  constexpr int n2 = 1 << L2, N = 1 << (L1 + L2);
  const int row = item >> Y::kLogTilesA;
  const int c0 = (item & ((1 << Y::kLogTilesA) - 1)) << Sh::LC;
  const int l = row < P.kqp ? row : row - P.kqp;
  const size_t off = (size_t)row * N + c0;
  u32* x = sm;
  uint2* tw = reinterpret_cast<uint2*>(sm + Y::kTabOff);
  const u32 p = P.p[l];
  __syncthreads();
  load_table<1 << L1>(tw, P.itw1p, P.itw1p_sh, l);
#pragma unroll
  for (int q = 0; q < Sh::kPer; ++q) {
    const int e = threadIdx.x + q * kThreads;
    const int r = e >> Sh::LC, c = e & (Sh::C - 1);
    x[Sh::at(r, c)] = P.s2[off + r * n2 + c];
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

template <int L1, int L2>
__global__ void __launch_bounds__(kThreads, 2) keyswitch2_fused_kernel(const Params P) {
  using Y = Layout<L1, L2>;
  extern __shared__ __align__(16) u32 sm[];
  cg::grid_group grid = cg::this_grid();
  const int na = (P.d * P.kqp) << Y::kLogTilesA;
  for (int it = blockIdx.x; it < na; it += gridDim.x) phase_a<L1, L2>(P, sm, it);
  grid.sync();
  const int nb = P.kqp << Y::kLogTilesB;
  for (int it = blockIdx.x; it < nb; it += gridDim.x) phase_b<L1, L2>(P, sm, it);
  grid.sync();
  const int nc = (2 * P.kqp) << Y::kLogTilesA;
  for (int it = blockIdx.x; it < nc; it += gridDim.x) phase_c<L1, L2>(P, sm, it);
}

// The cooperative launch of one shape: as many blocks as fit on the card at once,
// and no more than the phase with the most work items has items.
template <int L1, int L2>
int launch(const Params& P, cudaStream_t stream) {
  using Y = Layout<L1, L2>;
  constexpr size_t smem = Y::kWords * sizeof(u32);
  const void* kern = reinterpret_cast<const void*>(keyswitch2_fused_kernel<L1, L2>);
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, keyswitch2_fused_kernel<L1, L2>,
                                                      kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const int na = (P.d * P.kqp) << Y::kLogTilesA, nb = P.kqp << Y::kLogTilesB;
  const int nc = (2 * P.kqp) << Y::kLogTilesA;
  const int most = na > nb ? (na > nc ? na : nc) : (nb > nc ? nb : nc);
  const int grid = per_sm * sms < most ? per_sm * sms : most;
  void* args[] = {const_cast<Params*>(&P)};
  err = cudaLaunchCooperativeKernel(kern, dim3(grid), dim3(kThreads), args, smem, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The fused core on one level: see the note above for the layouts.  The tables are
// NttTables' fields for the level's Q*P basis (p, pinv, mu; tw_mat, itw_mat and
// their Shoup companions; the packed stage tables).  s1 (d, kqp, N) and s2 (2, kqp, N)
// are scratch.  Returns cudaErrorInvalidValue for a shape outside n1 = 2^4 .. 2^8
// with n2 in {n1, 2*n1}, for kqp < 2 or for d*kqp >= 2^16, else the error of the cooperative
// launch, else cudaGetLastError().
extern "C" int hf_keyswitch2_fused(
    const void* z, const void* mat, const void* k0, const void* k1, void* s1, void* s2,
    void* out, int ka, int kqp, int d, int alpha, int n1, int n2, const void* p,
    const void* pinv, const void* mu, const void* tw_mat, const void* tw_mat_sh,
    const void* itw_mat, const void* itw_mat_sh, const void* tw1p, const void* tw1p_sh,
    const void* tw2p, const void* tw2p_sh, const void* itw1p, const void* itw1p_sh,
    const void* itw2p, const void* itw2p_sh, void* stream) {
  auto c = [](const void* v) { return static_cast<const u32*>(v); };
  if (kqp < 2 || d < 1 || (long long)d * kqp >= (1 << 16)) return cudaErrorInvalidValue;
  Params P;
  P.z = c(z); P.mat = c(mat); P.k0 = c(k0); P.k1 = c(k1);
  P.s1 = static_cast<u32*>(s1); P.s2 = static_cast<u32*>(s2);
  P.out = static_cast<u32*>(out);
  P.ka = ka; P.kqp = kqp; P.d = d; P.alpha = alpha;
  P.kqp_recip = static_cast<u32>(((1ull << 32) + kqp - 1) / kqp);
  P.p = c(p); P.pinv = c(pinv); P.mu = c(mu);
  P.tw_mat = c(tw_mat); P.tw_mat_sh = c(tw_mat_sh);
  P.itw_mat = c(itw_mat); P.itw_mat_sh = c(itw_mat_sh);
  P.tw1p = c(tw1p); P.tw1p_sh = c(tw1p_sh); P.tw2p = c(tw2p); P.tw2p_sh = c(tw2p_sh);
  P.itw1p = c(itw1p); P.itw1p_sh = c(itw1p_sh); P.itw2p = c(itw2p);
  P.itw2p_sh = c(itw2p_sh);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int l1 = ilog2(n1), l2 = ilog2(n2);
  if (n1 != 1 << l1 || n2 != 1 << l2) return cudaErrorInvalidValue;
  switch (l1 * 16 + l2) {
    case 4 * 16 + 4: return launch<4, 4>(P, st);
    case 4 * 16 + 5: return launch<4, 5>(P, st);
    case 5 * 16 + 5: return launch<5, 5>(P, st);
    case 5 * 16 + 6: return launch<5, 6>(P, st);
    case 6 * 16 + 6: return launch<6, 6>(P, st);
    case 6 * 16 + 7: return launch<6, 7>(P, st);
    case 7 * 16 + 7: return launch<7, 7>(P, st);
    case 7 * 16 + 8: return launch<7, 8>(P, st);
    case 8 * 16 + 8: return launch<8, 8>(P, st);
    default: return cudaErrorInvalidValue;
  }
}
