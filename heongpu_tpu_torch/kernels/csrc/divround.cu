// The exact rounding division by the special primes, for Hopper (sm_90a): K6.
//
// Replaces heongpu_tpu/ops/rns.py::DivRoundLastq (rns.py:226-260) applied p times
// in a row, which XLA fused on the TPU (no Pallas code): the ÷P that ends every
// keyswitch (P = P_0 ... P_{p-1}, the special primes) and every encryption.  Stage s
// divides by the last limb left, P_s' = P_{p-1-s}:
//   r_s = [x_{P_s'} + h_s]_{P_s'},  x_j <- (x_j + h_s - r_s) * P_s'^-1 mod q_j,
// h_s = floor(P_s'/2), for every limb j still present.  (B, k+p, N) -> (B, k, N).
//
// Bound: device-memory bandwidth (8 bytes a Q word moved against about 2p + 12
// integer operations).  The design:
// - A Q word takes all p stages at once.  The chain is linear in the word and the
//   r_s: x_j <- x_j A_j + sum_s r_s B_sj + C_j mod q_j, with A_j the product of the
//   P_s'^-1, G_sj the product of those of stages s and later, B_sj = q_j - G_sj and
//   C_j = sum_s h_s G_sj, all mod q_j.  With A, B and C in Montgomery form (times
//   2^32 mod q_j) the word is one lazy 64-bit sum S of p + 1 products below 2^60 and
//   C, and one REDC, (S + m q_j) / 2^32 with m = S (-q_j^-1) mod 2^32, below 3 q_j,
//   and two conditional subtractions to the canonical residue, which is the chain's,
//   so the residues are the plain version's bits (ops/rns.py::div_round_chain_plain).
//   From p = 7 on S can pass 2^63, so its high word is brought below 2 q_j (Barrett)
//   before the REDC; sixteen products can pass 2^64, so a chain of 15 or 16 stages
//   does that after the fifteenth product too.
// - The p special residues go through the chain in registers: each stage's rounding
//   term r_s, and the stage's update of the special limbs still present (at most
//   p(p-1)/2 modular steps, 15 for p = 6).  A special limb's step is exact 32-bit
//   arithmetic: v + h' - r_s with h' = h_s mod P_t plus a multiple of P_t that is at
//   least P_s' (so never negative, and below 2^32 for primes below 2^30), one Shoup
//   product by P_s'^-1 mod P_t and a conditional subtraction.
// - Two kernels.  Up to 16 Q limbs at p <= 4 (the main path's k = 12) and 8 at
//   p <= 8 (column_rows), a thread takes a column (256 a block) and all of its k + p
//   words, loaded before any is used, and runs the chain itself.  Above that (depth 48's k = 48, BFV's and BGV's k = 29) a
//   group of 32 columns takes W = ceil(k / kPerThread) warps, at most 8, and a block
//   8 / W groups: the group's tile of k + p rows is copied into shared memory 16 bytes
//   at a time (cp.async; so N is a multiple of 4), the special rows first as a commit
//   group of their own, so that the group's warp 0 runs the chain for its 32 columns
//   while the Q rows still arrive; the r_s go through shared memory, and the W warps
//   split the Q rows.  Depth 48's (2, 54, 2^16) launch is 2048 blocks of 256 threads
//   (W = 4, two groups a block), three waves at five blocks an SM.  kPerThread = 12
//   is the fastest of 8, 12 and 16 at that shape (tools/k6_k7_bench.py --variants
//   builds the K6_* macros below); 64- and 128-column groups, the table staged in shared memory and
//   one kernel for both paths were slower still.
// - The table (DivRoundChain.tab) is read through the read-only cache, every read
//   warp-uniform: P_s and h_s per stage, the special chain's (h', P_s'^-1 mod P_t,
//   its Shoup companion, P_t) per special limb t and stage, then per Q limb (q_j,
//   -q_j^-1 mod 2^32, floor(2^32/q_j), C_j, A_j, B_0j ... B_(p-1)j).  p is a template
//   parameter (1 to 16, K5's widest digit; rns.div_round_cuda runs a longer chain as
//   pieces of 16 stages, one launch each).
//
// The t-exact mode (EXACT = true, hf_div_exact_t) is BGV's division, which
// replaces heongpu_tpu/models/bgv.py::DivExactT (bgv.py:48-106), also XLA-fused on
// the TPU: stage s takes v_s = [-x_{P_s'} t^-1]_{P_s'}, centered, and sets
// x_j <- (x_j + t v_s) * P_s'^-1 mod q_j, an exact division that keeps the phase
// congruent to the message mod t.  The column's v_s is computed once, as its
// magnitude with the sign in bit 31 (|v_s| < 2^29); a limb's update is a Shoup
// product of |v_s| by [t]_{q_j}, negated for a negative v_s, an addition and the
// Shoup product by P_s'^-1 mod q_j, stage by stage.  Its table puts [-t^-1]_{P_s'}
// and its Shoup companion per stage after P_s and floor(P_s/2), the primes q_j, and
// ([t]_{q_j}, its companion, P_s'^-1 mod q_j, its companion) per limb and stage.  It
// runs on the same two kernels as the rounding mode.

#include <cuda_pipeline.h>

#include "ntt_common.cuh"

namespace {

// The tuning constants below; a build may set them (-D) to time other values.
#ifndef K6_PER_THREAD
#define K6_PER_THREAD 12
#endif
#ifndef K6_COLUMN_ROWS_4
#define K6_COLUMN_ROWS_4 16
#endif
#ifndef K6_COLUMN_ROWS_8
#define K6_COLUMN_ROWS_8 8
#endif

constexpr int kWarps = 8;       // a block's warps (the tile kernel: 8 / W groups of W)
constexpr int kThreads = 32 * kWarps;
constexpr int kPerThread = K6_PER_THREAD;  // the Q rows a thread should take: the warps
// The most Q rows a thread takes whole at p stages: 16 up to 4 stages, 8 up to 8 (the
// column kernel's registers grow with both), none beyond (its registers spill).
__host__ __device__ constexpr int column_rows(int p) {
  return p <= 4 ? K6_COLUMN_ROWS_4 : p <= 8 ? K6_COLUMN_ROWS_8 : 0;
}
constexpr int kMaxSmem = 227 * 1024;

struct DivParams {
  const u32* x;    // (B, k+p, N)
  u32* out;        // (B, k, N)
  const u32* tab;  // DivRoundChain.tab
  int k, N, warps;  // the tile kernel's warps to a group of 32 columns
};

// a mod m for a < 2m: min(a, a - m)
__device__ __forceinline__ u32 csub_min(u32 a, u32 m) { return min(a, a - m); }

// The rounding mode's table: words before the special chain, before the Q limbs,
// and a Q limb's words.
__host__ __device__ constexpr int round_chain_at(int p) { return (2 * p + 3) & ~3; }
__host__ __device__ constexpr int round_limbs_at(int p) {
  return round_chain_at(p) + 4 * (p - 1) * (p - 1);
}
__host__ __device__ constexpr int round_limb_words(int p) { return (p + 5 + 3) & ~3; }

// The t-exact mode's table: the head (P_s, floor(P_s/2), [-t^-1]_{P_s} and its Shoup
// companion per stage), the primes q_j of stage 0's basis, then 4 words per limb and
// stage.
__host__ __device__ constexpr int exact_body_at(int p, int k) {
  return (4 * p + k + p - 1 + 3) & ~3;
}

// The tile kernel's shared memory: for each group of 32 columns, the (k + p, 32) tile
// and the (p, 32) r_s.
constexpr int smem_bytes(int groups, int k, int p) { return groups * (k + 2 * p) * 32 * 4; }

// (v + h' - r) * P^-1 mod q, canonical; c = (h', P^-1 mod q, its Shoup companion, q).
__device__ __forceinline__ u32 div_step(u32 v, u32 r, uint4 c) {
  return csub_min(shoup_lazy(v + c.x - r, c.y, c.z, c.w), c.w);
}

// (v + t*w) * P^-1 mod q, canonical, for the centered w whose magnitude is r's low 31
// bits and whose sign is r's bit 31; c = ([t]_q, its Shoup companion, P^-1 mod q, its
// Shoup companion).
__device__ __forceinline__ u32 exact_step(u32 v, u32 r, uint4 c, u32 q) {
  u32 tw = csub(shoup_lazy(r & 0x7fffffffu, c.x, c.y, q), q);
  if (r >> 31) tw = tw ? q - tw : 0u;
  return csub(shoup_lazy(csub(v + tw, q), c.z, c.w, q), q);
}

// x with its high word brought below 2q by Barrett (mu = floor(2^32/q)): congruent
// mod q, and below 2q * 2^32 < 2^63.
__device__ __forceinline__ u64 reduce_high(u64 x, u32 q, u32 mu) {
  const u32 hi = static_cast<u32>(x >> 32);
  return (static_cast<u64>(hi - __umulhi(hi, mu) * q) << 32) | static_cast<u32>(x);
}

// x A + sum_s r_s B_s + C mod q, canonical, from a Q limb's words w = (q, -q^-1 mod
// 2^32, floor(2^32/q), C', A', B'_0 .. B'_(P-1)) (C', A', B' in Montgomery form).
// The sum S of P + 1 products below 2^60 and C' passes 2^63 from 8 products on: the
// high word is brought below 2q after the fifteenth product (P >= 15) and before the
// REDC (P >= 7).  Then (S + m q) / 2^32 with m = S * (-q^-1) mod 2^32 is S 2^-32 mod
// q, below 3q (S < 2q * 2^32, or S < 7 q 2^30 + q for P <= 6), and two conditional
// subtractions make it canonical.
template <int P>
__device__ __forceinline__ u32 fold_limb(u32 x, const u32 (&r)[P], const u32* w) {
  u64 acc = static_cast<u64>(x) * w[4] + w[3];
#pragma unroll
  for (int s = 0; s < P; ++s) {
    acc += static_cast<u64>(r[s]) * w[5 + s];
    if (s == 13 && P > 14) acc = reduce_high(acc, w[0], w[2]);
  }
  if (P > 6) acc = reduce_high(acc, w[0], w[2]);
  const u32 m = static_cast<u32>(acc) * w[1];
  const u32 t = static_cast<u32>((acc + static_cast<u64>(m) * w[0]) >> 32);
  return csub_min(csub_min(t, w[0]), w[0]);
}

// The special limbs' chain on a column's p special residues y (limb k + t): each
// stage's r_s (the rounding term, or the centered v_s with its sign in bit 31).
template <int P, bool EXACT>
__device__ __forceinline__ void special_chain(u32 (&y)[P], const u32* T, int k, u32 (&r)[P]) {
  if constexpr (EXACT) {
    const uint4* st = reinterpret_cast<const uint4*>(T + exact_body_at(P, k));
    const u32* q = T + 4 * P;
#pragma unroll
    for (int s = 0; s < P; ++s) {
      const u32 ps = __ldg(T + s);
      const u32 u = csub(shoup_lazy(y[P - 1 - s], __ldg(T + 2 * P + s), __ldg(T + 3 * P + s), ps),
                         ps);
      const u32 v = u > __ldg(T + P + s) ? (ps - u) | 0x80000000u : u;
      r[s] = v;
#pragma unroll
      for (int t = 0; t < P - 1 - s; ++t)
        y[t] = exact_step(y[t], v, __ldg(st + (k + t) * P + s), __ldg(q + k + t));
    }
  } else {
    const uint4* ch = reinterpret_cast<const uint4*>(T + round_chain_at(P));
#pragma unroll
    for (int s = 0; s < P; ++s) {
      const u32 v = csub_min(y[P - 1 - s] + __ldg(T + P + s), __ldg(T + s));
      r[s] = v;
#pragma unroll
      for (int t = 0; t < P - 1 - s; ++t) y[t] = div_step(y[t], v, __ldg(ch + t * (P - 1) + s));
    }
  }
}

// Q word x of limb j after every stage, canonical.
template <int P, bool EXACT>
__device__ __forceinline__ u32 q_word(u32 x, const u32 (&r)[P], const u32* T, int k, int j) {
  if constexpr (EXACT) {
    const uint4* st = reinterpret_cast<const uint4*>(T + exact_body_at(P, k));
    const u32 qj = __ldg(T + 4 * P + j);
#pragma unroll
    for (int s = 0; s < P; ++s) x = exact_step(x, r[s], __ldg(st + j * P + s), qj);
    return x;
  } else {
    constexpr int LW = round_limb_words(P) / 4;
    const uint4* limb = reinterpret_cast<const uint4*>(T + round_limbs_at(P)) + j * LW;
    u32 w[4 * LW];
#pragma unroll
    for (int h = 0; h < LW; ++h) {
      const uint4 u = __ldg(limb + h);
      w[4 * h] = u.x;
      w[4 * h + 1] = u.y;
      w[4 * h + 2] = u.z;
      w[4 * h + 3] = u.w;
    }
    return fold_limb<P>(x, r, w);
  }
}

// k <= column_rows(p): a thread takes a column (256 a block) and all of its words,
// loaded at once, with the chain in its own registers.
template <int P, bool EXACT>
__global__ void __launch_bounds__(kThreads) div_round_column_kernel(const DivParams A) {
  const int n = blockIdx.x * kThreads + threadIdx.x, k = A.k;
  if (n >= A.N) return;
  const size_t N = A.N;
  const u32* xc = A.x + static_cast<size_t>(blockIdx.y) * (k + P) * N + n;
  u32* oc = A.out + static_cast<size_t>(blockIdx.y) * k * N + n;
  constexpr int R = column_rows(P);
  u32 y[P], v[R], r[P];
#pragma unroll
  for (int t = 0; t < P; ++t) y[t] = xc[(k + t) * N];
#pragma unroll
  for (int j = 0; j < R; ++j)
    if (j < k) v[j] = xc[j * N];
  special_chain<P, EXACT>(y, A.tab, k, r);
#pragma unroll
  for (int j = 0; j < R; ++j)
    if (j < k) oc[j * N] = q_word<P, EXACT>(v[j], r, A.tab, k, j);
}

// Otherwise: a group of 32 columns takes W warps, which split its Q rows; a block holds
// 8 / W groups.
template <int P, bool EXACT>
__global__ void __launch_bounds__(kThreads) div_round_tile_kernel(const DivParams A) {
  extern __shared__ __align__(16) u32 sm[];  // per group: the tile, then the r_s
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, k = A.k;
  const int W = A.warps, g = warp / W, wg = warp - g * W;
  const int n0 = (blockIdx.x * (kWarps / W) + g) * 32;
  const int left = A.N - n0;
  const int cols = left < 0 ? 0 : left < 32 ? left : 32;  // a multiple of 4
  const size_t N = A.N;
  const u32* xb = A.x + static_cast<size_t>(blockIdx.y) * (k + P) * N + n0;
  u32* ob = A.out + static_cast<size_t>(blockIdx.y) * k * N + n0;
  u32* tile = sm + g * (k + 2 * P) * 32;  // tile[row * 32 + column]
  u32* rs = tile + (k + P) * 32;

  // 16 bytes a copy: the group's warp 0 copies the special rows as a commit group of
  // their own, then the group's warps copy the Q rows.
  if (wg == 0) {
    for (int c = lane; c < P * 8; c += 32) {
      const int row = k + (c >> 3), col = (c & 7) * 4;
      if (col < cols) __pipeline_memcpy_async(tile + row * 32 + col, xb + row * N + col, 16);
    }
    __pipeline_commit();
  }
  for (int c = wg * 32 + lane; c < k * 8; c += 32 * W) {
    const int row = c >> 3, col = (c & 7) * 4;
    if (col < cols) __pipeline_memcpy_async(tile + row * 32 + col, xb + row * N + col, 16);
  }
  __pipeline_commit();
  // the group's warp 0 runs the chain as soon as the special rows are in, under the Q
  // rows' copies
  u32 r[P];
  if (wg == 0) {
    __pipeline_wait_prior(1);
    __syncwarp();
    if (lane < cols) {
      u32 y[P];
#pragma unroll
      for (int t = 0; t < P; ++t) y[t] = tile[(k + t) * 32 + lane];
      special_chain<P, EXACT>(y, A.tab, k, r);
#pragma unroll
      for (int s = 0; s < P; ++s) rs[s * 32 + lane] = r[s];
    }
  }
  __pipeline_wait_prior(0);
  __syncthreads();
  if (lane >= cols) return;
#pragma unroll
  for (int s = 0; s < P; ++s) r[s] = rs[s * 32 + lane];
#pragma unroll 4
  for (int j = wg; j < k; j += W)
    ob[j * N + lane] = q_word<P, EXACT>(tile[j * 32 + lane], r, A.tab, k, j);
}

template <int P, bool EXACT>
int launch_div_round(const DivParams& A, int B, cudaStream_t stream) {
  const unsigned by = static_cast<unsigned>(B);
  if constexpr (column_rows(P) > 0) {
    if (A.k <= column_rows(P)) {
      div_round_column_kernel<P, EXACT>
          <<<dim3{static_cast<unsigned>((A.N + kThreads - 1) / kThreads), by, 1u}, kThreads, 0,
             stream>>>(A);
      return static_cast<int>(cudaGetLastError());
    }
  }
  const int groups = kWarps / A.warps, cols = 32 * groups;
  const int smem = smem_bytes(groups, A.k, P);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        div_round_tile_kernel<P, EXACT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  div_round_tile_kernel<P, EXACT><<<dim3{static_cast<unsigned>((A.N + cols - 1) / cols), by, 1u},
                                    32 * A.warps * groups, smem, stream>>>(A);
  return static_cast<int>(cudaGetLastError());
}

template <bool EXACT>
int div_chain(const void* x, void* out, const void* tab, int B, int k, int p, int N,
              void* stream) {
  // the tile kernel's warps to a group of 32 columns: kPerThread Q rows a thread, at
  // most 8 warps
  const int w = (k + kPerThread - 1) / kPerThread, warps = w < kWarps ? w : kWarps;
  if (B <= 0 || k <= 0 || N <= 0 || p <= 0 || N % 4 || reinterpret_cast<uintptr_t>(x) % 16 ||
      smem_bytes(kWarps / warps, k, p) > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const DivParams A{static_cast<const u32*>(x), static_cast<u32*>(out),
                    static_cast<const u32*>(tab), k, N, warps};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p) {
    case 1: return launch_div_round<1, EXACT>(A, B, s);
    case 2: return launch_div_round<2, EXACT>(A, B, s);
    case 3: return launch_div_round<3, EXACT>(A, B, s);
    case 4: return launch_div_round<4, EXACT>(A, B, s);
    case 5: return launch_div_round<5, EXACT>(A, B, s);
    case 6: return launch_div_round<6, EXACT>(A, B, s);
    case 7: return launch_div_round<7, EXACT>(A, B, s);
    case 8: return launch_div_round<8, EXACT>(A, B, s);
    case 9: return launch_div_round<9, EXACT>(A, B, s);
    case 10: return launch_div_round<10, EXACT>(A, B, s);
    case 11: return launch_div_round<11, EXACT>(A, B, s);
    case 12: return launch_div_round<12, EXACT>(A, B, s);
    case 13: return launch_div_round<13, EXACT>(A, B, s);
    case 14: return launch_div_round<14, EXACT>(A, B, s);
    case 15: return launch_div_round<15, EXACT>(A, B, s);
    case 16: return launch_div_round<16, EXACT>(A, B, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// out (B, k, N) = x (B, k+p, N) divided, with rounding, by its last p limbs, the last
// first; tab is DivRoundChain.tab.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for p outside 1..16 or an empty shape.
extern "C" int hf_div_round(const void* x, void* out, const void* tab, int B, int k, int p,
                            int N, void* stream) {
  return div_chain<false>(x, out, tab, B, k, p, N, stream);
}

// The same chain in the t-exact mode: tab is the DivRoundChain.tab of DivExactT stages.
extern "C" int hf_div_exact_t(const void* x, void* out, const void* tab, int B, int k, int p,
                              int N, void* stream) {
  return div_chain<true>(x, out, tab, B, k, p, N, stream);
}
