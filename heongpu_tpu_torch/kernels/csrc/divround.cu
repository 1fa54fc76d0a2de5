// The exact rounding division by the special primes, for Hopper (sm_90a): K6.
//
// Replaces heongpu_tpu/ops/rns.py::DivRoundLastq (rns.py:226-260) applied p times
// in a row, which XLA fused on the TPU (no Pallas code): the ÷P that ends every
// keyswitch (P = P_0 ... P_{p-1}, the special primes) and every encryption.  Stage s
// divides by the last limb left, P_s' = P_{p-1-s}:
//   r_s = [x_{P_s'} + h_s]_{P_s'},  x_j <- (x_j + h_s - r_s) * P_s'^-1 mod q_j,
// h_s = floor(P_s'/2), for every limb j still present.  (B, k+p, N) -> (B, k, N).
//
// A thread owns one coefficient column (b, n).  It loads the column's p special
// residues into registers and runs the chain on them there: each stage's rounding
// term r_s, and the stage's update of the special limbs still present (at most
// p(p-1)/2 modular steps, 15 for p = 6).  Then it streams the k Q limbs: each word
// is read once (coalesced along n), takes the p stage updates in registers, and is
// written once.  A stage update is exact 32-bit arithmetic: v + h'_sj - r_s with
// h'_sj = h_s mod q_j plus a multiple of q_j that is at least P_s' (so the sum is
// never negative, and below 2^32 for primes below 2^30), then one Shoup product by
// P_s'^-1 mod q_j and a conditional subtraction; no division.  So the residues are
// the plain version's bits (ops/rns.py::div_round_chain_plain).  The table
// (DivRoundChain.tab: P_s, h_s, the primes q_j, then (h'_sj, P_s^-1 mod q_j, its
// Shoup companion, 0) per limb and stage) is staged once per block into shared
// memory; every read of it is a warp-uniform broadcast, one 16-byte load per
// stage.  p is a template parameter (1 to 16, K5's widest digit; rns.div_round_cuda
// runs a longer chain as pieces of 16 stages, one launch each).
//
// Bound: device-memory bandwidth at p <= 4 (8 bytes a Q word moved against about
// 5p integer operations), near balance at p = 6.
//
// The t-exact mode (EXACT = true, hf_div_exact_t) is BGV's division, which
// replaces heongpu_tpu/models/bgv.py::DivExactT (bgv.py:48-106), also XLA-fused on
// the TPU: stage s takes v_s = [-x_{P_s'} t^-1]_{P_s'}, centered, and sets
// x_j <- (x_j + t v_s) * P_s'^-1 mod q_j, an exact division that keeps the phase
// congruent to the message mod t.  The column's v_s is computed once, as its
// magnitude with the sign in bit 31 (|v_s| < 2^29); a limb's update is a Shoup
// product of |v_s| by [t]_{q_j}, negated for a negative v_s, an addition and the
// Shoup product by P_s'^-1 mod q_j.  Its table puts [-t^-1]_{P_s'} and its Shoup
// companion per stage after P_s and floor(P_s/2), and ([t]_{q_j}, its companion,
// P_s'^-1 mod q_j, its companion) per limb and stage.  Same loads, stores and
// structure as the rounding mode, about twice its integer operations per update.

#include "ntt_common.cuh"

namespace {

constexpr int kThreads = 256;

struct DivParams {
  const u32* x;    // (B, k+p, N)
  u32* out;        // (B, k, N)
  const u32* tab;  // DivRoundChain.tab
  int k, N, words;
};

// (v + h' - r) * P^-1 mod q, canonical; c = (h', P^-1 mod q, its Shoup companion, 0).
__device__ __forceinline__ u32 div_step(u32 v, u32 r, uint4 c, u32 q) {
  return csub(shoup_lazy(v + c.x - r, c.y, c.z, q), q);
}

// (v + t*w) * P^-1 mod q, canonical, for the centered w whose magnitude is r's low 31
// bits and whose sign is r's bit 31; c = ([t]_q, its Shoup companion, P^-1 mod q, its
// Shoup companion).
__device__ __forceinline__ u32 exact_step(u32 v, u32 r, uint4 c, u32 q) {
  u32 tw = csub(shoup_lazy(r & 0x7fffffffu, c.x, c.y, q), q);
  if (r >> 31) tw = tw ? q - tw : 0u;
  return csub(shoup_lazy(csub(v + tw, q), c.z, c.w, q), q);
}

template <bool EXACT>
__device__ __forceinline__ u32 stage_step(u32 v, u32 r, uint4 c, u32 q) {
  return EXACT ? exact_step(v, r, c, q) : div_step(v, r, c, q);
}

// Head words per stage: P_s and floor(P_s/2), and in the t-exact mode [-t^-1]_{P_s}
// and its Shoup companion.
__host__ __device__ constexpr int head_words(bool exact) { return exact ? 4 : 2; }

template <int P, bool EXACT>
__global__ void __launch_bounds__(kThreads) div_round_kernel(const DivParams A) {
  extern __shared__ __align__(16) u32 sm[];
  for (int i = threadIdx.x; i < A.words; i += kThreads) sm[i] = A.tab[i];
  __syncthreads();

  const int n = blockIdx.x * kThreads + threadIdx.x;
  if (n >= A.N) return;
  constexpr int H = head_words(EXACT) * P;
  const u32* q = sm + H;                       // the primes q_j, j < k + P - 1
  const uint4* st = reinterpret_cast<const uint4*>(sm + ((H + A.k + P - 1 + 3) & ~3));
  const size_t N = A.N;
  const u32* xc = A.x + static_cast<size_t>(blockIdx.y) * (A.k + P) * N + n;

  u32 y[P];  // the special residues, limb k + t
#pragma unroll
  for (int t = 0; t < P; ++t) y[t] = xc[(A.k + t) * N];
  u32 r[P];  // the rounding term of each stage, or its centered v (t-exact)
#pragma unroll
  for (int s = 0; s < P; ++s) {
    if (EXACT) {
      const u32 v = csub(shoup_lazy(y[P - 1 - s], sm[2 * P + s], sm[3 * P + s], sm[s]), sm[s]);
      r[s] = v > sm[P + s] ? (sm[s] - v) | 0x80000000u : v;
    } else {
      r[s] = csub(y[P - 1 - s] + sm[P + s], sm[s]);
    }
#pragma unroll
    for (int t = 0; t < P - 1 - s; ++t)
      y[t] = stage_step<EXACT>(y[t], r[s], st[(A.k + t) * P + s], q[A.k + t]);
  }

  u32* oc = A.out + static_cast<size_t>(blockIdx.y) * A.k * N + n;
#pragma unroll 4
  for (int j = 0; j < A.k; ++j) {
    const u32 qj = q[j];
    u32 v = xc[j * N];
#pragma unroll
    for (int s = 0; s < P; ++s) v = stage_step<EXACT>(v, r[s], st[j * P + s], qj);
    oc[j * N] = v;
  }
}

template <int P, bool EXACT>
int launch_div_round(const DivParams& A, int B, cudaStream_t stream) {
  const dim3 grid{static_cast<unsigned>((A.N + kThreads - 1) / kThreads),
                  static_cast<unsigned>(B), 1u};
  const int smem = A.words * static_cast<int>(sizeof(u32));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        div_round_kernel<P, EXACT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  div_round_kernel<P, EXACT><<<grid, kThreads, smem, stream>>>(A);
  return static_cast<int>(cudaGetLastError());
}

template <bool EXACT>
int div_chain(const void* x, void* out, const void* tab, int B, int k, int p, int N,
              void* stream) {
  const int w = k + p - 1;
  const DivParams A{static_cast<const u32*>(x), static_cast<u32*>(out),
                    static_cast<const u32*>(tab), k, N,
                    ((head_words(EXACT) * p + w + 3) & ~3) + 4 * w * p};
  if (A.words * sizeof(u32) > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
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
// cudaErrorInvalidValue for p outside 1..16 or a table above the 227 KB a block
// may hold.
extern "C" int hf_div_round(const void* x, void* out, const void* tab, int B, int k, int p,
                            int N, void* stream) {
  return div_chain<false>(x, out, tab, B, k, p, N, stream);
}

// The same chain in the t-exact mode: tab is the DivRoundChain.tab of DivExactT stages.
extern "C" int hf_div_exact_t(const void* x, void* out, const void* tab, int B, int k, int p,
                              int N, void* stream) {
  return div_chain<true>(x, out, tab, B, k, p, N, stream);
}
