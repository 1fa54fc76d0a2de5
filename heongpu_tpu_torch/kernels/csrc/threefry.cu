// The uniform RNS draw of seed-expanded keys, for Hopper (sm_90a): K7.
//
// Replaces heongpu_tpu/utils/rng.py::uniform_rns (rng.py:127-140) over a JAX
// Threefry key, which XLA fused on the TPU (no Pallas code): jax.random.split of the
// key into (hi, lo) keys, jax.random.bits(k, (L,) + shape, uint32) of each under
// JAX's defaults (jax_threefry_partitionable: element c of the draw hashes the
// counter pair (c >> 32, c & 0xffffffff) and XORs the two output words), and
// (hi * 2^32 + lo) mod p_l for the element's limb l.  The seeded keys regenerate
// their uniform half this way (ringkit._regen_a, ringkit.py:203 and :375 of the JAX
// package), with the limb axis moved behind the digit axis and in Montgomery form.
//
// Bound: integer operations, about 83 of them on the ALU pipe a word against 4 bytes
// written: the 2 x 20 funnel shifts (SHF.L.W) and 2 x 21 xors (LOP3) of the two
// Threefry-2x32 hashes, which only that pipe runs, and the final conditional
// subtraction.  The design keeps everything else off that pipe:
// - No division.  The grid is the draw layout (L, d, n) itself: n along x (kWords = 4
//   words a thread, kThreads = 128 apart so that each store of a warp is coalesced),
//   the limb along y and the digit along z, from the first limb and digit l0 and j0
//   of the grid (the host launches several grids for an axis past 65535; without
//   the offsets ptxas loads the key schedules into uniform registers, 6% slower).  A
//   word's counter (l*d + j)*n + i and its output position, in the draw layout or
//   (d, L, n) when `moved`, are 32-bit multiply-adds; the wrapper refuses draws of
//   2^32 elements or more.
// - A row range.  The grid may cover only the limbs [lb, lb + rows) of the draw: the
//   counters stay those of the whole draw of L_all limbs, and the rows land in an
//   output of `rows` limbs (row l - lb).  A rank of a limb-sharded key regenerates
//   its block of a stripped key's rows this way, equal to the same rows of the
//   whole draw.  The whole draw is lb = 0, rows = L_all.  A thread's
//   words have no branch between them, so their hashes interleave; a word past the
//   row's end is hashed and not stored.  (tools/k6_k7_bench.py --variants builds
//   other words a thread and threads a block through the K7_* macros below.)
// - The key schedules are built once per launch, on the host: k2 = k0 ^ k1 ^ parity
//   and the ten injection words of each key (k_i, and k_i + i for the odd word), read
//   from the parameter bank.  A word's counter add and each injection are one add.
// - Every add is a multiply-add by `one` (a parameter that holds 1): ptxas cannot
//   fold it, so the adds go to the FMA pipe (IMAD) beside the ALU pipe's shifts
//   and xors, as do the reductions' products.
// - The reduction is lazy: hi*r1 by a Shoup product and lo by Barrett, each in
//   [0, 2p) (both take any 32-bit word), their sum below 4p < 2^32, then with `mont`
//   the Shoup product by r1 = 2^32 mod p into [0, 2p) and one conditional
//   subtraction, else two; a conditional subtraction is min(a, a - m) (IMNMX, one
//   ALU operation).  Every step is exact, so the residues are the plain version's
//   bits (utils/threefry.py::uniform_rns_plain).  The limb's table row (p,
//   floor(2^32/p), r1, floor(r1*2^32/p)) is loaded once per thread.
//
// Raw-words mode (hf_threefry_bits): the words of jax.random.bits(key, shape, uint32)
// themselves, one hash per word and no reduction, in the draw's own row-major order,
// kBitsWords = 2 words a thread, kBitsThreads = 256 apart, and the schedule from the
// host as above.  Its adds are plain adds: ptxas puts about half of them on the FMA
// pipe by itself, and a draw of one row (2^15 or 2^16 words) is too short to fill
// the card, so it waits on the hashes' latency, which an IMAD lengthens;
// tools/k6_k7_bench.py times all adds as IMADs (K7_BITS_FMA_ADDS=1) and 128 threads.
// It replaces the XLA-fused bits draw under heongpu_tpu/utils/rng.py::bits32
// (rng.py:84) on a Threefry key, which every other Threefry draw of the JAX package
// starts from: randint's two bit draws, normal's and permutation's sort keys (their
// integer and float transforms stay torch passes).  Bound by integer operations (41
// of its 72 a word on the ALU pipe only, against 4 bytes written).

#include "ntt_common.cuh"

namespace {

// Threads a block and words a thread of each mode; a build may set them (-D) to time
// other values.
#ifndef K7_THREADS
#define K7_THREADS 128
#endif
#ifndef K7_WORDS
#define K7_WORDS 4
#endif
#ifndef K7_BITS_THREADS
#define K7_BITS_THREADS 256
#endif
#ifndef K7_BITS_WORDS
#define K7_BITS_WORDS 2
#endif
// K7_BITS_FMA_ADDS=1 builds the raw-words mode with every add a multiply-add by `one`,
// as the uniform mode has them (see add).
#ifndef K7_BITS_FMA_ADDS
#define K7_BITS_FMA_ADDS 0
#endif

constexpr int kThreads = K7_THREADS;
constexpr int kWords = K7_WORDS;  // words a thread, kThreads apart
constexpr int kBitsThreads = K7_BITS_THREADS;  // the same in the raw-words mode
constexpr int kBitsWords = K7_BITS_WORDS;
constexpr int kGridMax = 65535;  // the most blocks along y or z
constexpr u32 kParity = 0x1BD11BDAu;

// One key's schedule: the starting words and the five injections into each word.
struct Schedule {
  u32 k0, k1;     // x0 = k0, x1 = c + k1
  u32 in0[5];     // added to x0 after rounds 4, 8, ..., 20: k1, k2, k0, k1, k2
  u32 in1[5];     // added to x1: k2 + 1, k0 + 2, k1 + 3, k2 + 4, k0 + 5
};

Schedule schedule(u32 k0, u32 k1) {
  const u32 k[3] = {k0, k1, k0 ^ k1 ^ kParity};
  Schedule s{k0, k1, {}, {}};
  for (int i = 0; i < 5; ++i) {
    s.in0[i] = k[(i + 1) % 3];
    s.in1[i] = k[(i + 2) % 3] + static_cast<u32>(i + 1);
  }
  return s;
}

struct DrawParams {
  u32* out;
  const uint4* tab;  // per limb: p, mu = floor(2^32/p), r1 = 2^32 mod p, floor(r1*2^32/p)
  Schedule hi, lo;   // the (hi, lo) keys of jax.random.split(key)
  u32 one;           // 1, unknown to the compiler (see add)
  int L, d, n, l0, j0;  // L: the output's limbs (the row range's length)
  int lb;               // the first limb of the row range in the whole draw
  int moved, mont;
};

struct BitsParams {
  u32* out;
  Schedule key;
  u32 one;
  u32 count;
};

// a + b as a multiply-add by one, so on the FMA pipe
__device__ __forceinline__ u32 add(u32 a, u32 b, u32 one) { return a * one + b; }

// a mod m for a < 2m: min(a, a - m), one ALU operation beside the add
__device__ __forceinline__ u32 csub1(u32 a, u32 neg_m, u32 one) {
  return min(a, add(a, neg_m, one));
}

template <int R>
__device__ __forceinline__ void mix(u32& x0, u32& x1, u32 one) {
  x0 = add(x0, x1, one);
  x1 = __funnelshift_l(x1, x1, R) ^ x0;
}

template <int R0, int R1, int R2, int R3>
__device__ __forceinline__ void four(u32& x0, u32& x1, u32 one) {
  mix<R0>(x0, x1, one);
  mix<R1>(x0, x1, one);
  mix<R2>(x0, x1, one);
  mix<R3>(x0, x1, one);
}

template <int I>
__device__ __forceinline__ void inject(u32& x0, u32& x1, const Schedule& K, u32 one) {
  x0 = add(x0, K.in0[I], one);
  x1 = add(x1, K.in1[I], one);
}

// jax.random.bits's word for counter c under a key: Threefry-2x32 of (0, c), the two
// output words XORed (a draw holds fewer than 2^32 elements).
__device__ __forceinline__ u32 threefry_bits(const Schedule& K, u32 c, u32 one) {
  u32 x0 = K.k0, x1 = add(c, K.k1, one);
  four<13, 15, 26, 6>(x0, x1, one);
  inject<0>(x0, x1, K, one);
  four<17, 29, 16, 24>(x0, x1, one);
  inject<1>(x0, x1, K, one);
  four<13, 15, 26, 6>(x0, x1, one);
  inject<2>(x0, x1, K, one);
  four<17, 29, 16, 24>(x0, x1, one);
  inject<3>(x0, x1, K, one);
  four<13, 15, 26, 6>(x0, x1, one);
  inject<4>(x0, x1, K, one);
  return x0 ^ x1;
}

__global__ void __launch_bounds__(kThreads) threefry_uniform_kernel(const DrawParams A) {
  const u32 one = A.one;
  const u32 l = A.l0 + blockIdx.y, j = A.j0 + blockIdx.z;
  const u32 n = A.n;
  const u32 i0 = blockIdx.x * (kThreads * kWords) + threadIdx.x;
  if (i0 >= n) return;
  const u32 row = (l * A.d + j) * n;  // the counter of the row's word 0
  const u32 lo = l - A.lb;             // the limb's row in the output
  u32* out = A.out + (A.moved ? (j * A.L + lo) * n : (lo * A.d + j) * n);
  const uint4 t = __ldg(A.tab + l);  // (p, mu, r1, r1_sh)
  const u32 neg_p = 0u - t.x;
  u32 v[kWords];
#pragma unroll
  for (int w = 0; w < kWords; ++w) {
    const u32 c = add(row, i0 + w * kThreads, one);
    const u32 hi = threefry_bits(A.hi, c, one);
    const u32 lo = threefry_bits(A.lo, c, one);
    // hi*r1 by Shoup and lo by Barrett, each in [0, 2p); their sum below 4p
    const u32 h = hi * t.z + __umulhi(hi, t.w) * neg_p;
    const u32 b = lo + __umulhi(lo, t.y) * neg_p;
    v[w] = add(h, b, one);
    if (A.mont) {
      v[w] = v[w] * t.z + __umulhi(v[w], t.w) * neg_p;  // [0, 2p)
    } else {
      v[w] = csub1(v[w], neg_p * 2u, one);              // [0, 2p)
    }
    v[w] = csub1(v[w], neg_p, one);
  }
#pragma unroll
  for (int w = 0; w < kWords; ++w)
    if (w * kThreads < n - i0) out[i0 + w * kThreads] = v[w];  // i0 + w * kThreads may pass 2^32
}

__global__ void __launch_bounds__(kBitsThreads) threefry_bits_kernel(const BitsParams A) {
  const u32 c0 = blockIdx.x * (kBitsThreads * kBitsWords) + threadIdx.x;
  const u32 one = K7_BITS_FMA_ADDS ? A.one : 1u;  // a literal 1: ptxas places the adds
  u32 v[kBitsWords];
#pragma unroll
  for (int w = 0; w < kBitsWords; ++w) v[w] = threefry_bits(A.key, c0 + w * kBitsThreads, one);
#pragma unroll
  for (int w = 0; w < kBitsWords; ++w)
    if (c0 + w * kBitsThreads < A.count) A.out[c0 + w * kBitsThreads] = v[w];
}

constexpr unsigned per_block = kThreads * kWords, bits_per_block = kBitsThreads * kBitsWords;

int launch_threefry(const DrawParams& A, dim3 grid, cudaStream_t stream) {
  threefry_uniform_kernel<<<grid, kThreads, 0, stream>>>(A);
  return static_cast<int>(cudaGetLastError());
}

int launch_threefry_bits(const BitsParams& A, unsigned blocks, cudaStream_t stream) {
  threefry_bits_kernel<<<blocks, kBitsThreads, 0, stream>>>(A);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out = the uniform residues of rng.uniform_rns(key, primes, (d, n)) at the limbs
// [l_begin, l_begin + l_count) of the L_all primes: (l_count, d, n), or (d, l_count, n)
// when `moved`; in Montgomery form when `mont`.  Each word is the word of the whole
// draw of L_all limbs at the same (limb, digit, index).  tab holds (p, floor(2^32/p),
// 2^32 mod p, its Shoup companion) for each of the L_all limbs; (hi0, hi1) and
// (lo0, lo1) are the keys jax.random.split(key) gives.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for an empty range, one outside [0, L_all), or a whole draw of
// 2^32 elements or more.
extern "C" int hf_threefry_uniform(void* out, const void* tab, unsigned hi0, unsigned hi1,
                                   unsigned lo0, unsigned lo1, int L_all, int l_begin,
                                   int l_count, int d, int n, int moved, int mont,
                                   void* stream) {
  const unsigned long long total = 1ull * L_all * d * n;
  if (L_all <= 0 || d <= 0 || n <= 0 || total >= (1ull << 32) || l_begin < 0 || l_count <= 0
      || l_count > L_all - l_begin)
    return static_cast<int>(cudaErrorInvalidValue);
  DrawParams A{static_cast<u32*>(out), static_cast<const uint4*>(tab), schedule(hi0, hi1),
               schedule(lo0, lo1), 1u, l_count, d, n, 0, 0, l_begin, moved, mont};
  const unsigned bx = (static_cast<unsigned>(n) + per_block - 1) / per_block;
  const int l_end = l_begin + l_count;
  for (A.l0 = l_begin; A.l0 < l_end; A.l0 += kGridMax)
    for (A.j0 = 0; A.j0 < d; A.j0 += kGridMax) {
      const dim3 grid{bx, static_cast<unsigned>(l_end - A.l0 < kGridMax ? l_end - A.l0 : kGridMax),
                      static_cast<unsigned>(d - A.j0 < kGridMax ? d - A.j0 : kGridMax)};
      const int err = launch_threefry(A, grid, static_cast<cudaStream_t>(stream));
      if (err) return err;
    }
  return 0;
}

// out[c] = the word c of jax.random.bits((k0, k1), shape, uint32) for c < count (the
// draw's elements in row-major order).  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for an empty draw or one of 2^31 words or more.
extern "C" int hf_threefry_bits(void* out, unsigned k0, unsigned k1, int count, void* stream) {
  if (count <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const BitsParams A{static_cast<u32*>(out), schedule(k0, k1), 1u, static_cast<u32>(count)};
  return launch_threefry_bits(A, (static_cast<unsigned>(count) + bits_per_block - 1) / bits_per_block,
                              static_cast<cudaStream_t>(stream));
}
