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
// One thread per output word.  The thread finds its element of the draw layout
// (L, d, n) from its output position (the draw layout itself, or (d, L, n) when
// `moved`): the counters belong to the draw layout.  It runs the two 20-round
// Threefry-2x32 hashes (rotations by __funnelshift_l), then reduces exactly: the
// high word by Barrett into [0, p), times 2^32 mod p by a Shoup product, plus the
// low word by Barrett, and with `mont` one more Shoup product by 2^32 mod p.  Every
// step is exact, so the residues are the plain version's bits
// (utils/threefry.py::uniform_rns_plain).  The per-limb table (p, floor(2^32/p),
// 2^32 mod p, its Shoup companion) is read through the read-only cache.
//
// Bound: integer operations (about 160 a word against 4 bytes written).

#include "ntt_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr u32 kParity = 0x1BD11BDAu;

struct DrawParams {
  u32* out;
  const uint4* tab;  // per limb: p, mu = floor(2^32/p), r1 = 2^32 mod p, floor(r1*2^32/p)
  u32 hi0, hi1, lo0, lo1;  // the (hi, lo) keys of jax.random.split(key)
  int L, d, n;
  int moved, mont;
};

template <int R>
__device__ __forceinline__ void mix(u32& x0, u32& x1) {
  x0 += x1;
  x1 = __funnelshift_l(x1, x1, R) ^ x0;
}

template <int R0, int R1, int R2, int R3>
__device__ __forceinline__ void four(u32& x0, u32& x1) {
  mix<R0>(x0, x1);
  mix<R1>(x0, x1);
  mix<R2>(x0, x1);
  mix<R3>(x0, x1);
}

// jax.random.bits's word for counter c under key (k0, k1): Threefry-2x32 of (0, c),
// the two output words XORed (a draw holds fewer than 2^32 elements).
__device__ __forceinline__ u32 threefry_bits(u32 k0, u32 k1, u32 c) {
  const u32 k2 = k0 ^ k1 ^ kParity;
  u32 x0 = k0, x1 = c + k1;
  four<13, 15, 26, 6>(x0, x1);
  x0 += k1;
  x1 += k2 + 1u;
  four<17, 29, 16, 24>(x0, x1);
  x0 += k2;
  x1 += k0 + 2u;
  four<13, 15, 26, 6>(x0, x1);
  x0 += k0;
  x1 += k1 + 3u;
  four<17, 29, 16, 24>(x0, x1);
  x0 += k1;
  x1 += k2 + 4u;
  four<13, 15, 26, 6>(x0, x1);
  x0 += k2;
  x1 += k0 + 5u;
  return x0 ^ x1;
}

// x mod p for any 32-bit x (mu = floor(2^32/p) leaves x - q*p below 2p).
__device__ __forceinline__ u32 barrett(u32 x, u32 p, u32 mu) {
  return csub(x - __umulhi(x, mu) * p, p);
}

__global__ void __launch_bounds__(kThreads) threefry_uniform_kernel(const DrawParams A) {
  const size_t o = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  const size_t n = A.n, per = n * A.d;
  if (o >= per * A.L) return;
  u32 l, c;
  if (A.moved) {  // output (d, L, n): o = (j * L + l) * n + i
    const u32 j = static_cast<u32>(o / (n * A.L));
    l = static_cast<u32>(o / n % A.L);
    c = (l * A.d + j) * A.n + static_cast<u32>(o % n);
  } else {
    l = static_cast<u32>(o / per);
    c = static_cast<u32>(o);
  }
  const uint4 t = __ldg(A.tab + l);  // (p, mu, r1, r1_sh)
  const u32 hi = barrett(threefry_bits(A.hi0, A.hi1, c), t.x, t.y);
  const u32 lo = barrett(threefry_bits(A.lo0, A.lo1, c), t.x, t.y);
  u32 v = csub(csub(shoup_lazy(hi, t.z, t.w, t.x), t.x) + lo, t.x);
  if (A.mont) v = csub(shoup_lazy(v, t.z, t.w, t.x), t.x);
  A.out[o] = v;
}

int launch_threefry(const DrawParams& A, unsigned blocks, cudaStream_t stream) {
  threefry_uniform_kernel<<<blocks, kThreads, 0, stream>>>(A);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out = the uniform residues of rng.uniform_rns(key, primes, (d, n)): (L, d, n), or
// (d, L, n) when `moved`; in Montgomery form when `mont`.  tab holds (p, floor(2^32/p),
// 2^32 mod p, its Shoup companion) per limb; (hi0, hi1) and (lo0, lo1) are the keys
// jax.random.split(key) gives.  Returns cudaGetLastError(), or cudaErrorInvalidValue
// for an empty draw or one of 2^32 elements or more.
extern "C" int hf_threefry_uniform(void* out, const void* tab, unsigned hi0, unsigned hi1,
                                   unsigned lo0, unsigned lo1, int L, int d, int n, int moved,
                                   int mont, void* stream) {
  const unsigned long long total = 1ull * L * d * n;
  if (L <= 0 || d <= 0 || n <= 0 || total >= (1ull << 32))
    return static_cast<int>(cudaErrorInvalidValue);
  const DrawParams A{static_cast<u32*>(out), static_cast<const uint4*>(tab), hi0, hi1, lo0,
                     lo1, L, d, n, moved, mont};
  return launch_threefry(A, static_cast<unsigned>((total + kThreads - 1) / kThreads),
                         static_cast<cudaStream_t>(stream));
}
