// Lazy Montgomery multiply-accumulate over RNS limbs, for Hopper (sm_90a).
//
// Replaces heongpu_tpu/ops/rns.py::lazy_mac_mont, which XLA fused on the TPU
// (no Pallas code).  It is both the keyswitch key MAC
// (heongpu_tpu/ops/keyswitch2.py:105-106) and FastBconv's
// convert_from_digits (rns.py:199-205).  Each thread owns one (limb,
// coefficient): it sums exact 64-bit products d*k (k in Montgomery form k*R,
// R = 2^32), at most 16 of them per accumulator (16 products of values below
// 2^30 fit in 64 bits), then folds the sum X to X*R^-1 mod p with one REDC
// after a Barrett pre-reduction of the high word; folds of successive
// 16-term chunks are added mod p (fold: ntt_common.cuh).  The result,
// sum d*k*R^-1 mod p, is exact, so it equals the plain int64 version bit for
// bit.
//
// What bounds it on this card: device-memory bandwidth.  mac_keys reads each
// digit once for both key halves (3 words read per 2 products), and the
// arithmetic is a handful of 32/64-bit integer ops per word.  base_conv reads
// each input limb once per output limb; its conversion matrix is tiny and
// is served from the constant cache / L1.

#include "ntt_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 16;

__global__ void __launch_bounds__(kThreads)
mac_keys_kernel(const u32* __restrict__ d, const u32* __restrict__ k0,
                const u32* __restrict__ k1, u32* __restrict__ out,
                const u32* __restrict__ pv, const u32* __restrict__ pinvv,
                const u32* __restrict__ muv, int D, int L, int N) {
  const size_t LN = (size_t)L * N;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= LN) return;
  const int limb = static_cast<int>(idx / N);
  const u32 p = pv[limb], pinv = pinvv[limb], mu = muv[limb];
  u32 r0 = 0, r1 = 0;
  for (int c0 = 0; c0 < D; c0 += kChunk) {
    u64 a0 = 0, a1 = 0;
    const int c1 = c0 + kChunk < D ? c0 + kChunk : D;
    for (int j = c0; j < c1; ++j) {
      const size_t o = (size_t)j * LN + idx;
      const u64 dv = d[o];
      a0 += dv * k0[o];
      a1 += dv * k1[o];
    }
    r0 = csub(r0 + fold(a0, p, pinv, mu), p);
    r1 = csub(r1 + fold(a1, p, pinv, mu), p);
  }
  out[idx] = r0;
  out[LN + idx] = r1;
}

__global__ void __launch_bounds__(kThreads)
base_conv_kernel(const u32* __restrict__ z, const u32* __restrict__ mat,
                 u32* __restrict__ out, const u32* __restrict__ pv,
                 const u32* __restrict__ pinvv, const u32* __restrict__ muv,
                 int B, int Kin, int Kout, int N) {
  const size_t total = (size_t)B * Kout * N;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int n = static_cast<int>(idx % N);
  const int o = static_cast<int>((idx / N) % Kout);
  const size_t b = idx / ((size_t)N * Kout);
  const u32 p = pv[o], pinv = pinvv[o], mu = muv[o];
  const u32* zb = z + b * Kin * N + n;
  u32 r = 0;
  for (int c0 = 0; c0 < Kin; c0 += kChunk) {
    u64 a = 0;
    const int c1 = c0 + kChunk < Kin ? c0 + kChunk : Kin;
    for (int i = c0; i < c1; ++i) a += (u64)zb[(size_t)i * N] * mat[i * Kout + o];
    r = csub(r + fold(a, p, pinv, mu), p);
  }
  out[idx] = r;
}

unsigned blocks_for(size_t n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

}  // namespace

// out (2, L, N) = (sum_j d[j]*k0[j]*R^-1, sum_j d[j]*k1[j]*R^-1) mod p_l;
// d, k0, k1: (D, L, N).  Returns cudaGetLastError().
extern "C" int hf_mac_keys(const void* d, const void* k0, const void* k1, void* out,
                           const void* p, const void* pinv, const void* mu,
                           int D, int L, int N, void* stream) {
  mac_keys_kernel<<<blocks_for((size_t)L * N), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const u32*>(d), static_cast<const u32*>(k0),
      static_cast<const u32*>(k1), static_cast<u32*>(out), static_cast<const u32*>(p),
      static_cast<const u32*>(pinv), static_cast<const u32*>(mu), D, L, N);
  return static_cast<int>(cudaGetLastError());
}

// out (B, Kout, N) = sum_i z[b, i] * mat[i, o] * R^-1 mod p_o;
// z: (B, Kin, N), mat: (Kin, Kout) Montgomery form.  Returns cudaGetLastError().
extern "C" int hf_base_conv(const void* z, const void* mat, void* out, const void* p,
                            const void* pinv, const void* mu, int B, int Kin, int Kout,
                            int N, void* stream) {
  base_conv_kernel<<<blocks_for((size_t)B * Kout * N), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const u32*>(z), static_cast<const u32*>(mat), static_cast<u32*>(out),
      static_cast<const u32*>(p), static_cast<const u32*>(pinv),
      static_cast<const u32*>(mu), B, Kin, Kout, N);
  return static_cast<int>(cudaGetLastError());
}
