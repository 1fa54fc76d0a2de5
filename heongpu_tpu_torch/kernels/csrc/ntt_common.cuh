// Device code shared by the kernels of heongpu_tpu_torch (sm_90a): the lazy Shoup
// product and the butterfly kinds of the four-step NTT (the column transform built on
// them is ntt_cols.cuh, shared by K1, ntt.cu, and the fused keyswitch K5,
// keyswitch.cu), and the REDC fold of an exact 64-bit Montgomery sum (K2, mac.cu;
// reused by K5).  The TFHE chain (tfhe.cu) shares csub and shoup_lazy.
//
// Conventions (ops/ntt.py): primes p < 2^30; values Harvey-lazy in [0, 2p) between
// butterfly stages; per-limb stage tables are packed, stage s at [2^(s-1), 2^s).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

typedef uint32_t u32;
typedef uint64_t u64;

namespace {

__device__ __forceinline__ u32 csub(u32 a, u32 m) { return a >= m ? a - m : a; }

// a*w mod p in [0, 2p) for any 32-bit a, w < p, w_sh = floor(w*2^32/p).
__device__ __forceinline__ u32 shoup_lazy(u32 a, u32 w, u32 w_sh, u32 p) {
  return a * w - __umulhi(a, w_sh) * p;
}

// X = hi*2^32 + lo  ->  X * 2^-32 mod p, canonical, for any 64-bit X; pinv = -p^-1
// mod 2^32, mu = floor(2^32/p).
__device__ __forceinline__ u32 fold(u64 acc, u32 p, u32 pinv, u32 mu) {
  const u32 hi = static_cast<u32>(acc >> 32);
  const u32 lo = static_cast<u32>(acc);
  u32 hm = hi - __umulhi(hi, mu) * p;            // Barrett
  hm = csub(csub(csub(hm, p), p), p);
  const u32 m = lo * pinv;
  const u32 t = hm + __umulhi(m, p) + (lo != 0u);  // < 2p + 1
  return csub(csub(t, p), p);
}

// The butterfly kinds of the four-step transform's column stages:
//  merged (negacyclic) stage s: groups of span t = S/2^s, pairs (i*2t + j, i*2t + t + j),
//                               twiddle tw[2^(s-1) + i];
//  cyclic stage s: blocks of m = 2^s, pairs (k*m + j, k*m + m/2 + j), twiddle
//                  tw[m/2 + j] indexed by the position j inside the block.
// CT kinds run stages 1..log S (forward pass 1: merged; inverse pass 1: cyclic), GS
// kinds log S..1 (forward pass 2: cyclic; inverse pass 2: merged).
enum Kind { kMergedCT = 0, kCyclicGS = 1, kCyclicCT = 2, kMergedGS = 3 };

int ilog2(int v) {
  int l = 0;
  while ((1 << l) < v) ++l;
  return l;
}

}  // namespace
