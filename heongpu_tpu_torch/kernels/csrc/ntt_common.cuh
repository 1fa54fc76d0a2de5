// Device code shared by the kernels of heongpu_tpu_torch (sm_90a): the lazy Shoup
// product, the column butterfly stages and the pass bodies of the four-step NTT (K1,
// ntt.cu; reused by the fused keyswitch K5, keyswitch.cu), and the REDC fold of an
// exact 64-bit Montgomery sum (K2, mac.cu; reused by K5).  The TFHE chain (tfhe.cu)
// shares csub and shoup_lazy.
//
// Conventions (ops/ntt.py): primes p < 2^30; values Harvey-lazy in [0, 2p) between
// butterfly stages; a row of N = N1*N2 residues is viewed as an (N1, N2) matrix and
// each pass runs the column transforms of one (rows x C) tile in shared memory, with
// a row pitch of C + 1 words so that column and transposed accesses hit distinct
// banks; per-limb stage tables are packed, stage s at [2^(s-1), 2^s).

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

enum Kind { kMergedCT = 0, kCyclicGS = 1, kCyclicCT = 2, kMergedGS = 3 };

// Column butterfly stages on a tile of S rows (pitch `pitch`) and C columns.
// tw / tw_sh: the limb's packed stage table, stage s at [2^(s-1), 2^s).
//  merged stage s: group i < 2^(s-1), span t = S/2^s, pairs (i*2t + j, i*2t + t + j),
//                  twiddle tw[2^(s-1) + i];
//  cyclic stage s: blocks of m = 2^s, pairs (k*m + j, k*m + m/2 + j), twiddle
//                  tw[m/2 + j] indexed by the position j inside the block.
// CT kinds run stages 1..logS, GS kinds logS..1.  Ends with a barrier.
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

// The rest of a first pass once its tile is loaded (and a barrier passed): the tile
// holds columns [c0, c0+C) of a row viewed as (R, K).  Runs the first sub-transform
// down the columns and writes the tile transposed into dst viewed as (K, R).
// Forward (merged CT) applies tw_mat (mr, mr_sh: the limb's rows, indexed in the
// (R, K) input order) before the transpose; inverse (cyclic CT) applies itw_mat
// (indexed in the (K, R) output order) during the transposed write.
template <bool INV>
__device__ void pass1_tile(u32* tile, int R, int logR, int K, int C, int c0,
                           const u32* twl, const u32* twl_sh, const u32* mr,
                           const u32* mr_sh, u32 p, u32* dst) {
  const int pitch = C + 1;
  column_stages<INV ? kCyclicCT : kMergedCT>(tile, R, logR, C, pitch, twl, twl_sh, p);
  if (!INV) {
    for (int i = threadIdx.x; i < R * C; i += blockDim.x) {
      const int r = i / C, c = i - (i / C) * C;
      const size_t g = (size_t)r * K + c0 + c;
      tile[r * pitch + c] = shoup_lazy(tile[r * pitch + c], mr[g], mr_sh[g], p);
    }
    __syncthreads();
  }
  // transposed write: dst is (K, R); consecutive threads walk r
  for (int i = threadIdx.x; i < R * C; i += blockDim.x) {
    const int c = i / R, r = i - (i / R) * R;
    const size_t g = (size_t)(c0 + c) * R + r;
    u32 v = tile[r * pitch + c];
    if (INV) v = shoup_lazy(v, mr[g], mr_sh[g], p);
    dst[g] = v;
  }
}

// A whole second pass on one tile: loads columns [c0, c0+C) of src viewed as (S, K)
// into sm, runs the second sub-transform down the columns (cyclic GS forward, merged
// GS inverse), reduces to [0, p) and writes the same positions of dst.  sm holds
// S*(C+1) + 2*S words.
template <bool INV>
__device__ void pass2_tile(u32* sm, const u32* src, u32* dst, const u32* tw,
                           const u32* tw_sh, int limb, u32 p, int S, int logS, int K,
                           int C, int c0) {
  const int pitch = C + 1;
  u32* tile = sm;
  u32* twl = sm + S * pitch;
  u32* twl_sh = twl + S;
  load_twiddles(twl, twl_sh, tw, tw_sh, limb, S);
  for (int i = threadIdx.x; i < S * C; i += blockDim.x) {
    const int r = i / C, c = i - (i / C) * C;
    tile[r * pitch + c] = src[(size_t)r * K + c0 + c];
  }
  __syncthreads();
  column_stages<INV ? kMergedGS : kCyclicGS>(tile, S, logS, C, pitch, twl, twl_sh, p);
  for (int i = threadIdx.x; i < S * C; i += blockDim.x) {
    const int r = i / C, c = i - (i / C) * C;
    dst[(size_t)r * K + c0 + c] = csub(tile[r * pitch + c], p);
  }
}

int ilog2(int v) {
  int l = 0;
  while ((1 << l) < v) ++l;
  return l;
}

}  // namespace
