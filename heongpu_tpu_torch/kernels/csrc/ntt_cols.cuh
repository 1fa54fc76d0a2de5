// The register-resident column transform shared by the four-step NTT K1 (ntt.cu) and
// the fused keyswitch K5 (keyswitch.cu), for Hopper (sm_90a).
//
// A row of N = n1*n2 residues is viewed as an (n1, n2) matrix (ops/ntt.py::split_n,
// n1 <= n2 <= 2*n1, N = 2^8 .. 2^16).  A pass transforms the columns of one tile of
// min(N, 2^12) words in shared memory: a column of S = 2^L <= 256 points is held in
// registers by T = S/16 threads of one warp, 16 values each.  Forward kinds (spans
// S/2 .. 1): thread k holds positions k + T*i and runs the four stages of span >= T;
// the values pass once through the warp's own columns of the tile behind a
// __syncwarp, after which thread k holds [16k, 16k + 16) and runs the log T stages of
// span < T.  Inverse kinds run the same schedule backwards.  Shapes are template
// parameters, so every index into a thread's values is a constant and every twiddle
// index a shift and mask of the lane: no run-time division and no block barrier
// between stages.  Tiles are XOR-swizzled inside each 32-word group (swz, found by
// exhaustive search per shape) so that the coalesced row copies, the strided and
// contiguous column reads and writes and the transposed read of a forward first
// pass are all free of bank conflicts.  Values stay Harvey-lazy in [0, 2p) between
// stages (ntt_common.cuh).

#pragma once

#include "ntt_common.cuh"   // csub, shoup_lazy, fold, Kind, ilog2

namespace {

constexpr int kThreads = 256;
constexpr int kVals = 16;         // values of a column a thread holds
constexpr int kTileLog = 12;      // a tile holds min(N, 2^12) words

constexpr int cmin(int a, int b) { return a < b ? a : b; }

// a - m if a >= m, else a
__device__ __forceinline__ u32 cred(u32 a, u32 m) { return min(a, a - m); }

// XOR swizzle of tile row r inside its 32-word group, per tile shape (2^LT * 16 rows,
// 2^LC columns), chosen by exhaustive search so that each access pattern of a pass
// (a warp's coalesced row copy, its strided and contiguous column reads and writes,
// a forward first pass's transposed read) hits 32 distinct banks.
template <int LT, int LC>
__device__ __forceinline__ int swz(int r) {
  if (LT == 4) return r ^ (r >> 3);               // 256 x 16
  if (LT == 3) return (r << 3) ^ ((r >> 2) * 5);  // 128 x 32
  if (LT == 2) return (r << 4) ^ ((r >> 1) * 9);  // 64 x 32, 64 x 64
  if (LT == 1) return LC == 4 ? r : r * 17;       // 32 x 16; 32 x 32, 32 x 64
  return LC == 4 ? r : r << 1;                    // 16 x 16; 16 x 32
}

// A tile of 2^LC columns of S = 2^L points each, held by 2^(L-4) threads a column:
// thread t holds column t >> LT as its k = t & (T-1)-th thread.
template <int L, int LC_>
struct Cols {
  static constexpr int LT = L - 4, T = 1 << LT, S = 1 << L, LC = LC_, C = 1 << LC;
  static constexpr int kActive = C << LT;     // threads that hold a column
  static constexpr int kWords = S << LC;      // words of the tile
  static constexpr int kPer = kWords / kThreads;  // words a thread copies
  static_assert(L >= 4 && L <= 8 && kActive <= kThreads && kWords >= kThreads, "shape");
  static_assert(LT == 0 || kActive % 32 == 0, "a column exchange needs whole warps");
  __device__ static int at(int r, int c) { return ((r << LC) | c) ^ (swz<LT, LC>(r) & 31); }
  // position of a thread's value i: strided k + T*i, contiguous 16*k + i
  template <bool STRIDED>
  __device__ static int pos(int k, int i) { return STRIDED ? k + (i << LT) : (k << 4) + i; }
};

// The two tile shapes of a four-step shape (L1, L2) = (log n1, log n2), one size.
template <int L1, int L2>
struct Tiles {
  using A = Cols<L1, cmin(L2, kTileLog - L1)>;   // columns of n1 points: the (n1, n2) view
  using B = Cols<L2, cmin(L1, kTileLog - L2)>;   // columns of n2 points: the (n2, n1) view
  static_assert(A::kWords == B::kWords, "one tile size");
  static constexpr int kTile = A::kWords;
  static constexpr int kLogTilesA = L2 - A::LC, kLogTilesB = L1 - B::LC;
};

// One butterfly stage of span 2^SIG on a column of S = 2^L points held by T = 2^(L-4)
// threads of a warp, this thread the k-th.  KIND as in ntt_common.cuh:
//  merged stages: group r >> (SIG+1), twiddle tw[2^(L-SIG-1) + group];
//  cyclic stages: twiddle tw[2^SIG + (r & (2^SIG - 1))].
// STRIDED: value i is position k + T*i (SIG >= L-4); else 16*k + i (SIG < 4).  Both
// twiddle indices reduce to shifts and masks of k and the constant i.  CT takes
// u < 2p and any v; GS takes both < 2p; both give values < 2p.  tw: (w, w_sh) pairs.
template <int KIND, int L, int SIG, bool STRIDED>
__device__ __forceinline__ void stage(u32 (&v)[kVals], const uint2* tw, int k, u32 p) {
  constexpr int LT = L - 4;
  constexpr int hs = STRIDED ? 1 << (SIG - LT) : 1 << SIG;   // span in registers
  constexpr bool ct = KIND == kMergedCT || KIND == kCyclicCT;
  constexpr bool merged = KIND == kMergedCT || KIND == kMergedGS;
  static_assert(STRIDED ? SIG >= LT : SIG < 4, "span outside the layout");
  const u32 p2 = p + p;
#pragma unroll
  for (int i = 0; i < kVals; ++i) {
    if (i & hs) continue;
    int w;
    if constexpr (merged && STRIDED) {
      w = (1 << (L - SIG - 1)) + (i >> (SIG + 1 - LT));
    } else if constexpr (merged) {
      w = (1 << (L - SIG - 1)) + (k << (3 - SIG)) + (i >> (SIG + 1));
    } else if constexpr (STRIDED) {
      w = (1 << SIG) + k + ((i & (hs - 1)) << LT);
    } else {
      w = (1 << SIG) + (i & ((1 << SIG) - 1));
    }
    const uint2 ww = tw[w];
    const u32 u = v[i], x = v[i + hs];
    if constexpr (ct) {
      const u32 t = shoup_lazy(x, ww.x, ww.y, p);
      v[i] = cred(u + t, p2);
      v[i + hs] = cred(u + p2 - t, p2);
    } else {
      v[i] = cred(u + x, p2);
      v[i + hs] = shoup_lazy(u + p2 - x, ww.x, ww.y, p);
    }
  }
}

// Stages of span 2^A, 2^(A±1), ..., 2^B.
template <int KIND, int L, int A, int B, bool STRIDED>
__device__ __forceinline__ void stages(u32 (&v)[kVals], const uint2* tw, int k, u32 p) {
  stage<KIND, L, A, STRIDED>(v, tw, k, p);
  if constexpr (A != B) stages<KIND, L, (A < B ? A + 1 : A - 1), B, STRIDED>(v, tw, k, p);
}

template <class Sh, bool STRIDED>
__device__ __forceinline__ void get(u32 (&v)[kVals], const u32* tile, int k, int col) {
#pragma unroll
  for (int i = 0; i < kVals; ++i) v[i] = tile[Sh::at(Sh::template pos<STRIDED>(k, i), col)];
}

template <class Sh, bool STRIDED>
__device__ __forceinline__ void put(const u32 (&v)[kVals], u32* tile, int k, int col) {
#pragma unroll
  for (int i = 0; i < kVals; ++i) tile[Sh::at(Sh::template pos<STRIDED>(k, i), col)] = v[i];
}

// Forward kinds (spans S/2 .. 1): strided values in, contiguous values out, through
// the warp's own columns of `tile`.
template <int KIND, class Sh>
__device__ __forceinline__ void column_fwd(u32 (&v)[kVals], u32* tile, const uint2* tw,
                                           int k, int col, u32 p) {
  constexpr int L = Sh::LT + 4, LT = Sh::LT;
  stages<KIND, L, L - 1, LT, true>(v, tw, k, p);
  if constexpr (LT > 0) {
    put<Sh, true>(v, tile, k, col);
    __syncwarp();
    get<Sh, false>(v, tile, k, col);
    stages<KIND, L, LT - 1, 0, false>(v, tw, k, p);
  }
}

// Inverse kinds (spans 1 .. S/2): contiguous values in, strided values out.
template <int KIND, class Sh>
__device__ __forceinline__ void column_inv(u32 (&v)[kVals], u32* tile, const uint2* tw,
                                           int k, int col, u32 p) {
  constexpr int L = Sh::LT + 4, LT = Sh::LT;
  if constexpr (LT > 0) {
    stages<KIND, L, 0, LT - 1, false>(v, tw, k, p);
    put<Sh, false>(v, tile, k, col);
    __syncwarp();
    get<Sh, true>(v, tile, k, col);
  }
  stages<KIND, L, LT, L - 1, true>(v, tw, k, p);
}

// The limb's packed stage table (S entries) as (w, w_sh) pairs.
template <int S>
__device__ __forceinline__ void load_table(uint2* dst, const u32* tw, const u32* tw_sh,
                                           int limb) {
  for (int i = threadIdx.x; i < S; i += kThreads)
    dst[i] = make_uint2(tw[limb * S + i], tw_sh[limb * S + i]);
}

}  // namespace
