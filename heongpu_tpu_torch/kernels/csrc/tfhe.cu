// TFHE blind rotation (the whole CMux chain of a gate bootstrap) for Hopper (sm_90a).
//
// K3 (UNROLLED = false) replaces the TPU kernel
// heongpu_tpu/ops/tfhe_kernel.py::blind_rotate (_make_kernel), K4 (UNROLLED = true)
// replaces heongpu_tpu/ops/tfhe_kernel.py::blind_rotate2 (_make_kernel2).  They compute
// what those compute, on the natural layouts of heongpu_tpu_torch/models/tfhe.py:
//   acc  (B, 2 polys, 2 limbs, 1024)  NTT domain, storage order eval_order(1024)
//   a_t  (B, n) rotation amounts, read mod 2N
//   key  K3: (n, 4 rows, 2 comps, 2 limbs, 1024);  K4: (n/2, 3, 4, 2, 2, 1024)
//        NTT domain, Montgomery form (R = 2^32)
// and return the final NTT-domain accumulator.  Each K3 step: X^a, diff = X^a*acc -
// acc, INTT, CRT to Torus32, signed gadget decomposition (l = 2, Bg = 2^10), forward
// NTT of the 4x2 digit rows, the external product with the step's TGSW rows and the
// accumulate; every 8 steps the accumulator is renormalised (INTT, torus, RNS, NTT).
// K4 runs n/2 pair steps of
//   acc += <D(acc), B0>*u0 + <D(acc), B1>*u1 + <D(acc), B01>*u0*u1,  u = X^a - 1,
// with one decomposition per pair and a renorm every 4 pair steps.  All arithmetic is
// exact mod p with canonical results, so the output equals the plain chains
// (blind_rotate_plain / blind_rotate2_plain) bit for bit.
//
// Design.  One block of 512 threads per gate runs the whole chain in one launch, with
// everything it rereads in shared memory (184 KB): the accumulator, the INTT scratch,
// the eight digit rows, the cross and stage twiddles, the psi-power table of X^a and
// the step's key rows.  A step is a round of four phases between block barriers:
//   A. the INTT of the 4 rows to decompose, one warp a row (K3 forms X^a*acc - acc
//      as the rows load);
//   B. CRT to the torus, all threads;
//   C. the signed digits and their forward NTT, one warp a row (8 rows);
//   D. the external product, all threads;
// a renormalisation is a round of A, B and C alone (C turning the torus words back
// into residues of acc).  A 1024-point row is a (32, 32) four-step transform owned
// by one warp: each lane holds one column (forward) or one row (inverse) of 32 values
// in registers and runs five butterfly stages there, then the cross twiddle, one
// transpose through the row's own padded (pitch 33, conflict-free) shared tile behind
// a __syncwarp, five more stages and one write.  Element (r, c) is coefficient
// r*32 + c and NTT storage position c*32 + r, so the packed stage tables of NttTables
// are used as they are; stage twiddles do not depend on the lane (shared-memory
// broadcasts).  Three things keep the transform fast on this card: each stage is a
// template instance, so every index into the 32 values is a constant and they stay
// in registers; each transform has one call site, so the kernel's code stays small
// for the instruction cache; a lane loads its 32 inputs before it stores anything,
// so the loads overlap.  CT butterflies are Harvey-lazy ([0, 4p)), and the first
// butterflies of each cyclic stage, whose twiddle is 1, do no product.
// X^a at NTT position pos is psi^((2*eo[pos] + 1)*a mod 2N): one lookup in a (2, 2N)
// Montgomery table of psi^j.  The CRT to the torus and back uses a Shoup product and
// conditional subtracts (no division).  The MAC sums up to four 64-bit products and
// reduces once (one REDC).  The first 64 KB of step i+1's key (K3: all of it; K4:
// B0) is copied into shared memory by cp.async right after step i's MAC and lands
// while step i+1 runs phases A-C; K4's B1 and B01 (128 KB, no room beside the rest)
// are read through L2 at the point of use, where their loads overlap the MAC's
// arithmetic (an L2 prefetch a pair step ahead timed no faster on the card).
//
// What bounds it: one SM per gate.  A step's 12 transforms are ~405k int32
// operations, 3.2 us at one SM's share of the card's int32 rate; phases A and C keep
// only 4 and 8 warps busy, and a warp's butterflies issue at well under one
// instruction a cycle.  Spreading a gate over several SMs (a cluster) is later work.

#include <cuda_pipeline.h>

#include "ntt_common.cuh"   // shoup_lazy

namespace {

constexpr int kN = 1024;             // TRLWE degree, N1 = N2 = 32
constexpr int kTwoN = 2 * kN;
constexpr int kPitch = 33;           // padded row pitch of the (32, 32) view
constexpr int kRow = 32 * kPitch;    // shared-memory words per polynomial row
constexpr int kThreads = 512;
constexpr int kBgBit = 10;
constexpr u32 kBgMask = (1u << kBgBit) - 1;
constexpr u32 kBgHalf = 1u << (kBgBit - 1);
constexpr u32 kOffset = (kBgHalf << (32 - kBgBit)) + (kBgHalf << (32 - 2 * kBgBit));
constexpr int kRenorm = 8;           // K3 steps between renormalisations
constexpr int kRenorm2 = 4;          // K4 pair steps between renormalisations
constexpr int kRowWords = 2 * 2 * kN;  // one TGSW row: 2 comps x 2 limbs x N
constexpr int kSlice = 4 * kRowWords;  // the 4 TGSW rows of one CMux: 64 KB

// dynamic shared memory, in words
constexpr int kKeyOff = 0;                     // kSlice: the step's first 4 key rows
constexpr int kXtwOff = kKeyOff + kSlice;      // uint2 (2 limbs, fwd/inv, N) cross twiddles
constexpr int kStwOff = kXtwOff + 2 * 2 * kN * 2;  // uint2 (2 limbs, 4 tables, 32) stage twiddles
constexpr int kPsiOff = kStwOff + 2 * 4 * 32 * 2;  // (2 limbs, 2N) Montgomery psi^j
constexpr int kExpOff = kPsiOff + 2 * kTwoN;   // (N,) 2*eo[pos] + 1
constexpr int kAccOff = kExpOff + kN;          // 4 rows (poly, limb), NTT domain
constexpr int kTmpOff = kAccOff + 4 * kRow;    // 4 rows: INTT output, then torus words
constexpr int kDigOff = kTmpOff + 4 * kRow;    // 8 rows ((poly, digit), limb)
constexpr int kSmemWords = kDigOff + 8 * kRow;

// stage tables per limb: merged forward, cyclic forward, merged inverse, cyclic inverse
enum { kTw1 = 0, kTw2 = 32, kItw1 = 64, kItw2 = 96 };

struct Tables {
  const u32* p;       // (2,)
  const u32* pinv;    // (2,) -p^-1 mod 2^32
  const u32* r1;      // (2,) 2^32 mod p (Montgomery one)
  const u32* psi;     // (2, 2N) Montgomery psi^j
  const u32* exps;    // (N,) 2*eo[pos] + 1
  const u32* stage[8];  // (2, 32) packed: tw1, tw1_sh, tw2, tw2_sh, itw1, itw1_sh, itw2, itw2_sh
  const u32* twm;     // (2, N) forward cross twiddles and Shoup companions
  const u32* twm_sh;
  const u32* itwm;    // (2, N) inverse cross twiddles (n^-1 psi^-i folded in)
  const u32* itwm_sh;
  u32 inv_p1_p2;      // p1^-1 mod p2 and its Shoup companion
  u32 inv_p1_p2_sh;
};

// per-limb constants held in registers
struct Limbs {
  u32 p[2], pinv[2], r1[2];
  u64 p12, half;  // P = p1*p2 and floor(P/2)
  __device__ u32 P(int l) const { return l ? p[1] : p[0]; }
  __device__ u32 PI(int l) const { return l ? pinv[1] : pinv[0]; }
  __device__ u32 R1(int l) const { return l ? r1[1] : r1[0]; }
};

// a - m if a >= m, else a: a subtract and an unsigned min, one ALU instruction less
// than csub's compare and select.
__device__ __forceinline__ u32 cred(u32 a, u32 m) { return min(a, a - m); }
__device__ __forceinline__ u32 add_mod(u32 a, u32 b, u32 p) { return cred(a + b, p); }
__device__ __forceinline__ u32 sub_mod(u32 a, u32 b, u32 p) { return a >= b ? a - b : a + p - b; }

// T*2^-32 mod p (REDC), canonical, for T < 4p^2 (a sum of up to four products of
// residues): the quotient is below T/2^32 + p < 2p, since 4p < 2^32.
__device__ __forceinline__ u32 redc(u64 T, u32 p, u32 pinv) {
  const u32 m = (u32)T * pinv;
  return cred((u32)((T + (u64)m * p) >> 32), p);
}

// a*b*2^-32 mod p, a, b < p < 2^30; canonical result.
__device__ __forceinline__ u32 mont_mul(u32 a, u32 b, u32 p, u32 pinv) {
  return redc((u64)a * b, p, pinv);
}

// shared-memory index of NTT storage position pos: (r, c) = (pos % 32, pos / 32)
__device__ __forceinline__ int sidx(int pos) { return (pos & 31) * kPitch + (pos >> 5); }
// shared-memory index of coefficient q: (r, c) = (q / 32, q % 32)
__device__ __forceinline__ int cidx(int q) { return (q >> 5) * kPitch + (q & 31); }

// One butterfly on two of a lane's values.  CT (a, b) -> (a + w*b, a - w*b) takes
// a < 4p and any b and gives both < 4p (Harvey's lazy form); GS (a, b) -> (a + b,
// (a - b)*w) takes and gives values < 2p.  w = (twiddle, Shoup companion).
template <bool CT>
__device__ __forceinline__ void butterfly(u32& a, u32& b, uint2 w, u32 p) {
  const u32 p2 = p + p;
  if (CT) {
    const u32 u = cred(a, p2), tt = shoup_lazy(b, w.x, w.y, p);
    a = u + tt;
    b = u + p2 - tt;
  } else {
    const u32 u = a;
    a = cred(u + b, p2);
    b = shoup_lazy(u + p2 - b, w.x, w.y, p);
  }
}

// One merged-negacyclic stage S on a lane's 32 values: groups i < 2^(S-1) of span
// 32 >> S, twiddle tw[2^(S-1) + i].  S is a template parameter so that every index
// is a constant after unrolling and v stays in registers.
template <int S, bool CT>
__device__ __forceinline__ void merged_stage(u32 (&v)[32], const uint2* tw, u32 p) {
  constexpr int t = 32 >> S;
#pragma unroll
  for (int i = 0; i < (1 << (S - 1)); ++i) {
    const uint2 w = tw[(1 << (S - 1)) + i];
#pragma unroll
    for (int j = 0; j < t; ++j) butterfly<CT>(v[i * 2 * t + j], v[i * 2 * t + t + j], w, p);
  }
}

// The butterfly with twiddle 1: the same bounds, no product.
template <bool CT>
__device__ __forceinline__ void butterfly1(u32& a, u32& b, u32 p) {
  const u32 p2 = p + p;
  if (CT) {
    const u32 u = cred(a, p2), tt = cred(b, p2);
    a = u + tt;
    b = u + p2 - tt;
  } else {
    const u32 u = a;
    a = cred(u + b, p2);
    b = cred(u + p2 - b, p2);
  }
}

// One cyclic stage S: blocks of 2^S, pairs (j, j + 2^(S-1)) inside a block, twiddle
// tw[2^(S-1) + j]; the first twiddle of each stage is w^0 = 1 (31 of the 80
// butterflies of a cyclic half).
template <int S, bool CT>
__device__ __forceinline__ void cyclic_stage(u32 (&v)[32], const uint2* tw, u32 p) {
  constexpr int hm = 1 << (S - 1);
#pragma unroll
  for (int blk = 0; blk < 16 / hm; ++blk) butterfly1<CT>(v[blk * 2 * hm], v[blk * 2 * hm + hm], p);
#pragma unroll
  for (int j = 1; j < hm; ++j) {
    const uint2 w = tw[hm + j];
#pragma unroll
    for (int blk = 0; blk < 16 / hm; ++blk)
      butterfly<CT>(v[blk * 2 * hm + j], v[blk * 2 * hm + hm + j], w, p);
  }
}

// Forward transform of one row by one warp into `row` (the warp's own tile).  Lane c
// takes column c (coefficients r*32 + c, r < 32) from load(r), values < 4p, all 32
// before any store so that the loads overlap; merged-negacyclic CT stages down the
// column, the cross twiddle, the transpose through the tile behind a __syncwarp,
// cyclic GS stages along row `lane`; writes NTT storage position c*32 + lane at
// (lane, c), canonical.  st: the limb's stage tables; xtw: its forward cross twiddles.
template <class Load>
__device__ __forceinline__ void warp_ntt_fwd(u32* row, const uint2* st, const uint2* xtw,
                                             u32 p, Load load) {
  const int lane = threadIdx.x & 31;
  u32 v[32];
#pragma unroll
  for (int r = 0; r < 32; ++r) v[r] = load(r);
  merged_stage<1, true>(v, st + kTw1, p);
  merged_stage<2, true>(v, st + kTw1, p);
  merged_stage<3, true>(v, st + kTw1, p);
  merged_stage<4, true>(v, st + kTw1, p);
  merged_stage<5, true>(v, st + kTw1, p);
#pragma unroll
  for (int r = 0; r < 32; ++r) {
    const uint2 w = xtw[r * 32 + lane];
    row[r * kPitch + lane] = shoup_lazy(v[r], w.x, w.y, p);
  }
  __syncwarp();
#pragma unroll
  for (int c = 0; c < 32; ++c) v[c] = row[lane * kPitch + c];
  cyclic_stage<5, false>(v, st + kTw2, p);
  cyclic_stage<4, false>(v, st + kTw2, p);
  cyclic_stage<3, false>(v, st + kTw2, p);
  cyclic_stage<2, false>(v, st + kTw2, p);
  cyclic_stage<1, false>(v, st + kTw2, p);
#pragma unroll
  for (int c = 0; c < 32; ++c) row[lane * kPitch + c] = cred(v[c], p);
}

// Inverse transform of one row by one warp into `row` (the warp's own tile).  Lane r
// takes row r (NTT storage positions c*32 + r, c < 32) from load(c), values < p, all
// 32 before any store; cyclic CT stages along the row, the transpose through the tile
// behind a __syncwarp, the inverse cross twiddle, merged-negacyclic GS stages down
// column `lane`; writes coefficient r*32 + lane at (r, lane), canonical.
template <class Load>
__device__ __forceinline__ void warp_ntt_inv(u32* row, const uint2* st, const uint2* ixtw,
                                             u32 p, Load load) {
  const int lane = threadIdx.x & 31;
  u32 v[32];
#pragma unroll
  for (int c = 0; c < 32; ++c) v[c] = load(c);
  cyclic_stage<1, true>(v, st + kItw2, p);
  cyclic_stage<2, true>(v, st + kItw2, p);
  cyclic_stage<3, true>(v, st + kItw2, p);
  cyclic_stage<4, true>(v, st + kItw2, p);
  cyclic_stage<5, true>(v, st + kItw2, p);
#pragma unroll
  for (int c = 0; c < 32; ++c) row[lane * kPitch + c] = v[c];
  __syncwarp();
#pragma unroll
  for (int r = 0; r < 32; ++r) {
    const uint2 w = ixtw[r * 32 + lane];
    v[r] = shoup_lazy(row[r * kPitch + lane], w.x, w.y, p);
  }
  merged_stage<5, false>(v, st + kItw1, p);
  merged_stage<4, false>(v, st + kItw1, p);
  merged_stage<3, false>(v, st + kItw1, p);
  merged_stage<2, false>(v, st + kItw1, p);
  merged_stage<1, false>(v, st + kItw1, p);
#pragma unroll
  for (int r = 0; r < 32; ++r) row[r * kPitch + lane] = cred(v[r], p);
}

// CRT pair residues -> the centered value mod 2^32 (Torus32), without division:
// r1 < p1 < 2^30 < 2*p2, and d*p1^-1 mod p2 is a Shoup product.
__device__ __forceinline__ u32 to_torus(u32 r1, u32 r2, const Limbs& L, u32 inv, u32 inv_sh) {
  const u32 p1 = L.p[0], p2 = L.p[1];
  const u32 d = sub_mod(r2, cred(r1, p2), p2);
  const u32 t = cred(shoup_lazy(d, inv, inv_sh, p2), p2);
  const u64 v = (u64)t * p1 + r1;  // in [0, P)
  return (u32)(v >= L.half ? v - L.p12 : v);
}

// Torus32 word read as a signed value -> residue mod p; |v| <= 2^31 < 4p for p > 2^29.
__device__ __forceinline__ u32 to_rns(u32 v, u32 p) {
  const bool neg = v >> 31;
  const u32 m = cred(cred(neg ? 0u - v : v, p + p), p);
  return (neg && m) ? p - m : m;
}

// Phase B: tmp rows (poly, limb) hold coefficient residues; row 2*poly gets the
// torus word plus `add` (the decomposition offset, or 0 for a renorm).
// The thread's four pairs are loaded before any store so that the loads overlap.
__device__ __forceinline__ void crt_rows(u32* tmp, const Limbs& L, const Tables& T, u32 add) {
  constexpr int kPer = 2 * kN / kThreads;
  u32* r0[kPer];
  u32 a[kPer], b[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int e = threadIdx.x + k * kThreads;
    r0[k] = tmp + 2 * (e >> 10) * kRow + cidx(e & (kN - 1));
    a[k] = *r0[k];
    b[k] = r0[k][kRow];
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k)
    *r0[k] = to_torus(a[k], b[k], L, T.inv_p1_p2, T.inv_p1_p2_sh) + add;
}

// Starts the copy of one step's first kSlice key words into shared memory.
__device__ __forceinline__ void stage_key(u32* keybuf, const u32* src) {
  for (int j = threadIdx.x; j < kSlice / 4; j += kThreads)
    __pipeline_memcpy_async(keybuf + 4 * j, src + 4 * j, 16);
  __pipeline_commit();
}

template <bool UNROLLED>
__global__ void __launch_bounds__(kThreads, 1)
blind_rotate_kernel(const u32* __restrict__ acc_in, u32* __restrict__ acc_out,
                    const int* __restrict__ a_t, const u32* __restrict__ key, int n,
                    Tables T) {
  extern __shared__ __align__(16) u32 sm[];
  u32* keybuf = sm + kKeyOff;
  uint2* xtw = reinterpret_cast<uint2*>(sm + kXtwOff);
  uint2* stw = reinterpret_cast<uint2*>(sm + kStwOff);
  u32* psi = sm + kPsiOff;
  u32* exps = sm + kExpOff;
  u32* acc = sm + kAccOff;
  u32* tmp = sm + kTmpOff;
  u32* dig = sm + kDigOff;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const size_t gate = blockIdx.x;
  const int steps = UNROLLED ? n / 2 : n;
  const size_t stride = (size_t)(UNROLLED ? 3 : 1) * kSlice;  // key words per step
  const int* as = a_t + gate * n;

  stage_key(keybuf, key);
  Limbs L;
  for (int l = 0; l < 2; ++l) {
    L.p[l] = T.p[l];
    L.pinv[l] = T.pinv[l];
    L.r1[l] = T.r1[l];
  }
  L.p12 = (u64)L.p[0] * L.p[1];
  L.half = L.p12 >> 1;
  for (int i = t; i < 2 * 2 * kN; i += kThreads) {  // (limb, fwd/inv, idx)
    const int g = (i >> 11) * kN + (i & (kN - 1));
    xtw[i] = (i >> 10) & 1 ? make_uint2(T.itwm[g], T.itwm_sh[g])
                           : make_uint2(T.twm[g], T.twm_sh[g]);
  }
  for (int i = t; i < 2 * 4 * 32; i += kThreads) {  // (limb, table, idx)
    const int k = 2 * ((i >> 5) & 3), g = (i >> 7) * 32 + (i & 31);
    stw[i] = make_uint2(T.stage[k][g], T.stage[k + 1][g]);
  }
  for (int i = t; i < 2 * kTwoN; i += kThreads) psi[i] = T.psi[i];
  for (int i = t; i < kN; i += kThreads) exps[i] = T.exps[i];
  for (int i = t; i < 4 * kN; i += kThreads)
    acc[(i >> 10) * kRow + sidx(i & (kN - 1))] = acc_in[gate * 4 * kN + i];
  __syncthreads();

  // the warp's row in phases A and C: (poly, limb) = (warp >> 1, warp & 1) in A and a
  // renorm's C, ((poly, digit), limb) in a step's C; one limb per warp
  const int wl = warp & 1;
  const u32 wp = L.P(wl);
  const uint2* wst = stw + wl * 128;
  const uint2* wxtw = xtw + wl * 2 * kN;
  const uint2* wixtw = wxtw + kN;

  // Rounds: a step (K3: one CMux; K4: a pair step) or, after every kRenorm (kRenorm2)
  // steps, a renormalisation.  Each round runs A, B and C; a step adds D.
  int i = 0;
  bool renorm = false;
  while (i < steps) {
    // A. INTT of the rows to decompose: X^a*acc - acc (K3 step) or acc
    if (warp < 4) {
      const u32* src = acc + warp * kRow;
      const bool diff = !UNROLLED && !renorm;
      const u32 a = diff ? as[i] & (kTwoN - 1) : 0, wpinv = L.PI(wl);
      const u32* ps = psi + wl * kTwoN;
      warp_ntt_inv(tmp + warp * kRow, wst, wixtw, wp, [&](int c) {  // position c*32 + lane
        const u32 x = src[lane * kPitch + c];
        if (!diff) return x;
        const u32 w = ps[(exps[c * 32 + lane] * a) & (kTwoN - 1)];
        return sub_mod(mont_mul(x, w, wp, wpinv), x, wp);
      });
    }
    __syncthreads();

    // B. CRT to the torus, plus the gadget offset in a step
    crt_rows(tmp, L, T, renorm ? 0u : kOffset);
    __syncthreads();

    // C. a step's 8 rows of signed gadget digits, or a renorm's 4 rows of residues
    // of the torus words, and their NTT (into dig, or back into acc)
    if (warp < (renorm ? 4 : 8)) {
      const u32* tor = tmp + 2 * (renorm ? warp >> 1 : warp >> 2) * kRow;
      const int sh = 32 - (((warp >> 1) & 1) + 1) * kBgBit;
      warp_ntt_fwd((renorm ? acc : dig) + warp * kRow, wst, wxtw, wp, [&](int r) {
        const u32 u = tor[r * kPitch + lane];  // coefficient r*32 + lane
        if (renorm) return to_rns(u, wp);
        const u32 dg = (u >> sh) & kBgMask;
        return dg >= kBgHalf ? dg - kBgHalf : wp - (kBgHalf - dg);
      });
    }
    if (renorm) {
      __syncthreads();
      renorm = false;
      ++i;
      continue;
    }
    __pipeline_wait_prior(0);
    __syncthreads();

    // D. external product with the step's key rows, accumulated into acc
    const u32* kg = key + i * stride;
    if (!UNROLLED) {
      // the thread's four elements: every load before any store
      constexpr int kPer = 2 * kN / kThreads;
      u32 dv[kPer][4], kw[kPer][2][4], av[kPer][2];
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int e = t + k * kThreads, limb = e >> 10, pos = e & (kN - 1), x = sidx(pos);
        const u32* kb = keybuf + limb * kN + pos;  // row r, comp c at kb[(r*2 + c)*2*kN]
#pragma unroll
        for (int row = 0; row < 4; ++row) {
          dv[k][row] = dig[(row * 2 + limb) * kRow + x];
          kw[k][0][row] = kb[row * 4 * kN];
          kw[k][1][row] = kb[row * 4 * kN + 2 * kN];
        }
        av[k][0] = acc[limb * kRow + x];
        av[k][1] = acc[(2 + limb) * kRow + x];
      }
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int e = t + k * kThreads, limb = e >> 10, x = sidx(e & (kN - 1));
        const u32 p = L.P(limb), pinv = L.PI(limb);
#pragma unroll
        for (int cp = 0; cp < 2; ++cp) {
          u64 s = 0;
#pragma unroll
          for (int row = 0; row < 4; ++row) s += (u64)dv[k][row] * kw[k][cp][row];
          acc[(cp * 2 + limb) * kRow + x] = add_mod(av[k][cp], redc(s, p, pinv), p);
        }
      }
    } else {
      // the rows of B1 and B01 come through L2: all 64 loads of the thread first
      u32 kv[2 * kN / kThreads][2][2][4];  // (element, B1 or B01, comp, row)
#pragma unroll
      for (int k = 0; k < 2 * kN / kThreads; ++k) {
        const int e = t + k * kThreads;
        const u32* kl = kg + kSlice + (e >> 10) * kN + (e & (kN - 1));
#pragma unroll
        for (int tt = 0; tt < 2; ++tt)
#pragma unroll
          for (int cp = 0; cp < 2; ++cp)
#pragma unroll
            for (int row = 0; row < 4; ++row)
              kv[k][tt][cp][row] = __ldg(kl + tt * kSlice + (row * 2 + cp) * 2 * kN);
      }
      // pass 1, loads only: <D, B_t> per (element, comp, t), reduced
      constexpr int kPer = 2 * kN / kThreads;
      u32 red[kPer][2][3];
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int e = t + k * kThreads, limb = e >> 10, pos = e & (kN - 1), x = sidx(pos);
        const u32 p = L.P(limb), pinv = L.PI(limb);
        const u32* kb = keybuf + limb * kN + pos;
#pragma unroll
        for (int cp = 0; cp < 2; ++cp) {
          u64 s0 = 0, s1 = 0, s2 = 0;
#pragma unroll
          for (int row = 0; row < 4; ++row) {
            const u64 d = dig[(row * 2 + limb) * kRow + x];
            s0 += d * kb[(row * 2 + cp) * 2 * kN];
            s1 += d * kv[k][0][cp][row];
            s2 += d * kv[k][1][cp][row];
          }
          red[k][cp][0] = redc(s0, p, pinv);
          red[k][cp][1] = redc(s1, p, pinv);
          red[k][cp][2] = redc(s2, p, pinv);
        }
      }
      // pass 2: u_t = X^a_t - 1 and the accumulate, every load before any store
      const u32 a0 = as[2 * i] & (kTwoN - 1), a1 = as[2 * i + 1] & (kTwoN - 1);
      u32 av[kPer][2], w0[kPer], w1[kPer];
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int e = t + k * kThreads, limb = e >> 10, pos = e & (kN - 1), x = sidx(pos);
        const u32* ps = psi + limb * kTwoN;
        const u32 ex = exps[pos];
        w0[k] = ps[(ex * a0) & (kTwoN - 1)];
        w1[k] = ps[(ex * a1) & (kTwoN - 1)];
        av[k][0] = acc[limb * kRow + x];
        av[k][1] = acc[(2 + limb) * kRow + x];
      }
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int e = t + k * kThreads, limb = e >> 10, x = sidx(e & (kN - 1));
        const u32 p = L.P(limb), pinv = L.PI(limb), one = L.R1(limb);
        const u32 u0 = sub_mod(w0[k], one, p), u1 = sub_mod(w1[k], one, p);
        const u32 u01 = mont_mul(u0, u1, p, pinv);
#pragma unroll
        for (int cp = 0; cp < 2; ++cp) {
          const u64 term = (u64)red[k][cp][0] * u0 + (u64)red[k][cp][1] * u1 +
                           (u64)red[k][cp][2] * u01;
          acc[(cp * 2 + limb) * kRow + x] = add_mod(av[k][cp], redc(term, p, pinv), p);
        }
      }
    }
    __syncthreads();
    if (i + 1 < steps) stage_key(keybuf, kg + stride);
    if ((i + 1) % (UNROLLED ? kRenorm2 : kRenorm) == 0)
      renorm = true;
    else
      ++i;
  }

  for (int i = t; i < 4 * kN; i += kThreads)
    acc_out[gate * 4 * kN + i] = acc[(i >> 10) * kRow + sidx(i & (kN - 1))];
}

template <bool UNROLLED>
int launch(const u32* acc_in, u32* acc_out, const int* a_t, const u32* key, int B, int n,
           const Tables& T, cudaStream_t st) {
  const size_t smem = (size_t)kSmemWords * sizeof(u32);
  cudaError_t e = cudaFuncSetAttribute(blind_rotate_kernel<UNROLLED>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  blind_rotate_kernel<UNROLLED><<<B, kThreads, smem, st>>>(acc_in, acc_out, a_t, key, n, T);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The whole blind rotation of B gates: unrolled = 0 runs K3 (n steps, key (n, 4, 2, 2,
// N)), unrolled = 1 runs K4 (n/2 pair steps, key (n/2, 3, 4, 2, 2, N)); the key
// 16-byte aligned.  acc_in / acc_out (B, 2, 2, N); a_t (B, n) int32; p, pinv, r1 (2,);
// psi (2, 2N) Montgomery psi^j; exps (N,) 2*eval_order + 1; stage tables (2, 32) each;
// cross twiddles (2, N) each; p1^-1 mod p2 and its Shoup companion.  n % 8 == 0.
// Returns cudaGetLastError() (or the attribute call's error).
extern "C" int hf_blind_rotate(int unrolled, const void* acc_in, void* acc_out,
                               const void* a_t, const void* key, int B, int n,
                               const void* p, const void* pinv, const void* r1,
                               const void* psi, const void* exps, const void* tw1,
                               const void* tw1_sh, const void* tw2, const void* tw2_sh,
                               const void* itw1, const void* itw1_sh, const void* itw2,
                               const void* itw2_sh, const void* twm, const void* twm_sh,
                               const void* itwm, const void* itwm_sh, unsigned inv_p1_p2,
                               unsigned inv_p1_p2_sh, void* stream) {
  auto c = [](const void* v) { return static_cast<const u32*>(v); };
  Tables T;
  T.p = c(p);
  T.pinv = c(pinv);
  T.r1 = c(r1);
  T.psi = c(psi);
  T.exps = c(exps);
  const void* stage[8] = {tw1, tw1_sh, tw2, tw2_sh, itw1, itw1_sh, itw2, itw2_sh};
  for (int k = 0; k < 8; ++k) T.stage[k] = c(stage[k]);
  T.twm = c(twm);
  T.twm_sh = c(twm_sh);
  T.itwm = c(itwm);
  T.itwm_sh = c(itwm_sh);
  T.inv_p1_p2 = inv_p1_p2;
  T.inv_p1_p2_sh = inv_p1_p2_sh;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* a = static_cast<const int*>(a_t);
  if (unrolled)
    return launch<true>(c(acc_in), static_cast<u32*>(acc_out), a, c(key), B, n, T, st);
  return launch<false>(c(acc_in), static_cast<u32*>(acc_out), a, c(key), B, n, T, st);
}
