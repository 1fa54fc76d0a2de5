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
// and return the final NTT-domain accumulator.  Each K3 step: X^a as a product of
// six radix-4 digit-selected omega tables, diff = X^a*acc - acc, INTT, CRT to
// Torus32, signed gadget decomposition (l = 2, Bg = 2^10), forward NTT of the 4x2
// digit rows, the external product with the step's TGSW rows (Montgomery REDC with
// pinv = -p^-1 mod 2^32) and the accumulate; every 8 steps the accumulator is
// renormalised (INTT, torus, RNS, NTT).  K4 runs n/2 pair steps of
//   acc += <D(acc), B0>*u0 + <D(acc), B1>*u1 + <D(acc), B01>*u0*u1,  u = X^a - 1,
// with one decomposition per pair and a renorm every 4 pair steps.  All arithmetic is
// exact mod p with canonical results, so the output equals the plain chains
// (blind_rotate_plain / blind_rotate2_plain) bit for bit.
//
// Design.  One block of 512 threads per gate runs the whole chain in one launch;
// the TPU's lane tiling over gates, its roll-based 32x32 transpose and its key
// pre-broadcast over the tile do not carry over.  The accumulator (16 KB), the
// INTT scratch (16 KB) and the eight digit rows (32 KB) stay in shared memory for
// the whole chain (~70 KB of dynamic shared memory).  A 1024-point transform fits
// in the block, so it is the four-step transform of ops/ntt.py done in place on a
// (32, 32) view with a row pitch of 33 words: element (r, c) holds coefficient
// r*32 + c in the coefficient domain and storage position c*32 + r in the NTT
// domain, so no transpose is ever written, the column and row butterflies are free
// of bank conflicts, and the packed per-stage tables of NttTables are used as they
// are (cross twiddles folded into the last butterfly stage of the first half).
// Key slices (64 KB per step, 192 KB per K4 pair step) and the omega tables
// (196 KB) are read from global memory through L2, which every gate block shares.
//
// What bounds it: latency.  Each step is a sequential chain of ~12 small transforms
// with a __syncthreads between butterfly stages (about 35 barriers a step), and at
// B = 8 only 8 of the 132 SMs have work.  Batching more gates per launch fills the
// card at the same chain latency.  Making one chain shorter is later work: a cluster
// per gate, key slices by TMA ahead of use, a warp-level transform without barriers.

#include "ntt_common.cuh"   // csub, shoup_lazy

namespace {

constexpr int kN = 1024;             // TRLWE degree, N1 = N2 = 32
constexpr int kPitch = 33;           // padded row pitch of the (32, 32) view
constexpr int kRow = 32 * kPitch;    // shared-memory words per polynomial row
constexpr int kThreads = 512;        // one butterfly per thread per row and stage
constexpr int kBgBit = 10;
constexpr u32 kBgMask = (1u << kBgBit) - 1;
constexpr u32 kBgHalf = 1u << (kBgBit - 1);
constexpr u32 kOffset = (kBgHalf << (32 - kBgBit)) + (kBgHalf << (32 - 2 * kBgBit));
constexpr int kRenorm = 8;           // K3 steps between renormalisations
constexpr int kRenorm2 = 4;          // K4 pair steps between renormalisations
constexpr int kRowWords = 2 * 2 * kN;  // one TGSW row: 2 comps x 2 limbs x N

struct Tables {
  const u32* p;       // (2,)
  const u32* pinv;    // (2,) -p^-1 mod 2^32
  const u32* r1;      // (2,) 2^32 mod p (Montgomery one)
  const u32* omega;   // (6, 4, 2, N) Montgomery NTT-domain X^(c*4^g)
  const u32* stage[8];  // (2, 32) packed: tw1, tw1_sh, tw2, tw2_sh, itw1, itw1_sh, itw2, itw2_sh
  const u32* twm;     // (2, N) forward cross twiddles and Shoup companions
  const u32* twm_sh;
  const u32* itwm;    // (2, N) inverse cross twiddles (n^-1 psi^-i folded in)
  const u32* itwm_sh;
  u32 inv_p1_p2;      // p1^-1 mod p2
};

// per-limb constants held in registers
struct Limbs {
  u32 p[2], pinv[2], r1[2];
  __device__ u32 P(int l) const { return l ? p[1] : p[0]; }
  __device__ u32 PI(int l) const { return l ? pinv[1] : pinv[0]; }
  __device__ u32 R1(int l) const { return l ? r1[1] : r1[0]; }
};

__device__ __forceinline__ u32 add_mod(u32 a, u32 b, u32 p) { return csub(a + b, p); }
__device__ __forceinline__ u32 sub_mod(u32 a, u32 b, u32 p) { return a >= b ? a - b : a + p - b; }

// a*b*2^-32 mod p (REDC), a, b < p < 2^30; canonical result.
__device__ __forceinline__ u32 mont_mul(u32 a, u32 b, u32 p, u32 pinv) {
  const u64 t = (u64)a * b;
  const u32 m = (u32)t * pinv;
  return csub((u32)((t + (u64)m * p) >> 32), p);
}

// shared-memory index of NTT storage position pos: (r, c) = (pos % 32, pos / 32)
__device__ __forceinline__ int sidx(int pos) { return (pos & 31) * kPitch + (pos >> 5); }
// shared-memory index of coefficient q: (r, c) = (q / 32, q % 32)
__device__ __forceinline__ int cidx(int q) { return (q >> 5) * kPitch + (q & 31); }

// st: shared stage tables, limb l's table k at st[l*256 + k*32]
__device__ __forceinline__ const u32* stab(const u32* st, int limb, int k) {
  return st + limb * 256 + k * 32;
}

// Forward transform of `nrows` rows in place (row j on limb j & 1): coefficient
// (r, c) -> NTT storage position c*32 + r, canonical.  Merged-negacyclic CT stages
// down the columns, cross twiddle, cyclic GS stages along the rows.
__device__ void ntt_fwd_rows(u32* base, int nrows, const u32* st, const Tables& T,
                             const Limbs& L) {
  const int t = threadIdx.x;
  {
    const int c = t & 31, k = t >> 5;
    for (int s = 1; s <= 5; ++s) {
      const int span = 32 >> s, i = k >> (5 - s), j = k & (span - 1);
      const int iu = i * 2 * span + j, iv = iu + span, w_i = (1 << (s - 1)) + i;
      for (int row = 0; row < nrows; ++row) {
        const int limb = row & 1;
        const u32 p = L.P(limb), p2 = p + p;
        u32* m = base + row * kRow;
        const u32 u = m[iu * kPitch + c], v = m[iv * kPitch + c];
        const u32 tt = shoup_lazy(v, stab(st, limb, 0)[w_i], stab(st, limb, 1)[w_i], p);
        u32 nu = csub(u + tt, p2), nv = csub(u + p2 - tt, p2);
        if (s == 5) {
          const int gu = limb * kN + iu * 32 + c, gv = limb * kN + iv * 32 + c;
          nu = shoup_lazy(nu, __ldg(T.twm + gu), __ldg(T.twm_sh + gu), p);
          nv = shoup_lazy(nv, __ldg(T.twm + gv), __ldg(T.twm_sh + gv), p);
        }
        m[iu * kPitch + c] = nu;
        m[iv * kPitch + c] = nv;
      }
      __syncthreads();
    }
  }
  {
    const int r = t & 31, k = t >> 5;
    for (int s = 5; s >= 1; --s) {
      const int hm = 1 << (s - 1), blk = k >> (s - 1), j = k & (hm - 1);
      const int iu = blk * 2 * hm + j, iv = iu + hm, w_i = hm + j;
      for (int row = 0; row < nrows; ++row) {
        const int limb = row & 1;
        const u32 p = L.P(limb), p2 = p + p;
        u32* m = base + row * kRow + r * kPitch;
        const u32 u = m[iu], v = m[iv];
        u32 nu = csub(u + v, p2);
        u32 nv = shoup_lazy(u + p2 - v, stab(st, limb, 2)[w_i], stab(st, limb, 3)[w_i], p);
        if (s == 1) {
          nu = csub(nu, p);
          nv = csub(nv, p);
        }
        m[iu] = nu;
        m[iv] = nv;
      }
      __syncthreads();
    }
  }
}

// Inverse transform of `nrows` rows in place: NTT storage position c*32 + r at
// (r, c) -> coefficient r*32 + c, canonical.  Cyclic CT stages along the rows,
// inverse cross twiddle, merged-negacyclic GS stages down the columns.
__device__ void ntt_inv_rows(u32* base, int nrows, const u32* st, const Tables& T,
                             const Limbs& L) {
  const int t = threadIdx.x;
  {
    const int r = t & 31, k = t >> 5;
    for (int s = 1; s <= 5; ++s) {
      const int hm = 1 << (s - 1), blk = k >> (s - 1), j = k & (hm - 1);
      const int iu = blk * 2 * hm + j, iv = iu + hm, w_i = hm + j;
      for (int row = 0; row < nrows; ++row) {
        const int limb = row & 1;
        const u32 p = L.P(limb), p2 = p + p;
        u32* m = base + row * kRow + r * kPitch;
        const u32 u = m[iu], v = m[iv];
        const u32 tt = shoup_lazy(v, stab(st, limb, 6)[w_i], stab(st, limb, 7)[w_i], p);
        u32 nu = csub(u + tt, p2), nv = csub(u + p2 - tt, p2);
        if (s == 5) {
          const int gu = limb * kN + r * 32 + iu, gv = limb * kN + r * 32 + iv;
          nu = shoup_lazy(nu, __ldg(T.itwm + gu), __ldg(T.itwm_sh + gu), p);
          nv = shoup_lazy(nv, __ldg(T.itwm + gv), __ldg(T.itwm_sh + gv), p);
        }
        m[iu] = nu;
        m[iv] = nv;
      }
      __syncthreads();
    }
  }
  {
    const int c = t & 31, k = t >> 5;
    for (int s = 5; s >= 1; --s) {
      const int span = 32 >> s, i = k >> (5 - s), j = k & (span - 1);
      const int iu = i * 2 * span + j, iv = iu + span, w_i = (1 << (s - 1)) + i;
      for (int row = 0; row < nrows; ++row) {
        const int limb = row & 1;
        const u32 p = L.P(limb), p2 = p + p;
        u32* m = base + row * kRow;
        const u32 u = m[iu * kPitch + c], v = m[iv * kPitch + c];
        u32 nu = csub(u + v, p2);
        u32 nv = shoup_lazy(u + p2 - v, stab(st, limb, 4)[w_i], stab(st, limb, 5)[w_i], p);
        if (s == 1) {
          nu = csub(nu, p);
          nv = csub(nv, p);
        }
        m[iu * kPitch + c] = nu;
        m[iv * kPitch + c] = nv;
      }
      __syncthreads();
    }
  }
}

// Montgomery NTT-domain X^a at (limb, pos): product of six digit-selected tables.
__device__ __forceinline__ u32 omega_of(int a, int limb, int pos, const Tables& T,
                                        u32 p, u32 pinv) {
  u32 w = __ldg(T.omega + ((a & 3) * 2 + limb) * kN + pos);
  for (int g = 1; g < 6; ++g) {
    const int d = (a >> (2 * g)) & 3;
    w = mont_mul(w, __ldg(T.omega + ((g * 4 + d) * 2 + limb) * kN + pos), p, pinv);
  }
  return w;
}

// CRT pair residues -> the centered value mod 2^32 (Torus32).
__device__ __forceinline__ u32 to_torus(u32 r1, u32 r2, const Limbs& L, u32 inv) {
  const u32 p1 = L.p[0], p2 = L.p[1];
  const u32 x = r1 % p2;
  const u32 d = r2 >= x ? r2 - x : r2 + p2 - x;
  const u32 t = (u32)(((u64)d * inv) % p2);
  const u64 v = (u64)t * p1 + r1;
  const u64 P = (u64)p1 * p2;
  return (u32)(v >= (P >> 1) ? v - P : v);
}

// Torus32 word read as a signed value -> residue mod p.
__device__ __forceinline__ u32 to_rns(u32 v, u32 p) {
  const bool neg = v >> 31;
  const u32 m = (neg ? 0u - v : v) % p;
  return (neg && m) ? p - m : m;
}

template <bool UNROLLED>
__global__ void __launch_bounds__(kThreads, 1)
blind_rotate_kernel(const u32* __restrict__ acc_in, u32* __restrict__ acc_out,
                    const int* __restrict__ a_t, const u32* __restrict__ key, int n,
                    Tables T) {
  extern __shared__ u32 sm[];
  u32* acc = sm;                 // rows (poly, limb), NTT domain
  u32* tmp = acc + 4 * kRow;     // rows (poly, limb): diff / INTT scratch
  u32* dig = tmp + 4 * kRow;     // rows ((poly, digit), limb): gadget digits
  u32* st = dig + 8 * kRow;      // 2 limbs x 8 stage tables x 32
  int* as = reinterpret_cast<int*>(st + 512);  // the gate's n rotation amounts
  const int t = threadIdx.x;
  const size_t gate = blockIdx.x;

  Limbs L;
  for (int l = 0; l < 2; ++l) {
    L.p[l] = T.p[l];
    L.pinv[l] = T.pinv[l];
    L.r1[l] = T.r1[l];
  }
  for (int i = t; i < 512; i += kThreads)
    st[i] = T.stage[(i >> 5) & 7][(i >> 8) * 32 + (i & 31)];
  for (int i = t; i < n; i += kThreads) as[i] = a_t[gate * n + i] & (2 * kN - 1);
  for (int i = t; i < 4 * kN; i += kThreads)
    acc[(i >> 10) * kRow + sidx(i & (kN - 1))] = acc_in[gate * 4 * kN + i];
  __syncthreads();

  const int steps = UNROLLED ? n / 2 : n;
  for (int i = 0; i < steps; ++i) {
    // 1. the rows to decompose: X^a*acc - acc (K3) or acc itself (K4)
    if (!UNROLLED) {
      const int a = as[i];
      for (int e = t; e < 2 * kN; e += kThreads) {
        const int limb = e >> 10, pos = e & (kN - 1), x = sidx(pos);
        const u32 p = L.P(limb), pinv = L.PI(limb);
        const u32 w = omega_of(a, limb, pos, T, p, pinv);
        for (int poly = 0; poly < 2; ++poly) {
          const int o = (poly * 2 + limb) * kRow + x;
          const u32 v = acc[o];
          tmp[o] = sub_mod(mont_mul(v, w, p, pinv), v, p);
        }
      }
    } else {
      for (int e = t; e < 4 * kRow; e += kThreads) tmp[e] = acc[e];
    }
    __syncthreads();
    ntt_inv_rows(tmp, 4, st, T, L);

    // 2. CRT to the torus and signed gadget digits, as residues of both limbs
    for (int e = t; e < 2 * kN; e += kThreads) {
      const int poly = e >> 10, x = cidx(e & (kN - 1));
      const u32 u = to_torus(tmp[(poly * 2) * kRow + x], tmp[(poly * 2 + 1) * kRow + x], L,
                             T.inv_p1_p2) + kOffset;
      for (int d = 0; d < 2; ++d) {
        const u32 dg = (u >> (32 - (d + 1) * kBgBit)) & kBgMask;
        for (int limb = 0; limb < 2; ++limb)
          dig[((poly * 2 + d) * 2 + limb) * kRow + x] =
              dg >= kBgHalf ? dg - kBgHalf : L.P(limb) - (kBgHalf - dg);
      }
    }
    __syncthreads();
    ntt_fwd_rows(dig, 8, st, T, L);

    // 3. external product with the step's key rows, accumulated into acc
    const u32* ki = key + (size_t)i * (UNROLLED ? 3 : 1) * 4 * kRowWords;
    for (int e = t; e < 2 * kN; e += kThreads) {
      const int limb = e >> 10, pos = e & (kN - 1), x = sidx(pos);
      const u32 p = L.P(limb), pinv = L.PI(limb);
      u32 dv[4];
      for (int row = 0; row < 4; ++row) dv[row] = dig[(row * 2 + limb) * kRow + x];
      if (!UNROLLED) {
        for (int cp = 0; cp < 2; ++cp) {
          u32 s = 0;
          for (int row = 0; row < 4; ++row)
            s = add_mod(s, mont_mul(dv[row], __ldg(ki + ((row * 2 + cp) * 2 + limb) * kN + pos),
                                    p, pinv), p);
          u32* a = acc + (cp * 2 + limb) * kRow + x;
          *a = add_mod(*a, s, p);
        }
      } else {
        const u32 u0 = sub_mod(omega_of(as[2 * i], limb, pos, T, p, pinv), L.R1(limb), p);
        const u32 u1 = sub_mod(omega_of(as[2 * i + 1], limb, pos, T, p, pinv), L.R1(limb), p);
        const u32 us[3] = {u0, u1, mont_mul(u0, u1, p, pinv)};
        for (int cp = 0; cp < 2; ++cp) {
          u32 term = 0;
          for (int tt = 0; tt < 3; ++tt) {
            u32 s = 0;
            for (int row = 0; row < 4; ++row)
              s = add_mod(s, mont_mul(dv[row],
                                      __ldg(ki + (((tt * 4 + row) * 2 + cp) * 2 + limb) * kN + pos),
                                      p, pinv), p);
            term = add_mod(term, mont_mul(s, us[tt], p, pinv), p);
          }
          u32* a = acc + (cp * 2 + limb) * kRow + x;
          *a = add_mod(*a, term, p);
        }
      }
    }
    __syncthreads();

    // 4. renormalise: pull the integer representative back to the torus
    if ((i + 1) % (UNROLLED ? kRenorm2 : kRenorm) == 0) {
      ntt_inv_rows(acc, 4, st, T, L);
      for (int e = t; e < 2 * kN; e += kThreads) {
        const int poly = e >> 10, x = cidx(e & (kN - 1));
        u32* r0 = acc + (poly * 2) * kRow + x;
        u32* r1 = acc + (poly * 2 + 1) * kRow + x;
        const u32 v = to_torus(*r0, *r1, L, T.inv_p1_p2);
        *r0 = to_rns(v, L.p[0]);
        *r1 = to_rns(v, L.p[1]);
      }
      __syncthreads();
      ntt_fwd_rows(acc, 4, st, T, L);
    }
  }

  for (int i = t; i < 4 * kN; i += kThreads)
    acc_out[gate * 4 * kN + i] = acc[(i >> 10) * kRow + sidx(i & (kN - 1))];
}

template <bool UNROLLED>
int launch(const u32* acc_in, u32* acc_out, const int* a_t, const u32* key, int B, int n,
           const Tables& T, cudaStream_t st) {
  const size_t smem = (size_t)(16 * kRow + 512 + n) * sizeof(u32);
  cudaError_t e = cudaFuncSetAttribute(blind_rotate_kernel<UNROLLED>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  blind_rotate_kernel<UNROLLED><<<B, kThreads, smem, st>>>(acc_in, acc_out, a_t, key, n, T);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The whole blind rotation of B gates: unrolled = 0 runs K3 (n steps, key (n, 4, 2, 2,
// N)), unrolled = 1 runs K4 (n/2 pair steps, key (n/2, 3, 4, 2, 2, N)).  acc_in /
// acc_out (B, 2, 2, N); a_t (B, n) int32; p, pinv, r1 (2,); omega (6, 4, 2, N);
// stage tables (2, 32) each; cross twiddles (2, N) each.  n % 8 == 0.
// Returns cudaGetLastError() (or the attribute call's error).
extern "C" int hf_blind_rotate(int unrolled, const void* acc_in, void* acc_out,
                               const void* a_t, const void* key, int B, int n,
                               const void* p, const void* pinv, const void* r1,
                               const void* omega, const void* tw1, const void* tw1_sh,
                               const void* tw2, const void* tw2_sh, const void* itw1,
                               const void* itw1_sh, const void* itw2, const void* itw2_sh,
                               const void* twm, const void* twm_sh, const void* itwm,
                               const void* itwm_sh, int inv_p1_p2, void* stream) {
  auto c = [](const void* v) { return static_cast<const u32*>(v); };
  Tables T;
  T.p = c(p);
  T.pinv = c(pinv);
  T.r1 = c(r1);
  T.omega = c(omega);
  const void* stage[8] = {tw1, tw1_sh, tw2, tw2_sh, itw1, itw1_sh, itw2, itw2_sh};
  for (int k = 0; k < 8; ++k) T.stage[k] = c(stage[k]);
  T.twm = c(twm);
  T.twm_sh = c(twm_sh);
  T.itwm = c(itwm);
  T.itwm_sh = c(itwm_sh);
  T.inv_p1_p2 = static_cast<u32>(inv_p1_p2);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* a = static_cast<const int*>(a_t);
  if (unrolled)
    return launch<true>(c(acc_in), static_cast<u32*>(acc_out), a, c(key), B, n, T, st);
  return launch<false>(c(acc_in), static_cast<u32*>(acc_out), a, c(key), B, n, T, st);
}
