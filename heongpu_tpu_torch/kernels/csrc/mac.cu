// Lazy Montgomery multiply-accumulate over RNS limbs, for Hopper (sm_90a): K2.
//
// Replaces heongpu_tpu/ops/rns.py::lazy_mac_mont, which XLA fused on the TPU
// (no Pallas code), in its two uses: the keyswitch key MAC
// (heongpu_tpu/ops/keyswitch2.py:105-106), mac_keys, and FastBconv
// (rns.py:164-209), base_conv.  Both sum exact 64-bit products d*k (k in
// Montgomery form k*R, R = 2^32), at most 16 of them per accumulator (16
// products of values below 2^30 fit in 64 bits), then fold the sum X to
// X*R^-1 mod p with one REDC after a Barrett pre-reduction of the high word;
// folds of successive 16-term chunks are added mod p (fold: ntt_common.cuh).
// The result, sum d*k*R^-1 mod p, is exact, so it equals the plain int64
// version bit for bit.
//
// mac_keys: one thread per (limb, coefficient), each digit read once for both
// key halves (3 words read per 2 products).  Bound by device-memory bandwidth.
//
// base_conv: (B, Kin, N) -> (B, Kout, N).  A thread owns two adjacent
// coefficient columns (b, n..n+1): it reads their input words once, 8 bytes a
// load (coalesced along n), into registers, multiplying each by q^_i^-1 mod q_i
// on the way in where a scale table is given (BaseConv.scaled_digits, Shoup),
// then loops over its block's output limbs and writes each output word once (8
// bytes a store, coalesced); the two columns' sums are independent chains.  The
// block's rows of the (Kin, Kout) matrix, transposed and zero-padded, the scale
// table (one 16-byte entry an input word) and the output primes' constants are
// staged once into shared memory; every read of them is a warp-uniform
// broadcast, four matrix words a load.  The input words are held in chunks of
// KP, a template parameter: Kin rounded up to a multiple of 4, at most 32 (eight
// instances, and a ninth for Kin > 32, cover every Kin).  The loads past Kin
// read row Kin - 1 again against zero matrix words, the 16-term folds are placed
// at compile time, and nothing divides at run time.  Kin > 32 takes
// ceil(Kin / 32) chunks, each adding its sum to the output word the chunk before
// wrote (read back by the thread that wrote it).  Where the B*N/512 column
// blocks leave a wave of 4 blocks an SM unfilled, the output limbs are split
// over blockIdx.z (each block reading its columns again, from L2) so that one
// wave holds the grid.  Bound: bytes at Kin <= 4 (4 -> 54 moves 58 words a
// column for 216 products), operations at BFV's 29 -> 32 (928 products a
// column).  Measured on an H100 at 38-47% of either bound (PERF.md): the sums
// are chains of half-rate 32x32->64-bit multiply-adds, Kin = 29, 31 take two
// folds an output word where the bound counts one, and the padding to 32 adds
// three zero products in 32 at Kin = 29.

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

// base_conv's arguments; blockIdx.z covers output limbs [z * per, min(z * per + per, Kout)).
struct ConvParams {
  const u32* z;      // (B, Kin, N)
  const u32* mat;    // (Kin, Kout), Montgomery form
  u32* out;          // (B, Kout, N)
  const u32* p;      // (Kout,) output primes, -p^-1 mod 2^32, floor(2^32/p)
  const u32* pinv;
  const u32* mu;
  const u32* scale;  // (3, Kin): q_i, w_i, floor(w_i * 2^32 / q_i); read when SCALED
  int Kin, Kout, N, per;
  int stride;        // words of a matrix row in shared memory: Kin rounded up to the chunk
};

constexpr int kCols = 2;       // adjacent coefficient columns per thread: 8-byte loads and stores
constexpr int kMaxChunk = 32;  // the widest chunk of input words held in registers
constexpr size_t kSmemBytes = 48 * 1024;

// The two words of a row at an even column.
__device__ __forceinline__ void load_cols(const u32* a, u32 (&v)[kCols]) {
  const uint2 w = *reinterpret_cast<const uint2*>(a);
  v[0] = w.x;
  v[1] = w.y;
}

__device__ __forceinline__ void store_cols(u32* a, const u32 (&v)[kCols]) {
  *reinterpret_cast<uint2*>(a) = make_uint2(v[0], v[1]);
}

size_t conv_smem_bytes(int per, int stride) {
  return sizeof(u32) * (static_cast<size_t>(per) * (stride + 3) + 4 * stride);
}

// KP input words a chunk (a multiple of 4, at most kMaxChunk): one chunk, or, where
// CHUNKED (KP = kMaxChunk), ceil(Kin / KP) chunks, each adding its sum to the output
// words the chunk before wrote.
template <int KP, bool SCALED, bool CHUNKED>
__global__ void __launch_bounds__(kThreads) base_conv_kernel(const ConvParams P) {
  extern __shared__ __align__(16) u32 sm[];
  const int K = P.Kin, W = P.stride;
  u32* mt = sm;  // (per, W): row r = output limb o0 + r, zero past Kin
  // the scale table, (q_i, w_i, its Shoup companion, 0) for each input word, zero past Kin
  uint4* sc = reinterpret_cast<uint4*>(sm + P.per * W);
  u32* cp = sm + (P.per + 4) * W;  // p, pinv, mu of the block's output limbs (per each)
  const int o0 = blockIdx.z * P.per;
  const int rows = P.Kout - o0 < P.per ? P.Kout - o0 : P.per;
  // every load below reads a row that exists (past Kin, row Kin - 1): unconditional
  // loads, so that a chunk's loads are all in flight at once; the matrix words past Kin
  // are zero, so the input words past it add nothing
  const int w_end = CHUNKED ? W : KP;  // W = KP for one chunk
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    for (int c0 = 0; c0 < w_end; c0 += KP)
#pragma unroll
      for (int i = 0; i < KP; ++i) {
        const int g = c0 + i;
        const u32 v = P.mat[(g < K ? g : K - 1) * P.Kout + o0 + r];
        mt[r * W + g] = g < K ? v : 0u;
      }
    cp[r] = P.p[o0 + r];
    cp[P.per + r] = P.pinv[o0 + r];
    cp[2 * P.per + r] = P.mu[o0 + r];
  }
  if (SCALED)
    for (int i = threadIdx.x; i < W; i += kThreads)
      sc[i] = i < K ? make_uint4(P.scale[i], P.scale[K + i], P.scale[2 * K + i], 0u)
                    : make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  const int n = (blockIdx.x * kThreads + threadIdx.x) * kCols;
  if (n >= P.N) return;
  const size_t N = P.N;
  const u32* zc = P.z + static_cast<size_t>(blockIdx.y) * K * N + n;
  u32* oc = P.out + (static_cast<size_t>(blockIdx.y) * P.Kout + o0) * N + n;
  const int c_end = CHUNKED ? K : 1;
  for (int c0 = 0; c0 < c_end; c0 += KP) {
    u32 x[KP][kCols];
#pragma unroll
    for (int i = 0; i < KP; ++i) {
      load_cols(zc + (c0 + i < K ? c0 + i : K - 1) * N, x[i]);
      if (SCALED) {  // a word past Kin becomes 0 (its scale entry is zero)
        const uint4 w = sc[c0 + i];
#pragma unroll
        for (int c = 0; c < kCols; ++c) x[i][c] = csub(shoup_lazy(x[i][c], w.y, w.z, w.x), w.x);
      }
    }
    for (int r = 0; r < rows; ++r) {
      const uint4* m4 = reinterpret_cast<const uint4*>(mt + r * W + c0);
      const u32 p = cp[r], pinv = cp[P.per + r], mu = cp[2 * P.per + r];
      u64 acc[kCols] = {};
      u32 res[kCols] = {};
      if (CHUNKED && c0) load_cols(oc + r * N, res);  // the sum of the earlier chunks
#pragma unroll
      for (int i4 = 0; i4 < KP / 4; ++i4) {
        const uint4 m = m4[i4];
        const u32 mv[4] = {m.x, m.y, m.z, m.w};
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int i = 4 * i4 + t;
#pragma unroll
          for (int c = 0; c < kCols; ++c) acc[c] += static_cast<u64>(x[i][c]) * mv[t];
          if ((i + 1) % kChunk == 0 && i + 1 < KP) {
#pragma unroll
            for (int c = 0; c < kCols; ++c) {
              res[c] = csub(res[c] + fold(acc[c], p, pinv, mu), p);
              acc[c] = 0;
            }
          }
        }
      }
#pragma unroll
      for (int c = 0; c < kCols; ++c) res[c] = csub(res[c] + fold(acc[c], p, pinv, mu), p);
      store_cols(oc + r * N, res);
    }
  }
}

unsigned blocks_for(size_t n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

template <int KP, bool CHUNKED>
int launch_base_conv(const ConvParams& P, dim3 grid, cudaStream_t stream) {
  const size_t smem = conv_smem_bytes(P.per, P.stride);
  if (P.scale)
    base_conv_kernel<KP, true, CHUNKED><<<grid, kThreads, smem, stream>>>(P);
  else
    base_conv_kernel<KP, false, CHUNKED><<<grid, kThreads, smem, stream>>>(P);
  return static_cast<int>(cudaGetLastError());
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

// out (B, Kout, N) = sum_i z'[b, i] * mat[i, o] * R^-1 mod p_o, z' = z, or
// z * scale[1] mod scale[0] where scale (3, Kin) is not null; z: (B, Kin, N), mat:
// (Kin, Kout) Montgomery form.  N even and z 8-byte aligned; sms, the card's SM
// count, sizes one wave of blocks.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue where one matrix row does not fit the shared memory.
extern "C" int hf_base_conv(const void* z, const void* mat, void* out, const void* p,
                            const void* pinv, const void* mu, const void* scale, int B,
                            int Kin, int Kout, int N, int sms, void* stream) {
  const int kp = Kin > kMaxChunk ? kMaxChunk : (Kin + 3) & ~3;
  const int stride = (Kin + kp - 1) / kp * kp;
  // one wave: 4 blocks of 256 threads on each SM; where B * N leaves it unfilled,
  // the output limbs are split over blockIdx.z
  const int col_blocks = static_cast<int>(blocks_for(N / kCols));
  int split = 4 * sms / (col_blocks * B);
  split = split < 1 ? 1 : split > Kout ? Kout : split;
  int per = (Kout + split - 1) / split;
  // at most as many output limbs a block as their matrix rows fit the shared memory
  const size_t room = kSmemBytes / sizeof(u32);
  if (Kin < 1 || Kout < 1 || 5 * static_cast<size_t>(stride) + 3 > room)
    return static_cast<int>(cudaErrorInvalidValue);
  const int fit = static_cast<int>((room - 4 * static_cast<size_t>(stride)) / (stride + 3));
  per = per > fit ? fit : per;
  const ConvParams P{static_cast<const u32*>(z), static_cast<const u32*>(mat),
                     static_cast<u32*>(out), static_cast<const u32*>(p),
                     static_cast<const u32*>(pinv), static_cast<const u32*>(mu),
                     static_cast<const u32*>(scale), Kin, Kout, N, per, stride};
  const dim3 grid{static_cast<unsigned>(col_blocks), static_cast<unsigned>(B),
                  static_cast<unsigned>((Kout + per - 1) / per)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Kin > kMaxChunk) return launch_base_conv<kMaxChunk, true>(P, grid, s);
  switch (kp) {
    case 4: return launch_base_conv<4, false>(P, grid, s);
    case 8: return launch_base_conv<8, false>(P, grid, s);
    case 12: return launch_base_conv<12, false>(P, grid, s);
    case 16: return launch_base_conv<16, false>(P, grid, s);
    case 20: return launch_base_conv<20, false>(P, grid, s);
    case 24: return launch_base_conv<24, false>(P, grid, s);
    case 28: return launch_base_conv<28, false>(P, grid, s);
    default: return launch_base_conv<32, false>(P, grid, s);
  }
}
