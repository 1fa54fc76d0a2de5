// Host stand-ins for the CUDA names that kernels/csrc/tfhe.cu, keyswitch.cu, ntt.cu,
// mac.cu, divround.cu and threefry.cu use, so that their device code compiles with a C++20 host
// compiler and runs one block at a time with one fiber per CUDA thread (fibers.h)
// (tests/test_torch_tfhe_host_kernel.py, tests/test_torch_keyswitch_host_kernel.py,
// tests/test_torch_ntt_host_kernel.py, tests/test_torch_rns_host_kernel.py,
// tests/test_torch_threefry_host_kernel.py).
#pragma once
#include <cstddef>
#include <cstdint>
#include <cstring>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__
#define __align__(n)
#define __restrict__ __restrict

struct dim3 {
  unsigned x = 0, y = 0, z = 0;
};
extern thread_local dim3 threadIdx, blockIdx, blockDim, gridDim;

struct uint2 {
  uint32_t x, y;
};
inline uint2 make_uint2(uint32_t a, uint32_t b) { return uint2{a, b}; }
struct alignas(16) uint4 {
  uint32_t x, y, z, w;
};
inline uint4 make_uint4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) { return uint4{a, b, c, d}; }
inline uint32_t min(uint32_t a, uint32_t b) { return a < b ? a : b; }
inline uint32_t __umulhi(uint32_t a, uint32_t b) {
  return static_cast<uint32_t>((static_cast<uint64_t>(a) * b) >> 32);
}
template <class T>
inline T __ldg(const T* p) { return *p; }
// the high word of (hi:lo) << (shift mod 32)
inline uint32_t __funnelshift_l(uint32_t lo, uint32_t hi, uint32_t shift) {
  shift &= 31u;
  return shift ? (hi << shift) | (lo >> (32u - shift)) : hi;
}
void __syncthreads();
void __syncwarp(unsigned mask = 0xffffffffu);

typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
typedef void* cudaStream_t;
