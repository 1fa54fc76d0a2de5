// Host stand-ins for the CUDA names that kernels/csrc/tfhe.cu uses, so that its
// device code compiles with a C++20 host compiler and runs one block at a time
// with one std::thread per CUDA thread (tests/test_torch_tfhe_host_kernel.py).
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
extern thread_local dim3 threadIdx, blockIdx, blockDim;

struct uint2 {
  uint32_t x, y;
};
inline uint2 make_uint2(uint32_t a, uint32_t b) { return uint2{a, b}; }
inline uint32_t min(uint32_t a, uint32_t b) { return a < b ? a : b; }
inline uint32_t __umulhi(uint32_t a, uint32_t b) {
  return static_cast<uint32_t>((static_cast<uint64_t>(a) * b) >> 32);
}
template <class T>
inline T __ldg(const T* p) { return *p; }
void __syncthreads();
void __syncwarp(unsigned mask = 0xffffffffu);

typedef int cudaError_t;
enum { cudaSuccess = 0 };
typedef void* cudaStream_t;
