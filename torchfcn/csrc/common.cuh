// Shared helpers of the port's CUDA kernels.
//
// The kernels are built by torchfcn/ops/cuda/build.py with nvcc into one
// shared library with a plain C interface (no PyTorch headers), loaded with
// ctypes.  Each exported function launches on the stream it is given and
// returns cudaGetLastError() as an int; the Python wrapper raises if it is
// not 0.  The build passes -fmad=false, so a*b+c rounds twice exactly as the
// reference's separate multiply and add do.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace torchfcn {

// dtype codes passed by the wrappers
enum DType : int { kFloat32 = 0, kBFloat16 = 1, kFloat8E5M2 = 2 };

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// v rounded to the storage type T and widened back to float
template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) { return v; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// the low and high bf16 of a packed pair, widened to float (exact)
__device__ __forceinline__ float bf16_lo(uint32_t u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t u) {
  return __uint_as_float(u & 0xFFFF0000u);
}
// two floats rounded to bf16 and packed, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the shared-memory address of a generic pointer into shared memory
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// e5m2 code -> float (exact: e5m2 is the top byte of an fp16)
__device__ __forceinline__ float e5m2_to_float(uint8_t code) {
  return __half2float(
      __ushort_as_half(static_cast<unsigned short>(code) << 8));
}

// Caffe LRN (beta 0.75) factor (k + alpha/size * win)^-0.75, computed as
// rsqrt(s) * rsqrt(sqrt(s)) like the reference
__device__ __forceinline__ float lrn_factor(float win, float alpha_over_size,
                                            float k) {
  const float s = k + alpha_over_size * win;
  return rsqrtf(s) * rsqrtf(sqrtf(s));
}

inline unsigned int blocks_for(long long total, int threads) {
  return static_cast<unsigned int>((total + threads - 1) / threads);
}

}  // namespace torchfcn
