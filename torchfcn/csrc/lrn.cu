// Caffe across-channel LRN, and LRN fused with the Caffe ceil-mode 3x3/2
// max pool, on channels-last (NHWC) tensors in float32 or bf16.
//
// Replaces tpufcn/ops/pallas/lrn.py::lrn_pallas (GoogLeNet pool1/norm1,
// (8, 112, 112, 64) bf16 on the serving path) and
// tpufcn/ops/pallas/lrn_pool.py::lrn_maxpool_pallas (conv2/norm2 ->
// pool2/3x3_s2, (8, 112, 112, 192) -> (8, 56, 56, 192) bf16).
//
// What bounds them on the H100: memory bandwidth.  Per element the LRN does
// about 15 flops over 2 bytes (bf16) read and 2 written, far below the
// card's ~295 flop/byte balance point.  The TPU kernels did the 5-wide
// channel window as a banded (C x C) matmul on the MXU; here a thread reads
// its 5 neighbours straight from the contiguous channel row, and the
// neighbouring threads of a warp read neighbouring channels, so each row is
// fetched from device memory once and the overlapping reads hit L1.  The
// fused kernel writes only the pooled output (a quarter of the input), so
// the LRN output never goes to device memory.  It recomputes the LRN of the
// inputs that neighbouring pool windows share (up to 2.25x the LRN work);
// the work is cheap next to the bytes, and a faster shared-memory tiling is
// left for later.
//
// Rounding follows tpufcn.ops.caffe_layers.lrn_across_channels: in bf16 the
// squares are rounded to bf16 and summed in float32; the power beta = 0.75
// is rsqrt(s) * rsqrt(sqrt(s)); the result is rounded to the storage type
// before the pool's max, as the unfused chain stores it.
#include "common.cuh"

namespace torchfcn {
namespace {

// LRN of channel c of one pixel's channel row, rounded to T
template <typename T>
__device__ __forceinline__ float lrn_at(const T* row, int c, int channels,
                                        int half, float alpha_over_size,
                                        float k) {
  const int lo = max(c - half, 0);
  const int hi = min(c + half, channels - 1);
  float win = 0.f;
  for (int j = lo; j <= hi; ++j) {
    const float v = load_f(row + j);
    win += round_to<T>(v * v);
  }
  return round_to<T>(load_f(row + c) * lrn_factor(win, alpha_over_size, k));
}

// one thread per element of the (pixels, channels) input
template <typename T>
__global__ void lrn_kernel(const T* __restrict__ x, T* __restrict__ y,
                           long long total, int channels, int half,
                           float alpha_over_size, float k) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= total) return;
  const long long pixel = i / channels;
  const int c = static_cast<int>(i - pixel * channels);
  store_f(y + i, lrn_at<T>(x + pixel * channels, c, channels, half,
                           alpha_over_size, k));
}

// one thread per pooled output element (b, oh, ow, c); the 3x3 stride-2
// window is clipped to the image, which is the ceil-mode pool's max
// against -inf past the edge
template <typename T>
__global__ void lrn_maxpool_kernel(const T* __restrict__ x,
                                   T* __restrict__ y, int batch, int h,
                                   int w, int channels, int ho, int wo,
                                   int half, float alpha_over_size,
                                   float k) {
  const long long total =
      static_cast<long long>(batch) * ho * wo * channels;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= total) return;
  const int c = static_cast<int>(i % channels);
  long long t = i / channels;
  const int ow = static_cast<int>(t % wo);
  t /= wo;
  const int oh = static_cast<int>(t % ho);
  const long long b = t / ho;

  float m = -INFINITY;
  for (int dh = 0; dh < 3; ++dh) {
    const int ih = 2 * oh + dh;
    if (ih >= h) break;
    for (int dw = 0; dw < 3; ++dw) {
      const int iw = 2 * ow + dw;
      if (iw >= w) break;
      const T* row = x + ((b * h + ih) * w + iw) * channels;
      m = fmaxf(m, lrn_at<T>(row, c, channels, half, alpha_over_size, k));
    }
  }
  store_f(y + i, m);
}

constexpr int kThreads = 256;

}  // namespace
}  // namespace torchfcn

using namespace torchfcn;

extern "C" int torchfcn_lrn(const void* x, void* y, long long pixels,
                            int channels, int size, float alpha_over_size,
                            float k, int dtype, void* stream) {
  const long long total = pixels * channels;
  const unsigned int blocks = blocks_for(total, kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16) {
    lrn_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y),
        total, channels, size / 2, alpha_over_size, k);
  } else if (dtype == kFloat32) {
    lrn_kernel<float><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(y), total,
        channels, size / 2, alpha_over_size, k);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int torchfcn_lrn_maxpool(const void* x, void* y, int batch, int h,
                                    int w, int channels, int ho, int wo,
                                    int size, float alpha_over_size, float k,
                                    int dtype, void* stream) {
  const long long total = static_cast<long long>(batch) * ho * wo * channels;
  const unsigned int blocks = blocks_for(total, kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16) {
    lrn_maxpool_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y),
        batch, h, w, channels, ho, wo, size / 2, alpha_over_size, k);
  } else if (dtype == kFloat32) {
    lrn_maxpool_kernel<float><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(y), batch, h, w,
        channels, ho, wo, size / 2, alpha_over_size, k);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
