// The GoogLeNet stem tail fused into one kernel, on channels-last tensors:
//
//   pool1 output (B, H, W, 64) -> LRN1 -> conv2/3x3_reduce 1x1 + ReLU
//     -> conv2/3x3 3x3 pad 1 + ReLU -> LRN2 -> pool2 3x3/2 ceil mode
//     -> (B, Ho, Wo, 192)
//
// Replaces tpufcn/ops/pallas/stem.py::stem_tail_pallas ((8, 112, 112, 64)
// -> (8, 56, 56, 192) on the serving path).  The storage type is a template
// parameter:
//   * bf16 computes what stem_tail_pallas computes;
//   * e5m2 reads the serving model's e5m2 pool1 output, rounds the LRN1,
//     conv2_reduce, conv2 and LRN2 outputs to bf16 and then to e5m2, as the
//     serving model stores them (tpufcn/models/googlenet.py:186-200), and
//     writes e5m2.  The roundings happen in registers: the intermediates
//     never leave the chip.
//
// Rounding: each conv multiplies bf16 operands, accumulates in float32
// (over dy, dx, then input channel), adds the float32 bias, applies ReLU
// and rounds once.  Products of two bf16 values are exact in float32, so the
// explicit __fmaf_rn gives the same numbers as a separate multiply and add
// (the build's -fmad=false does not apply to it).  The LRNs round their
// squares to bf16 and sum the window in float32, as
// tpufcn.ops.caffe_layers.lrn_across_channels does in bf16.
//
// What bounds it on the H100: arithmetic.  conv2 is 11.1 GMAC at B = 8,
// 112^2 (the reduce conv 0.4 GMAC), against 6.4 MB of e5m2 input and 4.8 MB
// of output; the convs run on the CUDA cores in float32.  The design:
//   * one block per (image, pool2 row), 384 threads;
//   * the 5 conv2 input rows of that pool row: LRN1 and the reduce conv
//     into shared memory (bf16, one zero column each side; rows outside the
//     image stay zero, which is conv2's zero padding of the reduce conv's
//     output);
//   * the 3 conv2 rows the pool window reads, bf16 in shared memory; each
//     thread accumulates a tile of 8 columns x 4 output channels, reading
//     8 input channels per 16-byte shared load and the weights through the
//     read-only cache;
//   * LRN2 over the 192 channels of each pixel, fused into the pool: only
//     the pooled row is written to device memory.
// Neighbouring pool rows share a conv2 row and two reduce-conv rows, which
// are recomputed (1.5x the conv2 work).  The TPU kernel's banded C x C LRN
// matmuls and 14-row stripes were devices of its VMEM and MXU; a tensor-core
// (wgmma) conv is later work.
#include "common.cuh"

namespace torchfcn {
namespace {

constexpr int kCin = 64;                  // pool1 = conv2_reduce channels
constexpr int kCout = 192;                // conv2 channels
constexpr int kThreads = 384;
constexpr int kXT = 8;                    // conv2 tile: columns
constexpr int kCT = 4;                    // conv2 tile: output channels
constexpr int kQuads = kCout / kCT;       // 48
constexpr int kXGroups = kThreads / kQuads;   // 8
constexpr int kRowsIn = 5;                // reduce-conv rows of a pool row
constexpr float kAlphaOverSize = 1e-4f / 5.f;
constexpr float kLrnK = 1.f;

// storage types: bf16, or e5m2 held as its 8-bit code
template <typename S>
struct Store;

template <>
struct Store<__nv_bfloat16> {
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  // a stage's float32 result as the chain stores it, widened back
  static __device__ __forceinline__ float round(float v) {
    return round_to<__nv_bfloat16>(v);
  }
  static __device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
  }
};

template <>
struct Store<uint8_t> {
  static __device__ __forceinline__ float load(const uint8_t* p) {
    return e5m2_to_float(*p);
  }
  static __device__ __forceinline__ float round(float v) {
    return e5m2_to_float(e5m2_from_float(round_to<__nv_bfloat16>(v)));
  }
  // v is already e5m2-exact
  static __device__ __forceinline__ void put(uint8_t* p, float v) {
    *p = e5m2_from_float(v);
  }
};

__device__ __forceinline__ float bf16_lo(uint32_t u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t u) {
  return __uint_as_float(u & 0xFFFF0000u);
}

// LRN window sum at channel c of one pixel's bf16 channel row
__device__ __forceinline__ float lrn_window(const __nv_bfloat16* px, int c,
                                            int channels) {
  float win = 0.f;
  const int hi = min(c + 2, channels - 1);
  for (int j = max(c - 2, 0); j <= hi; ++j) {
    const float v = __bfloat162float(px[j]);
    win += round_to<__nv_bfloat16>(v * v);
  }
  return win;
}

// shared memory of one block; must match ops/cuda/stem.py::shared_bytes
__host__ __device__ inline int shared_bytes_for(int w) {
  const int tiles = (w + kXT - 1) / kXT;
  return (kRowsIn * (tiles * kXT + 2) * kCin + 3 * w * kCout) * 2 +
         (kCin + kCout) * 4;
}

template <typename S>
__global__ void __launch_bounds__(kThreads, 1)
    stem_tail_kernel(const S* __restrict__ x,
                     const __nv_bfloat16* __restrict__ wr,   // [ci][co]
                     const float* __restrict__ br,
                     const __nv_bfloat16* __restrict__ w2,   // [dy][dx][ci][co]
                     const float* __restrict__ b2, S* __restrict__ y, int h,
                     int w, int ho, int wo) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tiles = (w + kXT - 1) / kXT;
  const int wp = tiles * kXT + 2;   // reduce-conv row with its zero columns
  // [5][wp][64] reduce-conv output; column p + 1 holds pixel p
  __nv_bfloat16* cr = reinterpret_cast<__nv_bfloat16*>(smem);
  // [3][w][192] conv2 output
  __nv_bfloat16* c2 = cr + kRowsIn * wp * kCin;
  float* brs = reinterpret_cast<float*>(c2 + 3 * w * kCout);
  float* b2s = brs + kCin;
  // phase 1's buffers live in c2's space, which phase 2 writes later:
  // [w][64] input row, [w][64] LRN1 output
  __nv_bfloat16* raw = c2;
  float* l1 = reinterpret_cast<float*>(raw + w * kCin);

  const int tid = threadIdx.x;
  const int oh = blockIdx.x;
  const S* xi = x + static_cast<long long>(blockIdx.y) * h * w * kCin;

  for (int i = tid; i < kRowsIn * wp * kCin; i += kThreads)
    cr[i] = __float2bfloat16_rn(0.f);
  for (int i = tid; i < kCin; i += kThreads) brs[i] = br[i];
  for (int i = tid; i < kCout; i += kThreads) b2s[i] = b2[i];

  // ---- phase 1: LRN1 and the 1x1 reduce conv on rows 2oh-1 .. 2oh+3 ----
  {
    const int co = tid % kCin;
    const int group = tid / kCin;
    float wcol[kCin];   // wr[:, co], in registers
#pragma unroll
    for (int ci = 0; ci < kCin; ++ci)
      wcol[ci] = __bfloat162float(wr[ci * kCin + co]);
    for (int k = 0; k < kRowsIn; ++k) {
      const int row = 2 * oh - 1 + k;
      if (row < 0 || row >= h) continue;   // the same for the whole block
      const S* xr = xi + static_cast<long long>(row) * w * kCin;
      __syncthreads();   // the previous row's readers are done
      for (int i = tid; i < w * kCin; i += kThreads)
        raw[i] = __float2bfloat16_rn(Store<S>::load(xr + i));
      __syncthreads();
      for (int i = tid; i < w * kCin; i += kThreads) {
        const int c = i % kCin;
        const __nv_bfloat16* px = raw + (i - c);
        l1[i] = Store<S>::round(
            __bfloat162float(px[c]) *
            lrn_factor(lrn_window(px, c, kCin), kAlphaOverSize, kLrnK));
      }
      __syncthreads();
      for (int p = group; p < w; p += kThreads / kCin) {
        const float4* in = reinterpret_cast<const float4*>(l1 + p * kCin);
        float acc = 0.f;
#pragma unroll
        for (int q = 0; q < kCin / 4; ++q) {
          const float4 v = in[q];
          acc = __fmaf_rn(v.x, wcol[4 * q], acc);
          acc = __fmaf_rn(v.y, wcol[4 * q + 1], acc);
          acc = __fmaf_rn(v.z, wcol[4 * q + 2], acc);
          acc = __fmaf_rn(v.w, wcol[4 * q + 3], acc);
        }
        cr[(k * wp + p + 1) * kCin + co] = __float2bfloat16_rn(
            Store<S>::round(fmaxf(acc + brs[co], 0.f)));
      }
    }
  }
  __syncthreads();

  // ---- phase 2: conv2 3x3 + ReLU on rows 2oh .. 2oh+2 inside the image --
  const int nrows = min(3, h - 2 * oh);
  {
    const int co0 = (tid % kQuads) * kCT;
    for (int item = tid / kQuads; item < nrows * tiles; item += kXGroups) {
      const int r = item / tiles;
      const int x0 = (item % tiles) * kXT;
      float acc[kXT][kCT] = {};
      for (int dy = 0; dy < 3; ++dy) {
        for (int dx = 0; dx < 3; ++dx) {
          const __nv_bfloat16* in = cr + ((r + dy) * wp + x0 + dx) * kCin;
          const __nv_bfloat16* wt = w2 + (dy * 3 + dx) * kCin * kCout + co0;
          for (int ci = 0; ci < kCin; ci += 8) {
            float wv[8][kCT];
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              const uint2 u = __ldg(
                  reinterpret_cast<const uint2*>(wt + (ci + i) * kCout));
              wv[i][0] = bf16_lo(u.x);
              wv[i][1] = bf16_hi(u.x);
              wv[i][2] = bf16_lo(u.y);
              wv[i][3] = bf16_hi(u.y);
            }
#pragma unroll
            for (int j = 0; j < kXT; ++j) {
              const uint4 u =
                  *reinterpret_cast<const uint4*>(in + j * kCin + ci);
              const float f[8] = {bf16_lo(u.x), bf16_hi(u.x), bf16_lo(u.y),
                                  bf16_hi(u.y), bf16_lo(u.z), bf16_hi(u.z),
                                  bf16_lo(u.w), bf16_hi(u.w)};
#pragma unroll
              for (int i = 0; i < 8; ++i) {
#pragma unroll
                for (int c = 0; c < kCT; ++c)
                  acc[j][c] = __fmaf_rn(f[i], wv[i][c], acc[j][c]);
              }
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kXT; ++j) {
        const int xx = x0 + j;
        if (xx < w) {
          __nv_bfloat16* out = c2 + (r * w + xx) * kCout + co0;
#pragma unroll
          for (int c = 0; c < kCT; ++c)
            out[c] = __float2bfloat16_rn(
                Store<S>::round(fmaxf(acc[j][c] + b2s[co0 + c], 0.f)));
        }
      }
    }
  }
  __syncthreads();

  // ---- phase 3: LRN2 fused into the 3x3/2 pool; window edges past the
  // image are left out, which is the ceil-mode pool's max against -inf ----
  S* yr = y + (static_cast<long long>(blockIdx.y) * ho + oh) * wo * kCout;
  for (int i = tid; i < wo * kCout; i += kThreads) {
    const int c = i % kCout;
    const int ow = i / kCout;
    float m = -INFINITY;
    for (int r = 0; r < nrows; ++r) {
      for (int dw = 0; dw < 3; ++dw) {
        const int xx = 2 * ow + dw;
        if (xx >= w) break;
        const __nv_bfloat16* px = c2 + (r * w + xx) * kCout;
        m = fmaxf(m, Store<S>::round(
                         __bfloat162float(px[c]) *
                         lrn_factor(lrn_window(px, c, kCout), kAlphaOverSize,
                                    kLrnK)));
      }
    }
    Store<S>::put(yr + i, m);
  }
}

template <typename S>
int launch_stem_tail(const void* x, const void* wr, const void* br,
                     const void* w2, const void* b2, void* y, int batch,
                     int h, int w, int ho, int wo, int shared_bytes,
                     cudaStream_t stream) {
  if (shared_bytes != shared_bytes_for(w) || h < 3 || w < 3)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      stem_tail_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      shared_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(ho, batch);
  stem_tail_kernel<S><<<grid, kThreads, shared_bytes, stream>>>(
      static_cast<const S*>(x), static_cast<const __nv_bfloat16*>(wr),
      static_cast<const float*>(br), static_cast<const __nv_bfloat16*>(w2),
      static_cast<const float*>(b2), static_cast<S*>(y), h, w, ho, wo);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace torchfcn

using namespace torchfcn;

extern "C" int torchfcn_stem_tail(const void* x, const void* wr,
                                  const void* br, const void* w2,
                                  const void* b2, void* y, int batch, int h,
                                  int w, int ho, int wo, int shared_bytes,
                                  int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16)
    return launch_stem_tail<__nv_bfloat16>(x, wr, br, w2, b2, y, batch, h, w,
                                           ho, wo, shared_bytes, s);
  if (dtype == kFloat8E5M2)
    return launch_stem_tail<uint8_t>(x, wr, br, w2, b2, y, batch, h, w, ho,
                                     wo, shared_bytes, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
