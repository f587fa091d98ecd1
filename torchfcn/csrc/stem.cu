// The GoogLeNet stem tail fused into one kernel, on channels-last tensors:
//
//   pool1 output (B, H, W, 64) -> LRN1 -> conv2/3x3_reduce 1x1 + ReLU
//     -> conv2/3x3 3x3 pad 1 + ReLU -> LRN2 -> pool2 3x3/2 ceil mode
//     -> (B, Ho, Wo, 192)
//
// Replaces tpufcn/ops/pallas/stem.py::stem_tail_pallas ((8, 112, 112, 64)
// -> (8, 56, 56, 192) on the serving path).
//
// Row shards (the (data, space) mesh, torchfcn/models/googlenet.py): the
// input may carry halo rows, `halo_top` rows of the shard above and
// `halo_bottom` of the shard below, which are real data and not conv2's zero
// padding.  Only rows outside the input are padding.  The pool's windows
// start at the shard's own rows 0, 2, 4, ... and the kernel writes exactly
// the shard's (H - halo_top - halo_bottom) / 2 pooled rows; an interior
// shard gives 1 row above (conv2) and 2 below (conv2 and the pool's third
// row).  Without halos this is the whole frame's stem tail.
//
// The storage type is a template parameter:
//   * bf16 computes what stem_tail_pallas computes;
//   * e5m2 reads the serving model's e5m2 pool1 output, rounds the LRN1,
//     conv2_reduce, conv2 and LRN2 outputs to bf16 and then to e5m2, as the
//     serving model stores them (tpufcn/models/googlenet.py:186-200), and
//     writes e5m2.  The roundings happen in registers: the intermediates
//     never leave the chip.
//
// Rounding: each conv multiplies bf16 operands, accumulates in float32,
// adds the float32 bias, applies ReLU and rounds once.  The LRNs round their
// squares to bf16 and sum the window in float32, as
// tpufcn.ops.caffe_layers.lrn_across_channels does in bf16.  Both convs run
// on the tensor cores as bf16 x bf16 products with float32 accumulation, in
// both instances: the e5m2 instance's activations are e5m2-exact bf16
// values, but its weights are bf16, so an fp8 product would compute another
// function.
//
// What bounds it on the H100: arithmetic.  conv2 is 11.1 GMAC at B = 8,
// 112^2, the reduce conv 0.4 GMAC: 23.0 GFLOP, 23 us at the 989 TFLOP/s of
// the bf16 tensor cores, against 6.4 MB of e5m2 input and 4.8 MB of output
// (3.4 us at 3.35 TB/s).  The design:
//   * implicit GEMM on mma.sync.m16n8k16 (bf16 in, f32 accumulators), A and
//     B fed by ldmatrix from shared memory: conv2 is M = the W pixels of a
//     row, N = 192, K = 9 taps x 64; the reduce conv M = W, N = 64, K = 64.
//     mma.sync and not wgmma: wgmma's A tile is 64 rows read through a
//     descriptor of a fixed core-matrix layout, and conv2's 9 taps read A at
//     shifts of one pixel (dx) from a ring of rows; that layout, its
//     descriptors and the async fences could not be checked here before a
//     card run, and a wrong one computes quietly wrong sums.  mma.sync with
//     ldmatrix takes any row address per lane, so a tap is a pointer shift;
//   * shared rows are 64 bf16 (128 bytes) per pixel, their 16-byte chunks
//     XOR-swizzled by the row index, so ldmatrix reads no two rows of one
//     8x8 matrix from the same banks;
//   * a block walks a stripe of pool rows (the wrapper's stripe plan: at
//     B = 8, 112^2, 14 stripes of 4 pool rows, 112 blocks, one wave on 132
//     SMs).  Each conv2 row is computed once per stripe: a ring of 3
//     reduce-conv rows (one zero column each side; rows outside the image
//     stay zero, which is conv2's zero padding of the reduce conv's output)
//     gains one row per conv2 row.  Only a stripe's first pool row pays the
//     overlap: 9 conv2 rows for 4 pool rows (8 without stripes);
//   * as each conv2 row leaves the accumulators it is rounded into a
//     staging row; LRN2 and the horizontal half of the pool read it and
//     max into one pooled row (bf16, exact for these values), which is
//     written out when its last conv2 row is done;
//   * conv2's weights stream through shared memory one tap (192 x 64 bf16,
//     24 KB) at a time, three buffers filled by cp.async two taps ahead:
//     the next taps (and a row's first two, during the previous row's LRN2
//     and reduce conv) load while the current one multiplies;
//   * 512 threads (16 warps, 4 along M x 4 along N; conv2: each warp up to
//     2 m-tiles x 6 n-tiles, 48 f32 accumulators), one block per SM: the
//     LRN, rounding and pool work between the products is latency-bound,
//     and 16 warps hide twice what 8 did; ptxas gives 128 registers a
//     thread (the most 512 threads on one SM can have) and 72 bytes of
//     spills;
//     193,024 bytes of shared memory at W = 112 and 208,640 at W = 128, the
//     widest the wrapper takes (4 warps x 2 m-tiles x 16 pixels).
#include "common.cuh"

namespace torchfcn {
namespace {

constexpr int kCin = 64;                  // pool1 = conv2_reduce channels
constexpr int kCout = 192;                // conv2 channels
constexpr int kThreads = 512;             // 16 warps: 4 along M x 4 along N
constexpr int kWarpsM = 4;
constexpr int kMTilesPerWarp = 2;         // m-tiles wm, wm + 4
constexpr int kMaxWidth = 128;            // 4 warps x 2 m-tiles x 16
constexpr int kStage = 200;               // staging row stride (bf16)
constexpr int kTap = kCout * kCin;        // one conv2 weight tap
constexpr int kTapBuffers = 3;            // taps in flight: 2 ahead
constexpr float kAlphaOverSize = 1e-4f / 5.f;
constexpr float kLrnK = 1.f;

// 8 float values (bf16-exact) packed as bf16
__device__ __forceinline__ uint4 pack8(const float (&f)[8]) {
  uint4 u;
  uint32_t* w = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) w[k] = pack_bf16(f[2 * k], f[2 * k + 1]);
  return u;
}

// 8 packed bf16 widened to float
__device__ __forceinline__ void unpack8(uint4 u, float (&f)[8]) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    f[2 * k] = bf16_lo(w[k]);
    f[2 * k + 1] = bf16_hi(w[k]);
  }
}

// storage types: bf16, or e5m2 held as its 8-bit code
template <typename S>
struct Store;

template <>
struct Store<__nv_bfloat16> {
  // 8 consecutive values as bf16 (exact)
  static __device__ __forceinline__ uint4 load8(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint4*>(p);
  }
  // a stage's float32 result as the chain stores it, widened back
  static __device__ __forceinline__ float round(float v) {
    return round_to<__nv_bfloat16>(v);
  }
  static __device__ __forceinline__ void put8(__nv_bfloat16* p,
                                              const float (&v)[8]) {
    *reinterpret_cast<uint4*>(p) = pack8(v);
  }
};

template <>
struct Store<uint8_t> {
  static __device__ __forceinline__ uint4 load8(const uint8_t* p) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    uint4 out;
    uint32_t* o = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t word = i < 2 ? u.x : u.y;
      const int shift = (i & 1) * 16;
      const __nv_bfloat162 pair = __floats2bfloat162_rn(
          e5m2_to_float((word >> shift) & 0xFF),
          e5m2_to_float((word >> (shift + 8)) & 0xFF));
      o[i] = *reinterpret_cast<const uint32_t*>(&pair);
    }
    return out;
  }
  // v rounded to bf16, then to e5m2 as PyTorch's fp8e5m2_from_fp32_value
  // rounds (nearest even, overflow to inf), so exactly as
  // tensor.to(torch.float8_e5m2) on either device.  e5m2 has f16's
  // exponent field: an e5m2 value is the top byte of an f16.  A bf16 value
  // of magnitude 2^-14 or more (or 0) converts to f16 exactly, or to inf
  // past its range, so rounding the f16's low byte away, half to even, is
  // that rounding, overflow included.  Below 2^-14 lie e5m2's subnormals,
  // the multiples of 2^-16: adding and subtracting 128, whose float32 ulp is
  // 2^-16, rounds to them half to even, as PyTorch's does.
  static __device__ __forceinline__ float round(float v) {
    const float b = round_to<__nv_bfloat16>(v);
    const float a = fabsf(b);
    const float sub = copysignf((a + 128.f) - 128.f, b);
    const unsigned short bits = __half_as_ushort(__float2half_rn(b));
    const float normal = __half2float(__ushort_as_half(
        static_cast<unsigned short>((bits + 0x7F + ((bits >> 8) & 1)) &
                                    0xFF00)));
    return a < 6.103515625e-05f ? sub : normal;
  }
  // v is already e5m2-exact
  static __device__ __forceinline__ void put8(uint8_t* p,
                                              const float (&v)[8]) {
    uint2 u;
    u.x = u.y = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {   // f16 holds every e5m2 value exactly
      const uint32_t code = __half_as_ushort(__float2half_rn(v[k])) >> 8;
      (k < 4 ? u.x : u.y) |= code << (8 * (k & 3));
    }
    *reinterpret_cast<uint2*>(p) = u;
  }
};

// element (row, c) of a [rows][64] bf16 tile whose 16-byte chunks are
// XOR-swizzled by the row index
__device__ __forceinline__ int swz(int row, int c) {
  return row * kCin + ((((c >> 3) ^ row) & 7) << 3) + (c & 7);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const __nv_bfloat16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// every commit group but the newest has landed
__device__ __forceinline__ void cp_async_wait_group_1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// the LRN outputs at channels 8 chunk .. 8 chunk + 7 of one pixel's bf16
// channel row px, rounded as the chain stores them, packed as 8 bf16.  The
// squares round to bf16 and each window sums in channel order from its
// lowest channel; zeros past the ends add nothing.
template <typename S>
__device__ __forceinline__ uint4 lrn8(const __nv_bfloat16* px, int chunk,
                                      int channels) {
  float v[12];
  const uint4 own = *reinterpret_cast<const uint4*>(px + 8 * chunk);
  const uint32_t* o = reinterpret_cast<const uint32_t*>(&own);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[2 + 2 * k] = bf16_lo(o[k]);
    v[3 + 2 * k] = bf16_hi(o[k]);
  }
  const bool left = chunk > 0, right = 8 * chunk + 8 < channels;
  v[0] = left ? __bfloat162float(px[8 * chunk - 2]) : 0.f;
  v[1] = left ? __bfloat162float(px[8 * chunk - 1]) : 0.f;
  v[10] = right ? __bfloat162float(px[8 * chunk + 8]) : 0.f;
  v[11] = right ? __bfloat162float(px[8 * chunk + 9]) : 0.f;
  float sq[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) sq[k] = round_to<__nv_bfloat16>(v[k] * v[k]);
  uint4 packed;
  uint32_t* out = reinterpret_cast<uint32_t*>(&packed);
#pragma unroll
  for (int k = 0; k < 8; k += 2) {
    float r[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float win = 0.f;
#pragma unroll
      for (int j = 0; j < 5; ++j) win += sq[k + e + j];
      r[e] = Store<S>::round(v[k + e + 2] *
                             lrn_factor(win, kAlphaOverSize, kLrnK));
    }
    out[k / 2] = pack_bf16(r[0], r[1]);
  }
  return packed;
}

struct Geometry {
  int mtiles;   // 16-pixel m-tiles of a row
  int wp;       // reduce-conv row: pixels of the m-tiles + 2 zero columns
  int stage;    // staging elements: a conv2 row, or LRN1 input and output
};

__host__ __device__ inline Geometry geometry(int w) {
  Geometry g;
  g.mtiles = (w + 15) / 16;
  g.wp = 16 * g.mtiles + 2;
  const int conv2_row = w * kStage;
  const int lrn1_rows = (16 * g.mtiles + w) * kCin;
  g.stage = conv2_row > lrn1_rows ? conv2_row : lrn1_rows;
  return g;
}

// shared memory of one block; must match ops/cuda/stem.py::shared_bytes.
// Wo = w / 2 is the ceil-mode 3x3/2 pooled width for w >= 3.
__host__ __device__ inline int shared_bytes_for(int w) {
  const Geometry g = geometry(w);
  return (3 * g.wp * kCin + kTapBuffers * kTap + kCin * kCin + g.stage +
          (w / 2) * kCout) * 2 +
         (kCin + kCout) * 4;
}

// copy conv2 weight tap `tap` ([co][ci] rows in w2) into dst, swizzled
__device__ __forceinline__ void load_tap(__nv_bfloat16* dst,
                                         const __nv_bfloat16* w2, int tap,
                                         int tid) {
  const __nv_bfloat16* src = w2 + tap * kTap;
  for (int q = tid; q < kCout * 8; q += kThreads) {
    const int co = q >> 3, chunk = q & 7;
    cp_async16(dst + swz(co, chunk * 8), src + co * kCin + chunk * 8);
  }
}

template <typename S>
__global__ void __launch_bounds__(kThreads, 1)
    stem_tail_kernel(const S* __restrict__ x,
                     const __nv_bfloat16* __restrict__ wr,   // [co][ci]
                     const float* __restrict__ br,
                     const __nv_bfloat16* __restrict__ w2,   // [dy][dx][co][ci]
                     const float* __restrict__ b2, S* __restrict__ y, int h,
                     int w, int ho, int wo, int stripe_rows, int halo_top) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Geometry geo = geometry(w);
  // [3][wp][64] ring of reduce-conv rows (swizzled); column p + 1 holds
  // pixel p
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* taps = ring + 3 * geo.wp * kCin;   // [3][192][64] swizzled
  __nv_bfloat16* wrs = taps + kTapBuffers * kTap;   // [64][64] swizzled
  // the staging area holds a conv2 row [w][kStage], or, while a reduce-conv
  // row is made, LRN1's output [16 * mtiles][64] (swizzled) and its input
  // row [w][64]
  __nv_bfloat16* stage = wrs + kCin * kCin;
  __nv_bfloat16* l1 = stage;
  __nv_bfloat16* raw = stage + 16 * geo.mtiles * kCin;
  __nv_bfloat16* pooled = stage + geo.stage;        // [wo][192]
  float* brs = reinterpret_cast<float*>(pooled + wo * kCout);
  float* b2s = brs + kCin;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp % kWarpsM, wn = warp / kWarpsM;   // warp tile
  const int g = lane >> 2, t = lane & 3;            // mma fragment row, col
  const int b = blockIdx.y;
  const int oh0 = blockIdx.x * stripe_rows;
  const int oh1 = min(oh0 + stripe_rows, ho);
  // input rows (halo rows included); pool row oh starts at input row
  // halo_top + 2 oh
  const int r_first = halo_top + 2 * oh0;
  const int r_last = min(halo_top + 2 * oh1, h - 1);
  const S* xi = x + static_cast<long long>(b) * h * w * kCin;
  S* yi = y + static_cast<long long>(b) * ho * wo * kCout;

  // conv2's first two taps; each tap then starts the copy of the one two
  // taps ahead (one commit group per tap, empty past the last)
  load_tap(taps, w2, 0, tid);
  cp_async_commit();
  load_tap(taps + kTap, w2, 1, tid);
  cp_async_commit();
  for (int i = tid; i < 3 * geo.wp * kCin; i += kThreads)
    ring[i] = __float2bfloat16_rn(0.f);
  for (int i = tid; i < kCin * kCin; i += kThreads)
    wrs[swz(i / kCin, i % kCin)] = wr[i];
  for (int i = tid; i < kCin; i += kThreads) brs[i] = br[i];
  for (int i = tid; i < kCout; i += kThreads) b2s[i] = b2[i];
  __syncthreads();

  // LRN1 and the 1x1 reduce conv of input row `row` into its ring slot;
  // zeros for a row outside the image.  Leaves every thread synchronised.
  auto reduce_row = [&](int row) {
    __nv_bfloat16* slot = ring + ((row + 3) % 3) * geo.wp * kCin;
    if (row < 0 || row >= h) {   // the same for the whole block
      for (int i = tid; i < w * kCin; i += kThreads)
        slot[swz(1 + i / kCin, i % kCin)] = __float2bfloat16_rn(0.f);
      __syncthreads();
      return;
    }
    const S* xr = xi + static_cast<long long>(row) * w * kCin;
    for (int q = tid; q < w * 8; q += kThreads)
      *reinterpret_cast<uint4*>(raw + q * 8) = Store<S>::load8(xr + q * 8);
    __syncthreads();
    // LRN1: 8 channels of one pixel per item; zeros past the row
    for (int q = tid; q < 16 * geo.mtiles * 8; q += kThreads) {
      const int p = q >> 3, chunk = q & 7;
      const uint4 packed = p < w ? lrn8<S>(raw + p * kCin, chunk, kCin)
                                 : make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(l1 + swz(p, chunk * 8)) = packed;
    }
    __syncthreads();
    // the 1x1 conv on the tensor cores: warp (wm, wn) takes m-tiles wm,
    // wm + 4 and output channels 16 wn .. 16 wn + 15
    float acc[kMTilesPerWarp][2][4] = {};
#pragma unroll
    for (int kc = 0; kc < kCin / 16; ++kc) {
      uint32_t bf[4];
      ldmatrix_x4(bf, wrs + swz(16 * wn + ((lane >> 4) << 3) + (lane & 7),
                                16 * kc + (((lane >> 3) & 1) << 3)));
#pragma unroll
      for (int i = 0; i < kMTilesPerWarp; ++i) {
        const int mt = wm + kWarpsM * i;
        if (mt < geo.mtiles) {
          uint32_t af[4];
          ldmatrix_x4(af, l1 + swz(16 * mt + (lane & 15),
                                   16 * kc + ((lane >> 4) << 3)));
          mma_bf16(acc[i][0], af, bf[0], bf[1]);
          mma_bf16(acc[i][1], af, bf[2], bf[3]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kMTilesPerWarp; ++i) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int co = 16 * wn + 8 * nt + 2 * t;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int p = 16 * (wm + kWarpsM * i) + g + 8 * half;
          if (p < w) {
            const float* a = &acc[i][nt][2 * half];
            *reinterpret_cast<uint32_t*>(slot + swz(p + 1, co)) = pack_bf16(
                Store<S>::round(fmaxf(a[0] + brs[co], 0.f)),
                Store<S>::round(fmaxf(a[1] + brs[co + 1], 0.f)));
          }
        }
      }
    }
    __syncthreads();
  };

  reduce_row(r_first - 1);
  reduce_row(r_first);
  int tap_count = 0;   // taps multiplied so far: tap n sits in buffer n % 3
  for (int r = r_first; r <= r_last; ++r) {
    const int rr = r - halo_top;   // the row within the shard
    reduce_row(r + 1);

    // ---- conv2 row r on the tensor cores: warp (wm, wn) takes m-tiles
    // wm, wm + 4 and output channels 48 wn .. 48 wn + 47 ----
    float acc[kMTilesPerWarp][6][4] = {};
    for (int tap = 0; tap < 9; ++tap, ++tap_count) {
      cp_async_wait_group_1();
      __syncthreads();   // this tap landed; the previous tap's buffer is free
      if (tap + 2 < 9 || r < r_last)
        load_tap(taps + ((tap_count + 2) % kTapBuffers) * kTap, w2,
                 (tap + 2) % 9, tid);
      cp_async_commit();
      const __nv_bfloat16* wt = taps + (tap_count % kTapBuffers) * kTap;
      const int dy = tap / 3, dx = tap % 3;
      const __nv_bfloat16* in = ring + ((r - 1 + dy + 3) % 3) * geo.wp * kCin;
#pragma unroll
      for (int kc = 0; kc < kCin / 16; ++kc) {
        uint32_t bf[3][4];
#pragma unroll
        for (int q = 0; q < 3; ++q)
          ldmatrix_x4(bf[q], wt + swz(48 * wn + 16 * q + ((lane >> 4) << 3) +
                                          (lane & 7),
                                      16 * kc + (((lane >> 3) & 1) << 3)));
        // all A fragments first, so that their loads are in flight together
        uint32_t af[kMTilesPerWarp][4];
#pragma unroll
        for (int i = 0; i < kMTilesPerWarp; ++i)
          if (wm + kWarpsM * i < geo.mtiles)
            ldmatrix_x4(af[i],
                        in + swz(16 * (wm + kWarpsM * i) + (lane & 15) + dx,
                                 16 * kc + ((lane >> 4) << 3)));
#pragma unroll
        for (int i = 0; i < kMTilesPerWarp; ++i) {
          if (wm + kWarpsM * i < geo.mtiles) {
#pragma unroll
            for (int q = 0; q < 3; ++q) {
              mma_bf16(acc[i][2 * q], af[i], bf[q][0], bf[q][1]);
              mma_bf16(acc[i][2 * q + 1], af[i], bf[q][2], bf[q][3]);
            }
          }
        }
      }
    }
    // bias, ReLU, rounding into the staging row (LRN1's buffers are free:
    // every thread passed the tap loop's barriers after the reduce conv)
#pragma unroll
    for (int i = 0; i < kMTilesPerWarp; ++i) {
#pragma unroll
      for (int nt = 0; nt < 6; ++nt) {
        const int co = 48 * wn + 8 * nt + 2 * t;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int p = 16 * (wm + kWarpsM * i) + g + 8 * half;
          if (p < w) {
            const float* a = &acc[i][nt][2 * half];
            *reinterpret_cast<uint32_t*>(stage + p * kStage + co) =
                pack_bf16(Store<S>::round(fmaxf(a[0] + b2s[co], 0.f)),
                          Store<S>::round(fmaxf(a[1] + b2s[co + 1], 0.f)));
          }
        }
      }
    }
    __syncthreads();

    // ---- LRN2 in place on the staging row: each item is 8 channels of
    // one pixel, held in registers until every item has read its
    // neighbours ----
    constexpr int kChunks = kCout / 8;
    constexpr int kItems = (kMaxWidth * kChunks + kThreads - 1) / kThreads;
    uint4 lrn2[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int q = tid + k * kThreads;
      if (q < w * kChunks)
        lrn2[k] = lrn8<S>(stage + (q / kChunks) * kStage, q % kChunks, kCout);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int q = tid + k * kThreads;
      if (q < w * kChunks)
        *reinterpret_cast<uint4*>(stage + (q / kChunks) * kStage +
                                  (q % kChunks) * 8) = lrn2[k];
    }
    __syncthreads();

    // ---- the pool: the row's horizontal maxima, then the vertical max
    // with the pool row's other conv2 rows.  Pool row oh reads the shard's
    // conv2 rows 2 oh .. 2 oh + 2, those of them in the input; window edges
    // past the input are left out, which is the ceil-mode pool's max
    // against -inf at the frame's bottom ----
    for (int q = tid; q < wo * kChunks; q += kThreads) {
      const int ow = q / kChunks, chunk = q % kChunks;
      const __nv_bfloat16* px = stage + 2 * ow * kStage + chunk * 8;
      float hp[8], v[8];
      unpack8(*reinterpret_cast<const uint4*>(px), hp);
      for (int dw = 1; dw < 3 && 2 * ow + dw < w; ++dw) {
        unpack8(*reinterpret_cast<const uint4*>(px + dw * kStage), v);
#pragma unroll
        for (int e = 0; e < 8; ++e) hp[e] = fmaxf(hp[e], v[e]);
      }
      uint4* m = reinterpret_cast<uint4*>(pooled + q * 8);
      unpack8(*m, v);   // the pool row's running max
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = fmaxf(v[e], hp[e]);
      if ((rr & 1) == 0) {
        // the last row of pool row rr/2 - 1 and the first of pool row rr/2
        if (r > r_first)
          Store<S>::put8(yi + (static_cast<long long>(rr / 2 - 1) * wo + ow) *
                                  kCout + chunk * 8, v);
        if (rr / 2 < oh1) *m = pack8(hp);
      } else if (r == h - 1) {   // the input's last row ends pool row rr/2
        Store<S>::put8(yi + (static_cast<long long>(rr / 2) * wo + ow) *
                                kCout + chunk * 8, v);
      } else {
        *m = pack8(v);
      }
    }
    __syncthreads();   // the staging row is free for the next reduce conv
  }
}

template <typename S>
int launch_stem_tail(const void* x, const void* wr, const void* br,
                     const void* w2, const void* b2, void* y, int batch,
                     int h, int w, int ho, int wo, int stripe_rows,
                     int stripes, int shared_bytes, int halo_top,
                     int halo_bottom, cudaStream_t stream) {
  const int rows = h - halo_top - halo_bottom;   // the shard's own rows
  if (shared_bytes != shared_bytes_for(w) || h < 3 || w < 3 ||
      w > kMaxWidth || halo_top < 0 || halo_bottom < 0 || rows < 2 ||
      ((halo_top || halo_bottom) && rows % 2) || ho != rows / 2 ||
      wo != w / 2 || stripe_rows < 1 ||
      stripes < 1 || static_cast<long long>(stripes) * stripe_rows < ho ||
      (stripes - 1) * stripe_rows >= ho)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      stem_tail_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      shared_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(stripes, batch);
  stem_tail_kernel<S><<<grid, kThreads, shared_bytes, stream>>>(
      static_cast<const S*>(x), static_cast<const __nv_bfloat16*>(wr),
      static_cast<const float*>(br), static_cast<const __nv_bfloat16*>(w2),
      static_cast<const float*>(b2), static_cast<S*>(y), h, w, ho, wo,
      stripe_rows, halo_top);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace torchfcn

using namespace torchfcn;

extern "C" int torchfcn_stem_tail(const void* x, const void* wr,
                                  const void* br, const void* w2,
                                  const void* b2, void* y, int batch, int h,
                                  int w, int ho, int wo, int stripe_rows,
                                  int stripes, int shared_bytes, int dtype,
                                  int halo_top, int halo_bottom,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16)
    return launch_stem_tail<__nv_bfloat16>(x, wr, br, w2, b2, y, batch, h, w,
                                           ho, wo, stripe_rows, stripes,
                                           shared_bytes, halo_top,
                                           halo_bottom, s);
  if (dtype == kFloat8E5M2)
    return launch_stem_tail<uint8_t>(x, wr, br, w2, b2, y, batch, h, w, ho,
                                     wo, stripe_rows, stripes, shared_bytes,
                                     halo_top, halo_bottom, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
