// Caffe across-channel LRN, and LRN fused with the Caffe ceil-mode 3x3/2
// max pool, on channels-last (NHWC) tensors in float32 or bf16.
//
// Replaces tpufcn/ops/pallas/lrn.py::lrn_pallas (GoogLeNet pool1/norm1,
// (8, 112, 112, 64) bf16 on the bf16 path) and
// tpufcn/ops/pallas/lrn_pool.py::lrn_maxpool_pallas (conv2/norm2 ->
// pool2/3x3_s2, (8, 112, 112, 192) -> (8, 56, 56, 192) bf16).
//
// What bounds them on the H100: the bytes, and close behind them the
// special-function unit.  Per LRN value the kernels move 2 bytes in (bf16)
// and, for lrn, 2 out, and issue three special-function instructions
// (rsqrt, the rsqrt inside the IEEE sqrt, rsqrt: common.cuh::lrn_factor),
// of which an H100 SM issues 16 per clock, about 4.18e12 per second on 132
// SMs.  At the bf16 path's shapes lrn needs 7.7 us for its 25.7 MB and 4.6
// us on that unit; lrn_maxpool 14.4 us for its 48.2 MB and 13.8 us on that
// unit, so it must evaluate each LRN value exactly once (its first design
// evaluated each of the 9 values of every pool window, 2.25x the work) and
// overlap the copies with the arithmetic.  The design:
//   * rows staged by Hopper's 1-D bulk copy: in NHWC a stretch of pixels of
//     one image row is one contiguous range (W x C elements, or the 2 Wt + 1
//     columns of a column tile), so one thread copies it into shared memory
//     with cp.async.bulk, completing on an mbarrier of its ring slot; the
//     copy of the next range runs while the block computes on the current
//     one.  The LRN reads each value's window from shared memory;
//   * the vector instance moves 16 bytes per access: each thread computes 8
//     bf16 (4 float32) channels of one pixel from its own 16 bytes and the
//     2 channels on each side, squares each value once, and stores 16 bytes;
//   * lrn: persistent blocks (4 per SM) walk tiles of consecutive pixels
//     (about 8 KB each) through a ring of 3 slots, and store straight to
//     device memory;
//   * lrn_maxpool: one block per (image, stripe of pool rows, column tile),
//     from the host's plan, which minimises the busiest SM's work (at B = 8,
//     112^2, 192 channels: 8 stripes of 7 pool rows x 4 tiles of 14 pool
//     columns, 256 blocks, 2 per SM).  A block walks input rows 2 oh0 ..
//     2 oh1 down through a ring of 2 slots; the LRN of each staged row goes
//     to one of two shared LRN rows (so one barrier a row suffices), the
//     3-wide stride-2 horizontal max of it (bf16 pairs in one instruction)
//     folds into a pooled row in shared memory (each thread owns the same
//     pooled entries on every row), and a finished pool row leaves in
//     16-byte stores.  A stripe rereads only its
//     first input row and a column tile its first column; the LRN output
//     never reaches device memory;
//   * the scalar instance of both (one channel per thread, read from device
//     memory) covers channel rows that are not a multiple of 16 bytes and
//     inputs that are not 16-byte aligned, which the bulk copy needs.
//   Sizes other than 5 take the same kernels with the window walked at run
//   time.
//
// Rounding is that of tpufcn.ops.caffe_layers.lrn_across_channels and of
// torchfcn's plain version: in bf16 the squares are rounded to bf16; the
// window sums in float32 in channel order c - half .. c + half, channels
// past the ends adding exact zeros; the power beta = 0.75 is
// rsqrt(s) * rsqrt(sqrt(s)); the result is rounded to the storage type,
// before the pool's max as the unfused chain stores it.  No running sum:
// each window is summed anew.
#include <type_traits>

#include "common.cuh"

namespace torchfcn {
namespace {

constexpr int kThreads = 256;
constexpr int kHeaderBytes = 64;    // the ring slots' mbarriers
constexpr int kLrnSlots = 3;        // lrn: tiles in flight, 2 ahead
constexpr int kPoolSlots = 2;       // lrn_maxpool: rows in flight, 1 ahead
constexpr int kAnyHalf = -1;        // window half-width known at run time
// at most 64 registers a thread, so that 4 blocks fit an SM: the lrn plan
// puts 4 on each; the lrn_maxpool plan fills 2, and its smaller blocks may
// share an SM with more
constexpr int kLrnBlocksPerSm = 4;
constexpr int kPoolBlocksPerSm = 4;

// ---- 1-D bulk copies into shared memory, completing on mbarriers ----

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// makes the barriers' initialisation visible to the async proxy
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// orders this thread's and, after a barrier, the block's earlier accesses
// of shared memory before later bulk-copy writes into it
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// copy `bytes` (a multiple of 16; both addresses 16-byte aligned) from
// device memory to shared memory; the copy completes the phase of `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// wait until the phase of `bar` with this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// ---- V consecutive channels: V = 1, or 16 bytes (8 bf16, 4 float) ----

template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* p, float (&f)[V]) {
  if constexpr (V == 1) {
    f[0] = load_f(p);
  } else {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if constexpr (sizeof(T) == 4) {
        f[k] = __uint_as_float(w[k]);
      } else {
        f[2 * k] = bf16_lo(w[k]);
        f[2 * k + 1] = bf16_hi(w[k]);
      }
    }
  }
}

// f rounded to T (to nearest even) on the way; bf16 pairs in one
// conversion each
template <typename T, int V>
__device__ __forceinline__ void store_vec(T* p, const float (&f)[V]) {
  if constexpr (V == 1) {
    store_f(p, f[0]);
  } else {
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if constexpr (sizeof(T) == 4)
        w[k] = __float_as_uint(f[k]);
      else
        w[k] = pack_bf16(f[2 * k], f[2 * k + 1]);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// V channels as stored, for the pool's max: 16 bytes, or one value
template <int V>
using Raw = typename std::conditional<V == 1, float, uint4>::type;

template <typename T, int V>
__device__ __forceinline__ Raw<V> load_raw(const T* p) {
  if constexpr (V == 1)
    return load_f(p);
  else
    return *reinterpret_cast<const uint4*>(p);
}

template <typename T, int V>
__device__ __forceinline__ void store_raw(T* p, Raw<V> v) {
  if constexpr (V == 1)
    store_f(p, v);
  else
    *reinterpret_cast<uint4*>(p) = v;
}

// elementwise max, NaN losing as in fmaxf: bf16 pairs in one instruction
template <typename T>
__device__ __forceinline__ uint32_t max2(uint32_t a, uint32_t b) {
  if constexpr (sizeof(T) == 2) {
    const __nv_bfloat162 m =
        __hmax2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                *reinterpret_cast<const __nv_bfloat162*>(&b));
    return *reinterpret_cast<const uint32_t*>(&m);
  } else {
    return __float_as_uint(fmaxf(__uint_as_float(a), __uint_as_float(b)));
  }
}

template <typename T, int V>
__device__ __forceinline__ Raw<V> vmax(Raw<V> a, Raw<V> b) {
  if constexpr (V == 1)
    return fmaxf(a, b);
  else
    return make_uint4(max2<T>(a.x, b.x), max2<T>(a.y, b.y),
                      max2<T>(a.z, b.z), max2<T>(a.w, b.w));
}

// the two channels at p (4- or 8-byte aligned) widened to float
template <typename T>
__device__ __forceinline__ void load_pair(const T* p, float& lo, float& hi) {
  if constexpr (sizeof(T) == 2) {
    const uint32_t u = *reinterpret_cast<const uint32_t*>(p);
    lo = bf16_lo(u);
    hi = bf16_hi(u);
  } else {
    const float2 f = *reinterpret_cast<const float2*>(p);
    lo = f.x;
    hi = f.y;
  }
}

// LRN of channel c of one pixel's channel row, rounded to T, with the
// window walked at run time
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

// the squares of v, rounded to T: bf16 pairs in one conversion each
template <typename T, int N>
__device__ __forceinline__ void squares(const float (&v)[N], float (&sq)[N]) {
  if constexpr (sizeof(T) == 2 && N % 2 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 2) {
      const uint32_t pair = pack_bf16(v[i] * v[i], v[i + 1] * v[i + 1]);
      sq[i] = bf16_lo(pair);
      sq[i + 1] = bf16_hi(pair);
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) sq[i] = round_to<T>(v[i] * v[i]);
  }
}

// the LRN outputs at channels c .. c + V - 1 of the channel row px (shared
// or device memory), before their rounding to T (store_vec rounds).  With
// HALF known, each of the V + 2 HALF values is loaded and squared once;
// channels past the row's ends are zeros.  A window's sum starts at its
// lowest channel's square, which is what adding it to 0 gives.
template <typename T, int V, int HALF>
__device__ __forceinline__ void lrn_vec(const T* px, int c, int channels,
                                        int half, float alpha_over_size,
                                        float k, float (&out)[V]) {
  if constexpr (HALF == kAnyHalf) {
#pragma unroll
    for (int j = 0; j < V; ++j)
      out[j] = lrn_at<T>(px, c + j, channels, half, alpha_over_size, k);
  } else {
    constexpr int N = V + 2 * HALF;
    float v[N];
    float own[V];
    load_vec<T, V>(px + c, own);
#pragma unroll
    for (int j = 0; j < V; ++j) v[HALF + j] = own[j];
    if constexpr (V > 1 && HALF == 2) {
      // c and channels are multiples of V (4 or 8): the two channels on
      // each side are one aligned pair, both inside the row or both outside
      v[0] = v[1] = v[V + 2] = v[V + 3] = 0.f;
      if (c > 0) load_pair<T>(px + c - 2, v[0], v[1]);
      if (c + V < channels) load_pair<T>(px + c + V, v[V + 2], v[V + 3]);
    } else {
#pragma unroll
      for (int i = 0; i < HALF; ++i) {
        const int left = c - HALF + i, right = c + V + i;
        v[i] = left >= 0 ? load_f(px + left) : 0.f;
        v[HALF + V + i] = right < channels ? load_f(px + right) : 0.f;
      }
    }
    float sq[N];
    squares<T, N>(v, sq);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float win = sq[j];
#pragma unroll
      for (int i = 1; i <= 2 * HALF; ++i) win += sq[j + i];
      out[j] = v[HALF + j] * lrn_factor(win, alpha_over_size, k);
    }
  }
}

// the items q = first, first + kThreads, ... of a grid of n columns, as
// (q / n, q % n) without a division in the loop
struct ItemWalk {
  int row, col;
  const int drow, dcol, n;
  __device__ ItemWalk(int first, int n_)
      : row(first / n_), col(first % n_), drow(kThreads / n_),
        dcol(kThreads % n_), n(n_) {}
  __device__ __forceinline__ void next() {
    row += drow;
    col += dcol;
    if (col >= n) {
      col -= n;
      ++row;
    }
  }
};

// ---- lrn: persistent blocks over tiles of consecutive pixels ----

template <typename T, int V>
__host__ __device__ inline long long lrn_shared_bytes(int tile_pixels,
                                                      int channels) {
  return V > 1 ? kHeaderBytes + static_cast<long long>(kLrnSlots) *
                                    tile_pixels * channels * sizeof(T)
               : 0;
}

// A block's j-th tile is tile blockIdx.x + j gridDim.x.  The vector
// instance stages each tile into ring slot j % 3, two tiles ahead; the
// scalar instance reads device memory.
template <typename T, int V, int HALF>
__global__ void __launch_bounds__(kThreads, kLrnBlocksPerSm)
    lrn_kernel(const T* __restrict__ x, T* __restrict__ y, long long pixels,
               int channels, int tile_pixels, int half,
               float alpha_over_size, float k) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr bool kStaged = V > 1;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  T* ring = reinterpret_cast<T*>(smem + kHeaderBytes);
  const int tid = threadIdx.x;
  const int chunks = channels / V;
  const long long tile_elems = static_cast<long long>(tile_pixels) * channels;
  const long long tiles = (pixels + tile_pixels - 1) / tile_pixels;
  const long long first = blockIdx.x;
  const int count =
      first < tiles ? static_cast<int>((tiles - 1 - first) / gridDim.x + 1)
                    : 0;
  auto tile_of = [&](int j) {
    return first + static_cast<long long>(j) * gridDim.x;
  };
  auto pixels_of = [&](long long t) {
    return static_cast<int>(min(static_cast<long long>(tile_pixels),
                                pixels - t * tile_pixels));
  };
  auto issue = [&](int j) {   // tile j into slot j % 3
    const long long t = tile_of(j);
    const int s = j % kLrnSlots;
    fence_proxy_async();
    bulk_load(ring + s * tile_elems, x + t * tile_elems,
              static_cast<uint32_t>(pixels_of(t)) * channels * sizeof(T),
              bars + s);
  };
  if constexpr (kStaged) {
    if (tid == 0) {
      for (int s = 0; s < kLrnSlots; ++s) mbar_init(bars + s);
      fence_mbar_init();
    }
    __syncthreads();
    if (tid == 0)
      for (int j = 0; j < kLrnSlots - 1 && j < count; ++j) issue(j);
  }
  for (int j = 0; j < count; ++j) {
    const long long t = tile_of(j);
    const T* src = x + t * tile_elems;
    if constexpr (kStaged) {
      // slot (j - 1) % 3 was freed by the barrier that ended tile j - 1
      if (tid == 0 && j + kLrnSlots - 1 < count) issue(j + kLrnSlots - 1);
      mbar_wait(bars + j % kLrnSlots, (j / kLrnSlots) & 1);
      src = ring + (j % kLrnSlots) * tile_elems;
    }
    T* dst = y + t * tile_elems;
    const int npix = pixels_of(t);
    for (ItemWalk it(tid, chunks); it.row < npix; it.next()) {
      float out[V];
      lrn_vec<T, V, HALF>(src + it.row * channels, it.col * V, channels, half,
                          alpha_over_size, k, out);
      store_vec<T, V>(
          dst + static_cast<long long>(it.row) * channels + it.col * V, out);
    }
    if constexpr (kStaged) __syncthreads();   // slot j % 3 is free
  }
}

// ---- lrn_maxpool: one block per (image, stripe, column tile) ----

__host__ __device__ inline long long round16(long long bytes) {
  return (bytes + 15) / 16 * 16;
}

// must match ops/cuda/lrn_pool.py::lrn_maxpool_shared_bytes: the
// barriers, two LRN rows and, in the vector instance, two staged input
// rows of 2 col_tile + 1 columns, and one pooled row of col_tile columns
template <typename T, int V>
__host__ __device__ inline long long pool_row_bytes(int col_tile,
                                                    int channels) {
  return round16((2LL * col_tile + 1) * channels * sizeof(T));
}
template <typename T, int V>
__host__ __device__ inline long long lrn_maxpool_shared_bytes(int col_tile,
                                                              int channels) {
  return kHeaderBytes +
         (2 + (V > 1 ? kPoolSlots : 0)) *
             pool_row_bytes<T, V>(col_tile, channels) +
         round16(static_cast<long long>(col_tile) * channels * sizeof(T));
}

// block (b, stripe, tile) = blockIdx.x in that order, tile fastest.  It
// walks input rows 2 oh0 .. min(2 oh1, h - 1) of the columns 2 ow0 ..
// min(2 ow1, w - 1); pool row oh reads rows 2 oh .. min(2 oh + 2, h - 1)
// and pool column ow columns 2 ow .. min(2 ow + 2, w - 1): window edges
// past the image are left out, which is the ceil-mode pool's max against
// -inf.
template <typename T, int V, int HALF>
__global__ void __launch_bounds__(kThreads, kPoolBlocksPerSm)
    lrn_maxpool_kernel(const T* __restrict__ x, T* __restrict__ y, int h,
                       int w, int channels, int ho, int wo, int stripe_rows,
                       int stripes, int col_tile, int tiles, int half,
                       float alpha_over_size, float k) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr bool kStaged = V > 1;
  const int row_elems =
      static_cast<int>(pool_row_bytes<T, V>(col_tile, channels) / sizeof(T));
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  T* lrn_rows = reinterpret_cast<T*>(smem + kHeaderBytes);   // [2][row]
  T* ring = lrn_rows + 2 * row_elems;            // [2][row], vector instance
  T* pooled = ring + (kStaged ? kPoolSlots * row_elems : 0);

  const int tid = threadIdx.x;
  const int chunks = channels / V;
  const int tile = blockIdx.x % tiles;
  const int stripe = (blockIdx.x / tiles) % stripes;
  const long long b = blockIdx.x / (tiles * stripes);
  const int oh0 = stripe * stripe_rows, oh1 = min(oh0 + stripe_rows, ho);
  const int ow0 = tile * col_tile, nwo = min(col_tile, wo - ow0);
  const int col0 = 2 * ow0, ncols = min(2 * (ow0 + nwo) + 1, w) - col0;
  const int r_first = 2 * oh0, r_last = min(2 * oh1, h - 1);
  const int nrows = r_last - r_first + 1;
  const T* xb = x + b * h * w * channels;
  T* yb = y + b * ho * wo * channels;
  auto row_src = [&](int i) {
    return xb + (static_cast<long long>(r_first + i) * w + col0) * channels;
  };
  auto issue = [&](int i) {   // input row r_first + i into its slot
    const int s = i % kPoolSlots;
    fence_proxy_async();
    bulk_load(ring + s * row_elems, row_src(i),
              static_cast<uint32_t>(ncols) * channels * sizeof(T), bars + s);
  };
  if constexpr (kStaged) {
    if (tid == 0) {
      for (int s = 0; s < kPoolSlots; ++s) mbar_init(bars + s);
      fence_mbar_init();
    }
    __syncthreads();
    if (tid == 0)
      for (int i = 0; i < kPoolSlots - 1 && i < nrows; ++i) issue(i);
  }

  for (int i = 0; i < nrows; ++i) {
    const int r = r_first + i;
    const T* src = row_src(i);
    if constexpr (kStaged) {
      // row i - 1's barrier freed its slot, the one row i + slots - 1 takes
      if (tid == 0 && i + kPoolSlots - 1 < nrows) issue(i + kPoolSlots - 1);
      mbar_wait(bars + i % kPoolSlots, (i / kPoolSlots) & 1);
      src = ring + (i % kPoolSlots) * row_elems;
    }
    // 1. the row's LRN, each value once, into LRN row i % 2
    T* lrow = lrn_rows + (i & 1) * row_elems;
    for (ItemWalk it(tid, chunks); it.row < ncols; it.next()) {
      float out[V];
      lrn_vec<T, V, HALF>(src + it.row * channels, it.col * V, channels, half,
                          alpha_over_size, k, out);
      store_vec<T, V>(lrow + it.row * channels + it.col * V, out);
    }
    // the LRN row is complete and the staged row free.  No second
    // barrier: the next row writes the other LRN row, and row i + 2, which
    // writes this one, comes after the next row's barrier
    __syncthreads();
    // 2. horizontal max at each pool column, folded into the pool row's
    // running max; each thread owns the same pooled entries on every row
    for (ItemWalk it(tid, chunks); it.row < nwo; it.next()) {
      const int owl = it.row, c = it.col * V;
      const T* l = lrow + 2 * owl * channels + c;
      Raw<V> hp = load_raw<T, V>(l);
      if (2 * owl + 1 < ncols)
        hp = vmax<T, V>(hp, load_raw<T, V>(l + channels));
      if (2 * owl + 2 < ncols)
        hp = vmax<T, V>(hp, load_raw<T, V>(l + 2 * channels));
      T* m = pooled + owl * channels + c;
      const Raw<V> v = r > r_first ? vmax<T, V>(load_raw<T, V>(m), hp) : hp;
      T* out = yb + (static_cast<long long>(r / 2) * wo + ow0 + owl) *
                        channels + c;
      if ((r & 1) == 0) {
        // the last row of pool row r/2 - 1 and the first of pool row r/2
        if (r > r_first) store_raw<T, V>(out - wo * channels, v);
        if (r / 2 < oh1) store_raw<T, V>(m, hp);
      } else if (r == h - 1) {   // the image's last row ends pool row r/2
        store_raw<T, V>(out, v);
      } else {
        store_raw<T, V>(m, v);
      }
    }
  }
}

// ---- launchers: the host's plan, checked again ----

template <typename T, int V, int HALF>
int launch_lrn(const void* x, void* y, long long pixels, int channels,
               int half, float alpha_over_size, float k, int tile_pixels,
               int blocks, int shared_bytes, cudaStream_t stream) {
  const long long tiles =
      tile_pixels > 0 ? (pixels + tile_pixels - 1) / tile_pixels : 0;
  if (pixels < 1 || channels < 1 || channels % V || tile_pixels < 1 ||
      blocks < 1 || blocks > tiles ||
      shared_bytes != lrn_shared_bytes<T, V>(tile_pixels, channels) ||
      (V > 1 && reinterpret_cast<uintptr_t>(x) % 16))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      lrn_kernel<T, V, HALF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      shared_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  lrn_kernel<T, V, HALF><<<blocks, kThreads, shared_bytes, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), pixels, channels,
      tile_pixels, half, alpha_over_size, k);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int V, int HALF>
int launch_lrn_maxpool(const void* x, void* y, int batch, int h, int w,
                       int channels, int ho, int wo, int half,
                       float alpha_over_size, float k, int stripe_rows,
                       int stripes, int col_tile, int tiles,
                       int shared_bytes, cudaStream_t stream) {
  const long long blocks = static_cast<long long>(batch) * stripes * tiles;
  if (batch < 1 || h < 3 || w < 3 || channels < 1 || channels % V ||
      ho != h / 2 || wo != w / 2 || stripe_rows < 1 || stripes < 1 ||
      static_cast<long long>(stripes) * stripe_rows < ho ||
      (stripes - 1) * stripe_rows >= ho || col_tile < 1 || tiles < 1 ||
      static_cast<long long>(tiles) * col_tile < wo ||
      (tiles - 1) * col_tile >= wo || blocks > 0x7FFFFFFF ||
      shared_bytes != lrn_maxpool_shared_bytes<T, V>(col_tile, channels) ||
      (V > 1 && reinterpret_cast<uintptr_t>(x) % 16))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      lrn_maxpool_kernel<T, V, HALF>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, shared_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  lrn_maxpool_kernel<T, V, HALF>
      <<<static_cast<unsigned int>(blocks), kThreads, shared_bytes, stream>>>(
          static_cast<const T*>(x), static_cast<T*>(y), h, w, channels, ho,
          wo, stripe_rows, stripes, col_tile, tiles, half, alpha_over_size,
          k);
  return static_cast<int>(cudaGetLastError());
}

// the instance: 16-byte vectors or one channel, size 5 or any odd size
template <typename T, template <typename, int, int> class Launch,
          typename... Args>
int dispatch(bool vector, int half, Args... args) {
  constexpr int kVec = 16 / sizeof(T);
  if (vector)
    return half == 2 ? Launch<T, kVec, 2>::run(args...)
                     : Launch<T, kVec, kAnyHalf>::run(args...);
  return half == 2 ? Launch<T, 1, 2>::run(args...)
                   : Launch<T, 1, kAnyHalf>::run(args...);
}

template <typename T, int V, int HALF>
struct LrnLaunch {
  template <typename... Args>
  static int run(Args... args) {
    return launch_lrn<T, V, HALF>(args...);
  }
};
template <typename T, int V, int HALF>
struct LrnMaxpoolLaunch {
  template <typename... Args>
  static int run(Args... args) {
    return launch_lrn_maxpool<T, V, HALF>(args...);
  }
};

}  // namespace
}  // namespace torchfcn

using namespace torchfcn;

extern "C" int torchfcn_lrn(const void* x, void* y, long long pixels,
                            int channels, int size, float alpha_over_size,
                            float k, int dtype, int vector, int tile_pixels,
                            int blocks, int shared_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int half = size / 2;
  if (dtype == kBFloat16)
    return dispatch<__nv_bfloat16, LrnLaunch>(
        vector != 0, half, x, y, pixels, channels, half, alpha_over_size, k,
        tile_pixels, blocks, shared_bytes, s);
  if (dtype == kFloat32)
    return dispatch<float, LrnLaunch>(vector != 0, half, x, y, pixels,
                                      channels, half, alpha_over_size, k,
                                      tile_pixels, blocks, shared_bytes, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int torchfcn_lrn_maxpool(const void* x, void* y, int batch, int h,
                                    int w, int channels, int ho, int wo,
                                    int size, float alpha_over_size, float k,
                                    int dtype, int vector, int stripe_rows,
                                    int stripes, int col_tile, int tiles,
                                    int shared_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int half = size / 2;
  if (dtype == kBFloat16)
    return dispatch<__nv_bfloat16, LrnMaxpoolLaunch>(
        vector != 0, half, x, y, batch, h, w, channels, ho, wo, half,
        alpha_over_size, k, stripe_rows, stripes, col_tile, tiles,
        shared_bytes, s);
  if (dtype == kFloat32)
    return dispatch<float, LrnMaxpoolLaunch>(
        vector != 0, half, x, y, batch, h, w, channels, ho, wo, half,
        alpha_over_size, k, stripe_rows, stripes, col_tile, tiles,
        shared_bytes, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
