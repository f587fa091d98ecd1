// Batched OpenCV groupRectangles NMS, one thread block per (image, class)
// instance of N <= 4096 candidates; each of the block's min(1024, N)
// threads owns every min(1024, N)-th candidate.
//
// Replaces tpufcn/ops/pallas/group_rects.py::group_rectangles_pallas
// (GoogLeNet serving path: 8 frames x 4 classes = 32 instances of
// N = K = 256 candidates; fcn8s_bbox at its default capacity: 8 frames x 10
// classes of N = 36 x 36 = 1296 grid cells).  Semantics are those of
// tpufcn.ops.group_rects and of the plain version
// torchfcn.ops.group_rects.group_rectangles:
//   1. rint the rects, read as (x, y, w, h) (the reference passes corner
//      boxes; the field reading is its quirk);
//   2. components of the SimilarRects graph, labelled by smallest index;
//   3. integer cluster sums and counts; means rounded half to even exactly;
//   4. keep clusters with count > group_threshold;
//   5. suppress a kept cluster inside a bigger kept one with
//      n2 > max(3, n1) || n1 < 3.
//
// What bounds it on the H100: latency, not bytes or flops.  An instance is
// 5 KB in and 6 KB out, and the work is one pass of N (N - 1) / 2 predicate
// tests (32 x 256 candidates: about 1 M tests of 12 float32 operations,
// 0.2 us at 67 TFLOP/s), so the time is the few dependent block-wide steps
// and the launch.  The TPU kernel built the N x N adjacency and closed it by
// repeated 0/1 squaring on the MXU; on the GPU that would be N^2 storage and
// log2(N) matmuls per instance.  Here the components come from a one-pass
// union-find in shared memory: the pairs j < i are spread evenly over the
// threads (rows k and N - 1 - k make a row pair of N - 1 pairs, split by j
// modulo g into g work items; at N <= 1024 g = 2 and threads 2k and
// 2k + 1 take row pair k, the even and the odd j), and
// each similar pair unites its two roots, hooking the larger root under
// the smaller with atomicCAS (retried when another thread hooked it first),
// with path halving in find.  Every parent pointer points to a smaller
// index of the same component, so after one barrier each component has a
// single root, its smallest index: the label of the plain version, whatever
// order the atomics took.  One predicate pass, whatever the components'
// diameter (decoded grid cells form long chains of similar boxes); no
// N x N matrix is stored.
// Cluster sums and counts are integer atomics in shared memory (64-bit sums,
// so any int-valued input is exact), one per warp and cluster: the lanes
// with one root (__match_any_sync) add as one.  The mean is an exact integer
// division rounded half to even.  Suppression compares each kept cluster
// with the kept ones only, from a list, not with all N slots.
// delta = (eps * 0.5) * (min w + min h) and dx = rint(w * eps) are computed
// in float32, as the JAX paths do, so borderline comparisons break the same
// way.  An instance holds 56 bytes per candidate in shared memory (an
// invalid candidate is a parent of -1, not a flag), which caps N at 4096.
#include "common.cuh"

namespace torchfcn {
namespace {

// s / c rounded half to even, exactly (c > 0)
__device__ __forceinline__ long long div_round_half_even(long long s,
                                                          int c) {
  long long q = s / c;
  long long r = s - q * c;  // C division truncates toward zero
  if (r < 0) {              // floor, so that 0 <= r < c
    q -= 1;
    r += c;
  }
  const long long twice = 2 * r;
  if (twice > c || (twice == c && (q & 1))) q += 1;
  return q;
}

// root of x, halving the path on the way: each visited node is pointed to
// its grandparent.  Pointers only ever move to a smaller index of the same
// component, so a stale read still leads to the root.
__device__ __forceinline__ int find(volatile int* parent, int x) {
  for (;;) {
    const int p = parent[x];
    if (p == x) return x;
    const int gp = parent[p];
    if (gp != p) parent[x] = gp;
    x = gp;
  }
}

// join the components of a and b: the larger root is hooked under the
// smaller, so a component's root stays its smallest index
__device__ __forceinline__ void unite(volatile int* parent, int a, int b) {
  for (;;) {
    a = find(parent, a);
    b = find(parent, b);
    if (a == b) return;
    const int lo = min(a, b), hi = max(a, b);
    // hi may have been hooked by another thread since it was found a root
    if (atomicCAS(const_cast<int*>(parent + hi), hi, lo) == hi) return;
  }
}

// SimilarRects on (x, y, w, h) boxes, in float32 as the JAX paths compute it
__device__ __forceinline__ bool similar(float4 a, float4 b, float half_eps) {
  const float delta = half_eps * (fminf(a.z, b.z) + fminf(a.w, b.w));
  return fabsf(a.x - b.x) <= delta && fabsf(a.y - b.y) <= delta &&
         fabsf((a.x + a.z) - (b.x + b.z)) <= delta &&
         fabsf((a.y + a.w) - (b.y + b.w)) <= delta;
}

__global__ void group_rects_kernel(const float* __restrict__ rects,
                                   const uint8_t* __restrict__ valid,
                                   float* __restrict__ out_rects,
                                   int* __restrict__ out_weights,
                                   uint8_t* __restrict__ out_valid, int n,
                                   int group, int group_threshold,
                                   float eps) {
  // shared memory: sums[4][n] (64-bit first, for alignment), box[n]
  // (x, y, w, h; later the cluster means), label[n] (union-find parents,
  // -1 for an invalid candidate; later the kept clusters), count[n]
  extern __shared__ __align__(16) long long smem[];
  long long* sums = smem;
  float4* box = reinterpret_cast<float4*>(sums + 4 * n);
  int* label = reinterpret_cast<int*>(box + n);
  int* count = label + n;
  __shared__ int kept;

  // thread t owns candidates t, t + threads, t + 2 threads, ...
  const int t = threadIdx.x;
  const int threads = blockDim.x;
  const int lane = t & 31;
  const size_t base = static_cast<size_t>(blockIdx.x) * n;

  for (int c = t; c < n; c += threads) {
    const float4 r = reinterpret_cast<const float4*>(rects)[base + c];
    box[c] = make_float4(rintf(r.x), rintf(r.y), rintf(r.z), rintf(r.w));
    label[c] = valid[base + c] ? c : -1;
    count[c] = 0;
    for (int q = 0; q < 4; ++q) sums[q * n + c] = 0;
  }
  if (t == 0) kept = 0;
  __syncthreads();

  // one pass of union-find over the SimilarRects graph.  Work item
  // (k, u) tests the pairs (row, j < row) of rows k and n - 1 - k (n - 1
  // pairs together) whose j is u modulo ``group``, four at a time so that
  // their loads overlap; the launcher picks ``group`` so that the busiest
  // thread has the fewest tests.  Lanes with one u read one box at a time.
  const float half_eps = eps * 0.5f;
  volatile int* parent = label;
  const int items = (n + 1) / 2 * group;
  for (int w = t; w < items; w += threads) {
    const int k = w / group;
    const int u = w - k * group;
    for (int pass = 0; pass < 2; ++pass) {
      const int row = pass == 0 ? k : n - 1 - k;
      if ((pass == 1 && row == k) || parent[row] < 0) continue;
      const float4 br = box[row];
      for (int j0 = u; j0 < row; j0 += 4 * group) {
        bool hit[4];
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int j = min(j0 + v * group, row - 1);
          hit[v] = j0 + v * group < row && parent[j] >= 0 &&
                   similar(br, box[j], half_eps);
        }
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          // most similar pairs of a dense cluster already share a parent
          const int j = j0 + v * group;
          if (hit[v] && parent[row] != parent[j]) unite(parent, row, j);
        }
      }
    }
  }
  __syncthreads();  // every union is done: one root per component

  // cluster sums and counts at the root's slot: the lanes of a warp with
  // one root add as one, their lowest lane summing their boxes in exact
  // 64-bit integers.  Every lane runs every step, for __match_any_sync.
  const int steps = (n + threads - 1) / threads;
  for (int s = 0; s < steps; ++s) {
    const int c = t + s * threads;
    const int lab = (c < n && parent[c] >= 0) ? find(parent, c) : -1;
    const unsigned same = __match_any_sync(0xFFFFFFFFu, lab);
    if (lab >= 0 && __ffs(same) - 1 == lane) {
      long long acc[4] = {0, 0, 0, 0};
      for (unsigned g = same; g; g &= g - 1) {
        const float4 b = box[c - lane + __ffs(g) - 1];
        acc[0] += static_cast<long long>(b.x);
        acc[1] += static_cast<long long>(b.y);
        acc[2] += static_cast<long long>(b.z);
        acc[3] += static_cast<long long>(b.w);
      }
      atomicAdd(&count[lab], __popc(same));
      for (int q = 0; q < 4; ++q) {
        atomicAdd(reinterpret_cast<unsigned long long*>(&sums[q * n + lab]),
                  static_cast<unsigned long long>(acc[q]));
      }
    }
  }
  __syncthreads();

  // means (0 for slots that are no cluster's root) replace the boxes; the
  // kept clusters' list replaces the parents, which no thread reads any more
  for (int c = t; c < n; c += threads) {
    const int cnt = count[c];
    float mean[4] = {0.f, 0.f, 0.f, 0.f};
    if (cnt > 0) {
      for (int q = 0; q < 4; ++q)
        mean[q] = static_cast<float>(div_round_half_even(sums[q * n + c], cnt));
    }
    box[c] = make_float4(mean[0], mean[1], mean[2], mean[3]);
    if (cnt > group_threshold) label[atomicAdd(&kept, 1)] = c;
  }
  __syncthreads();

  // containment suppression among the kept clusters, in any order: a
  // cluster goes if any other kept cluster suppresses it
  for (int c = t; c < n; c += threads) {
    const int cnt = count[c];
    const float4 m = box[c];
    const bool survive = cnt > group_threshold;
    bool suppressed = false;
    if (survive) {
      for (int q = 0; q < kept && !suppressed; ++q) {
        const int j = label[q];
        if (j == c) continue;
        const int nj = count[j];
        const float4 bj = box[j];
        const float dx = rintf(bj.z * eps), dy = rintf(bj.w * eps);
        const bool inside = m.x >= bj.x - dx && m.y >= bj.y - dy &&
                            m.x + m.z <= bj.x + bj.z + dx &&
                            m.y + m.w <= bj.y + bj.w + dy;
        suppressed = inside && (nj > max(3, cnt) || cnt < 3);
      }
    }
    const bool keep = survive && !suppressed;
    reinterpret_cast<float4*>(out_rects)[base + c] =
        keep ? m : make_float4(0.f, 0.f, 0.f, 0.f);
    out_weights[base + c] = keep ? cnt : 0;
    out_valid[base + c] = keep;
  }
}

}  // namespace
}  // namespace torchfcn

using namespace torchfcn;

// bytes of shared memory per candidate: sums, box, label, count
constexpr size_t kSmemPerCandidate = 4 * 8 + 4 * 4 + 4 + 4;
// 4096 x 56 bytes = 224 KB, within the 227 KB a block may have on Hopper
constexpr int kMaxCandidates = 4096;
constexpr int kMaxThreads = 1024;

// threads per row pair (the union pass's work items are row pairs times
// this), from 2 to 64: the count whose busiest thread runs the fewest pair
// tests, the smallest such.  2 for n <= 1024, one item per thread.
static int row_pair_group(int n, int threads) {
  const long long pairs = (n + 1) / 2;
  int best = 2;
  double best_tests = 1e300;
  for (int g = 2; g <= 64; ++g) {
    const long long per_thread = (pairs * g + threads - 1) / threads;
    const double tests = static_cast<double>(per_thread) * n / g;
    if (tests < best_tests) {
      best = g;
      best_tests = tests;
    }
  }
  return best;
}

extern "C" int torchfcn_group_rects(const void* rects, const void* valid,
                                    void* out_rects, void* out_weights,
                                    void* out_valid, int m, int n,
                                    int group_threshold, float eps,
                                    void* stream) {
  if (m <= 0 || n <= 0 || n > kMaxCandidates) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = n < kMaxThreads ? (n + 31) / 32 * 32 : kMaxThreads;
  const size_t smem = kSmemPerCandidate * n;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        group_rects_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  group_rects_kernel<<<m, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rects), static_cast<const uint8_t*>(valid),
      static_cast<float*>(out_rects), static_cast<int*>(out_weights),
      static_cast<uint8_t*>(out_valid), n, row_pair_group(n, threads),
      group_threshold, eps);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* torchfcn_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
