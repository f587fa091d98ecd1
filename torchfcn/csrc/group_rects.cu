// Batched OpenCV groupRectangles NMS, one thread block per (image, class)
// instance and one thread per candidate.
//
// Replaces tpufcn/ops/pallas/group_rects.py::group_rectangles_pallas
// (serving path: 8 frames x 4 classes = 32 instances of N = K = 256
// candidates).  Semantics are those of tpufcn.ops.group_rects and of the
// plain version torchfcn.ops.group_rects.group_rectangles:
//   1. rint the rects, read as (x, y, w, h) (the reference passes corner
//      boxes; the field reading is its quirk);
//   2. components of the SimilarRects graph, labelled by smallest index;
//   3. integer cluster sums and counts; means rounded half to even exactly;
//   4. keep clusters with count > group_threshold;
//   5. suppress a kept cluster inside a bigger kept one with
//      n2 > max(3, n1) || n1 < 3.
//
// What bounds it on the H100: latency, not bytes or flops.  An instance is
// 5 KB in and 6 KB out, and the work is a few N^2 predicate sweeps, so the
// time is the chain of dependent block-wide steps.  The TPU kernel built
// the N x N adjacency and closed it by repeated 0/1 squaring on the MXU; on
// the GPU that would be N^2 storage and log2(N) matmuls per instance.  Here
// the components come from min-label propagation instead: each thread takes
// the smallest label among its similar neighbours and its label's own label
// (pointer jumping), evaluating the predicate on the fly against the
// candidates held in shared memory, until __syncthreads_or reports no
// change.  Labels only fall and always name a member of the component, so
// the fixed point is each component's smallest index.  Without the jumps a
// label moves one edge per sweep, and neighbouring decoded grid cells form
// long chains of similar boxes; with them a chain of length L takes about
// log2(L) sweeps.  No N x N matrix is stored.
// Cluster sums and counts are integer atomics in shared memory (64-bit sums,
// so any int-valued input is exact), and the mean is an exact integer
// division rounded half to even.  delta = (eps * 0.5) * (min w + min h) and
// dx = rint(w * eps) are computed in float32, as the JAX paths do, so
// borderline comparisons break the same way.
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

__global__ void group_rects_kernel(const float* __restrict__ rects,
                                   const uint8_t* __restrict__ valid,
                                   float* __restrict__ out_rects,
                                   int* __restrict__ out_weights,
                                   uint8_t* __restrict__ out_valid, int n,
                                   int group_threshold, float eps) {
  // shared memory: sums[4][n] (64-bit first, for alignment), box[4][n]
  // (x, y, w, h; later the cluster means), label[n], count[n], ok[n]
  extern __shared__ long long smem[];
  long long* sums = smem;
  float* box = reinterpret_cast<float*>(sums + 4 * n);
  int* label = reinterpret_cast<int*>(box + 4 * n);
  int* count = label + n;
  uint8_t* ok = reinterpret_cast<uint8_t*>(count + n);

  const int i = threadIdx.x;
  const bool active = i < n;
  const size_t base = static_cast<size_t>(blockIdx.x) * n;

  float xi = 0.f, yi = 0.f, wi = 0.f, hi = 0.f;
  bool vi = false;
  if (active) {
    const float* r = rects + (base + i) * 4;
    xi = rintf(r[0]);
    yi = rintf(r[1]);
    wi = rintf(r[2]);
    hi = rintf(r[3]);
    vi = valid[base + i] != 0;
    box[i] = xi;
    box[n + i] = yi;
    box[2 * n + i] = wi;
    box[3 * n + i] = hi;
    ok[i] = vi;
    label[i] = i;
    count[i] = 0;
    for (int c = 0; c < 4; ++c) sums[c * n + i] = 0;
  }
  __syncthreads();

  // min-label propagation over the SimilarRects graph, with pointer
  // jumping: a thread also takes its label's own label, which lies in the
  // same component, so labels travel twice as far each sweep
  const float half_eps = eps * 0.5f;
  int lab = i;
  for (;;) {
    int best = lab;
    if (active && vi) {
      best = min(best, label[lab]);
      for (int j = 0; j < n; ++j) {
        const int lj = label[j];
        if (lj >= best || !ok[j]) continue;
        const float xj = box[j], yj = box[n + j];
        const float wj = box[2 * n + j], hj = box[3 * n + j];
        const float delta = half_eps * (fminf(wi, wj) + fminf(hi, hj));
        if (fabsf(xi - xj) <= delta && fabsf(yi - yj) <= delta &&
            fabsf((xi + wi) - (xj + wj)) <= delta &&
            fabsf((yi + hi) - (yj + hj)) <= delta) {
          best = lj;
        }
      }
    }
    __syncthreads();  // every read of label[] in this sweep is done
    const bool changed = best < lab;
    if (changed) {
      lab = best;
      label[i] = best;
    }
    if (!__syncthreads_or(changed)) break;
  }

  // cluster sums and counts at the root slot
  if (active && vi) {
    atomicAdd(&count[lab], 1);
    const float v[4] = {xi, yi, wi, hi};
    for (int c = 0; c < 4; ++c) {
      atomicAdd(reinterpret_cast<unsigned long long*>(&sums[c * n + lab]),
                static_cast<unsigned long long>(static_cast<long long>(v[c])));
    }
  }
  __syncthreads();

  // means (0 for slots that are no cluster's root)
  const int cnt = active ? count[i] : 0;
  float mean[4] = {0.f, 0.f, 0.f, 0.f};
  if (cnt > 0) {
    for (int c = 0; c < 4; ++c) {
      mean[c] = static_cast<float>(div_round_half_even(sums[c * n + i], cnt));
    }
  }
  if (active) {
    for (int c = 0; c < 4; ++c) box[c * n + i] = mean[c];
  }
  __syncthreads();

  if (!active) return;
  // containment suppression among the kept clusters
  const bool survive = cnt > group_threshold;
  bool suppressed = false;
  if (survive) {
    for (int j = 0; j < n && !suppressed; ++j) {
      const int nj = count[j];
      if (j == i || nj <= group_threshold) continue;
      const float xj = box[j], yj = box[n + j];
      const float wj = box[2 * n + j], hj = box[3 * n + j];
      const float dx = rintf(wj * eps), dy = rintf(hj * eps);
      const bool inside = mean[0] >= xj - dx && mean[1] >= yj - dy &&
                          mean[0] + mean[2] <= xj + wj + dx &&
                          mean[1] + mean[3] <= yj + hj + dy;
      suppressed = inside && (nj > max(3, cnt) || cnt < 3);
    }
  }
  const bool keep = survive && !suppressed;
  for (int c = 0; c < 4; ++c) out_rects[(base + i) * 4 + c] = keep ? mean[c] : 0.f;
  out_weights[base + i] = keep ? cnt : 0;
  out_valid[base + i] = keep;
}

}  // namespace
}  // namespace torchfcn

using namespace torchfcn;

// bytes of shared memory per candidate: sums, box, label, count, ok
constexpr size_t kSmemPerCandidate = 4 * 8 + 4 * 4 + 4 + 4 + 1;
constexpr int kMaxCandidates = 1024;

extern "C" int torchfcn_group_rects(const void* rects, const void* valid,
                                    void* out_rects, void* out_weights,
                                    void* out_valid, int m, int n,
                                    int group_threshold, float eps,
                                    void* stream) {
  if (m <= 0 || n <= 0 || n > kMaxCandidates) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = (n + 31) / 32 * 32;
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
      static_cast<uint8_t*>(out_valid), n, group_threshold, eps);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* torchfcn_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
