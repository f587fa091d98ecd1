// See fcn_point_map.hpp.  Reference behaviours are cited inline.

#include "fcn_point_map.hpp"

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <numeric>
#include <queue>
#include <unordered_map>

namespace torchfcn {

int otsu_threshold(const uint8_t* img, int n) {
  // Classic Otsu over a 256-bin histogram (cv::threshold THRESH_OTSU).
  double hist[256] = {0};
  for (int i = 0; i < n; ++i) hist[img[i]] += 1.0;
  double total = static_cast<double>(n);
  double sum = 0;
  for (int i = 0; i < 256; ++i) sum += i * hist[i];
  double sum_b = 0, w_b = 0;
  double max_var = -1.0;
  int thresh = 0;
  for (int t = 0; t < 256; ++t) {
    w_b += hist[t];
    if (w_b == 0) continue;
    double w_f = total - w_b;
    if (w_f == 0) break;
    sum_b += t * hist[t];
    double m_b = sum_b / w_b;
    double m_f = (sum - sum_b) / w_f;
    double var = w_b * w_f * (m_b - m_f) * (m_b - m_f);
    if (var > max_var) {
      max_var = var;
      thresh = t;
    }
  }
  return thresh;
}

std::vector<Rect> region_rects(const uint8_t* img, int h, int w,
                               int thresh, int area_thresh) {
  // BFS connected components (8-connectivity) over img > thresh; the
  // area gate mirrors the reference's contourArea > rect_thresh_ (=400,
  // reference fcn_point_map_node.cpp:5,141-152).
  std::vector<int> label(static_cast<size_t>(h) * w, -1);
  std::vector<Rect> rects;
  std::vector<int> stack;
  for (int y = 0; y < h; ++y) {
    for (int x = 0; x < w; ++x) {
      int idx = y * w + x;
      if (label[idx] != -1 || img[idx] <= thresh) continue;
      int cur = static_cast<int>(rects.size());
      label[idx] = cur;
      stack.clear();
      stack.push_back(idx);
      int minx = x, maxx = x, miny = y, maxy = y;
      int area = 0;
      while (!stack.empty()) {
        int p = stack.back();
        stack.pop_back();
        ++area;
        int py = p / w, px = p % w;
        minx = std::min(minx, px); maxx = std::max(maxx, px);
        miny = std::min(miny, py); maxy = std::max(maxy, py);
        for (int dy = -1; dy <= 1; ++dy) {
          for (int dx = -1; dx <= 1; ++dx) {
            if (!dy && !dx) continue;
            int ny = py + dy, nx = px + dx;
            if (ny < 0 || ny >= h || nx < 0 || nx >= w) continue;
            int q = ny * w + nx;
            if (label[q] == -1 && img[q] > thresh) {
              label[q] = cur;
              stack.push_back(q);
            }
          }
        }
      }
      if (area > area_thresh) {
        rects.push_back({minx, miny, maxx - minx + 1, maxy - miny + 1});
      } else {
        rects.push_back({0, 0, 0, 0});  // placeholder, filtered below
      }
    }
  }
  std::vector<Rect> out;
  for (const Rect& r : rects)
    if (r.w > 0 && r.h > 0) out.push_back(r);
  return out;
}

std::vector<Rect> region_mask(const uint8_t* img, int h, int w,
                              int area_thresh) {
  int t = otsu_threshold(img, h * w);
  return region_rects(img, h, w, t, area_thresh);
}

double rect_iou(const Rect& a, const Rect& b) {
  // Reference jaccardScore (fcn_point_map_node.cpp:128-133): plain
  // intersection over union of rects.
  int x1 = std::max(a.x, b.x), y1 = std::max(a.y, b.y);
  int x2 = std::min(a.x + a.w, b.x + b.w);
  int y2 = std::min(a.y + a.h, b.y + b.h);
  double inter = std::max(0, x2 - x1) * static_cast<double>(std::max(0, y2 - y1));
  double uni = static_cast<double>(a.w) * a.h + static_cast<double>(b.w) * b.h - inter;
  return uni > 0 ? inter / uni : 0.0;
}

namespace {

// Uniform voxel-grid fixed-radius neighbor structure (the PCL KdTree
// role in EuclideanClusterExtraction, reference
// fcn_point_map_node.cpp:112-125).  Cell edge = the cluster tolerance,
// so every neighbor within `tol` of a query lies in the 27-cell
// neighborhood.  `extract` REMOVES returned points: during the
// cluster-growing BFS a point is claimed exactly once, so each point
// is distance-checked only until consumed — near-linear total work,
// where a per-point kd-tree radius query was ~100x slower on dense
// organized-cloud blobs (measured 143 ms -> ~2 ms for 19k points).
// Cluster semantics are identical (same connected components of the
// tol-radius graph; removal == the old seen-marking).
struct VoxelGrid {
  const float* pts;            // (n, 3)
  float cell;
  std::unordered_map<uint64_t, std::vector<int>> cells;

  static uint64_t key(int ix, int iy, int iz) {
    return (static_cast<uint64_t>(static_cast<uint32_t>(ix + (1 << 20)))
            << 42) |
           (static_cast<uint64_t>(static_cast<uint32_t>(iy + (1 << 20)))
            << 21) |
           static_cast<uint64_t>(static_cast<uint32_t>(iz + (1 << 20)));
  }
  void cell_of(const float* p, int& ix, int& iy, int& iz) const {
    ix = static_cast<int>(std::floor(p[0] / cell));
    iy = static_cast<int>(std::floor(p[1] / cell));
    iz = static_cast<int>(std::floor(p[2] / cell));
  }

  VoxelGrid(const float* xyz, const std::vector<int>& ids, float c)
      : pts(xyz), cell(c) {
    cells.reserve(ids.size());
    for (int i : ids) {
      int ix, iy, iz;
      cell_of(xyz + i * 3, ix, iy, iz);
      cells[key(ix, iy, iz)].push_back(i);
    }
  }

  // Append every not-yet-claimed point within tol of q to `out`,
  // removing it from the grid.
  void extract(const float* q, float tol2, std::vector<int>& out) {
    int ix, iy, iz;
    cell_of(q, ix, iy, iz);
    for (int dx = -1; dx <= 1; ++dx)
      for (int dy = -1; dy <= 1; ++dy)
        for (int dz = -1; dz <= 1; ++dz) {
          auto it = cells.find(key(ix + dx, iy + dy, iz + dz));
          if (it == cells.end()) continue;
          auto& v = it->second;
          for (size_t k = 0; k < v.size();) {
            const float* p = pts + v[k] * 3;
            float a = p[0] - q[0], b = p[1] - q[1], d = p[2] - q[2];
            if (a * a + b * b + d * d <= tol2) {
              out.push_back(v[k]);
              v[k] = v.back();
              v.pop_back();
            } else {
              ++k;
            }
          }
          if (v.empty()) cells.erase(it);
        }
  }
};

}  // namespace

int euclidean_cluster(const float* xyz, int n, float tol,
                      int min_size, int max_size, int* labels_out) {
  std::vector<int> valid;
  valid.reserve(n);
  for (int i = 0; i < n; ++i) {
    const float* p = xyz + i * 3;
    labels_out[i] = -1;
    if (std::isfinite(p[0]) && std::isfinite(p[1]) && std::isfinite(p[2]))
      valid.push_back(i);
  }
  if (valid.empty()) return 0;
  VoxelGrid grid(xyz, valid, tol);
  const float tol2 = tol * tol;

  std::vector<char> claimed(n, 0);
  std::vector<int> cluster, frontier;
  int next_label = 0;
  for (int seed : valid) {
    if (claimed[seed]) continue;
    cluster.clear();
    frontier.clear();
    grid.extract(xyz + seed * 3, tol2, frontier);   // includes the seed
    for (int p : frontier) claimed[p] = 1;
    size_t head = 0;
    while (head < frontier.size()) {
      int p = frontier[head++];
      cluster.push_back(p);
      size_t before = frontier.size();
      grid.extract(xyz + p * 3, tol2, frontier);
      for (size_t k = before; k < frontier.size(); ++k)
        claimed[frontier[k]] = 1;
    }
    if (static_cast<int>(cluster.size()) >= min_size &&
        static_cast<int>(cluster.size()) <= max_size) {
      for (int p : cluster) labels_out[p] = next_label;
      ++next_label;
    }
  }
  return next_label;
}

}  // namespace torchfcn

extern "C" {

int fcn_otsu(const uint8_t* img, int n) {
  return torchfcn::otsu_threshold(img, n);
}

int fcn_region_rects(const uint8_t* img, int h, int w, int thresh,
                     int area_thresh, int max_rects, int* rects_out) {
  auto rects = thresh < 0 ? torchfcn::region_mask(img, h, w, area_thresh)
                          : torchfcn::region_rects(img, h, w, thresh,
                                                 area_thresh);
  int n = std::min<int>(static_cast<int>(rects.size()), max_rects);
  for (int i = 0; i < n; ++i) {
    rects_out[i * 4 + 0] = rects[i].x;
    rects_out[i * 4 + 1] = rects[i].y;
    rects_out[i * 4 + 2] = rects[i].w;
    rects_out[i * 4 + 3] = rects[i].h;
  }
  return n;
}

int fcn_euclidean_cluster(const float* xyz, int n, float tol,
                          int min_size, int max_size, int* labels_out) {
  return torchfcn::euclidean_cluster(xyz, n, tol, min_size, max_size,
                                   labels_out);
}

int fcn_point_map_process(const float* cloud, const uint8_t* mask,
                          const uint8_t* pmap, int h, int w,
                          float cluster_tol, int min_cluster,
                          int max_cluster, int area_thresh,
                          int keep_matched, int* labels_out) {
  using torchfcn::Rect;
  const int n = h * w;
  // regionMask on both images (reference callback :50-54)
  auto prects = torchfcn::region_mask(pmap, h, w, area_thresh);
  auto orects = torchfcn::region_mask(mask, h, w, area_thresh);

  // Fused-mask polarity (see PARITY.md "Known deviations"):
  //   keep_matched=1 (default) — gather points from obj-mask regions that
  //     DO intersect a probability-map region (the detector-confirmed
  //     objects).
  //   keep_matched=0 — reference polarity: the reference copies matched
  //     regions into im_mask then cv::bitwise_xor(im_mask, obj_mask)
  //     (reference :57-71), cancelling matched regions so points come
  //     from the UNMATCHED remainder of the object mask.  (The reference
  //     scans each rect from the image origin — a bug — here regions are
  //     rect-local.)
  // Both start from the Otsu-thresholded object mask.  Matched regions
  // are COPIED into a scratch mask (assignment is idempotent where
  // rects overlap — a per-rect XOR would flip overlap pixels twice;
  // the reference likewise copies regions then applies ONE global
  // cv::bitwise_xor), then combined per the polarity.
  int o_thresh = torchfcn::otsu_threshold(mask, n);
  std::vector<uint8_t> matched(n, 0);
  for (const Rect& orc : orects) {
    bool hit = false;
    for (const Rect& prc : prects) {
      if (torchfcn::rect_iou(orc, prc) > 0.0) { hit = true; break; }
    }
    if (!hit) continue;
    for (int y = orc.y; y < orc.y + orc.h; ++y) {
      for (int x = orc.x; x < orc.x + orc.w; ++x) {
        int idx = y * w + x;
        matched[idx] = mask[idx] > o_thresh ? 255 : 0;
      }
    }
  }
  std::vector<uint8_t> fused(n, 0);
  if (keep_matched) {
    fused = matched;
  } else {
    for (int i = 0; i < n; ++i) {
      uint8_t obj = mask[i] > o_thresh ? 255 : 0;
      fused[i] = obj ^ matched[i];  // the reference's single bitwise_xor
    }
  }

  // gather organized-cloud points under the fused mask (reference
  // :77-92: index = x + y*cols) and cluster them
  std::vector<float> pts;
  std::vector<int> src_index;
  pts.reserve(n / 8 * 3);
  for (int i = 0; i < n; ++i) {
    labels_out[i] = -1;
    if (!fused[i]) continue;
    const float* p = cloud + i * 3;
    if (std::isfinite(p[0]) && std::isfinite(p[1]) && std::isfinite(p[2])) {
      pts.insert(pts.end(), {p[0], p[1], p[2]});
      src_index.push_back(i);
    }
  }
  if (pts.empty()) return 0;
  std::vector<int> labels(src_index.size(), -1);
  int k = torchfcn::euclidean_cluster(pts.data(),
                                    static_cast<int>(src_index.size()),
                                    cluster_tol, min_cluster, max_cluster,
                                    labels.data());
  for (size_t i = 0; i < src_index.size(); ++i)
    labels_out[src_index[i]] = labels[i];
  return k;
}

}  // extern "C"
