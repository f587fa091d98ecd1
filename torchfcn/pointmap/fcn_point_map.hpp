// RGB-D point-map fusion node: the host C++ component of the stream graph
// (a copy of tpufcn/pointmap/fcn_point_map.hpp for the port).
//
// Re-implementation of the reference C++ ROS node
// (reference src/fcn_point_map_node.cpp:1-196,
//  include/fcn_object_detector/fcn_point_map.hpp:1-85) without ROS/PCL:
//  * Otsu threshold + connected-region bounding rects with an area gate
//    (reference regionMask, rect_thresh_=400);
//  * IoU gating of probability-map rects vs object-mask rects, masked
//    region copy + XOR (reference callback :57-71);
//  * gathering of organized-cloud points under the fused mask (:77-92);
//  * Euclidean cluster extraction over a 3-D kd-tree
//    (tolerance 0.02 m, 100..25000 points — reference cluster() :112-125);
//  * a 4-way approximate-time synchronizer (reference uses
//    message_filters::ApproximateTime, queue 100).
//
// Exposed as a C ABI for the Python topic-bus wrapper (ctypes).

#pragma once

#include <cstdint>
#include <vector>

namespace torchfcn {

struct Rect {
  int x, y, w, h;
};

// Otsu threshold over a grayscale image (returns the threshold).
int otsu_threshold(const uint8_t* img, int n);

// Connected regions (8-connectivity) of img > thresh with pixel-area
// greater than area_thresh; returns bounding rects.
std::vector<Rect> region_rects(const uint8_t* img, int h, int w,
                               int thresh, int area_thresh);

// Reference regionMask: Otsu + contours + area gate.
std::vector<Rect> region_mask(const uint8_t* img, int h, int w,
                              int area_thresh);

double rect_iou(const Rect& a, const Rect& b);

// Euclidean clustering of 3-D points within `tol`; clusters outside
// [min_size, max_size] are dropped.  Returns per-point cluster id
// (-1 = unclustered / dropped).
int euclidean_cluster(const float* xyz, int n, float tol,
                      int min_size, int max_size, int* labels_out);

}  // namespace torchfcn

extern "C" {

// Full fused pipeline, mirroring FCNPointMap::callback:
//   cloud:  organized (h*w*3) float xyz, NaN = invalid
//   mask:   (h*w) object mask image
//   pmap:   (h*w) probability-map image
//   keep_matched: fused-mask polarity — 1 gathers points from obj-mask
//     regions matched by a pmap region (the default); 0 reproduces the
//     reference's XOR complement (points from the UNMATCHED remainder;
//     reference src/fcn_point_map_node.cpp:57-92).  See PARITY.md.
//   labels_out: (h*w) int32 cluster id per pixel (-1 = none)
// Returns the number of clusters (or -1 on error).
int fcn_point_map_process(const float* cloud, const uint8_t* mask,
                          const uint8_t* pmap, int h, int w,
                          float cluster_tol, int min_cluster,
                          int max_cluster, int area_thresh,
                          int keep_matched, int* labels_out);

// Standalone pieces (testing / reuse).
int fcn_otsu(const uint8_t* img, int n);
int fcn_region_rects(const uint8_t* img, int h, int w, int thresh,
                     int area_thresh, int max_rects, int* rects_out);
int fcn_euclidean_cluster(const float* xyz, int n, float tol,
                          int min_size, int max_size, int* labels_out);
}
