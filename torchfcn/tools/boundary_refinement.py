"""Pseudo-label boundary refinement (``tpufcn/tools/boundary_refinement.py``).

Role of the reference tool
(scripts/boundary_adjustment/boundary_refinement.py): walk an image
sequence with rough tracker-given GT boxes, refine each box by tracking
from the previous frame, gate the update by CNN-code similarity to the
previous crop (Bhattacharyya distance of features, reference :129-135),
and write a refined ``train.txt``.

The reference tracks with a pretrained GOTURN Caffe net (reference
:109-120) whose weights are not redistributable; like the JAX package, the
port tracks by normalised cross-correlation template matching inside a 2x
search window (``tools/ncc.py``, on the host), keeping the similarity-gated
accept/reject logic and the offline manifest rewrite.  A custom tracker
can be injected via ``track_fn(prev_img, prev_rect, cur_img) -> rect``.
The CNN codes come from ``CnnCodeExtractor``, on the card by default.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np

from torchfcn.data.imageio import imread_or_none
from torchfcn.data.manifest import DetectionSample, detection_line
from torchfcn.serve.bus import TimeSynchronizer
from torchfcn.tools.features import CnnCodeExtractor, bhattacharyya
from torchfcn.tools.ncc import match_template_ccoeff_normed, min_max_loc


def ncc_track(prev_img: np.ndarray, prev_rect, cur_img: np.ndarray):
    """Template-match the previous crop inside a 2x window around its
    old position (GOTURN also searches a 2x context window)."""
    x, y, w, h = [int(v) for v in prev_rect]
    x, y = max(x, 0), max(y, 0)
    w = min(w, prev_img.shape[1] - x)
    h = min(h, prev_img.shape[0] - y)
    if w < 4 or h < 4:
        return list(prev_rect)
    tmpl = prev_img[y:y + h, x:x + w]

    cx, cy = x + w // 2, y + h // 2
    sx = max(cx - w, 0)
    sy = max(cy - h, 0)
    ex = min(cx + w, cur_img.shape[1])
    ey = min(cy + h, cur_img.shape[0])
    search = cur_img[sy:ey, sx:ex]
    if search.shape[0] < h or search.shape[1] < w:
        return [x, y, w, h]
    _, _, _, max_loc = min_max_loc(match_template_ccoeff_normed(search, tmpl))
    return [sx + max_loc[0], sy + max_loc[1], w, h]


class BoundaryRefinerNode:
    """Live refinement node (reference ``is_online`` path, :326-339 +
    callback :158-245): exact-time sync over (image, rect) topics, one
    :meth:`BoundaryRefiner.refine_live` step per pair.  The reference
    only imshows the refined box; the refined box is published on
    ``out_topic`` (x, y, w, h frame coords) for downstream nodes, as the
    JAX package does."""

    def __init__(self, bus,
                 refiner: Optional["BoundaryRefiner"] = None,
                 image_topic: str = "/camera/rgb/image_rect_color",
                 rect_topic: str = "/object_rect",
                 out_topic: str = "/boundary_refinement/rect",
                 queue_size: int = 10):
        self.bus = bus
        self.refiner = refiner or BoundaryRefiner()
        self.out_topic = out_topic
        TimeSynchronizer(bus, [image_topic, rect_topic], self.callback,
                         queue_size=queue_size)

    def callback(self, image_msg, rect_msg):
        img = np.asarray(image_msg.data)
        refined = self.refiner.refine_live(
            img, [int(v) for v in rect_msg.data])
        if refined is not None:
            self.bus.publish(self.out_topic, refined,
                             stamp=image_msg.stamp)


class BoundaryRefiner:
    """Without an ``extractor``, the default one (on the card, bf16) is
    built at first use; pass ``extractor=`` for another device."""

    def __init__(self,
                 extractor: Optional[CnnCodeExtractor] = None,
                 track_fn: Callable = ncc_track,
                 similarity_thresh: float = 0.5,
                 imread=imread_or_none):
        self._extractor = extractor
        self.track_fn = track_fn
        self.similarity_thresh = similarity_thresh
        self.imread = imread

    @property
    def extractor(self) -> CnnCodeExtractor:
        # built lazily: the live path (refine_live) never gates by CNN
        # codes, so it needs no backbone on the device
        if self._extractor is None:
            self._extractor = CnnCodeExtractor()
        return self._extractor

    def _crop(self, img, rect):
        x, y, w, h = [int(v) for v in rect]
        # clamp the origin INSIDE the frame (a tracker box fully right
        # of / below the image otherwise yields an empty slice, which
        # the resize cannot take), then the extent to the frame
        x = min(max(x, 0), img.shape[1] - 1)
        y = min(max(y, 0), img.shape[0] - 1)
        w = max(min(w, img.shape[1] - x), 1)
        h = max(min(h, img.shape[0] - y), 1)
        return img[y:y + h, x:x + w]

    def refine(self, samples: Sequence[DetectionSample]
               ) -> List[DetectionSample]:
        """Offline sequence walk (reference :77-157): refine each frame's
        box with the tracker; accept when the refined crop's CNN code is
        close to the previous frame's (Bhattacharyya below threshold),
        else keep the original annotation.

        Single-object sequences only (like the reference, which reads
        one tracker box per frame): only ``rects[0]``/``labels[0]`` of
        each sample are used, and the refined samples carry exactly one
        rect + one label."""
        out: List[DetectionSample] = []
        prev_img = None
        prev_rect = None
        prev_code = None
        for s in samples:
            img = self.imread(s.image_path)
            if img is None:
                out.append(s)
                continue
            rect = [int(v) for v in s.rects[0]]
            refined = rect
            if prev_img is not None:
                cand = self.track_fn(prev_img, prev_rect, img)
                code = self.extractor([self._crop(img, cand)])[0]
                dist = bhattacharyya(code, prev_code)
                if dist < self.similarity_thresh:
                    refined = [int(v) for v in cand]
            code_now = self.extractor([self._crop(img, refined)])[0]
            out.append(DetectionSample(
                s.image_path, np.asarray([refined], np.int32),
                s.labels[:1].copy()))
            prev_img, prev_rect, prev_code = img, refined, code_now
        return out

    def refine_live(self, img: np.ndarray, rect) -> Optional[List[int]]:
        """One live-callback step (reference :158-245): expand the given
        rect by the 2.25 context factor, crop the window, track the
        previous window's box into it, update the template, and return
        the refined rect in FRAME coordinates (None on the first frame,
        which only seeds the template — reference :192-195)."""
        factor = 2.25
        x, y, w, h = [int(v) for v in rect]
        cx1 = max(x - int(w / factor), 0)
        cy1 = max(y - int(h / factor), 0)
        cx2 = min(x + w + int(w / factor), img.shape[1])
        cy2 = min(y + h + int(h / factor), img.shape[0])
        roi = img[cy1:cy2, cx1:cx2]
        rect_in_roi = [x - cx1, y - cy1, w, h]
        prev = getattr(self, "_live_prev", None)
        self._live_prev = (roi, rect_in_roi)
        if prev is None:
            return None
        prev_roi, prev_rect = prev
        cand = self.track_fn(prev_roi, prev_rect, roi)
        return [int(cand[0]) + cx1, int(cand[1]) + cy1,
                int(cand[2]), int(cand[3])]

    def refine_manifest(self, samples: Sequence[DetectionSample],
                        out_path: str,
                        one_based_labels: bool = True) -> int:
        refined = self.refine(samples)
        with open(out_path, "w") as f:
            for s in refined:
                f.write(detection_line(s.image_path, s.rects[0],
                                       s.labels[0], one_based_labels)
                        + "\n")
        return len(refined)
