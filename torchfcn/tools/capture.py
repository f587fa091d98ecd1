"""Dataset capture node (``tpufcn/tools/capture.py``).

Mirrors reference scripts/misc/image_rect_writer.py: exact-time
synchronizer over (image, rect) topics; clamps the rect to the frame,
writes numbered JPEGs and appends ``path x y w h label`` lines to
train.txt (reference :30-74).  The JPEG is ``data/jpeg.py::encode`` at
quality 95, the bytes ``cv.imwrite`` writes at its default quality.
"""

from __future__ import annotations

import os

import numpy as np

from torchfcn.data import jpeg
from torchfcn.data.manifest import detection_line
from torchfcn.serve.bus import TimeSynchronizer, TopicBus


class ImageRectWriter:
    def __init__(self, bus: TopicBus,
                 out_dir: str,
                 label: int = 1,
                 image_topic: str = "/camera/rgb/image_rect_color",
                 rect_topic: str = "/object_rect",
                 manifest_name: str = "train.txt",
                 queue_size: int = 10):
        self.out_dir = out_dir
        self.label = label
        os.makedirs(out_dir, exist_ok=True)
        self.manifest = os.path.join(out_dir, manifest_name)
        # resume-safe numbering: a second capture session into the same
        # out_dir must not overwrite frames the appended manifest still
        # references, so it continues after the highest frame number there
        existing = [int(n[:-4]) for n in os.listdir(out_dir)
                    if len(n) == 12 and n.endswith(".jpg")
                    and n[:-4].isdigit()]
        self.counter = max(existing) + 1 if existing else 0
        self.processed = 0   # frames written by this writer (the counter
        #                      resumes past earlier files, so it is no count)
        TimeSynchronizer(bus, [image_topic, rect_topic], self.callback,
                         queue_size=queue_size)

    def callback(self, image_msg, rect_msg):
        img = np.asarray(image_msg.data)
        x, y, w, h = [int(v) for v in rect_msg.data]
        # clamp to frame (reference :44-57)
        x, y = max(x, 0), max(y, 0)
        w = min(w, img.shape[1] - x)
        h = min(h, img.shape[0] - y)
        if w <= 0 or h <= 0:
            return
        path = os.path.join(self.out_dir, f"{self.counter:08d}.jpg")
        with open(path, "wb") as f:
            f.write(jpeg.encode(img, 95))
        with open(self.manifest, "a") as f:
            # self.label is the literal manifest value (already one-based
            # by the reference convention), so no offset here
            f.write(detection_line(path, (x, y, w, h), self.label,
                                   one_based_labels=False) + "\n")
        self.counter += 1
        self.processed += 1
