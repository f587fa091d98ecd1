"""Training data of the port: manifests, the VOC converter, record shards,
the host and on-device scene compositors, the batch sources and the pool
of processes that composes on the host (``parallel``).  Nothing here
imports ``cv2``: images are decoded by the port's own JPEG and PNG readers
(``jpeg``, ``imageio``), or come as arrays, or through a decoder that the
caller passes."""

from torchfcn.data.compositor import (
    ComposedScene, Compositor, fcn_crop_sample, photometric,
    random_augmentation, resize_image_and_rects, rotate_image_with_rects,
    zoom_crop)
from torchfcn.data.parallel import ParallelCompositePipeline
from torchfcn.data.pipeline import CompositeTrainPipeline

__all__ = ["ComposedScene", "Compositor", "CompositeTrainPipeline",
           "ParallelCompositePipeline", "fcn_crop_sample", "photometric",
           "random_augmentation", "resize_image_and_rects",
           "rotate_image_with_rects", "zoom_crop"]
