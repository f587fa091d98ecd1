"""CNN codes of image crops for the label tools (``tpufcn/tools/features.py``).

The reference tools gate and cluster by "CNN codes", CaffeNet fc7
activations of each crop (reference
scripts/boundary_adjustment/boundary_refinement.py:385-396,
rank_object_models.py:270-276).  Here, as in the JAX package, a code is
the spatial mean of the VGG16 backbone's conv5_3 (512 values), L2
normalised.  The backbone runs on the card unless the caller passes
``device="cpu"``; the resize of each crop runs on the host.
"""

from __future__ import annotations

import logging
from typing import Mapping, Sequence

import numpy as np
import torch

from torchfcn.core.device import port_device
from torchfcn.core.dtypes import DTypePolicy
from torchfcn.data.raster import resize_linear_u8
from torchfcn.models.layers import nchw
from torchfcn.models.vgg import VGG16Backbone
from torchfcn.ops.image import demean_bgr


class CnnCodeExtractor:
    """(N crops of any size, uint8 BGR) -> (N, 512) float32 codes.

    Each crop is resized to ``input_size`` squared with cv2's INTER_LINEAR
    (``resize_linear_u8``, bit-equal to ``cv.resize``), the batch is
    demeaned (``demean_bgr``) and run through VGG16 in ``dtype`` (float32
    parameters, ``DTypePolicy``; float32 runs with TF32 off), and conv5_3
    is averaged over its rows and columns in float32 and divided by its L2
    norm (at least 1e-8).  The JAX package pads each batch to a power of
    two to bound its XLA compiles; the port has no compile to bound, so a
    batch is the crops given.

    The weights are the seeded Caffe "xavier" init drawn from
    ``generator`` (a CPU ``torch.Generator``, seed 0 by default), which
    warns as tpufcn's random init does; ``from_caffemodel`` and
    ``from_jax`` load trained weights.
    """

    def __init__(self, input_size: int = 224, dtype=torch.bfloat16,
                 device="cuda", generator: torch.Generator = None):
        # codes of a random backbone gate far worse than the pretrained
        # CaffeNet fc7 codes the reference's thresholds were tuned for
        # (similarity 0.5, DBSCAN eps 0.25)
        logging.getLogger(__name__).warning(
            "CnnCodeExtractor built with randomly initialized VGG16 weights; "
            "similarity gating will be weak: load trained weights "
            "(from_caffemodel / from_jax) for real refinement/ranking runs")
        self._bind(_seeded_backbone(generator), input_size, dtype, device)

    def _bind(self, model: VGG16Backbone, input_size: int, dtype,
              device) -> None:
        self.size = input_size
        self.device = port_device(device, "CnnCodeExtractor")
        self.policy = DTypePolicy(compute_dtype=dtype)
        self.model = self.policy.apply(model).to(self.device).eval()

    @classmethod
    def from_caffemodel(cls, path: str, input_size: int = 224,
                        dtype=torch.bfloat16,
                        device="cuda") -> "CnnCodeExtractor":
        """The extractor with a VGG16 ``.caffemodel``'s convs, loaded by
        layer name (``conv1_1`` .. ``conv5_3``); layers the backbone lacks
        are ignored and convs the file lacks keep the seeded init (the
        reference tools load a ``.caffemodel`` for their fc7 codes,
        boundary_refinement.py:374-383)."""
        from torchfcn.convert import convert_caffemodel
        model = _seeded_backbone(None)
        convert_caffemodel(model, path, strict=False)
        self = cls.__new__(cls)
        self._bind(model, input_size, dtype, device)
        return self

    @classmethod
    def from_jax(cls, params: Mapping, input_size: int = 224,
                 dtype=torch.bfloat16,
                 device="cuda") -> "CnnCodeExtractor":
        """The extractor with the JAX package's extractor parameters
        (``tpufcn.tools.features.CnnCodeExtractor.params`` as numpy
        arrays), through ``convert.from_jax.load_jax_params``."""
        from torchfcn.convert.from_jax import load_jax_params
        model = VGG16Backbone()
        load_jax_params(model, params)
        self = cls.__new__(cls)
        self._bind(model, input_size, dtype, device)
        return self

    def batch(self, crops_bgr: Sequence[np.ndarray]) -> torch.Tensor:
        """The crops resized on the host and stacked: (N, S, S, 3) uint8 on
        the extractor's device."""
        resized = np.stack([resize_linear_u8(c, (self.size, self.size))
                            for c in crops_bgr])
        return torch.from_numpy(resized).to(self.device)

    @torch.no_grad()
    def codes(self, batch: torch.Tensor) -> torch.Tensor:
        """(N, S, S, 3) uint8 BGR on the extractor's device -> (N, 512)
        float32 codes there, under the caller's TF32 settings."""
        conv5_3 = self.model(nchw(demean_bgr(batch)))["conv5_3"]
        code = conv5_3.float().mean(dim=(-2, -1))
        norm = torch.linalg.vector_norm(code, dim=-1, keepdim=True)
        return code / torch.clamp(norm, min=1e-8)

    def __call__(self, crops_bgr: Sequence[np.ndarray]) -> np.ndarray:
        with self.policy.precision():
            return self.codes(self.batch(crops_bgr)).cpu().numpy()


def _seeded_backbone(generator) -> VGG16Backbone:
    model = VGG16Backbone()
    model.init_weights(generator if generator is not None
                       else torch.Generator().manual_seed(0))
    return model


def bhattacharyya(a: np.ndarray, b: np.ndarray) -> float:
    """Bhattacharyya distance between nonnegative feature vectors, the
    reference's similarity gate (cv.compareHist HISTCMP_BHATTACHARYYA,
    boundary_refinement.py:129-135)."""
    a = np.abs(np.asarray(a, np.float64))
    b = np.abs(np.asarray(b, np.float64))
    sa, sb = a.sum(), b.sum()
    if sa == 0 or sb == 0:
        return 1.0
    bc = np.sum(np.sqrt(a * b)) / np.sqrt(sa * sb)
    return float(np.sqrt(max(0.0, 1.0 - bc)))


def chi_square(a: np.ndarray, b: np.ndarray) -> float:
    """chi^2 histogram distance (cv.HISTCMP_CHISQR), used by the ranking
    walk (rank_object_models.py)."""
    a = np.abs(np.asarray(a, np.float64))
    b = np.abs(np.asarray(b, np.float64))
    denom = a + b
    mask = denom > 0
    return float(np.sum((a[mask] - b[mask]) ** 2 / denom[mask]))
