"""The segmentation serving surface of the port (``bench.py::_seg_forward``
in the JAX package):

    raw BGR frames -> demean + min-max per image -> FCN forward -> argmax
    over the classes of the full-resolution ``seg`` logits

The segmentation family has no decode or NMS stage.  Frames are not
resized: FCN-32s returns labels of the frame's size for heights and widths
that are multiples of 16 (its native size is 224x224).
"""

from __future__ import annotations

import torch

from typing import Optional

from torchfcn.core.dtypes import DTypePolicy
from torchfcn.models import get_spec
from torchfcn.ops.image import demean_bgr
from torchfcn.serve.detector import model_and_device, serving_policy


class Segmenter:
    """Per-pixel class labels from a segmentation model of the zoo.

    Example:
        seg = Segmenter("fcn32s_seg_serving")
        labels = seg(frames_u8)   # (B, H, W, 3) BGR -> (B, H, W) int64

    ``device`` defaults to "cuda" and raises if CUDA is absent; pass "cpu"
    to run on the CPU.  ``dtype``, ``policy`` and ``weights`` as for the
    Detector; weights are otherwise the seeded Caffe "xavier" init
    (``rng_seed``) until loaded, e.g. with
    ``torchfcn.convert.from_jax.load_jax_params(seg.model, tree)``.
    ``model``: a model of ``model_name`` served as it is, as for the
    Detector.
    """

    def __init__(self, model_name: str = "fcn32s_seg",
                 dtype: torch.dtype = torch.bfloat16, rng_seed: int = 0,
                 device="cuda", policy: Optional[DTypePolicy] = None,
                 weights: Optional[str] = None,
                 model: Optional[torch.nn.Module] = None):
        self.spec = get_spec(model_name)
        if "seg" not in self.spec.heads:
            raise ValueError(f"{model_name} has no segmentation head")
        self.policy = serving_policy(dtype, policy)
        self.model, self.device = model_and_device(
            model, model_name, dtype, rng_seed, None, device, self.policy,
            weights)

    @classmethod
    def from_checkpoint(cls, snapshot_dir: str,
                        model_name: str = "fcn32s_seg",
                        step: Optional[int] = None, **kwargs) -> "Segmenter":
        """A Segmenter with the parameters of a Trainer snapshot."""
        from torchfcn.train.trainer import load_snapshot_params
        seg = cls(model_name, **kwargs)
        seg.model.load_state_dict(load_snapshot_params(snapshot_dir, step))
        return seg

    def logits(self, frames: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) frames -> (B, H, W, C) float32 ``seg`` logits."""
        return self.model(demean_bgr(frames))["seg"]

    @torch.inference_mode()
    def __call__(self, frames) -> torch.Tensor:
        """frames: (B, H, W, 3) BGR, uint8 or float in [0, 255]; returns
        (B, H, W) int64 labels, the first of equal maxima."""
        frames = torch.as_tensor(frames, device=self.device)
        if frames.dim() != 4 or frames.shape[-1] != 3:
            raise ValueError(f"frames must be (B, H, W, 3), got "
                             f"{tuple(frames.shape)}")
        with self.policy.precision():
            return torch.argmax(self.logits(frames), dim=-1)
