"""Model zoo registry of the port (``tpufcn/models/registry.py``): every
family with its serving presets, its grid geometry, its input preprocessing
and its heads, under the JAX package's names."""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn as nn

from torchfcn.core.config import GridConfig
from torchfcn.models.fcn import FCN8sBBox, FCN32sSeg
from torchfcn.models.googlenet import GoogLeNetDetectNet
from torchfcn.models.resnet_fpn import ResNetFPNDetectNet
from torchfcn.models.vgg import VGGDetectNet, VGGPyramidDetectNet

E5M2 = torch.float8_e5m2
DETECTION = ("coverage", "bboxes")


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """A zoo entry: module factory, grid geometry, IO conventions."""

    factory: Callable[..., nn.Module]
    grid: GridConfig
    # "shift127": raw 0..255 BGR, the model normalises it itself;
    # "demean": ImageNet-BGR demean + per-image min-max before the resize
    preprocessing: str
    background_channel: Optional[int]  # coverage channel to skip, or None
    heads: Tuple[str, ...]             # subset of ("coverage", "bboxes", "seg")


_REGISTRY: Dict[str, ModelSpec] = {}


def get_spec(name: str) -> ModelSpec:
    if name not in _REGISTRY:
        raise KeyError(f"unknown model '{name}'; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def build(name: str, **overrides) -> nn.Module:
    """The model with zeroed float32 parameters on the CPU, in eval mode
    (no dropout; ``train()`` turns it on).  ``overrides`` go to its
    constructor (``num_classes``, ``store_dtype``, ``dropout_rate``, ...)
    over the entry's own."""
    return get_spec(name).factory(**overrides).eval()


def names():
    return sorted(_REGISTRY)


def _register(name: str, cls, classes: int, grid: GridConfig,
              preprocessing: str, background: Optional[int] = None,
              heads: Tuple[str, ...] = DETECTION, **preset) -> None:
    """Register ``cls`` with ``classes`` classes and the preset's
    constructor arguments as defaults."""
    _REGISTRY[name] = ModelSpec(
        factory=lambda **kw: cls(**{"num_classes": classes, **preset, **kw}),
        grid=dataclasses.replace(grid, num_classes=classes),
        preprocessing=preprocessing, background_channel=background,
        heads=heads)


# --- GoogLeNet DetectNet (reference models/deploy.prototxt, 4 classes;
# models/train_val.prototxt, 1; models/train_val2.prototxt, 3) -----------
G448_16 = GridConfig(448, 448, stride=16)
for _name, _classes in (("googlenet_detectnet", 4),
                        ("googlenet_detectnet_1cls", 1),
                        ("googlenet_detectnet_3cls", 3)):
    _register(_name, GoogLeNetDetectNet, _classes, G448_16, "shift127")
# the flagship's serving configuration: e5m2 storage of conv1's output,
# pool1's, the stem tail's (one kernel), the inception branches and concats;
# all compute bf16.  Same parameters as googlenet_detectnet.
_register("googlenet_detectnet_serving", GoogLeNetDetectNet, 4, G448_16,
          "shift127", store_dtype=E5M2, store_blocks=True, store_stem2=True)

# --- VGG DetectNet (reference train/bounding_box/) ------------------------
_register("vgg_detectnet_train", VGGDetectNet, 11,
          GridConfig(224, 224, stride=8), "demean")
_register("vgg_pyramid_detectnet", VGGPyramidDetectNet, 20, G448_16,
          "demean")
# e5m2 storage on the VGG conv stack and the pyramid concat
_register("vgg_pyramid_detectnet_serving", VGGPyramidDetectNet, 20, G448_16,
          "demean", store_dtype=E5M2)

# --- FCN families (classes include background, channel 0) -----------------
G288_8 = GridConfig(288, 288, stride=8)
_register("fcn8s_bbox", FCN8sBBox, 11, G288_8, "demean", background=0,
          heads=DETECTION + ("seg",))
# e5m2 storage on backbone stages 1-2 only: the taps the score heads read
# (pool3, pool4, conv5_3) stay in the compute dtype
_register("fcn8s_bbox_serving", FCN8sBBox, 11, G288_8, "demean",
          background=0, heads=DETECTION + ("seg",), store_dtype=E5M2,
          store_stages=2)
G224_16 = GridConfig(224, 224, stride=16)
_register("fcn32s_seg", FCN32sSeg, 12, G224_16, "demean", background=0,
          heads=("seg",))
# e5m2 storage on the whole backbone; score_fr and the deconv stay exact
_register("fcn32s_seg_serving", FCN32sSeg, 12, G224_16, "demean",
          background=0, heads=("seg",), store_dtype=E5M2)

# --- Modern backbone swap: normalises raw BGR itself ----------------------
_register("resnet_fpn_detectnet", ResNetFPNDetectNet, 4, G448_16,
          "shift127")
