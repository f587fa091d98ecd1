"""Model zoo registry of the port (``tpufcn/models/registry.py``): the
GoogLeNet DetectNet family, with its fp8 serving preset, its grid geometry
and its input preprocessing.  The other families are not ported yet."""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch
import torch.nn as nn

from torchfcn.core.config import GridConfig
from torchfcn.models.googlenet import GoogLeNetDetectNet


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """A zoo entry: module factory, grid geometry, IO conventions."""

    factory: Callable[[], nn.Module]
    grid: GridConfig
    # "shift127": raw 0..255 BGR, the model shifts by -127 itself.  The
    # other families' "demean" (demean + min-max) is not ported yet.
    preprocessing: str
    background_channel: Optional[int]  # coverage channel to skip, or None


_REGISTRY: Dict[str, ModelSpec] = {}


def get_spec(name: str) -> ModelSpec:
    if name not in _REGISTRY:
        raise KeyError(f"unknown model '{name}'; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def build(name: str) -> nn.Module:
    """The model with zeroed float32 parameters on the CPU."""
    return get_spec(name).factory()


# head widths of reference models/deploy.prototxt (4 classes),
# models/train_val.prototxt (1) and models/train_val2.prototxt (3)
for _name, _classes in (("googlenet_detectnet", 4),
                        ("googlenet_detectnet_1cls", 1),
                        ("googlenet_detectnet_3cls", 3)):
    _REGISTRY[_name] = ModelSpec(
        factory=lambda c=_classes: GoogLeNetDetectNet(num_classes=c),
        grid=GridConfig(448, 448, stride=16, num_classes=_classes),
        preprocessing="shift127",
        background_channel=None,
    )

# The flagship's serving configuration: e5m2 activation storage of conv1's
# output, pool1's, the stem tail's (one kernel), the inception branches and
# concats; all compute bf16.  Same parameters as googlenet_detectnet.
_REGISTRY["googlenet_detectnet_serving"] = ModelSpec(
    factory=lambda: GoogLeNetDetectNet(
        num_classes=4, store_dtype=torch.float8_e5m2, store_blocks=True,
        store_stem2=True),
    grid=GridConfig(448, 448, stride=16, num_classes=4),
    preprocessing="shift127",
    background_channel=None,
)
