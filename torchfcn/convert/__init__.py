"""Weights of the port's models: ``.caffemodel`` files (``convert.py``),
Trainer snapshots (``torchfcn.train.trainer``) and tpufcn parameter trees
(``from_jax.py``)."""

from __future__ import annotations

import os
from typing import Optional

from torchfcn.convert.caffe_pb import load_caffemodel, write_caffemodel
from torchfcn.convert.convert import convert_caffemodel, export_caffemodel
from torchfcn.models.layers import ZooModel


def resolve_weights(weights: Optional[str], model: ZooModel) -> ZooModel:
    """One resolver for every weights argument (``tpufcn/convert/
    __init__.py::resolve_weights``), loading into ``model`` in place:
    ``None`` keeps its seeded init, a directory loads the latest snapshot
    of a port Trainer, a file loads a ``.caffemodel`` leniently by name
    (convs it does not name keep their init).  Returns ``model``."""
    if weights and os.path.isdir(weights):
        from torchfcn.train.trainer import load_snapshot_params
        model.load_state_dict(load_snapshot_params(weights))
    elif weights:
        convert_caffemodel(model, weights, strict=False)
    return model


__all__ = ["load_caffemodel", "write_caffemodel", "convert_caffemodel",
           "export_caffemodel", "resolve_weights"]
