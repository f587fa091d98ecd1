"""``.caffemodel`` weights in and out of a model of the port's zoo
(``tpufcn/convert/convert.py``).

A Caffe convolution blob is (C_out, C_in, kH, kW), the port's own OIHW
layout, so weights load without a transpose; biases are (C_out,).  Every
Deconvolution of the reference zoo is a frozen depthwise bilinear filler
that the models compute as a constant: such blobs are recognised and
skipped.

Names: a conv's Caffe layer name is the path of its leaf in the JAX
package's Flax tree (``ZooModel.flax_paths``) without the trailing "conv"
scope, e.g. ``inception_3a/1x1`` or ``backbone/conv4_3``.  A Caffe layer
maps to the conv whose name equals it or, failing that, to the one conv
whose name ends with ``/`` + it (``conv4_3`` -> ``backbone/conv4_3``).
GroupNorm parameters have no Caffe layer and keep their values.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from torchfcn.convert.caffe_pb import load_caffemodel, write_caffemodel
from torchfcn.models.layers import CaffeConv, ZooModel


def conv_layers(model: ZooModel) -> Dict[str, CaffeConv]:
    """Caffe layer name -> conv module of ``model``."""
    paths = model.flax_paths()
    layers = {}
    for name, module in model.named_modules():
        if isinstance(module, CaffeConv):
            path = paths[f"{name}.weight"][:-1]          # drop "kernel"
            if path[-1] == "conv":
                path = path[:-1]
            layers["/".join(path)] = module
    return layers


def _match(layers: Dict[str, CaffeConv], layer: str) -> Optional[CaffeConv]:
    if layer in layers:
        return layers[layer]
    suffix = [name for name in layers if name.endswith("/" + layer)]
    if len(suffix) > 1:
        raise KeyError(f"ambiguous caffe layer '{layer}': {suffix}")
    return layers[suffix[0]] if suffix else None


def _looks_bilinear(w: np.ndarray) -> bool:
    """A depthwise (dim 1 == 1) kernel symmetric under a half turn: the
    blob of a bilinear upsampler."""
    if w.ndim != 4 or w.shape[1] != 1:
        return False
    k = w[0, 0]
    return bool(np.allclose(k, k[::-1, ::-1], atol=1e-5))


def _copy(param: torch.Tensor, value: np.ndarray, what: str) -> None:
    if tuple(value.shape) != tuple(param.shape):
        raise ValueError(f"shape mismatch at {what}: caffemodel "
                         f"{value.shape} vs model {tuple(param.shape)}")
    param.copy_(torch.from_numpy(np.ascontiguousarray(value, np.float32)))


@torch.no_grad()
def convert_caffemodel(model: ZooModel, caffemodel_path: str,
                       strict: bool = True) -> ZooModel:
    """Load the conv blobs of a ``.caffemodel`` into ``model`` in place (its
    dtypes and device stay) and return it.  Convs the file does not name
    keep their values (Caffe's copy-by-layer-name).  ``strict`` raises
    KeyError if a 4-D blob that is not a bilinear filler finds no conv;
    a shape mismatch raises ValueError."""
    layers = conv_layers(model)
    unmatched: List[str] = []
    for layer, blobs in load_caffemodel(caffemodel_path).items():
        w = blobs[0]
        if w.ndim != 4:
            continue              # no such layer in the zoo
        conv = _match(layers, layer)
        if conv is None:
            if not _looks_bilinear(w):
                unmatched.append(layer)
            continue              # frozen bilinear deconv: a constant here
        _copy(conv.weight, w, f"{layer} weight")
        if len(blobs) > 1:
            # legacy (V1) blobs carry 4-D dims: a bias may arrive as
            # (1, C, 1, 1); a one-channel head's as (1, 1, 1, 1)
            b = np.atleast_1d(np.squeeze(blobs[1]))
            if b.ndim != 1:
                unmatched.append(f"{layer} (bias shape {blobs[1].shape})")
            elif conv.bias is None:
                raise KeyError(f"no bias at {layer}")
            else:
                _copy(conv.bias, b, f"{layer} bias")
    if strict and unmatched:
        raise KeyError(f"unmatched caffe layers: {unmatched}")
    return model


def export_caffemodel(model: ZooModel, path: str) -> None:
    """Write the conv parameters of ``model`` as a ``.caffemodel``, float32
    (the reverse of ``convert_caffemodel``)."""
    layers = {}
    for name, conv in conv_layers(model).items():
        blobs = [conv.weight.detach().float().cpu().numpy()]
        if conv.bias is not None:
            blobs.append(conv.bias.detach().float().cpu().numpy())
        layers[name] = blobs
    write_caffemodel(path, layers)
