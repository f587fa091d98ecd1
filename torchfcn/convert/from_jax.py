"""Load a tpufcn (JAX/Flax) parameter tree into the port's GoogLeNet.

The tree comes as nested dicts of numpy arrays (``jax.tree.map(np.asarray,
params)``), Caffe-named as in the JAX package::

    {"params": {"conv1/7x7_s2": {"conv": {"kernel": HWIO, "bias": (O,)}},
                "inception_3a": {"1x1": {"conv": {...}}, ...}, ...}}

Kernels go from HWIO to OIHW.  Loading is strict: every leaf of the tree is
used exactly once and every parameter of the module is set.  This module
needs neither JAX nor Flax.
"""

from __future__ import annotations

from typing import Any, Mapping, Tuple

import numpy as np
import torch
import torch.nn as nn

# The one place that maps port module names to the Caffe layer names of the
# JAX param tree: stem and heads, then the inception branches.
MODULE_TO_CAFFE = {
    "conv1": "conv1/7x7_s2",
    "conv2_reduce": "conv2/3x3_reduce",
    "conv2": "conv2/3x3",
    "cvg": "cvg/classifier",
    "bbox": "bbox/regressor",
}
BRANCH_TO_CAFFE = {
    "b1x1": "1x1",
    "b3x3_reduce": "3x3_reduce",
    "b3x3": "3x3",
    "b5x5_reduce": "5x5_reduce",
    "b5x5": "5x5",
    "pool_proj": "pool_proj",
}
LEAF_TO_FLAX = {"weight": "kernel", "bias": "bias"}


def jax_path(param_name: str) -> Tuple[str, ...]:
    """Port parameter name -> path of the JAX leaf, e.g.
    ``inception_3a.b3x3.weight`` -> (inception_3a, 3x3, conv, kernel)."""
    *modules, leaf = param_name.split(".")
    if len(modules) == 1:
        caffe = (MODULE_TO_CAFFE[modules[0]],)
    else:
        block, branch = modules
        caffe = (block, BRANCH_TO_CAFFE[branch])
    return (*caffe, "conv", LEAF_TO_FLAX[leaf])


def _flatten(tree: Mapping[str, Any], prefix=()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), value


@torch.no_grad()
def load_jax_params(model: nn.Module, tree: Mapping[str, Any]) -> None:
    """Copy the JAX parameters into ``model`` in place (its dtype, device
    and memory format stay).  Raises KeyError on a missing or unused leaf
    and ValueError on a shape mismatch."""
    leaves = dict(_flatten(tree["params"] if "params" in tree else tree))
    used = set()
    for name, param in model.named_parameters():
        path = jax_path(name)
        if path not in leaves:
            raise KeyError(f"no JAX leaf {'/'.join(path)} for {name}")
        used.add(path)
        value = np.array(leaves[path], np.float32)
        if value.ndim == 4:
            value = value.transpose(3, 2, 0, 1)          # HWIO -> OIHW
        if tuple(value.shape) != tuple(param.shape):
            raise ValueError(f"{name}: JAX shape {value.shape} vs "
                             f"{tuple(param.shape)}")
        param.copy_(torch.from_numpy(np.ascontiguousarray(value)))
    unused = sorted("/".join(p) for p in set(leaves) - used)
    if unused:
        raise KeyError(f"JAX leaves not loaded: {unused}")
