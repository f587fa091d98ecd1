"""Load a tpufcn (JAX/Flax) parameter tree into a model of the port's zoo,
and write a model's parameters as such a tree (``flax_arrays``).

The tree comes as nested dicts of numpy arrays (``jax.tree.map(np.asarray,
params)``), named as in the JAX package, e.g.::

    {"params": {"conv1/7x7_s2": {"conv": {"kernel": HWIO, "bias": (O,)}},
                "backbone": {"conv4_3": {"conv": {...}}},
                "stage2_block0": {"down": {"kernel": ...},
                                  "gn_down": {"scale": ..., "bias": ...}}}}

Each model declares where its parameters live in that tree
(``ZooModel.flax_paths``).  Kernels go from HWIO to OIHW.  Loading is
strict: every leaf of the tree is used exactly once and every parameter of
the module is set.  This module needs neither JAX nor Flax.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from torchfcn.models.layers import ZooModel


def _flatten(tree: Mapping[str, Any], prefix=()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), value


@torch.no_grad()
def load_jax_params(model: ZooModel, tree: Mapping[str, Any]) -> None:
    """Copy the JAX parameters into ``model`` in place (its dtypes, device
    and memory format stay).  Raises KeyError on a missing or unused leaf
    and ValueError on a shape mismatch."""
    leaves = dict(_flatten(tree["params"] if "params" in tree else tree))
    paths = model.flax_paths()
    used = set()
    for name, param in model.named_parameters():
        path = paths[name]
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


def flax_arrays(model: ZooModel) -> Dict[str, np.ndarray]:
    """The parameters of ``model`` as the JAX package's ``convert``
    subcommand writes its tree into a ``.npz`` (the inverse of
    ``load_jax_params``): ``params/<Flax path>`` -> float32 array, kernels
    HWIO, in the order of JAX's flattening (the keys sorted at each
    level)."""
    paths = model.flax_paths()
    arrays = {}
    for name, param in model.named_parameters():
        value = param.detach().float().cpu().numpy()
        if value.ndim == 4:
            value = value.transpose(2, 3, 1, 0)          # OIHW -> HWIO
        arrays[("params",) + paths[name]] = np.ascontiguousarray(value)
    return {"/".join(path): arrays[path] for path in sorted(arrays)}
