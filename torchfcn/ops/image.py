"""Frame preprocessing of the port (``tpufcn/ops/image.py``): the demean +
min-max of the VGG and FCN families, and frame resizing.

``demean_bgr`` subtracts the ImageNet BGR means and min-max normalises each
image over all its pixels and channels, in float32, as the reference's
``demean_rgb_image`` does (on BGR images, despite its name).

``resize_bilinear`` is ``jax.image.resize(method="linear")`` with its
default ``antialias=True``:
half-pixel sample positions and a triangle kernel that widens by the
downscale factor, so a downscale averages every input pixel it covers.  It
separates into one weight matrix per axis, applied here as two float32
matmuls (H, then W), with TF32 off whatever the caller's settings
(``jax.image.resize`` computes at HIGHEST precision).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from torchfcn.core.config import IMAGENET_BGR_MEAN
from torchfcn.core.dtypes import float32_exact


def demean_bgr(img: torch.Tensor, mesh=None) -> torch.Tensor:
    """(..., H, W, 3) BGR images -> float32 in [0, 1]: subtract the
    ImageNet BGR means, then min-max over each image.  A constant image
    maps to zeros (the denominator is at least float32's smallest normal)
    where the reference would divide by zero.  On a mesh that shards rows
    (``torchfcn.core.mesh``) ``img`` is this rank's band of rows, and the
    minimum and maximum are the whole frame's (reduced over the space
    group, exactly)."""
    out = img.to(torch.float32) - torch.tensor(
        IMAGENET_BGR_MEAN, dtype=torch.float32, device=img.device)
    lo = out.amin(dim=(-3, -2, -1), keepdim=True)
    hi = out.amax(dim=(-3, -2, -1), keepdim=True)
    if mesh is not None and mesh.space > 1:
        import torch.distributed as dist
        dist.all_reduce(lo, dist.ReduceOp.MIN, group=mesh.space_group)
        dist.all_reduce(hi, dist.ReduceOp.MAX, group=mesh.space_group)
    return (out - lo) / torch.clamp(hi - lo,
                                    min=torch.finfo(torch.float32).tiny)


def scale_translate_weights(in_size: int, out_size: int, scale,
                            translation: Optional[torch.Tensor] = None,
                            antialias: bool = False,
                            device=None) -> torch.Tensor:
    """(..., in_size, out_size) float32 weights of one axis, as JAX's
    ``compute_weight_mat`` builds them for the linear kernel inside a jitted
    program: an output pixel ``i`` samples the input at ``(i + 0.5) / scale
    - translation / scale - 0.5`` with a triangle kernel (widened by the
    downscale factor with ``antialias``), each column divided by its sum
    where that exceeds 1000 eps, and no weight where the sample lies
    outside [-0.5, in_size - 0.5].

    ``scale`` is a Python float (JAX's resize passes one, and inverts it in
    float64) or a float32 tensor of shape (...,) (inverted in float32).
    ``translation`` is None (no translation term) or a float32 tensor like
    ``scale``.  The sample position rounds as XLA's CPU code does: without
    a translation, ``(i + 0.5) * inv - 0.5`` is one fused multiply-add;
    with one, ``t * inv`` rounds, ``(i + 0.5) * inv - t * inv`` is one fused
    multiply-add and the ``- 0.5`` rounds again.  The products are exact in
    float64, so each fused operation rounds once here too."""
    f32 = dict(dtype=torch.float32, device=device)
    if isinstance(scale, torch.Tensor):
        scale = scale.to(torch.float32)
        f32["device"] = scale.device
        inv = torch.ones_like(scale) / scale
    else:
        inv = torch.tensor(1.0 / scale, **f32)
    pos = torch.arange(out_size, dtype=torch.float64,
                       device=f32["device"]) + 0.5
    prod = pos * inv.double()[..., None]
    if translation is None:
        sample = (prod - 0.5).float()
    else:
        shift = translation.to(torch.float32) * inv
        sample = (prod - shift.double()[..., None]).float() - 0.5
    kernel_scale = torch.clamp(inv, min=1.0) if antialias \
        else torch.ones_like(inv)
    src = torch.arange(in_size, **f32)
    w = torch.clamp(1.0 - (sample[..., None, :] - src[:, None]).abs()
                    / kernel_scale[..., None, None], min=0.0)
    total = w.sum(dim=-2, keepdim=True)
    eps = 1000.0 * torch.finfo(torch.float32).eps
    w = torch.where(total.abs() > eps,
                    w / torch.where(total != 0, total, 1.0), 0.0)
    # a sample outside the input gets no weight at all
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[..., None, :], w, 0.0)


def resize_weights(in_size: int, out_size: int,
                   device=None) -> torch.Tensor:
    """(in_size, out_size) float32 weights of one axis, as
    ``jax.image.resize(method="linear")`` builds them (antialiased, no
    translation)."""
    return scale_translate_weights(in_size, out_size, out_size / in_size,
                                   antialias=True, device=device)


def resize_bilinear(img: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Antialiased bilinear resize of (..., H, W, C) images to
    (..., h, w, C) float32.  An axis whose size does not change is left as
    it is, as JAX leaves it."""
    h, w = size
    x = img.to(torch.float32)
    in_h, in_w = x.shape[-3], x.shape[-2]
    with float32_exact():
        if in_h != h:
            x = torch.einsum("...hwc,hy->...ywc", x,
                             resize_weights(in_h, h, x.device))
        if in_w != w:
            x = torch.einsum("...ywc,wx->...yxc", x,
                             resize_weights(in_w, w, x.device))
    return x


def preprocess_bgr(img: torch.Tensor, net_hw: Tuple[int, int]) -> torch.Tensor:
    """Demean + min-max at the input resolution, then resize to the net's
    (height, width) where that differs: the reference's order (demean
    first, then resize)."""
    x = demean_bgr(img)
    if tuple(x.shape[-3:-1]) != tuple(net_hw):
        x = resize_bilinear(x, net_hw)
    return x
