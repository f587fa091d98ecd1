"""Frame resizing of the port (``tpufcn/ops/image.py::resize_bilinear``).

``jax.image.resize(method="linear")`` with its default ``antialias=True``:
half-pixel sample positions and a triangle kernel that widens by the
downscale factor, so a downscale averages every input pixel it covers.  It
separates into one weight matrix per axis, applied here as two float32
matmuls (H, then W).  On a GPU these are full float32 as long as
``torch.backends.cuda.matmul.allow_tf32`` stays at its default, False.
"""

from __future__ import annotations

from typing import Tuple

import torch


def resize_weights(in_size: int, out_size: int,
                   device=None) -> torch.Tensor:
    """(in_size, out_size) float32 weights of one axis, as JAX's
    ``compute_weight_mat`` builds them for the linear kernel."""
    f32 = dict(dtype=torch.float32, device=device)
    inv = torch.tensor(1.0 / (out_size / in_size), **f32)
    kernel_scale = torch.clamp(inv, min=1.0)
    # (i + 0.5) * inv - 0.5 rounded once, as XLA's fused multiply-add
    # computes it: the product is exact in float64
    sample = ((torch.arange(out_size, dtype=torch.float64, device=device)
               + 0.5) * inv.double() - 0.5).float()
    src = torch.arange(in_size, **f32)
    w = torch.clamp(1.0 - (sample[None, :] - src[:, None]).abs()
                    / kernel_scale, min=0.0)
    total = w.sum(dim=0, keepdim=True)
    eps = 1000.0 * torch.finfo(torch.float32).eps
    w = torch.where(total.abs() > eps,
                    w / torch.where(total != 0, total, 1.0), 0.0)
    # a sample outside the input gets no weight at all
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], w, 0.0)


def resize_bilinear(img: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Antialiased bilinear resize of (..., H, W, C) images to
    (..., h, w, C) float32.  An axis whose size does not change is left as
    it is, as JAX leaves it."""
    h, w = size
    x = img.to(torch.float32)
    in_h, in_w = x.shape[-3], x.shape[-2]
    if in_h != h:
        x = torch.einsum("...hwc,hy->...ywc", x,
                         resize_weights(in_h, h, x.device))
    if in_w != w:
        x = torch.einsum("...ywc,wx->...yxc", x,
                         resize_weights(in_w, w, x.device))
    return x
