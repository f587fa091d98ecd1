"""On-device copy-paste scene composition of the port
(``tpufcn/data/device_compositor.py``): a whole training batch composed on
the pipeline's device, with no per-scene host work.

Per scene: a background zoom-crop of 1-2x, 1..3 pasted object crops (each
flipped, rescaled by 1.0-2.2x with p = 0.5, and placed at the first of T
random candidates whose scaled IoU with every earlier paste is at most
0.05), the instance mask (label + 1), a whole-scene flip, a zoom-crop of
single-box scenes and a photometric chain (blur, sharpen, add, multiply,
partial grayscale).

The JAX package draws from keys inside one jitted program.  The port splits
that into two parts:

* ``draw``: every random value of a batch, as one ``SceneDraws`` of (B, ...)
  tensors drawn from the pipeline's ``torch.Generator`` on its device, in
  the JAX package's ranges.  Uniform values are kept as unit draws in
  [0, 1) and mapped to their range where they are used, as
  ``jax.random.uniform`` maps them (``_uniform``), because two ranges
  depend on the scene;
* ``compose``: a deterministic function of the draws, the backgrounds and
  the crop library, computed on (B, ...) tensors without a host
  synchronisation (no ``.item()``, no Python branch on a tensor, no
  ``nonzero``).

The float32 products (the renders' weight products, the blur and sharpen
convolutions, the gray projection) run with TF32 off, so the card computes
what the CPU computes.  Crops and backgrounds come as arrays, or from files
through a decoder the caller passes: the port never imports ``cv2``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from torchfcn.core.config import DataConfig, GridConfig
from torchfcn.core.device import port_device
from torchfcn.core.dtypes import float32_exact
from torchfcn.data.manifest import MaskSample, bgr2gray_u8, need_decoder
from torchfcn.ops.boxes import scaled_iou_xywh
from torchfcn.ops.image import scale_translate_weights

# BGR weights of the partial grayscale (cv BGR2GRAY)
GRAY_BGR = (0.114, 0.587, 0.299)
# taps of the blur: the cv gaussian at sigma 3 (radius about 9) and every
# box width the blur can draw
BLUR_RADIUS = 9


def _moved(obj, device) -> list:
    """The tensor fields of a dataclass, on ``device``."""
    return [getattr(obj, f.name).to(device) for f in dataclasses.fields(obj)]


@dataclasses.dataclass
class CropLibrary:
    """Object-crop library as fixed-capacity arrays.

    images: (K, Hc, Wc, 3) f32 zero-padded crops (content at the origin)
    masks:  (K, Hc, Wc) f32 in {0, 1}
    sizes:  (K, 2) int64 (h, w) content sizes
    labels: (K,) int64 object class ids (0-based)
    """

    images: torch.Tensor
    masks: torch.Tensor
    sizes: torch.Tensor
    labels: torch.Tensor

    @classmethod
    def from_arrays(cls, images: Sequence[np.ndarray],
                    masks: Sequence[np.ndarray],
                    labels: Sequence[int]) -> "CropLibrary":
        """Crops (h, w, 3), their masks (h, w; nonzero = object) and labels,
        padded with zeros to the largest height and width, as
        ``tpufcn``'s ``from_samples`` pads them."""
        if not len(images):
            raise ValueError("empty crop library")
        hc = max(im.shape[0] for im in images)
        wc = max(im.shape[1] for im in images)
        k = len(images)
        out = np.zeros((k, hc, wc, 3), np.float32)
        out_m = np.zeros((k, hc, wc), np.float32)
        sizes = np.zeros((k, 2), np.int64)
        for i, (im, m) in enumerate(zip(images, masks)):
            h, w = im.shape[:2]
            out[i, :h, :w] = im
            out_m[i, :h, :w] = np.asarray(m) > 0
            sizes[i] = (h, w)
        return cls(torch.from_numpy(out), torch.from_numpy(out_m),
                   torch.from_numpy(sizes),
                   torch.as_tensor(np.asarray(labels, np.int64)))

    @classmethod
    def from_samples(cls, samples: Sequence[MaskSample],
                     imread: Optional[Callable] = None) -> "CropLibrary":
        """The crops of a mask manifest's samples: each image and mask
        decoded by ``imread(path)`` (a BGR uint8 array, or None when
        unreadable), cut to the sample's rect (clipped to the image; rects
        of 1 pixel or less skipped), a 3-channel mask reduced to gray as cv
        does."""
        imread = need_decoder(imread, "CropLibrary.from_samples")
        crops, masks, labels = [], [], []
        for s in samples:
            img, mask = imread(s.image_path), imread(s.mask_path)
            if img is None or mask is None:
                continue
            if mask.ndim == 3:
                mask = bgr2gray_u8(mask)
            x, y, w, h = [int(v) for v in s.rect]
            x, y = max(x, 0), max(y, 0)
            w = min(w, img.shape[1] - x)
            h = min(h, img.shape[0] - y)
            if w <= 1 or h <= 1:
                continue
            crops.append(img[y:y + h, x:x + w])
            masks.append(mask[y:y + h, x:x + w] > 0)
            labels.append(int(s.label))
        return cls.from_arrays(crops, masks, labels)

    def to(self, device) -> "CropLibrary":
        return CropLibrary(*_moved(self, device))


def load_backgrounds(paths: Sequence[str], size_wh: Tuple[int, int],
                     imread: Optional[Callable] = None,
                     resize: Optional[Callable] = None) -> np.ndarray:
    """(N, H, W, 3) float32 backgrounds at the net's size: each decoded by
    ``imread(path)`` (None when unreadable) and brought to ``size_wh`` by
    ``resize(img, (W, H))`` where its size differs."""
    imread = need_decoder(imread, "load_backgrounds")
    out = []
    for p in paths:
        img = imread(p)
        if img is None:
            continue
        if img.shape[1::-1] != tuple(size_wh):
            img = need_decoder(resize, "load_backgrounds")(img, tuple(size_wh))
        out.append(np.asarray(img, np.float32))
    if not out:
        raise ValueError("no readable backgrounds")
    return np.stack(out)


@dataclasses.dataclass
class SceneDraws:
    """Every random value of a batch of B scenes with S paste slots and T
    placement candidates.  ``u_*`` are unit draws in [0, 1), mapped to
    their ranges by ``_uniform`` where they are used."""

    background: torch.Tensor      # (B,) background index
    u_zoom: torch.Tensor          # (B,) background zoom, [1, 2)
    u_oy: torch.Tensor            # (B,) background crop offsets
    u_ox: torch.Tensor
    n_paste: torch.Tensor         # (B,) pastes asked for, in num_compose
    crop: torch.Tensor            # (B, S) crop index
    flip: torch.Tensor            # (B, S) flip code in {-1, 0, 1, 2}
    rescale: torch.Tensor         # (B, S) bool, p = 0.5
    u_scale: torch.Tensor         # (B, S) in scale_range
    cx: torch.Tensor              # (B, S, T) candidate corners in [0, W)
    cy: torch.Tensor              # (B, S, T) in [0, H)
    scene_flip: torch.Tensor      # (B,) flip code in {-1, 0, 1, 2}
    u_e1: torch.Tensor            # (B,) zoom growth, [1, max(W // w, 1))
    u_e2: torch.Tensor            # (B,) [1, max(H // h, 1))
    u_cx: torch.Tensor            # (B,) zoom window jitter
    u_cy: torch.Tensor
    blur_kind: torch.Tensor       # (B,) 0 gaussian, 1 box, 2 odd box
    u_sigma: torch.Tensor         # (B,) gaussian sigma, [0, 3)
    box_width: torch.Tensor       # (B,) in [2, 8)
    odd_half: torch.Tensor        # (B,) in [1, 4): width 2 * odd_half + 1
    u_alpha: torch.Tensor         # (B,) sharpen blend, [0, 1)
    u_light: torch.Tensor         # (B,) sharpen lightness, [0.75, 1.5)
    u_add: torch.Tensor           # (B, 3) [-2, 21)
    add_per_channel: torch.Tensor  # (B,) bool
    u_mul: torch.Tensor           # (B, 3) [0.75, 1.25)
    mul_per_channel: torch.Tensor  # (B,) bool
    u_gray: torch.Tensor          # (B,) gray blend, [0, 0.5)

    def to(self, device) -> "SceneDraws":
        return SceneDraws(*_moved(self, device))


def _uniform(u: torch.Tensor, lo, hi) -> torch.Tensor:
    """``jax.random.uniform``'s map of unit draws to [lo, hi):
    ``max(lo, u * (hi - lo) + lo)`` with ``hi - lo`` in float32 and the
    multiply-add rounded once, as XLA fuses it (the product is exact in
    float64).  ``hi`` may be a tensor like ``u``."""
    lo32 = float(np.float32(lo))
    if isinstance(hi, torch.Tensor):
        span = (hi.to(torch.float32) - lo32).double()
    else:
        span = float(np.float32(hi) - np.float32(lo))
    return torch.clamp((u.double() * span + lo32).float(), min=lo32)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c in float32 rounded once, as XLA fuses it."""
    return (a.double() * b.double() + c.double()).float()


def _rdiv(a: float, t: torch.Tensor) -> torch.Tensor:
    """a / t as one float32 division (``a / t`` on a tensor takes the
    reciprocal and multiplies, which rounds twice)."""
    return torch.full_like(t, a) / t


def _render(img: torch.Tensor, out_hw: Tuple[int, int], sy, sx, ty, tx
            ) -> torch.Tensor:
    """``jax.image.scale_and_translate(method="linear", antialias=False)``
    of (B, Hin, Win, C) images with per-scene (B,) scales and translations:
    content at the input origin lands at [ty, ty + h sy) x [tx, tx + w sx)
    of a (B, H, W, C) float32 canvas."""
    wy = scale_translate_weights(img.shape[1], out_hw[0], sy, ty)
    wx = scale_translate_weights(img.shape[2], out_hw[1], sx, tx)
    with float32_exact():
        out = torch.einsum("bhwc,bhy->bywc", img, wy)
        return torch.einsum("bywc,bwx->byxc", out, wx)


def _scaled_iou_grid(placed, pvalid, cx, cy, w, h):
    """(B, S, T) reference ``JaccardCoeff.iou`` of each placed box
    (B, S, 4) against each candidate at (cx, cy) (B, T) of size (w, h)
    (B,); 0 for slots not placed."""
    cand = torch.stack([cx, cy, w[:, None].expand_as(cx),
                        h[:, None].expand_as(cx)], dim=-1)
    iou = scaled_iou_xywh(placed[:, :, None, :], cand[:, None, :, :])
    return torch.where(pvalid[:, :, None], iou, 0.0)


def _flip_codes(fc: torch.Tensor):
    """(horizontal, vertical) flags of flip codes: 1 horizontal, 0 vertical,
    -1 both, 2 none."""
    return (fc == 1) | (fc == -1), (fc == 0) | (fc == -1)


def _flip_crop(crop: torch.Tensor, h: torch.Tensor, w: torch.Tensor,
               fc: torch.Tensor) -> torch.Tensor:
    """Flip (B, Hc, Wc, C) padded crops of content size (h, w) by their
    flip codes, re-anchoring the content at the origin: ``jnp.roll(
    jnp.flip(crop, axis), w - Wc, axis)`` as a gather, since the shift
    differs per scene."""
    b, hc, wc, c = crop.shape
    do_h, do_v = _flip_codes(fc)
    # roll(flip(a), w - n)[x] = a[n - 1 - ((x - w) mod n)]
    src_x = wc - 1 - torch.remainder(
        torch.arange(wc, device=crop.device)[None] - w[:, None], wc)
    flipped = torch.gather(crop, 2,
                           src_x[:, None, :, None].expand(b, hc, wc, c))
    crop = torch.where(do_h[:, None, None, None], flipped, crop)
    src_y = hc - 1 - torch.remainder(
        torch.arange(hc, device=crop.device)[None] - h[:, None], hc)
    flipped = torch.gather(crop, 1,
                           src_y[:, :, None, None].expand(b, hc, wc, c))
    return torch.where(do_v[:, None, None, None], flipped, crop)


def _compose_scene(d: SceneDraws, bgs: torch.Tensor, lib: CropLibrary,
                   crops: torch.Tensor, *, H: int, W: int, S: int,
                   iou_thresh: float, scale_range: Tuple[float, float],
                   margin: bool = False):
    """The composed scenes: (image f32 (B, H, W, 3), seg int32 (B, H, W),
    rects f32 (B, S, 4) xywh, labels int32 (B, S), valid bool (B, S)), and
    with ``margin`` the (B, H, W) distance of each pixel's pasted masks to
    0.5 (inf where no paste reached it).  ``crops`` are the library's
    images with the mask as a fourth channel."""
    z = _uniform(d.u_zoom, 1.0, 2.0)
    oy = d.u_oy * (H - _rdiv(H, z))
    ox = d.u_ox * (W - _rdiv(W, z))
    canvas = _render(bgs[d.background], (H, W), z, z, -oy * z, -ox * z)
    b = canvas.shape[0]
    dev = canvas.device
    seg = torch.zeros((b, H, W), dtype=torch.int32, device=dev)
    placed = torch.zeros((b, S, 4), dtype=torch.float32, device=dev)
    pvalid = torch.zeros((b, S), dtype=torch.bool, device=dev)
    labels = torch.zeros((b, S), dtype=torch.int32, device=dev)
    near = torch.full((b, H, W), float("inf"), device=dev) if margin \
        else None
    for i in range(S):
        k = d.crop[:, i]
        h, w = lib.sizes[k, 0], lib.sizes[k, 1]
        crop = _flip_crop(crops[k], h, w, d.flip[:, i])
        # p = 0.5 rescale in scale_range, clamped to the frame
        s = torch.where(d.rescale[:, i],
                        _uniform(d.u_scale[:, i], *scale_range), 1.0)
        hw = torch.clamp(torch.round(h * s), 1, H)
        ww = torch.clamp(torch.round(w * s), 1, W)
        # T candidates, the first that overlaps no placed box wins
        cx, cy = d.cx[:, i].float(), d.cy[:, i].float()
        cx = torch.clamp(torch.where(cx + ww[:, None] > W - 1,
                                     cx - (cx + ww[:, None] - W), cx), min=0.0)
        cy = torch.clamp(torch.where(cy + hw[:, None] > H - 1,
                                     cy - (cy + hw[:, None] - H), cy), min=0.0)
        ok = (_scaled_iou_grid(placed, pvalid, cx, cy, ww, hw)
              <= iou_thresh).all(dim=1)
        idx = torch.argmax(ok.to(torch.int32), dim=1, keepdim=True)
        x, y = cx.gather(1, idx)[:, 0], cy.gather(1, idx)[:, 0]
        active = (i < d.n_paste) & ok.gather(1, idx)[:, 0] & (h > 1) & (w > 1)

        layer = _render(crop, (H, W), hw / h, ww / w, y, x)
        sel = (layer[..., 3] > 0.5) & active[:, None, None]
        canvas = torch.where(sel[..., None], layer[..., :3], canvas)
        lab = lib.labels[k].to(torch.int32)
        seg = torch.where(sel, (lab + 1)[:, None, None], seg)
        placed[:, i] = torch.stack([x, y, ww, hw], dim=-1)
        pvalid[:, i] = active
        labels[:, i] = lab
        if margin:
            near = torch.minimum(near, torch.where(
                active[:, None, None], (layer[..., 3] - 0.5).abs(),
                float("inf")))
    return canvas, seg, placed, labels, pvalid, near


def _scene_flip(fc: torch.Tensor, img: torch.Tensor, seg: torch.Tensor,
                rects: torch.Tensor, *, H: int, W: int, near=None):
    """Whole-scene flip by the (B,) flip codes, with the reference rect
    transform's -1-pixel shifts; ``near`` (the mask margin) flips with the
    image."""
    do_h, do_v = _flip_codes(fc)

    def flip(t, dim, do):
        if t is None:
            return None
        return torch.where(do.view(-1, *[1] * (t.dim() - 1)), t.flip(dim), t)

    img = flip(flip(img, 2, do_h), 1, do_v)
    seg = flip(flip(seg, 2, do_h), 1, do_v)
    near = flip(flip(near, 2, do_h), 1, do_v)
    x, y, w, h = rects.unbind(-1)
    x = torch.where(do_h[:, None], torch.clamp(W - x - w - 1, min=0), x)
    y = torch.where(do_v[:, None], torch.clamp(H - y - h - 1, min=0), y)
    return img, seg, torch.stack([x, y, w, h], dim=-1), near


def _support_min(near: torch.Tensor, wy: torch.Tensor, wx: torch.Tensor
                 ) -> torch.Tensor:
    """(B, H, W) smallest ``near`` among the input pixels that each output
    pixel of a render samples: the first input row and column with weight
    and the next ones (an upscale samples at most two per axis)."""
    def pair(w):
        n = w.shape[1]
        first = torch.argmax((w > 0).to(torch.int32), dim=1)
        return first, torch.clamp(first + 1, max=n - 1)

    b = near.shape[0]
    out = None
    for ry in pair(wy):
        rows = torch.gather(near, 1, ry[:, :, None].expand(
            b, ry.shape[1], near.shape[2]))
        for rx in pair(wx):
            v = torch.gather(rows, 2, rx[:, None, :].expand(
                b, rows.shape[1], rx.shape[1]))
            out = v if out is None else torch.minimum(out, v)
    return out


def _zoom_crop(d: SceneDraws, img, seg, rects, valid, *, H: int, W: int,
               near=None):
    """Single-box zoom-crop: a window grown by e1 + e2 (e1 ~ U(1,
    floor(W / w)), e2 ~ U(1, floor(H / h))) around a jittered box centre,
    rendered back to (H, W); scenes with another box count keep theirs."""
    b = img.shape[0]
    i = torch.argmax(valid.to(torch.int32), dim=1)
    x, y, w, h = rects[torch.arange(b, device=img.device), i].unbind(-1)
    w = torch.clamp(w, min=1.0)
    h = torch.clamp(h, min=1.0)
    e1 = _uniform(d.u_e1, 1.0, torch.clamp(torch.floor(_rdiv(W, w)), min=1.0))
    e2 = _uniform(d.u_e2, 1.0, torch.clamp(torch.floor(_rdiv(H, h)), min=1.0))
    nw = torch.clamp(torch.clamp(w * (e1 + e2), min=w), max=W)
    nh = torch.clamp(torch.clamp(h * (e1 + e2), min=h), max=H)
    # window centre: the box centre jittered within the slack, clamped so
    # that the window stays in the frame and holds the box
    cx = _fma(d.u_cx - 0.5, nw - w, x + w / 2)
    cy = _fma(d.u_cy - 0.5, nh - h, y + h / 2)
    nx = torch.clamp(torch.clamp(cx - nw / 2, min=torch.clamp(x + w - nw,
                                                             min=0.0)),
                     max=torch.minimum(x, W - nw))
    ny = torch.clamp(torch.clamp(cy - nh / 2, min=torch.clamp(y + h - nh,
                                                             min=0.0)),
                     max=torch.minimum(y, H - nh))
    sx, sy = _rdiv(W, nw), _rdiv(H, nh)
    out = _render(torch.cat([img, (seg > 0).to(torch.float32)[..., None]],
                            dim=-1), (H, W), sy, sx, -ny * sy, -nx * sx)
    segf = out[..., 3]
    # a single-box scene holds one object class: its largest value
    lab = torch.clamp(seg.amax(dim=(1, 2)), min=1)
    seg2 = torch.where(segf > 0.5, lab[:, None, None], 0).to(seg.dtype)
    r = torch.floor(torch.stack([(x - nx) * sx, (y - ny) * sy, w * sx,
                                 h * sy], dim=-1))
    slot = torch.arange(rects.shape[1], device=img.device)[None] == i[:, None]
    rects2 = torch.where(slot[..., None], r[:, None, :], rects)
    single = valid.sum(dim=1) == 1
    if near is not None:
        wy = scale_translate_weights(H, H, sy, -ny * sy)
        wx = scale_translate_weights(W, W, sx, -nx * sx)
        near2 = torch.minimum((segf - 0.5).abs(), _support_min(near, wy, wx))
        near = torch.where(single[:, None, None], near2, near)
    img = torch.where(single[:, None, None, None], out[..., :3], img)
    seg = torch.where(single[:, None, None], seg2, seg)
    rects = torch.where(single[:, None, None], rects2, rects)
    return img, seg, rects, near


def _per_channel(k: torch.Tensor, c: int) -> torch.Tensor:
    """(B, ...) per-scene kernels -> (B * c, ...), each repeated for the c
    channels of its scene (the grouped convolution's weight order)."""
    return k[:, None].expand(k.shape[0], c, *k.shape[1:]).reshape(
        k.shape[0] * c, *k.shape[1:])


def _sepconv(img: torch.Tensor, k1d: torch.Tensor) -> torch.Tensor:
    """Depthwise separable filter of (B, H, W, 3) images with a (B, n)
    kernel per scene (cross-correlation, zero "SAME" padding), along H then
    W, in float32 with TF32 off."""
    b, hh, ww, c = img.shape
    n = k1d.shape[1]
    k = _per_channel(k1d, c)
    x = img.permute(0, 3, 1, 2).reshape(1, b * c, hh, ww)
    with float32_exact():
        x = F.conv2d(x, k[:, None, :, None], padding=(n // 2, 0),
                     groups=b * c)
        x = F.conv2d(x, k[:, None, None, :], padding=(0, n // 2),
                     groups=b * c)
    return x.reshape(b, c, hh, ww).permute(0, 2, 3, 1)


def _photometric(d: SceneDraws, img: torch.Tensor, gray_w: torch.Tensor
                 ) -> torch.Tensor:
    """The photometric chain with the reference ranges: a blur (gaussian,
    box, or an odd box for the median), a sharpen blend, add and multiply
    (each per channel with p = 0.5), a partial grayscale; clipped to
    [0, 255].  ``gray_w``: the (3,) BGR gray weights on the device."""
    b, hh, ww, c = img.shape
    r = torch.arange(-BLUR_RADIUS, BLUR_RADIUS + 1, dtype=torch.float32,
                     device=img.device)[None]
    sigma = _uniform(d.u_sigma, 0.0, 3.0)[:, None]
    gk = torch.exp(-0.5 * torch.square(r / torch.clamp(sigma, min=1e-3)))
    gk = torch.where(sigma > 1e-3, gk / gk.sum(dim=1, keepdim=True),
                     (r == 0).to(torch.float32))
    kind = d.blur_kind[:, None]
    width = torch.where(kind == 1, d.box_width[:, None],
                        d.odd_half[:, None] * 2 + 1)
    half = width // 2                    # cv anchor-centred window
    bk = ((r >= -half) & (r <= width - 1 - half)).to(torch.float32)
    bk = bk / bk.sum(dim=1, keepdim=True)
    img = _sepconv(img, torch.where(kind == 0, gk, bk))

    # sharpen blend (imgaug Sharpen alpha / lightness)
    alpha = _uniform(d.u_alpha, 0.0, 1.0)[:, None, None, None]
    light = _uniform(d.u_light, 0.75, 1.5)
    kern = torch.full((b, 3, 3), -1.0, device=img.device)
    kern[:, 1, 1] = 8.0 + light
    x = img.permute(0, 3, 1, 2).reshape(1, b * c, hh, ww)
    with float32_exact():
        sharp = F.conv2d(x, _per_channel(kern, c)[:, None], padding=1,
                         groups=b * c)
    sharp = sharp.reshape(b, c, hh, ww).permute(0, 2, 3, 1)
    img = (1 - alpha) * img + alpha * sharp

    # Add(-2, 21) / Multiply(0.75, 1.25), each per channel with p = 0.5
    add = _uniform(d.u_add, -2.0, 21.0)
    add = torch.where(d.add_per_channel[:, None], add, add[:, :1])
    img = img + add[:, None, None, :]
    mul = _uniform(d.u_mul, 0.75, 1.25)
    mul = torch.where(d.mul_per_channel[:, None], mul, mul[:, :1])
    img = img * mul[:, None, None, :]

    # partial grayscale, alpha U(0, 0.5); BGR weights (cv BGR2GRAY)
    ga = _uniform(d.u_gray, 0.0, 0.5)[:, None, None, None]
    with float32_exact():
        gray = img @ gray_w
    img = (1 - ga) * img + ga * gray[..., None]
    return torch.clamp(img, 0.0, 255.0)


class DeviceCompositePipeline:
    """Training batches composed on the device, one call per batch: a dict
    of image uint8 (B, H, W, 3), rects float32 (B, cap, 4) xywh, labels
    int32 (B, cap), valid bool (B, cap) and seg int32 (B, H, W) (mask =
    label + 1), all on ``device``.

    ``library``: the crops (``CropLibrary.from_arrays`` or
    ``.from_samples``); ``backgrounds``: (N, H, W, 3) arrays at the net's
    size (``load_backgrounds``); ``from_samples`` builds both from a mask
    manifest's samples like the JAX package's constructor.  ``device``
    defaults to "cuda" and raises without CUDA; "cpu" composes on the CPU.
    ``seed`` seeds the pipeline's generator on the device.  ``mesh`` (a
    ``torchfcn.core.mesh.Mesh``; ``tpufcn/data/device_compositor.py:
    461-469``): every rank draws the global batch's ``SceneDraws`` from the
    same generator, composes only its batch shard on the mesh's device and
    keeps its band of the image and seg rows; the batch is a
    ``LocalBatch``, the rank's share of the one-device batch, bit for bit.
    """

    def __init__(self, library: CropLibrary, backgrounds, grid: GridConfig,
                 data_cfg: Optional[DataConfig] = None,
                 box_capacity: int = 8,
                 seed: int = 0,
                 scene_flip: bool = True,
                 zoom: bool = True,
                 photometric: bool = True,
                 mesh=None,
                 device="cuda"):
        self.cfg = data_cfg or DataConfig()
        if self.cfg.rotate:
            raise ValueError(
                "rotation augmentation is host-path only (it is gated off "
                "in the reference too); unset DataConfig.rotate")
        self.mesh = mesh
        self.device = mesh.device if mesh is not None \
            else port_device(device, "DeviceCompositePipeline")
        self.grid = grid
        self.box_capacity = box_capacity
        self.H, self.W = grid.im_height, grid.im_width
        bgs = torch.as_tensor(np.asarray(backgrounds, np.float32))
        if bgs.dim() != 4 or tuple(bgs.shape[1:]) != (self.H, self.W, 3):
            raise ValueError(f"backgrounds must be (N, {self.H}, {self.W}, "
                             f"3) at the net's size, got {tuple(bgs.shape)}")
        self.bgs = bgs.to(self.device)
        self.lib = library.to(self.device)
        self._crops = torch.cat([self.lib.images, self.lib.masks[..., None]],
                                dim=-1)
        self._gray = torch.tensor(GRAY_BGR, dtype=torch.float32,
                                  device=self.device)
        self.S = min(self.cfg.num_compose[1], box_capacity)
        # candidate count = the host path's bounded-trials budget
        self.T = self.cfg.compose_max_trials
        self.switches = dict(scene_flip=scene_flip, zoom=zoom,
                             photometric=photometric)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    @classmethod
    def from_samples(cls, samples: Sequence[MaskSample], grid: GridConfig,
                     data_cfg: Optional[DataConfig] = None,
                     backgrounds: Optional[Sequence[str]] = None,
                     imread: Optional[Callable] = None,
                     resize: Optional[Callable] = None,
                     **kwargs) -> "DeviceCompositePipeline":
        """The JAX package's constructor: crops from the samples, and
        backgrounds from ``backgrounds`` paths (default: the samples'
        images), decoded by ``imread`` and brought to the net's size by
        ``resize(img, (W, H))``."""
        lib = CropLibrary.from_samples(samples, imread=imread)
        paths = list(backgrounds or []) or [s.image_path for s in samples]
        bgs = load_backgrounds(paths, (grid.im_width, grid.im_height),
                               imread=imread, resize=resize)
        return cls(lib, bgs, grid, data_cfg, **kwargs)

    def draw(self, n: int) -> SceneDraws:
        """The random values of ``n`` scenes, from the pipeline's
        generator, on the generator's device (the pipeline's own, unless
        the caller gave it another generator, e.g. a CPU one so that two
        devices compose the same scenes); ``compose`` takes them on the
        pipeline's device."""
        g = self.generator
        dev = g.device
        S, T = self.S, self.T

        def ints(lo, hi, *shape):
            return torch.randint(lo, hi, (n, *shape), generator=g, device=dev)

        def unit(*shape):
            return torch.rand((n, *shape), generator=g, device=dev)

        def coin(*shape):
            return unit(*shape) < 0.5

        lo, hi = self.cfg.num_compose[0], S
        return SceneDraws(
            background=ints(0, self.bgs.shape[0]), u_zoom=unit(),
            u_oy=unit(), u_ox=unit(), n_paste=ints(lo, hi + 1),
            crop=ints(0, self.lib.images.shape[0], S), flip=ints(-1, 3, S),
            rescale=coin(S), u_scale=unit(S), cx=ints(0, self.W, S, T),
            cy=ints(0, self.H, S, T), scene_flip=ints(-1, 3), u_e1=unit(),
            u_e2=unit(), u_cx=unit(), u_cy=unit(), blur_kind=ints(0, 3),
            u_sigma=unit(), box_width=ints(2, 8), odd_half=ints(1, 4),
            u_alpha=unit(), u_light=unit(), u_add=unit(3),
            add_per_channel=coin(), u_mul=unit(3), mul_per_channel=coin(),
            u_gray=unit())

    def compose(self, d: SceneDraws, checks: bool = False
                ) -> Dict[str, torch.Tensor]:
        """The batch of the draws ``d`` (on the pipeline's device).  With
        ``checks`` it also holds "image_float", the image before rounding,
        and "mask_margin", per pixel the smallest distance to 0.5 of the
        rendered masks that decided its label (through the zoom, the
        smallest over the pixels it samples; inf where no mask reached)."""
        H, W, S = self.H, self.W, self.S
        img, seg, rects, labels, valid, near = _compose_scene(
            d, self.bgs, self.lib, self._crops, H=H, W=W, S=S,
            iou_thresh=self.cfg.compose_iou_thresh,
            scale_range=self.cfg.scale_range, margin=checks)
        if self.switches["scene_flip"]:
            img, seg, rects, near = _scene_flip(d.scene_flip, img, seg, rects,
                                                H=H, W=W, near=near)
        if self.switches["zoom"]:
            img, seg, rects, near = _zoom_crop(d, img, seg, rects, valid,
                                               H=H, W=W, near=near)
        if self.switches["photometric"]:
            img = _photometric(d, img, self._gray)
        def pad(t):
            extra = t.new_zeros((t.shape[0], self.box_capacity - S,
                                 *t.shape[2:]))
            return torch.cat([t, extra], dim=1)

        out = {"image": torch.clamp(torch.round(img), 0, 255).to(torch.uint8),
               "rects": pad(rects), "labels": pad(labels),
               "valid": pad(valid), "seg": seg}
        if checks:
            out.update(image_float=img, mask_margin=near)
        return out

    def batch(self, batch_size: int) -> Dict[str, torch.Tensor]:
        """A batch of ``batch_size`` scenes; on a mesh this rank's share of
        the global batch of ``batch_size`` scenes."""
        draws = self.draw(batch_size)
        if self.mesh is None:
            return self.compose(draws)
        from torchfcn.parallel.distributed import LocalBatch, batch_rows
        bs, rows = batch_rows(self.mesh, batch_size, self.H)
        out = self.compose(SceneDraws(**{
            f.name: getattr(draws, f.name)[bs]
            for f in dataclasses.fields(SceneDraws)}))
        return LocalBatch({k: v[:, rows] if k in ("image", "seg") else v
                           for k, v in out.items()})

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        while True:
            yield self.batch(self.cfg.batch_size)
