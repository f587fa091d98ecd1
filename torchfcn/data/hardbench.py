"""The hard synthetic detection benchmark of the port
(``tpufcn/data/hardbench.py``): the tracked accuracy gates' dataset.

Objects are shape x texture conjunctions (rect + checker, ellipse + rings,
rect + stripes, triangle + speckle, ...), pasted on low-frequency colour
fields; backgrounds carry unlabeled distractors of the mismatched pairings;
scenes allow occlusion up to scaled IoU 0.30 and a 0.7-1.8x paste rescale.

The JAX package draws its sources with ``cv2`` and writes them as PNGs.
The port draws them with ``torchfcn.data.raster`` (numpy) and keeps them
as arrays: the crops cut to their rects with their masks and labels, and
the 384x512 backgrounds, cached as one ``.npz`` under ``root``.  Every
numpy draw comes in the JAX package's order, so one ``dataset_seed`` gives
the same sizes, positions, colours and noise.

Scenes are composed only by the port's device compositor
(``hard_device_pipeline``); the held-out set (``build_eval_set``) too, from
draws of a CPU generator, so that the card and the CPU compose the same
set.  The JAX package's host compositor (``hard_pipeline``) is not ported.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Tuple

import numpy as np
import torch

from torchfcn.core.config import DataConfig, GridConfig
from torchfcn.data import raster

# shape x texture pairings; the first `classes` entries are the labeled
# classes, every OTHER pairing is eligible as an unlabeled distractor
SHAPES = ("rect", "ellipse", "triangle")
TEXTURES = ("checker", "rings", "stripes", "speckle")
CLASS_DEFS: Tuple[Tuple[str, str], ...] = (
    ("rect", "checker"),
    ("ellipse", "rings"),
    ("rect", "stripes"),
    ("triangle", "speckle"),
    ("triangle", "rings"),
    ("ellipse", "stripes"),
)
BOX_CAPACITY = 6          # num_compose max 5 + headroom
SOURCE_HW = (192, 256)    # each object source's clutter field
BACKGROUND_HW = (384, 512)


def distractor_defs(classes: int) -> List[Tuple[str, str]]:
    """All shape/texture pairings not used by the first ``classes``
    classes: each shares a shape or a texture with a class, never both."""
    used = set(CLASS_DEFS[:classes])
    return [(s, t) for s in SHAPES for t in TEXTURES if (s, t) not in used]


def _two_colors(rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
    """Two well-separated random BGR colours (per-instance variation)."""
    hsv = np.zeros((1, 2, 3), np.uint8)
    h0 = int(rng.integers(0, 180))
    hsv[0, 0] = (h0, int(rng.integers(120, 256)), int(rng.integers(120, 256)))
    hsv[0, 1] = ((h0 + int(rng.integers(40, 140))) % 180,
                 int(rng.integers(120, 256)), int(rng.integers(60, 200)))
    bgr = raster.hsv2bgr(hsv)[0]
    return bgr[0].astype(np.float32), bgr[1].astype(np.float32)


def render_texture(kind: str, h: int, w: int,
                   rng: np.random.Generator) -> np.ndarray:
    """(h, w, 3) uint8 texture patch with per-instance colour and period:
    the colours, then the period, then (speckle) the dot mask, then the
    noise."""
    c1, c2 = _two_colors(rng)
    gy, gx = np.mgrid[0:h, 0:w].astype(np.float32)
    p = float(rng.integers(5, 13))
    if kind == "checker":
        sel = ((gx // p).astype(int) + (gy // p).astype(int)) % 2
    elif kind == "rings":
        d = np.hypot(gx - w / 2.0, gy - h / 2.0)
        sel = (d // p).astype(int) % 2
    elif kind == "stripes":
        sel = ((gx + gy) // p).astype(int) % 2
    elif kind == "speckle":
        dots = (rng.random((h, w)) < 0.10).astype(np.uint8)
        sel = raster.dilate_2x2(dots).astype(int)
    else:
        raise ValueError(f"unknown texture '{kind}'")
    img = np.where(sel[..., None] > 0, c2, c1)
    img += rng.normal(0.0, 6.0, size=img.shape).astype(np.float32)
    return np.clip(img, 0, 255).astype(np.uint8)


def render_shape_mask(kind: str, h: int, w: int,
                      rng: np.random.Generator) -> np.ndarray:
    """(h, w) uint8 {0, 255} mask of the shape, filling the patch (the
    triangle draws its apex jitter)."""
    m = np.zeros((h, w), np.uint8)
    if kind == "rect":
        m[:] = 255
    elif kind == "ellipse":
        raster.fill_ellipse(m, (w // 2, h // 2), (w // 2 - 1, h // 2 - 1))
    elif kind == "triangle":
        jx = int(rng.integers(-w // 6, w // 6 + 1))
        raster.fill_poly(m, np.array([[w // 2 + jx, 0], [0, h - 1],
                                      [w - 1, h - 1]]))
    else:
        raise ValueError(f"unknown shape '{kind}'")
    return m


def render_object(shape: str, texture: str, h: int, w: int,
                  rng: np.random.Generator):
    """-> (patch (h, w, 3) uint8, mask (h, w) uint8)."""
    return render_texture(texture, h, w, rng), \
        render_shape_mask(shape, h, w, rng)


def _color_field(h: int, w: int, rng: np.random.Generator) -> np.ndarray:
    """Low-frequency colour field + fine noise (cluttered background)."""
    small = rng.integers(30, 200, size=(6, 8, 3)).astype(np.uint8)
    field = raster.resize_cubic_u8(small, (w, h))
    noise = rng.normal(0.0, 8.0, size=field.shape).astype(np.float32)
    return np.clip(field.astype(np.float32) + noise, 0, 255).astype(np.uint8)


def _paste(img: np.ndarray, patch: np.ndarray, msk: np.ndarray, x: int,
           y: int) -> None:
    sel = msk > 0
    img[y:y + msk.shape[0], x:x + msk.shape[1]][sel] = patch[sel]


def make_hard_dataset(rng: np.random.Generator, classes: int = 4,
                      per_class: int = 8,
                      size_range: Tuple[int, int] = (32, 88)):
    """The object sources: one instance per 192x256 clutter field,
    ``per_class`` instances per class with per-instance size, aspect,
    colour and period.  -> (crops [(h, w, 3) uint8], masks [(h, w) uint8],
    labels [int]): each source cut to its object's rect, as the JAX
    package's ``CropLibrary.from_samples`` reads it back."""
    if classes > len(CLASS_DEFS):
        raise ValueError(f"classes <= {len(CLASS_DEFS)} supported")
    crops, masks, labels = [], [], []
    H, W = SOURCE_HW
    for c in range(classes):
        shape, texture = CLASS_DEFS[c]
        for _ in range(per_class):
            img = _color_field(H, W, rng)
            h = int(rng.integers(size_range[0], size_range[1] + 1))
            w = int(rng.integers(size_range[0], size_range[1] + 1))
            x = int(rng.integers(0, W - w))
            y = int(rng.integers(0, H - h))
            patch, msk = render_object(shape, texture, h, w, rng)
            _paste(img, patch, msk, x, y)
            crops.append(img[y:y + h, x:x + w].copy())
            masks.append(msk)
            labels.append(c)
    return crops, masks, labels


def make_hard_backgrounds(rng: np.random.Generator, classes: int = 4,
                          n: int = 10,
                          size_hw: Tuple[int, int] = BACKGROUND_HW,
                          distractors: Tuple[int, int] = (3, 7)
                          ) -> np.ndarray:
    """(n, H, W, 3) uint8 cluttered backgrounds: colour field + unlabeled
    mismatched shape/texture distractors (hard negatives)."""
    defs = distractor_defs(classes)
    H, W = size_hw
    out = np.empty((n, H, W, 3), np.uint8)
    for i in range(n):
        img = _color_field(H, W, rng)
        for _ in range(int(rng.integers(distractors[0],
                                        distractors[1] + 1))):
            shape, texture = defs[int(rng.integers(0, len(defs)))]
            h = int(rng.integers(28, 90))
            w = int(rng.integers(28, 90))
            x = int(rng.integers(0, W - w))
            y = int(rng.integers(0, H - h))
            patch, msk = render_object(shape, texture, h, w, rng)
            _paste(img, patch, msk, x, y)
        out[i] = img
    return out


def hard_data_config(batch_size: int = 16) -> DataConfig:
    """The hardness knobs: 2-5 pastes per scene, occlusion allowed up to
    scaled IoU 0.30, 0.7-1.8x paste rescale."""
    return DataConfig(batch_size=batch_size, num_compose=(2, 5),
                      compose_iou_thresh=0.30, scale_range=(0.7, 1.8))


@dataclasses.dataclass
class HardSources:
    """The rendered sources: crops zero-padded to the largest (K, Hc, Wc,
    3) uint8 with masks (K, Hc, Wc) bool, their (h, w) sizes and labels,
    and the backgrounds (N, 384, 512, 3) uint8."""

    crops: np.ndarray
    masks: np.ndarray
    sizes: np.ndarray
    labels: np.ndarray
    backgrounds: np.ndarray

    @classmethod
    def from_lists(cls, crops, masks, labels, backgrounds) -> "HardSources":
        hc = max(c.shape[0] for c in crops)
        wc = max(c.shape[1] for c in crops)
        padded = np.zeros((len(crops), hc, wc, 3), np.uint8)
        pmasks = np.zeros((len(crops), hc, wc), bool)
        sizes = np.zeros((len(crops), 2), np.int64)
        for i, (c, m) in enumerate(zip(crops, masks)):
            h, w = c.shape[:2]
            padded[i, :h, :w] = c
            pmasks[i, :h, :w] = m > 0
            sizes[i] = (h, w)
        return cls(padded, pmasks, sizes, np.asarray(labels, np.int64),
                   np.asarray(backgrounds, np.uint8))

    def library(self):
        """The crops as the compositor's ``CropLibrary`` (on the CPU)."""
        from torchfcn.data.device_compositor import CropLibrary
        return CropLibrary(torch.from_numpy(self.crops.astype(np.float32)),
                           torch.from_numpy(self.masks.astype(np.float32)),
                           torch.from_numpy(self.sizes),
                           torch.from_numpy(self.labels))

    def backgrounds_at(self, size_wh: Tuple[int, int]) -> np.ndarray:
        """(N, H, W, 3) float32 backgrounds at the net's size, resized as
        the JAX package's loader resizes them (``cv.resize``, bilinear)."""
        return np.stack([raster.resize_linear_u8(b, size_wh)
                         for b in self.backgrounds]).astype(np.float32)


def sources_cache_path(root: str, classes: int, dataset_seed: int) -> str:
    return os.path.join(root, f"hard_sources_c{classes}_seed{dataset_seed}"
                              f".npz")


def hard_sources(root: str, classes: int = 4,
                 dataset_seed: int = 7) -> HardSources:
    """Object sources + backgrounds, rendered once per ``root`` from
    ``dataset_seed`` (sources first, then backgrounds, from one generator)
    and reused from the ``.npz`` cache."""
    path = sources_cache_path(root, classes, dataset_seed)
    if os.path.isfile(path):
        with np.load(path, allow_pickle=False) as z:
            return HardSources(**{f.name: z[f.name]
                                  for f in dataclasses.fields(HardSources)})
    rng = np.random.default_rng(dataset_seed)
    crops, masks, labels = make_hard_dataset(rng, classes=classes)
    backgrounds = make_hard_backgrounds(rng, classes=classes)
    src = HardSources.from_lists(crops, masks, labels, backgrounds)
    os.makedirs(root, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp.npz"
    np.savez(tmp, **dataclasses.asdict(src))
    os.replace(tmp, path)        # no reader sees a half-written file
    return src


def hard_device_pipeline(root: str, grid: GridConfig, batch_size: int = 16,
                         seed: int = 1, classes: int = 4,
                         dataset_seed: int = 7, device="cuda"):
    """The device compositor over the hard sources (``hard_data_config``,
    ``BOX_CAPACITY`` boxes a scene), its generator seeded with ``seed`` on
    ``device`` ("cuda", which raises without CUDA, or "cpu")."""
    from torchfcn.data.device_compositor import DeviceCompositePipeline
    src = hard_sources(root, classes, dataset_seed)
    return DeviceCompositePipeline(
        src.library(), src.backgrounds_at((grid.im_width, grid.im_height)),
        grid, hard_data_config(batch_size), box_capacity=BOX_CAPACITY,
        seed=seed, device=device)


def eval_cache_path(root: str, grid: GridConfig, classes: int,
                    n_images: int, seed: int = 99) -> str:
    """Where the held-out set of ``build_eval_set`` is cached (the gate
    scheduler probes it to decide whether a gate unit pays first-touch
    costs).  The name says "device": the set is composed by the device
    compositor, not the JAX package's host one, whose sets differ."""
    return os.path.join(
        root, f"hard_eval_device_{grid.im_height}x{grid.im_width}"
              f"_s{grid.stride}_c{classes}_n{n_images}_seed{seed}.npz")


def build_eval_set(root: str, grid: GridConfig, classes: int = 4,
                   n_images: int = 128, seed: int = 99, chunk: int = 32,
                   device="cuda"):
    """Fixed held-out set: scenes composed on ``device`` from draws of a
    CPU generator seeded with ``seed`` (so the card and the CPU compose the
    same set, up to pixels on a mask's threshold), cached at
    ``eval_cache_path``.  Returns (images (N, H, W, 3) uint8, gts [per
    image (corners float32, labels int32)], segs (N, H, W) int32)."""
    cache = eval_cache_path(root, grid, classes, n_images, seed)
    if os.path.isfile(cache):
        with np.load(cache, allow_pickle=False) as z:
            gts = [(z[f"gt_c{i}"], z[f"gt_l{i}"]) for i in range(n_images)]
            return z["images"], gts, z["segs"]
    pipe = hard_device_pipeline(root, grid, batch_size=chunk, seed=seed,
                                classes=classes, device=device)
    pipe.generator = torch.Generator().manual_seed(seed)
    images, segs, gts = [], [], []
    for i in range(0, n_images, chunk):
        b = pipe.compose(pipe.draw(min(chunk, n_images - i)).to(pipe.device))
        b = {k: v.cpu().numpy() for k, v in b.items()}
        images.append(b["image"])
        segs.append(b["seg"])
        for r, lab, v in zip(b["rects"], b["labels"], b["valid"]):
            r = r[v]
            gts.append((np.concatenate([r[:, :2], r[:, :2] + r[:, 2:4]],
                                       axis=1), lab[v]))
    images, segs = np.concatenate(images), np.concatenate(segs)
    os.makedirs(root, exist_ok=True)
    tmp = f"{cache}.{os.getpid()}.tmp.npz"
    np.savez(tmp, images=images, segs=segs,
             **{f"gt_c{i}": g[0] for i, g in enumerate(gts)},
             **{f"gt_l{i}": g[1] for i, g in enumerate(gts)})
    os.replace(tmp, cache)
    return images, gts, segs
