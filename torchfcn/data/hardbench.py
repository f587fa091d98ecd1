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

Scenes are composed on the host (``hard_pipeline``: the port's
``CompositeTrainPipeline`` reading the sources from memory under the JAX
package's file names, so that one seed composes the JAX package's scenes)
or on the device (``hard_device_pipeline``).  The held-out set
(``build_eval_set``) is the JAX package's: host scenes, under its cache
name.  ``build_device_eval_set`` composes one on the device from draws of a
CPU generator, so that the card and the CPU compose the same set.
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
    colour and period.  -> (images [(192, 256, 3) uint8], masks [(192, 256)
    uint8], rects [(x, y, w, h)], labels [int]): what the JAX package
    writes as PNGs and lists as samples."""
    if classes > len(CLASS_DEFS):
        raise ValueError(f"classes <= {len(CLASS_DEFS)} supported")
    images, masks, rects, labels = [], [], [], []
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
            mask = np.zeros((H, W), np.uint8)
            mask[y:y + h, x:x + w] = msk
            images.append(img)
            masks.append(mask)
            rects.append((x, y, w, h))
            labels.append(c)
    return images, masks, rects, labels


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
    """The rendered sources: the object sources (K, 192, 256, 3) uint8 with
    their masks (K, 192, 256) uint8, rects (K, 4) and labels; the same
    cut to their rects, crops zero-padded to the largest (K, Hc, Wc, 3)
    uint8 with masks (K, Hc, Wc) bool and their (h, w) sizes; and the
    backgrounds (N, 384, 512, 3) uint8."""

    sources: np.ndarray
    source_masks: np.ndarray
    rects: np.ndarray
    crops: np.ndarray
    masks: np.ndarray
    sizes: np.ndarray
    labels: np.ndarray
    backgrounds: np.ndarray

    @classmethod
    def from_lists(cls, images, masks, rects, labels,
                   backgrounds) -> "HardSources":
        hc = max(r[3] for r in rects)
        wc = max(r[2] for r in rects)
        padded = np.zeros((len(images), hc, wc, 3), np.uint8)
        pmasks = np.zeros((len(images), hc, wc), bool)
        sizes = np.zeros((len(images), 2), np.int64)
        for i, (img, m, (x, y, w, h)) in enumerate(zip(images, masks, rects)):
            padded[i, :h, :w] = img[y:y + h, x:x + w]
            pmasks[i, :h, :w] = m[y:y + h, x:x + w] > 0
            sizes[i] = (h, w)
        return cls(np.stack(images), np.stack(masks),
                   np.asarray(rects, np.int64), padded, pmasks, sizes,
                   np.asarray(labels, np.int64),
                   np.asarray(backgrounds, np.uint8))

    def names(self):
        """(the object sources as ``MaskSample``s, the backgrounds' names):
        the JAX package's file names, which ``imread`` reads from memory."""
        from torchfcn.data.manifest import MaskSample
        samples, seen = [], np.zeros(len(CLASS_DEFS), np.int64)
        for rect, c in zip(self.rects, self.labels):
            stem = f"hard_c{c}_{seen[c]:02d}"
            seen[c] += 1
            samples.append(MaskSample(f"{stem}.png", f"{stem}_mask.png",
                                      int(c), rect.astype(np.int32)))
        return samples, [f"hard_bg{i:02d}.png"
                         for i in range(len(self.backgrounds))]

    def imread(self, name: str) -> np.ndarray:
        """The array that the JAX package writes as the PNG ``name`` (masks
        as one channel)."""
        stem = name[:-len(".png")]
        if stem.startswith("hard_bg"):
            return self.backgrounds[int(stem[len("hard_bg"):])]
        c, k = stem[len("hard_c"):].split("_")[:2]
        i = int(np.flatnonzero(self.labels == int(c))[int(k)])
        return (self.source_masks if stem.endswith("_mask")
                else self.sources)[i]

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
                              f"_v2.npz")


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
    images, masks, rects, labels = make_hard_dataset(rng, classes=classes)
    backgrounds = make_hard_backgrounds(rng, classes=classes)
    src = HardSources.from_lists(images, masks, rects, labels, backgrounds)
    os.makedirs(root, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp.npz"
    np.savez(tmp, **dataclasses.asdict(src))
    os.replace(tmp, path)        # no reader sees a half-written file
    return src


def hard_pipeline(root: str, grid: GridConfig, batch_size: int = 16,
                  seed: int = 1, classes: int = 4, dataset_seed: int = 7):
    """The host compositor over the hard sources (``hard_data_config``,
    ``BOX_CAPACITY`` boxes a scene): the JAX package's ``hard_pipeline``,
    the sources read from memory."""
    from torchfcn.data.pipeline import CompositeTrainPipeline
    src = hard_sources(root, classes, dataset_seed)
    samples, backgrounds = src.names()
    return CompositeTrainPipeline(
        samples, grid, hard_data_config(batch_size), backgrounds=backgrounds,
        box_capacity=BOX_CAPACITY, imread=src.imread, seed=seed)


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
    """Where the held-out set of ``build_eval_set`` is cached, under the JAX
    package's name (the gate scheduler probes it to decide whether a gate
    unit pays first-touch costs)."""
    return os.path.join(
        root, f"hard_eval_{grid.im_height}x{grid.im_width}_s{grid.stride}"
              f"_c{classes}_n{n_images}_seed{seed}.npz")


def device_eval_cache_path(root: str, grid: GridConfig, classes: int,
                           n_images: int, seed: int = 99) -> str:
    """Where the held-out set of ``build_device_eval_set`` is cached."""
    return os.path.join(
        root, f"hard_eval_device_{grid.im_height}x{grid.im_width}"
              f"_s{grid.stride}_c{classes}_n{n_images}_seed{seed}.npz")


def _gts(rects, labels, valid) -> list:
    """Per image (corners float32 (M, 4), labels int32 (M,)) of its valid
    boxes."""
    return [(np.concatenate([r[v][:, :2], r[v][:, :2] + r[v][:, 2:4]],
                            axis=1), lab[v])
            for r, lab, v in zip(rects, labels, valid)]


def _load_eval_set(cache: str, n_images: int):
    with np.load(cache, allow_pickle=False) as z:
        gts = [(z[f"gt_c{i}"], z[f"gt_l{i}"]) for i in range(n_images)]
        return z["images"], gts, z["segs"]


def _save_eval_set(cache: str, images, gts, segs) -> None:
    os.makedirs(os.path.dirname(cache), exist_ok=True)
    tmp = f"{cache}.{os.getpid()}.tmp.npz"
    np.savez(tmp, images=images, segs=segs,
             **{f"gt_c{i}": g[0] for i, g in enumerate(gts)},
             **{f"gt_l{i}": g[1] for i, g in enumerate(gts)})
    os.replace(tmp, cache)       # no reader sees a half-written file


def build_eval_set(root: str, grid: GridConfig, classes: int = 4,
                   n_images: int = 128, seed: int = 99, chunk: int = 32):
    """The fixed held-out set of the JAX package: ``n_images`` scenes of
    ``hard_pipeline(seed=seed)`` (composed in batches of up to ``chunk``),
    cached at ``eval_cache_path``.  Returns (images (N, H, W, 3) uint8, gts
    [per image (corners float32, labels int32)], segs (N, H, W) int32)."""
    cache = eval_cache_path(root, grid, classes, n_images, seed)
    if os.path.isfile(cache):
        return _load_eval_set(cache, n_images)
    pipe = hard_pipeline(root, grid, batch_size=chunk, seed=seed,
                         classes=classes)
    images, segs, gts = [], [], []
    for i in range(0, n_images, chunk):
        b = pipe.batch(min(chunk, n_images - i))
        images.append(b["image"])
        segs.append(b["seg"])
        gts += _gts(b["rects"], b["labels"], b["valid"])
    images, segs = np.concatenate(images), np.concatenate(segs)
    _save_eval_set(cache, images, gts, segs)
    return images, gts, segs


def build_device_eval_set(root: str, grid: GridConfig, classes: int = 4,
                          n_images: int = 128, seed: int = 99,
                          chunk: int = 32, device="cuda"):
    """A fixed held-out set composed on ``device`` from draws of a CPU
    generator seeded with ``seed`` (so the card and the CPU compose the
    same set, up to pixels on a mask's threshold), cached at
    ``device_eval_cache_path``; returns what ``build_eval_set`` does."""
    cache = device_eval_cache_path(root, grid, classes, n_images, seed)
    if os.path.isfile(cache):
        return _load_eval_set(cache, n_images)
    pipe = hard_device_pipeline(root, grid, batch_size=chunk, seed=seed,
                                classes=classes, device=device)
    pipe.generator = torch.Generator().manual_seed(seed)
    images, segs, gts = [], [], []
    for i in range(0, n_images, chunk):
        b = pipe.compose(pipe.draw(min(chunk, n_images - i)).to(pipe.device))
        b = {k: v.cpu().numpy() for k, v in b.items()}
        images.append(b["image"])
        segs.append(b["seg"])
        gts += _gts(b["rects"], b["labels"], b["valid"])
    images, segs = np.concatenate(images), np.concatenate(segs)
    _save_eval_set(cache, images, gts, segs)
    return images, gts, segs
