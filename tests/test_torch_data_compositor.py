"""torchfcn's device compositor (``torchfcn/data/device_compositor.py``)
against tpufcn's on the same draws, on the CPU at 64x64, T = 16, S = 3,
crops of 12-20 px.

tpufcn draws inside its functions from keys.  Its draws are recorded by
running a stage under ``jax.disable_jit()`` with ``jax.random.randint``,
``uniform`` and ``bernoulli`` wrapped (the stages import ``jax.random`` in
their bodies): integers and coins as drawn, uniforms as their unit draw,
and the value handed back to tpufcn is that unit draw mapped to its range
with the multiply-add rounded once, as the jitted program computes it.  The
recorded values then go to the port as a ``SceneDraws``.

Tolerances:
* ``scale_translate_weights`` equals jitted ``compute_weight_mat`` bit for
  bit; a render is within RENDER_ATOL (0..255 scale) of tpufcn's jitted
  ``_render`` (both sum float32 products, in other orders);
* a stage run under ``disable_jit`` rounds its sample positions once more
  than the port (which follows the jitted program): float images within
  STAGE_ATOL, and seg equal except at pixels whose rendered mask lies within
  MASK_TOL of 0.5 (``mask_margin``), where the threshold may flip; the
  image is then compared away from those pixels only;
* rects, labels and valid flags are exact everywhere;
* against tpufcn's jitted pipeline on the same draws, uint8 images differ
  by at most 1 level (a float image within rounding of .5) at no more than
  IMAGE_FLIP_SHARE of the pixels, seg equal except within MASK_TOL.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax import random
from jax._src.image.scale import _fill_triangle_kernel, compute_weight_mat

import tpufcn.data.device_compositor as J
from tpufcn.core.config import DataConfig as JDataConfig
from tpufcn.core.config import GridConfig as JGridConfig
from tpufcn.data.compositor import _scaled_iou
from tpufcn.data.manifest import MaskSample as JMaskSample
from torchfcn.core.config import DataConfig, GridConfig
from torchfcn.core.mesh import Mesh
from torchfcn.data import device_compositor as P
from torchfcn.data.manifest import MaskSample
from torchfcn.ops.image import scale_translate_weights

torch.set_num_threads(2)

HW, S, T = 64, 3, 16
RENDER_ATOL = 2e-3
STAGE_ATOL = 2e-2
MASK_TOL = 1e-4
IMAGE_FLIP_SHARE = 1e-3
KW = dict(H=HW, W=HW, iou_thresh=0.05, scale_range=(1.0, 2.2),
          n_range=(1, 3))
GRID = GridConfig(HW, HW, 8, 3)
CFG = DataConfig(batch_size=8, compose_max_trials=T)


def _crops(rng, n=6, classes=3):
    """Crops of 12-20 px with box masks and formula ellipses."""
    imgs, masks, labels = [], [], []
    for i in range(n):
        h, w = int(rng.integers(12, 21)), int(rng.integers(12, 21))
        imgs.append(rng.integers(0, 256, (h, w, 3)).astype(np.uint8))
        m = np.zeros((h, w), np.uint8)
        if i % 2:
            yy, xx = np.mgrid[0:h, 0:w]
            m[((yy - h / 2 + 0.5) / (h / 2)) ** 2
              + ((xx - w / 2 + 0.5) / (w / 2)) ** 2 <= 1] = 255
        else:
            m[1:h - 1, 2:w - 1] = 255
        masks.append(m)
        labels.append(i % classes)
    return imgs, masks, labels


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    imgs, masks, labels = _crops(rng)
    bgs = rng.uniform(0, 255, (3, HW, HW, 3)).astype(np.float32)
    lib = P.CropLibrary.from_arrays(imgs, masks, labels)
    jlib = J.CropLibrary(
        images=jnp.asarray(lib.images.numpy()),
        masks=jnp.asarray(lib.masks.numpy()),
        sizes=jnp.asarray(lib.sizes.numpy().astype(np.int32)),
        labels=jnp.asarray(lib.labels.numpy().astype(np.int32)))
    return dict(imgs=imgs, masks=masks, labels=labels, bgs=bgs, lib=lib,
                jlib=jlib)


class Recorder:
    """jax.random.randint / uniform / bernoulli wrapped to record draws."""

    def __init__(self, monkeypatch):
        self.log = []
        ou, oi, ob = jax.random.uniform, jax.random.randint, \
            jax.random.bernoulli

        def uniform(key, shape=(), dtype=jnp.float32, minval=0.0,
                    maxval=1.0):
            u = np.asarray(ou(key, shape, dtype, 0.0, 1.0))
            lo = np.float32(minval)
            span = np.float32(np.float32(np.asarray(maxval)) - lo)
            v = np.maximum(lo, (u.astype(np.float64) * np.float64(span)
                                + np.float64(lo)).astype(np.float32))
            self.log.append(u)
            return jnp.asarray(v)

        def record(fn):
            def wrapped(*a, **k):
                r = fn(*a, **k)
                self.log.append(np.asarray(r))
                return r
            return wrapped

        monkeypatch.setattr(jax.random, "uniform", uniform)
        monkeypatch.setattr(jax.random, "randint", record(oi))
        monkeypatch.setattr(jax.random, "bernoulli", record(ob))

    def take(self, *names):
        out = dict(zip(names, self.log[:len(names)]))
        del self.log[:len(names)]
        return out


SCENE = ("background", "u_zoom", "u_oy", "u_ox", "n_paste")
SLOT = ("crop", "flip", "rescale", "u_scale", "cx", "cy")
ZOOM = ("u_e1", "u_e2", "u_cx", "u_cy")
PHOTO = ("blur_kind", "u_sigma", "box_width", "odd_half", "u_alpha",
         "u_light", "u_add", "add_per_channel", "u_mul", "mul_per_channel",
         "u_gray")


def _scene_fields(rec):
    d = rec.take(*SCENE)
    slots = [rec.take(*SLOT) for _ in range(S)]
    d.update({f: np.stack([s[f] for s in slots]) for f in SLOT})
    return d


def _draws(per_scene):
    """SceneDraws from per-scene dicts of recorded values (missing fields
    zero: the stage under test does not read them)."""
    out = {}
    for f in (SCENE + SLOT + ("scene_flip",) + ZOOM + PHOTO):
        if f not in per_scene[0]:
            continue
        v = np.stack([p[f] for p in per_scene])
        t = torch.from_numpy(np.ascontiguousarray(v))
        out[f] = t.long() if t.dtype == torch.int32 else t
    n = len(per_scene)
    for field in P.SceneDraws.__dataclass_fields__:
        out.setdefault(field, torch.zeros(n, dtype=torch.long))
    return P.SceneDraws(**out)


def _split(key, n=8):
    return [random.split(k, 4) for k in random.split(random.key(key), n)]


# (a) the render ------------------------------------------------------------

@pytest.mark.parametrize("in_size,out_size", [(20, 64), (64, 64), (17, 48)])
def test_scale_translate_weights_equal_jax(in_size, out_size):
    rng = np.random.default_rng(in_size)
    sc = rng.uniform(0.5, 2.2, 200).astype(np.float32)
    tr = rng.uniform(-80, 80, 200).astype(np.float32)   # off the canvas too
    f = jax.jit(jax.vmap(lambda s, t: compute_weight_mat(
        in_size, out_size, s, t, _fill_triangle_kernel, False)))
    want = np.asarray(f(sc, tr))
    got = scale_translate_weights(in_size, out_size, torch.from_numpy(sc),
                                  torch.from_numpy(tr)).numpy()
    assert np.array_equal(got, want)
    assert (want.sum(axis=1) == 0).any()       # some samples off the input


def test_render_matches_jax(data):
    rng = np.random.default_rng(1)
    img = data["lib"].images[:4].numpy()
    sy, sx = (rng.uniform(0.5, 2.2, 4).astype(np.float32) for _ in range(2))
    ty, tx = (rng.uniform(-30, 60, 4).astype(np.float32) for _ in range(2))
    f = jax.jit(jax.vmap(lambda im, a, b, c, d: J._render(
        im, (HW, HW), a, b, c, d, 3)))
    want = np.asarray(f(img, sy, sx, ty, tx))
    got = P._render(torch.from_numpy(img), (HW, HW),
                    *(torch.from_numpy(v) for v in (sy, sx, ty, tx)))
    assert (want == 0).all(axis=-1).any() and want.max() > 100
    np.testing.assert_allclose(got.numpy(), want, atol=RENDER_ATOL, rtol=0)


# (b) each stage on the same draws ------------------------------------------

def test_scaled_iou_grid_equals_jax():
    rng = np.random.default_rng(2)
    placed = np.concatenate([rng.uniform(0, 50, (4, S, 2)),
                             rng.uniform(5, 30, (4, S, 2))], -1)
    placed = placed.astype(np.float32)
    pvalid = rng.random((4, S)) < 0.7
    cx, cy = (rng.integers(0, HW, (4, T)).astype(np.float32)
              for _ in range(2))
    w, h = (rng.integers(5, 40, 4).astype(np.float32) for _ in range(2))
    got = P._scaled_iou_grid(*(torch.from_numpy(v) for v in
                               (placed, pvalid, cx, cy, w, h))).numpy()
    for b in range(4):
        want = np.asarray(J._scaled_iou_grid(placed[b], pvalid[b], cx[b],
                                             cy[b], w[b], h[b]))
        assert np.array_equal(got[b], want)
    assert (got > 0).any()


@pytest.mark.parametrize("fc", [-1, 0, 1, 2])
def test_flip_crop_equals_jax(data, fc):
    lib = data["lib"]
    crops = torch.cat([lib.images, lib.masks[..., None]], -1)
    k = len(crops)
    got = P._flip_crop(crops, lib.sizes[:, 0], lib.sizes[:, 1],
                       torch.full((k,), fc)).numpy()
    for i in range(k):
        h, w = (int(v) for v in lib.sizes[i])
        ci, mi = J._flip_crop(lib.images[i].numpy(), lib.masks[i].numpy(),
                              h, w, fc)
        assert np.array_equal(got[i, ..., :3], np.asarray(ci))
        assert np.array_equal(got[i, ..., 3], np.asarray(mi))


def _compose_recorded(monkeypatch, data, keys):
    """tpufcn's _compose_scene per scene under disable_jit with recorded
    draws -> (its outputs stacked, the port's SceneDraws)."""
    rec = Recorder(monkeypatch)
    outs, per = [], []
    with jax.disable_jit():
        for k1, _, _, _ in keys:
            outs.append([np.asarray(v) for v in J._compose_scene(
                k1, jnp.asarray(data["bgs"]), data["jlib"], S=S, T=T,
                **KW)])
            per.append(_scene_fields(rec))
    return [np.stack(v) for v in zip(*outs)], _draws(per)


def _port_scene(data, d):
    lib = data["lib"]
    crops = torch.cat([lib.images, lib.masks[..., None]], -1)
    return P._compose_scene(d, torch.from_numpy(data["bgs"]), lib, crops,
                            H=HW, W=HW, S=S, iou_thresh=0.05,
                            scale_range=(1.0, 2.2), margin=True)


def _check_seg(got, want, near, what):
    bad = got != want
    assert (near[bad] < MASK_TOL).all(), what
    return bad


def test_compose_scene_matches_jax(monkeypatch, data):
    (img, seg, rects, labels, valid), d = _compose_recorded(
        monkeypatch, data, _split(5, n=5))
    g_img, g_seg, g_rects, g_labels, g_valid, near = _port_scene(data, d)
    assert np.array_equal(g_rects.numpy(), rects)
    assert np.array_equal(g_labels.numpy(), labels)
    assert np.array_equal(g_valid.numpy(), valid)
    assert valid.sum() > 5 and (~valid).any()
    bad = _check_seg(g_seg.numpy(), seg, near.numpy(), "seg")
    keep = ~bad & (near.numpy() >= MASK_TOL)
    np.testing.assert_allclose(g_img.numpy()[keep], img[keep],
                               atol=STAGE_ATOL, rtol=0)


def test_scene_flip_equals_jax(monkeypatch, data):
    rng = np.random.default_rng(3)
    img = rng.uniform(0, 255, (8, HW, HW, 3)).astype(np.float32)
    seg = rng.integers(0, 4, (8, HW, HW)).astype(np.int32)
    rects = rng.uniform(0, 40, (8, S, 4)).astype(np.float32)
    rec = Recorder(monkeypatch)
    want = []
    with jax.disable_jit():
        for i, (_, k2, _, _) in enumerate(_split(6)):
            want.append([np.asarray(v) for v in J._scene_flip(
                k2, img[i], seg[i], rects[i], H=HW, W=HW)])
    fc = torch.from_numpy(np.stack(rec.log)).long()
    assert set(fc.tolist()) == {-1, 0, 1, 2}
    got = P._scene_flip(fc, *(torch.from_numpy(v) for v in (img, seg, rects)),
                        H=HW, W=HW)
    for g, w in zip(got[:3], zip(*want)):
        assert np.array_equal(g.numpy(), np.stack(w))


def test_zoom_crop_matches_jax(monkeypatch, data):
    """The zoom on composed scenes, single- and multi-box."""
    (img, seg, rects, _, valid), d = _compose_recorded(
        monkeypatch, data, _split(7))
    rec = Recorder(monkeypatch)
    want, per = [], []
    with jax.disable_jit():
        for i, (_, _, k3, _) in enumerate(_split(7)):
            want.append([np.asarray(v) for v in J._zoom_crop(
                k3, *(jnp.asarray(v[i]) for v in (img, seg, rects, valid)),
                H=HW, W=HW)])
            per.append(rec.take(*ZOOM))
    zd = _draws(per)
    near = np.full(seg.shape, np.inf, np.float32)
    g_img, g_seg, g_rects, g_near = P._zoom_crop(
        zd, *(torch.from_numpy(v) for v in (img, seg, rects, valid)),
        H=HW, W=HW, near=torch.from_numpy(near))
    w_img, w_seg, w_rects = (np.stack(v) for v in zip(*want))
    single = valid.sum(1) == 1
    assert single.any() and not single.all()
    assert np.array_equal(g_rects.numpy(), w_rects)
    bad = _check_seg(g_seg.numpy(), w_seg, g_near.numpy(), "zoom seg")
    assert bad.sum() <= 2
    np.testing.assert_allclose(g_img.numpy(), w_img, atol=STAGE_ATOL, rtol=0)


def test_sepconv_matches_jax():
    rng = np.random.default_rng(8)
    img = rng.uniform(0, 255, (3, HW, HW, 3)).astype(np.float32)
    k = rng.uniform(0, 1, (3, 19)).astype(np.float32)
    k /= k.sum(1, keepdims=True)
    got = P._sepconv(torch.from_numpy(img), torch.from_numpy(k)).numpy()
    for b in range(3):
        want = np.asarray(jax.jit(J._sepconv)(img[b], k[b]))
        np.testing.assert_allclose(got[b], want, atol=RENDER_ATOL, rtol=0)


def test_photometric_matches_jax(monkeypatch):
    rng = np.random.default_rng(9)
    img = rng.uniform(0, 255, (8, HW, HW, 3)).astype(np.float32)
    rec = Recorder(monkeypatch)
    want, per = [], []
    with jax.disable_jit():
        for i, (_, _, _, k4) in enumerate(_split(10)):
            want.append(np.asarray(J._photometric(k4, img[i])))
            per.append(rec.take(*PHOTO))
    d = _draws(per)
    assert set(d.blur_kind.tolist()) == {0, 1, 2}
    got = P._photometric(d, torch.from_numpy(img),
                         torch.tensor(P.GRAY_BGR)).numpy()
    np.testing.assert_allclose(got, np.stack(want), atol=STAGE_ATOL, rtol=0)


def test_pipeline_matches_jitted_jax(monkeypatch, data):
    """The whole batch against tpufcn's jitted pipeline on its own key
    stream: the port composes the draws recorded from the same keys."""
    samples, store = [], {}
    for i, (im, m, l) in enumerate(zip(data["imgs"], data["masks"],
                                       data["labels"])):
        store[f"i{i}"], store[f"m{i}"] = im, m
        samples.append(JMaskSample(f"i{i}", f"m{i}", l,
                                   np.array([0, 0, im.shape[1],
                                             im.shape[0]])))
    jpipe = J.DeviceCompositePipeline(
        samples, JGridConfig(HW, HW, 8, 3),
        JDataConfig(batch_size=8, compose_max_trials=T), imread=store.get,
        seed=3)
    jpipe._bgs = jnp.asarray(data["bgs"])
    _, key = random.split(jpipe._key)
    want = {k: np.asarray(v) for k, v in jpipe.batch(8).items()}
    rec = Recorder(monkeypatch)
    per = []
    bgs = jnp.asarray(data["bgs"])
    with jax.disable_jit():
        for k in random.split(key, 8):
            k1, k2, k3, k4 = random.split(k, 4)
            img, seg, rects, labels, valid = J._compose_scene(
                k1, bgs, jpipe.lib, S=S, T=T, **KW)
            img, seg, rects = J._scene_flip(k2, img, seg, rects, H=HW, W=HW)
            img, seg, rects = J._zoom_crop(k3, img, seg, rects, valid,
                                           H=HW, W=HW)
            J._photometric(k4, img)
            d = _scene_fields(rec)
            d.update(rec.take("scene_flip", *ZOOM, *PHOTO))
            per.append(d)
    pipe = P.DeviceCompositePipeline(data["lib"], data["bgs"], GRID, CFG,
                                     device="cpu")
    got = pipe.compose(_draws(per), checks=True)
    for k in ("rects", "labels", "valid"):
        assert np.array_equal(got[k].numpy(), want[k]), k
    assert got["image"].dtype == torch.uint8
    diff = np.abs(got["image"].numpy().astype(int) - want["image"])
    assert diff.max() <= 1 and (diff > 0).mean() <= IMAGE_FLIP_SHARE
    _check_seg(got["seg"].numpy(), want["seg"],
               got["mask_margin"].numpy(), "pipeline seg")


# (c) the pipeline's invariants ---------------------------------------------

def _pipe(data, seed, **kw):
    return P.DeviceCompositePipeline(data["lib"], data["bgs"], GRID, CFG,
                                     seed=seed, device="cpu", **kw)


def test_batch_contract_and_determinism(data):
    b = _pipe(data, 3).batch(8)
    assert b["image"].shape == (8, HW, HW, 3)
    assert b["image"].dtype == torch.uint8
    assert b["seg"].shape == (8, HW, HW) and b["seg"].dtype == torch.int32
    assert b["rects"].shape == (8, 8, 4) and b["labels"].dtype == torch.int32
    valid = b["valid"].numpy()
    assert valid.sum(1).min() >= 1
    for r in b["rects"].numpy()[valid]:
        assert r[0] >= 0 and r[1] >= 0
        assert r[0] + r[2] <= HW + 1e-3 and r[1] + r[3] <= HW + 1e-3
    again = _pipe(data, 3)
    assert torch.equal(again.batch(8)["image"], b["image"])
    assert not torch.equal(again.batch(8)["image"], b["image"])


def _rects_bound_seg(b, tol):
    seg, rects, valid = (b[k].numpy() for k in ("seg", "rects", "valid"))
    for i in range(len(seg)):
        vr = rects[i][valid[i]]
        for yy, xx in zip(*np.nonzero(seg[i])):
            assert any(r[0] - tol <= xx <= r[0] + r[2] + tol
                       and r[1] - tol <= yy <= r[1] + r[3] + tol
                       for r in vr), (i, xx, yy, vr)


def test_mask_rect_alignment_and_iou_constraint(data):
    b = _pipe(data, 5, scene_flip=False, zoom=False,
              photometric=False).batch(8)
    _rects_bound_seg(b, 2)
    seg, rects, valid, labels = (b[k].numpy() for k in
                                 ("seg", "rects", "valid", "labels"))
    for i in range(8):
        vr, vl = rects[i][valid[i]], labels[i][valid[i]]
        for r, lab in zip(vr, vl):
            x0, y0, w, h = [int(v) for v in r]
            assert (seg[i, y0:y0 + h + 1, x0:x0 + w + 1] == lab + 1).any()
        for a in range(len(vr)):
            for c in range(a + 1, len(vr)):
                assert _scaled_iou(vr[a], vr[c]) <= 0.05 + 1e-6


def test_scene_transforms_keep_alignment(data):
    _rects_bound_seg(_pipe(data, 11).batch(8), 4)


def test_photometric_changes_pixels_in_range(data):
    kw = dict(scene_flip=False, zoom=False)
    plain = _pipe(data, 7, photometric=False, **kw).batch(2)["image"]
    jit_ = _pipe(data, 7, photometric=True, **kw).batch(2)["image"]
    assert not torch.equal(plain, jit_)


def test_refusals_and_loaders(data, tmp_path):
    with pytest.raises(ValueError, match="rotation"):
        P.DeviceCompositePipeline(data["lib"], data["bgs"], GRID,
                                  DataConfig(rotate=True), device="cpu")
    # a mesh is no longer refused: rank 3 of a (2, 2) mesh composes its
    # share of the global batch (its scenes and rows), the one-device
    # batch's, bit for bit
    mesh = Mesh(2, 2, 3, {"mesh": None, "data": None, "space": None}, "cpu")
    share, whole = _pipe(data, 0, mesh=mesh).batch(4), _pipe(data, 0).batch(4)
    for key, value in whole.items():
        want = value[2:4, HW // 2:] if key in ("image", "seg") \
            else value[2:4]
        assert torch.equal(share[key], want), key
    with pytest.raises(ValueError, match="net's size"):
        P.DeviceCompositePipeline(data["lib"], data["bgs"][:, :32],
                                  GRID, CFG, device="cpu")
    with pytest.raises(ValueError, match="decoder"):
        P.CropLibrary.from_samples([MaskSample("a", "b", 0,
                                               np.array([0, 0, 4, 4]))])


def test_from_samples_equals_jax(data):
    """CropLibrary.from_samples with a decoder from the caller (3-channel
    masks through the port's BGR2GRAY) equals tpufcn's, which uses cv2;
    the backgrounds come through the caller's resize."""
    import cv2 as cv
    rng = np.random.default_rng(12)
    store, samples, jsamples = {}, [], []
    for i in range(4):
        img = rng.integers(0, 256, (40, 50, 3)).astype(np.uint8)
        mask = rng.integers(0, 3, (40, 50, 3)).astype(np.uint8) * 3
        store[f"i{i}"], store[f"m{i}"] = img, mask
        rect = np.array([i - 1, 3, 30 + i, 20 + 9 * i])
        samples.append(MaskSample(f"i{i}", f"m{i}", i % 2, rect))
        jsamples.append(JMaskSample(f"i{i}", f"m{i}", i % 2, rect))
    lib = P.CropLibrary.from_samples(samples, imread=store.get)
    jlib = J.CropLibrary.from_samples(jsamples, imread=store.get)
    for f in ("images", "masks", "sizes", "labels"):
        assert np.array_equal(getattr(lib, f).numpy(),
                              np.asarray(getattr(jlib, f))), f
    bgs = P.load_backgrounds(["i0", "i1"], (HW, HW), imread=store.get,
                             resize=cv.resize)
    want = J._load_backgrounds(["i0", "i1"], (HW, HW), imread=store.get)
    assert np.array_equal(bgs, want)


def test_mean_paste_count_matches_jax(data):
    """Mean valid boxes over 256 scenes from each package's own random
    stream, within PASTE_TOL (about 3 standard errors of the difference)."""
    paste_tol = 0.2
    samples, store = [], {}
    for i, (im, m, l) in enumerate(zip(data["imgs"], data["masks"],
                                       data["labels"])):
        store[f"i{i}"], store[f"m{i}"] = im, m
        samples.append(JMaskSample(f"i{i}", f"m{i}", l,
                                   np.array([0, 0, im.shape[1],
                                             im.shape[0]])))
    jpipe = J.DeviceCompositePipeline(
        samples, JGridConfig(HW, HW, 8, 3),
        JDataConfig(batch_size=256, compose_max_trials=T), imread=store.get,
        seed=1, scene_flip=False, zoom=False, photometric=False)
    want = float(np.asarray(jpipe.batch(256)["valid"]).sum(1).mean())
    got = float(_pipe(data, 1, scene_flip=False, zoom=False,
                      photometric=False).batch(256)["valid"].sum(1)
                .float().mean())
    assert 1.0 < want < 3.0
    assert abs(got - want) <= paste_tol, (got, want)
