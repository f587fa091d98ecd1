"""The port's accuracy gates (``torchfcn/train/gates.py``) and CLI
(``torchfcn/cli.py``) against tpufcn's.

* ``bench_gate_configs``: both tiers equal to tpufcn's, ``voc_fixture``
  entry included, but for the dtype objects (``torch``'s e5m2 for
  ``jnp``'s) and the estimates (the card's walls);
* the scheduler (``plan_gate_units``, ``_merge_family``,
  ``run_bench_gates`` budgets, passes and pretrain hand-over, the voc kind
  run once, ``warm_gate_caches``, ``_unit_cold``): tpufcn's scheduler
  tests (``tests/test_hardbench.py``) held by the port's module;
* ``_score_detector``: tpufcn's mAP and detection count on the same carried
  parameters and images (bf16 Detectors at max_candidates=128,
  vgg_detectnet_train with its grid at 64x64 on both sides, heads biased so
  that cells fire), exactly; the segmentation scoring: tpufcn's mIoU on
  the same parameters within SEG_ATOL (a bf16 argmax may flip at a
  near-tie);
* ``detection_gate`` and ``segmentation_gate`` end to end on the CPU at a
  few steps and 64x64: tpufcn's result keys, the same readings in two
  runs;
* the host data modes ("host_cached", the default, and "host") train a
  step on the CPU from tpufcn's scenes (the cached batch's boxes, labels
  and valid masks equal to tpufcn's cache, under its file name), and a
  second call reads the cache; a gate on ``device="cuda"`` without CUDA
  raises.
"""

import dataclasses
import json
import os
import time as time_mod

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import tpufcn.models
from tpufcn.core.config import GridConfig as JGridConfig
from tpufcn.serve import detector as jax_det
from tpufcn.train import evaluate as jev
from tpufcn.train import gates as jgates
from torchfcn import cli
from torchfcn.convert.from_jax import load_jax_params
from torchfcn.core.config import GridConfig
from torchfcn.serve import detector as port_det
from torchfcn.train import gates

torch.set_num_threads(2)

HW = 64
SEG_ATOL = 5e-3
EST_KEYS = ("est_s", "est_s0")


def _comparable(cfgs, e5m2):
    """Configs without estimates, the e5m2 dtype replaced by a tag."""
    out = {}
    for name, cfg in cfgs.items():
        cfg = {k: v for k, v in cfg.items() if k not in EST_KEYS}
        if "serving_kwargs" in cfg:
            cfg["serving_kwargs"] = {
                k: ("e5m2" if v is e5m2 else v)
                for k, v in cfg["serving_kwargs"].items()}
        out[name] = cfg
    return out


@pytest.mark.parametrize("tier", ["bench", "full"])
def test_bench_gate_configs_equal_jax_but_voc(tier):
    want = jgates.bench_gate_configs(tier)
    assert want["voc_fixture"]["kind"] == "voc"
    got = gates.bench_gate_configs(tier)
    assert list(got) == list(want)
    assert _comparable(got, torch.float8_e5m2) == \
        _comparable(want, jnp.float8_e5m2)
    for cfg in got.values():
        assert cfg["est_s"] > 0 and cfg["est_s0"] >= cfg["est_s"]


def test_run_bench_gates_budget_skip(tmp_path):
    sunk = []
    out = gates.run_bench_gates(root=str(tmp_path), log=lambda m: None,
                                deadline=time_mod.time() + 1.0,
                                sink=sunk.append, device="cpu")
    assert set(out) == set(gates.bench_gate_configs())
    for name, cfg in gates.bench_gate_configs().items():
        assert out[name] == {"skipped": "budget",
                             "est_s": cfg.get("est_s0", cfg["est_s"])}
    assert sunk == []


def test_plan_gate_units_breadth_first():
    cfgs = {"a": {"seeds": (0, 1)}, "b": {"seeds": (0,)},
            "voc": {}, "fcn8s": {"seeds": (0, 1, 2)}}
    units = gates.plan_gate_units(cfgs)
    assert units == jgates.plan_gate_units(cfgs)
    assert units[:4] == [("a", 0), ("b", 0), ("voc", 0), ("fcn8s", 0)]
    assert units[4:] == [("fcn8s", 1), ("a", 1), ("fcn8s", 2)]
    assert gates.SEED_APPEND_PRIORITY == jgates.SEED_APPEND_PRIORITY


def test_merge_family_per_seed():
    a = {"exact": {"mAP": 0.2, "min": 0.2, "max": 0.2, "per_seed": [0.2]},
         "fp8": {"mAP": 0.18, "min": 0.18, "max": 0.18, "per_seed": [0.18]},
         "seeds": [0], "n_gt": 50, "n_det": 40, "train_s": 10.0,
         "eval_s": 2.0, "wall_s": 12.0}
    b = {"exact": {"mAP": 0.4, "min": 0.4, "max": 0.4, "per_seed": [0.4]},
         "fp8": {"mAP": 0.38, "min": 0.38, "max": 0.38, "per_seed": [0.38]},
         "seeds": [1], "n_gt": 50, "n_det": 44, "train_s": 11.0,
         "eval_s": 2.0, "wall_s": 13.0}
    m = gates._merge_family(a, b)
    assert m == jgates._merge_family(a, b)
    assert m["exact"] == {"mAP": 0.3, "min": 0.2, "max": 0.4,
                          "per_seed": [0.2, 0.4]}
    assert m["seeds"] == [0, 1]
    assert m["n_det"] == 44 and m["train_s"] == 21.0 and m["wall_s"] == 25.0
    assert gates._merge_family({"skipped": "budget", "est_s": 9}, b) == b
    m = gates._merge_family(a, {"error": "RuntimeError: boom", "wall_s": 1})
    assert m["exact"]["per_seed"] == [0.2] and "error_later_seed" in m


def _clocked(monkeypatch):
    clock = [1_000_000.0]
    monkeypatch.setattr(time_mod, "time", lambda: clock[0])
    return clock


def _result(key, value, seeds):
    return {"exact": {key: value, "min": value, "max": value,
                      "per_seed": [value]}, "seeds": list(seeds)}


def test_run_bench_gates_unit_scheduler(monkeypatch, tmp_path):
    clock = _clocked(monkeypatch)
    cfgs = {
        "det2": dict(kind="detection", model="m", seeds=(0, 1), est_s=10),
        "seg1": dict(kind="segmentation", seeds=(0,), est_s=10),
        "pre": dict(kind="pretrain", classes=6, steps=4, est_s=10),
    }
    calls = []

    def fake_det(model, root, seeds, log, **kw):
        calls.append(("det", seeds))
        clock[0] += 10
        return _result("mAP", 0.5, seeds)

    def fake_seg(root, seeds, log, **kw):
        calls.append(("seg", seeds))
        clock[0] += 10
        return _result("mIoU", 0.8, seeds)

    def fake_pretrain(root, log, **kw):
        calls.append(("pre", None))
        clock[0] += 10
        return "/fake/backbone.caffemodel"

    import torchfcn.train.pretrain as pretrain_mod
    monkeypatch.setattr(gates, "bench_gate_configs",
                        lambda tier="bench": cfgs)
    monkeypatch.setattr(gates, "detection_gate", fake_det)
    monkeypatch.setattr(gates, "segmentation_gate", fake_seg)
    monkeypatch.setattr(pretrain_mod, "cached_vgg16_pretrain", fake_pretrain)
    monkeypatch.setattr(gates, "_unit_cold", lambda *a: False)

    out = gates.run_bench_gates(root=str(tmp_path), log=lambda m: None,
                                deadline=1_000_000.0 + 35)
    assert calls == [("det", (0,)), ("seg", (0,)), ("pre", None)]
    assert out["det2"]["exact"]["per_seed"] == [0.5]
    assert out["det2"]["seeds_skipped"] == 1
    assert out["seg1"]["exact"]["per_seed"] == [0.8]
    assert out["pre"]["path"] == "/fake/backbone.caffemodel"

    calls.clear()
    clock[0] = 1_000_000.0
    out = gates.run_bench_gates(root=str(tmp_path), log=lambda m: None,
                                deadline=1_000_000.0 + 1000)
    assert calls == [("det", (0,)), ("seg", (0,)), ("pre", None),
                     ("det", (1,))]
    assert out["det2"]["exact"]["per_seed"] == [0.5, 0.5]
    assert out["det2"]["seeds"] == [0, 1]

    calls.clear()
    clock[0] = 1_000_000.0
    p0 = gates.run_bench_gates(root=str(tmp_path), log=lambda m: None,
                               deadline=1_000_000.0 + 1000, passes=(0,))
    assert calls == [("det", (0,)), ("seg", (0,)), ("pre", None)]
    rest = gates.run_bench_gates(root=str(tmp_path), log=lambda m: None,
                                 deadline=1_000_000.0 + 1000,
                                 passes=range(1, 8), prior=p0)
    assert calls[-1] == ("det", (1,))
    assert rest["det2"]["exact"]["per_seed"] == [0.5, 0.5]


def test_run_bench_gates_adaptive_degradation(monkeypatch, tmp_path):
    clock = _clocked(monkeypatch)
    cfgs = {n: dict(kind="detection", model="m", seeds=(0,), est_s=10)
            for n in "abc"}

    def slow_det(model, root, seeds, log, **kw):
        clock[0] += 30          # 3x the estimate
        return _result("mAP", 0.5, seeds)

    monkeypatch.setattr(gates, "bench_gate_configs",
                        lambda tier="bench": cfgs)
    monkeypatch.setattr(gates, "detection_gate", slow_det)
    monkeypatch.setattr(gates, "_unit_cold", lambda *a: False)
    out = gates.run_bench_gates(root=str(tmp_path), log=lambda m: None,
                                deadline=1_000_000.0 + 70)
    assert "exact" in out["a"] and "exact" in out["b"]
    assert out["c"] == {"skipped": "budget", "est_s": 30}


def test_failed_unit_and_unported_kind_report_errors(monkeypatch, tmp_path):
    cfgs = {"host": dict(kind="host", est_s=1),
            "voc": dict(kind="voc", est_s=1, steps=7),
            "det": dict(kind="detection", model="m", seeds=(0, 1),
                        est_s=1)}
    voc_calls = []

    def broken(model, root, seeds, log, **kw):
        raise RuntimeError("boom")

    def voc(**kw):
        voc_calls.append(kw)
        return {"mAP": 0.25, "n_det": 3, "val_images": 96, "n_gt": 168}

    monkeypatch.setattr(gates, "bench_gate_configs",
                        lambda tier="bench": cfgs)
    monkeypatch.setattr(gates, "detection_gate", broken)
    monkeypatch.setattr(gates, "voc_fixture_gate", voc)
    monkeypatch.setattr(gates, "_unit_cold", lambda *a: False)
    out = gates.run_bench_gates(root=str(tmp_path), log=lambda m: None,
                                device="cpu")
    assert out["host"]["error"].startswith("NotImplementedError")
    assert out["det"]["error"] == "RuntimeError: boom"
    assert set(out["det"]) == {"error", "wall_s"}
    # the voc kind is one unit, given the entry's arguments and the device
    assert voc_calls == [{"steps": 7, "device": "cpu"}]
    assert out["voc"]["mAP"] == 0.25 and "wall_s" in out["voc"]


def test_pretrain_path_resolves_across_invocations(monkeypatch, tmp_path):
    clock = _clocked(monkeypatch)
    cfgs = {
        "pre": dict(kind="pretrain", classes=6, steps=4, est_s=1),
        "vgg": dict(kind="detection", model="m", seeds=(0, 1),
                    pretrain=True, est_s=1),
    }
    weights_seen = []

    def fake_det(model, root, seeds, log, weights=None, **kw):
        weights_seen.append(weights)
        clock[0] += 1
        return _result("mAP", 0.1, seeds)

    def fake_pretrain(root, log, **kw):
        clock[0] += 1
        return "/fake/backbone.caffemodel"

    import torchfcn.train.pretrain as pretrain_mod
    monkeypatch.setattr(gates, "bench_gate_configs",
                        lambda tier="bench": cfgs)
    monkeypatch.setattr(gates, "detection_gate", fake_det)
    monkeypatch.setattr(pretrain_mod, "cached_vgg16_pretrain", fake_pretrain)
    monkeypatch.setattr(gates, "_unit_cold", lambda *a: False)
    p0 = gates.run_bench_gates(root=str(tmp_path), log=lambda m: None,
                               deadline=1_000_000.0 + 100, passes=(0,))
    assert p0["pre"]["path"] == "/fake/backbone.caffemodel"
    assert p0["vgg"]["pretrained"] is True
    rest = gates.run_bench_gates(root=str(tmp_path), log=lambda m: None,
                                 deadline=1_000_000.0 + 100,
                                 passes=range(1, 8), prior=p0)
    assert weights_seen == ["/fake/backbone.caffemodel"] * 2
    assert rest["vgg"]["exact"]["per_seed"] == [0.1, 0.1]


def test_warm_gate_caches_composes_missing(monkeypatch, tmp_path):
    cfgs = {
        "pre": dict(kind="pretrain", classes=6, steps=4, est_s=1),
        "det": dict(kind="detection", model="googlenet_detectnet",
                    classes=4, im=64, stride=16, batch=2, n_cached=2,
                    eval_images=2, seeds=(0,), est_s=1),
    }
    monkeypatch.setattr(gates, "bench_gate_configs",
                        lambda tier="bench": cfgs)
    composed = []
    monkeypatch.setattr(gates, "_cached_host_batches",
                        lambda *a, **k: composed.append("train"))
    monkeypatch.setattr(gates, "build_eval_set",
                        lambda *a, **k: composed.append("eval"))
    import torchfcn.train.pretrain as pretrain_mod

    def fake_cached(root, log=None, device=None, **kw):
        p = pretrain_mod.pretrain_cache_path(root, **kw)
        open(p, "wb").close()
        composed.append("pretrain")
        return p

    monkeypatch.setattr(pretrain_mod, "cached_vgg16_pretrain", fake_cached)
    out = gates.warm_gate_caches(root=str(tmp_path), log=lambda m: None,
                                 device="cpu")
    # det contributes its held-out set and one seed's training scenes
    assert sorted(composed) == ["eval", "pretrain", "train"]
    assert sorted(out.values()) == ["composed", "composed", "composed"]
    composed.clear()
    out2 = gates.warm_gate_caches(root=str(tmp_path), log=lambda m: None,
                                  device="cpu")
    assert composed == ["eval", "train"]   # the fakes wrote no npz
    assert "warm" in out2.values()


def test_unit_cold_probe(tmp_path):
    """Cold while the unit's cached training scenes or its held-out set are
    missing, at the gate's own geometry (tpufcn's probe, its file names)."""
    from torchfcn.data.hardbench import eval_cache_path
    cfg = dict(model="googlenet_detectnet", classes=4, im=448, stride=16,
               steps=6000, n_cached=60, eval_images=128)
    root = str(tmp_path)
    assert gates._unit_cold("detection", cfg, root, 0)
    grid = GridConfig(448, 448, stride=16, num_classes=5)
    train = gates.train_cache_path(root, grid, classes=4, batch=16,
                                   n_cached=60, seed=1000)
    assert train == jgates.train_cache_path(
        root, JGridConfig(448, 448, stride=16, num_classes=5), classes=4,
        batch=16, n_cached=60, seed=1000)
    open(train, "wb").close()
    assert gates._unit_cold("detection", cfg, root, 0)    # eval missing
    open(eval_cache_path(root, grid, 4, 128), "wb").close()
    assert not gates._unit_cold("detection", cfg, root, 0)
    assert gates._unit_cold("detection", cfg, root, 1)    # other seed
    assert gates._unit_cold("segmentation", dict(steps=1), root, 0)
    assert gates._unit_cold("pretrain", dict(classes=6, steps=4), root, 0)
    assert not gates._unit_cold("voc", {}, root, 0)


@pytest.fixture()
def small_specs(monkeypatch):
    """vgg_detectnet_train's grid at 64x64 in both packages' Detectors."""
    name = "vgg_detectnet_train"
    for module, pkg in ((jax_det, tpufcn.models), (port_det, None)):
        get = module.get_spec
        spec = get(name)
        small = dataclasses.replace(spec, grid=dataclasses.replace(
            spec.grid, im_width=HW, im_height=HW))
        monkeypatch.setattr(module, "get_spec",
                            lambda n, get=get, s=small: s if n == name
                            else get(n))


@pytest.fixture(scope="module")
def eval_set(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("gate_eval"))
    grid = GridConfig(HW, HW, stride=8, num_classes=4)
    from torchfcn.data.hardbench import build_eval_set
    return build_eval_set(root, grid, classes=4, n_images=8, chunk=4)


def test_score_detector_matches_jax(small_specs, eval_set):
    images, gts, _ = eval_set
    name, classes = "vgg_detectnet_train", 4
    kwargs = {"num_classes": classes}
    jmodel = tpufcn.models.build(name, dtype=jnp.bfloat16, **kwargs)
    params = jax.tree.map(np.array, jax.jit(jmodel.init)(
        jax.random.key(0), jnp.zeros((1, HW, HW, 3), jnp.float32)))
    params["params"]["cvg/classifier"]["conv"]["bias"][:] = 1.0
    params["params"]["bbox/regressor"]["conv"]["bias"][:] = \
        [-24, -24, 40, 40] * classes
    grid = GridConfig(HW, HW, stride=8, num_classes=classes)
    # the boxes tpufcn finds, shifted, stand in for every other image's GT,
    # so that the mAP lies strictly between 0 and 1
    jparams = jax.tree.map(jnp.asarray, params)
    det = jax_det.Detector(name, dtype=jnp.bfloat16, max_candidates=128,
                           model_kwargs=dict(kwargs))
    det.params = jparams
    found = det(images).to_lists()
    gts = [g if i % 2 else
           (np.asarray([b for b, _, _ in found[i]], np.float64) + 2,
            np.asarray([l for _, l, _ in found[i]], np.int64))
           for i, g in enumerate(gts)]
    want = jgates._score_detector(name, jparams, grid, images, gts, classes,
                                  kwargs, chunk=4)
    model = port_det.serving_model(name, torch.float32, 0, kwargs, "cpu")
    load_jax_params(model, params)
    got = gates._score_detector(name, model.state_dict(), grid, images, gts,
                                classes, kwargs, chunk=4, device="cpu")
    assert want[1] > 0 and 0 < want[0] < 1
    assert got == want


def test_segmentation_scoring_matches_jax(eval_set):
    images, _, segs = eval_set
    name, C = "fcn32s_seg", 5
    jmodel = tpufcn.models.build(name, dtype=jnp.bfloat16, num_classes=C)
    params = jax.tree.map(np.asarray, jax.jit(jmodel.init)(
        jax.random.key(1), jnp.zeros((1, HW, HW, 3), jnp.float32)))
    from tpufcn.ops.image import demean_bgr
    # tpufcn's segmentation_gate scoring (tpufcn/train/gates.py:819-834)
    logits = jmodel.apply(params, demean_bgr(jnp.asarray(images,
                                                         jnp.float32)))
    preds = np.asarray(jnp.argmax(logits["seg"], axis=-1))
    want = jev.evaluate_segmentation(list(segs), list(preds),
                                     num_classes=C)["mean_iou"]
    from torchfcn.models import build
    model = build(name, num_classes=C)
    load_jax_params(model, params)
    got = gates._score_segmenter(name, model.state_dict(), images, segs, C,
                                 chunk=4, device="cpu")
    assert 0 < want < 1
    assert abs(got - float(want)) <= SEG_ATOL, (got, want)


JAX_DETECTION_KEYS = {"n_gt", "n_det", "eval_images", "seeds", "train_s",
                      "eval_s", "exact", "fp8"}
JAX_SEGMENTATION_KEYS = {"eval_images", "seeds", "train_s", "eval_s",
                         "exact", "fp8"}
TIMES = ("train_s", "eval_s")


def _readings(out):
    return {k: v for k, v in out.items() if k not in TIMES}


def test_gates_end_to_end_on_cpu(tmp_path):
    e5m2 = torch.float8_e5m2
    runs = []
    for i in range(2):
        root = str(tmp_path / f"r{i}")
        det = gates.detection_gate(
            "googlenet_detectnet_3cls", classes=3, im=HW, stride=16,
            steps=3, batch=2, n_cached=2, eval_images=4, root=root,
            serving_kwargs={"store_dtype": e5m2, "store_blocks": True,
                            "store_stem2": True}, device="cpu")
        seg = gates.segmentation_gate(im=HW, steps=3, batch=2, n_cached=2,
                                      eval_images=4, root=root,
                                      device="cpu")
        runs.append((det, seg))
    (det, seg), (det2, seg2) = runs
    assert set(det) == JAX_DETECTION_KEYS
    assert set(det["exact"]) == {"mAP", "min", "max", "per_seed"}
    assert det["n_gt"] > 0 and det["eval_images"] == 4
    assert set(seg) == JAX_SEGMENTATION_KEYS
    assert set(seg["fp8"]) == {"mIoU", "min", "max", "per_seed"}
    assert 0 <= seg["exact"]["mIoU"] <= 1
    assert _readings(det) == _readings(det2)
    assert _readings(seg) == _readings(seg2)


def test_host_modes_and_missing_cuda_raise(tmp_path, monkeypatch):
    """"host_cached" and "host" each train one step on the CPU from the host
    compositor's scenes: the cached batch is tpufcn's (its boxes, labels
    and valid masks equal, under tpufcn's file name; its images and seg
    maps within the hard sources' stated differences); a second
    "host_cached" call reads the cache.  A gate on "cuda" without CUDA
    raises."""
    from tpufcn.core.config import GridConfig as JGrid
    from torchfcn.data import hardbench
    grid = GridConfig(HW, HW, stride=8, num_classes=4)
    root = str(tmp_path / "port")
    kw = dict(classes=4, steps=1, batch=2, n_cached=1, seed=0,
              with_seg=False, model_kwargs={"num_classes": 4}, device="cpu")
    for mode in ("host_cached", "host"):
        state = gates._train_hard("vgg_detectnet_train", grid, root,
                                  data_mode=mode, **kw)
        assert state.step == 1
    got = gates._cached_host_batches(root, grid, classes=4, batch=2,
                                     n_cached=1, seed=1000)
    jroot = str(tmp_path / "jax")
    want = jgates._cached_host_batches(
        jroot, JGrid(HW, HW, stride=8, num_classes=4), classes=4, batch=2,
        n_cached=1, seed=1000, log=lambda m: None)
    assert os.listdir(jroot) and set(os.listdir(jroot)) & set(
        os.listdir(root)) >= {os.path.basename(gates.train_cache_path(
            root, grid, classes=4, batch=2, n_cached=1, seed=1000))}
    for k in ("rects", "labels", "valid"):
        assert np.array_equal(got[0][k], want[0][k]), k
    assert got[0]["seg"].dtype == want[0]["seg"].dtype == np.int32
    assert int((got[0]["image"] != want[0]["image"]).sum()) <= 1000
    assert int((got[0]["seg"] != want[0]["seg"]).sum()) <= 20

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            gates.segmentation_gate(im=HW, steps=1, batch=2, n_cached=1,
                                    eval_images=2, root=str(tmp_path))

    def no_compose(*a, **k):
        raise AssertionError("composed again")

    monkeypatch.setattr(gates, "hard_pipeline", no_compose)
    monkeypatch.setattr(hardbench, "hard_pipeline", no_compose)
    state = gates._train_hard("vgg_detectnet_train", grid, root,
                              data_mode="host_cached", **kw)
    assert state.step == 1
    with pytest.raises(ValueError, match="data_mode"):
        gates._train_hard("vgg_detectnet_train", grid, root,
                          data_mode="disk", **kw)


def test_cli_prints_one_json_line(monkeypatch, capsys):
    seen = {}

    def fake_run(**kw):
        seen.update(kw)
        return {"fcn32s": {"exact": {"mIoU": 0.5}}}

    monkeypatch.setattr(gates, "run_bench_gates", fake_run)
    cli.main(["gates", "--family", "fcn32s", "--device", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()
    assert json.loads(out[-1]) == {"fcn32s": {"exact": {"mIoU": 0.5}}}
    assert seen["only"] == ["fcn32s"] and seen["device"] == "cpu"
    with pytest.raises(SystemExit):
        cli.main(["gates", "--family", "voc_fixtures"])
    cli.main(["gates", "--family", "voc_fixture", "--device", "cpu"])
    assert seen["only"] == ["voc_fixture"]
