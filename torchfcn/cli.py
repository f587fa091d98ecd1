"""Command-line interface of the port (``tpufcn/cli.py``), with the JAX
package's flags plus ``--device``.  Subcommands so far:

  detect    run the detector over image files (baseline JPEG, 8-bit PNG)
  replay    stream frame files through the detector node
            (``--micro-batch``: the batched throughput mode)
  launch    build a node graph from a JSON launch spec and stream frames
            through it, in one process or across processes (``--bus``)
  bus       run the cross-process topic broker
  export    the serving pipeline as a ``torch.export`` artifact
  profile   per-kernel device time of the serving pipeline or a train step
  pointmap  build the C++ point-map library
  gates     the tracked accuracy gates
  pretrain  the VGG16 backbone pretrain
  train     train a recipe from record shards (``--records``) or from
            scenes composed on the host (``--manifest``) or on the device
            (``--manifest`` with ``--device-data``)
  records   build record shards from a manifest, or inspect them
  voc       Pascal VOC annotations -> manifests
  eval      held-out mAP (``--format voc|detection``) or mean-IoU
            (``--format seg``) of a snapshot or ``.caffemodel``
  convert   a ``.caffemodel`` -> tpufcn's ``.npz`` parameter tree of a model
  refine    the boundary-refinement walk over a detection manifest
  rank      proposal ranking / outlier rejection over a detection manifest

Each prints JSON lines on stdout, as tpufcn's do (``records``, ``voc`` and
``convert`` print tpufcn's plain lines); progress goes to stderr.
Everything that runs a model runs on the card (``--device cuda``, the
default) or on the CPU (``--device cpu``); ``records``, ``voc`` and
``convert`` run on the host, and so do the tracking and clustering of
``refine`` and ``rank`` (their CNN codes run on ``--device``).  ``replay``
and ``launch`` read camera recordings (``--video``: MJPG AVIs, with
``--video-stride`` and ``--max-frames``); ``train --manifest --workers N``
composes in N host processes.  ``detect --overlay-dir`` and ``train
--inspect-data`` draw tpufcn's detection overlay on the host
(``torchfcn.serve.viz``).

    python -m torchfcn.cli detect frame.png --model googlenet_detectnet
    python -m torchfcn.cli launch examples/fcn_point_map.launch.json \
        --frames a.png b.png
    python -m torchfcn.cli replay --video cam.avi --video-stride 2
    python -m torchfcn.cli train --manifest crops.txt --backgrounds bg/*.png \
        --workers 7
    python -m torchfcn.cli gates --family fcn32s
    python -m torchfcn.cli voc tests/fixtures/voc_mini --out man \
        --classes ball crate cone
    python -m torchfcn.cli records --manifest man/train.txt --format voc \
        --out rec/ds
    python -m torchfcn.cli train --records rec/ds --max-iter 20 \
        --snapshot-dir snap
    python -m torchfcn.cli eval --manifest man/val.txt --format voc \
        --model vgg_detectnet_train --weights snap
    python -m torchfcn.cli convert vgg16.caffemodel --model \
        vgg_detectnet_train --out weights.npz --lenient
    python -m torchfcn.cli refine --manifest seq/train.txt \
        --extractor-weights vgg16.caffemodel      # seq/train_refined.txt
    python -m torchfcn.cli rank --manifest seq/train.txt \
        --metric chi_square                       # seq/train2.txt
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _cmd_train(args):
    """Train a recipe (``tpufcn/cli.py::_cmd_train``) from record shards or
    from scenes composed on the host (in this process, or in ``--workers``
    processes) or on the device.  The layout is the recipe's ``mesh``
    (every recipe is 1 x 1, as in tpufcn); a process started in a larger
    world raises."""
    import dataclasses
    import os
    from torchfcn import recipes
    from torchfcn.data.imageio import imread
    from torchfcn.data.raster import resize_linear_u8
    from torchfcn.models import get_spec

    if not args.records and not args.manifest:
        raise SystemExit("one of --manifest or --records is required")

    cfg = recipes.get(args.recipe)
    if args.max_iter:
        cfg = dataclasses.replace(cfg, max_iter=args.max_iter)
    if args.batch_size:
        cfg = dataclasses.replace(cfg, data=dataclasses.replace(
            cfg.data, batch_size=args.batch_size))
    if args.snapshot_dir:
        cfg = dataclasses.replace(cfg, snapshot_dir=args.snapshot_dir)
    if args.iter_size and args.iter_size != 1:
        cfg = dataclasses.replace(cfg, iter_size=args.iter_size)
    if args.warmup:
        cfg = dataclasses.replace(cfg, warmup_steps=args.warmup)

    world = int(os.environ.get("WORLD_SIZE", 1))
    if world != cfg.mesh.num_devices:
        raise ValueError(
            f"the recipe's mesh names {cfg.mesh.num_devices} device(s) "
            f"({cfg.mesh.data}x{cfg.mesh.space}) but this process was "
            f"started in a world of {world}; sharded training is "
            "Trainer(cfg) with a cfg.mesh of that many devices")
    # seg supervision follows the model's heads, not the recipe's name
    heads = get_spec(cfg.model).heads
    with_seg = "seg" in heads
    pool = contextlib.nullcontext()
    if args.records:
        # record shards store boxes and labels, not masks: a seg-only model
        # cannot train from them, a joint one trains its detection heads
        if heads == ("seg",):
            raise SystemExit(
                "--records cannot train a segmentation-only model (records "
                "store box labels, not masks); use --manifest")
        if with_seg:
            _log("note: records store box labels only: training the "
                 "detection heads, the seg head unsupervised")
            with_seg = False
        from torchfcn.data.pipeline import RecordTrainPipeline
        pipe = RecordTrainPipeline(args.records, cfg.grid,
                                   batch_size=cfg.data.batch_size)
    else:
        from torchfcn.data.manifest import (
            read_mask_manifest, snapshot_label_path)
        samples = read_mask_manifest(
            args.manifest, snapshot_label_manifest=snapshot_label_path(
                os.path.join(cfg.snapshot_dir, "labels")))
        if args.device_data and args.workers:
            raise SystemExit(
                "--device-data composes on the accelerator; --workers "
                "(host worker pool) does not apply — pass one or the "
                "other")
        if args.device_data:
            from torchfcn.data.device_compositor import (
                DeviceCompositePipeline)
            pipe = DeviceCompositePipeline.from_samples(
                samples, cfg.grid, cfg.data, backgrounds=args.backgrounds,
                imread=imread, resize=resize_linear_u8, device=args.device,
                seed=cfg.seed)
        elif args.workers > 0:
            from torchfcn.data.parallel import ParallelCompositePipeline
            pipe = pool = ParallelCompositePipeline(
                samples, cfg.grid, cfg.data, backgrounds=args.backgrounds,
                workers=args.workers)
        else:
            from torchfcn.data.pipeline import CompositeTrainPipeline
            pipe = CompositeTrainPipeline(samples, cfg.grid, cfg.data,
                                          backgrounds=args.backgrounds)
    with pool:      # the worker pool stops when training ends, or fails
        if args.inspect_data:
            _inspect_data(args.inspect_data, pipe)
        else:
            _fit(args, cfg, pipe, heads, with_seg)


def _inspect_data(out_dir: str, pipe) -> None:
    """The data dry-run (``tpufcn/cli.py:110-137``): the first batch as
    overlay PNGs (``b0_XX.png``, each valid box drawn with confidence 1)
    and its seg masks scaled to 0-255 (``b0_XX_seg.png``), then one JSON
    line."""
    import os
    import numpy as np
    import torch
    from torchfcn.data.imageio import imwrite
    from torchfcn.serve.viz import draw_detections

    os.makedirs(out_dir, exist_ok=True)
    batch = {k: v.cpu().numpy() if isinstance(v, torch.Tensor)
             else np.asarray(v) for k, v in next(iter(pipe)).items()}
    imgs, seg = batch["image"], batch.get("seg")
    for i in range(imgs.shape[0]):
        dets = [([r[0], r[1], r[0] + r[2], r[1] + r[3]], int(l), 1.0)
                for r, l, v in zip(batch["rects"][i], batch["labels"][i],
                                   batch["valid"][i]) if v]
        imwrite(os.path.join(out_dir, f"b0_{i:02d}.png"),
                draw_detections(imgs[i], dets))
        if seg is not None:
            hi = max(int(seg[i].max()), 1)
            imwrite(os.path.join(out_dir, f"b0_{i:02d}_seg.png"),
                    (seg[i].astype(np.float32) * (255.0 / hi))
                    .astype(np.uint8))
    print(json.dumps({"inspect_data": out_dir, "images": int(imgs.shape[0]),
                      "with_seg": seg is not None}))


def _fit(args, cfg, pipe, heads, with_seg):
    """``_cmd_train``'s validator, Trainer and run over ``pipe``."""
    import dataclasses
    from torchfcn.data.imageio import imread
    from torchfcn.data.raster import resize_linear_u8
    from torchfcn.train.trainer import Trainer

    validator = None
    if args.eval_every:
        if not (args.val_records or args.val_manifest):
            raise SystemExit(
                "--eval-every requires --val-records or --val-manifest")
        cfg = dataclasses.replace(cfg, eval_every=args.eval_every)
        from torchfcn.train import validate as V
        hw = (cfg.grid.im_height, cfg.grid.im_width)
        if heads == ("seg",):
            if not args.val_manifest:
                raise SystemExit("seg-only families validate from "
                                 "--val-manifest (mask manifest)")
            vi, vm = V.seg_val_set_from_manifest(
                args.val_manifest, hw, limit=args.val_limit, imread=imread,
                resize=resize_linear_u8)
            validator = V.seg_validator(cfg.model, vi, vm)
        else:
            if args.val_records:
                vi, vg = V.val_set_from_records(args.val_records, hw,
                                                limit=args.val_limit)
            else:
                vi, vg = V.val_set_from_manifest(
                    args.val_manifest, hw, limit=args.val_limit,
                    imread=imread, resize=resize_linear_u8)
            validator = V.detection_validator(cfg.model, vi, vg,
                                              chunk=min(32, len(vi)))
        _log(f"validation: {len(vi)} held-out samples every "
             f"{args.eval_every} steps")
    trainer = Trainer(cfg, with_seg=with_seg, validator=validator,
                      device=args.device, log_sink=_log)
    src = iter(pipe)
    if args.cache > 0:
        # build N batches once and train epochs over them on the device
        from torchfcn.data.pipeline import DeviceBatchCache
        src = iter(DeviceBatchCache(trainer.put, src, args.cache))
    state = None
    if args.weights:
        # fine-tune init (the reference's `caffe train --weights`): a
        # .caffemodel (lenient, by name) or a snapshot directory; a
        # snapshot in --snapshot-dir still resumes over it
        from torchfcn.convert import resolve_weights
        state = trainer.init_state()
        resolve_weights(args.weights, state.model)
    state = trainer.fit(src, state=state)
    if args.metrics_out and trainer.writer:
        with open(args.metrics_out, "w") as f:
            for h in trainer.logger.history:
                f.write(json.dumps(h) + "\n")
        _log(f"wrote {len(trainer.logger.history)} metric records to "
             f"{args.metrics_out}")
    if trainer.best is not None:
        _log(f"best checkpoint: step {trainer.best['step']} "
             f"({trainer.best['metric']}={trainer.best['score']:.4f}) in "
             f"{cfg.snapshot_dir}/best")
    if trainer.writer:
        print(json.dumps({"trained_to": state.step,
                          "snapshot_dir": cfg.snapshot_dir,
                          "best": trainer.best, "device": args.device}))


def _cmd_records(args):
    """Record shards from a manifest (``tpufcn/cli.py::_cmd_records``), or
    with ``--inspect`` one JSON line per record read back and a count."""
    from torchfcn.data.manifest import (
        read_detection_manifest, read_voc_manifest)
    from torchfcn.data.records import RecordReader, create_detection_records
    if args.inspect:
        r = RecordReader(args.out)
        for i in range(min(args.limit, len(r))):
            rec = r.read(i)
            print(json.dumps({"index": i, "image": list(rec["image"].shape),
                              "rects": rec["rects"].tolist(),
                              "labels": rec["labels"].tolist()}))
        print(json.dumps({"records": len(r), "prefix": args.out}))
        r.close()
        return
    if not args.manifest:
        raise SystemExit("--manifest is required (unless --inspect)")
    samples = (read_voc_manifest(args.manifest) if args.format == "voc"
               else read_detection_manifest(args.manifest))
    n = create_detection_records(
        samples, args.out, augment=args.augment,
        relabel_contiguous=args.relabel, add_background=args.background)
    print(f"wrote {n} records to {args.out}-*.rec")


def _cmd_voc(args):
    from torchfcn.data.voc import VOC_CLASSES, PascalVOC
    PascalVOC(args.voc_root,
              classes=args.classes or VOC_CLASSES).create(args.out)
    print(f"wrote manifests to {args.out}")


def _eval_seg(args):
    """Mean-IoU, pixel and class accuracy of a segmentation family over a
    mask manifest (``img mask label x y w h`` records on every other line):
    images resized to the net's size as cv2's INTER_LINEAR, masks by
    nearest neighbour, mask pixels label + 1 (0 background)."""
    import numpy as np
    import torch
    from torchfcn.data.imageio import imread_or_none
    from torchfcn.data.manifest import (
        bgr2gray_u8, read_label_map_snapshot, read_mask_manifest)
    from torchfcn.data.raster import resize_linear_u8, resize_nearest_u8
    from torchfcn.models import get_spec
    from torchfcn.serve.detector import serving_model
    from torchfcn.serve.segment import Segmenter
    from torchfcn.train.evaluate import evaluate_segmentation

    label_map = (read_label_map_snapshot(args.labels) if args.labels
                 else None)
    samples = read_mask_manifest(args.manifest, background_offset=1,
                                 label_map=label_map)
    spec = get_spec(args.model)
    C = args.num_classes or spec.grid.num_classes
    mkw = {"num_classes": args.num_classes} if args.num_classes else {}
    seg = Segmenter(args.model, model=serving_model(
        args.model, torch.bfloat16, 0, mkw, args.device,
        weights=args.weights))
    H, W = spec.grid.im_height, spec.grid.im_width
    gts, preds = [], []
    for s in samples[:args.limit]:
        img, msk = imread_or_none(s.image_path), imread_or_none(s.mask_path)
        if img is None or msk is None:
            continue
        msk = resize_nearest_u8(bgr2gray_u8(msk), (W, H))
        gts.append(np.where(msk > 0, s.label, 0))
        preds.append(seg(resize_linear_u8(img, (W, H))[None])[0].cpu()
                     .numpy())
    res = evaluate_segmentation(gts, preds, num_classes=C)
    print(json.dumps({"mean_iou": res["mean_iou"],
                      "pixel_accuracy": res["pixel_accuracy"],
                      "mean_class_accuracy": res["mean_class_accuracy"],
                      "iou": {str(k): v for k, v in res["iou"].items()},
                      "images": len(gts)}))


def _cmd_eval(args):
    """Held-out mAP@``--iou`` and per-class AP of a detector over a VOC or
    detection manifest (``tpufcn/cli.py::_cmd_eval``), each image at its own
    size through the full serving pipeline; ``--format seg``: mean-IoU.
    ``--weights``: a Trainer snapshot directory or a ``.caffemodel``."""
    import os

    import numpy as np
    from torchfcn.data.imageio import imread_or_none
    from torchfcn.data.manifest import (
        read_detection_manifest, read_voc_manifest)
    from torchfcn.models import get_spec
    from torchfcn.serve.detector import Detector
    from torchfcn.train.evaluate import evaluate_detector

    if args.format == "seg":
        return _eval_seg(args)
    reader = (read_voc_manifest if args.format == "voc"
              else read_detection_manifest)
    samples = reader(args.manifest)
    mkw = {"num_classes": args.num_classes} if args.num_classes else {}
    if args.weights and os.path.isdir(args.weights):
        det = Detector.from_checkpoint(args.weights, args.model,
                                       model_kwargs=mkw, device=args.device)
    elif args.weights:
        # a .caffemodel, loaded as a launch graph's detector node loads it
        from torchfcn.serve.bus import TopicBus
        from torchfcn.serve.launch import _make_detector
        det = _make_detector(TopicBus(), {
            "model": args.model, "pretrained_weights": args.weights,
            "device": args.device, **mkw}, {}).detector
    else:
        det = Detector(args.model, model_kwargs=mkw, device=args.device)
    images, gts = [], []
    for s in samples[:args.limit]:
        img = imread_or_none(s.image_path)
        if img is None:
            continue
        images.append(img)
        r = np.asarray(s.rects, np.float64)
        gts.append((np.concatenate([r[:, :2], r[:, :2] + r[:, 2:4]], axis=1),
                    np.asarray(s.labels)))
    C = args.num_classes or get_spec(args.model).grid.num_classes
    res = evaluate_detector(det, images, gts, num_classes=C,
                            iou_thresh=args.iou)
    print(json.dumps({"mAP": res["mAP"],
                      "ap": {str(k): v for k, v in res["ap"].items()},
                      "images": len(images)}))


def _cmd_gates(args):
    from torchfcn.train.gates import (
        bench_gate_configs, run_bench_gates, warm_gate_caches)

    known = sorted(bench_gate_configs(args.tier))
    fams = args.family or known
    unknown = sorted(set(fams) - set(known))
    if unknown:
        raise SystemExit(f"unknown families {unknown}; have {known}")
    if args.warm_caches:
        out = warm_gate_caches(root=args.root, only=fams, log=_log,
                               tier=args.tier, device=args.device)
    else:
        out = run_bench_gates(root=args.root, only=fams, log=_log,
                              tier=args.tier, device=args.device)
    print(json.dumps(out))


def _cmd_pretrain(args):
    """The backbone pretrain (the reference's fine-tune seed, reproduced
    without a download): a ``.caffemodel`` that the gates load by name."""
    from torchfcn.train.pretrain import pretrain_vgg16
    res = pretrain_vgg16(args.out, classes=args.classes, steps=args.steps,
                         lr=args.lr, seed=args.seed, log=_log,
                         device=args.device)
    print(json.dumps(res))


def _read_frames(paths):
    """(path, BGR frame) of each readable JPEG or PNG; the others are
    reported on stderr and skipped, as tpufcn skips what cv2 cannot read."""
    from torchfcn.data.imageio import imread
    for path in paths:
        try:
            yield path, imread(path)
        except (OSError, ValueError) as e:
            print(f"{path}: unreadable ({e})", file=sys.stderr)


def _detector_node(args, **params):
    from torchfcn.serve.bus import TopicBus
    from torchfcn.serve.launch import _make_detector
    params = dict(model=args.model, pretrained_weights=args.weights,
                  device=args.device, **params)
    return _make_detector(TopicBus(), {k: v for k, v in params.items()
                                       if v is not None}, {})


def _cmd_detect(args):
    """The detector over image files, one JSON line each; with
    ``--overlay-dir`` also each frame's overlay as ``<stem>_det.png``
    (``_1``, ``_2`` ... after the stem where inputs share a basename)."""
    import os
    node = _detector_node(args, detection_threshold=args.threshold,
                          min_boxes=args.min_boxes, nms_eps=args.nms_eps,
                          manifest=args.manifest)
    names = node.names or []
    overlay_names: set = set()
    for path, img in _read_frames(args.images):
        dets = node.detector(img[None]).to_lists()[0]
        if args.overlay_dir:
            from torchfcn.data.imageio import imwrite
            from torchfcn.serve.viz import draw_detections
            os.makedirs(args.overlay_dir, exist_ok=True)
            stem = os.path.splitext(os.path.basename(path))[0]
            n, base = 1, stem
            while stem in overlay_names:
                stem = f"{base}_{n}"
                n += 1
            overlay_names.add(stem)
            imwrite(os.path.join(args.overlay_dir, stem + "_det.png"),
                    draw_detections(img, dets, names or None))
        print(json.dumps({"image": path, "detections": [
            {"box": [int(v) for v in box], "label": label,
             "name": (names[label] if label < len(names)
                      else f"object_{label}"),
             "confidence": conf}
            for box, label, conf in dets]}))


def _cmd_replay(args):
    """Frame files, or a camera recording's frames (``--video``), stream
    through the topic bus, one per stamp; with ``--micro-batch`` the
    batched throughput mode instead."""
    if args.video and args.images:
        raise SystemExit("give image files OR --video, not both")
    if args.video:
        from torchfcn.serve.video import read_video_frames
        frames, _ = read_video_frames(args.video, stride=args.video_stride,
                                      max_frames=args.max_frames or None)
    else:
        frames = [img for _, img in _read_frames(args.images)]
    if not frames:
        raise SystemExit("no readable frames")
    if args.micro_batch > 0:
        from torchfcn.serve.stream import replay_throughput
        det = _detector_node(args).detector
        stats = replay_throughput(det, frames,
                                  micro_batch=min(args.micro_batch,
                                                  len(frames)))
        print(json.dumps(stats))
        return

    from torchfcn.serve.launch import launch
    from torchfcn.serve.stream import replay
    params = {"model": args.model, "device": args.device}
    if args.weights:
        params["pretrained_weights"] = args.weights
    graph = launch({"fcn_object_detector": {
        "type": "detector", "params": params,
        "remap": {"image": "image"}}})
    rects = []
    graph.bus.subscribe("/fcn_object_detector/rects",
                        lambda m: rects.append(m.data), queue_size=10**6)
    node = graph.nodes["fcn_object_detector"]
    n = replay(node, frames, bus=graph.bus)
    for i, r in enumerate(rects):
        print(json.dumps({"frame": i, "detections": len(r.labels)}))
    print(json.dumps({"frames_processed": n}))


def _cmd_export(args):
    """The serving pipeline (preprocess -> forward -> decode -> NMS) as a
    ``torch.export`` program; the weights stay outside it
    (``torchfcn/serve/export.py``)."""
    from torchfcn.serve.export import export_detector
    det = _detector_node(args).detector
    art = export_detector(det, args.batch)
    with open(args.out, "wb") as f:
        f.write(art)
    print(json.dumps({"out": args.out, "bytes": len(art),
                      "batch": args.batch, "device": args.device}))


def _cmd_launch(args):
    """Build a node graph from a JSON spec (node types, params, remaps: see
    ``torchfcn/serve/launch.py`` and ``examples/*.launch.json``) and stream
    frames through it.  ``--device`` goes to every node that does not set
    its own.  With ``--bus tcp://host:port`` the graph attaches to a broker
    (``cli bus``), and ``--nodes`` runs a subset of the spec in this
    process: together they split one launch file across processes.  A
    camera recording (``--video``) goes out with its source stamps, so that
    stamp-based synchronizers see the capture cadence."""
    from torchfcn.serve.launch import launch

    if args.frames and args.video:
        raise SystemExit("give --frames OR --video, not both")
    with open(args.graph) as f:
        spec = json.load(f)
    if args.nodes:
        wanted = [n.strip() for n in args.nodes.split(",") if n.strip()]
        missing = [n for n in wanted if n not in spec]
        if missing:
            raise SystemExit(f"--nodes not in spec: {', '.join(missing)}")
        spec = {n: spec[n] for n in wanted}
    for node in spec.values():
        if node.get("type") == "detector":
            node["params"] = {"device": args.device,
                              **(node.get("params") or {})}
    bus = None
    if args.bus:
        from torchfcn.serve.netbus import RemoteTopicBus
        bus = RemoteTopicBus(args.bus)
    graph = launch(spec, bus=bus)
    published = 0
    followers = [n for n in graph.nodes.values()
                 if getattr(n, "following", False)]
    if followers:
        # a rank of a meshed detector other than rank 0: run rank 0's
        # batches until its graph closes
        print(json.dumps({"nodes": sorted(graph.nodes),
                          "followed": [n.follow() for n in followers]}))
        return
    if args.frames or args.video:
        if args.video:
            from torchfcn.serve.video import iter_video_frames
            source = iter_video_frames(args.video, stride=args.video_stride,
                                       max_frames=args.max_frames or None)
        else:
            source = ((float(i), img) for i, (_, img) in
                      enumerate(_read_frames(args.frames)))
        for stamp, img in source:
            graph.bus.publish(args.topic, img, stamp=stamp)
            graph.spin()
            published += 1
        graph.close()    # part-filled micro-batches at stream end
        graph.spin()             # deliver what the flush published
    elif args.serve is not None:
        # a node-only process on a remote bus: spin until the time is up
        # (or until SIGINT with 0)
        deadline = time.time() + args.serve if args.serve > 0 else None
        try:
            while deadline is None or time.time() < deadline:
                graph.spin()
                time.sleep(0.005)
        except KeyboardInterrupt:
            pass
    else:
        graph.spin(args.spin)
    print(json.dumps({
        "nodes": sorted(graph.nodes),
        "frames_published": published,
        "processed": {name: getattr(node, "processed", None)
                      for name, node in graph.nodes.items()}}))


def _cmd_bus(args):
    """Run the cross-process topic broker in the foreground: node processes
    attach with ``cli launch --bus tcp://host:port``."""
    import signal
    from torchfcn.serve.netbus import start_broker
    handle = start_broker(port=args.port,
                          native="no" if args.python else "auto",
                          max_outbox=args.max_outbox)
    kind = "python" if handle._proc is None else "native"
    print(json.dumps({"address": handle.address, "broker": kind}),
          flush=True)
    stop = {"flag": False}

    def _sig(_s, _f):
        stop["flag"] = True
    signal.signal(signal.SIGINT, _sig)
    signal.signal(signal.SIGTERM, _sig)
    try:
        while not stop["flag"]:
            if handle._proc is not None and handle._proc.poll() is not None:
                raise SystemExit("broker process exited")
            time.sleep(0.2)
    finally:
        handle.stop()


def _cmd_profile(args):
    """Per-entry time of the serving pipeline (or, with ``--train``, a
    train step) of each ``--model`` over ``--iters`` calls under
    ``torch.profiler`` (``torchfcn/serve/profile.py``): device time of
    every kernel and copy on the card, operator self time on the CPU."""
    import os
    import subprocess

    from torchfcn.serve.profile import DEFAULT_MODELS, profile_path

    card = None
    if args.device != "cpu":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.splitlines()[0]
    models = args.model or DEFAULT_MODELS
    for model in models:
        logdir = (os.path.join(args.logdir, model)
                  if args.logdir and len(models) > 1 else args.logdir)
        r = profile_path(model, device=args.device, batch=args.batch,
                         iters=args.iters, train=args.train,
                         max_candidates=args.max_candidates, logdir=logdir)
        ops = r["ops"][:args.top] if args.top else r["ops"]
        if args.json:
            print(json.dumps({**r, "card": card, "ops": ops}))
            continue
        busy = r["total_device_us"] / 1e3 / r["iters"]
        print(f"{model} [{r['mode']}]  batch {r['batch']}  x{r['iters']} "
              f"calls on {card or 'cpu'}: "
              f"{'device busy' if card else 'operator time'} {busy:.3f} ms of "
              f"{r['wall_ms']:.3f} ms wall per call  (trace: {r['logdir']})")
        print(f"{'ms/call':>10}  {'share':>6}  {'count':>6}  entry")
        for o in ops:
            print(f"{o['dur_us'] / 1e3 / r['iters']:10.4f}  "
                  f"{o['dur_us'] / (r['total_device_us'] or 1.0):6.1%}  "
                  f"{o['count'] / r['iters']:6.1f}  {o['name'][:90]}")


def _cmd_convert(args):
    """A ``.caffemodel`` -> the ``.npz`` of ``--model``'s parameter tree
    that tpufcn's ``convert`` writes (``tpufcn/cli.py::_cmd_convert``): the
    same keys (``params/<Flax path>``) and float32 arrays, kernels HWIO.
    Convs the file does not name keep the model's seeded init, where
    tpufcn's keep JAX's."""
    import numpy as np
    import torch
    from torchfcn.convert import convert_caffemodel
    from torchfcn.convert.from_jax import flax_arrays
    from torchfcn.models import build

    model = build(args.model)
    model.init_weights(torch.Generator().manual_seed(0))
    convert_caffemodel(model, args.caffemodel, strict=not args.lenient)
    arrays = flax_arrays(model)
    np.savez(args.out, **arrays)
    print(f"wrote {args.out} ({len(arrays)} arrays)")


def _tool_extractor(args):
    """CNN-code extractor for the pseudo-label tools, on ``--device`` in
    ``--dtype``: trained VGG16 weights from a .caffemodel when given (the
    reference tools load a .caffemodel for their fc7 codes,
    boundary_refinement.py:374-383), else the seeded init (the extractor
    itself warns that gating will be weak)."""
    import torch
    from torchfcn.tools.features import CnnCodeExtractor
    kw = dict(input_size=args.input_size, dtype=getattr(torch, args.dtype),
              device=args.device)
    if args.extractor_weights:
        return CnnCodeExtractor.from_caffemodel(args.extractor_weights, **kw)
    return CnnCodeExtractor(**kw)


def _cmd_refine(args):
    """Offline boundary-refinement walk over a detection manifest
    (reference boundary_refinement.py:77-157): track each frame's box
    from the previous frame, keep the tracked box when its CNN code
    stays similar, write the refined manifest."""
    import os
    from torchfcn.data.manifest import read_detection_manifest
    from torchfcn.tools.boundary_refinement import BoundaryRefiner
    samples = read_detection_manifest(args.manifest)
    out = args.out or os.path.join(
        os.path.dirname(os.path.abspath(args.manifest)),
        "train_refined.txt")
    refiner = BoundaryRefiner(extractor=_tool_extractor(args),
                              similarity_thresh=args.threshold)
    n = refiner.refine_manifest(samples, out)
    print(json.dumps({"refined": n, "out": out}))


def _cmd_rank(args):
    """Proposal ranking / outlier rejection over a detection manifest
    (reference rank_object_models.py): cluster the crops' CNN codes,
    walk the sequence with template/previous similarity gating, write
    the kept lines (the reference's train2.txt convention)."""
    import os
    from torchfcn.data.manifest import read_detection_manifest
    from torchfcn.tools.rank_proposals import RankObjectProposals
    samples = read_detection_manifest(args.manifest)
    out = args.out or os.path.join(
        os.path.dirname(os.path.abspath(args.manifest)), "train2.txt")
    ranker = RankObjectProposals(extractor=_tool_extractor(args),
                                 distance_thresh=args.threshold,
                                 metric=args.metric)
    n = ranker.write_filtered(samples, out)
    print(json.dumps({"kept": n, "total": len(samples), "out": out}))


def _cmd_pointmap(args):
    from torchfcn.pointmap import build_library
    print(build_library(force=True))


def main(argv=None):
    from torchfcn.train.gates import DEFAULT_ROOT

    p = argparse.ArgumentParser(prog="torchfcn")
    sub = p.add_subparsers(dest="cmd", required=True)

    ga = sub.add_parser(
        "gates",
        help="run the tracked accuracy gates: per-family trained mAP/mIoU "
             "on the hard synthetic benchmark, exact and e5m2 serving; "
             "trains each family")
    ga.add_argument("--family", nargs="*", default=None,
                    help="subset: googlenet googlenet_3cls vgg_pyramid "
                         "vgg16_pretrain fcn8s fcn32s (default: all)")
    ga.add_argument("--root", default=DEFAULT_ROOT,
                    help="work and cache directory of the hard benchmark")
    ga.add_argument("--warm-caches", action="store_true",
                    help="compose the held-out sets and each seed's "
                         "cached training scenes and run the pretrain, "
                         "without the gates")
    ga.add_argument("--tier", choices=("bench", "full"), default="bench",
                    help="'bench': the capture tier; 'full': the batch-16, "
                         "6k-step calibration tier")
    ga.add_argument("--device", default="cuda")
    ga.set_defaults(fn=_cmd_gates)

    pt = sub.add_parser(
        "pretrain",
        help="pretrain the VGG16 backbone as a classifier of hard-benchmark "
             "crops and export a .caffemodel fine-tune seed")
    pt.add_argument("--out", default="vgg16.caffemodel")
    pt.add_argument("--classes", type=int, default=4)
    pt.add_argument("--steps", type=int, default=1500)
    pt.add_argument("--lr", type=float, default=3e-4)
    pt.add_argument("--seed", type=int, default=0)
    pt.add_argument("--device", default="cuda")
    pt.set_defaults(fn=_cmd_pretrain)

    d = sub.add_parser("detect", help="run the detector over image files")
    d.add_argument("images", nargs="+")
    d.add_argument("--model", default="googlenet_detectnet")
    d.add_argument("--weights", default=None,
                   help=".caffemodel file or Trainer snapshot directory")
    d.add_argument("--threshold", type=float, default=0.5)
    d.add_argument("--min-boxes", type=int, default=3)
    d.add_argument("--nms-eps", type=float, default=0.2)
    d.add_argument("--manifest", default=None,
                   help="label manifest ('idx name' / 'idx _ name' lines) "
                        "naming classes in the output")
    d.add_argument("--overlay-dir", default=None,
                   help="write each input's detection overlay here as "
                        "<stem>_det.png")
    d.add_argument("--device", default="cuda")
    d.set_defaults(fn=_cmd_detect)

    rp = sub.add_parser("replay", help="stream frame files through the "
                                       "detector node")
    rp.add_argument("images", nargs="*")
    rp.add_argument("--video", default=None,
                    help="camera recording (MJPG AVI) as the frame source")
    rp.add_argument("--video-stride", type=int, default=1,
                    help="keep every Nth video frame")
    rp.add_argument("--max-frames", type=int, default=0,
                    help="cap the number of video frames (0 = all)")
    rp.add_argument("--model", default="googlenet_detectnet")
    rp.add_argument("--weights", default=None)
    rp.add_argument("--micro-batch", type=int, default=0,
                    help="> 0: batched throughput mode instead of "
                         "per-frame bus replay")
    rp.add_argument("--device", default="cuda")
    rp.set_defaults(fn=_cmd_replay)

    x = sub.add_parser("export", help="the serving pipeline as a "
                                      "torch.export artifact")
    x.add_argument("--model", default="googlenet_detectnet")
    x.add_argument("--weights", default=None,
                   help="snapshot dir or .caffemodel (shapes only; weights "
                        "are a call argument, not stored)")
    x.add_argument("--batch", type=int, default=8)
    x.add_argument("--out", default="detector.pt2")
    x.add_argument("--device", default="cuda",
                   help="the device the program is traced for and runs on")
    x.set_defaults(fn=_cmd_export)

    ln = sub.add_parser("launch", help="build a node graph from a JSON "
                                       "launch spec and stream frames "
                                       "through it")
    ln.add_argument("graph", help="JSON launch spec "
                                  "(see examples/*.launch.json)")
    ln.add_argument("--frames", nargs="*", default=None,
                    help="image files to publish through the graph")
    ln.add_argument("--video", default=None,
                    help="camera recording (MJPG AVI) to publish through "
                         "the graph, with its source stamps")
    ln.add_argument("--video-stride", type=int, default=1,
                    help="keep every Nth video frame")
    ln.add_argument("--max-frames", type=int, default=0,
                    help="cap the number of video frames (0 = all)")
    ln.add_argument("--topic", default="image",
                    help="topic the frames are published on")
    ln.add_argument("--spin", type=int, default=1,
                    help="bus spins when no frames are given")
    ln.add_argument("--bus", default=None,
                    help="attach to a cross-process broker "
                         "(tcp://host:port, see `cli bus`)")
    ln.add_argument("--nodes", default=None,
                    help="comma-separated subset of the spec to run in "
                         "this process")
    ln.add_argument("--serve", type=float, default=None,
                    help="spin for SECONDS serving remote-bus traffic "
                         "(0 = until SIGINT); for node-only processes")
    ln.add_argument("--device", default="cuda",
                    help="device of the nodes that do not set one")
    ln.set_defaults(fn=_cmd_launch)

    bs = sub.add_parser("bus", help="run the cross-process topic broker")
    bs.add_argument("--port", type=int, default=0,
                    help="TCP port (0 = ephemeral, printed on start)")
    bs.add_argument("--python", action="store_true",
                    help="the pure-Python broker instead of the native one")
    bs.add_argument("--max-outbox", type=int, default=64,
                    help="per-subscriber queued-frame cap (drop-oldest)")
    bs.set_defaults(fn=_cmd_bus)

    pf = sub.add_parser("profile", help="per-kernel device time")
    pf.add_argument("--model", action="append", default=None,
                    help="registered model name, repeatable (default: "
                         "googlenet_detectnet and its _serving preset)")
    pf.add_argument("--batch", type=int, default=8)
    pf.add_argument("--iters", type=int, default=10)
    pf.add_argument("--top", type=int, default=25,
                    help="rows to print (0 = all)")
    pf.add_argument("--max-candidates", type=int, default=256)
    pf.add_argument("--train", action="store_true",
                    help="profile the train step (forward, backward, Adam) "
                         "instead of the serving pipeline")
    pf.add_argument("--logdir", default=None,
                    help="write the Chrome trace here (one subdirectory "
                         "per model when there are several)")
    pf.add_argument("--json", action="store_true",
                    help="one JSON line per model instead of the table")
    pf.add_argument("--device", default="cuda")
    pf.set_defaults(fn=_cmd_profile)

    t = sub.add_parser("train", help="train a recipe from record shards or "
                                     "from composed scenes")
    t.add_argument("--recipe", default="bounding_box")
    t.add_argument("--manifest", default=None,
                   help="mask manifest of the crops, composed on the host "
                        "(or the device, --device-data)")
    t.add_argument("--records", default=None,
                   help="train from record shards (the prefix given to "
                        "`records --out`) instead of composed scenes")
    t.add_argument("--backgrounds", nargs="*", default=None)
    t.add_argument("--max-iter", type=int, default=None)
    t.add_argument("--batch-size", type=int, default=None)
    t.add_argument("--iter-size", type=int, default=1,
                   help="Caffe gradient accumulation: one update per N "
                        "micro-batches, with their mean gradient")
    t.add_argument("--snapshot-dir", default=None)
    t.add_argument("--metrics-out", default=None, metavar="FILE",
                   help="write the per-display-step metrics as JSONL")
    t.add_argument("--weights", default=None,
                   help="initial weights: a .caffemodel (lenient, by name) "
                        "or a Trainer snapshot directory")
    t.add_argument("--workers", type=int, default=0,
                   help="scene-builder worker processes (0 = in-process)")
    t.add_argument("--warmup", type=int, default=0, metavar="N",
                   help="linear lr warmup over the first N steps")
    t.add_argument("--inspect-data", default=None, metavar="DIR",
                   help="data dry-run: the first batch as overlay PNGs "
                        "(+ seg masks) in DIR, then exit")
    t.add_argument("--device-data", action="store_true",
                   help="compose scenes on the device instead of the "
                        "host")
    t.add_argument("--cache", type=int, default=0,
                   help="build N batches once and train epochs over them "
                        "on the device")
    t.add_argument("--eval-every", type=int, default=0, metavar="N",
                   help="score the held-out set every N steps and keep the "
                        "best snapshot in <snapshot-dir>/best")
    t.add_argument("--val-records", default=None, metavar="PREFIX",
                   help="held-out record shards for --eval-every "
                        "(detection families: mAP@0.5 under the full "
                        "serving pipeline)")
    t.add_argument("--val-manifest", default=None, metavar="FILE",
                   help="held-out manifest for --eval-every: detection "
                        "lines, or the mask manifest for seg-only families")
    t.add_argument("--val-limit", type=int, default=64)
    t.add_argument("--device", default="cuda")
    t.set_defaults(fn=_cmd_train)

    r = sub.add_parser("records", help="build record shards from a manifest "
                                       "(the LMDB writer's counterpart)")
    r.add_argument("--manifest", default=None)
    r.add_argument("--format", choices=("detection", "voc"),
                   default="detection",
                   help="manifest format: `path x y w h label` lines "
                        "(1-based labels) or the VOC converter's "
                        "comma-grouped multi-box manifests (0-based)")
    r.add_argument("--out", required=True, help="shard prefix")
    r.add_argument("--inspect", action="store_true",
                   help="read back the records at --out and print their "
                        "shapes and labels instead of writing")
    r.add_argument("--limit", type=int, default=10)
    r.add_argument("--augment", action="store_true",
                   help="bake the reference's offline augmentation into the "
                        "shards (original, flip, zoom-crop, blur per sample)")
    r.add_argument("--relabel", action="store_true",
                   help="map labels to contiguous 0..K-1 ids (the map is "
                        "saved as <out>.labelmap.json)")
    r.add_argument("--background", action="store_true",
                   help="contiguous ids shifted by 1, so that id 0 is a "
                        "learned background class")
    r.set_defaults(fn=_cmd_records)

    v = sub.add_parser("voc", help="Pascal VOC annotations -> manifests")
    v.add_argument("voc_root")
    v.add_argument("--out", default=".")
    v.add_argument("--classes", nargs="*", default=None,
                   help="class names in label order (default: the 20 "
                        "Pascal VOC classes); objects of other names are "
                        "skipped")
    v.set_defaults(fn=_cmd_voc)

    e = sub.add_parser("eval", help="held-out mAP or mean-IoU of weights "
                                    "over a manifest")
    e.add_argument("--manifest", required=True)
    e.add_argument("--format", choices=("voc", "detection", "seg"),
                   default="voc")
    e.add_argument("--model", default="vgg_pyramid_detectnet")
    e.add_argument("--weights", default=None,
                   help="Trainer snapshot directory or .caffemodel file")
    e.add_argument("--num-classes", type=int, default=0,
                   help="the head width of weights trained with another "
                        "class count than the registry's")
    e.add_argument("--iou", type=float, default=0.5)
    e.add_argument("--limit", type=int, default=10 ** 9)
    e.add_argument("--labels", default=None,
                   help="label-manifest snapshot pinning seg class ids to "
                        "the training run's (--format seg)")
    e.add_argument("--device", default="cuda")
    e.set_defaults(fn=_cmd_eval)

    c = sub.add_parser("convert", help="a .caffemodel -> tpufcn's .npz "
                                       "parameter tree of a model")
    c.add_argument("caffemodel")
    c.add_argument("--model", default="googlenet_detectnet")
    c.add_argument("--out", default="weights.npz")
    c.add_argument("--lenient", action="store_true")
    c.set_defaults(fn=_cmd_convert)

    def _tool_args(sp):
        sp.add_argument("--manifest", required=True)
        sp.add_argument("--out", default=None,
                        help="output manifest (default: next to the "
                             "input, the reference's convention)")
        sp.add_argument("--threshold", type=float, default=0.5)
        sp.add_argument("--extractor-weights", default=None,
                        help="VGG16 .caffemodel for the CNN-code "
                             "extractor (seeded init otherwise)")
        sp.add_argument("--input-size", type=int, default=224)
        sp.add_argument("--dtype", choices=("bfloat16", "float32"),
                        default="bfloat16",
                        help="the extractor's compute dtype")
        sp.add_argument("--device", default="cuda")

    rf = sub.add_parser("refine",
                        help="offline boundary-refinement walk "
                             "(boundary_refinement.py analog)")
    _tool_args(rf)
    rf.set_defaults(fn=_cmd_refine)

    rk = sub.add_parser("rank",
                        help="proposal ranking / outlier rejection "
                             "(rank_object_models.py analog)")
    _tool_args(rk)
    rk.add_argument("--metric", choices=("bhattacharyya", "chi_square"),
                    default="bhattacharyya")
    rk.set_defaults(fn=_cmd_rank)

    pm = sub.add_parser("pointmap", help="build the C++ point-map library")
    pm.set_defaults(fn=_cmd_pointmap)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
