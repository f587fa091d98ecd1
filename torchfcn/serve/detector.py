"""The serving pipeline of the port (``tpufcn/serve/detector.py``):

    raw BGR frames -> preprocess ("shift127": resize other sizes only;
    "demean": demean + min-max at the input resolution, then resize) ->
    forward -> grid decode -> top-K candidate select -> groupRectangles NMS
    -> rescale to frame coords

PyTorch runs it eagerly; the stem (LRN, or the fused stem tail of the fp8
serving preset) and groupRectangles steps are hand-written CUDA kernels on a
CUDA device and their plain versions on the CPU.

On a (data, space) mesh (``Detector(mesh=...)``, one process per rank,
``torchfcn.core.mesh``) every rank is given the global frame batch and moves
only its share to its device: its batch shard (``data``) and, with
``space > 1``, its band of each frame's rows (``core.mesh.row_bands``,
bands of other lengths where the rows do not split evenly).  Each rank runs
the forward on its share (row-sharded with halo exchange), the heads' bands
are gathered within the space group, decode, top-K and groupRectangles run
per data shard (every space rank of a shard repeats them, as the JAX
package's shard_map does), and the data shards' results are gathered, so
that every rank returns the global ``DetectionResult``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn as nn

from torchfcn.convert import resolve_weights
from torchfcn.core.config import DetectorConfig
from torchfcn.core.device import port_device
from torchfcn.core.dtypes import DTypePolicy
from torchfcn.core.mesh import DATA_AXIS, SPACE_AXIS, Mesh, space_sharded
from torchfcn.models import build as build_model, get_spec
from torchfcn.ops.grid_codec import decode_gridboxes
from torchfcn.ops.group_rects import vote_boxes_batched
from torchfcn.ops.image import demean_bgr, preprocess_bgr, resize_bilinear
from torchfcn.serve.result import DetectionResult

# select_candidates clamps rounded coords to what the reference's packed sort
# payload holds, so that results stay bit-identical to it
_COORD_MIN, _COORD_MAX = -2048.0, 2047.0


def select_candidates(cvg: torch.Tensor, boxes: torch.Tensor,
                      valid: torch.Tensor, k: int):
    """Top-K candidates by coverage among valid cells, ties by cell index.

    Args:
      cvg: (..., M) coverage scores in [0, 1].
      boxes: (..., M, 4) decoded cell boxes.
      valid: (..., M) bool.
      k: candidates kept per instance.
    Returns (boxes (..., k, 4) rounded to integers and clamped to
    [-2048, 2047], valid (..., k)).  groupRectangles rounds on entry anyway;
    invalid cells sort last with score -1.
    """
    key = -torch.where(valid, cvg, -1.0)
    key, order = torch.sort(key, dim=-1, stable=True)
    order = order[..., :k]
    r = torch.clamp(torch.round(boxes), _COORD_MIN, _COORD_MAX)
    cand = torch.gather(r, -2, order[..., None].expand(*order.shape, 4))
    return cand, key[..., :k] <= 0.0


def preprocess(frames: torch.Tensor, mode: str,
               net_hw: Tuple[int, int]) -> torch.Tensor:
    """Family-specific preprocessing (``tpufcn/serve/detector.py:107-126``).

    "shift127" (GoogLeNet DetectNet, ResNet-FPN): frames at the net's size
    go to the model as they are (it normalises them itself); other sizes
    are resized, as float32, with JAX's antialiased bilinear resize.
    "demean" (VGG and FCN families): float32, demean + min-max per image at
    the input resolution, then the resize where the size differs.
    """
    if mode == "demean":
        return preprocess_bgr(frames, net_hw)
    if tuple(frames.shape[-3:-1]) == tuple(net_hw):
        return frames
    return resize_bilinear(frames, net_hw)


def serving_policy(dtype: torch.dtype,
                   policy: Optional[DTypePolicy]) -> DTypePolicy:
    """``policy``, or by default the whole model in ``dtype``."""
    return policy or DTypePolicy(param_dtype=dtype, compute_dtype=dtype)


def serving_model(model_name: str, dtype: torch.dtype, rng_seed: int,
                  model_kwargs: Optional[dict], device,
                  policy: Optional[DTypePolicy] = None,
                  weights: Optional[str] = None) -> nn.Module:
    """The zoo model ``model_name`` built with ``model_kwargs``, seeded
    Caffe "xavier" weights from ``rng_seed`` or ``weights``
    (``torchfcn.convert.resolve_weights``), under ``policy`` (by default
    parameters and compute in ``dtype``), ``channels_last`` on ``device``
    ("cuda", which raises without CUDA, or "cpu"), in eval mode."""
    device = port_device(device, model_name)
    model = build_model(model_name, **(model_kwargs or {}))
    model.init_weights(torch.Generator().manual_seed(rng_seed))
    resolve_weights(weights, model)
    serving_policy(dtype, policy).apply(model)
    return model.to(device=device, memory_format=torch.channels_last)


def model_and_device(model: Optional[nn.Module], model_name: str,
                     dtype: torch.dtype, rng_seed: int,
                     model_kwargs: Optional[dict], device,
                     policy: DTypePolicy, weights: Optional[str]):
    """(model, device) of a serving surface: ``model`` as it is on its own
    device, or else ``serving_model``'s."""
    if model is not None:
        return model, next(model.parameters()).device
    return (serving_model(model_name, dtype, rng_seed, model_kwargs, device,
                          policy, weights), torch.device(device))


class Detector:
    """Detector over any detection family of the zoo.

    Example:
        det = Detector("googlenet_detectnet", max_candidates=256)
        result = det(frames_u8)   # (B, H, W, 3) BGR, boxes in frame coords

    ``device`` defaults to "cuda" and raises if CUDA is absent; pass
    "cpu" to run the plain versions of the kernels.  The model's parameters
    and convolutions are in ``dtype`` (bf16 for serving), unless a
    ``policy`` (``torchfcn.core.dtypes.DTypePolicy``) replaces it; a float32
    model runs with TF32 off.  Weights are the seeded Caffe "xavier" init
    (``rng_seed``), or ``weights`` (a ``.caffemodel`` or a Trainer
    snapshot directory; see also ``from_checkpoint``), or loaded later,
    e.g. with ``torchfcn.convert.from_jax.load_jax_params(det.model,
    tree)``.
    ``model_kwargs`` go to the model's constructor (e.g.
    ``{"store_dtype": torch.float8_e5m2}``); a ``num_classes`` there also
    sets the decode grid's.  The NMS kernel takes at most
    ``ops.cuda.group_rects.MAX_CANDIDATES`` candidates per class.
    ``model``: a model of ``model_name`` to serve as it is, with its own
    parameters, dtypes and device (a Trainer's live model, for the
    validators); nothing is built, cast or loaded then, and ``dtype``
    only picks the default policy's precision scope.
    ``mesh``: a ``torchfcn.core.mesh.Mesh``; every rank builds the Detector
    and calls it with the same global batch, a multiple of ``data``.  The
    model runs on the mesh's device (``device`` is not read), with rank
    0's parameters broadcast to every rank.  ``space > 1`` shards the
    rows of every detection family's net (``core.mesh.row_bands``: each
    band but the last a multiple of 32 rows, the last the remainder; it
    raises for fewer than space x 32 rows, the last 32 may be partial).
    """

    def __init__(self,
                 model_name: str = "googlenet_detectnet",
                 config: Optional[DetectorConfig] = None,
                 dtype: torch.dtype = torch.bfloat16,
                 max_candidates: Optional[int] = None,
                 rng_seed: int = 0,
                 model_kwargs: Optional[dict] = None,
                 device="cuda",
                 policy: Optional[DTypePolicy] = None,
                 weights: Optional[str] = None,
                 model: Optional[nn.Module] = None,
                 mesh: Optional[Mesh] = None):
        self.spec = get_spec(model_name)
        if "coverage" not in self.spec.heads:
            raise ValueError(f"{model_name} has no detection heads; serve "
                             f"it with torchfcn.serve.segment.Segmenter")
        self.policy = serving_policy(dtype, policy)
        if mesh is not None:
            extra = {a: n for a, n in mesh.shape.items()
                     if a not in (DATA_AXIS, SPACE_AXIS) and n > 1}
            if extra:
                raise ValueError(
                    f"Detector(mesh=...) shards over '{DATA_AXIS}' and "
                    f"'{SPACE_AXIS}' only; mesh has extra non-trivial axes "
                    f"{extra} whose chips would run redundant replicas — "
                    "pass a (data, space) mesh, e.g. "
                    "make_mesh(MeshConfig(data=N, space=M))")
            device = mesh.device
        self.mesh = mesh
        self.model, self.device = model_and_device(
            model, model_name, dtype, rng_seed, model_kwargs, device,
            self.policy, weights)
        if mesh is not None:
            from torchfcn.parallel.distributed import shard_params_replicated
            shard_params_replicated(self.model, mesh)
        grid = self.spec.grid
        if model_kwargs and "num_classes" in model_kwargs:
            grid = dataclasses.replace(
                grid, num_classes=model_kwargs["num_classes"])
        self.config = config or DetectorConfig(
            grid=grid, model=model_name, max_candidates=max_candidates)
        self.grid = self.config.grid

    @property
    def num_fg(self) -> int:
        """The number of foreground classes decoded."""
        c = self.grid.num_classes
        return c - 1 if self.spec.background_channel is not None else c

    def _forward(self, frames: torch.Tensor, params: Optional[dict] = None,
                 banded: bool = False):
        """Preprocess + model forward -> (coverage, bboxes) NHWC grids, with
        the model's own parameters or ``params`` (a name -> tensor map of
        every parameter and buffer, ``torch.func.functional_call``).  On a
        mesh ``frames`` are this rank's share (``_share``; ``banded``: its
        rows alone) and the grids its data shard's, gathered within the
        space group."""
        net_hw = (self.grid.im_height, self.grid.im_width)
        mesh = self.mesh
        if banded:
            x = demean_bgr(frames, mesh) \
                if self.spec.preprocessing == "demean" else frames
        else:
            x = preprocess(frames, self.spec.preprocessing, net_hw)
            if space_sharded(mesh):
                x = x[:, self._rows(net_hw[0])]
        kw = {} if mesh is None else {"mesh": mesh}
        out = (self.model(x, **kw) if params is None else
               torch.func.functional_call(self.model, params, (x,), kw))
        coverage, bboxes = out["coverage"], out["bboxes"]
        if space_sharded(mesh):
            # both heads' bands in one gather
            from torchfcn.parallel.distributed import all_gather_bands
            both = all_gather_bands(torch.cat([coverage, bboxes], dim=-1),
                                    mesh.space_group, dim=1)
            coverage, bboxes = both.split([coverage.shape[-1],
                                           bboxes.shape[-1]], dim=-1)
        return coverage, bboxes

    def _rows(self, rows: int) -> slice:
        offset, n = self.mesh.band(rows)
        return slice(offset, offset + n)

    def _share(self, frames: torch.Tensor):
        """(this rank's share of the global batch ``frames`` on its device,
        whether it is a band of rows): the batch shard and, under row
        sharding, its rows of frames at the net's size (frames of another
        size move whole, to be resized first).  Raises on a batch the data
        axis does not divide, and on rows too few to split."""
        mesh = self.mesh
        n = mesh.shape[DATA_AXIS]
        if frames.shape[0] % n:
            raise ValueError(
                f"sharded serving needs batch size divisible by the mesh "
                f"data axis ({n}); got {frames.shape[0]}")
        b = frames.shape[0] // n
        frames = frames[mesh.data_index * b:(mesh.data_index + 1) * b]
        net_hw = (self.grid.im_height, self.grid.im_width)
        banded = space_sharded(mesh) and tuple(frames.shape[1:3]) == net_hw
        if space_sharded(mesh):
            rows = self._rows(net_hw[0])   # raises on rows too few to split
            if banded:
                frames = frames[:, rows]
        return frames.to(self.device), banded

    def _pipeline(self, frames: torch.Tensor,
                  params: Optional[dict] = None) -> DetectionResult:
        if frames.dim() != 4 or frames.shape[-1] != 3:
            raise ValueError(f"frames must be (B, H, W, 3), got "
                             f"{tuple(frames.shape)}")
        in_hw = tuple(frames.shape[1:3])
        banded = False
        if self.mesh is not None:
            frames, banded = self._share(frames)
        with self.policy.precision():
            coverage, bboxes = self._forward(frames, params, banded)
        result = self._decode_nms(coverage, bboxes, in_hw)
        if self.mesh is None:
            return result
        from torchfcn.parallel.distributed import all_gather_cat
        return DetectionResult(*(all_gather_cat(t, self.mesh.data_group)
                                 for t in result))

    def forward_fn(self):
        """``(fn, params)``: ``fn(params, frames) -> DetectionResult`` is the
        whole pipeline (``tpufcn/serve/detector.py:312-315``) with the
        parameters as an explicit input, run without autograd under the
        Detector's policy; ``params`` maps the name of every parameter and
        buffer of the model to its tensor.  Another map of the same names
        serves other weights with no rebuild (``serve/export.py`` exports
        ``fn``)."""
        params = dict(self.model.named_parameters())
        params.update(self.model.named_buffers())

        def fn(params: dict, frames: torch.Tensor) -> DetectionResult:
            with torch.no_grad():
                return self._pipeline(self._as_frames(frames), params)
        return fn, params

    def _as_frames(self, frames) -> torch.Tensor:
        """The frames as a tensor: on this Detector's device, or on a mesh
        where they are (``_share`` moves each rank's share alone)."""
        if self.mesh is not None:
            return torch.as_tensor(frames)
        return torch.as_tensor(frames, device=self.device)

    def _decode_nms(self, coverage: torch.Tensor, bboxes: torch.Tensor,
                    in_hw: Tuple[int, int]) -> DetectionResult:
        cfg, grid = self.config, self.grid
        in_h, in_w = in_hw

        bg = self.spec.background_channel
        if bg is not None:
            # Skip the background coverage channel and pair foreground class
            # k with bbox block k, the block its training encoder writes
            # (tpufcn/serve/detector.py:253-271).
            keep = [c for c in range(grid.num_classes) if c != bg]
            coverage = coverage[..., keep]
            bboxes = bboxes[..., [4 * c + i for c in keep for i in range(4)]]
            dec_grid = dataclasses.replace(grid, num_classes=len(keep))
        else:
            dec_grid = grid

        k = min(cfg.candidate_capacity, dec_grid.grid_h * dec_grid.grid_w)
        boxes, cvg, valid = decode_gridboxes(coverage, bboxes, dec_grid,
                                             cfg.detection_threshold)
        cand_boxes, cand_valid = select_candidates(cvg, boxes, valid, k)
        b, c = cand_boxes.shape[:2]
        det = vote_boxes_batched(
            cand_boxes.reshape(b * c, k, 4), cand_valid.reshape(b * c, k),
            cfg.min_boxes, cfg.nms_eps, cfg.min_box_height)

        # back to frame coords (reference fcn_object_detector.py:396-405):
        # int boxes, then scaled values truncated into an int array
        diff = torch.tensor([in_w / grid.im_width, in_h / grid.im_height] * 2,
                            dtype=torch.float32, device=det.boxes.device)
        d_boxes = torch.trunc(torch.trunc(det.boxes) * diff).int()
        return DetectionResult(d_boxes.reshape(b, c, k, 4),
                               det.confidence.reshape(b, c, k),
                               det.valid.reshape(b, c, k))

    @torch.inference_mode()
    def __call__(self, frames) -> DetectionResult:
        """frames: (B, H, W, 3) BGR, uint8 or float in [0, 255], of any
        size; boxes come back in the frames' coordinates.  On a mesh every
        rank passes the same global batch and gets the global result."""
        return self._pipeline(self._as_frames(frames))

    @classmethod
    def from_checkpoint(cls, snapshot_dir: str,
                        model_name: str = "googlenet_detectnet",
                        step: Optional[int] = None, **kwargs) -> "Detector":
        """A Detector with the parameters of a Trainer snapshot (the latest,
        or ``step``).  A snapshot of an exact net loads into its
        ``_serving`` preset too: the presets share the parameters."""
        from torchfcn.train.trainer import load_snapshot_params
        det = cls(model_name, **kwargs)
        det.model.load_state_dict(load_snapshot_params(snapshot_dir, step))
        return det
