"""Serving: a bucketed ``Predictor`` and the ``BatchingServer`` micro-batcher.

Counterpart of ``ugpg_tpu/eval/serving.py``, on BN-folded weights.
Requests are (N, H, W, 3) numpy images, float32 in [0, 1] or uint8.
Segmentation responses are numpy (preds, probs, uncertainty) maps of shape
(N, res, res, K); classification ones are (labels (N,) int32, probs (N, K)
float32), with ``mc_dropout=N`` a third output, the predictive variance
(N,).  Ragged batches route to the smallest bucket that fits, padding is
stripped, and larger requests run in chunks of the largest bucket
(``eval/exported.py::_BucketRouter``, as in the JAX package).
``Predictor.export`` writes a ``torch.export`` artifact of it, which
``ExportedPredictor`` serves without model code; ``ServingRegistry``
serves several predictors and artifacts by name.

On the GPU every DoubleConv, every Up-block upsample and the uncertainty
map run the port's CUDA kernels (9, 4 and 1 launches per stage-4
segmentation call; 4 double convs per stage-4 classifier call).
``quantize=True`` serves the W8A8 int8 graph (``ops/quant.py``): int8
convs as ``torch._int_mm`` GEMMs, the upsample and the uncertainty map on
their kernels (4 and 1 launches per stage-4 call, no double conv).
``fold_bn=False`` serves the live-BN model in plain PyTorch instead, as
the JAX package's live-BN ``Predictor`` runs it in XLA; the uncertainty map
keeps its kernel.  ``stream`` overlaps the copy of batch k + 1 to the
device with batch k's forward (``data/loader.py::prefetch_to_device``).

``mesh`` (``parallel/mesh.py``; one process drives every device of it):
each bucket's rows split over the mesh's ``data`` axis, each part served
by a replica on its data row's first device (one per distinct device, the
weights packed once there), and the outputs gather on the mesh's first
device in request order.  ``shard_model=True`` with a ``model`` axis of
more than one device runs the wide convs column-parallel over each data
row (``parallel/tensor.py``).  Both compose with either task,
``quantize``, ``mc_dropout`` (the masks of the whole bucket, drawn as one
device draws them, split by row) and ``stream``; ``export`` writes the
unsharded artifact.

``stage_model`` and ``classifier_model`` build a checkpoint's model the
way the serving paths run it, for the evaluators and the slide predictor
too.
"""

from __future__ import annotations

import copy
import json
import queue
import threading
import time
import warnings
from collections import deque
from concurrent.futures import Future
from pathlib import Path
from typing import Iterable, Iterator, Mapping, Sequence

import numpy as np
import torch

from ugpg_tpu_torch.data.loader import prefetch_to_device
from ugpg_tpu_torch.device import resolve_device
from ugpg_tpu_torch.eval.exported import (
    PLATFORMS,
    ExportedPredictor,
    _BucketRouter,
    check_platforms,
)
from ugpg_tpu_torch.io.checkpoint import classifier_state_dict, load_checkpoint
from ugpg_tpu_torch.models.blocks import DoubleConv
from ugpg_tpu_torch.models.classifier import CLS_STAGE_RESOLUTIONS, HerlevClassificationModel
from ugpg_tpu_torch.models.folding import fold_batchnorm
from ugpg_tpu_torch.models.pgunet import STAGE_MODELS, STAGE_RESOLUTIONS
from ugpg_tpu_torch.ops.cuda.library import uncertainty_from_logits
from ugpg_tpu_torch.ops.quant import QuantizedClassifier, QuantizedModel
from ugpg_tpu_torch.parallel.mesh import data_axis_size, shard_batch
from ugpg_tpu_torch.parallel.tensor import column_parallel
from ugpg_tpu_torch.uncertainty import mc_dropout_uncertainty

__all__ = ["Predictor", "BatchingServer", "ServingRegistry", "stage_model", "classifier_model"]

_INPUT_DTYPES = {torch.float32: np.dtype(np.float32), torch.uint8: np.dtype(np.uint8)}


def stage_model(stage: int, state_dict: Mapping[str, torch.Tensor], device: torch.device,
                num_classes: int = 1, dtype: torch.dtype = torch.float32,
                fold_bn: bool = True) -> torch.nn.Module:
    """The stage's model in eval mode on ``device``, its weights loaded
    strictly from a reference-named ``state_dict``.  ``fold_bn=True``: BN
    folded into the convs (``use_bn=False``), the body cast to ``dtype``,
    every DoubleConv's weights packed once in the kernels' layout.
    ``fold_bn=False``: the live-BN model, float32 parameters, ``dtype``
    the compute dtype."""
    model = STAGE_MODELS[stage](num_classes=num_classes, use_bn=not fold_bn, dtype=dtype)
    return _served(model, state_dict, device, fold_bn)


def classifier_model(stage: int, state_dict: Mapping[str, torch.Tensor], device: torch.device,
                     num_classes: int = 7, dtype: torch.dtype = torch.float32,
                     fold_bn: bool = True) -> HerlevClassificationModel:
    """The stage's Herlev classifier as ``stage_model`` builds a segmentation
    stage, from a reference classifier ``state_dict`` (its decoder keys
    dropped, ``io/checkpoint.py::classifier_state_dict``)."""
    model = HerlevClassificationModel(stage, num_classes, use_bn=not fold_bn, dtype=dtype)
    return _served(model, classifier_state_dict(state_dict, stage), device, fold_bn)


def _served(model: torch.nn.Module, state_dict, device: torch.device, fold_bn: bool):
    model.load_state_dict(fold_batchnorm(state_dict) if fold_bn else state_dict, strict=True)
    model = model.to(device).eval()
    if fold_bn:
        for block in model.modules():  # the kernels' weight layouts, made once
            if isinstance(block, DoubleConv):
                block.pack()
    return model


class _BucketEntry(torch.nn.Module):
    """What ``Predictor.export`` traces for one bucket: the predictor's
    ``_graph`` over its model, and with MC dropout the bucket's head masks
    as buffers."""

    def __init__(self, predictor: "Predictor", masks):
        super().__init__()
        self.model = predictor.model  # the weights, lifted into the program
        self._graph = predictor._graph
        self._present = [[m is not None for m in layer] for layer in masks or ()]
        for i, layer in enumerate(masks or ()):
            for j, mask in enumerate(layer):
                if mask is not None:
                    self.register_buffer(f"mask_{i}_{j}", mask, persistent=False)

    def forward(self, raw: torch.Tensor) -> tuple[torch.Tensor, ...]:
        masks = None
        if self._present:
            masks = [[getattr(self, f"mask_{i}_{j}") if present else None
                      for j, present in enumerate(layer)]
                     for i, layer in enumerate(self._present)]
        return self._graph(raw, masks)


class Predictor(_BucketRouter):
    """Bucketed predictor on BN-folded weights.

    Example:
        p = Predictor("ug_pgunet_stage4_best.pth", buckets=(1, 8, 64))
        preds, probs, unc = p(images)          # any leading batch size

        c = Predictor("herlev_stage4_best.pth", task_type="classification",
                      num_classes=7)
        labels, probs = c(images)
    """

    def __init__(
        self,
        checkpoint: str,
        batch_size: int = 64,
        num_classes: int = 1,
        dtype: torch.dtype = torch.bfloat16,
        threshold: float = 0.5,
        emit_uncertainty: bool = True,
        fold_bn: bool = True,
        task_type: str = "segmentation",
        buckets: Sequence[int] | None = None,
        input_dtype=np.float32,
        quantize: bool = False,
        compact_output: bool = False,
        mesh=None,
        shard_model: bool = False,
        mc_dropout: int = 0,
        mc_seed: int = 0,
        device: str | torch.device | None = None,
        calibration_batches: Iterable[np.ndarray] | None = None,
    ):
        """``checkpoint``: a reference-format ``.pth``, or a msgpack or orbax
        checkpoint directory that the JAX package or the port wrote
        (``io/checkpoint.py``).
        ``dtype``: compute dtype of the network body (heads stay float32);
        None is the checkpoint's float32, as the JAX package's command
        lines ask for it.
        ``threshold``: preds are ``probs > threshold``.
        ``input_dtype``: float32 or uint8 requests (uint8 is divided by 255
        on the device).  ``compact_output`` (segmentation): uint8 preds,
        float16 maps.  ``fold_bn=False``: the live-BN model in plain
        PyTorch (float32 parameters, ``dtype`` the compute dtype).
        ``task_type="classification"``: a Herlev classifier checkpoint
        with ``num_classes`` classes; responses (labels, probs).
        ``mc_dropout=N`` (classification): the encoder runs once and the
        head N times with dropout active, BN in eval mode; labels and
        probs come from the mean, and a third output is the variance
        averaged over classes.  The masks come from a generator seeded by
        ``mc_seed`` at every call, so equal requests get equal responses.
        ``quantize=True`` (either task): the W8A8 int8 graph
        (``ops/quant.py``), BN folded, activation scales calibrated by the
        bf16 walker on ``calibration_batches`` (an iterable of (B, H, W, 3)
        float images from the real input distribution; required, there is
        no default); ``dtype`` does not apply to it.
        ``mesh`` (``parallel/mesh.py::make_mesh``; it must have a ``data``
        axis that divides every bucket): data-parallel serving, the rows of
        each bucket split over ``data``, answering as one device does.
        ``shard_model=True`` with a ``model`` axis of more than one device
        also runs the convs of at least 256 output channels column-parallel
        over each data row (the TP layout of ``param_shardings``).
        ``device``: ``cuda`` unless given; raises without CUDA.  With a
        mesh the predictor's device is the mesh's first, and ``device``, if
        given, must be of its type."""
        _BucketRouter.__init__(self)
        self.device = resolve_device(device)
        if task_type not in ("segmentation", "classification"):
            raise ValueError(f"unknown task_type: {task_type!r}")
        if compact_output and task_type != "segmentation":
            raise ValueError("compact_output=True supports segmentation only")
        if mc_dropout:
            if task_type != "classification":
                raise ValueError(
                    "mc_dropout requires task_type='classification': the PGUNet segmentation "
                    "stages have no dropout layers (the seg uncertainty map is the "
                    "1-2|p-0.5| output already in the response)")
            if quantize:
                raise ValueError("mc_dropout is not supported with quantize=True: the int8 "
                                 "classification graph has no dropout layers")
            if mc_dropout < 2:
                raise ValueError(f"mc_dropout={mc_dropout}: need >= 2 stochastic passes "
                                 "for a variance")
        self.input_dtype = _INPUT_DTYPES.get(input_dtype) or np.dtype(input_dtype)
        if self.input_dtype not in (np.dtype(np.float32), np.dtype(np.uint8)):
            raise ValueError("input_dtype must be float32 or uint8")
        self.task_type = task_type
        self.buckets = tuple(sorted(set(buckets or (batch_size,))))
        self.batch_size = self.buckets[-1]
        self.mesh = mesh
        n_data = 1
        if mesh is not None:
            n_data = data_axis_size(mesh)
            bad = [b for b in self.buckets if b % n_data]
            if bad:
                raise ValueError(
                    f"buckets {bad} do not divide by the mesh 'data' axis size ({n_data}): "
                    "each bucket's rows split evenly over the data axis")
            if device is not None and self.device.type != mesh.first.type:
                raise ValueError(f"device {self.device} is not of the mesh's type ({mesh.first})")
            self.device = mesh.first
        self._shard_model = bool(shard_model) and mesh is not None \
            and mesh.shape.get("model", 1) > 1
        self.quantize = bool(quantize)
        if quantize:
            if calibration_batches is None:
                raise ValueError(
                    "quantize=True requires calibration_batches: an iterable of (B, H, W, 3) "
                    "float arrays from the real input distribution (scales calibrated on "
                    "random data silently degrade accuracy, so there is no default)")
            # per device: under a mesh each data row sees bucket / n_data images
            per_device = self.batch_size // n_data
            if task_type == "segmentation" and per_device >= 32 and per_device % 128:
                warnings.warn(
                    f"quantize=True with largest per-device bucket {per_device}: the JAX "
                    "package asks for a multiple of 128 for int8 segmentation throughput "
                    "buckets (latency buckets under 32 are exempt), a rule measured on its "
                    "TPU; PERF.md has this port's int8 numbers per bucket", stacklevel=2)
        self.threshold = float(threshold)
        self.emit_uncertainty = emit_uncertainty
        self.mc_dropout = int(mc_dropout)
        self.mc_seed = int(mc_seed)
        self._pred_dtype = torch.uint8 if compact_output else torch.float32
        self._map_dtype = torch.float16 if compact_output else torch.float32

        dtype = torch.float32 if dtype is None else dtype
        self.dtype = dtype
        self.stage, state_dict = load_checkpoint(checkpoint)
        if task_type == "classification":
            self.resolution = CLS_STAGE_RESOLUTIONS[self.stage]
            if quantize:
                self.model = QuantizedClassifier.from_state_dict(
                    classifier_state_dict(state_dict, self.stage), self.stage,
                    calibration_batches, self.device)
            else:
                self.model = classifier_model(self.stage, state_dict, self.device,
                                              num_classes, dtype, fold_bn)
            self._n_outputs = 3 if mc_dropout else 2
        else:
            self.resolution = STAGE_RESOLUTIONS[self.stage]
            if quantize:
                self.model = QuantizedModel.from_state_dict(state_dict, self.stage,
                                                            calibration_batches, self.device)
            else:
                self.model = stage_model(self.stage, state_dict, self.device, num_classes,
                                         dtype, fold_bn)
            self._n_outputs = 3
        if mesh is not None:
            self._rows = self._place(mesh, n_data)

    def _place(self, mesh, n_data: int) -> list[tuple[torch.device, torch.nn.Module]]:
        """(device, model) of each data row: a replica of ``self.model`` on
        the row's first device (one per distinct device), column-parallel
        over the row's devices with ``shard_model``."""
        n_model = mesh.shape.get("model", 1)
        replicas = {self.device: self.model}
        parallel = {}
        rows = []
        for i in range(n_data):
            devices = tuple(mesh.device_at(data=i, model=j) for j in range(n_model))
            home = devices[0]
            if home not in replicas:
                replicas[home] = copy.deepcopy(self.model).to(home)
            model = replicas[home]
            if self._shard_model:
                if devices not in parallel:
                    parallel[devices] = column_parallel(model, devices)
                model = parallel[devices]
            rows.append((home, model))
        return rows

    @torch.inference_mode()
    def _forward(self, x: torch.Tensor) -> tuple[torch.Tensor, ...]:
        """(B, H, W, 3) request images (on the device; under a mesh on any
        device) -> NHWC (preds, probs, uncertainty), or (labels, probs[,
        variance]), on the device."""
        if self.mesh is None:
            return self._graph(x)
        masks = self._mc_masks(x.shape[0]) if self.mc_dropout else None
        rows = x.shape[0] // len(self._rows)
        outs = []
        for i, ((home, model), part) in enumerate(zip(self._rows, shard_batch(x, self.mesh))):
            row_masks = None if masks is None else [
                [None if m is None else m[i * rows:(i + 1) * rows].to(home) for m in layer]
                for layer in masks]
            outs.append(self._graph(part, row_masks, model))
        return tuple(torch.cat([o[k].to(self.device, non_blocking=True) for o in outs])
                     for k in range(len(outs[0])))

    def _graph(self, x: torch.Tensor, masks=None, model=None) -> tuple[torch.Tensor, ...]:
        """``_forward``'s body on ``model`` (default ``self.model``), which an
        exported bucket runs too (``masks``: the MC-dropout head masks baked
        into it, see ``export``)."""
        model = self.model if model is None else model
        x = x.permute(0, 3, 1, 2).float()  # NCHW view of NHWC (channels_last) memory
        if self.input_dtype == np.uint8:
            x = x / 255.0
        if self.task_type == "classification":
            return self._classify(model, x, masks)
        logits = model(x)
        probs = torch.sigmoid(logits)
        preds = (probs > self.threshold).to(self._pred_dtype)
        if self.emit_uncertainty:
            unc = uncertainty_from_logits(logits)
        else:
            unc = torch.zeros_like(probs)
        outs = (preds, probs.to(self._map_dtype), unc.to(self._map_dtype))
        return tuple(o.permute(0, 2, 3, 1) for o in outs)

    def _classify(self, model, x: torch.Tensor, masks=None) -> tuple[torch.Tensor, ...]:
        if not self.mc_dropout:
            probs = torch.softmax(model(x).float(), dim=-1)
            return probs.argmax(-1).to(torch.int32), probs
        # the encoder has no dropout and its BN is in eval mode: one pass of
        # it, then the head's N stochastic passes
        feats = model.features(x)
        if masks is None:
            generator = torch.Generator(device=self.device).manual_seed(self.mc_seed)

            def head(h, g):
                return model.head(h, active=True, generator=g)
        else:
            generator, passes = None, iter(masks)

            def head(h, g):
                return model.head(h, active=True, keep=next(passes))
        mean, var = mc_dropout_uncertainty(head, feats, generator, num_samples=self.mc_dropout,
                                           task_type="classification")
        return mean.argmax(-1).to(torch.int32), mean, var

    def _mc_masks(self, bucket: int) -> list:
        """The head masks a call on ``bucket`` rows draws, pass by pass, from
        the generator seeded by ``mc_seed`` on this device: what an
        exported bucket bakes in to answer as this predictor does."""
        generator = torch.Generator(device=self.device).manual_seed(self.mc_seed)
        return [self.model.head_masks(bucket, generator, self.device)
                for _ in range(self.mc_dropout)]

    def _dispatch(self, bucket: int, chunk: np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(chunk))
        if self.mesh is None:  # under a mesh each row's part goes to its own device
            x = x.to(self.device)
        return tuple(o.cpu().numpy() for o in self._forward(x))

    def export(self, path, platforms: Sequence[str] = PLATFORMS):
        """Write this predictor as an artifact that serves without model
        code or checkpoint (``ExportedPredictor``, ``eval/exported.py``).

        One ``torch.export`` program per bucket, ``bucket_{b}.pt2``, of
        ``_forward`` on a (b, res, res, 3) request in the served input
        dtype: the weights (and the kernels' packed layouts), the threshold,
        the uint8 scaling and the compact outputs inside, the kernels as
        the ``torch.ops.ugpg_torch`` operators; with ``mc_dropout``, the
        bucket's head masks drawn as a live call draws them on this
        device.  Plus ``manifest.json``.  The programs serve on the CPU and
        the GPU (``platforms`` records that).  Answers bit for bit as this
        predictor on the same device (``tests/test_torch_artifact.py``).
        Under a mesh the artifact is the unsharded model (its replica on
        the mesh's first device): the loader picks its own device.
        Returns ``path``."""
        platforms = check_platforms(platforms)
        path = Path(path)
        path.mkdir(parents=True, exist_ok=True)
        res = self.resolution
        in_dtype = torch.uint8 if self.input_dtype == np.uint8 else torch.float32
        for b in self.buckets:
            masks = self._mc_masks(b) if self.mc_dropout else None
            example = torch.zeros((b, res, res, 3), dtype=in_dtype, device=self.device)
            with torch.no_grad():
                program = torch.export.export(_BucketEntry(self, masks), (example,))
            torch.export.save(program, str(path / f"bucket_{b}.pt2"))
        manifest = {
            "format_version": 1,
            "task_type": self.task_type,
            "stage": self.stage,
            "resolution": self.resolution,
            "buckets": list(self.buckets),
            "input_dtype": self.input_dtype.name,
            "n_outputs": self._n_outputs,
            "platforms": platforms,
            "torch_version": torch.__version__,
        }
        (path / "manifest.json").write_text(json.dumps(manifest, indent=1))
        return path

    def stream(self, batches: Iterator[np.ndarray], prefetch: int = 2):
        """Yield the numpy outputs (as ``__call__`` returns them) for each
        batch of ``batches`` (any size up to the largest bucket, padded to
        it), with the copy of the next ``prefetch`` batches to the device
        overlapped with the current one's forward.  Under a mesh a batch
        arrives on the mesh's first device and its rows move to their
        devices from there."""
        top = self.batch_size
        sizes = deque()  # each batch's real size, in order: the producer runs ahead

        def padded():
            for b in batches:
                b = self._coerce(b)
                n = b.shape[0]
                if n > top:
                    raise ValueError(f"stream: a batch of {n} exceeds the largest bucket {top}")
                if n < top:
                    b = np.concatenate([b, np.zeros((top - n, *b.shape[1:]), b.dtype)])
                sizes.append(n)
                yield (np.ascontiguousarray(b),)

        for (device_batch,) in prefetch_to_device(padded(), size=prefetch, device=self.device):
            outs = self._forward(torch.as_tensor(device_batch).to(self.device))
            n = sizes.popleft()
            yield tuple(o[:n].cpu().numpy() for o in outs)


class BatchingServer:
    """Deadline-bounded dynamic micro-batcher over a ``Predictor``.

    ``submit(image)`` returns a ``concurrent.futures.Future`` immediately;
    a background worker coalesces queued requests into one predictor call
    when either the largest bucket fills or the oldest queued request has
    waited ``max_latency_ms``.  Each future resolves to a tuple of
    per-output arrays for its single image.
    """

    def __init__(self, predictor: Predictor, max_latency_ms: float = 5.0):
        self.predictor = predictor
        self.max_latency_s = max_latency_ms / 1e3
        self._q: queue.Queue = queue.Queue()
        self._closed = False
        self._submit_lock = threading.Lock()
        self._n_submitted = 0
        self._n_groups = 0
        self._max_group = 0
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()

    def stats(self) -> dict:
        """Coalescing counters: how well concurrent submits share calls."""
        with self._submit_lock:
            groups = self._n_groups
            out = {
                "submitted": self._n_submitted,
                "groups": groups,
                "max_group": self._max_group,
            }
        out["mean_group"] = round(out["submitted"] / groups, 3) if groups else 0.0
        return out

    def submit(self, image: np.ndarray) -> Future:
        """image: (H, W, 3) float32 in [0,1] or uint8 RGB."""
        image = np.asarray(image)
        if image.ndim != 3 or image.shape[-1] != 3:
            raise ValueError(f"expected one (H, W, 3) image, got {image.shape}")
        fut: Future = Future()
        # the lock orders the closed-check and the enqueue against close():
        # a submit behind the shutdown sentinel would never resolve
        with self._submit_lock:
            if self._closed:
                raise RuntimeError("server is closed")
            self._n_submitted += 1
            self._q.put((image, fut))
        return fut

    def close(self):
        """Drain outstanding requests, then stop the worker."""
        with self._submit_lock:
            self._closed = True
            self._q.put(None)
        self._worker.join()
        # resolve any request that raced the shutdown sentinel
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is None:
                continue
            image, fut = item
            with self._submit_lock:
                self._n_groups += 1
                self._max_group = max(self._max_group, 1)
            try:
                outs = self.predictor(image[None])
                fut.set_result(tuple(o[0] for o in outs))
            except Exception as exc:
                fut.set_exception(exc)

    def _collect(self):
        """Block for the first request, then gather more until the largest
        bucket fills or the deadline passes.  Returns (items, saw_sentinel)."""
        first = self._q.get()
        if first is None:
            return [], True
        items = [first]
        cap = self.predictor.batch_size
        deadline = time.monotonic() + self.max_latency_s
        saw_sentinel = False
        while len(items) < cap:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                nxt = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt is None:
                saw_sentinel = True
                break
            items.append(nxt)
        return items, saw_sentinel

    def _loop(self):
        while True:
            items, stop = self._collect()
            if items:
                # coerce per item so one malformed request fails only its
                # future (and never the worker); the rest batch together
                good = []
                for im, fut in items:
                    try:
                        good.append((self.predictor._coerce(np.asarray(im)[None])[0], fut))
                    except Exception as exc:
                        fut.set_exception(exc)
                if good:
                    with self._submit_lock:
                        self._n_groups += 1
                        self._max_group = max(self._max_group, len(good))
                    try:
                        outs = self.predictor(np.stack([g for g, _ in good]))
                        for i, (_, fut) in enumerate(good):
                            fut.set_result(tuple(o[i] for o in outs))
                    except Exception as exc:  # the group shares one call
                        for _, fut in good:
                            fut.set_exception(exc)
            if stop:
                return


class ServingRegistry:
    """Named multi-model serving: one surface over many predictors.

    Deployments serve several checkpoints side by side (stage variants,
    segmentation and classification, canary and stable).  The registry
    owns a predictor per name and, on the first ``submit``, a
    ``BatchingServer`` in front of it; duplicate names are rejected,
    shutdown drains cleanly, and a predictor is built outside the
    registry's lock, so that registering a model never stalls live
    traffic.

    Example:
        reg = ServingRegistry()
        reg.register("seg_stage4", "out/ug_pgunet_stage4_best.pth", buckets=(1, 64))
        reg.register("cls", "out/herlev_stage4_best.pth",
                     task_type="classification", num_classes=7)
        preds, probs, unc = reg.predict("seg_stage4", images)
        fut = reg.submit("cls", image)           # micro-batched
        reg.close()
    """

    def __init__(self, max_latency_ms: float = 5.0):
        self._max_latency_ms = max_latency_ms
        self._predictors: dict = {}
        self._servers: dict[str, BatchingServer] = {}
        self._lock = threading.Lock()

    def _add(self, name: str, build):
        with self._lock:
            if name in self._predictors:
                raise ValueError(f"model {name!r} already registered")
        p = build()  # outside the lock: loading a model never blocks submit()
        with self._lock:
            if name in self._predictors:  # lost a registration race
                raise ValueError(f"model {name!r} already registered")
            self._predictors[name] = p
        return p

    def register(self, name: str, checkpoint: str, **predictor_kwargs) -> Predictor:
        """Load a checkpoint as a ``Predictor`` under ``name`` (its options
        in ``predictor_kwargs``, ``mesh`` and ``shard_model`` included);
        duplicate names are rejected."""
        return self._add(name, lambda: Predictor(checkpoint, **predictor_kwargs))

    def register_artifact(self, name: str, path, **kwargs):
        """Register an exported artifact under ``name``: the same traffic
        surface, no model code or checkpoint.  Dispatches on the manifest:
        bucket artifacts (``Predictor.export``) load as
        ``ExportedPredictor``, slide artifacts (``SlidePredictor.export``)
        as ``ExportedSlidePredictor``.  ``kwargs`` (``device``) go to the
        loader."""
        manifest = json.loads((Path(path) / "manifest.json").read_text())
        if manifest.get("kind") == "slide":
            from ugpg_tpu_torch.eval.slide import ExportedSlidePredictor

            return self._add(name, lambda: ExportedSlidePredictor(path, **kwargs))
        return self._add(name, lambda: ExportedPredictor(path, **kwargs))

    def register_slide(self, name: str, checkpoint: str, **slide_kwargs):
        """Register a native-resolution ``SlidePredictor`` under ``name``:
        requests of any size run on the whole image instead of being
        resized to the stage resolution (``eval/slide.py``; spatially
        sharded with ``mesh=`` and ``w_axis=`` in ``slide_kwargs``).  The
        micro-batcher is bypassed: slides of different sizes cannot share a
        call."""
        from ugpg_tpu_torch.eval.slide import SlidePredictor

        return self._add(name, lambda: SlidePredictor(checkpoint, **slide_kwargs))

    def names(self) -> list[str]:
        return sorted(self._predictors)

    def _unknown(self, name: str) -> KeyError:
        return KeyError(f"unknown model {name!r}; registered: {self.names()}")

    def get(self, name: str):
        try:
            return self._predictors[name]
        except KeyError:
            raise self._unknown(name) from None

    def predict(self, name: str, images):
        """Synchronous batch prediction on the named model."""
        return self.get(name)(images)

    def submit(self, name: str, image) -> Future:
        """Micro-batched single-image request (a server per model, made on
        first use).  A server closed between the lookup and the submit is
        replaced and the request sent again."""
        predictor = self.get(name)
        if not getattr(predictor, "micro_batch", True):
            # slide predictors: images of different sizes cannot share one
            # device call; served directly, still as a future
            fut: Future = Future()
            try:
                outs = predictor(np.asarray(image)[None])
                fut.set_result(tuple(o[0] for o in outs))
            except Exception as exc:
                fut.set_exception(exc)
            return fut
        for _ in range(2):
            with self._lock:
                server = self._servers.get(name)
                if server is None:
                    server = BatchingServer(self.get(name), max_latency_ms=self._max_latency_ms)
                    self._servers[name] = server
            try:
                return server.submit(image)
            except RuntimeError:  # closed under us: replace it and try again
                with self._lock:
                    if self._servers.get(name) is server:
                        del self._servers[name]
        raise RuntimeError(f"could not submit to {name!r} (closing repeatedly)")

    def unregister(self, name: str) -> None:
        """Remove a model: drain its micro-batcher, drop the predictor.
        Futures already submitted resolve; later ``predict``/``submit``
        raise KeyError, and the name is free again."""
        with self._lock:
            if name not in self._predictors:
                raise self._unknown(name)
            # both under one lock, so that a concurrent submit cannot make a
            # server for a half-removed name
            del self._predictors[name]
            server = self._servers.pop(name, None)
        if server is not None:
            server.close()  # outside the lock: close() waits for the drain

    def replace(self, name: str, checkpoint: str, **predictor_kwargs):
        """Swap the model behind ``name`` (canary promotion).  The new
        predictor is built before the old one is removed, so the name never
        answers with an error; traffic moves at the next request."""
        p = Predictor(checkpoint, **predictor_kwargs)
        with self._lock:
            if name not in self._predictors:
                raise self._unknown(name)
            server = self._servers.pop(name, None)
            self._predictors[name] = p
        if server is not None:
            server.close()  # drains the futures against the old predictor
        return p

    def stats(self) -> dict:
        """Per-model request, latency and coalescing counters."""
        with self._lock:
            predictors = dict(self._predictors)
            servers = dict(self._servers)
        out = {}
        for name, p in predictors.items():
            entry = {"predictor": p.stats()}
            server = servers.get(name)
            if server is not None:
                entry["batcher"] = server.stats()
            out[name] = entry
        return out

    def close(self):
        """Drain and stop every micro-batcher (the predictors stay usable)."""
        with self._lock:
            servers, self._servers = dict(self._servers), {}
        for server in servers.values():
            server.close()
