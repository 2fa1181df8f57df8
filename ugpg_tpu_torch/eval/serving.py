"""Serving: a bucketed ``Predictor`` and the ``BatchingServer`` micro-batcher.

Counterpart of ``ugpg_tpu/eval/serving.py``, on BN-folded weights.
Requests are (N, H, W, 3) numpy images, float32 in [0, 1] or uint8.
Segmentation responses are numpy (preds, probs, uncertainty) maps of shape
(N, res, res, K); classification ones are (labels (N,) int32, probs (N, K)
float32), with ``mc_dropout=N`` a third output, the predictive variance
(N,).  Ragged batches route to the smallest bucket that fits, padding is
stripped, and larger requests run in chunks of the largest bucket
(``_BucketRouter``, a copy of ``ugpg_tpu/eval/exported.py``'s).

On the GPU every DoubleConv, every Up-block upsample and the uncertainty
map run the port's CUDA kernels (9, 4 and 1 launches per stage-4
segmentation call; 4 double convs per stage-4 classifier call).
``fold_bn=False`` serves the live-BN model in plain PyTorch instead, as
the JAX package's live-BN ``Predictor`` runs it in XLA; the uncertainty map
keeps its kernel.  ``stream`` overlaps the copy of batch k + 1 to the
device with batch k's forward (``data/loader.py::prefetch_to_device``).

``stage_model`` and ``classifier_model`` build a checkpoint's model the
way the serving paths run it, for the evaluators and the slide predictor
too.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Iterator, Mapping, Sequence

import numpy as np
import torch

from ugpg_tpu_torch.data.loader import prefetch_to_device
from ugpg_tpu_torch.device import resolve_device
from ugpg_tpu_torch.io.checkpoint import classifier_state_dict, load_checkpoint
from ugpg_tpu_torch.models.blocks import DoubleConv
from ugpg_tpu_torch.models.classifier import CLS_STAGE_RESOLUTIONS, HerlevClassificationModel
from ugpg_tpu_torch.models.folding import fold_batchnorm
from ugpg_tpu_torch.models.pgunet import STAGE_MODELS, STAGE_RESOLUTIONS
from ugpg_tpu_torch.ops.cuda.uncertainty import uncertainty_from_logits
from ugpg_tpu_torch.ops.resize import resize_bilinear_align_corners
from ugpg_tpu_torch.uncertainty import mc_dropout_uncertainty

__all__ = ["Predictor", "BatchingServer", "stage_model", "classifier_model"]

_INPUT_DTYPES = {torch.float32: np.dtype(np.float32), torch.uint8: np.dtype(np.uint8)}


def _resize_nhwc(images: np.ndarray, res: int) -> np.ndarray:
    """Host-side bilinear (align_corners) resize of float32 NHWC images."""
    x = torch.from_numpy(np.ascontiguousarray(images, dtype=np.float32)).permute(0, 3, 1, 2)
    return resize_bilinear_align_corners(x, (res, res)).permute(0, 2, 3, 1).numpy()


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


class _BucketRouter:
    """Fixed-bucket request routing.

    Requires ``buckets`` (ascending), ``batch_size`` (largest bucket),
    ``resolution``, ``input_dtype``, ``_n_outputs`` and
    ``_dispatch(bucket, chunk) -> tuple``.  ``stats()`` reports request
    counters and latency percentiles over a sliding window.
    """

    def __init__(self):
        self._stats_lock = threading.Lock()
        self._n_requests = 0
        self._n_images = 0
        self._n_device_calls = 0
        self._total_s = 0.0
        self._latencies = deque(maxlen=1024)  # per-request wall seconds

    def _dispatch(self, bucket: int, chunk):
        raise NotImplementedError

    def stats(self) -> dict:
        """Request counters + latency percentiles (sliding 1024 window)."""
        with self._stats_lock:
            lat = list(self._latencies)
            out = {
                "requests": self._n_requests,
                "images": self._n_images,
                "device_calls": self._n_device_calls,
                "total_seconds": round(self._total_s, 6),
            }
        lat.sort()
        if lat:
            def pct(p):
                return round(lat[min(len(lat) - 1, int(p / 100.0 * len(lat)))] * 1e3, 3)
            out["latency_ms"] = {"p50": pct(50), "p95": pct(95), "p99": pct(99)}
        return out

    def _record(self, dt: float, n_images: int, n_device_calls: int) -> None:
        with self._stats_lock:
            self._n_requests += 1
            self._n_images += n_images
            self._n_device_calls += n_device_calls
            self._total_s += dt
            self._latencies.append(dt)

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def _coerce(self, images: np.ndarray) -> np.ndarray:
        """Match the served input signature: dtype and spatial size."""
        images = np.asarray(images)
        res = self.resolution
        if self.input_dtype == np.uint8:
            if images.dtype != np.uint8:
                images = np.clip(np.asarray(images, np.float32) * 255.0, 0, 255).astype(np.uint8)
        else:
            if images.dtype == np.uint8:
                images = images.astype(np.float32) / 255.0
            else:
                images = np.asarray(images, np.float32)
        if images.shape[1:3] != (res, res):
            # arbitrary request sizes: resize on the host once
            x = images.astype(np.float32)
            if images.dtype == np.uint8:
                x = x / 255.0
            images = _resize_nhwc(x, res)
            if self.input_dtype == np.uint8:
                images = np.clip(images * 255.0, 0, 255).astype(np.uint8)
        return images

    def _run_padded(self, chunk: np.ndarray):
        n = chunk.shape[0]
        bucket = self._bucket_for(n)
        if n < bucket:
            pad = np.zeros((bucket - n, *chunk.shape[1:]), chunk.dtype)
            chunk = np.concatenate([chunk, pad])
        outs = self._dispatch(bucket, chunk)
        return tuple(o[:n] for o in outs)

    def __call__(self, images: np.ndarray):
        """images: (N, H, W, 3) float32 in [0,1] or uint8 RGB; any N.
        -> numpy (preds, probs, uncertainty)."""
        t0 = time.perf_counter()
        images = self._coerce(images)
        outs = [
            self._run_padded(images[s: s + self.batch_size])
            for s in range(0, len(images), self.batch_size)
        ]
        result = tuple(
            np.concatenate([np.asarray(o[i]) for o in outs]) for i in range(self._n_outputs)
        )
        self._record(time.perf_counter() - t0, len(images), len(outs))
        return result


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
    ):
        """``checkpoint``: a reference-format ``.pth`` (``ugpg-export-torch``).
        ``dtype``: compute dtype of the network body (heads stay float32).
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
        ``device``: ``cuda`` unless given; raises without CUDA."""
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
        deferred = {"quantize": quantize, "mesh": mesh is not None, "shard_model": shard_model}
        missing = [name for name, asked in deferred.items() if asked]
        if missing:
            raise NotImplementedError(
                f"not ported to ugpg_tpu_torch yet: {', '.join(missing)} (see ROADMAP.md)")
        self.input_dtype = _INPUT_DTYPES.get(input_dtype) or np.dtype(input_dtype)
        if self.input_dtype not in (np.dtype(np.float32), np.dtype(np.uint8)):
            raise ValueError("input_dtype must be float32 or uint8")
        self.task_type = task_type
        self.buckets = tuple(sorted(set(buckets or (batch_size,))))
        self.batch_size = self.buckets[-1]
        self.threshold = float(threshold)
        self.emit_uncertainty = emit_uncertainty
        self.mc_dropout = int(mc_dropout)
        self.mc_seed = int(mc_seed)
        self._pred_dtype = torch.uint8 if compact_output else torch.float32
        self._map_dtype = torch.float16 if compact_output else torch.float32

        self.stage, state_dict = load_checkpoint(checkpoint)
        if task_type == "classification":
            self.resolution = CLS_STAGE_RESOLUTIONS[self.stage]
            self.model = classifier_model(self.stage, state_dict, self.device, num_classes,
                                          dtype, fold_bn)
            self._n_outputs = 3 if mc_dropout else 2
        else:
            self.resolution = STAGE_RESOLUTIONS[self.stage]
            self.model = stage_model(self.stage, state_dict, self.device, num_classes, dtype,
                                     fold_bn)
            self._n_outputs = 3

    @torch.inference_mode()
    def _forward(self, x: torch.Tensor) -> tuple[torch.Tensor, ...]:
        """(B, H, W, 3) request images on the device -> NHWC (preds, probs,
        uncertainty), or (labels, probs[, variance]), on the device."""
        x = x.permute(0, 3, 1, 2).float()  # NCHW view of NHWC (channels_last) memory
        if self.input_dtype == np.uint8:
            x = x / 255.0
        if self.task_type == "classification":
            return self._classify(x)
        logits = self.model(x)
        probs = torch.sigmoid(logits)
        preds = (probs > self.threshold).to(self._pred_dtype)
        if self.emit_uncertainty:
            unc = uncertainty_from_logits(logits)
        else:
            unc = torch.zeros_like(probs)
        outs = (preds, probs.to(self._map_dtype), unc.to(self._map_dtype))
        return tuple(o.permute(0, 2, 3, 1) for o in outs)

    def _classify(self, x: torch.Tensor) -> tuple[torch.Tensor, ...]:
        if not self.mc_dropout:
            probs = torch.softmax(self.model(x).float(), dim=-1)
            return probs.argmax(-1).to(torch.int32), probs
        # the encoder has no dropout and its BN is in eval mode: one pass of
        # it, then the head's N stochastic passes
        feats = self.model.features(x)
        generator = torch.Generator(device=self.device).manual_seed(self.mc_seed)
        mean, var = mc_dropout_uncertainty(
            lambda h, g: self.model.head(h, active=True, generator=g), feats, generator,
            num_samples=self.mc_dropout, task_type="classification")
        return mean.argmax(-1).to(torch.int32), mean, var

    def _dispatch(self, bucket: int, chunk: np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(chunk)).to(self.device)
        return tuple(o.cpu().numpy() for o in self._forward(x))

    def export(self, *args, **kwargs):
        raise NotImplementedError("Predictor.export is not ported to ugpg_tpu_torch yet")

    def stream(self, batches: Iterator[np.ndarray], prefetch: int = 2):
        """Yield the numpy outputs (as ``__call__`` returns them) for each
        batch of ``batches`` (any size up to the largest bucket, padded to
        it), with the copy of the next ``prefetch`` batches to the device
        overlapped with the current one's forward."""
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
