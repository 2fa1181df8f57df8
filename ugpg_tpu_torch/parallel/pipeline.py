"""The uncertainty pipeline: the frozen previous stage's forward as a
producer beside the train step (counterpart of
``ugpg_tpu/parallel/pipeline.py``).

Every train step after stage 1 runs two forwards per batch: the current
stage's (forward and backward) and the frozen previous stage's, which only
produces the uncertainty.  The pipeline splits them:

    producer (unc group):   resize -> (augment) -> previous stage, eval
                            -> sigmoid -> upsample  => probs_up    (k+1)
    consumer (train group): the external-uncertainty train step     (k)

The producer runs up to ``depth`` batches ahead of the consumer.  For
classification it hands over the per-sample weights (B,) instead.

Semantics are exact: the producer repeats the step's preprocessing (the
stage resize, the augmentation on the same drawn parameters, and for
classification the ImageNet normalisation), so the frozen forward sees the
pixels the fused step would give it.  Per batch the augmentation
parameters are drawn once, per micro-batch in the step's order
(``data/augment.py``), and the same draw goes to the producer and to the
step: the counterpart of the one key per batch that the JAX package hands
both programs.  The two halves are named profiler regions
(``uncertainty_pipeline.produce``, ``uncertainty_pipeline.train_step``).

Devices: the last ``n_unc`` of ``devices`` are the unc group, the others
the train group, as in the JAX package: a train mesh ``make_mesh(n_train //
n_model, n_model)`` over the first ``n_train = (len(train) // n_model) *
n_model`` train devices and an unc mesh ``make_mesh(n_unc, 1)``.  A
position in a group is a shard, also where the list names one device more
than once.  The consumer is the external-uncertainty step on the train
mesh (``shard_model`` when ``n_model > 1``; ``train/steps.py``).  The
producer splits each batch over the unc mesh's ``data`` axis and runs the
frozen stage on every shard, one copy of it per distinct unc device; the
shards' outputs join in order on the train mesh's first device, where the
step splits them again over its own ``data`` axis.  They are the only
traffic between the groups.  A group of one position runs unsharded, on
its one device.  On a card each distinct unc device runs its shards on a
CUDA stream of its own, and the consumer's stream waits on an event
recorded after them; on the CPU the same code runs without streams.
Whether the side stream gains anything on one card is a measurement
(``chip_smoke.py``), not a claim.

``run_epoch_scan`` (the trainers' ``scan_epochs``) pipelines whole chunks:
the epoch's uniform prefix in equal chunks of at most ``chunk_bytes``
(``train/steps.py::plan_epoch_chunks``), each stacked and moved once to the
unc group and once to the train group; the producer makes the chunk's
block of maps (segmentation) or weights (classification) one chunk ahead
of the consumer, which runs the previous chunk's steps eagerly; the ragged
tail runs per step.  The steps and the draws are ``run_epoch``'s, so the
trajectory is too.
"""

from __future__ import annotations

import copy
from collections import deque
from typing import Any, Sequence

import torch
from torch import nn

from ugpg_tpu_torch.data.augment import (
    apply_herlev_params,
    apply_monuseg_params,
    imagenet_normalize,
    sample_herlev_params,
    sample_monuseg_params,
)
from ugpg_tpu_torch.ops.resize import resize_bilinear_align_corners
from ugpg_tpu_torch.parallel.mesh import Mesh, make_mesh, tensor_device
from ugpg_tpu_torch.train.steps import (
    CLS_METRIC_KEYS,
    METRIC_KEYS,
    _nchw,
    _row,
    make_cls_train_step,
    make_seg_train_step,
    micro_params,
    plan_epoch_chunks,
    stack_epoch,
)
from ugpg_tpu_torch.uncertainty import classification_uncertainty_weights
from ugpg_tpu_torch.utils.profiling import annotate

__all__ = ["split_devices", "pipeline_devices", "pipeline_device_list", "pipeline_check",
           "UncertaintyPipeline"]


def split_devices(n_unc: int, devices=None):
    """Split the devices into (train group, unc group): the last ``n_unc``
    run the uncertainty producer.  ``devices=None``: the visible CUDA
    devices.  A list may name one device more than once."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if not 1 <= n_unc < len(devices):
        raise ValueError(
            f"n_unc={n_unc} must leave at least one train device out of "
            f"{len(devices)} visible")
    return devices[:-n_unc], devices[-n_unc:]


def pipeline_devices(n_unc: int, devices=None, n_model: int = 1) -> tuple[Mesh, Mesh]:
    """(train mesh, unc mesh) of ``split_devices(n_unc, devices)``, as the
    JAX pipeline builds them; ``ValueError`` when the train group cannot
    hold one row of ``n_model`` devices."""
    train, unc = split_devices(n_unc, devices)
    n_train = (len(train) // n_model) * n_model
    if n_train == 0:
        raise ValueError(
            f"{len(train)} train device(s) cannot host a "
            f"model-axis of {n_model}")
    return (make_mesh(n_train // n_model, n_model, devices=train[:n_train]),
            make_mesh(n_unc, 1, devices=unc))


def pipeline_device_list(n_unc: int, device: torch.device, devices=None) -> list[torch.device]:
    """The devices a trainer on ``device`` pipelines over: ``devices`` when
    given (the counterpart of the JAX trainer's ``jax.devices()``), else the
    visible cards on ``cuda`` and, on the CPU, which torch counts as one
    device, the CPU ``n_unc + 1`` times."""
    if devices is not None:
        return [torch.device(d) for d in devices]
    if device.type == "cpu":
        return [device] * (n_unc + 1)
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def pipeline_check(n_unc: int, device: torch.device, devices=None) -> torch.device:
    """Raise now what a trainer on ``device`` with ``pipeline_unc=n_unc``
    would raise at its first pipelined stage (what the JAX pipeline
    raises); return the device its models live on, the train mesh's
    first."""
    train, _ = pipeline_devices(n_unc, pipeline_device_list(n_unc, device, devices))
    return tensor_device(train.first)


def _build_seg_unc_body(prev_model: nn.Module, resolution: int, prev_resolution: int,
                        augment: bool, aug_quantize: int = 0):
    """Producer of segmentation: NCHW images and the drawn parameters (or
    None) -> probs_up (B, K, resolution, resolution), as the fused step's
    chain (``train/steps.py::make_seg_train_step``) computes it."""

    @torch.no_grad()
    def unc_fn(images: torch.Tensor, aug: dict | None) -> torch.Tensor:
        x = resize_bilinear_align_corners(images, (resolution, resolution))
        if augment:  # the image half: masks do not move the image transform
            x, _ = apply_monuseg_params(x, x[:, :1], aug, quantize_angles=aug_quantize)
        prev_model.eval()
        x_prev = resize_bilinear_align_corners(x, (prev_resolution, prev_resolution))
        return resize_bilinear_align_corners(torch.sigmoid(prev_model(x_prev)),
                                             (resolution, resolution))

    return unc_fn


def _build_cls_unc_body(prev_model: nn.Module, resolution: int, prev_resolution: int,
                        num_classes: int, alpha: float, augment: bool, normalize: bool):
    """Producer of classification: NCHW images and the drawn parameters
    (or None) -> the per-sample weights 1 + alpha A (B,), after the step's
    augmentation, normalisation and resize."""

    @torch.no_grad()
    def unc_fn(images: torch.Tensor, aug: dict | None) -> torch.Tensor:
        if augment:
            images = apply_herlev_params(images, aug)
        if normalize:
            images = imagenet_normalize(images)
        x = resize_bilinear_align_corners(images, (resolution, resolution))
        prev_model.eval()
        x_prev = resize_bilinear_align_corners(x, (prev_resolution, prev_resolution))
        return classification_uncertainty_weights(prev_model(x_prev), num_classes, alpha)

    return unc_fn


class UncertaintyPipeline:
    """Producer and consumer for one progressive stage (stage > 1).

    ``model``, ``prev_model``: the current and the frozen previous stage;
    ``optimizer`` holds ``model``'s parameters to train.  ``task_type``:
    'segmentation' (``probs_up`` handed over, a ``pos_weight`` scalar) or
    'classification' (per-sample weights, a ``class_weights`` vector).
    ``n_unc``: devices of the producer, from the tail of ``devices``;
    ``n_model``: the train mesh's ``model`` axis.  ``alpha``, ``augment``,
    ``fused_loss``, ``accum_steps``, ``aug_quantize``, ``num_classes``,
    ``normalize``: as the steps take them.  ``depth``: how many batches
    the producer may run ahead.
    """

    def __init__(self, model: nn.Module, prev_model: nn.Module,
                 optimizer: torch.optim.Optimizer, stage: int, resolution: int,
                 prev_resolution: int, *, task_type: str = "segmentation", n_unc: int = 1,
                 n_model: int = 1, devices=None, alpha: float = 1.0, augment: bool = False,
                 fused_loss: bool = False, num_classes: int = 1, normalize: bool = False,
                 depth: int = 2, accum_steps: int = 1, aug_quantize: int = 0):
        if stage <= 1:
            raise ValueError(
                "pipeline parallelism applies to stages > 1 (stage 1 has no "
                "frozen previous model to offload)")
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        if task_type not in ("segmentation", "classification"):
            raise ValueError(f"unknown task_type: {task_type!r}")
        if task_type == "classification" and aug_quantize:
            raise ValueError("aug_quantize applies to the segmentation augmentation only")
        self.train_mesh, self.unc_mesh = pipeline_devices(n_unc, devices, n_model)
        self.train_device = tensor_device(self.train_mesh.first)
        # one position: the unsharded step on that device
        mesh = self.train_mesh if self.train_mesh.devices.size > 1 else None
        self.task_type = task_type
        self.depth = depth
        self.accum_steps = int(accum_steps)
        self.augment = augment
        self.aug_quantize = int(aug_quantize)
        self.model, self.prev_model = model, prev_model
        if task_type == "segmentation":
            self._unc_body = lambda prev: _build_seg_unc_body(
                prev, resolution, prev_resolution, augment, self.aug_quantize)
            self._step = make_seg_train_step(
                model, optimizer, stage, resolution, alpha=alpha, augment=augment,
                fused_loss=fused_loss, accum_steps=self.accum_steps,
                external_uncertainty=True, aug_quantize=self.aug_quantize, mesh=mesh,
                shard_model=n_model > 1)
        else:
            self._unc_body = lambda prev: _build_cls_unc_body(
                prev, resolution, prev_resolution, num_classes, alpha, augment, normalize)
            self._step = make_cls_train_step(
                model, optimizer, stage, resolution, num_classes, alpha=alpha,
                augment=augment, normalize=normalize, accum_steps=self.accum_steps,
                external_uncertainty=True, mesh=mesh, shard_model=n_model > 1)
        self._unc: dict = {}  # the producer per distinct unc device, once place_prev has run
        self._side = {dev: torch.cuda.Stream(dev) for dev in self.unc_mesh.distinct_devices()
                      if dev.type == "cuda"}

    # ------------------------------------------------------------------
    def create_state(self) -> nn.Module:
        """Put the current stage on the train mesh's first device (its
        parameters stay the optimizer's); returns the model."""
        return self.model.to(self.train_device)

    def place_prev(self) -> nn.Module:
        """The frozen previous stage on every distinct unc device, in eval
        mode (a copy where it lives elsewhere); the producers run it from
        here on.  Returns the copy on the unc mesh's first device."""
        here = next(self.prev_model.parameters()).device
        self._unc = {}
        for dev in self.unc_mesh.distinct_devices():
            prev = self.prev_model
            if here != tensor_device(dev) or len(self._unc):
                prev = copy.deepcopy(prev).to(dev)
            self._unc[dev] = (self._unc_body(prev.eval()), prev)
        return self._unc[self.unc_mesh.first][1]

    # ------------------------------------------------------------------
    def run_epoch(self, batches: Sequence[tuple], loss_weights, aug=None,
                  generator: torch.Generator | None = None) -> list[dict[str, Any]]:
        """Pipelined epoch: produce batch k + 1 .. k + depth before training
        on batch k.  ``batches``: host ``(images NHWC, masks NHW1)`` or
        ``(images NHWC, labels (B,))``; ``loss_weights``: ``pos_weight`` or
        ``class_weights`` (or None).  ``aug`` (with ``augment=True``): a
        ``torch.Generator`` from which every batch's parameters are drawn
        in order before the epoch starts, or one drawn dict per batch.
        ``generator``: the classification step's dropout masks.  Returns
        the per-step metrics (device scalars)."""
        batches = list(batches)
        if not batches:
            return []
        if not self._unc:
            self.place_prev()
        self._validate_batches(batches)
        params = self._draw(batches, aug)
        metrics: list[dict[str, Any]] = []
        inflight: deque = deque()
        for batch, p in zip(batches, params):
            inflight.append(self._produce(batch, p))
            if len(inflight) > self.depth:
                metrics.append(self._consume(inflight.popleft(), loss_weights, generator))
        while inflight:
            metrics.append(self._consume(inflight.popleft(), loss_weights, generator))
        return metrics

    def run_epoch_scan(self, batches: Sequence[tuple], loss_weights, aug=None,
                       generator: torch.Generator | None = None,
                       chunk_bytes: int | None = None) -> tuple[list, list]:
        """Chunk-level pipelined epoch (the module's docstring; the JAX
        package's ``run_epoch_scan``): the producer one chunk ahead of the
        consumer.  Arguments as ``run_epoch``'s; ``chunk_bytes`` caps a
        chunk (None: the whole uniform prefix).  Returns ``(parts,
        tail_metrics)``: per chunk the (S, 6) metric rows of its steps on
        the train device (``METRIC_KEYS``, or ``CLS_METRIC_KEYS`` as
        floats), and the tail steps' metrics."""
        batches = list(batches)
        if not batches:
            return [], []
        if not self._unc:
            self.place_prev()
        self._validate_batches(batches)
        params = self._draw(batches, aug)
        ranges, tail_start = plan_epoch_chunks(batches, chunk_bytes)
        keys = METRIC_KEYS if self.task_type == "segmentation" else CLS_METRIC_KEYS
        parts: list = []
        inflight: deque = deque()
        unc_home = tensor_device(self.unc_mesh.first)
        for a, b in ranges:
            stacked, _ = stack_epoch(batches[a:b])
            images_u = torch.as_tensor(stacked[0]).to(unc_home)  # moved once per group
            train = [torch.as_tensor(x).to(self.train_device) for x in stacked]
            with annotate("uncertainty_pipeline.produce_chunk"):
                block = [self._produce((images_u[s], None), params[a + s])[0]
                         for s in range(b - a)]
            inflight.append((block, train, params[a:b]))
            if len(inflight) > 1:  # one chunk ahead
                parts.append(self._consume_chunk(inflight.popleft(), loss_weights, generator,
                                                 keys))
        while inflight:
            parts.append(self._consume_chunk(inflight.popleft(), loss_weights, generator, keys))
        tail = [self._consume(self._produce(batch, p), loss_weights, generator)
                for batch, p in zip(batches[tail_start:], params[tail_start:])]
        return parts, tail

    def _consume_chunk(self, item, loss_weights, generator, keys) -> torch.Tensor:
        block, (images, masks_or_labels), params = item
        return torch.stack([_row(self._consume((outs, (images[s], masks_or_labels[s]),
                                                params[s]), loss_weights, generator), keys)
                            for s, outs in enumerate(block)])

    def _draw(self, batches: list, aug) -> list:
        """The augmentation parameters of every batch (None without)."""
        if not self.augment:
            return [None] * len(batches)
        if aug is None:
            raise ValueError("augment=True: pass aug, a torch.Generator or one dict per batch")
        if not isinstance(aug, torch.Generator):
            if len(aug) < len(batches):
                raise ValueError(f"need {len(batches)} parameter draws, got {len(aug)}")
            return list(aug[:len(batches)])
        out = []
        for images, _ in batches:
            b, h, w = images.shape[:3]
            if self.task_type == "segmentation":
                def draw(m):
                    return sample_monuseg_params(aug, m, quantize_angles=self.aug_quantize)
            else:
                def draw(m, h=h, w=w):
                    return sample_herlev_params(aug, m, h, w)
            out.append(micro_params(draw, b, self.accum_steps))
        return out

    def _produce(self, batch: tuple, params: dict | None):
        """Start the producer on ``batch``, a shard per unc position:
        ([(output, its event or None, its device)], batch, params)."""
        n = self.unc_mesh.shape["data"]
        rows = batch[0].shape[0] // n
        outs = []
        with annotate("uncertainty_pipeline.produce"):
            for i in range(n):
                dev = self.unc_mesh.device_at(data=i)
                unc_fn = self._unc[dev][0]
                images = _nchw(batch[0][i * rows:(i + 1) * rows], dev)
                p_unc = (None if params is None else
                         {k: v[i * rows:(i + 1) * rows].to(dev) for k, v in params.items()})
                side = self._side.get(dev)
                if side is None:
                    outs.append((unc_fn(images, p_unc), None, dev))
                    continue
                side.wait_stream(torch.cuda.current_stream(dev))
                with torch.cuda.stream(side):
                    out = unc_fn(images, p_unc)
                    done = torch.cuda.Event()
                    done.record(side)
                # inputs made on the consumer's stream stay allocated until the producer is done
                for t in (images, *(p_unc or {}).values()):
                    t.record_stream(side)
                outs.append((out, done, dev))
        return outs, batch, params

    def _consume(self, item, loss_weights, generator) -> dict[str, Any]:
        outs, batch, params = item
        parts = []
        for out, done, dev in outs:
            if done is not None:
                stream = torch.cuda.current_stream(dev)
                stream.wait_event(done)
                out.record_stream(stream)
            parts.append(out.to(self.train_device))
        unc = parts[0] if len(parts) == 1 else torch.cat(parts)
        p_train = (None if params is None
                   else {k: v.to(self.train_device) for k, v in params.items()})
        with annotate("uncertainty_pipeline.train_step"):
            if self.task_type == "segmentation":
                return self._step(batch, loss_weights, aug=p_train, unc=unc)
            return self._step(batch, loss_weights, generator, aug=p_train, unc=unc)

    def _validate_batches(self, batches: Sequence[tuple]) -> None:
        """Reject, before the epoch starts, a batch that does not split over
        both groups' ``data`` axes, or into ``accum_steps`` micro-batches per
        train data shard (a ``drop_last=False`` loader's short final batch),
        with the JAX package's messages."""
        n_t = self.train_mesh.shape["data"]
        n_u = self.unc_mesh.shape["data"]
        for i, batch in enumerate(batches):
            b = batch[0].shape[0]
            if b % n_t or b % n_u:
                raise ValueError(
                    f"batch {i} has size {b}, which must divide both the "
                    f"train mesh's data axis ({n_t}) and the unc group "
                    f"({n_u}); pick n_unc so that (n_devices - n_unc) and "
                    f"n_unc both divide every batch, and drop or pad the "
                    f"ragged final batch (loader drop_last=True)")
            if b % (self.accum_steps * n_t):
                raise ValueError(
                    f"batch {i} has size {b}, not divisible into "
                    f"accum_steps={self.accum_steps} micro-batches per "
                    f"data shard ({n_t})")
