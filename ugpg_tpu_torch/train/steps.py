"""Train and eval steps (counterpart of ``ugpg_tpu/train/steps.py``).

One segmentation train step runs, per batch:

    resize (image bilinear align_corners, mask nearest)
    -> ``augment=True``: the MoNuSeg augmentation on the device
       (``data/augment.py``; ``aug_quantize=N``: N grid angles)
    -> stage > 1: the frozen previous stage in eval mode, no grad, on the
       image resized down; sigmoid; resized back up; A = 1 - 2|P - 0.5|
    -> the current stage in train mode (BN running stats update)
    -> the loss: the fused kernels (``fused_loss=True``) or BCE + the
       uncertainty-weighted mean
    -> backward -> one optimizer step -> the six metrics

Batches keep the JAX layout: ``(images (B, H, W, 3), masks (B, H, W, 1))``,
NHWC numpy arrays or tensors, at any size (resized here).  A batch on the
host goes to the model's device by a synchronous copy; one already there
(``data/loader.py::prefetch_to_device``) is used in place.  It is
transposed to NCHW here.  The metrics come back as 0-d tensors on the
device, so a step never waits for the device.

One classification train step (``make_cls_train_step``) runs, per batch
``(images (B, H, W, 3), labels (B,))``:

    ``augment=True``: the Herlev augmentation on the device
    -> ``normalize=True``: ImageNet normalisation -> resize (bilinear,
       align_corners) to the stage resolution
    -> stage > 1: the frozen previous stage in eval mode, no grad, on the
       image resized down; per-sample weights 1 + alpha A (entropy / log K)
    -> the current stage in train mode (BN stats, dropout from the
       generator)
    -> class-weighted CE (the base loss); at stage > 1 the loss is the mean
       of the *unweighted* per-sample CE times the weights
    -> backward -> one optimizer step -> the six metrics

``external_uncertainty=True`` (both tasks) takes the frozen previous
stage out of the step: the step is handed, as ``unc=``, what that stage
would give, computed elsewhere (``parallel/pipeline.py``) and detached:
segmentation's upsampled probabilities ``probs_up`` (B, K, res, res),
classification's per-sample weights (B,).  They are sliced per
micro-batch as the images are.

``mesh=`` (every step): the batch splits over the mesh's ``data`` axis
(each micro-batch in order, shard i on data row i's first device) and the
model runs over the shards in lock-step (``parallel/tensor.py``): BN with
the whole batch's statistics, one set of parameters whose gradients
autograd sums over the replicas, one optimizer update.  Augmentation
parameters and Herlev's dropout masks are drawn for the whole micro-batch
from the trainer's generator, in the unsharded step's order, then sliced
per shard.  Each shard computes its loss (with ``fused_loss=True`` the
kernels, one forward and one backward launch per shard), and the global
loss is the mean of the shards' means (the shards are equal): the mesh
step trains the unsharded step's function on the same batch.  The metrics
are the same global means and sums.  ``shard_model`` runs the wide convs
column-parallel over each data row's ``model`` devices.  Over several
processes (``parallel/distributed.py``) the mesh is each process's own and
the global batch every process's: the draws are made for the global batch
and each process keeps its rows, BN's moments and the metrics are gathered
from every process, the classification loss is taken on every process's
logits, and the gradients are averaged over the processes before the
update.

Whole epochs (``make_*_epoch``, the trainers' ``scan_epochs``): the
counterparts of the JAX package's ``lax.scan`` epoch programs.  An epoch's
uniform prefix is cut into equal chunks of at most ``scan_chunk_bytes``
(``plan_epoch_chunks``); each chunk is stacked (``stack_epoch``) and moved
to the device once (``put_stacked``; on a mesh its batch axis split over
``data``), every step's augmentation parameters and (Herlev) dropout masks
are drawn before the chunk from the trainer's generator in the order the
per-step path draws them (``draw_seg_epoch`` / ``draw_cls_epoch``, the
counterpart of ``split_epoch_keys``), and the chunk's steps run the per-step
path's own step function on each step's slice.  The metrics stay on the
device, one row per step, and the trainers read them once an epoch
(``run_scan_epoch``, the loop both trainers share).  On one card with no
mesh a chunk's steps replay a CUDA graph of one step (``train/graphs.py``);
on a mesh or the CPU they run eagerly.  Either way the update is the
per-step path's, so the trajectories are the same.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import numpy as np
import torch
from torch import nn

from ugpg_tpu_torch.data.augment import (
    apply_herlev_params,
    apply_monuseg_params,
    imagenet_normalize,
    sample_herlev_params,
    sample_monuseg_params,
)
from ugpg_tpu_torch.metrics.segmentation import (
    dice_coefficient,
    get_predictions,
    grid_metrics,
    pixel_accuracy,
)
from ugpg_tpu_torch.ops.losses import (
    bce_with_logits,
    softmax_cross_entropy,
    weighted_cross_entropy_mean,
)
from ugpg_tpu_torch.ops.resize import resize_bilinear_align_corners, resize_nearest
from ugpg_tpu_torch.parallel import distributed
from ugpg_tpu_torch.parallel.mesh import shard_batch, shard_stacked_batch
from ugpg_tpu_torch.parallel.tensor import ReplicaLayout, replica_features, replica_forward
from ugpg_tpu_torch.train.graphs import StepGraph, take
from ugpg_tpu_torch.uncertainty import (
    apply_uncertainty_weighted_loss,
    binary_uncertainty,
    classification_uncertainty_weights,
    generate_uncertainty_map,
    shard_loss,
)

__all__ = ["make_seg_train_step", "make_seg_eval_step", "make_cls_train_step",
           "make_cls_eval_step", "METRIC_KEYS", "CLS_METRIC_KEYS", "not_ported",
           "scan_usable", "plan_epoch_chunks", "stack_epoch", "put_stacked",
           "draw_seg_epoch", "draw_cls_epoch", "make_seg_train_epoch", "make_seg_eval_epoch",
           "make_cls_train_epoch", "make_cls_eval_epoch", "reduce_cls_rows", "scan_rows",
           "scan_batches", "run_scan_epoch"]

METRIC_KEYS = ("final_loss", "base_loss", "dice", "accuracy",
               "uncertainty_weight_mean", "uncertainty_weight_std")
# "correct" and "count" are summed over micro-batches, the others averaged
CLS_METRIC_KEYS = ("final_loss", "base_loss", "correct", "count",
                   "uncertainty_weight_mean", "uncertainty_weight_std")

Metrics = dict[str, torch.Tensor]


def _nchw(a, device: torch.device) -> torch.Tensor:
    """NHWC batch array -> float32 NCHW tensor on ``device`` (a float32
    tensor already on ``device`` is not copied there again)."""
    return torch.as_tensor(a, dtype=torch.float32).to(device).permute(0, 3, 1, 2).contiguous()


def _unc_stats(unc_map: torch.Tensor | None, like: torch.Tensor):
    if unc_map is None:
        zero = torch.zeros((), dtype=torch.float32, device=like.device)
        return zero, zero
    return unc_map.mean(), unc_map.std(correction=0)


def _metrics(final, base, logits, y, unc_map) -> Metrics:
    preds = get_predictions(logits.detach())
    unc_mean, unc_std = _unc_stats(unc_map, logits)
    return {
        "final_loss": final.detach(),
        "base_loss": base.detach(),
        "dice": dice_coefficient(preds, y),
        "accuracy": pixel_accuracy(preds, y),
        "uncertainty_weight_mean": unc_mean,
        "uncertainty_weight_std": unc_std,
    }


def _external(unc, n: int, device: torch.device, spatial: tuple = ()) -> torch.Tensor:
    """``unc`` of an external-uncertainty step, checked and detached on
    ``device``: n rows, and the spatial size ``spatial`` where given."""
    if unc is None:
        raise ValueError("external_uncertainty=True: pass unc, the previous stage's output")
    unc = torch.as_tensor(unc).detach().to(device)
    if unc.shape[0] != n or (spatial and tuple(unc.shape[-2:]) != spatial):
        raise ValueError(f"unc has shape {tuple(unc.shape)}; the batch has {n} rows"
                         + (f" at {spatial[0]}x{spatial[1]}" if spatial else ""))
    return unc


@torch.no_grad()
def _replica_probs(prev_model, xs: list, layout: ReplicaLayout, prev_resolution: int,
                   resolution: int) -> list:
    """The frozen previous stage's probabilities per batch shard, resized
    down, run in eval mode and resized back up, as the unsharded steps'."""
    prev_model.eval()
    x_prev = [resize_bilinear_align_corners(x, (prev_resolution, prev_resolution)) for x in xs]
    return [resize_bilinear_align_corners(torch.sigmoid(lg), (resolution, resolution))
            for lg in replica_forward(prev_model, x_prev, layout)]


def _layout(mesh, shard_model: bool) -> ReplicaLayout | None:
    return None if mesh is None else ReplicaLayout(mesh, shard_model)


def not_ported(where: str = 'ROADMAP.md, "Not to port"', **asked: bool) -> None:
    """Raise ``NotImplementedError`` naming every option asked for that the
    port does not have yet, and ``where`` the roadmap places it."""
    missing = [name for name, on in asked.items() if on]
    if missing:
        raise NotImplementedError(
            f"not ported to ugpg_tpu_torch yet: {', '.join(missing)} ({where})")


def make_seg_train_step(
    model: nn.Module,
    optimizer: torch.optim.Optimizer,
    stage: int,
    resolution: int,
    prev_model: nn.Module | None = None,
    prev_resolution: int | None = None,
    alpha: float = 1.0,
    augment: bool = False,
    fused_loss: bool = False,
    accum_steps: int = 1,
    external_uncertainty: bool = False,
    aug_quantize: int = 0,
    mesh=None,
    shard_model: bool = True,
) -> Callable[..., Metrics]:
    """``step(batch, pos_weight, aug=None, unc=None) -> metrics``: one update of
    ``model`` through ``optimizer``.  ``prev_model`` is the frozen previous stage
    (stage > 1).  ``fused_loss=True`` computes the loss and its gradient
    with the ``uncertainty_weighted_bce`` kernels; at stage 1 it passes a
    0-d probability of 0.5 with ``alpha=0``, so the kernels run there too
    and read no p.

    ``accum_steps=K`` splits the batch (size K*m) into K micro-batches in
    order: gradients are averaged over them, the BN running stats update
    once per micro-batch, and one optimizer step follows; the metrics are
    the micro-batch means.

    ``augment=True``: the MoNuSeg augmentation runs after the resize and
    before the previous stage sees ``x``, as in the JAX step.  ``aug`` is a
    ``torch.Generator`` on the model's device, from which each micro-batch
    draws its parameters in turn, or the parameters of the whole batch
    drawn before (``data/augment.py::sample_monuseg_params``, sliced per
    micro-batch).  ``aug_quantize=N`` rotates by one of N grid angles.

    ``external_uncertainty=True`` (stage > 1): no ``prev_model``; ``unc`` is
    ``probs_up`` (B, K, res, res), the previous stage's upsampled
    probabilities of the batch as augmented here, which the step (and,
    with ``fused_loss=True``, the loss kernels) uses as the fused step uses
    its own.

    ``mesh``: data-parallel over its ``data`` axis (the module's
    docstring); every micro-batch must split over it.  ``shard_model``:
    the wide convs column-parallel over ``model``."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    external = stage > 1 and external_uncertainty
    use_unc = external or (stage > 1 and prev_model is not None)
    params = [p for p in model.parameters() if p.requires_grad]
    layout = _layout(mesh, shard_model)

    def micro(images: torch.Tensor, masks: torch.Tensor, pos_weight: float, aug,
              unc) -> Metrics:
        x = resize_bilinear_align_corners(images, (resolution, resolution))
        y = resize_nearest(masks, (resolution, resolution))
        if augment:
            if isinstance(aug, torch.Generator):
                aug = sample_monuseg_params(aug, x.shape[0], quantize_angles=aug_quantize)
            x, y = apply_monuseg_params(x, y, aug, quantize_angles=aug_quantize)
        probs_up = unc_map = None
        if use_unc:
            with torch.no_grad():
                if external:
                    probs_up = unc
                else:
                    prev_model.eval()
                    x_prev = resize_bilinear_align_corners(x, (prev_resolution, prev_resolution))
                    probs_up = resize_bilinear_align_corners(
                        torch.sigmoid(prev_model(x_prev)), (resolution, resolution))
                unc_map = binary_uncertainty(probs_up)
        model.train()
        logits = model(x)
        final, base = shard_loss(logits, y, probs_up, unc_map, pos_weight, alpha, fused_loss)
        final.backward()
        return _metrics(final, base, logits, y, unc_map)

    def micro_mesh(images: torch.Tensor, masks: torch.Tensor, pos_weight: float, aug,
                   unc) -> Metrics:
        if augment and isinstance(aug, torch.Generator):  # the unsharded step's draw
            n = images.shape[0]
            aug = distributed.own_rows(sample_monuseg_params(
                aug, n * distributed.world_size(), quantize_angles=aug_quantize), n)
        mesh = layout.mesh
        augs = shard_batch(aug, mesh) if augment else [None] * mesh.shape["data"]
        xs, ys = [], []
        for img, msk, part in zip(shard_batch(images, mesh), shard_batch(masks, mesh), augs):
            x = resize_bilinear_align_corners(img, (resolution, resolution))
            y = resize_nearest(msk, (resolution, resolution))
            if augment:
                x, y = apply_monuseg_params(x, y, part, quantize_angles=aug_quantize)
            xs.append(x)
            ys.append(y)
        probs = uncs = None
        if use_unc:
            probs = (shard_batch(unc, mesh) if external else
                     _replica_probs(prev_model, xs, layout, prev_resolution, resolution))
            uncs = [binary_uncertainty(p) for p in probs]
        model.train()
        logits = replica_forward(model, xs, layout)
        losses = [shard_loss(lg, y, None if probs is None else probs[i],
                             None if uncs is None else uncs[i], pos_weight, alpha, fused_loss)
                  for i, (lg, y) in enumerate(zip(logits, ys))]
        home = params[0].device
        (sum(f.to(home) for f, _ in losses) / len(losses)).backward()
        return grid_metrics([f for f, _ in losses], [b for _, b in losses], logits, ys, uncs,
                            home)

    run = micro if layout is None else micro_mesh

    def step(batch, pos_weight: float, aug=None, unc=None) -> Metrics:
        device = params[0].device
        images, masks = _nchw(batch[0], device), _nchw(batch[1], device)
        n = images.shape[0]
        if n % accum_steps:
            raise ValueError(f"batch size {n} is not divisible by accum_steps={accum_steps}")
        if augment and aug is None:
            raise ValueError("augment=True: pass aug, a torch.Generator or drawn parameters")
        if external:
            unc = _external(unc, n, device, (resolution, resolution))
        m = n // accum_steps
        optimizer.zero_grad(set_to_none=True)
        parts = []
        for i in range(accum_steps):
            part = aug
            if isinstance(aug, dict):
                part = {k: v[i * m:(i + 1) * m] for k, v in aug.items()}
            parts.append(run(images[i * m:(i + 1) * m], masks[i * m:(i + 1) * m], pos_weight,
                             part, unc[i * m:(i + 1) * m] if external else None))
        if accum_steps > 1:
            for p in params:  # the micro-batches' gradients were summed
                if p.grad is not None:
                    p.grad.div_(accum_steps)
        if layout is not None:
            distributed.average_gradients(params)
        optimizer.step()
        if accum_steps == 1:
            return parts[0]
        return {k: torch.stack([part[k] for part in parts]).mean() for k in METRIC_KEYS}

    return step


def make_seg_eval_step(
    model: nn.Module,
    stage: int,
    resolution: int,
    prev_model: nn.Module | None = None,
    prev_resolution: int | None = None,
    alpha: float = 1.0,
    mesh=None,
    shard_model: bool = True,
) -> Callable[[tuple, float], Metrics]:
    """``step(batch, pos_weight) -> metrics`` in eval mode (running BN
    stats), no update.  It always computes the plain loss, also where
    training uses the fused kernels, as the JAX package does.  ``mesh``:
    the batch split over its ``data`` axis, the metrics global."""
    use_unc = stage > 1 and prev_model is not None
    layout = _layout(mesh, shard_model)

    def prev_apply(x: torch.Tensor) -> torch.Tensor:
        prev_model.eval()
        return prev_model(x)

    @torch.no_grad()
    def step(batch, pos_weight: float) -> Metrics:
        device = next(model.parameters()).device
        x = resize_bilinear_align_corners(_nchw(batch[0], device), (resolution, resolution))
        y = resize_nearest(_nchw(batch[1], device), (resolution, resolution))
        model.eval()
        if layout is None:
            unc_map = (generate_uncertainty_map(prev_apply, x, prev_resolution, resolution)
                       if use_unc else None)
            logits = model(x)
            final, base = apply_uncertainty_weighted_loss(
                bce_with_logits(logits, y, pos_weight), unc_map, alpha)
            return _metrics(final, base, logits, y, unc_map)
        xs, ys = shard_batch(x, layout.mesh), shard_batch(y, layout.mesh)
        uncs = None
        if use_unc:
            uncs = [binary_uncertainty(p) for p in
                    _replica_probs(prev_model, xs, layout, prev_resolution, resolution)]
        logits = replica_forward(model, xs, layout)
        losses = [shard_loss(lg, t, None, None if uncs is None else uncs[i], pos_weight, alpha,
                             False) for i, (lg, t) in enumerate(zip(logits, ys))]
        return grid_metrics([f for f, _ in losses], [b for _, b in losses], logits, ys, uncs,
                            device)

    return step


# ---------------------------------------------------------------- classification
def _cls_batch(batch, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    return _nchw(batch[0], device), torch.as_tensor(batch[1]).to(device).long()


def _cls_inputs(images: torch.Tensor, resolution: int, normalize: bool, prev_model,
                prev_resolution, num_classes: int, alpha: float):
    """Normalise, resize, and the previous stage's per-sample weights (or None)."""
    if normalize:
        images = imagenet_normalize(images)
    x = resize_bilinear_align_corners(images, (resolution, resolution))
    weights = None
    if prev_model is not None:
        with torch.no_grad():
            prev_model.eval()
            x_prev = resize_bilinear_align_corners(x, (prev_resolution, prev_resolution))
            weights = classification_uncertainty_weights(prev_model(x_prev), num_classes, alpha)
    return x, weights


def _global_cls(logits, labels, weights) -> tuple:
    """(logits, labels, weights) of the global batch: every process's, in
    process order (``parallel/distributed.py``); the logits differentiably,
    so that each process's loss is the global one and the averaged
    gradients are its gradient.  One process: as given."""
    if distributed.world_size() == 1:
        return logits, labels, weights
    logits = distributed.gather_parts(logits).flatten(0, 1)
    if weights is None:
        return (logits, *distributed.gather_rows(labels), None)
    return (logits, *distributed.gather_rows(labels, weights))


def _cls_metrics(logits, labels, weights, class_weights) -> tuple[torch.Tensor, Metrics]:
    """(final loss, the six metrics)."""
    base = weighted_cross_entropy_mean(logits, labels, class_weights)
    final = base if weights is None else (softmax_cross_entropy(logits, labels) * weights).mean()
    if weights is None:
        unc_mean = unc_std = torch.zeros((), dtype=torch.float32, device=logits.device)
    else:
        unc_mean, unc_std = weights.mean(), weights.std(correction=0)
    return final, {
        "final_loss": final.detach(),
        "base_loss": base.detach(),
        "correct": (logits.detach().argmax(-1) == labels).sum().to(torch.int32),
        "count": torch.full((), labels.shape[0], dtype=torch.int32, device=logits.device),
        "uncertainty_weight_mean": unc_mean,
        "uncertainty_weight_std": unc_std,
    }


def _cls_replicas(model, prev_model, images: list, resolution: int, normalize: bool,
                  prev_resolution, num_classes: int, alpha: float, layout: ReplicaLayout,
                  home: torch.device):
    """``_cls_inputs`` over batch shards: (the shards' inputs, the previous
    stage's per-sample weights gathered on ``home``, or None)."""
    xs = [_cls_inputs(img, resolution, normalize, None, None, num_classes, alpha)[0]
          for img in images]
    if prev_model is None:
        return xs, None
    with torch.no_grad():
        prev_model.eval()
        feats = replica_features(
            prev_model, [resize_bilinear_align_corners(x, (prev_resolution, prev_resolution))
                         for x in xs], layout)
        return xs, torch.cat([classification_uncertainty_weights(prev_model.head(f), num_classes,
                                                                 alpha).to(home)
                              for f in feats])


def make_cls_train_step(
    model: nn.Module,
    optimizer: torch.optim.Optimizer,
    stage: int,
    resolution: int,
    num_classes: int,
    prev_model: nn.Module | None = None,
    prev_resolution: int | None = None,
    alpha: float = 1.0,
    augment: bool = False,
    normalize: bool = False,
    accum_steps: int = 1,
    external_uncertainty: bool = False,
    mesh=None,
    shard_model: bool = True,
) -> Callable[..., Metrics]:
    """``step(batch, class_weights, generator=None, aug=None, unc=None,
    drop=None) -> metrics``: one update of the classifier ``model`` through
    ``optimizer`` (which holds the parameters to train).  ``prev_model`` is
    the frozen previous stage (stage > 1).  ``generator`` (a
    ``torch.Generator`` on the model's device) draws the dropout masks and,
    with ``augment=True``, each micro-batch's augmentation parameters
    before them.  ``aug``: the augmentation parameters of the whole batch
    drawn before (``data/augment.py::sample_herlev_params`` per
    micro-batch, concatenated), sliced per micro-batch; the generator then
    draws the dropout masks only.  ``drop``: the head's three dropout masks
    of the whole batch drawn before (``model.head_masks`` per micro-batch,
    after its augmentation, concatenated; None where a rate draws
    nothing), sliced per micro-batch; with ``aug`` too the step draws
    nothing.  ``augment=True`` with neither a generator nor ``aug``
    raises.  ``class_weights``: (K,) or None.

    ``external_uncertainty=True`` (stage > 1): no ``prev_model``; ``unc`` is
    the previous stage's per-sample weights (B,) of the batch.

    ``accum_steps=K`` splits the batch into K micro-batches in order: the
    class-weighted CE normalises per micro-batch (what torch accumulation
    gives), gradients are averaged, BN stats update per micro-batch, one
    optimizer step follows; "correct" and "count" are summed, the other
    metrics averaged.

    ``mesh``: the encoder data-parallel over its ``data`` axis (the
    module's docstring); the heads run per shard on their slices of the
    micro-batch's dropout masks, and the loss on the logits gathered on
    the model's device.  ``shard_model``: the wide convs column-parallel."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    external = stage > 1 and external_uncertainty
    prev_model = prev_model if stage > 1 and not external else None
    params = [p for p in model.parameters() if p.requires_grad]
    layout = _layout(mesh, shard_model)

    def micro(images, labels, class_weights, generator, aug, unc, drop) -> Metrics:
        if augment:
            b, _, h, w = images.shape
            images = apply_herlev_params(
                images, aug if aug is not None else sample_herlev_params(generator, b, h, w))
        x, weights = _cls_inputs(images, resolution, normalize, prev_model, prev_resolution,
                                 num_classes, alpha)
        if external:
            weights = unc
        model.train()
        logits = (model(x, generator=generator) if drop is None
                  else model.head(model.features(x), True, None, drop))
        final, metrics = _cls_metrics(logits, labels, weights, class_weights)
        final.backward()
        return metrics

    def micro_mesh(images, labels, class_weights, generator, aug, unc, drop) -> Metrics:
        b, _, h, w = images.shape
        world = distributed.world_size()  # draws for the global batch, this process's rows
        if augment and aug is None:
            aug = distributed.own_rows(sample_herlev_params(generator, b * world, h, w), b)
        # drawn after the augmentation, as the unsharded forward draws them
        if drop is None:
            drop = [None if k is None else distributed.own_rows(k, b)
                    for k in model.head_masks(b * world, generator, images.device)]
        keep = [None if k is None else shard_batch(k, layout.mesh) for k in drop]
        shards = shard_batch(images, layout.mesh)
        if augment:
            shards = [apply_herlev_params(img, part)
                      for img, part in zip(shards, shard_batch(aug, layout.mesh))]
        xs, weights = _cls_replicas(model, prev_model, shards, resolution, normalize,
                                    prev_resolution, num_classes, alpha, layout, images.device)
        if external:
            weights = unc
        model.train()
        logits = torch.cat([
            model.head(f, True, generator, [None if k is None else k[i] for k in keep])
            .to(images.device) for i, f in enumerate(replica_features(model, xs, layout))])
        final, metrics = _cls_metrics(*_global_cls(logits, labels, weights), class_weights)
        final.backward()
        return metrics

    run = micro if layout is None else micro_mesh

    def step(batch, class_weights=None, generator: torch.Generator | None = None, aug=None,
             unc=None, drop=None) -> Metrics:
        device = params[0].device
        images, labels = _cls_batch(batch, device)
        n = images.shape[0]
        if n % accum_steps:
            raise ValueError(f"batch size {n} is not divisible by accum_steps={accum_steps}")
        if augment and generator is None and aug is None:
            raise ValueError("augment=True: pass generator, a torch.Generator, or aug")
        if external:
            unc = _external(unc, n, device)
        m = n // accum_steps

        def part(t, i):
            if t is None:
                return None
            if isinstance(t, dict):
                return {k: v[i * m:(i + 1) * m] for k, v in t.items()}
            if isinstance(t, (list, tuple)):
                return [part(v, i) for v in t]
            return t[i * m:(i + 1) * m]

        optimizer.zero_grad(set_to_none=True)
        parts = [run(images[i * m:(i + 1) * m], labels[i * m:(i + 1) * m], class_weights,
                     generator, part(aug, i), part(unc, i), part(drop, i))
                 for i in range(accum_steps)]
        if accum_steps > 1:
            for p in params:  # the micro-batches' gradients were summed
                if p.grad is not None:
                    p.grad.div_(accum_steps)
        if layout is not None:
            distributed.average_gradients(params)
        optimizer.step()
        if accum_steps == 1:
            return parts[0]
        return {k: torch.stack([part[k] for part in parts]).sum() if k in ("correct", "count")
                else torch.stack([part[k] for part in parts]).mean() for k in CLS_METRIC_KEYS}

    return step


def make_cls_eval_step(
    model: nn.Module,
    stage: int,
    resolution: int,
    num_classes: int,
    prev_model: nn.Module | None = None,
    prev_resolution: int | None = None,
    alpha: float = 1.0,
    normalize: bool = False,
    mesh=None,
    shard_model: bool = True,
) -> Callable[..., Metrics]:
    """``step(batch, class_weights=None) -> metrics`` in eval mode (running
    BN stats, no dropout), no update.  ``mesh``: the encoder over its
    ``data`` axis, the loss on the gathered logits."""
    prev_model = prev_model if stage > 1 else None
    layout = _layout(mesh, shard_model)

    @torch.no_grad()
    def step(batch, class_weights=None) -> Metrics:
        images, labels = _cls_batch(batch, next(model.parameters()).device)
        model.eval()
        if layout is None:
            x, weights = _cls_inputs(images, resolution, normalize, prev_model, prev_resolution,
                                     num_classes, alpha)
            return _cls_metrics(model(x), labels, weights, class_weights)[1]
        xs, weights = _cls_replicas(model, prev_model, shard_batch(images, layout.mesh), resolution,
                                    normalize, prev_resolution, num_classes, alpha, layout,
                                    images.device)
        logits = torch.cat([model.head(f).to(images.device)
                            for f in replica_features(model, xs, layout)])
        return _cls_metrics(*_global_cls(logits, labels, weights), class_weights)[1]

    return step


# ---------------------------------------------------------------- whole epochs
def scan_usable(first_batch, mesh) -> bool:
    """Whether an epoch may take the whole-epoch path, from its first batch
    alone (before anything is stacked): one process, and on a mesh a batch
    that splits over ``data``."""
    if mesh is None:
        return True
    if distributed.world_size() > 1:
        return False
    return np.shape(first_batch[0])[0] % mesh.shape["data"] == 0


def scan_batches(dataloader, scan_epochs: bool, mesh) -> tuple:
    """``(batches, whole)``: whether a trainer's epoch takes the
    whole-epoch path, decided on its first batch before anything is stacked
    (``scan_usable``; over several processes a mesh's epochs run per step
    and the loader is not listed), and its batches, a list once listed."""
    if not scan_epochs or (mesh is not None and distributed.world_size() > 1):
        return dataloader, False
    batches = list(dataloader)
    return batches, bool(batches) and scan_usable(batches[0], mesh)


def _batch_nbytes(batch) -> int:
    """Bytes of one batch as it is held (host arrays or tensors)."""
    total = 0
    for x in batch:
        nb = getattr(x, "nbytes", None)
        total += int(nb) if nb is not None else np.asarray(x).nbytes
    return total


def _uniform_prefix(batches: Sequence) -> int:
    """How many leading batches have the first one's image shape."""
    first = tuple(np.shape(batches[0][0]))
    n = 1
    while n < len(batches) and tuple(np.shape(batches[n][0])) == first:
        n += 1
    return n


def plan_epoch_chunks(batches: Sequence, max_bytes: int | None):
    """``(ranges, tail_start)``: the uniform prefix cut into equal chunks
    ``(a, b)`` of at most ``max_bytes`` each (None: one chunk), and the
    first batch of the tail, which runs per step (the prefix's remainder
    and the ragged batches)."""
    n = _uniform_prefix(batches)
    if max_bytes is None:
        return [(0, n)], n
    s = max(1, int(max_bytes) // max(1, _batch_nbytes(batches[0])))
    if s >= n:
        return [(0, n)], n
    n_chunks = n // s
    return [(i * s, (i + 1) * s) for i in range(n_chunks)], n_chunks * s


def stack_epoch(batches: Sequence, pin: bool = False):
    """``(stacked, tail)``: the uniform prefix stacked to (S, B, ...) per
    array (on the device for tensors, else in numpy) and the rest.
    ``pin``: host arrays stack into page-locked tensors, which a card
    copies from without holding the host."""
    n = _uniform_prefix(batches)
    prefix, tail = batches[:n], list(batches[n:])
    if all(isinstance(x, torch.Tensor) for x in batches[0]):
        stacked = tuple(torch.stack([b[i] for b in prefix]) for i in range(len(batches[0])))
    elif pin:
        stacked = []
        for i in range(len(batches[0])):
            parts = [torch.as_tensor(np.asarray(b[i])) for b in prefix]
            out = torch.empty((len(parts), *parts[0].shape), dtype=parts[0].dtype,
                              pin_memory=True)
            stacked.append(torch.stack(parts, out=out))
        stacked = tuple(stacked)
    else:
        stacked = tuple(np.stack([np.asarray(b[i]) for b in prefix])
                        for i in range(len(batches[0])))
    return stacked, tail


def put_stacked(stacked, mesh=None, device: torch.device | None = None):
    """A stacked chunk on the device, moved once: on ``mesh`` its axis 1
    (the per-step batch) split over ``data`` (``shard_stacked_batch``),
    else on ``device``."""
    if mesh is not None:
        return shard_stacked_batch(stacked, mesh)
    return tuple(torch.as_tensor(x).to(device) for x in stacked)


def micro_params(draw: Callable[[int], dict], batch: int, accum_steps: int) -> dict:
    """One batch's parameters, drawn per micro-batch in order and
    concatenated (what the step's own draws would give)."""
    m = batch // accum_steps
    parts = [draw(m) for _ in range(accum_steps)]
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


def _stack_draws(draws: list):
    if isinstance(draws[0], dict):
        return {k: torch.stack([d[k] for d in draws]) for k in draws[0]}
    return [None if draws[0][j] is None else torch.stack([d[j] for d in draws])
            for j in range(len(draws[0]))]


def draw_seg_epoch(generator: torch.Generator, n_steps: int, batch: int, accum_steps: int = 1,
                   aug_quantize: int = 0) -> dict:
    """The MoNuSeg augmentation parameters of ``n_steps`` steps of
    ``batch`` rows, stacked (S, B, ...): drawn from ``generator`` step by
    step and micro-batch by micro-batch, as the per-step path draws them."""
    return _stack_draws([micro_params(
        lambda m: sample_monuseg_params(generator, m, quantize_angles=aug_quantize),
        batch, accum_steps) for _ in range(n_steps)])


def draw_cls_epoch(generator: torch.Generator, model, n_steps: int, batch: int, height: int,
                   width: int, augment: bool, accum_steps: int = 1):
    """``(aug, drop)`` of ``n_steps`` Herlev train steps, stacked: per step
    and micro-batch the augmentation parameters (``augment``), then the
    head's three dropout masks, drawn from ``generator`` in the order the
    per-step path draws them.  ``aug`` is None without augmentation; a
    mask slot is None where its rate draws nothing."""
    m = batch // accum_steps
    augs, drops = [], []
    for _ in range(n_steps):
        a, d = [], []
        for _ in range(accum_steps):
            if augment:
                a.append(sample_herlev_params(generator, m, height, width))
            d.append(model.head_masks(m, generator, generator.device))
        if augment:
            augs.append({k: torch.cat([p[k] for p in a]) for k in a[0]})
        drops.append([None if d[0][j] is None else torch.cat([p[j] for p in d])
                      for j in range(len(d[0]))])
    return (_stack_draws(augs) if augment else None), _stack_draws(drops)


def _row(m: Metrics, keys) -> torch.Tensor:
    return torch.stack([m[k].float() for k in keys])


def _epoch(body: Callable, model: nn.Module, mesh):
    """``epoch(chunk, n, *consts) -> (n, K) rows``: ``body(inputs, *consts)``
    on each of the chunk's n steps, replayed from a CUDA graph
    (``epoch.graph``, a ``train/graphs.py::StepGraph``) where ``model`` is
    on a card and there is no mesh, else eagerly (``epoch.graph`` None)."""
    device = next(model.parameters()).device
    graph = StepGraph(device) if device.type == "cuda" and mesh is None else None

    def epoch(chunk: dict, n: int, *consts) -> torch.Tensor:
        if graph is not None:
            return graph.run(lambda x: body(x, *consts), chunk, n, key=consts)
        return torch.stack([body(take(chunk, s), *consts) for s in range(n)])

    epoch.graph = graph
    return epoch


def make_seg_train_epoch(model: nn.Module, optimizer: torch.optim.Optimizer, stage: int,
                         resolution: int, prev_model: nn.Module | None = None,
                         prev_resolution: int | None = None, alpha: float = 1.0,
                         augment: bool = False, fused_loss: bool = False, accum_steps: int = 1,
                         external_uncertainty: bool = False, aug_quantize: int = 0, mesh=None,
                         shard_model: bool = True) -> Callable:
    """Whole-epoch segmentation training (counterpart of the JAX package's
    ``make_seg_train_epoch``): ``epoch(chunk, n, pos_weight) -> rows``,
    the (n, 6) metrics of ``METRIC_KEYS`` of each of the chunk's n steps, on
    the device.  ``chunk``: ``{"images": (S, B, H, W, C), "masks": (S, B,
    H, W, 1)}`` from ``put_stacked``, with ``"aug"`` (``draw_seg_epoch``;
    ``augment=True``) and ``"unc"`` (the stacked ``probs_up``;
    ``external_uncertainty=True``).  Each step is ``make_seg_train_step``'s
    with the same arguments.  On one card with no mesh the steps replay a
    CUDA graph (``epoch.graph``)."""
    step = make_seg_train_step(model, optimizer, stage, resolution, prev_model=prev_model,
                               prev_resolution=prev_resolution, alpha=alpha, augment=augment,
                               fused_loss=fused_loss, accum_steps=accum_steps,
                               external_uncertainty=external_uncertainty,
                               aug_quantize=aug_quantize, mesh=mesh, shard_model=shard_model)

    def body(x, pos_weight):
        return _row(step((x["images"], x["masks"]), pos_weight, aug=x.get("aug"),
                         unc=x.get("unc")), METRIC_KEYS)

    return _epoch(body, model, mesh)


def make_seg_eval_epoch(model: nn.Module, stage: int, resolution: int,
                        prev_model: nn.Module | None = None, prev_resolution: int | None = None,
                        alpha: float = 1.0, mesh=None, shard_model: bool = True) -> Callable:
    """Whole-epoch segmentation validation: ``epoch(chunk, n, pos_weight)
    -> rows`` of ``make_seg_eval_step``'s metrics."""
    step = make_seg_eval_step(model, stage, resolution, prev_model=prev_model,
                              prev_resolution=prev_resolution, alpha=alpha, mesh=mesh,
                              shard_model=shard_model)

    def body(x, pos_weight):
        return _row(step((x["images"], x["masks"]), pos_weight), METRIC_KEYS)

    return _epoch(body, model, mesh)


def make_cls_train_epoch(model: nn.Module, optimizer: torch.optim.Optimizer, stage: int,
                         resolution: int, num_classes: int, prev_model: nn.Module | None = None,
                         prev_resolution: int | None = None, alpha: float = 1.0,
                         augment: bool = False, normalize: bool = False, accum_steps: int = 1,
                         external_uncertainty: bool = False, mesh=None,
                         shard_model: bool = True) -> Callable:
    """Whole-epoch classification training: ``epoch(chunk, n,
    class_weights) -> rows``, the (n, 6) metrics of ``CLS_METRIC_KEYS``
    (``correct`` and ``count`` as floats; ``reduce_cls_rows`` sums them).
    ``chunk``: ``{"images", "labels", "drop"}`` with ``"aug"``
    (``draw_cls_epoch``) and ``"unc"`` (stacked weights (S, B);
    ``external_uncertainty=True``)."""
    step = make_cls_train_step(model, optimizer, stage, resolution, num_classes,
                               prev_model=prev_model, prev_resolution=prev_resolution,
                               alpha=alpha, augment=augment, normalize=normalize,
                               accum_steps=accum_steps,
                               external_uncertainty=external_uncertainty, mesh=mesh,
                               shard_model=shard_model)

    def body(x, class_weights):
        return _row(step((x["images"], x["labels"]), class_weights, None, aug=x.get("aug"),
                         unc=x.get("unc"), drop=x["drop"]), CLS_METRIC_KEYS)

    return _epoch(body, model, mesh)


def make_cls_eval_epoch(model: nn.Module, stage: int, resolution: int, num_classes: int,
                        prev_model: nn.Module | None = None, prev_resolution: int | None = None,
                        alpha: float = 1.0, normalize: bool = False, mesh=None,
                        shard_model: bool = True) -> Callable:
    """Whole-epoch classification validation: ``epoch(chunk, n,
    class_weights) -> rows`` of ``make_cls_eval_step``'s metrics."""
    step = make_cls_eval_step(model, stage, resolution, num_classes, prev_model=prev_model,
                              prev_resolution=prev_resolution, alpha=alpha,
                              normalize=normalize, mesh=mesh, shard_model=shard_model)

    def body(x, class_weights):
        return _row(step((x["images"], x["labels"]), class_weights), CLS_METRIC_KEYS)

    return _epoch(body, model, mesh)


def reduce_cls_rows(rows: np.ndarray) -> dict[str, Any]:
    """The JAX package's ``_reduce_cls_epoch_metrics`` over (n, 6) rows:
    ``correct`` and ``count`` summed, the others averaged."""
    return {k: (rows[:, j].sum() if k in ("correct", "count") else rows[:, j].mean())
            for j, k in enumerate(CLS_METRIC_KEYS)}


def scan_rows(parts: list, tail_metrics: list, keys) -> torch.Tensor:
    """An epoch's (n, K) metric rows in step order, on the device: the
    chunks' rows and the tail steps' metrics (``keys``, as floats)."""
    rows = list(parts) + [_row(m, keys)[None] for m in tail_metrics]
    if not rows:
        return torch.zeros((0, len(keys)))
    return torch.cat([r.to(rows[0].device) for r in rows])


def run_scan_epoch(batches: list, epoch: Callable, consts: tuple, tail_step: Callable,
                   names: tuple, keys, max_bytes: int | None, mesh=None,
                   device: torch.device | None = None, draw: Callable | None = None,
                   cache: dict | None = None, cache_key=None, token=None) -> torch.Tensor:
    """A trainer's train or validation epoch on the whole-epoch path (the
    JAX trainers' ``_train_epoch_scan`` / ``_validate_epoch_scan``):
    ``batches`` (a list whose first batch passed ``scan_usable``) cut by
    ``plan_epoch_chunks(batches, max_bytes)``; each chunk stacked, named
    ``names`` (the batch's arrays), given ``draw(n, stacked)``'s entries
    (the steps' pre-drawn parameters) and run as ``epoch(chunk, n,
    *consts)``; the tail as ``tail_step(batch) -> metrics``.  A chunk goes
    to the device once: split over ``mesh`` (None: on ``device``), or, where
    ``epoch`` replays a graph, as a page-locked host stack the graph copies
    into its own buffers.  ``cache``: a validation epoch of one chunk and no
    tail keeps its stacked device copy at ``cache[cache_key]`` for
    ``token`` (the loader's identity) and this epoch's length, so a static
    validation set is stacked and moved once.  Returns ``scan_rows``: the
    (n, K) rows of every step, in order, on the device."""
    ranges, tail_start = plan_epoch_chunks(batches, max_bytes)
    graphs = epoch.graph is not None
    keep = cache is not None and tail_start == len(batches) and len(ranges) == 1
    parts = []
    for a, b in ranges:
        hit = cache.get(cache_key) if keep else None
        if hit is not None and hit[0] == (token, len(batches)):
            chunk = hit[1]
        else:
            stacked, _ = stack_epoch(batches[a:b], pin=graphs)
            if not graphs:
                placed = put_stacked(stacked, mesh, device)
            elif keep:  # a device copy the graph's buffers are filled from
                placed = tuple(torch.as_tensor(x).to(device) for x in stacked)
            else:
                placed = stacked
            chunk = dict(zip(names, placed))
            if draw is not None:
                chunk.update(draw(b - a, stacked))
            if keep:
                cache[cache_key] = ((token, len(batches)), chunk)
        parts.append(epoch(chunk, b - a, *consts))
    return scan_rows(parts, [tail_step(batch) for batch in batches[tail_start:]], keys)
