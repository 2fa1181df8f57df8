"""Uncertainty-guided progressive trainer for segmentation (counterpart of
``ugpg_tpu/train/seg_trainer.py``).

* stage configs {1: (32 px, lr 3e-4), 2-4: (64/128/256 px, lr 1e-4)},
  40 epochs each
* RMSprop(weight_decay=1e-4), built anew at every stage entry
* BCE-with-logits(pos_weight=5) base loss, weighted by ``1 + alpha A`` where
  A comes from the frozen previous stage (stages > 1)
* weight transfer at stage entry; the best-val-Dice checkpoint per stage,
  as a reference-format ``.pth`` (``checkpoint_backend="msgpack"``,
  ``"orbax"`` or ``"orbax-async"``: the JAX package's directory of the
  same name without ``.pth``, ``io/checkpoint.py``); history, ``training_log.csv``, plots (with
  matplotlib) and the uncertainty analysis JSON
* ``checkpoint_every=N``: a rolling ``ug_pgunet_stage{S}_last.pth``
  (weights, optimizer state, epoch, history); ``resume=True`` continues
  from the latest one, mid-stage, in either form whatever the trainer's
  own backend (a JAX run's directories too); a ``PreemptionGuard`` (``preemption=``)
  is polled at every epoch boundary, and when it is armed the loop writes
  ``_last`` and returns with ``preempted`` set
* ``dtype=torch.bfloat16``: bf16 compute over float32 parameters and
  optimizer state, BN statistics in float32 (``models/blocks.py``)
* ``remat=True``: every DoubleConv recomputed in the backward
  (``models/blocks.py``); ``tb_logdir``: per-epoch TensorBoard scalars
  (``utils/tb.py``); ``pipeline_unc=N``: stages > 1 train through the
  uncertainty pipeline (``parallel/pipeline.py``)
* ``mesh``: data-parallel steps over its ``data`` axis with cross-replica
  BN (``train/steps.py``), ``shard_model`` the wide convs column-parallel;
  ``finetune_native``: a stage fine-tuned at native resolution on a
  spatially sharded grid (``parallel/spatial.py``)
* ``scan_epochs``: each epoch's uniform prefix in chunks of at most
  ``scan_chunk_bytes``, stacked and moved to the device once per chunk,
  its steps replayed from a CUDA graph on one card (``train/graphs.py``),
  run eagerly elsewhere (``train/steps.py``, "Whole epochs"); the ragged
  tail per step

The loop reads the device once per epoch: the steps return device
scalars, averaged at the epoch's end.
"""

from __future__ import annotations

import contextlib
import json
import time
from pathlib import Path
from typing import Any, Iterable, Mapping

import numpy as np
import torch
from torch import nn

from ugpg_tpu_torch.data.loader import prefetch_to_device
from ugpg_tpu_torch.device import resolve_device
from ugpg_tpu_torch.io.checkpoint import (
    checkpoint_backend_of,
    checkpoint_metadata,
    checkpoint_path,
    find_checkpoint,
    load_checkpoint,
    read_checkpoint,
    save_checkpoint,
    wait_for_async_saves,
)
from ugpg_tpu_torch.models.blocks import DoubleConv, init_parameters
from ugpg_tpu_torch.models.pgunet import STAGE_MODELS
from ugpg_tpu_torch.ops.resize import resize_bilinear_align_corners
from ugpg_tpu_torch.parallel import distributed
from ugpg_tpu_torch.parallel.mesh import data_axis_size, tensor_device
from ugpg_tpu_torch.parallel.pipeline import (
    UncertaintyPipeline,
    pipeline_check,
    pipeline_device_list,
)
from ugpg_tpu_torch.parallel.spatial import (
    make_spatial_eval_step,
    make_spatial_train_step,
    spatial_divisor,
)
from ugpg_tpu_torch.progressive.transfer import transfer_weights
from ugpg_tpu_torch.train.optim import (
    get_learning_rate,
    load_optimizer_state,
    param_names,
    torch_rmsprop,
)
from ugpg_tpu_torch.train.steps import (
    METRIC_KEYS,
    draw_seg_epoch,
    make_seg_eval_epoch,
    make_seg_eval_step,
    make_seg_train_epoch,
    make_seg_train_step,
    run_scan_epoch,
    scan_batches,
    scan_rows,
)
from ugpg_tpu_torch.uncertainty import generate_uncertainty_map
from ugpg_tpu_torch.utils.anomaly import TrainingDivergedError, nonfinite_metrics
from ugpg_tpu_torch.utils.profiling import CSVLogger
from ugpg_tpu_torch.utils.tb import TBWriter

__all__ = ["UncertaintyGuidedProgressiveTrainer", "DEFAULT_STAGE_CONFIGS"]

_UNSET = object()  # finetune_native's dtype: the trainer's

DEFAULT_STAGE_CONFIGS = {
    1: {"resolution": 32, "epochs_per_stage": 40, "lr": 3e-4},
    2: {"resolution": 64, "epochs_per_stage": 40, "lr": 1e-4},
    3: {"resolution": 128, "epochs_per_stage": 40, "lr": 1e-4},
    4: {"resolution": 256, "epochs_per_stage": 40, "lr": 1e-4},
}


def _average_rows(rows: torch.Tensor) -> tuple[float, ...]:
    """Epoch means of the six metrics from their (n, 6) rows: one read
    from the device."""
    if not len(rows):
        return (0.0,) * len(METRIC_KEYS)
    host = rows.cpu()
    return tuple(float(np.mean(host[:, j].numpy())) for j in range(len(METRIC_KEYS)))


class UncertaintyGuidedProgressiveTrainer:
    """Progressive 4-stage trainer with uncertainty-guided loss weighting."""

    def __init__(
        self,
        in_channels: int = 3,
        num_classes: int = 1,
        uncertainty_alpha: float = 1.0,
        pos_weight: float = 5.0,
        weight_decay: float = 1e-4,
        stage_configs: Mapping[int, Mapping[str, Any]] | None = None,
        dtype: torch.dtype | None = None,
        axis_name: str | None = None,
        seed: int = 0,
        verbose: bool = True,
        augment: bool = False,
        fused_loss: bool = False,
        mesh=None,
        shard_model: bool = True,
        checkpoint_backend: str = "pth",
        scan_epochs: bool = False,
        scan_chunk_bytes: int | None = 1 << 30,
        tb_logdir=None,
        accum_steps: int = 1,
        remat: bool = False,
        pipeline_unc: int = 0,
        nan_guard: bool = True,
        width: float = 1.0,
        aug_quantize: int = 0,
        device: str | torch.device | None = None,
        devices=None,
    ):
        """``fused_loss=True``: every train step computes the loss and its
        gradient with the hand-written ``uncertainty_weighted_bce`` kernels
        (off by default, as in the JAX package).  ``augment=True``: every
        train step augments its batch on the device (``data/augment.py``)
        with parameters drawn from the trainer's generator, seeded by
        ``seed + 1``; ``aug_quantize=N`` rotates by one of N grid angles.
        ``in_channels``: the models' input channels.  ``accum_steps=K``: each
        batch runs as K micro-batches with one optimizer step.  ``width``
        scales every stage's channels (1.0 = the reference widths).
        ``seed`` seeds the ``torch.Generator`` of each stage's
        initialisation.  ``nan_guard``: a NaN/Inf epoch loss saves a
        ``*_diverged`` checkpoint and raises ``TrainingDivergedError``.
        ``checkpoint_backend``: ``"pth"`` (the reference's files, the
        port's default), ``"msgpack"`` (the JAX package's directories,
        its default), ``"orbax"`` or ``"orbax-async"`` (its orbax
        directories; the trainer waits for the async saves before it
        raises or returns).
        ``device``: ``cuda`` unless given; raises without CUDA.
        ``dtype``: None or float32, or bfloat16 compute (parameters and
        optimizer state stay float32).

        ``remat=True``: every DoubleConv is recomputed in the backward
        instead of keeping its activations; gradients and BN updates are
        those without it, bit for bit.  ``tb_logdir``: per-epoch scalars
        (``stage{S}/train_loss``, ``val_loss``, ``train_dice``,
        ``val_dice``, ``uncertainty_mean``) as TensorBoard events; without
        the ``tensorboard`` package, one warning and no events.
        ``pipeline_unc=N``: at stages > 1 the frozen previous stage runs as
        a producer on the last N of the devices (``parallel/pipeline.py``)
        while the train step consumes its output; the devices are the
        visible cards on ``cuda`` (one card and N = 1 raises
        ``ValueError``, as in the JAX package) and N + 1 times the CPU on
        ``cpu``, or ``devices`` when given (the JAX trainer's
        ``jax.devices()``; a list may name a device more than once): the
        last N form the unc group, the others a data-parallel train mesh,
        whose first device the models live on.  Stage 1 runs the plain path.

        ``mesh`` (``parallel/mesh.py::make_mesh``; one process drives it,
        and it may name one card more than once): every batch whose
        micro-batches split over the ``data`` axis trains data-parallel, the
        model's replicas in lock-step with BN over the whole batch, one
        optimizer update (``train/steps.py``); another batch (a ragged
        tail) trains unsharded on the mesh's first device, the same
        function.  The models live on that device.  ``shard_model`` (with
        a mesh only, as in the JAX package): the convs with at least 256
        output channels that divide by the ``model`` axis run
        column-parallel over it.  ``axis_name``: set on every block as the
        JAX modules' BN axis; no trainer binds it, so a train step raises
        the JAX package's ``NameError`` (eval runs).

        Over several processes (``parallel/distributed.py``, a process
        group initialised before the trainer trains): each process trains
        its loader's batches on its own ``mesh``, the processes' batches
        together forming the global batch (BN, the loss, the metrics and
        the averaged gradients are the global batch's, so every process
        holds the same parameters; a ragged batch runs on a one-device mesh,
        still across the processes).  Every process's batches must have
        the same shapes.  Process 0 writes the checkpoints, the log, the
        events and the plots; the others wait at a barrier.  Models are
        made process 0's when built, transferred or resumed.

        ``scan_epochs``: each epoch runs as whole chunks (the JAX trainer's
        ``lax.scan`` epochs): its uniform prefix is cut into equal chunks of
        at most ``scan_chunk_bytes`` (default 1 GiB; None: one chunk), each
        stacked and moved to the device once, the steps' augmentation
        parameters drawn before it in the per-step path's order, and the
        metrics read once at the epoch's end; the ragged tail runs per
        step.  On one card the chunk's steps replay a CUDA graph of the
        step (``train/graphs.py``; a capture that fails raises), else they
        run eagerly; a validation epoch of one chunk and no tail keeps its
        stacked copy per stage.  The trajectory is the per-step path's: a
        trainer built with ``scan_epochs`` on a card takes torch's
        capturable optimizers, which a graph can replay, for every step,
        the tail's too; other trainers keep the host-float variant
        (``train/optim.py``).  With a mesh over several processes, or a
        batch that does not split over the mesh, epochs run per step.

        ``pipeline_unc`` with a ``mesh`` raises ``ValueError``."""
        self.device = resolve_device(device)
        self.pipeline_unc = int(pipeline_unc)
        if self.pipeline_unc and mesh is not None:
            raise ValueError(
                "pipeline_unc and mesh are mutually exclusive: the "
                "pipeline builds its own (train, uncertainty) device "
                "split from the visible devices")
        if mesh is not None:
            data_axis_size(mesh)
            self.device = tensor_device(mesh.first)
        self.mesh, self.shard_model, self.axis_name = mesh, bool(shard_model), axis_name
        self.checkpoint_backend = checkpoint_backend_of(checkpoint_backend)
        self.scan_epochs, self.scan_chunk_bytes = bool(scan_epochs), scan_chunk_bytes
        self.devices = devices
        if self.pipeline_unc:
            self.device = pipeline_check(self.pipeline_unc, self.device, devices)
        # one optimizer variant for every step of a trainer (train/optim.py)
        self._capturable = self.scan_epochs and self.device.type == "cuda"
        self.tb_logdir = tb_logdir
        self.remat = bool(remat)
        if dtype not in (None, torch.float32, torch.bfloat16):
            raise ValueError(f"dtype must be None, float32 or bfloat16, got {dtype}")
        self.dtype = dtype or torch.float32
        if accum_steps < 1:
            raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
        self.in_channels = in_channels
        self.num_classes = num_classes
        self.uncertainty_alpha = uncertainty_alpha
        self.pos_weight = float(pos_weight)
        self.weight_decay = weight_decay
        self.stage_configs = {
            s: dict(cfg) for s, cfg in (stage_configs or DEFAULT_STAGE_CONFIGS).items()}
        self.seed = seed
        self.verbose = verbose
        self.fused_loss = fused_loss
        self.augment = augment
        self.aug_quantize = int(aug_quantize)
        # stands where the JAX trainer splits its augmentation key
        self.aug_generator = torch.Generator(device=self.device).manual_seed(seed + 1)
        self.accum_steps = accum_steps
        self.nan_guard = nan_guard
        self.width = float(width)
        self._print = print if verbose else (lambda *a, **k: None)

        self.models: dict[int, nn.Module] = {}  # built at first use
        self.current_stage = 1
        self.preempted = False
        self.optimizer: torch.optim.Optimizer | None = None
        self._optimizer_stage: int | None = None
        # per stage, and per (stage, "mesh") the data-parallel steps
        self._train_steps: dict[Any, Any] = {}
        self._eval_steps: dict[Any, Any] = {}
        self._pipelines: dict[int, UncertaintyPipeline] = {}
        # per (stage, "train" | "eval", sharded) the whole-epoch functions,
        # and per stage a validation epoch's stacked device copy
        self._epochs: dict[tuple, Any] = {}
        self._val_stack_cache: dict[int, tuple] = {}
        # seconds the steps waited on the prefetch queue, and its batches
        self.loader_stats = {"wait_s": 0.0, "batches": 0}
        self.history: dict[str, list] = {
            "train_loss": [], "val_loss": [], "train_dice": [], "val_dice": [],
            "uncertainty_weights_mean": [], "uncertainty_weights_std": [],
            "base_loss": [], "stage_transitions": [],
        }

    # ------------------------------------------------------------------
    def _model(self, stage: int) -> nn.Module:
        if stage not in self.models:
            model = STAGE_MODELS[stage](num_classes=self.num_classes, use_bn=True,
                                        width=self.width, in_channels=self.in_channels,
                                        dtype=self.dtype, remat=self.remat)
            init_parameters(model, torch.Generator().manual_seed(4 * self.seed + stage - 1))
            for block in model.modules():
                if isinstance(block, DoubleConv):
                    block.axis_name = self.axis_name
            self.models[stage] = model.to(self.device)
            distributed.broadcast_module(self.models[stage])
        return self.models[stage]

    def setup_optimizer(self, stage: int) -> torch.optim.Optimizer:
        """A fresh RMSprop for the stage; the stage's steps are rebuilt on it."""
        self.optimizer = torch_rmsprop(self._model(stage).parameters(),
                                       self.stage_configs[stage]["lr"],
                                       weight_decay=self.weight_decay,
                                       capturable=self._capturable)
        self._optimizer_stage = stage
        for key in (stage, (stage, "mesh")):
            self._train_steps.pop(key, None)
        self._pipelines.pop(stage, None)
        self._epochs.clear()
        return self.optimizer

    def transfer_weights(self, prev_stage: int, new_stage: int) -> list[str]:
        """Name-keyed overlap merge from the previous stage."""
        self._print(f"Transferring weights from stage {prev_stage} to stage {new_stage}")
        new = self._model(new_stage)
        merged, copied = transfer_weights(self._model(prev_stage).state_dict(), new.state_dict())
        new.load_state_dict(merged)
        distributed.broadcast_module(new)
        self._epochs.clear()
        self._print(f"transfer_weights(stage={new_stage}): copied {len(copied)} keys "
                    f"(examples: {copied[:5]})")
        return copied

    def _prev(self, stage: int):
        if stage <= 1:
            return None, None
        return self._model(stage - 1), self.stage_configs[stage - 1]["resolution"]

    def _sharded(self, batch, accum_steps: int = 1) -> bool:
        """Whether ``batch`` runs on the mesh: its micro-batches split over
        the ``data`` axis (else it runs unsharded, the same function, as
        the JAX trainer replicates a ragged batch).  Over several
        processes every process's batch must have this shape, so that all
        take the same branch."""
        if self.mesh is None:
            return False
        distributed.check_same_shape(tuple(batch[0].shape))
        n = len(batch[0])
        return n % accum_steps == 0 and (n // accum_steps) % self.mesh.shape["data"] == 0

    def _get_train_step(self, stage: int, sharded: bool = False):
        if self._optimizer_stage != stage:
            self.setup_optimizer(stage)
        key = (stage, "mesh") if sharded else stage
        if key not in self._train_steps:
            prev_model, prev_res = self._prev(stage)
            self._train_steps[key] = make_seg_train_step(
                self._model(stage), self.optimizer, stage,
                self.stage_configs[stage]["resolution"], prev_model=prev_model,
                prev_resolution=prev_res, alpha=self.uncertainty_alpha,
                augment=self.augment, fused_loss=self.fused_loss,
                accum_steps=self.accum_steps, aug_quantize=self.aug_quantize,
                mesh=distributed.step_mesh(self.mesh, sharded), shard_model=self.shard_model)
        return self._train_steps[key]

    def _get_pipeline(self, stage: int) -> UncertaintyPipeline:
        """The stage's pipeline, built at its first epoch: after the
        transfer and the optimizer, over the previous stage's final
        weights."""
        if self._optimizer_stage != stage:
            self.setup_optimizer(stage)
        if stage not in self._pipelines:
            prev_model, prev_res = self._prev(stage)
            pipe = UncertaintyPipeline(
                self._model(stage), prev_model, self.optimizer, stage,
                self.stage_configs[stage]["resolution"], prev_res,
                task_type="segmentation", n_unc=self.pipeline_unc,
                devices=pipeline_device_list(self.pipeline_unc, self.device, self.devices),
                alpha=self.uncertainty_alpha, augment=self.augment,
                fused_loss=self.fused_loss, accum_steps=self.accum_steps,
                aug_quantize=self.aug_quantize)
            pipe.create_state()
            pipe.place_prev()
            self._pipelines[stage] = pipe
        return self._pipelines[stage]

    def _get_eval_step(self, stage: int, sharded: bool = False):
        key = (stage, "mesh") if sharded else stage
        if key not in self._eval_steps:
            prev_model, prev_res = self._prev(stage)
            self._eval_steps[key] = make_seg_eval_step(
                self._model(stage), stage, self.stage_configs[stage]["resolution"],
                prev_model=prev_model, prev_resolution=prev_res,
                alpha=self.uncertainty_alpha, mesh=distributed.step_mesh(self.mesh, sharded),
                shard_model=self.shard_model)
        return self._eval_steps[key]

    @staticmethod
    def _average(acc: list[dict]) -> tuple[float, ...]:
        """Epoch means of the six metrics: one read from the device."""
        return _average_rows(scan_rows([], acc, METRIC_KEYS))

    # ------------------------------------------------------------------ whole epochs
    def _epoch_fn(self, stage: int, train: bool, sharded: bool):
        """The stage's whole-epoch train or eval function (a CUDA graph's
        runner on one card); those of other stages are dropped."""
        if train and self._optimizer_stage != stage:
            self.setup_optimizer(stage)
        for key in [k for k in self._epochs if k[0] != stage]:
            del self._epochs[key]
        key = (stage, "train" if train else "eval", sharded)
        if key not in self._epochs:
            prev_model, prev_res = self._prev(stage)
            kw = dict(prev_model=prev_model, prev_resolution=prev_res,
                      alpha=self.uncertainty_alpha,
                      mesh=distributed.step_mesh(self.mesh, sharded),
                      shard_model=self.shard_model)
            res = self.stage_configs[stage]["resolution"]
            self._epochs[key] = (
                make_seg_train_epoch(self._model(stage), self.optimizer, stage, res,
                                     augment=self.augment, fused_loss=self.fused_loss,
                                     accum_steps=self.accum_steps,
                                     aug_quantize=self.aug_quantize, **kw)
                if train else make_seg_eval_epoch(self._model(stage), stage, res, **kw))
        return self._epochs[key]

    def _scan_epoch(self, batches: list, stage: int, train: bool, token=None):
        """One train or validation epoch on the whole-epoch path
        (``train/steps.py::run_scan_epoch``): the augmentation parameters
        drawn before each chunk, the tail per step, a validation set of one
        chunk kept per stage (``token``: the loader's identity)."""
        accum = self.accum_steps if train else 1
        sharded = self._sharded(batches[0], accum)
        draw = None
        if train:
            def tail(batch):
                return self._get_train_step(stage, self._sharded(batch, accum))(
                    batch, self.pos_weight, self.aug_generator)
            if self.augment:
                def draw(n, stacked):
                    return {"aug": draw_seg_epoch(self.aug_generator, n, stacked[0].shape[1],
                                                  accum, self.aug_quantize)}
        else:
            def tail(batch):
                return self._get_eval_step(stage, self._sharded(batch))(batch, self.pos_weight)
        return _average_rows(run_scan_epoch(
            batches, self._epoch_fn(stage, train, sharded), (self.pos_weight,), tail,
            ("images", "masks"), METRIC_KEYS, self.scan_chunk_bytes,
            mesh=self.mesh if sharded else None, device=self.device, draw=draw,
            cache=None if train else self._val_stack_cache, cache_key=stage, token=token))

    # ------------------------------------------------------------------
    def train_epoch(self, dataloader: Iterable, stage: int) -> tuple[float, ...]:
        """One training epoch -> the means of (loss, base_loss, dice,
        accuracy, uncertainty mean, uncertainty std).  With
        ``pipeline_unc`` at stages > 1, through the pipeline: the epoch's
        batches are read first, the augmentation drawn from the trainer's
        generator in the order the plain steps draw it."""
        if self.pipeline_unc and stage > 1:
            batches = list(dataloader)
            pipe = self._get_pipeline(stage)
            aug = self.aug_generator if self.augment else None
            if self.scan_epochs:
                return _average_rows(scan_rows(*pipe.run_epoch_scan(
                    batches, self.pos_weight, aug=aug, chunk_bytes=self.scan_chunk_bytes),
                    METRIC_KEYS))
            return self._average(pipe.run_epoch(batches, self.pos_weight, aug=aug))
        dataloader, whole = scan_batches(dataloader, self.scan_epochs, self.mesh)
        if whole:
            return self._scan_epoch(dataloader, stage, True)
        acc = []
        # closed on any exit, so the prefetch thread never outlives the epoch
        with contextlib.closing(self._prefetch(dataloader)) as batches:
            for batch_idx, batch in enumerate(batches):
                step = self._get_train_step(stage, self._sharded(batch, self.accum_steps))
                metrics = step(batch, self.pos_weight, self.aug_generator)
                acc.append(metrics)
                if self.verbose and batch_idx % 10 == 0:
                    m = {k: float(v) for k, v in metrics.items()}
                    unc = f", Unc_mean: {m['uncertainty_weight_mean']:.4f}" if stage > 1 else ""
                    self._print(f"Stage {stage}, Batch {batch_idx}, Loss: {m['final_loss']:.4f}, "
                                f"Base_Loss: {m['base_loss']:.4f}, Dice: {m['dice']:.4f}, "
                                f"Acc: {m['accuracy']:.4f}{unc}")
        return self._average(acc)

    def validate_epoch(self, dataloader: Iterable, stage: int) -> tuple[float, ...]:
        """One validation epoch (eval-mode BN, the plain loss, no update)."""
        token = id(dataloader)
        dataloader, whole = scan_batches(dataloader, self.scan_epochs, self.mesh)
        if whole:
            return self._scan_epoch(dataloader, stage, False, token)
        with contextlib.closing(self._prefetch(dataloader)) as batches:
            return self._average([self._get_eval_step(stage, self._sharded(batch))(
                batch, self.pos_weight) for batch in batches])

    def _prefetch(self, dataloader: Iterable):
        return prefetch_to_device(iter(dataloader), size=2, device=self.device,
                                  stats=self.loader_stats)

    def _checkpoint(self, save_path: Path, name: str, stage: int, epoch: int,
                    **extra) -> Path:
        """Write checkpoint ``name`` in the trainer's backend (process 0;
        the others wait for it)."""
        path = checkpoint_path(save_path, name, self.checkpoint_backend)
        if distributed.is_writer():
            model = self._model(stage)
            save_checkpoint(
                path, model.state_dict(), backend=self.checkpoint_backend,
                param_names=param_names(self.optimizer, model), stage=stage, epoch=epoch,
                optimizer_state_dict=self.optimizer.state_dict(),
                uncertainty_alpha=self.uncertainty_alpha, history=self.history, **extra)
        distributed.barrier()
        return path

    # ------------------------------------------------------------------
    def train_progressive(
        self,
        train_loader: Iterable,
        val_loader: Iterable,
        max_stages: int = 4,
        save_dir: str = "./uncertainty_guided_weights",
        stages: Iterable[int] | None = None,
        checkpoint_every: int | None = None,
        resume: bool = False,
        preemption=None,
    ) -> dict[str, list]:
        """Stages 1..max_stages (or ``stages``).  Per epoch: train,
        validate, log a ``training_log.csv`` row, and write
        ``ug_pgunet_stage{S}_best`` (``.pth``, or the directory) when the
        validation Dice improves; ``checkpoint_every=N`` also writes
        ``ug_pgunet_stage{S}_last`` every N epochs.  Loaders may be dicts
        keyed by stage.

        ``resume=True`` restores the latest ``_last`` in ``save_dir``, a
        ``.pth`` or a directory (``io.checkpoint.find_checkpoint``: of both,
        the later epoch's), with weights, optimizer state and history;
        earlier stages' weights from their ``_best``, else ``_last``; and
        continues after its epoch; the stage's ``_best`` keeps gating on
        the Dice it recorded.  The
        augmentation generator and the loaders' order are not restored (nor
        are they in the JAX package).  ``preemption`` (a
        ``utils.preemption.PreemptionGuard``) is polled at each epoch's
        end: when armed, the loop writes ``_last``, sets ``self.preempted``
        and returns."""
        save_path = Path(save_dir)
        save_path.mkdir(parents=True, exist_ok=True)
        resume_stage = resume_epoch = None
        if resume:
            resume_stage, resume_epoch = self._find_resume_point(save_path)
            if resume_stage is not None:
                self._print(f"Resuming from stage {resume_stage}, epoch {resume_epoch + 1}")
        writer = distributed.is_writer()
        csv_log = CSVLogger(
            save_path / "training_log.csv",
            ["stage", "epoch", "train_loss", "val_loss", "train_dice", "val_dice",
             "train_acc", "val_acc", "base_loss", "uncertainty_mean", "lr", "epoch_time_s"]
        ) if writer else None
        tb = TBWriter(self.tb_logdir if writer else None)
        self._print("Starting Uncertainty-Guided Progressive Growing U-Net Training")

        stage_list = list(stages) if stages is not None else list(range(1, max_stages + 1))
        self.preempted = False
        for stage in stage_list:
            if self.preempted:
                break
            tl = train_loader[stage] if isinstance(train_loader, dict) else train_loader
            vl = val_loader[stage] if isinstance(val_loader, dict) else val_loader
            cfg = self.stage_configs[stage]
            self._print(f"\nStage {stage} — {cfg['resolution']}x{cfg['resolution']}"
                        + (f" (uncertainty alpha={self.uncertainty_alpha})" if stage > 1 else ""))
            start_epoch = 0
            if resume_stage is not None:
                if stage < resume_stage:
                    self._print(f"Resume: skipping completed stage {stage}")
                    continue
                if stage == resume_stage:
                    self.current_stage = stage
                    self.setup_optimizer(stage)
                    self._restore_last(save_path, stage)
                    start_epoch = resume_epoch + 1
                    resume_stage = None
                    if start_epoch >= cfg["epochs_per_stage"]:
                        continue
                else:
                    # the stage list skipped past the resume stage: load its
                    # trained weights, or the transfer below and the
                    # uncertainty source would use a fresh initialisation
                    for suffix in ("last", "best"):
                        ckpt = find_checkpoint(save_path,
                                               f"ug_pgunet_stage{resume_stage}_{suffix}")
                        if ckpt is not None:
                            self.load_stage_weights(resume_stage, ckpt)
                            break
                    resume_stage = None
            if start_epoch == 0:
                if stage > 1:
                    self.transfer_weights(stage - 1, stage)
                self.current_stage = stage
                self.setup_optimizer(stage)
                self.history["stage_transitions"].append(len(self.history["train_loss"]))
            # mid-stage: the restored history holds this stage's transition,
            # and the _best on disk keeps gating (0 would let a worse epoch
            # overwrite better weights)
            best_val_dice = (self._best_val_dice_on_disk(save_path, stage)
                             if start_epoch > 0 else 0.0)
            for epoch in range(start_epoch, cfg["epochs_per_stage"]):
                t0 = time.time()
                tr_loss, tr_base, tr_dice, tr_acc, _, _ = self.train_epoch(tl, stage)
                va_loss, va_base, va_dice, va_acc, va_um, va_us = self.validate_epoch(vl, stage)
                self.history["train_loss"].append(tr_loss)
                self.history["val_loss"].append(va_loss)
                self.history["train_dice"].append(tr_dice)
                self.history["val_dice"].append(va_dice)
                self.history["uncertainty_weights_mean"].append(va_um)
                self.history["uncertainty_weights_std"].append(va_us)
                self.history["base_loss"].append(va_base)
                if csv_log is not None:
                    csv_log.log(
                        stage=stage, epoch=epoch + 1,
                        train_loss=round(tr_loss, 6), val_loss=round(va_loss, 6),
                        train_dice=round(tr_dice, 6), val_dice=round(va_dice, 6),
                        train_acc=round(tr_acc, 6), val_acc=round(va_acc, 6),
                        base_loss=round(va_base, 6), uncertainty_mean=round(va_um, 6),
                        lr=get_learning_rate(self.optimizer),
                        epoch_time_s=round(time.time() - t0, 3))
                tb.scalars(len(self.history["train_loss"]) - 1,
                           **{f"stage{stage}/train_loss": tr_loss,
                              f"stage{stage}/val_loss": va_loss,
                              f"stage{stage}/train_dice": tr_dice,
                              f"stage{stage}/val_dice": va_dice,
                              f"stage{stage}/uncertainty_mean": va_um})
                self._print(
                    f"Stage {stage}, Epoch {epoch + 1}/{cfg['epochs_per_stage']} "
                    f"({time.time() - t0:.2f}s)\n"
                    f"Train - Loss: {tr_loss:.4f}, Base: {tr_base:.4f}, "
                    f"Dice: {tr_dice:.4f}, Acc: {tr_acc:.4f}\n"
                    f"Val   - Loss: {va_loss:.4f}, Base: {va_base:.4f}, "
                    f"Dice: {va_dice:.4f}, Acc: {va_acc:.4f}")

                if self.nan_guard:
                    bad = nonfinite_metrics(train_loss=tr_loss, val_loss=va_loss)
                    if bad:
                        ckpt = self._checkpoint(
                            save_path, f"ug_pgunet_stage{stage}_diverged", stage, epoch,
                            diverged_metrics={k: repr(v) for k, v in bad.items()})
                        wait_for_async_saves()
                        raise TrainingDivergedError(stage, epoch + 1, bad, ckpt)
                if va_dice > best_val_dice:
                    best_val_dice = va_dice
                    self._checkpoint(save_path, f"ug_pgunet_stage{stage}_best", stage, epoch,
                                     val_dice=va_dice, train_dice=tr_dice)
                rolled = checkpoint_every and (epoch + 1) % checkpoint_every == 0
                stopping = distributed.agree(preemption is not None and preemption.should_stop())
                if rolled or stopping:
                    self._checkpoint(save_path, f"ug_pgunet_stage{stage}_last", stage, epoch,
                                     val_dice=va_dice)
                if stopping:
                    self.preempted = True
                    self._print(
                        f"Preemption requested (signal {getattr(preemption, 'signum', None)}): "
                        f"rolling checkpoint saved at stage {stage}, epoch {epoch + 1}; "
                        "restart with resume=True to continue")
                    break
        wait_for_async_saves()  # durable checkpoints before returning
        tb.close()
        self._print("Uncertainty-guided progressive training "
                    + ("preempted — resumable from the _last checkpoint"
                       if self.preempted else "completed!"))
        if writer:
            self.save_training_plots(save_path)
        return self.history

    def finetune_native(self, train_loader: Iterable, stage: int = 4, epochs: int = 1,
                        mesh=None, w_axis: str | None = None, lr: float | None = None,
                        val_loader: Iterable | None = None, save_dir: str | None = None,
                        dtype=_UNSET, accum_steps: int = 1) -> dict[str, list]:
        """Fine-tune one stage at native slide resolution, spatially
        sharded (``parallel/spatial.py::make_spatial_train_step``: H over
        the mesh's ``data`` axis, W over ``w_axis`` too when given, 1-px
        halos both ways, global-batch BN and loss), with a fresh RMSprop
        (``lr``: default the stage's) that becomes the trainer's optimizer.
        ``mesh``: default the trainer's; without one ``ValueError``, as in
        the JAX package.  ``dtype``: default the trainer's compute dtype
        (None: float32).  ``accum_steps`` defaults to 1, not the trainer's
        setting: native loaders yield whole slides, batch 1.

        Each batch keeps its native size, cropped bottom and right to the
        grid's divisor (cropped, not padded: pad pixels would enter the
        loss mean; a slide smaller than the divisor raises), and is
        prefetched to the mesh's first device.  The previous stage stays
        the uncertainty source.  ``val_loader``: a validation pass per
        epoch.  The stage's model keeps the result; ``save_dir``: also
        ``ug_pgunet_stage{S}_native`` in the trainer's backend (weights,
        optimizer state, the JAX package's metadata keys), which the
        predictors load.
        Returns the per-epoch train (and validation) loss and Dice."""
        mesh = mesh if mesh is not None else self.mesh
        if mesh is None:
            raise ValueError("finetune_native needs a mesh (e.g. parallel.mesh.make_mesh)")
        dtype = self.dtype if dtype is _UNSET else (dtype or torch.float32)
        model = self._model(stage)
        prev_model = self._model(stage - 1) if stage > 1 else None
        optimizer = torch_rmsprop(model.parameters(),
                                  lr if lr is not None else self.stage_configs[stage]["lr"],
                                  weight_decay=self.weight_decay,
                                  capturable=self._capturable)
        kw = dict(w_axis=w_axis, prev_model=prev_model, alpha=self.uncertainty_alpha,
                  dtype=dtype)
        step = make_spatial_train_step(model, optimizer, stage, mesh, accum_steps=accum_steps,
                                       fused_loss=self.fused_loss, **kw)
        eval_step = (make_spatial_eval_step(model, stage, mesh, **kw)
                     if val_loader is not None else None)
        h_div, w_div = spatial_divisor(stage, mesh, "data", w_axis)

        def crop(images, masks):
            ch, cw = (images.shape[1] // h_div) * h_div, (images.shape[2] // w_div) * w_div
            if ch == 0 or cw == 0:
                raise ValueError(f"native size {tuple(images.shape[1:3])} smaller than the grid "
                                 f"divisor ({h_div}, {w_div})")
            return images[:, :ch, :cw], masks[:, :ch, :cw]

        hist: dict[str, list] = {"train_loss": [], "train_dice": [], "val_loss": [],
                                 "val_dice": []}
        home = tensor_device(mesh.first)
        for epoch in range(epochs):
            t0 = time.time()
            acc = []
            with contextlib.closing(prefetch_to_device((crop(*b) for b in train_loader), size=2,
                                                       device=home)) as batches:
                for batch in batches:
                    distributed.check_same_shape(tuple(batch[0].shape))
                    acc.append(step(batch, self.pos_weight))
            tr_loss, _, tr_dice, *_ = self._average(acc)
            hist["train_loss"].append(tr_loss)
            hist["train_dice"].append(tr_dice)
            msg = (f"Native fine-tune stage {stage}, epoch {epoch + 1}/{epochs} "
                   f"({time.time() - t0:.2f}s) — loss {tr_loss:.4f}, dice {tr_dice:.4f}")
            if eval_step is not None:
                va_loss, _, va_dice, *_ = self._average(
                    [eval_step(crop(*b), self.pos_weight) for b in val_loader])
                hist["val_loss"].append(va_loss)
                hist["val_dice"].append(va_dice)
                msg += f"; val loss {va_loss:.4f}, dice {va_dice:.4f}"
            self._print(msg)

        self.optimizer, self._optimizer_stage = optimizer, stage
        for key in (stage, (stage, "mesh")):  # built on the optimizer replaced here
            self._train_steps.pop(key, None)
        self._epochs.clear()
        if save_dir is not None and distributed.is_writer():
            save_checkpoint(checkpoint_path(save_dir, f"ug_pgunet_stage{stage}_native",
                                            self.checkpoint_backend),
                            model.state_dict(), backend=self.checkpoint_backend,
                            param_names=param_names(optimizer, model),
                            optimizer_state_dict=optimizer.state_dict(),
                            stage=stage, native_finetune=True, epochs=epochs,
                            uncertainty_alpha=self.uncertainty_alpha, history=hist)
            wait_for_async_saves()
        distributed.barrier()
        return hist

    # ------------------------------------------------------------------
    @staticmethod
    def _best_val_dice_on_disk(save_path: Path, stage: int) -> float:
        """val_dice recorded in the stage's ``_best`` (0.0 if none)."""
        try:
            path = find_checkpoint(save_path, f"ug_pgunet_stage{stage}_best")
            return 0.0 if path is None else float(
                checkpoint_metadata(path).get("val_dice", 0.0))
        except (OSError, RuntimeError, ValueError):
            return 0.0

    def _find_resume_point(self, save_path: Path):
        """The latest stage with a ``_last`` -> (stage, epoch), or
        (None, None); loads every earlier stage's weights (the frozen
        uncertainty sources), from ``_best`` before ``_last``."""
        for stage in (4, 3, 2, 1):
            last = find_checkpoint(save_path, f"ug_pgunet_stage{stage}_last")
            if last is not None:
                break
        else:
            return None, None
        epoch = int(checkpoint_metadata(last).get("epoch", -1))
        for s in range(1, stage):
            for suffix in ("best", "last"):
                ckpt = find_checkpoint(save_path, f"ug_pgunet_stage{s}_{suffix}")
                if ckpt is not None:
                    self.load_stage_weights(s, ckpt)
                    break
        return stage, epoch

    def _restore_last(self, save_path: Path, stage: int) -> None:
        """Weights, optimizer state and history from the stage's ``_last``,
        for a mid-stage resume."""
        obj = read_checkpoint(find_checkpoint(save_path, f"ug_pgunet_stage{stage}_last"))
        model = self._model(stage)
        model.load_state_dict(obj["model_state_dict"], strict=True)
        if obj.get("optimizer_state_dict") is not None:
            load_optimizer_state(self.optimizer, obj["optimizer_state_dict"],
                                 param_names(self.optimizer, model), obj.get("lr"))
        distributed.broadcast_module(self._model(stage))
        self._epochs.clear()  # a graph would read the replaced optimizer state
        if isinstance(obj.get("history"), dict):
            for k, v in obj["history"].items():
                if k in self.history and isinstance(v, list):
                    self.history[k] = list(v)

    def load_stage_weights(self, stage: int, path: str) -> None:
        """Load one stage's weights from a ``.pth`` or a msgpack directory
        (strict)."""
        _, state_dict = load_checkpoint(path)
        self._model(stage).load_state_dict(state_dict, strict=True)
        distributed.broadcast_module(self._model(stage))
        self._epochs.clear()
        self._print(f"Loaded weights for stage {stage} from {path}")

    def save_uncertainty_analysis(self, data_loader: Iterable, stage: int, save_path):
        """Uncertainty statistics of the first 10 batches, as
        ``uncertainty_stats_stage{S}.json``; None at stage 1."""
        if stage == 1:
            self._print("No uncertainty analysis for stage 1 (base stage)")
            return None
        res = self.stage_configs[stage]["resolution"]
        prev_model, prev_res = self._prev(stage)
        prev_model.eval()
        stats = []
        for batch_idx, batch in enumerate(data_loader):
            if batch_idx >= 10:
                break
            images = torch.as_tensor(batch[0], dtype=torch.float32).to(self.device)
            x = resize_bilinear_align_corners(images.permute(0, 3, 1, 2), (res, res))
            amap = generate_uncertainty_map(prev_model, x, prev_res, res)
            stats.append({
                "batch_idx": batch_idx,
                "uncertainty_mean": float(amap.mean()),
                "uncertainty_std": float(amap.std(correction=0)),
                "uncertainty_min": float(amap.min()),
                "uncertainty_max": float(amap.max()),
            })
        out = Path(save_path) / f"uncertainty_stats_stage{stage}.json"
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(stats, indent=2))
        self._print(f"Uncertainty analysis saved for stage {stage}")
        return stats

    def save_training_plots(self, save_path):
        """4-panel history plot; skipped when matplotlib is not installed."""
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            self._print("matplotlib not available; skipping plots")
            return None

        h = self.history
        epochs = range(len(h["train_loss"]))
        fig, ((ax1, ax2), (ax3, ax4)) = plt.subplots(2, 2, figsize=(16, 12))
        ax1.plot(epochs, h["train_loss"], label="Train Loss (Weighted)", alpha=0.7)
        ax1.plot(epochs, h["val_loss"], label="Val Loss (Weighted)", alpha=0.7)
        ax1.plot(epochs, h["base_loss"], "--", label="Base Loss (Unweighted)", alpha=0.7)
        ax1.set_title("Loss (Uncertainty-Guided)")
        ax2.plot(epochs, h["train_dice"], label="Train Dice")
        ax2.plot(epochs, h["val_dice"], label="Val Dice")
        ax2.set_title("Dice Coefficient")
        um = np.array(h["uncertainty_weights_mean"])
        us = np.array(h["uncertainty_weights_std"])
        ax3.plot(epochs, um, label="Mean Uncertainty Weight")
        if len(um):
            ax3.fill_between(epochs, um - us, um + us, alpha=0.3, label="±1 Std")
        ax3.set_title("Uncertainty Weights")
        diff = np.array(h["val_loss"]) - np.array(h["base_loss"])
        ax4.plot(epochs, diff, label="Weighted − Base", alpha=0.7)
        ax4.axhline(0, color="black", alpha=0.3)
        ax4.set_title("Impact of Uncertainty Weighting")
        for ax in (ax1, ax2, ax3, ax4):
            for t in h["stage_transitions"]:
                ax.axvline(t, color="red", linestyle="--", alpha=0.5)
            ax.set_xlabel("Epoch")
            ax.legend()
        fig.tight_layout()
        out = Path(save_path) / "uncertainty_guided_training_plots.png"
        fig.savefig(out, dpi=150, bbox_inches="tight")
        plt.close(fig)
        self._print(f"Training plots saved to {out}")
        return out
