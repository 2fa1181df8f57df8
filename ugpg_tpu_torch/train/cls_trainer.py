"""HerlevTrainer: the progressive classification trainer (counterpart of
``ugpg_tpu/train/cls_trainer.py``).

* stage resolutions {1: 32, 2: 64, 3: 128, 4: 224}, lr 3e-4 at stage 1
  and 1e-4 after; Adam(weight_decay 1e-4) and ``ReduceLROnPlateau(0.5,
  patience 5)`` on the validation loss, both built anew at every stage
* class-weighted CE; at stages > 1 every sample's CE weighted by
  ``1 + alpha A``, A the normalised entropy of the frozen previous stage
* head-only weight transfer between stages (``classifier.*`` on an exact
  shape match); ``pretrained_unet_paths`` merges a segmentation ``.pth``
  or msgpack directory into a stage's encoder and freezes it
  (``freeze_subtrees``)
* per stage the best-validation-accuracy ``herlev_stage{S}_best.pth`` with
  the config (reference schema and key set; ``checkpoint_backend="msgpack"``,
  ``"orbax"`` or ``"orbax-async"``: the JAX package's directory ``herlev_stage{S}_best``, and so for every
  checkpoint below; resume reads either form), early stopping after 15
  epochs without improvement, ``training_log.csv``, the history JSON, and
  the NaN guard (``herlev_stage{S}_diverged.pth``, then
  ``TrainingDivergedError``)
* a ``PreemptionGuard`` polled at every epoch's end: when armed, the loop
  writes ``herlev_stage{S}_last.pth`` (weights, optimizer and scheduler
  state, early-stopping state, history, the generator's state) and
  returns with ``preempted`` set; ``resume=True`` continues from it.  The
  trainer's randomness (dropout masks, augmentation) comes from one
  ``torch.Generator`` seeded by ``seed + 1``, which ``_last`` carries, so a
  resumed run trains the bits an uninterrupted one trains when the loaders
  give the same batches (a shuffling loader restarts its sequence)
* ``dtype=torch.bfloat16``: bf16 compute over float32 parameters
* the config's ``remat`` (each encoder DoubleConv recomputed in the
  backward), ``tb_logdir`` (per-epoch TensorBoard scalars) and
  ``pipeline_unc`` (stages > 1 through the uncertainty pipeline,
  ``parallel/pipeline.py``)
* ``mesh`` and ``shard_model``: data-parallel (and column-parallel) steps
  with cross-replica BN (``train/steps.py``)
* the config's ``scan_epochs`` and ``scan_chunk_bytes``: whole epochs in
  chunks, replayed from a CUDA graph on one card (as in
  ``train/seg_trainer.py``)

The loop reads the device once per epoch.
"""

from __future__ import annotations

import contextlib
import json
import os
from pathlib import Path
from typing import Any, Iterable, Mapping

import numpy as np
import torch

from ugpg_tpu_torch.data.loader import prefetch_to_device
from ugpg_tpu_torch.device import resolve_device
from ugpg_tpu_torch.io.checkpoint import (
    checkpoint_backend_of,
    checkpoint_path,
    classifier_decoder_fill,
    classifier_state_dict,
    find_checkpoint,
    full_classifier_state_dict,
    read_checkpoint,
    save_checkpoint,
    wait_for_async_saves,
)
from ugpg_tpu_torch.models.blocks import DoubleConv, init_parameters
from ugpg_tpu_torch.models.classifier import CLS_STAGE_RESOLUTIONS, HerlevClassificationModel
from ugpg_tpu_torch.parallel import distributed
from ugpg_tpu_torch.parallel.mesh import data_axis_size, tensor_device
from ugpg_tpu_torch.parallel.pipeline import (
    UncertaintyPipeline,
    pipeline_check,
    pipeline_device_list,
)
from ugpg_tpu_torch.progressive.transfer import transfer_weights
from ugpg_tpu_torch.train.optim import (
    ReduceLROnPlateau,
    freeze_subtrees,
    get_learning_rate,
    load_optimizer_state,
    param_names,
    torch_adam,
)
from ugpg_tpu_torch.train.steps import (
    CLS_METRIC_KEYS,
    draw_cls_epoch,
    make_cls_eval_epoch,
    make_cls_eval_step,
    make_cls_train_epoch,
    make_cls_train_step,
    reduce_cls_rows,
    run_scan_epoch,
    scan_batches,
    scan_rows,
)
from ugpg_tpu_torch.utils.anomaly import TrainingDivergedError, nonfinite_metrics
from ugpg_tpu_torch.utils.profiling import CSVLogger
from ugpg_tpu_torch.utils.tb import TBWriter

__all__ = ["HerlevTrainer", "create_config"]

_HEAD = "classifier."


def create_config() -> dict:
    """The default Herlev config (the JAX package's, paths removed)."""
    return {
        "data_dir": None,
        "binary_classification": False,
        "num_classes": 7,
        "pretrained_unet_paths": {},
        "batch_size": 16,
        "epochs_per_stage": 30,
        "stages": [1, 2, 3, 4],
        "num_workers": 4,
        "log_interval": 10,
        "early_stopping_patience": 15,
        "weight_decay": 1e-4,
        "class_weights": None,
        "uncertainty_alpha": 1.0,
        "split_ratios": {"train": 0.7, "val": 0.2, "test": 0.1},
        "output_dir": "./herlev_outputs",
    }


def _plain_config(config: Mapping[str, Any]) -> dict:
    return {k: v for k, v in config.items()
            if isinstance(v, (int, float, str, bool, list, dict, type(None)))}


def _reduce_rows(rows: torch.Tensor) -> tuple[float, ...]:
    """(loss, base loss, accuracy %, weight mean, weight std) from the
    epoch's (n, 6) metric rows (``reduce_cls_rows`` in float64): one read
    from the device."""
    if not len(rows):
        return (0.0,) * 5
    r = reduce_cls_rows(rows.cpu().numpy().astype(np.float64))
    return (float(r["final_loss"]), float(r["base_loss"]),
            100.0 * float(r["correct"]) / max(float(r["count"]), 1.0),
            float(r["uncertainty_weight_mean"]), float(r["uncertainty_weight_std"]))


class HerlevTrainer:
    """Progressive trainer for Herlev cervical-cell classification."""

    def __init__(self, config: Mapping[str, Any], dtype: torch.dtype | None = None,
                 axis_name: str | None = None, seed: int = 0, mesh=None,
                 shard_model: bool = True, checkpoint_backend: str = "pth",
                 nan_guard: bool = True, device: str | torch.device | None = None,
                 devices=None):
        """``config``: ``create_config()``'s keys, plus ``augment`` (default
        True), ``accum_steps`` (1) and ``verbose`` (True).  ``seed`` seeds
        each stage's initialisation and, as ``seed + 1``, the generator of
        dropout and augmentation.  ``dtype``: None or float32, or bfloat16
        compute.  ``device``: ``cuda`` unless given; raises without CUDA.
        ``shard_model`` acts with a mesh only, as in the JAX package.

        The config's ``remat``: each encoder DoubleConv recomputed in the
        backward (gradients and BN updates unchanged, bit for bit).
        ``tb_logdir``: per-epoch scalars (``stage{S}/train_loss``,
        ``val_loss``, ``train_acc``, ``val_acc``) as TensorBoard events, or
        one warning without the ``tensorboard`` package.
        ``pipeline_unc=N``: at stages > 1 the frozen previous stage's
        per-sample weights come from a producer on the last N devices
        (``parallel/pipeline.py``): the visible cards on ``cuda`` (one card
        and N = 1 raises ``ValueError``, as in the JAX package), N + 1
        times the CPU on ``cpu``, or ``devices`` when given (the JAX
        trainer's ``jax.devices()``): the last N form the unc group, the
        others a data-parallel train mesh, whose first device the models
        live on.  There each epoch's augmentation parameters are drawn from
        the generator before its dropout masks, so a pipelined run augments
        otherwise than a plain one.

        ``mesh``: every batch whose micro-batches split over its ``data``
        axis trains and validates data-parallel, the encoder's replicas in
        lock-step with BN over the whole batch, the dropout masks drawn for
        the whole batch and sliced (``train/steps.py``); another batch runs
        unsharded on the mesh's first device, where the models live.
        ``shard_model``: the wide encoder convs column-parallel over the
        ``model`` axis.  ``axis_name``: the blocks' BN axis, which no
        trainer binds: a train step raises the JAX package's ``NameError``.

        Over several processes (``parallel/distributed.py``): each process
        trains its loader's batches on its own ``mesh`` as its part of the
        global batch, whose loss, BN, metrics and averaged gradients every
        process shares (a ragged batch on a one-device mesh); the batches'
        shapes must agree.  Process 0 writes the checkpoints, the log, the
        events and the history; the others wait at a barrier.

        The config's ``scan_epochs`` and ``scan_chunk_bytes`` (default 1
        GiB, None unbounded): whole epochs in chunks, as the segmentation
        trainer runs them (``train/seg_trainer.py``); each chunk's
        augmentation parameters and dropout masks are drawn before it, per
        step in the per-step path's order, so the trajectory is that path's
        (on a card such a trainer takes the capturable optimizer for every
        step, ``train/optim.py``).

        ``checkpoint_backend``: ``"pth"`` (the port's default),
        ``"msgpack"``, ``"orbax"`` or ``"orbax-async"`` (the JAX package's
        directories; the trainer waits for the async saves before it raises
        or returns).  ``pipeline_unc`` with a
        ``mesh`` raises ``ValueError``."""
        self.config = dict(config)
        self.device = resolve_device(device)
        cfg = self.config
        self.pipeline_unc = int(cfg.get("pipeline_unc") or 0)
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
        self.scan_epochs = bool(cfg.get("scan_epochs", False))
        self.scan_chunk_bytes = cfg.get("scan_chunk_bytes", 1 << 30)
        self.devices = devices
        if self.pipeline_unc:
            self.device = pipeline_check(self.pipeline_unc, self.device, devices)
        # one optimizer variant for every step of a trainer (train/optim.py)
        self._capturable = self.scan_epochs and self.device.type == "cuda"
        self.remat = bool(cfg.get("remat"))
        if dtype not in (None, torch.float32, torch.bfloat16):
            raise ValueError(f"dtype must be None, float32 or bfloat16, got {dtype}")
        self.dtype = dtype or torch.float32
        self.nan_guard = nan_guard
        self.seed = seed
        self.num_classes = int(cfg["num_classes"])
        epochs = cfg.get("epochs_per_stage", 30)
        self.stage_configs = {
            s: {"resolution": CLS_STAGE_RESOLUTIONS[s], "epochs": epochs,
                "lr": 3e-4 if s == 1 else 1e-4}
            for s in (1, 2, 3, 4)
        }
        self.uncertainty_alpha = cfg.get("uncertainty_alpha", 1.0)
        self.verbose = cfg.get("verbose", True)
        self._print = print if self.verbose else (lambda *a, **kw: None)
        self.accum_steps = int(cfg.get("accum_steps", 1))
        if self.accum_steps < 1:
            raise ValueError(f"accum_steps must be >= 1, got {self.accum_steps}")
        cw = cfg.get("class_weights")
        self.class_weights = (None if cw is None else
                              torch.as_tensor(cw, dtype=torch.float32, device=self.device))
        # dropout masks and augmentation parameters (the JAX trainer's key)
        self.generator = torch.Generator(device=self.device).manual_seed(seed + 1)

        self.models: dict[int, HerlevClassificationModel] = {}  # built at first use
        self._frozen_stages: set[int] = set()
        self._fills: dict[int, dict] = {}  # the decoder keys a .pth carries
        self.current_stage = 1
        self.preempted = False
        self.optimizer: torch.optim.Optimizer | None = None
        self._scheduler: ReduceLROnPlateau | None = None
        self._train_steps: dict[int, Any] = {}
        self._eval_steps: dict[int, Any] = {}
        self._pipelines: dict[int, UncertaintyPipeline] = {}
        # whole-epoch functions per (stage, "train" | "eval", sharded); a
        # validation epoch's stacked device copy per stage
        self._epochs: dict[tuple, Any] = {}
        self._val_stack_cache: dict[int, tuple] = {}
        self.history: dict[str, list] = {
            "train_loss": [], "val_loss": [],
            "train_acc": [], "val_acc": [],
            "uncertainty_weights_mean": [], "uncertainty_weights_std": [],
            "base_loss": [],
            "stage_transitions": [],
        }
        for s, path in (cfg.get("pretrained_unet_paths") or {}).items():
            if path and os.path.exists(str(path)):
                self.load_pretrained_unet(int(s), path)

    # ------------------------------------------------------------------
    def _model(self, stage: int) -> HerlevClassificationModel:
        if stage not in self.models:
            model = HerlevClassificationModel(stage, self.num_classes, use_bn=True,
                                              dtype=self.dtype, remat=self.remat)
            init_parameters(model, torch.Generator().manual_seed(4 * self.seed + stage - 1))
            for block in model.modules():
                if isinstance(block, DoubleConv):
                    block.axis_name = self.axis_name
            self.models[stage] = model.to(self.device)
            distributed.broadcast_module(self.models[stage])
        return self.models[stage]

    def load_pretrained_unet(self, stage: int, ckpt_path) -> list[str]:
        """Merge a segmentation checkpoint's (``.pth`` or msgpack
        directory) matching encoder blocks into the stage's ``unet`` (the
        name-keyed overlap merge) and freeze it."""
        self._print(f"Loading pretrained U-Net weights from: {ckpt_path}")
        seg = read_checkpoint(ckpt_path)["model_state_dict"]
        model = self._model(stage)
        merged, copied = transfer_weights({f"unet.{k}": v for k, v in seg.items()},
                                          model.state_dict())
        model.load_state_dict(merged, strict=True)
        distributed.broadcast_module(model)
        self._frozen_stages.add(stage)
        self._print(f"  merged {len(copied)} encoder keys; encoder frozen")
        return copied

    def setup_optimizer_scheduler(self, stage: int) -> torch.optim.Optimizer:
        """A fresh Adam and plateau scheduler for the stage; the encoder of
        a stage with a pretrained U-Net is frozen."""
        model = self._model(stage)
        params = (freeze_subtrees(model, ("unet",)) if stage in self._frozen_stages
                  else list(model.parameters()))
        self.optimizer = torch_adam(params, self.stage_configs[stage]["lr"],
                                    weight_decay=self.config.get("weight_decay", 1e-4),
                                    capturable=self._capturable)
        self._scheduler = ReduceLROnPlateau(factor=0.5, patience=5)
        for key in (stage, (stage, "mesh")):
            self._train_steps.pop(key, None)
        self._pipelines.pop(stage, None)
        self._epochs.clear()
        return self.optimizer

    def transfer_weights(self, prev_stage: int, current_stage: int) -> int:
        """Copy the head's tensors whose shapes match; the encoder keeps its
        own initialisation."""
        self._print(f"Transferring weights from stage {prev_stage} to {current_stage}")
        prev = self._model(prev_stage).state_dict()
        cur = self._model(current_stage)
        state = cur.state_dict()
        copied = 0
        for key, value in prev.items():
            if key.startswith(_HEAD) and key in state and value.shape == state[key].shape:
                state[key] = value.detach().clone()
                copied += 1
        cur.load_state_dict(state, strict=True)
        distributed.broadcast_module(cur)
        self._epochs.clear()
        self._print(f"  Transferred {copied} classifier tensors")
        return copied

    def _prev(self, stage: int):
        if stage <= 1:
            return None, None
        return self._model(stage - 1), self.stage_configs[stage - 1]["resolution"]

    def _sharded(self, batch, accum_steps: int = 1) -> bool:
        """Whether ``batch`` runs on the mesh: its micro-batches split over
        the ``data`` axis (a ragged batch runs unsharded, the same
        function).  Over several processes every process's batch must
        have this shape."""
        if self.mesh is None:
            return False
        distributed.check_same_shape(tuple(batch[0].shape))
        n = len(batch[0])
        return n % accum_steps == 0 and (n // accum_steps) % self.mesh.shape["data"] == 0

    def _get_train_step(self, stage: int, sharded: bool = False):
        if self.optimizer is None:
            self.setup_optimizer_scheduler(stage)
        key = (stage, "mesh") if sharded else stage
        if key not in self._train_steps:
            prev_model, prev_res = self._prev(stage)
            self._train_steps[key] = make_cls_train_step(
                self._model(stage), self.optimizer, stage,
                self.stage_configs[stage]["resolution"], self.num_classes,
                prev_model=prev_model, prev_resolution=prev_res,
                alpha=self.uncertainty_alpha, augment=bool(self.config.get("augment", True)),
                normalize=True, accum_steps=self.accum_steps,
                mesh=distributed.step_mesh(self.mesh, sharded), shard_model=self.shard_model)
        return self._train_steps[key]

    def _get_pipeline(self, stage: int) -> UncertaintyPipeline:
        """The stage's pipeline, built at its first epoch, after the
        transfer and the optimizer."""
        if self.optimizer is None:
            self.setup_optimizer_scheduler(stage)
        if stage not in self._pipelines:
            prev_model, prev_res = self._prev(stage)
            pipe = UncertaintyPipeline(
                self._model(stage), prev_model, self.optimizer, stage,
                self.stage_configs[stage]["resolution"], prev_res,
                task_type="classification", num_classes=self.num_classes,
                n_unc=self.pipeline_unc,
                devices=pipeline_device_list(self.pipeline_unc, self.device, self.devices),
                alpha=self.uncertainty_alpha, augment=bool(self.config.get("augment", True)),
                normalize=True, accum_steps=self.accum_steps)
            pipe.create_state()
            pipe.place_prev()
            self._pipelines[stage] = pipe
        return self._pipelines[stage]

    def _get_eval_step(self, stage: int, sharded: bool = False):
        key = (stage, "mesh") if sharded else stage
        if key not in self._eval_steps:
            prev_model, prev_res = self._prev(stage)
            self._eval_steps[key] = make_cls_eval_step(
                self._model(stage), stage, self.stage_configs[stage]["resolution"],
                self.num_classes, prev_model=prev_model, prev_resolution=prev_res,
                alpha=self.uncertainty_alpha, normalize=True,
                mesh=distributed.step_mesh(self.mesh, sharded), shard_model=self.shard_model)
        return self._eval_steps[key]

    @staticmethod
    def _reduce_epoch(metrics: list[dict]) -> tuple[float, ...]:
        """(loss, base loss, accuracy %, weight mean, weight std): one read
        from the device for the epoch."""
        return _reduce_rows(scan_rows([], metrics, CLS_METRIC_KEYS))


    # ------------------------------------------------------------------ whole epochs
    def _epoch_fn(self, stage: int, train: bool, sharded: bool):
        """The stage's whole-epoch train or eval function (a CUDA graph's
        runner on one card); those of other stages are dropped."""
        if train and self.optimizer is None:
            self.setup_optimizer_scheduler(stage)
        for key in [k for k in self._epochs if k[0] != stage]:
            del self._epochs[key]
        key = (stage, "train" if train else "eval", sharded)
        if key not in self._epochs:
            prev_model, prev_res = self._prev(stage)
            kw = dict(prev_model=prev_model, prev_resolution=prev_res,
                      alpha=self.uncertainty_alpha, normalize=True,
                      mesh=distributed.step_mesh(self.mesh, sharded),
                      shard_model=self.shard_model)
            res = self.stage_configs[stage]["resolution"]
            self._epochs[key] = (
                make_cls_train_epoch(self._model(stage), self.optimizer, stage, res,
                                     self.num_classes,
                                     augment=bool(self.config.get("augment", True)),
                                     accum_steps=self.accum_steps, **kw)
                if train else make_cls_eval_epoch(self._model(stage), stage, res,
                                                  self.num_classes, **kw))
        return self._epochs[key]

    def _scan_epoch(self, batches: list, stage: int, train: bool, token=None):
        """One train or validation epoch on the whole-epoch path
        (``train/steps.py::run_scan_epoch``): each chunk's augmentation
        parameters and dropout masks drawn before it, the tail per step, a
        validation set of one chunk kept per stage."""
        accum = self.accum_steps if train else 1
        sharded = self._sharded(batches[0], accum)
        draw = None
        if train:
            augment = bool(self.config.get("augment", True))

            def tail(batch):
                return self._get_train_step(stage, self._sharded(batch, accum))(
                    batch, self.class_weights, self.generator)

            def draw(n, stacked):
                _, b, h, w = stacked[0].shape[:4]
                return dict(zip(("aug", "drop"), draw_cls_epoch(
                    self.generator, self._model(stage), n, b, h, w, augment, accum)))
        else:
            def tail(batch):
                return self._get_eval_step(stage, self._sharded(batch))(batch,
                                                                        self.class_weights)
        return _reduce_rows(run_scan_epoch(
            batches, self._epoch_fn(stage, train, sharded), (self.class_weights,), tail,
            ("images", "labels"), CLS_METRIC_KEYS, self.scan_chunk_bytes,
            mesh=self.mesh if sharded else None, device=self.device, draw=draw,
            cache=None if train else self._val_stack_cache, cache_key=stage, token=token))

    def _prefetch(self, dataloader: Iterable):
        return prefetch_to_device(iter(dataloader), size=2, device=self.device)

    # ------------------------------------------------------------------
    def train_epoch(self, dataloader: Iterable, stage: int) -> tuple[float, ...]:
        if self.pipeline_unc and stage > 1:
            pipe = self._get_pipeline(stage)
            augment = bool(self.config.get("augment", True))
            if self.scan_epochs:
                return _reduce_rows(scan_rows(*pipe.run_epoch_scan(
                    list(dataloader), self.class_weights, aug=self.generator if augment else None,
                    generator=self.generator, chunk_bytes=self.scan_chunk_bytes),
                    CLS_METRIC_KEYS))
            return self._reduce_epoch(pipe.run_epoch(
                list(dataloader), self.class_weights,
                aug=self.generator if augment else None, generator=self.generator))
        dataloader, whole = scan_batches(dataloader, self.scan_epochs, self.mesh)
        if whole:
            return self._scan_epoch(dataloader, stage, True)
        log_every = self.config.get("log_interval", 10)
        collected = []
        with contextlib.closing(self._prefetch(dataloader)) as batches:
            for batch_idx, batch in enumerate(batches):
                step = self._get_train_step(stage, self._sharded(batch, self.accum_steps))
                m = step(batch, self.class_weights, self.generator)
                collected.append(m)
                if self.verbose and batch_idx % log_every == 0:
                    self._print(f"Stage {stage}, Batch {batch_idx} "
                                f"Loss: {float(m['final_loss']):.6f} "
                                f"Base: {float(m['base_loss']):.6f}")
        return self._reduce_epoch(collected)

    def validate_epoch(self, dataloader: Iterable, stage: int) -> tuple[float, ...]:
        token = id(dataloader)
        dataloader, whole = scan_batches(dataloader, self.scan_epochs, self.mesh)
        if whole:
            return self._scan_epoch(dataloader, stage, False, token)
        with contextlib.closing(self._prefetch(dataloader)) as batches:
            return self._reduce_epoch([self._get_eval_step(stage, self._sharded(batch))(
                batch, self.class_weights) for batch in batches])

    def _state_dict(self, stage: int) -> dict:
        """The stage's weights with the reference's full ``unet`` key set."""
        if stage not in self._fills:
            self._fills[stage] = classifier_decoder_fill(stage)
        return full_classifier_state_dict(self._model(stage).state_dict(), stage,
                                          self._fills[stage])

    def _save(self, save_path: Path, name: str, stage: int, epoch: int, **metadata) -> Path:
        """Write checkpoint ``name`` in the trainer's backend (process 0;
        the others wait for it)."""
        path = checkpoint_path(save_path, name, self.checkpoint_backend)
        state = self._state_dict(stage)
        if distributed.is_writer():
            save_checkpoint(path, state, backend=self.checkpoint_backend,
                            param_names=param_names(self.optimizer, self._model(stage)),
                            stage=stage, epoch=epoch,
                            optimizer_state_dict=self.optimizer.state_dict(),
                            config=_plain_config(self.config), **metadata)
        distributed.barrier()
        return path

    # ------------------------------------------------------------------
    def train_progressive(self, train_loaders, val_loaders, save_dir: str,
                          preemption=None, resume: bool = False) -> dict[str, list]:
        """The stages of ``config["stages"]`` with early stopping and
        best-accuracy checkpoints.  Loaders may be dicts keyed by stage.

        ``preemption`` (``utils.preemption.PreemptionGuard``) is polled at
        each epoch's end; when armed, the loop writes
        ``herlev_stage{S}_last`` and returns.  ``resume=True`` restores
        the latest ``_last`` in ``save_dir``, a ``.pth`` or a directory (of
        both, the later epoch's), earlier stages' weights from their
        ``_best``, else ``_last``, and continues after its epoch."""
        save_path = Path(save_dir)
        save_path.mkdir(parents=True, exist_ok=True)
        resume_stage = resume_meta = None
        if resume:
            resume_stage, resume_meta = self._find_resume_point(save_path)
            if resume_stage is not None:
                self._print(f"Resuming from stage {resume_stage}, "
                            f"epoch {resume_meta.get('epoch', 0) + 1}")
        writer = distributed.is_writer()
        csv_log = CSVLogger(save_path / "training_log.csv",
                            ["stage", "epoch", "train_loss", "val_loss", "train_acc",
                             "val_acc", "base_loss", "uncertainty_mean", "lr"]
                            ) if writer else None
        tb = TBWriter(self.config.get("tb_logdir") if writer else None)
        self.preempted = False
        for stage in self.config["stages"]:
            if self.preempted:
                break
            cfg = self.stage_configs[stage]
            start_epoch = 0
            best_val_acc, best_val_loss = 0.0, float("inf")
            epochs_without_improvement = 0
            saved_any = False
            if resume_stage is not None:
                if stage < resume_stage:
                    self._print(f"Resume: skipping completed stage {stage}")
                    continue
                if stage == resume_stage:
                    self._print(f"\nResuming Stage {stage} - Resolution: {cfg['resolution']}")
                    self.current_stage = stage
                    self.setup_optimizer_scheduler(stage)
                    self._restore_last(stage, resume_meta)
                    # "epoch" counts completed epochs: the next one's index
                    start_epoch = int(resume_meta.get("epoch", 0))
                    best_val_acc = float(resume_meta.get("best_val_acc", 0.0))
                    best_val_loss = float(resume_meta.get("best_val_loss", float("inf")))
                    epochs_without_improvement = int(
                        resume_meta.get("epochs_without_improvement", 0))
                    saved_any = bool(resume_meta.get("saved_any", True))
                    resume_stage = None
                    if start_epoch >= cfg["epochs"]:
                        self.history["stage_transitions"].append(
                            {"stage": stage, "best_val_acc": best_val_acc,
                             "best_val_loss": best_val_loss})
                        continue
                else:
                    # the stage list skipped past the resume stage: its
                    # trained weights, not a fresh initialisation, feed the
                    # transfer and the uncertainty
                    for suffix in ("last", "best"):
                        ckpt = find_checkpoint(save_path,
                                               f"herlev_stage{resume_stage}_{suffix}")
                        if ckpt is not None:
                            self.load_stage_weights(resume_stage, ckpt)
                            break
                    resume_stage = None
            if start_epoch == 0:
                self._print(f"\nTraining Stage {stage} - Resolution: {cfg['resolution']}")
                self.current_stage = stage
                if stage > 1:
                    self.transfer_weights(stage - 1, stage)
                self.setup_optimizer_scheduler(stage)

            tl = train_loaders[stage] if isinstance(train_loaders, dict) else train_loaders
            vl = val_loaders[stage] if isinstance(val_loaders, dict) else val_loaders
            for epoch in range(start_epoch, cfg["epochs"]):
                tr_loss, tr_base, tr_acc, _, _ = self.train_epoch(tl, stage)
                va_loss, va_base, va_acc, va_um, va_us = self.validate_epoch(vl, stage)
                # the lr this epoch trained with, before the plateau step
                epoch_lr = get_learning_rate(self.optimizer)
                self._scheduler.step(va_loss, self.optimizer)

                self.history["train_loss"].append(tr_loss)
                self.history["val_loss"].append(va_loss)
                self.history["train_acc"].append(tr_acc)
                self.history["val_acc"].append(va_acc)
                self.history["uncertainty_weights_mean"].append(va_um)
                self.history["uncertainty_weights_std"].append(va_us)
                self.history["base_loss"].append(va_base)
                if csv_log is not None:
                    csv_log.log(stage=stage, epoch=epoch + 1,
                                train_loss=round(tr_loss, 6), val_loss=round(va_loss, 6),
                                train_acc=round(tr_acc, 4), val_acc=round(va_acc, 4),
                                base_loss=round(va_base, 6), uncertainty_mean=round(va_um, 6),
                                lr=epoch_lr)
                tb.scalars(len(self.history["train_loss"]) - 1,
                           **{f"stage{stage}/train_loss": tr_loss,
                              f"stage{stage}/val_loss": va_loss,
                              f"stage{stage}/train_acc": tr_acc,
                              f"stage{stage}/val_acc": va_acc})
                self._print(f"Stage {stage} Epoch {epoch + 1}/{cfg['epochs']} | "
                            f"Train {tr_loss:.4f}/{tr_acc:.2f}% | "
                            f"Val {va_loss:.4f}/{va_acc:.2f}%")

                if self.nan_guard:
                    bad = nonfinite_metrics(train_loss=tr_loss, val_loss=va_loss)
                    if bad:
                        ckpt = self._save(
                            save_path, f"herlev_stage{stage}_diverged", stage, epoch + 1,
                            diverged_metrics={k: repr(v) for k, v in bad.items()},
                            history=self.history)
                        wait_for_async_saves()
                        raise TrainingDivergedError(stage, epoch + 1, bad, ckpt)

                # strict > as the reference, but at least one checkpoint a stage
                if va_acc > best_val_acc or not saved_any:
                    best_val_acc = max(best_val_acc, va_acc)
                    best_val_loss = va_loss
                    epochs_without_improvement = 0
                    saved_any = True
                    self._save(save_path, f"herlev_stage{stage}_best", stage, epoch + 1,
                               train_loss=tr_loss, val_loss=va_loss, train_acc=tr_acc,
                               val_acc=va_acc)
                    self._print(f"New best model saved! Val Acc: {va_acc:.2f}%")
                else:
                    epochs_without_improvement += 1

                # a pending SIGTERM is acknowledged even when early stopping
                # fires in the same epoch
                if distributed.agree(preemption is not None and preemption.should_stop()):
                    self.preempted = True
                    self._save(
                        save_path, f"herlev_stage{stage}_last", stage, epoch + 1,
                        val_acc=va_acc, val_loss=va_loss, best_val_acc=best_val_acc,
                        best_val_loss=best_val_loss,
                        epochs_without_improvement=epochs_without_improvement,
                        saved_any=saved_any,
                        scheduler={"best": self._scheduler.best,
                                   "num_bad_epochs": self._scheduler.num_bad_epochs},
                        history=self.history, generator_state=self.generator.get_state())
                    self._print(f"Preemption requested (signal "
                                f"{getattr(preemption, 'signum', None)}): "
                                f"herlev_stage{stage}_last saved at epoch {epoch + 1}; "
                                "restart with resume=True (--resume) to continue")
                    break

                if epochs_without_improvement >= self.config.get("early_stopping_patience", 15):
                    self._print(f"Early stopping after {epochs_without_improvement} "
                                "epochs without improvement")
                    break

            self.history["stage_transitions"].append(
                {"stage": stage, "best_val_acc": best_val_acc, "best_val_loss": best_val_loss})
            self._print(f"Stage {stage} completed. Best Val Acc: {best_val_acc:.2f}%")

        wait_for_async_saves()  # durable checkpoints before returning
        tb.close()
        hist_path = save_path / "training_history.json"
        if writer:
            hist_path.write_text(json.dumps(self.history, indent=2))
            self._print(f"Training history saved to: {hist_path}")
        distributed.barrier()
        return self.history

    # ------------------------------------------------------------------
    def load_stage_weights(self, stage: int, path) -> None:
        """Load one stage's weights from a reference ``.pth`` or a msgpack
        directory (strict, the decoder's keys dropped)."""
        sd = read_checkpoint(path)["model_state_dict"]
        self._model(stage).load_state_dict(classifier_state_dict(sd, stage), strict=True)
        distributed.broadcast_module(self._model(stage))
        self._epochs.clear()
        self._print(f"Loaded weights for stage {stage} from {path}")

    def _find_resume_point(self, save_path: Path):
        """The latest ``herlev_stage{S}_last`` -> (stage, its container),
        or (None, None); loads earlier stages' weights (the frozen
        uncertainty sources), ``_best`` before ``_last``."""
        stages = sorted(self.config["stages"])
        for stage in reversed(stages):
            last = find_checkpoint(save_path, f"herlev_stage{stage}_last")
            if last is not None:
                break
        else:
            return None, None
        meta = read_checkpoint(last)
        for s in (s for s in stages if s < stage):
            for suffix in ("best", "last"):
                ckpt = find_checkpoint(save_path, f"herlev_stage{s}_{suffix}")
                if ckpt is not None:
                    self.load_stage_weights(s, ckpt)
                    break
        return stage, meta

    def _restore_last(self, stage: int, meta: Mapping) -> None:
        """Weights, optimizer, scheduler, history and generator state from
        the stage's ``_last`` (``meta``), for a mid-stage resume."""
        sd = classifier_state_dict(meta["model_state_dict"], stage)
        model = self._model(stage)
        model.load_state_dict(sd, strict=True)
        distributed.broadcast_module(model)
        if meta.get("optimizer_state_dict") is not None:
            load_optimizer_state(self.optimizer, meta["optimizer_state_dict"],
                                 param_names(self.optimizer, model), meta.get("lr"))
        self._epochs.clear()  # a graph would read the replaced optimizer state
        sched = meta.get("scheduler") or {}
        if sched:
            self._scheduler.best = float(sched.get("best", float("inf")))
            self._scheduler.num_bad_epochs = int(sched.get("num_bad_epochs", 0))
        if isinstance(meta.get("history"), dict):
            for k, v in meta["history"].items():
                if k in self.history and isinstance(v, list):
                    self.history[k] = list(v)
        if meta.get("generator_state") is not None:  # a list in a directory's metadata
            self.generator.set_state(torch.as_tensor(meta["generator_state"], dtype=torch.uint8))
