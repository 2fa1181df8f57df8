"""Herlev classification training command line (counterpart of
``ugpg_tpu/cli/train_herlev.py``).

    python -m ugpg_tpu_torch.cli.train_herlev --data_dir DIR --output_dir OUT

Takes the JAX command's flags, plus ``--device`` (default ``cuda``; ``cpu``
runs the plain PyTorch path).  One dataset per stage at that stage's
resolution, the train loader shuffled with seed 42 + stage; class weights
from the stage-1 training split.  Checkpoints are reference-format
``.pth`` files (``--checkpoint_backend pth``, the port's default) or the
JAX package's directories (``--checkpoint_backend msgpack``, the JAX
command's default, ``orbax`` or ``orbax-async``); ``--resume`` reads any.  ``--tb_logdir DIR``,
``--remat`` and ``--pipeline_unc N`` as in ``train_monuseg`` (one card and
N = 1 exits 2 with the JAX package's message); with ``--pipeline_unc`` the
train loaders drop the ragged final batch, as the JAX command's do.
``--mesh DATA[,MODEL]`` trains data-parallel (and column-parallel) over a
mesh, as ``train_monuseg``'s does, across processes under a coordinator.
``--scan_epochs`` and ``--scan_chunk_mb`` (default 1024, 0 = unbounded) as
in ``train_monuseg``.

SIGTERM stops the run at the end of the current epoch with a
``herlev_stage{S}_last`` written, and ``cli`` exits 75 (EX_TEMPFAIL);
rerun with ``--resume`` to continue.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

EX_TEMPFAIL = 75


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Train Progressive U-Net for Herlev cervical-cell classification "
                    "(PyTorch/CUDA)")
    p.add_argument("--stages", nargs="+", type=int, default=[1, 2, 3, 4])
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--binary", action="store_true",
                   help="binary normal/abnormal classification")
    p.add_argument("--uncertainty_alpha", type=float, default=1.0)
    p.add_argument("--data_dir", type=str, required=False)
    p.add_argument("--output_dir", type=str, default="./herlev_outputs")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute over float32 parameters")
    p.add_argument("--accum_steps", type=int, default=1, metavar="K",
                   help="gradient accumulation: each batch (size K*m) as K "
                        "micro-batches with one optimizer update")
    p.add_argument("--resume", action="store_true",
                   help="resume mid-stage from the herlev_stage{S}_last (.pth or "
                        "directory) a preempted run wrote in output_dir")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default cuda; cpu runs the plain PyTorch path)")
    p.add_argument("--checkpoint_backend", default="pth",
                   choices=["pth", "msgpack", "orbax", "orbax-async"],
                   help="checkpoint format: pth (default; the reference's files), or the JAX "
                        "package's directories: msgpack (the JAX command's default), orbax "
                        "or orbax-async")
    p.add_argument("--tb_logdir", type=str, default=None,
                   help="write per-epoch TensorBoard scalars to this directory")
    p.add_argument("--remat", action="store_true",
                   help="recompute each encoder DoubleConv in the backward: less peak "
                        "memory, the same gradients")
    p.add_argument("--pipeline_unc", type=int, default=0, metavar="N",
                   help="run the frozen previous stage's uncertainty forward on the last N "
                        "devices, ahead of the train step (stages > 1); the train loaders "
                        "drop the ragged final batch")
    p.add_argument("--mesh", type=str, default=None, metavar="DATA,MODEL",
                   help="shard over a (data, model) device mesh (e.g. '4,2'; 'auto' = all "
                        "devices data-parallel)")
    p.add_argument("--scan_epochs", action="store_true",
                   help="run each epoch as whole chunks, stacked and moved to the device once, "
                        "the steps replayed from a CUDA graph on one card (eagerly elsewhere); "
                        "the same trajectory as the per-step path")
    p.add_argument("--scan_chunk_mb", type=int, default=1024,
                   help="cap (MiB) on a stacked chunk under --scan_epochs; a larger epoch runs "
                        "as several chunks (0 = unbounded)")
    return p


def main(argv=None):
    parser = build_argparser()
    args = parser.parse_args(argv)

    import torch

    from ugpg_tpu_torch.cli import parse_mesh
    from ugpg_tpu_torch.data.herlev import HerlevDataset
    from ugpg_tpu_torch.data.loader import DataLoader
    from ugpg_tpu_torch.models.classifier import CLS_STAGE_RESOLUTIONS
    from ugpg_tpu_torch.parallel import distributed
    from ugpg_tpu_torch.train.cls_trainer import HerlevTrainer, create_config
    from ugpg_tpu_torch.utils.preemption import PreemptionGuard

    try:
        mesh = parse_mesh(args.mesh, args.device)
    except (NotImplementedError, ValueError) as e:
        parser.error(f"--mesh {args.mesh}: {e}")

    config = create_config()
    config.update(stages=args.stages, epochs_per_stage=args.epochs, batch_size=args.batch_size,
                  binary_classification=args.binary, uncertainty_alpha=args.uncertainty_alpha,
                  output_dir=args.output_dir, accum_steps=args.accum_steps,
                  tb_logdir=args.tb_logdir, remat=args.remat, pipeline_unc=args.pipeline_unc,
                  scan_epochs=args.scan_epochs,
                  scan_chunk_bytes=(args.scan_chunk_mb << 20) or None)
    if args.data_dir:
        config["data_dir"] = args.data_dir
    if config["binary_classification"]:
        config["num_classes"] = 2
    if not config["data_dir"]:
        raise SystemExit("--data_dir is required")

    print("=== Herlev Cervical Cell Classification Training ===")
    print(f"Classes: {config['num_classes']}  Stages: {config['stages']}  "
          f"Epochs/stage: {config['epochs_per_stage']}")

    train_loaders, val_loaders = {}, {}
    class_weights = None
    for stage in range(1, 5):
        size = CLS_STAGE_RESOLUTIONS[stage]
        tr_ds = HerlevDataset(config["data_dir"], image_size=size, split="train", augment=True,
                              binary_classification=config["binary_classification"],
                              target_split_ratio=config["split_ratios"], verbose=(stage == 1))
        va_ds = HerlevDataset(config["data_dir"], image_size=size, split="val", augment=False,
                              binary_classification=config["binary_classification"],
                              target_split_ratio=config["split_ratios"], verbose=False)
        # a pipelined epoch needs every batch to split into the micro-batches
        train_loaders[stage] = DataLoader(distributed.process_shard(tr_ds),
                                          batch_size=config["batch_size"], shuffle=True,
                                          num_workers=config["num_workers"], seed=42 + stage,
                                          drop_last=bool(args.pipeline_unc))
        val_loaders[stage] = DataLoader(distributed.process_shard(va_ds),
                                        batch_size=config["batch_size"],
                                        num_workers=config["num_workers"])
        if class_weights is None:
            class_weights = tr_ds.get_class_weights().tolist()
    if config.get("class_weights") is None:
        config["class_weights"] = class_weights
        print(f"Computed class weights: {[round(w, 3) for w in class_weights]}")

    try:
        trainer = HerlevTrainer(config, dtype=torch.bfloat16 if args.bf16 else None,
                                mesh=mesh, checkpoint_backend=args.checkpoint_backend,
                                device=args.device)
    except ValueError as e:  # e.g. --pipeline_unc leaving no train device, or beside --mesh
        parser.error(str(e))
    try:
        # SIGTERM -> herlev_stage{S}_last and an early return; cli()
        # then exits 75 so that a scheduler requeues
        with PreemptionGuard() as guard:
            trainer.train_progressive(train_loaders, val_loaders, config["output_dir"],
                                      preemption=guard, resume=args.resume)
        if distributed.is_writer():
            cfg_path = os.path.join(config["output_dir"], "config.json")
            with open(cfg_path, "w") as f:
                json.dump(config, f, indent=2, default=str)
            print(f"Configuration saved to: {cfg_path}")
    except KeyboardInterrupt:
        print("Training interrupted by user")
    return trainer


def cli(argv=None) -> int:
    """Console entry: 75 (EX_TEMPFAIL) when the run was preempted, else 0."""
    trainer = main(argv)
    return EX_TEMPFAIL if getattr(trainer, "preempted", False) else 0


if __name__ == "__main__":
    sys.exit(cli())
