"""MoNuSeg training command line (counterpart of ``ugpg_tpu/cli/train_monuseg.py``).

    python -m ugpg_tpu_torch.cli.train_monuseg --data_dir DIR --output_dir OUT

Takes the JAX command's flags, plus ``--device`` (default ``cuda``; ``cpu``
runs the plain PyTorch path), where the JAX package reads
``JAX_PLATFORMS``.  Checkpoints are reference-format ``.pth`` files
(``--checkpoint_backend pth``, the port's default) or the JAX package's
directories: msgpack (``--checkpoint_backend msgpack``, the JAX command's
default), ``orbax`` or ``orbax-async`` (``io/checkpoint.py``; the command
returns, and exits 75, only once the async saves have committed).  ``--tb_logdir DIR``
writes per-epoch TensorBoard scalars, ``--remat`` recomputes every
DoubleConv in the backward, ``--pipeline_unc N`` runs the frozen previous
stage on the last N devices (``parallel/pipeline.py``; on ``cuda`` the
visible cards, so one card and N = 1 exits 2 with the JAX package's
message; on ``cpu`` the CPU N + 1 times).  ``--mesh DATA[,MODEL]`` trains
data-parallel (and column-parallel) over a mesh
(``cli/__init__.py::parse_mesh``: on ``cuda`` the visible cards, on
``cpu`` the CPU as often as the mesh asks; under a coordinator,
``UGPG_COORDINATOR_ADDRESS`` with ``WORLD_SIZE`` and ``RANK`` or torchrun,
the processes join first and each trains its share of the data on its own
mesh: ``parallel/distributed.py``).  ``--native_finetune EPOCHS``
then fine-tunes the last requested stage at native resolution
(``--native_size``, default 1000 px), spatially sharded over the mesh (H
over ``data``; ``--native_w_axis``: W over ``model`` too), writing
``ug_pgunet_stage{S}_native``; it requires ``--mesh`` and is skipped
after an interrupt.  ``--scan_epochs`` runs every epoch as whole chunks of
at most ``--scan_chunk_mb`` MiB (default 1024, 0 = unbounded), stacked and
moved to the device once, the steps replayed from a CUDA graph on one card
and run eagerly on the CPU or a mesh (the trainer's ``scan_epochs``).
No flag is ignored.

``--resume`` loads every requested stage that has a ``_best`` and no
``_last``, and ``train_progressive`` continues mid-stage from the latest
``_last``, each a ``.pth`` or a directory whatever ``--checkpoint_backend``
says (so a JAX run's output directory resumes here).  SIGTERM stops the
run at the end of the current epoch with a ``_last`` written, and ``cli``
exits 75 (EX_TEMPFAIL), so that a scheduler requeues it with ``--resume``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

EX_TEMPFAIL = 75


def create_config() -> dict:
    return {
        "data_dir": "./data/MoNuSeg",
        "output_dir": "./monuseg_outputs",
        "stages": [1, 2, 3, 4],
        "epochs_per_stage": 50,
        "batch_size": 8,
        "lr": None,  # per-stage defaults (3e-4 / 1e-4)
        "uncertainty_alpha": 1.0,
        "num_workers": 4,
        "resume": False,
    }


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Train Uncertainty-Guided Progressive U-Net on MoNuSeg (PyTorch/CUDA)")
    p.add_argument("--data_dir", type=str, help="MoNuSeg dataset root")
    p.add_argument("--output_dir", type=str, help="output directory")
    p.add_argument("--stages", nargs="+", type=int, default=[1, 2, 3, 4])
    p.add_argument("--epochs", type=int, default=50, help="epochs per stage")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--uncertainty_alpha", type=float, default=1.0)
    p.add_argument("--resume", action="store_true",
                   help="resume from the stage checkpoints in output_dir "
                        "(mid-stage when _last checkpoints exist; .pth files or msgpack "
                        "directories)")
    p.add_argument("--checkpoint_every", type=int, default=5,
                   help="write a rolling _last checkpoint every N epochs")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute over float32 parameters")
    p.add_argument("--plain", action="store_true",
                   help="use the raw MoNuSegDataset instead of aug patches")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default cuda; cpu runs the plain PyTorch path)")
    p.add_argument("--checkpoint_backend", default="pth",
                   choices=["pth", "msgpack", "orbax", "orbax-async"],
                   help="checkpoint format: pth (default; the reference's files), or the JAX "
                        "package's directories: msgpack, orbax or orbax-async")
    p.add_argument("--accum_steps", type=int, default=1, metavar="K",
                   help="gradient accumulation: each batch (size K*m) as K "
                        "micro-batches with one optimizer update")
    p.add_argument("--aug_quantize", type=int, default=0, metavar="N",
                   help="quantize the augmentation rotation to N grid angles")
    p.add_argument("--tb_logdir", type=str, default=None,
                   help="write per-epoch TensorBoard scalars to this directory")
    p.add_argument("--remat", action="store_true",
                   help="recompute every DoubleConv in the backward instead of keeping its "
                        "activations: less peak memory, the same gradients")
    p.add_argument("--pipeline_unc", type=int, default=0, metavar="N",
                   help="run the frozen previous stage's uncertainty forward on the last N "
                        "devices, ahead of the train step (stages > 1)")
    p.add_argument("--mesh", type=str, default=None, metavar="DATA,MODEL",
                   help="shard over a (data, model) device mesh, e.g. '4,2' for 4-way data x "
                        "2-way column parallel; 'auto' = all devices data-parallel")
    p.add_argument("--native_finetune", type=int, default=0, metavar="EPOCHS",
                   help="after progressive training, fine-tune the last requested stage at "
                        "native slide resolution, spatially sharded over --mesh (H over "
                        "'data'; add --native_w_axis to shard W over 'model' too)")
    p.add_argument("--native_size", type=int, default=1000,
                   help="dataset resolution for the native fine-tune phase (default 1000 = "
                        "MoNuSeg full TIFF resolution)")
    p.add_argument("--native_w_axis", action="store_true",
                   help="2-D spatial grid for --native_finetune: W sharded over 'model'")
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
    config = create_config()
    for key, val in (("data_dir", args.data_dir), ("output_dir", args.output_dir),
                     ("lr", args.lr)):
        if val is not None:
            config[key] = val
    config.update(stages=args.stages, epochs_per_stage=args.epochs, batch_size=args.batch_size,
                  uncertainty_alpha=args.uncertainty_alpha, resume=args.resume)

    import torch

    from ugpg_tpu_torch.cli import parse_mesh
    from ugpg_tpu_torch.data.monuseg import MoNuSegDataset, create_train_val_split
    from ugpg_tpu_torch.io.checkpoint import find_checkpoint
    from ugpg_tpu_torch.parallel import distributed
    from ugpg_tpu_torch.train.aug_trainer import AugMoNuSegTrainer, compute_pos_weight
    from ugpg_tpu_torch.utils.preemption import PreemptionGuard

    try:
        mesh = parse_mesh(args.mesh, args.device)
    except (NotImplementedError, ValueError) as e:
        parser.error(f"--mesh {args.mesh}: {e}")
    try:
        trainer = AugMoNuSegTrainer(config, dtype=torch.bfloat16 if args.bf16 else None,
                                    accum_steps=args.accum_steps,
                                    aug_quantize=args.aug_quantize, tb_logdir=args.tb_logdir,
                                    remat=args.remat, pipeline_unc=args.pipeline_unc,
                                    scan_epochs=args.scan_epochs,
                                    scan_chunk_bytes=(args.scan_chunk_mb << 20) or None,
                                    checkpoint_backend=args.checkpoint_backend,
                                    mesh=mesh, device=args.device)
    except ValueError as e:  # e.g. --pipeline_unc leaving no train device, or beside --mesh
        parser.error(str(e))
    if args.plain:
        data_dir = config["data_dir"]
        if distributed.agree(not os.path.isdir(os.path.join(data_dir, "val"))):
            if distributed.is_writer():
                create_train_val_split(data_dir, val_ratio=0.2, seed=42)
            distributed.barrier()
        for stage in config["stages"]:
            res = trainer.stage_configs[stage]["resolution"]
            trainer.train_datasets[stage] = MoNuSegDataset(data_dir, image_size=res,
                                                           split="train", augment=True)
            trainer.val_datasets[stage] = MoNuSegDataset(data_dir, image_size=res,
                                                         split="val", augment=False)
        trainer.pos_weight = compute_pos_weight(trainer.train_datasets[config["stages"][0]])
        print(f"Auto-computed pos_weight: {trainer.pos_weight:.4f}")
    else:
        trainer.setup_datasets(config["data_dir"], stages=tuple(config["stages"]))
    train_loaders, val_loaders = trainer.make_loaders(batch_size=config["batch_size"],
                                                      num_workers=config["num_workers"])

    stages = list(config["stages"])
    if config["resume"]:
        # whole stages with a _best and no _last are done; a _last means
        # train_progressive continues that stage mid-way
        out = Path(config["output_dir"])
        for stage in list(stages):
            best = find_checkpoint(out, f"ug_pgunet_stage{stage}_best")
            last = find_checkpoint(out, f"ug_pgunet_stage{stage}_last")
            if best is not None and last is None:
                trainer.load_stage_weights(stage, best)
                stages.remove(stage)
                print(f"Resume: stage {stage} restored from {best}")
            else:
                break
        if not stages:
            print("Resume: all requested stages already trained")

    interrupted = False
    if stages:
        try:
            # SIGTERM -> _last checkpoint at the epoch's end and an early
            # return; cli() then exits 75 so that a scheduler requeues
            with PreemptionGuard() as guard:
                trainer.train_progressive(train_loaders, val_loaders,
                                          save_dir=config["output_dir"], stages=stages,
                                          checkpoint_every=args.checkpoint_every,
                                          resume=config["resume"], preemption=guard)
        except KeyboardInterrupt:
            interrupted = True
            print("Training interrupted by user")
        interrupted = interrupted or trainer.preempted

    if args.native_finetune and interrupted:
        print("Skipping --native_finetune after interrupt")
    if args.native_finetune and not interrupted:
        if trainer.mesh is None:
            raise SystemExit("--native_finetune requires --mesh")
        from ugpg_tpu_torch.data.loader import DataLoader

        stage = max(config["stages"])
        # whole slides, batch 1 a step: the spatial grid, not the batch,
        # gives the parallelism at native resolution
        ft_train = DataLoader(distributed.process_shard(MoNuSegDataset(
            config["data_dir"], image_size=args.native_size, split="train", augment=False)),
                              batch_size=1, shuffle=True, seed=0)
        ft_val = DataLoader(distributed.process_shard(MoNuSegDataset(
            config["data_dir"], image_size=args.native_size, split="val", augment=False)),
            batch_size=1)
        trainer.finetune_native(ft_train, stage=stage, epochs=args.native_finetune,
                                w_axis="model" if args.native_w_axis else None,
                                val_loader=ft_val, save_dir=config["output_dir"])

    if distributed.is_writer():
        cfg_path = Path(config["output_dir"]) / "config.json"
        cfg_path.parent.mkdir(parents=True, exist_ok=True)
        cfg_path.write_text(json.dumps(config, indent=2, default=str))
    return trainer


def cli(argv=None) -> int:
    """Console entry: 75 (EX_TEMPFAIL) when the run was preempted, else 0."""
    trainer = main(argv)
    return EX_TEMPFAIL if getattr(trainer, "preempted", False) else 0


if __name__ == "__main__":
    sys.exit(cli())
