#!/usr/bin/env python3
"""Per-step training images/s of the port's segmentation trainer on one
NVIDIA GPU, in the configuration of ``chip_smoke.py``'s phase 7: full
width, float32 with TF32 on, batch 8, the fused loss, the trainer's default
augmentation, synthetic disks at 256 px (resized to each stage's
resolution by the step), stages 1-4, each over the previous stage's
weights as its frozen source.  The optimizer is the one the trainer builds
(``--optimizer default``) or torch's capturable RMSprop with its learning
rate as a device tensor (``--optimizer capturable``: the variant a
``scan_epochs`` trainer takes on a card, put in the trainer's place here,
so that a commit without it can be measured the same way).

    python3 tools/torch_train_step_cost.py [--root DIR] [--optimizer default|capturable]
                                          [--steps 16] [--epochs 4]

``--root``: the checkout whose ``ugpg_tpu_torch`` is imported (default:
this one), so that two commits compare on one card; run them in turns
(parent, change, change, parent).  Every epoch is timed from a
synchronise to the epoch's metrics on the host.  Prints the card's name
and power limit, then one JSON line: per stage the images/s of every
epoch and the median of all but the first.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch


def _capturable_rmsprop(params, lr, weight_decay=0.0, **_):
    params = list(params)
    return torch.optim.RMSprop(params, lr=torch.tensor(float(lr), device=params[0].device),
                               alpha=0.99, eps=1e-8, weight_decay=weight_decay, momentum=0,
                               centered=False, capturable=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--optimizer", choices=("default", "capturable"), default="default")
    ap.add_argument("--steps", type=int, default=16, help="train steps an epoch")
    ap.add_argument("--epochs", type=int, default=4)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("torch_train_step_cost: CUDA is not available; this script needs an NVIDIA GPU")
    sys.path.insert(0, str(Path(args.root).resolve()))
    from ugpg_tpu_torch.data.synthetic import ArrayLoader, disk_dataset
    from ugpg_tpu_torch.train import seg_trainer

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    if args.optimizer == "capturable":
        seg_trainer.torch_rmsprop = _capturable_rmsprop
    batch = 8
    images, masks = disk_dataset(args.steps * batch, 256, seed=0)
    loader = ArrayLoader(images, masks, batch_size=batch, shuffle=True, seed=0)
    cfgs = {s: {**c, "epochs_per_stage": args.epochs}
            for s, c in seg_trainer.DEFAULT_STAGE_CONFIGS.items()}
    tr = seg_trainer.UncertaintyGuidedProgressiveTrainer(fused_loss=True, width=1.0,
                                                         stage_configs=cfgs, verbose=False)
    out = {"root": args.root, "optimizer": args.optimizer, "steps": args.steps, "stages": {}}
    for stage in (1, 2, 3, 4):
        if stage > 1:
            tr.transfer_weights(stage - 1, stage)
        tr.current_stage = stage
        opt = tr.setup_optimizer(stage)
        assert isinstance(opt.param_groups[0]["lr"], torch.Tensor) == (
            args.optimizer == "capturable")
        ips = []
        for _ in range(args.epochs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr.train_epoch(loader, stage)  # ends by reading the epoch's metrics back
            ips.append(args.steps * batch / (time.perf_counter() - t0))
        out["stages"][stage] = {"images_per_s": ips, "median": statistics.median(ips[1:])}
    out["card"] = card
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
