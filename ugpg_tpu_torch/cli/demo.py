"""Runnable demos on synthetic data (counterpart of ``ugpg_tpu/cli/demo.py``).

    python -m ugpg_tpu_torch.cli.demo [--demo all] [--stages 2] [--epochs 2] \\
        [--save_dir ./demo_outputs] [--device cuda]

Three demos, no dataset needed:
1. uncertainty maps from a stage-1 model, with shape and range checks;
2. the loss's alpha sweep over {0, .5, 1, 2, 5};
3. a mini progressive training run on synthetic disks (``--stages``
   stages, ``--epochs`` each), checkpoints under ``--save_dir``.

Runs on ``--device`` (default ``cuda``; ``cpu`` runs the plain PyTorch
path).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


def demo_uncertainty_maps(device="cuda"):
    from ugpg_tpu_torch.models.pgunet import PGUNet1
    from ugpg_tpu_torch.uncertainty import generate_uncertainty_map

    print("=" * 60)
    print("Demo 1: uncertainty map generation")
    torch.manual_seed(0)
    model = PGUNet1(num_classes=1).to(device).eval()
    x = torch.from_numpy(np.random.default_rng(0).random((2, 3, 64, 64), dtype=np.float32))
    with torch.no_grad():
        amap = generate_uncertainty_map(model, x.to(device), 32, 64)
    print(f"  input {tuple(x.shape)} -> uncertainty {tuple(amap.shape)} (NCHW)")
    print(f"  range [{float(amap.min()):.4f}, {float(amap.max()):.4f}], "
          f"mean {float(amap.mean()):.4f}")
    assert tuple(amap.shape) == (2, 1, 64, 64)
    assert 0.0 <= float(amap.min()) and float(amap.max()) <= 1.0
    print("  OK: shape and [0,1] range verified")
    return amap


def demo_alpha_sweep(device="cuda"):
    from ugpg_tpu_torch.uncertainty import apply_uncertainty_weighted_loss

    print("=" * 60)
    print("Demo 2: alpha sweep (uncertainty weighting impact)")
    rng = np.random.default_rng(1)
    pixel_loss = torch.from_numpy(rng.random((2, 1, 32, 32), dtype=np.float32)).to(device)
    amap = torch.from_numpy(rng.random((2, 1, 32, 32), dtype=np.float32)).to(device)
    base = float(pixel_loss.mean())
    print(f"  {'alpha':>6} {'weighted':>10} {'increase':>9}")
    rows = []
    for alpha in (0.0, 0.5, 1.0, 2.0, 5.0):
        final, _ = apply_uncertainty_weighted_loss(pixel_loss, amap, alpha)
        inc = float(final) / base - 1.0
        print(f"  {alpha:>6.1f} {float(final):>10.4f} {inc:>8.1%}")
        rows.append((alpha, float(final)))
    assert all(b[1] >= a[1] for a, b in zip(rows, rows[1:]))
    print("  OK: loss grows monotonically with alpha")
    return rows


def demo_mini_progressive_train(epochs: int = 2, stages: int = 2, device="cuda",
                                save_dir: str = "./demo_outputs"):
    from ugpg_tpu_torch.data.synthetic import ArrayLoader, disk_dataset
    from ugpg_tpu_torch.train.seg_trainer import UncertaintyGuidedProgressiveTrainer

    print("=" * 60)
    print(f"Demo 3: mini progressive training ({stages} stages x {epochs} epochs)")
    images, masks = disk_dataset(num_samples=16, image_size=64, seed=2)
    train = ArrayLoader(images[:12], masks[:12], batch_size=4, shuffle=True)
    val = ArrayLoader(images[12:], masks[12:], batch_size=4)
    cfgs = {
        s: {"resolution": r, "epochs_per_stage": epochs, "lr": 3e-4 if s == 1 else 1e-4}
        for s, r in {1: 32, 2: 64, 3: 128, 4: 256}.items()
    }
    trainer = UncertaintyGuidedProgressiveTrainer(stage_configs=cfgs, verbose=False,
                                                  device=device)
    history = trainer.train_progressive(train, val, max_stages=stages, save_dir=save_dir)
    for i, (tl, td) in enumerate(zip(history["train_loss"], history["train_dice"])):
        print(f"  epoch {i}: loss {tl:.4f}, dice {td:.4f}")
    print("  OK: progressive training completed")
    return history


def main(argv=None):
    p = argparse.ArgumentParser(description="UG-PG-UNet demos (PyTorch/CUDA)")
    p.add_argument("--demo", choices=["uncertainty", "alpha", "train", "all"], default="all")
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--stages", type=int, default=2)
    p.add_argument("--save_dir", default="./demo_outputs",
                   help="where the training demo writes its checkpoints")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default cuda; cpu runs the plain PyTorch path)")
    args = p.parse_args(argv)

    from ugpg_tpu_torch.device import resolve_device

    device = resolve_device(args.device)
    if args.demo in ("uncertainty", "all"):
        demo_uncertainty_maps(device)
    if args.demo in ("alpha", "all"):
        demo_alpha_sweep(device)
    if args.demo in ("train", "all"):
        demo_mini_progressive_train(args.epochs, args.stages, device, args.save_dir)
    print("=" * 60)
    print("All demos completed.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
