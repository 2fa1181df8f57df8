"""Import a reference PyTorch ``.pth`` as the JAX package's checkpoint
directory (counterpart of ``ugpg_tpu/cli/import_torch.py``).

    python -m ugpg_tpu_torch.cli.import_torch --pth ug_pgunet_stage4_best.pth \\
        --out imported/stage4 [--stage 4] [--task segmentation] [--classes 1]

The stage is taken from the checkpoint's container when it has one (a
bare state dict is stage 4, as the reference's loader assumes).  The
directory (``variables.msgpack``, ``metadata.json``) loads in the JAX
package and in the port.  The conversion runs on the host; the stage's
model is built on the ``meta`` device for its key names and shapes only.
``main`` returns the stage, as the JAX command's does; ``cli`` exits 0
after an import (the JAX package's console script points at ``main``, so
it exits with the stage's number after a successful import).
"""

from __future__ import annotations

import argparse
import sys


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Import a torch .pth checkpoint (PyTorch/CUDA port)")
    p.add_argument("--pth", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--stage", type=int, default=None)
    p.add_argument("--task", choices=["segmentation", "classification"],
                   default="segmentation")
    p.add_argument("--classes", type=int, default=None)
    return p


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)

    from ugpg_tpu_torch.io.torch_import import import_torch_checkpoint

    num_classes = args.classes or (1 if args.task == "segmentation" else 7)
    _, stage = import_torch_checkpoint(args.pth, stage=args.stage, num_classes=num_classes,
                                       task_type=args.task, output_dir=args.out)
    return stage


def cli(argv=None) -> int:
    """Console entry: 0 after an import (errors raise)."""
    main(argv)
    return 0


if __name__ == "__main__":
    sys.exit(cli())
