"""Export a checkpoint as a reference-loadable PyTorch ``.pth``
(counterpart of ``ugpg_tpu/cli/export_torch.py``).

    python -m ugpg_tpu_torch.cli.export_torch --ckpt outputs/ug_pgunet_stage4_best \\
        --out ug_pgunet_stage4_best.pth [--stage 4] [--task segmentation] [--raw]

``--ckpt`` is a JAX checkpoint directory (msgpack, orbax or orbax-async) or
a ``.pth``.  The ``.pth`` written loads in the reference's evaluation
commands (strict ``load_state_dict``) and in the port's.  ``--raw`` writes
a bare state dict (the reference's segmentation loader then assumes stage
4).  The conversion runs on the host; no model is built.  Exits 0 after an
export.
"""

from __future__ import annotations

import argparse
import sys


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Export a torch .pth checkpoint (PyTorch/CUDA port)")
    p.add_argument("--ckpt", required=True,
                   help="checkpoint: a JAX checkpoint directory or a .pth")
    p.add_argument("--out", required=True, help="output .pth path")
    p.add_argument("--stage", type=int, default=None,
                   help="override the stage recorded in the checkpoint")
    p.add_argument("--task", choices=["segmentation", "classification"],
                   default="segmentation")
    p.add_argument("--raw", action="store_true",
                   help="save a bare state dict instead of a checkpoint dict")
    return p


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)

    from ugpg_tpu_torch.io.torch_export import export_torch_checkpoint

    export_torch_checkpoint(args.ckpt, args.out, task_type=args.task, stage=args.stage,
                            raw_state_dict=args.raw)
    return 0


def cli(argv=None) -> int:
    """Console entry: 0 after an export (errors raise)."""
    return main(argv)


if __name__ == "__main__":
    sys.exit(cli())
