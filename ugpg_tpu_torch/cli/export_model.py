"""Export a checkpoint as a serving artifact (counterpart of
``ugpg_tpu/cli/export_model.py``).

    python -m ugpg_tpu_torch.cli.export_model --model OUT/ug_pgunet_stage4_best.pth \\
        --out exported/stage4 [--buckets 1 8 64] [--task segmentation] \\
        [--classes 1] [--uint8] [--compact] [--quantize --calibration CAL.npy] \\
        [--device cpu]

The artifact directory (one ``torch.export`` program per batch bucket,
``bucket_{b}.pt2``, weights inside, and ``manifest.json``) serves without
model code or checkpoint through
``ugpg_tpu_torch.eval.exported.ExportedPredictor``, on the CPU or the GPU
(``--platforms cpu cuda``): its kernels are the ``torch.ops.ugpg_torch``
operators, which run the hand-written kernels on the GPU and the plain
versions on the CPU.  The JAX package writes StableHLO instead.  The
checkpoint is exported in its own float32, or with ``--quantize`` as the
W8A8 int8 graph (``ops/quant.py``), its activation scales calibrated on the
images of ``--calibration`` (a (N, H, W, 3) float ``.npy`` from the real
input distribution; ``--quantize`` without it exits with status 2).
``--platforms tpu`` is not ported: given, it exits with status 2.
"""

from __future__ import annotations

import argparse
import sys


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Export a checkpoint as a torch.export serving "
                                            "artifact (PyTorch/CUDA)")
    p.add_argument("--model", required=True, help="checkpoint (.pth or a JAX checkpoint "
                                             "directory)")
    p.add_argument("--out", required=True, help="artifact output directory")
    p.add_argument("--buckets", type=int, nargs="+", default=[1, 8, 64])
    p.add_argument("--task", choices=["segmentation", "classification"], default="segmentation")
    p.add_argument("--classes", type=int, default=None)
    p.add_argument("--uint8", action="store_true",
                   help="serve raw uint8 RGB requests (divided by 255 on the device)")
    p.add_argument("--compact", action="store_true",
                   help="uint8 preds and float16 maps (2.4x fewer bytes)")
    p.add_argument("--quantize", action="store_true",
                   help="export the W8A8 int8 graph (requires --calibration)")
    p.add_argument("--calibration", type=str, default=None, metavar="NPY",
                   help=".npy of (N, H, W, 3) float images from the real input distribution: "
                        "activation calibration for --quantize")
    p.add_argument("--platforms", nargs="+", default=["cpu", "cuda"],
                   help="devices the artifact is for (cpu, cuda)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to export on (default cuda; cpu traces the plain path)")
    return p


def main(argv=None):
    parser = build_argparser()
    args = parser.parse_args(argv)
    if args.quantize and args.calibration is None:
        parser.error("--quantize requires --calibration NPY (no silent random calibration)")
    if "tpu" in args.platforms:
        parser.error("not ported: --platforms tpu (the port's artifacts serve on cpu and cuda)")
    bad = [p for p in args.platforms if p not in ("cpu", "cuda")]
    if bad:
        parser.error(f"--platforms {bad}: choose from cpu and cuda")

    import numpy as np

    from ugpg_tpu_torch.eval.serving import Predictor

    num_classes = args.classes or (1 if args.task == "segmentation" else 7)
    calibration_batches = [np.load(args.calibration)] if args.quantize else None
    predictor = Predictor(
        args.model,
        task_type=args.task,
        num_classes=num_classes,
        buckets=tuple(args.buckets),
        input_dtype=np.uint8 if args.uint8 else np.float32,
        compact_output=args.compact,
        quantize=args.quantize,
        calibration_batches=calibration_batches,
        dtype=None,  # the checkpoint's float32
        device=args.device,
    )
    path = predictor.export(args.out, platforms=tuple(args.platforms))
    print(f"exported stage-{predictor.stage} {args.task} artifact to {path} "
          f"(buckets {predictor.buckets}, platforms {args.platforms})")
    return path


def cli(argv=None) -> int:
    """Console entry: 0 after an export (errors raise)."""
    main(argv)
    return 0


if __name__ == "__main__":
    sys.exit(cli())
