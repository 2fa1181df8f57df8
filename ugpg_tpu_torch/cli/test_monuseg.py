"""MoNuSeg evaluation and inference command line (counterpart of
``ugpg_tpu/cli/test_monuseg.py``).

    python -m ugpg_tpu_torch.cli.test_monuseg --model OUT/ug_pgunet_stage4_best.pth \\
        --data DIR --eval_full [--native_res [--mesh H[,W]]] [--save_uncertainty] \\
        [--infer_dir DIR]

Takes the JAX command's flags, plus ``--device`` (default ``cuda``; ``cpu``
runs the plain PyTorch path).  ``--mesh H[,W]`` shards ``--native_res``
spatially: H-way over the mesh's ``data`` axis and, with W > 1, W-way over
``model`` ('auto': every visible card H-way); on ``--device cpu`` the mesh
repeats the CPU, on ``cuda`` it takes the visible cards and a mesh larger
than they are exits 2.  As in the JAX command, it does nothing without
``--native_res``, and under a coordinator each process evaluates alone on
its own mesh.  PNGs are written by the port's own writer (``io/png.py``).
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def _is_dataset(path: str) -> bool:
    return any(os.path.isdir(os.path.join(path, split)) for split in ("val", "train"))


def resolve_dataset_path(data_arg: str | None) -> str | None:
    """The MoNuSeg root: ``data_arg`` when given (``ValueError`` if it holds
    neither ``val/`` nor ``train/``), else the first of the usual places
    that does, else None."""
    if data_arg is not None:
        if not _is_dataset(data_arg):
            raise ValueError(f"--data {data_arg}: no val/ or train/ directory there")
        return data_arg
    for cand in ("./data/MoNuSeg", "./MoNuSeg", os.path.expanduser("~/data/MoNuSeg")):
        if _is_dataset(cand):
            return cand
    return None


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Evaluate / run inference with a trained "
                                "UG-PG-UNet on MoNuSeg (PyTorch/CUDA)")
    p.add_argument("--model", required=True, help="checkpoint (.pth or a JAX checkpoint "
                                             "directory)")
    p.add_argument("--data", type=str, default=None, help="MoNuSeg root")
    p.add_argument("--split", type=str, default="val")
    p.add_argument("--num_images", type=int, default=3, help="random images to visualize")
    p.add_argument("--infer", type=str, default=None, help="single image path")
    p.add_argument("--infer_dir", type=str, default=None, help="directory of images")
    p.add_argument("--eval_full", action="store_true",
                   help="run full-dataset evaluation and dump JSON")
    p.add_argument("--save_uncertainty", action="store_true",
                   help="also write uncertainty_{idx}.png maps for the visualized images")
    p.add_argument("--native_res", action="store_true",
                   help="with --eval_full: evaluate at native slide resolution (padded "
                        "full-resolution forward, no downsizing to the stage resolution)")
    p.add_argument("--mesh", type=str, default=None, metavar="H[,W]",
                   help="spatial shard grid for --native_res: H-way over 'data' (and W-way "
                        "over 'model'), e.g. '4' or '4,2'; 'auto' = all devices H-way")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default cuda; cpu runs the plain PyTorch path)")
    p.add_argument("--output_dir", type=str, default="./test_results")
    return p


def main(argv=None):
    parser = build_argparser()
    args = parser.parse_args(argv)
    try:
        data_dir = resolve_dataset_path(args.data)
    except ValueError as e:
        parser.error(str(e))
    mesh = None
    if args.eval_full and args.native_res and args.mesh:
        from ugpg_tpu_torch.cli import parse_mesh

        try:
            # under a coordinator each process evaluates on its own mesh: the
            # JAX command never joins the processes (ugpg_tpu/cli/test_monuseg.py:111-121)
            mesh = parse_mesh(args.mesh, args.device, join=False)
        except (NotImplementedError, ValueError) as e:
            parser.error(f"--mesh {args.mesh}: {e}")

    from ugpg_tpu_torch.data.monuseg import MoNuSegDataset
    from ugpg_tpu_torch.eval.monuseg import MoNuSegEvaluator, MoNuSegInferer
    from ugpg_tpu_torch.io.png import write_png

    results = {}
    if args.infer or args.infer_dir:
        inferer = MoNuSegInferer(args.model, device=args.device)
        if args.infer:
            inferer.infer_image(args.infer, args.output_dir)
        if args.infer_dir:
            results["inference"] = inferer.infer_directory(args.infer_dir, args.output_dir)
        if not (args.data or args.eval_full):
            return results

    evaluator = MoNuSegEvaluator(args.model, device=args.device)
    if data_dir is None:
        print("No dataset found; nothing to evaluate (use --data or --infer/--infer_dir)")
        return results

    dataset = MoNuSegDataset(data_dir, image_size=evaluator.resolution, split=args.split,
                             augment=False)
    if args.num_images:
        results["visualizations"] = evaluator.test_random_images(
            dataset, num_images=args.num_images, output_dir=args.output_dir)
        if args.save_uncertainty:
            os.makedirs(args.output_dir, exist_ok=True)
            rng = np.random.default_rng(42)
            idxs = rng.choice(len(dataset), size=min(args.num_images, len(dataset)),
                              replace=False)
            for idx in idxs:
                image, _ = dataset[int(idx)]
                _, _, unc = evaluator.predict_image(image, return_uncertainty=True)
                heat = (np.clip(unc, 0, 1) * 255).astype("uint8")
                write_png(os.path.join(args.output_dir, f"uncertainty_{idx}.png"), heat)
    if args.eval_full:
        if args.native_res:
            w_axis = "model" if mesh is not None and mesh.shape["model"] > 1 else None
            results["metrics"] = evaluator.evaluate_dataset_native(
                dataset, mesh=mesh, w_axis=w_axis,
                output_file=os.path.join(args.output_dir, "evaluation_results_native.json"))
        else:
            results["metrics"] = evaluator.evaluate_dataset(
                dataset, output_file=os.path.join(args.output_dir, "evaluation_results.json"))
        print("Evaluation:", {k: round(v, 4) for k, v in results["metrics"].items()
                              if isinstance(v, float)})
    return results


def cli(argv=None) -> int:
    main(argv)
    return 0


if __name__ == "__main__":
    main()
