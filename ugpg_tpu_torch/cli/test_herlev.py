"""Herlev classification evaluation command line (counterpart of
``ugpg_tpu/cli/test_herlev.py``).

    python -m ugpg_tpu_torch.cli.test_herlev --model OUT/herlev_stage4_best.pth \\
        --data_dir DIR [--predict IMAGE] [--device cpu]

Evaluates a split (``test`` by default) and writes
``evaluation_results.json`` to ``--output_dir``, with ``confusion_matrix.png``,
``class_metrics.png`` and a grid of ``--num_samples`` predictions,
``sample_predictions.png``, where matplotlib is installed; or classifies
one image with ``--predict``.  ``cli`` returns 0 after a run (the JAX command's
console script points at ``main``, which returns its results dict, so that
script exits 1 after a successful run).
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Evaluate a trained Herlev classification model (PyTorch/CUDA)")
    p.add_argument("--model", required=True, help="checkpoint (.pth or a JAX checkpoint "
                                             "directory)")
    p.add_argument("--data_dir", required=True, help="Herlev dataset root")
    p.add_argument("--split", default="test")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--output_dir", default="./herlev_test_results")
    p.add_argument("--num_samples", type=int, default=16,
                   help="sample-prediction grid size")
    p.add_argument("--predict", type=str, default=None,
                   help="classify a single image instead of a dataset")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default cuda; cpu runs the plain PyTorch path)")
    return p


def main(argv=None):
    args = build_argparser().parse_args(argv)

    from ugpg_tpu_torch.eval.herlev import HerlevEvaluator

    evaluator = HerlevEvaluator(args.model, device=args.device)
    if args.predict:
        pred, name, probs = evaluator.predict_single(args.predict)
        print(f"{args.predict}: {name} (class {pred}, p={probs[pred]:.4f})")
        return {"prediction": name, "probs": probs.tolist()}

    from ugpg_tpu_torch.data.herlev import HerlevDataset

    dataset = HerlevDataset(args.data_dir, image_size=evaluator.resolution, split=args.split,
                            augment=False, binary_classification=evaluator.binary,
                            verbose=False)
    results = evaluator.evaluate_dataset(dataset, batch_size=args.batch_size,
                                         output_dir=args.output_dir)
    evaluator.plot_sample_predictions(dataset,
                                      os.path.join(args.output_dir, "sample_predictions.png"),
                                      num_samples=args.num_samples)
    print(f"Accuracy: {results['accuracy']:.4f}  ROC-AUC: {results['roc_auc']:.4f}")
    print(json.dumps(results["classification_report"]["weighted avg"], indent=2))
    return results


def cli(argv=None) -> int:
    """Console entry: 0 after a run (errors raise)."""
    main(argv)
    return 0


if __name__ == "__main__":
    sys.exit(cli())
