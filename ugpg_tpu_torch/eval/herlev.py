"""Herlev classification evaluation (counterpart of ``ugpg_tpu/eval/herlev.py``).

``HerlevEvaluator`` reads a classifier ``.pth`` or msgpack or orbax checkpoint
directory (``io/checkpoint.py``; its stage from the
container, the class count and the binary flag from its ``config``) and
builds the stage's classifier as ``Predictor`` does: BN folded, the
encoder on the double-conv kernels.  One forward: resize (bilinear,
align_corners) to the stage resolution -> ImageNet normalisation ->
classifier -> softmax; this order is the JAX evaluator's (training
normalises before it resizes).  Single-image prediction, batched dataset
evaluation and the metric suite (accuracy, the per-class report,
confusion matrix, per-class accuracy, ROC-AUC binary or macro
one-vs-rest), dumped as ``evaluation_results.json``.  The port draws no
plots: ``plot_*`` return None, as the JAX package's do without
matplotlib.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from ugpg_tpu_torch.data.augment import imagenet_normalize
from ugpg_tpu_torch.data.herlev import CLASS_NAMES
from ugpg_tpu_torch.data.monuseg import load_rgb, resize_image
from ugpg_tpu_torch.device import resolve_device
from ugpg_tpu_torch.eval.serving import classifier_model
from ugpg_tpu_torch.io.checkpoint import container_stage, read_checkpoint
from ugpg_tpu_torch.metrics.classification import (
    classification_report,
    confusion_matrix,
    macro_roc_auc_ovr,
    per_class_accuracy,
    roc_auc,
)
from ugpg_tpu_torch.models.classifier import CLS_STAGE_RESOLUTIONS
from ugpg_tpu_torch.ops.resize import resize_bilinear_align_corners

__all__ = ["HerlevEvaluator"]


class HerlevEvaluator:
    """Evaluate a trained Herlev classifier."""

    def __init__(self, model_path: str, dtype: torch.dtype | None = None,
                 device: str | torch.device | None = None):
        """``dtype``: None (float32) or bfloat16 compute.  ``device``:
        ``cuda`` unless given; raises without CUDA."""
        self.device = resolve_device(device)
        self.model_path = model_path
        obj = read_checkpoint(model_path)
        self.stage = container_stage(obj)
        self.config = obj.get("config", {}) or {}
        self.num_classes = int(self.config.get("num_classes", 7))
        self.binary = bool(self.config.get("binary_classification", False))
        self.resolution = CLS_STAGE_RESOLUTIONS[self.stage]
        self.class_names = (["normal", "abnormal"] if self.binary or self.num_classes == 2
                            else list(CLASS_NAMES))
        self.model = classifier_model(self.stage, obj["model_state_dict"], self.device,
                                      self.num_classes, dtype or torch.float32)
        print(f"Loaded stage-{self.stage} Herlev model ({self.num_classes} classes)")

    @torch.inference_mode()
    def _forward(self, images: np.ndarray) -> torch.Tensor:
        x = torch.from_numpy(np.ascontiguousarray(images, dtype=np.float32)).to(self.device)
        x = resize_bilinear_align_corners(x.permute(0, 3, 1, 2), (self.resolution,) * 2)
        return torch.softmax(self.model(imagenet_normalize(x)).float(), dim=-1)

    # ------------------------------------------------------------------
    def predict_single(self, image_path: str):
        """(predicted class index, class name, probabilities) of one image
        file, resized to the stage resolution on the host first."""
        img = resize_image(load_rgb(image_path), self.resolution)
        probs = self.predict_probs(img[None].astype(np.float32) / 255.0)[0]
        pred = int(np.argmax(probs))
        return pred, self.class_names[pred], probs

    def predict_probs(self, images: np.ndarray) -> np.ndarray:
        """NHWC images in [0, 1], any size -> softmax probabilities (N, K)."""
        return self._forward(images).cpu().numpy()

    # ------------------------------------------------------------------
    def evaluate_dataset(self, dataset, batch_size: int = 16,
                         output_dir: str | None = None) -> dict:
        n = len(dataset)
        all_probs = []
        all_labels = []
        for start in range(0, n, batch_size):
            imgs, labels = zip(*(dataset[i] for i in range(start, min(start + batch_size, n))))
            all_probs.append(self.predict_probs(np.stack(imgs)))
            all_labels.extend(labels)
        probs = np.concatenate(all_probs)
        y_true = np.asarray(all_labels)
        y_pred = probs.argmax(axis=1)

        report = classification_report(y_true, y_pred, self.num_classes, self.class_names)
        cm = confusion_matrix(y_true, y_pred, self.num_classes)
        pca = per_class_accuracy(y_true, y_pred, self.num_classes)
        if self.num_classes == 2:
            auc = roc_auc(y_true, probs[:, 1])
        else:
            auc = macro_roc_auc_ovr(y_true, probs)
        results = {
            "accuracy": report["accuracy"],
            "classification_report": report,
            "confusion_matrix": cm.tolist(),
            "per_class_accuracy": {self.class_names[i]: float(a) for i, a in enumerate(pca)},
            "roc_auc": auc,
            "num_samples": int(n),
            "stage": self.stage,
        }
        if output_dir:
            out = Path(output_dir)
            out.mkdir(parents=True, exist_ok=True)
            (out / "evaluation_results.json").write_text(json.dumps(results, indent=2))
        return results

    # ------------------------------------------------------------------
    def plot_confusion_matrix(self, cm: np.ndarray, path):
        """None: the port draws no plots."""
        return None

    def plot_class_metrics(self, report: dict, path):
        """None: the port draws no plots."""
        return None

    def plot_sample_predictions(self, dataset, path, num_samples: int = 16, seed: int = 42):
        """None: the port draws no plots."""
        return None
