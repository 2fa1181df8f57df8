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
one-vs-rest), dumped as ``evaluation_results.json`` with the plots
``confusion_matrix.png`` and ``class_metrics.png``.  The plots
(``plot_*``) are the JAX evaluator's, drawn with matplotlib where it is
installed (imported inside each function, the Agg backend); without it
they draw nothing and return None, as the JAX package's do.
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
            self.plot_confusion_matrix(cm, out / "confusion_matrix.png")
            self.plot_class_metrics(report, out / "class_metrics.png")
        return results

    # ------------------------------------------------------------------
    def plot_confusion_matrix(self, cm: np.ndarray, path):
        """Confusion heatmap with counts -> ``path``; None without matplotlib."""
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            return None
        fig, ax = plt.subplots(figsize=(8, 7))
        im = ax.imshow(cm, cmap="Blues")
        ax.set_xticks(range(len(self.class_names)))
        ax.set_yticks(range(len(self.class_names)))
        ax.set_xticklabels(self.class_names, rotation=45, ha="right")
        ax.set_yticklabels(self.class_names)
        for i in range(cm.shape[0]):
            for j in range(cm.shape[1]):
                ax.text(j, i, str(cm[i, j]), ha="center", va="center",
                        color="white" if cm[i, j] > cm.max() / 2 else "black")
        ax.set_xlabel("Predicted")
        ax.set_ylabel("True")
        ax.set_title("Confusion Matrix")
        fig.colorbar(im)
        fig.tight_layout()
        fig.savefig(path, dpi=120)
        plt.close(fig)
        return path

    def plot_class_metrics(self, report: dict, path):
        """Per-class precision, recall and F1 bars beside the support bars
        -> ``path``; None without matplotlib."""
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            return None
        names = [n for n in self.class_names if n in report]
        precision = [report[n]["precision"] for n in names]
        recall = [report[n]["recall"] for n in names]
        f1 = [report[n]["f1-score"] for n in names]
        support = [report[n]["support"] for n in names]
        x = np.arange(len(names))
        fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(15, 5))
        width = 0.27
        ax1.bar(x - width, precision, width, label="Precision")
        ax1.bar(x, recall, width, label="Recall")
        ax1.bar(x + width, f1, width, label="F1")
        ax1.set_xticks(x)
        ax1.set_xticklabels(names, rotation=45, ha="right")
        ax1.set_ylim(0, 1.05)
        ax1.legend()
        ax1.set_title("Per-class metrics")
        ax2.bar(x, support, color="tab:gray")
        ax2.set_xticks(x)
        ax2.set_xticklabels(names, rotation=45, ha="right")
        ax2.set_title("Class distribution (support)")
        fig.tight_layout()
        fig.savefig(path, dpi=120)
        plt.close(fig)
        return path

    def plot_sample_predictions(self, dataset, path, num_samples: int = 16, seed: int = 42):
        """Grid of ``num_samples`` predictions drawn with ``seed``, titles
        green where right and red where wrong -> ``path``; each image is one
        ``predict_probs`` call.  None without matplotlib."""
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            return None
        rng = np.random.default_rng(seed)
        idxs = rng.choice(len(dataset), size=min(num_samples, len(dataset)), replace=False)
        cols = 4
        rows = (len(idxs) + cols - 1) // cols
        fig, axes = plt.subplots(rows, cols, figsize=(3.2 * cols, 3.2 * rows))
        axes = np.atleast_2d(axes)
        for ax in axes.ravel():
            ax.axis("off")
        for ax, idx in zip(axes.ravel(), idxs):
            img, label = dataset[idx]
            probs = self.predict_probs(img[None])[0]
            pred = int(probs.argmax())
            ok = pred == label
            ax.imshow(img)
            ax.set_title(f"P: {self.class_names[pred]}\nT: {self.class_names[label]}",
                         color="green" if ok else "red", fontsize=8)
            ax.axis("off")
        fig.tight_layout()
        fig.savefig(path, dpi=110)
        plt.close(fig)
        return path
