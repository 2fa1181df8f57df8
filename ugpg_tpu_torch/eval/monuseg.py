"""MoNuSeg evaluation and inference (counterpart of ``ugpg_tpu/eval/monuseg.py``).

* ``MoNuSegEvaluator``: reads a ``.pth`` or a msgpack or orbax checkpoint directory
  (``io/checkpoint.py``; its stage from the container, a bare state dict
  is stage 4) and builds the stage's model as ``Predictor``
  does: BN folded, the kernels' weight layouts packed once.  One forward:
  resize to the stage resolution -> model -> sigmoid -> 0.5 threshold, and
  the uncertainty map from the logits (``uncertainty_from_logits``, the
  JAX package's ``binary_uncertainty(sigmoid(logits))``).  Single-image
  prediction (mask resized back by nearest, confidence = mean
  probability), the per-sample metric suite over a dataset with mean and
  std and a JSON dump, the native-resolution evaluation (the padded
  forward of ``eval/slide.py``, or under a mesh the spatially sharded one
  of ``parallel/spatial.py``, scored against the full-resolution mask),
  ground-truth-vs-prediction panels (with matplotlib) and a seeded random
  spot check.
* ``MoNuSegInferer``: single-image and directory inference writing
  ``*_mask.png`` and a red-overlay ``*_vis.png`` (``io/png.py``).

On the GPU each forward runs 9 double-conv, 4 upsample and 1 uncertainty
launches at stage 4.  Computes in float32 unless ``dtype`` says otherwise.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np
import torch

from ugpg_tpu_torch.data.monuseg import _IMG_EXTS, load_rgb
from ugpg_tpu_torch.device import resolve_device
from ugpg_tpu_torch.eval.serving import stage_model
from ugpg_tpu_torch.eval.slide import native_divisor, native_forward
from ugpg_tpu_torch.io.checkpoint import container_stage, read_checkpoint
from ugpg_tpu_torch.io.png import write_png
from ugpg_tpu_torch.metrics.segmentation import binary_eval_metrics
from ugpg_tpu_torch.models.pgunet import STAGE_RESOLUTIONS
from ugpg_tpu_torch.ops.cuda.library import uncertainty_from_logits
from ugpg_tpu_torch.ops.resize import resize_bilinear_align_corners, resize_nearest
from ugpg_tpu_torch.parallel.spatial import SpatialWeights, spatial_predict

__all__ = ["MoNuSegEvaluator", "MoNuSegInferer"]


def _summarise(per_sample: dict[str, list[float]]) -> dict:
    results = {}
    for k, vals in per_sample.items():
        arr = np.asarray(vals)
        results[f"{k}_mean"] = float(arr.mean())
        results[f"{k}_std"] = float(arr.std())
    return results


def _dump(results: dict, output_file: str | None, what: str) -> None:
    if output_file:
        Path(output_file).parent.mkdir(parents=True, exist_ok=True)
        with open(output_file, "w") as f:
            json.dump(results, f, indent=2)
        print(f"{what} saved to {output_file}")


class MoNuSegEvaluator:
    """Loads a checkpoint and evaluates or visualises segmentation quality.

    ``dtype``: compute dtype of the body (None = float32, as in the JAX
    package).  ``device``: ``cuda`` unless given; raises without CUDA."""

    def __init__(self, model_path: str, num_classes: int = 1,
                 dtype: torch.dtype | None = None, device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.model_path = model_path
        obj = read_checkpoint(model_path)
        self.stage = container_stage(obj)
        self.resolution = STAGE_RESOLUTIONS[self.stage]
        self.metadata = {k: v for k, v in obj.items()
                         if k not in ("model_state_dict", "optimizer_state_dict")}
        self._state_dict = obj["model_state_dict"]
        self.model = stage_model(self.stage, self._state_dict, self.device, num_classes,
                                 dtype or torch.float32)
        self._spatial: dict = {}  # (mesh, dtype) -> SpatialWeights
        print(f"Loaded stage-{self.stage} model from {model_path}")

    @torch.inference_mode()
    def _forward(self, images) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(B, H, W, 3) float images in [0, 1] -> NHWC (probs, preds,
        uncertainty) at the stage resolution, on the device."""
        x = torch.as_tensor(np.ascontiguousarray(images), dtype=torch.float32).to(self.device)
        res = self.resolution
        x = resize_bilinear_align_corners(x.permute(0, 3, 1, 2), (res, res))
        logits = self.model(x.contiguous(memory_format=torch.channels_last))
        probs = torch.sigmoid(logits)
        preds = (probs > 0.5).float()
        unc = uncertainty_from_logits(logits)
        return tuple(t.permute(0, 2, 3, 1) for t in (probs, preds, unc))

    # ------------------------------------------------------------------
    def predict_image(self, image: np.ndarray, return_uncertainty: bool = False):
        """image: (H, W, 3) uint8 or float in [0, 1].  -> (mask at the
        image's size, confidence), and the uncertainty map at the stage
        resolution when asked."""
        orig_h, orig_w = image.shape[:2]
        img = image.astype(np.float32)
        if img.max() > 1.5:
            img = img / 255.0
        probs, preds, unc = self._forward(img[None])
        mask = resize_nearest(preds.permute(0, 3, 1, 2), (orig_h, orig_w))[0, 0]
        confidence = float(probs.mean())
        mask = mask.cpu().numpy()
        if return_uncertainty:
            return mask, confidence, unc[0, ..., 0].cpu().numpy()
        return mask, confidence

    def predict_batch(self, images: np.ndarray):
        """(B, H, W, 3) -> numpy (probs, preds, uncertainty) at the stage
        resolution."""
        return tuple(t.cpu().numpy() for t in self._forward(images))

    # ------------------------------------------------------------------
    def evaluate_dataset(self, dataset, output_file: str | None = None, batch_size: int = 8,
                         max_samples: int | None = None) -> dict:
        """Per-sample IoU/Dice/accuracy/precision/recall/specificity at the
        stage resolution, their means and (population) stds."""
        n = len(dataset) if max_samples is None else min(len(dataset), max_samples)
        per_sample: dict[str, list[float]] = {}
        res = self.resolution
        for start in range(0, n, batch_size):
            imgs, masks = zip(*(dataset[i] for i in range(start, min(start + batch_size, n))))
            _, preds, _ = self._forward(np.stack(imgs))
            t = torch.from_numpy(np.stack(masks)).to(self.device).permute(0, 3, 1, 2)
            t = resize_nearest(t, (res, res))
            batch_m = binary_eval_metrics(preds[..., 0], t[:, 0])
            for k, v in batch_m.items():
                per_sample.setdefault(k, []).extend(v.cpu().tolist())
        results = _summarise(per_sample)
        results["num_samples"] = n
        results["stage"] = self.stage
        _dump(results, output_file, "Evaluation results")
        return results

    def evaluate_dataset_native(self, dataset, mesh=None, w_axis: str | None = None,
                                output_file: str | None = None,
                                max_samples: int | None = None, dtype=None) -> dict:
        """The metric suite at each image's own resolution, against the
        full-resolution mask: the padded forward of
        ``eval/slide.py::native_forward``.  ``dataset`` must have
        ``load_raw(idx) -> (uint8 HWC image, uint8 HW mask)``.

        Under a ``mesh`` the image is spatially sharded, H over ``data``
        and W over ``w_axis`` when given, with 1-px halo exchange
        (``parallel/spatial.py::spatial_predict(..., pad=True)``), the
        body in ``dtype`` (None: float32); without one ``dtype`` is not
        read and the evaluator's own model runs, as in the JAX package."""
        div = native_divisor(self.stage)
        if mesh is not None:
            key = (mesh, dtype)
            if key not in self._spatial:
                self._spatial[key] = SpatialWeights(self._state_dict, self.stage, mesh, dtype)
            weights = self._spatial[key]
        n = len(dataset) if max_samples is None else min(len(dataset), max_samples)
        per_sample: dict[str, list[float]] = {}
        for idx in range(n):
            img_u8, mask_u8 = dataset.load_raw(idx)
            x = torch.from_numpy(img_u8.astype(np.float32) / 255.0)[None]
            if mesh is None:
                preds = native_forward(self.model, x.to(self.device), (div, div))[0]
            else:
                preds = spatial_predict(weights, x, mesh, stage=self.stage, w_axis=w_axis,
                                        dtype=dtype, pad=True)[0]
            gt = torch.from_numpy(mask_u8.astype(np.float32))[None].to(preds.device)
            batch_m = binary_eval_metrics(preds[..., 0], gt)
            for k, v in batch_m.items():
                per_sample.setdefault(k, []).extend(v.cpu().tolist())
        results = _summarise(per_sample)
        results["num_samples"] = n
        results["stage"] = self.stage
        results["native_resolution"] = True
        _dump(results, output_file, "Native-resolution evaluation results")
        return results

    # ------------------------------------------------------------------
    def visualize_predictions(self, dataset, indices, output_dir: str) -> list[str]:
        """Ground truth and prediction overlays with each image's Dice and
        IoU, one PNG per index; [] without matplotlib."""
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            print("matplotlib unavailable; skipping visualization")
            return []

        out = Path(output_dir)
        out.mkdir(parents=True, exist_ok=True)
        written = []
        for idx in indices:
            image, gt = dataset[idx]
            pred_mask, _ = self.predict_image(image)
            gt2d = gt[..., 0]
            m = binary_eval_metrics(torch.from_numpy(pred_mask)[None],
                                    torch.from_numpy(gt2d)[None])
            dice, iou = float(m["dice"][0]), float(m["iou"][0])
            fig, axes = plt.subplots(1, 3, figsize=(14, 5))
            axes[0].imshow(image)
            axes[0].set_title("Image")
            axes[1].imshow(image)
            axes[1].imshow(gt2d, alpha=0.4, cmap="Greens")
            axes[1].set_title("Ground Truth")
            axes[2].imshow(image)
            axes[2].imshow(pred_mask, alpha=0.4, cmap="Reds")
            axes[2].set_title(f"Prediction (Dice {dice:.3f}, IoU {iou:.3f})")
            for ax in axes:
                ax.axis("off")
            path = out / f"prediction_{idx}.png"
            fig.savefig(path, dpi=100, bbox_inches="tight")
            plt.close(fig)
            written.append(str(path))
        return written

    def test_random_images(self, dataset, num_images: int = 3, seed: int = 42,
                           output_dir: str = "./predictions") -> list[str]:
        """``visualize_predictions`` of ``num_images`` indices drawn without
        replacement from ``np.random.default_rng(seed)``."""
        rng = np.random.default_rng(seed)
        indices = rng.choice(len(dataset), size=min(num_images, len(dataset)), replace=False)
        return self.visualize_predictions(dataset, indices.tolist(), output_dir)


class MoNuSegInferer:
    """Single-image and directory inference writing PNGs."""

    def __init__(self, model_path: str, device: str | torch.device | None = None):
        self.evaluator = MoNuSegEvaluator(model_path, device=device)

    def infer_image(self, image_path: str, output_dir: str):
        """``{stem}_mask.png`` (gray, 0 or 255) and ``{stem}_vis.png`` (the
        image with predicted nuclei blended half-way to red) -> (mask,
        confidence)."""
        out = Path(output_dir)
        out.mkdir(parents=True, exist_ok=True)
        image = load_rgb(image_path)
        mask, confidence = self.evaluator.predict_image(image)
        stem = Path(image_path).stem
        write_png(out / f"{stem}_mask.png", (mask * 255).astype(np.uint8))
        vis = image.copy()
        sel = mask > 0.5
        vis[sel] = (0.5 * vis[sel] + 0.5 * np.array([255, 0, 0])).astype(np.uint8)
        write_png(out / f"{stem}_vis.png", vis)
        print(f"{stem}: confidence {confidence:.4f}, positive fraction {mask.mean():.4f}")
        return mask, confidence

    def infer_directory(self, input_dir: str, output_dir: str,
                        exts=(".tif", ".tiff", ".png", ".jpg")) -> dict[str, float]:
        """Every image of ``input_dir`` with one of ``exts``, in name order
        -> {file name: confidence}.  The port decodes PNG and TIFF only: a
        selected file of another type (a JPEG) raises ``ValueError``, naming
        each such file, before any image is inferred."""
        names = [n for n in sorted(os.listdir(input_dir)) if n.lower().endswith(exts)]
        undecodable = [n for n in names if not n.lower().endswith(_IMG_EXTS)]
        if undecodable:
            raise ValueError(f"{input_dir}: the port has no decoder for {', '.join(undecodable)} "
                             f"(it reads {', '.join(_IMG_EXTS)})")
        results = {}
        for name in names:
            _, conf = self.infer_image(os.path.join(input_dir, name), output_dir)
            results[name] = conf
        return results
