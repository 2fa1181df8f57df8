"""ugpg_tpu_torch: the PyTorch + CUDA port of ugpg_tpu for NVIDIA Hopper.

Serves stage-4 uncertainty-guided segmentation (mask, probabilities and
uncertainty map) on BN-folded weights, trains the four stages
progressively (``train/seg_trainer.py``), resumably, and evaluates MoNuSeg
at the stage and at native resolution (``eval/monuseg.py``,
``eval/slide.py``); trains, evaluates and serves Herlev classification
(``train/cls_trainer.py``, ``eval/herlev.py``, ``Predictor(task_type=
"classification")``); exports its predictors as ``torch.export`` artifacts
and serves checkpoints and artifacts by name and over HTTP
(``eval/exported.py``, ``ServingRegistry``, ``eval/http_server.py``); and
does all of this through command lines (``cli/``), with MoNuSeg's offline
augmentation and the demos.  The kernels on those paths --
the fused DoubleConv, the exact 2x bilinear upsample, the uncertainty map,
and the uncertainty-weighted BCE loss with its gradient -- are
hand-written CUDA C++ for ``sm_90a`` (``csrc/``), each with a plain
PyTorch version beside it (``ops/cuda/``); the three serving kernels are
``torch.library`` operators (``ops/cuda/library.py``), so that the models
and their exported graphs call the same code on either device.

Layout mirrors ``ugpg_tpu`` (``models/``, ``ops/``, ``io/``, ``eval/``,
``train/``, ``progressive/``, ``metrics/``, ``data/``, ``utils/``).  The
package imports torch, numpy and the standard library only; it never
imports JAX or ``ugpg_tpu``.  Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``.
"""

from __future__ import annotations

import importlib

from ugpg_tpu_torch.device import resolve_device

__version__ = "0.2.0"

# public name -> defining submodule, resolved on first attribute access (the
# flat names of ``ugpg_tpu/__init__.py``, all of them)
_EXPORTS = {
    "PGUNet1": "ugpg_tpu_torch.models.pgunet",
    "PGUNet2": "ugpg_tpu_torch.models.pgunet",
    "PGUNet3": "ugpg_tpu_torch.models.pgunet",
    "PGUNet4": "ugpg_tpu_torch.models.pgunet",
    "UNet": "ugpg_tpu_torch.models.pgunet",
    "ProgressiveUNet": "ugpg_tpu_torch.models.progressive",
    "HerlevClassificationModel": "ugpg_tpu_torch.models.classifier",
    "UncertaintyGuidedLoss": "ugpg_tpu_torch.uncertainty",
    "apply_uncertainty_weighted_loss": "ugpg_tpu_torch.uncertainty",
    "binary_uncertainty": "ugpg_tpu_torch.uncertainty",
    "create_uncertainty_weighted_loss_fn": "ugpg_tpu_torch.uncertainty",
    "entropy_uncertainty": "ugpg_tpu_torch.uncertainty",
    "generate_uncertainty_map": "ugpg_tpu_torch.uncertainty",
    "mc_dropout_uncertainty": "ugpg_tpu_torch.uncertainty",
    "HerlevDataset": "ugpg_tpu_torch.data.herlev",
    "create_herlev_splits": "ugpg_tpu_torch.data.herlev",
    "AugMoNuSegDataset": "ugpg_tpu_torch.data.monuseg",
    "MoNuSegDataset": "ugpg_tpu_torch.data.monuseg",
    "create_train_val_split": "ugpg_tpu_torch.data.monuseg",
    "xml_to_mask": "ugpg_tpu_torch.data.rasterize",
    "AugMoNuSegTrainer": "ugpg_tpu_torch.train.aug_trainer",
    "HerlevTrainer": "ugpg_tpu_torch.train.cls_trainer",
    "UncertaintyGuidedProgressiveTrainer": "ugpg_tpu_torch.train.seg_trainer",
}

__all__ = sorted(_EXPORTS) + ["resolve_device"]


def __getattr__(name: str):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module 'ugpg_tpu_torch' has no attribute {name!r}")
    value = getattr(importlib.import_module(module), name)
    globals()[name] = value  # cache: later lookups skip __getattr__
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
