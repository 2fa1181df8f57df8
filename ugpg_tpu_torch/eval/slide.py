"""Whole-slide (native-resolution) serving (counterpart of
``ugpg_tpu/eval/slide.py``, one device).

``SlidePredictor`` serves segmentation at the request's own size instead of
downsizing it to the stage resolution: the image is zero-padded up to the
model's divisibility constraint (``2 ** pools``, with ``pad_multiple`` its
lcm), run convolutionally on the whole padded image, and the (preds,
probs, uncertainty) maps are cropped back to the request size.  The
forward is ``native_forward``, the one
``MoNuSegEvaluator.evaluate_dataset_native`` runs too, on BN-folded
weights: on the GPU every DoubleConv, every Up-block upsample and the
uncertainty map run the port's kernels.

The multi-scale heads interpolate at the padded size, so a different
``pad_multiple`` moves boundary values by interpolation round-off: leave
it unset to match the evaluation path.  The spatially sharded path
(``mesh``) is not ported yet and raises.

``SlidePredictor.export`` writes one ``torch.export`` program per (H, W)
size, which ``ExportedSlidePredictor`` serves without model code: each
request goes to the smallest exported size that fits, zero-padded up and
cropped back (the slide counterpart of ``Predictor.export`` and
``ExportedPredictor``).
"""

from __future__ import annotations

import json
import math
import time
from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from ugpg_tpu_torch.device import resolve_device
from ugpg_tpu_torch.eval.exported import (
    PLATFORMS,
    _BucketRouter,
    check_platforms,
    load_program,
    read_manifest,
)
from ugpg_tpu_torch.eval.serving import stage_model
from ugpg_tpu_torch.io.checkpoint import load_checkpoint
from ugpg_tpu_torch.ops.cuda.library import uncertainty_from_logits

__all__ = ["SlidePredictor", "ExportedSlidePredictor", "native_forward", "native_divisor"]


def _round_up(n: int, d: int) -> int:
    return d * -(-n // d)


def native_divisor(stage: int) -> int:
    """The side a stage's input must divide: 2 ** (its max-pools)."""
    return 2 ** (1 if stage == 1 else stage)


@torch.inference_mode()
def native_forward(model: torch.nn.Module, images: torch.Tensor,
                   divisor: tuple[int, int]) -> tuple[torch.Tensor, ...]:
    """(B, H, W, 3) float32 images in [0, 1] on the model's device -> NHWC
    float32 (preds, probs, uncertainty) at (H, W): zero-padded bottom and
    right to multiples of ``divisor``, run, cropped back."""
    return _native_body(model, images, divisor)


def _native_body(model, images, divisor):
    """``native_forward``'s body, which an exported slide size runs too."""
    n, h, w, c = images.shape
    hp, wp = _round_up(h, divisor[0]), _round_up(w, divisor[1])
    x = images
    if (hp, wp) != (h, w):
        x = images.new_zeros((n, hp, wp, c))
        x[:, :h, :w] = images
    logits = model(x.permute(0, 3, 1, 2))  # NCHW view of NHWC (channels_last) memory
    probs = torch.sigmoid(logits)
    preds = (probs > 0.5).float()
    unc = uncertainty_from_logits(logits)
    return tuple(t[:, :, :h, :w].permute(0, 2, 3, 1) for t in (preds, probs, unc))


class _SlideBase(_BucketRouter):
    """The request surface of the live and the exported slide predictors:
    (B, H, W, 3) requests of any size, (preds, probs, uncertainty) at the
    request's size.  ``micro_batch = False``: slides of different sizes
    cannot share one device call, so the registry and the HTTP front end
    serve each request directly instead of through ``BatchingServer``."""

    task_type = "segmentation"
    micro_batch = False
    resolution = "native"
    buckets: tuple = ()
    input_dtype = np.dtype(np.float32)
    _n_outputs = 3

    def __init__(self, max_batch: int = 1, compact_output: bool = False):
        _BucketRouter.__init__(self)
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.max_batch = max_batch
        self.compact_output = compact_output

    @staticmethod
    def _coerce(images: np.ndarray) -> np.ndarray:
        """(B, H, W, 3) float32 in [0, 1]; uint8 RGB is divided by 255."""
        images = np.asarray(images)
        if images.ndim != 4 or images.shape[-1] != 3:
            raise ValueError(f"expected a (B, H, W, 3) batch, got shape {images.shape}")
        if images.dtype == np.uint8:
            return images.astype(np.float32) / 255.0
        return np.asarray(images, np.float32)

    def _run(self, chunk: np.ndarray) -> tuple[np.ndarray, ...]:
        raise NotImplementedError

    def __call__(self, images):
        """images: (B, H, W, 3) float32 in [0, 1] or uint8 RGB, any (H, W).
        -> numpy (preds, probs, uncertainty), each (B, H, W, 1)."""
        t0 = time.perf_counter()
        images = self._coerce(images)
        outs = [self._run(images[s:s + self.max_batch])
                for s in range(0, len(images), self.max_batch)]
        preds, probs, unc = (np.concatenate([o[i] for o in outs]) for i in range(3))
        if self.compact_output:
            preds, probs, unc = preds.astype(np.uint8), probs.astype(np.float16), \
                unc.astype(np.float16)
        self._record(time.perf_counter() - t0, len(images), len(outs))
        return preds, probs, unc


class SlidePredictor(_SlideBase):
    """Native-resolution segmentation predictor over a ``.pth`` checkpoint.

    Example:
        p = SlidePredictor("out/ug_pgunet_stage4_best.pth")
        preds, probs, unc = p(slides)           # (B, 1000, 1000, 3) in and out

    ``dtype``: compute dtype of the body (None = float32).  ``max_batch``:
    slides per device call.  ``pad_multiple``: quantise the padded sizes up
    to multiples of N.  ``compact_output``: uint8 preds, float16 maps.
    ``device``: ``cuda`` unless given; raises without CUDA.
    """

    def __init__(self, checkpoint: str, num_classes: int = 1, dtype: torch.dtype | None = None,
                 mesh=None, w_axis: str | None = None, max_batch: int = 1,
                 pad_multiple: int | None = None, compact_output: bool = False,
                 device: str | torch.device | None = None):
        _SlideBase.__init__(self, max_batch, compact_output)
        self.device = resolve_device(device)
        if mesh is not None or w_axis is not None:
            raise NotImplementedError(
                "not ported to ugpg_tpu_torch yet: SlidePredictor(mesh=...) "
                "(ROADMAP.md queue A, item 4)")
        if num_classes != 1:
            raise ValueError("SlidePredictor is the binary-segmentation slide path "
                             f"(num_classes=1), got num_classes={num_classes}")
        self.stage, state_dict = load_checkpoint(checkpoint)
        div = native_divisor(self.stage)
        if pad_multiple:
            div = math.lcm(div, int(pad_multiple))
        self._divisor = (div, div)
        self.model = stage_model(self.stage, state_dict, self.device, 1,
                                 dtype or torch.float32)

    def _run(self, chunk: np.ndarray) -> tuple[np.ndarray, ...]:
        x = torch.from_numpy(np.ascontiguousarray(chunk)).to(self.device)
        return tuple(t.cpu().numpy() for t in native_forward(self.model, x, self._divisor))

    def export(self, path, sizes: Sequence[tuple[int, int]] = ((1024, 1024),),
               platforms: Sequence[str] = PLATFORMS):
        """Write a slide artifact that serves without model code
        (``ExportedSlidePredictor``): one ``torch.export`` program per (H, W)
        of ``sizes``, ``slide_{h}x{w}.pt2``, batch 1, float32 in [0, 1].
        Each pads to the stage's divisor, runs ``native_forward``'s body on
        this predictor's weights and crops back.  Plus ``manifest.json``
        (format 2, kind "slide").  Returns ``path``."""
        platforms = check_platforms(platforms)
        path = Path(path)
        path.mkdir(parents=True, exist_ok=True)
        sizes = sorted({(int(h), int(w)) for h, w in sizes})
        div = native_divisor(self.stage)
        entry = _SlideEntry(self.model, (div, div))
        for h, w in sizes:
            example = torch.zeros((1, h, w, 3), dtype=torch.float32, device=self.device)
            with torch.no_grad():
                program = torch.export.export(entry, (example,))
            torch.export.save(program, str(path / f"slide_{h}x{w}.pt2"))
        manifest = {
            "format_version": 2,
            "kind": "slide",
            "task_type": "segmentation",
            "stage": self.stage,
            "sizes": [list(s) for s in sizes],
            "n_outputs": 3,
            "platforms": platforms,
            "torch_version": torch.__version__,
        }
        (path / "manifest.json").write_text(json.dumps(manifest, indent=1))
        return path


class _SlideEntry(torch.nn.Module):
    """What ``SlidePredictor.export`` traces: ``native_forward``'s body."""

    def __init__(self, model: torch.nn.Module, divisor: tuple[int, int]):
        super().__init__()
        self.model = model
        self.divisor = divisor

    def forward(self, raw: torch.Tensor) -> tuple[torch.Tensor, ...]:
        return _native_body(self.model, raw, self.divisor)


class ExportedSlidePredictor(_SlideBase):
    """Serve a ``SlidePredictor.export`` artifact: no model code or
    checkpoint.  Each request image goes to the smallest exported size that
    fits (zero-padded up, the maps cropped back).

    ``device``: ``cuda`` unless given; raises without CUDA.
    """

    def __init__(self, path, compact_output: bool = False,
                 device: str | torch.device | None = None):
        _SlideBase.__init__(self, max_batch=1, compact_output=compact_output)
        self.device = resolve_device(device)
        path = Path(path)
        manifest = read_manifest(path, 2)
        if manifest.get("kind") != "slide":
            raise ValueError("not a slide artifact (need format_version=2, kind='slide'); "
                             "use ExportedPredictor for bucket artifacts")
        self.manifest = manifest
        self.stage = manifest["stage"]
        # ascending by area, so that _size_for picks the tightest fit
        self.sizes = sorted((tuple(s) for s in manifest["sizes"]),
                            key=lambda s: (s[0] * s[1], s))
        self._fns = {(h, w): load_program(path / f"slide_{h}x{w}.pt2", self.device,
                                          manifest["platforms"])
                     for h, w in self.sizes}

    def _size_for(self, h: int, w: int) -> tuple[int, int]:
        for sh, sw in self.sizes:
            if h <= sh and w <= sw:
                return sh, sw
        raise ValueError(f"request ({h}, {w}) exceeds every exported size {self.sizes}; "
                         "re-export with a larger size bucket")

    @torch.inference_mode()
    def _run(self, chunk: np.ndarray) -> tuple[np.ndarray, ...]:
        h, w = chunk.shape[1], chunk.shape[2]
        sh, sw = self._size_for(h, w)
        x = chunk
        if (sh, sw) != (h, w):
            x = np.pad(chunk, ((0, 0), (0, sh - h), (0, sw - w), (0, 0)))
        x = torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
        return tuple(t[:, :h, :w].cpu().numpy() for t in self._fns[(sh, sw)](x))
