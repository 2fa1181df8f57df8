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
(``mesh``) and ``export`` are not ported yet and raise.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from ugpg_tpu_torch.device import resolve_device
from ugpg_tpu_torch.eval.serving import _BucketRouter, stage_model
from ugpg_tpu_torch.io.checkpoint import load_checkpoint
from ugpg_tpu_torch.ops.cuda.uncertainty import uncertainty_from_logits

__all__ = ["SlidePredictor", "native_forward", "native_divisor"]


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


class SlidePredictor(_BucketRouter):
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
        _BucketRouter.__init__(self)
        self.device = resolve_device(device)
        if mesh is not None or w_axis is not None:
            raise NotImplementedError(
                "not ported to ugpg_tpu_torch yet: SlidePredictor(mesh=...) (see ROADMAP.md)")
        if num_classes != 1:
            raise ValueError("SlidePredictor is the binary-segmentation slide path "
                             f"(num_classes=1), got num_classes={num_classes}")
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.max_batch = max_batch
        self.compact_output = compact_output
        self.stage, state_dict = load_checkpoint(checkpoint)
        div = native_divisor(self.stage)
        if pad_multiple:
            div = math.lcm(div, int(pad_multiple))
        self._divisor = (div, div)
        self.model = stage_model(self.stage, state_dict, self.device, 1,
                                 dtype or torch.float32)

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
        x = torch.from_numpy(np.ascontiguousarray(chunk)).to(self.device)
        return tuple(t.cpu().numpy() for t in native_forward(self.model, x, self._divisor))

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

    def export(self, *args, **kwargs):
        raise NotImplementedError("not ported to ugpg_tpu_torch yet: SlidePredictor.export "
                                  "(see ROADMAP.md)")
