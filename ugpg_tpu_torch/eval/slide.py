"""Whole-slide (native-resolution) serving (counterpart of
``ugpg_tpu/eval/slide.py``).

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
it unset to match the evaluation path.

With ``mesh`` (``parallel/mesh.py``) the slide is spatially sharded, H
over the mesh's ``data`` axis and W over ``w_axis`` when given, with 1-px
halo exchange (``parallel/spatial.py::spatial_predict``, the program
``MoNuSegEvaluator.evaluate_dataset_native(mesh=...)`` runs): padded to
``shards * 2 ** pools`` per axis, so that it equals the unsharded forward
on the same padded image, not on the unsharded divisor's.

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
from ugpg_tpu_torch.parallel.mesh import data_axis_size
from ugpg_tpu_torch.parallel.spatial import SpatialWeights, spatial_divisor, spatial_predict

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
    """Native-resolution segmentation predictor over a checkpoint (a ``.pth``
    or a msgpack or orbax directory).

    Example:
        p = SlidePredictor("out/ug_pgunet_stage4_best.pth")
        preds, probs, unc = p(slides)           # (B, 1000, 1000, 3) in and out

        # slides larger than one device: the spatial halo-exchange grid
        p = SlidePredictor("out/ug_pgunet_stage4_best.pth",
                           mesh=make_mesh(2, 2), w_axis="model")

    ``dtype``: compute dtype of the body (None = float32).  ``mesh``: H
    shards over its ``data`` axis (and W over ``w_axis``, a second mesh
    axis, when given), the predictor's device the mesh's first.
    ``max_batch``: slides per device call.  ``pad_multiple``: quantise the
    padded sizes up to multiples of N.  ``compact_output``: uint8 preds,
    float16 maps.  ``device``: ``cuda`` unless given; raises without CUDA.
    """

    def __init__(self, checkpoint: str, num_classes: int = 1, dtype: torch.dtype | None = None,
                 mesh=None, w_axis: str | None = None, max_batch: int = 1,
                 pad_multiple: int | None = None, compact_output: bool = False,
                 device: str | torch.device | None = None):
        _SlideBase.__init__(self, max_batch, compact_output)
        self.device = resolve_device(device)
        if num_classes != 1:
            raise ValueError("SlidePredictor is the binary-segmentation slide path "
                             f"(num_classes=1), got num_classes={num_classes}")
        self.stage, state_dict = load_checkpoint(checkpoint)
        self.mesh, self._w_axis, self._dtype = mesh, w_axis, dtype
        self._pad_multiple = pad_multiple
        if mesh is not None:
            data_axis_size(mesh)
            if w_axis is not None and w_axis not in mesh.axis_names:
                raise ValueError(f"w_axis {w_axis!r} is not a mesh axis ({mesh.axis_names})")
            h_div, w_div = spatial_divisor(self.stage, mesh, "data", w_axis)
            self.device = mesh.first
        elif w_axis is not None:
            raise ValueError("w_axis names an axis of a mesh: pass mesh= too")
        else:
            h_div = w_div = native_divisor(self.stage)
        if pad_multiple:
            h_div, w_div = math.lcm(h_div, int(pad_multiple)), math.lcm(w_div, int(pad_multiple))
        self._divisor = (h_div, w_div)
        if mesh is None:
            self.model = stage_model(self.stage, state_dict, self.device, 1,
                                     dtype or torch.float32)
        else:
            self._state_dict = state_dict  # export builds the unsharded model from it
            self._weights = SpatialWeights(state_dict, self.stage, mesh, dtype)

    def _run(self, chunk: np.ndarray) -> tuple[np.ndarray, ...]:
        x = torch.from_numpy(np.ascontiguousarray(chunk))
        if self.mesh is None:
            outs = native_forward(self.model, x.to(self.device), self._divisor)
        else:  # the program evaluate_dataset_native(mesh=) runs
            outs = spatial_predict(self._weights, x, self.mesh, stage=self.stage,
                                   w_axis=self._w_axis, dtype=self._dtype, pad=True,
                                   pad_multiple=self._pad_multiple)
        return tuple(t.cpu().numpy() for t in outs)

    def export(self, path, sizes: Sequence[tuple[int, int]] = ((1024, 1024),),
               platforms: Sequence[str] = PLATFORMS):
        """Write a slide artifact that serves without model code
        (``ExportedSlidePredictor``): one ``torch.export`` program per (H, W)
        of ``sizes``, ``slide_{h}x{w}.pt2``, batch 1, float32 in [0, 1].
        Each pads to the stage's divisor, runs ``native_forward``'s body on
        this predictor's weights and crops back.  Plus ``manifest.json``
        (format 2, kind "slide").  Under a mesh the artifact is the
        unsharded model on the mesh's first device.  Returns ``path``."""
        platforms = check_platforms(platforms)
        path = Path(path)
        path.mkdir(parents=True, exist_ok=True)
        sizes = sorted({(int(h), int(w)) for h, w in sizes})
        div = native_divisor(self.stage)
        model = self.model if self.mesh is None else stage_model(
            self.stage, self._state_dict, self.device, 1, self._dtype or torch.float32)
        entry = _SlideEntry(model, (div, div))
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
