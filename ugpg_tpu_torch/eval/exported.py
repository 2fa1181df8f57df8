"""Serving of exported artifacts without model code (counterpart of
``ugpg_tpu/eval/exported.py``).

``Predictor.export`` (``eval/serving.py``) writes one ``torch.export``
program per batch bucket, ``bucket_{b}.pt2``, with the weights inside, and
a ``manifest.json``; ``ExportedPredictor`` here serves such an artifact.
This module imports torch, numpy, ``ops/resize.py`` and the operator
registrations (``ops/cuda/library.py``) only -- no model code, no
checkpoint reader, no ``eval/serving.py`` -- so a deployment host can

    from ugpg_tpu_torch.eval.exported import ExportedPredictor

with nothing else of the package loaded.  The programs call the three
serving kernels as the operators ``torch.ops.ugpg_torch.*``, which the
import of ``ops/cuda/library.py`` registers before a program is loaded:
on the GPU they launch the hand-written kernels, on the CPU they run the
plain versions, so one artifact serves on either device.

The JAX package's artifacts are StableHLO (``*.stablehlo``); this module
refuses them, and a manifest whose ``format_version`` it does not know.

``_BucketRouter`` holds the request routing shared with the live
``Predictor``: ragged batches route to the smallest bucket that fits,
padding is stripped from the responses, larger requests run in chunks of
the largest bucket, and requests are coerced to the served input dtype
and resolution (on the host, once); subclasses provide ``_dispatch``.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from pathlib import Path

import numpy as np
import torch

from ugpg_tpu_torch.device import resolve_device
from ugpg_tpu_torch.ops.cuda import library  # noqa: F401  (registers torch.ops.ugpg_torch)
from ugpg_tpu_torch.ops.resize import resize_bilinear_align_corners

__all__ = ["ExportedPredictor", "PLATFORMS", "check_platforms", "read_manifest"]

PLATFORMS = ("cpu", "cuda")  # the devices an artifact can serve on


def check_platforms(platforms) -> list[str]:
    """``platforms`` as a list; raise ``ValueError`` unless each is one the
    port's artifacts serve on."""
    platforms = list(platforms)
    if not platforms or any(p not in PLATFORMS for p in platforms):
        raise ValueError(f"platforms {platforms}: the port's artifacts serve on {list(PLATFORMS)}")
    return platforms


def _resize_nhwc(images: np.ndarray, res: int) -> np.ndarray:
    """Host-side bilinear (align_corners) resize of float32 NHWC images."""
    x = torch.from_numpy(np.ascontiguousarray(images, dtype=np.float32)).permute(0, 3, 1, 2)
    return resize_bilinear_align_corners(x, (res, res)).permute(0, 2, 3, 1).numpy()


def read_manifest(path, format_version: int) -> dict:
    """``path/manifest.json`` of an artifact of ``format_version`` (1: batch
    buckets, 2: slide sizes); raise ``ValueError`` on a JAX StableHLO
    artifact or another format."""
    path = Path(path)
    jax_files = sorted(p.name for p in path.glob("*.stablehlo"))
    if jax_files:
        raise ValueError(
            f"{path} is a JAX StableHLO artifact ({', '.join(jax_files[:3])}); the port serves "
            "torch.export programs (*.pt2) written by its own Predictor.export or "
            "SlidePredictor.export")
    manifest = json.loads((path / "manifest.json").read_text())
    if manifest.get("format_version") != format_version:
        raise ValueError(f"unsupported artifact format: {manifest.get('format_version')} "
                         f"(this loader reads format_version {format_version})")
    return manifest


def load_program(file: Path, device: torch.device, platforms) -> torch.nn.Module:
    """One saved ``torch.export`` program, its weights moved to ``device``,
    as a callable module."""
    if device.type not in platforms:
        raise ValueError(f"the artifact was exported for {list(platforms)}, not {device.type}")
    from torch.export.passes import move_to_device_pass

    program = move_to_device_pass(torch.export.load(str(file)), str(device))
    return program.module()


class _BucketRouter:
    """Fixed-bucket request routing.

    Requires ``buckets`` (ascending), ``batch_size`` (largest bucket),
    ``resolution``, ``input_dtype``, ``_n_outputs`` and
    ``_dispatch(bucket, chunk) -> tuple``.  ``stats()`` reports request
    counters and latency percentiles over a sliding window.
    """

    def __init__(self):
        self._stats_lock = threading.Lock()
        self._n_requests = 0
        self._n_images = 0
        self._n_device_calls = 0
        self._total_s = 0.0
        self._latencies = deque(maxlen=1024)  # per-request wall seconds

    def _dispatch(self, bucket: int, chunk):
        raise NotImplementedError

    def stats(self) -> dict:
        """Request counters + latency percentiles (sliding 1024 window)."""
        with self._stats_lock:
            lat = list(self._latencies)
            out = {
                "requests": self._n_requests,
                "images": self._n_images,
                "device_calls": self._n_device_calls,
                "total_seconds": round(self._total_s, 6),
            }
        lat.sort()
        if lat:
            def pct(p):
                return round(lat[min(len(lat) - 1, int(p / 100.0 * len(lat)))] * 1e3, 3)
            out["latency_ms"] = {"p50": pct(50), "p95": pct(95), "p99": pct(99)}
        return out

    def _record(self, dt: float, n_images: int, n_device_calls: int) -> None:
        with self._stats_lock:
            self._n_requests += 1
            self._n_images += n_images
            self._n_device_calls += n_device_calls
            self._total_s += dt
            self._latencies.append(dt)

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def _coerce(self, images: np.ndarray) -> np.ndarray:
        """Match the served input signature: dtype and spatial size."""
        images = np.asarray(images)
        res = self.resolution
        if self.input_dtype == np.uint8:
            if images.dtype != np.uint8:
                images = np.clip(np.asarray(images, np.float32) * 255.0, 0, 255).astype(np.uint8)
        else:
            if images.dtype == np.uint8:
                images = images.astype(np.float32) / 255.0
            else:
                images = np.asarray(images, np.float32)
        if images.shape[1:3] != (res, res):
            # arbitrary request sizes: resize on the host once
            x = images.astype(np.float32)
            if images.dtype == np.uint8:
                x = x / 255.0
            images = _resize_nhwc(x, res)
            if self.input_dtype == np.uint8:
                images = np.clip(images * 255.0, 0, 255).astype(np.uint8)
        return images

    def _run_padded(self, chunk: np.ndarray):
        n = chunk.shape[0]
        bucket = self._bucket_for(n)
        if n < bucket:
            pad = np.zeros((bucket - n, *chunk.shape[1:]), chunk.dtype)
            chunk = np.concatenate([chunk, pad])
        outs = self._dispatch(bucket, chunk)
        return tuple(o[:n] for o in outs)

    def __call__(self, images: np.ndarray):
        """images: (N, H, W, 3) float32 in [0,1] or uint8 RGB; any N.
        Segmentation -> numpy (preds, probs, uncertainty); classification
        -> (labels, probs[, variance])."""
        t0 = time.perf_counter()
        images = self._coerce(images)
        outs = [
            self._run_padded(images[s: s + self.batch_size])
            for s in range(0, len(images), self.batch_size)
        ]
        result = tuple(
            np.concatenate([np.asarray(o[i]) for o in outs]) for i in range(self._n_outputs)
        )
        self._record(time.perf_counter() - t0, len(images), len(outs))
        return result


class ExportedPredictor(_BucketRouter):
    """Serve a ``Predictor.export`` artifact: no model code or checkpoint.

    Loads the per-bucket programs (weights inside) and exposes the live
    ``Predictor``'s request surface; composes with ``BatchingServer``.

    Example:
        p = ExportedPredictor("exported/stage4")        # on cuda
        preds, probs, unc = p(images)

    ``device``: ``cuda`` unless given; raises without CUDA.
    """

    def __init__(self, path, device: str | torch.device | None = None):
        _BucketRouter.__init__(self)
        self.device = resolve_device(device)
        path = Path(path)
        manifest = read_manifest(path, 1)
        self.manifest = manifest
        self.task_type = manifest["task_type"]
        self.stage = manifest["stage"]
        self.resolution = manifest["resolution"]
        self.buckets = tuple(manifest["buckets"])
        self.batch_size = self.buckets[-1]
        self.input_dtype = np.dtype(manifest["input_dtype"])
        self._n_outputs = manifest["n_outputs"]
        self._fns = {b: load_program(path / f"bucket_{b}.pt2", self.device,
                                     manifest["platforms"])
                     for b in self.buckets}

    @torch.inference_mode()
    def _dispatch(self, bucket: int, chunk):
        x = torch.from_numpy(np.ascontiguousarray(chunk)).to(self.device)
        return tuple(o.cpu().numpy() for o in self._fns[bucket](x))
