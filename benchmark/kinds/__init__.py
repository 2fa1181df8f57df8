"""Traffic drivers: one module per traffic ``kind``, each reading a mix's
parameters from ``benchmark/traffic/<mix>.json``.  Shared here: the seeded
checkpoint files, the sample of answers kept for the check, and the CPU
tests' shrinking of a cell (``scale``: ``width`` of every channel count,
``resolution``, and the mix's own sizes)."""

from __future__ import annotations

import copy
import shutil
import tempfile
from pathlib import Path

import numpy as np
import torch

from benchmark import weights
from benchmark.reference import models

__all__ = ["scaled_config", "Checkpoints", "Reservoir", "BODY_DTYPES", "uint8_images"]

BODY_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _width(n: int, w: float) -> int:
    return max(8, round(n * w))


def _scale_blocks(blocks: dict, w: float) -> dict:
    out = {}
    for name, (cin, cout) in blocks.items():
        if name == "inc":
            cin_s = cin
        elif name.startswith("up"):
            cin_s = 2 * _width(cin // 2, w)
        else:
            cin_s = _width(cin, w)
        out[name] = [cin_s, _width(cout, w)]
    return out


def scaled_config(config: dict, scale: dict) -> dict:
    """``config`` with its channel counts times ``scale['width']`` (the
    port's rule: at least 8) and its resolution ``scale['resolution']``;
    ``config`` itself when ``scale`` has neither."""
    if "width" not in scale and "resolution" not in scale:
        return config
    cfg = copy.deepcopy(config)
    w = scale.get("width", 1.0)
    if "resolution" in scale:
        ratio = scale["resolution"] / cfg["resolution"]
        cfg["resolution"] = scale["resolution"]
        if "train" in cfg:
            prev = cfg["train"]["prev"]
            prev["resolution"] = round(prev["resolution"] * ratio)
    specs = [cfg] + ([cfg["train"]["prev"]] if "train" in cfg else [])
    for spec in specs:
        spec["blocks"] = _scale_blocks(spec["blocks"], w)
        if "heads" in spec:
            spec["heads"] = {k: _width(v, w) for k, v in spec["heads"].items()}
    return cfg


class Checkpoints:
    """Seeded reference-format ``.pth`` files in a directory of their own
    under ``TMPDIR``, removed by ``close``."""

    def __init__(self):
        self.dir = Path(tempfile.mkdtemp(prefix="bench-"))

    def write(self, name: str, config: dict, seed: int, device, stage: int,
              spec: dict | None = None) -> Path:
        sd = self.state_dict(config, seed, device, spec)
        return weights.write_pth(self.dir / f"{name}.pth", sd, stage)

    @staticmethod
    def state_dict(config: dict, seed: int, device, spec: dict | None = None) -> dict:
        with torch.device("meta"):
            model = models.build(config, spec)
        return weights.seeded_state_dict(model, seed, device)

    def close(self) -> None:
        shutil.rmtree(self.dir, ignore_errors=True)


class Reservoir:
    """A uniform sample of ``k`` of the items offered, drawn from ``seed``
    (reservoir sampling): the answers the check compares."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.items, self.seen = k, np.random.default_rng(seed), [], 0

    def offer(self, item) -> None:
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                self.items[j] = item
        self.seen += 1


def uint8_images(shape: tuple, seed: int, device) -> np.ndarray:
    """Uniform uint8 images drawn on ``device``, as a host array."""
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(0, 256, shape, dtype=torch.uint8, generator=g,
                         device=device).cpu().numpy()
