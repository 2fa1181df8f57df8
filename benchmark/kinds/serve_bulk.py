"""Bulk scoring: full batches of uint8 images through ``Predictor.stream``.

Mix parameters: ``batch`` (images per request, the only bucket),
``pool_batches`` (distinct request batches drawn from the seed, sent in
turn), ``prefetch`` (the stream's copies ahead), ``warmup_batches``,
``check_calls`` (calls whose answers the check compares, drawn from the
seed over the window), and for a classifier ``mc_dropout`` and
``mc_seed``.  The configuration gives the model, its resolution and the
body's dtype.  The window runs the stream until ``seconds`` have passed
and ends with the answer of the call that crossed it, every image's
outputs on the host as numpy arrays.

End-to-end value: ``<task>_serve_images_per_s`` (``seg`` or ``cls``), the
images answered over the window's seconds.  The control: the program's
int8 path (``quantize=True``, calibrated on the first pool batch) for a
segmentation model, the reference in float8 for a classifier (the
program's int8 path has no MC dropout).
"""

from __future__ import annotations

import itertools
import time

import numpy as np
import torch

from benchmark import checks
from benchmark.harness import Window, mark
from benchmark.kinds import BODY_DTYPES, Checkpoints, Reservoir, scaled_config, uint8_images
from benchmark.weights import sub_seed


class BulkServing:
    def __init__(self, cell, seed: int, device: torch.device, scale: dict, control: bool):
        from ugpg_tpu_torch.eval.serving import Predictor

        self.config = cfg = scaled_config(cell.config, scale)
        t = cell.traffic
        self.limits, self.device, self.seed, self.control = cell.limits, device, seed, control
        self.cls = cfg["model"] == "herlev_classifier"
        self.batch = scale.get("batch", t["batch"])
        res = cfg["resolution"]
        self.ckpts = Checkpoints()
        path = self.ckpts.write("model", cfg, sub_seed(seed, 0), device, cfg["stage"])
        mark("weights")
        n_pool = scale.get("pool_batches", t["pool_batches"])
        self.pool = uint8_images((n_pool, self.batch, res, res, 3), sub_seed(seed, 1), device)
        mark("requests")
        kw = dict(buckets=(self.batch,), input_dtype=np.uint8, device=device,
                  dtype=BODY_DTYPES[cfg["serve"]["body_dtype"]])
        if self.cls:
            self.passes, self.mc_seed = t["mc_dropout"], t["mc_seed"]
            kw.update(task_type="classification", num_classes=cfg["num_classes"],
                      mc_dropout=self.passes, mc_seed=self.mc_seed)
        elif control:
            kw.update(quantize=True, calibration_batches=[self.pool[0].astype(np.float32) / 255])
        self.predictor = Predictor(str(path), **kw)
        mark("predictor")
        self.prefetch = t["prefetch"]
        self.kept = Reservoir(scale.get("check_calls", t["check_calls"]), sub_seed(seed, 2))
        self.metric = ("cls" if self.cls else "seg") + "_serve_images_per_s"
        for _ in self.predictor.stream(iter(self.pool[:t["warmup_batches"]]), self.prefetch):
            pass
        mark("warm-up")

    def _requests(self):
        for i in itertools.count():
            yield self.pool[i % len(self.pool)]

    def window(self, seconds: float) -> Window:
        images = calls = 0
        stream = self.predictor.stream(self._requests(), self.prefetch)
        t0 = time.perf_counter()
        for outs in stream:
            self.kept.offer((calls % len(self.pool), outs))
            images += len(outs[0])
            calls += 1
            if time.perf_counter() - t0 >= seconds:
                break
        elapsed = time.perf_counter() - t0
        stream.close()
        return Window(elapsed, {self.metric: images / elapsed}, images, 0,
                      {"images": images, "calls": calls})

    def release(self) -> None:
        self.predictor = None
        self.ckpts.close()

    def check(self) -> dict:
        cfg = self.config
        sd = Checkpoints.state_dict(cfg, sub_seed(self.seed, 0), self.device)
        ctl = self.control and self.cls
        if self.cls:
            items = [(self.pool[i], outs, 0) for i, outs in self.kept.items]
            return checks.classification(cfg, sd, items, self.limits, self.device, self.passes,
                                         self.mc_seed, self.batch, control=ctl)
        items = [(self.pool[i], outs) for i, outs in self.kept.items]
        return checks.segmentation(cfg, sd, items, self.limits, self.device)


def make(cell, seed, device, scale, control):
    return BulkServing(cell, seed, device, scale, control)
