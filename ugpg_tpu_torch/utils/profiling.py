"""Tracing, step timing and the per-epoch training log (counterpart of
``ugpg_tpu/utils/profiling.py``).

* ``trace``: a context manager around ``torch.profiler.profile`` over the
  CPU and, where there is a card, CUDA activities; it writes a Chrome
  trace (``*.pt.trace.json``) under ``log_dir``, which TensorBoard's
  profiler plugin and ``chrome://tracing`` read.  A trace is for people
  to read: on the H100 machine the profiler has lost kernel launches
  (ROADMAP.md section C), so launch counts come from
  ``ops/cuda/_lib.py::launch_counts``.
* ``annotate``: a named host-side region, ``torch.profiler.record_function``.
* ``StepTimer``: wall-clock step timing with an EMA and a summary.  Device
  work is asynchronous: time whole steps that end in a synchronise.
* ``CSVLogger``: ``training_log.csv``, one row per epoch.
"""

from __future__ import annotations

import contextlib
import csv
import time
from pathlib import Path

import numpy as np
import torch

__all__ = ["trace", "annotate", "StepTimer", "CSVLogger"]


@contextlib.contextmanager
def trace(log_dir: str | Path):
    """Profile the block into a Chrome trace under ``log_dir``; yields the
    ``torch.profiler.profile`` object."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(str(log_dir))
                 ) as prof:
        yield prof


def annotate(name: str):
    """Named host-side trace region (shows up in the profiler timeline)."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Wall-clock step timer with EMA and summary statistics."""

    def __init__(self, ema: float = 0.9):
        self._ema_coef = ema
        self.ema: float | None = None
        self.times: list[float] = []
        self._t0: float | None = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        self.ema = dt if self.ema is None else (
            self._ema_coef * self.ema + (1 - self._ema_coef) * dt)
        return False

    def summary(self) -> dict:
        if not self.times:
            return {}
        arr = np.asarray(self.times)
        return {
            "steps": len(arr),
            "mean_s": float(arr.mean()),
            "p50_s": float(np.percentile(arr, 50)),
            "p95_s": float(np.percentile(arr, 95)),
            "total_s": float(arr.sum()),
        }


class CSVLogger:
    """Append-only CSV with a fixed header."""

    def __init__(self, path: str | Path, fieldnames: list[str]):
        self.path = Path(path)
        self.fieldnames = list(fieldnames)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        if not self.path.exists():
            with open(self.path, "w", newline="") as f:
                csv.DictWriter(f, fieldnames=self.fieldnames).writeheader()

    def log(self, **row):
        with open(self.path, "a", newline="") as f:
            csv.DictWriter(f, fieldnames=self.fieldnames).writerow(
                {k: row.get(k, "") for k in self.fieldnames})
