"""Open-loop single images through ``ServingRegistry.submit``, the
micro-batcher coalescing them into the predictor's buckets.

Mix parameters: ``rate_per_s`` (offered load), ``buckets`` and
``max_latency_ms`` (the serving settings), ``pool_images`` (distinct uint8
tiles drawn from the seed, sent in turn), ``warmup_requests``,
``check_requests`` (answers the check
compares, drawn from the seed over the window) and ``drain_s`` (how long
past the window's close answers are waited for).

Every seed sends the same number of requests, ``rate_per_s`` x
``seconds``, with the same set of gaps between arrivals: the quantiles of
an exponential distribution, rescaled to span the window, in an order
drawn from the seed.  Each request is timed from when it was due to when
its future resolved; one that fails or never resolves counts as missing,
an infinite latency.  How late the generator sent is on standard error.

End-to-end value: ``request_p95_ms``, the 95th percentile over every
request due in the window.  The control: the program's int8 path.
"""

from __future__ import annotations

import concurrent.futures
import sys
import time

import numpy as np
import torch

from benchmark import checks
from benchmark.harness import Window, mark
from benchmark.kinds import BODY_DTYPES, Checkpoints, Reservoir, scaled_config, uint8_images
from benchmark.weights import sub_seed

NAME = "model"


def arrivals(rate: float, seconds: float, seed: int) -> np.ndarray:
    """Due times (s from the window's start) of ``rate`` x ``seconds``
    requests: the same multiset of exponential gaps for every seed, in a
    seeded order, spanning ``seconds``."""
    n = max(1, round(rate * seconds))
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n)
    gaps = np.random.default_rng(seed).permutation(gaps)
    due = np.cumsum(gaps) - gaps[0]
    due *= seconds / (due[-1] + gaps.mean()) if n > 1 else 0.0
    return due


class OpenLoop:
    def __init__(self, cell, seed: int, device: torch.device, scale: dict, control: bool):
        from ugpg_tpu_torch.eval.serving import ServingRegistry

        self.config = cfg = scaled_config(cell.config, scale)
        t = self.traffic = cell.traffic
        self.limits, self.device, self.seed = cell.limits, device, seed
        res = cfg["resolution"]
        self.ckpts = Checkpoints()
        path = self.ckpts.write("model", cfg, sub_seed(seed, 0), device, cfg["stage"])
        mark("weights")
        self.pool = uint8_images((scale.get("pool_images", t["pool_images"]), res, res, 3),
                                 sub_seed(seed, 1), device)
        mark("requests")
        self.registry = ServingRegistry(max_latency_ms=t["max_latency_ms"])
        kw = dict(buckets=tuple(t["buckets"]), input_dtype=np.uint8, device=device,
                  dtype=BODY_DTYPES[cfg["serve"]["body_dtype"]])
        if control:
            kw.update(quantize=True, calibration_batches=[self.pool[:64].astype(np.float32) / 255])
        predictor = self.registry.register(NAME, str(path), **kw)
        mark("predictor")
        for b in t["buckets"]:  # every bucket's shapes, then the batcher's thread
            predictor(self.pool[:b])
        futures = [self.registry.submit(NAME, im) for im in self.pool[:t["warmup_requests"]]]
        for f in futures:
            f.result()
        mark("warm-up")
        self.rate = scale.get("rate_per_s", t["rate_per_s"])
        self.kept = Reservoir(scale.get("check_requests", t["check_requests"]), sub_seed(seed, 2))

    def _batcher(self) -> dict:
        return self.registry.stats()[NAME]["batcher"]

    def window(self, seconds: float) -> Window:
        t = self.traffic
        due = arrivals(self.rate, seconds, sub_seed(self.seed, 3))
        n = len(due)
        done = np.full(n, np.inf)
        late = np.zeros(n)
        futures = []
        before = self._batcher()
        t0 = time.perf_counter()

        def finished(i, fut):
            if fut.exception() is None:
                done[i] = time.perf_counter() - t0

        for i, d in enumerate(due):
            wait = d - (time.perf_counter() - t0)
            if wait > 0:
                time.sleep(wait)
            late[i] = time.perf_counter() - t0 - d
            fut = self.registry.submit(NAME, self.pool[i % len(self.pool)])
            fut.add_done_callback(lambda f, i=i: finished(i, f))
            futures.append(fut)
        closed = time.perf_counter() - t0
        concurrent.futures.wait(futures, timeout=t["drain_s"])
        after = self._batcher()
        failed = 0
        for i, fut in enumerate(futures):
            if not fut.done() or fut.exception() is not None:
                failed += 1
                continue
            self.kept.offer((i, fut.result()))
        latency_ms = self.last_latency_ms = (done - due) * 1e3
        print(f"generator: {n} requests over {closed:.4f} s, lateness ms median "
              f"{np.median(late) * 1e3:.4f} p95 {np.percentile(late, 95) * 1e3:.4f} max "
              f"{late.max() * 1e3:.4f}", file=sys.stderr, flush=True)
        groups = after["groups"] - before["groups"]
        submitted = after["submitted"] - before["submitted"]
        return Window(seconds, {"request_p95_ms": float(np.percentile(latency_ms, 95))}, n,
                      failed, {"requests": n, "images": n - failed, "groups": groups,
                               "submitted": submitted,
                               "late_p95_ms": float(np.percentile(late, 95) * 1e3),
                               "span_s": float(np.max(done, initial=closed, where=np.isfinite(done)))})

    def release(self) -> None:
        self.registry.close()
        self.registry = None
        self.ckpts.close()

    def check(self) -> dict:
        cfg = self.config
        sd = Checkpoints.state_dict(cfg, sub_seed(self.seed, 0), self.device)
        idx = [i for i, _ in self.kept.items]
        images = self.pool[[i % len(self.pool) for i in idx]]
        outs = [np.stack([o[k] for _, o in self.kept.items]) for k in range(3)]
        return checks.segmentation(cfg, sd, [(images, outs)], self.limits, self.device)


def make(cell, seed, device, scale, control):
    return OpenLoop(cell, seed, device, scale, control)
