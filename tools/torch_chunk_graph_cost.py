#!/usr/bin/env python3
"""Three ways to run a resident chunk of S train steps of the port's
segmentation step (``train/steps.py::make_seg_train_step``) on one NVIDIA
GPU, timed in turns:

* ``eager``: the S steps launched one by one, as the whole-epoch path runs
  them on a mesh or the CPU;
* ``step_graph``: one step captured and replayed S times, each replay
  reading its slice of the chunk at a step counter on the device (the
  design of ``train/graphs.py::StepGraph``, the port's choice);
* ``chunk_graph``: all S steps captured as one graph and replayed once.

    python3 tools/torch_chunk_graph_cost.py [--stages 1 4] [--steps 8] [--turns 5]

Full width, float32 with TF32 off, batch 8, the fused loss, augmented
(the parameters drawn before the chunk), torch's capturable RMSprop; stage
4 over a stage-3 model as its frozen source.  Each way gets its own model
and optimizer from the same seed, runs three warm-up steps on its capture
stream, then captures.  Per stage and way: images/s (median, min and max
over the turns, each turn one chunk from a synchronise to a synchronise),
the host's µs per step until the chunk's last launch was enqueued,
capture seconds, and the device memory the capture reserved.  Prints the
card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from ugpg_tpu_torch.data.synthetic import disk_dataset  # noqa: E402
from ugpg_tpu_torch.train.graphs import WARMUP_STEPS, take  # noqa: E402
from ugpg_tpu_torch.train.optim import torch_rmsprop  # noqa: E402
from ugpg_tpu_torch.train.seg_trainer import (  # noqa: E402
    DEFAULT_STAGE_CONFIGS,
    UncertaintyGuidedProgressiveTrainer,
)
from ugpg_tpu_torch.train.steps import (  # noqa: E402
    METRIC_KEYS,
    draw_seg_epoch,
    make_seg_train_step,
)

BATCH = 8
WAYS = ("eager", "step_graph", "chunk_graph")


class ChunkRunner:
    """One way of running a chunk of ``n`` steps (the module's docstring)."""

    def __init__(self, way: str, stage: int, chunk: dict, n: int):
        tr = UncertaintyGuidedProgressiveTrainer(verbose=False, seed=7, augment=True,
                                                 fused_loss=True)
        model = tr._model(stage)
        prev, prev_res = tr._prev(stage)
        opt = torch_rmsprop(model.parameters(), DEFAULT_STAGE_CONFIGS[stage]["lr"],
                            capturable=True)
        step = make_seg_train_step(model, opt, stage, DEFAULT_STAGE_CONFIGS[stage]["resolution"],
                                   prev_model=prev, prev_resolution=prev_res, augment=True,
                                   fused_loss=True)

        def body(x):
            m = step((x["images"], x["masks"]), 1.0, aug=x["aug"])
            return torch.stack([m[k].float() for k in METRIC_KEYS])

        self.way, self.n, self.body = way, n, body
        self.static = {k: (v.clone() if isinstance(v, torch.Tensor)
                           else {j: t.clone() for j, t in v.items()}) for k, v in chunk.items()}
        self.slot = torch.zeros((), dtype=torch.int64, device="cuda")
        self.rows = torch.zeros((n, len(METRIC_KEYS)), device="cuda")
        self.stream = torch.cuda.Stream()
        self.graph, self.capture_s, self.reserved_gib = None, 0.0, 0.0
        self.stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(self.stream):
            for _ in range(WARMUP_STEPS):
                self._step()
            self.slot.zero_()
            if way != "eager":
                torch.cuda.synchronize()
                before = torch.cuda.memory_reserved()
                self.graph = torch.cuda.CUDAGraph()
                t0 = time.perf_counter()
                with torch.cuda.graph(self.graph, stream=self.stream,
                                      capture_error_mode="thread_local"):
                    for _ in range(1 if way == "step_graph" else n):
                        self._step()
                self.capture_s = time.perf_counter() - t0
                self.reserved_gib = (torch.cuda.memory_reserved() - before) / 2**30
        torch.cuda.current_stream().wait_stream(self.stream)

    def _step(self) -> None:
        row = self.body(take(self.static, self.slot)).reshape(1, -1)
        self.rows.index_copy_(0, self.slot.view(1), row)
        self.slot.add_(1)

    def run(self, chunk: dict) -> float:
        """One chunk; returns the host's seconds until its last launch."""
        main = torch.cuda.current_stream()
        self.stream.wait_stream(main)
        with torch.cuda.stream(self.stream):
            t0 = time.perf_counter()
            if self.way == "eager":  # the port's eager chunk: a step per slice
                rows = torch.stack([self.body(take(chunk, s)) for s in range(self.n)])
            else:
                for dst, src in ((self.static[k], chunk[k]) for k in ("images", "masks")):
                    dst.copy_(src, non_blocking=True)
                for k, v in chunk["aug"].items():
                    self.static["aug"][k].copy_(v, non_blocking=True)
                self.slot.zero_()
                for _ in range(self.n if self.way == "step_graph" else 1):
                    self.graph.replay()
                rows = self.rows.clone()
            host = time.perf_counter() - t0
        main.wait_stream(self.stream)
        assert rows.shape == (self.n, len(METRIC_KEYS))
        return host


def _chunk(n: int, seed: int) -> dict:
    images, masks = disk_dataset(n * BATCH, 256, seed=seed)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return {"images": torch.from_numpy(images).cuda().view(n, BATCH, *images.shape[1:]),
            "masks": torch.from_numpy(masks).cuda().view(n, BATCH, *masks.shape[1:]),
            "aug": draw_seg_epoch(gen, n, BATCH)}


def measure(stage: int, n: int, turns: int) -> dict:
    chunks = [_chunk(n, seed) for seed in (1, 2)]
    runners = {way: ChunkRunner(way, stage, chunks[0], n) for way in WAYS}
    for r in runners.values():  # one untimed chunk each
        r.run(chunks[1])
    walls = {w: [] for w in WAYS}
    hosts = {w: [] for w in WAYS}
    order = list(WAYS)
    for t in range(turns):
        for way in (order if t % 2 == 0 else order[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            hosts[way].append(runners[way].run(chunks[t % 2]))
            torch.cuda.synchronize()
            walls[way].append(time.perf_counter() - t0)
    out = {}
    for way in WAYS:
        ips = [n * BATCH / w for w in walls[way]]
        out[way] = {"images_per_s": {"median": statistics.median(ips), "min": min(ips),
                                     "max": max(ips)},
                    "host_us_per_step": statistics.median(hosts[way]) / n * 1e6,
                    "capture_s": runners[way].capture_s,
                    "capture_reserved_gib": runners[way].reserved_gib}
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--stages", type=int, nargs="+", default=[1, 4])
    ap.add_argument("--steps", type=int, default=8, help="steps a chunk (S)")
    ap.add_argument("--turns", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("torch_chunk_graph_cost: CUDA is not available; this script needs an NVIDIA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    out = {"steps_per_chunk": args.steps, "batch": BATCH,
           "stages": {s: measure(s, args.steps, args.turns) for s in args.stages}, "card": card}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
