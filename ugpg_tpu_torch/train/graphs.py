"""CUDA graphs of a train or eval step over a resident chunk of an epoch.

The whole-epoch path (``train/steps.py::make_*_epoch``, the trainers'
``scan_epochs``) stacks S equal batches and moves them to the card once.
``StepGraph`` runs their S steps as replays of one captured step:

* the chunk lives in static buffers the graph reads (a later chunk of the
  same shapes is copied into them), beside a step counter ``slot`` and a
  (S, K) buffer of metric rows on the device;
* one step reads its slice of every buffer at ``slot``
  (``index_select``), runs the per-step path's own step function, writes
  its metric row at ``slot`` and adds one to it, all on the device, so the
  host only calls ``replay()`` S times and makes no synchronisation inside
  a chunk;
* the first ``WARMUP_STEPS`` steps over new buffers run eagerly on the capture
  stream (real steps of the epoch, in order, over as many chunks as it
  takes: they make the optimizer's state, cuDNN's and cuBLAS's handles,
  the loss kernel's workspace and the allocator's blocks on that stream),
  then one step is captured (capture runs nothing) and replayed for the
  rest.

A graph keeps the kernels its capture chose: a change of cuDNN's or the
matmuls' settings (deterministic, benchmark, TF32) captures anew, as it
would change what the eager step runs.  What the step reads besides the
chunk (parameters, gradients, the optimizer's state and its learning-rate
tensor, BN buffers) must stay the same tensors while the graph lives:
the trainers drop their graphs when a stage's optimizer is rebuilt,
weights are transferred or loaded, or a run resumes.  A step that cannot be captured raises; nothing falls back to the
eager step.

Launch counts (``ops/cuda/_lib.py``): the capture's launches go to the
graph's own tally, added to the run's counts once per replay.
"""

from __future__ import annotations

import time
from typing import Any, Callable

import torch

from ugpg_tpu_torch.ops.cuda import _lib

__all__ = ["StepGraph", "take", "WARMUP_STEPS"]

WARMUP_STEPS = 3  # eager steps on the capture stream before a capture


def take(tree: Any, s) -> Any:
    """Step ``s`` of a stacked tree (tensors (S, ...), dicts, lists, None;
    a leaf with a ``step`` method — a chunk split over a mesh — is asked
    for it).  ``s`` is an int, or a 0-d int64 device tensor (read on the
    device, as a graph needs)."""
    if tree is None:
        return None
    if hasattr(tree, "step"):
        return tree.step(s)
    if isinstance(tree, dict):
        return {k: take(v, s) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [take(v, s) for v in tree]
    if isinstance(s, torch.Tensor):
        return tree.index_select(0, s.view(1))[0]
    return tree[s]


def _leaves(tree: Any) -> list:
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _to_device(tree: Any, device: torch.device) -> Any:
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_device(v, device) for v in tree]
    # the graph's own buffer; from page-locked memory the copy does not hold the host
    return torch.as_tensor(tree).to(device, copy=True, non_blocking=True)


def _backend_flags() -> tuple:
    """The settings that pick the kernels a step runs."""
    cudnn = torch.backends.cudnn
    return (cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)


def _same_key(a: tuple, b: tuple) -> bool:
    """Constants a graph closes over: tensors by identity (the graph reads
    their memory, and the runner keeps them alive), others by value."""
    return len(a) == len(b) and all(
        x is y or not isinstance(x, torch.Tensor) and not isinstance(y, torch.Tensor) and x == y
        for x, y in zip(a, b))


def _layout(tree: Any) -> list:
    """Shapes and dtypes (numpy's and torch's alike) of a tree's leaves."""
    return [(tuple(x.shape), str(x.dtype).removeprefix("torch.")) for x in _leaves(tree)]


class StepGraph:
    """One step of a chunk, captured once and replayed (the module's
    docstring).  ``run(body, chunk, n, key)`` -> the (n, K) metric rows of
    the chunk's n steps, a new device tensor.  ``body(inputs) -> row``:
    one step on the inputs of one step (``take(chunk, s)``).  A new graph
    is captured when the chunk's shapes or ``key`` (the constants the step
    closes over, such as ``pos_weight``) change."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.stream = torch.cuda.Stream(self.device)
        self.graph: torch.cuda.CUDAGraph | None = None
        self.launches: dict[str, int] = {}  # per replay
        self.capture_s = self.replay_s = 0.0  # seconds capturing; in replay() calls
        self.captures = self.replays = self.eager_steps = 0
        self._static = self._slot = self._rows = self._key = None
        self._warm = 0  # eager steps run over the current buffers

    def reset(self) -> None:
        """Forget the graph and its buffers (the next run captures anew)."""
        self.graph = None
        self._static = self._slot = self._rows = self._key = None
        self._warm = 0

    def stats(self) -> dict:
        """The counters: captures, replays, eager steps, seconds."""
        return {"captures": self.captures, "replays": self.replays,
                "eager_steps": self.eager_steps, "capture_s": self.capture_s,
                "replay_s": self.replay_s}

    def _step(self, body: Callable, n: int) -> None:
        row = body(take(self._static, self._slot)).reshape(1, -1)
        if self._rows is None:
            self._rows = row.new_zeros((n, row.shape[1]))
        self._rows.index_copy_(0, self._slot.view(1), row)
        self._slot.add_(1)

    def run(self, body: Callable, chunk: Any, n: int, key: tuple = ()) -> torch.Tensor:
        key = (*key, _backend_flags())
        main = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(main)
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            if (self._static is None or not _same_key(key, self._key)
                    or _layout(chunk) != _layout(self._static)):
                self.reset()
                self._static = _to_device(chunk, self.device)
                self._slot = torch.zeros((), dtype=torch.int64, device=self.device)
                self._key = key
            else:
                for dst, src in zip(_leaves(self._static), _leaves(chunk)):
                    dst.copy_(torch.as_tensor(src), non_blocking=True)
                self._slot.zero_()
            done = 0
            if self.graph is None:
                while done < n and self._warm < WARMUP_STEPS:
                    self._step(body, n)
                    done += 1
                    self._warm += 1
                self.eager_steps += done
                if done < n:
                    self._capture(body, n)
            t0 = time.perf_counter()
            for _ in range(n - done):
                self.graph.replay()
            self.replay_s += time.perf_counter() - t0
            if n > done:
                _lib.add_launches(self.launches, n - done)
                self.replays += n - done
            out = self._rows[:n].clone()
        main.wait_stream(self.stream)
        out.record_stream(main)
        return out

    def _capture(self, body: Callable, n: int) -> None:
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        with _lib.recording() as tally:
            with torch.cuda.graph(graph, stream=self.stream, capture_error_mode="thread_local"):
                self._step(body, n)
        self.capture_s += time.perf_counter() - t0
        self.captures += 1
        self.graph, self.launches = graph, dict(tally)
