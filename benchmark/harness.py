"""The benchmark's harness: finds a cell's files by name, runs it once, and
reduces a profiler trace to the device's busy time and a breakdown.

A cell (an entry of ``workloads`` in ``BENCHMARK.json``) names its
configuration (``benchmark/configs/<config>.json``) and its traffic mix
(``benchmark/traffic/<traffic>.json``, whose ``kind`` names the driver
``benchmark/kinds/<kind>.py``); its correctness limits are in
``benchmark/workloads/<cell>.json``.  Each per-layer metric is a reader,
``benchmark/metrics/<metric>.py``, with ``read(ctx) -> float | None``; a
metric with no file of its own is read by the file of its longest dotted
prefix (``device_idle.train`` by ``device_idle.py``).  A later cell,
configuration, mix or metric is new files and new entries.

A driver module has ``make(cell, seed, device, scale, control)`` returning
a runner with ``window(seconds) -> Window``, ``release()`` (frees the
program's state once the window is over) and ``check() -> numbers``.
``scale`` shrinks a cell for the CPU tests (empty in every chip run);
``control`` runs the cell's control in the program's place.
"""

from __future__ import annotations

import dataclasses
import gc
import heapq
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from benchmark.reference import compare

ROOT = Path(__file__).resolve().parents[1]
HERE = ROOT / "benchmark"
# top-level module names the run may not hold: JAX, its libraries, the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "ugpg_tpu")
SKIP_DEVICE = ("Activity Buffer Request",)
NOT_KERNELS = ("Memcpy", "Memset")  # the profiler's names of the device's copies and fills
NAMED_SECONDS = 2.0  # the host-traced window that names the idle gaps


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


@dataclasses.dataclass
class Window:
    """What a driver's window did: its seconds, the end-to-end values it
    measured, requests attempted and failed, and counts for the readers."""

    seconds: float
    values: dict
    attempted: int
    failed: int
    work: dict = dataclasses.field(default_factory=dict)


def log(line: str) -> None:
    """A line for standard error (diagnostics, before the check's lines)."""
    print(line, file=sys.stderr, flush=True)


_run_start = time.perf_counter()


def mark(phase: str) -> None:
    """The end of a set-up phase, in seconds since the run started, for
    standard error: where ``setup_s`` goes."""
    log(f"info set-up {phase} done at {time.perf_counter() - _run_start:.3f} s")


def _json(path: Path) -> dict:
    return json.loads(path.read_text())


def manifest() -> dict:
    return _json(ROOT / "BENCHMARK.json")


def _for(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str) -> Cell:
    m = manifest()
    entry = next((w for w in m["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"unknown workload {name!r}: {[w['name'] for w in m['workloads']]}")
    return Cell(
        name=name, chips=entry["chips"],
        config=_json(HERE / "configs" / f"{entry['config']}.json"),
        traffic=_json(HERE / "traffic" / f"{entry['traffic']}.json"),
        limits=_json(HERE / "workloads" / f"{name}.json")["limits"],
        end_to_end=[e for e in m["end_to_end"] if _for(e, name)],
        per_layer=[p for p in m["per_layer"] if _for(p, name)])


def driver(kind: str):
    return importlib.import_module(f"benchmark.kinds.{kind}")


def reader_path(metric: str) -> Path | None:
    """The reader of ``metric``: its own file, or its longest dotted prefix's."""
    parts = metric.split(".")
    for n in range(len(parts), 0, -1):
        path = HERE / "metrics" / (".".join(parts[:n]) + ".py")
        if path.is_file():
            return path
    return None


def reader(metric: str):
    path = reader_path(metric)
    spec = importlib.util.spec_from_file_location(f"benchmark.metrics.{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def forbidden_modules() -> list[str]:
    return sorted(n for n in sys.modules if n.split(".", 1)[0] in FORBIDDEN)


# ---------------------------------------------------------------- the trace
def _union(intervals: np.ndarray) -> np.ndarray:
    """Merged (start, end) rows of ``intervals``, sorted."""
    if len(intervals) == 0:
        return intervals.reshape(0, 2)
    iv = intervals[np.argsort(intervals[:, 0])]
    merged = [list(iv[0])]
    for s, e in iv[1:]:
        if s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return np.asarray(merged, dtype=np.float64)


def short_name(name: str) -> str:
    """A device operation's name without its argument list and return type."""
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i] if i > 0 else name
                break
    return name.removeprefix("void ").strip()[:160]


def _innermost(cpu: list, mids: np.ndarray) -> list[str]:
    """For each time in ``mids``, the name of the shortest host operation
    of ``cpu`` ((start, end, name), any thread) running then, or ``(no op)``:
    the host between operators, in Python."""
    order = sorted(range(len(cpu)), key=lambda i: cpu[i][0])
    active: list[tuple] = []  # heap of (end, duration, name)
    names, j = [], 0
    for m in np.argsort(mids):
        mid = mids[m]
        while j < len(order) and cpu[order[j]][0] <= mid:
            s, e, n = cpu[order[j]]
            heapq.heappush(active, (e, e - s, n))
            j += 1
        while active and active[0][0] < mid:
            heapq.heappop(active)
        names.append((m, min(active, key=lambda a: a[1])[2] if active else "(no op)"))
    return [n for _, n in sorted(names)]


def reduce_trace(events, window: tuple[float, float] | None = None, top: int = 10) -> dict:
    """From raw profiler events (objects with ``name()``, ``device_type()``,
    ``start_ns()``, ``end_ns()``, ``is_user_annotation()``) and the
    window's (start, end) in ns on the same clock (default: the span of
    the events): the window's seconds, the device's busy seconds (the union
    of its operations' intervals inside the window) and its kernel seconds
    (the same, copies and fills left out), seconds and launches by device
    operation, the ``top`` operations by time, and the idle gaps summed by
    the innermost host operation running at each gap's middle."""
    real = [e for e in events if e.name() not in SKIP_DEVICE and not e.name().startswith("bench.")]
    if window is None:
        window = ((min(e.start_ns() for e in real), max(e.end_ns() for e in real)) if real
                  else (0, 0))
    w0, w1 = window
    dev, kernels, cpu = [], [], []
    by_op: dict[str, list] = {}
    for e in real:
        s, t = e.start_ns(), e.end_ns()
        if t <= w0 or s >= w1:
            continue
        if e.device_type() == torch.autograd.DeviceType.CPU:
            if not e.is_user_annotation():
                cpu.append((s, t, e.name()))
            continue
        if e.is_user_annotation():
            continue
        s, t = max(s, w0), min(t, w1)
        dev.append((s, t))
        if not e.name().startswith(NOT_KERNELS):
            kernels.append((s, t))
        acc = by_op.setdefault(short_name(e.name()), [0.0, 0])
        acc[0] += (t - s) / 1e9
        acc[1] += 1
    busy = _union(np.asarray(dev, dtype=np.float64).reshape(-1, 2))
    busy_s = float((busy[:, 1] - busy[:, 0]).sum()) / 1e9 if len(busy) else 0.0
    kern = _union(np.asarray(kernels, dtype=np.float64).reshape(-1, 2))
    kernel_s = float((kern[:, 1] - kern[:, 0]).sum()) / 1e9 if len(kern) else 0.0
    edges = np.concatenate([[w0], busy.ravel(), [w1]]).reshape(-1, 2)
    gaps = edges[edges[:, 1] > edges[:, 0]]
    idle: dict[str, float] = {}
    for (g0, g1), name in zip(gaps, _innermost(cpu, gaps.mean(axis=1))):
        idle[name] = idle.get(name, 0.0) + (g1 - g0) / 1e9
    ops = sorted(by_op.items(), key=lambda kv: -kv[1][0])
    return {
        "window_s": (w1 - w0) / 1e9,
        "busy_s": busy_s,
        "kernel_s": kernel_s,
        "ops": {k: {"seconds": v[0], "launches": v[1]} for k, v in by_op.items()},
        "device_ops": [[k, v[0]] for k, v in ops[:top]],
        "idle_gaps": [[k[:160], v] for k, v in sorted(idle.items(), key=lambda kv: -kv[1])[:top]],
    }


def _profile(fn, cpu: bool):
    """``fn()`` under torch.profiler (the card's operations, and with
    ``cpu`` the host's operators): (its result, the raw events)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] if cpu or not torch.cuda.is_available() else []
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        out = fn()
    return out, prof.profiler.kineto_results.events()


def traced_window(runner, seconds: float, named_seconds: float) -> tuple[Window, dict]:
    """The runner's window traced for the card's operations alone (the
    device's seconds, by operation), then a window of ``named_seconds``
    traced with the host's operators too, whose idle gaps are named by the
    operator the host was in (the breakdown's ``idle_gaps``; that tracing
    slows the host more, so only the names and their order are read from
    it).  Even the first trace costs the host time at every launch, so
    rates are read from an untraced window, not from this one."""
    win, events = _profile(lambda: runner.window(seconds), cpu=False)
    trace = reduce_trace(events)
    _, events = _profile(lambda: runner.window(named_seconds), cpu=True)
    trace["idle_gaps"] = reduce_trace(events)["idle_gaps"]
    return win, trace


# ---------------------------------------------------------------- one run
def device_info(device: torch.device, chips: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def run(name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
        scale: dict | None = None, control: bool = False, t_start: float | None = None,
        log=log, numbers_out: dict | None = None) -> dict:
    """One run of cell ``name``: set-up, the window, the check.  Returns
    the result object (its ``checks`` key last); ``log`` gets the lines
    for standard error."""
    global _run_start
    t_start = _run_start = time.perf_counter() if t_start is None else t_start
    mark("imports")
    c = cell(name)
    dev = torch.device(device)
    runner = driver(c.traffic["kind"]).make(c, seed, dev, scale or {}, control)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    # the process's first full collection walks every object that torch, the
    # port and the set-up made (100-200 ms on the card's host): done here, in
    # set-up, and those objects frozen out of the window's collections
    gc.collect()
    gc.freeze()
    mark("collection")
    setup_s = time.perf_counter() - t_start
    win, traced, tr = runner.window(seconds), None, None
    if trace:
        # the same window again under the profiler: the device's seconds per
        # image from it, every rate from the untraced window above
        traced, tr = traced_window(runner, seconds, min(seconds, NAMED_SECONDS))
        rates = [w.work["images"] / w.seconds for w in (win, traced)]
        log(f"info images/s untraced {rates[0]!r}, traced {rates[1]!r} "
            f"(traced/untraced {rates[1] / rates[0]!r}); traced device busy "
            f"{tr['busy_s']!r} s, kernels {tr['kernel_s']!r} s of {tr['window_s']!r} s")
    info = device_info(dev, c.chips)
    runner.release()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    numbers = runner.check()
    if numbers_out is not None:
        numbers_out.update(numbers)
    for k, v in numbers.items():
        if k not in c.limits:
            log(f"info {k} = {v!r}")
    windows = [win] + ([traced] if traced else [])
    attempted, failed = sum(w.attempted for w in windows), sum(w.failed for w in windows)
    correct = compare.passes(numbers, c.limits) and failed == 0
    result = {"correct": correct, "attempted": attempted, "failed": failed}
    if trace:
        ctx = {"cell": c, "window": win, "traced": traced, "trace": tr,
               "on_chip": dev.type == "cuda"}
        metrics = {}
        for m in c.per_layer:
            value = reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        info["busy_s"], info["window_s"] = tr["busy_s"], tr["window_s"]
        result["metrics"] = metrics
        result["device"] = info
        result["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    else:
        values = {**win.values, "setup_s": setup_s}
        result["metrics"] = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                             for m in c.end_to_end}
        result["device"] = info
    checks = {k: {"value": numbers.get(k), "limit": v} for k, v in c.limits.items()}
    if failed:
        checks["failed"] = {"value": failed, "limit": 0}
    result["checks"] = checks
    for k, v in checks.items():
        log(f"check {k} = {v['value']!r} (limit {v['limit']!r})")
    return result


# ---------------------------------------------------------------- for the readers
def kernel_time(ctx: dict, part: str) -> tuple[float, int]:
    """(device seconds, launches) of the traced operations whose name holds ``part``."""
    ops = [v for k, v in ctx["trace"]["ops"].items() if part in k]
    return sum(v["seconds"] for v in ops), sum(v["launches"] for v in ops)
