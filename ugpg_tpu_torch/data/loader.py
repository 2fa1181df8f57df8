"""Host data loader: threaded decode and a device prefetch queue
(counterpart of ``ugpg_tpu/data/loader.py``).

* ``DataLoader``: a thread pool runs ``dataset[i]`` concurrently (the C++
  decoders and rasterizer release the GIL) and collates each batch into
  numpy arrays; the batch order comes from ``np.random.default_rng(seed)``,
  as in the JAX package, so both packages see the same batches.
* ``prefetch_to_device``: a producer thread keeps ``size`` batches ahead of
  the consumer.  On CUDA each batch is collated into pinned host tensors
  and copied with ``non_blocking=True`` on a side stream; the consumer's
  stream waits on that copy's event before it uses the batch, and
  ``record_stream`` keeps the caching allocator from reusing the device
  buffers while the consumer's stream may still read them.  On the CPU it
  is a plain pass-through queue.  A producer error re-raises in the
  consumer.  Closing the generator early (``close()``, or dropping it)
  stops the producer after the batch it is reading, closes the source
  iterator in the producer's thread and joins it, so no thread outlives
  the loop.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Sequence

import numpy as np
import torch

__all__ = ["DataLoader", "prefetch_to_device"]


def _collate(samples: Sequence) -> tuple[np.ndarray, ...]:
    first = samples[0]
    out = []
    for i in range(len(first)):
        parts = [s[i] for s in samples]
        if np.isscalar(parts[0]) or np.asarray(parts[0]).ndim == 0:
            out.append(np.asarray(parts))
        else:
            out.append(np.stack(parts))
    return tuple(out)


class DataLoader:
    """Minimal threaded batch loader over a map-style dataset."""

    def __init__(self, dataset, batch_size: int = 8, shuffle: bool = False,
                 num_workers: int = 4, drop_last: bool = False, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[tuple[np.ndarray, ...]]:
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            self._rng.shuffle(idx)
        end = (n // self.batch_size) * self.batch_size if self.drop_last else n
        batches = [idx[s:s + self.batch_size] for s in range(0, end, self.batch_size)]
        if not batches:
            return
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            # the items of batch k + 1 decode while batch k is consumed; each
            # item is its own task, so one worker is enough
            def submit(batch_idx):
                return [pool.submit(self.dataset.__getitem__, i) for i in batch_idx]

            pending = submit(batches[0])
            for nxt in batches[1:]:
                ready = _collate([f.result() for f in pending])
                pending = submit(nxt)
                yield ready
            yield _collate([f.result() for f in pending])


class _Ready:
    """A batch on the device with the event its copy recorded."""

    __slots__ = ("batch", "event")

    def __init__(self, batch, event):
        self.batch, self.event = batch, event


class _ProducerError:
    __slots__ = ("exc",)

    def __init__(self, exc):
        self.exc = exc


def _to_device(batch, device: torch.device, stream) -> _Ready:
    """Pinned host copies of the batch's arrays, copied to ``device`` on
    ``stream`` without blocking; the returned event marks the copy's end."""
    out = []
    with torch.cuda.stream(stream):
        for a in batch:
            host = torch.as_tensor(np.ascontiguousarray(a)).pin_memory()
            out.append(host.to(device, non_blocking=True))
        event = torch.cuda.Event()
        event.record(stream)
    return _Ready(tuple(out), event)


def prefetch_to_device(iterator, size: int = 2, device=None, stats: dict | None = None):
    """Iterate ``iterator``'s batches with ``size`` of them prefetched to
    ``device`` (``None``: the current CUDA device when CUDA is available,
    else the CPU).  On CUDA every array of a batch arrives as a tensor on
    the device, ready on the consumer's current stream; on the CPU the
    batches pass through unchanged.  ``stats``, when given, accumulates
    ``wait_s`` (the seconds the consumer waited on the queue) and
    ``batches``."""
    device = torch.device(device) if device is not None else (
        torch.device("cuda", torch.cuda.current_device()) if torch.cuda.is_available()
        else torch.device("cpu"))
    on_cuda = device.type == "cuda"
    if on_cuda and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    copy_stream = torch.cuda.Stream(device) if on_cuda else None

    q: queue.Queue = queue.Queue(maxsize=size)
    sentinel = object()
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for batch in iterator:
                if stop.is_set() or not put(
                        _to_device(batch, device, copy_stream) if on_cuda else batch):
                    return
        except BaseException as exc:  # a swallowed error would silently end the epoch early
            put(_ProducerError(exc))
            return
        finally:
            close = getattr(iterator, "close", None)
            if close is not None:
                close()
        put(sentinel)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            t0 = time.perf_counter()
            item = q.get()
            if stats is not None:
                stats["wait_s"] = stats.get("wait_s", 0.0) + time.perf_counter() - t0
                stats["batches"] = stats.get("batches", 0) + (item is not sentinel)
            if item is sentinel:
                break
            if isinstance(item, _ProducerError):
                raise item.exc
            if on_cuda:
                consumer = torch.cuda.current_stream(device)
                consumer.wait_event(item.event)
                for t in item.batch:
                    t.record_stream(consumer)
                item = item.batch
            yield item
    finally:
        stop.set()
        thread.join()
