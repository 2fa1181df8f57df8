"""Graceful preemption: SIGTERM -> rolling checkpoint -> resumable exit.

A copy of ``ugpg_tpu/utils/preemption.py`` (standard library only).

Cloud TPU VMs (and most cluster schedulers) deliver SIGTERM shortly before
a maintenance event or preemption kills the process.  The reference's only
failure handling is a ``KeyboardInterrupt``/generic ``except`` around the
training loop that just prints and exits (ref:
MoNuSegImprove/train_aug_monuseg.py:263-267, Herlev/train_herlev.py:649-653)
— work since the last best-checkpoint is lost.

``PreemptionGuard`` converts that signal into a cooperative stop: the
handler only sets a flag; the trainers poll ``should_stop()`` at epoch
boundaries, write a rolling ``*_last`` checkpoint (variables + optimizer
state + epoch), flush async checkpoint writes, and return — so a
``resume=True`` restart continues mid-stage exactly where the preempted
run stopped (train/seg_trainer.py resume machinery).  The CLIs exit with
code 75 (EX_TEMPFAIL) on a preempted run so schedulers requeue instead of
marking the job failed.

Checkpoint granularity is one epoch: polling happens where the state is
consistent and cheap to snapshot.  A second signal while stopping falls
through to the previous handler (normally: terminate) — the guard never
blocks a determined kill.
"""

from __future__ import annotations

import signal
import threading
import time

__all__ = ["PreemptionGuard"]


class PreemptionGuard:
    """Cooperative stop flag armed by OS signals.

    Use as a context manager (or call ``install()``/``uninstall()``);
    installing replaces the handlers for ``signals`` (default: SIGTERM)
    and restores the previous ones on exit.  ``trigger()`` arms the flag
    programmatically (tests, custom schedulers).
    """

    def __init__(self, signals=(signal.SIGTERM,)):
        self._signals = tuple(signals)
        self._event = threading.Event()
        self._prev: dict = {}
        self.signum: int | None = None
        self.at: float | None = None

    # -- lifecycle ------------------------------------------------------
    def install(self) -> "PreemptionGuard":
        for s in self._signals:
            if s in self._prev:
                continue  # idempotent
            self._prev[s] = signal.signal(s, self._on_signal)
        return self

    def uninstall(self) -> None:
        for s, handler in self._prev.items():
            signal.signal(s, handler)
        self._prev.clear()

    def __enter__(self) -> "PreemptionGuard":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()

    # -- signal path ----------------------------------------------------
    def _on_signal(self, signum, frame) -> None:
        if self._event.is_set():
            # second signal: defer to the previous handler (usually the
            # default terminate) — never block a determined kill
            prev = self._prev.get(signum)
            if callable(prev):
                prev(signum, frame)
            elif prev == signal.SIG_DFL:
                signal.signal(signum, signal.SIG_DFL)
                signal.raise_signal(signum)
            return
        self.signum = signum
        self.at = time.time()
        self._event.set()

    def trigger(self) -> None:
        """Arm the stop flag without a signal (tests / custom schedulers)."""
        self._on_signal(None, None)

    # -- polling --------------------------------------------------------
    def should_stop(self) -> bool:
        return self._event.is_set()
