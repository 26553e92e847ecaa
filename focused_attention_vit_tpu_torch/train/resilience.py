"""Preemption-safe training: SIGTERM -> checkpoint -> clean exit (port of
``focused_attention_vit_tpu/train/resilience.py``, pure Python, copied).

Spot and preemptible capacity delivers SIGTERM with a grace window before
the machine goes away:

- :class:`GracefulShutdown` latches the signal into a bool that the
  training loop polls at batch boundaries
  (``train_and_evaluate(should_stop=...)``).
- The loop finishes the step in flight and stops; the experiment saves the
  mid-epoch state as a checkpoint of the next epoch (the partial epoch
  counts as complete, its remaining batches are skipped on resume) and the
  CLI exits with code 143 (128 + SIGTERM), so that a supervisor restarts
  the command and ``--checkpoint_dir`` resumes it.

A second signal while the first is still draining raises
``SystemExit(128 + signum)`` at once.
"""

from __future__ import annotations

import signal
import threading
from typing import Iterable


class GracefulShutdown:
    """Context manager latching SIGTERM (by default) into a pollable bool.

    Python delivers signals to the main thread only; entered from any other
    thread this installs nothing (``triggered`` stays False).

    Usable directly as the loop's ``should_stop`` callable::

        with GracefulShutdown() as stop:
            train_and_evaluate(..., should_stop=stop)
    """

    def __init__(self, signals: Iterable[int] = (signal.SIGTERM,)):
        self._signals = tuple(signals)
        self._old = {}
        self._triggered = False
        self._installed = False

    def _handler(self, signum, frame):
        if self._triggered:
            raise SystemExit(128 + signum)  # second signal: die now
        self._triggered = True

    def __enter__(self) -> "GracefulShutdown":
        if threading.current_thread() is threading.main_thread():
            for s in self._signals:
                self._old[s] = signal.signal(s, self._handler)
            self._installed = True
        return self

    def __exit__(self, *exc) -> bool:
        if self._installed:
            for s, old in self._old.items():
                signal.signal(s, old)
            self._installed = False
        return False

    @property
    def triggered(self) -> bool:
        return self._triggered

    def __call__(self) -> bool:
        return self._triggered
