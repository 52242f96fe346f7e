"""Loop timing for anytime budgets (counterpart of
ilqgames_tpu/utils/timing.py; the reference's utils/loop_timer.h:56-90,
src/loop_timer.cpp:75-92): tic/toc over a moving window with a
mean + 3 sigma upper bound, with which a host-side runtime decides
whether another solver call fits in a real-time budget. Host seconds
(time.perf_counter): a caller timing work on the card synchronizes
before toc."""

from __future__ import annotations

import collections
import time


class LoopTimer:
    def __init__(self, max_samples: int = 10, initial_guess_s: float = 0.02):
        self._window = collections.deque(maxlen=max_samples)
        self._initial_guess = initial_guess_s
        self._tic = None

    def tic(self):
        self._tic = time.perf_counter()

    def toc(self) -> float:
        if self._tic is None:
            raise RuntimeError("toc() without tic()")
        dt = time.perf_counter() - self._tic
        self._window.append(dt)
        self._tic = None
        return dt

    def runtime_upper_bound(self) -> float:
        """mean + 3 sigma of the window; the initial guess before any
        sample arrives (loop_timer.h:74-75)."""
        if not self._window:
            return self._initial_guess
        n = len(self._window)
        mean = sum(self._window) / n
        var = sum((s - mean) ** 2 for s in self._window) / n
        return mean + 3.0 * var ** 0.5
