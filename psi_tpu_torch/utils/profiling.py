"""Tracing and throughput instrumentation (port of ``psi_tpu.utils.profiling``).

* ``trace(logdir)`` — a ``torch.profiler`` capture of the enclosed block
  (host and, when a card is present, CUDA activity), written to
  ``logdir`` as a Chrome trace viewable in Perfetto or chrome://tracing;
* ``StepTimer`` — rolling step-time / items-per-second counters for
  train/generation/fitting loops (copied);
* ``annotate(name)`` — a named region in that trace
  (``torch.profiler.record_function``).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import deque
from typing import Dict, Iterator, Optional

import torch


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Profile the enclosed block; on exit write ``logdir/trace.json``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def annotate(name: str):
    """Named region in the profiler trace."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Rolling throughput meter: step time and items/sec."""

    def __init__(self, window: int = 50):
        self.times: deque = deque(maxlen=window)
        self.items: deque = deque(maxlen=window)
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, n_items: int = 1) -> float:
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        self.items.append(n_items)
        return dt

    @contextlib.contextmanager
    def step(self, n_items: int = 1) -> Iterator[None]:
        self.start()
        yield
        self.stop(n_items)

    def summary(self) -> Dict[str, float]:
        if not self.times:
            return {"mean_step_s": 0.0, "items_per_sec": 0.0, "steps": 0}
        total_t = sum(self.times)
        return {
            "mean_step_s": total_t / len(self.times),
            "items_per_sec": sum(self.items) / total_t if total_t > 0 else 0.0,
            "steps": len(self.times),
        }
