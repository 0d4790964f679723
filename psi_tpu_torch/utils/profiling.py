"""Tracing (port of ``psi_tpu.utils.profiling``).

* ``trace(logdir)`` — a ``torch.profiler`` capture of the enclosed block
  (host and, when a card is present, CUDA activity), written to
  ``logdir`` as a Chrome trace viewable in Perfetto or chrome://tracing;
* ``span(name)`` — a named region of the program in that trace
  (``torch.profiler.record_function``) while a profiler runs, and nothing
  while none does. The program's spans are named ``psi.*``.
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator

import torch

# a span while no profiler runs: entering a bare record_function would cost
# ~13 us on the host, this costs well under one
_OFF = contextlib.nullcontext()


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


def span(name: str):
    """Named region in the profiler trace, recorded only while a profiler runs."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF
