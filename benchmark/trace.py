"""The traced part of a window: ``torch.profiler`` over the first
``trace_seconds`` of it, read into device activity, kernel time by name,
launches and idle gaps named by what the host was running. Without a trace,
the device's clock: the card's busy seconds over the whole window, from a
profile of device activity alone."""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch


class DeviceClock:
    """The card's busy seconds over a stretch of host time: CUPTI's record
    of every kernel, copy and set (``torch.autograd``'s profiler with the
    CUDA activity alone, nothing recorded on the host), read once at the end
    through the profiler's raw events, with none of ``torch.profiler``'s
    parsing of them."""

    def __init__(self):
        from torch._C._profiler import _ExperimentalConfig
        from torch.autograd import ProfilerActivity, ProfilerConfig, ProfilerState

        self.config = ProfilerConfig(ProfilerState.KINETO, False, False, False, False, False, _ExperimentalConfig())
        self.activities = {ProfilerActivity.CUDA}

    def start(self) -> None:
        from torch.autograd import _enable_profiler, _prepare_profiler

        _prepare_profiler(self.config, self.activities)
        _enable_profiler(self.config, self.activities)

    def stop(self, t0: int, t1: int) -> float:
        """Busy seconds of the device within [t0, t1] (ns), the union of its operations."""
        from torch.autograd import _disable_profiler

        events = _disable_profiler().events()
        cpu = torch.autograd.DeviceType.CPU
        return busy_ns([(e.start_ns(), e.start_ns() + e.duration_ns()) for e in events if e.device_type() != cpu],
                       t0, t1) / 1e9


class Tracer:
    """Started at the window's start; ``tick`` stops it, at a unit's
    boundary, once ``seconds`` have passed. Off, it does nothing, unless
    ``clock``: then it times the device over the whole window, from
    ``start`` to the ``tick`` that forces the end, into ``device_busy_s``."""

    def __init__(self, enabled: bool, seconds: float, device, clock: bool = False):
        self.enabled, self.seconds, self.device = enabled, seconds, device
        self.prof = None
        self.units = 0
        self.stopped: Optional[float] = None  # perf_counter() when the profile stopped
        self.view: Optional["TraceView"] = None
        self.clock = DeviceClock() if clock and not enabled and device.type == "cuda" else None
        self.device_busy_s: Optional[float] = None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self) -> None:
        if self.clock is not None:
            self._sync()
            self.clock.start()
            self.t0 = time.time_ns()
        if not self.enabled:
            return
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        self._sync()
        self.t0 = time.time_ns()

    def tick(self, units: int, force: bool = False) -> None:
        """Units (calls, steps, program calls) done since the window began."""
        if self.clock is not None and force:
            self._sync()
            self.device_busy_s = self.clock.stop(self.t0, time.time_ns())
            self.clock = None
        if self.prof is None or self.view is not None:
            return
        if force or (time.time_ns() - self.t0) / 1e9 >= self.seconds:
            self._sync()
            t1 = time.time_ns()
            self.prof.__exit__(None, None, None)
            self.units = units
            self.view = TraceView(self.prof, self.t0, t1)
            self.prof = None
            self.stopped = time.perf_counter()

    def untraced(self, units: int, t0: float, t_end: float) -> dict:
        """The units and seconds of the window after the profile stopped
        (all of it without one): rates there carry no profiler overhead."""
        start = self.stopped if self.stopped is not None else t0
        return {"rest_units": units - self.units, "rest_s": t_end - start}


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def busy_ns(intervals: List[Tuple[int, int]], t0: int, t1: int) -> int:
    """Nanoseconds of [t0, t1] that the intervals cover, overlaps once."""
    return sum(e - s for s, e in _union([(max(s, t0), min(e, t1)) for s, e in intervals if min(e, t1) > max(s, t0)]))


class TraceView:
    """Device and host events of the traced window [t0, t1] (ns)."""

    def __init__(self, prof, t0: int, t1: int):
        self.t0, self.t1 = t0, t1
        self.device: List[Tuple[int, int, str]] = []
        self.host: List[Tuple[int, int, str]] = []
        events = prof.profiler.kineto_results.events()
        # a span opened on the host (record_function) is mirrored onto the
        # device's timeline under its own name: that is not device work
        spans = {e.name() for e in events if e.device_type() == torch.autograd.DeviceType.CPU and e.is_user_annotation()}
        for e in events:
            s = e.start_ns()
            end = s + e.duration_ns()
            if end < t0 or s > t1:
                continue
            on_device = e.device_type() != torch.autograd.DeviceType.CPU
            if on_device and (e.name() in spans or e.is_user_annotation()):
                continue
            (self.device if on_device else self.host).append((s, end, e.name()))
        self.busy = _union([(max(s, t0), min(e, t1)) for s, e, _ in self.device])

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) / 1e9

    @property
    def launches(self) -> int:
        return len(self.device)

    def device_s(self, patterns: Sequence[str]) -> float:
        """Device seconds of the operations whose names contain a pattern."""
        return sum(e - s for s, e, n in self.device if any(p in n for p in patterns)) / 1e9

    def top_ops(self, k: int = 10) -> List[List]:
        by: Dict[str, int] = {}
        for s, e, n in self.device:
            by[n] = by.get(n, 0) + (e - s)
        return [[n[:120], t / 1e9] for n, t in sorted(by.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10) -> List[List]:
        """The k longest stretches with no device activity, each named by the
        shortest host operation that spans its middle."""
        edges = [self.t0] + [x for iv in self.busy for x in iv] + [self.t1]
        gaps = sorted(((edges[i + 1] - edges[i], edges[i]) for i in range(0, len(edges) - 1, 2)
                       if edges[i + 1] > edges[i]), reverse=True)[:k]
        out = []
        for length, start in gaps:
            mid = start + length // 2
            spans = [(e - s, n) for s, e, n in self.host if s <= mid <= e]
            out.append([min(spans)[1][:120] if spans else "(no host operation)", length / 1e9])
        return out
