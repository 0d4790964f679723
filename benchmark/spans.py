"""The program's spans in the traced window: which phase the host was in
while the device idled, and the host's time a fit pass or a training step.

A fit that replays its CUDA graph opens one ``psi.fit.replay`` span in place
of its passes and their phases. The host then never enters a phase, so that
phase's idle share is nought (``fit_phase_idle_pct``), and the host's time a
pass is the replay's time over the passes it replays (``host_ms_per_pass``).

The program opens ``psi.*`` spans (``psi_tpu_torch/utils/profiling.py::span``)
while a profiler runs; ``TraceView`` keeps them in ``.host``. A phase's idle
share is the part of its spans, clipped to the window, in which the device's
busy union has nothing, over the window. Where one counted span lies inside another the time goes to the
innermost. The counted spans of a family are disjoint where the program runs
as the cells run it, so the shares of a family plus ``outside`` equal
``readers.idle_pct``. The host's time a unit is read under the profiler,
which adds its own cost to every operation: compare it between traced runs.
"""

from __future__ import annotations

import bisect
from typing import Callable, Dict, List, Optional, Sequence, Tuple

# the phases whose idle time each family's shares count
GENFIT = ("psi.sample", "psi.fit.decode", "psi.fit.contact", "psi.fit.collision", "psi.fit.backward",
          "psi.fit.adam")
TRAIN = ("psi.train.stage", "psi.train.forward", "psi.train.backward", "psi.train.optimizer")
# the span a replayed fit opens in place of its passes and their phases
REPLAY = "psi.fit.replay"
# the spans of one training step, in the order it opens them
STEP = TRAIN[1:]


class _Busy:
    """Busy nanoseconds of the device in any interval, from the sorted,
    disjoint busy union."""

    def __init__(self, busy: Sequence[Tuple[int, int]]):
        self.starts = [s for s, _ in busy]
        self.ends = [e for _, e in busy]
        self.before = [0]  # busy time of the intervals before index i
        for s, e in busy:
            self.before.append(self.before[-1] + e - s)

    def _until(self, x: int) -> int:
        i = bisect.bisect_right(self.starts, x)
        return 0 if i == 0 else self.before[i - 1] + min(x, self.ends[i - 1]) - self.starts[i - 1]

    def within(self, a: int, b: int) -> int:
        return self._until(b) - self._until(a)


def _clipped(t, keep: Callable[[str], bool]) -> List[Tuple[int, int, str]]:
    return [(max(s, t.t0), min(e, t.t1), n) for s, e, n in t.host if keep(n) and min(e, t.t1) > max(s, t.t0)]


def idle_shares(t, names: Sequence[str]) -> Optional[Dict[str, float]]:
    """Per cent of the window in which the device idled while the host was
    inside each named span that the window holds (innermost wins), and
    ``outside`` every one of them. None without device events."""
    if t is None or t.window_s <= 0 or not t.device:
        return None
    spans = _clipped(t, lambda n: n in names)
    busy = _Busy(t.busy)
    idle = {n: 0 for _, _, n in spans}
    edges = sorted({x for s, e, _ in spans for x in (s, e)})
    for a, b in zip(edges, edges[1:]):
        covering = [(s, s - e, n) for s, e, n in spans if s <= a and b <= e]
        if covering:  # the latest start, and of those the shortest, is the innermost
            idle[max(covering)[2]] += (b - a) - busy.within(a, b)
    out = {n: 100.0 * v / (t.t1 - t.t0) for n, v in idle.items()}
    out["outside"] = 100.0 * (1.0 - t.busy_s / t.window_s) - sum(out.values())
    return out


def idle_pct_in(ctx, family: Sequence[str], name: str) -> Optional[float]:
    """The idle share of one phase of a family; None where the trace holds
    no device events or no such span (a program that opens none)."""
    shares = idle_shares(ctx.trace, family)
    return shares.get(name) if shares is not None else None


def fit_phase_idle_pct(ctx, name: str) -> Optional[float]:
    """The idle share of one of the fit's phases: as ``idle_pct_in``, and 0
    where the window holds replayed fits and no span of the phase (the host
    was never in it)."""
    shares = idle_shares(ctx.trace, GENFIT)
    if shares is None:
        return None
    if name in shares:
        return shares[name]
    return 0.0 if _clipped(ctx.trace, lambda n: n == REPLAY) else None


def _inside(t, keep: Callable[[str], bool]) -> List[Tuple[int, int, str]]:
    """The spans ``keep`` selects that lie wholly inside the window, in time order."""
    return sorted((s, e, n) for s, e, n in t.host if keep(n) and t.t0 <= s and e <= t.t1)


def host_ms_per_pass(t, passes_per_replay: Optional[int] = None) -> Optional[float]:
    """Mean host milliseconds of the fit's passes (``psi.fit.pass.*``) that lie
    wholly inside the window. Where it holds none, and ``passes_per_replay``
    is given, the mean host milliseconds of its replayed fits
    (``psi.fit.replay``) over the passes each replays. None without device
    events or such spans."""
    if t is None or not t.device:
        return None
    took = [e - s for s, e, _ in _inside(t, lambda n: n.startswith("psi.fit.pass."))]
    if took:
        return sum(took) / len(took) / 1e6
    took = [e - s for s, e, _ in _inside(t, lambda n: n == REPLAY)]
    return sum(took) / len(took) / passes_per_replay / 1e6 if took and passes_per_replay else None


def host_ms_per_step(t) -> Optional[float]:
    """Mean host milliseconds of a training step (its ``STEP`` spans, in turn,
    summed) over the steps whose three spans lie wholly inside the window;
    None without device events or such steps."""
    if t is None or not t.device:
        return None
    steps, cur = [], None
    for s, e, n in _inside(t, lambda n: n in STEP):
        if n == STEP[0]:
            cur = [e - s]
        elif cur is not None and n == STEP[len(cur)]:
            cur.append(e - s)
        else:
            cur = None
        if cur is not None and len(cur) == len(STEP):
            steps.append(sum(cur))
            cur = None
    return sum(steps) / len(steps) / 1e6 if steps else None
