"""The two timers of psi_tpu_torch.utils.timing, on a stubbed device clock.

On the CPU there is no card, so the CUDA events, the graph and its capture
are replaced by stand-ins that keep one simulated clock: a call of the
timed function costs the host HOST ms before its work reaches the device
and the device DEVICE ms to run it; a graph replay costs the host nothing.
What is checked is the timers' arithmetic: which spans they bracket, what
they divide by and which sample they report.
"""

import contextlib

import pytest
import torch

from psi_tpu_torch.utils import timing

torch.set_num_threads(1)


class _Card:
    """A device whose clock only moves when told to."""

    def __init__(self, host_ms, device_ms):
        self.now = 0.0
        self.host_ms, self.device_ms = host_ms, device_ms  # per call; device_ms may be a list, one per call
        self.capturing = None
        self.calls = 0

    def work(self):
        """The timed function: one launch."""
        cost = self.device_ms[self.calls % len(self.device_ms)] if isinstance(self.device_ms, list) else self.device_ms
        self.calls += 1
        if self.capturing is not None:
            self.capturing.append(cost)  # recorded, not run
        else:
            self.now += self.host_ms + cost

    def install(self, monkeypatch):
        card = self

        class Event:
            def __init__(self, enable_timing=False):
                self.at = None

            def record(self):
                self.at = card.now

            def synchronize(self):
                pass

            def elapsed_time(self, end):
                return end.at - self.at

        class Graph:
            def __init__(self):
                self.nodes = []

            def replay(self):
                card.now += sum(self.nodes)

        @contextlib.contextmanager
        def capture(graph):
            card.capturing = graph.nodes
            try:
                yield
            finally:
                card.capturing = None

        monkeypatch.setattr(torch.cuda, "Event", Event)
        monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
        monkeypatch.setattr(torch.cuda, "graph", capture)
        monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)


def test_cuda_ms_brackets_one_call_host_path_included(monkeypatch):
    card = _Card(host_ms=0.030, device_ms=0.004)
    card.install(monkeypatch)
    assert timing.cuda_ms(card.work, reps=7) == pytest.approx(0.034)
    assert card.calls == 8  # one warm-up call and seven timed ones


def test_cuda_device_ms_leaves_the_host_out(monkeypatch):
    card = _Card(host_ms=0.030, device_ms=0.004)
    card.install(monkeypatch)
    assert timing.cuda_device_ms(card.work, calls=20, reps=5) == pytest.approx(0.004)
    assert card.calls == 21  # the warm-up call, then 20 captured once; replays call nothing


@pytest.mark.parametrize("calls", [1, 4, 20])
def test_cuda_device_ms_divides_the_replay_by_its_calls(monkeypatch, calls):
    # the captured launches differ: the replay's time is their sum, a call's its mean
    costs = [0.001, 0.002, 0.006, 0.003]
    card = _Card(host_ms=0.050, device_ms=costs)
    card.install(monkeypatch)
    captured = [costs[(1 + k) % 4] for k in range(calls)]  # call 0 is the warm-up
    assert timing.cuda_device_ms(card.work, calls=calls, reps=3) == pytest.approx(sum(captured) / calls)


def test_timers_report_the_median_sample(monkeypatch):
    # one slow call among five does not move the median
    card = _Card(host_ms=0.0, device_ms=[0.002, 0.002, 0.050, 0.002, 0.002, 0.002])
    card.install(monkeypatch)
    assert timing.cuda_ms(card.work, reps=5) == pytest.approx(0.002)


def test_card_refuses_a_machine_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs an NVIDIA card"):
        timing.card()
