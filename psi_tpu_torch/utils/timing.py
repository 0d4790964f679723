"""Device timing and the card's identity, for the profiling entry points
and chip_smoke.py. Both need an NVIDIA card; neither falls back."""

from __future__ import annotations

import statistics
import subprocess

import torch


def nvidia_smi() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 10) -> float:
    """Median time of one fn() call in ms over ``reps`` calls, each between
    its own pair of CUDA events, after one warm-up call. The device reaches
    the first event at once and then waits for the host to enqueue fn's
    work, so for a kernel of a few microseconds this is mostly the host
    path of the call; ``cuda_device_ms`` gives the device's time alone."""
    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def cuda_device_ms(fn, calls: int = 20, reps: int = 10) -> float:
    """Device time of one fn() in ms with the host taken out: ``calls``
    calls of fn are captured into one CUDA graph after a warm-up call, and
    the median time of ``reps`` replays, each between one pair of CUDA
    events, is divided by ``calls``. A replay enqueues nothing from Python
    between fn's kernels, so what is left is each kernel's run and the
    device's own gap between dependent launches. fn must be capturable: it
    launches on the current stream and does not synchronise."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def card() -> torch.device:
    """cuda:0, or SystemExit when there is no card: a measurement never
    falls back to the CPU."""
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA card: torch.cuda.is_available() is False")
    return torch.device("cuda", 0)
