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
    """Median device time of fn() in ms over ``reps`` launches (CUDA events),
    after one warm-up call."""
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


def card() -> torch.device:
    """cuda:0, or SystemExit when there is no card: a measurement never
    falls back to the CPU."""
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA card: torch.cuda.is_available() is False")
    return torch.device("cuda", 0)
