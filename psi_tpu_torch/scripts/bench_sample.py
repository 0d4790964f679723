"""Sampling-latency bench (encode-once population sampling).

The port's counterpart of ``scripts/bench_sample.py``: ``generate_bodies``
at N=256 for one snapshot and ``generate_bodies_rows`` at N=256 rows over
R=16 snapshots, each over REPS=60 distinct inputs after a warm-up call, the
host clock around all the calls and a ``torch.cuda.synchronize()``.

    python -m psi_tpu_torch.scripts.bench_sample

Needs an NVIDIA card.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from psi_tpu_torch.gen.sample import generate_bodies, generate_bodies_rows
from psi_tpu_torch.models.cvae_s1 import HumanCVAES1
from psi_tpu_torch.utils.init import seeded_init_
from psi_tpu_torch.utils.timing import card

N, R, REPS = 256, 16, 60


def _timed(calls) -> float:
    """Seconds a call of ``calls`` (a list of thunks), the first one a warm-up."""
    calls[0]()
    torch.cuda.synchronize()
    t0 = time.time()
    for c in calls[1:]:
        c()
    torch.cuda.synchronize()
    return (time.time() - t0) / (len(calls) - 1)


def main() -> dict:
    dev = card()
    mdl = seeded_init_(HumanCVAES1(latentD=256), 0).eval().to(dev)
    rng = np.random.RandomState(0)
    cam_int = torch.from_numpy(np.eye(3, dtype=np.float32)[None] * 500).to(dev)
    max_d = torch.tensor([6.0], dtype=torch.float32, device=dev)
    gen = lambda seed: torch.Generator(device=dev).manual_seed(seed)

    xs_all = torch.from_numpy(rng.randn(REPS + 1, 1, 128, 128, 2).astype(np.float32)).to(dev)
    dt = _timed([lambda i=i: generate_bodies(mdl, xs_all[i], cam_int, max_d, N, generator=gen(1 + i))
                 for i in range(REPS + 1)])
    print(f"generate_bodies ({N} bodies, 1 snapshot): {dt * 1e3:.1f} ms  [total {dt * REPS:.1f}s]", flush=True)

    cam_stack = cam_int.expand(R, 3, 3)
    max_stack = torch.full((R,), 6.0, dtype=torch.float32, device=dev)
    ridx = torch.from_numpy(np.arange(N) % R).to(dev)
    stacks = torch.from_numpy(rng.randn(REPS + 1, R, 128, 128, 2).astype(np.float32)).to(dev)
    dt_rows = _timed([lambda i=i: generate_bodies_rows(mdl, stacks[i], cam_stack, max_stack, ridx,
                                                       generator=gen(9 + i)) for i in range(REPS + 1)])
    print(f"generate_bodies_rows ({N} rows, {R} snapshots): {dt_rows * 1e3:.1f} ms  "
          f"[total {dt_rows * REPS:.1f}s]", flush=True)
    return {"generate_bodies_ms": dt * 1e3, "generate_bodies_rows_ms": dt_rows * 1e3}


if __name__ == "__main__":
    main()
