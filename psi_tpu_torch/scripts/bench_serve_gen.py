"""End-to-end time of one engine request, generate-only and fitted.

The port's counterpart of ``scripts/bench_serve_gen.py``: the production
serving stack (``soak_serve.build_engine``: population 256, bf16 packed
grids, FitConfig.production(num_iter=20)), warmed, then 30 generate-only
and 8 fitted ``GenerationEngine.generate`` calls on fresh snapshots, host
clock around each batch of calls (every call ends in its copy to the host).

    python -m psi_tpu_torch.scripts.bench_serve_gen

Needs an NVIDIA card.
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch

from psi_tpu_torch.scripts.soak_serve import build_engine, make_snapshot
from psi_tpu_torch.utils.timing import card, nvidia_smi


def run(engine, reps_gen: int = 30, reps_fit: int = 8) -> dict:
    rng = np.random.default_rng(0)
    out = {}
    for fit, reps in ((False, reps_gen), (True, reps_fit)):
        t0 = time.time()
        for _ in range(reps):
            engine.generate(make_snapshot(rng, 6.0), fit=fit)
        dt = (time.time() - t0) / reps
        out["fit_ms" if fit else "generate_ms"] = dt * 1e3
        print(f"engine.generate(fit={fit}): {dt * 1e3:.2f} ms end-to-end  [total {dt * reps:.1f}s]", flush=True)
    return out


def main() -> None:
    dev = card()
    smi = nvidia_smi()
    print(f"device: {torch.cuda.get_device_name(dev)}; nvidia-smi: {smi}", flush=True)
    engine = build_engine(dev, tiny=False)
    warm = engine.warmup()
    print(f"warmup_s: {warm:.1f}", flush=True)
    print(json.dumps({"card": smi, "warmup_s": warm, **run(engine)}), flush=True)


if __name__ == "__main__":
    main()
