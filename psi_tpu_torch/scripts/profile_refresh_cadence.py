"""The production fit at three refresh cadences, at the bench shapes. The
port's counterpart of ``scripts/profile_refresh_cadence.py``.

    python -m psi_tpu_torch.scripts.profile_refresh_cadence [--groups 8] [--reps 2]

``FitConfig.production(num_iter=20, refresh_every=r)`` for r in 10, 15 and
20 on bf16 grids, ``make_fit_step(want_metrics=False)``, with
``profile_fused``'s shapes, inputs and protocol (one warm-up call, then
``--groups`` groups of ``--reps`` calls on distinct body batches). A full
pass runs at iterations 0 and 4 and then every r-th iteration: 0, 4, 14 for
r=10; 0, 4, 19 for r=15; 0, 4 for r=20. K1/K2/K3 launch 20/20/6, 20/20/6
and 20/20/5 (K4/K5, the 'high' tier's, 0). Prints a table and one JSON line with ``psi_tpu``'s keys
(median_s, ms_per_iter, bodies_per_sec) per cadence and, beside them, the
group times, the launches, the peak device memory and the card's name and
power limit. Needs an NVIDIA card.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from psi_tpu_torch.scripts.profile_fused import (N_BODIES, NUM_ITER, bench_assets, expected_launches, fit_inputs,
                                                 time_fit)
from psi_tpu_torch.train.objective import SceneAssets
from psi_tpu_torch.utils.config import FitConfig
from psi_tpu_torch.utils.timing import card, nvidia_smi

CADENCES = (10, 15, 20)


def variants(assets_bf16: SceneAssets, num_iter: int = NUM_ITER) -> Dict[str, tuple]:
    """name -> (assets, FitConfig) for each cadence."""
    return {f"refresh{r}": (assets_bf16, FitConfig.production(num_iter=num_iter, refresh_every=r)) for r in CADENCES}


def run(dev, groups: int = 8, reps: int = 2, assets: Optional[SceneAssets] = None) -> Dict[str, Dict]:
    """Every cadence on ``dev``, on ``assets`` (bf16 grids) or ``bench_assets``'."""
    from psi_tpu_torch.fit.fitting import make_fit_step

    if assets is None:
        assets = bench_assets(dev, torch.bfloat16)
    xs, cam_ext, scene_idx = fit_inputs(np.random.default_rng(0), N_BODIES, groups * reps, dev)
    results = {}
    print(f"{'cadence':<12} {'median s':>9} {'ms/iter':>8} {'bodies/s':>9}  spread  K1/K2/K3/K4/K5", flush=True)
    for name, (a, cfg) in variants(assets).items():
        r = time_fit(make_fit_step(a, cfg, want_metrics=False), xs, cam_ext, scene_idx, groups, reps, NUM_ITER,
                     N_BODIES)
        r["expected_launches"] = list(expected_launches(cfg))
        results[name] = r
        print(f"{name:<12} {r['median_s']:9.4f} {r['ms_per_iter']:8.3f} {r['bodies_per_sec']:9.2f}  "
              f"[{min(r['group_s']):.4f}, {max(r['group_s']):.4f}]  "
              f"{'/'.join(str(v) for v in r['launches'].values())}", flush=True)
    return results


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--groups", type=int, default=8)
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args(argv)
    dev = card()
    smi = nvidia_smi()
    print(f"device: {torch.cuda.get_device_name(dev)}; nvidia-smi: {smi}", flush=True)
    results = run(dev, args.groups, args.reps)
    print(json.dumps({"card": smi, **results}), flush=True)
    return results


if __name__ == "__main__":
    main()
