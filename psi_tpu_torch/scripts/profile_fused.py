"""Time the fit's LBS tiers in the production refresh schedule and in the
reference-exact tier, at the bench shapes. The port's counterpart of
``scripts/profile_fused.py``.

    python -m psi_tpu_torch.scripts.profile_fused [--groups 10] [--reps 2]

``make_fit_step(want_metrics=False)`` on synthetic assets (N=256 bodies,
10475 verts, 55 joints, 1455 contact verts, 4 scenes, 128^3 grids, 20k-point
clouds, 20 iterations), inputs drawn as ``psi_tpu`` draws them
(``random_body_batch`` and ``random_camera_batch`` from
``np.random.default_rng(0)``, a distinct body batch for every rep). Variants:

* on bf16 grids, ``FitConfig(refresh_every=10)`` at 'fast' and at 'fused'
  (``refresh10_fast``, ``refresh10_fused``);
* on f32 grids, the exact tier ``FitConfig(num_iter=20)`` at 'high', 'fast'
  and 'fused' (``exact_high``, ``exact_fast``, ``exact_fused``);
* ``exact_high_m20000``, this script's own addition: ``exact_high`` with
  ``prune_scene_points=0``, the fully exact NN search that
  ``FitConfig.exact()``'s docstring points to (K3 over the whole 20k cloud
  on every pass).

Each variant: one warm-up call, which also gives its launch counts and
peak device memory, then ``--groups`` groups of ``--reps`` calls, the host
clock around each group ending in ``torch.cuda.synchronize()``. Prints a
table and one JSON line with ``psi_tpu``'s keys per variant (median_s,
ms_per_iter, bodies_per_sec, group_s) and beside them the K1–K5 launches,
the peak device memory, the warm-up call's mean loss at iterations 0, 1 and
the last, and the card's name and power limit. Needs an NVIDIA card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from psi_tpu_torch.fit.fitting import fit_schedule
from psi_tpu_torch.train.objective import SceneAssets
from psi_tpu_torch.utils.config import FitConfig
from psi_tpu_torch.utils.timing import card, nvidia_smi

N_BODIES = 256
NUM_ITER = 20
ASSET_KW = dict(num_verts=10475, num_joints=55, num_scenes=4, sdf_dim=128, scene_points=20000, n_contact=1455,
                seed=0)
MAX_D = 5.0


def variants(assets_f32: SceneAssets, assets_bf16: SceneAssets,
             num_iter: int = NUM_ITER) -> Dict[str, Tuple[SceneAssets, FitConfig]]:
    """The six variants: name -> (assets, FitConfig)."""
    return {
        "refresh10_fast": (assets_bf16, FitConfig(num_iter=num_iter, refresh_every=10, lbs_precision="fast")),
        "refresh10_fused": (assets_bf16, FitConfig(num_iter=num_iter, refresh_every=10, lbs_precision="fused")),
        "exact_high": (assets_f32, FitConfig(num_iter=num_iter)),
        "exact_fast": (assets_f32, FitConfig(num_iter=num_iter, lbs_precision="fast")),
        "exact_fused": (assets_f32, FitConfig(num_iter=num_iter, lbs_precision="fused")),
        "exact_high_m20000": (assets_f32, FitConfig(num_iter=num_iter, prune_scene_points=0)),
    }


def expected_launches(cfg: FitConfig) -> Tuple[int, int, int, int, int]:
    """K1–K5 launches of one ``want_metrics=False`` call: the fused tier runs
    K1 and K2 once a pass, the 'high' tier K4 twice (pose correctives, blend)
    and K5 twice (their gradients) a pass, and every pass but a cheap one
    searches (K3)."""
    kinds = fit_schedule(cfg)
    fused = len(kinds) if cfg.lbs_precision == "fused" else 0
    high = 2 * len(kinds) if cfg.lbs_precision == "high" else 0
    return fused, fused, sum(k != "cheap" for k in kinds), high, high


def fit_inputs(rng: np.random.Generator, n: int, count: int, device) -> Tuple[List[torch.Tensor], torch.Tensor,
                                                                               torch.Tensor]:
    """``count`` body batches [n, 72], one camera batch and scene 0, drawn in
    ``psi_tpu``'s order: the cameras first, then the bodies."""
    from psi_tpu_torch.data.synthetic import random_body_batch, random_camera_batch

    cam_ext = torch.from_numpy(random_camera_batch(rng, n)[0]).to(device)
    scene_idx = torch.zeros(n, dtype=torch.int64, device=device)
    max_d = np.full((n,), MAX_D, np.float32)
    xs = [torch.from_numpy(random_body_batch(rng, n, max_d)).to(device) for _ in range(count)]
    return xs, cam_ext, scene_idx


def launch_counters(split: bool = True):
    """K1, K2, K3 and, with ``split``, the 'high' tier's K4 and K5."""
    from psi_tpu_torch.ops.chamfer import NN_ARGMIN
    from psi_tpu_torch.ops.fused_skinning import SKIN_BWD, SKIN_FWD
    from psi_tpu_torch.ops.precision import SPLIT_BWD, SPLIT_FWD

    return (SKIN_FWD, SKIN_BWD, NN_ARGMIN) + ((SPLIT_FWD, SPLIT_BWD) if split else ())


def time_fit(fit, xs, cam_ext, scene_idx, groups: int, reps: int, num_iter: int, n: int) -> Dict:
    """One warm-up call on xs[0] (its launches, peak memory and loss history),
    then ``groups`` x ``reps`` calls on xs[0..groups*reps-1]."""
    kernels = launch_counters()
    dev = cam_ext.device
    torch.cuda.synchronize(dev)
    for k in kernels:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    out, _, hist = fit(xs[0], cam_ext, scene_idx)
    torch.cuda.synchronize(dev)
    first_s = time.perf_counter() - t0
    rec = {"first_call_s": first_s, "launches": {k.name: k.launches for k in kernels},
           "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
           "loss_first": hist[0].mean().item(), "loss_second": hist[1].mean().item(),
           "loss_last": hist[-1].mean().item(),
           "out_shape": list(out.shape), "finite": bool(torch.isfinite(out).all())}
    dts, k = [], 0
    for _ in range(groups):
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fit(xs[k], cam_ext, scene_idx)[0]
            k += 1
        torch.cuda.synchronize(dev)
        dts.append((time.perf_counter() - t0) / reps)
    dt = statistics.median(dts)
    return {"median_s": dt, "ms_per_iter": dt / num_iter * 1e3, "bodies_per_sec": n / dt, "group_s": dts, **rec}


def bench_assets(dev, sdf_dtype=None) -> SceneAssets:
    """The bench shapes' synthetic assets on ``dev`` (f32 grids, or ``sdf_dtype``)."""
    from psi_tpu_torch.data.synthetic import make_synthetic_assets

    return make_synthetic_assets(**ASSET_KW, sdf_dtype=sdf_dtype, device=dev)[0]


def run(dev, groups: int = 10, reps: int = 2, assets: Optional[Tuple[SceneAssets, SceneAssets]] = None
        ) -> Dict[str, Dict]:
    """Every variant at the bench shapes on ``dev``; ``assets`` (f32, bf16)
    are ``bench_assets``' unless given."""
    from psi_tpu_torch.fit.fitting import make_fit_step

    assets_f32, assets_bf16 = (bench_assets(dev), bench_assets(dev, torch.bfloat16)) if assets is None else assets
    xs, cam_ext, scene_idx = fit_inputs(np.random.default_rng(0), N_BODIES, groups * reps, dev)
    results = {}
    print(f"{'variant':<18} {'median s':>9} {'ms/iter':>8} {'bodies/s':>9}  spread  K1/K2/K3/K4/K5  peak GB", flush=True)
    for name, (a, cfg) in variants(assets_f32, assets_bf16).items():
        fit = make_fit_step(a, cfg, want_metrics=False)
        r = time_fit(fit, xs, cam_ext, scene_idx, groups, reps, NUM_ITER, N_BODIES)
        r["expected_launches"] = list(expected_launches(cfg))
        results[name] = r
        print(f"{name:<18} {r['median_s']:9.4f} {r['ms_per_iter']:8.3f} {r['bodies_per_sec']:9.2f}  "
              f"[{min(r['group_s']):.4f}, {max(r['group_s']):.4f}]  "
              f"{'/'.join(str(v) for v in r['launches'].values())}  {r['peak_gb']:.4f}", flush=True)
    return results


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--groups", type=int, default=10)
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
