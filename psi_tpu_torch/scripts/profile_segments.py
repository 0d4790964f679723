"""The production fit's cost by pass kind: 20 iterations of each segment
alone at the bench shapes. The port's counterpart of
``scripts/profile_segments.py``.

    python -m psi_tpu_torch.scripts.profile_segments [fused|fast|high]

For one LBS tier (``FitConfig.production(num_iter=20, lbs_precision=tier)``
on bf16 grids), each segment is 20 Adam steps (``fit.fitting.Adam``) of one
pass kind through ``fit.fitting._per_body_losses``:

* ``decode_only`` — the decode chain alone (VPoser, kinematic tree, LBS and
  camera), its vertices consumed by a real cotangent (sum x 1e-3);
* ``cheap`` — contact against frozen correspondences, collision against
  the frozen cell cache: no search, no gather;
* ``nn_only`` — a fresh NN search (K3), collision against the cache;
* ``full`` — a fresh NN search and a real packed-SDF gather.

As in ``psi_tpu``, the frozen correspondences and cell cache are zeros: a
segment measures cost, not a fit. Inputs are ``profile_fused``'s (N=256, the
rng of seed 0). Each segment: one warm-up call, which gives its K1–K5
launches, then 5 calls on other body batches, the host clock around them
ending in ``torch.cuda.synchronize()``. Prints s a call and ms an iteration
per segment, and one JSON line with the card's name and power limit. Needs
an NVIDIA card.
"""

from __future__ import annotations

import json
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from psi_tpu_torch.scripts.profile_fused import N_BODIES, NUM_ITER, bench_assets, fit_inputs, launch_counters
from psi_tpu_torch.train.objective import SceneAssets
from psi_tpu_torch.utils.config import FitConfig
from psi_tpu_torch.utils.timing import card, nvidia_smi

# name -> (fresh_nn, fresh_sdf, decode_only)
SEGMENTS = {
    "decode_only": (False, False, True),
    "cheap": (False, False, False),
    "nn_only": (True, False, False),
    "full": (True, True, False),
}
REPS = 5


def build(assets: SceneAssets, cfg: FitConfig, fresh_nn: bool, fresh_sdf: bool, decode_only: bool = False,
          num_iter: int = NUM_ITER) -> Callable:
    """run(x72_init [N, 72], cam_ext [N, 4, 4], scene_idx [N], y_nn [N, C, 3],
    cache (corners [N, V, 8], base [N, V, 3])) -> xhr [N, 75] after
    ``num_iter`` Adam steps of one pass kind against the given frozen state."""
    from psi_tpu_torch.body.decode import body_vec_to_verts
    from psi_tpu_torch.body.smplx_model import make_fused_bundle
    from psi_tpu_torch.fit.fitting import Adam, _per_body_losses
    from psi_tpu_torch.geometry.bodyvec import convert_to_3D_rot, convert_to_6D_rot
    from psi_tpu_torch.utils.precision import strict_f32

    def run(x72_init, cam_ext, scene_idx, y_nn, cache):
        scene_idx = scene_idx.to(torch.int64)
        with strict_f32(), torch.no_grad():
            xhr = convert_to_6D_rot(x72_init)
            xhr_init = xhr
            fb = make_fused_bundle(assets.smplx) if cfg.lbs_precision == "fused" else None

            def loss_fn(x):
                if decode_only:
                    v = body_vec_to_verts(assets.smplx, assets.vposer, convert_to_3D_rot(x), cam_ext,
                                          precision=cfg.lbs_precision, fused_bundle=fb)[0]
                    return torch.sum(v * 1e-3)
                return _per_body_losses(assets, x, xhr_init, cam_ext, scene_idx, cfg, (y_nn, cache),
                                        fresh_nn, fresh_sdf, fb)[0]

            adam = Adam(xhr, cfg.init_lr_h)
            for _ in range(num_iter):
                x = xhr.detach().requires_grad_(True)
                with torch.enable_grad():
                    (g,) = torch.autograd.grad(loss_fn(x), x)
                xhr = adam.step(xhr, g)
            return xhr

    return run


def frozen_state(assets: SceneAssets, n: int):
    """Zero correspondences [n, C, 3] and a zero cell cache in the grid's dtype."""
    dev = assets.sdf_packed.device
    n_contact, n_verts = int(assets.contact_vids.shape[0]), assets.smplx.num_verts
    y_nn = torch.zeros((n, n_contact, 3), dtype=torch.float32, device=dev)
    cache = (torch.zeros((n, n_verts, 8), dtype=assets.sdf_packed.dtype, device=dev),
             torch.zeros((n, n_verts, 3), dtype=torch.float32, device=dev))
    return y_nn, cache


def run(dev, tier: str = "fused", assets: Optional[SceneAssets] = None, reps: int = REPS) -> Dict[str, Dict]:
    """Every segment at ``tier`` on ``dev``, on ``assets`` (bf16 grids) or
    ``profile_fused.bench_assets``', timed over ``reps`` calls after the warm-up."""
    cfg = FitConfig.production(num_iter=NUM_ITER, lbs_precision=tier)
    if assets is None:
        assets = bench_assets(dev, torch.bfloat16)
    xs, cam_ext, scene_idx = fit_inputs(np.random.default_rng(0), N_BODIES, 4, dev)
    y_nn, cache = frozen_state(assets, N_BODIES)
    kernels = launch_counters()
    results = {}
    print(f"tier={tier}")
    print(f"{'segment':<12} {'s/run':>8} {'ms/iter':>8}  K1/K2/K3/K4/K5", flush=True)
    for name, (fresh_nn, fresh_sdf, decode_only) in SEGMENTS.items():
        fn = build(assets, cfg, fresh_nn, fresh_sdf, decode_only)
        torch.cuda.synchronize(dev)
        for k in kernels:
            k.launches = 0
        fn(xs[0], cam_ext, scene_idx, y_nn, cache)
        torch.cuda.synchronize(dev)
        launches = {k.name: k.launches for k in kernels}
        t0 = time.perf_counter()
        for i in range(reps):
            fn(xs[1 + i % 3], cam_ext, scene_idx, y_nn, cache)
        torch.cuda.synchronize(dev)
        dt = (time.perf_counter() - t0) / reps
        results[name] = {"s_per_run": dt, "ms_per_iter": dt / NUM_ITER * 1e3, "launches": launches}
        print(f"{name:<12} {dt:8.4f} {dt / NUM_ITER * 1e3:8.3f}  {'/'.join(str(v) for v in launches.values())}",
              flush=True)
    return results


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Dict]:
    args: List[str] = list(sys.argv[1:] if argv is None else argv)
    tier = args[0] if args else "fused"
    if tier not in ("fused", "fast", "high"):
        raise SystemExit(f"tier must be fused, fast or high, not {tier!r}")
    dev = card()
    smi = nvidia_smi()
    print(f"device: {torch.cuda.get_device_name(dev)}; nvidia-smi: {smi}", flush=True)
    results = run(dev, tier)
    print(json.dumps({"card": smi, "tier": tier, **results}), flush=True)
    return results


if __name__ == "__main__":
    main()
