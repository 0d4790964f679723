"""End-to-end demo (equivalent of the reference's demo.ipynb, runnable
headless): synthetic scene -> stage-1 CVAE sampling -> SMPL-X decode ->
scene-aware fitting -> eval scores -> rendered PNG.

The port's counterpart of ``demo.py``:

    python -m psi_tpu_torch.scripts.demo [--out demo_out] [--n_samples 16] [--device cpu]

Runs on the first NVIDIA card unless --device names another device (an
error without a card). The fit is ``FitConfig.production(num_iter=20)``
through ``fit_bodies``: on the card it launches the fused skinning kernels
(K1 forward, K2 backward) and the chamfer argmin (K3).
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np
import torch

from psi_tpu_torch.body.decode import body_vec_to_verts
from psi_tpu_torch.data.synthetic import SyntheticBatchGenerator, make_synthetic_assets
from psi_tpu_torch.eval.collision import collision_contact_scores
from psi_tpu_torch.eval.diversity import diversity_metrics
from psi_tpu_torch.fit.fitting import fit_bodies
from psi_tpu_torch.gen.sample import generate_bodies
from psi_tpu_torch.models.cvae_s1 import HumanCVAES1
from psi_tpu_torch.utils.config import FitConfig
from psi_tpu_torch.utils.init import seeded_init_
from psi_tpu_torch.utils.tools import resolve_device
from psi_tpu_torch.viz.colors import BODY_COLORS, mpcat40_color
from psi_tpu_torch.viz.show_results import render_color, write_png

RENDERED_BODIES = 4  # bodies drawn into the PNG


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="demo_out")
    ap.add_argument("--n_samples", type=int, default=16)
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: the first NVIDIA card; an error without one)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device, "the demo")
    os.makedirs(args.out, exist_ok=True)

    print("[1/5] building assets (synthetic SMPL-X + scenes)...")
    assets, registry = make_synthetic_assets(
        num_verts=10475, num_joints=55, num_scenes=2, sdf_dim=48, scene_points=5000, n_contact=1024, device=dev
    )

    print("[2/5] sampling bodies from the stage-1 CVAE...")
    model = seeded_init_(HumanCVAES1(latentD=256), 0).eval().to(dev)
    b = SyntheticBatchGenerator(num_scenes=2, batches_per_epoch=1, seed=0).next_batch(1)
    on = lambda a: torch.from_numpy(a).to(dev)
    x72 = generate_bodies(model, on(b["xs"]), on(b["cam_int"]), on(b["max_d"]), args.n_samples,
                          generator=torch.Generator(device=dev).manual_seed(1))
    print(f"    sampled {x72.shape[0]} bodies")

    print("[3/5] scene-aware fitting (20 Adam iters)...")
    cam_ext = on(np.tile(b["cam_ext"][0][None], (args.n_samples, 1, 1)))
    scene_idx = torch.zeros(args.n_samples, dtype=torch.int64, device=dev)
    # the production fit stack (refresh blocks + fused skinning), the
    # config every CLI defaults to; FitConfig.exact() for parity
    x_fit, _, hist = fit_bodies(assets, x72, cam_ext, scene_idx, FitConfig.production(num_iter=20))
    loss0, loss_last = hist[0].mean().item(), hist[-1].mean().item()
    print(f"    loss {loss0:.4f} -> {loss_last:.4f}")

    print("[4/5] evaluation...")
    nc, ct = collision_contact_scores(assets, x_fit, cam_ext, scene_idx)
    ent, md = diversity_metrics(x_fit, k=min(8, args.n_samples))
    print(f"    non-collision={nc:.3f} contact={ct:.3f} diversity entropy={ent:.3f}")

    print("[5/5] rendering...")
    scene_pts = registry.verts_stack[0, : registry.n_verts[0]]
    scene_colors = mpcat40_color(np.full(len(scene_pts), 5))
    with torch.no_grad():
        verts, _ = body_vec_to_verts(assets.smplx, assets.vposer, x_fit, cam_ext)
    verts = verts.cpu().numpy()
    view = np.eye(4, dtype=np.float32)
    view[:3, 3] = [0, 0, 8.0]
    cam_int = np.array([[400, 0, 320], [0, 400, 240], [0, 0, 1]], np.float32)
    # psi_tpu's demo draws bodies 0-3; JAX clamps an index past the end to the
    # last body, so with fewer samples its image is this one
    shown = [verts[i] for i in range(min(RENDERED_BODIES, len(verts)))]
    all_pts = np.concatenate([scene_pts] + shown, axis=0)
    all_col = np.concatenate([scene_colors] + [np.tile(BODY_COLORS["blue"], (len(v), 1)) for v in shown], axis=0)
    img = render_color(all_pts, all_col, cam_int, 480, 640, cam_ext=view, device=dev)
    out = write_png(os.path.join(args.out, "demo_bodies.png"), img)
    print(f"    wrote {out}")
    print("done.")
    return {"loss": (loss0, loss_last), "non_collision": nc, "contact": ct, "entropy": ent, "mean_dist": md,
            "png": out, "x_fit": x_fit}


if __name__ == "__main__":
    main()
