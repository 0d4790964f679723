"""Fitting CLI — PROX-E and MP3D-R refinement entry points.

Port of ``psi_tpu.cli.fitting``. Reference surface: ``python
fitting_proxe.py <gen_path> <fit_path>`` (fitting_proxe.py:217-263, 4 test
scenes x <=1200 pkls, 20 iters) and ``fitting_habitat.py`` (7 rooms x
<=10000 pkls, 50 iters, contact denominator 1.0). Here each scene's whole
population is fitted by one ``FittingOP`` (chunks of 512 bodies). Runs on
the first NVIDIA card unless --device names another device.

  python -m psi_tpu_torch.cli.fitting <gen_path> <fit_path> \
      [--dataset proxe|habitat] [--proxe_path ... | --synthetic] [--device cpu]
"""

from __future__ import annotations

import argparse
import os


MP3D_ROOMS = ["17DRP5sb8fy-bedroom", "17DRP5sb8fy-familyroomlounge",
              "17DRP5sb8fy-livingroom", "X7HyMhZNoso-livingroom_16",
              "zsNo4HB9uLZ-bedroom0_0", "zsNo4HB9uLZ-livingroom0_13",
              "X7HyMhZNoso-16"]  # 7 rooms (test_habitat_s1.py / BASELINE.md)


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("gen_path", type=str)
    p.add_argument("fit_path", type=str)
    p.add_argument("--dataset", type=str, default="proxe", choices=["proxe", "habitat"])
    p.add_argument("--num_iter", type=int, default=None, help="default: 20 proxe / 50 habitat")
    p.add_argument("--max_files", type=int, default=None, help="default: 1200 proxe / 10000 habitat")
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument(
        "--refresh_every", type=int, default=10,
        help="selection-refresh schedule for the fit losses: full SDF "
        "gathers + NN search every N-th Adam iter, frozen-cell/frozen-"
        "correspondence math in between (1 = full loss every iteration)",
    )
    p.add_argument(
        "--lbs_precision", type=str, default="fused",
        choices=["high", "fast", "fused"],
        help="LBS tier inside the fit loss: 'fused' = one CUDA kernel "
        "for the whole vertex path (production default, bf16 class); "
        "'fast' = single-pass bf16 products; 'high' = split-bf16 parity "
        "grade (the reference-exact tier)",
    )
    p.add_argument(
        "--exact", action="store_true",
        help="reference-exact loss semantics: full NN search + real SDF "
        "gathers every iteration with 'high' LBS and f32 SDF grids "
        "(overrides --refresh_every/--lbs_precision)",
    )
    p.add_argument(
        "--prune_scene_points", type=int, default=2048,
        help="contact-NN candidate set size (0 = exact full-scene NN "
        "search; with --refresh_every 1 and 0 here the fit is fully "
        "reference-exact)",
    )
    from psi_tpu_torch.cli.common import add_asset_args

    add_asset_args(p)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    import torch

    from psi_tpu_torch.cli.common import build_assets, resolve_device
    from psi_tpu_torch.data.hdf5 import PROX_TEST_SCENES
    from psi_tpu_torch.fit.fitting import FittingOP
    from psi_tpu_torch.utils.config import FitConfig

    device = resolve_device(args.device)
    refresh_every = 1 if args.exact else args.refresh_every
    lbs_precision = "high" if args.exact else args.lbs_precision
    if args.dataset == "proxe":
        scenes = PROX_TEST_SCENES
        cfg = FitConfig(
            init_lr_h=args.lr,
            num_iter=args.num_iter or 20,
            contact_denom_offset=0.01,  # fitting_proxe.py:139
            weight_loss_rec=1.0, weight_loss_vposer=0.01,
            weight_contact=0.1, weight_collision=0.5,
            refresh_every=refresh_every,
            lbs_precision=lbs_precision,
            prune_scene_points=args.prune_scene_points,
        )
        max_files = args.max_files or 1200
    else:
        scenes = MP3D_ROOMS
        cfg = FitConfig(
            init_lr_h=args.lr,
            num_iter=args.num_iter or 50,  # fitting_habitat.py:253
            contact_denom_offset=1.0,  # fitting_habitat.py:141
            weight_loss_rec=1.0, weight_loss_vposer=0.01,
            weight_contact=0.1, weight_collision=0.5,
            refresh_every=refresh_every,
            lbs_precision=lbs_precision,
            prune_scene_points=args.prune_scene_points,
        )
        max_files = args.max_files or 10000

    # the active numerics, visible at startup: the default is the
    # approximate production stack, not the reference-exact one (psi_tpu's
    # banner, word for word). --exact still prunes the contact candidates
    # unless --prune_scene_points 0.
    if args.exact:
        print("[INFO] fit mode: EXACT (reference-exact loss semantics: "
              "every-iteration full loss, f32 SDF grids, high LBS precision)")
    else:
        print(f"[INFO] fit mode: PRODUCTION (approximate: refresh_every="
              f"{refresh_every}, lbs_precision={lbs_precision}, bf16 packed "
              f"SDF grids; protocol-validated vs --exact in EVAL_SYNTH.md)")

    # the production stack pairs the refresh schedule with bf16 packed SDF
    # grids (half the gather bytes); --exact keeps the f32 grids
    assets, registry = build_assets(
        args, scene_names=scenes if not args.synthetic else None,
        sdf_dtype=None if args.exact else torch.bfloat16, device=device,
    )

    # Habitat bodies live in the habitat world frame; the reference right-
    # composes a y/z flip into the extrinsics before every loss transform
    # (fitting_habitat.py:177-184). PROX-E uses cam_ext as-is.
    cam_post = None
    if args.dataset == "habitat":
        from psi_tpu_torch.data.matfile import HABITAT_T_MAT

        cam_post = HABITAT_T_MAT

    total = 0
    for si, scene in enumerate(scenes):
        gen_dir = os.path.join(args.gen_path, scene)
        if not os.path.isdir(gen_dir):
            continue
        scene_idx = registry.index_of(scene) if scene in registry.names else si % registry.num_scenes
        op = FittingOP(assets, cfg, scene_idx=scene_idx, cam_post=cam_post, device=device)
        n = op.fitting_files(gen_dir, os.path.join(args.fit_path, scene), max_files=max_files)
        print(f"[INFO] {scene}: fitted {n} bodies")
        total += n
    print(f"[INFO] fitting finish: {total} bodies total")


if __name__ == "__main__":
    main()
