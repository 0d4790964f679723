"""Shared CLI plumbing: the device, and asset construction from real paths
or synthetic.

Port of ``psi_tpu.cli.common``. The reference hardcodes cluster paths in
each script (train_s1.py:374-423); here every entry point takes
--proxe_path / --human_model_path / --vposer_ckpt_path and falls back to
synthetic fixtures (--synthetic) so the full pipeline runs without the
licensed PROX / SMPL-X downloads. Every entry point runs on the first
NVIDIA card unless --device names another device, and fails without one.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Tuple

import numpy as np
import torch

from psi_tpu_torch.data.scenes import SceneRegistry, load_scene_registry
from psi_tpu_torch.data.synthetic import make_assets, make_synthetic_assets
from psi_tpu_torch.geometry.contact import DEFAULT_CONTACT_PARTS, get_contact_ids
from psi_tpu_torch.train.objective import SceneAssets


def add_asset_args(p: argparse.ArgumentParser):
    p.add_argument("--proxe_path", type=str, default=None, help="PROXE dataset root")
    p.add_argument("--human_model_path", type=str, default=None, help="dir containing smplx/SMPLX_NEUTRAL.npz")
    p.add_argument("--vposer_ckpt_path", type=str, default=None, help="VPoser checkpoint dir or converted npz")
    p.add_argument("--synthetic", action="store_true", help="run on synthetic assets (no real data needed)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device to run on (default: the first NVIDIA card; an error "
                   "without one; 'cpu' runs every kernel's plain version)")
    return p


def resolve_device(name: Optional[str]) -> torch.device:
    """--device's value as a device; None is the first card, and an error
    without one."""
    if name is None:
        if not torch.cuda.is_available():
            raise SystemExit("no NVIDIA card: pass --device cpu to run on the CPU")
        return torch.device("cuda", 0)
    return torch.device(name)


def build_assets(args, scene_names=None, sdf_dtype=None, device=None) -> Tuple[SceneAssets, SceneRegistry]:
    """SceneAssets (on ``device``, default --device's) + registry from real
    paths, else synthetic.

    sdf_dtype: pack the SDF corner grid in this dtype (the production
    fit stack passes torch.bfloat16 — half the gather bytes; None = f32)."""
    device = device if device is not None else resolve_device(getattr(args, "device", None))
    if args.synthetic or args.proxe_path is None:
        return make_synthetic_assets(
            num_verts=10475, num_joints=55, num_scenes=len(scene_names or []) or 4,
            sdf_dim=64, scene_points=20000, n_contact=1455, sdf_dtype=sdf_dtype, device=device,
        )

    from psi_tpu_torch.body.smplx_model import load_smplx_npz
    from psi_tpu_torch.data.hdf5 import PROX_SCENES
    from psi_tpu_torch.utils.convert_torch import load_vposer

    smplx = load_smplx_npz(os.path.join(args.human_model_path, "smplx", "SMPLX_NEUTRAL.npz"))
    vposer = load_vposer(args.vposer_ckpt_path)
    vids, _ = get_contact_ids(
        os.path.join(args.proxe_path, "body_segments"), DEFAULT_CONTACT_PARTS
    )
    names = scene_names or PROX_SCENES
    registry = load_scene_registry(
        os.path.join(args.proxe_path, "scenes_downsampled"),
        os.path.join(args.proxe_path, "scenes_sdf"),
        names,
    )
    return make_assets(smplx, vposer, np.asarray(vids, np.int32), registry,
                       sdf_dtype=sdf_dtype, device=device), registry
