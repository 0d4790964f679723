"""Synthetic data fixtures: asset bundles and batches.

Port of ``psi_tpu.data.synthetic``. The body model, contact ids and
scenes come from the same numpy draws as psi_tpu's; the VPoser weights
are seeded torch draws (``body.vposer.synthetic_vposer``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from psi_tpu_torch.body.smplx_model import SMPLXModel, synthetic_smplx
from psi_tpu_torch.body.vposer import VPoser, synthetic_vposer
from psi_tpu_torch.data.scenes import SceneRegistry, synthetic_scene_registry
from psi_tpu_torch.geometry.contact import synthetic_contact_ids
from psi_tpu_torch.geometry.rot6d import aa_to_matrix
from psi_tpu_torch.ops.sdf import pack_sdf_corners
from psi_tpu_torch.train.objective import SceneAssets


def make_assets(
    smplx: SMPLXModel,
    vposer: VPoser,
    contact_vids: np.ndarray,
    registry: SceneRegistry,
    sdf_dtype: Optional[torch.dtype] = None,
    device="cpu",
) -> SceneAssets:
    """Move a registry to ``device`` and corner-pack its SDF grids there.
    sdf_dtype: store the packed grid in this dtype (torch.bfloat16 in
    production: half the bytes; the lerp still accumulates in f32)."""
    sdf = torch.from_numpy(registry.sdf_stack).to(device)
    packed = pack_sdf_corners(sdf)
    del sdf
    if sdf_dtype is not None:
        packed = packed.to(sdf_dtype)
    return SceneAssets(
        smplx=smplx.to(device),
        vposer=vposer.to(device),
        contact_vids=torch.from_numpy(np.asarray(contact_vids, np.int64)).to(device),
        sdf_packed=packed,
        grid_mins=torch.from_numpy(registry.grid_mins).to(device),
        grid_maxs=torch.from_numpy(registry.grid_maxs).to(device),
        scene_verts=torch.from_numpy(registry.verts_stack).to(device),
    )


def make_synthetic_assets(
    num_verts: int = 10475,
    num_joints: int = 55,
    num_scenes: int = 4,
    sdf_dim: int = 32,
    scene_points: int = 2000,
    n_contact: int = 1024,
    seed: int = 0,
    sdf_dtype: Optional[torch.dtype] = None,
    device="cpu",
) -> Tuple[SceneAssets, SceneRegistry]:
    smplx = synthetic_smplx(num_verts=num_verts, num_joints=num_joints, seed=seed)
    vposer = synthetic_vposer(seed=seed)
    contact = synthetic_contact_ids(num_verts, n_contact=n_contact, seed=seed)
    registry = synthetic_scene_registry(
        num_scenes=num_scenes, dim=sdf_dim, num_verts=scene_points, seed=seed
    )
    return make_assets(smplx, vposer, contact, registry, sdf_dtype=sdf_dtype, device=device), registry


def random_body_batch(rng: np.random.Generator, batch_size: int, max_d: np.ndarray) -> np.ndarray:
    """[B, 72] body vectors with positive camera-frame depth."""
    xh = (rng.normal(size=(batch_size, 72)) * 0.3).astype(np.float32)
    xh[:, 2] = rng.uniform(0.5, 0.9, batch_size).astype(np.float32) * max_d
    return xh


def random_camera_batch(rng: np.random.Generator, batch_size: int):
    cam_int = np.zeros((batch_size, 3, 3), np.float32)
    cam_int[:, 0, 0] = rng.uniform(500, 1100, batch_size)
    cam_int[:, 1, 1] = rng.uniform(500, 1100, batch_size)
    cam_int[:, 0, 2] = rng.uniform(250, 550, batch_size)
    cam_int[:, 1, 2] = rng.uniform(250, 550, batch_size)
    cam_int[:, 2, 2] = 1.0

    cam_ext = np.tile(np.eye(4, dtype=np.float32), (batch_size, 1, 1))
    aa = rng.normal(0, 0.3, size=(batch_size, 3)).astype(np.float32)
    cam_ext[:, :3, :3] = aa_to_matrix(torch.from_numpy(aa)).numpy()
    cam_ext[:, :3, 3] = rng.normal(0, 0.5, size=(batch_size, 3))
    return cam_ext, cam_int


class SyntheticBatchGenerator:
    """Random snapshot batches (numpy), drawn exactly as psi_tpu draws them."""

    def __init__(self, num_scenes: int = 4, batches_per_epoch: int = 4, seed: int = 0, image_size: int = 128):
        self.num_scenes = num_scenes
        self.batches_per_epoch = batches_per_epoch
        self.image_size = image_size
        self._rng = np.random.default_rng(seed)
        self._count = 0

    def reset(self):
        self._count = 0

    def has_next_batch(self) -> bool:
        return self._count < self.batches_per_epoch

    def next_batch(self, batch_size: int) -> Optional[Dict[str, np.ndarray]]:
        if not self.has_next_batch():
            return None
        self._count += 1
        rng = self._rng
        s = self.image_size
        max_d = rng.uniform(4.0, 6.0, batch_size).astype(np.float32)
        cam_ext, cam_int = random_camera_batch(rng, batch_size)
        return {
            "xs": rng.uniform(-1, 1, size=(batch_size, s, s, 2)).astype(np.float32),
            "xh": random_body_batch(rng, batch_size, max_d),
            "cam_ext": cam_ext,
            "cam_int": cam_int,
            "max_d": max_d,
            "scene_idx": rng.integers(0, self.num_scenes, batch_size).astype(np.int32),
        }
