"""Camera-aware transforms of the global body translation and vertices.

Port of ``psi_tpu.geometry.camera`` (reference source/cvae.py:141-199).
``normalize_global_T`` maps the metric camera-frame translation to the
normalised box the CVAE works in; ``recover_global_T`` is its inverse.
"""

from __future__ import annotations

import torch


def _intrinsics_scale(cam_int: torch.Tensor):
    """fx, fy and the reference's s_ = 1/max(px, py) per batch element."""
    fx = cam_int[..., 0, 0]
    fy = cam_int[..., 1, 1]
    px = cam_int[..., 0, 2]
    py = cam_int[..., 1, 2]
    return fx, fy, 1.0 / torch.maximum(px, py)


def normalize_global_T(x: torch.Tensor, cam_int: torch.Tensor, max_depth: torch.Tensor) -> torch.Tensor:
    """Perspective-normalise x[:, :3]; cam_int [B, 3, 3], max_depth [B]."""
    t = x[..., :3]
    fx, fy, s = _intrinsics_scale(cam_int)
    z_raw = t[..., 2]
    nx = s * t[..., 0] * fx / (z_raw + 1e-6)
    ny = s * t[..., 1] * fy / (z_raw + 1e-6)
    nz = 2.0 * z_raw / max_depth - 1.0
    return torch.cat([torch.stack([nx, ny, nz], dim=-1), x[..., 3:]], dim=-1)


def recover_global_T(x: torch.Tensor, cam_int: torch.Tensor, max_depth: torch.Tensor) -> torch.Tensor:
    """Inverse of normalize_global_T (reference source/cvae.py:152-172)."""
    t = x[..., :3]
    fx, fy, s = _intrinsics_scale(cam_int)
    z = (t[..., 2] + 1.0) / 2.0 * max_depth
    X = t[..., 0] * z / s / fx
    Y = t[..., 1] * z / s / fy
    return torch.cat([torch.stack([X, Y, z], dim=-1), x[..., 3:]], dim=-1)


def verts_transform(verts: torch.Tensor, cam_ext: torch.Tensor) -> torch.Tensor:
    """Apply homogeneous 4x4 extrinsics: verts [B, V, 3], cam_ext [B, 4, 4]."""
    ones = torch.ones(verts.shape[:-1] + (1,), dtype=verts.dtype, device=verts.device)
    homo = torch.cat([verts, ones], dim=-1)  # [B, V, 4]
    return torch.einsum("bvi,bji->bvj", homo, cam_ext)[..., :3]
