"""Packed trilinear SDF lookups — the fit loss's collision term.

Port of the packed half of ``psi_tpu.ops.sdf``. The scene SDF grids are
stored corner-packed, [S, D, H, W, 8]: each cell's 2x2x2 corner block in
one row (channel dx*4 + dy*2 + dz), so a lookup is one row gather per
point. In psi_tpu these are XLA gathers, not Pallas kernels, so plain
torch (index + gather) is the port.

Coordinates follow the reference's grid_sample call (align_corners=False,
border clamp): world -> [-1, 1] -> voxel coords clamped to [0, size-1].
Gradients flow to the points through the fractional weights; the cell
index (floor) has none.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _unnormalize(coord: torch.Tensor, size: int) -> torch.Tensor:
    """[-1, 1] -> voxel coords (align_corners=False), clamped to the border."""
    c = ((coord + 1.0) * size - 1.0) / 2.0
    return torch.clamp(c, 0.0, float(size - 1))


def pack_sdf_corners(sdf_stack: torch.Tensor) -> torch.Tensor:
    """[S, D, H, W] -> [S, D, H, W, 8] corner rows (edge-clamped)."""
    out = []
    for dx in (0, 1):
        sx = torch.cat([sdf_stack[:, dx:], sdf_stack[:, -1:]], dim=1) if dx else sdf_stack
        for dy in (0, 1):
            sy = torch.cat([sx[:, :, dy:], sx[:, :, -1:]], dim=2) if dy else sx
            for dz in (0, 1):
                sz = torch.cat([sy[:, :, :, dz:], sy[:, :, :, -1:]], dim=3) if dz else sy
                out.append(sz)
    return torch.stack(out, dim=-1)


def _lerp8(c: torch.Tensor, wx: torch.Tensor, wy: torch.Tensor, wz: torch.Tensor) -> torch.Tensor:
    """Trilinear combine of corner rows c [..., 8] (channel dx*4 + dy*2 + dz)."""
    ux, uy, uz = 1 - wx, 1 - wy, 1 - wz
    c00 = c[..., 0] * uz + c[..., 1] * wz
    c01 = c[..., 2] * uz + c[..., 3] * wz
    c10 = c[..., 4] * uz + c[..., 5] * wz
    c11 = c[..., 6] * uz + c[..., 7] * wz
    c0 = c00 * uy + c01 * wy
    c1 = c10 * uy + c11 * wy
    return c0 * ux + c1 * wx


def _voxel_coords(points, scene_idx, grid_mins, grid_maxs, dims):
    """World points [B, N, 3] -> clamped voxel coords (cx, cy, cz), each [B, N]."""
    D, H, W = dims
    gmin = grid_mins[scene_idx][:, None, :]
    gmax = grid_maxs[scene_idx][:, None, :]
    norm = (points - gmin) / (gmax - gmin) * 2.0 - 1.0
    return (
        _unnormalize(norm[..., 0], D),
        _unnormalize(norm[..., 1], H),
        _unnormalize(norm[..., 2], W),
    )


def _gather_cells(sdf_packed, scene_idx, cx, cy, cz):
    """Corner rows [B, N, 8] (grid dtype) of each point's cell, and the
    floor coords (x0, y0, z0) as float."""
    S, D, H, W, _ = sdf_packed.shape
    x0, y0, z0 = torch.floor(cx), torch.floor(cy), torch.floor(cz)
    x0i = torch.clamp(x0.to(torch.int64), 0, D - 1)
    y0i = torch.clamp(y0.to(torch.int64), 0, H - 1)
    z0i = torch.clamp(z0.to(torch.int64), 0, W - 1)
    sbase = (scene_idx.to(torch.int64) * D)[:, None]
    flat = ((sbase + x0i) * H + y0i) * W + z0i
    rows = sdf_packed.reshape(-1, 8)
    return rows[flat], (x0, y0, z0)


def sdf_trilinear_packed(
    sdf_packed: torch.Tensor,  # [S, D, H, W, 8], f32 or bf16
    scene_idx: torch.Tensor,  # [B] scene id per body
    points: torch.Tensor,  # [B, N, 3] world points
    grid_mins: torch.Tensor,  # [S, 3]
    grid_maxs: torch.Tensor,  # [S, 3]
) -> torch.Tensor:
    """Interpolated signed distance [B, N], one packed-row gather per point."""
    dims = tuple(sdf_packed.shape[1:4])
    cx, cy, cz = _voxel_coords(points, scene_idx, grid_mins, grid_maxs, dims)
    c, (x0, y0, z0) = _gather_cells(sdf_packed, scene_idx, cx, cy, cz)
    return _lerp8(c.to(torch.float32), cx - x0, cy - y0, cz - z0)


def sdf_trilinear_packed_cached(
    sdf_packed, scene_idx, points, grid_mins, grid_maxs
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """sdf_trilinear_packed plus each point's cell cache: (sdf [B, N],
    (corners [B, N, 8] in the grid's dtype, base [B, N, 3] f32 floor
    coords)). Carrying the corners in the grid dtype is lossless — they
    were gathered from it."""
    dims = tuple(sdf_packed.shape[1:4])
    cx, cy, cz = _voxel_coords(points, scene_idx, grid_mins, grid_maxs, dims)
    c_src, (x0, y0, z0) = _gather_cells(sdf_packed, scene_idx, cx, cy, cz)
    sdf = _lerp8(c_src.to(torch.float32), cx - x0, cy - y0, cz - z0)
    return sdf, (c_src, torch.stack([x0, y0, z0], dim=-1))


def sdf_trilinear_from_cache(
    cache: Tuple[torch.Tensor, torch.Tensor],
    scene_idx: torch.Tensor,
    points: torch.Tensor,
    grid_mins: torch.Tensor,
    grid_maxs: torch.Tensor,
    dims: Tuple[int, int, int],
) -> torch.Tensor:
    """Frozen-cell SDF: each point against the trilinear patch of the cell
    cached by ``sdf_trilinear_packed_cached``, with no memory traffic
    beyond the cache. The weights are not clamped to [0, 1]: a point that
    left its cell sees the patch's linear extrapolation, which keeps the
    gradient alive."""
    corners, base = cache
    corners = corners.detach().to(torch.float32)
    base = base.detach()
    cx, cy, cz = _voxel_coords(points, scene_idx, grid_mins, grid_maxs, dims)
    return _lerp8(corners, cx - base[..., 0], cy - base[..., 1], cz - base[..., 2])
