"""Trilinear SDF lookups — the fit loss's collision term and the eval scores.

Port of ``psi_tpu.ops.sdf``. In psi_tpu these are XLA gathers, not Pallas
kernels, so plain torch (index + gather) is the port. Two storages:
* scalar grids [B or S, D, H, W]: ``grid_sample_3d``, ``sdf_trilinear``
  and ``sdf_trilinear_stacked`` fetch the 8 corners of a point's cell
  with 8 scalar gathers;
* corner-packed grids [S, D, H, W, 8]: each cell's 2x2x2 corner block in
  one row (channel dx*4 + dy*2 + dz), so ``sdf_trilinear_packed`` and the
  cached lookups fetch one row per point.

Coordinates follow the reference's grid_sample call (align_corners=False,
border clamp): world -> [-1, 1] -> voxel coords clamped to [0, size-1].
Gradients flow to the points through the fractional weights; the cell
index (floor) has none. At exactly a border the clamp's gradient is
torch's (passes through), not jnp.clip's.
"""

from __future__ import annotations

from typing import Tuple

import torch

from psi_tpu_torch.parallel.distributed import all_reduce_sum_


def _unnormalize(coord: torch.Tensor, size: int) -> torch.Tensor:
    """[-1, 1] -> voxel coords (align_corners=False), clamped to the border."""
    c = ((coord + 1.0) * size - 1.0) / 2.0
    return torch.clamp(c, 0.0, float(size - 1))


def _corner_lerp(take, cx, cy, cz, dims):
    """Trilinear interpolation from 8 scalar corner fetches.

    ``take(xi, yi, zi)`` returns the grid values at int64 voxel indices;
    cx, cy, cz are pre-clamped voxel coords. Corner indices are clamped
    again, so out-of-range corners replicate the border value."""
    D, H, W = dims
    x0, y0, z0 = torch.floor(cx), torch.floor(cy), torch.floor(cz)
    wx, wy, wz = cx - x0, cy - y0, cz - z0  # weights before index clamping (border semantics)
    x0i = torch.clamp(x0.to(torch.int64), 0, D - 1)
    y0i = torch.clamp(y0.to(torch.int64), 0, H - 1)
    z0i = torch.clamp(z0.to(torch.int64), 0, W - 1)
    x1i = torch.clamp(x0i + 1, 0, D - 1)
    y1i = torch.clamp(y0i + 1, 0, H - 1)
    z1i = torch.clamp(z0i + 1, 0, W - 1)
    c00 = take(x0i, y0i, z0i) * (1 - wz) + take(x0i, y0i, z1i) * wz
    c01 = take(x0i, y1i, z0i) * (1 - wz) + take(x0i, y1i, z1i) * wz
    c10 = take(x1i, y0i, z0i) * (1 - wz) + take(x1i, y0i, z1i) * wz
    c11 = take(x1i, y1i, z0i) * (1 - wz) + take(x1i, y1i, z1i) * wz
    c0 = c00 * (1 - wy) + c01 * wy
    c1 = c10 * (1 - wy) + c11 * wy
    return c0 * (1 - wx) + c1 * wx


def _trilinear_gather(grid: torch.Tensor, cx: torch.Tensor, cy: torch.Tensor, cz: torch.Tensor) -> torch.Tensor:
    """Trilinear interpolation of each grid [B, D, H, W] at its own voxel
    coords cx, cy, cz [B, N] (cx indexes D, cy H, cz W; pre-clamped)."""
    B, D, H, W = grid.shape
    flat = grid.reshape(B, -1)
    return _corner_lerp(lambda xi, yi, zi: torch.gather(flat, 1, (xi * H + yi) * W + zi), cx, cy, cz, (D, H, W))


def grid_sample_3d(grid: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """The reference's F.grid_sample in 3D (align_corners=False, border
    padding), written as psi_tpu writes it.

    grid:   [B, D, H, W]   (torch's input [B, 1, D, H, W] squeezed)
    coords: [B, N, 3] normalized in [-1, 1], ordered (x, y, z): x indexes
            W, y indexes H, z indexes D — torch's convention.
    returns [B, N]
    """
    D, H, W = grid.shape[-3:]
    cw = _unnormalize(coords[..., 0], W)
    ch = _unnormalize(coords[..., 1], H)
    cd = _unnormalize(coords[..., 2], D)
    return _trilinear_gather(grid, cd, ch, cw)


def _normalize(points: torch.Tensor, gmin: torch.Tensor, gmax: torch.Tensor) -> torch.Tensor:
    """World points [B, N, 3] -> [-1, 1] against per-body bounds [B, 3]."""
    return (points - gmin[:, None, :]) / (gmax[:, None, :] - gmin[:, None, :]) * 2.0 - 1.0


def sdf_trilinear(sdf: torch.Tensor, points: torch.Tensor, grid_min: torch.Tensor, grid_max: torch.Tensor) -> torch.Tensor:
    """World-space SDF lookup, one grid per body.

    sdf [B, D, H, W] with axes ordered (x, y, z); points [B, N, 3];
    grid_min, grid_max [B, 3]. Returns [B, N]. The same function as the
    reference's normalize -> [2, 1, 0] flip -> F.grid_sample chain: the
    flip exists only because grid_sample's x indexes the last axis."""
    norm = _normalize(points, grid_min, grid_max)
    D, H, W = sdf.shape[-3:]
    return _trilinear_gather(
        sdf, _unnormalize(norm[..., 0], D), _unnormalize(norm[..., 1], H), _unnormalize(norm[..., 2], W)
    )


def sdf_trilinear_stacked(
    sdf_stack: torch.Tensor,  # [S, D, H, W] every scene's grid
    scene_idx: torch.Tensor,  # [B] scene id per body
    points: torch.Tensor,  # [B, N, 3] world points
    grid_mins: torch.Tensor,  # [S, 3]
    grid_maxs: torch.Tensor,  # [S, 3]
) -> torch.Tensor:
    """SDF lookup against the resident grid registry [B, N]: eight scalar
    gathers into the flattened stack per point."""
    S, D, H, W = sdf_stack.shape
    cx, cy, cz = _voxel_coords(points, scene_idx, grid_mins, grid_maxs, (D, H, W))
    flat = sdf_stack.reshape(-1)
    base = (scene_idx.to(torch.int64) * D)[:, None]
    return _corner_lerp(lambda xi, yi, zi: flat[((base + xi) * H + yi) * W + zi], cx, cy, cz, (D, H, W))


def sdf_penetration_loss(body_sdf: torch.Tensor, mesh=None) -> torch.Tensor:
    """Mean |sdf| over penetrating (sdf < 0) vertices; 0 if none — the
    reference's ``body_sdf[body_sdf < 0].abs().mean()`` at a static shape.

    With a mesh, ``body_sdf`` is this rank's rows of the batch and the result
    is its share of the whole batch's mean: its own sum over the count of
    penetrating vertices on every rank (summed over the ranks; no gradient
    through a count). The shares sum to the mean of the whole batch."""
    count = (body_sdf < 0).sum()
    if mesh is not None:
        count = all_reduce_sum_(count, mesh)
    # minimum, not clamp: at sdf == 0 both it and jnp.minimum pass half the gradient
    total = -torch.minimum(body_sdf, body_sdf.new_zeros(())).sum()
    return total / torch.clamp(count, min=1).to(body_sdf.dtype)


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
    norm = _normalize(points, grid_mins[scene_idx], grid_maxs[scene_idx])
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
