"""Plain scene geometry: Morton order, candidate tiles, nearest neighbours
and trilinear SDF lookups, from the raw grids and clouds.

The program stores its clouds in Morton order and its grids corner-packed
(bf16 in production); here both are worked out again from the raw arrays
that the benchmark made.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

TILE = 32  # points a candidate tile holds


def morton_order(verts: np.ndarray, bits: int = 10) -> np.ndarray:
    """Permutation of [P, 3] points along the Z-order curve of their box
    (10 bits an axis, ties kept in input order)."""
    v = np.asarray(verts, np.float64)
    lo = v.min(axis=0)
    span = np.maximum(v.max(axis=0) - lo, 1e-9)
    q = np.clip(((v - lo) / span * (2**bits - 1)).astype(np.uint64), 0, 2**bits - 1)
    code = np.zeros(v.shape[0], np.uint64)
    for b in range(bits):
        for ax in range(3):
            code |= ((q[:, ax] >> np.uint64(b)) & np.uint64(1)) << np.uint64(3 * b + ax)
    return np.argsort(code, kind="stable")


def near_tiles(cloud: torch.Tensor, centroid: torch.Tensor, k_points: int) -> torch.Tensor:
    """The ceil(k/TILE) tiles of TILE consecutive points (of a Morton-ordered
    cloud [B, M, 3]) whose nearest point is nearest each centroid [B, 3],
    nearest first: [B, k_tiles * TILE, 3]."""
    B, M, _ = cloud.shape
    pad = (-M) % TILE
    if pad:
        cloud = torch.cat([cloud, cloud.new_full((B, pad, 3), 1.0e5)], 1)
    nt = cloud.shape[1] // TILE
    k_tiles = max(1, -(-k_points // TILE))
    if k_tiles >= nt:
        return cloud
    d = torch.sum((cloud - centroid[:, None, :]) ** 2, dim=-1).reshape(B, nt, TILE).amin(-1)
    idx = torch.topk(d, k_tiles, dim=-1, largest=False, sorted=True).indices
    tiles = cloud.reshape(B, nt, TILE * 3)
    return torch.gather(tiles, 1, idx[:, :, None].expand(-1, -1, TILE * 3)).reshape(B, k_tiles * TILE, 3)


def nearest(x: torch.Tensor, y: torch.Tensor, budget: int = 1 << 27) -> torch.Tensor:
    """Index [B, N] of each x point's nearest y point by the exact float32
    sum of (x - y)^2, ties to the lowest index; in blocks of ``budget``
    elements."""
    B, N, _ = x.shape
    M = y.shape[1]
    out = torch.empty((B, N), dtype=torch.int64, device=x.device)
    nstep = max(1, min(N, budget // (3 * M)))
    bstep = max(1, budget // (3 * M * nstep))
    with torch.no_grad():
        for b0 in range(0, B, bstep):
            for n0 in range(0, N, nstep):
                xb = x[b0:b0 + bstep, n0:n0 + nstep, None, :]
                out[b0:b0 + bstep, n0:n0 + nstep] = ((xb - y[b0:b0 + bstep, None]) ** 2).sum(-1).argmin(-1)
    return out


def gather_points(y: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(y, 1, idx[..., None].expand(-1, -1, 3))


def voxel_coords(points: torch.Tensor, gmin: torch.Tensor, gmax: torch.Tensor, dim: int):
    """World points [B, N, 3] against per-body bounds [B, 3] -> clamped voxel
    coordinates, grid_sample's align_corners=False with border padding."""
    norm = (points - gmin[:, None, :]) / (gmax[:, None, :] - gmin[:, None, :]) * 2.0 - 1.0
    c = torch.clamp(((norm + 1.0) * dim - 1.0) / 2.0, 0.0, float(dim - 1))
    return c[..., 0], c[..., 1], c[..., 2]


def lerp_corners(c: torch.Tensor, wx, wy, wz) -> torch.Tensor:
    """Trilinear blend of corners [..., 8] (index dx*4 + dy*2 + dz)."""
    c00 = c[..., 0] * (1 - wz) + c[..., 1] * wz
    c01 = c[..., 2] * (1 - wz) + c[..., 3] * wz
    c10 = c[..., 4] * (1 - wz) + c[..., 5] * wz
    c11 = c[..., 6] * (1 - wz) + c[..., 7] * wz
    return (c00 * (1 - wy) + c01 * wy) * (1 - wx) + (c10 * (1 - wy) + c11 * wy) * wx


def sdf_cells(grid: torch.Tensor, scene_idx: torch.Tensor, points: torch.Tensor, gmins: torch.Tensor,
              gmaxs: torch.Tensor) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Signed distance [B, N] of every point from its body's scene grid
    (grid [S, D, D, D], already in the stated precision), and each point's
    cell: its eight corner values [B, N, 8] and floor coordinates [B, N, 3]."""
    S, D = grid.shape[:2]
    cx, cy, cz = voxel_coords(points, gmins[scene_idx], gmaxs[scene_idx], D)
    x0, y0, z0 = torch.floor(cx), torch.floor(cy), torch.floor(cz)
    xi, yi, zi = (torch.clamp(t.to(torch.int64), 0, D - 1) for t in (x0, y0, z0))
    flat = grid.reshape(-1)
    base = (scene_idx.to(torch.int64) * D)[:, None]
    corners = []
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                xx, yy, zz = (torch.clamp(t + o, 0, D - 1) for t, o in ((xi, dx), (yi, dy), (zi, dz)))
                corners.append(flat[((base + xx) * D + yy) * D + zz])
    c = torch.stack(corners, -1).detach()
    return lerp_corners(c, cx - x0, cy - y0, cz - z0), (c, torch.stack([x0, y0, z0], -1).detach())


def sdf_from_cells(cells, scene_idx, points, gmins, gmaxs, dim: int) -> torch.Tensor:
    """Each point against the trilinear patch of its carried cell, extrapolated
    linearly once it has left the cell."""
    c, base = cells
    cx, cy, cz = voxel_coords(points, gmins[scene_idx], gmaxs[scene_idx], dim)
    return lerp_corners(c, cx - base[..., 0], cy - base[..., 1], cz - base[..., 2])
