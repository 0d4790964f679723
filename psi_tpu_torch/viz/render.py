"""Software renderer: pinhole projection, z-buffer splatting and triangle
rasterization, in plain torch on the tensors' device.

Port of ``psi_tpu.viz.render`` (which replaces the reference's Open3D
offscreen capture):

* points project through the pinhole intrinsics;
* each point splats into a (2r+1)^2 pixel neighborhood;
* per pixel, an int32 key packs (quantized depth, semantic label),
  ``(depth_mm << 6) | label``, so a single scatter-min
  (``scatter_reduce_(..., 'amin')``) resolves both the depth buffer and the
  winning label.

``rasterize_mesh`` evaluates the edge functions of every (pixel, triangle)
pair with psi_tpu's formulas, so each pixel's key is psi_tpu's; only the
grouping differs: psi_tpu loops over (tile x tile) blocks and chunks of
triangles, here one pass takes a chunk of triangles against a block of
whole tiles sized so the pass's temporaries stay at tens of MB (one pass,
not one a tile: on a card each tile would be its own launches). The
minimum over integer keys does not depend on the grouping.

Meshes are densified on the host with ``upsample_mesh`` (midpoint 1->4
subdivision, numpy, copied).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

_LABEL_BITS = 6  # labels < 64 (mpcat40 has 42)
_DEPTH_SCALE = 1000.0  # mm quantization for the packed z-buffer key
_BIG = 2**30
_PAIRS_PER_PASS = 1 << 23  # (pixel, triangle) pairs of one rasterizer pass: 32 MB per f32 temporary


def upsample_mesh(verts: np.ndarray, faces: np.ndarray, iterations: int = 1) -> Tuple[np.ndarray, np.ndarray]:
    """Midpoint subdivision (each triangle -> 4). Host-side, one-time."""
    verts = np.asarray(verts, np.float64)
    faces = np.asarray(faces, np.int64)
    for _ in range(iterations):
        edges = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]], axis=0)
        edges = np.sort(edges, axis=1)
        uniq, inv = np.unique(edges, axis=0, return_inverse=True)
        mid = verts[uniq].mean(axis=1)
        mid_idx = len(verts) + np.arange(len(uniq))
        verts = np.concatenate([verts, mid], axis=0)
        f = faces.shape[0]
        m01 = mid_idx[inv[:f]]
        m12 = mid_idx[inv[f : 2 * f]]
        m20 = mid_idx[inv[2 * f :]]
        faces = np.concatenate(
            [
                np.stack([faces[:, 0], m01, m20], 1),
                np.stack([faces[:, 1], m12, m01], 1),
                np.stack([faces[:, 2], m20, m12], 1),
                np.stack([m01, m12, m20], 1),
            ],
            axis=0,
        )
    return verts, faces


def project_points(
    verts: torch.Tensor, cam_int: torch.Tensor, cam_ext: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """World points [N, 3] -> (pixel uv [N, 2], camera-frame depth [N]).

    cam_ext is world->camera [4, 4]; intrinsics use the +z-forward
    pinhole convention of the PROX snapshots."""
    if cam_ext is not None:
        verts = verts @ cam_ext[:3, :3].T + cam_ext[:3, 3]
    z = verts[:, 2]
    fx, fy = cam_int[0, 0], cam_int[1, 1]
    px, py = cam_int[0, 2], cam_int[1, 2]
    zc = torch.where(z > 1e-6, z, torch.full_like(z, 1e-6))
    u = verts[:, 0] * fx / zc + px
    v = verts[:, 1] * fy / zc + py
    return torch.stack([u, v], dim=1), z


def _unpack(buf: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Packed keys -> (depth in m, label), 0 where nothing was drawn."""
    hit = buf < _BIG
    zero = torch.zeros((), dtype=torch.float32, device=buf.device)
    # a divisor on the device, not a Python number: CUDA multiplies by the
    # reciprocal of a host scalar, one ulp off the CPU's (and psi_tpu's) quotient
    scale = torch.tensor(_DEPTH_SCALE, dtype=torch.float32, device=buf.device)
    depth = torch.where(hit, (buf >> _LABEL_BITS).to(torch.float32) / scale, zero)
    seg = torch.where(hit, (buf & (2**_LABEL_BITS - 1)).to(torch.float32), zero)
    return depth, seg


def rasterize_mesh(
    verts: torch.Tensor,
    faces: torch.Tensor,
    labels: torch.Tensor,
    cam_int: torch.Tensor,
    height: int,
    width: int,
    cam_ext: Optional[torch.Tensor] = None,
    tile: int = 64,
    tri_chunk: int = 512,
    max_depth: float = 20.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """True z-buffer triangle rasterization -> (depth [H, W], seg [H, W]).

    Each pass evaluates the edge functions of ``tri_chunk`` triangles against
    a block of whole ``tile``-row bands of the image (as many as fit
    ``_PAIRS_PER_PASS`` pairs, at least one band), with the packed
    (depth, label) int32 min-key. Cost O(H*W*F); no holes, unlike point
    splatting. faces: [F, 3] int; labels: per-vertex [V] (face label =
    vertex 0's). Runs on ``verts``' device.
    """
    verts = verts.to(torch.float32)
    dev = verts.device
    uv, z = project_points(verts, cam_int, cam_ext)
    tri = faces.to(device=dev, dtype=torch.int64)
    xy = uv[tri]  # [F, 3, 2]
    zz = z[tri]  # [F, 3]
    tri_label = torch.clamp(labels.to(dev)[tri[:, 0]].to(torch.int32), 0, 2**_LABEL_BITS - 1)

    x0, y0 = xy[:, 0, 0], xy[:, 0, 1]
    x1, y1 = xy[:, 1, 0], xy[:, 1, 1]
    x2, y2 = xy[:, 2, 0], xy[:, 2, 1]
    area = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)  # [F]
    nonzero = torch.abs(area) > 1e-9
    valid_tri = nonzero & torch.all(zz > 1e-3, dim=1)
    inv_area = torch.where(valid_tri, 1.0 / torch.where(nonzero, area, torch.ones_like(area)),
                           torch.zeros_like(area))

    band = tile * width
    rows = max(1, _PAIRS_PER_PASS // (band * tri_chunk)) * tile  # image rows a pass
    big = torch.tensor(_BIG, dtype=torch.int32, device=dev)
    buf = torch.full((height * width,), _BIG, dtype=torch.int32, device=dev)
    cols = torch.arange(width, dtype=torch.float32, device=dev)
    for r0 in range(0, height, rows):
        r1 = min(height, r0 + rows)
        pyf = torch.arange(r0, r1, dtype=torch.float32, device=dev).repeat_interleave(width)[:, None]  # [P, 1]
        pxf = cols.repeat(r1 - r0)[:, None]
        best = buf[r0 * width : r1 * width]
        for c0 in range(0, tri.shape[0], tri_chunk):
            sl = slice(c0, c0 + tri_chunk)
            cx0, cy0, cx1, cy1, cx2, cy2 = x0[sl], y0[sl], x1[sl], y1[sl], x2[sl], y2[sl]
            cz, cia = zz[sl], inv_area[sl]
            # barycentric weights via edge functions [P, C]
            w0 = ((cx1 - pxf) * (cy2 - pyf) - (cx2 - pxf) * (cy1 - pyf)) * cia
            w1 = ((cx2 - pxf) * (cy0 - pyf) - (cx0 - pxf) * (cy2 - pyf)) * cia
            w2 = 1.0 - w0 - w1
            inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0) & valid_tri[sl][None, :]
            zi = w0 * cz[:, 0] + w1 * cz[:, 1] + w2 * cz[:, 2]
            zq = torch.clamp(zi * _DEPTH_SCALE, 0, max_depth * _DEPTH_SCALE).to(torch.int32)
            key = torch.where(inside & (zi > 1e-3), (zq << _LABEL_BITS) | tri_label[sl][None, :], big)
            torch.minimum(best, key.amin(dim=1), out=best)
    depth, seg = _unpack(buf)
    return depth.reshape(height, width), seg.reshape(height, width)


def render_depth_semantics(
    verts: torch.Tensor,
    labels: torch.Tensor,
    cam_int: torch.Tensor,
    height: int,
    width: int,
    cam_ext: Optional[torch.Tensor] = None,
    splat_radius: int = 1,
    max_depth: float = 20.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Splat labeled world points to (depth [H, W], seg [H, W]) on
    ``verts``' device.

    Pixels with no points get depth 0 and label 0 (the reference's
    empty-canvas convention). The depth is truncated to mm before it is
    clipped (psi_tpu's order; ``rasterize_mesh`` clips first)."""
    uv, z = project_points(verts, cam_int, cam_ext)
    ui = torch.round(uv[:, 0]).to(torch.int32)
    vi = torch.round(uv[:, 1]).to(torch.int32)
    zq = torch.clamp((z * _DEPTH_SCALE).to(torch.int32), 0, int(max_depth * _DEPTH_SCALE))
    key_base = (zq << _LABEL_BITS) | torch.clamp(labels.to(verts.device).to(torch.int32), 0, 2**_LABEL_BITS - 1)

    big = torch.full_like(key_base, _BIG)
    buf = torch.full((height * width,), _BIG, dtype=torch.int32, device=verts.device)
    for dy in range(-splat_radius, splat_radius + 1):
        for dx in range(-splat_radius, splat_radius + 1):
            x = ui + dx
            y = vi + dy
            valid = (x >= 0) & (x < width) & (y >= 0) & (y < height) & (z > 1e-3)
            flat = torch.where(valid, y * width + x, torch.zeros_like(x)).to(torch.int64)
            key = torch.where(valid, key_base, big)
            buf.scatter_reduce_(0, flat, key, reduce="amin")
    depth, seg = _unpack(buf)
    return depth.reshape(height, width), seg.reshape(height, width)
