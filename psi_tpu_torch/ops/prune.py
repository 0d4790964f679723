"""Contact-NN candidate pruning over Morton-ordered scene clouds.

Port of ``psi_tpu.ops.prune``. Scene clouds are Morton-ordered once when
the registry is built (``morton_argsort``, numpy, copied verbatim), so
every run of ``TILE`` consecutive points is a compact spatial blob.
``select_near_tiles`` ranks the tiles by their nearest point to each
body's contact centroid and keeps the k/TILE nearest tiles whole.

psi_tpu carries four interchangeable rank/fetch variants that exist only
to dodge a TPU compiler fault; here it is ``topk`` plus ``gather``, which
selects the same set of points as psi_tpu's default ``topk_matmul``.
"""

from __future__ import annotations

import numpy as np
import torch

TILE = 32
_FAR = 1.0e5


def morton_codes(verts: np.ndarray, bits: int = 10) -> np.ndarray:
    """[P, 3] float -> [P] uint64 Morton (Z-order) codes over the bbox."""
    v = np.asarray(verts, np.float64)
    lo = v.min(axis=0)
    span = np.maximum(v.max(axis=0) - lo, 1e-9)
    q = np.clip(((v - lo) / span * (2**bits - 1)).astype(np.uint64), 0, 2**bits - 1)
    code = np.zeros(v.shape[0], np.uint64)
    for b in range(bits):
        for ax in range(3):
            code |= ((q[:, ax] >> np.uint64(b)) & np.uint64(1)) << np.uint64(3 * b + ax)
    return code


def morton_argsort(verts: np.ndarray) -> np.ndarray:
    """Permutation that orders points along the Z-order curve."""
    return np.argsort(morton_codes(verts), kind="stable")


def select_near_tiles(
    scene_pts: torch.Tensor,  # [B, M, 3] Morton-ordered (far-padded OK)
    centroid: torch.Tensor,  # [B, 3]
    k_points: int,
    tile: int = TILE,
) -> torch.Tensor:
    """The ~k_points scene points nearest each centroid, tile-granular:
    [B, ceil(k/tile)*tile, 3]. The selection carries no gradient (the
    scene cloud is a constant of every caller)."""
    B, M, _ = scene_pts.shape
    k_tiles = max(1, -(-k_points // tile))
    pad = (-M) % tile
    if pad:
        far = torch.full((B, pad, 3), _FAR, dtype=scene_pts.dtype, device=scene_pts.device)
        scene_pts = torch.cat([scene_pts, far], dim=1)
    nt = (M + pad) // tile
    if k_tiles >= nt:
        return scene_pts
    with torch.no_grad():
        cd = torch.sum((scene_pts - centroid[:, None, :]) ** 2, dim=-1)  # [B, Mp]
        tile_min = cd.reshape(B, nt, tile).amin(dim=-1)  # [B, nt]
        tidx = torch.topk(tile_min, k_tiles, dim=-1, largest=False, sorted=True).indices
    tiles = scene_pts.detach().reshape(B, nt, tile * 3)
    cand = torch.gather(tiles, 1, tidx[:, :, None].expand(-1, -1, tile * 3))
    return cand.reshape(B, k_tiles * tile, 3)
