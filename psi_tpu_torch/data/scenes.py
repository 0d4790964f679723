"""Scene geometry registry: all scenes' SDF grids and point clouds, stacked.

Copied from ``psi_tpu.data.scenes`` (numpy only): ``SceneRegistry``,
``build_registry`` and ``synthetic_scene_registry`` produce exactly the
arrays psi_tpu builds from the same seed. SDF grids of different dims are
edge-padded to a common dim with grid_max rescaled (the voxel mapping is
unchanged); point clouds are Morton-ordered and padded with far points
(1e5) that never win a nearest-neighbour query. ``load_scene_registry``
reads PROX-style scene files.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Optional, Sequence

import numpy as np

from psi_tpu_torch.ops.prune import morton_argsort

_FAR = 1.0e5


@dataclasses.dataclass
class SceneRegistry:
    """Host-side registry; fields are numpy."""

    names: List[str]
    sdf_stack: np.ndarray  # [S, D, D, D] float32
    grid_mins: np.ndarray  # [S, 3]
    grid_maxs: np.ndarray  # [S, 3] (adjusted for padding)
    verts_stack: np.ndarray  # [S, P, 3] (far-padded)
    n_verts: np.ndarray  # [S] true vertex counts
    faces: Optional[List[np.ndarray]] = None  # per-scene [F, 3] int32

    @property
    def num_scenes(self) -> int:
        return len(self.names)

    def index_of(self, name: str) -> int:
        """The row of scene ``name``; ValueError for a name not in ``names``."""
        return self.names.index(name)


def _pad_sdf(sdf: np.ndarray, grid_min: np.ndarray, grid_max: np.ndarray, target_dim: int):
    """Edge-replicate pad a dim^3 grid to target_dim^3 and rescale grid_max
    so the coordinate -> voxel mapping is unchanged."""
    d = sdf.shape[0]
    if d == target_dim:
        return sdf, grid_max
    pad = target_dim - d
    sdf_p = np.pad(sdf, ((0, pad),) * 3, mode="edge")
    new_max = grid_min + (grid_max - grid_min) * (float(target_dim) / d)
    return sdf_p, new_max


def build_registry(
    names: Sequence[str],
    verts_list: Sequence[np.ndarray],
    sdf_list: Sequence[np.ndarray],
    grid_mins: Sequence[np.ndarray],
    grid_maxs: Sequence[np.ndarray],
    faces_list: Optional[Sequence[np.ndarray]] = None,
) -> SceneRegistry:
    S = len(names)
    target_dim = max(s.shape[0] for s in sdf_list)
    max_p = max(v.shape[0] for v in verts_list)

    sdf_stack = np.zeros((S, target_dim, target_dim, target_dim), np.float32)
    mins = np.zeros((S, 3), np.float32)
    maxs = np.zeros((S, 3), np.float32)
    verts_stack = np.full((S, max_p, 3), _FAR, np.float32)
    n_verts = np.zeros(S, np.int32)

    for i in range(S):
        sdf_p, new_max = _pad_sdf(
            np.asarray(sdf_list[i], np.float32),
            np.asarray(grid_mins[i], np.float32),
            np.asarray(grid_maxs[i], np.float32),
            target_dim,
        )
        sdf_stack[i] = sdf_p
        mins[i] = grid_mins[i]
        maxs[i] = new_max
        v = np.asarray(verts_list[i], np.float32)
        # Morton order: small point tiles are spatial blobs (ops/prune.py)
        perm = morton_argsort(v)
        verts_stack[i, : v.shape[0]] = v[perm]
        if faces_list is not None and faces_list[i] is not None and len(faces_list[i]):
            inv = np.empty_like(perm)
            inv[perm] = np.arange(perm.shape[0])
            faces_list = list(faces_list)
            faces_list[i] = inv[np.asarray(faces_list[i], np.int64)].astype(np.int32)
        n_verts[i] = v.shape[0]

    return SceneRegistry(
        names=list(names),
        sdf_stack=sdf_stack,
        grid_mins=mins,
        grid_maxs=maxs,
        verts_stack=verts_stack,
        n_verts=n_verts,
        faces=list(faces_list) if faces_list is not None else None,
    )


def _read_mesh_vertices(path: str):
    """Read a triangle mesh (ply/obj). Uses open3d when present, else a
    minimal binary/ascii PLY parser sufficient for PROX scene files."""
    try:  # pragma: no cover - open3d is an optional dependency
        import open3d as o3d

        m = o3d.io.read_triangle_mesh(path)
        return np.asarray(m.vertices), np.asarray(m.triangles)
    except ImportError:
        from psi_tpu_torch.data.plyio import read_ply

        return read_ply(path)


def load_scene_registry(
    scene_verts_path: str,
    scene_sdf_path: str,
    scene_names: Sequence[str],
    mesh_ext: str = ".ply",
) -> SceneRegistry:
    """Load PROX-style assets: {scene}.ply meshes + {scene}.json /
    {scene}_sdf.npy SDFs (reference batch_gen_hdf5.py:135-166)."""
    verts_list, faces_list, sdf_list, mins, maxs = [], [], [], [], []
    for name in scene_names:
        verts, faces = _read_mesh_vertices(os.path.join(scene_verts_path, name + mesh_ext))
        with open(os.path.join(scene_sdf_path, name + ".json")) as f:
            sdf_data = json.load(f)
        dim = sdf_data["dim"]
        sdf = np.load(os.path.join(scene_sdf_path, name + "_sdf.npy")).reshape(dim, dim, dim)
        verts_list.append(verts)
        faces_list.append(faces)
        sdf_list.append(sdf)
        mins.append(np.asarray(sdf_data["min"], np.float32))
        maxs.append(np.asarray(sdf_data["max"], np.float32))
    return build_registry(scene_names, verts_list, sdf_list, mins, maxs, faces_list)


def synthetic_scene_registry(
    num_scenes: int = 4,
    dim: int = 32,
    num_verts: int = 2000,
    seed: int = 0,
    varied_dims: bool = False,
) -> SceneRegistry:
    """Random rooms: floor-plane SDF + a sphere obstacle + a random cloud."""
    rng = np.random.default_rng(seed)
    names = [f"SynthScene{i:02d}" for i in range(num_scenes)]
    verts_list, sdf_list, mins, maxs = [], [], [], []
    for i in range(num_scenes):
        d = dim if not varied_dims else dim + 4 * (i % 3)
        gmin = np.array([-3.0, -3.0, 0.0], np.float32) + rng.normal(0, 0.2, 3).astype(np.float32)
        gmax = np.array([3.0, 3.0, 6.0], np.float32) + rng.normal(0, 0.2, 3).astype(np.float32)
        xs = np.linspace(gmin[0], gmax[0], d)
        ys = np.linspace(gmin[1], gmax[1], d)
        zs = np.linspace(gmin[2], gmax[2], d)
        X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
        floor_h = rng.uniform(-2.5, -1.5)
        center = rng.uniform(-1, 1, 3)
        r = rng.uniform(0.3, 0.8)
        sphere = np.sqrt((X - center[0]) ** 2 + (Y - center[1]) ** 2 + (Z - center[2]) ** 2) - r
        sdf = np.minimum(Y - floor_h, sphere).astype(np.float32)
        n = num_verts + (37 * i if varied_dims else 0)
        verts = rng.uniform(gmin, gmax, size=(n, 3)).astype(np.float32)
        verts_list.append(verts)
        sdf_list.append(sdf)
        mins.append(gmin)
        maxs.append(gmax)
    return build_registry(names, verts_list, sdf_list, mins, maxs)
