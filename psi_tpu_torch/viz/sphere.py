"""Icosphere helpers (equivalent of human_body_prior/mesh/sphere.py:
Sphere and points_to_spheres for visualizing joints/points as balls).

Port of ``psi_tpu.viz.sphere`` (numpy, copied) on the port's
``viz.render.upsample_mesh``."""

from __future__ import annotations

from typing import Tuple

import numpy as np

from psi_tpu_torch.viz.render import upsample_mesh


def icosphere(radius: float = 1.0, subdivisions: int = 2) -> Tuple[np.ndarray, np.ndarray]:
    """Unit icosahedron subdivided and projected to the sphere."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        np.float64,
    )
    faces = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        np.int64,
    )
    verts, faces = upsample_mesh(verts, faces, subdivisions)
    verts = verts / np.linalg.norm(verts, axis=1, keepdims=True) * radius
    return verts, faces


def points_to_spheres(
    points: np.ndarray, radius: float = 0.02, subdivisions: int = 1
) -> Tuple[np.ndarray, np.ndarray]:
    """One merged mesh with a small sphere at each point."""
    sv, sf = icosphere(radius, subdivisions)
    verts, faces = [], []
    for i, p in enumerate(np.asarray(points)):
        verts.append(sv + p[None])
        faces.append(sf + i * len(sv))
    return np.concatenate(verts, axis=0), np.concatenate(faces, axis=0)
