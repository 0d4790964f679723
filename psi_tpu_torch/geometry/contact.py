"""Contact vertex ids: the body vertices the contact loss reads.

Copied from ``psi_tpu.geometry.contact`` (numpy only). ``get_contact_ids``
is the equivalent of GeometryTransformer.get_contact_id (reference:
source/cvae.py:99-115): load {part}.json files with "verts_ind" /
"faces_ind" lists, dedupe, concatenate. The ids come back sorted ascending
within each part (the reference's list(set(...)) yields the same order for
small ints in CPython). They are static: load them once and keep them on
the device as constant gather indices (``SceneAssets.contact_vids``).
"""

from __future__ import annotations

import json
import os
from typing import List, Sequence, Tuple

import numpy as np

DEFAULT_CONTACT_PARTS: Tuple[str, ...] = (
    "back", "butt", "L_Hand", "R_Hand", "L_Leg", "R_Leg", "thighs",
)


def get_contact_ids(
    body_segments_folder: str,
    contact_body_parts: Sequence[str] = DEFAULT_CONTACT_PARTS,
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (contact_verts_ids, contact_faces_ids) int32 arrays."""
    verts: List[np.ndarray] = []
    faces: List[np.ndarray] = []
    for part in contact_body_parts:
        with open(os.path.join(body_segments_folder, part + ".json")) as f:
            data = json.load(f)
        verts.append(np.unique(np.asarray(data["verts_ind"], dtype=np.int32)))
        faces.append(np.unique(np.asarray(data["faces_ind"], dtype=np.int32)))
    return np.concatenate(verts), np.concatenate(faces)


def synthetic_contact_ids(num_verts: int, n_contact: int = 1024, seed: int = 0) -> np.ndarray:
    """Deterministic random contact-vertex subset for tests/benchmarks."""
    rng = np.random.default_rng(seed)
    n = min(n_contact, num_verts)
    return np.sort(rng.choice(num_verts, size=n, replace=False)).astype(np.int32)
