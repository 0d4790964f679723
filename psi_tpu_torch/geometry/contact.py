"""Contact vertex ids: the body vertices the contact loss reads.

Copied from ``psi_tpu.geometry.contact`` (numpy only). The reader of PROX
body_segments annotations (``get_contact_ids``) is not ported yet; the
slice runs on the synthetic ids below, the same draws as psi_tpu's.
"""

from __future__ import annotations

import numpy as np


def synthetic_contact_ids(num_verts: int, n_contact: int = 1024, seed: int = 0) -> np.ndarray:
    """Deterministic random contact-vertex subset for tests/benchmarks."""
    rng = np.random.default_rng(seed)
    n = min(n_contact, num_verts)
    return np.sort(rng.choice(num_verts, size=n, replace=False)).astype(np.int32)
