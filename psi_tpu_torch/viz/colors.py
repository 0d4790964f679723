"""Color tables for visualization (a copy of ``psi_tpu.viz.colors``;
equivalent of the reference's mpcat40
color coding in utils_show_test_results_habitat.py:101-119 and the
omni_tools color dict)."""

from __future__ import annotations

import numpy as np

# deterministic 42-entry palette for mpcat40 labels (0..41)
def _make_palette(n: int = 42, seed: int = 7) -> np.ndarray:
    rng = np.random.default_rng(seed)
    hues = (np.arange(n) * 0.618033988749895) % 1.0
    sat = 0.45 + 0.4 * rng.random(n)
    val = 0.65 + 0.3 * rng.random(n)
    c = val * sat
    h6 = hues * 6.0
    x = c * (1 - np.abs(h6 % 2 - 1))
    rgb = np.zeros((n, 3))
    for i in range(n):
        k = int(h6[i]) % 6
        rgb[i] = [(c[i], x[i], 0), (x[i], c[i], 0), (0, c[i], x[i]),
                  (0, x[i], c[i]), (x[i], 0, c[i]), (c[i], 0, x[i])][k]
    rgb += (val - c)[:, None]
    return rgb


MPCAT40_PALETTE = _make_palette()
MPCAT40_PALETTE[0] = [0.8, 0.8, 0.8]  # void/unlabeled: grey

BODY_COLORS = {
    "grey": np.array([0.7, 0.7, 0.7]),
    "blue": np.array([0.35, 0.45, 0.9]),
    "red": np.array([0.9, 0.3, 0.3]),
    "green": np.array([0.3, 0.8, 0.4]),
    "orange": np.array([0.95, 0.65, 0.2]),
}


def mpcat40_color(label: "np.ndarray | int") -> np.ndarray:
    """mpcat40 id(s) -> rgb in [0, 1]."""
    return MPCAT40_PALETTE[np.clip(np.asarray(label, np.int64), 0, 41)]
