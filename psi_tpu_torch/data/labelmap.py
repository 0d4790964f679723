"""ADE20K (150 classes) -> Matterport mpcat40 (41 classes) label transfer.

Port of ``psi_tpu.data.labelmap`` (numpy, copied). Equivalent of
utils/utils_label_adk20_to_matterport3d.py:1-21 + data/ade20_to_mp3dlabel.npy.
The mapping is a fixed fact about the two label taxonomies, embedded here as
data so no .npy asset is needed.
"""

from __future__ import annotations

import numpy as np

# index = ADE20K class id (0-based), value = mpcat40 id (41 = unlabeled/other)
ADE20K_TO_MPCAT40 = np.array(
    [
        0, 1, 41, 41, 2, 14, 17, 41, 11, 9, 41, 7, 41, 40, 41, 4, 5, 41, 14, 12,
        3, 41, 41, 6, 10, 31, 41, 41, 21, 2, 41, 3, 34, 41, 5, 41, 41, 28, 25, 30,
        8, 39, 39, 24, 39, 13, 26, 41, 15, 41, 27, 37, 41, 41, 16, 41, 39, 5, 8, 4,
        16, 41, 41, 39, 32, 5, 18, 14, 31, 41, 34, 26, 37, 14, 26, 39, 3, 41, 41, 39,
        41, 41, 20, 28, 41, 41, 28, 41, 28, 36, 22, 41, 41, 38, 39, 2, 30, 16, 36, 39,
        5, 41, 41, 41, 41, 41, 41, 41, 37, 39, 41, 19, 39, 39, 41, 41, 39, 41, 36, 37,
        39, 39, 16, 41, 41, 37, 39, 40, 41, 41, 37, 22, 11, 40, 38, 28, 39, 28, 39, 39,
        39, 41, 22, 39, 22, 35, 23, 39, 39, 39,
    ],
    dtype=np.int32,
)


def look_up_ade2mp3d(seg: np.ndarray) -> np.ndarray:
    """Map an ADE20K segmentation map (values 0..149) to mpcat40 ids."""
    seg = np.asarray(seg, dtype=np.int64)
    return ADE20K_TO_MPCAT40[np.clip(seg, 0, len(ADE20K_TO_MPCAT40) - 1)]
