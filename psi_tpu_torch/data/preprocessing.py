"""Snapshot preprocessing: depth/semantics -> 128x128 normalized canvas.

Port of ``psi_tpu.data.preprocessing`` (reference ``data_preprocessing``,
source/batch_gen_hdf5.py:359-441, duplicated in test_habitat_s1.py):

1. clamp (depth > 6.0 m -> 6.0; seg labels > 41 -> 41)
2. rescale to [-1, 1] via 2*img/max(img) - 1
3. aspect-preserving bilinear resize (align_corners=False) so the long
   side fits the 128 canvas, short side rounded down to even
4. paste centered on a zero canvas

Returns (canvas [H, W], factor, max_val) like the reference. Host-side
ingest: numpy in, numpy out, the resize through ``ops.resize`` on the CPU.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from psi_tpu_torch.ops.resize import resize_bilinear


def data_preprocessing(
    img: np.ndarray,
    modality: str,
    target_domain_size: Sequence[int] = (128, 128),
) -> Tuple[np.ndarray, float, float]:
    img = np.asarray(img, dtype=np.float32).copy()
    h, w = img.shape

    if modality == "depth":
        img[img > 6.0] = 6.0
    elif modality == "seg":
        img[img > 41] = 41

    max_val = float(np.max(img))
    scaled = torch.from_numpy(2.0 * img / max_val - 1.0)

    th, tw = target_domain_size
    canvas = np.zeros((th, tw), dtype=np.float32)

    if h >= w:
        factor = float(th) / h
        target_h = th
        target_w = int(w * factor) // 2 * 2
        resized = resize_bilinear(scaled, target_h, target_w).numpy()
        lower = (tw // 2) - (target_w // 2)
        canvas[:, lower : lower + target_w] = resized
    else:
        factor = float(tw) / w
        target_h = int(h * factor) // 2 * 2
        target_w = tw
        resized = resize_bilinear(scaled, target_h, target_w).numpy()
        lower = (th // 2) - (target_h // 2)
        canvas[lower : lower + target_h, :] = resized

    return canvas, factor, max_val
