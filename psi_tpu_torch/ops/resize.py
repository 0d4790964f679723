"""Bilinear image resize with torch ``F.interpolate(align_corners=False)``.

Port of ``psi_tpu.ops.resize`` (used by the snapshot preprocessing;
reference source/batch_gen_hdf5.py:359-441 resizes depth/seg maps onto a
128x128 canvas with ``F.interpolate(mode='bilinear', align_corners=False)``).
psi_tpu calls ``jax.image.resize(method='linear', antialias=False)``: the
same half-pixel centres and no antialiasing filter, so this is the very
call psi_tpu stands in for. Not a kernel: plain torch on host-side ingest.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_bilinear(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Resize the last two axes of ``img`` to (out_h, out_w), bilinear,
    half-pixel centres (align_corners=False), no antialiasing."""
    lead = img.shape[:-2]
    flat = img.reshape(-1, 1, *img.shape[-2:])
    out = F.interpolate(flat, size=(out_h, out_w), mode="bilinear", align_corners=False, antialias=False)
    return out.reshape(*lead, out_h, out_w)
