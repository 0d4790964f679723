"""The port's float32 contract on the card.

A float32 matrix product on an NVIDIA card runs in full float32 unless
``torch.backends.cuda.matmul.allow_tf32`` is set, but a float32
convolution goes through cuDNN in TF32 (about three decimal digits)
unless ``torch.backends.cudnn.allow_tf32`` is cleared. The port's f32
paths (the 'high' LBS tier, the scene trunk, the fit losses) are held to
the JAX package in full float32, so their entry points run inside
``strict_f32``. The 'fast' and 'fused' LBS tiers round their operands to
bf16 explicitly instead; they never rely on TF32.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def strict_f32():
    """Turn TF32 off for matmuls and cuDNN convolutions, restoring on exit."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
