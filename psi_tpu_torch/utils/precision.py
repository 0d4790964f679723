"""The port's float32 contract on the card.

A float32 matrix product on an NVIDIA card runs in full float32 unless
``torch.backends.cuda.matmul.allow_tf32`` is set, but a float32
convolution goes through cuDNN in TF32 (about three decimal digits)
unless ``torch.backends.cudnn.allow_tf32`` is cleared. The port's f32
paths (the 'high' LBS tier's products but its two split-bf16 ones, the
scene trunk, the fit losses) are held to the JAX package in full float32,
so their entry points run inside ``strict_f32``. The 'fast' and 'fused'
LBS tiers and the split-bf16 products round their operands to bf16
explicitly instead; they never rely on TF32.

Both flags are process-global, and the serving path enters ``strict_f32``
from several threads at once (one worker per model). So the context
counts its entries under a lock: the first entry saves and clears the
flags, the last exit restores them, and an entry or exit in between only
counts. A thread that leaves while another is still inside therefore
cannot switch TF32 back on under it.
"""

from __future__ import annotations

import contextlib
import threading

import torch

_lock = threading.Lock()
_depth = 0  # entries not yet left, over all threads
_saved = None  # the flags as the first of them found them


@contextlib.contextmanager
def strict_f32():
    """Turn TF32 off for matmuls and cuDNN convolutions; the flags come back
    when the last overlapping or nested entry, of any thread, has left."""
    global _depth, _saved
    with _lock:
        if _depth == 0:
            _saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        _depth += 1
    try:
        yield
    finally:
        with _lock:
            _depth -= 1
            if _depth == 0:
                torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = _saved
                _saved = None
