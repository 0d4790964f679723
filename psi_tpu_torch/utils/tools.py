"""Small utilities (port of ``psi_tpu.utils.tools``; reference:
human_body_prior/tools/omni_tools.py, training_tools.py): file+stderr
logger, path maker, early stopping, and ``resolve_device``, the entry
points' device rule."""

from __future__ import annotations

import os
import sys
from typing import Optional

import numpy as np
import torch


def makepath(path: str, isfile: bool = False) -> str:
    """mkdir -p for a path (or its dirname when isfile)."""
    d = os.path.dirname(path) if isfile else path
    if d:
        os.makedirs(d, exist_ok=True)
    return path


class log2file:
    """Logger writing to stderr and, optionally, a file
    (omni_tools.py:60-76 behavior)."""

    def __init__(self, logpath: Optional[str] = None, auto_newline: bool = True):
        self.fhandle = None
        self.auto_newline = auto_newline
        if logpath is not None:
            makepath(logpath, isfile=True)
            self.fhandle = open(logpath, "a")

    def __call__(self, text: str) -> None:
        if self.auto_newline and not text.endswith("\n"):
            text = text + "\n"
        sys.stderr.write(text)
        if self.fhandle is not None:
            self.fhandle.write(text)
            self.fhandle.flush()


class EarlyStopping:
    """Patience counter over a monitored loss
    (training_tools.py:27-58 behavior)."""

    def __init__(self, patience: int = 7, verbose: bool = False, delta: float = 0.0):
        self.patience = patience
        self.verbose = verbose
        self.delta = delta
        self.counter = 0
        self.best_loss = np.inf
        self.early_stop = False

    def __call__(self, val_loss: float) -> bool:
        if val_loss < self.best_loss - self.delta:
            self.best_loss = val_loss
            self.counter = 0
        else:
            self.counter += 1
            if self.counter >= self.patience:
                self.early_stop = True
        return self.early_stop


def copy2cpu(x: torch.Tensor) -> np.ndarray:
    """Tensor on any device -> numpy (omni_tools.py:24 equivalent)."""
    return x.detach().cpu().numpy()


def resolve_device(device, what: str) -> torch.device:
    """``device`` as a torch.device; None is the first card, and an error
    naming ``what`` without one (no CPU fallback)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(f"{what} runs on an NVIDIA card; pass device='cpu' to run it on the CPU")
        return torch.device("cuda", 0)
    return torch.device(device)
