"""ctypes bindings for the native host runtime (``native/psi_native.cpp``).

Port of ``psi_tpu.data.native_loader``, same C entry points and signatures:

* ``pack_dataset`` — write the .psipack flat binary from host arrays (a
  one-time conversion of HDF5 or snapshot data); ``hdf5_to_pack`` does it
  for the reference's HDF5 files;
* ``NativeBatchGenerator`` — the batch-generator protocol of
  ``data/hdf5.py`` over the mmap'd C++ loader, whose background thread
  assembles the next batch while the card trains on this one; its shuffle
  is seeded, so two processes with one seed read the same batches;
* ``chamfer_nn_cpu`` — brute-force nearest neighbours on the host (a
  verification twin of kernel K3).

The library is built from the repository's ``native/psi_native.cpp`` by
``g++`` at first use into ``build/native/libpsi_native_<hash>.so`` (a
directory git ignores; the hash covers the source and the flags), never
beside the source. The build runs under a lock and through a temporary
name of its own, so threads and ranks that start together build once each
and never load a partial file. Nothing degrades: a failed build raises with
the compiler's output, and no Python loader stands in for the native one.
Batches are numpy arrays on the host; ``TrainOP`` stages them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Optional

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
SRC_PATH = ROOT / "native" / "psi_native.cpp"
BUILD_DIR = ROOT / "build" / "native"
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared"]  # psi_tpu's :36-37

_IMG = 128 * 128

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def library_path() -> Path:
    h = hashlib.sha256(SRC_PATH.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libpsi_native_{h.hexdigest()[:16]}.so"


def build_library() -> Path:
    """Compile the source into the hashed library unless it exists; raises
    with the compiler's stderr when that fails."""
    out = library_path()
    with _lock:
        if out.exists():
            return out
        cxx = shutil.which("g++")
        if cxx is None:
            raise RuntimeError(f"g++ not found on PATH: the native loader is built from {SRC_PATH}")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp_name = tempfile.mkstemp(prefix=f"{out.stem}.", suffix=".tmp.so", dir=BUILD_DIR)
        os.close(fd)
        tmp = Path(tmp_name)
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SRC_PATH)], capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed ({proc.returncode}) on {SRC_PATH}:\n{proc.stderr[-4000:]}")
        os.chmod(tmp, 0o755)  # mkstemp made it 0600
        os.replace(tmp, out)  # atomic: a concurrent loader never sees a partial file
        return out


def get_lib() -> ctypes.CDLL:
    """The loaded library, built on first call."""
    global _lib
    if _lib is None:
        path = build_library()
        with _lock:
            if _lib is None:
                lib = ctypes.CDLL(str(path))
                f32p = ctypes.POINTER(ctypes.c_float)
                i32p = ctypes.POINTER(ctypes.c_int)
                lib.chamfer_nn.argtypes = [f32p, ctypes.c_int, f32p, ctypes.c_int, f32p, i32p]
                lib.chamfer_nn.restype = None
                lib.pack_write.argtypes = [ctypes.c_char_p] + [f32p] * 6 + [i32p, ctypes.c_int]
                lib.pack_write.restype = ctypes.c_int
                lib.loader_create.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_uint64, ctypes.c_int]
                lib.loader_create.restype = ctypes.c_void_p
                lib.loader_num_samples.argtypes = [ctypes.c_void_p]
                lib.loader_num_samples.restype = ctypes.c_int
                lib.loader_next.argtypes = [ctypes.c_void_p] + [f32p] * 6 + [i32p]
                lib.loader_next.restype = ctypes.c_int
                lib.loader_reset.argtypes = [ctypes.c_void_p]
                lib.loader_reset.restype = None
                lib.loader_destroy.argtypes = [ctypes.c_void_p]
                lib.loader_destroy.restype = None
                _lib = lib
    return _lib


def native_available() -> bool:
    """Whether the library builds and loads here."""
    try:
        get_lib()
    except (RuntimeError, OSError):
        return False
    return True


def _fp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _ip(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int))


def chamfer_nn_cpu(x: np.ndarray, y: np.ndarray):
    """x [N, 3], y [M, 3] -> (squared dist [N], idx [N]); native brute force."""
    x = np.ascontiguousarray(x, np.float32)
    y = np.ascontiguousarray(y, np.float32)
    if x.ndim != 2 or y.ndim != 2 or x.shape[1] != 3 or y.shape[1] != 3 or len(y) == 0:
        raise ValueError(f"chamfer_nn_cpu takes x [N, 3] and y [M, 3] with M > 0, got {x.shape} and {y.shape}")
    lib = get_lib()
    dist = np.empty(len(x), np.float32)
    idx = np.empty(len(x), np.int32)
    lib.chamfer_nn(_fp(x), len(x), _fp(y), len(y), _fp(dist), _ip(idx))
    return dist, idx


def pack_dataset(
    path: str,
    depth: np.ndarray,
    seg: np.ndarray,
    body: np.ndarray,
    cam_ext: np.ndarray,
    cam_int: np.ndarray,
    max_d: np.ndarray,
    sceneid: np.ndarray,
) -> str:
    """Write the .psipack flat binary (n samples)."""
    lib = get_lib()
    n = depth.shape[0]
    args = [
        np.ascontiguousarray(depth, np.float32).reshape(n, _IMG),
        np.ascontiguousarray(seg, np.float32).reshape(n, _IMG),
        np.ascontiguousarray(body, np.float32).reshape(n, 72),
        np.ascontiguousarray(cam_ext, np.float32).reshape(n, 16),
        np.ascontiguousarray(cam_int, np.float32).reshape(n, 9),
        np.ascontiguousarray(max_d, np.float32).reshape(n),
    ]
    sid = np.ascontiguousarray(sceneid, np.int32).reshape(n)
    rc = lib.pack_write(str(path).encode(), *[_fp(a) for a in args], _ip(sid), n)
    if rc != 0:
        raise OSError(f"pack_write failed: {path}")
    return path


def hdf5_to_pack(hdf5_paths, pack_path: str) -> str:
    """Convert reference-format HDF5(s) (what ``data/hdf5.py::_load_streams``
    reads: row 0 of each file is a placeholder) to the native pack."""
    from psi_tpu_torch.data.hdf5 import _load_streams

    s = _load_streams(hdf5_paths)
    n = s["depth"].shape[0]
    return pack_dataset(
        pack_path,
        s["depth"].reshape(n, -1), s["seg"].reshape(n, -1),
        s["body"].reshape(n, -1), s["cam_ext"].reshape(n, -1),
        s["cam_int"].reshape(n, -1), s["max_d"].reshape(n),
        s["sceneid"].reshape(n).astype(np.int32),
    )


class NativeBatchGenerator:
    """The batch-generator protocol (has_next_batch / next_batch / reset) over
    the C++ prefetching loader: one epoch serves every sample once, in an
    order shuffled from ``seed``; ``scene_idx`` is the pack's scene id."""

    def __init__(self, pack_path: str, batch_size: int, seed: int = 0):
        self._lib = get_lib()
        self.batch_size = batch_size
        self._h = self._lib.loader_create(str(pack_path).encode(), batch_size, seed, 1)
        if not self._h:
            raise OSError(f"loader_create failed: {pack_path}")
        self.n_samples = self._lib.loader_num_samples(self._h)
        self._served = 0
        b = batch_size
        self._depth = np.empty((b, 128, 128), np.float32)
        self._seg = np.empty((b, 128, 128), np.float32)
        self._body = np.empty((b, 72), np.float32)
        self._cam_ext = np.empty((b, 4, 4), np.float32)
        self._cam_int = np.empty((b, 3, 3), np.float32)
        self._max_d = np.empty(b, np.float32)
        self._sceneid = np.empty(b, np.int32)

    def has_next_batch(self) -> bool:
        return self._served + self.batch_size <= self.n_samples

    def reset(self) -> None:
        """Start the next epoch, reshuffled."""
        self._lib.loader_reset(self._h)
        self._served = 0

    def next_batch(self, batch_size: Optional[int] = None) -> Optional[Dict[str, np.ndarray]]:
        """The next batch of ``self.batch_size`` (the argument is the
        protocol's and must match), or None at the end of the epoch."""
        if batch_size is not None and batch_size != self.batch_size:
            raise ValueError(f"this loader serves batches of {self.batch_size}, not {batch_size}")
        ok = self._lib.loader_next(
            self._h, _fp(self._depth), _fp(self._seg), _fp(self._body),
            _fp(self._cam_ext), _fp(self._cam_int), _fp(self._max_d), _ip(self._sceneid),
        )
        if not ok:
            return None
        self._served += self.batch_size
        return {
            "xs": np.stack([self._depth, self._seg], axis=-1),
            "xh": self._body.copy(),
            "cam_ext": self._cam_ext.copy(),
            "cam_int": self._cam_int.copy(),
            "max_d": self._max_d.copy(),
            "scene_idx": self._sceneid.copy(),
        }

    def close(self) -> None:
        """Stop the prefetch thread and unmap the pack."""
        if getattr(self, "_h", None):
            self._lib.loader_destroy(self._h)
            self._h = None

    def __del__(self):
        self.close()
