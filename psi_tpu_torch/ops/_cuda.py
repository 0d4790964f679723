"""Build, load and launch the hand-written CUDA kernels under ``csrc/``.

Every ``csrc/*.cu`` file is compiled for ``sm_90a`` by its own ``nvcc``
call, all of them at once, and linked into one shared library with a plain
C interface, at first use, under
``build/kernels/`` beside the package (a directory git ignores). The
library name carries a hash of the sources and flags, so an edited
source is rebuilt and an unchanged one is loaded as it is. The library
is bound with ``ctypes``: pointers and the stream are ``c_void_p``, from
``Tensor.data_ptr()`` and the current stream's handle (``stream_of``).

Each C entry point launches on the stream it is given, allocates
nothing, and returns ``cudaGetLastError()`` after its launches; a
``Kernel`` raises when that is not 0 and otherwise counts the launch.
Nothing here runs when a module is imported: there is no ``nvcc`` on a
CPU-only machine, and the CPU path never reaches this file.

Threads: the build and the load are taken under one lock, so two threads
that launch their first kernel together build once and load once, and the
compiler writes to a temporary name no other thread or process can hold.
A launch itself takes no lock; its count is raised under the kernel's own
lock, so ``Kernel.launches`` stays exact while several threads launch (a
router's workers, one a model).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills per kernel, into the build log
]

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C signature of every entry point: (argtypes); each returns int (cudaError_t)
# unless RESTYPES says otherwise
SIGNATURES: Dict[str, List] = {
    "psi_skin_fwd": [_P] * 7 + [_I] * 8 + [_P],
    "psi_skin_fwd_workspace": [_I] * 4,
    "psi_skin_fwd_smem": [],
    "psi_skin_bwd": [_P] * 12 + [_I] * 8 + [_P],
    "psi_skin_bwd_workspace": [_I] * 4,
    "psi_nn_argmin": [_P] * 3 + [_I] * 3 + [_P],
    "psi_probe_row_gather": [_P] * 3 + [_I] * 2 + [_P],
    "psi_probe_lane_gather": [_P] * 3 + [_I] * 2 + [_P],
    "psi_probe_chained_gather": [_P] * 3 + [_I] * 4 + [_P],
    "psi_probe_relayout": [_P] * 2 + [_I] * 4 + [_P],
    "psi_probe_smem_opt_ins": [],
    "psi_split_mm": [_P] * 3 + [_I] * 4 + [_L] * 7 + [_I] + [_L] * 4 + [_I, _P],
    "psi_split_mm_grad_workspace": [_I] * 4,
    "psi_split_mm_grad": [_P] * 4 + [_I] * 5 + [_L] * 7 + [_I] + [_L] * 4 + [_I, _I, _P],
}
RESTYPES = {"psi_skin_fwd_workspace": ctypes.c_size_t, "psi_skin_bwd_workspace": ctypes.c_size_t,
            "psi_split_mm_grad_workspace": ctypes.c_size_t}

_library: Optional[ctypes.CDLL] = None
_build_lock = threading.RLock()  # library() holds it around build_library()


def find_nvcc() -> str:
    """nvcc from CUDA_HOME, then PATH, then /usr/local/cuda/bin; raises if none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and /usr/local/cuda/bin); "
        "the CUDA kernels of psi_tpu_torch need the CUDA toolkit to build"
    )


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256()
    for f in sources():
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libpsi_kernels_{h.hexdigest()[:16]}.so"


def build_library() -> Path:
    """Compile csrc/*.cu into the hashed shared library unless it exists:
    one ``nvcc -c`` a source, all started together, then one link. The
    compilers' output (ptxas resource usage) goes to ``<lib>.log``. One
    thread of a process builds at a time; the others find the file."""
    out = library_path()
    with _build_lock:
        if out.exists():
            return out
        nvcc = find_nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # a directory of its own: another process building the same sources never shares it
        with tempfile.TemporaryDirectory(prefix=f"{out.stem}.", dir=BUILD_DIR) as work:
            cus = [s for s in sources() if s.suffix == ".cu"]
            objs = [str(Path(work) / f"{s.stem}.o") for s in cus]
            compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
            cmds = [[nvcc, *compile_flags, "-c", "-o", o, str(s)] for s, o in zip(cus, objs)]
            tmp = str(Path(work) / out.name)
            with ThreadPoolExecutor(max_workers=len(cmds)) as pool:
                procs = list(pool.map(lambda c: subprocess.run(c, capture_output=True, text=True), cmds))
            if all(p.returncode == 0 for p in procs):
                cmds.append([nvcc, *NVCC_FLAGS, "-o", tmp, *objs])
                procs.append(subprocess.run(cmds[-1], capture_output=True, text=True))
            out.with_suffix(".log").write_text(
                "".join(" ".join(c) + "\n" + p.stdout + p.stderr for c, p in zip(cmds, procs)))
            failed = [p for p in procs if p.returncode != 0]
            if failed:
                raise RuntimeError(f"nvcc failed ({failed[0].returncode}):\n{failed[0].stderr[-4000:]}")
            os.chmod(tmp, 0o755)
            os.replace(tmp, out)  # atomic: a concurrent loader never sees a partial file
        return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call). Safe to call from
    several threads at once: the first builds and loads, the rest wait."""
    global _library
    if _library is None:
        with _build_lock:
            if _library is None:  # checked again: another thread may have loaded it meanwhile
                lib = ctypes.CDLL(str(build_library()))
                for name, argtypes in SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.argtypes = argtypes
                    fn.restype = RESTYPES.get(name, ctypes.c_int)
                _library = lib
    return _library


def stream_of(t: torch.Tensor) -> int:
    """The handle (cudaStream_t, as an int) of the current stream of ``t``'s
    device, without building a ``torch.cuda.Stream`` around it."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


class Kernel:
    """One hand-written kernel: its C entry point and its launch count.

    ``launches`` is raised by one, under a lock, each time ``launch`` runs
    the kernel and its launch is accepted. Callers that want the count of
    one run set it to 0 before and read it after.
    """

    def __init__(self, name: str, symbol: str, source: str, replaces: str):
        self.name = name
        self.symbol = symbol
        self.source = source  # path of the CUDA source, relative to the repo root
        self.replaces = replaces  # the Pallas kernel it ports, file:line
        self.launches = 0
        self._entry = None  # the bound C function, looked up at the first launch
        self._count_lock = threading.Lock()

    def launch(self, device: torch.device, *args) -> None:
        entry = self._entry
        if entry is None:
            entry = self._entry = getattr(library(), self.symbol)
        if device.index == torch._C._cuda_getDevice():
            err = entry(*args)
        else:  # the entry point launches on the current device: make it the tensors'
            with torch.cuda.device(device):
                err = entry(*args)
        if err != 0:
            raise RuntimeError(f"{self.name}: CUDA launch failed with cudaError {err}")
        with self._count_lock:
            self.launches += 1


def check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple, device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on ``device``."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
