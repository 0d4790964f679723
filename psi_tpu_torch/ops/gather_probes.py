"""Shared-memory gather probes P1-P4 and their plain twins.

Port of the four Pallas kernels of ``scripts/profile_vmem_gather.py``,
which measure gathers from a VMEM-resident table on the TPU (the
candidate replacement for the SDF's packed-row gather from HBM). On the
card the resident table lives in shared memory (``csrc/gather_probes.cu``):

* P1 ``row_gather``      out[i, j] = t[r[i, j], j]          (take_along_axis, axis 0)
* P2 ``lane_gather``     out[i, j] = t[i, l[i, j]]          (axis 1)
* P3 ``chained_gather``  out[n, i, j] = sum_{k < n_gathers} t[n, i, (l[n, i, j] + k) % L],
  summed from 0 in k order
* P4 ``relayout``        out[n, r, :] = sum_{k < n_arrays} (c[n].flat[r] + k), broadcast over L lanes

Tables are f32 and indices int32, as in the probes. P1/P2's indices must
lie in the table (the kernels give NaN for one that does not, the twins
raise); P3 takes its indices mod L, as the probe does.
Dispatch follows the tensors' device: a CPU tensor takes the plain twin,
a CUDA tensor launches the kernel or raises. Kernel and twin agree
exactly: the gathers copy values, and P3/P4 add in the same order.
P1 and P2 move 16 bytes at a time when L is a multiple of 4 and the
tensors' storage is 16-byte aligned (any tensor PyTorch allocates is), and
4 bytes at a time otherwise, e.g. for a contiguous view at an odd offset.
"""

from __future__ import annotations

import torch

from psi_tpu_torch.ops import _cuda

_SRC = "psi_tpu_torch/csrc/gather_probes.cu"
_PROBES = "scripts/profile_vmem_gather.py"
ROW_GATHER = _cuda.Kernel("vmem_row_gather", "psi_probe_row_gather", _SRC, f"{_PROBES}:49")
LANE_GATHER = _cuda.Kernel("vmem_lane_gather", "psi_probe_lane_gather", _SRC, f"{_PROBES}:53")
CHAINED_GATHER = _cuda.Kernel("vmem_chained_gather", "psi_probe_chained_gather", _SRC, f"{_PROBES}:82")
RELAYOUT = _cuda.Kernel("vmem_relayout", "psi_probe_relayout", _SRC, f"{_PROBES}:130")
KERNELS = (ROW_GATHER, LANE_GATHER, CHAINED_GATHER, RELAYOUT)

# the kernels' shared-memory limits: P1 stages at least one column of every
# table row, P2/P3 16 rows of L floats, in a block's 227 KB
_MAX_SMEM_FLOATS = 232448 // 4
MAX_ROW_GATHER_ROWS = _MAX_SMEM_FLOATS
MAX_LANES = _MAX_SMEM_FLOATS // 16


def row_gather_reference(t: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Plain twin of P1."""
    return torch.take_along_dim(t, r.long(), dim=0)


def lane_gather_reference(t: torch.Tensor, l: torch.Tensor) -> torch.Tensor:
    """Plain twin of P2."""
    return torch.take_along_dim(t, l.long(), dim=-1)


def chained_gather_reference(t: torch.Tensor, l: torch.Tensor, n_gathers: int = 8) -> torch.Tensor:
    """Plain twin of P3."""
    L = t.shape[-1]
    acc = torch.zeros_like(t)
    for k in range(n_gathers):
        acc = acc + torch.take_along_dim(t, ((l + k) % L).long(), dim=-1)
    return acc


def relayout_reference(c: torch.Tensor, n_arrays: int = 7, lanes: int = 128) -> torch.Tensor:
    """Plain twin of P4: c [G, A, B] -> [G, A*B, lanes]."""
    flat = c.reshape(c.shape[0], -1)
    acc = torch.zeros_like(flat)
    for k in range(n_arrays):
        acc = acc + (flat + k)
    return acc[..., None].expand(-1, -1, lanes).contiguous()


def _takes_twin(t: torch.Tensor, idx: torch.Tensor, ndim: int, name: str) -> bool:
    """True for a CPU pair (the twin's), False for a CUDA pair that the
    kernels take: one [..] shape of ``ndim`` dims, one device, and on the
    card contiguous f32 and int32. Raises on anything else; each property is
    looked at once."""
    if t.dim() != ndim or idx.shape != t.shape:
        raise ValueError(f"{name} takes a table and an index array of one {ndim}-D shape, "
                         f"got {tuple(t.shape)} and {tuple(idx.shape)}")
    if t.is_cuda and idx.is_cuda:
        if t.get_device() != idx.get_device():
            raise ValueError(f"{name}: table on {t.device}, indices on {idx.device}")
        if t.dtype is not torch.float32 or idx.dtype is not torch.int32:
            raise TypeError(f"{name} takes a float32 table and int32 indices, got {t.dtype} and {idx.dtype}")
        if not (t.is_contiguous() and idx.is_contiguous()):
            raise ValueError(f"{name}: table and indices must be contiguous")
        return False
    dev = t.device
    if idx.device != dev:
        raise ValueError(f"{name}: table on {dev}, indices on {idx.device}")
    if dev.type != "cpu":
        raise ValueError(f"{name} runs on cpu or cuda tensors, got {dev}")
    return True


def row_gather(t: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """P1: t [rows, L] f32, r [rows, L] int32 -> out[i, j] = t[r[i, j], j]."""
    if _takes_twin(t, r, 2, "row_gather"):
        return row_gather_reference(t, r)
    rows, L = t.shape
    if rows > MAX_ROW_GATHER_ROWS:
        raise ValueError(f"row_gather stages a column of every row in shared memory: rows <= {MAX_ROW_GATHER_ROWS}")
    out = torch.empty_like(t)
    ROW_GATHER.launch(t.device, t.data_ptr(), r.data_ptr(), out.data_ptr(), rows, L, _cuda.stream_of(t))
    return out


def lane_gather(t: torch.Tensor, l: torch.Tensor) -> torch.Tensor:
    """P2: t [rows, L] f32, l [rows, L] int32 -> out[i, j] = t[i, l[i, j]]."""
    if _takes_twin(t, l, 2, "lane_gather"):
        return lane_gather_reference(t, l)
    rows, L = t.shape
    if L > MAX_LANES:
        raise ValueError(f"lane_gather stages 16 rows in shared memory: L <= {MAX_LANES}")
    out = torch.empty_like(t)
    LANE_GATHER.launch(t.device, t.data_ptr(), l.data_ptr(), out.data_ptr(), rows, L, _cuda.stream_of(t))
    return out


def chained_gather(t: torch.Tensor, l: torch.Tensor, n_gathers: int = 8) -> torch.Tensor:
    """P3: t [G, rows, L] f32, l [G, rows, L] int32 -> the sum of n_gathers
    lane gathers at l, l + 1, ... (mod L)."""
    if n_gathers < 0:
        raise ValueError("n_gathers must be >= 0")
    if _takes_twin(t, l, 3, "chained_gather"):
        return chained_gather_reference(t, l, n_gathers)
    G, rows, L = t.shape
    if L > MAX_LANES or G > 65535:
        raise ValueError(f"chained_gather takes L <= {MAX_LANES} and at most 65535 bodies")
    out = torch.empty_like(t)
    CHAINED_GATHER.launch(t.device, t.data_ptr(), l.data_ptr(), out.data_ptr(), G, rows, L, n_gathers,
                          _cuda.stream_of(t))
    return out


def relayout(c: torch.Tensor, n_arrays: int = 7, lanes: int = 128) -> torch.Tensor:
    """P4: c [G, A, B] f32 -> [G, A*B, lanes], row r of body n holding
    sum_{k < n_arrays} (c[n].flat[r] + k) in every lane."""
    if c.dim() != 3:
        raise ValueError(f"relayout takes c [G, A, B], got {tuple(c.shape)}")
    if n_arrays < 0 or lanes <= 0 or lanes % 4:
        raise ValueError("relayout takes n_arrays >= 0 and a positive multiple of 4 lanes")
    if c.device.type == "cpu":
        return relayout_reference(c, n_arrays, lanes)
    if c.device.type != "cuda":
        raise ValueError(f"relayout runs on cpu or cuda tensors, got {c.device}")
    _cuda.check(c, "c", torch.float32, tuple(c.shape), c.device)
    G, R = c.shape[0], c.shape[1] * c.shape[2]
    out = torch.empty((G, R, lanes), dtype=torch.float32, device=c.device)
    RELAYOUT.launch(c.device, c.data_ptr(), out.data_ptr(), G, R, lanes, n_arrays, _cuda.stream_of(c))
    return out
