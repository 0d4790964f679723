"""Process groups: the opt-in initialisation and the port's two collectives.

Port of ``psi_tpu.parallel.distributed``. psi_tpu joins hosts with
``jax.distributed`` and lets GSPMD place the collectives; here each rank is
one process with one device, joined by ``torch.distributed``, and the code
that runs across ranks calls its collectives itself. Only two are used
anywhere in the port: a SUM all-reduce and a broadcast from rank 0. A gather
is an all-reduce of a buffer filled with -0.0 in which each rank writes its
own rows (``x + -0.0 == x`` for every float ``x``, -0.0 included, so the
gathered rows keep their bits). That pair runs under NCCL across cards,
under gloo on the CPU, and under gloo with CUDA tensors: two ranks on one
card, which NCCL refuses (torch's gloo backend takes CUDA tensors for both
collectives and stages them through host memory itself).

``ensure_distributed`` is opt-in exactly as psi_tpu's
(psi_tpu/parallel/distributed.py:52-57): with no coordinator given by
argument or environment it does nothing and returns False, so every entry
point may call it. The environment is torch's own: ``MASTER_ADDR`` and
``MASTER_PORT`` (the coordinator), ``WORLD_SIZE``, ``RANK`` and
``LOCAL_RANK`` (the card of the rank).
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v is not None else None


def rank_device(device, rank: int) -> torch.device:
    """The device of ``rank``: ``device`` when given, else the card
    ``LOCAL_RANK`` (or ``rank``); raises without that card."""
    if device is not None:
        return torch.device(device)
    local = _env_int("LOCAL_RANK")
    local = rank if local is None else local
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if local >= count:
        raise RuntimeError(f"rank {rank} wants card {local} but {count} NVIDIA card(s) are present; "
                           "pass device='cpu' to run the rank on the CPU")
    return torch.device("cuda", local)


def ensure_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    init_method: Optional[str] = None,
    device=None,
) -> bool:
    """Join the process group once, if a multi-process run is configured.

    Returns True when this process is (or now is) one rank of a group, False
    when no coordinator is given (a single-process run: nothing is done).
    The coordinator is ``init_method`` (any of torch's: ``tcp://host:port``,
    ``file:///path``), else ``coordinator_address`` ("host:port"), else
    ``MASTER_ADDR``:``MASTER_PORT``. The backend is ``backend`` when given,
    else NCCL for a CUDA device and gloo for the CPU; the device is
    ``rank_device(device, rank)``, and a card is made the current one."""
    if dist.is_initialized():
        return True
    if init_method is None:
        if coordinator_address is None and os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
            coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
        if coordinator_address is None:
            return False  # single-process run
        init_method = f"tcp://{coordinator_address}"
    world = num_processes if num_processes is not None else _env_int("WORLD_SIZE")
    rank = process_id if process_id is not None else _env_int("RANK")
    if world is None or rank is None:
        raise ValueError("a process group needs its size and this rank: pass num_processes and process_id "
                         "or set WORLD_SIZE and RANK")
    dev = rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend or ("nccl" if dev.type == "cuda" else "gloo"),
                            init_method=init_method, world_size=world, rank=rank)
    return True


def global_mesh(axis_name: str = "dp", device=None):
    """The 1-D mesh over every rank of the group (``mesh.make_mesh``)."""
    from psi_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(axis_name=axis_name, device=device)


def is_primary() -> bool:
    """True on the process that writes checkpoints and logs: rank 0, or the
    only process when there is no group."""
    return not dist.is_initialized() or dist.get_rank() == 0


def all_reduce_sum_(t: torch.Tensor, mesh) -> torch.Tensor:
    """Sum ``t`` over the ranks, in place; returns ``t``."""
    dist.all_reduce(t.detach(), op=dist.ReduceOp.SUM, group=mesh.group)
    return t


def broadcast_(t: torch.Tensor, mesh, src: int = 0) -> torch.Tensor:
    """Overwrite ``t`` with rank ``src``'s, in place; returns ``t``."""
    dist.broadcast(t.detach(), src, group=mesh.group)
    return t


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks; the gradient of each rank's input is the sum of
    every rank's output gradient (every rank must run the backward)."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return all_reduce_sum_(t.clone(), mesh)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum_(g.clone(), ctx.mesh), None


def all_reduce_sum(t: torch.Tensor, mesh) -> torch.Tensor:
    """Sum ``t`` over the ranks into a new tensor, differentiably."""
    return _AllReduceSum.apply(t, mesh)


def gather_rows(local: torch.Tensor, mesh, dim: int = 0) -> torch.Tensor:
    """Every rank's ``local`` stacked along ``dim`` in rank order, on every
    rank, bit for bit: one all-reduce of a -0.0 buffer (ranks hold equal
    shards)."""
    n = local.shape[dim]
    shape = list(local.shape)
    shape[dim] = n * mesh.size
    fill = -0.0 if local.is_floating_point() else 0
    out = torch.full(shape, fill, dtype=local.dtype, device=local.device)
    out.narrow(dim, mesh.rank * n, n).copy_(local)
    return all_reduce_sum_(out, mesh)
