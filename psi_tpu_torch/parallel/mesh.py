"""The 1-D data/population mesh over a process group, and its helpers.

Port of ``psi_tpu.parallel.mesh``. psi_tpu's mesh is a ``jax.sharding.Mesh``
over devices and GSPMD splits global arrays over it. Here the mesh is the
initialised ``torch.distributed`` group, one rank a process and a device,
and each rank keeps its own rows of a global array explicitly:

* training: every rank reads the same global batch and keeps its rows
  (``shard_batch``); weights start equal (``replicate``) and stay equal
  because the gradients are summed over the ranks before each step;
* generation and fitting: every rank samples the whole population and fits
  its rows; the fitted rows are gathered on every rank.

``mesh.size`` is the number of ranks, as psi_tpu's ``mesh.size`` is the
number of devices. There is no mesh without a group: ``make_mesh`` raises
rather than hand back a one-device mesh the caller did not ask for.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch
import torch.distributed as dist

from psi_tpu_torch.parallel.distributed import broadcast_


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of the group: its rank, the rank count, its device,
    the group and its backend ('nccl' or 'gloo')."""

    rank: int
    size: int
    device: torch.device
    group: Any
    backend: str
    axis_names: Tuple[str, ...] = ("dp",)

    def rows(self, n: int) -> Tuple[int, int]:
        """[lo, hi) of this rank's rows of a global axis of ``n``."""
        if n % self.size:
            raise ValueError(f"{n} rows do not divide evenly over the {self.size}-rank mesh")
        k = n // self.size
        return self.rank * k, (self.rank + 1) * k


def make_mesh(n_devices=None, axis_name: str = "dp", device=None) -> Mesh:
    """The 1-D mesh over the initialised process group (see
    ``distributed.ensure_distributed``). ``n_devices``, when given, must be
    the group's size. ``device`` is this rank's device: by default its
    current card under NCCL and the CPU under gloo."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group (distributed.ensure_distributed); "
                           "for one device pass mesh=None")
    size = dist.get_world_size()
    if n_devices is not None and n_devices != size:
        raise ValueError(f"n_devices={n_devices} but the process group has {size} ranks")
    backend = str(dist.get_backend())
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device()) if backend == "nccl" else torch.device("cpu")
    return Mesh(rank=dist.get_rank(), size=size, device=torch.device(device), group=dist.group.WORLD,
                backend=backend, axis_names=(axis_name,))


def shard_batch(batch: Dict[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """This rank's rows of every leaf of a global batch (numpy arrays or
    tensors, leading axis divisible by ``mesh.size``)."""
    lo, hi = mesh.rows(len(next(iter(batch.values()))))
    return {k: v[lo:hi] for k, v in batch.items()}


def replicate(obj: Any, mesh: Mesh) -> Any:
    """Make ``obj`` rank 0's on every rank, in place, and return it: a module
    (its parameters and buffers), a tensor, or a dict, list or tuple of them."""
    if isinstance(obj, torch.nn.Module):
        for t in list(obj.parameters()) + list(obj.buffers()):
            broadcast_(t, mesh)
    elif isinstance(obj, torch.Tensor):
        broadcast_(obj, mesh)
    elif isinstance(obj, dict):
        for v in obj.values():
            replicate(v, mesh)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            replicate(v, mesh)
    else:
        raise TypeError(f"replicate takes a module, a tensor or a dict, list or tuple of them, not {type(obj)}")
    return obj


def pad_to_multiple(n: int, k: int) -> int:
    return -(-n // k) * k
