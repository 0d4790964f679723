"""The einsum decode's per-vertex tail: kernel K6, its twin and its gradient.

After the skinning blend, each vertex of the 'high' and 'fast' LBS tiers
goes through its blended 3x4 transform, the body's translation and, when
the caller has one, the camera extrinsics:

    verts = E33 (T33 v + T3 + transl) + E3

``vertex_tail(T12, v_posed, transl, cam_ext)`` computes it, T12 the blend's
[B, V, 12] output (row-major 3x4, K4's layout), v_posed [B, V, 3], transl
[B, 3] or None, cam_ext [B, 4, 4] or None.

* CUDA tensors: kernel K6 (``csrc/vertex_tail.cu``), one launch forward,
  one backward (the per-vertex pass and a fixed-order reduction for
  transl's gradient): f32 with fused multiply-adds, no TF32, no atomics.
  The wrapper raises on what the kernel does not take (a dtype other than
  float32, a non-contiguous operand, a T12 not 16-byte aligned, a cam_ext
  that requires a gradient: no caller differentiates through the camera);
  it never falls back to the twin.
* CPU tensors: the plain twin ``vertex_tail_reference``, the einsum chain
  the decode ran before K6, operation for operation; autograd differentiates
  it, so the CPU's numbers are the chain's.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from psi_tpu_torch.geometry.camera import verts_transform
from psi_tpu_torch.ops import _cuda

VTAIL_FWD = _cuda.Kernel(
    "vertex_tail_fwd", "psi_vtail_fwd", "psi_tpu_torch/csrc/vertex_tail.cu",
    "none: psi_tpu/body/lbs.py:198's apply, transl and verts_transform, fused by XLA",
)
VTAIL_BWD = _cuda.Kernel(
    "vertex_tail_bwd", "psi_vtail_bwd", "psi_tpu_torch/csrc/vertex_tail.cu",
    "none: their transpose, fused by XLA",
)


def vertex_tail_reference(T12: torch.Tensor, v_posed: torch.Tensor, transl: Optional[torch.Tensor],
                          cam_ext: Optional[torch.Tensor]) -> torch.Tensor:
    """Plain twin of K6: the 3x4 apply of ``lbs``, then ``+ transl`` and
    ``verts_transform``, as the decode chained them."""
    T34 = T12.reshape(T12.shape[0], -1, 3, 4)
    verts = torch.einsum("bvxy,bvy->bvx", T34[..., :3], v_posed) + T34[..., 3]
    if transl is not None:
        verts = verts + transl[:, None, :]
    if cam_ext is not None:
        verts = verts_transform(verts, cam_ext)
    return verts


def _check(T12, v_posed, transl, cam_ext) -> None:
    B, V = v_posed.shape[:2]
    dev = T12.device
    _cuda.check(T12, "T12", torch.float32, (B, V, 12), dev)
    _cuda.check(v_posed, "v_posed", torch.float32, (B, V, 3), dev)
    if T12.data_ptr() % 16:
        raise ValueError("T12 must be 16-byte aligned (K6 reads a vertex's 3x4 as three float4)")
    if transl is not None:
        _cuda.check(transl, "transl", torch.float32, (B, 3), dev)
    if cam_ext is not None:
        _cuda.check(cam_ext, "cam_ext", torch.float32, (B, 4, 4), dev)
        if cam_ext.requires_grad:
            raise ValueError("K6 takes no gradient to cam_ext: pass it detached")


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


class _VertexTail(torch.autograd.Function):
    """K6 forward and backward. transl and cam_ext may be None."""

    @staticmethod
    def forward(ctx, T12, v_posed, transl, cam_ext):
        B, V = v_posed.shape[:2]
        out = torch.empty((B, V, 3), dtype=torch.float32, device=T12.device)
        VTAIL_FWD.launch(T12.device, T12.data_ptr(), v_posed.data_ptr(), _ptr(transl), _ptr(cam_ext),
                         out.data_ptr(), B, V, _cuda.stream_of(out))
        ctx.has_transl = transl is not None
        ctx.save_for_backward(T12, v_posed, cam_ext)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        T12, v_posed, cam_ext = ctx.saved_tensors
        B, V = v_posed.shape[:2]
        dev = T12.device
        g = g.to(torch.float32).contiguous()
        gT = torch.empty((B, V, 12), dtype=torch.float32, device=dev)
        gv = torch.empty((B, V, 3), dtype=torch.float32, device=dev)
        gt = work = None
        if ctx.has_transl:
            gt = torch.empty((B, 3), dtype=torch.float32, device=dev)
            work = torch.empty(_cuda.library().psi_vtail_bwd_workspace(B, V), dtype=torch.uint8, device=dev)
        VTAIL_BWD.launch(dev, T12.data_ptr(), v_posed.data_ptr(), _ptr(cam_ext), g.data_ptr(), gT.data_ptr(),
                         gv.data_ptr(), _ptr(gt), _ptr(work), B, V, _cuda.stream_of(gT))
        need = ctx.needs_input_grad
        return (gT if need[0] else None), (gv if need[1] else None), (gt if need[2] else None), None


def vertex_tail(T12: torch.Tensor, v_posed: torch.Tensor, transl: Optional[torch.Tensor] = None,
                cam_ext: Optional[torch.Tensor] = None) -> torch.Tensor:
    """verts [B, V, 3] = cam_ext applied to (T12's 3x4 applied to v_posed,
    plus transl): K6 on CUDA tensors, the twin on CPU tensors."""
    if T12.device.type == "cpu":
        return vertex_tail_reference(T12, v_posed, transl, cam_ext)
    if T12.device.type != "cuda":
        raise ValueError(f"vertex_tail runs on cpu or cuda tensors, got {T12.device}")
    _check(T12, v_posed, transl, cam_ext)
    return _VertexTail.apply(T12, v_posed, transl, cam_ext)
