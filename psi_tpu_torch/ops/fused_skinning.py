"""Fused skinning: the whole LBS vertex path in one kernel, and its backward.

Port of ``psi_tpu.ops.fused_skinning``. Per vertex v and body b:

    vp_y[b,v]  = sum_c cb[b,c] * base_y[c,v]          cb = [1 | betas | pose feature]
    T_xy[b,v]  = sum_j A12[b,j,4x+y] * w[v,j]         (3x4 blended transform)
    out_x      = T_x3 + sum_y T_xy * vp_y
    verts_x    = cam[4x+3] + sum_y cam[4x+y] * out_y  (transl and extrinsics folded in)

Nothing [B, V, *]-shaped is written but the vertices (and, backward, read
but the incoming cotangent).

Numerics: cb and A12 are rounded to bf16 exactly where psi_tpu's
``_pad_operands`` rounds them, the basis and weights are stored bf16,
cam stays f32, and everything accumulates in f32 — the TPU kernel's
numeric tier. The backward rounds the same intermediates to bf16 as
``_bwd_kernel`` (g_vp before the basis product, gout_x*vp_y and gout_x
before the weight product).

Two routes, chosen by the device of the tensors:
* CUDA: kernels K1 (forward) and K2 (backward) in
  ``csrc/fused_skinning.cu``; a launch that fails raises.
* CPU: the plain twins ``fused_skinning_fwd_reference`` and
  ``fused_skinning_bwd_reference`` below (bf16-rounded operands, f32
  matmuls). They are the tests' oracle and the kernels' comparison on
  the card.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from psi_tpu_torch.ops import _cuda

SKIN_FWD = _cuda.Kernel(
    "fused_skinning_fwd", "psi_skin_fwd", "psi_tpu_torch/csrc/fused_skinning.cu",
    "psi_tpu/ops/fused_skinning.py:163",
)
SKIN_BWD = _cuda.Kernel(
    "fused_skinning_bwd", "psi_skin_bwd", "psi_tpu_torch/csrc/fused_skinning.cu",
    "psi_tpu/ops/fused_skinning.py:176",
)


class SkinningBundle(NamedTuple):
    """Constant operands of the fused kernels, built once per fit call.

    Both layouts of each operand are kept: the [*, V] ones are read by
    vertex-parallel threads (forward, and the backward's recompute), the
    [V, *] ones by output-parallel threads (the backward's reductions).
    Nothing is padded: the kernels mask their own ragged edges."""

    base_cv: torch.Tensor  # [3, C, V] bf16: rows [v_template | shapedirs | posedirs]
    base_vc: torch.Tensor  # [3, V, C] bf16
    w_jv: torch.Tensor  # [J, V] bf16 skinning weights
    w_vj: torch.Tensor  # [V, J] bf16
    n_verts: int
    n_feat: int


def make_skinning_bundle(
    v_template: torch.Tensor,  # [V, 3]
    shapedirs: torch.Tensor,  # [V, 3, L]
    posedirs: Optional[torch.Tensor],  # [(J-1)*9, V*3] or None
    lbs_weights: torch.Tensor,  # [V, J]
) -> SkinningBundle:
    V = v_template.shape[0]
    parts = [v_template.T[:, None, :], shapedirs.permute(1, 2, 0)]
    if posedirs is not None:
        P = posedirs.shape[0]
        parts.append(posedirs.reshape(P, V, 3).permute(2, 0, 1))
    base = torch.cat(parts, dim=1).to(torch.bfloat16)  # [3, C, V]
    w = lbs_weights.to(torch.bfloat16)
    return SkinningBundle(
        base_cv=base.contiguous(),
        base_vc=base.transpose(1, 2).contiguous(),
        w_jv=w.T.contiguous(),
        w_vj=w.contiguous(),
        n_verts=V,
        n_feat=base.shape[1],
    )


def _round_operands(cb, A12, cam12):
    """The kernels' input tier: bf16 cb / A12, f32 cam (psi_tpu _pad_operands)."""
    return (
        cb.to(torch.bfloat16).to(torch.float32),
        A12.to(torch.bfloat16).to(torch.float32),
        cam12.to(torch.float32),
    )


def _recompute(cbh, Ah, bundle: SkinningBundle):
    """vp [B, 3, V] and T [B, 12, V] from rounded operands (f32 matmuls)."""
    vp = torch.einsum("bc,ycv->byv", cbh, bundle.base_cv.to(torch.float32))
    T = torch.einsum("bjz,jv->bzv", Ah, bundle.w_jv.to(torch.float32))
    out = [
        T[:, 4 * x + 3] + T[:, 4 * x] * vp[:, 0] + T[:, 4 * x + 1] * vp[:, 1] + T[:, 4 * x + 2] * vp[:, 2]
        for x in range(3)
    ]
    return vp, T, out


def fused_skinning_fwd_reference(cb, A12, cam12, bundle: SkinningBundle) -> torch.Tensor:
    """Plain twin of K1: verts [B, V, 3]. Differentiable by autograd."""
    cbh, Ah, cam = _round_operands(cb, A12, cam12)
    _, _, out = _recompute(cbh, Ah, bundle)
    fin = [
        cam[:, 4 * x + 3, None] + cam[:, 4 * x, None] * out[0]
        + cam[:, 4 * x + 1, None] * out[1] + cam[:, 4 * x + 2, None] * out[2]
        for x in range(3)
    ]
    return torch.stack(fin, dim=-1)


def fused_skinning_bwd_reference(
    cb, A12, cam12, bundle: SkinningBundle, g: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain twin of K2: (g_cb [B, C], g_A12 [B, J, 12], g_cam12 [B, 12]),
    the math and bf16 casts of psi_tpu's ``_bwd_kernel`` written out."""
    bf16 = torch.bfloat16
    cbh, Ah, cam = _round_operands(cb, A12, cam12)
    vp, T, out = _recompute(cbh, Ah, bundle)
    g = g.to(torch.float32)
    gx = [g[..., x] for x in range(3)]  # [B, V] each

    cols = []
    for x in range(3):
        cols.extend(torch.sum(gx[x] * out[y], dim=1) for y in range(3))
        cols.append(torch.sum(gx[x], dim=1))
    g_cam = torch.stack(cols, dim=1)  # [B, 12], column 4x+y

    gout = [
        cam[:, y, None] * gx[0] + cam[:, 4 + y, None] * gx[1] + cam[:, 8 + y, None] * gx[2]
        for y in range(3)
    ]
    base_vc = bundle.base_vc.to(torch.float32)
    g_cb = 0
    for y in range(3):
        g_vp = gout[0] * T[:, y] + gout[1] * T[:, 4 + y] + gout[2] * T[:, 8 + y]
        g_cb = g_cb + g_vp.to(bf16).to(torch.float32) @ base_vc[y]

    w_vj = bundle.w_vj.to(torch.float32)
    planes = []
    for x in range(3):
        planes.extend((gout[x] * vp[:, y]).to(bf16).to(torch.float32) @ w_vj for y in range(3))
        planes.append(gout[x].to(bf16).to(torch.float32) @ w_vj)
    g_A12 = torch.stack(planes, dim=-1)  # [B, J, 12]
    return g_cb, g_A12, g_cam


def _check_operands(cb, A12, cam12, bundle: SkinningBundle):
    B, C = cb.shape
    J = A12.shape[1]
    V = bundle.n_verts
    dev = cb.device
    if C != bundle.n_feat:
        raise ValueError(f"cb has {C} coefficients, the bundle basis {bundle.n_feat}")
    _cuda.check(bundle.base_cv, "base_cv", torch.bfloat16, (3, C, V), dev)
    _cuda.check(bundle.base_vc, "base_vc", torch.bfloat16, (3, V, C), dev)
    _cuda.check(bundle.w_jv, "w_jv", torch.bfloat16, (J, V), dev)
    _cuda.check(bundle.w_vj, "w_vj", torch.bfloat16, (V, J), dev)
    cb16 = cb.detach().to(torch.bfloat16).contiguous()
    a16 = A12.detach().to(torch.bfloat16).contiguous()
    cam = cam12.detach().to(torch.float32).contiguous()
    _cuda.check(a16, "A12", torch.bfloat16, (B, J, 12), dev)
    _cuda.check(cam, "cam12", torch.float32, (B, 12), dev)
    return cb16, a16, cam, (B, C, J, V)


def fused_skinning_fwd(cb, A12, cam12, bundle: SkinningBundle) -> torch.Tensor:
    """verts [B, V, 3]: K1 on a CUDA tensor, the twin on a CPU tensor."""
    if cb.device.type == "cpu":
        return fused_skinning_fwd_reference(cb, A12, cam12, bundle)
    if cb.device.type != "cuda":
        raise ValueError(f"fused skinning runs on cpu or cuda tensors, got {cb.device}")
    cb16, a16, cam, (B, C, J, V) = _check_operands(cb, A12, cam12, bundle)
    out = torch.empty((B, V, 3), dtype=torch.float32, device=cb.device)
    SKIN_FWD.launch(
        cb.device, cb16.data_ptr(), a16.data_ptr(), cam.data_ptr(),
        bundle.base_cv.data_ptr(), bundle.w_jv.data_ptr(), out.data_ptr(),
        B, C, J, V, _cuda.stream_of(cb),
    )
    return out


def fused_skinning_bwd(cb, A12, cam12, bundle: SkinningBundle, g: torch.Tensor):
    """(g_cb, g_A12, g_cam12): K2 on a CUDA tensor, the twin on a CPU tensor.

    K2 is deterministic: per-vertex-tile partials, then a fixed-order
    reduction, with no atomics."""
    if cb.device.type == "cpu":
        return fused_skinning_bwd_reference(cb, A12, cam12, bundle, g)
    if cb.device.type != "cuda":
        raise ValueError(f"fused skinning runs on cpu or cuda tensors, got {cb.device}")
    cb16, a16, cam, (B, C, J, V) = _check_operands(cb, A12, cam12, bundle)
    g = g.detach().to(torch.float32).contiguous()
    _cuda.check(g, "g", torch.float32, (B, V, 3), cb.device)
    vtile = _cuda.library().psi_skin_bwd_vtile()
    K = C + 12 * J + 12
    partial = torch.empty((-(-V // vtile), B, K), dtype=torch.float32, device=cb.device)
    out = torch.empty((B, K), dtype=torch.float32, device=cb.device)
    SKIN_BWD.launch(
        cb.device, cb16.data_ptr(), a16.data_ptr(), cam.data_ptr(),
        bundle.base_cv.data_ptr(), bundle.base_vc.data_ptr(),
        bundle.w_jv.data_ptr(), bundle.w_vj.data_ptr(), g.data_ptr(),
        partial.data_ptr(), out.data_ptr(), B, C, J, V, _cuda.stream_of(cb),
    )
    return out[:, :C], out[:, C : C + 12 * J].reshape(B, J, 12), out[:, C + 12 * J :]


class _FusedSkinning(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cb, A12, cam12, bundle):
        ctx.bundle = bundle
        ctx.save_for_backward(cb, A12, cam12)
        return fused_skinning_fwd(cb, A12, cam12, bundle)

    @staticmethod
    def backward(ctx, g):
        cb, A12, cam12 = ctx.saved_tensors
        g_cb, g_A12, g_cam = fused_skinning_bwd(cb, A12, cam12, ctx.bundle, g)
        return g_cb.to(cb.dtype), g_A12.to(A12.dtype), g_cam.to(cam12.dtype), None


def fused_skinning_apply(
    cb: torch.Tensor,  # [B, C] = [1 | shape_coeffs | pose_feature]
    A12: torch.Tensor,  # [B, J, 12] relative transforms, rows (R | t)
    cam12: torch.Tensor,  # [B, 12] 3x4 rows (camR | camR @ transl + camT)
    bundle: SkinningBundle,
) -> torch.Tensor:
    """verts [B, V, 3] with transl and camera applied; differentiable in
    cb, A12 and cam12 (the backward is K2, or its twin on the CPU)."""
    return _FusedSkinning.apply(cb, A12, cam12, bundle)
