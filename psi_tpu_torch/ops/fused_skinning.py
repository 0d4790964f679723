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
  ``csrc/fused_skinning.cu``, both bf16 tensor-core products summed in
  f32; a launch that fails raises.
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


# The bundle pads C, J and V to these multiples, which csrc/fused_skinning.cu
# (PAD_*) requires and checks; K1 and K2 pad the bodies themselves.
PAD_C, PAD_J, PAD_V = 64, 64, 256
# K1's and K2's launches, the bits of psi_skin_fwd's and psi_skin_bwd's
# `stages`, in launch order
FWD_STAGES = (("pack", 1), ("main", 2))
FWD_ALL = 3
BWD_STAGES = (("pack", 1), ("coef", 2), ("g_cb", 4), ("g_A", 8), ("reduce", 16))
BWD_ALL = 31


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


class SkinningBundle(NamedTuple):
    """Constant operands of the fused kernels, built once per fit call.

    The basis (rows [v_template | shapedirs | posedirs], C of them) and the
    skinning weights, bf16, each in both layouts and zero-padded (C to Cp,
    V to Vp, J to Jp; see PAD_*), so that every row starts 16-byte aligned
    for the kernels' cp.async copies and no tile is ragged. K1 reads the
    K-contiguous copies (base_vcp, w_vjp), K2 all four. The twins read the
    valid region."""

    base_cvp: torch.Tensor  # [3, Cp, Vp] bf16
    base_vcp: torch.Tensor  # [3, Vp, Cp] bf16
    w_jvp: torch.Tensor  # [Jp, Vp] bf16 skinning weights
    w_vjp: torch.Tensor  # [Vp, Jp] bf16
    n_verts: int
    n_feat: int
    n_joints: int


def make_skinning_bundle(
    v_template: torch.Tensor,  # [V, 3]
    shapedirs: torch.Tensor,  # [V, 3, L]
    posedirs: Optional[torch.Tensor],  # [(J-1)*9, V*3] or None
    lbs_weights: torch.Tensor,  # [V, J]
) -> SkinningBundle:
    V, J = lbs_weights.shape
    parts = [v_template.T[:, None, :], shapedirs.permute(1, 2, 0)]
    if posedirs is not None:
        P = posedirs.shape[0]
        parts.append(posedirs.reshape(P, V, 3).permute(2, 0, 1))
    base = torch.cat(parts, dim=1).to(torch.bfloat16)  # [3, C, V]
    w_jv = lbs_weights.T.to(torch.bfloat16)
    C = base.shape[1]
    Cp, Jp, Vp = _ceil_to(C, PAD_C), _ceil_to(J, PAD_J), _ceil_to(V, PAD_V)
    base_cvp = base.new_zeros((3, Cp, Vp))
    base_cvp[:, :C, :V] = base
    w_jvp = w_jv.new_zeros((Jp, Vp))
    w_jvp[:J, :V] = w_jv
    return SkinningBundle(
        base_cvp=base_cvp,
        base_vcp=base_cvp.transpose(1, 2).contiguous(),
        w_jvp=w_jvp,
        w_vjp=w_jvp.T.contiguous(),
        n_verts=V,
        n_feat=C,
        n_joints=J,
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
    V, C, J = bundle.n_verts, bundle.n_feat, bundle.n_joints
    vp = torch.einsum("bc,ycv->byv", cbh, bundle.base_cvp[:, :C, :V].to(torch.float32))
    T = torch.einsum("bjz,jv->bzv", Ah, bundle.w_jvp[:J, :V].to(torch.float32))
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
    V, C, J = bundle.n_verts, bundle.n_feat, bundle.n_joints
    base_vc = bundle.base_vcp[:, :V, :C].to(torch.float32)
    g_cb = 0
    for y in range(3):
        g_vp = gout[0] * T[:, y] + gout[1] * T[:, 4 + y] + gout[2] * T[:, 8 + y]
        g_cb = g_cb + g_vp.to(bf16).to(torch.float32) @ base_vc[y]

    w_vj = bundle.w_vjp[:V, :J].to(torch.float32)
    planes = []
    for x in range(3):
        planes.extend((gout[x] * vp[:, y]).to(bf16).to(torch.float32) @ w_vj for y in range(3))
        planes.append(gout[x].to(bf16).to(torch.float32) @ w_vj)
    g_A12 = torch.stack(planes, dim=-1)  # [B, J, 12]
    return g_cb, g_A12, g_cam


def _check_operands(cb, A12, cam12, bundle: SkinningBundle):
    """The per-body operands as the kernels read them (bf16 cb and A12, f32
    cam12, contiguous) and the sizes (B, C, J, V, Cp, Jp, Vp); raises on a
    shape, type or device that the kernels do not take. The kernels check
    that the padded widths are multiples of their tiles."""
    B, C = cb.shape
    J, V = bundle.n_joints, bundle.n_verts
    dev = cb.device
    if C != bundle.n_feat:
        raise ValueError(f"cb has {C} coefficients, the bundle basis {bundle.n_feat}")
    Vp, Cp = bundle.base_vcp.shape[1:]
    Jp = bundle.w_vjp.shape[1]
    _cuda.check(bundle.base_vcp, "base_vcp", torch.bfloat16, (3, Vp, Cp), dev)
    _cuda.check(bundle.w_vjp, "w_vjp", torch.bfloat16, (Vp, Jp), dev)
    cb16 = cb.detach().to(torch.bfloat16).contiguous()
    a16 = A12.detach().to(torch.bfloat16).contiguous()
    cam = cam12.detach().to(torch.float32).contiguous()
    _cuda.check(a16, "A12", torch.bfloat16, (B, J, 12), dev)
    _cuda.check(cam, "cam12", torch.float32, (B, 12), dev)
    return cb16, a16, cam, (B, C, J, V, Cp, Jp, Vp)


def fwd_operands(cb, A12, cam12, bundle: SkinningBundle, out: Optional[torch.Tensor] = None):
    """K1's launch: (the arguments of psi_skin_fwd before `stages` and the
    stream, the output verts [B, V, 3] that the launch fills, the tensors
    behind the pointers, to be kept alive until the launch). ``out``, if
    given, is filled instead of a new tensor."""
    cb16, a16, cam, dims = _check_operands(cb, A12, cam12, bundle)
    B, _, _, V, Cp, Jp, Vp = dims
    dev = cb.device
    work = torch.empty(_cuda.library().psi_skin_fwd_workspace(B, Cp, Jp, Vp), dtype=torch.uint8, device=dev)
    if out is None:
        out = torch.empty((B, V, 3), dtype=torch.float32, device=dev)
    _cuda.check(out, "out", torch.float32, (B, V, 3), dev)
    tensors = (cb16, a16, cam, bundle.base_vcp, bundle.w_vjp, work, out)
    return (*(t.data_ptr() for t in tensors), *dims), out, tensors


def fused_skinning_fwd(cb, A12, cam12, bundle: SkinningBundle) -> torch.Tensor:
    """verts [B, V, 3]: K1 on a CUDA tensor, the twin on a CPU tensor.

    K1 sums nothing across blocks: two runs give equal bits."""
    if cb.device.type == "cpu":
        return fused_skinning_fwd_reference(cb, A12, cam12, bundle)
    if cb.device.type != "cuda":
        raise ValueError(f"fused skinning runs on cpu or cuda tensors, got {cb.device}")
    args, out, _ = fwd_operands(cb, A12, cam12, bundle)
    SKIN_FWD.launch(cb.device, *args, FWD_ALL, _cuda.stream_of(cb))
    return out


def bwd_operands(cb, A12, cam12, bundle: SkinningBundle, g: torch.Tensor):
    """K2's launch: (the arguments of psi_skin_bwd before `stages` and the
    stream, the outputs (g_cb, g_A12, g_cam12) that the launch fills, the
    tensors behind the pointers, to be kept alive until the launch)."""
    cb16, a16, cam, dims = _check_operands(cb, A12, cam12, bundle)
    B, C, J, V, Cp, Jp, Vp = dims
    dev = cb.device
    _cuda.check(bundle.base_cvp, "base_cvp", torch.bfloat16, (3, Cp, Vp), dev)
    _cuda.check(bundle.w_jvp, "w_jvp", torch.bfloat16, (Jp, Vp), dev)
    g = g.detach().to(torch.float32).contiguous()
    _cuda.check(g, "g", torch.float32, (B, V, 3), dev)
    work = torch.empty(_cuda.library().psi_skin_bwd_workspace(B, Cp, Jp, Vp), dtype=torch.uint8, device=dev)
    outs = tuple(torch.empty(s, dtype=torch.float32, device=dev) for s in ((B, C), (B, J, 12), (B, 12)))
    tensors = (cb16, a16, cam, bundle.base_cvp, bundle.base_vcp, bundle.w_jvp, bundle.w_vjp, g, work, *outs)
    return (*(t.data_ptr() for t in tensors), *dims), outs, tensors


def fused_skinning_bwd(cb, A12, cam12, bundle: SkinningBundle, g: torch.Tensor):
    """(g_cb, g_A12, g_cam12): K2 on a CUDA tensor, the twin on a CPU tensor.

    K2 is deterministic: split-K partials, then a fixed-order reduction,
    with no atomics."""
    if cb.device.type == "cpu":
        return fused_skinning_bwd_reference(cb, A12, cam12, bundle, g)
    if cb.device.type != "cuda":
        raise ValueError(f"fused skinning runs on cpu or cuda tensors, got {cb.device}")
    args, outs, _ = bwd_operands(cb, A12, cam12, bundle, g)
    SKIN_BWD.launch(cb.device, *args, BWD_ALL, _cuda.stream_of(cb))
    return outs


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
