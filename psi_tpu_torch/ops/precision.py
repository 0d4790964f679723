"""Split-bf16 products: about float32 accuracy from bf16 tensor-core products.

Port of ``psi_tpu.ops.precision``, the numerics of psi_tpu's 'high' LBS
tier. Each operand is cut into a high and a low bf16 half, hi = x rounded
to the nearest even bf16 and lo = bf16(x - hi), so that x = hi + lo to
about 2^-16 relative, and

    a.b  ~=  ah.bh + al.bh + ah.bl        (the ~2^-32 al.bl term dropped)

is ONE bf16 contraction over a 3x-widened K: the lhs widened as (hi, lo,
hi) blocks, the rhs as (hi, hi, lo), every product exact in f32 and the
sum taken in f32.

The gradient is the transpose that JAX derives for that program. Each
operand's three cotangent blocks are the f32 output cotangent contracted
with the other operand's matching bf16 blocks, summed in f32 and rounded
to bf16. Then, through the split (rp = round to bf16 and back):
    lhs blocks (c1, c2, c3) = (hi, lo, hi):  grad = c2 + rp(f32(bf16(c1 + c3)) - c2)
    rhs blocks (d1, d2, d3) = (hi, hi, lo):  grad = d3 + rp(f32(bf16(d1 + d2)) - d3)
In both, one block pairs the cotangent with the other operand's hi half
twice: with H = bf16(g . other_hi) and L = bf16(g . other_lo) the gradient
is H + rp(f32(bf16(H + L)) - H). The rounding of the cotangent makes the
'high' gradients bf16-class (~1e-3 relative), as psi_tpu's are.

Two routes, chosen by the device of the tensors:
* CUDA: kernel K4 (the forward) and K5 (a gradient) in
  ``csrc/split_bf16.cu``, bf16 ``mma.sync`` products summed in f32, the
  hi/lo cut made as the tiles are loaded; a launch that fails raises.
  K5 serves the gradient of every operand that is not shared across the
  batch; that of a shared operand (the skinning weights of the blend, a 2-D
  lhs under a batched rhs) raises ``NotImplementedError`` there.
* CPU: the plain twins, ``split_product_reference`` and
  ``split_product_grad_reference``: products of the bf16-valued halves (each
  exact in f32), the forward summed in float64 and rounded once, the
  cotangent blocks summed in f32, and the gradient as written above. They
  are the tests' oracle and the kernels' comparison on the card.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from psi_tpu_torch.ops import _cuda

SPLIT_FWD = _cuda.Kernel(
    "split_bf16_fwd", "psi_split_mm", "psi_tpu_torch/csrc/split_bf16.cu",
    "psi_tpu/ops/precision.py:43,52 (XLA products, not Pallas)",
)
SPLIT_BWD = _cuda.Kernel(
    "split_bf16_bwd", "psi_split_mm_grad", "psi_tpu_torch/csrc/split_bf16.cu",
    "psi_tpu/ops/precision.py:43,52 (their transpose, XLA, not Pallas)",
)
# K5's launches, the bits of psi_split_mm_grad's `stages`, in launch order
BWD_STAGES = (("main", 1), ("reduce", 2))
BWD_ALL = 3
BLEND_SPEC = "vj,bjz->bvz"  # the one einsum of lbs, and the one the kernels take


def _hi_lo(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    hi = x.to(torch.bfloat16)
    return hi, (x.to(torch.float32) - hi.to(torch.float32)).to(torch.bfloat16)


def split3(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Widen axis ``axis`` 3x with (hi, lo, hi) bf16 blocks (lhs form)."""
    hi, lo = _hi_lo(x)
    return torch.cat([hi, lo, hi], dim=axis)


def split3_rhs(x: torch.Tensor, axis: int) -> torch.Tensor:
    """(hi, hi, lo) blocks: pairs with split3 so that the contraction
    yields ah.bh + al.bh + ah.bl."""
    hi, lo = _hi_lo(x)
    return torch.cat([hi, hi, lo], dim=axis)


def _rp(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def _combine(h: torch.Tensor, low: torch.Tensor) -> torch.Tensor:
    """An operand's gradient from its f32 cotangent sums against the other
    operand's hi and lo halves: H + rp(f32(bf16(H + L)) - H), H and L
    rounded to bf16 first (module docstring)."""
    h, low = h.to(torch.bfloat16), low.to(torch.bfloat16)
    k = h.to(torch.float32)
    return k + _rp((h + low).to(torch.float32) - k)  # h + low is a bf16 add


Contraction = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]  # torch.matmul, or one einsum


def _halves(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x's hi and lo bf16 halves, as f32 values."""
    return tuple(t.to(torch.float32) for t in _hi_lo(x.detach()))


def split_product_reference(a: torch.Tensor, b: torch.Tensor, fn: Contraction) -> torch.Tensor:
    """Plain twin of K4: (ah + al).bh + ah.bl, the widened contraction's three
    blocks, summed in float64 and rounded to f32 once. Its bf16 x bf16
    products are exact in f32 either way, and on the card an f32 sum of the
    3K of them by cuBLAS strays further from the exact sum than K4 does
    (chip_smoke.py's [K4/K5] prints both), so the twin sums exactly."""
    (ah, al), (bh, bl) = _halves(a), _halves(b)
    f64 = lambda t: t.to(torch.float64)  # noqa: E731
    return (fn(f64(ah + al), f64(bh)) + fn(f64(ah), f64(bl))).to(torch.float32)


def split_product_grad_reference(
    a: torch.Tensor, b: torch.Tensor, g: torch.Tensor, fn: Contraction, need: Tuple[bool, bool] = (True, True)
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Plain twin of K5: (grad a, grad b), each None unless ``need`` asks
    for it: the cotangent g contracted in f32 with the other operand's hi
    and with its lo half (the widened product's cotangent blocks), then
    ``_combine``. Each contraction is the gradient of ``fn`` in that
    operand, which does not depend on the operand's value."""
    g = g.detach().to(torch.float32)

    def cotangent(x, y, wrt):
        x, y = x.detach().to(torch.float32), y.detach().to(torch.float32)
        (x, y)[wrt].requires_grad_(True)
        with torch.enable_grad():
            return torch.autograd.grad(fn(x, y), (x, y)[wrt], g)[0]

    ga = gb = None
    if need[0]:
        bh, bl = _halves(b)
        ga = _combine(cotangent(a, bh, 0), cotangent(a, bl, 0))
    if need[1]:
        ah, al = _halves(a)
        gb = _combine(cotangent(ah, b, 1), cotangent(al, b, 1))
    return ga, gb


# ---- the kernels' view of a product: out[t] = A[t] @ B[t], t < T

class Layout(NamedTuple):
    """Where element (t, r, c) of a batch of matrices lies in a tensor, in
    elements: at t st + r sr + (c // g) sq + (c % g) sc. g is the column
    group: the bodies' A12 side by side in the blend (g = 12); g = the
    column count where the columns are not grouped."""

    st: int
    sr: int
    sq: int
    sc: int
    g: int


class Gemm(NamedTuple):
    """A batch of T products [M, K] @ [K, N] of f32 operands: A (rows m,
    columns k, not grouped) and B (rows k, columns n) read through their
    layouts, the output written into a new tensor of ``out_shape`` through
    ``lo``. ``shared`` marks an operand that every product of the batch reads
    (its gradient would sum over the batch); ``grads`` are the layouts of the
    two operands' gradients, each a new tensor of the operand's shape."""

    T: int
    M: int
    N: int
    K: int
    a: torch.Tensor
    la: Layout
    b: torch.Tensor
    lb: Layout
    out_shape: Tuple[int, ...]
    lo: Layout
    shared: Tuple[bool, bool] = (False, False)
    grads: Optional[Tuple[Layout, Layout]] = None


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.detach().to(torch.float32)


def _dense(rows: int, cols: int, batch: bool = True) -> Layout:
    """A contiguous [T, rows, cols] (or [rows, cols] with T = 1)."""
    return Layout(rows * cols if batch else 0, cols, 0, 1, cols)


def _strided(x3: torch.Tensor) -> Layout:
    """A [T, rows, cols] view as it lies."""
    return Layout(x3.stride(0), x3.stride(1), 0, x3.stride(2), x3.shape[2])


def matmul_gemm(a: torch.Tensor, b: torch.Tensor) -> Gemm:
    """torch.matmul(a, b) for a [..., M, K] and b [..., K, N] as a Gemm. A 2-D
    rhs takes the lhs's batch into M; a 2-D lhs under a batched rhs is shared."""
    if a.dim() < 2 or b.dim() < 2 or a.shape[-1] != b.shape[-2]:
        raise ValueError(f"matmul_f32x3 on the card takes [..., M, K] @ [..., K, N], got "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    a, b = _f32(a), _f32(b)
    M, K, N = a.shape[-2], a.shape[-1], b.shape[-1]
    if b.dim() == 2:
        a3, b3 = a.reshape(1, -1, K), b[None]
        return Gemm(1, a3.shape[1], N, K, a3, _strided(a3), b3, _strided(b3), (*a.shape[:-1], N),
                    _dense(a3.shape[1], N), grads=(_dense(a3.shape[1], K), _dense(K, N)))
    batch = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    T = math.prod(batch)

    def flat(x, rows, cols):
        if x.dim() > 2 and tuple(x.shape[:-2]) != tuple(batch):
            raise NotImplementedError("matmul_f32x3 on the card broadcasts only a 2-D operand over the batch")
        return x.expand(*batch, rows, cols).reshape(T, rows, cols)  # a 2-D operand: batch stride 0

    a3, b3 = flat(a, M, K), flat(b, K, N)
    return Gemm(T, M, N, K, a3, _strided(a3), b3, _strided(b3), (*batch, M, N), _dense(M, N),
                shared=(a.dim() == 2 and T > 1, b.dim() == 2 and T > 1),
                grads=(_dense(M, K, a.dim() > 2), _dense(K, N, b.dim() > 2)))


def blend_gemm(w: torch.Tensor, a12: torch.Tensor) -> Gemm:
    """einsum('vj,bjz->bvz', w, a12) as one product w [V, J] @ [J, B Z]: the
    bodies' A12 side by side (column n = Z b + z), written into [B, V, Z].
    w is shared by the bodies."""
    if w.dim() != 2 or a12.dim() != 3 or w.shape[1] != a12.shape[1]:
        raise ValueError(f"the blend takes w [V, J] and a12 [B, J, Z], got {tuple(w.shape)}, {tuple(a12.shape)}")
    w, a12 = _f32(w), _f32(a12)
    (V, J), (B, _, Z) = w.shape, a12.shape
    return Gemm(1, V, B * Z, J, w, Layout(0, w.stride(0), 0, w.stride(1), J),
                a12, Layout(0, a12.stride(1), a12.stride(0), a12.stride(2), Z),
                (B, V, Z), Layout(0, Z, V * Z, 1, Z), shared=(True, False),
                grads=(Layout(0, J, 0, 1, J), Layout(0, Z, J * Z, 1, Z)))


def _check_gemm(gm: Gemm) -> torch.device:
    dev = gm.a.device
    for name, t in (("a", gm.a), ("b", gm.b)):
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError(f"split-bf16 operand {name}: {t.dtype} on {t.device}, expected float32 on {dev}")
    if min(gm.T, gm.M, gm.N, gm.K) <= 0:
        raise ValueError(f"split-bf16 product of an empty shape {gm[:4]}")
    if gm.la.g != gm.K:
        raise ValueError("the kernels take no grouping of the contracted axis")
    return dev


def _strides(gm: Gemm) -> tuple:
    """The stride arguments of psi_split_mm and psi_split_mm_grad."""
    la, lb, lo = gm.la, gm.lb, gm.lo
    return (la.st, la.sr, la.sc, lb.st, lb.sr, lb.sq, lb.sc, lb.g, lo.st, lo.sr, lo.sq, lo.sc, lo.g)


def split_mm(gm: Gemm, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K4: the product, a new f32 tensor of ``gm.out_shape`` on the card (or
    ``out``, written through ``gm.lo``). Nothing is summed across blocks:
    two runs give equal bits."""
    dev = _check_gemm(gm)
    if out is None:
        out = torch.empty(gm.out_shape, dtype=torch.float32, device=dev)
    SPLIT_FWD.launch(dev, gm.a.data_ptr(), gm.b.data_ptr(), out.data_ptr(), gm.T, gm.M, gm.N, gm.K,
                     *_strides(gm), _cuda.stream_of(out))
    return out


def grad_gemms(gm: Gemm, g: torch.Tensor, shapes: Tuple[tuple, tuple]) -> Tuple[Optional[Gemm], Gemm]:
    """The products behind the gradients of ``gm``'s operands (of shapes
    ``shapes``) for the output cotangent g, a contiguous tensor of
    gm.out_shape: grad A = g @ B^T (its cotangent the lhs; None where the
    output's or B's columns are grouped), grad B = A^T @ g (the rhs)."""
    lo, la, lb = gm.lo, gm.la, gm.lb
    ga = None
    if lo.g == gm.N and lb.g == gm.N:
        ga = Gemm(gm.T, gm.M, gm.K, gm.N, g, Layout(lo.st, lo.sr, 0, lo.sc, gm.N),
                  gm.b, Layout(lb.st, lb.sc, 0, lb.sr, gm.K), shapes[0], gm.grads[0])
    gb = Gemm(gm.T, gm.K, gm.N, gm.M, gm.a, Layout(la.st, la.sc, 0, la.sr, gm.M), g, lo, shapes[1], gm.grads[1])
    return ga, gb


def grad_operands(gm: Gemm, cot_is_a: bool):
    """K5's launch: (the arguments of psi_split_mm_grad before `stages` and
    the stream, the output, the tensors behind the pointers)."""
    dev = _check_gemm(gm)
    out = torch.empty(gm.out_shape, dtype=torch.float32, device=dev)
    work = torch.empty(_cuda.library().psi_split_mm_grad_workspace(gm.T, gm.M, gm.N, gm.K),
                       dtype=torch.uint8, device=dev)
    args = (gm.a.data_ptr(), gm.b.data_ptr(), out.data_ptr(), work.data_ptr(), int(cot_is_a),
            gm.T, gm.M, gm.N, gm.K, *_strides(gm))
    return args, out, (gm.a, gm.b, out, work)


def split_mm_grad(gm: Gemm, cot_is_a: bool) -> torch.Tensor:
    """K5: one gradient of a split-bf16 product, a product from
    ``grad_gemms``. Split-K partials, then a fixed-order reduction that
    rounds and combines: no atomics, two runs give equal bits."""
    args, out, _keep = grad_operands(gm, cot_is_a)
    SPLIT_BWD.launch(out.device, *args, BWD_ALL, _cuda.stream_of(out))
    return out


def _card_backward(a, b, g, gemm, need):
    """K5 for each gradient asked for. That of an operand the batch shares
    needs a sum over the batch that K5 does not take: it raises."""
    gm = gemm(a, b)
    if any(n and s for n, s in zip(need, gm.shared)):
        raise NotImplementedError(
            "the split-bf16 gradient of an operand shared across the batch is not ported to the card"
        )
    ga_gm, gb_gm = grad_gemms(gm, g.detach().to(torch.float32).contiguous(), (tuple(a.shape), tuple(b.shape)))
    return (split_mm_grad(ga_gm, True) if need[0] else None), (split_mm_grad(gb_gm, False) if need[1] else None)


class _SplitProduct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, fn, gemm):
        ctx.fn, ctx.gemm = fn, gemm
        ctx.save_for_backward(a, b)
        if a.device.type == "cpu":
            return split_product_reference(a, b, fn)
        if a.device.type != "cuda":
            raise ValueError(f"split-bf16 products run on cpu or cuda tensors, got {a.device}")
        return split_mm(gemm(a, b))

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        need = tuple(ctx.needs_input_grad[:2])
        if a.device.type == "cpu":
            ga, gb = split_product_grad_reference(a, b, g, ctx.fn, need)
        else:
            ga, gb = _card_backward(a, b, g, ctx.gemm, need)
        return (None if ga is None else ga.to(a.dtype)), (None if gb is None else gb.to(b.dtype)), None, None


def matmul_f32x3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """torch.matmul(a, b) (a's last axis against b's second-to-last, the
    usual batching) with split-bf16 accuracy; output f32."""
    return _SplitProduct.apply(a, b, torch.matmul, matmul_gemm)


def einsum_f32x3(spec: str, a: torch.Tensor, b: torch.Tensor, a_axis: int, b_axis: int) -> torch.Tensor:
    """torch.einsum(spec, a, b) with the contraction axes (a_axis in a,
    b_axis in b) split-widened; the spec must contract exactly that one
    shared index. The card takes the blend of lbs, ``'vj,bjz->bvz'`` with
    a_axis = b_axis = 1; the CPU twin takes any such spec."""
    a_axis, b_axis = a_axis % a.dim(), b_axis % b.dim()
    if a.device.type == "cuda" and (spec.replace(" ", "") != BLEND_SPEC or (a_axis, b_axis) != (1, 1)):
        raise NotImplementedError(f"einsum_f32x3 on the card takes {BLEND_SPEC!r} over axes (1, 1), got "
                                  f"{spec!r} over ({a_axis}, {b_axis})")
    return _SplitProduct.apply(a, b, lambda x, y: torch.einsum(spec, x, y), blend_gemm)
