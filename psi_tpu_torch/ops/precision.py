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
'high' gradients bf16-class (~1e-3 relative), as psi_tpu's are. Where an
operand is shared by every product of a batch (the skinning weights of the
blend, a 2-D lhs under a batched rhs), its cotangent blocks sum over the
batch before they are rounded, as in JAX's transpose.

Two routes, chosen by the device of the tensors:
* CUDA: kernel K4 (the forward) and K5 (a gradient) in
  ``csrc/split_bf16.cu``, on wgmma: the operand that varies per call (``Gemm.a``)
  cut into bf16 parts in registers, read through shared memory where its rows
  are contiguous in k (``slab_route``) and straight into registers otherwise;
  the other one (``Gemm.b``) cut once into packed bf16 hi/lo planes by a pack
  launch, kept in ``PACKS`` for an operand that takes no gradient. K5 serves
  every gradient, that of a shared operand through a grouped contraction
  axis. A launch that fails raises.
* CPU: the plain twins, ``split_product_reference`` and
  ``split_product_grad_reference``: products of the bf16-valued halves (each
  exact in f32), the forward summed in float64 and rounded once, the
  cotangent blocks summed in f32, and the gradient as written above. They
  are the tests' oracle and the kernels' comparison on the card;
  ``pack_reference`` is the pack's.
"""

from __future__ import annotations

import contextlib
import math
import threading
import weakref
from typing import Callable, Iterator, List, NamedTuple, Optional, Tuple

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
SPLIT_PACK = _cuda.Kernel(
    "split_bf16_pack", "psi_split_pack", "psi_tpu_torch/csrc/split_bf16.cu",
    "none: cuts K4's and K5's packed operand (part of their wrappers' calls)",
)
# K5's launches, the bits of psi_split_mm_grad's `stages`, in launch order
BWD_STAGES = (("main", 1), ("reduce", 2))
BWD_ALL = 3
BLEND_SPEC = "vj,bjz->bvz"  # the one einsum of lbs, and the one the kernels take
# the packed planes' layout (csrc/split_bf16.cu: KC, NB_FWD, NB_GRAD): k a ring
# stage, and the columns of a block panel for K4 and for K5
KC, NB_FWD, NB_GRAD = 64, 128, 64


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

class Axis(NamedTuple):
    """An index axis in groups: index i is member i % r of group i // r, and
    exists where i // r < q and i % r < g. q * r indices are laid out. The
    contraction's r is a multiple of 16: one wgmma k step never spans two
    groups."""

    q: int
    r: int
    g: int

    @property
    def size(self) -> int:
        return self.q * self.r


def _plain(n: int, align: int = 1) -> Axis:
    """An axis of n indices in one group, laid out to a multiple of ``align``."""
    return Axis(1, -(-n // align) * align, n)


def _grouped(q: int, g: int) -> Axis:
    """q groups of g members, each laid out as 16 (the blend's bodies, the batch of a shared operand's gradient)."""
    return Axis(q, -(-g // 16) * 16, g)


class Gemm(NamedTuple):
    """A batch of T products of f32 operands, out[t][m, n] = sum over k of
    A[t][m, k] B[t][k, n], for rows m of the axis ``m``, N columns and k of
    the axis ``k``. A, the operand that varies per call, is read by the
    kernel into registers: element (t, m, k) at a[t sa0 + (m // m.r) sa1 +
    (m % m.r) sa2 + (k // k.r) sa3 + (k % k.r) sa4]. B is cut into packed
    bf16 planes first: element (t, k, n) at b[t sb0 + (k // k.r) sb1 + (k %
    k.r) sb2 + n sb3]; sb0 = 0 where every product reads the one B. The
    output, a new tensor of ``out_shape``: (t, m, n) at t so0 + (m // m.r)
    so1 + (m % m.r) so2 + n so3."""

    T: int
    m: Axis
    N: int
    k: Axis
    a: torch.Tensor
    sa: Tuple[int, int, int, int, int]
    b: torch.Tensor
    sb: Tuple[int, int, int, int]
    out_shape: Tuple[int, ...]
    so: Tuple[int, int, int, int]


def _f32(x: torch.Tensor) -> torch.Tensor:
    """x as f32, the same tensor object where it is one (the pack cache is
    keyed on it); only read through its pointer."""
    return x if x.dtype == torch.float32 else x.detach().to(torch.float32)


def matmul_gemm(a: torch.Tensor, b: torch.Tensor) -> Gemm:
    """torch.matmul(a, b) for a [..., M, K] and b [..., K, N] as a Gemm. A 2-D
    rhs takes the lhs's batch into M; a 2-D lhs under a batched rhs is read
    with batch stride 0."""
    if a.dim() < 2 or b.dim() < 2 or a.shape[-1] != b.shape[-2]:
        raise ValueError(f"matmul_f32x3 on the card takes [..., M, K] @ [..., K, N], got "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    a, b = _f32(a), _f32(b)
    M, K, N = a.shape[-2], a.shape[-1], b.shape[-1]
    if b.dim() == 2:
        a2 = a.reshape(-1, K)
        R = a2.shape[0]
        return Gemm(1, _plain(R), N, _plain(K, 16), a2, (0, 0, a2.stride(0), 0, a2.stride(1)),
                    b, (0, 0, b.stride(0), b.stride(1)), (*a.shape[:-1], N), (0, 0, N, 1))
    batch = _batch(a, b)
    a3, b3 = _flat(a, batch, M, K), _flat(b, batch, K, N)
    return Gemm(a3.shape[0], _plain(M), N, _plain(K, 16), a3, (a3.stride(0), 0, a3.stride(1), 0, a3.stride(2)),
                b3, (b3.stride(0), 0, b3.stride(1), b3.stride(2)), (*batch, M, N), (M * N, 0, N, 1))


def _batch(a: torch.Tensor, b: torch.Tensor) -> tuple:
    batch = tuple(torch.broadcast_shapes(a.shape[:-2], b.shape[:-2]))
    for x in (a, b):
        if x.dim() > 2 and tuple(x.shape[:-2]) != batch:
            raise NotImplementedError("matmul_f32x3 on the card broadcasts only a 2-D operand over the batch")
    return batch


def _flat(x: torch.Tensor, batch: tuple, rows: int, cols: int) -> torch.Tensor:
    """x as [T, rows, cols]; a 2-D operand with batch stride 0."""
    return x.expand(*batch, rows, cols).reshape(math.prod(batch), rows, cols)


def matmul_grad_gemms(a: torch.Tensor, b: torch.Tensor, g: torch.Tensor,
                      need: Tuple[bool, bool]) -> Tuple[Optional[Gemm], Optional[Gemm]]:
    """K5's products for torch.matmul(a, b)'s gradients (None where not
    needed), g the contiguous f32 output cotangent. The cotangent is always
    the register operand: grad a = g @ b^T; grad b = (g^T @ a)^T, its rows
    the columns n; a 2-D lhs under a batched rhs contracts over (t, n)."""
    a, b = _f32(a), _f32(b)
    M, K, N = a.shape[-2], a.shape[-1], b.shape[-1]
    ga = gb = None
    if b.dim() == 2:
        a2 = a.reshape(-1, K)
        R = a2.shape[0]
        if need[0]:
            ga = Gemm(1, _plain(R), K, _plain(N, 16), g, (0, 0, N, 0, 1), b, (0, 0, b.stride(1), b.stride(0)),
                      tuple(a.shape), (0, 0, K, 1))
        if need[1]:
            gb = Gemm(1, _plain(N), K, _plain(R, 16), g, (0, 0, 1, 0, N), a2, (0, 0, a2.stride(0), a2.stride(1)),
                      tuple(b.shape), (0, 0, 1, N))
        return ga, gb
    batch = _batch(a, b)
    a3, b3 = _flat(a, batch, M, K), _flat(b, batch, K, N)
    T = a3.shape[0]
    if need[0] and a.dim() == 2 and T > 1:  # shared by the batch: the sum over t inside the contraction
        ga = Gemm(1, _plain(M), K, _grouped(T, N), g, (0, 0, N, M * N, 1),
                  b3, (0, b3.stride(0), b3.stride(2), b3.stride(1)), (M, K), (0, 0, K, 1))
    elif need[0]:
        ga = Gemm(T, _plain(M), K, _plain(N, 16), g, (M * N, 0, N, 0, 1),
                  b3, (b3.stride(0), 0, b3.stride(2), b3.stride(1)), tuple(a.shape), (M * K, 0, K, 1))
    if need[1]:
        gb = Gemm(T, _plain(N), K, _plain(M, 16), g, (M * N, 0, 1, 0, N),
                  a3, (a3.stride(0), 0, a3.stride(1), a3.stride(2)), tuple(b.shape), (K * N, 0, 1, N))
    return ga, gb


def blend_gemm(w: torch.Tensor, a12: torch.Tensor) -> Gemm:
    """einsum('vj,bjz->bvz', w, a12) as rows (b, z) of a12 (16 laid out a
    body, Z used) against w^T [J, V], written into [B, V, Z]: a body's rows
    are one contiguous run of the output."""
    if w.dim() != 2 or a12.dim() != 3 or w.shape[1] != a12.shape[1]:
        raise ValueError(f"the blend takes w [V, J] and a12 [B, J, Z], got {tuple(w.shape)}, {tuple(a12.shape)}")
    w, a12 = _f32(w), _f32(a12)
    (V, J), (B, _, Z) = w.shape, a12.shape
    return Gemm(1, _grouped(B, Z), V, _plain(J, 16), a12, (0, a12.stride(0), a12.stride(2), 0, a12.stride(1)),
                w, (0, 0, w.stride(1), w.stride(0)), (B, V, Z), (0, V * Z, 1, Z))


def blend_grad_gemms(w: torch.Tensor, a12: torch.Tensor, g: torch.Tensor,
                     need: Tuple[bool, bool]) -> Tuple[Optional[Gemm], Optional[Gemm]]:
    """K5's products for the blend's gradients, g the contiguous [B, V, Z]
    cotangent: the weights' (shared by the bodies) rows v of g contracted
    over the grouped axis (b, z) with a12; a12's rows (b, z) of g contracted
    over v with w."""
    w, a12 = _f32(w), _f32(a12)
    (V, J), (B, _, Z) = w.shape, a12.shape
    gw = ga = None
    if need[0]:
        gw = Gemm(1, _plain(V), J, _grouped(B, Z), g, (0, 0, Z, V * Z, 1),
                  a12, (0, a12.stride(0), a12.stride(2), a12.stride(1)), (V, J), (0, 0, J, 1))
    if need[1]:
        ga = Gemm(1, Axis(B, Z, Z), J, _plain(V, 16), g, (0, V * Z, 1, 0, Z),
                  w, (0, 0, w.stride(0), w.stride(1)), (B, J, Z), (0, J * Z, 1, Z))
    return gw, ga


def _check_gemm(gm: Gemm) -> torch.device:
    dev = gm.a.device
    for name, t in (("a", gm.a), ("b", gm.b)):
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError(f"split-bf16 operand {name}: {t.dtype} on {t.device}, expected float32 on {dev}")
    if min(gm.T, gm.N, *gm.m, *gm.k) <= 0 or gm.k.r % 16 or gm.m.g > gm.m.r or gm.k.g > gm.k.r:
        raise ValueError(f"split-bf16 product of a shape the kernels do not take: {gm[:4]}")
    return dev


def _nb(grad: bool) -> int:
    return NB_GRAD if grad else NB_FWD


def _layout(gm: Gemm, grad: bool) -> Tuple[int, int, int]:
    """(batch entries, column panels, k stages) of gm's packed planes."""
    return (gm.T if gm.sb[0] else 1), -(-gm.N // _nb(grad)), -(-gm.k.size // KC)


def slab_route(gm: Gemm) -> bool:
    """Whether the kernel reads gm's A through shared memory (its rows
    contiguous in one k group: a bulk copy a row and stage) rather than
    straight into registers."""
    return gm.k.q == 1 and gm.sa[4] == 1


def pack_layout(gm: Gemm, grad: bool) -> int:
    """The packed planes' layout: K4 (0) or K5 (1), + 2 on the slab route."""
    return int(grad) + 2 * slab_route(gm)


def packed_k(k: torch.Tensor, layout: int) -> torch.Tensor:
    """The packed position of k. The slab route's layouts order each 16 k so
    that the thread with q = lane % 4 finds k 4 q + [0, 4) in its A
    fragment's slots 2 q, 2 q + 1, 2 q + 8, 2 q + 9 (four neighbours in its
    slab row)."""
    if layout < 2:
        return k
    x = k % 16
    return k - x + 2 * (x // 4) + x % 2 + 8 * ((x % 4) // 2)


def pack_reference(gm: Gemm, grad: bool) -> torch.Tensor:
    """Plain twin of the pack: B's bf16 hi and lo planes in the layout K4
    (grad False) or K5 reads, on B's device. For each batch entry, column
    panel of NB and k stage of KC: the hi plane then the lo plane, each
    NB / 8 x KC / 8 core matrices (8 columns x 8 packed k, k fastest), a
    column group's KC / 8 cores in k order; k at ``packed_k``; zero where k
    or n does not exist."""
    nb = _nb(grad)
    Tb, n_tiles, k_stages = _layout(gm, grad)
    dev = gm.b.device
    t = torch.arange(Tb, device=dev)[:, None, None]
    k = torch.arange(k_stages * KC, device=dev)[None, :, None]
    n = torch.arange(n_tiles * nb, device=dev)[None, None, :]
    kq, kr = k // gm.k.r, k % gm.k.r
    ok = (kq < gm.k.q) & (kr < gm.k.g) & (n < gm.N)
    off = (t * gm.sb[0] + kq * gm.sb[1] + kr * gm.sb[2] + n * gm.sb[3]) * ok
    flat = torch.as_strided(gm.b, (int(off.max()) + 1,), (1,))
    hi, lo = _hi_lo(torch.where(ok, flat[off], 0.0))
    kp = packed_k(k, pack_layout(gm, grad))
    dest = (((t * n_tiles + n // nb) * k_stages + kp // KC) * (2 * nb * KC)
            + ((n % nb) // 8 * (KC // 8) + (kp % KC) // 8) * 64 + (n % 8) * 8 + kp % 8)
    planes = torch.empty(Tb * n_tiles * k_stages * 2 * nb * KC, dtype=torch.bfloat16, device=dev)
    planes[dest] = hi
    planes[dest + nb * KC] = lo
    return planes


class PackCache:
    """Packed planes of operands that take no gradient (posedirs,
    lbs_weights), kept while their source tensor lives and is unchanged.

    An entry is keyed on the source object (a weak reference: it goes when
    the tensor goes) and the layout asked for, and holds the tensor's
    ``_version`` at packing: an in-place change of the source bumps the
    version, and the next call repacks. Nothing is stored while a CUDA graph
    is being captured (the planes would live in the graph's pool); what a
    capture is served from the cache it learns through ``served``."""

    def __init__(self):
        self._lock = threading.RLock()  # a dying source's callback may run inside get()
        self._entries = {}  # id(source) -> (weak reference, {layout: (version, planes)})
        self._served = threading.local()  # .log: this thread's list inside served(), else absent

    def get(self, src: torch.Tensor, layout: tuple, build: Callable[[], torch.Tensor]) -> torch.Tensor:
        with self._lock:
            slot = self._entries.get(id(src))
            if slot is not None and slot[0]() is src:
                hit = slot[1].get(layout)
                if hit is not None and hit[0] == src._version:
                    log = getattr(self._served, "log", None)
                    if log is not None:
                        log.append((slot[0], hit[0], hit[1]))
                    return hit[1]
        planes = build()
        if planes.is_cuda and torch.cuda.is_current_stream_capturing():
            return planes
        with self._lock:
            slot = self._entries.get(id(src))
            if slot is None or slot[0]() is not src:
                slot = self._entries[id(src)] = (weakref.ref(src, self._dropper(id(src))), {})
            slot[1][layout] = (src._version, planes)
        return planes

    def _dropper(self, key: int):
        def drop(ref):
            with self._lock:
                if self._entries.get(key, (None,))[0] is ref:
                    del self._entries[key]
        return drop

    @contextlib.contextmanager
    def served(self) -> Iterator[List[tuple]]:
        """The planes this thread is given from the cache while inside, as
        (weak reference to the source, its version then, planes): a CUDA graph
        captured inside reads them, and is stale once a source's version moves."""
        log = self._served.log = []
        try:
            yield log
        finally:
            del self._served.log

    def nbytes(self) -> int:
        """Device bytes held."""
        with self._lock:
            return sum(p.numel() * p.element_size() for _, d in self._entries.values() for _, p in d.values())

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()


PACKS = PackCache()


def pack(gm: Gemm, grad: bool) -> torch.Tensor:
    """B's packed planes on the card: one pack launch, or the cached planes
    of a B that takes no gradient."""
    def build():
        Tb, n_tiles, k_stages = _layout(gm, grad)
        planes = torch.empty(Tb * n_tiles * k_stages * 2 * _nb(grad) * KC, dtype=torch.bfloat16, device=gm.b.device)
        SPLIT_PACK.launch(gm.b.device, gm.b.data_ptr(), planes.data_ptr(), Tb, gm.N, *gm.k, *gm.sb,
                          pack_layout(gm, grad), _cuda.stream_of(planes))
        return planes

    if gm.b.requires_grad:
        return build()
    layout = (pack_layout(gm, grad), gm.N, gm.k, gm.sb, gm.T if gm.sb[0] else 1, gm.b.data_ptr(), tuple(gm.b.shape))
    return PACKS.get(gm.b, layout, build)


def _args(gm: Gemm) -> tuple:
    """The shape and stride arguments of psi_split_mm and psi_split_mm_grad after the pointers."""
    reach = 1 + sum((n - 1) * s for n, s in zip(gm.a.shape, gm.a.stride()))  # elements of a from its pointer
    return (gm.T, *gm.m, gm.N, *gm.k, *gm.sa, reach, int(gm.sb[0] != 0), *gm.so)


def split_mm(gm: Gemm, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K4: the product, a new f32 tensor of ``gm.out_shape`` on the card (or
    ``out``, written through ``gm.so``). Blocks never share an output: two
    runs give equal bits."""
    dev = _check_gemm(gm)
    planes = pack(gm, False)
    if out is None:
        out = torch.empty(gm.out_shape, dtype=torch.float32, device=dev)
    SPLIT_FWD.launch(dev, gm.a.data_ptr(), planes.data_ptr(), out.data_ptr(), *_args(gm), int(slab_route(gm)),
                     _cuda.stream_of(out))
    return out


def grad_operands(gm: Gemm):
    """K5's launch: (the arguments of psi_split_mm_grad before `stages` and
    the stream, the output, the tensors behind the pointers)."""
    dev = _check_gemm(gm)
    planes = pack(gm, True)
    out = torch.empty(gm.out_shape, dtype=torch.float32, device=dev)
    work = torch.empty(_cuda.library().psi_split_mm_grad_workspace(gm.T, gm.m.q, gm.m.r, gm.N, gm.k.q, gm.k.r),
                       dtype=torch.uint8, device=dev)
    args = (gm.a.data_ptr(), planes.data_ptr(), out.data_ptr(), work.data_ptr(), *_args(gm), int(slab_route(gm)))
    return args, out, (gm.a, planes, out, work)


def split_mm_grad(gm: Gemm) -> torch.Tensor:
    """K5: one gradient of a split-bf16 product, a product from
    ``matmul_grad_gemms`` or ``blend_grad_gemms`` whose register operand is
    the cotangent. Split-K partials, then a fixed-order reduction that
    rounds and combines: no atomics, two runs give equal bits."""
    args, out, _keep = grad_operands(gm)
    SPLIT_BWD.launch(out.device, *args, BWD_ALL, _cuda.stream_of(out))
    return out


class _SplitProduct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, fn, gemm, grad_gemms):
        ctx.fn, ctx.grad_gemms = fn, grad_gemms
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
            gms = ctx.grad_gemms(a, b, g.detach().to(torch.float32).contiguous(), need)
            ga, gb = (None if gm is None else split_mm_grad(gm) for gm in gms)
        return (None if ga is None else ga.to(a.dtype)), (None if gb is None else gb.to(b.dtype)), None, None, None


def matmul_f32x3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """torch.matmul(a, b) (a's last axis against b's second-to-last, the
    usual batching) with split-bf16 accuracy; output f32."""
    return _SplitProduct.apply(a, b, torch.matmul, matmul_gemm, matmul_grad_gemms)


def einsum_f32x3(spec: str, a: torch.Tensor, b: torch.Tensor, a_axis: int, b_axis: int) -> torch.Tensor:
    """torch.einsum(spec, a, b) with the contraction axes (a_axis in a,
    b_axis in b) split-widened; the spec must contract exactly that one
    shared index. The card takes the blend of lbs, ``'vj,bjz->bvz'`` with
    a_axis = b_axis = 1; the CPU twin takes any such spec."""
    a_axis, b_axis = a_axis % a.dim(), b_axis % b.dim()
    if a.device.type == "cuda" and (spec.replace(" ", "") != BLEND_SPEC or (a_axis, b_axis) != (1, 1)):
        raise NotImplementedError(f"einsum_f32x3 on the card takes {BLEND_SPEC!r} over axes (1, 1), got "
                                  f"{spec!r} over ({a_axis}, {b_axis})")
    return _SplitProduct.apply(a, b, lambda x, y: torch.einsum(spec, x, y), blend_gemm, blend_grad_gemms)
