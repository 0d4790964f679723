"""psi_tpu_torch.ops.precision and the 'high' LBS tier against psi_tpu's.

The split-bf16 products on seeded numpy inputs at psi_tpu's own test
shapes (tests/test_precision.py): (64, 486) @ (486, 300), the batched
(4, 32, 55) @ (4, 55, 16) and the blend's (200, 55) . (3, 55, 12). The
forward holds to 2e-6 of max |psi_tpu| (the same exact bf16 products, f32
sums in another order). The gradient of each operand, from one seeded
output cotangent, equals psi_tpu's ``jax.grad`` in bits on >= 99.9% of
its elements; the rest differ by one bf16 rounding (at most 2^-7 of the
element), where the two f32 sums of a cotangent block land on either side
of a bf16 rounding point.

Then the CPU's view of the kernels: each product laid out as K4 and K5
read it (``Gemm``: the register operand through its strides and grouped
axes, the other operand from its packed bf16 planes at the kernel's
addresses) and computed with K4's and K5's arithmetic in float64 (exact
products, the hi/lo and three-part cuts, the combine), held to the twins
as the card holds the kernels; the gradient of an operand the batch
shares among them; the pack cache.

And ``lbs`` at 'high' against psi_tpu's unpatched 'high', and at
``exact=True`` against psi_tpu's ``exact=True``, on the small SMPL-X model
of test_torch_body.py.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psi_tpu.body.lbs import lbs as j_lbs
from psi_tpu.body.smplx_model import synthetic_smplx as j_synthetic_smplx
from psi_tpu.ops import precision as jp
from psi_tpu_torch.body.lbs import lbs as t_lbs
from psi_tpu_torch.ops import precision as tp
from psi_tpu_torch.utils.convert_jax import SMPLX_FIELDS, smplx_from_numpy

torch.set_num_threads(1)
FWD_REL = 2e-6  # of max |reference|: the same products summed in another order
GRAD_EQUAL_SHARE = 0.999  # gradient elements equal in bits
BF16_ULP_REL = 2.0**-7  # one bf16 rounding, relative to the element
LBS_TOL = 5e-6  # m: 'high' vs 'high' and exact vs exact on metre-scale vertices (measured 8.3e-7, 2.4e-7)
# the lbs gradients, of max |gradient|: >= 99% of the elements within
# LBS_GRAD_TOL, all within 10x that, where one cotangent block rounded to
# the other bf16 moves one term of an element by 2^-8 (measured 1.1e-5 on
# one of 180 pose entries at 'high', 5e-7 elsewhere)
LBS_GRAD_TOL = 1e-5
LBS_GRAD_SHARE = 0.99


def _blend_j(w, a):
    return jp.einsum_f32x3("vj,bjz->bvz", w, a, a_axis=1, b_axis=1)


def _blend_t(w, a):
    return tp.einsum_f32x3("vj,bjz->bvz", w, a, a_axis=1, b_axis=1)


def _mm_inputs(rng):
    return rng.normal(size=(64, 486)).astype(np.float32), rng.normal(size=(486, 300)).astype(np.float32)


def _bmm_inputs(rng):
    return rng.normal(size=(4, 32, 55)).astype(np.float32), rng.normal(size=(4, 55, 16)).astype(np.float32)


def _blend_inputs(rng):
    return rng.random((200, 55)).astype(np.float32), rng.normal(size=(3, 55, 12)).astype(np.float32)


CASES = {
    "matmul": (_mm_inputs, jp.matmul_f32x3, tp.matmul_f32x3),
    "matmul_batched": (_bmm_inputs, jp.matmul_f32x3, tp.matmul_f32x3),
    "blend": (_blend_inputs, _blend_j, _blend_t),
}


def _bits_close(got: np.ndarray, want: np.ndarray, what: str, scale=None) -> None:
    """Equal in bits on GRAD_EQUAL_SHARE of the elements, the rest within one
    bf16 ulp of the element (of ``scale`` where given)."""
    differ = got != want
    assert differ.mean() <= 1 - GRAD_EQUAL_SHARE, f"{what}: {differ.mean():.4%} of elements differ"
    rel = np.abs(got - want)[differ] / (np.abs(want)[differ] if scale is None else scale)
    assert rel.size == 0 or rel.max() <= BF16_ULP_REL, f"{what}: {rel.max()} relative"


@pytest.mark.parametrize("name", list(CASES))
def test_split_product_matches_psi_tpu(name):
    make, jfn, tfn = CASES[name]
    rng = np.random.default_rng(0)
    a, b = make(rng)
    out_j = np.asarray(jfn(jnp.asarray(a), jnp.asarray(b)))
    ct = rng.normal(size=out_j.shape).astype(np.float32)
    ga_j, gb_j = jax.grad(lambda x, y: jnp.sum(jfn(x, y) * ct), argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))

    at, bt = torch.from_numpy(a).requires_grad_(True), torch.from_numpy(b).requires_grad_(True)
    out_t = tfn(at, bt)
    assert out_t.dtype == torch.float32 and out_t.shape == out_j.shape
    np.testing.assert_allclose(out_t.detach().numpy(), out_j, rtol=0, atol=FWD_REL * np.abs(out_j).max())
    (out_t * torch.from_numpy(ct)).sum().backward()
    _bits_close(at.grad.numpy(), np.asarray(ga_j), f"{name} grad a")
    _bits_close(bt.grad.numpy(), np.asarray(gb_j), f"{name} grad b")


def test_split_is_psi_tpus_and_more_accurate_than_bf16():
    """split3/split3_rhs give psi_tpu's bf16 blocks bit for bit, and the
    product is ~2^-16 accurate where a single bf16 pass is ~2^-8."""
    rng = np.random.default_rng(1)
    a, b = _mm_inputs(rng)
    for jf, tf, axis in ((jp.split3, tp.split3, 1), (jp.split3_rhs, tp.split3_rhs, 0)):
        want = np.asarray(jf(jnp.asarray(a), axis).astype(jnp.float32))
        got = tf(torch.from_numpy(a), axis)
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(), want)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    split_err = np.abs(tp.matmul_f32x3(torch.from_numpy(a), torch.from_numpy(b)).numpy() - ref).max()
    bf16_err = np.abs((torch.from_numpy(a).bfloat16().float() @ torch.from_numpy(b).bfloat16().float()).numpy()
                      - ref).max()
    assert split_err < 2e-4 * np.abs(ref).max() and split_err < bf16_err / 50, (split_err, bf16_err)


# ---- the kernels' arithmetic on the kernels' layouts, in float64

def _read_a(gm: tp.Gemm) -> torch.Tensor:
    """The [T, m.size, k.size] matrices that the kernels read into registers
    through gm.sa, in float64; zero where a row or a k does not exist."""
    t = torch.arange(gm.T)[:, None, None]
    m, k = torch.arange(gm.m.size)[None, :, None], torch.arange(gm.k.size)[None, None, :]
    mq, mr, kq, kr = m // gm.m.r, m % gm.m.r, k // gm.k.r, k % gm.k.r
    ok = (mq < gm.m.q) & (mr < gm.m.g) & (kq < gm.k.q) & (kr < gm.k.g)
    off = (t * gm.sa[0] + mq * gm.sa[1] + mr * gm.sa[2] + kq * gm.sa[3] + kr * gm.sa[4]) * ok
    flat = torch.as_strided(gm.a, (int(off.max()) + 1,), (1,))
    return torch.where(ok, flat[off], 0.0).to(torch.float64)


def _read_b(gm: tp.Gemm, grad: bool):
    """B's hi and lo halves [T, k.size, N] as the kernel reads the packed
    planes: stage (t, column panel, k stage) one contiguous run of the two
    planes, a core matrix's 8 columns 16 bytes apart, the next core 128
    bytes on along k (the descriptor's leading byte offset) and KC / 8 cores
    on along the columns (its stride byte offset); in K5's layout each 16 k
    reordered so that a thread's A fragment holds 4 consecutive k. Also
    checks that the planes hold nothing but those elements (their padding
    is zero)."""
    planes = tp.pack_reference(gm, grad)
    nb = tp.NB_GRAD if grad else tp.NB_FWD
    Tb, n_tiles, k_stages = gm.T if gm.sb[0] else 1, -(-gm.N // nb), -(-gm.k.size // tp.KC)
    assert planes.numel() == Tb * n_tiles * k_stages * 2 * nb * tp.KC
    lbo, sbo = 128, tp.KC // 8 * 128  # bytes
    t = torch.arange(gm.T)[:, None, None] * (gm.sb[0] != 0)
    n = torch.arange(gm.N)[None, None, :]
    k = tp.packed_k(torch.arange(gm.k.size), tp.pack_layout(gm, grad))[None, :, None]  # where the kernel finds k
    stage = ((t * n_tiles + n // nb) * k_stages + k // tp.KC) * (4 * nb * tp.KC)
    byte = stage + (n % nb) // 8 * sbo + (k % tp.KC) // 8 * lbo + (n % 8) * 16 + (k % 8) * 2
    hi, lo = planes[byte // 2], planes[(byte + 2 * nb * tp.KC) // 2]
    read = torch.zeros(planes.numel(), dtype=torch.bool)
    read[byte.flatten() // 2] = True
    read[(byte.flatten() + 2 * nb * tp.KC) // 2] = True
    assert not planes[~read].float().any(), "the packed planes' padding is not zero"
    return hi.to(torch.float64), lo.to(torch.float64)


def _write(vals: torch.Tensor, gm: tp.Gemm) -> torch.Tensor:
    """A new tensor of gm.out_shape with the existing rows of vals [T, m.size, N] written through gm.so."""
    out = torch.full(gm.out_shape, float("nan"))
    t = torch.arange(gm.T)[:, None, None]
    m, n = torch.arange(gm.m.size)[None, :, None], torch.arange(gm.N)[None, None, :]
    mq, mr = m // gm.m.r, m % gm.m.r
    ok = ((mq < gm.m.q) & (mr < gm.m.g)).expand(gm.T, -1, gm.N)
    off = (t * gm.so[0] + mq * gm.so[1] + mr * gm.so[2] + n * gm.so[3]).expand(gm.T, -1, gm.N)
    out.view(-1)[off[ok]] = vals.to(torch.float32)[ok]
    return out


def _parts(x: torch.Tensor, n: int):
    """x (f64 holding f32 values) cut into n bf16 parts as the kernels cut it."""
    out, rest = [], x.to(torch.float32)
    for _ in range(n):
        p = rest.to(torch.bfloat16).to(torch.float32)
        out.append(p.to(torch.float64))
        rest = rest - p
    return out


def _kernel_fwd(gm: tp.Gemm) -> torch.Tensor:
    """K4: ah.bh + al.bh + ah.bl, A cut in registers, B's halves from its packed planes."""
    ah, al = _parts(_read_a(gm), 2)
    bh, bl = _read_b(gm, False)
    return _write(al @ bh + ah @ bl + ah @ bh, gm)


def _kernel_grad(gm: tp.Gemm) -> torch.Tensor:
    """K5: H and L from the three-part cotangent (the register operand) and
    the other operand's halves (the packed planes), rounded to bf16 and combined."""
    g = sum(_parts(_read_a(gm), 3))
    hi, lo = _read_b(gm, True)
    h, low = ((g @ x).to(torch.float32).to(torch.bfloat16).to(torch.float32) for x in (hi, lo))
    pair = (h + low).to(torch.bfloat16).to(torch.float32)
    return _write(h + (pair - h).to(torch.bfloat16).to(torch.float32), gm)


def _einsum_blend(w, a):
    return torch.einsum("vj,bjz->bvz", w, a)


def _mm(rows_a, cols_b, scale=1.0):
    return lambda rng: (rng.normal(size=rows_a).astype(np.float32),
                        (rng.normal(size=cols_b) * scale).astype(np.float32))


KERNEL_CASES = {  # inputs, the forward Gemm, the gradients' Gemms, the contraction
    "matmul": (_mm_inputs, tp.matmul_gemm, tp.matmul_grad_gemms, torch.matmul),
    "matmul_batched": (_bmm_inputs, tp.matmul_gemm, tp.matmul_grad_gemms, torch.matmul),
    # lbs' pose correctives at a small width: [B, (J-1)*9] @ [(J-1)*9, 3V]; K = 99 is not a
    # multiple of a wgmma k step nor of a ring stage, N = 900 not of a column panel
    "correctives": (_mm((5, 99), (99, 900), 0.01), tp.matmul_gemm, tp.matmul_grad_gemms, torch.matmul),
    # rows past one 64-row tile of a warpgroup, and past the two of a block
    "correctives_b130": (_mm((130, 70), (70, 200), 0.01), tp.matmul_gemm, tp.matmul_grad_gemms, torch.matmul),
    # a transposed lhs: its rows, not k, are contiguous
    "strided_lhs": (lambda rng: (rng.normal(size=(70, 33)).astype(np.float32).T,
                                 rng.normal(size=(70, 41)).astype(np.float32)),
                    tp.matmul_gemm, tp.matmul_grad_gemms, torch.matmul),
    # a 2-D lhs under a batched rhs: its gradient contracts over (t, n), grouped
    "shared_lhs": (_mm((40, 70), (3, 70, 50)), tp.matmul_gemm, tp.matmul_grad_gemms, torch.matmul),
    # the blend: rows (b, z), 16 laid out a body; the weights' gradient contracts over (b, z)
    "blend": (_blend_inputs, tp.blend_gemm, tp.blend_grad_gemms, _einsum_blend),
    "blend_b1": (lambda rng: (rng.random((130, 55)).astype(np.float32), rng.normal(size=(1, 55, 12)).astype(np.float32)),
                 tp.blend_gemm, tp.blend_grad_gemms, _einsum_blend),
}


@pytest.mark.parametrize("name", list(KERNEL_CASES))
def test_kernel_layouts_and_arithmetic_match_the_twins(name):
    make, gemm, grad_gemms, fn = KERNEL_CASES[name]
    rng = np.random.default_rng(2)
    a, b = (torch.from_numpy(x) for x in make(rng))
    gm = gemm(a, b)
    want = tp.split_product_reference(a, b, fn)
    assert tuple(gm.out_shape) == tuple(want.shape)
    got = _kernel_fwd(gm)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=FWD_REL * want.abs().max().item())

    g = torch.from_numpy(rng.normal(size=tuple(want.shape)).astype(np.float32))
    twin = tp.split_product_grad_reference(a, b, g, fn)
    subs = grad_gemms(a, b, g, (True, True))
    for sub, op, ref, what in zip(subs, (a, b), twin, "ab"):
        # float64 sums against the twin's f32 ones: a cotangent block can
        # round the other way, and where a block is small from
        # cancellation, or H and L nearly cancel, one bf16 rounding there
        # is more than one ulp of the element: the bound is one ulp of the
        # operand's largest gradient (the card's check in chip_smoke.py)
        got = _kernel_grad(sub)
        assert got.shape == op.shape
        _bits_close(got.numpy(), ref.numpy(), f"{name} grad {what}", ref.abs().max().item())


def test_the_card_refuses_what_k5_does_not_take():
    """The operands every product of a batch shares: the blend's weights and
    a 2-D lhs under a batched rhs. Their gradients contract over a grouped
    axis, the batch and the rows of one product, so that the sum over the
    batch comes before the bf16 rounding; emulated as K5 reads them, they
    match the twin. A broadcast of a batched operand is still refused."""
    rng = np.random.default_rng(6)
    w, a12 = torch.from_numpy(rng.random((7, 5)).astype(np.float32)), torch.ones(3, 5, 12)
    gm = tp.blend_gemm(w, a12)
    assert gm.m == tp.Axis(3, 16, 12) and (gm.T, gm.N, gm.k) == (1, 7, tp.Axis(1, 16, 5))
    gw, _ = tp.blend_grad_gemms(w, a12, torch.ones(3, 7, 12), (True, False))
    assert gw.k == tp.Axis(3, 16, 12) and gw.out_shape == (7, 5) and gw.sa == (0, 0, 12, 84, 1)
    cases = ((tp.blend_grad_gemms, _einsum_blend, (7, 5), (3, 5, 12)),
             (tp.matmul_grad_gemms, torch.matmul, (7, 5), (3, 5, 2)))
    for grad_gemms, fn, sa, sb in cases:
        a, b = (torch.from_numpy(rng.normal(size=s).astype(np.float32)) for s in (sa, sb))
        g = torch.from_numpy(rng.normal(size=tuple(fn(a, b).shape)).astype(np.float32))
        sub, _ = grad_gemms(a, b, g, (True, False))
        assert sub.T == 1 and sub.k.q == 3  # one product, the batch inside the contraction
        ref = tp.split_product_grad_reference(a, b, g, fn, (True, False))[0]
        _bits_close(_kernel_grad(sub).numpy(), ref.numpy(), "shared operand", ref.abs().max().item())
    gm = tp.matmul_gemm(torch.ones(7, 5), torch.ones(3, 5, 2))
    assert gm.sa[0] == 0 and gm.sb[0] == 10 and gm.out_shape == (3, 7, 2)
    with pytest.raises(NotImplementedError, match="broadcasts only a 2-D operand"):
        tp.matmul_gemm(torch.ones(2, 1, 7, 5), torch.ones(1, 3, 5, 2))


def test_pack_reference_places_and_pads_every_element():
    """The packed planes of a B with a grouped contraction (the weights'
    gradient's A12, B = 3 bodies of Z = 12 laid out as 16) and of one whose
    k and columns end mid-stage and mid-panel: each element's hi and lo
    halves at the kernel's address, psi_tpu's cut, the rest zero."""
    rng = np.random.default_rng(7)
    w, a12 = torch.from_numpy(rng.random((70, 55)).astype(np.float32)), \
        torch.from_numpy(rng.normal(size=(3, 55, 12)).astype(np.float32))
    for gm, grad in ((tp.blend_grad_gemms(w, a12, torch.ones(3, 70, 12), (True, False))[0], True),
                     (tp.blend_gemm(w, a12), False), (tp.matmul_gemm(torch.ones(2, 70), w[:, :33]), False)):
        hi, lo = _read_b(gm, grad)
        x = _read_b_f32(gm)
        np.testing.assert_array_equal(hi.float().numpy(), x.to(torch.bfloat16).float().numpy())
        np.testing.assert_array_equal(lo.float().numpy(),
                                      (x - x.to(torch.bfloat16).float()).to(torch.bfloat16).float().numpy())


def _read_b_f32(gm: tp.Gemm) -> torch.Tensor:
    """B [T, k.size, N] in f32 straight from its source through gm.sb, zero where k does not exist."""
    t = torch.arange(gm.T)[:, None, None]
    k, n = torch.arange(gm.k.size)[None, :, None], torch.arange(gm.N)[None, None, :]
    kq, kr = k // gm.k.r, k % gm.k.r
    ok = ((kq < gm.k.q) & (kr < gm.k.g)).expand(gm.T, -1, gm.N)
    off = (t * gm.sb[0] + kq * gm.sb[1] + kr * gm.sb[2] + n * gm.sb[3]) * ok
    flat = torch.as_strided(gm.b, (int(off.max()) + 1,), (1,))
    return torch.where(ok, flat[off], 0.0)


def test_pack_cache_keeps_a_constant_and_repacks_after_an_in_place_change():
    """The cache returns the same planes while the source is unchanged,
    repacks after an in-place change (its _version), keeps one entry a
    layout, and lets the entry go with the tensor."""
    cache = tp.PackCache()
    src = torch.from_numpy(np.random.default_rng(8).normal(size=(40, 30)).astype(np.float32))
    builds = []

    def build():
        builds.append(1)
        return src.to(torch.bfloat16).clone()

    first = cache.get(src, ("k4",), build)
    assert cache.get(src, ("k4",), build) is first and len(builds) == 1
    cache.get(src, ("k5",), build)
    assert len(builds) == 2 and cache.nbytes() == 2 * src.numel() * 2
    src.mul_(2.0)
    again = cache.get(src, ("k4",), build)
    assert again is not first and len(builds) == 3 and torch.equal(again, src.to(torch.bfloat16))
    del src, first, again
    assert cache.nbytes() == 0


def test_pack_cache_reports_what_it_serves_to_this_thread_inside_served():
    """Inside ``served()`` a hit is logged with its source and version (what a
    CUDA graph captured there reads); a miss, a hit outside and another
    thread's hit are not."""
    cache = tp.PackCache()
    src, other = torch.ones(6), torch.zeros(6)
    planes = cache.get(src, ("k4",), lambda: src.to(torch.bfloat16))
    with cache.served() as log:
        cache.get(other, ("k4",), lambda: other.to(torch.bfloat16))  # a miss: packed now, not served from the cache
        assert cache.get(src, ("k4",), None) is planes
        worker = threading.Thread(target=cache.get, args=(other, ("k4",), None))
        worker.start()
        worker.join()
    cache.get(src, ("k4",), None)
    ((ref, version, got),) = log
    assert ref() is src and version == src._version and got is planes


# ---- lbs at 'high' and at exact=True

B, V, J = 5, 300, 12


@pytest.fixture(scope="module")
def models():
    jm = j_synthetic_smplx(num_verts=V, num_joints=J, seed=0)
    host = jax.device_get(jm)
    return jm, smplx_from_numpy(host.parents, **{f: getattr(host, f) for f in SMPLX_FIELDS})


@pytest.mark.parametrize("exact", [False, True])
def test_lbs_high_matches_psi_tpu(models, exact):
    jm, tm = models
    rng = np.random.default_rng(3)
    betas = rng.normal(0, 1.0, (B, 10)).astype(np.float32)
    pose = rng.normal(0, 0.3, (B, J * 3)).astype(np.float32)
    vj, jj = j_lbs(jnp.asarray(betas), jnp.asarray(pose), jm.v_template, jm.shapedirs, jm.posedirs,
                   jm.J_regressor, jm.parents, jm.lbs_weights, exact=exact)
    vt, jt = t_lbs(torch.from_numpy(betas), torch.from_numpy(pose), tm.v_template, tm.shapedirs, tm.posedirs,
                   tm.J_regressor, tm.parents, tm.lbs_weights, exact=exact)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=LBS_TOL, rtol=0)
    np.testing.assert_allclose(jt.numpy(), np.asarray(jj), atol=LBS_TOL, rtol=0)


def _lbs_grads(models, exact_t, exact_j):
    """d sum(verts * ct) / d (pose, betas) of both packages' lbs."""
    jm, tm = models
    rng = np.random.default_rng(5)
    betas = rng.normal(0, 1.0, (B, 10)).astype(np.float32)
    pose = rng.normal(0, 0.3, (B, J * 3)).astype(np.float32)
    ct = rng.normal(size=(B, V, 3)).astype(np.float32)

    def jfun(p, b):
        v, _ = j_lbs(b, p, jm.v_template, jm.shapedirs, jm.posedirs, jm.J_regressor, jm.parents, jm.lbs_weights,
                     exact=exact_j)
        return jnp.sum(v * ct)

    gj = jax.grad(jfun, argnums=(0, 1))(jnp.asarray(pose), jnp.asarray(betas))
    p, b = torch.from_numpy(pose).requires_grad_(True), torch.from_numpy(betas).requires_grad_(True)
    v, _ = t_lbs(b, p, tm.v_template, tm.shapedirs, tm.posedirs, tm.J_regressor, tm.parents, tm.lbs_weights,
                 exact=exact_t)
    (v * torch.from_numpy(ct)).sum().backward()
    return [(t.grad.numpy(), np.asarray(j)) for t, j in zip((p, b), gj)]


@pytest.mark.parametrize("exact", [False, True])
def test_lbs_gradients_match_psi_tpu(models, exact):
    """The pose and shape gradients at 'high' (bf16 cotangents in both) and
    at exact=True. A port that ran 'high' in plain f32 would miss psi_tpu's
    'high' pose gradient beyond LBS_GRAD_TOL on most entries (93% here)."""
    for got, want in _lbs_grads(models, exact, exact):
        rel = np.abs(got - want) / np.abs(want).max()
        assert (rel <= LBS_GRAD_TOL).mean() >= LBS_GRAD_SHARE and rel.max() <= 10 * LBS_GRAD_TOL, rel.max()
    if not exact:
        got, want = _lbs_grads(models, True, False)[0]
        assert (np.abs(got - want) > LBS_GRAD_TOL * np.abs(want).max()).mean() > 0.5


def test_lbs_high_is_split_bf16_not_plain_f32(models):
    """'high' differs from exact=True by the split's ~2^-16 (psi_tpu's own
    gap), and its pose gradient from the f32 one by bf16-class amounts."""
    _, tm = models
    rng = np.random.default_rng(4)
    betas = torch.from_numpy(rng.normal(0, 1.0, (B, 10)).astype(np.float32))
    args = (tm.v_template, tm.shapedirs, tm.posedirs, tm.J_regressor, tm.parents, tm.lbs_weights)
    pose0 = rng.normal(0, 0.3, (B, J * 3)).astype(np.float32)
    grads = {}
    for exact in (False, True):
        pose = torch.from_numpy(pose0).requires_grad_(True)
        v, _ = t_lbs(betas, pose, *args, exact=exact)
        v.sum().backward()
        grads[exact] = (v.detach(), pose.grad)
    d = (grads[False][0] - grads[True][0]).abs().max().item()
    assert 1e-8 < d < 1e-4, d
    g = (grads[False][1] - grads[True][1]).abs().max().item() / grads[True][1].abs().max().item()
    assert 1e-6 < g < 1e-2, g
