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
read it (``Gemm``, through its strides) and computed with K4's and K5's
arithmetic in float64 (exact products, the hi/lo and three-part cuts,
the combine), held to the twins as the card holds the kernels.

And ``lbs`` at 'high' against psi_tpu's unpatched 'high', and at
``exact=True`` against psi_tpu's ``exact=True``, on the small SMPL-X model
of test_torch_body.py.
"""

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

def _offsets(lay: tp.Layout, T: int, R: int, C: int) -> torch.Tensor:
    t, r, c = torch.arange(T)[:, None, None], torch.arange(R)[None, :, None], torch.arange(C)[None, None, :]
    return t * lay.st + r * lay.sr + (c // lay.g) * lay.sq + (c % lay.g) * lay.sc


def _read(x: torch.Tensor, lay: tp.Layout, T: int, R: int, C: int) -> torch.Tensor:
    """The [T, R, C] matrices that a kernel reads from x through ``lay``, in float64."""
    off = _offsets(lay, T, R, C)
    return torch.as_strided(x, (int(off.max()) + 1,), (1,))[off].to(torch.float64)


def _write(vals: torch.Tensor, gm: tp.Gemm) -> torch.Tensor:
    """A new tensor of gm.out_shape with vals [T, M, N] written through gm.lo."""
    out = torch.full(gm.out_shape, float("nan"))
    out.view(-1)[_offsets(gm.lo, gm.T, gm.M, gm.N)] = vals.to(torch.float32)
    return out


def _parts(x: torch.Tensor, n: int):
    """x (f64 holding f32 values) cut into n bf16 parts as the kernels cut it."""
    out, rest = [], x.to(torch.float32)
    for _ in range(n):
        p = rest.to(torch.bfloat16).to(torch.float32)
        out.append(p.to(torch.float64))
        rest = rest - p
    return out


def _operands(gm: tp.Gemm):
    return _read(gm.a, gm.la, gm.T, gm.M, gm.K), _read(gm.b, gm.lb, gm.T, gm.K, gm.N)


def _kernel_fwd(gm: tp.Gemm) -> torch.Tensor:
    """K4: ah.bh + al.bh + ah.bl over the Gemm's operands, through its layouts."""
    A, B = _operands(gm)
    (ah, al), (bh, bl) = _parts(A, 2), _parts(B, 2)
    return _write(ah @ bh + al @ bh + ah @ bl, gm)


def _kernel_grad(gm: tp.Gemm, cot_is_a: bool) -> torch.Tensor:
    """K5: H and L from the three-part cotangent and the other operand's
    halves, rounded to bf16 and combined."""
    A, B = _operands(gm)
    if cot_is_a:
        g = sum(_parts(A, 3))
        hi, lo = _parts(B, 2)
        sums = (g @ hi, g @ lo)
    else:
        g = sum(_parts(B, 3))
        hi, lo = _parts(A, 2)
        sums = (hi @ g, lo @ g)
    h, low = (x.to(torch.float32).to(torch.bfloat16).to(torch.float32) for x in sums)
    pair = (h + low).to(torch.bfloat16).to(torch.float32)
    return _write(h + (pair - h).to(torch.bfloat16).to(torch.float32), gm)


def _einsum_blend(w, a):
    return torch.einsum("vj,bjz->bvz", w, a)


KERNEL_CASES = {  # inputs, the Gemm, the contraction, the gradients K5 serves
    "matmul": (_mm_inputs, tp.matmul_gemm, torch.matmul, (True, True)),
    "matmul_batched": (_bmm_inputs, tp.matmul_gemm, torch.matmul, (True, True)),
    # lbs' pose correctives at a small width: [B, (J-1)*9] @ [(J-1)*9, 3V]
    "correctives": (lambda rng: (rng.normal(size=(5, 99)).astype(np.float32),
                                 (rng.normal(size=(99, 900)) * 0.01).astype(np.float32)),
                    tp.matmul_gemm, torch.matmul, (True, True)),
    # a transposed lhs: its rows, not k, are contiguous
    "strided_lhs": (lambda rng: (rng.normal(size=(70, 33)).astype(np.float32).T,
                                 rng.normal(size=(70, 41)).astype(np.float32)),
                    tp.matmul_gemm, torch.matmul, (True, True)),
    # the blend: the weights are shared by the bodies, K5 serves only A12's gradient
    "blend": (_blend_inputs, tp.blend_gemm, _einsum_blend, (False, True)),
}


@pytest.mark.parametrize("name", list(KERNEL_CASES))
def test_kernel_layouts_and_arithmetic_match_the_twins(name):
    make, gemm, fn, served = KERNEL_CASES[name]
    rng = np.random.default_rng(2)
    a, b = (torch.from_numpy(x) for x in make(rng))
    gm = gemm(a, b)
    want = tp.split_product_reference(a, b, fn)
    assert tuple(gm.out_shape) == tuple(want.shape)
    got = _kernel_fwd(gm)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=FWD_REL * want.abs().max().item())

    g = torch.from_numpy(rng.normal(size=tuple(want.shape)).astype(np.float32))
    twin = tp.split_product_grad_reference(a, b, g, fn)
    subs = tp.grad_gemms(gm, g, (tuple(a.shape), tuple(b.shape)))
    assert (subs[0] is None) == (name == "blend")  # the blend's columns are grouped: no product for w's gradient
    for serve, sub, cot, op, ref, what in zip(served, subs, (True, False), (a, b), twin, "ab"):
        if serve:
            # float64 sums against the twin's f32 ones: a cotangent block can
            # round the other way, and where a block is small from
            # cancellation, or H and L nearly cancel, one bf16 rounding there
            # is more than one ulp of the element: the bound is one ulp of the
            # operand's largest gradient (the card's check in chip_smoke.py)
            got = _kernel_grad(sub, cot)
            assert got.shape == op.shape
            _bits_close(got.numpy(), ref.numpy(), f"{name} grad {what}", ref.abs().max().item())


def test_the_card_refuses_what_k5_does_not_take():
    """The blend's weights are shared by every body: their gradient needs a
    sum over the bodies that K5 does not take, so the card raises for it
    (no path asks for it); a 2-D lhs under a batched rhs likewise."""
    gm = tp.blend_gemm(torch.ones(7, 5), torch.ones(3, 5, 12))
    assert gm.shared == (True, False) and (gm.T, gm.M, gm.N, gm.K) == (1, 7, 36, 5)
    with pytest.raises(NotImplementedError, match="shared across the batch"):
        tp._card_backward(torch.ones(7, 5), torch.ones(3, 5, 12), torch.ones(3, 7, 12), tp.blend_gemm,
                          (True, False))
    gm = tp.matmul_gemm(torch.ones(7, 5), torch.ones(3, 5, 2))
    assert gm.la.st == 0 and gm.lb.st == 10 and gm.out_shape == (3, 7, 2) and gm.shared == (True, False)
    with pytest.raises(NotImplementedError, match="shared across the batch"):
        tp._card_backward(torch.ones(7, 5), torch.ones(3, 5, 2), torch.ones(3, 7, 2), tp.matmul_gemm,
                          (True, True))
    with pytest.raises(NotImplementedError, match="broadcasts only a 2-D operand"):
        tp.matmul_gemm(torch.ones(2, 1, 7, 5), torch.ones(1, 3, 5, 2))


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
