"""The scalar-grid SDF lookups: psi_tpu_torch vs psi_tpu, and the
reference's F.grid_sample.

grid_sample_3d, sdf_trilinear and sdf_trilinear_stacked fetch 8 scalar
corners per point and interpolate in the same order as psi_tpu; values
are O(1), held to 1e-6 relative (plus 1e-6 absolute near zero: XLA may
contract a multiply-add that torch rounds twice). F.grid_sample combines
the corners in another order: 1e-5 absolute.

Gradients w.r.t. the points are held only at points strictly inside the
grid or strictly outside it: at exactly a border jnp.clip and torch.clamp
split the gradient differently.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from psi_tpu.data.scenes import synthetic_scene_registry
from psi_tpu.ops import sdf as jsdf
from psi_tpu_torch.ops import sdf as tsdf

torch.set_num_threads(1)
VAL = dict(rtol=1e-6, atol=1e-6)
GRAD = dict(rtol=1e-5, atol=1e-5)
SIDX = np.array([0, 2, 1, 2], np.int32)


@pytest.fixture(scope="module")
def registry():
    return synthetic_scene_registry(num_scenes=3, dim=16, num_verts=100, seed=0)


def _points(registry, region, seed=1, n=64):
    """World points per body of SIDX: 'mixed' spans the grid and 10% past
    it; 'inside' stays 5% in from every face; 'outside' lies beyond it."""
    rng = np.random.default_rng(seed)
    lo, hi = registry.grid_mins[SIDX][:, None], registry.grid_maxs[SIDX][:, None]
    if region == "outside":
        u = rng.uniform(1.1, 1.5, (len(SIDX), n, 3)) * rng.choice([-1.0, 1.0], (len(SIDX), n, 3))
        u = 0.5 + 0.5 * u  # beyond [0, 1] on every axis
    else:
        a, b = (-0.1, 1.1) if region == "mixed" else (0.05, 0.95)
        u = rng.uniform(a, b, (len(SIDX), n, 3))
    return (lo + (hi - lo) * u).astype(np.float32)


def _stacked_args(registry, pts):
    return registry.sdf_stack, SIDX, pts, registry.grid_mins, registry.grid_maxs


def _per_body_args(registry, pts):
    return registry.sdf_stack[SIDX], pts, registry.grid_mins[SIDX], registry.grid_maxs[SIDX]


def _grid_sample_args(registry, pts):
    """Normalised coords in torch's (x->W, y->H, z->D) order on the same grids."""
    lo, hi = registry.grid_mins[SIDX][:, None], registry.grid_maxs[SIDX][:, None]
    norm = (pts - lo) / (hi - lo) * 2.0 - 1.0
    return registry.sdf_stack[SIDX], norm.astype(np.float32)


# (name, function making its arguments, index of the points among them)
FUNCS = [
    ("grid_sample_3d", _grid_sample_args, 1),
    ("sdf_trilinear", _per_body_args, 1),
    ("sdf_trilinear_stacked", _stacked_args, 2),
]


def _jax_args(args):
    return [jnp.asarray(a) for a in args]


def _torch_args(args):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in args]


@pytest.mark.parametrize("name, build, _", FUNCS)
def test_values_match_jax(registry, name, build, _):
    args = build(registry, _points(registry, "mixed"))
    vj = np.asarray(getattr(jsdf, name)(*_jax_args(args)))
    vt = getattr(tsdf, name)(*_torch_args(args)).numpy()
    assert vt.shape == vj.shape == (len(SIDX), 64)
    np.testing.assert_allclose(vt, vj, **VAL)


def test_grid_sample_3d_is_torchs_grid_sample(registry):
    """The reference's call: grid [B, 1, D, H, W], coords [B, N, 1, 1, 3],
    align_corners=False, border padding."""
    grid, coords = _torch_args(_grid_sample_args(registry, _points(registry, "mixed")))
    B, N, _ = coords.shape
    ref = F.grid_sample(grid[:, None], coords.view(B, N, 1, 1, 3), align_corners=False,
                        padding_mode="border").view(B, N)
    np.testing.assert_allclose(tsdf.grid_sample_3d(grid, coords).numpy(), ref.numpy(), rtol=0, atol=1e-5)


def test_stacked_is_the_per_body_lookup_and_the_packed_one(registry):
    pts = _points(registry, "mixed")
    stacked = tsdf.sdf_trilinear_stacked(*_torch_args(_stacked_args(registry, pts)))
    per_body = tsdf.sdf_trilinear(*_torch_args(_per_body_args(registry, pts)))
    sdf, sidx, p, lo, hi = _torch_args(_stacked_args(registry, pts))
    packed = tsdf.sdf_trilinear_packed(tsdf.pack_sdf_corners(sdf), sidx.long(), p, lo, hi)
    np.testing.assert_allclose(stacked.numpy(), per_body.numpy(), **VAL)
    np.testing.assert_allclose(stacked.numpy(), packed.numpy(), **VAL)


@pytest.mark.parametrize("region", ["inside", "outside"])
@pytest.mark.parametrize("name, build, pos", FUNCS)
def test_gradients_match_jax(registry, name, build, pos, region):
    pts = _points(registry, region)
    w = np.random.default_rng(3).normal(size=pts.shape[:2]).astype(np.float32)
    args = build(registry, pts)

    def loss_j(p):
        a = _jax_args(args)
        a[pos] = p
        return jnp.sum(getattr(jsdf, name)(*a) * w)

    gj = np.asarray(jax.grad(loss_j)(jnp.asarray(args[pos])))
    a = _torch_args(args)
    a[pos].requires_grad_(True)
    (getattr(tsdf, name)(*a) * torch.from_numpy(w)).sum().backward()
    gt = a[pos].grad.numpy()
    if region == "outside":  # the border clamp stops every gradient
        assert not gt.any() and not gj.any()
    np.testing.assert_allclose(gt, gj, **GRAD)


@pytest.mark.parametrize("case", ["mixed", "none_penetrate"])
def test_penetration_loss_matches_jax(case):
    rng = np.random.default_rng(4)
    s = rng.normal(0, 0.5, (4, 200)).astype(np.float32)
    if case == "none_penetrate":
        s = np.abs(s) + 0.01
    lj, gj = jax.value_and_grad(lambda x: jsdf.sdf_penetration_loss(x))(jnp.asarray(s))
    st = torch.from_numpy(s).requires_grad_(True)
    lt = tsdf.sdf_penetration_loss(st)
    lt.backward()
    np.testing.assert_allclose(lt.item(), float(lj), **VAL)
    np.testing.assert_allclose(st.grad.numpy(), np.asarray(gj), **VAL)
    if case == "none_penetrate":
        assert lt.item() == 0.0
