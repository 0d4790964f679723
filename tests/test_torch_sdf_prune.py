"""Packed SDF lookups and Morton-tile pruning: psi_tpu_torch vs psi_tpu.

Both sides are plain gathers plus f32 trilinear arithmetic in the same
order; SDF values are O(1) metres -> 1e-5 absolute, and anything gathered
(corner rows, floor coords, selected points) must be bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psi_tpu.data.scenes import synthetic_scene_registry as j_registry
from psi_tpu.ops import prune as jprune
from psi_tpu.ops import sdf as jsdf
from psi_tpu_torch.data.scenes import synthetic_scene_registry as t_registry
from psi_tpu_torch.ops import prune as tprune
from psi_tpu_torch.ops import sdf as tsdf

torch.set_num_threads(1)
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module")
def registry():
    rj = j_registry(num_scenes=3, dim=16, num_verts=500, seed=0, varied_dims=True)
    rt = t_registry(num_scenes=3, dim=16, num_verts=500, seed=0, varied_dims=True)
    return rj, rt


def _to_torch(a: jax.Array) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def grids(registry):
    rj, _ = registry
    packed_j = jsdf.pack_sdf_corners(jnp.asarray(rj.sdf_stack))
    out = {}
    for name, (jd, td) in DTYPES.items():
        pj = packed_j.astype(jd)
        out[name] = (pj, _to_torch(pj))
    return out


@pytest.fixture(scope="module")
def points(registry):
    rj, _ = registry
    rng = np.random.default_rng(1)
    sidx = np.array([0, 2, 1, 2], np.int32)
    lo, hi = rj.grid_mins[sidx], rj.grid_maxs[sidx]
    # some points outside the grid exercise the border clamp
    pts = lo[:, None] + (hi - lo)[:, None] * rng.uniform(-0.1, 1.1, (4, 64, 3))
    return sidx, pts.astype(np.float32)


def test_registry_is_the_same(registry):
    rj, rt = registry
    assert rj.names == rt.names
    for f in ("sdf_stack", "grid_mins", "grid_maxs", "verts_stack", "n_verts"):
        np.testing.assert_array_equal(getattr(rt, f), getattr(rj, f), err_msg=f)


def test_pack_sdf_corners_matches_jax(registry, grids):
    _, rt = registry
    np.testing.assert_array_equal(
        tsdf.pack_sdf_corners(torch.from_numpy(rt.sdf_stack)).numpy(), np.asarray(grids["f32"][0])
    )


def _args_j(rj, sidx, pts):
    return jnp.asarray(sidx), jnp.asarray(pts), jnp.asarray(rj.grid_mins), jnp.asarray(rj.grid_maxs)


def _args_t(rt, sidx, pts):
    return (torch.from_numpy(sidx).long(), torch.from_numpy(pts),
            torch.from_numpy(rt.grid_mins), torch.from_numpy(rt.grid_maxs))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_sdf_trilinear_packed_matches_jax(registry, grids, points, dtype):
    rj, rt = registry
    pj, pt = grids[dtype]
    sidx, pts = points
    sj = np.asarray(jsdf.sdf_trilinear_packed(pj, *_args_j(rj, sidx, pts)))
    st = tsdf.sdf_trilinear_packed(pt, *_args_t(rt, sidx, pts)).numpy()
    np.testing.assert_allclose(st, sj, atol=1e-5, rtol=0)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_sdf_cached_and_from_cache_match_jax(registry, grids, points, dtype):
    rj, rt = registry
    pj, pt = grids[dtype]
    sidx, pts = points
    sj, (cj, bj) = jsdf.sdf_trilinear_packed_cached(pj, *_args_j(rj, sidx, pts))
    st, (ct, bt) = tsdf.sdf_trilinear_packed_cached(pt, *_args_t(rt, sidx, pts))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-5, rtol=0)
    assert ct.dtype == pt.dtype  # the cache keeps the grid's dtype
    np.testing.assert_array_equal(ct.float().numpy(), np.asarray(cj.astype(jnp.float32)))
    np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))
    # moved points: the unclamped linear extrapolation of the cached cell
    moved = pts + np.random.default_rng(2).normal(0, 0.3, pts.shape).astype(np.float32)
    dims = tuple(pt.shape[1:4])
    fj = np.asarray(jsdf.sdf_trilinear_from_cache((cj, bj), *_args_j(rj, sidx, moved), dims))
    ft = tsdf.sdf_trilinear_from_cache((ct, bt), *_args_t(rt, sidx, moved), dims).numpy()
    np.testing.assert_allclose(ft, fj, atol=1e-5, rtol=0)


def test_sdf_gradient_matches_jax(registry, grids, points):
    rj, rt = registry
    pj, pt = grids["bf16"]
    sidx, pts = points
    w = np.random.default_rng(3).normal(size=pts.shape[:2]).astype(np.float32)
    gj = jax.grad(lambda p: jnp.sum(jsdf.sdf_trilinear_packed(pj, jnp.asarray(sidx), p,
                                                              jnp.asarray(rj.grid_mins),
                                                              jnp.asarray(rj.grid_maxs)) * w))(jnp.asarray(pts))
    s, p, lo, hi = _args_t(rt, sidx, pts)
    p.requires_grad_(True)
    (tsdf.sdf_trilinear_packed(pt, s, p, lo, hi) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(gj), atol=1e-4, rtol=0)


@pytest.mark.parametrize("k_points, m", [(64, 500), (100, 490), (1024, 500)])
def test_select_near_tiles_matches_jax(registry, k_points, m):
    """Same tile set, same order (exact top-k over distinct tile minima);
    m=490 takes the far-padding path, k >= M returns every point."""
    _, rt = registry
    rng = np.random.default_rng(4)
    pts = rt.verts_stack[:, :m]
    centroid = rng.uniform(-1, 1, (pts.shape[0], 3)).astype(np.float32)
    cj = np.asarray(jprune.select_near_tiles(jnp.asarray(pts), jnp.asarray(centroid), k_points))
    ct = tprune.select_near_tiles(torch.from_numpy(np.array(pts)), torch.from_numpy(centroid), k_points).numpy()
    assert ct.shape == cj.shape
    np.testing.assert_array_equal(ct, cj)


def test_morton_order_is_the_same():
    pts = np.random.default_rng(5).uniform(-3, 3, (300, 3)).astype(np.float32)
    np.testing.assert_array_equal(tprune.morton_argsort(pts), jprune.morton_argsort(pts))
