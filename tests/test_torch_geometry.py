"""psi_tpu_torch.geometry vs psi_tpu.geometry on the same numpy inputs.

Tolerance: both sides compute in float32 with the same formulas but in
another operation order, on O(1) values -> 2e-5 absolute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psi_tpu.geometry import bodyvec as jbv
from psi_tpu.geometry import camera as jcam
from psi_tpu.geometry import rot6d as jr
from psi_tpu_torch.geometry import bodyvec as tbv
from psi_tpu_torch.geometry import camera as tcam
from psi_tpu_torch.geometry import rot6d as tr

torch.set_num_threads(1)
ATOL = 2e-5


def _both(fn_name, x, mod_j=jr, mod_t=tr):
    out_j = np.asarray(getattr(mod_j, fn_name)(jnp.asarray(x)))
    out_t = getattr(mod_t, fn_name)(torch.from_numpy(x)).numpy()
    return out_j, out_t


def _rotations(rng, n):
    return np.array(jr.aa_to_matrix(jnp.asarray(rng.normal(0, 1.0, (n, 3)).astype(np.float32))))


@pytest.mark.parametrize(
    "fn_name, make",
    [
        ("aa_to_matrix", lambda rng: rng.normal(0, 1.0, (64, 3)).astype(np.float32)),
        ("rot6d_to_matrix", lambda rng: rng.normal(0, 1.0, (64, 6)).astype(np.float32)),
        ("matrix_to_rot6d", lambda rng: _rotations(rng, 64)),
        ("matrix_to_quat", lambda rng: _rotations(rng, 64)),
        ("quat_to_aa", lambda rng: np.array(jr.matrix_to_quat(jnp.asarray(_rotations(rng, 64))))),
        ("matrix_to_aa", lambda rng: _rotations(rng, 64)),
        ("aa_to_rot6d", lambda rng: rng.normal(0, 1.0, (64, 3)).astype(np.float32)),
        ("rot6d_to_aa", lambda rng: rng.normal(0, 1.0, (64, 6)).astype(np.float32)),
    ],
)
def test_rot6d_matches_jax(fn_name, make):
    x = make(np.random.default_rng(0))
    out_j, out_t = _both(fn_name, x)
    np.testing.assert_allclose(out_t, out_j, atol=ATOL, rtol=0)


def test_rot6d_singular_points_match_jax():
    """Angle 0 (Taylor branch) and angle pi (non-w pivot) agree."""
    aa = np.array([[0, 0, 0], [1e-5, 0, 0], [np.pi, 0, 0], [0, np.pi - 1e-4, 0]], np.float32)
    out_j, out_t = _both("aa_to_matrix", aa)
    np.testing.assert_allclose(out_t, out_j, atol=ATOL, rtol=0)
    out_j, out_t = _both("matrix_to_aa", np.array(out_j))
    np.testing.assert_allclose(out_t, out_j, atol=1e-4, rtol=0)  # angle pi: sqrt of a ~1e-8 pivot


@pytest.mark.parametrize("fn_name", ["aa_to_matrix", "aa_to_rot6d"])
def test_gradient_finite_and_matches_jax_at_zero_angle(fn_name):
    """The double-where keeps d/d(aa) finite at theta = 0 (both packages)."""
    rng = np.random.default_rng(1)
    aa = np.zeros((3, 3), np.float32)
    aa[1] = rng.normal(0, 0.5, 3)
    w = rng.normal(size=np.asarray(getattr(jr, fn_name)(jnp.asarray(aa))).shape).astype(np.float32)
    g_j = np.asarray(jax.grad(lambda a: jnp.sum(getattr(jr, fn_name)(a) * w))(jnp.asarray(aa)))
    a_t = torch.from_numpy(aa).requires_grad_(True)
    (getattr(tr, fn_name)(a_t) * torch.from_numpy(w)).sum().backward()
    assert np.all(np.isfinite(a_t.grad.numpy()))
    np.testing.assert_allclose(a_t.grad.numpy(), g_j, atol=1e-4, rtol=0)


def test_matrix_to_aa_gradient_finite_at_identity():
    """quat_to_aa at the identity (|v| = 0): the port's gradient is finite."""
    x6 = torch.tensor([[1.0, 0.0, 0.0, 1.0, 0.0, 0.0]], requires_grad=True)
    tr.rot6d_to_aa(x6).sum().backward()
    assert torch.isfinite(x6.grad).all()
    q = torch.tensor([[1.0, 0.0, 0.0, 0.0]], requires_grad=True)
    tr.quat_to_aa(q).sum().backward()
    assert torch.isfinite(q.grad).all()


@pytest.mark.parametrize("fn_name", ["convert_to_6D_rot", "convert_to_3D_rot"])
def test_bodyvec_converters_match_jax(fn_name):
    rng = np.random.default_rng(2)
    x = rng.normal(0, 0.5, (16, 72 if fn_name == "convert_to_6D_rot" else 75)).astype(np.float32)
    out_j, out_t = _both(fn_name, x, jbv, tbv)
    np.testing.assert_allclose(out_t, out_j, atol=ATOL, rtol=0)


def test_body_params_encapsulate_layout():
    x = np.arange(2 * 72, dtype=np.float32).reshape(2, 72)
    pj = jbv.body_params_encapsulate(jnp.asarray(x))
    pt = tbv.body_params_encapsulate(torch.from_numpy(x))
    assert set(pj) == set(pt)
    for k in pj:
        np.testing.assert_array_equal(pt[k].numpy(), np.asarray(pj[k]))


def _camera(rng, n):
    cam_int = np.zeros((n, 3, 3), np.float32)
    cam_int[:, 0, 0] = rng.uniform(500, 1100, n)
    cam_int[:, 1, 1] = rng.uniform(500, 1100, n)
    cam_int[:, 0, 2] = rng.uniform(250, 550, n)
    cam_int[:, 1, 2] = rng.uniform(250, 550, n)
    cam_int[:, 2, 2] = 1.0
    return cam_int, rng.uniform(4.0, 6.0, n).astype(np.float32)


@pytest.mark.parametrize("fn_name", ["recover_global_T", "normalize_global_T"])
def test_camera_translation_codecs_match_jax(fn_name):
    rng = np.random.default_rng(3)
    cam_int, max_d = _camera(rng, 16)
    x = rng.normal(0, 0.3, (16, 72)).astype(np.float32)
    x[:, 2] = rng.uniform(1.0, 4.0, 16)
    out_j = np.asarray(getattr(jcam, fn_name)(jnp.asarray(x), jnp.asarray(cam_int), jnp.asarray(max_d)))
    out_t = getattr(tcam, fn_name)(torch.from_numpy(x), torch.from_numpy(cam_int), torch.from_numpy(max_d)).numpy()
    np.testing.assert_allclose(out_t, out_j, rtol=1e-5, atol=1e-5)


def test_verts_transform_matches_jax():
    rng = np.random.default_rng(4)
    verts = rng.normal(0, 1.0, (3, 50, 3)).astype(np.float32)
    cam = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    cam[:, :3, :3] = _rotations(rng, 3)
    cam[:, :3, 3] = rng.normal(0, 0.5, (3, 3))
    out_j = np.asarray(jcam.verts_transform(jnp.asarray(verts), jnp.asarray(cam)))
    out_t = tcam.verts_transform(torch.from_numpy(verts), torch.from_numpy(cam)).numpy()
    np.testing.assert_allclose(out_t, out_j, atol=ATOL, rtol=0)
