"""psi_tpu_torch.body vs psi_tpu.body at V=300, J=12 on identical models.

Tolerances, by tier:
* 'high': both packages run the two large contractions as split-bf16
  products (~2^-16 relative) on the same bf16 halves; only f32 sums taken
  in another order differ -> 2e-5 absolute on metre-scale vertices
  (measured 4.2e-6, through the VPoser decode; 1.9e-6 for lbs alone).
* 'fast': the port rounds the large contractions' operands to bf16, the
  TPU's numerics; psi_tpu on the CPU computes 'fast' in plain f32 (its
  rounding happens inside the TPU's matrix unit) -> the bf16 input
  rounding bound of tests/test_fused_skinning.py, 2.5e-2.
* 'fused': both sides feed the same bf16-rounded operands to the kernel
  math (psi_tpu runs its Pallas kernel in interpret mode) -> 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psi_tpu.body.decode import body_vec_to_verts as j_decode
from psi_tpu.body.lbs import lbs as j_lbs
from psi_tpu.body.smplx_model import smplx_forward as j_forward
from psi_tpu.body.smplx_model import synthetic_smplx as j_synthetic_smplx
from psi_tpu.body.vposer import synthetic_vposer_params, vposer_decode as j_vposer_decode
from psi_tpu_torch.body.decode import body_vec_to_verts as t_decode
from psi_tpu_torch.body.lbs import lbs as t_lbs
from psi_tpu_torch.body.smplx_model import smplx_forward as t_forward
from psi_tpu_torch.body.smplx_model import synthetic_smplx as t_synthetic_smplx
from psi_tpu_torch.body.vposer import vposer_decode as t_vposer_decode
from psi_tpu_torch.utils.convert_jax import SMPLX_FIELDS, smplx_from_numpy, vposer_from_jax

torch.set_num_threads(1)
B, V, J = 5, 300, 12
TOL = {"high": 2e-5, "fast": 2.5e-2, "fused": 1e-4}


@pytest.fixture(scope="module")
def models():
    jm = j_synthetic_smplx(num_verts=V, num_joints=J, seed=0)
    host = jax.device_get(jm)
    tm = smplx_from_numpy(host.parents, **{f: getattr(host, f) for f in SMPLX_FIELDS})
    jvp = synthetic_vposer_params(seed=0)
    return jm, tm, jvp, vposer_from_jax(jax.device_get(jvp))


@pytest.fixture(scope="module")
def params():
    rng = np.random.default_rng(1)
    return dict(
        transl=rng.normal(0, 0.5, (B, 3)).astype(np.float32),
        global_orient=rng.normal(0, 0.3, (B, 3)).astype(np.float32),
        betas=rng.normal(0, 1.0, (B, 10)).astype(np.float32),
        body_pose=rng.normal(0, 0.3, (B, (J - 1) * 3)).astype(np.float32),
    )


def _cam(rng, n):
    cam = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    th = rng.normal(0, 0.2, n).astype(np.float32)
    cam[:, 0, 0], cam[:, 0, 1] = np.cos(th), -np.sin(th)
    cam[:, 1, 0], cam[:, 1, 1] = np.sin(th), np.cos(th)
    cam[:, :3, 3] = rng.normal(0, 0.5, (n, 3)).astype(np.float32)
    return cam


def test_synthetic_smplx_is_the_same_model(models):
    """The port's numpy copy draws exactly psi_tpu's arrays from a seed."""
    jm, tm, _, _ = models
    own = t_synthetic_smplx(num_verts=V, num_joints=J, seed=0)
    assert own.parents == tm.parents == jm.parents
    for f in SMPLX_FIELDS:
        a, b = getattr(own, f), getattr(tm, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=f)


@pytest.mark.parametrize("precision", ["high", "fast"])
def test_lbs_matches_jax(models, params, precision):
    jm, tm, _, _ = models
    rng = np.random.default_rng(2)
    pose = rng.normal(0, 0.3, (B, J * 3)).astype(np.float32)
    betas = params["betas"]
    vj, jj = j_lbs(jnp.asarray(betas), jnp.asarray(pose), jm.v_template, jm.shapedirs, jm.posedirs,
                   jm.J_regressor, jm.parents, jm.lbs_weights, precision=precision)
    vt, jt = t_lbs(torch.from_numpy(betas), torch.from_numpy(pose), tm.v_template, tm.shapedirs,
                   tm.posedirs, tm.J_regressor, tm.parents, tm.lbs_weights, precision=precision)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=TOL[precision], rtol=0)
    np.testing.assert_allclose(jt.numpy(), np.asarray(jj), atol=TOL[precision], rtol=0)


def test_lbs_fast_is_bf16_tier(models, params):
    """'fast' really rounds: it differs from 'high', by a bf16-sized amount."""
    _, tm, _, _ = models
    pose = torch.from_numpy(np.random.default_rng(2).normal(0, 0.3, (B, J * 3)).astype(np.float32))
    betas = torch.from_numpy(params["betas"])
    args = (betas, pose, tm.v_template, tm.shapedirs, tm.posedirs, tm.J_regressor, tm.parents, tm.lbs_weights)
    d = (t_lbs(*args, precision="fast")[0] - t_lbs(*args, precision="high")[0]).abs().max().item()
    assert 1e-5 < d < TOL["fast"], d


@pytest.mark.parametrize("precision", ["high", "fast"])
def test_smplx_forward_matches_jax(models, params, precision):
    jm, tm, _, _ = models
    vj, jj = j_forward(jm, **{k: jnp.asarray(v) for k, v in params.items()}, precision=precision)
    vt, jt = t_forward(tm, **{k: torch.from_numpy(v) for k, v in params.items()}, precision=precision)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=TOL[precision], rtol=0)
    np.testing.assert_allclose(jt.numpy(), np.asarray(jj), atol=TOL[precision], rtol=0)


def test_vposer_decode_matches_jax(models):
    _, _, jvp, tvp = models
    z = np.random.default_rng(3).normal(0, 1.0, (8, 32)).astype(np.float32)
    aj = np.asarray(j_vposer_decode(jvp, jnp.asarray(z)))
    with torch.no_grad():
        at = t_vposer_decode(tvp, torch.from_numpy(z)).numpy()
    assert at.shape == (8, 63)
    np.testing.assert_allclose(at, aj, atol=1e-4, rtol=0)


@pytest.mark.parametrize("precision", ["high", "fast", "fused"])
def test_body_vec_to_verts_matches_jax(models, precision):
    jm, tm, jvp, tvp = models
    rng = np.random.default_rng(4)
    x72 = rng.normal(0, 0.3, (B, 72)).astype(np.float32)
    cam = _cam(rng, B)
    vj, jj = j_decode(jm, jvp, jnp.asarray(x72), jnp.asarray(cam), precision=precision)
    with torch.no_grad():
        vt, jt = t_decode(tm, tvp, torch.from_numpy(x72), torch.from_numpy(cam), precision=precision)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=TOL[precision], rtol=0)
    # joints never go through the bf16 contractions on the fused tier
    joint_tol = TOL["high"] if precision == "fused" else TOL[precision]
    np.testing.assert_allclose(jt.numpy(), np.asarray(jj), atol=joint_tol, rtol=0)
