"""psi_tpu_torch's BodyModel wrappers against psi_tpu's on the same model
and weights, and the untangler's objective and gradient.

SMPL-X cut to V=80, 55 joints (the hands' PCA and pose mean are real
fields), batch 2; VPoser at full width from psi_tpu's seeded init, carried
across with ``vposer_from_jax``. The comparisons run both packages'
SMPL-X forward at ``lbs(exact=True)`` (plain f32; the ``exact_lbs``
fixture), and the ``_high_lbs`` ones at 'high', whose two large
contractions are split-bf16 products on both sides. Vertices and joints
agree to 1e-5 either way, the untangle objective and its gradient to 1e-5
relative at exact=True. At 'high' the gradient carries bf16-rounded
cotangents: the vposer decode's f32 differences (~3e-6 rad) move a few
roundings, so the latent's gradient agrees to one bf16 rounding (2^-8) of
its largest entry (measured 6.3e-4; psi_tpu's own moves 1.7e-4 for a 1e-6
change of z). The untangler runs psi_tpu's L-BFGS on both sides from the
same start.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psi_tpu.body import smplx_model as j_smplx_model
from psi_tpu.body.body_model import BodyModel as JBodyModel
from psi_tpu.body.body_model import BodyModelWithPoser as JBodyModelWithPoser
from psi_tpu.body.lbs import lbs as j_lbs
from psi_tpu.body.smplx_model import smplx_forward as j_forward
from psi_tpu.body.smplx_model import synthetic_smplx as j_synthetic_smplx
from psi_tpu.body.vposer import synthetic_vposer_params, vposer_decode as j_vposer_decode
from psi_tpu_torch.body import smplx_model as t_smplx_model
from psi_tpu_torch.body.body_model import BodyModel, BodyModelWithPoser, BodyResult
from psi_tpu_torch.body.lbs import lbs as t_lbs
from psi_tpu_torch.utils.convert_jax import SMPLX_FIELDS, smplx_from_numpy, vposer_from_jax

torch.set_num_threads(1)
B, V, J = 2, 80, 55
TOL = 1e-5
HIGH_GRAD_TOL = 2.0**-8  # of max |gradient| at 'high': one bf16 rounding of a cotangent block
# The untangler on both sides, 6 L-BFGS iterations at exact=True: z within
# UNTANGLE_Z_TOL of max |z| and the penalty within UNTANGLE_F_TOL relative
# (measured 4.9e-6 and 2.8e-6). In f32 the line searches part later, where
# a bracket compares penalties that differ in their sixth digit (iteration
# 8 of this start). At 'high' the gradient's bf16 noise parts them sooner:
# 2 iterations, within UNTANGLE_HIGH_TOL (measured 1.9e-4 and 8.1e-4).
UNTANGLE_ITERS, UNTANGLE_HIGH_ITERS = 6, 2
UNTANGLE_Z_TOL = UNTANGLE_F_TOL = 5e-5
UNTANGLE_HIGH_TOL = 2e-3


@pytest.fixture
def exact_lbs(monkeypatch):
    """Both packages' SMPL-X forward at lbs(exact=True): plain f32."""
    monkeypatch.setattr(j_smplx_model, "lbs", functools.partial(j_lbs, exact=True))
    monkeypatch.setattr(t_smplx_model, "lbs", functools.partial(t_lbs, exact=True))


@pytest.fixture(scope="module")
def models():
    jm = j_synthetic_smplx(num_verts=V, num_joints=J, seed=1)
    host = jax.device_get(jm)
    tm = smplx_from_numpy(host.parents, **{f: getattr(host, f) for f in SMPLX_FIELDS})
    jvp = synthetic_vposer_params(seed=1)
    return jm, tm, jvp, vposer_from_jax(jax.device_get(jvp))


@pytest.fixture(scope="module")
def params():
    rng = np.random.default_rng(2)
    return dict(
        transl=rng.normal(0, 0.5, (B, 3)).astype(np.float32),
        root_orient=rng.normal(0, 0.3, (B, 3)).astype(np.float32),
        betas=rng.normal(0, 1.0, (B, 10)).astype(np.float32),
        pose_body=rng.normal(0, 0.3, (B, 63)).astype(np.float32),
        pose_hand=rng.normal(0, 0.5, (B, 24)).astype(np.float32),
    )


def _close(got: BodyResult, want) -> None:
    np.testing.assert_allclose(got.v.numpy(), np.asarray(want.v), atol=TOL, rtol=0)
    np.testing.assert_allclose(got.Jtr.numpy(), np.asarray(want.Jtr), atol=TOL, rtol=0)
    np.testing.assert_array_equal(got.f.numpy(), np.asarray(want.f))


@pytest.mark.parametrize("keys", [(), ("transl",), ("transl", "root_orient", "betas", "pose_body"),
                                  ("transl", "root_orient", "betas", "pose_body", "pose_hand")])
def test_body_model_matches_psi_tpu(models, params, keys, exact_lbs):
    _body_model_matches(models, params, keys)


@pytest.mark.parametrize("keys", [(), ("transl", "root_orient", "betas", "pose_body", "pose_hand")])
def test_body_model_matches_psi_tpu_high_lbs(models, params, keys):
    _body_model_matches(models, params, keys)


def _body_model_matches(models, params, keys):
    jm, tm, _, _ = models
    kw = {k: params[k] for k in keys}
    _close(BodyModel(tm, batch_size=B, device="cpu")(**kw), JBodyModel(jm, batch_size=B)(**kw))


def test_separate_hand_poses_equal_the_split_pose_hand(models, params):
    _, tm, _, _ = models
    bm = BodyModel(tm, batch_size=B, device="cpu")
    lh, rh = np.split(params["pose_hand"], 2, axis=-1)
    a = bm(pose_hand=params["pose_hand"])
    b = bm(left_hand_pose=lh, right_hand_pose=torch.from_numpy(rh))
    assert torch.equal(a.v, b.v) and torch.equal(a.Jtr, b.Jtr)


def test_body_model_with_poser_matches_psi_tpu(models, params, exact_lbs):
    _with_poser_matches(models, params)


def test_body_model_with_poser_matches_psi_tpu_high_lbs(models, params):
    _with_poser_matches(models, params)


def _with_poser_matches(models, params):
    jm, tm, jvp, tvp = models
    z = np.random.default_rng(3).normal(0, 1, (B, 32)).astype(np.float32)
    jb, tb = JBodyModelWithPoser(jm, jvp, batch_size=B), BodyModelWithPoser(tm, tvp, batch_size=B, device="cpu")
    with torch.no_grad():
        _close(tb(), jb())
        _close(tb(poZ_body=z, transl=params["transl"]), jb(poZ_body=jnp.asarray(z), transl=params["transl"]))
        tb.poZ_body = torch.from_numpy(z)
        jb.poZ_body = jnp.asarray(z)
        _close(tb(betas=params["betas"]), jb(betas=params["betas"]))


def test_synthetic_and_randomize_pose_draw_from_their_seeds():
    bm = BodyModel.synthetic(batch_size=1, device="cpu", num_verts=V, num_joints=J, seed=1)
    assert bm().v.shape == (1, V, 3) and bm.device == torch.device("cpu")
    vp = vposer_from_jax(jax.device_get(synthetic_vposer_params(seed=1)))
    a = BodyModelWithPoser(bm.model, vp, batch_size=1, device="cpu")
    a.randomize_pose(torch.Generator().manual_seed(3))
    first = a.poZ_body.clone()
    torch.manual_seed(0)  # torch's global state plays no part
    a.randomize_pose(torch.Generator().manual_seed(3))
    assert torch.equal(a.poZ_body, first) and float(first.abs().max()) > 0
    a.randomize_pose()  # default: a generator seeded 0
    assert torch.equal(a.poZ_body, torch.randn((1, 32), generator=torch.Generator().manual_seed(0)))


def _jax_objective(jm, jvp, n_samples, radius, prior_weight, seed):
    """psi_tpu's untangle objective (psi_tpu/body/body_model.py:120-141),
    written out: psi_tpu builds it inside ``untangle_interpenetrations``."""
    rng = np.random.default_rng(seed)
    sel = jnp.asarray(np.sort(rng.choice(jm.num_verts, size=min(n_samples, jm.num_verts), replace=False)))
    rest = jm.v_template[sel]
    mask = jnp.sum((rest[:, None, :] - rest[None, :, :]) ** 2, axis=-1) > (4.0 * radius) ** 2

    def objective(z):
        b = z.shape[0]
        verts, _ = j_forward(jm, transl=jnp.zeros((b, 3)), global_orient=jnp.zeros((b, 3)),
                             betas=jnp.zeros((b, jm.shapedirs.shape[-1])), body_pose=j_vposer_decode(jvp, z))
        p = verts[:, sel, :]
        d2 = jnp.sum((p[:, :, None, :] - p[:, None, :, :]) ** 2, axis=-1)
        return jnp.sum(jnp.maximum(radius**2 - d2, 0.0) * mask[None]) + prior_weight * jnp.mean(z**2)

    return objective


def test_untangle_objective_and_gradient_match_psi_tpu(models, exact_lbs):
    _untangle_objective_matches(models, TOL)


def test_untangle_objective_and_gradient_match_psi_tpu_high_lbs(models):
    _untangle_objective_matches(models, HIGH_GRAD_TOL)


def _untangle_objective_matches(models, grad_tol):
    jm, tm, jvp, tvp = models
    kw = dict(n_samples=64, radius=0.3, prior_weight=0.1, seed=0)  # radius wide enough that pairs overlap
    z = np.random.default_rng(5).normal(0, 1.5, (1, 32)).astype(np.float32)
    jf = _jax_objective(jm, jvp, **kw)
    jval, jgrad = jax.jit(jax.value_and_grad(jf))(jnp.asarray(z))
    tb = BodyModelWithPoser(tm, tvp, batch_size=1, device="cpu")
    zt = torch.from_numpy(z).requires_grad_(True)
    val = tb._untangle_objective(**kw)(zt)
    val.backward()
    val = val.detach()
    assert float(jval) > 0.1 * kw["prior_weight"] * float(np.mean(z**2)) + 1e-3  # the penalty is live
    assert abs(float(val) - float(jval)) <= TOL * abs(float(jval))
    np.testing.assert_allclose(zt.grad.numpy(), np.asarray(jgrad), rtol=0,
                               atol=grad_tol * float(np.abs(np.asarray(jgrad)).max()))


def test_untangle_matches_psi_tpus_untangler(models, exact_lbs):
    """The same start, objective and L-BFGS: psi_tpu's latent and penalty."""
    _untangler_matches(models, UNTANGLE_ITERS, UNTANGLE_Z_TOL, UNTANGLE_F_TOL)


def test_untangle_matches_psi_tpus_untangler_high_lbs(models):
    _untangler_matches(models, UNTANGLE_HIGH_ITERS, UNTANGLE_HIGH_TOL, UNTANGLE_HIGH_TOL)


def _untangler_matches(models, iters, z_tol, f_tol):
    jm, tm, jvp, tvp = models
    kw = dict(n_samples=64, radius=0.3, prior_weight=0.1, seed=0)
    tb = BodyModelWithPoser(tm, tvp, batch_size=1, device="cpu")
    tb.randomize_pose(torch.Generator().manual_seed(1))
    jb = JBodyModelWithPoser(jm, jvp, batch_size=1)
    jb.poZ_body = jnp.asarray(tb.poZ_body.numpy())
    before = float(_jax_objective(jm, jvp, **kw)(jb.poZ_body))
    jb.untangle_interpenetrations(max_iter=iters, **kw)
    tb.untangle_interpenetrations(max_iter=iters, **kw)
    z_j, z_t = np.asarray(jb.poZ_body), tb.poZ_body.numpy()
    f_j = float(_jax_objective(jm, jvp, **kw)(jb.poZ_body))
    with torch.no_grad():
        f_t = float(tb._untangle_objective(**kw)(tb.poZ_body))
    assert f_j < 0.5 * before, (before, f_j)
    np.testing.assert_allclose(z_t, z_j, rtol=0, atol=z_tol * np.abs(z_j).max())
    assert abs(f_t - f_j) <= f_tol * abs(f_j), (f_t, f_j)


def test_untangle_lowers_the_penalty(models):
    _, tm, _, tvp = models
    tb = BodyModelWithPoser(tm, tvp, batch_size=1, device="cpu")
    tb.randomize_pose(torch.Generator().manual_seed(1))
    kw = dict(n_samples=64, radius=0.3, prior_weight=0.1, seed=0)
    objective = tb._untangle_objective(**kw)
    with torch.no_grad():
        before = float(objective(tb.poZ_body))
    tb.untangle_interpenetrations(max_iter=10, **kw)
    with torch.no_grad():
        after = float(objective(tb.poZ_body))
    assert np.isfinite(after) and after < before, (before, after)
    assert not tb.poZ_body.requires_grad


def test_wrappers_need_a_card_unless_told_otherwise(models, monkeypatch):
    _, tm, _, tvp = models
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="NVIDIA card"):
        BodyModel(tm)
    with pytest.raises(RuntimeError, match="NVIDIA card"):
        BodyModelWithPoser(tm, tvp)
