"""The slice: psi_tpu_torch's generate+fit vs psi_tpu's, on the same model,
weights, assets and latents (injected through sample_with_eps).

Shapes: N=4 bodies, V=300 verts, J=12 joints, 2 scenes, sdf_dim=16, 512
scene points, 32 contact verts. The production tier runs with bf16 packed
grids and psi_tpu's fused Pallas kernels in interpret mode; the exact
tier with f32 grids. The population is placed in scene floor through the
camera extrinsics so the collision and contact terms both act.

Tolerances:
* generated bodies: f32 networks summed in another order -> 1e-4;
* iteration-0 per-body loss: the same bodies through the same math ->
  1e-4 relative;
* fitted x72 after Adam: bounded drift. tests/test_fused_skinning.py:
  200-201 allows max 0.25, mean 0.02 (Adam amplifies rounding-level
  differences near zero gradients); found here max 1.8e-5 / mean 1.2e-6
  (production) and max 3.1e-4 / mean 1.5e-5 (exact, where psi_tpu's
  split-bf16 'high' LBS meets the port's f32), so the bounds are
  max 5e-3, mean 5e-4;
* per-iteration mean loss and final metrics: found within 3e-5 relative,
  held to 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from psi_tpu.body.smplx_model import synthetic_smplx
from psi_tpu.body.vposer import VPoser
from psi_tpu.data.scenes import synthetic_scene_registry
from psi_tpu.data.synthetic import SyntheticBatchGenerator, make_assets
from psi_tpu.geometry.contact import synthetic_contact_ids
from psi_tpu.fit.fitting import make_fit_step as j_make_fit_step
from psi_tpu.geometry.bodyvec import convert_to_3D_rot as j_to_3d
from psi_tpu.geometry.camera import recover_global_T as j_recover
from psi_tpu.models import HumanCVAES1 as JCVAE
from psi_tpu.utils.config import FitConfig as JFitConfig
from psi_tpu_torch.fit.fitting import Adam, fit_schedule, make_fit_step, make_generate_fit_step
from psi_tpu_torch.utils.config import FitConfig
from psi_tpu_torch.utils.convert_jax import (
    SMPLX_FIELDS,
    cvae_s1_from_jax,
    scene_assets_from_numpy,
    smplx_from_numpy,
    vposer_from_jax,
)

torch.set_num_threads(1)
N, V, J, IMAGE = 4, 300, 12, 32
ASSETS = dict(sdf_dim=16, scene_points=512, n_contact=32)
PRODUCTION = dict(num_iter=6, refresh_every=3, refresh_warmup=2, prune_scene_points=256)
EXACT = dict(num_iter=6)
DRIFT_MAX, DRIFT_MEAN = 5e-3, 5e-4


def _numpy_variables(module, rng, *args):
    """Random variables of a flax module, drawn with numpy from its shapes
    (jax.eval_shape traces without compiling, unlike module.init)."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)

    def fill(path, leaf):
        name = path[-1].key
        if name == "kernel":
            return rng.normal(0, 1 / np.sqrt(np.prod(leaf.shape[:-1])), leaf.shape).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        return rng.normal(0, 0.1, leaf.shape).astype(np.float32)  # bias, mean

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _port_assets(a):
    h = jax.device_get(a)
    smplx = smplx_from_numpy(h.smplx.parents, **{f: getattr(h.smplx, f) for f in SMPLX_FIELDS})
    return scene_assets_from_numpy(
        smplx, vposer_from_jax(h.vposer_params), h.contact_vids, h.sdf_packed,
        h.grid_mins, h.grid_maxs, h.scene_verts,
    )


@pytest.fixture(scope="module")
def world():
    """Model, assets for both packages, one snapshot, latents, placement."""
    rng = np.random.default_rng(0)
    model = JCVAE(latentD=64)
    v = _numpy_variables(model, rng, jnp.zeros((1, 75)), jnp.zeros((1, IMAGE, IMAGE, 2)))
    b = SyntheticBatchGenerator(num_scenes=2, batches_per_epoch=1, seed=0, image_size=IMAGE).next_batch(1)
    eps = np.random.default_rng(7).normal(0, 1, (N, 32)).astype(np.float32)
    xhr = model.apply(v, jnp.asarray(np.repeat(b["xs"], N, 0)), jnp.asarray(eps), method=JCVAE.sample_with_eps)
    x72 = j_recover(j_to_3d(xhr), jnp.asarray(np.repeat(b["cam_int"], N, 0)),
                    jnp.asarray(np.repeat(b["max_d"], N, 0)))
    smplx = synthetic_smplx(num_verts=V, num_joints=J, seed=0)
    vposer = _numpy_variables(VPoser(), rng, jnp.zeros((2, 63)))
    contact = synthetic_contact_ids(V, n_contact=ASSETS["n_contact"], seed=0)
    reg = synthetic_scene_registry(num_scenes=2, dim=ASSETS["sdf_dim"], num_verts=ASSETS["scene_points"], seed=0)
    assets_bf16 = make_assets(smplx, vposer, contact, reg, sdf_dtype=jnp.bfloat16)
    assets_f32 = make_assets(smplx, vposer, contact, reg)
    sidx = (np.arange(N) % 2).astype(np.int32)
    # identity-rotation extrinsics that put each body in its scene's floor
    lo, hi = reg.grid_mins[sidx], reg.grid_maxs[sidx]
    target = 0.5 * (lo + hi)
    target[:, 1] = 0.8 * lo[:, 1]
    cam = np.tile(np.eye(4, dtype=np.float32), (N, 1, 1))
    cam[:, :3, 3] = target - np.asarray(x72)[:, :3].mean(0)
    return dict(
        model=model, variables=v, tmodel=cvae_s1_from_jax(jax.device_get(v)), batch=b, eps=eps,
        x72=np.array(x72), cam=cam, sidx=sidx,
        assets={"bf16": (assets_bf16, _port_assets(assets_bf16)), "f32": (assets_f32, _port_assets(assets_f32))},
    )


def _run_both(world, cfg_kw, production, grid):
    ja, ta = world["assets"][grid]
    jcfg = JFitConfig.production(**cfg_kw) if production else JFitConfig.exact(**cfg_kw)
    tcfg = FitConfig.production(**cfg_kw) if production else FitConfig.exact(**cfg_kw)
    xj, mj, hj = j_make_fit_step(ja, jcfg)(jnp.asarray(world["x72"]), jnp.asarray(world["cam"]),
                                           jnp.asarray(world["sidx"]))
    b = world["batch"]
    run = make_generate_fit_step(world["tmodel"], ta, tcfg, N)
    xt, mt, ht = run(torch.from_numpy(b["xs"]), torch.from_numpy(b["cam_int"]), torch.from_numpy(b["max_d"]),
                     torch.from_numpy(world["cam"]), torch.from_numpy(world["sidx"]),
                     eps=torch.from_numpy(world["eps"]))
    return dict(xj=np.asarray(xj), hj=np.asarray(hj), mj={k: np.asarray(x) for k, x in mj.items()},
                xt=xt.numpy(), ht=ht.numpy(), mt={k: x.numpy() for k, x in mt.items()})


@pytest.fixture(scope="module")
def production(world):
    return _run_both(world, PRODUCTION, True, "bf16")


@pytest.fixture(scope="module")
def exact(world):
    return _run_both(world, EXACT, False, "f32")


def test_generated_bodies_match_jax(world):
    from psi_tpu_torch.gen.sample import generate_bodies

    b = world["batch"]
    x72 = generate_bodies(world["tmodel"], torch.from_numpy(b["xs"]), torch.from_numpy(b["cam_int"]),
                          torch.from_numpy(b["max_d"]), N, eps=torch.from_numpy(world["eps"]))
    np.testing.assert_allclose(x72.numpy(), world["x72"], atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("tier", ["production", "exact"])
def test_iteration0_loss_matches_jax(request, tier):
    r = request.getfixturevalue(tier)
    assert r["ht"].shape == r["hj"].shape == (6, N)
    np.testing.assert_allclose(r["ht"][0], r["hj"][0], rtol=1e-4, atol=0)


def test_setup_penetrates_the_floor(world):
    """The placement makes the collision term act from iteration 0."""
    from psi_tpu_torch.fit.fitting import _per_body_losses
    from psi_tpu_torch.geometry.bodyvec import convert_to_6D_rot

    _, ta = world["assets"]["f32"]
    xhr = convert_to_6D_rot(torch.from_numpy(world["x72"]))
    _, (m, _) = _per_body_losses(ta, xhr, xhr, torch.from_numpy(world["cam"]),
                                 torch.from_numpy(world["sidx"]).long(), FitConfig.exact())
    assert float(m["collision"].detach().sum()) > 0


@pytest.mark.parametrize("tier", ["production", "exact"])
def test_fitted_bodies_bounded_drift_from_jax(request, tier):
    r = request.getfixturevalue(tier)
    assert np.all(np.isfinite(r["xt"]))
    d = np.abs(r["xt"] - r["xj"])
    assert d.max() < DRIFT_MAX, f"max fitted-param drift {d.max()}"
    assert d.mean() < DRIFT_MEAN, f"mean fitted-param drift {d.mean()}"


@pytest.mark.parametrize("tier", ["production", "exact"])
def test_loss_history_and_final_metrics_track_jax(request, tier):
    r = request.getfixturevalue(tier)
    np.testing.assert_allclose(r["ht"].mean(1), r["hj"].mean(1), rtol=1e-3)
    for k in ("rec", "vposer", "contact", "collision", "total"):
        # atol: a body grazing the floor (1 mm) carries ~1e-5 absolute collision error
        np.testing.assert_allclose(r["mt"][k], r["mj"][k], rtol=1e-3, atol=2e-5, err_msg=k)


def test_production_schedule_at_20_iterations():
    kinds = fit_schedule(FitConfig.production(num_iter=20))
    assert [i for i, k in enumerate(kinds) if k == "full"] == [0, 4, 14]
    assert [i for i, k in enumerate(kinds) if k == "nn_only"] == [1, 2, 3]
    assert kinds.count("cheap") == 14
    assert fit_schedule(FitConfig.exact(num_iter=5)) == ["full"] * 5
    assert fit_schedule(FitConfig.production(num_iter=6, sdf_warmup_gathers=True, refresh_every=3,
                                             refresh_warmup=2)) == ["full", "full", "full", "cheap", "cheap", "full"]


@pytest.mark.parametrize("knob", [dict(cheap_collision_verts=64), dict(overlap_chunks=2), dict(remat_decode=True)])
def test_unported_fit_knobs_raise(world, knob):
    _, ta = world["assets"]["bf16"]
    with pytest.raises(NotImplementedError):
        make_fit_step(ta, FitConfig.production(**knob))


def test_adam_matches_optax():
    rng = np.random.default_rng(0)
    x0 = rng.normal(size=(3, 5)).astype(np.float32)
    grads = rng.normal(size=(8, 3, 5)).astype(np.float32) * np.logspace(-6, 1, 8, dtype=np.float32)[:, None, None]
    opt = optax.adam(0.1)
    xj, state = jnp.asarray(x0), opt.init(jnp.asarray(x0))
    xt = torch.from_numpy(x0)
    adam = Adam(xt, 0.1)
    for g in grads:
        u, state = opt.update(jnp.asarray(g), state, xj)
        xj = optax.apply_updates(xj, u)
        xt = adam.step(xt, torch.from_numpy(g))
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", ["LossConfig", "TrainConfig", "FitConfig"])
def test_config_fields_are_psi_tpus(name):
    """One config drives both packages: the same fields and defaults, and
    the same production() / exact() presets."""
    import dataclasses

    import psi_tpu.utils.config as jc
    import psi_tpu_torch.utils.config as tc

    def fields(mod):
        return [(f.name, f.default) for f in dataclasses.fields(getattr(mod, name))]

    assert fields(tc) == fields(jc)
    assert dataclasses.asdict(FitConfig.production(num_iter=7)) == dataclasses.asdict(JFitConfig.production(num_iter=7))
    assert dataclasses.asdict(FitConfig.exact()) == dataclasses.asdict(JFitConfig.exact())
