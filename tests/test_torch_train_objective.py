"""The six-term training objective: psi_tpu_torch.train.objective.cvae_loss
vs psi_tpu's, for 's1' and 's2', on the same weights, assets, batch and
noise.

Sizes (tests/test_train.py's): 128 vertices, 12 joints, 3 scenes, 16^3 SDF,
300 scene points, 32 contact vertices, latentD 32, batch 4, 32 x 32
snapshots. Inputs come from numpy seeds; weights cross with convert_jax; the
noise is drawn once with jax.random.normal on the keys psi_tpu uses (S2
splits its key) and injected into the port. BatchNorm runs in train mode
(batch statistics) on both sides unless a test says otherwise. psi_tpu's
chamfer takes its jnp reference path on the CPU, the port its twin.

Tolerance on each metric: the same f32 math summed in another order through
a ResNet trunk in train mode, an MLP, the LBS and two means -> 2e-5
relative + 1e-7 absolute (found: at most 1.4e-6 relative).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psi_tpu.body.smplx_model import synthetic_smplx
from psi_tpu.body.vposer import VPoser
from psi_tpu.data.scenes import synthetic_scene_registry
from psi_tpu.data.synthetic import SyntheticBatchGenerator, make_assets
from psi_tpu.geometry.contact import synthetic_contact_ids
from psi_tpu.models import HumanCVAES1 as JS1
from psi_tpu.models import HumanCVAES2 as JS2
from psi_tpu.train.objective import cvae_loss as j_cvae_loss
from psi_tpu.utils.config import LossConfig as JLossConfig
from psi_tpu_torch.ops.prune import select_near_tiles
from psi_tpu_torch.train import objective
from psi_tpu_torch.train.objective import cvae_loss
from psi_tpu_torch.utils.config import LossConfig
from psi_tpu_torch.utils.convert_jax import (
    SMPLX_FIELDS,
    cvae_s1_from_jax,
    cvae_s2_from_jax,
    scene_assets_from_numpy,
    smplx_from_numpy,
    vposer_from_jax,
)

torch.set_num_threads(1)
B, IMAGE, LATENT, SCENES = 4, 32, 32, 3
ASSETS = dict(num_verts=128, num_joints=12, sdf_dim=16, scene_points=300, n_contact=32)
TOL = dict(rtol=2e-5, atol=1e-7)
S1_NAMES = {"loss", "rec_t", "rec_p", "vposer", "contact", "collision", "kl"}


def numpy_variables(module, rng, *args):
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


def port_assets(a):
    h = jax.device_get(a)
    smplx = smplx_from_numpy(h.smplx.parents, **{f: getattr(h.smplx, f) for f in SMPLX_FIELDS})
    return scene_assets_from_numpy(smplx, vposer_from_jax(h.vposer_params), h.contact_vids, h.sdf_packed,
                                   h.grid_mins, h.grid_maxs, h.scene_verts)


def jax_noise(model_type, key, n=B, d=32):
    """The normals psi_tpu's model draws from ``key``, as the port's ``eps``."""
    draw = lambda k: torch.from_numpy(np.array(jax.random.normal(k, (n, d))))
    if model_type == "s1":
        return draw(key)
    kg, kl = jax.random.split(key)
    return draw(kg), draw(kl)


def torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def make_world(seed=0):
    """Assets for both packages, one batch placed in its scenes' floors, and
    for 's1' and 's2' the flax model, its random variables and a function building
    the port's model from them."""
    rng = np.random.default_rng(seed)
    smplx = synthetic_smplx(num_verts=ASSETS["num_verts"], num_joints=ASSETS["num_joints"], seed=0)
    vposer = numpy_variables(VPoser(), rng, jnp.zeros((2, 63)))
    contact = synthetic_contact_ids(ASSETS["num_verts"], n_contact=ASSETS["n_contact"], seed=0)
    reg = synthetic_scene_registry(num_scenes=SCENES, dim=ASSETS["sdf_dim"], num_verts=ASSETS["scene_points"], seed=0)
    ja = make_assets(smplx, vposer, contact, reg)
    batch = SyntheticBatchGenerator(num_scenes=SCENES, batches_per_epoch=1, seed=seed, image_size=IMAGE).next_batch(B)
    # identity-rotation extrinsics that drop each body into its scene's floor,
    # so that the collision term is nonzero
    lo, hi = reg.grid_mins[batch["scene_idx"]], reg.grid_maxs[batch["scene_idx"]]
    target = 0.5 * (lo + hi)
    target[:, 1] = 0.8 * lo[:, 1]
    cam = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    cam[:, :3, 3] = target - batch["xh"][:, :3]
    batch["cam_ext"] = cam
    models = {}
    for mt, cls, kw, conv in (("s1", JS1, dict(latentD=LATENT), cvae_s1_from_jax),
                              ("s2", JS2, dict(latentD_g=LATENT, latentD_l=LATENT), cvae_s2_from_jax)):
        m = cls(**kw)
        v = jax.device_get(numpy_variables(m, rng, jnp.zeros((1, 75)), jnp.zeros((1, IMAGE, IMAGE, 2))))
        models[mt] = (m, v, (lambda v=v, conv=conv, **k: conv(v, **k)))
    return dict(jassets=ja, tassets=port_assets(ja), batch=batch, models=models)


@pytest.fixture(scope="module")
def world():
    return make_world()


def _both(world, mt, fca=0.7, f_scene=1.0, train=True, prune=0, xs_dtype=None, key=jax.random.PRNGKey(21)):
    jm, v, build = world["models"][mt]
    jb = {k: jnp.asarray(x) for k, x in world["batch"].items()}
    tb = torch_batch(world["batch"])
    if xs_dtype is not None:
        jb["xs"] = jb["xs"].astype(jnp.bfloat16)
        tb["xs"] = tb["xs"].to(torch.bfloat16)
    _, mj, _ = j_cvae_loss(jm, v, jb, world["jassets"], key, jnp.float32(fca), jnp.float32(f_scene),
                           JLossConfig(prune_scene_points=prune), model_type=mt, train=train)
    tm = build(train=not train)  # cvae_loss must set the mode itself
    with torch.no_grad():
        total, mt_, third = cvae_loss(tm, tb, world["tassets"], fca, f_scene, LossConfig(prune_scene_points=prune),
                                      model_type=mt, train=train, eps=jax_noise(mt, key))
    assert third is None and tm.training == train and total is mt_["loss"]
    return {k: float(x) for k, x in mt_.items()}, {k: float(x) for k, x in mj.items()}


@pytest.mark.parametrize("mt", ["s1", "s2"])
def test_every_metric_matches_jax(world, mt):
    t, j = _both(world, mt)
    assert set(t) == set(j) == (S1_NAMES | ({"kl_g", "kl_l"} if mt == "s2" else set()))
    for k in j:
        assert np.isfinite(j[k]) and j[k] > 0, k  # every term is live, collision included
        np.testing.assert_allclose(t[k], j[k], err_msg=k, **TOL)


@pytest.mark.parametrize("mt", ["s1", "s2"])
def test_scene_gate_zeroes_the_scene_terms(world, mt):
    t, j = _both(world, mt, fca=0.5, f_scene=0.0)
    assert t["contact"] == 0.0 and t["collision"] == 0.0 and j["contact"] == 0.0
    for k in j:
        np.testing.assert_allclose(t[k], j[k], err_msg=k, **TOL)


@pytest.mark.parametrize("prune", [0, 128])
def test_prune_scene_points_on_and_off(world, prune, monkeypatch):
    """prune_scene_points=128 of 300 searches one 128-point tile of the
    three: the objective calls the selection, and both packages agree."""
    calls = []
    monkeypatch.setattr(objective, "select_near_tiles",
                        lambda pts, c, k: calls.append(k) or select_near_tiles(pts, c, k))
    t, j = _both(world, "s1", prune=prune)
    assert calls == ([prune] if prune else [])
    np.testing.assert_allclose(t["contact"], j["contact"], **TOL)
    np.testing.assert_allclose(t["loss"], j["loss"], **TOL)
    pts = world["tassets"].scene_verts[:1]
    assert select_near_tiles(pts, pts[:, 0], 128).shape[1] == 128 < pts.shape[1]


@pytest.mark.parametrize("mt", ["s1", "s2"])
def test_bf16_staged_snapshots_are_upcast_on_entry(world, mt):
    t, j = _both(world, mt, xs_dtype="bfloat16")
    f32, _ = _both(world, mt)
    assert t["loss"] != f32["loss"]  # the rounding of xs reaches the loss
    for k in j:
        np.testing.assert_allclose(t[k], j[k], err_msg=k, **TOL)


@pytest.mark.parametrize("mt", ["s1", "s2"])
def test_eval_mode_objective_matches_jax(world, mt):
    """train=False: running statistics, and the module is left in eval mode."""
    t, j = _both(world, mt, train=False)
    for k in j:
        np.testing.assert_allclose(t[k], j[k], err_msg=k, **TOL)


def test_noise_from_a_generator_equals_the_same_draws_injected(world):
    tb = torch_batch(world["batch"])
    for mt in ("s1", "s2"):
        tm = world["models"][mt][2]()
        g = torch.Generator().manual_seed(5)
        draws = [torch.randn((B, 32), generator=g) for _ in range(2)]
        eps = draws[0] if mt == "s1" else tuple(draws)
        with torch.no_grad():
            a = cvae_loss(tm, tb, world["tassets"], 1.0, 1.0, LossConfig(), mt,
                          generator=torch.Generator().manual_seed(5))[0]
            b = cvae_loss(tm, tb, world["tassets"], 1.0, 1.0, LossConfig(), mt, eps=eps)[0]
            mean = cvae_loss(tm, tb, world["tassets"], 1.0, 1.0, LossConfig(), mt)[0]
        assert torch.equal(a, b) and not torch.equal(a, mean)


def test_gates_may_be_tensors(world):
    tb = torch_batch(world["batch"])
    tm = world["models"]["s1"][2]()
    eps = jax_noise("s1", jax.random.PRNGKey(3))
    with torch.no_grad():
        a = cvae_loss(tm, tb, world["tassets"], 0.5, 1.0, LossConfig(), eps=eps)[1]
        b = cvae_loss(tm, tb, world["tassets"], torch.tensor(0.5), torch.tensor(1.0), LossConfig(), eps=eps)[1]
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_unknown_model_type_raises(world):
    with pytest.raises(ValueError):
        cvae_loss(world["models"]["s1"][2](), torch_batch(world["batch"]), world["tassets"], 1.0, 1.0, LossConfig(),
                  model_type="s3")
