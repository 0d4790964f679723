"""Generation entry points: psi_tpu_torch.gen.sample vs psi_tpu.gen.sample
for both model types: generate_bodies (one snapshot), generate_bodies_rows
(a coalesced stack of snapshots) and generate_bodies_line (a latent sweep),
and the generate+fit step with the Stage-2 sampler.

Weights cross with convert_jax; the latents are drawn with jax.random.normal
on the keys psi_tpu uses (S2 splits its key) and injected into the port.
Tolerance: f32 networks summed in another order, then 6D -> axis-angle and
the metric translation (|x| up to ~6 m) -> 1e-4 absolute + 1e-4 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psi_tpu.gen.sample import generate_bodies as j_generate_bodies
from psi_tpu.gen.sample import generate_bodies_line as j_generate_bodies_line
from psi_tpu.gen.sample import generate_bodies_rows as j_generate_bodies_rows
from psi_tpu_torch.data.synthetic import make_synthetic_assets
from psi_tpu_torch.fit.fitting import make_generate_fit_step
from psi_tpu_torch.gen.sample import generate_bodies, generate_bodies_line, generate_bodies_rows
from psi_tpu_torch.utils.config import FitConfig
from test_torch_train_objective import jax_noise, make_world

torch.set_num_threads(1)
TOL = dict(atol=1e-4, rtol=1e-4)
N = 6


@pytest.fixture(scope="module")
def world():
    return make_world(seed=2)


def _snapshots(world):
    b = world["batch"]
    return b["xs"], b["cam_int"], b["max_d"]


@pytest.mark.parametrize("mt", ["s1", "s2"])
def test_generate_bodies_matches_jax(world, mt):
    jm, v, build = world["models"][mt]
    xs, cam_int, max_d = (a[:1] for a in _snapshots(world))
    key = jax.random.PRNGKey(41)
    xj = np.asarray(j_generate_bodies(jm, v, jnp.asarray(xs), jnp.asarray(cam_int), jnp.asarray(max_d), N, key))
    xt = generate_bodies(build(), torch.from_numpy(xs), torch.from_numpy(cam_int), torch.from_numpy(max_d), N,
                         eps=jax_noise(mt, key, n=N))
    assert xt.shape == (N, 72) and not xt.requires_grad
    np.testing.assert_allclose(xt.numpy(), xj, **TOL)


@pytest.mark.parametrize("mt", ["s1", "s2"])
def test_generate_bodies_rows_matches_jax(world, mt):
    """Three snapshots, seven population rows: features gathered per row."""
    jm, v, build = world["models"][mt]
    xs, cam_int, max_d = (a[:3] for a in _snapshots(world))
    req = np.array([0, 2, 1, 1, 0, 2, 2], np.int32)
    key = jax.random.PRNGKey(42)
    xj = np.asarray(j_generate_bodies_rows(jm, v, jnp.asarray(xs), jnp.asarray(cam_int), jnp.asarray(max_d),
                                           jnp.asarray(req), key))
    xt = generate_bodies_rows(build(), torch.from_numpy(xs), torch.from_numpy(cam_int), torch.from_numpy(max_d),
                              torch.from_numpy(req), eps=jax_noise(mt, key, n=len(req)))
    assert xt.shape == (len(req), 72)
    np.testing.assert_allclose(xt.numpy(), xj, **TOL)


def test_generate_bodies_line_matches_jax(world):
    jm, v, build = world["models"]["s1"]
    xs, cam_int, max_d = (a[:1] for a in _snapshots(world))
    xj, ej = j_generate_bodies_line(jm, v, jnp.asarray(xs), jnp.asarray(cam_int), jnp.asarray(max_d), N, z_range=2.0)
    xt, et = generate_bodies_line(build(), torch.from_numpy(xs), torch.from_numpy(cam_int), torch.from_numpy(max_d),
                                  N, z_range=2.0)
    assert et.shape == (N, 32)
    np.testing.assert_allclose(et.numpy(), np.asarray(ej), atol=1e-6)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), **TOL)


@pytest.mark.parametrize("mt", ["s1", "s2"])
def test_generator_noise_is_reproducible_and_model_mode_is_restored(world, mt):
    tm = world["models"][mt][2](train=True)
    xs, cam_int, max_d = (torch.from_numpy(a[:1]) for a in _snapshots(world))
    a = generate_bodies(tm, xs, cam_int, max_d, N, generator=torch.Generator().manual_seed(1))
    b = generate_bodies(tm, xs, cam_int, max_d, N, generator=torch.Generator().manual_seed(1))
    c = generate_bodies(tm, xs, cam_int, max_d, N, generator=torch.Generator().manual_seed(2))
    assert tm.training and torch.equal(a, b) and not torch.equal(a, c)


def test_generate_fit_step_takes_the_stage_two_sampler(world):
    """The production tier's fit on bodies sampled by HumanCVAES2: finite,
    and equal to fitting the bodies generate_bodies returns."""
    from psi_tpu_torch.fit.fitting import make_fit_step

    assets, _ = make_synthetic_assets(num_verts=128, num_joints=12, num_scenes=3, sdf_dim=16, scene_points=300,
                                      n_contact=32)
    tm = world["models"]["s2"][2]()
    xs, cam_int, max_d = (torch.from_numpy(a[:1]) for a in _snapshots(world))
    eps = jax_noise("s2", jax.random.PRNGKey(43), n=N)
    cam_ext = torch.eye(4).repeat(N, 1, 1)
    sidx = torch.zeros(N, dtype=torch.int64)
    cfg = FitConfig.production(num_iter=3, refresh_every=2, refresh_warmup=1, prune_scene_points=128)
    x72, metrics, hist = make_generate_fit_step(tm, assets, cfg, N)(xs, cam_int, max_d, cam_ext, sidx, eps=eps)
    assert x72.shape == (N, 72) and hist.shape == (3, N) and torch.isfinite(x72).all()
    want, _, _ = make_fit_step(assets, cfg)(generate_bodies(tm, xs, cam_int, max_d, N, eps=eps), cam_ext, sidx)
    assert torch.equal(x72, want)
