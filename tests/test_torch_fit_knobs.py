"""The fit modes the port refuses, a body's fit as its own, and the
carried-Adam mode: psi_tpu_torch.fit.fitting vs psi_tpu.fit.fitting on
tests/test_torch_fit.py's world (N=4 bodies, V=300, J=12, 2 scenes,
sdf_dim=16, 512 scene points, 32 contact vertices; the same model-sampled
bodies placed in the scenes' floors), plus the two parity cases that file
left out (the exact tier with prune_scene_points=0,
production(refresh_every=20)).

psi_tpu's FitConfig has three fit modes that the port refuses when a fit is
built with one switched on (``remat_decode``, ``overlap_chunks > 1``,
``cheap_collision_verts > 0``); their "off" values are accepted.

What psi_tpu computes on the CPU, and so what each comparison can hold:
* 'fused' runs psi_tpu's Pallas kernels in interpret mode: both sides round
  the same operands to bf16, and fits agree to ~1e-5 (tests/test_torch_fit.py).
* 'fast' is plain f32 in psi_tpu on the CPU (its bf16 rounding happens inside
  the TPU's matrix unit) while the port rounds the operands itself, so the
  fixture ``f32_fast`` switches the port's rounding off where a 'fast' fit is
  held to psi_tpu's at rounding level.
* 'high' is a split-bf16 emulation of f32 in psi_tpu (~2^-16): fine for one
  forward, amplified by Adam, so 'high' fits are compared only on this
  world's exact tier, where tests/test_torch_fit.py found 3.1e-4.

Tolerances (tests/test_torch_fit.py's, with its reasons): iteration-0 loss
1e-4 relative; fitted x72 drift max 5e-3, mean 5e-4; mean loss per iteration
and final metrics 1e-3 relative (+2e-5 absolute on a metric). Found here: the
unpruned exact tier 3.1e-4, 2.4e-5. Comparisons of the port with itself say
their own bound.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psi_tpu.fit.fitting import make_fit_step as j_make_fit_step
from psi_tpu.fit.fitting import make_fit_step_carry_opt_state as j_make_carry
from psi_tpu.utils.config import FitConfig as JFitConfig
from psi_tpu_torch.body import lbs as t_lbs_module
from psi_tpu_torch.fit import fitting
from psi_tpu_torch.fit.fitting import (make_fit_step, make_fit_step_carry_opt_state, make_generate_fit_rows,
                                       make_generate_fit_step)
from psi_tpu_torch.utils.config import FitConfig
from test_torch_fit import DRIFT_MAX, DRIFT_MEAN, EXACT, N, world  # noqa: F401  (world: the module-scoped fixture)

torch.set_num_threads(1)
PRODUCTION = dict(num_iter=6, refresh_every=3, refresh_warmup=2, prune_scene_points=256)
METRICS = ("rec", "vposer", "contact", "collision", "total")


@pytest.fixture
def f32_fast(monkeypatch):
    """The port's 'fast' tier without its bf16 operand rounding: what
    psi_tpu's 'fast' computes on the CPU."""
    monkeypatch.setattr(t_lbs_module, "_bf16", lambda t: t)


def _inputs(world, lib):
    arrs = world["x72"], world["cam"], world["sidx"]
    return tuple(jnp.asarray(a) for a in arrs) if lib == "jax" else tuple(torch.from_numpy(a) for a in arrs)


def _cfgs(kw, production=True):
    if production:
        return JFitConfig.production(**kw), FitConfig.production(**kw)
    return JFitConfig.exact(**kw), FitConfig.exact(**kw)


def _jax_fit(world, kw, production=True, grid="bf16"):
    x, m, h = j_make_fit_step(world["assets"][grid][0], _cfgs(kw, production)[0])(*_inputs(world, "jax"))
    return np.array(x), {k: np.array(v) for k, v in m.items()}, np.array(h)  # copies: jax's views are read-only


def _port_fit(world, kw, production=True, grid="bf16"):
    x, m, h = make_fit_step(world["assets"][grid][1], _cfgs(kw, production)[1])(*_inputs(world, "torch"))
    return x.numpy(), {k: v.numpy() for k, v in m.items()}, h.numpy()


def _assert_tracks(port, ref):
    (xt, mt, ht), (xj, mj, hj) = port, ref
    assert ht.shape == hj.shape and np.all(np.isfinite(xt))
    np.testing.assert_allclose(ht[0], hj[0], rtol=1e-4, atol=0)
    np.testing.assert_allclose(ht.mean(1), hj.mean(1), rtol=1e-3)
    d = np.abs(xt - xj)
    assert d.max() < DRIFT_MAX and d.mean() < DRIFT_MEAN, (d.max(), d.mean())
    for k in METRICS:
        np.testing.assert_allclose(mt[k], mj[k], rtol=1e-3, atol=2e-5, err_msg=k)


# ---- the modes the port refuses

# each mode: the value that switches it on, and the values that meant "off" in psi_tpu and still do
MODES = {
    "remat_decode": (True, (False, 0)),
    "overlap_chunks": (2, (1, 0, -1, None)),
    "cheap_collision_verts": (64, (0, -1)),
}
CONSTRUCTORS = {
    "make_fit_step": lambda cfg: make_fit_step(None, cfg),
    "make_generate_fit_step": lambda cfg: make_generate_fit_step(None, None, cfg, N),
    "make_generate_fit_rows": lambda cfg: make_generate_fit_rows(None, None, cfg),
    "make_fit_step_carry_opt_state": lambda cfg: make_fit_step_carry_opt_state(None, cfg),
}


@pytest.mark.parametrize("constructor", list(CONSTRUCTORS))
@pytest.mark.parametrize("mode", list(MODES))
def test_a_dropped_mode_is_refused_when_the_fit_is_built(mode, constructor):
    """A config that switches a dropped mode on is refused by name when the
    fit is built, with no model, assets or input in hand, as an unknown
    lbs_precision is; its "off" values build a fit."""
    on, offs = MODES[mode]
    build = CONSTRUCTORS[constructor]
    with pytest.raises(ValueError, match=mode):
        build(FitConfig.production(**{mode: on}))
    with pytest.raises(ValueError, match="lbs_precision"):
        build(FitConfig.production(lbs_precision="exactish"))
    for off in offs:
        assert callable(build(FitConfig.production(**{mode: off})))


# ---- a body's fit is its own

@pytest.mark.parametrize("half", [0, 1], ids=["first_half", "second_half"])
@pytest.mark.parametrize("tier", ["exact", "production"])
def test_a_bodys_fit_is_its_own(world, tier, half):
    """Every loss term is per body, and Adam acts per coordinate, so half of
    the population fitted alone has the bits of those rows of the whole
    population's fit: the property that lets each rank of a mesh fit only
    its own rows."""
    production = tier == "production"
    grid = "bf16" if production else "f32"
    fit = make_fit_step(world["assets"][grid][1], _cfgs(PRODUCTION if production else EXACT, production)[1])
    ins = _inputs(world, "torch")
    x, m, h = fit(*ins)
    rows = slice(half * N // 2, (half + 1) * N // 2)
    xa, ma, ha = fit(*(a[rows] for a in ins))
    assert torch.equal(x[rows], xa) and torch.equal(h[:, rows], ha)
    assert all(torch.equal(m[k][rows], ma[k]) for k in METRICS)


# ---- the two parity cases tests/test_torch_fit.py left out

def test_exact_tier_over_the_unpruned_cloud_matches_jax(world):
    kw = dict(num_iter=6, prune_scene_points=0)
    _assert_tracks(_port_fit(world, kw, production=False, grid="f32"), _jax_fit(world, kw, production=False, grid="f32"))


def test_production_with_one_refresh_block_matches_jax(world, f32_fast):
    """refresh_every=20 over 6 iterations: 2 warm-up passes, then one full
    pass and 3 cheap ones in the partial tail block."""
    kw = dict(PRODUCTION, refresh_every=20, lbs_precision="fast")
    assert fitting.fit_schedule(FitConfig.production(**kw)) == ["full", "nn_only", "full", "cheap", "cheap", "cheap"]
    _assert_tracks(_port_fit(world, kw), _jax_fit(world, kw))


# ---- the carried-Adam mode

CARRY = dict(num_iter=4, lbs_precision="fast")


def test_carried_adam_matches_jax_and_returns_two_values(world, f32_fast):
    """One Adam state across the bodies, serially, a full pass every
    iteration. Same tolerances as a fit ('fast' is f32 on both sides here)."""
    ja, ta = world["assets"]["f32"]
    jcfg, tcfg = _cfgs(CARRY, production=False)
    out_j = j_make_carry(ja, jcfg)(*_inputs(world, "jax"))
    out_t = make_fit_step_carry_opt_state(ta, tcfg)(*_inputs(world, "torch"))
    assert len(out_j) == len(out_t) == 2
    xt, mt = out_t[0].numpy(), {k: v.numpy() for k, v in out_t[1].items()}
    xj, mj = np.asarray(out_j[0]), out_j[1]
    d = np.abs(xt - xj)
    assert xt.shape == (N, 72) and d.max() < DRIFT_MAX and d.mean() < DRIFT_MEAN, (d.max(), d.mean())
    for k in METRICS:
        np.testing.assert_allclose(mt[k], np.asarray(mj[k]), rtol=1e-3, atol=2e-5, err_msg=k)


def test_carried_adam_first_body_is_the_fresh_fit_and_later_bodies_are_not(world):
    """Body 0 starts from fresh moments, as every body of make_fit_step does:
    equal to 1e-5 (batch 1 against batch 4: another sum order at most).
    Bodies 1.. inherit moments and a step count of 4, 8, 12: they differ."""
    _, ta = world["assets"]["f32"]
    cfg = FitConfig.exact(**CARRY)
    x_carry, m_carry = make_fit_step_carry_opt_state(ta, cfg)(*_inputs(world, "torch"))
    x_fresh, m_fresh, _ = make_fit_step(ta, cfg)(*_inputs(world, "torch"))
    np.testing.assert_allclose(x_carry[0].numpy(), x_fresh[0].numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(m_carry["total"][0].numpy(), m_fresh["total"][0].numpy(), rtol=1e-5)
    assert all((x_carry[b] - x_fresh[b]).abs().max() > 1e-3 for b in range(1, N))


def test_carried_adam_runs_full_passes_whatever_refresh_every_says(world, monkeypatch):
    """With a production config the serial loop still searches and gathers
    afresh every iteration (sel is never passed), on the fused tier too."""
    _, ta = world["assets"]["bf16"]
    seen = []
    real = fitting._per_body_losses

    def spy(assets, xhr, xhr_init, cam_ext, scene_idx, cfg, sel=None, *a, **k):
        seen.append((xhr.shape[0], sel))
        return real(assets, xhr, xhr_init, cam_ext, scene_idx, cfg, sel, *a, **k)

    monkeypatch.setattr(fitting, "_per_body_losses", spy)
    x, m = make_fit_step_carry_opt_state(ta, FitConfig.production(num_iter=3))(*_inputs(world, "torch"))
    assert seen == [(1, None)] * (3 * N) + [(N, None)]
    assert torch.isfinite(x).all() and m["total"].shape == (N,)
