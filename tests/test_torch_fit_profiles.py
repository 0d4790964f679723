"""The fit profiling scripts (``scripts.profile_fused``,
``profile_refresh_cadence``, ``profile_segments``) against psi_tpu, on
tests/test_torch_fit.py's world (N=4 bodies, V=300, J=12, 2 scenes,
sdf_dim=16, 512 scene points, 32 contact vertices; model-sampled bodies
placed in the scenes' floors) at the scripts' 20 iterations.

* Every variant that ``profile_fused.variants`` and
  ``profile_refresh_cadence.variants`` build (the exact tier at 'high',
  'fast' and 'fused', with and without pruning; the production schedule at
  refresh 10, 15 and 20) fits the world, and so does psi_tpu's
  ``make_fit_step`` with the same FitConfig fields.
* The port's ``fit_schedule`` is the pass kinds psi_tpu's fit runs, read
  from inside psi_tpu's compiled fit (a ``jax.debug.callback`` in its
  ``_per_body_losses``), for refresh_every 1, 10, 15 and 20, and at
  refresh_every 10 with no warm-up, a warm-up of one, a warm-up of gathers,
  fewer iterations than the warm-up, and refresh blocks with no tail.
* Each of ``profile_segments``' four segments, two Adam steps, against the
  same segment built from psi_tpu's ``_per_body_losses`` and
  ``optax.adam``.
* Each script raises without a card.

What psi_tpu computes on the CPU, and so what each comparison holds
(tests/test_torch_fit_knobs.py's reading): 'fused' runs psi_tpu's Pallas
kernels in interpret mode, both sides rounding the same operands to bf16;
'fast' is plain f32 in psi_tpu on the CPU, so the port's bf16 operand
rounding is switched off (``t_lbs._bf16`` the identity); 'high' is the
split-bf16 products in both packages: the ``_high_lbs`` tests compare them
as they are, the others patch both packages' LBS to ``exact=True`` (plain
f32), the comparison these tests made before the port had the split.

Tolerances: the fits, tests/test_torch_fit.py's (iteration-0 loss 1e-4
relative; fitted x72 drift max 5e-3, mean 5e-4; mean loss per iteration and
final metrics 1e-3 relative, +2e-5 absolute on a metric); the segments'
iterates 1e-5 (absolute and relative). Found here: fitted x72 drift max
8.4e-6, mean 6.1e-7 (exact_fused; the others under 6.1e-6), the mean loss
per iteration 3.0e-6 relative, final metrics 3.9e-7 absolute; the segments
1.2e-5 absolute on decode_only's translations (metres), under 5e-7
elsewhere.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from psi_tpu.body import smplx_model as j_smplx_model
from psi_tpu.body.lbs import lbs as j_lbs
from psi_tpu.fit import fitting as j_fitting
from psi_tpu.fit.fitting import make_fit_step as j_make_fit_step
from psi_tpu.geometry.bodyvec import convert_to_3D_rot as j_to_3d
from psi_tpu.geometry.bodyvec import convert_to_6D_rot as j_to_6d
from psi_tpu.utils.config import FitConfig as JFitConfig
from psi_tpu_torch.body import lbs as t_lbs
from psi_tpu_torch.body import smplx_model as t_smplx_model
from psi_tpu_torch.fit.fitting import fit_schedule, make_fit_step
from psi_tpu_torch.scripts import profile_fused, profile_refresh_cadence, profile_segments
from psi_tpu_torch.utils.config import FitConfig
from test_torch_fit import DRIFT_MAX, DRIFT_MEAN, N, world  # noqa: F401  (world: the module-scoped fixture)

torch.set_num_threads(1)
NUM_ITER = 20
SEGMENT_ITERS = 2
SEGMENT_TOL = 1e-5
# The split 'high' comparisons (the _high_lbs tests) run shorter. Both
# gradients carry bf16-rounded cotangents and agree to ~5e-4 relative on
# their smallest entries; Adam's second update divides moment sums that
# nearly cancel where the first step (lr * sign(g)) overshot, which parts
# the iterates by ~5e-3 from that update on, and over the exact tier's 20
# iterations a few latent coordinates part by ~1e-1 (measured on this world:
# 6 iterations 1.5e-4 max / 7e-6 mean, 10 iterations 2.5e-2, 20 8.9e-2). So
# the fits hold 6 iterations (test_torch_fit.py's exact tier) and the segments
# their first update, at the tolerances above.
HIGH_NUM_ITER, HIGH_SEGMENT_ITERS = 6, 1
METRICS = ("rec", "vposer", "contact", "collision", "total")
FUSED_VARIANTS = ("refresh10_fast", "refresh10_fused", "exact_high", "exact_fast", "exact_fused", "exact_high_m20000")
HIGH_VARIANTS = ("exact_high", "exact_high_m20000")
# refresh10 of the cadence script is profile_fused's refresh10_fused, the same FitConfig
CADENCE_VARIANTS = ("refresh15", "refresh20")


def _same_tier_arithmetic(monkeypatch, precision, split_high=False):
    """Make both packages compute the same arithmetic for ``precision``:
    'high' at exact=True in both, unless ``split_high`` keeps their split."""
    if precision == "fast":
        monkeypatch.setattr(t_lbs, "_bf16", lambda t: t)
    elif precision == "high" and not split_high:
        monkeypatch.setattr(j_smplx_model, "lbs", functools.partial(j_lbs, exact=True))
        monkeypatch.setattr(t_smplx_model, "lbs", functools.partial(t_lbs.lbs, exact=True))


def _variant(world, name, num_iter=NUM_ITER):
    """(psi_tpu's assets, the port's assets, the port's FitConfig) of a variant."""
    grids = {id(world["assets"][g][1]): g for g in ("f32", "bf16")}
    _, ta_f32 = world["assets"]["f32"]
    _, ta_bf16 = world["assets"]["bf16"]
    built = {**profile_fused.variants(ta_f32, ta_bf16, num_iter), **profile_refresh_cadence.variants(ta_bf16, num_iter)}
    ta, cfg = built[name]
    return world["assets"][grids[id(ta)]][0], ta, cfg


def _inputs(world):
    return world["x72"], world["cam"], world["sidx"]


def test_variant_builders_name_the_scripts_configurations(world):
    _, ta_f32 = world["assets"]["f32"]
    _, ta_bf16 = world["assets"]["bf16"]
    fused = profile_fused.variants(ta_f32, ta_bf16, NUM_ITER)
    assert tuple(fused) == FUSED_VARIANTS
    assert {n for n, (a, _) in fused.items() if a is ta_bf16} == {"refresh10_fast", "refresh10_fused"}
    assert fused["exact_high"][1] == FitConfig.exact(num_iter=NUM_ITER)
    assert fused["exact_high_m20000"][1] == FitConfig.exact(num_iter=NUM_ITER, prune_scene_points=0)
    cadence = profile_refresh_cadence.variants(ta_bf16, NUM_ITER)
    assert cadence["refresh10"][1] == fused["refresh10_fused"][1]
    assert tuple(cadence) == ("refresh10",) + CADENCE_VARIANTS
    expected = {n: profile_fused.expected_launches(c) for n, (_, c) in {**fused, **cadence}.items()}
    # K1, K2, K3 and the 'high' tier's K4, K5 (two products a pass, each with its gradient)
    assert expected == {"refresh10_fast": (0, 0, 6, 0, 0), "refresh10_fused": (20, 20, 6, 0, 0),
                        "exact_high": (0, 0, 20, 40, 40), "exact_fast": (0, 0, 20, 0, 0),
                        "exact_fused": (20, 20, 20, 0, 0), "exact_high_m20000": (0, 0, 20, 40, 40),
                        "refresh10": (20, 20, 6, 0, 0), "refresh15": (20, 20, 6, 0, 0), "refresh20": (20, 20, 5, 0, 0)}


@pytest.mark.parametrize("name", FUSED_VARIANTS + CADENCE_VARIANTS)
def test_variant_fit_matches_psi_tpu(world, monkeypatch, name):
    _variant_fit_matches(world, monkeypatch, name, split_high=False)


@pytest.mark.parametrize("name", HIGH_VARIANTS)
def test_variant_fit_matches_psi_tpu_high_lbs(world, monkeypatch, name):
    _variant_fit_matches(world, monkeypatch, name, split_high=True)


def _variant_fit_matches(world, monkeypatch, name, split_high):
    num_iter = HIGH_NUM_ITER if split_high else NUM_ITER
    ja, ta, cfg = _variant(world, name, num_iter)
    _same_tier_arithmetic(monkeypatch, cfg.lbs_precision, split_high)
    x72, cam, sidx = _inputs(world)
    xj, mj, hj = j_make_fit_step(ja, JFitConfig(**dataclasses.asdict(cfg)))(
        jnp.asarray(x72), jnp.asarray(cam), jnp.asarray(sidx))
    xt, mt, ht = make_fit_step(ta, cfg)(torch.from_numpy(x72), torch.from_numpy(cam), torch.from_numpy(sidx))
    xj, hj, xt, ht = np.asarray(xj), np.asarray(hj), xt.numpy(), ht.numpy()
    assert ht.shape == hj.shape == (num_iter, N) and np.all(np.isfinite(xt))
    np.testing.assert_allclose(ht[0], hj[0], rtol=1e-4, atol=0)
    np.testing.assert_allclose(ht.mean(1), hj.mean(1), rtol=1e-3)
    d = np.abs(xt - xj)
    assert d.max() < DRIFT_MAX and d.mean() < DRIFT_MEAN, (d.max(), d.mean())
    for k in METRICS:
        np.testing.assert_allclose(mt[k].numpy(), np.asarray(mj[k]), rtol=1e-3, atol=2e-5, err_msg=k)


def _jax_schedule(monkeypatch, world, cfg):
    """The pass kind of every iteration psi_tpu's compiled fit runs, in order."""
    kinds = []
    inner = j_fitting._per_body_losses

    def spy(assets, xhr, xhr_init, cam_ext, scene_idx, cfg_, sel=None, fresh_nn=None, fresh_sdf=None, *a, **k):
        kind = "full" if sel is None else ("nn_only" if fresh_nn else "cheap")
        jax.debug.callback(lambda: kinds.append(kind), ordered=True)
        return inner(assets, xhr, xhr_init, cam_ext, scene_idx, cfg_, sel, fresh_nn, fresh_sdf, *a, **k)

    monkeypatch.setattr(j_fitting, "_per_body_losses", spy)
    ja = world["assets"]["bf16"][0]
    x72, cam, sidx = _inputs(world)
    out = j_make_fit_step(ja, JFitConfig(**dataclasses.asdict(cfg)), want_metrics=False)(
        jnp.asarray(x72), jnp.asarray(cam), jnp.asarray(sidx))
    jax.block_until_ready(out)
    jax.effects_barrier()
    return kinds


# keyword sets over FitConfig.production(num_iter=NUM_ITER, lbs_precision="fast"): the
# cadences, no warm-up, a warm-up of one, a warm-up of gathers, a fit shorter than its
# warm-up, and one whose refresh blocks fill it with no tail
SCHEDULES = {
    "1": dict(refresh_every=1), "10": dict(refresh_every=10), "15": dict(refresh_every=15),
    "20": dict(refresh_every=20), "no_warmup": dict(refresh_warmup=0), "warmup_1": dict(refresh_warmup=1),
    "warmup_gathers": dict(sdf_warmup_gathers=True), "shorter_than_warmup": dict(num_iter=3),
    "no_tail_block": dict(num_iter=24),
}


@pytest.mark.parametrize("schedule", list(SCHEDULES))
def test_fit_schedule_is_psi_tpus(world, monkeypatch, schedule):
    cfg = FitConfig.production(**{"num_iter": NUM_ITER, "lbs_precision": "fast", **SCHEDULES[schedule]})
    assert fit_schedule(cfg) == _jax_schedule(monkeypatch, world, cfg)


def _jax_segment(ja, cfg, fresh_nn, fresh_sdf, decode_only, num_iter):
    """``scripts/profile_segments.py``'s segment, built from psi_tpu's
    ``_per_body_losses`` and ``optax.adam`` as that script builds it."""
    from psi_tpu.body.decode import body_vec_to_verts

    opt = optax.adam(cfg.init_lr_h)

    @jax.jit
    def run(assets_, x72_init, cam_ext, scene_idx, y_nn, cache):
        xhr_init = j_to_6d(x72_init)
        fb = j_smplx_model.make_fused_bundle(assets_.smplx) if cfg.lbs_precision == "fused" else None

        def loss_fn(x):
            if decode_only:
                v = body_vec_to_verts(assets_.smplx, assets_.vposer_params, j_to_3d(x), cam_ext,
                                      precision=cfg.lbs_precision, fused_bundle=fb)[0]
                return jnp.sum(v * 1e-3)
            return j_fitting._per_body_losses(assets_, x, xhr_init, cam_ext, scene_idx, cfg, (y_nn, cache),
                                              fresh_nn, fresh_sdf, None, fb)[0]

        def step(carry, _):
            xhr, opt_state = carry
            grads = jax.grad(loss_fn)(xhr)
            updates, opt_state = opt.update(grads, opt_state, xhr)
            return (optax.apply_updates(xhr, updates), opt_state), None

        carry, _ = jax.lax.scan(step, (xhr_init, opt.init(xhr_init)), None, length=num_iter)
        return carry[0]

    return lambda *args: run(ja, *args)


@pytest.mark.parametrize("tier", ["fused", "high"])
@pytest.mark.parametrize("segment", list(profile_segments.SEGMENTS))
def test_segment_matches_psi_tpu(world, monkeypatch, tier, segment):
    _segment_matches(world, monkeypatch, tier, segment, split_high=False)


@pytest.mark.parametrize("segment", list(profile_segments.SEGMENTS))
def test_segment_matches_psi_tpu_high_lbs(world, monkeypatch, segment):
    _segment_matches(world, monkeypatch, "high", segment, split_high=True)


def _segment_matches(world, monkeypatch, tier, segment, split_high):
    _same_tier_arithmetic(monkeypatch, tier, split_high)
    iters = HIGH_SEGMENT_ITERS if split_high else SEGMENT_ITERS
    ja, ta = world["assets"]["bf16"]
    cfg = FitConfig.production(num_iter=iters, lbs_precision=tier)
    fresh_nn, fresh_sdf, decode_only = profile_segments.SEGMENTS[segment]
    y_nn, cache = profile_segments.frozen_state(ta, N)
    x72, cam, sidx = _inputs(world)
    xt = profile_segments.build(ta, cfg, fresh_nn, fresh_sdf, decode_only, iters)(
        torch.from_numpy(x72), torch.from_numpy(cam), torch.from_numpy(sidx), y_nn, cache)
    jcache = (jnp.asarray(cache[0].float().numpy()).astype(ja.sdf_packed.dtype), jnp.asarray(cache[1].numpy()))
    xj = _jax_segment(ja, JFitConfig(**dataclasses.asdict(cfg)), fresh_nn, fresh_sdf, decode_only, iters)(
        jnp.asarray(x72), jnp.asarray(cam), jnp.asarray(sidx), jnp.asarray(y_nn.numpy()), jcache)
    assert xt.shape == (N, 75)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=SEGMENT_TOL, atol=SEGMENT_TOL)


@pytest.mark.parametrize("script, argv", [(profile_fused, ["--groups", "1", "--reps", "1"]),
                                          (profile_segments, ["high"]),
                                          (profile_refresh_cadence, ["--groups", "1", "--reps", "1"])])
def test_fit_scripts_raise_without_a_card(monkeypatch, script, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs an NVIDIA card"):
        script.main(argv)
