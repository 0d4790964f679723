"""The fit's off-by-default knobs and the carried-Adam mode:
psi_tpu_torch.fit.fitting vs psi_tpu.fit.fitting on tests/test_torch_fit.py's
world (N=4 bodies, V=300, J=12, 2 scenes, sdf_dim=16, 512 scene points, 32
contact vertices; the same model-sampled bodies placed in the scenes'
floors), plus smplx_vertex_subset and the two parity cases that file left
out (the exact tier with prune_scene_points=0, production(refresh_every=20)).

What psi_tpu computes on the CPU, and so what each comparison can hold:
* 'fused' runs psi_tpu's Pallas kernels in interpret mode: both sides round
  the same operands to bf16, and fits agree to ~1e-5 (tests/test_torch_fit.py).
* 'fast' is plain f32 in psi_tpu on the CPU (its bf16 rounding happens inside
  the TPU's matrix unit) while the port rounds the operands itself. The
  vertex-subset passes of cheap_collision_verts run 'fast', so the fixture
  ``f32_fast`` switches the port's rounding off where the *logic* of those
  passes is held to psi_tpu's at rounding level; a second comparison runs
  with the rounding on.
* 'high' is a split-bf16 emulation of f32 in psi_tpu (~2^-16): fine for one
  forward, amplified by Adam, so 'high' fits are compared only on this
  world's exact tier, where tests/test_torch_fit.py found 3.1e-4.

Tolerances (tests/test_torch_fit.py's, with its reasons): iteration-0 loss
1e-4 relative; fitted x72 drift max 5e-3, mean 5e-4; mean loss per iteration
and final metrics 1e-3 relative (+2e-5 absolute on a metric). Found here:
every knob drift max 1.2e-6, loss history 1.2e-7 relative; the unpruned
exact tier 3.1e-4, 2.4e-5. With the port's bf16 rounding on, the subset
passes differ from psi_tpu's f32 ones by the bf16 tier's input rounding and
still keep those bounds (found drift max 5.0e-4, mean 2.1e-5, loss history
3.8e-5). Comparisons of the port with itself say their own bound.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psi_tpu.body.decode import body_vec_to_verts as j_decode
from psi_tpu.body.smplx_model import smplx_vertex_subset as j_vertex_subset
from psi_tpu.fit.fitting import make_fit_step as j_make_fit_step
from psi_tpu.fit.fitting import make_fit_step_carry_opt_state as j_make_carry
from psi_tpu.ops.sdf import sdf_trilinear_packed as j_sdf_packed
from psi_tpu.utils.config import FitConfig as JFitConfig
from psi_tpu_torch.body import lbs as t_lbs_module
from psi_tpu_torch.body.decode import body_vec_to_verts as t_decode
from psi_tpu_torch.body.smplx_model import SMPLX_FIELDS, smplx_forward, smplx_vertex_subset
from psi_tpu_torch.fit import fitting
from psi_tpu_torch.fit.fitting import _build_subset, make_fit_step, make_fit_step_carry_opt_state
from psi_tpu_torch.ops import fused_skinning
from psi_tpu_torch.ops.sdf import sdf_trilinear_packed as t_sdf_packed
from psi_tpu_torch.utils.config import FitConfig
from test_torch_fit import DRIFT_MAX, DRIFT_MEAN, N, V, world  # noqa: F401  (world: the module-scoped fixture)

torch.set_num_threads(1)
PRODUCTION = dict(num_iter=6, refresh_every=3, refresh_warmup=2, prune_scene_points=256)
S = 48  # cheap_collision_verts: 24 stride rows + 24 penetration rows
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


# ---- the vertex-subset model

ROWS = np.array([7, 299, 0, 7, 150, 42, 42, 298], np.int64)  # unsorted, with repeats


def _body_params(world):
    from psi_tpu_torch.geometry.bodyvec import body_params_encapsulate

    p = body_params_encapsulate(torch.from_numpy(world["x72"]))
    pose = torch.from_numpy(np.random.default_rng(3).normal(0, 0.3, (N, 63)).astype(np.float32))
    return dict(transl=p["transl"], global_orient=p["global_orient"], betas=p["betas"], body_pose=pose,
                left_hand_pose=p["left_hand_pose"], right_hand_pose=p["right_hand_pose"])


def test_vertex_subset_fields_match_jax(world):
    """Slicing computes nothing: every field equals psi_tpu's exactly, and
    posedirs keeps a vertex's three columns together."""
    ja, ta = world["assets"]["f32"]
    jsub, jjd = j_vertex_subset(ja.smplx, jnp.asarray(ROWS))
    tsub, tjd = smplx_vertex_subset(ta.smplx, torch.from_numpy(ROWS))
    for f in SMPLX_FIELDS:
        a, b = getattr(tsub, f), getattr(jsub, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f)
    assert tsub.parents == jsub.parents and tsub.num_verts == len(ROWS)
    assert torch.equal(tsub.faces, ta.smplx.faces)  # not remapped
    for a, b in zip(tjd, jjd):  # the folded regressor: a [J, V] x [V, ...] sum in f32, psi_tpu's in split bf16
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=0)


@pytest.mark.parametrize("precision", ["high", "fast"])
def test_vertex_subset_rows_equal_the_full_models_rows(world, precision):
    """The subset forward gives the full model's vertices at those rows when
    both take their joints from the folded regressor: the same per-row sums,
    1e-6 on metre-scale vertices at 'high' and at 'fast' (bf16 operands are
    rounded per element, so a row's operands do not depend on its
    neighbours). Against the full model's own joint regression 'high' still
    agrees to 1e-5 (one more f32 sum over V), 'fast' only to the bf16 tier:
    its regression runs on rounded operands, the folded one does not."""
    _, ta = world["assets"]["f32"]
    p = _body_params(world)
    sub, jd = smplx_vertex_subset(ta.smplx, torch.from_numpy(ROWS))
    vs, js = smplx_forward(sub, **p, precision=precision, joints_direct=jd)
    vf, jf = smplx_forward(ta.smplx, **p, precision=precision, joints_direct=jd)
    assert vs.shape == (N, len(ROWS), 3)
    np.testing.assert_allclose(vs.numpy(), vf[:, ROWS].numpy(), atol=1e-6, rtol=0)
    np.testing.assert_allclose(js.numpy(), jf.numpy(), atol=1e-6, rtol=0)
    v_own = smplx_forward(ta.smplx, **p, precision=precision)[0]
    np.testing.assert_allclose(vs.numpy(), v_own[:, ROWS].numpy(), atol=1e-5 if precision == "high" else 2.5e-2, rtol=0)


def test_subset_decode_matches_jax_and_fused_falls_back_to_fast(world, f32_fast):
    """body_vec_to_verts on a subset model vs psi_tpu's (1e-4, the 'high'
    bound of tests/test_torch_body.py; 'fast' is f32 on both sides here), and
    'fused' with joints_direct is the 'fast' path to the bit: no bundle."""
    ja, ta = world["assets"]["f32"]
    jsub, jjd = j_vertex_subset(ja.smplx, jnp.asarray(ROWS))
    tsub, tjd = smplx_vertex_subset(ta.smplx, torch.from_numpy(ROWS))
    xj, cj, _ = _inputs(world, "jax")
    xt, ct, _ = _inputs(world, "torch")
    out = {}
    for precision in ("high", "fast", "fused"):
        vj = j_decode(jsub, ja.vposer_params, xj, cj, precision=precision, joints_direct=jjd)[0]
        with torch.no_grad():
            out[precision] = t_decode(tsub, ta.vposer, xt, ct, precision=precision, joints_direct=tjd)[0]
        np.testing.assert_allclose(out[precision].numpy(), np.asarray(vj), atol=1e-4, rtol=0)
    assert torch.equal(out["fused"], out["fast"])


# ---- cheap_collision_verts

@pytest.fixture(scope="module")
def jax_cheap(world):
    return _jax_fit(world, dict(PRODUCTION, cheap_collision_verts=S))


def test_cheap_collision_verts_matches_jax(world, jax_cheap, f32_fast):
    _assert_tracks(_port_fit(world, dict(PRODUCTION, cheap_collision_verts=S)), jax_cheap)


def test_cheap_collision_verts_with_bf16_rounding_stays_within_its_tier(world, jax_cheap):
    port = _port_fit(world, dict(PRODUCTION, cheap_collision_verts=S))
    _assert_tracks(port, jax_cheap)
    # the subset changes the iterates from the first cheap pass on, and only from there
    plain = _port_fit(world, PRODUCTION)
    w = PRODUCTION["refresh_warmup"]
    assert np.array_equal(port[2][: w + 1], plain[2][: w + 1]) and not np.array_equal(port[2][w + 1], plain[2][w + 1])


@pytest.mark.parametrize("budget", [V, 10 ** 6])
def test_cheap_collision_verts_of_every_vertex_equals_the_plain_refresh_run(world, budget):
    """A budget of V or more selects arange(V): the cheap passes then see
    every vertex, through the subset model. At 'high' both routes are the
    same f32 sums per row (1e-6 a vertex, above); over 6 Adam steps the
    loss history is held to 1e-5 relative and the bodies to 1e-4."""
    kw = dict(PRODUCTION, lbs_precision="high")
    xa, ma, ha = _port_fit(world, dict(kw, cheap_collision_verts=budget))
    xb, mb, hb = _port_fit(world, kw)
    np.testing.assert_allclose(ha, hb, rtol=1e-5)
    np.testing.assert_allclose(xa, xb, atol=1e-4, rtol=0)
    np.testing.assert_allclose(ma["total"], mb["total"], rtol=1e-5)


def _post_warmup_state(world):
    """psi_tpu's population after the warm-up passes, at 'high'."""
    kw = dict(PRODUCTION, lbs_precision="high", num_iter=PRODUCTION["refresh_warmup"])
    return _jax_fit(world, kw)[0]


def test_selected_rows_match_jax_at_high(world):
    """The subset recipe on psi_tpu's post-warm-up state, through each
    package's own decode and SDF lookup at 'high': the stride half equal, the
    penetration half equal as a set, or else every row that differs has a
    mass within 1e-5 of the k-th (the two f32 decodes agree to ~1e-6 a
    vertex, summed over 4 bodies)."""
    ja, ta = world["assets"]["bf16"]
    x_now = _post_warmup_state(world)
    _, cam_j, sidx_j = _inputs(world, "jax")
    _, cam_t, sidx_t = _inputs(world, "torch")
    s_stride, k = S // 2, S - S // 2
    verts0 = j_decode(ja.smplx, ja.vposer_params, jnp.asarray(x_now), cam_j, precision="high")[0]
    mass_j = jnp.sum(jnp.minimum(j_sdf_packed(ja.sdf_packed, sidx_j, verts0, ja.grid_mins, ja.grid_maxs), 0.0), axis=0)
    pen_j = np.asarray(jax.lax.top_k(-mass_j, k)[1])
    stride = np.unique(np.round(np.linspace(0, V - 1, s_stride)).astype(np.int64))

    cfg = FitConfig.production(**dict(PRODUCTION, lbs_precision="high", cheap_collision_verts=S))
    with torch.no_grad():
        sub = _build_subset(ta, cfg, torch.from_numpy(x_now), cam_t, sidx_t.long(), None)
    coll = sub["coll_rows"].numpy()
    assert sub["n_contact"] == 32 and coll.dtype == np.int64
    np.testing.assert_array_equal(coll[: len(stride)], stride)
    np.testing.assert_array_equal(sub["rows"].numpy(), np.concatenate([ta.contact_vids.numpy(), coll]))
    assert sub["smplx"].num_verts == 32 + len(coll)
    pen_t = coll[len(stride):]
    assert len(pen_t) == k
    mass = np.asarray(mass_j)
    assert (mass < 0).sum() > k  # more vertices penetrate than are taken: no tie at the cut
    kth = np.sort(-mass)[::-1][k - 1]
    for row in set(pen_t) ^ set(pen_j):
        assert abs(-mass[row] - kth) < 1e-5, (row, mass[row], kth)


def test_selected_rows_break_ties_by_the_lowest_index(world):
    """A scene whose SDF is negative only under one horizontal plane, and
    bodies placed so that 10 vertices dip under it: fewer than the 24 rows of
    the penetration half. The rest of that half are ties at mass exactly 0,
    which jax.lax.top_k takes lowest index first. The port's stable sort must
    give the same rows in the same order (torch.topk promises none)."""
    from psi_tpu_torch.ops.sdf import pack_sdf_corners

    _, ta = world["assets"]["bf16"]
    x, cam, _ = _inputs(world, "torch")
    sidx = torch.zeros(N, dtype=torch.int64)
    D, layers, n_dip = ta.sdf_packed.shape[1], 4, 10
    slab = np.where(np.arange(D)[None, :, None] < layers, -1.0, 1.0).astype(np.float32)  # axes (x, y, z)
    grid = torch.from_numpy(np.broadcast_to(slab, (ta.sdf_packed.shape[0], D, D, D)).copy())
    ta = dataclasses.replace(ta, sdf_packed=pack_sdf_corners(grid).to(ta.sdf_packed.dtype))
    lo, hi = ta.grid_mins[0, 1].item(), ta.grid_maxs[0, 1].item()
    plane = lo + layers / D * (hi - lo)  # where the interpolated SDF crosses 0 (voxel centres at (i + 0.5) / D)
    cfg = FitConfig.production(**dict(PRODUCTION, lbs_precision="high", cheap_collision_verts=S))
    with torch.no_grad():
        lowest = t_decode(ta.smplx, ta.vposer, x, cam, precision="high")[0][..., 1].min(dim=0).values.sort().values
        cam = cam.clone()
        cam[:, 1, 3] += plane - 0.5 * (lowest[n_dip - 1] + lowest[n_dip]).item()
        verts = t_decode(ta.smplx, ta.vposer, x, cam, precision="high")[0]
        mass = torch.minimum(t_sdf_packed(ta.sdf_packed, sidx, verts, ta.grid_mins, ta.grid_maxs),
                             torch.zeros(())).sum(0)
        coll = _build_subset(ta, cfg, x, cam, sidx, None)["coll_rows"].numpy()
    k = S - S // 2
    n_pen = int((mass < 0).sum())
    assert n_pen == n_dip < k
    want = np.asarray(jax.lax.top_k(-jnp.asarray(mass.numpy()), k)[1])
    pen = coll[-k:]
    np.testing.assert_array_equal(pen, want)
    zero_rows = np.flatnonzero(mass.numpy() == 0)
    np.testing.assert_array_equal(pen[n_pen:], zero_rows[: k - n_pen])  # the ties: the lowest rows, ascending


# ---- overlap_chunks

@pytest.fixture(scope="module")
def port_plain(world):
    return _port_fit(world, PRODUCTION)


def test_overlap_chunks_matches_jax(world, f32_fast):
    kw = dict(PRODUCTION, overlap_chunks=2, lbs_precision="fast", num_iter=4)
    _assert_tracks(_port_fit(world, kw), _jax_fit(world, kw))


def test_overlap_chunks_two_equals_one_per_body(world, port_plain):
    """Every loss term is per body, so two chunks of two bodies give the
    batched run's bodies; a matmul may sum in another order at half the
    batch, so: loss history 1e-5 relative, bodies 1e-4 over 6 Adam steps
    (found equal to the bit)."""
    x, m, h = _port_fit(world, dict(PRODUCTION, overlap_chunks=2))
    assert h.shape == (6, N)
    np.testing.assert_allclose(h, port_plain[2], rtol=1e-5)
    np.testing.assert_allclose(x, port_plain[0], atol=1e-4, rtol=0)
    np.testing.assert_allclose(m["total"], port_plain[1]["total"], rtol=1e-5)


@pytest.mark.parametrize("extra", [dict(), dict(cheap_collision_verts=V)], ids=["plain", "every_row_subset"])
def test_overlap_chunk_is_the_fit_of_its_own_bodies_alone(world, extra):
    """A chunk shares nothing with its neighbour: each half of the two-chunk
    run has the bits of the one-chunk fit of those two bodies alone (the same
    operations at the same shapes). With the every-row subset the carried
    cells go through the subset's transition too; the subset itself is the
    population's, so it must not depend on the bodies for this to hold."""
    kw = dict(PRODUCTION, **extra)
    x, m, h = _port_fit(world, dict(kw, overlap_chunks=2))
    fit = make_fit_step(world["assets"]["bf16"][1], _cfgs(kw)[1])
    for lo in (0, 2):
        xa, ma, ha = fit(*(a[lo:lo + 2] for a in _inputs(world, "torch")))
        assert np.array_equal(x[lo:lo + 2], xa.numpy()) and np.array_equal(h[:, lo:lo + 2], ha.numpy())
        assert all(np.array_equal(m[k][lo:lo + 2], ma[k].numpy()) for k in METRICS)


def test_overlap_chunks_that_do_not_divide_the_population_fall_back(world, port_plain):
    """3 chunks of 4 bodies: psi_tpu runs the batched program without a
    word, and so does the port: the very same operations, equal bits."""
    x, m, h = _port_fit(world, dict(PRODUCTION, overlap_chunks=3))
    assert np.array_equal(x, port_plain[0]) and np.array_equal(h, port_plain[2])
    assert all(np.array_equal(m[k], port_plain[1][k]) for k in METRICS)


def test_overlap_chunks_keep_their_own_adam_and_carried_state(world, monkeypatch):
    made = []
    real = fitting._Chunk

    def spy(*a):
        made.append(real(*a))
        return made[-1]

    monkeypatch.setattr(fitting, "_Chunk", spy)
    _port_fit(world, dict(PRODUCTION, overlap_chunks=2, cheap_collision_verts=S))
    assert [(c.lo, c.hi) for c in made] == [(0, 2), (2, 4)]
    assert made[0].adam is not made[1].adam and all(c.adam.count == 6 for c in made)
    # each carries its own bodies' correspondences and, after the transition, the subset's cells only
    assert all(c.sel[0].shape == (2, 32, 3) and c.sel[1][0].shape[:2] == (2, S) for c in made)


# ---- remat_decode

@pytest.mark.parametrize("extra", [dict(), dict(cheap_collision_verts=S, overlap_chunks=2)])
def test_remat_decode_gives_the_same_bits(world, extra):
    """Recomputing the decode in the backward pass changes what is kept, not
    what is computed."""
    a = _port_fit(world, dict(PRODUCTION, remat_decode=True, **extra))
    b = _port_fit(world, dict(PRODUCTION, **extra))
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[2], b[2])
    assert all(np.array_equal(a[1][k], b[1][k]) for k in METRICS)


def test_remat_decode_runs_the_fused_forward_again_in_the_backward_pass(world, monkeypatch):
    """On the CPU the wrapper takes the kernel's plain twin; under remat each
    of the 6 passes runs it twice (forward, then again for the backward),
    and the final metrics pass once."""
    calls = []
    real = fused_skinning.fused_skinning_fwd_reference
    monkeypatch.setattr(fused_skinning, "fused_skinning_fwd_reference",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    _port_fit(world, PRODUCTION)
    plain, calls[:] = len(calls), []
    _port_fit(world, dict(PRODUCTION, remat_decode=True))
    assert (plain, len(calls)) == (6 + 1, 12 + 1)


# ---- every FitConfig field runs

@pytest.mark.parametrize("knob", [dict(cheap_collision_verts=64), dict(overlap_chunks=2), dict(remat_decode=True)])
def test_fit_knobs_run_on_both_tiers(world, knob):
    """No FitConfig field of psi_tpu raises in the port. On the exact tier
    (refresh_every=1) cheap_collision_verts has no cached pass to act on and
    the run equals the plain one, as in psi_tpu."""
    _, ta = world["assets"]["bf16"]
    x, m, h = _port_fit(world, dict(PRODUCTION, **knob))
    assert x.shape == (N, 72) and h.shape == (6, N) and np.all(np.isfinite(x)) and set(m) == set(METRICS)
    exact = _port_fit(world, dict(num_iter=3, **knob), production=False, grid="f32")
    if "cheap_collision_verts" in knob:
        assert np.array_equal(exact[0], _port_fit(world, dict(num_iter=3), production=False, grid="f32")[0])
    assert np.all(np.isfinite(exact[0]))
    with pytest.raises(ValueError, match="lbs_precision"):
        make_fit_step(ta, dataclasses.replace(FitConfig.production(**knob), lbs_precision="exactish"))


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
