"""The train step: gradients, Adam, BatchNorm's running statistics, the
gradient clip and the chunked epoch, psi_tpu_torch.train.loop vs psi_tpu's
(jax.value_and_grad, optax.adam, flax batch_stats), on the objective test's
world: the same weights, assets, batch and injected noise, fca 0.7,
f_scene 1 (all six terms live).

Tolerances:
* gradients, leaf by leaf: max |port - jax| <= 5e-4 of the leaf's largest
  |gradient| + 1e-9 (f32 sums in another order through the BatchNorm trunk's
  backward; found at most 4.6e-6 of the leaf's largest for s1 and 1.2e-4
  for s2, whose local VAE sits behind the global one's output);
* parameters after Adam steps: at step 1 Adam moves a parameter by
  lr * g / (|g| + 1e-8), about +-lr whatever the size of g, so a gradient
  of ~1e-8 that differs in the last bits between the packages moves its
  parameter by up to 2 lr apart. Held: max <= 2.5 lr per leaf and mean
  <= 0.05 lr per leaf after 1 step and after 3 (found: max 0.13 lr, mean
  0.022 lr on a 64-element leaf after 3 steps; tests/test_train.py holds
  psi_tpu's own two step programs to 12.5 lr and 0.05 lr);
* running statistics after one step: 1e-5 relative + 1e-6 absolute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn

from psi_tpu.train.loop import TrainState as JTrainState
from psi_tpu.train.loop import make_train_step as j_make_train_step
from psi_tpu.train.objective import cvae_loss as j_cvae_loss
from psi_tpu.utils.config import LossConfig as JLossConfig
from psi_tpu_torch.nn.layers import BatchNorm2d
from psi_tpu_torch.train.loop import (
    TrainState,
    _stage_chunk,
    clip_by_global_norm_,
    make_epoch_step,
    make_optimizer,
    make_train_step,
)
from psi_tpu_torch.utils.config import LossConfig
from psi_tpu_torch.utils.convert_jax import cvae_s1_to_jax, cvae_s2_to_jax, grads_to_jax
from test_torch_train_objective import jax_noise, make_world, torch_batch

torch.set_num_threads(1)
LR = 3e-4
FCA, F_SCENE = 0.7, 1.0
KEYS = [jax.random.PRNGKey(31 + i) for i in range(3)]
GRAD_REL, PARAM_MAX, PARAM_MEAN = 5e-4, 2.5 * LR, 0.05 * LR
TO_JAX = {"s1": cvae_s1_to_jax, "s2": cvae_s2_to_jax}


@pytest.fixture(scope="module")
def world():
    return make_world(seed=1)


def _leaves(tree):
    return [(jax.tree_util.keystr(p), np.asarray(x)) for p, x in jax.tree_util.tree_leaves_with_path(tree)]


def _assert_grads_close(gt, gj):
    lt, lj = _leaves(gt), _leaves(gj)
    assert [k for k, _ in lt] == [k for k, _ in lj]
    worst = 0.0
    for (k, a), (_, b) in zip(lt, lj):
        scale = np.abs(b).max()
        assert scale > 0, f"{k}: psi_tpu's gradient is all zero"
        err = np.abs(a - b).max()
        assert err <= GRAD_REL * scale + 1e-9, f"{k}: {err} vs largest {scale}"
        worst = max(worst, err / scale)
    return worst


def _assert_params_close(pt, pj):
    lt, lj = _leaves(pt), _leaves(pj)
    assert [k for k, _ in lt] == [k for k, _ in lj]
    for (k, a), (_, b) in zip(lt, lj):
        d = np.abs(a - b)
        assert d.max() <= PARAM_MAX and d.mean() <= PARAM_MEAN, f"{k}: max {d.max()}, mean {d.mean()}"


def _jax_state(v, opt):
    return JTrainState(params=v["params"], batch_stats=v["batch_stats"], opt_state=opt.init(v["params"]),
                       step=jnp.zeros((), jnp.int32))


def _port_state(world, mt):
    model = world["models"][mt][2](train=True)
    return TrainState(model, make_optimizer(model, LR), 0, torch.Generator().manual_seed(0))


@pytest.fixture(scope="module", params=["s1", "s2"])
def stepped(request, world):
    """Three steps on one batch in both packages; the state after each."""
    mt = request.param
    jm, v, _ = world["models"][mt]
    opt = optax.adam(LR)
    jstep = j_make_train_step(jm, opt, world["jassets"], JLossConfig(), mt)
    jb = {k: jnp.asarray(x) for k, x in world["batch"].items()}
    js = _jax_state(jax.tree.map(jnp.asarray, v), opt)
    ts = _port_state(world, mt)
    tstep = make_train_step(world["tassets"], LossConfig(), mt)
    tb = torch_batch(world["batch"])
    trail = []
    for key in KEYS:
        js, mj = jstep(js, jb, key, jnp.float32(FCA), jnp.float32(F_SCENE))
        ts, mt_ = tstep(ts, tb, FCA, F_SCENE, eps=jax_noise(mt, key))
        trail.append(dict(jparams=jax.device_get(js.params), jstats=jax.device_get(js.batch_stats),
                          mj={k: float(x) for k, x in mj.items()}, tvars=TO_JAX[mt](ts.model),
                          mt={k: float(x) for k, x in mt_.items()}))
    assert ts.step == 3 and int(js.step) == 3 and ts.model.training
    return mt, trail


@pytest.mark.parametrize("mt", ["s1", "s2"])
def test_gradients_match_jax_tree_against_tree(world, mt):
    jm, v, build = world["models"][mt]
    jb = {k: jnp.asarray(x) for k, x in world["batch"].items()}

    def loss(params):
        return j_cvae_loss(jm, {"params": params, "batch_stats": v["batch_stats"]}, jb, world["jassets"], KEYS[0],
                           jnp.float32(FCA), jnp.float32(F_SCENE), JLossConfig(), model_type=mt, train=True)[0]

    gj = jax.device_get(jax.jit(jax.grad(loss))(v["params"]))
    ts = TrainState(build(train=True), None, 0, None)
    ts.optimizer = torch.optim.SGD(ts.model.parameters(), lr=0.0)  # leaves parameters and .grad as they are
    make_train_step(world["tassets"], LossConfig(), mt)(ts, torch_batch(world["batch"]), FCA, F_SCENE,
                                                         eps=jax_noise(mt, KEYS[0]))
    worst = _assert_grads_close(grads_to_jax(ts.model), gj)
    assert worst < GRAD_REL


def test_metrics_of_each_step_match_jax(stepped):
    """Step k's metrics come from step k-1's parameters: 2e-5 relative at the
    first step, and within 1e-3 relative after Adam's +-lr moves."""
    _, trail = stepped
    for i, rec in enumerate(trail):
        for k, x in rec["mj"].items():
            np.testing.assert_allclose(rec["mt"][k], x, rtol=2e-5 if i == 0 else 1e-3, atol=1e-7, err_msg=f"{i} {k}")


@pytest.mark.parametrize("n_steps", [1, 3])
def test_parameters_after_adam_steps_match_optax(stepped, n_steps):
    _, trail = stepped
    rec = trail[n_steps - 1]
    _assert_params_close(rec["tvars"]["params"], rec["jparams"])


def test_running_statistics_after_one_step_match_flax(stepped):
    _, trail = stepped
    lt, lj = _leaves(trail[0]["tvars"]["batch_stats"]), _leaves(trail[0]["jstats"])
    assert [k for k, _ in lt] == [k for k, _ in lj] and len(lt) >= 20  # 10 BatchNorm layers a trunk
    for (k, a), (_, b) in zip(lt, lj):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6, err_msg=k)


def test_running_statistics_moved(stepped, world):
    mt, trail = stepped
    before = _leaves(world["models"][mt][1]["batch_stats"])
    after = _leaves(trail[0]["tvars"]["batch_stats"])
    assert all(np.abs(a - b).max() > 0 for (_, a), (_, b) in zip(after, before))


def test_batchnorm_running_update_is_flax(rng):
    """One layer alone: flax blends in the biased batch variance, torch's
    nn.BatchNorm2d the unbiased one; the port's layer follows flax while its
    output and running mean stay nn.BatchNorm2d's bit for bit."""
    x = rng.normal(0.3, 2.0, (4, 5, 5, 8)).astype(np.float32)  # NHWC, n = 100 per channel
    stats = {"mean": rng.normal(0, 1, 8).astype(np.float32), "var": rng.uniform(0.5, 2, 8).astype(np.float32)}
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = {"params": {"scale": jnp.ones(8), "bias": jnp.zeros(8)}, "batch_stats": stats}
    yj, new = bn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    ours, stock = BatchNorm2d(8, eps=1e-5), torch.nn.BatchNorm2d(8, eps=1e-5)
    for m in (ours, stock):
        m.running_mean.copy_(torch.from_numpy(stats["mean"]))
        m.running_var.copy_(torch.from_numpy(stats["var"]))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    yt, ys = ours(xt), stock(xt)
    assert torch.equal(yt, ys) and torch.equal(ours.running_mean, stock.running_mean)
    assert int(ours.num_batches_tracked) == 1
    np.testing.assert_allclose(yt.detach().permute(0, 2, 3, 1).numpy(), np.asarray(yj), atol=1e-5)
    np.testing.assert_allclose(ours.running_mean.numpy(), np.asarray(new["batch_stats"]["mean"]), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(ours.running_var.numpy(), np.asarray(new["batch_stats"]["var"]), rtol=1e-6, atol=1e-7)
    # the stock layer is off by momentum * var / (n - 1): visible at n = 100
    assert np.abs(stock.running_var.numpy() - np.asarray(new["batch_stats"]["var"])).max() > 1e-3
    # eval mode is nn.BatchNorm2d's, bit for bit
    stock.load_state_dict(ours.state_dict())
    assert torch.equal(ours.eval()(xt), stock.eval()(xt))
    assert list(ours.state_dict()) == list(stock.state_dict())


def test_clip_by_global_norm_is_optax(rng):
    grads = [rng.normal(0, 1, s).astype(np.float32) for s in ((7, 5), (11,), (3, 2, 2))]
    for max_norm in (0.5, 1e3):  # clipping, and not
        want, _ = optax.clip_by_global_norm(max_norm).update([jnp.asarray(g) for g in grads], optax.EmptyState())
        got = [torch.from_numpy(g.copy()) for g in grads]
        clip_by_global_norm_(got, max_norm)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=0)
    assert np.array_equal(got[0].numpy(), grads[0])  # below the threshold: untouched


def test_step_with_grad_clip_matches_optax_chain(world):
    """grad_clip_norm 1e-2 is well under this step's gradient norm, so the clip acts."""
    mt, clip = "s1", 1e-2
    jm, v, _ = world["models"][mt]
    opt = optax.chain(optax.clip_by_global_norm(clip), optax.adam(LR))
    js = _jax_state(jax.tree.map(jnp.asarray, v), opt)
    js, _ = j_make_train_step(jm, opt, world["jassets"], JLossConfig(), mt)(
        js, {k: jnp.asarray(x) for k, x in world["batch"].items()}, KEYS[0], jnp.float32(FCA), jnp.float32(F_SCENE))
    ts = _port_state(world, mt)
    make_train_step(world["tassets"], LossConfig(), mt, grad_clip_norm=clip)(
        ts, torch_batch(world["batch"]), FCA, F_SCENE, eps=jax_noise(mt, KEYS[0]))
    norm = float(torch.sqrt(sum((p.grad ** 2).sum() for p in ts.model.parameters())))
    np.testing.assert_allclose(norm, clip, rtol=1e-5)  # the stored gradients are the clipped ones
    _assert_params_close(cvae_s1_to_jax(ts.model)["params"], jax.device_get(js.params))


@pytest.mark.parametrize("mt", ["s1", "s2"])
def test_chunked_epoch_step_equals_the_per_step_loop(world, mt):
    """Three batches as one staged chunk, as 2 + 1, and one at a time: the
    same steps and the same noise sequence, so equal bits."""
    from psi_tpu_torch.data.synthetic import SyntheticBatchGenerator

    gen = SyntheticBatchGenerator(num_scenes=3, batches_per_epoch=3, seed=3, image_size=32)
    batches = [gen.next_batch(4) for _ in range(3)]
    step = make_train_step(world["tassets"], LossConfig(), mt)
    epoch = make_epoch_step(world["tassets"], LossConfig(), mt)

    def run(groups):
        ts = _port_state(world, mt)
        losses = []
        for group in groups:
            if isinstance(group, list):
                ts, m = epoch(ts, _stage_chunk(group, False, "cpu"), FCA, F_SCENE)
                losses += m["loss"].tolist()
            else:
                ts, m = step(ts, {k: torch.from_numpy(x) for k, x in group.items()}, FCA, F_SCENE)
                losses.append(float(m["loss"]))
        return ts, losses

    a, la = run(batches)
    b, lb = run([batches])
    c, lc = run([batches[:2], batches[2]])
    assert a.step == b.step == c.step == 3 and la == lb == lc and len(la) == 3
    for (k, x), y, z in zip(a.model.state_dict().items(), b.model.state_dict().values(), c.model.state_dict().values()):
        assert torch.equal(x, y) and torch.equal(x, z), k


def test_stage_chunk_stacks_and_narrows_only_the_snapshots(world):
    group = [world["batch"], world["batch"]]
    staged = _stage_chunk(group, True, "cpu")
    assert staged["xs"].dtype == torch.bfloat16 and staged["xs"].shape == (2, 4, 32, 32, 2)
    assert staged["xh"].dtype == torch.float32 and staged["scene_idx"].shape == (2, 4)
    assert _stage_chunk(group, False, "cpu")["xs"].dtype == torch.float32
