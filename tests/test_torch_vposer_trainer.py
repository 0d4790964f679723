"""psi_tpu_torch's VPoser trainer and AMASS prep against psi_tpu's.

Tiny widths, as tests/test_vposer_trainer.py: VPoser width 32,
``synthetic_smplx(num_verts=60, num_joints=22)``, batch 8. The one-step
comparison runs both trainers from the port's seeded weights (carried to
psi_tpu with ``vposer_to_jax``) on the same batch, with psi_tpu's noise
(``jax.random.normal`` of the step key's first half, computed here) injected
through the port's ``eps`` and psi_tpu's dropout masks (recorded by wrapping
``jax.random.bernoulli``) fed to the port by patching its mask draw.
Tolerances: losses 1e-5 relative; parameters after AdamW, per tensor
||port - psi_tpu|| / ||psi_tpu||, median 1e-6 and largest 1e-4 (psi_tpu's
LBS at full f32 there: see the test); BatchNorm running statistics 1e-6.
Two gloo ranks (``multiprocess_worker``) train one epoch against one rank on
the same data: losses 1e-5 relative, weights within psi_tpu's own
sharded-vs-one bound (tests/test_vposer_trainer.py: atol 5e-5, rtol 5e-4).
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from psi_tpu.body import smplx_model as j_smplx_model
from psi_tpu.body.lbs import lbs as j_lbs
from psi_tpu.body.smplx_model import synthetic_smplx as j_synthetic_smplx
from psi_tpu.data import amass as j_amass
from psi_tpu.train.vposer_trainer import VPoserTrainConfig as JConfig
from psi_tpu.train.vposer_trainer import VPoserTrainer as JTrainer
from psi_tpu_torch.body import smplx_model as t_smplx_model
from psi_tpu_torch.body.lbs import lbs as t_lbs
from psi_tpu_torch.body.smplx_model import synthetic_smplx
from psi_tpu_torch.data import amass
from psi_tpu_torch.nn import layers
from psi_tpu_torch.scripts import multiprocess_worker
from psi_tpu_torch.train.vposer_trainer import VPoserTrainConfig, VPoserTrainer
from psi_tpu_torch.utils.convert_jax import vposer_to_jax
from psi_tpu_torch.utils.convert_torch import load_vposer
from psi_tpu_torch.utils.tools import EarlyStopping, copy2cpu

torch.set_num_threads(1)
B = 8
CFG = dict(num_neurons=32, batch_size=B, num_epochs=3, base_lr=1e-3, num_joints=21)
BM = dict(num_verts=60, num_joints=22, seed=0)
WORKER_TIMEOUT_S = 240


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("vposer_data")
    amass.make_synthetic_amass(str(d), n_train=64, n_val=32)
    return str(d)


def _port(tmp, data, **kw):
    cfg = VPoserTrainConfig(**dict(CFG, **kw))
    return VPoserTrainer(str(tmp), cfg, data, synthetic_smplx(**BM), device="cpu")


# ---- the AMASS prep


def test_amass_prep_gives_psi_tpus_arrays_and_batch_order(tmp_path):
    rng = np.random.default_rng(0)
    raw = tmp_path / "raw"
    for sub in ("SubA", "SubB"):
        os.makedirs(raw / sub)
        for i in range(2):
            np.savez(raw / sub / f"m{i}.npz", poses=rng.normal(size=(120, 156)).astype(np.float32))
    one = str(raw / "SubA" / "m0.npz")
    np.testing.assert_array_equal(amass.subsample_amass_npz(one, keep_rate=0.5),
                                  j_amass.subsample_amass_npz(one, keep_rate=0.5))
    assert amass.subsample_amass_npz(str(tmp_path / "missing.npz")) is None
    splits = {"train": ["SubA"], "vald": ["SubB"], "test": []}
    counts = amass.prepare_vposer_datasets(str(raw), str(tmp_path / "t"), splits=splits, seed=3)
    assert counts == j_amass.prepare_vposer_datasets(str(raw), str(tmp_path / "j"), splits=splits, seed=3)
    for split in splits:
        t = amass.VPoserDS(str(tmp_path / "t" / split))
        j = j_amass.VPoserDS(str(tmp_path / "j" / split))
        np.testing.assert_array_equal(t.pose, j.pose)
        if len(t):
            np.testing.assert_array_equal(t[0]["pose_aa"], j[0]["pose_aa"])
        for drop_last in (True, False):
            tb = list(t.batches(4, np.random.default_rng(9), drop_last=drop_last))
            jb = list(j.batches(4, np.random.default_rng(9), drop_last=drop_last))
            assert len(tb) == len(jb)
            for a, b in zip(tb, jb):
                np.testing.assert_array_equal(a, b)
    amass.make_synthetic_amass(str(tmp_path / "st"), n_train=20, n_val=6, seed=2)
    j_amass.make_synthetic_amass(str(tmp_path / "sj"), n_train=20, n_val=6, seed=2)
    for split in ("train", "vald", "test"):
        np.testing.assert_array_equal(np.load(tmp_path / "st" / split / "data.npz")["pose"],
                                      np.load(tmp_path / "sj" / split / "data.npz")["pose"])


# ---- one train step against psi_tpu's


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a, np.float64) - np.asarray(b, np.float64))
                 / max(np.linalg.norm(np.asarray(b, np.float64)), 1e-30))


def _jax_step(tmp, data, model, batch, key, epoch, monkeypatch):
    """psi_tpu's jitted train step from the port's weights: (params, batch
    stats, losses, the two dropout masks it drew, encoder's first)."""
    jt = JTrainer(str(tmp), JConfig(**CFG), data, j_synthetic_smplx(**BM))
    jt.variables = jax.tree_util.tree_map(jnp.asarray, vposer_to_jax(model))
    jt.opt_state = jt.optimizer.init(jt.variables["params"])
    masks = {}
    real = jax.random.bernoulli

    def recording(*args, **kw):  # inside the jitted step: the n-th draw of the trace lands in masks[n]
        m = real(*args, **kw)
        jax.debug.callback(lambda v, i=len(masks): masks.__setitem__(i, np.array(v)), m)
        masks.setdefault(len(masks), None)
        return m

    with monkeypatch.context() as m:
        m.setattr(jax.random, "bernoulli", recording)
        params, bs, _, losses = jt._train_step(jt.variables["params"], jt.variables["batch_stats"], jt.opt_state,
                                               jnp.asarray(batch), key, jnp.int32(epoch))
        jax.effects_barrier()
    assert sorted(masks) == [0, 1]
    return jax.device_get(params), jax.device_get(bs), jax.device_get(losses), [masks[0], masks[1]]


def test_one_train_step_matches_psi_tpu(tmp_path, data, monkeypatch):
    """The losses against psi_tpu's step as it is and with its LBS at
    ``exact=True``, the port's LBS patched to ``exact=True`` too (plain
    f32); the parameters after AdamW against psi_tpu's exact=True step:
    'high' backward carries bf16 cotangents, ~1e-3 relative in the
    gradients, and Adam's first update is lr * sign(g), so an entry whose
    gradient sits in that noise moves by 2 lr on one side only."""
    monkeypatch.setattr(t_smplx_model, "lbs", functools.partial(t_lbs, exact=True))
    tt = _port(tmp_path / "t", data)
    batch = next(tt.ds_train.batches(B, np.random.default_rng(1)))
    epoch = 1  # the pose term's gate is open (epochs_completed is raised before train_epoch)
    key = jax.random.PRNGKey(11)
    _, _, jlosses, masks = _jax_step(tmp_path / "j", data, tt.model, batch, key, epoch, monkeypatch)
    monkeypatch.setattr(j_smplx_model, "lbs", functools.partial(j_lbs, exact=True))
    jparams, jbs, jlosses_exact, masks_exact = _jax_step(tmp_path / "x", data, tt.model, batch, key, epoch,
                                                         monkeypatch)
    assert all(np.array_equal(a, b) for a, b in zip(masks, masks_exact))
    _port_step_matches(tt, batch, key, epoch, masks, (jlosses, jlosses_exact), jparams, jbs, monkeypatch)


def test_one_train_step_matches_psi_tpu_high_lbs(tmp_path, data, monkeypatch):
    """Both steps at their 'high' LBS (split-bf16 products, bf16 cotangents
    on both sides): the losses and the parameters after AdamW."""
    tt = _port(tmp_path / "t", data)
    batch = next(tt.ds_train.batches(B, np.random.default_rng(1)))
    epoch, key = 1, jax.random.PRNGKey(11)
    jparams, jbs, jlosses, masks = _jax_step(tmp_path / "j", data, tt.model, batch, key, epoch, monkeypatch)
    _port_step_matches(tt, batch, key, epoch, masks, (jlosses,), jparams, jbs, monkeypatch)


def _port_step_matches(tt, batch, key, epoch, masks, jlosses_all, jparams, jbs, monkeypatch):
    eps = np.array(jax.random.normal(jax.random.split(key)[0], (B, 32)))
    feed = [torch.from_numpy(m) for m in masks]
    monkeypatch.setattr(layers, "dropout_mask", lambda shape, keep, gen, device: feed.pop(0))
    losses = tt._train_step(torch.from_numpy(batch), epoch, eps=torch.from_numpy(eps))
    assert not feed and tt.step_count == 1
    for want in jlosses_all:
        assert set(losses) == set(want)
        for k, v in want.items():
            assert abs(float(losses[k]) - float(v)) <= 1e-5 * abs(float(v)), (k, float(losses[k]), float(v))
    assert float(losses["loss_pose_rec"]) > 0

    got = vposer_to_jax(tt.model)
    rels = {"/".join(str(p) for p in path): _rel(a, b) for (path, a), (_, b) in
            zip(jax.tree_util.tree_leaves_with_path(got["params"]), jax.tree_util.tree_leaves_with_path(jparams))}
    assert np.median(list(rels.values())) <= 1e-6, rels
    assert max(rels.values()) <= 1e-4, rels
    for name, stats in jbs.items():
        for k in ("mean", "var"):
            np.testing.assert_allclose(got["batch_stats"][name][k], stats[k], atol=1e-6, rtol=1e-6)


def test_learning_rate_follows_psi_tpus_schedule(tmp_path, data):
    """num_epochs 7 over 8 steps an epoch: halvings at step counts 16, 32
    and 48, applied when the count reaches them (optax's
    piecewise_constant_schedule over the same boundaries)."""
    tt = _port(tmp_path, data, num_epochs=7)
    assert tt.steps_per_epoch == 8 and tt.boundaries == [16, 32, 48]
    sched = optax.piecewise_constant_schedule(1e-3, {16: 0.5, 32: 0.5, 48: 0.5})
    for count in (0, 15, 16, 17, 31, 32, 47, 48, 100):
        assert abs(tt.lr_at(count) - float(sched(count))) <= 1e-7 * tt.lr_at(count), count  # optax's is float32
    tt.step_count = 16
    tt._train_step(torch.from_numpy(next(tt.ds_train.batches(B, np.random.default_rng(0)))), 1)
    assert tt.optimizer.param_groups[0]["lr"] == 5e-4


# ---- the loop


def test_two_epochs_lower_the_eval_loss_and_the_best_snapshot_reloads(tmp_path, data):
    tt = _port(tmp_path / "w", data)
    e0 = tt.evaluate()
    best = tt.perform_training(2)
    assert np.isfinite(best) and best < e0["loss_total"]
    name = os.path.basename(tt.best_model_fname)
    assert name.startswith("TR00_E") and name.endswith(".pt") and os.path.exists(tt.best_model_fname)
    tt.train_epoch()  # moves the weights off the best snapshot and writes nothing
    tt.load_best()
    assert abs(tt.evaluate()["loss_total"] - best) <= 1e-3 * max(1.0, abs(best))
    vp = load_vposer(str(tmp_path / "w"))  # the newest snapshot: the best one, written last
    tt.model.eval()
    z = torch.from_numpy(np.random.default_rng(0).normal(size=(4, 32)).astype(np.float32))
    with torch.no_grad():
        assert torch.equal(vp.decode_aa(z), tt.model.decode_aa(z))
    assert os.path.exists(tmp_path / "w" / "vposer.log")


def test_early_stopping_and_small_eval_split(tmp_path, data):
    es = EarlyStopping(patience=2)
    assert not es(1.0)
    assert not es(0.5)
    assert not es(0.6)
    assert es(0.7)  # two non-improvements -> stop
    tt = _port(tmp_path, data, batch_size=48)  # vald (32 frames) is under one batch: drop_last empties it
    assert tt.evaluate() == {}
    assert tt.perform_training(1) == np.inf and tt.best_model_fname is None
    tt = _port(tmp_path / "p", data)
    tt.evaluate = lambda split_name="vald": {"loss_total": 1.0}  # no epoch improves on the first
    tt.perform_training(5, patience=2)
    assert tt.epochs_completed == 3 and os.path.basename(tt.best_model_fname) == "TR00_E001.pt"
    assert np.array_equal(copy2cpu(torch.ones(2, requires_grad=True)), np.ones(2, np.float32))


def test_trainer_needs_a_card_unless_told_otherwise(tmp_path, data, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="NVIDIA card"):
        VPoserTrainer(str(tmp_path), VPoserTrainConfig(**CFG), data, synthetic_smplx(**BM))


# ---- two gloo ranks


def test_two_ranks_train_an_epoch_as_one(tmp_path, data):
    out = tmp_path / "mp"
    os.makedirs(out)
    cfg = VPoserTrainConfig(**CFG)
    call = dict(name="vposer", kind="vposer_epochs", cfg=cfg, dataset_dir=data, body_model=synthetic_smplx(**BM),
                work_dir=str(out / "work_r{rank}"), epochs=1)
    torch.save({"calls": [call]}, out / "train_spec.pt")
    ranks = multiprocess_worker.spawn(out, "train", 2, device="cpu", timeout_s=WORKER_TIMEOUT_S, threads=1)
    one = _port(tmp_path / "one", data)
    one.epochs_completed += 1
    want = {"train": one.train_epoch(), "eval": one.evaluate()}
    for r in ranks:
        got = r["vposer"]["epochs"][0]
        for phase in ("train", "eval"):
            for k, v in want[phase].items():
                assert abs(got[phase][k] - v) <= 1e-5 * max(abs(v), 1e-6), (phase, k, got[phase][k], v)
        for k, v in one.model.state_dict().items():
            np.testing.assert_allclose(r["vposer"]["state_dict"][k].numpy(), v.numpy(), atol=5e-5, rtol=5e-4,
                                       err_msg=k)
    assert (out / "work_r0" / "snapshots").exists() is False  # an epoch alone writes no snapshot
    assert (out / "work_r0" / "vposer.log").exists() and not (out / "work_r1").exists()


def test_tools_and_profiling(tmp_path, capsys):
    """utils/tools.py's logger and path maker as psi_tpu's; utils/profiling.py's
    trace writes a Chrome trace holding the span that ``span()`` opened inside it."""
    import json

    from psi_tpu.utils import tools as j_tools
    from psi_tpu_torch.utils import profiling, tools

    log = tools.log2file(str(tmp_path / "a" / "b.log"))
    log("one")
    log("two\n")
    assert open(tmp_path / "a" / "b.log").read() == "one\ntwo\n" and "one\n" in capsys.readouterr().err
    assert tools.makepath(str(tmp_path / "c" / "d.txt"), isfile=True) == str(tmp_path / "c" / "d.txt")
    assert (tmp_path / "c").is_dir() and not (tmp_path / "c" / "d.txt").exists()
    es, jes = tools.EarlyStopping(patience=3, delta=0.1), j_tools.EarlyStopping(patience=3, delta=0.1)
    for v in (1.0, 0.95, 0.8, 0.79, 0.85, 0.7):
        assert es(v) == jes(v) and es.counter == jes.counter
    with profiling.trace(str(tmp_path / "trace")):
        with profiling.span("psi.vposer_step"):
            torch.ones(8).sum()
    events = json.load(open(tmp_path / "trace" / "trace.json"))["traceEvents"]
    step = [e for e in events if e.get("name") == "psi.vposer_step" and e.get("ph") == "X"]
    assert len(step) == 1 and step[0]["dur"] > 0
    inside = [e for e in events if e.get("name") == "aten::sum"]
    assert inside and all(step[0]["ts"] <= e["ts"] <= step[0]["ts"] + step[0]["dur"] for e in inside)
