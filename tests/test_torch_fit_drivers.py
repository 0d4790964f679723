"""The file-driven generate -> fit path: psi_tpu_torch's TestOP, FittingOP,
fit_bodies and make_generate_fit_rows vs psi_tpu's, on
tests/test_torch_train_objective.py's world (128 vertices, 12 joints, 3
scenes, 16^3 SDF, 300 scene points, 32 contact vertices, latentD 32, 32 x 32
snapshots), 7 bodies of one snapshot placed in scene 1's floor.

Pickles cross both ways: psi_tpu's TestOP writes files that the port's
FittingOP fits, and the port's TestOP writes files that psi_tpu's FittingOP
fits. The drivers' fit is the production tier at 4 iterations ('fused':
psi_tpu runs its Pallas kernels in interpret mode, the port their plain
twins, so both round the same operands); psi_tpu compiles it once, in one
FittingOP that every test shares.

Tolerances (tests/test_torch_fit.py's, with its reasons): generated bodies
1e-4 absolute + relative; fitted x72 within max 5e-3 / mean 5e-4 of
psi_tpu's (found max 4.8e-7 through the drivers, 1.5e-4 on the exact
tier of fit_bodies and make_generate_fit_rows); final metrics and the verbose lines' mean loss
1e-3 relative. Keys, dtypes and shapes of records are held exactly. Port
against port: chunked against unchunked 1e-5 (every term is per body; a
matmul may sum in another order at another batch; found equal bits), and
equal bits where the same arrays go through the same calls.
"""

import os
import pickle
import re
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psi_tpu.fit.fitting import FittingOP as JFittingOP
from psi_tpu.fit.fitting import fit_bodies as j_fit_bodies
from psi_tpu.fit.fitting import make_generate_fit_rows as j_make_generate_fit_rows
from psi_tpu.gen.sample import TestOP as JTestOP
from psi_tpu.utils.config import FitConfig as JFitConfig
from psi_tpu_torch.fit.fitting import FittingOP, fit_bodies, make_fit_step, make_generate_fit_rows
from psi_tpu_torch.gen.sample import TestOP, generate_bodies
from psi_tpu_torch.geometry.bodyvec import body_params_parse
from psi_tpu_torch.train.loop import TrainOP
from psi_tpu_torch.utils.config import FitConfig, LossConfig, TrainConfig
from test_torch_fit import DRIFT_MAX, DRIFT_MEAN
from test_torch_train_objective import IMAGE, LATENT, jax_noise, make_world

torch.set_num_threads(1)
N, SCENE, OFFSET = 7, 1, 900
FIT = dict(num_iter=4, refresh_every=3, refresh_warmup=1, prune_scene_points=128)
RECORD = {"transl": 3, "global_orient": 3, "betas": 10, "body_pose": 32, "left_hand_pose": 12, "right_hand_pose": 12}
HABITAT_T = np.diag([1.0, -1.0, -1.0, 1.0]).astype(np.float32)  # the Habitat axis flip a caller passes as cam_post


def _names(n=N, offset=OFFSET):
    return [f"body_gen_{i + offset:06d}.pkl" for i in range(n)]


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def _stack(folder):
    """x72 [n, 72] of a folder's records, in file order."""
    return np.concatenate([body_params_parse(_load(os.path.join(folder, f))).numpy() for f in sorted(os.listdir(folder))])


def _assert_drift(a, b):
    d = np.abs(a - b)
    assert d.max() < DRIFT_MAX and d.mean() < DRIFT_MEAN, (d.max(), d.mean())


@pytest.fixture(scope="module")
def world():
    return make_world(seed=5)


@pytest.fixture(scope="module")
def snapshot(world):
    """One snapshot with extrinsics that drop psi_tpu's sampled bodies into
    scene SCENE's floor, and psi_tpu's TestOP for it."""
    jm, v, _ = world["models"]["s1"]
    b = {k: a[:1] for k, a in world["batch"].items() if k in ("xs", "cam_int", "max_d")}
    jop = JTestOP(jm, v, n_samples=N, seed=3)
    ta = world["tassets"]
    target = 0.5 * (ta.grid_mins[SCENE] + ta.grid_maxs[SCENE]).numpy()
    target[1] = 0.8 * ta.grid_mins[SCENE, 1].item()
    cam = np.eye(4, dtype=np.float32)[None]
    cam[0, :3, 3] = target - np.asarray(jop.generate(b, jax.random.PRNGKey(9)))[:, :3].mean(0)
    b["cam_ext"] = cam
    return b, jop


@pytest.fixture(scope="module")
def ops(world):
    """(psi_tpu's FittingOP, the port's) on the same configuration."""
    return (JFittingOP(world["jassets"], JFitConfig.production(**FIT), SCENE),
            FittingOP(world["tassets"], FitConfig.production(**FIT), SCENE, device="cpu"))


@pytest.fixture(scope="module")
def jax_files(snapshot, tmp_path_factory):
    """A folder of N pickles written by psi_tpu's TestOP, and their arrays."""
    b, jop = snapshot
    root = tmp_path_factory.mktemp("jax_gen")
    assert jop.test(b, str(root), "scene") == N
    folder = os.path.join(str(root), "scene")
    return folder, _stack(folder), np.repeat(b["cam_ext"], N, 0)


@pytest.fixture(scope="module")
def fitted(ops, jax_files):
    """fit_population of both packages on the same arrays."""
    (jop, top), (_, x72, cam) = ops, jax_files
    xj, mj = jop.fit_population(x72, cam)
    xt, mt = top.fit_population(x72, cam)
    return (xj, mj), (xt, mt)


# ---- TestOP

def test_testop_writes_the_reference_layout(world, snapshot, tmp_path):
    b, _ = snapshot
    op = TestOP(world["models"]["s1"][2](), n_samples=5, seed=0, device="cpu")
    assert op.test(b, str(tmp_path), "MPH16", idx_offset=40) == 5
    assert sorted(os.listdir(tmp_path / "MPH16")) == _names(5, 40)
    rec = _load(tmp_path / "MPH16" / "body_gen_000042.pkl")
    assert list(rec) == list(RECORD) + ["cam_ext", "cam_int"]
    for k, w in RECORD.items():
        assert type(rec[k]) is np.ndarray and rec[k].dtype == np.float32 and rec[k].shape == (1, w), k
    np.testing.assert_array_equal(rec["cam_ext"], b["cam_ext"])
    np.testing.assert_array_equal(rec["cam_int"], b["cam_int"])
    assert TestOP(world["models"]["s1"][2](), n_samples=2, device="cpu").test(b, str(tmp_path), "dflt") == 2
    assert sorted(os.listdir(tmp_path / "dflt")) == _names(2)  # the reference's +900


def test_testop_records_have_psi_tpus_keys_dtypes_and_shapes(world, snapshot, jax_files, tmp_path):
    b, _ = snapshot
    TestOP(world["models"]["s1"][2](), n_samples=1, device="cpu").test(b, str(tmp_path), "s")
    ours, theirs = _load(tmp_path / "s" / _names(1)[0]), _load(os.path.join(jax_files[0], _names(1)[0]))
    assert list(ours) == list(theirs)
    for k in ours:
        assert ours[k].dtype == np.asarray(theirs[k]).dtype and ours[k].shape == np.asarray(theirs[k]).shape, k


@pytest.mark.parametrize("mt", ["s1", "s2"])
def test_testop_generates_what_generate_bodies_does(world, snapshot, mt):
    """Either model; injected latents go straight through; the op's own
    generator is seeded, advances from call to call, and a caller's
    generator takes its place."""
    b, _ = snapshot
    tm = world["models"][mt][2]()
    op = TestOP(tm, n_samples=N, seed=4, device="cpu")
    eps = jax_noise(mt, jax.random.PRNGKey(1), n=N)
    want = generate_bodies(tm, torch.from_numpy(b["xs"]), torch.from_numpy(b["cam_int"]), torch.from_numpy(b["max_d"]),
                           N, eps=eps)
    assert torch.equal(op.generate(b, eps=eps), want)
    first, second = op.generate(b), op.generate(b)
    again = TestOP(tm, n_samples=N, seed=4, device="cpu").generate(b)
    assert first.shape == (N, 72) and torch.equal(first, again) and not torch.equal(first, second)
    g = lambda: torch.Generator().manual_seed(11)
    assert torch.equal(op.generate(b, generator=g()), op.generate(b, generator=g()))


def test_testop_matches_jax_on_injected_latents(world, snapshot):
    b, jop = snapshot
    key = jax.random.PRNGKey(2)
    op = TestOP(world["models"]["s1"][2](), n_samples=N, device="cpu")
    np.testing.assert_allclose(op.generate(b, eps=jax_noise("s1", key, n=N)).numpy(), np.asarray(jop.generate(b, key)),
                               atol=1e-4, rtol=1e-4)


def test_testop_from_checkpoint_restores_a_trainops_weights(world, tmp_path):
    from psi_tpu_torch.data.synthetic import SyntheticBatchGenerator

    cfg = TrainConfig(model_type="s1", latentD=LATENT, batch_size=2, epoch=1, image_size=IMAGE,
                      save_dir=str(tmp_path / "ck"), saving_per_epochs=1, verbose=False)
    trainer = TrainOP(cfg, LossConfig(), world["tassets"], device="cpu")
    trainer.train(SyntheticBatchGenerator(num_scenes=3, batches_per_epoch=1, seed=0, image_size=IMAGE))
    fresh = world["models"]["s1"][2]()
    op = TestOP.from_checkpoint(fresh, cfg.save_dir, n_samples=3, seed=1, device="cpu")
    assert op.model is fresh and op.n_samples == 3
    for (k, a), c in zip(op.model.state_dict().items(), trainer.model.state_dict().values()):
        assert torch.equal(a, c), k
    # the training noise stream stays out of generation: the seeded generator decides
    b = {k: v[:1] for k, v in world["batch"].items()}
    same_seed = TestOP(trainer.model, n_samples=3, seed=1, device="cpu")
    assert torch.equal(op.generate(b), same_seed.generate(b))
    os.makedirs(tmp_path / "empty")
    with pytest.raises(FileNotFoundError, match="no epoch-"):
        TestOP.from_checkpoint(fresh, str(tmp_path / "empty"), device="cpu")


def test_drivers_need_a_card_unless_given_the_cpu(world):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="NVIDIA card"):
        TestOP(world["models"]["s1"][2]())
    with pytest.raises(RuntimeError, match="NVIDIA card"):
        FittingOP(world["tassets"], FitConfig.production(**FIT), SCENE)


# ---- fit_bodies and make_generate_fit_rows

def test_fit_bodies_matches_jax_and_make_fit_step(world, jax_files):
    _, x72, cam = jax_files
    sidx = np.full(N, SCENE, np.int32)
    kw = dict(num_iter=3)
    xj, mj, hj = j_fit_bodies(world["jassets"], jnp.asarray(x72), jnp.asarray(cam), jnp.asarray(sidx), JFitConfig.exact(**kw))
    args = torch.from_numpy(x72), torch.from_numpy(cam), torch.from_numpy(sidx)
    xt, mt, ht = fit_bodies(world["tassets"], *args, FitConfig.exact(**kw))
    _assert_drift(xt.numpy(), np.asarray(xj))
    np.testing.assert_allclose(ht.numpy()[0], np.asarray(hj)[0], rtol=1e-4)
    np.testing.assert_allclose(mt["total"].numpy(), np.asarray(mj["total"]), rtol=1e-3)
    # no config: the dataclass defaults, i.e. the exact tier at 20 iterations
    xd, _, hd = fit_bodies(world["tassets"], *args)
    want, _, _ = make_fit_step(world["tassets"], FitConfig())(*args)
    assert hd.shape == (20, N) and torch.equal(xd, want)


@pytest.mark.parametrize("mt", ["s1", "s2"])
def test_generate_fit_rows_matches_jax(world, mt):
    """Three snapshots, seven rows whose req_idx repeats snapshot 2 and skips
    snapshot 1; each row fitted in its own scene."""
    jm, v, build = world["models"][mt]
    xs, cam_int, max_d = (world["batch"][k][:3] for k in ("xs", "cam_int", "max_d"))
    req = np.array([2, 0, 2, 2, 0, 0, 2], np.int32)
    sidx = np.array([0, 1, 2, 0, 1, 2, 0], np.int32)
    cam = np.repeat(np.eye(4, dtype=np.float32)[None], len(req), 0)
    cam[:, :3, 3] = np.random.default_rng(0).normal(0, 0.3, (len(req), 3))
    key = jax.random.PRNGKey(6)
    kw = dict(num_iter=2)
    run_j = j_make_generate_fit_rows(jm, world["jassets"], JFitConfig.exact(**kw))
    xj, mj, hj = run_j(v, *(jnp.asarray(a) for a in (xs, cam_int, max_d, req, cam, sidx)), key)
    tm = build(train=True)  # left in train mode: the run must see eval mode and put the mode back
    run_t = make_generate_fit_rows(tm, world["tassets"], FitConfig.exact(**kw))
    xt, mt_, ht = run_t(*(torch.from_numpy(a) for a in (xs, cam_int, max_d, req, cam, sidx)),
                        eps=jax_noise(mt, key, n=len(req)))
    assert tm.training and xt.shape == (len(req), 72) and ht.shape == (2, len(req))
    np.testing.assert_allclose(ht.numpy()[0], np.asarray(hj)[0], rtol=1e-4)
    _assert_drift(xt.numpy(), np.asarray(xj))
    np.testing.assert_allclose(mt_["total"].numpy(), np.asarray(mj["total"]), rtol=1e-3)
    # a generator in place of eps: reproducible, and want_metrics=False drops the last pass
    quiet = make_generate_fit_rows(tm, world["tassets"], FitConfig.exact(**kw), want_metrics=False)
    outs = [quiet(*(torch.from_numpy(a) for a in (xs, cam_int, max_d, req, cam, sidx)),
                  generator=torch.Generator().manual_seed(s)) for s in (1, 1, 2)]
    assert outs[0][1] is None and torch.equal(outs[0][0], outs[1][0]) and not torch.equal(outs[0][0], outs[2][0])


# ---- FittingOP.fit_population

def test_fit_population_matches_jax(fitted):
    (xj, mj), (xt, mt) = fitted
    assert type(xt) is np.ndarray and xt.dtype == xj.dtype == np.float32 and xt.shape == xj.shape == (N, 72)
    _assert_drift(xt, xj)
    assert set(mt) == set(mj)
    for k in mj:
        assert type(mt[k]) is np.ndarray and mt[k].shape == (N,)
        np.testing.assert_allclose(mt[k], mj[k], rtol=1e-3, atol=2e-5, err_msg=k)


def test_fit_population_chunks_and_pads_without_changing_a_body(world, jax_files, fitted, monkeypatch):
    """max_population=3 on 7 bodies: chunks of 3, 3 and 1 padded to 3 by
    repeating its last row. Every fit call sees exactly 3 bodies."""
    _, x72, cam = jax_files
    op = FittingOP(world["tassets"], FitConfig.production(**FIT), SCENE, max_population=3, device="cpu")
    shapes, inner = [], op._fit

    def spy(x, c, s):
        shapes.append((tuple(x.shape), tuple(c.shape), s.tolist()))
        return inner(x, c, s)

    monkeypatch.setattr(op, "_fit", spy)
    x, m = op.fit_population(x72, cam)
    assert shapes == [((3, 72), (3, 4, 4), [SCENE] * 3)] * 3
    (_, _), (x_whole, m_whole) = fitted
    assert x.shape == (N, 72) and all(v.shape == (N,) for v in m.values())
    np.testing.assert_allclose(x, x_whole, atol=1e-5, rtol=0)
    np.testing.assert_allclose(m["total"], m_whole["total"], rtol=1e-5)


def test_cam_post_is_right_composed_onto_every_cam_ext(world, jax_files):
    """cam_post=T on E gives what no cam_post gives on E @ T: equal bits."""
    _, x72, cam = jax_files
    cfg = FitConfig.production(**FIT)
    with_post = FittingOP(world["tassets"], cfg, SCENE, cam_post=HABITAT_T.reshape(-1), device="cpu")
    plain = FittingOP(world["tassets"], cfg, SCENE, device="cpu")
    xa, ma = with_post.fit_population(x72, cam)
    xb, mb = plain.fit_population(x72, cam @ HABITAT_T)
    xc, _ = plain.fit_population(x72, cam)
    assert np.array_equal(xa, xb) and np.array_equal(ma["total"], mb["total"]) and not np.array_equal(xa, xc)


def test_verbose_prints_one_line_per_iteration_as_psi_tpu_does(ops, jax_files, capsys, monkeypatch):
    (jop, top), (_, x72, cam) = ops, jax_files
    lines = {}
    for name, op in (("jax", jop), ("port", top)):
        monkeypatch.setattr(op, "verbose", True)
        capsys.readouterr()
        op.fit_population(x72, cam)
        lines[name] = capsys.readouterr().out.splitlines()
    pat = re.compile(r"^\[INFO\]\[fitting\] iter=(\d+), mean_total=(\d+\.\d{6})$")
    got = [pat.match(line) for line in lines["port"]]
    assert len(got) == FIT["num_iter"] and all(got) and [int(g.group(1)) for g in got] == list(range(FIT["num_iter"]))
    want = [pat.match(line) for line in lines["jax"]]
    np.testing.assert_allclose([float(g.group(2)) for g in got], [float(g.group(2)) for g in want], rtol=1e-3)
    monkeypatch.setattr(top, "verbose", False)
    top.fit_population(x72, cam)
    assert capsys.readouterr().out == ""


# ---- FittingOP.fitting_files

def _assert_same_records(folder_a, folder_b):
    assert sorted(os.listdir(folder_a)) == sorted(os.listdir(folder_b))
    for f in os.listdir(folder_a):
        a, b = _load(os.path.join(folder_a, f)), _load(os.path.join(folder_b, f))
        assert list(a) == list(b), f
        for k in a:
            assert type(a[k]) is np.ndarray and a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, (f, k)
    _assert_drift(_stack(folder_a), _stack(folder_b))


def test_fitting_files_reads_psi_tpus_pickles_and_writes_what_psi_tpu_writes(ops, jax_files, fitted, tmp_path):
    (jop, top), (gen_dir, _, _) = ops, jax_files
    out_t, out_j = str(tmp_path / "port"), str(tmp_path / "jax")
    assert top.fitting_files(gen_dir, out_t) == N and jop.fitting_files(gen_dir, out_j) == N
    assert sorted(os.listdir(out_t)) == _names()
    _assert_same_records(out_t, out_j)
    np.testing.assert_array_equal(_stack(out_t), fitted[1][0])  # the files hold fit_population's rows
    rec, src = _load(os.path.join(out_t, _names()[3])), _load(os.path.join(gen_dir, _names()[3]))
    assert list(rec) == list(RECORD) + ["cam_ext", "cam_int"]
    np.testing.assert_array_equal(rec["cam_ext"], src["cam_ext"])
    np.testing.assert_array_equal(rec["cam_int"], src["cam_int"])
    # a second call finds every output in place
    assert top.fitting_files(gen_dir, out_t) == 0


def test_psi_tpu_reads_the_ports_pickles(world, snapshot, ops, tmp_path):
    """The other direction: the port's TestOP writes, both FittingOPs fit."""
    (jop, top), (b, _) = ops, snapshot
    assert TestOP(world["models"]["s1"][2](), n_samples=N, seed=8, device="cpu").test(b, str(tmp_path), "gen") == N
    gen_dir = str(tmp_path / "gen")
    assert jop.fitting_files(gen_dir, str(tmp_path / "jax")) == N
    assert top.fitting_files(gen_dir, str(tmp_path / "port")) == N
    _assert_same_records(str(tmp_path / "port"), str(tmp_path / "jax"))


def test_fitting_files_skips_gaps_resumes_and_keeps_row_0_of_a_tiled_cam_ext(world, jax_files, tmp_path):
    """A gap in the numbering, files past max_files, a cam_ext tiled
    [n_samples, 4, 4] as the reference stores it, and a record without
    cam_int (carried over as numpy's object array of None)."""
    gen_dir, x72, cam = jax_files
    mine = tmp_path / "gen"
    shutil.copytree(gen_dir, mine)
    os.remove(mine / _names()[2])
    tiled = _load(mine / _names()[4])
    tiled["cam_ext"] = np.concatenate([tiled["cam_ext"], np.zeros((2, 4, 4), np.float32)])
    del tiled["cam_int"]
    with open(mine / _names()[4], "wb") as f:
        pickle.dump(tiled, f)
    op = FittingOP(world["tassets"], FitConfig.production(**FIT), SCENE, device="cpu")
    out = tmp_path / "fit"
    assert op.fitting_files(str(mine), str(out), max_files=OFFSET + 6) == 5  # 900..905 without 902
    assert sorted(os.listdir(out)) == [n for i, n in enumerate(_names(6)) if i != 2]
    keep = [0, 1, 3, 4, 5]
    want, _ = op.fit_population(x72[keep], cam[keep])
    np.testing.assert_array_equal(_stack(str(out)), want)
    rec = _load(out / _names()[4])
    assert rec["cam_ext"].shape == (3, 4, 4) and rec["cam_int"].dtype == object and rec["cam_int"].shape == ()
    # resume: only what is still missing is fitted
    os.remove(out / _names()[0])
    assert op.fitting_files(str(mine), str(out)) == 2  # 900 again, and 906 now inside max_files
    assert op.fitting_files(str(mine), str(out)) == 0
    assert op.fitting_files(str(tmp_path / "nowhere"), str(out)) == 0
