"""Data-parallel training over two processes: psi_tpu_torch's
``make_train_step(mesh=)`` and ``TrainOP(mesh=)`` on two gloo ranks on the
CPU against one rank, on the same weights, batches and noise, and
``cli.train --num_devices``.

World: ``tests/test_torch_train_objective.py``'s (128 vertices, 12 joints, 3
scenes, 16^3 SDF, 300 scene points, latentD 32, batch 4 of 32 x 32
snapshots, 's1', gates open), so each rank trains on 2 rows. The ranks are
``psi_tpu_torch/scripts/multiprocess_worker.py`` processes joined through a
file store under the test's tmp_path, one torch thread each, and joined
under WORKER_TIMEOUT_S (a hung or failed rank fails the test).

Tolerances (tests/test_multichip.py's, for the same sharded-vs-one
comparison): the first step's loss within 1e-5 relative; each gradient
within 5e-3 of its norm (:92); after two Adam steps every weight within
2.5 lr x 2 and their mean within 0.05 lr (:128-134). BatchNorm's running
statistics: the ranks' E[x^2] - mean^2 against torch's variance of one
batch, 1e-5 absolute and relative. The collision case: the term within 1e-5
relative, each gradient within 5e-3 of its norm (the per-rank-mean average
it guards against is off by 0.5 in both).

The ranks and the one-rank reference decode the bodies at
``lbs(exact=True)``, plain f32 (``exact_lbs``; the ranks get it from a
``sitecustomize`` on their PYTHONPATH). At the default 'high' tier the
cotangents are rounded to bf16 as in psi_tpu, so a gradient entry at noise
level takes either sign with the last bits of the forward, which the ranks'
half batches move; Adam's first update turns that into 2 lr on one weight
(measured: one weight of resnet.4.0.conv2, its BatchNorm's running mean
1.9e-5 apart after the second step). What these tests hold is the
sharding, at the arithmetic that does not amplify last bits.
"""

import dataclasses
import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from psi_tpu_torch.body import smplx_model as t_smplx_model
from psi_tpu_torch.body.lbs import lbs as t_lbs
from psi_tpu_torch.cli import train as cli_train
from psi_tpu_torch.data.synthetic import SyntheticBatchGenerator
from psi_tpu_torch.scripts import multiprocess_worker
from psi_tpu_torch.train import objective
from psi_tpu_torch.train.loop import init_state, make_train_step
from psi_tpu_torch.utils.config import LossConfig, TrainConfig
from test_torch_train_objective import B, IMAGE, LATENT, SCENES, make_world

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER_TIMEOUT_S = 240
CFG = TrainConfig(model_type="s1", latentD=LATENT, image_size=IMAGE, batch_size=B, verbose=False)
LR = CFG.init_lr_h
COLLISION_ONLY = LossConfig(weight_loss_rec_h=0.0, weight_loss_vposer=0.0, weight_loss_kl=0.0, weight_contact=0.0,
                            weight_collision=1.0)


EXACT_LBS_SITE = """import functools
from psi_tpu_torch.body import lbs, smplx_model
smplx_model.lbs = functools.partial(lbs.lbs, exact=True)
"""


@pytest.fixture(scope="module", autouse=True)
def exact_lbs(tmp_path_factory):
    """lbs(exact=True) here and in every rank this module starts (module docstring)."""
    site = tmp_path_factory.mktemp("site")
    (site / "sitecustomize.py").write_text(EXACT_LBS_SITE)
    with pytest.MonkeyPatch.context() as m:
        m.setattr(t_smplx_model, "lbs", functools.partial(t_lbs, exact=True))
        m.setenv("PYTHONPATH", os.pathsep.join(filter(None, [str(site), os.environ.get("PYTHONPATH")])))
        yield


@pytest.fixture(scope="module")
def world():
    w = make_world()
    rng = np.random.default_rng(5)
    w["eps"] = [torch.from_numpy(rng.normal(0, 1, (B, 32)).astype(np.float32)) for _ in range(2)]
    b2 = SyntheticBatchGenerator(num_scenes=SCENES, batches_per_epoch=1, seed=1, image_size=IMAGE).next_batch(B)
    b2["cam_ext"] = w["batch"]["cam_ext"]
    w["batches"] = [w["batch"], b2]
    # rank 0's rows (0, 1) lifted 100 m, out of every scene's grid, where the
    # clamped lookup reads the positive top border: no vertex of them penetrates
    lifted = {k: np.array(v) for k, v in w["batch"].items()}
    lifted["cam_ext"][: B // 2, 1, 3] += 100.0
    w["lifted"] = lifted
    w["state_dict"] = w["models"]["s1"][2]().state_dict()
    return w


def _one_rank(world, loss_cfg, batches, eps):
    """The unsharded steps: (metrics per step, first step's gradients, model)."""
    state = init_state(CFG, "cpu")
    state.model.load_state_dict(world["state_dict"])
    step = make_train_step(world["tassets"], loss_cfg, "s1")
    metrics, grads = [], None
    for b, e in zip(batches, eps):
        state, m = step(state, {k: torch.from_numpy(np.array(v)) for k, v in b.items()}, 1.0, 1.0, eps=e)
        metrics.append(m)
        if grads is None:
            grads = {n: p.grad.clone() for n, p in state.model.named_parameters()}
    return metrics, grads, state.model


@pytest.fixture(scope="module")
def sharded(world, tmp_path_factory):
    out = tmp_path_factory.mktemp("mp_train")
    common = dict(kind="train_steps", train_cfg=CFG, assets=world["tassets"], state_dict=world["state_dict"])
    calls = [
        dict(name="steps", loss_cfg=LossConfig(), batches=world["batches"], eps=world["eps"], **common),
        dict(name="collision", loss_cfg=COLLISION_ONLY, batches=[world["lifted"]], eps=world["eps"][:1], **common),
        dict(name="trainop", kind="trainop", assets=world["tassets"], loss_cfg=LossConfig(),
             train_cfg=dataclasses.replace(CFG, epoch=1, saving_per_epochs=1, save_dir=str(out / "ckpt_r{rank}")),
             batch_gen=dict(num_scenes=SCENES, batches_per_epoch=2, seed=0, image_size=IMAGE)),
    ]
    torch.save({"calls": calls}, out / "train_spec.pt")
    return out, multiprocess_worker.spawn(out, "train", 2, device="cpu", timeout_s=WORKER_TIMEOUT_S, threads=1)


def _rel(a, b):
    return float(torch.linalg.vector_norm((a - b).double()) / (torch.linalg.vector_norm(b.double()) + 1e-12))


def test_gradients_and_two_adam_steps_match_one_rank(world, sharded):
    metrics, grads, model = _one_rank(world, LossConfig(), world["batches"], world["eps"])
    for r in sharded[1]:
        got = r["steps"]
        torch.testing.assert_close(got["metrics"][0]["loss"], metrics[0]["loss"], rtol=1e-5, atol=0)
        assert set(got["grads"]) == set(grads)
        for n, g in grads.items():
            assert _rel(got["grads"][n], g) < 5e-3, n
        params = dict(model.named_parameters())
        for n, p in params.items():
            d = (got["state_dict"][n] - p.detach()).abs()
            assert d.max() < 2.5 * LR * 2, (n, d.max())
            assert d.mean() < 0.05 * LR, (n, d.mean())


def test_batchnorm_running_statistics_match_one_rank(world, sharded):
    _, _, model = _one_rank(world, LossConfig(), world["batches"], world["eps"])
    buffers = dict(model.named_buffers())
    stats = [n for n in buffers if n.endswith(("running_mean", "running_var"))]
    assert stats
    for r in sharded[1]:
        for n in stats:
            torch.testing.assert_close(r["steps"]["state_dict"][n], buffers[n], rtol=1e-5, atol=1e-5, msg=n)
            assert not torch.equal(buffers[n], torch.zeros_like(buffers[n]) if "mean" in n else
                                   torch.ones_like(buffers[n])), f"{n} did not move"


def test_collision_over_the_whole_batch_when_one_rank_has_none(world, sharded, monkeypatch):
    """Every penetrating vertex sits in rank 1's rows. The collision term is a
    mean over the whole batch's penetrating vertices: averaging the ranks' own
    means would halve it, and its gradient, which this test catches."""
    seen = []
    real = objective.collision_loss
    monkeypatch.setattr(objective, "collision_loss", lambda sdf, mesh=None: seen.append(sdf.detach()) or real(sdf, mesh))
    metrics, grads, _ = _one_rank(world, COLLISION_ONLY, [world["lifted"]], world["eps"][:1])
    (sdf,) = seen
    assert int((sdf[: B // 2] < 0).sum()) == 0 and int((sdf[B // 2:] < 0).sum()) > 0
    assert float(metrics[0]["collision"]) > 0
    for r in sharded[1]:
        got = r["collision"]
        torch.testing.assert_close(got["metrics"][0]["collision"], metrics[0]["collision"], rtol=1e-5, atol=0)
        moved = [n for n, g in grads.items() if float(g.abs().max()) > 0]
        assert moved
        for n in moved:
            assert _rel(got["grads"][n], grads[n]) < 5e-3, n


def test_only_rank_0_writes_checkpoints_and_metrics(sharded):
    out, ranks = sharded
    rows = [json.loads(line) for line in open(out / "ckpt_r0" / "metrics.jsonl")]
    assert len(rows) == 2 and all(np.isfinite(v) for row in rows for v in row.values())
    assert (out / "ckpt_r0" / "epoch-000001.ckp").exists()
    assert not (out / "ckpt_r1").exists()
    for k, v in ranks[0]["trainop"]["state_dict"].items():  # the two ranks hold one model
        assert torch.equal(v, ranks[1]["trainop"]["state_dict"][k]), k


def test_cli_train_on_two_cpu_ranks(tmp_path):
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    r = subprocess.run(
        [sys.executable, "-m", "psi_tpu_torch.cli.train", "--num_devices", "2", "--device", "cpu", "--synthetic",
         "--latentD", "32", "--batch_size", "2", "--num_epoch", "1", "--synthetic_batches", "2",
         "--save_dir", str(tmp_path)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=WORKER_TIMEOUT_S)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    rows = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    assert len(rows) == 2 and all(np.isfinite(row["loss"]) for row in rows)


def test_more_ranks_than_cards_raises():
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    ask = max(2, have + 1)
    with pytest.raises(SystemExit, match=f"--num_devices {ask} asks for {ask} NVIDIA cards, {have} present"):
        cli_train.main(["--num_devices", str(ask), "--synthetic"])
