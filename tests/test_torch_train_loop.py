"""TrainOP end to end on the CPU at tests/test_train.py's sizes: metrics.jsonl,
checkpoints and resume, the mid-epoch resume equal to the uninterrupted run,
the chunked epoch equal to the per-step loop, bf16 staging, and the gates.

These runs compare the port with itself (the noise comes from the port's own
generator, which follows no JAX key stream); the step's agreement with
psi_tpu is held by test_torch_train_step.py. One process, one thread, the
same operations in the same order: resumed and chunked runs are held to
equal bits.
"""

import json
import os

import numpy as np
import pytest
import torch

from psi_tpu_torch.data.synthetic import SyntheticBatchGenerator, make_synthetic_assets
from psi_tpu_torch.gen.sample import generate_bodies
from psi_tpu_torch.train.checkpoint import save_checkpoint
from psi_tpu_torch.train.loop import TrainOP, build_model, init_state
from psi_tpu_torch.utils.config import LossConfig, TrainConfig

torch.set_num_threads(1)
IMAGE = 32


@pytest.fixture(scope="module")
def assets():
    return make_synthetic_assets(num_verts=128, num_joints=12, num_scenes=3, sdf_dim=16, scene_points=300,
                                 n_contact=32)[0]


def _cfg(save_dir, **kw):
    base = dict(model_type="s1", latentD=32, batch_size=4, epoch=1, image_size=IMAGE, save_dir=str(save_dir),
                saving_per_epochs=1, verbose=False)
    base.update(kw)
    return TrainConfig(**base)


def _gen(n, seed=0):
    return SyntheticBatchGenerator(num_scenes=3, batches_per_epoch=n, seed=seed, image_size=IMAGE)


def _rows(cfg):
    with open(os.path.join(cfg.save_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _assert_same_weights(a, b):
    for (k, x), y in zip(a.state.model.state_dict().items(), b.state.model.state_dict().values()):
        assert torch.equal(x, y), k


@pytest.mark.parametrize("model_type", ["s1", "s2"])
def test_trains_logs_checkpoints_and_resumes(assets, tmp_path, model_type):
    cfg = _cfg(tmp_path / "ck", model_type=model_type, epoch=2)
    op = TrainOP(cfg, LossConfig(), assets, device="cpu")
    first = [p.detach().clone() for p in op.model.parameters()]
    last = op.train(_gen(2))
    assert op.state.step == 4 and op.model.training
    assert any(not torch.equal(a, b) for a, b in zip(first, op.model.parameters()))
    assert sorted(f for f in os.listdir(cfg.save_dir) if f.endswith(".ckp")) == ["epoch-000001.ckp", "epoch-000002.ckp"]
    rows = _rows(cfg)
    names = {"epoch", "loss", "rec_t", "rec_p", "vposer", "contact", "collision", "kl"}
    assert len(rows) == 4 and [r["epoch"] for r in rows] == [1, 1, 2, 2]
    assert set(rows[0]) == names | ({"kl_g", "kl_l"} if model_type == "s2" else set())
    assert all(np.isfinite(v) for r in rows for v in r.values())
    assert {k: v for k, v in rows[-1].items() if k != "epoch"} == last
    assert rows[0]["kl"] == 0.0 and rows[2]["kl"] > 0.0  # fca = 0 in epoch 0, 2/3 in epoch 1
    # a fresh TrainOP restores epoch 2 and has nothing left to do
    op2 = TrainOP(cfg, LossConfig(), assets, device="cpu")
    messages = []
    assert op2.train(_gen(2), log_fn=messages.append) == {}
    assert op2.state.step == 4 and "resuming training from" in messages[0] and len(_rows(cfg)) == 4
    _assert_same_weights(op, op2)


def test_gates_open_past_three_quarters_of_the_epochs(assets, tmp_path):
    """Resuming at epoch 7 of 8 (7 > 0.75 * 8) runs with f_scene = 1 and
    fca = 1: contact and collision enter the loss from the first step."""
    cfg = _cfg(tmp_path / "gates", epoch=8, saving_per_epochs=10)
    save_checkpoint(cfg.save_dir, 7, init_state(cfg, "cpu"))
    op = TrainOP(cfg, LossConfig(), assets, device="cpu")
    op.train(_gen(2))
    rows = _rows(cfg)
    assert len(rows) == 2 and all(r["epoch"] == 8 and r["contact"] > 0 and r["kl"] > 0 for r in rows)
    early = _cfg(tmp_path / "early", epoch=8, saving_per_epochs=10, resume_training=False)
    TrainOP(early, LossConfig(), assets, device="cpu").train(_gen(1))
    assert _rows(early)[0]["contact"] == 0.0 and _rows(early)[0]["collision"] == 0.0


def test_no_resume_when_told_not_to(assets, tmp_path):
    cfg = _cfg(tmp_path / "ck", resume_training=False)
    TrainOP(cfg, LossConfig(), assets, device="cpu").train(_gen(1))
    op = TrainOP(cfg, LossConfig(), assets, device="cpu")
    op.train(_gen(1))
    assert op.state.step == 1 and len(_rows(cfg)) == 2  # trained again from scratch, log appended


@pytest.mark.parametrize("chunk", [2, 8])
def test_chunked_epoch_equals_the_per_step_loop(assets, tmp_path, chunk):
    """5 batches: chunks of 2 + a tail of 1, or one short tail (chunk 8):
    every step logged, same metrics and weights as the per-step run."""
    a = TrainOP(_cfg(tmp_path / "chunked", scan_epoch=True, scan_chunk_size=chunk, seed=4), LossConfig(), assets, "cpu")
    b = TrainOP(_cfg(tmp_path / "loop", seed=4), LossConfig(), assets, device="cpu")
    ma, mb = a.train(_gen(5, seed=2)), b.train(_gen(5, seed=2))
    assert ma == mb and _rows(a.cfg) == _rows(b.cfg) and len(_rows(a.cfg)) == 5
    _assert_same_weights(a, b)


@pytest.mark.parametrize("scan_epoch", [True, False])
def test_mid_epoch_resume_equals_the_uninterrupted_run(assets, tmp_path, scan_epoch):
    """saving_per_hours = 0 saves at every chunk or batch boundary. Keeping
    only the checkpoint after batch 2 is what a preemption there leaves; the
    resumed run skips 2 batches, continues the noise stream and ends with
    the uninterrupted run's weights and metrics."""
    kw = dict(seed=7, scan_epoch=scan_epoch, scan_chunk_size=2, saving_per_hours=0.0)
    a = TrainOP(_cfg(tmp_path / "a", **kw), LossConfig(), assets, device="cpu")
    a.train(_gen(6, seed=11))
    assert a.state.step == 6
    cfg_b = _cfg(tmp_path / "b", **kw)
    TrainOP(cfg_b, LossConfig(), assets, device="cpu").train(_gen(6, seed=11))
    kept = "epoch-000000-b00002.ckp"
    names = os.listdir(cfg_b.save_dir)
    assert kept in names, names
    for f in names:
        if f != kept:
            os.remove(os.path.join(cfg_b.save_dir, f))
    r = TrainOP(cfg_b, LossConfig(), assets, device="cpu")
    r.train(_gen(6, seed=11))
    assert r.state.step == 6  # 2 restored + 4 resumed
    _assert_same_weights(a, r)
    assert _rows(cfg_b) == _rows(a.cfg)[2:]


def test_stage_bf16_trains_close_to_f32_staging(assets, tmp_path):
    """Only the snapshots' host -> device format narrows: bf16 keeps about
    three digits of the images, so the loss stays within 5% (psi_tpu's own
    bound in tests/test_train.py) without being equal."""
    kw = dict(seed=9, scan_epoch=True, scan_chunk_size=2)
    ma = TrainOP(_cfg(tmp_path / "bf16", stage_bf16=True, **kw), LossConfig(), assets, "cpu").train(_gen(4, seed=3))
    mb = TrainOP(_cfg(tmp_path / "f32", **kw), LossConfig(), assets, device="cpu").train(_gen(4, seed=3))
    assert np.isfinite(ma["loss"]) and ma["loss"] != mb["loss"]
    np.testing.assert_allclose(ma["loss"], mb["loss"], rtol=0.05)


def test_verbose_line_and_completion_message(assets, tmp_path):
    messages = []
    TrainOP(_cfg(tmp_path / "v", verbose=True), LossConfig(), assets, device="cpu").train(_gen(2), log_fn=messages.append)
    assert sum(m.startswith("---in [epoch 1]: rec_t=") for m in messages) == 2
    assert messages[-1] == "[INFO]: Training completes!"


def test_generation_sees_eval_mode_and_training_mode_survives(assets, tmp_path):
    """TrainOP leaves its model in train mode; generate_bodies runs it in
    eval mode (running statistics, none updated) and puts the mode back."""
    op = TrainOP(_cfg(tmp_path / "g"), LossConfig(), assets, device="cpu")
    op.train(_gen(1))
    b = _gen(1).next_batch(1)
    xs, cam_int, max_d = (torch.from_numpy(b[k]) for k in ("xs", "cam_int", "max_d"))
    stats = [t.clone() for k, t in op.model.state_dict().items() if "running" in k]
    eps = torch.randn((3, 32), generator=torch.Generator().manual_seed(0))
    x = generate_bodies(op.model, xs, cam_int, max_d, 3, eps=eps)
    assert op.model.training and x.shape == (3, 72) and not x.requires_grad
    assert all(torch.equal(a, t) for a, t in zip(stats, (t for k, t in op.model.state_dict().items() if "running" in k)))
    assert torch.equal(x, generate_bodies(op.model.eval(), xs, cam_int, max_d, 3, eps=eps))


def test_needs_a_card_unless_given_the_cpu(assets, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="NVIDIA card"):
        TrainOP(_cfg(tmp_path / "x"), LossConfig(), assets)


def test_build_model_widths_and_unknown_type():
    m = build_model(TrainConfig(model_type="s2", latentD=16, image_size=IMAGE))
    assert m.trans_vae.fc.in_features == 32 * 4 * 4 and m.pose_vae.fc.in_features == 128 * 4 * 4
    assert m.pose_vae.decode[3].out_features == 72
    with pytest.raises(ValueError):
        build_model(TrainConfig(model_type="s3"))
