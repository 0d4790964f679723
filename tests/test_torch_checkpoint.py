"""psi_tpu_torch.train.checkpoint: the round trip, the directory name (the
same string as psi_tpu's), the mtime-newest rule and a weights-only file in
the reference's layout."""

import os

import pytest
import torch

from psi_tpu.train.checkpoint import checkpoint_dir_name as j_checkpoint_dir_name
from psi_tpu_torch.train.checkpoint import checkpoint_dir_name, load_newest_checkpoint, save_checkpoint
from psi_tpu_torch.train.loop import init_state
from psi_tpu_torch.utils.config import TrainConfig

torch.set_num_threads(1)


def _state(model_type="s1", seed=0):
    return init_state(TrainConfig(model_type=model_type, latentD=16, image_size=32, seed=seed), "cpu")


def _take_a_step(state):
    """Some gradient through every parameter, then Adam: nonzero moments."""
    loss = sum((p ** 2).sum() for p in state.model.parameters())
    loss.backward()
    state.optimizer.step()
    state.step += 1
    torch.randn(3, generator=state.generator)  # advance the noise stream


@pytest.mark.parametrize("model_type", ["s1", "s2"])
def test_round_trip_restores_everything(tmp_path, model_type):
    a = _state(model_type)
    _take_a_step(a)
    path = save_checkpoint(str(tmp_path), 7, a)
    assert os.path.basename(path) == "epoch-000007.ckp"
    b = _state(model_type, seed=5)  # other weights, fresh moments, another stream
    restored = load_newest_checkpoint(str(tmp_path), b)
    assert restored["epoch"] == 7 and restored["batches_done"] == 0 and restored["path"] == path
    assert restored["state"] is b and b.step == 1
    for (k, x), y in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        assert torch.equal(x, y), k
    sa, sb = a.optimizer.state_dict()["state"], b.optimizer.state_dict()["state"]
    assert sa.keys() == sb.keys() and len(sa) > 0
    for i in sa:
        assert torch.equal(sa[i]["exp_avg"], sb[i]["exp_avg"]) and torch.equal(sa[i]["exp_avg_sq"], sb[i]["exp_avg_sq"])
    assert torch.equal(torch.randn(4, generator=a.generator), torch.randn(4, generator=b.generator))


def test_mid_epoch_file_name_and_batches_done(tmp_path):
    a = _state()
    path = save_checkpoint(str(tmp_path), 3, a, batches_done=12)
    assert os.path.basename(path) == "epoch-000003-b00012.ckp"
    assert load_newest_checkpoint(str(tmp_path), _state())["batches_done"] == 12


def test_payload_is_the_reference_layout(tmp_path):
    a = _state("s2")
    payload = torch.load(save_checkpoint(str(tmp_path), 1, a), weights_only=True)
    assert {"epoch", "model_h_state_dict", "optimizer_h_state_dict"} <= set(payload)
    assert list(payload["model_h_state_dict"]) == list(a.model.state_dict())
    assert "trans_vae.resnet.0.weight" in payload["model_h_state_dict"]


def test_newest_by_mtime_not_by_name(tmp_path):
    a = _state()
    late, early = save_checkpoint(str(tmp_path), 9, a), save_checkpoint(str(tmp_path), 2, a)
    os.utime(late, (1_000_000, 1_000_000))
    os.utime(early, (2_000_000, 2_000_000))
    assert load_newest_checkpoint(str(tmp_path), _state())["epoch"] == 2


def test_no_checkpoint_gives_none(tmp_path):
    assert load_newest_checkpoint(str(tmp_path), _state()) is None
    assert load_newest_checkpoint(str(tmp_path / "absent"), _state()) is None


def test_weights_only_reference_file_resumes_with_fresh_adam(tmp_path):
    """A reference checkpoint carried over holds only the weights and the
    epoch: the moments, the step count and the generator stay fresh."""
    a = _state(seed=3)
    torch.save({"epoch": 4, "model_h_state_dict": a.model.state_dict()}, str(tmp_path / "epoch-000004.ckp"))
    b = _state()
    before = torch.Generator().set_state(b.generator.get_state())
    restored = load_newest_checkpoint(str(tmp_path), b)
    assert restored["epoch"] == 4 and restored["batches_done"] == 0 and b.step == 0
    assert all(torch.equal(x, y) for x, y in zip(a.model.state_dict().values(), b.model.state_dict().values()))
    assert b.optimizer.state_dict()["state"] == {}
    assert torch.equal(torch.randn(4, generator=before), torch.randn(4, generator=b.generator))


def test_dir_name_is_psi_tpus_string():
    args = ("ckpts", "s1", 32, 30, 0.0003, 0.001, 0.1, 0.01, 0.1)
    assert checkpoint_dir_name(*args) == j_checkpoint_dir_name(*args)
    assert checkpoint_dir_name(*args, prefix="x") == j_checkpoint_dir_name(*args, prefix="x")
    assert "modelS1_batch32_epoch30_LR0.0003" in checkpoint_dir_name(*args)
    assert "modelS2" in checkpoint_dir_name("c", "s2", 8, 1, 0.1, 1, 1, 1, 1)


def _reference_file(tmp_path, optimizer_state):
    """A checkpoint in the reference's own layout, built as
    tests/test_reference_ckpt.py builds one: the reference module's
    state_dict, the epoch, and the reference optimizer's state."""
    from tests.test_convert_full_model import _TorchCVAES1

    tm = _TorchCVAES1(latentD=16)
    opt = torch.optim.Adam(tm.parameters(), lr=1e-3)
    if optimizer_state == "adam":  # one step: moments indexed by the reference module's parameter order
        sum((p ** 2).sum() for p in tm.parameters()).backward()
        opt.step()
    payload = {"epoch": 12, "model_h_state_dict": tm.state_dict(),
               "optimizer_h_state_dict": opt.state_dict() if optimizer_state == "adam" else {}}
    torch.save(payload, str(tmp_path / "epoch-000012.ckp"))
    return tm


@pytest.mark.parametrize("optimizer_state", ["empty", "adam"])
def test_reference_layout_file_loads_weights_and_epoch_only(tmp_path, optimizer_state):
    """psi_tpu/train/checkpoint.py:70-79: a reference checkpoint resumes with
    its weights and epoch; its torch Adam moments are dropped, not loaded by
    position, and the step count and the noise stream stay fresh."""
    tm = _reference_file(tmp_path, optimizer_state)
    b = init_state(TrainConfig(model_type="s1", latentD=16), "cpu")  # the reference module's 128 x 128 input
    before = torch.Generator().set_state(b.generator.get_state())
    restored = load_newest_checkpoint(str(tmp_path), b)
    assert restored["epoch"] == 12 and restored["batches_done"] == 0 and b.step == 0
    ref = tm.state_dict()
    assert all(torch.equal(ref[k], v) for k, v in b.model.state_dict().items())
    assert b.optimizer.state_dict()["state"] == {}
    assert torch.equal(torch.randn(4, generator=before), torch.randn(4, generator=b.generator))


def test_port_file_is_told_apart_from_a_reference_file(tmp_path):
    """A file save_checkpoint wrote carries the step and the generator's
    state and resumes with its moments; a reference-layout file has neither."""
    from psi_tpu_torch.train.checkpoint import is_port_checkpoint

    a = _state()
    _take_a_step(a)
    port = torch.load(save_checkpoint(str(tmp_path / "port"), 2, a), weights_only=True)
    _reference_file(tmp_path, "adam")
    ref = torch.load(str(tmp_path / "epoch-000012.ckp"), weights_only=True)
    assert is_port_checkpoint(port) and not is_port_checkpoint(ref)
    b = _state(seed=4)
    load_newest_checkpoint(str(tmp_path / "port"), b)
    sa, sb = a.optimizer.state_dict()["state"], b.optimizer.state_dict()["state"]
    assert len(sb) == len(sa) > 0 and all(torch.equal(sa[i]["exp_avg"], sb[i]["exp_avg"]) for i in sa)
    assert b.step == 1
