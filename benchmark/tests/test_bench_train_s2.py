"""Stage 2's training mix (``train_s2_b32`` on ``psi_s2``) at a toy size on
the CPU: the run as it is comes out correct, each fault makes it not
correct, and the plain reference's stage-2 step agrees with ``HumanCVAES2``
driven through ``make_train_step`` on the same weights, batch and latents."""

import time

import pytest
import torch

from benchmark import faults
from benchmark import run as brun
from benchmark.generators import train
from benchmark.reference import train as rtrain
from benchmark.reference.numerics import STATED
from benchmark.tests.helpers import cell_args, traffic

MIX, CONFIG = "train_s2_b32", "psi_s2"
S1_LIMITS = traffic("train_b32")["limits"]


def execute(seconds: float = 1.5):
    cfg, tr = cell_args(CONFIG, MIX)
    b = {"end_to_end": [{"name": "setup_s", "unit": "s"}], "per_layer": []}
    return brun.execute(b, {"name": "toy", "chips": 1}, cfg, tr, 2**33 + 7, seconds, False,
                        torch.device("cpu"), time.time())


def test_s2_sound_run_is_correct():
    out = execute()
    assert out["correct"], out["compared"]


@pytest.mark.parametrize("fault", faults.NAMES)
def test_s2_fault_is_caught(fault):
    with faults.plant(fault, "train"):
        out = execute()
    assert not out["correct"], out["compared"]


@pytest.mark.parametrize("weights", ["random", "training_start"])
def test_s2_reference_first_step_matches_the_program(weights):
    """One step from the seed's weights: the first loss and the gradient of
    every leaf (each parameter's ``.grad``) within ``train_b32``'s limits from
    the spread weights, within the mix's own from a training run's start
    (there the body decode's share of the gradient is larger, and the
    program's 'high' LBS carries its cotangents in bf16); the latents are the
    pair (global, local) of [B, 32]."""
    cfg, tr = cell_args(CONFIG, MIX, checked_steps=1, warmup_steps=1, weights=weights)
    gen = train.Generator(brun.Run({"name": "toy", "chips": 1}, cfg, tr, 2**33 + 29, torch.device("cpu")))
    gen.setup()
    batch, eps, loss = gen.first[0]
    assert isinstance(eps, tuple) and [tuple(e.shape) for e in eps] == [(tr["batch_size"], 32)] * 2
    assert not torch.equal(eps[0], eps[1])
    lc = dict(tr["loss"], fca=tr["fca"], f_scene=tr["f_scene"])
    ref_loss, ref_g, _ = rtrain.train_steps(gen.weights, [gen._batch(batch)], [eps], gen._world(STATED["exact"]),
                                            lc, tr["lr"], STATED["exact"], model_type="s2")
    limits = tr["limits"]
    if weights == "random":
        limits = S1_LIMITS
    assert abs(loss - ref_loss[0]) / abs(ref_loss[0]) <= limits["loss1_gap"], (loss, ref_loss)
    assert set(ref_g) == set(gen.grad1)
    assert train.leaf_gap(gen.grad1, ref_g) <= limits["grad_gap"]
    gen.release()


def test_the_output_bias_is_each_stage_s_decoder_output():
    """The altered-answer fault nudges the output layer's bias: stage 1's
    ``linear_out`` (the leaf it always nudged), stage 2's local decoder's last
    layer."""
    from benchmark import system

    for name, want in (("psi_s1", "linear_out.bias"), ("psi_s2", "pose_vae.decode.3.bias")):
        cfg, _ = cell_args(name, "train_b32")
        model = system._model_on_meta(cfg["model_type"], cfg)
        assert train.output_bias(model) == want


def test_a_leaf_that_overflowed_reads_infinite():
    """A NaN norm on either side, or no leaf kept, reads an infinite gap:
    ``max`` alone would pass over a NaN that does not come first."""
    ok = {"a": torch.ones(3), "b": torch.ones(3)}
    bad = {"a": torch.ones(3), "b": torch.full((3,), float("nan"))}
    assert train.leaf_gap(ok, ok) == 0.0
    assert train.leaf_gap(bad, ok) == float("inf") and train.leaf_gap(ok, bad) == float("inf")
    assert train.leaf_gap(ok, ok, keep=set()) == float("inf")


def test_the_held_gradient_survives_a_large_first_moment():
    """The held step's gradient is read as Adam read it, not worked out from
    its first moment: with every moment scaled up by 1e10 (and the second by
    1e20, so that the updates keep their size) the window's gradient still
    agrees with the reference's, where (m1 - b1 m0) / (1 - b1) keeps none of
    its digits."""
    from benchmark.trace import Tracer

    cfg, tr = cell_args(CONFIG, MIX, weights="random")
    gen = train.Generator(brun.Run({"name": "toy", "chips": 1}, cfg, tr, 2**33 + 31, torch.device("cpu")))
    gen.setup()
    for st in gen.state.optimizer.state.values():
        st["exp_avg"].mul_(1e10)
        st["exp_avg_sq"].mul_(1e20)
    gen.window(0.5, Tracer(False, 0.0, gen.dev))
    gen.release()
    compared = gen.check()
    assert compared["win_grad_gap"] <= S1_LIMITS["win_grad_gap"], compared
