"""Each traffic mix's comparison at a toy size on the CPU: the run as it is comes
out correct, and with the timed path broken underneath (a state left
unchanged, half of the batch left out, an answer altered where it is
produced) it comes out not correct. The chip's own look is skipped; the
rest of the run is the harness's."""

import time

import pytest
import torch

from benchmark import faults
from benchmark import run as brun
from benchmark.tests.helpers import cell_args, mixes

MIXES = mixes()


def execute(mix: str, seconds: float = 1.5):
    cfg, tr = cell_args(MIXES[mix], mix)
    b = {"end_to_end": [{"name": "setup_s", "unit": "s"}], "per_layer": []}
    return brun.execute(b, {"name": "toy", "chips": 1}, cfg, tr, 2**33 + 7, seconds, False,
                        torch.device("cpu"), time.time())


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_sound_run_is_correct(mix):
    out = execute(mix)
    assert out["correct"], out["compared"]
    assert list(out)[-1] == "compared"
    assert set(out) >= {"correct", "attempted", "failed", "metrics", "device"}


@pytest.mark.parametrize("fault", faults.NAMES)
@pytest.mark.parametrize("mix", sorted(MIXES))
def test_fault_is_caught(mix, fault):
    with faults.plant(fault, cell_args(MIXES[mix], mix)[1]["generator"]):
        out = execute(mix)
    assert not out["correct"], out["compared"]



def test_training_check_holds_a_window_step_that_starts_an_epoch():
    """The training check follows one of the window's own steps, from the
    program's state before it: the first that starts a new epoch. Set-up
    ends one step short of an epoch's end, so that step is the window's
    second; the first is held until it comes."""
    from benchmark.generators.train import Generator
    from benchmark.trace import Tracer

    cfg, tr = cell_args("psi_s1", "train_b32")
    tr["warmup_steps"] = tr["samples"] // tr["batch_size"] - 1
    gen = Generator(brun.Run({"name": "toy", "chips": 1}, cfg, tr, 2**33 + 13, torch.device("cpu")))
    gen.setup()
    _, counters = gen.window(1.0, Tracer(False, 0.0, gen.dev))
    assert counters["calls"] >= 2
    assert counters["held_step"] == 1 and counters["held_epoch_start"]
    gen.release()
    compared = gen.check()
    assert all(compared[k] <= lim for k, lim in tr["limits"].items()), compared


def test_a_half_turn_written_the_other_way_moves_no_body():
    """Two fitted populations that differ only in how a rotation near a half
    turn is written (axis-angle r against r - 2 pi r/|r|, the same rotation)
    read no gap in how far each body moved, and a body left unfitted reads 1."""
    from benchmark.generators.genfit import population_gaps

    g = torch.Generator().manual_seed(5)
    x_init = torch.randn(8, 72, generator=g, dtype=torch.float64)
    x_ref = x_init + 0.1 * torch.randn(8, 72, generator=g, dtype=torch.float64)
    axis = torch.nn.functional.normalize(torch.randn(8, 3, generator=g, dtype=torch.float64), dim=1)
    x_ref[:, 3:6] = (torch.pi - 1e-3) * axis
    x_prog = x_ref.clone()
    x_prog[:4, 3:6] = x_ref[:4, 3:6] - 2 * torch.pi * axis[:4]
    assert population_gaps(x_prog, x_ref, x_init)["fit_move_gap"] < 1e-9
    assert population_gaps(x_init, x_ref, x_init)["fit_move_gap"] == pytest.approx(1.0)
