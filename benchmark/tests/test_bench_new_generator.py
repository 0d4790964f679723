"""A cell of a generator that the harness has never heard of runs from the
generator's module alone: a stub generator, registered under a fresh name
that no file of the benchmark mentions, gives its own toy configuration,
toy traffic and faults, and goes through ``helpers``, ``faults.plant`` and
``benchmark.run.execute`` with no edit to any of them. Its sound run comes
out correct, and each fault makes it not correct.

The stub's program is full-batch Adam on a least-squares fit; its plain
reference takes the same first step from the same start, and the check
compares that step's loss and the parameters' change."""

import sys
import time
import types
import uuid

import pytest
import torch

from benchmark import faults, inputs
from benchmark import run as brun
from benchmark.run import BENCH_DIR
from benchmark.tests import helpers

NAME = "stub_" + uuid.uuid4().hex[:12]
CONFIG = {"rows": 4096, "dim": 256}
TRAFFIC = {"generator": NAME, "lr": 0.01, "trace_seconds": 2.0,
           "limits": {"loss_gap": 1e-6, "change_gap": 1e-5}}


class Program:
    """The stub's system under test."""

    def __init__(self, x: torch.Tensor, y: torch.Tensor, lr: float):
        self.x, self.y = x, y
        self.w = torch.zeros(x.shape[1], requires_grad=True)
        self.opt = torch.optim.Adam([self.w], lr=lr)

    def loss(self, x, y):
        return torch.mean((x @ self.w - y) ** 2)

    def update(self):
        self.opt.step()

    def step(self) -> float:
        self.opt.zero_grad(set_to_none=True)
        total = self.loss(self.x, self.y)
        total.backward()
        self.update()
        return float(total.detach())


def reference_step(x, y, lr):
    """Plain first step from zeros: (its loss, the parameters' change)."""
    w = torch.zeros(x.shape[1], requires_grad=True)
    opt = torch.optim.Adam([w], lr=lr)
    total = ((x @ w - y) ** 2).mean()
    total.backward()
    opt.step()
    return float(total), w.detach().clone()


class Generator:
    def __init__(self, run):
        self.cfg, self.tr, self.seed = run.config, run.traffic, run.seed

    def setup(self):
        g = inputs.generator(self.seed, 1, torch.device("cpu"))
        self.x = torch.randn(self.cfg["rows"], self.cfg["dim"], generator=g)
        self.y = torch.randn(self.cfg["rows"], generator=g)
        self.program = Program(self.x, self.y, self.tr["lr"])

    def window(self, seconds, tracer):
        tracer.start()
        t0 = time.perf_counter()
        steps = 0
        while True:
            loss = self.program.step()
            if steps == 0:
                self.first = (loss, self.program.w.detach().clone())
            steps += 1
            tracer.tick(steps)
            if time.perf_counter() - t0 >= seconds:
                break
        tracer.tick(steps, force=True)
        wall = time.perf_counter() - t0
        return {"stub_steps_per_s": steps / wall}, {"calls": steps, "traced_calls": tracer.units,
                                                    "window_s": wall, **tracer.untraced(steps, t0, t0 + wall)}

    def release(self):
        del self.program

    def check(self):
        ref_loss, ref_change = reference_step(self.x, self.y, self.tr["lr"])
        loss, change = self.first
        return {"loss_gap": abs(loss - ref_loss) / abs(ref_loss),
                "change_gap": float((change - ref_change).norm() / ref_change.norm())}


def toy_config(cfg):
    return dict(cfg, rows=64, dim=8)


def plant(fault):
    if fault == "unchanged_state":
        return faults.patched(Program, "update", lambda self: None)
    if fault == "half_batch":
        inner = Program.loss
        return faults.patched(Program, "loss", lambda self, x, y: inner(self, x[: len(x) // 2], y[: len(y) // 2]))
    if fault == "altered_answer":
        def nudged(self):
            self.opt.step()
            with torch.no_grad():
                self.w[0] += 1e-3

        return faults.patched(Program, "update", nudged)
    raise ValueError(f"unknown fault {fault!r}")


@pytest.fixture
def stub(monkeypatch):
    mod = types.ModuleType(f"benchmark.generators.{NAME}")
    mod.Generator, mod.TOY, mod.toy_config, mod.plant = Generator, {"trace_seconds": 0.5}, toy_config, plant
    monkeypatch.setitem(sys.modules, mod.__name__, mod)
    return mod


def execute():
    cfg = helpers.toy_config(CONFIG, NAME)
    tr = helpers.toy_traffic(TRAFFIC)
    assert (cfg["rows"], cfg["dim"], tr["trace_seconds"]) == (64, 8, 0.5)
    b = {"end_to_end": [{"name": "setup_s", "unit": "s"}], "per_layer": []}
    return brun.execute(b, {"name": "toy", "chips": 1}, cfg, tr, 2**33 + 17, 0.2, False, torch.device("cpu"),
                        time.time())


def test_no_file_of_the_benchmark_names_the_stub():
    for p in BENCH_DIR.rglob("*"):
        if p.is_file() and p.suffix in (".py", ".json"):
            assert NAME not in p.read_text(), p


def test_stub_sound_run_is_correct(stub):
    out = execute()
    assert out["correct"], out["compared"]
    assert out["attempted"] >= 1 and set(out["compared"]) == set(TRAFFIC["limits"])


@pytest.mark.parametrize("fault", faults.NAMES)
def test_stub_fault_is_caught(stub, fault):
    with faults.plant(fault, NAME):
        out = execute()
    assert not out["correct"], out["compared"]
