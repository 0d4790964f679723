"""The port's spans (``utils/profiling.py::span``) and the benchmark's readers
of them (``benchmark/spans.py``, ``benchmark/metrics/``).

(a) Off, ``span`` hands back one shared null context. (b) A toy generate+fit
call on the CPU under ``torch.profiler`` opens one ``psi.sample`` and one
``psi.fit.pass.<kind>`` an iteration in ``fit_schedule``'s order, each holding
one decode, contact, collision, backward and Adam span in that order, for the
exact tier and for a production schedule with nn_only and cheap passes.
(c) A toy training step opens one stage, forward, backward and optimizer span.
(d) The readers on a hand-built trace: each phase's idle share, the innermost
span's claim, the host's time a fit pass and a training step, and nothing where
the trace has no device events or the program no spans.
"""

import contextlib
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # the benchmark lives at the repo's root

from benchmark import readers
from benchmark import spans as bspans
from benchmark.run import Context, load_reader
from benchmark.tests.helpers import bench
from benchmark.trace import TraceView
from psi_tpu_torch.data.synthetic import SyntheticBatchGenerator, make_synthetic_assets
from psi_tpu_torch.fit.fitting import fit_schedule, make_generate_fit_step
from psi_tpu_torch.models.cvae_s1 import HumanCVAES1
from psi_tpu_torch.train.loop import _stage_chunk, init_state, make_train_step
from psi_tpu_torch.utils import profiling
from psi_tpu_torch.utils.config import FitConfig, LossConfig, TrainConfig
from psi_tpu_torch.utils.init import seeded_init_

IMAGE, N = 32, 4
ASSETS = dict(num_verts=128, num_joints=12, num_scenes=2, sdf_dim=16, scene_points=300, n_contact=32)
FIT_PHASES = ["psi.fit.decode", "psi.fit.contact", "psi.fit.collision", "psi.fit.backward", "psi.fit.adam"]


def profiled_spans(fn):
    """(start, end, name) of every ``psi.*`` span the call opens, in time order."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                  for e in prof.profiler.kineto_results.events() if e.name().startswith("psi."))


def test_span_is_a_shared_null_context_without_a_profiler():
    assert not torch.autograd._profiler_enabled()
    off = profiling.span("psi.a")
    assert isinstance(off, contextlib.nullcontext) and profiling.span("psi.b") is off
    with off, off:  # reentrant
        pass
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert isinstance(profiling.span("psi.a"), torch.profiler.record_function)


@pytest.fixture(scope="module")
def assets():
    return make_synthetic_assets(**ASSETS)[0]


@pytest.mark.parametrize("cfg", [FitConfig.exact(num_iter=3),
                                 FitConfig.production(num_iter=6, refresh_every=3, refresh_warmup=2)],
                         ids=["exact", "production"])
def test_a_generate_fit_call_opens_its_spans(assets, cfg):
    model = seeded_init_(HumanCVAES1(latentD=32, image_size=IMAGE), 0)
    batch = SyntheticBatchGenerator(num_scenes=2, batches_per_epoch=1, seed=1, image_size=IMAGE).next_batch(1)
    xs, cam_int, max_d = (torch.from_numpy(batch[k]) for k in ("xs", "cam_int", "max_d"))
    cam_ext = torch.eye(4).repeat(N, 1, 1)
    step = make_generate_fit_step(model, assets, cfg, N, want_metrics=False)
    got = profiled_spans(lambda: step(xs, cam_int, max_d, cam_ext, torch.zeros(N, dtype=torch.int64),
                                      generator=torch.Generator().manual_seed(2)))
    kinds = fit_schedule(cfg)
    assert set(kinds) == ({"full"} if cfg.refresh_every == 1 else {"full", "nn_only", "cheap"})
    sample = [sp for sp in got if sp[2] == "psi.sample"]
    passes = [sp for sp in got if sp[2].startswith("psi.fit.pass.")]
    assert len(sample) == 1 and sample[0][1] <= passes[0][0]
    assert [n for _, _, n in passes] == [f"psi.fit.pass.{k}" for k in kinds]
    inner = [sp for sp in got if sp[2] in FIT_PHASES]
    for s, e, _ in passes:
        assert [n for a, b, n in inner if s <= a and b <= e] == FIT_PHASES
    assert len(inner) == len(FIT_PHASES) * len(kinds)  # none outside a pass
    for (_, e0, _), (s1, _, _) in zip(inner, inner[1:]):
        assert e0 <= s1  # siblings, in turn


def test_a_training_step_opens_its_spans(assets):
    cfg = TrainConfig(model_type="s1", latentD=32, batch_size=2, image_size=IMAGE)
    state = init_state(cfg, "cpu")
    step = make_train_step(assets, LossConfig(), "s1")
    b = SyntheticBatchGenerator(num_scenes=2, batches_per_epoch=1, seed=3, image_size=IMAGE).next_batch(2)

    def one():
        staged = {k: v[0] for k, v in _stage_chunk([b], False, "cpu").items()}
        step(state, staged, 1.0, 1.0)

    got = profiled_spans(one)
    assert [n for _, _, n in got] == list(bspans.TRAIN)
    for (_, e0, _), (s1, _, _) in zip(got, got[1:]):
        assert e0 <= s1


# ---- (d) the readers on a hand-built trace

class _Event:
    def __init__(self, name, start, end, device=False, annotation=False):
        self._n, self._s, self._d = name, start, end - start
        self._dev = torch.autograd.DeviceType.CUDA if device else torch.autograd.DeviceType.CPU
        self._ann = annotation

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return self._dev

    def is_user_annotation(self):
        return self._ann


class _Prof:
    def __init__(self, events):
        self.profiler = type("P", (), {"kineto_results": type("K", (), {"events": lambda _: events})()})()


def view(kernels, spans, calls, t0=0, t1=1000):
    """A TraceView over [t0, t1] ns: device kernels (start, end), program
    spans (name, start, end) with their mirrors on the device, and host calls
    (name, start)."""
    ev = [_Event(f"k{i}", s, e, device=True) for i, (s, e) in enumerate(kernels)]
    for n, s, e in spans:
        ev += [_Event(n, s, e, annotation=True), _Event(n, s, e, device=True, annotation=True)]
    ev += [_Event(n, s, s + 5) for n, s in calls]
    return TraceView(_Prof(ev), t0, t1)


KERNELS = [(100, 200), (400, 450), (700, 900)]  # busy 350 of 1000 ns: idle 65%
GENFIT_SPANS = [("psi.sample", 0, 150), ("psi.fit.pass.full", 200, 800), ("psi.fit.decode", 200, 300),
                ("psi.fit.contact", 300, 400), ("psi.fit.collision", 400, 500), ("psi.fit.backward", 500, 700),
                ("psi.fit.adam", 700, 800)]
CALLS = [("cudaMemcpyAsync", 50), ("cudaLaunchKernel", 210), ("cudaLaunchKernelExC_v11060", 450),
         ("cuLaunchKernel", 600), ("cudaLaunchCooperativeKernel", 650), ("cudaStreamSynchronize", 720)]
TRAIN_SPANS = [("psi.train.stage", 0, 100), ("psi.train.forward", 100, 400), ("psi.train.backward", 400, 700),
               ("psi.train.optimizer", 700, 950)]


def read(name, trace):
    return load_reader(name)(Context(trace, {}, None))


def test_idle_shares_and_host_time_a_unit_on_a_known_trace():
    t = view(KERNELS, GENFIT_SPANS, CALLS)
    assert t.launches == 3 and readers.idle_pct(Context(t, {}, None)) == pytest.approx(65.0)
    want = {"sample": 10.0, "decode": 10.0, "contact": 10.0, "collision": 5.0, "backward": 20.0, "adam": 0.0}
    for phase, pct in want.items():
        assert read(f"idle_pct.{phase}.genfit", t) == pytest.approx(pct), phase
    shares = bspans.idle_shares(t, bspans.GENFIT)
    assert shares["outside"] == pytest.approx(10.0)  # [900, 1000]
    assert sum(shares.values()) == pytest.approx(readers.idle_pct(Context(t, {}, None)))
    assert read("host_ms_per_pass.genfit", t) == pytest.approx(600 / 1e6)  # the pass [200, 800] ns

    t = view(KERNELS, TRAIN_SPANS, CALLS)
    want = {"stage": 10.0, "forward": 20.0, "backward": 25.0, "optimizer": 5.0}
    for phase, pct in want.items():
        assert read(f"idle_pct.{phase}.train", t) == pytest.approx(pct), phase
    shares = bspans.idle_shares(t, bspans.TRAIN)
    assert sum(shares.values()) == pytest.approx(65.0) and shares["outside"] == pytest.approx(5.0)
    assert read("host_ms_per_step.train", t) == pytest.approx(850 / 1e6)  # [100, 950]
    # a step the window cuts, and a backward without its forward, are no steps
    cut = TRAIN_SPANS + [("psi.train.backward", 960, 970), ("psi.train.forward", 975, 985),
                         ("psi.train.backward", 985, 995), ("psi.train.optimizer", 995, 1010)]
    assert read("host_ms_per_step.train", view(KERNELS, cut, CALLS)) == pytest.approx(850 / 1e6)


def test_the_innermost_span_takes_the_idle_time():
    """A counted span inside another (a decode inside the backward) and spans cut by the window."""
    spans = GENFIT_SPANS + [("psi.fit.decode", 550, 650)]
    t = view(KERNELS, spans, CALLS, t0=100, t1=1000)
    shares = bspans.idle_shares(t, bspans.GENFIT)
    window = 900
    assert shares["psi.fit.decode"] == pytest.approx(100 * 200 / window)
    assert shares["psi.fit.backward"] == pytest.approx(100 * 100 / window)
    assert shares["psi.sample"] == pytest.approx(0.0)  # [100, 150] is busy
    assert sum(shares.values()) == pytest.approx(100 * (1 - 350 / window))


def test_nothing_to_read_gives_none():
    names = [m["name"] for m in bench()["per_layer"] if m["name"].startswith(("idle_pct.", "host_ms_per_"))]
    assert names
    no_device = view([], GENFIT_SPANS + TRAIN_SPANS, CALLS)
    no_spans = view(KERNELS, [], CALLS)  # a program that opens none
    for name in names:
        assert read(name, no_device) is None and read(name, no_spans) is None, name
    assert readers.idle_pct(Context(no_device, {}, None)) is None
    assert np.isfinite(read("idle_pct.sample.genfit", view(KERNELS, GENFIT_SPANS[:1], [])))


def test_profile_scripts_drop_the_device_mirrors_of_host_spans():
    """``scripts/profile_fit.py::device_events`` (which the profiling scripts
    and the smoke run read) leaves out what ``TraceView`` leaves out: the
    device-side entries named as a span opened on the host, whatever its name."""
    from types import SimpleNamespace

    from psi_tpu_torch.scripts.profile_fit import device_events

    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA

    def entry(key, device, annotation=False):
        return SimpleNamespace(key=key, device_type=device, is_user_annotation=annotation)

    averages = [entry("psi.fit.decode", cpu, True), entry("psi.fit.decode", cuda),
                entry("bench.genfit_call", cpu, True), entry("bench.genfit_call", cuda, True),
                entry("aten::mm", cpu), entry("ampere_sgemm", cuda), entry("Memcpy HtoD", cuda)]
    prof = SimpleNamespace(key_averages=lambda: averages)
    assert [e.key for e in device_events(prof)] == ["ampere_sgemm", "Memcpy HtoD"]
