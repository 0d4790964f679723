"""The fit replayed from a CUDA graph (``psi_tpu_torch/fit/fitting.py::_FitProgram``).

On the CPU a test double stands in for ``torch.cuda.CUDAGraph`` and
``torch.cuda.graph``: a capture runs the call once and keeps it, and a replay
runs it again on the static inputs and writes the results into the captured
outputs in place, as a replay overwrites a graph's buffers. With it: which calls
are never graphed (CPU tensors, a mesh), what
tells keys apart (N, a dtype, the ``SceneAssets`` object), eager then capture
then replay, a new key taking the program's one graph slot, a packed plane whose
source changed in place dropping the graph, a capture keeping only the planes it
was served, outputs that never alias the graph's buffers or an earlier call's,
``Kernel.launches`` (a capture records, a replay runs what it recorded), a
capture that fails falling back once, and the benchmark's reader of the
replays.

On the card (``cuda``-marked, skipped without one; ``python -m pytest
--noconftest -m cuda tests/test_torch_fit_graph.py``): three consecutive calls
of ``make_generate_fit_step`` equal in bits to the eager program on the same
inputs, with the same launches of the hand-written kernels a call (counted by
``Kernel.launches`` and seen on the device in a trace), on the exact tier, the
production tier and with the final metrics.
"""

import contextlib
import dataclasses
import sys
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # the benchmark lives at the repo's root

from benchmark.run import Context, load_reader
from benchmark.trace import TraceView
from psi_tpu_torch.data.synthetic import make_synthetic_assets, random_body_batch
from psi_tpu_torch.fit import fitting
from psi_tpu_torch.ops import _cuda
from psi_tpu_torch.ops.precision import PACKS
from psi_tpu_torch.parallel.mesh import Mesh
from psi_tpu_torch.utils.config import FitConfig

N = 4
ASSETS = dict(num_verts=128, num_joints=12, num_scenes=2, sdf_dim=16, scene_points=300, n_contact=32)
EXACT = FitConfig.exact(num_iter=3)


@pytest.fixture(scope="module")
def assets():
    return make_synthetic_assets(**ASSETS)[0]


def inputs(seed, n=N, sidx_dtype=torch.int64):
    rng = np.random.default_rng(seed)
    x72 = torch.from_numpy(random_body_batch(rng, n, np.float32(3.0)))
    cam = torch.eye(4).repeat(n, 1, 1)
    cam[:, :3, 3] = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32) * 0.1)
    return x72, cam, torch.from_numpy(rng.integers(0, 2, n)).to(sidx_dtype)


def tensors(out):
    x72, final, hist = out
    return [x72, hist] + ([] if final is None else [final[k] for k in sorted(final)])


def assert_equal(got, want):
    for g, w in zip(tensors(got), tensors(want), strict=True):
        assert torch.equal(g, w)


class FakeGraph:
    made = []

    def __init__(self):
        self.replay_fn = None
        self.replays = 0
        FakeGraph.made.append(self)

    def replay(self):
        self.replays += 1
        self.replay_fn()


class Card:
    """The test double of the card's graphs around one fit program: every
    tensor counts as the card's, a capture keeps the call, a replay reruns it
    into the captured outputs. ``fail`` makes a capture raise; ``record``
    adds launches to kernels' ``captured`` inside a capture; ``pack`` is a
    source tensor every call has ``PACKS`` pack, as the 'high' tier's decode
    packs posedirs on the card."""

    def __init__(self, monkeypatch, prog, fail=False, record=None, pack=None):
        self.prog, self.captures = prog, 0
        self.eager = prog.run
        state = threading.local()  # a capture records its own thread's launches alone

        @contextlib.contextmanager
        def capture(graph, capture_error_mode="global"):
            assert capture_error_mode == "thread_local"
            state.graph = graph
            self.captures += 1
            try:
                for k, n in (record or {}).items():
                    k.captured += n
                yield
            finally:
                state.graph = None

        def run(assets, *ins):
            graph = getattr(state, "graph", None)
            if graph is not None and fail:
                raise RuntimeError("operation not permitted when stream is capturing")
            if pack is not None:
                PACKS.get(pack, ("test",), lambda: pack.to(torch.bfloat16))
            out = self.eager(assets, *ins)
            if graph is not None:
                def replay():
                    for dst, src in zip(tensors(out), tensors(self.eager(assets, *ins)), strict=True):
                        dst.copy_(src)
                graph.replay_fn = replay
            return out

        prog.run = run
        FakeGraph.made = []
        stream = object()
        monkeypatch.setattr(fitting, "_on_card", lambda t: True)
        monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
        monkeypatch.setattr(torch.cuda, "graph", capture)
        monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: stream)


def stats(prog):
    s = prog.graph_stats()
    return s["eager"], s["captures"], s["replays"], s["failed_captures"]


@pytest.mark.parametrize("case", ["cpu", "mesh"])
def test_never_graphed(monkeypatch, assets, case):
    mesh = None
    if case == "mesh":
        mesh = Mesh(rank=0, size=1, device=torch.device("cpu"), group=None, backend="gloo")
        monkeypatch.setattr(fitting, "gather_rows", lambda x, mesh, dim=0: x)
    prog = fitting._fit_program(EXACT, want_metrics=False, mesh=mesh)
    eager = prog.run
    if case != "cpu":
        Card(monkeypatch, prog)
    for seed in range(3):
        ins = inputs(seed)
        assert_equal(prog(assets, *ins), eager(assets, *ins))
    assert stats(prog) == (3, 0, 0, 0) and not FakeGraph.made and prog.slot is None


@pytest.mark.parametrize("other", ["n", "dtype", "assets"])
def test_keys_differ_by_n_dtype_and_assets(monkeypatch, assets, other):
    prog = fitting._fit_program(EXACT, want_metrics=False)
    card = Card(monkeypatch, prog)
    a = (assets, *inputs(0))
    b = {"n": (assets, *inputs(1, n=6)), "dtype": (assets, *inputs(1, sidx_dtype=torch.int32)),
         "assets": (dataclasses.replace(assets), *inputs(1))}[other]
    prog(*a), prog(*a)
    assert stats(prog) == (1, 1, 1, 0)
    prog(*b)  # another key takes the one slot: seen once, eager
    assert stats(prog) == (2, 1, 1, 0) and prog.graph_stats()["graphs"] == 0
    prog(*b)  # and captures
    assert stats(prog) == (2, 2, 2, 0)
    assert_equal(prog(*a), card.eager(*a))  # the first key's graph went with the slot: eager again
    assert stats(prog) == (3, 2, 2, 0) and card.captures == 2
    assert_equal(prog(*a), card.eager(*a))
    assert stats(prog) == (3, 3, 3, 0) and prog.slot.key[1] == a[1].shape


def test_first_call_eager_second_captures_later_calls_replay(monkeypatch, assets):
    step = fitting.make_fit_step(assets, EXACT, want_metrics=True)
    prog = step.graph_stats.__self__
    card = Card(monkeypatch, prog)
    want = [(1, 0, 0, 0), (1, 1, 1, 0), (1, 1, 2, 0), (1, 1, 3, 0)]
    for seed, w in enumerate(want):
        ins = inputs(seed)
        assert_equal(step(*ins), card.eager(assets, *ins))
        assert stats(prog) == w
    assert len(FakeGraph.made) == 1 and FakeGraph.made[0].replays == 3
    assert prog.graph_stats()["graphs"] == 1


def test_an_in_place_change_of_a_packed_source_drops_the_graph(monkeypatch, assets):
    src = torch.arange(12, dtype=torch.float32)
    prog = fitting._fit_program(EXACT, want_metrics=False)
    card = Card(monkeypatch, prog, pack=src)
    ins = [inputs(seed) for seed in range(6)]
    for i in ins[:3]:
        prog(assets, *i)
    assert stats(prog) == (1, 1, 2, 0) and [v for _, v, _ in prog.slot.packed] == [src._version]
    src.add_(1.0)  # the graph read planes of the old values
    assert_equal(prog(assets, *ins[3]), card.eager(assets, *ins[3]))
    assert stats(prog) == (2, 1, 2, 0) and prog.slot.graph is None
    prog(assets, *ins[4]), prog(assets, *ins[5])  # captured anew, on the repacked planes
    assert stats(prog) == (2, 2, 4, 0)
    ((ref, version, planes),) = prog.slot.packed
    assert ref() is src and version == src._version and torch.equal(planes, src.to(torch.bfloat16))


def test_a_capture_keeps_only_the_planes_it_was_served(monkeypatch, assets):
    src, other = torch.ones(8), torch.zeros(8)
    kept = PACKS.get(other, ("test",), lambda: other.to(torch.bfloat16))  # another program's planes
    prog = fitting._fit_program(EXACT, want_metrics=False)
    Card(monkeypatch, prog, pack=src)
    for seed in range(2):
        prog(assets, *inputs(seed))
    served = [p for _, _, p in prog.slot.packed]
    assert len(served) == 1 and served[0] is PACKS.get(src, ("test",), None)
    assert all(p is not kept for p in served) and all(t is not kept for t in prog.slot.keep)


def test_a_dead_assets_object_never_meets_its_graph(monkeypatch, assets):
    prog = fitting._fit_program(EXACT, want_metrics=False)
    Card(monkeypatch, prog)
    ins = inputs(0)
    prog(assets, *ins), prog(assets, *ins)
    prog.slot.assets = lambda: None  # what a dead SceneAssets whose id a new one took reads as
    prog(assets, *ins)
    assert stats(prog) == (2, 1, 1, 0)
    prog(assets, *ins)
    assert stats(prog) == (2, 2, 2, 0)


def test_outputs_never_alias_the_graph_or_an_earlier_call(monkeypatch, assets):
    prog = fitting._fit_program(EXACT, want_metrics=True)
    card = Card(monkeypatch, prog)
    ins = [inputs(seed) for seed in range(5)]
    outs = [prog(assets, *i) for i in ins]
    static = {t.data_ptr() for t in tensors(prog.slot.static_out) + list(prog.slot.static_in)}
    ptrs = [t.data_ptr() for o in outs for t in tensors(o)]
    assert len(set(ptrs)) == len(ptrs) and not static & set(ptrs)
    for o, i in zip(outs, ins):  # each still holds its own call's results
        assert_equal(o, card.eager(assets, *i))


def test_launches_count_a_replay_and_not_a_capture(monkeypatch, assets):
    monkeypatch.setattr(_cuda, "KERNELS", [])
    k4 = _cuda.Kernel("k4", "psi_split_mm", "csrc", "test")
    k3 = _cuda.Kernel("k3", "psi_nn_argmin", "csrc", "test")
    prog = fitting._fit_program(EXACT, want_metrics=False)
    Card(monkeypatch, prog, record={k4: 40, k3: 20})
    ins = inputs(0)
    prog(assets, *ins)
    assert (k4.launches, k3.launches) == (0, 0)
    prog(assets, *ins)  # the capture records 40 and 20, its replay runs them
    assert (k4.launches, k3.launches, k4.captured, k3.captured) == (40, 20, 40, 20)
    prog(assets, *ins)
    assert (k4.launches, k3.launches, k4.captured) == (80, 40, 40)
    k4.count(3)
    assert k4.launches == 83


@pytest.mark.parametrize("capturing", [False, True], ids=["run", "recorded"])
def test_a_launch_into_a_capture_is_recorded_not_run(monkeypatch, capturing):
    monkeypatch.setattr(_cuda, "KERNELS", [])
    kernel = _cuda.Kernel("stub", "psi_stub", "psi_tpu_torch/csrc/none.cu", "none")
    kernel._entry = lambda *args: 0
    monkeypatch.setattr(torch._C, "_cuda_getDevice", lambda: 0, raising=False)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing)
    for _ in range(3):
        kernel.launch(torch.device("cuda", 0), 7)
    assert (kernel.launches, kernel.captured) == ((0, 3) if capturing else (3, 0))


def test_a_failed_capture_falls_back_to_eager_once(monkeypatch, assets):
    prog = fitting._fit_program(EXACT, want_metrics=False)
    card = Card(monkeypatch, prog, fail=True)
    ins = [inputs(seed) for seed in range(4)]
    prog(assets, *ins[0])
    with pytest.warns(RuntimeWarning, match="capture failed"):
        out = prog(assets, *ins[1])
    assert_equal(out, card.eager(assets, *ins[1]))
    for i in ins[2:]:  # the key stays eager: no second attempt
        assert_equal(prog(assets, *i), card.eager(assets, *i))
    assert stats(prog) == (4, 0, 0, 1) and card.captures == 1 and prog.slot.failed


def test_threads_sharing_a_program_capture_once_and_each_get_their_own_results(monkeypatch, assets):
    prog = fitting._fit_program(EXACT, want_metrics=False)
    card = Card(monkeypatch, prog)
    ins = {seed: inputs(seed) for seed in range(24)}
    want = {seed: card.eager(assets, *i) for seed, i in ins.items()}
    got = {}
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(8) as pool:
            futures = {seed: pool.submit(prog, assets, *i) for seed, i in ins.items()}
            got = {seed: f.result(timeout=120) for seed, f in futures.items()}
    finally:
        sys.setswitchinterval(interval)
    for seed in ins:
        assert_equal(got[seed], want[seed])
    eager, captures, replays, failed = stats(prog)
    assert captures == 1 and card.captures == 1 and failed == 0 and eager + replays == len(ins) and replays >= 1


def test_every_fit_entry_point_reads_its_programs_counts(assets):
    from psi_tpu_torch.models.cvae_s1 import HumanCVAES1

    model = HumanCVAES1(latentD=32, image_size=32)
    for run in (fitting.make_fit_step(assets, EXACT), fitting.make_generate_fit_step(model, assets, EXACT, N),
                fitting.make_generate_fit_rows(model, assets, EXACT)):
        assert run.graph_stats() == {"eager": 0, "captures": 0, "replays": 0, "failed_captures": 0, "graphs": 0}


# ---- the benchmark's reader of the replays, on hand-built traces

class _Event:
    def __init__(self, name, start, end, device=False):
        self._n, self._s, self._d = name, start, end - start
        self._dev = torch.autograd.DeviceType.CUDA if device else torch.autograd.DeviceType.CPU

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return self._dev

    def is_user_annotation(self):
        return self._n.startswith(("bench.", "psi."))


def trace(spans, kernels=((10, 20),)):
    ev = [_Event(f"k{i}", s, e, device=True) for i, (s, e) in enumerate(kernels)]
    ev += [_Event(n, s, e) for n, s, e in spans]
    prof = type("P", (), {"profiler": type("Q", (), {"kineto_results": type("K", (), {"events": lambda _: ev})()})()})
    return TraceView(prof, 0, 1000)


def replay_pct(t):
    return load_reader("graph_replay_pct.genfit")(Context(t, {}, None))


@pytest.mark.parametrize("spans, want", [
    ([("bench.genfit_call", 0, 300), ("psi.fit.replay", 100, 290), ("bench.genfit_call", 300, 600),
      ("psi.fit.replay", 400, 590), ("bench.genfit_call", 600, 900), ("psi.fit.replay", 700, 890)], 100.0),
    ([("bench.genfit_call", 0, 300), ("psi.sample", 10, 90), ("psi.fit.pass.full", 100, 290),
      ("bench.genfit_call", 300, 600), ("psi.fit.replay", 400, 590)], 50.0),
    ([("bench.genfit_call", 0, 300), ("psi.fit.pass.full", 100, 290)], 0.0),
], ids=["all_replayed", "eager_then_replay", "eager"])
def test_graph_replay_share_of_the_traced_calls(spans, want):
    assert replay_pct(trace(spans)) == pytest.approx(want)


def test_graph_replay_share_reads_nothing_without_calls_or_a_device():
    spans = [("bench.genfit_call", 0, 300), ("psi.fit.replay", 100, 290)]
    assert replay_pct(trace(spans, kernels=())) is None
    assert replay_pct(trace([("psi.fit.replay", 100, 290)])) is None


# ---- on the card: the graphed fit against the eager program

CARD_ASSETS = dict(num_verts=10475, num_joints=55, num_scenes=4, sdf_dim=128, scene_points=20000, n_contact=1455)
CARD_N = 256


@pytest.fixture(scope="module")
def card_world():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the fit's CUDA graph and kernels have no CPU mode)")
    from psi_tpu_torch.data.synthetic import SyntheticBatchGenerator
    from psi_tpu_torch.models.cvae_s1 import HumanCVAES1
    from psi_tpu_torch.scripts.profile_fit import floor_placement
    from psi_tpu_torch.utils.init import seeded_init_

    dev = torch.device("cuda", 0)
    worlds = {dt: make_synthetic_assets(**CARD_ASSETS, sdf_dtype=dt, device=dev)[0] for dt in (None, torch.bfloat16)}
    model = seeded_init_(HumanCVAES1(latentD=256, image_size=128), 0).eval().to(dev)
    batch = SyntheticBatchGenerator(num_scenes=4, batches_per_epoch=1, seed=0, image_size=128).next_batch(3)
    calls = []
    for i in range(3):
        snap = tuple(torch.from_numpy(batch[k][i:i + 1]).to(dev) for k in ("xs", "cam_int", "max_d"))
        eps = torch.randn(CARD_N, 32, generator=torch.Generator(device=dev).manual_seed(10 + i), device=dev)
        sidx = torch.full((CARD_N,), i % 4, dtype=torch.int64, device=dev)
        x72 = fitting.generate_bodies(model, *snap, CARD_N, eps=eps)
        g = worlds[None]
        cam = floor_placement(x72, g.grid_mins[i % 4], g.grid_maxs[i % 4])
        calls.append((snap, eps, cam, sidx, x72))
    return dev, worlds, model, calls


HAND_WRITTEN = ("skin_fwd_kernel", "skin_pack_kernel", "skin_bwd_coef_kernel", "splitk_gemm_kernel",
                "reduce_tiles_kernel", "nn_argmin_kernel", "split_wgmma_kernel", "split_reduce_kernel",
                "split_pack_kernel")


def kernel_counts(fn, traced=True):
    """(fn(), ``Kernel.launches`` during it, the hand-written kernels the trace shows on the device by name, or
    None untraced)."""
    from psi_tpu_torch.scripts.profile_fit import device_events

    torch.cuda.synchronize()
    for k in _cuda.KERNELS:
        k.launches = 0
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
                                ) if traced else contextlib.nullcontext() as prof:
        out = fn()
        torch.cuda.synchronize()
    on_device = traced and {e.key: e.count for e in device_events(prof) if any(h in e.key for h in HAND_WRITTEN)}
    return out, {k.name: k.launches for k in _cuda.KERNELS}, on_device


@pytest.mark.cuda
@pytest.mark.parametrize("tier, want_metrics", [("exact", False), ("production", False), ("exact", True)],
                         ids=["exact", "production", "exact_metrics"])
def test_graphed_fit_equals_the_eager_program_in_bits(card_world, tier, want_metrics):
    dev, worlds, model, calls = card_world
    assets = worlds[torch.bfloat16 if tier == "production" else None]
    cfg = getattr(FitConfig, tier)(num_iter=20)
    step = fitting.make_generate_fit_step(model, assets, cfg, CARD_N, want_metrics=want_metrics)
    eager = fitting._fit_program(cfg, want_metrics=want_metrics).run
    eager(assets, *calls[0][-1:], *calls[0][2:4])  # packs K4's and K5's planes, as any first call does
    outs = []
    for i, (snap, eps, cam, sidx, x72) in enumerate(calls):
        traced = i != 1  # the eager first call and a replay; the capturing call untraced
        want, n_want, dev_want = kernel_counts(lambda: eager(assets, x72, cam, sidx), traced)
        got, n_got, dev_got = kernel_counts(lambda: step(*snap, cam, sidx, eps=eps), traced)
        assert_equal(got, want)
        assert n_got == n_want and sum(n_got.values()) > 0, (n_got, n_want)
        assert dev_got == dev_want and (dev_got or not traced), (dev_got, dev_want)  # what ran, from the trace
        outs.append(got)
    assert step.graph_stats() == {"eager": 1, "captures": 1, "replays": 2, "failed_captures": 0, "graphs": 1}
    ptrs = [t.data_ptr() for o in outs for t in tensors(o)]
    assert len(set(ptrs)) == len(ptrs)
    for o, (snap, eps, cam, sidx, x72) in zip(outs, calls):  # later replays left earlier outputs alone
        assert_equal(o, eager(assets, x72, cam, sidx))
