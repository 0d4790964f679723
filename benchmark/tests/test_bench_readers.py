"""The generate+fit cells' per-layer readers on hand-built traces of three
calls: the strict-f32 products' device time (``device_ms.f32_products.genfit``)
counts its kernel family alone, per traced call, and reads the same whether
the fit replays its CUDA graph or runs eagerly; every metric each genfit cell
lists reads something on replayed calls, the eager phases' idle shares 0 and
the host's time a pass from the replay; ``s1_fit_prod`` lists no reader of
K4/K5; and the fused vertex path's share of its bound is a finite share."""

import json
import math
from types import SimpleNamespace

import pytest
import torch

from benchmark.run import BENCH_DIR, Context, Run, cell_metrics, load_reader
from benchmark.tests.helpers import ROOT, bench
from benchmark.trace import Tracer, TraceView, busy_ns

F32 = "device_ms.f32_products.genfit"
# kernel names as the profiler gave them on the card (traced runs of both genfit cells)
GEMV_ARGS = ("cublasGemvParamsEx<int, cublasGemvTensorStridedBatched<float const>, cublasGemvTensorStridedBatched"
             "<float const>, cublasGemvTensorStridedBatched<float>, float>")
F32_KERNELS = [
    "sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize32x32x8_stage3_warpsize1x2x1_ffma_aligna4_alignc4_execute_kernel"
    "__5x_cublas",
    "sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize64x32x8_stage3_warpsize1x2x1_ffma_aligna4_alignc4_execute_split_k"
    "_kernel__5x_cublas",
    "void cutlass::Kernel2<cutlass_80_simt_sgemm_64x64_8x5_nn_align1>(cutlass_80_simt_sgemm_64x64_8x5_nn_align1::Params)",
    "void sgemm_largek_lds64<true, false, 5, 5, 4, 4, 4, 34>(float*, float const*, float const*, int, int, int, int, "
    "int, int, float const*, float const*, float, float, int, int, int*, int*)",
    f"void gemv2N_kernel<int, int, float, float, float, float, 128, 2, 4, 4, 1, false, {GEMV_ARGS} >({GEMV_ARGS})",
    "std::enable_if<true, void>::type internal::gemvx::kernel<int, int, float, float, float, float, true, true, true, "
    f"false, 5, false, {GEMV_ARGS} >({GEMV_ARGS})",
    "void cublasLt::splitKreduce_kernel<32, 16, int, float, float, float, float, false, float, float, float, true, "
    "false, false, false>(cublasLt::cublasSplitKParams<float>, float const*, float const*, float*)",
    "void cublasLt::epilogue::impl::globalKernel<8, 32, float, float, float, true, true, 1>(int, int, long, float*, "
    "cublasLtEpilogue_t, int, float*, long, void*, long, long, long, float*, long, int*)",
    "void scal_kernel<float, float, 1, true, 6, 5, 5, 3>(cublasTransposeParams<float>, float const*, float*, "
    "float const*)",
]
PORT_KERNELS = [
    "void (anonymous namespace)::split_wgmma_kernel<1, 64, 1, true>((anonymous namespace)::Lhs, __nv_bfloat16 const*, "
    "(anonymous namespace)::Out, float*)",
    "(anonymous namespace)::split_reduce_kernel(float const*, (anonymous namespace)::Out, (anonymous namespace)::Plan, "
    "long long, long long)",
    "(anonymous namespace)::skin_pack_kernel(__nv_bfloat16 const*, __nv_bfloat16 const*, float const*, "
    "__nv_bfloat16*, __nv_bfloat16*, float*, int, int, int)",
    "void (anonymous namespace)::skin_fwd_kernel<32, 64, 4, 256, 2>(__nv_bfloat16 const*, __nv_bfloat16 const*, "
    "float const*, __nv_bfloat16 const*)",
    "(anonymous namespace)::skin_bwd_coef_kernel(__nv_bfloat16 const*, __nv_bfloat16 const*, float const*)",
    "(anonymous namespace)::splitk_gemm_kernel(__nv_bfloat16 const*, int, unsigned long, __nv_bfloat16 const*, int, "
    "unsigned long, int, int, int, float*, int, unsigned long)",
    "(anonymous namespace)::reduce_tiles_kernel(float const*, float const*, float const*, float*, float*, float*, int)",
    "(anonymous namespace)::nn_argmin_kernel(float const*, float const*, long long*, int, int, int)",
]
OTHER_KERNELS = [
    "void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>, std::array<char*, 3ul> >"
    "(int, at::native::CUDAFunctor_add<float>, std::array<char*, 3ul>)",
    "sm80_xmma_fprop_implicit_gemm_f32f32_f32f32_f32_nchwkcrs_nchw_tilesize32x32x8_stage3_warpsize1x2x1_g1_ffma"
    "_aligna4_alignc4_execute_kernel__5x_cudnn",
    "void convolve_common_engine_float_NHWC<float, float, 1024, 5, 5, 3, 3, 3, true, false, false, false, false>"
    "(int, int, int, float const*, float const*, int, float*, conv_kernel_common_params)",
    "void at::native::vectorized_gather_kernel<16, long>(char*, char*, long*, int, long, long, long, long, bool)",
]
US = 1000  # ns
CALL_US = 20_000
F32_US = 400  # each f32 kernel, once a call
# a call's device work, (name, start, end) in us from its start
COMMON = [(n, 1000 + F32_US * i, 1000 + F32_US * (i + 1)) for i, n in enumerate(F32_KERNELS)]
COMMON += [(PORT_KERNELS[7], 11000, 12000), (OTHER_KERNELS[0], 12000, 15000), (OTHER_KERNELS[1], 15000, 16000),
           (OTHER_KERNELS[2], 16000, 16500), (OTHER_KERNELS[3], 16500, 19000)]
TIER = {"production": [(PORT_KERNELS[2], 5000, 5500), (PORT_KERNELS[3], 5500, 7000), (PORT_KERNELS[4], 7000, 8000),
                       (PORT_KERNELS[5], 8000, 10000), (PORT_KERNELS[6], 10000, 11000)],
        "exact": [(PORT_KERNELS[0], 5000, 9000), (PORT_KERNELS[1], 9000, 11000)]}
PHASES = ["psi.fit.decode", "psi.fit.contact", "psi.fit.collision", "psi.fit.backward", "psi.fit.adam"]
# the readers of the fit's phase spans, which only an eager call opens
PHASE_READERS = [f"idle_pct.{p.rsplit('.', 1)[1]}.genfit" for p in PHASES]


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


def calls(tier="exact", replayed=True, n=3, kernels=True):
    """A TraceView of n generate+fit calls back to back: the sampler's span,
    then either one ``psi.fit.replay`` or an eager pass with its phase spans."""
    ev = []
    for c in range(n):
        o = c * CALL_US
        spans = [("bench.genfit_call", 0, CALL_US - 1), ("psi.sample", 100, 900)]
        if replayed:
            spans.append(("psi.fit.replay", 1000, 1200))
        else:
            spans.append(("psi.fit.pass.full", 1000, 19000))
            spans += [(p, 1000 + 3600 * i, 4600 + 3600 * i) for i, p in enumerate(PHASES)]
        ev += [_Event(name, (o + s) * US, (o + e) * US) for name, s, e in spans]
        if kernels:
            ev += [_Event(name, (o + s) * US, (o + e) * US, device=True) for name, s, e in COMMON + TIER[tier]]
    prof = SimpleNamespace(profiler=SimpleNamespace(kineto_results=SimpleNamespace(events=lambda: ev)))
    return TraceView(prof, 0, n * CALL_US * US)


def context(trace, cell=None, traced_calls=3):
    run = None
    if cell is not None:
        b = bench()
        config = {c["name"]: c for c in b["configs"]}[cell["config"]]
        tr = json.loads((BENCH_DIR / "traffic" / f"{cell['traffic']}.json").read_text())
        run = Run(cell, json.loads((ROOT / config["file"]).read_text()), tr, 1, torch.device("cpu"))
    counters = {"calls": 13, "traced_calls": traced_calls, "rest_units": 10, "rest_s": 4.0, "window_s": 4.1}
    return Context(trace, counters, run)


def genfit_cells():
    out = []
    for w in bench()["workloads"]:
        tr = json.loads((BENCH_DIR / "traffic" / f"{w['traffic']}.json").read_text())
        if tr["generator"] == "genfit":
            out.append(pytest.param(w, tr["tier"], id=w["name"]))
    return out


def test_the_f32_patterns_match_the_family_alone():
    patterns = load_reader(F32).__globals__["PATTERNS"]
    for name in F32_KERNELS:
        assert any(p in name for p in patterns), name
    for name in PORT_KERNELS + OTHER_KERNELS:
        assert not any(p in name for p in patterns), name


@pytest.mark.parametrize("tier", ["exact", "production"])
def test_f32_products_count_their_family_per_traced_call(tier):
    got = load_reader(F32)(context(calls(tier)))
    assert got == pytest.approx(len(F32_KERNELS) * F32_US * US / 1e6)  # a call's f32 kernels, in ms


def test_f32_products_read_nothing_without_device_events_or_calls():
    read = load_reader(F32)
    assert read(context(calls(kernels=False))) is None
    assert read(context(calls(), traced_calls=0)) is None
    assert read(context(None)) is None


def test_f32_products_read_the_same_replayed_or_eager():
    read = load_reader(F32)
    replayed, eager = calls(replayed=True), calls(replayed=False)
    assert not any(n.startswith("psi.fit.pass.") or n in PHASES for _, _, n in replayed.host)
    assert read(context(replayed)) == read(context(eager))


@pytest.mark.parametrize("cell, tier", genfit_cells())
def test_every_metric_of_a_genfit_cell_reads_on_replayed_calls(cell, tier):
    ctx = context(calls(tier), cell)
    for m in cell_metrics(bench(), cell["name"], True):
        v = load_reader(m["name"])(ctx)
        assert v is not None and math.isfinite(v), m["name"]


@pytest.mark.parametrize("name", PHASE_READERS)
def test_a_replayed_fit_leaves_no_idle_time_to_its_phases(name):
    """The host never enters a phase of a replayed fit: its share is 0, the
    eager call's share is its spans', and a trace with neither reads nothing."""
    read = load_reader(name)
    assert read(context(calls(replayed=True))) == 0.0
    eager = read(context(calls(replayed=False)))
    assert eager is not None and eager >= 0
    no_fit = calls(replayed=True)
    no_fit.host = [h for h in no_fit.host if h[2] != "psi.fit.replay"]
    assert read(context(no_fit)) is None
    assert read(context(calls(replayed=True, kernels=False))) is None


def test_host_time_a_pass_of_a_replayed_fit_is_the_replay_over_its_passes():
    cell = {w["name"]: w for w in bench()["workloads"]}["s2_fit_exact"]
    read = load_reader("host_ms_per_pass.genfit")
    num_iter = json.loads((BENCH_DIR / "traffic" / f"{cell['traffic']}.json").read_text())["num_iter"]
    assert read(context(calls(replayed=True), cell)) == pytest.approx(0.2 / num_iter)  # a 200-us replay
    assert read(context(calls(replayed=False), cell)) == pytest.approx(18.0)  # the eager pass's own span
    assert read(context(calls(replayed=True))) is None  # no traffic, so no passes to divide by


def test_the_production_cell_lists_no_reader_of_k4_k5():
    b = bench()
    assert {m["name"] for m in cell_metrics(b, "s1_fit_prod", False)} == {"bodies_per_s", "setup_s"}
    names = [m["name"] for m in cell_metrics(b, "s1_fit_prod", True)]
    assert "roofline_pct.skinning.genfit" in names and F32 in names
    for name in names:
        kernels = load_reader(name).__globals__.get("KERNELS", ())
        assert not any(k in n for k in kernels for n in PORT_KERNELS[:2]), name


def test_skinning_roofline_is_a_finite_share():
    cell = {w["name"]: w for w in bench()["workloads"]}["s1_fit_prod"]
    share = load_reader("roofline_pct.skinning.genfit")(context(calls("production"), cell))
    # 20 x (K1 + K2 bounds, 0.0195 + 0.0265 ms) over the 6,000 us of skin_* and K2's split-K kernels a call
    assert share == pytest.approx(100 * 20 * 0.046 / 6.0, rel=0.02)
    assert 0 < share <= 100
    assert load_reader("roofline_pct.skinning.genfit")(context(calls("exact"), cell)) is None


def test_busy_time_counts_overlaps_once_and_within_the_window():
    # 10-30 and 20-40 overlap (30 ns once), 50-60 alone; 90-120 is cut at the window's end, 0-5 lies before it
    spans = [(20, 40), (10, 30), (50, 60), (90, 120), (0, 5)]
    assert busy_ns(spans, 8, 100) == 30 + 10 + 10
    assert busy_ns([], 0, 100) == 0


def test_the_device_clock_runs_only_on_a_card_and_only_without_a_trace():
    cpu = torch.device("cpu")
    for enabled, clock in ((False, True), (True, True), (False, False)):
        tracer = Tracer(enabled, 1.0, cpu, clock=clock)
        assert tracer.clock is None
        tracer.start()
        tracer.tick(1, force=True)
        assert tracer.device_busy_s is None


def test_steps_a_second_read_the_untraced_rest():
    cell = {w["name"]: w for w in bench()["workloads"]}["s1_train"]
    read = load_reader("steps_per_s.train")
    run = Run(cell, {}, {}, 1, torch.device("cpu"))
    assert read(Context(None, {"rest_units": 600, "rest_s": 40.0}, run)) == pytest.approx(15.0)
    assert read(Context(None, {"rest_units": 0, "rest_s": 0.0}, run)) is None
    assert read(Context(None, {}, run)) is None


def test_the_training_cell_times_the_device_end_to_end():
    b = bench()
    e2e = {m["name"]: m for m in cell_metrics(b, "s1_train", False)}
    assert set(e2e) == {"train_device_ms_per_step", "setup_s"}
    assert e2e["train_device_ms_per_step"]["source"] == "device_trace"
    assert "steps_per_s.train" in {m["name"] for m in cell_metrics(b, "s1_train", True)}
