"""The serving path: psi_tpu_torch.serve (GenerationEngine, ServingQueue,
ServingRouter) against psi_tpu.serve, and the two thread-safety repairs
the path needs (utils.precision.strict_f32, ops._cuda's build and load).

Sizes are tests/test_serve.py's: 100 vertices, 12 joints, 2 scenes, 16^3 SDF,
200 scene points, 32 contact vertices, latentD 32, population 8,
FitConfig(num_iter=2), max_requests 4, 128 x 128 snapshots; everything on
the CPU, one thread. Engines are built once per module.

(a) Port against psi_tpu: the same weights (numpy draws, carried across with
convert_jax), the same numpy snapshots, and psi_tpu's noise: its engine draws
each call's key as split(key)[1] of a chain that starts at PRNGKey(seed), so
the test reads that key before each call and injects the normals it yields
through the port's ``eps``. Tolerances: unfitted bodies 1e-4 absolute + 1e-4
relative, tests/test_torch_gen_sample.py's (the same f32 networks summed in
another order, then 6D -> axis-angle and a metric translation that reaches
~13 m here; found: 3.1e-5 absolute, 1.9e-5 relative, so 1e-5 absolute does
not hold); fitted bodies tests/test_torch_fit.py's bounded drift (max 5e-3,
mean 5e-4: Adam amplifies rounding-level differences).
(b) psi_tpu's own serving tests (tests/test_serve.py), one for one, against
the port's classes; the CLI ones are in tests/test_torch_cli_serve.py.
(c) The repairs, each with a test that fails without it.
"""

import threading
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psi_tpu.data.synthetic import make_synthetic_assets as j_make_synthetic_assets
from psi_tpu.models import HumanCVAES1 as JS1
from psi_tpu.models import HumanCVAES2 as JS2
from psi_tpu.serve import GenerationEngine as JGenerationEngine
from psi_tpu.utils.config import FitConfig as JFitConfig
from psi_tpu_torch.serve import GenerationEngine, ServeResult, ServingQueue, ServingRouter
from psi_tpu_torch.serve import engine as engine_mod
from psi_tpu_torch.utils.config import FitConfig
from psi_tpu_torch.utils.convert_jax import cvae_s1_from_jax, cvae_s2_from_jax
from test_torch_fit import DRIFT_MAX, DRIFT_MEAN
from test_torch_train_objective import jax_noise, numpy_variables, port_assets

torch.set_num_threads(1)
ASSETS = dict(num_verts=100, num_joints=12, num_scenes=2, sdf_dim=16, scene_points=200, n_contact=32)
POPULATION, MAX_REQUESTS, LATENT, IMAGE, SEED = 8, 4, 32, 128, 5
UNFITTED = dict(atol=1e-4, rtol=1e-4)


def _snapshot(depth=6.0):
    """tests/test_serve.py's snapshot."""
    return {
        "xs": np.zeros((1, IMAGE, IMAGE, 2), np.float32),
        "cam_int": np.eye(3, dtype=np.float32)[None] * 500,
        "cam_ext": np.eye(4, dtype=np.float32)[None],
        "max_d": np.asarray([depth], np.float32),
    }


def _random_snapshot(rng, depth):
    """A snapshot with content: an image, intrinsics and a translated camera from the seed."""
    cam_int = np.array([[rng.uniform(500, 1100), 0, rng.uniform(250, 550)],
                        [0, rng.uniform(500, 1100), rng.uniform(250, 550)], [0, 0, 1]], np.float32)[None]
    cam_ext = np.eye(4, dtype=np.float32)[None]
    cam_ext[0, :3, 3] = rng.normal(0, 0.3, 3)
    return {"xs": rng.uniform(-1, 1, (1, IMAGE, IMAGE, 2)).astype(np.float32), "cam_int": cam_int,
            "cam_ext": cam_ext, "max_d": np.asarray([depth], np.float32)}


@pytest.fixture(scope="module")
def world():
    """Assets for both packages and, for 's1' and 's2', psi_tpu's engine and
    the port's on the same weights."""
    rng = np.random.default_rng(SEED)
    jassets, _ = j_make_synthetic_assets(**ASSETS)
    tassets = port_assets(jassets)
    sides = {}
    for mt, cls, kw, conv in (("s1", JS1, dict(latentD=LATENT), cvae_s1_from_jax),
                              ("s2", JS2, dict(latentD_g=LATENT, latentD_l=LATENT), cvae_s2_from_jax)):
        jm = cls(**kw)
        v = jax.device_get(numpy_variables(jm, rng, jnp.zeros((1, 75)), jnp.zeros((1, IMAGE, IMAGE, 2))))
        jeng = JGenerationEngine(jm, v, jassets, population=POPULATION, fit_cfg=JFitConfig(num_iter=2),
                                 seed=SEED, max_requests=MAX_REQUESTS)
        teng = GenerationEngine(conv(v), tassets, population=POPULATION, fit_cfg=FitConfig(num_iter=2),
                                seed=SEED, max_requests=MAX_REQUESTS, device="cpu")
        sides[mt] = types.SimpleNamespace(jax=jeng, port=teng)
    return types.SimpleNamespace(tassets=tassets, sides=sides)


@pytest.fixture(scope="module")
def engine(world):
    """The port's s1 engine (tests/test_serve.py's ``_tiny_engine``), built once."""
    return world.sides["s1"].port


def _next_eps(jeng, mt):
    """The port's ``eps`` for the key psi_tpu's engine will draw on its next call."""
    return jax_noise(mt, jax.random.split(jeng._key)[1], n=POPULATION, d=LATENT)


def _assert_drift(a, b):
    d = np.abs(a - b)
    assert d.max() < DRIFT_MAX and d.mean() < DRIFT_MEAN, (d.max(), d.mean())


# ---- (a) the port against psi_tpu

def test_psi_tpus_key_chain_starts_at_the_seed(world):
    """What ``_next_eps`` rests on: a fresh psi_tpu engine holds PRNGKey(seed) and hands out split(key)[1]."""
    fresh = JGenerationEngine.__new__(JGenerationEngine)
    fresh._key = jax.random.PRNGKey(SEED)
    want = jax.random.split(jax.random.PRNGKey(SEED))
    got = fresh._next_key()
    assert np.array_equal(np.asarray(got), np.asarray(want[1])) and np.array_equal(np.asarray(fresh._key), np.asarray(want[0]))


@pytest.mark.parametrize("fit", [False, True], ids=["generate", "generate_fit"])
@pytest.mark.parametrize("mt", ["s1", "s2"])
def test_generate_matches_psi_tpu(world, mt, fit):
    side = world.sides[mt]
    snap = _random_snapshot(np.random.default_rng(11), 4.5)
    eps = _next_eps(side.jax, mt)
    rj = side.jax.generate(snap, n_samples=6, fit=fit, scene_idx=1)
    rt = side.port.generate(snap, n_samples=6, fit=fit, scene_idx=1, eps=eps)
    assert isinstance(rt, ServeResult) and rt.fitted == rj.fitted == fit and rt.batch_size == rj.batch_size == 1
    assert type(rt.bodies) is np.ndarray and rt.bodies.dtype == rj.bodies.dtype and rt.bodies.shape == rj.bodies.shape == (6, 72)
    assert rt.latency_s > 0
    if fit:
        _assert_drift(rt.bodies, rj.bodies)
    else:
        np.testing.assert_allclose(rt.bodies, rj.bodies, **UNFITTED)


@pytest.mark.parametrize("fit", [False, True], ids=["coalesced", "coalesced_fit"])
@pytest.mark.parametrize("mt", ["s1", "s2"])
def test_generate_coalesced_matches_psi_tpu(world, mt, fit):
    """Three requests with their own image, intrinsics, extrinsics, scene and
    max_d; request i's rows are the slice [offset_i, offset_i + n_i) in both
    packages, and the two padding rows are returned by neither."""
    side = world.sides[mt]
    rng = np.random.default_rng(12)
    counts = [3, 1, 2]
    reqs = [{"batch": _random_snapshot(rng, d), "n_samples": n, "scene_idx": s}
            for d, n, s in zip((6.0, 5.0, 4.0), counts, (0, 1, 0))]
    eps = _next_eps(side.jax, mt)
    rj = side.jax.generate_coalesced(reqs, fit=fit)
    rt = side.port.generate_coalesced(reqs, fit=fit, eps=eps)
    assert [r.bodies.shape for r in rt] == [r.bodies.shape for r in rj] == [(n, 72) for n in counts]
    assert all(r.batch_size == 3 and r.fitted == fit for r in rt)
    for a, b in zip(rt, rj):
        if fit:
            _assert_drift(a.bodies, b.bodies)
        else:
            np.testing.assert_allclose(a.bodies, b.bodies, **UNFITTED)
    # each request's rows are its own snapshot's: another max_d, another depth scale
    assert not np.allclose(rt[0].bodies[:1], rt[1].bodies, atol=1e-3)


def test_coalesced_rows_are_the_single_requests_rows(world):
    """Row partition inside the port: with the same latents, request i of a
    coalesced call gets the rows [offset_i, offset_i + n_i) of its own
    snapshot's single-request population."""
    eng = world.sides["s1"].port
    rng = np.random.default_rng(13)
    snaps = [_random_snapshot(rng, d) for d in (6.0, 4.0)]
    eps = torch.randn((POPULATION, LATENT), generator=torch.Generator().manual_seed(1))
    both = eng.generate_coalesced([{"batch": snaps[0], "n_samples": 3}, {"batch": snaps[1], "n_samples": 4}], eps=eps)
    alone = [eng.generate(s, eps=eps).bodies for s in snaps]
    # the trunk runs on 4 slots here and on 1 snapshot there: f32 sums in another order, |x| up to ~20
    np.testing.assert_allclose(both[0].bodies, alone[0][0:3], atol=2e-5, rtol=0)
    np.testing.assert_allclose(both[1].bodies, alone[1][3:7], atol=2e-5, rtol=0)


def test_engine_draws_from_its_own_seeded_generator(world):
    """No eps: the engine's generator decides, advances from call to call, and a fresh engine with the seed repeats it."""
    eng = world.sides["s1"].port

    def fresh():
        return GenerationEngine(eng.model, world.tassets, population=POPULATION, fit_cfg=FitConfig(num_iter=2),
                                seed=3, max_requests=MAX_REQUESTS, device="cpu")

    a, b = fresh(), fresh()
    first, second = a.generate(_snapshot()).bodies, a.generate(_snapshot()).bodies
    assert np.array_equal(first, b.generate(_snapshot()).bodies) and not np.array_equal(first, second)
    assert a.fit_cfg == FitConfig(num_iter=2) and GenerationEngine(
        eng.model, world.tassets, population=2, device="cpu").fit_cfg == FitConfig.production()


def test_engine_needs_a_card_unless_given_the_cpu_and_assets_on_its_device(world):
    eng = world.sides["s1"].port
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="NVIDIA card"):
            GenerationEngine(eng.model, world.tassets, population=POPULATION)
    with pytest.raises(ValueError, match="assets"):
        GenerationEngine(eng.model, world.tassets, population=POPULATION, device="meta")
    assert eng.device == torch.device("cpu") and next(eng.model.parameters()).device == eng.device


# ---- (b) tests/test_serve.py, one for one

def test_engine_generate_and_fit(engine):
    warm = engine.warmup()
    assert warm > 0
    r1 = engine.generate(_snapshot(), n_samples=5, fit=False)
    assert r1.bodies.shape == (5, 72)
    r2 = engine.generate(_snapshot(), n_samples=8, fit=True, scene_idx=1)
    assert r2.bodies.shape == (8, 72)
    assert r2.fitted
    assert np.all(np.isfinite(r2.bodies))


def test_generate_coalesced_splits_rows(engine):
    reqs = [
        {"batch": _snapshot(), "n_samples": 3, "scene_idx": 0},
        {"batch": _snapshot(5.0), "n_samples": 2, "scene_idx": 1},
        {"batch": _snapshot(4.0), "n_samples": 3, "scene_idx": 0},
    ]
    results = engine.generate_coalesced(reqs, fit=True)
    assert [r.bodies.shape for r in results] == [(3, 72), (2, 72), (3, 72)]
    assert all(r.batch_size == 3 and r.fitted for r in results)
    assert all(np.isfinite(r.bodies).all() for r in results)
    # distinct snapshots (different max_d) must condition their own rows:
    # recover_global_T scales depth by max_d, so populations differ
    assert not np.allclose(results[0].bodies[:2], results[1].bodies)

    # over-capacity and over-slot-count are rejected, not silently truncated
    with pytest.raises(ValueError):
        engine.generate_coalesced([{"batch": _snapshot(), "n_samples": 6}] * 2)
    with pytest.raises(ValueError):
        engine.generate_coalesced([{"batch": _snapshot(), "n_samples": 1}] * 5)


def test_generate_coalesced_refuses_a_snapshot_of_another_shape(engine):
    small = _snapshot()
    small["xs"] = np.zeros((1, 64, 64, 2), np.float32)
    with pytest.raises(ValueError, match="does not match"):
        engine.generate_coalesced([{"batch": _snapshot(), "n_samples": 1}, {"batch": small, "n_samples": 1}])


def test_serving_queue_coalesces_concurrent_requests(engine):
    engine.warmup()
    q = ServingQueue(engine, linger_s=0.25)  # wide window: the burst must share programs
    futs = [q.submit(_snapshot(), n_samples=2, fit=False, scene_idx=i % 2) for i in range(4)]
    results = [f.result(timeout=120) for f in futs]
    q.stop()
    assert all(r.bodies.shape == (2, 72) for r in results)
    stats = q.stats()
    assert stats["requests"] == 4
    # 4 requests x 2 rows fit in one 8-row program (max_requests=4)
    assert stats["batches"] < 4
    assert any(r.batch_size > 1 for r in results)
    assert "latency_p50_s" in stats and "latency_p99_s" in stats
    assert stats["latency_p99_s"] >= stats["latency_p50_s"]


def test_serving_queue_groups_by_fit_flag(engine):
    engine.warmup()
    q = ServingQueue(engine, linger_s=0.25)
    f1 = q.submit(_snapshot(), n_samples=2, fit=False)
    f2 = q.submit(_snapshot(), n_samples=2, fit=True)
    r1, r2 = f1.result(timeout=120), f2.result(timeout=120)
    q.stop()
    assert not r1.fitted and r2.fitted
    assert q.stats()["batches"] == 2  # incompatible fit flags never share a program


def test_serving_router_two_models(world):
    """s1 + s2 resident side by side; requests route by model name and
    stats aggregate across queues with a per-model breakdown."""
    engines = {mt: world.sides[mt].port for mt in ("s1", "s2")}
    for e in engines.values():
        e.warmup()

    router = ServingRouter(engines, linger_s=0.25)
    futs = {
        "s1": router.submit(_snapshot(), n_samples=2, model="s1"),
        "s2": router.submit(_snapshot(), n_samples=3, model="s2"),
        "default": router.submit(_snapshot(), n_samples=1),  # -> first engine (s1)
    }
    res = {k: f.result(timeout=120) for k, f in futs.items()}
    bad = router.submit(_snapshot(), model="nope")
    with pytest.raises(KeyError):
        bad.result(timeout=10)
    router.stop()

    assert res["s1"].bodies.shape == (2, 72)
    assert res["s2"].bodies.shape == (3, 72)
    assert res["default"].bodies.shape == (1, 72)
    stats = router.stats()
    assert stats["requests"] == 3
    assert stats["models"]["s1"]["requests"] == 2  # s1 + default
    assert stats["models"]["s2"]["requests"] == 1
    assert "latency_p50_s" in stats
    with pytest.raises(ValueError):
        ServingRouter({})


def test_engine_coalesced_s2_model(world):
    """The coalesced path must work for the two-stage model too
    (encode_scenes + sample_with_feats)."""
    eng = world.sides["s2"].port
    reqs = [
        {"batch": _snapshot(), "n_samples": 3, "scene_idx": 0},
        {"batch": _snapshot(5.0), "n_samples": 5, "scene_idx": 1},
    ]
    for fit in (False, True):
        results = eng.generate_coalesced(reqs, fit=fit)
        assert [r.bodies.shape for r in results] == [(3, 72), (5, 72)]
        assert all(np.isfinite(r.bodies).all() for r in results)


def test_negative_n_samples_rejected(engine):
    """A negative or zero n_samples must fail ITS request (ValueError)
    rather than corrupting co-batched requests' row partitions."""
    with pytest.raises(ValueError):
        engine.generate_coalesced(
            [{"batch": _snapshot(), "n_samples": -3},
             {"batch": _snapshot(), "n_samples": 2}]
        )
    with pytest.raises(ValueError):
        engine.generate(_snapshot(), n_samples=0)
    q = ServingQueue(engine, linger_s=0.01)
    bad = q.submit(_snapshot(), n_samples=-1)
    good = q.submit(_snapshot(), n_samples=2)
    with pytest.raises(ValueError):
        bad.result(timeout=60)
    assert good.result(timeout=120).bodies.shape == (2, 72)
    q.stop()


def test_warmup_program_selection(engine):
    """warmup(programs=...) runs only the named programs and rejects unknown names."""
    calls = []
    spy = types.SimpleNamespace(
        generate=lambda batch, fit=False, scene_idx=0: calls.append(("single", fit)),
        generate_coalesced=lambda reqs, fit=False: calls.append(("coalesced", fit, len(reqs))),
        _dummy_batch=engine._dummy_batch, WARMUP_PROGRAMS=GenerationEngine.WARMUP_PROGRAMS)
    assert GenerationEngine.warmup(spy, programs=("single", "coalesced_fit")) >= 0
    assert calls == [("single", False), ("coalesced", True, 2)]
    t = engine.warmup(programs=("single",))
    assert t > 0
    with pytest.raises(ValueError):
        engine.warmup(programs=("single", "nope"))


def test_serving_queue_mini_soak(engine):
    """Sustained mixed-size load with a mid-stream malformed storm: every
    malformed future fails cleanly, no valid request is lost, and the
    queue keeps serving afterwards. The long soak on the card is
    psi_tpu_torch/scripts/soak_serve.py; this is the structural version."""
    engine.warmup()
    q = ServingQueue(engine, linger_s=0.01)
    stop = threading.Event()
    ok, errs = [], []

    def client(cid):
        rng = np.random.default_rng(cid)
        while not stop.is_set():
            rows = int(rng.choice([1, 2, 4]))
            fut = q.submit(_snapshot(float(rng.uniform(3, 6))), n_samples=rows,
                           fit=bool(rng.random() < 0.5))
            try:
                r = fut.result(timeout=60)
                ok.append((rows, r.bodies.shape))
            except Exception as e:  # noqa: BLE001
                errs.append(repr(e))

    threads = [threading.Thread(target=client, args=(c,), daemon=True) for c in range(2)]
    [t.start() for t in threads]
    time.sleep(1.0)

    # malformed storm: each future fails cleanly, queue survives
    storm = []
    for k in range(40):
        if k % 3 == 0:
            storm.append(q.submit(_snapshot(), n_samples=-1))
        elif k % 3 == 1:
            storm.append(q.submit({"cam_int": np.eye(3, dtype=np.float32)}, n_samples=2))
        else:
            bad = _snapshot()
            bad["xs"] = np.zeros((3,), np.float32)
            storm.append(q.submit(bad, n_samples=2))
    failed = 0
    for f in storm:
        with pytest.raises(Exception):
            f.result(timeout=30)
        failed += 1
    assert failed == 40

    time.sleep(1.0)
    stop.set()
    [t.join(timeout=60) for t in threads]
    post = q.submit(_snapshot(), n_samples=3, fit=True).result(timeout=60)
    q.stop()
    assert post.bodies.shape == (3, 72) and np.isfinite(post.bodies).all()
    assert not errs, errs[:3]
    assert len(ok) >= 4
    assert all(shape == (rows, 72) for rows, shape in ok)
    stats = q.stats()
    assert stats["requests"] == len(ok) + 1
    assert "latency_p99_s" in stats


# ---- the queue's other promises

class _FakeEngine:
    """An engine that records its groups; no model, no device."""

    population, max_requests = 8, 3

    def __init__(self, fail_on=()):
        self.groups, self.fail_on = [], set(fail_on)

    def generate_coalesced(self, reqs, fit=False):
        self.groups.append(([r["n_samples"] for r in reqs], fit))
        if len(self.groups) in self.fail_on:
            raise RuntimeError("program failed")
        time.sleep(0.05)
        return [ServeResult(np.zeros((r["n_samples"], 72), np.float32), fit, 0.001, len(reqs)) for r in reqs]


def test_queue_groups_stay_within_rows_and_slots_and_carry_the_incompatible_request():
    eng = _FakeEngine()
    q = ServingQueue(eng, linger_s=0.3)
    small = _snapshot()
    small["xs"] = np.zeros((1, 64, 64, 2), np.float32)
    plan = [(_snapshot(), 3, False), (_snapshot(), 3, False), (_snapshot(), 3, False),  # 9 rows > 8: the third waits
            (_snapshot(), 1, False), (_snapshot(), 1, False), (_snapshot(), 1, False),  # slots: 3 a group
            (small, 1, False),  # another snapshot shape
            (_snapshot(), None, True)]  # a full population is its own group
    futs = [q.submit(b, n_samples=n, fit=f) for b, n, f in plan]
    res = [f.result(timeout=30) for f in futs]
    q.stop()
    assert eng.groups == [([3, 3], False), ([3, 1, 1], False), ([1], False), ([1], False), ([8], True)]
    assert [r.batch_size for r in res] == [2, 2, 3, 3, 3, 1, 1, 1]
    assert q.stats()["requests"] == 8 and q.stats()["batches"] == 5


def test_a_failed_program_fails_its_group_and_the_worker_lives_on():
    eng = _FakeEngine(fail_on={1})
    q = ServingQueue(eng, linger_s=0.2)
    doomed = [q.submit(_snapshot(), n_samples=2) for _ in range(2)]
    for f in doomed:
        with pytest.raises(RuntimeError, match="program failed"):
            f.result(timeout=30)
    t0 = time.time()
    later = q.submit(_snapshot(), n_samples=2)
    r = later.result(timeout=30)
    waited = time.time() - t0
    q.stop()
    stats = q.stats()
    assert r.bodies.shape == (2, 72) and stats["requests"] == 1 and stats["batches"] == 1
    # latency_s is end to end (submit -> ready: the linger and the program), not the engine's 0.001
    assert 0.2 <= r.latency_s <= waited + 0.01
    assert q.samples()["latency"] == [r.latency_s] and q._samples["latency"].maxlen == 100_000


def test_queue_records_each_request_s_wait_and_each_call_s_seconds():
    """A request's queue wait runs from its submit to its group's program
    call, and its latency is that wait plus the call; a router merges its
    queues' series."""
    eng = _FakeEngine()
    q = ServingQueue(eng, linger_s=0.0)
    futs = [q.submit(_snapshot(), n_samples=None) for _ in range(3)]  # a full population each: three calls in turn
    res = [f.result(timeout=30) for f in futs]
    q.stop()
    got = q.samples()
    assert len(got["call"]) == 3 and min(got["call"]) >= 0.05  # the engine sleeps 0.05 s a call
    assert [r.latency_s for r in res] == got["latency"]
    for lat, wait, call in zip(got["latency"], got["wait"], got["call"]):
        assert lat == pytest.approx(wait + call, abs=1e-9) and wait >= 0
    # the second request waits out the first call, the third both
    assert got["wait"][1] >= 0.05 and got["wait"][2] >= 0.10
    stats = q.stats()
    assert stats["call_p50_s"] == sorted(got["call"])[1] and stats["wait_p50_s"] == got["wait"][1]
    assert got["wait"][1] <= stats["wait_p99_s"] <= got["wait"][2]
    assert stats["wait_p99_s"] <= stats["latency_p99_s"]

    router = ServingRouter({"a": _FakeEngine(), "b": _FakeEngine()}, linger_s=0.0)
    for name in ("a", "b"):
        router.submit(_snapshot(), n_samples=2, model=name).result(timeout=30)
    router.stop()
    stats = router.stats()
    assert stats["batches"] == 2 and stats["call_p50_s"] >= 0.05 and stats["wait_p99_s"] >= 0
    assert {"wait_p50_s", "wait_p99_s", "call_p50_s"} <= set(stats["models"]["a"])


def test_a_malformed_request_never_reaches_the_worker():
    eng = _FakeEngine()
    q = ServingQueue(eng, linger_s=0.01)
    bad = [q.submit(_snapshot(), n_samples="many"), q.submit({"cam_int": np.eye(3)}, n_samples=1),
           q.submit(_snapshot(), n_samples=0)]
    for f, exc in zip(bad, (ValueError, KeyError, ValueError)):
        assert f.done()
        with pytest.raises(exc):
            f.result(timeout=1)
    q.stop()
    assert eng.groups == [] and q.stats() == {"requests": 0, "batches": 0}
    assert engine_mod._validate_rows(None, 8) == 8 and engine_mod._validate_rows(100, 8) == 8


# ---- (c) the repairs

def test_strict_f32_holds_while_another_thread_is_still_inside():
    """A enters, B enters, A leaves: inside B both TF32 flags must still be
    cleared, and they come back when B, the last one, leaves."""
    from psi_tpu_torch.utils.precision import strict_f32

    mm, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    before = (mm.allow_tf32, cudnn.allow_tf32)
    a_in, b_in, a_out = threading.Event(), threading.Event(), threading.Event()
    seen = {}

    def thread_a():
        with strict_f32():
            a_in.set()
            b_in.wait(10)
        a_out.set()

    def thread_b():
        a_in.wait(10)
        with strict_f32():
            b_in.set()
            a_out.wait(10)
            seen["inside_b_after_a_left"] = (mm.allow_tf32, cudnn.allow_tf32)
        seen["after_b"] = (mm.allow_tf32, cudnn.allow_tf32)

    try:
        mm.allow_tf32 = cudnn.allow_tf32 = True
        threads = [threading.Thread(target=f) for f in (thread_a, thread_b)]
        [t.start() for t in threads]
        [t.join(20) for t in threads]
        assert seen == {"inside_b_after_a_left": (False, False), "after_b": (True, True)}
        # one thread, nested, with an exception on the way out: as before
        with pytest.raises(KeyError):
            with strict_f32():
                with strict_f32():
                    assert (mm.allow_tf32, cudnn.allow_tf32) == (False, False)
                assert (mm.allow_tf32, cudnn.allow_tf32) == (False, False)
                raise KeyError("x")
        assert (mm.allow_tf32, cudnn.allow_tf32) == (True, True)
    finally:
        mm.allow_tf32, cudnn.allow_tf32 = before


def test_strict_f32_never_shows_tf32_inside_under_many_threads():
    """16 threads enter and leave 300 times each with a 1-us switch interval:
    no thread ever reads a set flag inside, and both are back at the end."""
    import sys

    from psi_tpu_torch.utils.precision import strict_f32

    mm, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    before, interval = (mm.allow_tf32, cudnn.allow_tf32), sys.getswitchinterval()
    leaked = []

    def work():
        for _ in range(300):
            with strict_f32():
                if mm.allow_tf32 or cudnn.allow_tf32:
                    leaked.append(1)

    try:
        mm.allow_tf32 = cudnn.allow_tf32 = True
        sys.setswitchinterval(1e-6)
        threads = [threading.Thread(target=work) for _ in range(16)]
        [t.start() for t in threads]
        [t.join(60) for t in threads]
        assert not any(t.is_alive() for t in threads)
        assert not leaked, f"TF32 was on inside strict_f32 {len(leaked)} times"
        assert (mm.allow_tf32, cudnn.allow_tf32) == (True, True)
    finally:
        sys.setswitchinterval(interval)
        mm.allow_tf32, cudnn.allow_tf32 = before


def _stub_compiler(monkeypatch, tmp_path):
    """Point ops._cuda at an empty build directory and replace nvcc with a
    stand-in that sleeps, records its -o path and writes a file there."""
    from psi_tpu_torch.ops import _cuda

    outputs = []

    def fake_run(cmd, **kw):
        out = cmd[cmd.index("-o") + 1]
        outputs.append(out)
        time.sleep(0.2)
        with open(out, "ab") as f:
            f.write(b"x")
        return types.SimpleNamespace(returncode=0, stdout="", stderr="")

    monkeypatch.setattr(_cuda, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_cuda, "find_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_cuda.subprocess, "run", fake_run)
    return _cuda, outputs


def _together(n, fn):
    """fn() in n threads released at once; their results, or the exception of one."""
    gate, out = threading.Barrier(n), [None] * n

    def work(i):
        gate.wait(10)
        try:
            out[i] = fn()
        except Exception as e:  # noqa: BLE001 - handed to the test
            out[i] = e

    threads = [threading.Thread(target=work, args=(i,)) for i in range(n)]
    [t.start() for t in threads]
    [t.join(30) for t in threads]
    return out


def _one_build(_cuda) -> int:
    """Compiler runs of one build: a compile a source, then one link."""
    return sum(s.suffix == ".cu" for s in _cuda.sources()) + 1


def test_four_threads_build_the_kernel_library_once(monkeypatch, tmp_path):
    _cuda, outputs = _stub_compiler(monkeypatch, tmp_path)
    paths = _together(4, _cuda.build_library)
    assert len(outputs) == _one_build(_cuda), f"{len(outputs)} compiler runs, temporary outputs {outputs}"
    assert len(set(paths)) == 1 and paths[0] == _cuda.library_path() and paths[0].exists()
    assert sorted(p.name for p in (tmp_path / "kernels").iterdir()) == sorted(
        [paths[0].name, paths[0].with_suffix(".log").name])  # no temporary file left
    assert str(paths[0]) not in outputs  # linked under a temporary name, then moved into place


def test_four_threads_load_the_kernel_library_once(monkeypatch, tmp_path):
    _cuda, outputs = _stub_compiler(monkeypatch, tmp_path)
    loads = []

    class FakeLibrary:
        def __init__(self, path):
            loads.append(path)
            time.sleep(0.1)

        def __getattr__(self, name):
            fn = types.SimpleNamespace()
            self.__dict__[name] = fn
            return fn

    monkeypatch.setattr(_cuda, "_library", None)
    monkeypatch.setattr(_cuda.ctypes, "CDLL", FakeLibrary)
    libs = _together(4, _cuda.library)
    assert len(outputs) == _one_build(_cuda) and len(loads) == 1
    assert all(lib is libs[0] for lib in libs) and isinstance(libs[0], FakeLibrary)
    assert libs[0].psi_nn_argmin.argtypes == _cuda.SIGNATURES["psi_nn_argmin"]


def test_two_threads_launching_together_count_every_launch(monkeypatch):
    """Kernel.launches is raised under the kernel's lock: two threads that
    drive ``launch`` through a stub entry point N times each read 2N. (On
    CPython with the GIL an unlocked ``+= 1`` on an int has not been seen to
    lose an update, so this holds on the tree before the lock too; it is the
    count a router's two workers read.)"""
    import sys

    from psi_tpu_torch.ops import _cuda

    kernel = _cuda.Kernel("stub", "psi_stub", "psi_tpu_torch/csrc/none.cu", "none")
    calls = []
    kernel._entry = lambda *args: calls.append(args) or 0
    monkeypatch.setattr(torch._C, "_cuda_getDevice", lambda: 0, raising=False)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    device, n = torch.device("cuda", 0), 20000
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        out = _together(2, lambda: [kernel.launch(device, 7) for _ in range(n)])
    finally:
        sys.setswitchinterval(interval)
    assert not any(isinstance(o, Exception) for o in out)
    assert kernel.launches == len(calls) == 2 * n and calls[0] == (7,)
    kernel._entry = lambda *args: 3  # a refused launch is not counted
    with pytest.raises(RuntimeError, match="cudaError 3"):
        kernel.launch(device)
    assert kernel.launches == 2 * n
