"""The population-sharded fit over two processes: psi_tpu_torch's
``make_fit_step(mesh=)``, ``make_generate_fit_step(mesh=)``,
``make_generate_fit_rows(mesh=)`` and ``GenerationEngine(mesh=)`` on two gloo
ranks on the CPU, against the port's unsharded calls and psi_tpu's, on the
same inputs.

World: ``tests/test_torch_fit.py``'s (N=4 bodies, V=300, J=12, 2 scenes,
16^3 bf16 grids, 512 scene points, 32 contact verts; production tier at 6
iterations, and one fit at the exact tier), so each rank fits 2 rows. The ranks are
``psi_tpu_torch/scripts/multiprocess_worker.py`` processes joined through a
file store under the test's own tmp_path, one torch thread each, and joined
under WORKER_TIMEOUT_S (a hung or failed rank fails the test).

Tolerances:
* sharded vs the port's unsharded call: a rank runs the same math on 2 rows
  instead of 4, which the CPU may sum in another order, so the bounds of
  tests/test_multichip.py:172-175: max fitted drift < 2.5 lr, mean < 1e-4,
  metrics within 1e-4 (absolute and relative); the first iteration's loss
  (nothing fitted yet) within 1e-5 relative;
* sharded vs psi_tpu: the port's own fit parity bounds (test_torch_fit.py):
  drift max 5e-3, mean 5e-4; iteration 0 within 1e-4 relative; metrics
  1e-3 relative + 2e-5 absolute;
* the engine: tests/test_serve_mesh.py's, fitted 5e-3, generate-only 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psi_tpu.fit.fitting import make_fit_step as j_make_fit_step
from psi_tpu.utils.config import FitConfig as JFitConfig
from psi_tpu_torch.fit.fitting import make_fit_step, make_generate_fit_rows, make_generate_fit_step
from psi_tpu_torch.parallel.mesh import Mesh
from psi_tpu_torch.scripts import multiprocess_worker
from psi_tpu_torch.serve.engine import GenerationEngine
from psi_tpu_torch.utils.config import FitConfig
from test_torch_fit import DRIFT_MAX, DRIFT_MEAN, N, PRODUCTION, world  # noqa: F401  (world: the fixture)

torch.set_num_threads(1)
WORKER_TIMEOUT_S = 240
CFG = FitConfig.production(**PRODUCTION)
LR = CFG.init_lr_h
SHARD_TOL = dict(max=2.5 * LR, mean=1e-4, metrics=1e-4)
ENGINE = dict(population=N, fit_cfg=FitConfig(num_iter=3), seed=7)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _snapshot(depth=6.0):
    cam_int = np.eye(3, dtype=np.float32)[None] * 500
    cam_int[0, 2, 2] = 1.0
    return {"xs": np.zeros((1, 32, 32, 2), np.float32), "cam_int": cam_int,
            "cam_ext": np.eye(4, dtype=np.float32)[None], "max_d": np.asarray([depth], np.float32)}


def _inputs(world):
    b = world["batch"]
    rows_xs = np.concatenate([b["xs"], b["xs"][:, ::-1]], 0)  # two snapshots, the second flipped
    rows = dict(xs=_t(rows_xs), cam_int=_t(np.repeat(b["cam_int"], 2, 0)), max_d=_t(np.array([6.0, 4.0], np.float32)),
                req=_t(np.array([0, 1, 1, 0], np.int64)))
    return dict(x72=_t(world["x72"]), cam=_t(world["cam"]), sidx=_t(world["sidx"]), b=b, rows=rows,
                eps=_t(world["eps"]))


def _calls(world):
    i, b = _inputs(world), world["batch"]
    snap = (_t(b["xs"]), _t(b["cam_int"]), _t(b["max_d"]))
    r = i["rows"]
    reqs = [{"batch": _snapshot(), "n_samples": 1, "scene_idx": 0}, {"batch": _snapshot(4.0), "n_samples": 3,
                                                                     "scene_idx": 1}]
    return [
        dict(name="fit", kind="fit_step", cfg=CFG, args=(i["x72"], i["cam"], i["sidx"])),
        dict(name="genfit", kind="generate_fit_step", cfg=CFG, n=N, args=(*snap, i["cam"], i["sidx"]), eps=i["eps"]),
        dict(name="rows", kind="generate_fit_rows", cfg=CFG,
             args=(r["xs"], r["cam_int"], r["max_d"], r["req"], i["cam"], i["sidx"]), eps=i["eps"]),
        dict(name="exact", kind="fit_step", cfg=FitConfig.exact(num_iter=CFG.num_iter,
                                                               prune_scene_points=CFG.prune_scene_points),
             args=(i["x72"], i["cam"], i["sidx"])),
        dict(name="engine", kind="engine", **ENGINE, requests=[
            ("generate", dict(batch=_snapshot(), fit=True, scene_idx=1)),
            ("generate_coalesced", dict(requests=reqs, fit=True)),
            ("generate", dict(batch=_snapshot(), n_samples=3, fit=False)),
        ]),
    ]


def _unsharded(world, call):
    """The port's unsharded twin of one of _calls' calls."""
    _, ta = world["assets"]["bf16"]
    if call["kind"] == "fit_step":
        return make_fit_step(ta, call["cfg"])(*call["args"])
    if call["kind"] == "generate_fit_step":
        return make_generate_fit_step(world["tmodel"], ta, call["cfg"], call["n"])(*call["args"], eps=call["eps"])
    return make_generate_fit_rows(world["tmodel"], ta, call["cfg"])(*call["args"], eps=call["eps"])


@pytest.fixture(scope="module")
def sharded(world, tmp_path_factory):
    """(the calls, each rank's results) of one 2-rank run of every call."""
    out = tmp_path_factory.mktemp("mp_fit")
    _, ta = world["assets"]["bf16"]
    calls = _calls(world)
    torch.save({"assets": ta, "model": world["tmodel"], "calls": calls}, out / "fit_spec.pt")
    ranks = multiprocess_worker.spawn(out, "fit", 2, device="cpu", timeout_s=WORKER_TIMEOUT_S, threads=1)
    return {c["name"]: c for c in calls}, ranks


def _assert_shard_bounds(got, ref):
    (x, m, h), (xr, mr, hr) = got, ref
    assert x.shape == xr.shape and torch.isfinite(x).all()
    d = (x - xr).abs()
    assert d.max() < SHARD_TOL["max"], f"max fitted drift {d.max()}"
    assert d.mean() < SHARD_TOL["mean"], f"mean fitted drift {d.mean()}"
    torch.testing.assert_close(h[0], hr[0], rtol=1e-5, atol=0)
    for k in mr:
        torch.testing.assert_close(m[k], mr[k], rtol=SHARD_TOL["metrics"], atol=SHARD_TOL["metrics"], msg=k)


@pytest.mark.parametrize("name", ["fit", "genfit", "rows", "exact"])
def test_sharded_fit_matches_the_unsharded_call(world, sharded, name):
    calls, ranks = sharded
    for r in ranks:  # every rank returns the whole population's results
        res = r[name]
        _assert_shard_bounds((res["x72"], res["metrics"], res["hist"]), _unsharded(world, calls[name]))
        assert res["hist"].shape == (CFG.num_iter, res["x72"].shape[0])
    torch.testing.assert_close(ranks[0][name]["x72"], ranks[1][name]["x72"], rtol=0, atol=0)


def test_sharded_fit_matches_psi_tpu(world, sharded):
    ja, _ = world["assets"]["bf16"]
    xj, mj, hj = j_make_fit_step(ja, JFitConfig.production(**PRODUCTION))(
        jnp.asarray(world["x72"]), jnp.asarray(world["cam"]), jnp.asarray(world["sidx"]))
    for name in ("fit", "genfit"):
        res = sharded[1][1][name]  # rank 1's copy of the whole population
        d = np.abs(res["x72"].numpy() - np.asarray(xj))
        assert d.max() < DRIFT_MAX and d.mean() < DRIFT_MEAN, (name, d.max(), d.mean())
        np.testing.assert_allclose(res["hist"].numpy()[0], np.asarray(hj)[0], rtol=1e-4, atol=0)
        for k in ("rec", "vposer", "contact", "collision", "total"):
            np.testing.assert_allclose(res["metrics"][k].numpy(), np.asarray(mj[k]), rtol=1e-3, atol=2e-5, err_msg=k)


def test_sharded_engine_matches_the_single_engine(world, sharded):
    _, ta = world["assets"]["bf16"]
    single = GenerationEngine(world["tmodel"], ta, device="cpu", **ENGINE)
    one = single.generate(_snapshot(), fit=True, scene_idx=1).bodies
    reqs = sharded[0]["engine"]["requests"][1][1]["requests"]
    many = [r.bodies for r in single.generate_coalesced(reqs, fit=True)]
    plain = single.generate(_snapshot(), n_samples=3).bodies
    for r in sharded[1]:
        got_one, got_many, got_plain = r["engine"]["requests"]
        np.testing.assert_allclose(got_one[0], one, atol=5e-3)
        assert [g.shape for g in got_many] == [(1, 72), (3, 72)]
        for g, w in zip(got_many, many):
            np.testing.assert_allclose(g, w, atol=5e-3)
        assert got_plain[0].shape == (3, 72)
        np.testing.assert_allclose(got_plain[0], plain, atol=1e-5)


def test_an_indivisible_population_raises(world):
    """Nothing is launched: the checks come before any collective."""
    _, ta = world["assets"]["bf16"]
    mesh = Mesh(rank=0, size=2, device=torch.device("cpu"), group=None, backend="gloo")
    with pytest.raises(ValueError, match="divide evenly"):
        GenerationEngine(world["tmodel"], ta, population=3, device="cpu", mesh=mesh)
    with pytest.raises(ValueError, match="divide evenly"):
        make_fit_step(ta, CFG, mesh=mesh)(torch.zeros(3, 72), torch.eye(4).repeat(3, 1, 1),
                                          torch.zeros(3, dtype=torch.int64))
