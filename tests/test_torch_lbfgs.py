"""psi_tpu_torch.utils.lbfgs against psi_tpu.utils.lbfgs on the same
seeded problems: the same number of iterations, the same ``converged``,
the same line-search points in order, and iterates within 1e-5 relative.

The problems run in float64 on both sides (psi_tpu's under
``jax.enable_x64``): the objective is the same function written in each
framework, and its value, gradient and the search's dot products are sums
taken in another order by each. In float32 those last-bit differences
decide a stopping test such as |f - f_prev| < 1e-9 one iteration apart and
grow to ~1e-4 along a 32-D Rosenbrock valley; in float64 they stay at
rounding level along the whole search, so the comparison holds the
algorithm: defaults, stopping rules, history and line search.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psi_tpu.utils.lbfgs import _cubic_interpolate as j_cubic
from psi_tpu.utils.lbfgs import lbfgs_minimize as j_lbfgs
from psi_tpu_torch.utils.lbfgs import _cubic_interpolate as t_cubic
from psi_tpu_torch.utils.lbfgs import lbfgs_minimize as t_lbfgs

torch.set_num_threads(1)
REL = 1e-5


def _rosenbrock(lib):
    def f(x):
        return lib.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2)
    return f


def _quadratic(lib, A, c):
    def f(x):
        r = A @ x.reshape(-1) - c
        return 0.5 * lib.sum(r * r) + 0.01 * lib.sum(x ** 4)
    return f


def _problems():
    rng = np.random.default_rng(0)
    x_rb = 1.0 + rng.normal(0, 0.3, 32)  # 32-D Rosenbrock near its valley
    A = rng.normal(size=(24, 16))
    c = rng.normal(size=24)
    x_q = rng.normal(size=(4, 4))  # a 2-D iterate: the search runs over its flattened values
    return {
        "rosenbrock32": (_rosenbrock(jnp), _rosenbrock(torch), x_rb, {}),
        "rosenbrock32_short_history": (_rosenbrock(jnp), _rosenbrock(torch), x_rb, dict(history_size=5, max_iter=40)),
        "quartic_4x4": (_quadratic(jnp, jnp.asarray(A), jnp.asarray(c)),
                        _quadratic(torch, torch.from_numpy(A), torch.from_numpy(c)), x_q, {}),
        "no_line_search": (_rosenbrock(jnp), _rosenbrock(torch), x_rb, dict(line_search="none", lr=1e-3, max_iter=30)),
    }


@pytest.mark.parametrize("name", list(_problems()))
def test_lbfgs_matches_psi_tpu(name):
    with jax.enable_x64(True):
        jf, tf, x0, kw = _problems()[name]
        jr = j_lbfgs(jf, jnp.asarray(x0), **kw)
        tr = t_lbfgs(tf, torch.from_numpy(x0), **kw)
    assert tr.num_iters == jr.num_iters and tr.converged == jr.converged, (tr.num_iters, jr.num_iters)
    assert tr.num_iters > 3
    assert tr.x.shape == x0.shape and tr.x.dtype == torch.float64
    scale = np.abs(np.asarray(jr.x)).max()
    np.testing.assert_allclose(tr.x.numpy(), np.asarray(jr.x), rtol=0, atol=REL * scale)
    assert abs(tr.fval - jr.fval) <= REL * max(abs(jr.fval), 1e-3)
    assert tr.fval < float(tf(torch.from_numpy(x0)))


def test_lbfgs_iterates_follow_psi_tpus(monkeypatch):
    """Every line-search point the port evaluates is psi_tpu's, in order."""
    import psi_tpu.utils.lbfgs as jl
    import psi_tpu_torch.utils.lbfgs as tl

    points = {"j": [], "t": []}
    with jax.enable_x64(True):
        jf, tf, x0, kw = _problems()["rosenbrock32"]
        _search(jl, jf, jnp.asarray(x0), kw, points["j"], monkeypatch)
        _search(tl, tf, torch.from_numpy(x0), kw, points["t"], monkeypatch)
    assert len(points["t"]) == len(points["j"]) > 20
    for i, (p, q) in enumerate(zip(points["t"], points["j"])):
        np.testing.assert_allclose(p, q, rtol=0, atol=REL * np.abs(q).max(), err_msg=f"point {i}")


def _search(mod, f, x, kw, seen, monkeypatch):
    """mod.lbfgs_minimize(f, x) with every line-search point appended to ``seen``."""
    inner = mod._strong_wolfe

    def spy(eval_fn, *a, **k):
        def ev(p):
            seen.append(np.array(p.numpy() if isinstance(p, torch.Tensor) else p))
            return eval_fn(p)
        return inner(ev, *a, **k)

    monkeypatch.setattr(mod, "_strong_wolfe", spy)
    mod.lbfgs_minimize(f, x, **kw)


@pytest.mark.parametrize("args", [(0.0, 1.0, -2.0, 1.0, 0.5, 1.0), (1.0, 1.0, 3.0, 0.0, 0.2, -1.0),
                                  (0.0, 1.0, -1.0, 2.0, 3.0, 4.0)])
def test_cubic_interpolate_is_psi_tpus(args):
    assert t_cubic(*args) == j_cubic(*args)
    assert t_cubic(*args, bounds=(0.1, 0.5)) == j_cubic(*args, bounds=(0.1, 0.5))


def test_converged_at_the_start_returns_x0():
    r = t_lbfgs(lambda x: torch.sum((x - 1.0) ** 2), torch.ones(3))
    assert r.num_iters == 0 and r.converged and torch.equal(r.x, torch.ones(3))
