"""L-BFGS with a strong-Wolfe cubic-interpolation line search.

Port of ``psi_tpu.utils.lbfgs`` (psi_tpu's equivalent of the optimizer
that the reference vendors from pytorch PR#8824,
human_body_prior/optimizers/lbfgs_ls.py, used by the interpenetration
untangler, body_model.py:437): the same defaults, stopping rules, history
handling and line search, step for step. The objective's value and
gradient come from ``torch.autograd.grad``; the two-loop recursion and the
line search run on the host over device scalars, read as Python floats
where psi_tpu reads ``float(...)``. It serves few-hundred-step offline
refinements, not a training loop.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch


class LBFGSResult(NamedTuple):
    x: torch.Tensor
    fval: float
    num_iters: int
    converged: bool


def _dot(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.dot(a, b))


def _cubic_interpolate(x1, f1, g1, x2, f2, g2, bounds=None):
    """Minimizer of the cubic through (x1, f1, g1), (x2, f2, g2)."""
    if bounds is not None:
        lo, hi = bounds
    else:
        lo, hi = (x1, x2) if x1 <= x2 else (x2, x1)
    d1 = g1 + g2 - 3 * (f1 - f2) / (x1 - x2)
    d2_sq = d1**2 - g1 * g2
    if d2_sq >= 0:
        d2 = math.sqrt(d2_sq)
        if x1 <= x2:
            min_pos = x2 - (x2 - x1) * ((g2 + d2 - d1) / (g2 - g1 + 2 * d2))
        else:
            min_pos = x1 - (x1 - x2) * ((g1 + d2 - d1) / (g1 - g2 + 2 * d2))
        return float(min(max(min_pos, lo), hi))
    return float((lo + hi) / 2.0)


def _strong_wolfe(
    eval_fn, x, t, d, f0, g0, gtd0, c1=1e-4, c2=0.9, tolerance_change=1e-9, max_ls=25
):
    """Line search satisfying the strong Wolfe conditions. Returns
    (f_new, g_new, t, num_evals)."""
    d_norm = float(d.abs().max())
    f_new, g_new = eval_fn(x + t * d)
    gtd_new = _dot(g_new, d)
    ls_func_evals = 1

    # bracket phase
    t_prev, f_prev, g_prev, gtd_prev = 0.0, f0, g0, gtd0
    bracket = None
    done = False
    for _ in range(max_ls):
        if f_new > (f0 + c1 * t * gtd0) or (ls_func_evals > 1 and f_new >= f_prev):
            bracket = ([t_prev, t], [f_prev, f_new], [g_prev, g_new], [gtd_prev, gtd_new])
            break
        if abs(gtd_new) <= -c2 * gtd0:
            bracket = ([t, t], [f_new, f_new], [g_new, g_new], [gtd_new, gtd_new])
            done = True
            break
        if gtd_new >= 0:
            bracket = ([t_prev, t], [f_prev, f_new], [g_prev, g_new], [gtd_prev, gtd_new])
            break
        min_step = t + 0.01 * (t - t_prev)
        max_step = t * 10
        tmp = t
        t = _cubic_interpolate(t_prev, f_prev, gtd_prev, t, f_new, gtd_new, bounds=(min_step, max_step))
        t_prev, f_prev, g_prev, gtd_prev = tmp, f_new, g_new, gtd_new
        f_new, g_new = eval_fn(x + t * d)
        gtd_new = _dot(g_new, d)
        ls_func_evals += 1
    else:
        bracket = ([0.0, t], [f0, f_new], [g0, g_new], [gtd0, gtd_new])

    # zoom phase
    if not done:
        ts, fs, gs, gtds = bracket
        insuf_progress = False
        for _ in range(max_ls - ls_func_evals):
            if abs(ts[1] - ts[0]) * d_norm < tolerance_change:
                break
            low = 0 if fs[0] <= fs[1] else 1
            high = 1 - low
            t = _cubic_interpolate(ts[0], fs[0], gtds[0], ts[1], fs[1], gtds[1])
            eps = 0.1 * abs(ts[1] - ts[0])
            if min(abs(max(ts) - t), abs(t - min(ts))) < eps:
                if insuf_progress or t >= max(ts) or t <= min(ts):
                    t = max(ts) - eps if abs(t - max(ts)) < abs(t - min(ts)) else min(ts) + eps
                    insuf_progress = False
                else:
                    insuf_progress = True
            else:
                insuf_progress = False
            f_new, g_new = eval_fn(x + t * d)
            gtd_new = _dot(g_new, d)
            ls_func_evals += 1
            if f_new > (f0 + c1 * t * gtd0) or f_new >= fs[low]:
                ts[high], fs[high], gs[high], gtds[high] = t, f_new, g_new, gtd_new
            else:
                if abs(gtd_new) <= -c2 * gtd0:
                    ts[low], fs[low], gs[low], gtds[low] = t, f_new, g_new, gtd_new
                    break
                if gtd_new * (ts[high] - ts[low]) >= 0:
                    ts[high], fs[high], gs[high], gtds[high] = ts[low], fs[low], gs[low], gtds[low]
                ts[low], fs[low], gs[low], gtds[low] = t, f_new, g_new, gtd_new
        low = 0 if fs[0] <= fs[1] else 1
        t, f_new, g_new = ts[low], fs[low], gs[low]

    return f_new, g_new, t, ls_func_evals


def lbfgs_minimize(
    fun: Callable[[torch.Tensor], torch.Tensor],
    x0: torch.Tensor,
    max_iter: int = 100,
    history_size: int = 100,
    lr: float = 1.0,
    tolerance_grad: float = 1e-7,
    tolerance_change: float = 1e-9,
    line_search: str = "strong_wolfe",
) -> LBFGSResult:
    """Minimize a scalar function of one tensor (any shape; the search runs
    over its flattened values). ``fun`` is differentiated with
    ``torch.autograd.grad``; parameters it closes over take no gradient."""
    shape = x0.shape

    def eval_fn(flat):
        x = flat.detach().reshape(shape).requires_grad_(True)
        with torch.enable_grad():
            v = fun(x)
            (g,) = torch.autograd.grad(v, x)
        return float(v.detach()), g.reshape(-1)

    x = x0.detach().reshape(-1)
    f, g = eval_fn(x)
    if float(g.abs().max()) <= tolerance_grad:
        return LBFGSResult(x.reshape(shape), f, 0, True)

    s_hist, y_hist, rho_hist = [], [], []
    n_iter = 0
    converged = False
    while n_iter < max_iter:
        n_iter += 1
        # two-loop recursion
        q = -g
        alphas = []
        for s, y, rho in zip(reversed(s_hist), reversed(y_hist), reversed(rho_hist)):
            a = rho * _dot(s, q)
            alphas.append(a)
            q = q - a * y
        if y_hist:
            gamma = float(torch.dot(s_hist[-1], y_hist[-1]) / torch.dot(y_hist[-1], y_hist[-1]))
            q = q * gamma
        for (s, y, rho), a in zip(zip(s_hist, y_hist, rho_hist), reversed(alphas)):
            b = rho * _dot(y, q)
            q = q + (a - b) * s
        d = q

        gtd = _dot(g, d)
        if gtd > -tolerance_change:
            break
        t = lr if n_iter > 1 else min(1.0, 1.0 / float(g.abs().sum())) * lr

        if line_search == "strong_wolfe":
            f_new, g_new, t, _ = _strong_wolfe(eval_fn, x, t, d, f, g, gtd)
        else:
            f_new, g_new = eval_fn(x + t * d)

        x_new = x + t * d
        s = x_new - x
        y = g_new - g
        ys = _dot(y, s)
        if ys > 1e-10:
            if len(s_hist) >= history_size:
                s_hist.pop(0)
                y_hist.pop(0)
                rho_hist.pop(0)
            s_hist.append(s)
            y_hist.append(y)
            rho_hist.append(1.0 / ys)

        x, f_prev, f, g = x_new, f, f_new, g_new
        if float(g.abs().max()) <= tolerance_grad:
            converged = True
            break
        if float((t * d).abs().max()) <= tolerance_change:
            converged = True
            break
        if abs(f - f_prev) < tolerance_change:
            converged = True
            break

    return LBFGSResult(x.reshape(shape), f, n_iter, converged)
