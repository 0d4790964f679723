"""The five loss terms: psi_tpu_torch.losses.terms vs psi_tpu.losses.terms,
values and gradients on the same numpy inputs.

Tolerance: elementwise f32 math and one mean over at most 4 x 300 values,
summed in another order -> 1e-6 absolute + 1e-5 relative on values and on
gradients. At the kinks the subgradient must be jnp's: |d| has derivative +1
at d == 0 (torch.abs has 0), min(sdf, 0) passes half the gradient at 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psi_tpu.losses import terms as jt
from psi_tpu_torch.losses import terms as tt

torch.set_num_threads(1)
TOL = dict(atol=1e-6, rtol=1e-5)


def _inputs(name):
    rng = np.random.default_rng(5)
    f = lambda *s: rng.normal(0, 1, s).astype(np.float32)
    return {
        "l1_loss": (f(4, 75), f(4, 75)),
        "kl_normal_loss": (f(4, 32), 0.5 * f(4, 32)),
        "vposer_reg_loss": (f(4, 32),),
        "contact_robust_loss": (np.abs(f(4, 32)),),
        "collision_loss": (f(4, 300),),
    }[name]


def _both(name, args, **kw):
    """(value, grads) from each package for term ``name`` on numpy ``args``."""
    jf = lambda *a: getattr(jt, name)(*a, **kw)
    vj, gj = jax.value_and_grad(jf, argnums=tuple(range(len(args))))(*map(jnp.asarray, args))
    ta = [torch.from_numpy(a.copy()).requires_grad_(True) for a in args]
    vt = getattr(tt, name)(*ta, **kw)
    gt = torch.autograd.grad(vt, ta)
    return (float(vt.detach()), [g.numpy() for g in gt]), (float(vj), [np.asarray(g) for g in gj])


@pytest.mark.parametrize("name", ["l1_loss", "kl_normal_loss", "vposer_reg_loss", "contact_robust_loss",
                                  "collision_loss"])
def test_term_value_and_gradient_match_jax(name):
    (vt, gt), (vj, gj) = _both(name, _inputs(name))
    np.testing.assert_allclose(vt, vj, **TOL)
    for a, b in zip(gt, gj):
        assert np.abs(b).max() > 0
        np.testing.assert_allclose(a, b, **TOL)


def test_contact_robust_loss_denominator_offset():
    (vt, gt), (vj, gj) = _both("contact_robust_loss", _inputs("contact_robust_loss"), denom_offset=0.01)
    np.testing.assert_allclose(vt, vj, **TOL)
    np.testing.assert_allclose(gt[0], gj[0], **TOL)


def test_l1_loss_gradient_where_a_equals_b_is_jnp_abs():
    """Half of the entries have a == b: jnp.abs gives them d|d|/da = +1, so
    the gradient there is +1/n for a and -1/n for b."""
    a, b = _inputs("l1_loss")
    b[:, ::2] = a[:, ::2]
    (vt, gt), (vj, gj) = _both("l1_loss", (a, b))
    np.testing.assert_allclose(vt, vj, **TOL)
    assert np.all(gj[0][:, ::2] == np.float32(1.0 / a.size))  # what psi_tpu does
    np.testing.assert_array_equal(gt[0], gj[0])
    np.testing.assert_array_equal(gt[1], gj[1])


def test_collision_loss_subgradient_at_zero_and_no_penetration():
    sdf = _inputs("collision_loss")[0]
    sdf[:, ::3] = 0.0
    (vt, gt), (vj, gj) = _both("collision_loss", (sdf,))
    np.testing.assert_allclose(vt, vj, **TOL)
    np.testing.assert_allclose(gt[0], gj[0], **TOL)
    assert np.any(gj[0][:, ::3] != 0)  # jnp.minimum passes half the gradient at 0
    (vt, gt), (vj, gj) = _both("collision_loss", (np.abs(sdf) + 0.1,))
    assert vt == vj == 0.0 and not gt[0].any() and not gj[0].any()
