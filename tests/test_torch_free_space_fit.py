"""The fit of samples that sit in free space, in psi_tpu and in the port:
what the first Adam update does to the total loss, held on the same
samples, weights and assets as tests/test_torch_fit.py (N=4, V=300, f32
grids), through FitConfig.production(num_iter=20) as demo.py fits.

Two placements of the same samples in scene 0:
* ``demo_camera``: the synthetic batch's own cam_ext, as demo.py places
  its samples;
* ``free_space``: identity rotation, the samples' centre at the middle of
  the scene box in x and y and three quarters of its height in z, above
  the floor, where only a few vertices of the (random) synthetic bodies
  penetrate.

The fit starts at the samples, so the L1-to-sample term is 0 at iteration
0; Adam's first update moves every coordinate by about lr, and the term
grows faster than the others fall. In both packages the mean total rises
after the first update (found: demo_camera 0.683059 -> 0.782466,
free_space 0.152917 -> 0.240664); after 20 iterations it ends above its
iteration-0 value at demo_camera (0.712594) and just below it at
free_space (0.151225, where the collision term goes 0.038250 -> 0). The
curves agree between the packages within 2e-5 relative; held to 1e-3 as
tests/test_torch_fit.py holds them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psi_tpu.fit.fitting import _per_body_losses as j_losses
from psi_tpu.fit.fitting import make_fit_step as j_make_fit_step
from psi_tpu.geometry.bodyvec import convert_to_6D_rot as j_to_6d
from psi_tpu.utils.config import FitConfig as JFitConfig
from psi_tpu_torch.fit.fitting import make_fit_step
from psi_tpu_torch.utils.config import FitConfig
from test_torch_fit import N, world  # noqa: F401  (the module fixture)

torch.set_num_threads(1)
NUM_ITER = 20


def _placement(world, name):
    ja, _ = world["assets"]["f32"]
    if name == "demo_camera":
        return np.repeat(world["batch"]["cam_ext"], N, 0)
    lo, hi = np.asarray(ja.grid_mins[0]), np.asarray(ja.grid_maxs[0])
    target = 0.5 * (lo + hi)
    target[2] = lo[2] + 0.75 * (hi[2] - lo[2])
    cam = np.tile(np.eye(4, dtype=np.float32), (N, 1, 1))
    cam[:, :3, 3] = target - world["x72"][:, :3].mean(0)
    return cam


@pytest.fixture(scope="module")
def fits(world):  # noqa: F811
    """Both placements through one psi_tpu program and the port's fit."""
    ja, ta = world["assets"]["f32"]
    j_fit = j_make_fit_step(ja, JFitConfig.production(num_iter=NUM_ITER))
    t_fit = make_fit_step(ta, FitConfig.production(num_iter=NUM_ITER))
    sidx = np.zeros(N, np.int32)
    xh = j_to_6d(jnp.asarray(world["x72"]))
    out = {}
    for name in ("demo_camera", "free_space"):
        cam = _placement(world, name)
        _, (m0, _) = j_losses(ja, xh, xh, jnp.asarray(cam), jnp.asarray(sidx), JFitConfig.production())
        _, mj, hj = j_fit(jnp.asarray(world["x72"]), jnp.asarray(cam), jnp.asarray(sidx))
        _, mt, ht = t_fit(torch.from_numpy(world["x72"]), torch.from_numpy(cam), torch.from_numpy(sidx))
        out[name] = dict(m0={k: np.asarray(v) for k, v in m0.items()}, hj=np.asarray(hj).mean(1),
                         mj={k: np.asarray(v) for k, v in mj.items()}, ht=ht.numpy().mean(1),
                         mt={k: v.numpy() for k, v in mt.items()})
    return out


@pytest.mark.parametrize("placement", ["demo_camera", "free_space"])
def test_first_update_raises_the_total_in_both_packages(fits, placement):
    r = fits[placement]
    assert float(r["m0"]["rec"].max()) == 0.0  # the fit starts at the samples
    assert r["hj"].shape == r["ht"].shape == (NUM_ITER,)
    assert r["hj"][1] > r["hj"][0] and r["ht"][1] > r["ht"][0]
    np.testing.assert_allclose(r["ht"], r["hj"], rtol=1e-3)
    for k in ("rec", "vposer", "contact", "collision", "total"):
        np.testing.assert_allclose(r["mt"][k], r["mj"][k], rtol=1e-3, atol=2e-5, err_msg=k)


def test_free_space_samples_shed_collision_in_both_packages(fits):
    """At free_space the samples start with a few vertices in collision and
    the fit clears them in both packages, while the total ends within 2% of where it began."""
    r = fits["free_space"]
    assert float(r["m0"]["collision"].mean()) > 0
    assert float(r["mj"]["collision"].mean()) < float(r["m0"]["collision"].mean())
    assert float(r["mt"]["collision"].mean()) < float(r["m0"]["collision"].mean())
