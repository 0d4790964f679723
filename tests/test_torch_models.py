"""Sampling networks: psi_tpu_torch (NCHW torch) vs psi_tpu (NHWC flax)
with weights carried across by utils/convert_jax.py.

BatchNorm statistics and affine terms are randomised so the conversion of
every tensor is exercised. Tolerance: f32 convolutions and matmuls summed
in another order, outputs O(1) -> 1e-4 absolute + 1e-4 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psi_tpu.models import HumanCVAES1 as JCVAE
from psi_tpu.models.resnet import ResNet18Trunk
from psi_tpu.utils.convert_torch import convert_cvae_s1_state_dict
from psi_tpu_torch.utils.convert_jax import cvae_s1_from_jax
from psi_tpu_torch.utils.precision import strict_f32

torch.set_num_threads(1)
LATENT = 64
TOL = dict(atol=1e-4, rtol=1e-4)


def _randomise_bn(tree, rng):
    """Replace BatchNorm scale/bias/mean/var leaves with random values."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _randomise_bn(v, rng)
        elif k in ("scale", "var"):
            out[k] = rng.uniform(0.5, 1.5, np.shape(v)).astype(np.float32)
        elif k in ("bias", "mean") and np.ndim(v) == 1:
            out[k] = rng.normal(0, 0.1, np.shape(v)).astype(np.float32)
        else:
            out[k] = np.asarray(v)
    return out


def _build(image):
    model = JCVAE(latentD=LATENT)
    v = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 75)), jnp.zeros((1, image, image, 2)))
    v = _randomise_bn(jax.device_get(v), np.random.default_rng(0))
    return model, v


@pytest.fixture(scope="module")
def small():
    model, v = _build(32)
    return model, v, cvae_s1_from_jax(v)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(1)
    return (rng.uniform(-1, 1, (3, 32, 32, 2)).astype(np.float32),
            rng.normal(0, 1, (3, 32)).astype(np.float32),
            rng.normal(0, 0.5, (3, 75)).astype(np.float32))


def test_resnet_trunk_matches_flax(small, inputs):
    _, v, tm = small
    xs = inputs[0]
    trunk = {"params": v["params"]["scene"]["resnet"], "batch_stats": v["batch_stats"]["scene"]["resnet"]}
    fj = np.asarray(ResNet18Trunk().apply(trunk, jnp.asarray(xs)))  # [B, 4, 4, 128] NHWC
    with torch.no_grad(), strict_f32():
        ft = tm.resnet(torch.from_numpy(xs).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert ft.shape == fj.shape == (3, 4, 4, 128)
    np.testing.assert_allclose(ft, fj, **TOL)


def test_scene_encoder_matches_flax(small, inputs):
    """Covers the NHWC -> NCHW flatten permutation of fc."""
    model, v, tm = small
    zj = np.asarray(model.apply(v, jnp.asarray(inputs[0]), method=JCVAE.encode_scene))
    with torch.no_grad():
        zt = tm.encode_scene(torch.from_numpy(inputs[0])).numpy()
    np.testing.assert_allclose(zt, zj, **TOL)


def test_sample_with_eps_matches_flax(small, inputs):
    model, v, tm = small
    xs, eps, _ = inputs
    oj = np.asarray(model.apply(v, jnp.asarray(xs), jnp.asarray(eps), method=JCVAE.sample_with_eps))
    with torch.no_grad():
        ot = tm.sample_with_eps(torch.from_numpy(xs), torch.from_numpy(eps)).numpy()
    assert ot.shape == (3, 75)
    np.testing.assert_allclose(ot, oj, **TOL)


def test_sample_n_broadcasts_one_trunk_pass(small, inputs):
    """sample_n on one snapshot == sample_with_eps on the tiled snapshot."""
    _, _, tm = small
    xs, eps, _ = inputs
    one = torch.from_numpy(xs[:1])
    with torch.no_grad():
        a = tm.sample_n(one, 3, eps=torch.from_numpy(eps))
        b = tm.sample_with_eps(one.expand(3, -1, -1, -1), torch.from_numpy(eps))
    # the same rows, through convolutions of another batch size: f32 order only
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=0)


def test_posterior_mean_forward_matches_flax(small, inputs):
    """The encoder half too: (x_rec, mu, logvar) at the posterior mean."""
    model, v, tm = small
    xs, _, xb = inputs
    outs_j = model.apply(v, jnp.asarray(xb), jnp.asarray(xs))
    with torch.no_grad():
        outs_t = tm(torch.from_numpy(xb), torch.from_numpy(xs))
    for a, b in zip(outs_t, outs_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_state_dict_names_are_the_reference_checkpoints():
    """psi_tpu's own converter for reference .ckp state dicts reads the
    port's state dict as it stands, and the result reproduces the port."""
    model, v = _build(128)
    tm = cvae_s1_from_jax(v)
    sd = {k: t.numpy() for k, t in tm.state_dict().items() if not k.endswith("num_batches_tracked")}
    back = convert_cvae_s1_state_dict(sd)
    xs = np.random.default_rng(2).uniform(-1, 1, (1, 128, 128, 2)).astype(np.float32)
    eps = np.random.default_rng(3).normal(0, 1, (2, 32)).astype(np.float32)
    oj = np.asarray(model.apply(back, jnp.asarray(np.repeat(xs, 2, 0)), jnp.asarray(eps),
                                method=JCVAE.sample_with_eps))
    with torch.no_grad():
        ot = tm.sample_n(torch.from_numpy(xs), 2, eps=torch.from_numpy(eps)).numpy()
    np.testing.assert_allclose(ot, oj, **TOL)
