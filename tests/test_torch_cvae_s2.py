"""The Stage-2 CVAE and the converters: psi_tpu_torch (NCHW torch) vs
psi_tpu (NHWC flax), weights carried across by utils/convert_jax.py.

Widths: latentD 32 for both sub-VAEs (their trunks keep f_dim 32 and 128),
32 x 32 snapshots, batch 3. Every weight, BatchNorm statistic and affine
term is random, so the conversion of every tensor is exercised. The noise
is drawn once with jax.random.normal on the keys psi_tpu would use (S2
splits its key into a global and a local one) and injected into the port.

Tolerance: f32 convolutions and matmuls summed in another order, outputs
O(1) -> 1e-4 absolute + 1e-4 relative (tests/test_torch_models.py's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psi_tpu.models import HumanCVAES1 as JS1
from psi_tpu.models import HumanCVAES2 as JS2
from psi_tpu.utils.convert_torch import convert_cvae_s1_state_dict, convert_cvae_s2_state_dict
from psi_tpu_torch.models.cvae_s2 import HumanCVAES2
from psi_tpu_torch.utils.convert_jax import (
    cvae_s1_from_jax,
    cvae_s1_to_jax,
    cvae_s2_from_jax,
    cvae_s2_to_jax,
)
from test_torch_train_objective import numpy_variables

torch.set_num_threads(1)
LATENT, IMAGE, B = 32, 32, 3
TOL = dict(atol=1e-4, rtol=1e-4)


def assert_trees_equal(a, b):
    la, lb = jax.tree_util.tree_leaves_with_path(a), jax.tree_util.tree_leaves_with_path(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=jax.tree_util.keystr(path))


@pytest.fixture(scope="module")
def s2():
    model = JS2(latentD_g=LATENT, latentD_l=LATENT)
    v = numpy_variables(model, np.random.default_rng(0), jnp.zeros((1, 75)), jnp.zeros((1, IMAGE, IMAGE, 2)))
    return model, v, cvae_s2_from_jax(v)


@pytest.fixture(scope="module")
def s1():
    model = JS1(latentD=LATENT)
    v = numpy_variables(model, np.random.default_rng(1), jnp.zeros((1, 75)), jnp.zeros((1, IMAGE, IMAGE, 2)))
    return model, v, cvae_s1_from_jax(v)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(2)
    return (rng.uniform(-1, 1, (B, IMAGE, IMAGE, 2)).astype(np.float32),
            rng.normal(0, 0.5, (B, 75)).astype(np.float32))


def _split_noise(key, n, d=32):
    """The (global, local) normals psi_tpu's HumanCVAES2 draws from ``key``."""
    kg, kl = jax.random.split(key)
    return np.array(jax.random.normal(kg, (n, d))), np.array(jax.random.normal(kl, (n, d)))


def test_forward_matches_flax_with_injected_noise(s2, inputs):
    """(x_rec, mu_g, logvar_g, mu_l, logvar_l); the local VAE conditions on
    the reconstructed translation, so x_rec's local part checks the chain."""
    model, v, tm = s2
    xs, xb = inputs
    key = jax.random.PRNGKey(11)
    outs_j = model.apply(v, jnp.asarray(xb), jnp.asarray(xs), key)
    eg, el = _split_noise(key, B)
    with torch.no_grad():
        outs_t = tm(torch.from_numpy(xb), torch.from_numpy(xs), eps_g=torch.from_numpy(eg), eps_l=torch.from_numpy(el))
    assert len(outs_t) == len(outs_j) == 5 and outs_t[0].shape == (B, 75)
    for a, b in zip(outs_t, outs_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_posterior_mean_forward_matches_flax(s2, inputs):
    model, v, tm = s2
    xs, xb = inputs
    outs_j = model.apply(v, jnp.asarray(xb), jnp.asarray(xs))
    with torch.no_grad():
        outs_t = tm(torch.from_numpy(xb), torch.from_numpy(xs))
    for a, b in zip(outs_t, outs_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_sample_and_sample_n_match_flax(s2, inputs):
    model, v, tm = s2
    xs = inputs[0]
    key = jax.random.PRNGKey(12)
    oj = np.asarray(model.apply(v, jnp.asarray(xs), key, method=JS2.sample))
    eg, el = (torch.from_numpy(e) for e in _split_noise(key, B))
    with torch.no_grad():
        ot = tm.sample(torch.from_numpy(xs), eps_g=eg, eps_l=el).numpy()
    np.testing.assert_allclose(ot, oj, **TOL)
    n = 5
    oj = np.asarray(model.apply(v, jnp.asarray(xs[:1]), n, key, method=JS2.sample_n))
    eg, el = (torch.from_numpy(e) for e in _split_noise(key, n))
    with torch.no_grad():
        ot = tm.sample_n(torch.from_numpy(xs[:1]), n, eps_g=eg, eps_l=el).numpy()
    assert ot.shape == (n, 75)
    np.testing.assert_allclose(ot, oj, **TOL)


def test_encode_scenes_and_sample_with_feats_match_flax(s2, inputs):
    """Covers fc's flatten permutation at both trunk widths (f_dim 32, 128)."""
    model, v, tm = s2
    xs = inputs[0]
    zg_j, zl_j = model.apply(v, jnp.asarray(xs), method=JS2.encode_scenes)
    with torch.no_grad():
        zg_t, zl_t = tm.encode_scenes(torch.from_numpy(xs))
    np.testing.assert_allclose(zg_t.numpy(), np.asarray(zg_j), **TOL)
    np.testing.assert_allclose(zl_t.numpy(), np.asarray(zl_j), **TOL)
    key = jax.random.PRNGKey(13)
    oj = np.asarray(model.apply(v, zg_j, zl_j, key, method=JS2.sample_with_feats))
    eg, el = (torch.from_numpy(e) for e in _split_noise(key, B))
    with torch.no_grad():
        ot = tm.sample_with_feats(zg_t, zl_t, eps_g=eg, eps_l=el).numpy()
    np.testing.assert_allclose(ot, oj, **TOL)


def test_generator_draws_global_then_local(s2, inputs):
    """With a generator the port draws the global latent first, then the
    local one: the same as injecting those two draws."""
    _, _, tm = s2
    xs, xb = (torch.from_numpy(a) for a in inputs)
    g = torch.Generator().manual_seed(3)
    eg, el = torch.randn((B, 32), generator=g), torch.randn((B, 32), generator=g)
    with torch.no_grad():
        a = tm(xb, xs, generator=torch.Generator().manual_seed(3))
        b = tm(xb, xs, eps_g=eg, eps_l=el)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_s1_sample_with_feat_matches_flax(s1, inputs):
    model, v, tm = s1
    xs = inputs[0]
    key = jax.random.PRNGKey(14)
    z_j = model.apply(v, jnp.asarray(xs), method=JS1.encode_scene)
    oj = np.asarray(model.apply(v, z_j, key, method=JS1.sample_with_feat))
    eps = torch.from_numpy(np.array(jax.random.normal(key, (B, 32))))
    with torch.no_grad():
        ot = tm.sample_with_feat(tm.encode_scene(torch.from_numpy(xs)), eps=eps).numpy()
    np.testing.assert_allclose(ot, oj, **TOL)


def test_s1_forward_with_injected_noise_matches_flax(s1, inputs):
    model, v, tm = s1
    xs, xb = inputs
    key = jax.random.PRNGKey(15)
    outs_j = model.apply(v, jnp.asarray(xb), jnp.asarray(xs), key)
    eps = torch.from_numpy(np.array(jax.random.normal(key, (B, 32))))
    with torch.no_grad():
        outs_t = tm(torch.from_numpy(xb), torch.from_numpy(xs), eps=eps)
    for a, b in zip(outs_t, outs_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_state_dict_names_are_the_reference_checkpoints(s2):
    _, _, tm = s2
    sd = {k for k in tm.state_dict() if not k.endswith("num_batches_tracked")}
    assert {k.split(".")[0] for k in sd} == {"trans_vae", "pose_vae"}
    for name in ("trans_vae.resnet.0.weight", "pose_vae.resnet.5.0.downsample.1.running_var", "trans_vae.conv.bias",
                 "pose_vae.fc.weight", "trans_vae.torso_linear.weight", "pose_vae.pose_linear.bias",
                 "pose_vae.encode.1.fc2.weight", "trans_vae.mean_linear.bias", "pose_vae.log_var_linear.weight",
                 "trans_vae.decode.0.weight", "pose_vae.decode.2.fc1.bias", "trans_vae.decode.3.weight"):
        assert name in sd, name
    assert "trans_vae.pose_linear.weight" not in sd


def test_reference_converter_reads_the_ports_state_dict():
    """psi_tpu's own converter for reference .ckp state dicts (which expects
    the 128-pixel snapshots' 16 x 16 features) reads the port's state dict
    as it stands and gives back the variables it came from."""
    model = JS2(latentD_g=8, latentD_l=8)
    v = numpy_variables(model, np.random.default_rng(4), jnp.zeros((1, 75)), jnp.zeros((1, 128, 128, 2)))
    tm = cvae_s2_from_jax(v)
    sd = {k: t.numpy() for k, t in tm.state_dict().items() if not k.endswith("num_batches_tracked")}
    assert_trees_equal(convert_cvae_s2_state_dict(sd), jax.device_get(v))


@pytest.mark.parametrize("which", ["s1", "s2"])
def test_to_jax_inverts_from_jax(which, s1, s2):
    _, v, tm = s1 if which == "s1" else s2
    back = (cvae_s1_to_jax if which == "s1" else cvae_s2_to_jax)(tm)
    assert_trees_equal(back, jax.device_get(v))


def test_from_jax_inverts_to_jax_from_a_port_model():
    tm = HumanCVAES2(latentD_g=16, latentD_l=24, image_size=IMAGE)
    back = cvae_s2_from_jax(cvae_s2_to_jax(tm))
    for (k, a), (k2, b) in zip(tm.state_dict().items(), back.state_dict().items()):
        assert k == k2 and torch.equal(a, b), k


def test_converters_return_eval_mode_unless_asked(s1, s2):
    assert not s1[2].training and not s2[2].training
    assert cvae_s1_from_jax(s1[1], train=True).training
    assert cvae_s2_from_jax(s2[1], train=True).training


def test_s1_reference_converter_roundtrip_unchanged():
    """S1's state-dict names, after the converter was rewritten around a
    shared scene-encoder loader."""
    model = JS1(latentD=8)
    v = numpy_variables(model, np.random.default_rng(6), jnp.zeros((1, 75)), jnp.zeros((1, 128, 128, 2)))
    tm = cvae_s1_from_jax(v)
    sd = {k: t.numpy() for k, t in tm.state_dict().items() if not k.endswith("num_batches_tracked")}
    assert_trees_equal(convert_cvae_s1_state_dict(sd), jax.device_get(v))
