"""psi_tpu_torch's VPoser (encoder, full VAE, BatchNorm1d, dropout) against
psi_tpu's on the same weights, and the converters both ways.

Width 32 (latentD 32, 21 joints), batch 8; weights drawn by the port's
seeded init and carried to psi_tpu with ``vposer_to_jax``, running
statistics moved off identity so eval mode reads them. Tolerances: eval-mode
mean and std 1e-5, pose_aa 1e-4 absolute (the 6D -> matrix -> axis-angle
chain); BatchNorm1d running statistics after one train-mode batch 1e-6
(flax's E[x^2] - mean^2 against torch's two-pass variance).
"""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psi_tpu.body.vposer import VPoser as JVPoser
from psi_tpu_torch.body.vposer import VPoser, synthetic_vposer, vposer_decode
from psi_tpu_torch.nn import layers
from psi_tpu_torch.nn.layers import BatchNorm1d, Dropout
from psi_tpu_torch.utils.convert_jax import vposer_from_jax, vposer_to_jax
from psi_tpu_torch.utils.convert_torch import vposer_from_state_dict
from psi_tpu_torch.utils.init import seeded_init_

torch.set_num_threads(1)
B, WIDTH, LATENT = 8, 32, 32
# sha256 of synthetic_vposer(0)'s decoder weights (bodyprior_dec_* in state-dict
# order, float32 bytes), taken on the decoder-only module that preceded the encoder
DECODER_SHA256 = "3ad912ed62488ab74c1518428fb07101d3036681edc69dcdc6979bdf81522e65"


@pytest.fixture(scope="module")
def pair():
    """(port VPoser in eval mode, psi_tpu variables on its weights, poses)."""
    vp = seeded_init_(VPoser(num_neurons=WIDTH, latentD=LATENT), 3)
    rng = np.random.default_rng(4)
    with torch.no_grad():
        for bn in (vp.bodyprior_enc_bn1, vp.bodyprior_enc_bn2):
            n = bn.num_features
            bn.running_mean.copy_(torch.from_numpy(rng.normal(0, 0.3, n).astype(np.float32)))
            bn.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, n).astype(np.float32)))
            bn.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, n).astype(np.float32)))
            bn.bias.copy_(torch.from_numpy(rng.normal(0, 0.1, n).astype(np.float32)))
    poses = rng.normal(0, 0.4, (B, 63)).astype(np.float32)
    return vp.eval(), jax.tree_util.tree_map(jnp.asarray, vposer_to_jax(vp)), poses


def _jmodel():
    return JVPoser(num_neurons=WIDTH, latentD=LATENT)


def test_eval_mode_encode_and_forward_match_psi_tpu(pair):
    vp, jvars, poses = pair
    jm = _jmodel()
    jmean, jstd = jm.apply(jvars, jnp.asarray(poses), method=JVPoser.encode)
    jout = jm.apply(jvars, jnp.asarray(poses))
    with torch.no_grad():
        mean, std = vp.encode(torch.from_numpy(poses))
        out = vp(torch.from_numpy(poses))
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), atol=1e-5, rtol=0)
    np.testing.assert_allclose(std.numpy(), np.asarray(jstd), atol=1e-5, rtol=0)
    np.testing.assert_allclose(out["mean"].numpy(), np.asarray(jout["mean"]), atol=1e-5, rtol=0)
    np.testing.assert_allclose(out["pose_aa"].numpy(), np.asarray(jout["pose_aa"]), atol=1e-4, rtol=0)
    assert torch.equal(out["mean"], mean)  # eval mode, no eps: z = mean
    with torch.no_grad():
        np.testing.assert_allclose(out["pose_aa"].numpy(), vposer_decode(vp, mean).numpy(), atol=0, rtol=0)


def test_train_mode_forward_and_batchnorm_statistics_match_psi_tpu(pair, monkeypatch):
    """One train-mode batch: the same noise and the same dropout masks on
    both sides (psi_tpu's recorded by wrapping jax.random.bernoulli, fed to
    the port by patching its mask draw); the outputs and the BatchNorms'
    new running statistics agree."""
    vp, jvars, poses = pair
    key = jax.random.PRNGKey(7)
    nkey, dkey = jax.random.split(key)
    masks = []
    real = jax.random.bernoulli

    def recording(*args, **kw):
        m = real(*args, **kw)
        masks.append(np.asarray(m))
        return m

    monkeypatch.setattr(jax.random, "bernoulli", recording)
    with jax.disable_jit():
        jout, new_state = _jmodel().apply(jvars, jnp.asarray(poses), deterministic=False, rng_key=nkey,
                                          mutable=["batch_stats"], rngs={"dropout": dkey})
    assert [m.shape for m in masks] == [(B, WIDTH), (B, WIDTH)]  # the encoder's, then the decoder's
    eps = np.array(jax.random.normal(nkey, (B, LATENT)))

    feed = [torch.from_numpy(np.array(m)) for m in masks]
    monkeypatch.setattr(layers, "dropout_mask", lambda shape, keep, gen, device: feed.pop(0))
    port = VPoser(num_neurons=WIDTH, latentD=LATENT)
    port.load_state_dict(vp.state_dict())
    port.train()
    out = port(torch.from_numpy(poses), eps=torch.from_numpy(eps), generator=torch.Generator())
    assert not feed
    for k in ("mean", "std"):
        np.testing.assert_allclose(out[k].detach().numpy(), np.asarray(jout[k]), atol=1e-5, rtol=0)
    np.testing.assert_allclose(out["pose_aa"].detach().numpy(), np.asarray(jout["pose_aa"]), atol=1e-4, rtol=0)
    for name in ("enc_bn1", "enc_bn2"):
        bn = getattr(port, f"bodyprior_{name}")
        js = new_state["batch_stats"][name]
        np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(js["mean"]), atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(js["var"]), atol=1e-6, rtol=1e-6)
        assert not torch.equal(bn.running_mean, vp.state_dict()[f"bodyprior_{name}.running_mean"])


def test_train_mode_draws_only_from_the_generator_it_is_given(pair):
    vp, _, poses = pair
    port = VPoser(num_neurons=WIDTH, latentD=LATENT)
    port.load_state_dict(vp.state_dict())
    port.train()
    x = torch.from_numpy(poses)
    with pytest.raises(ValueError):
        port(x)  # no generator, no eps
    torch.manual_seed(0)
    a = port(x, generator=torch.Generator().manual_seed(5))["pose_aa"]
    torch.manual_seed(1)  # torch's global state plays no part
    port.load_state_dict(vp.state_dict())
    b = port(x, generator=torch.Generator().manual_seed(5))["pose_aa"]
    assert torch.equal(a, b)
    c = port(x, generator=torch.Generator().manual_seed(6))["pose_aa"]
    assert not torch.equal(a, c)
    with pytest.raises(ValueError):
        Dropout(0.1)(x, deterministic=False)


def test_vposer_decode_drops_nothing_in_train_mode(pair):
    vp, _, _ = pair
    z = torch.from_numpy(np.random.default_rng(2).normal(size=(B, LATENT)).astype(np.float32))
    with torch.no_grad():
        want = vposer_decode(vp, z)
        vp.train()
        try:
            got = vposer_decode(vp, z)
        finally:
            vp.eval()
    assert torch.equal(got, want)


def test_batchnorm1d_has_flax_defaults():
    bn = BatchNorm1d(5)
    assert bn.momentum == 0.01 and bn.eps == 1e-5 and isinstance(bn, torch.nn.BatchNorm1d)


def test_jax_round_trip_is_exact(pair):
    vp, jvars, _ = pair
    back = vposer_from_jax(jax.device_get(jvars))
    assert not back.training
    for k, v in vp.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(back.state_dict()[k], v), k
    again = vposer_to_jax(back)
    for (pa, a), (pb, b) in zip(jax.tree_util.tree_leaves_with_path(again),
                                jax.tree_util.tree_leaves_with_path(jax.device_get(jvars))):
        assert pa == pb and np.array_equal(a, np.asarray(b)), pa


def test_from_jax_keeps_a_decoder_only_tree():
    from psi_tpu.body.vposer import synthetic_vposer_params

    full = jax.device_get(synthetic_vposer_params(0))
    dec = {"params": {k: v for k, v in full["params"].items() if k.startswith("dec_")}}
    a, b = vposer_from_jax(full), vposer_from_jax(dec)
    for k in ("bodyprior_dec_fc1.weight", "bodyprior_dec_out.bias"):
        assert torch.equal(a.state_dict()[k], b.state_dict()[k])
    assert not torch.equal(a.bodyprior_enc_fc1.weight, b.bodyprior_enc_fc1.weight)


def test_state_dict_with_encoder_and_decoder_only_both_load(pair):
    vp, _, poses = pair
    full = {k: v.numpy() for k, v in vp.state_dict().items()}
    loaded = vposer_from_state_dict(full)
    for k, v in vp.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k
    no_counter = {k: v for k, v in full.items() if not k.endswith("num_batches_tracked")}
    vposer_from_state_dict(no_counter)  # older torch wrote BatchNorm without its counter
    dec_only = {k: v for k, v in full.items() if k.startswith("bodyprior_dec_")}
    d = vposer_from_state_dict(dec_only)
    z = torch.from_numpy(np.random.default_rng(1).normal(size=(B, LATENT)).astype(np.float32))
    with torch.no_grad():
        assert torch.equal(vposer_decode(d, z), vposer_decode(vp, z))
    partial = dict(dec_only, **{"bodyprior_enc_fc1.weight": full["bodyprior_enc_fc1.weight"]})
    with pytest.raises(KeyError, match="partial encoder"):
        vposer_from_state_dict(partial)


def test_synthetic_vposer_decoder_weights_are_unchanged_by_the_encoder():
    vp = synthetic_vposer(0)
    h = hashlib.sha256()
    for k, t in vp.state_dict().items():
        if k.startswith("bodyprior_dec_"):
            h.update(t.numpy().tobytes())
    assert h.hexdigest() == DECODER_SHA256
    assert not vp.training
    for bn in (vp.bodyprior_enc_bn1, vp.bodyprior_enc_bn2):  # reset to identity statistics
        assert torch.equal(bn.running_mean, torch.zeros_like(bn.running_mean))
        assert torch.equal(bn.running_var, torch.ones_like(bn.running_var))
