"""One-sided chamfer NN: the port's K3 twin vs psi_tpu's Pallas kernel
(interpret mode) and jnp reference. The CUDA kernel vs the twin is in
test_torch_kernels.py, which runs on a card without JAX.

Distances agree to 1e-5 relative: both sides recompute the f32 distance
to the winner, and the winners coincide except between near-equidistant
points, where psi_tpu's |y|^2 - 2x.y argmin (split-bf16 cross term in the
kernel) may pick the other one (ROADMAP Queue C, chamfer near-ties).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psi_tpu.ops import chamfer as jch
from psi_tpu_torch.ops import chamfer as tch

torch.set_num_threads(1)
B, N, M = 3, 200, 700


@pytest.fixture(scope="module")
def clouds():
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1.0, (B, N, 3)).astype(np.float32)
    y = rng.uniform(-2, 2, (B, M, 3)).astype(np.float32)
    y[:, -20:] = 1.0e5  # registry-style far padding never wins
    return x, y


@pytest.mark.parametrize("implementation", ["pallas", "reference"])
def test_nn_distance_matches_jax(clouds, implementation):
    x, y = clouds
    dj, ynn_j = jch.chamfer_one_sided_nn(jnp.asarray(x), jnp.asarray(y), implementation=implementation)
    dt, ynn_t = tch.chamfer_one_sided_nn(torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-5, atol=0)
    _, _, ij, _ = jch.chamfer_with_idx(jnp.asarray(x), jnp.asarray(y), implementation=implementation)
    it = tch.nn_argmin(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    differ = it != np.asarray(ij)
    # index disagreements only where the two winners are equidistant
    assert differ.mean() < 0.01
    assert np.all(np.isclose(dt.numpy()[differ], np.asarray(dj)[differ], rtol=1e-5, atol=0))
    assert np.all(ynn_t.numpy()[~differ] == np.asarray(ynn_j)[~differ])


def test_nn_ties_go_to_lowest_index():
    """Duplicated points: strict < while scanning upward -> first copy."""
    y = np.zeros((2, 6, 3), np.float32)
    y[:, 1] = [1.0, 0.0, 0.0]
    y[:, 4] = [1.0, 0.0, 0.0]  # duplicate of point 1
    y[:, 5] = [0.0, 0.0, 0.0]  # duplicate of point 0
    y[:, 2:4] = 5.0
    x = np.array([[[0.9, 0.0, 0.0], [0.1, 0.0, 0.0], [0.5, 0.0, 0.0]]] * 2, np.float32)
    idx = tch.nn_argmin(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    # x=0.5 is equidistant from points 0/5 and 1/4: the lowest index wins
    np.testing.assert_array_equal(idx, [[1, 0, 0], [1, 0, 0]])


def test_chamfer_one_sided_gradient_matches_jax(clouds):
    """d1's gradient scatters into both clouds (the reference CUDA backward)."""
    x, y = clouds
    w = np.random.default_rng(1).normal(size=(B, N)).astype(np.float32)

    def f(a, b):
        return jnp.sum(jch.chamfer_one_sided(a, b, implementation="reference") * w)

    gxj, gyj = jax.grad(f, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))
    xt = torch.from_numpy(x).requires_grad_(True)
    yt = torch.from_numpy(y).requires_grad_(True)
    d = tch.chamfer_one_sided(xt, yt)
    (d * torch.from_numpy(w)).sum().backward()
    # psi_tpu's reference path returns the minimum of |x|^2 + |y|^2 - 2x.y,
    # whose f32 cancellation error is ~eps * (|x|^2 + |y|^2) ~ 1e-6 here;
    # the port recomputes (x - y)^2 from the winner (measured gap 1.8e-6)
    np.testing.assert_allclose(d.detach().numpy(), np.asarray(jch.chamfer_one_sided(
        jnp.asarray(x), jnp.asarray(y), implementation="reference")), rtol=1e-5, atol=5e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gxj), rtol=0, atol=1e-5)
    np.testing.assert_allclose(yt.grad.numpy(), np.asarray(gyj), rtol=0, atol=1e-5)


def test_one_sided_nn_gradient_flows_to_x_only(clouds):
    x, y = clouds
    xt = torch.from_numpy(x).requires_grad_(True)
    yt = torch.from_numpy(y).requires_grad_(True)
    d, y_nn = tch.chamfer_one_sided_nn(xt, yt)
    d.sum().backward()
    assert yt.grad is None and not y_nn.requires_grad
    np.testing.assert_allclose(xt.grad.numpy(), 2 * (x - y_nn.numpy()), rtol=1e-6, atol=1e-6)


def test_twin_chunking_is_exact(monkeypatch, clouds):
    """The twin's body/point chunking does not change the answer."""
    x, y = clouds
    full = tch.nn_argmin_reference(torch.from_numpy(x), torch.from_numpy(y))
    monkeypatch.setattr(tch, "_TWIN_CHUNK", 3 * M * 7)  # 7 points per chunk
    np.testing.assert_array_equal(tch.nn_argmin_reference(torch.from_numpy(x), torch.from_numpy(y)), full)
