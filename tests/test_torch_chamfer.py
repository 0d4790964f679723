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


def test_nn_argmin_returns_int64(clouds):
    x, y = clouds
    idx = tch.nn_argmin(torch.from_numpy(x), torch.from_numpy(y))
    assert idx.dtype == torch.int64 and idx.shape == (B, N)
    assert int(idx.min()) >= 0 and int(idx.max()) < M - 20  # the far padding never wins


@pytest.fixture(scope="module")
def near_clouds(clouds):
    """The same clouds without the far padding: in the two-sided op every y
    point is also a query, and psi_tpu's |y|^2 - 2x.y argmin cannot tell the
    x points apart from 1e5 away (its cross term is good to ~4e-5 of |y|^2),
    so there it and an exact search rightly pick different winners."""
    x, y = clouds
    return x, np.ascontiguousarray(y[:, :-20])


@pytest.mark.parametrize("implementation", ["pallas", "reference"])
def test_chamfer_distance_matches_jax(near_clouds, implementation):
    """The two-sided distance: K3's second caller, two searches with the
    clouds swapped. Indices are compared through the distances: psi_tpu's
    argmin may take the other of two near-equidistant points."""
    x, y = near_clouds
    d1j, d2j = jch.chamfer_distance(jnp.asarray(x), jnp.asarray(y), implementation=implementation)
    d1t, d2t = tch.chamfer_distance(torch.from_numpy(x), torch.from_numpy(y))
    assert d1t.shape == (B, N) and d2t.shape == (B, M - 20)
    # 'pallas' recomputes (x - y)^2 from its winner, as the port does;
    # 'reference' returns the minimum of |x|^2 + |y|^2 - 2x.y, whose f32
    # cancellation error is ~eps * (|x|^2 + |y|^2) ~ 1e-6 at these clouds
    atol = 0 if implementation == "pallas" else 5e-6
    np.testing.assert_allclose(d1t.numpy(), np.asarray(d1j), rtol=1e-5, atol=atol)
    np.testing.assert_allclose(d2t.numpy(), np.asarray(d2j), rtol=1e-5, atol=atol)


@pytest.mark.parametrize("implementation", ["pallas", "reference"])
def test_chamfer_distance_gradients_match_jax(near_clouds, implementation):
    """Each direction's gradient flows to its own point and scatters into
    the winner of the other cloud (the reference CUDA backward)."""
    x, y = near_clouds
    rng = np.random.default_rng(2)
    w1 = rng.normal(size=(B, N)).astype(np.float32)
    w2 = rng.normal(size=(B, M - 20)).astype(np.float32)

    def f(a, b):
        d1, d2 = jch.chamfer_distance(a, b, implementation=implementation)
        return jnp.sum(d1 * w1) + jnp.sum(d2 * w2)

    gxj, gyj = jax.grad(f, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))
    xt = torch.from_numpy(x).requires_grad_(True)
    yt = torch.from_numpy(y).requires_grad_(True)
    d1, d2 = tch.chamfer_distance(xt, yt)
    ((d1 * torch.from_numpy(w1)).sum() + (d2 * torch.from_numpy(w2)).sum()).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gxj), rtol=0, atol=1e-5)
    np.testing.assert_allclose(yt.grad.numpy(), np.asarray(gyj), rtol=0, atol=1e-5)


def test_chamfer_distance_gradient_flows_to_one_cloud_alone(clouds):
    x, y = clouds
    xt = torch.from_numpy(x).requires_grad_(True)
    d1, d2 = tch.chamfer_distance(xt, torch.from_numpy(y))
    (d1.sum() + d2.sum()).backward()
    assert xt.grad.shape == xt.shape and bool(torch.isfinite(xt.grad).all())


def test_chamfer_with_idx_matches_jax_exactly():
    """Coordinates on a 1/64 grid in [-2, 2): every product and sum of the
    distance is exact in f32 in either formula, so both sides see the same
    distances, ties included, and both take the lowest index."""
    rng = np.random.default_rng(3)
    x = (rng.integers(-128, 128, (2, 150, 3)) / 64.0).astype(np.float32)
    y = (rng.integers(-128, 128, (2, 260, 3)) / 64.0).astype(np.float32)
    d1j, d2j, i1j, i2j = jch.chamfer_with_idx(jnp.asarray(x), jnp.asarray(y), implementation="reference")
    d1t, d2t, i1t, i2t = tch.chamfer_with_idx(torch.from_numpy(x), torch.from_numpy(y))
    assert i1t.dtype == i2t.dtype == torch.int64 and not d1t.requires_grad
    np.testing.assert_array_equal(i1t.numpy(), np.asarray(i1j))
    np.testing.assert_array_equal(i2t.numpy(), np.asarray(i2j))
    np.testing.assert_array_equal(d1t.numpy(), np.asarray(d1j))
    np.testing.assert_array_equal(d2t.numpy(), np.asarray(d2j))


def test_chamfer_distance_first_direction_is_the_one_sided_op(clouds):
    x, y = clouds
    d1, _ = tch.chamfer_distance(torch.from_numpy(x), torch.from_numpy(y))
    assert torch.equal(d1, tch.chamfer_one_sided(torch.from_numpy(x), torch.from_numpy(y)))
