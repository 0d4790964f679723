"""The eval scorers: psi_tpu_torch.eval vs psi_tpu.eval (and scipy).

collision_contact_scores: the same bodies, weights and assets (carried
over from psi_tpu with utils/convert_jax.py) on both sides. psi_tpu's
'high' LBS and the port's f32 one differ by ~1e-6 m, so a vertex whose
SDF lies that close to 0 may change sign: the non-collision score is held
to one such vertex, 1 / (N * V); contact is an any() over 300 vertices and
must agree exactly.

diversity_metrics: the fixtures of tests/test_diversity_scipy.py, whose
true entropy is known by construction. The port does not reproduce JAX's
PRNG stream, so it is held to the metric: within 0.02 of the true
entropy (the bound psi_tpu meets), within 0.04 of psi_tpu's (each within
0.02 of the truth), and a distortion no worse than scipy's protocol by 2%.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psi_tpu.body.smplx_model import synthetic_smplx
from psi_tpu.body.vposer import VPoser
from psi_tpu.data.scenes import synthetic_scene_registry
from psi_tpu.data.synthetic import make_assets
from psi_tpu.eval import collision_contact_scores as j_collision
from psi_tpu.eval import diversity_metrics as j_diversity
from psi_tpu.geometry.contact import synthetic_contact_ids
from psi_tpu_torch.eval import collision_contact_scores, diversity_metrics, kmeans
from psi_tpu_torch.utils.convert_jax import SMPLX_FIELDS, scene_assets_from_numpy, smplx_from_numpy, vposer_from_jax

pytest.importorskip("scipy.cluster")
from scipy.cluster import vq as scipy_vq  # noqa: E402
from scipy.stats import entropy as scipy_entropy  # noqa: E402

torch.set_num_threads(1)
N, V, J = 8, 300, 12


def _vposer_variables(rng):
    """Random VPoser variables drawn with numpy from the module's shapes."""
    shapes = jax.eval_shape(VPoser().init, jax.random.PRNGKey(0), jnp.zeros((2, 63)))

    def fill(path, leaf):
        scale = 1 / np.sqrt(np.prod(leaf.shape[:-1])) if path[-1].key == "kernel" else 0.1
        return rng.normal(0, scale, leaf.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def scored():
    """Both packages' scores of one population, half of it sunk into the floor."""
    rng = np.random.default_rng(0)
    smplx = synthetic_smplx(num_verts=V, num_joints=J, seed=0)
    reg = synthetic_scene_registry(num_scenes=2, dim=16, num_verts=200, seed=0)
    ja = make_assets(smplx, _vposer_variables(rng), synthetic_contact_ids(V, n_contact=32, seed=0), reg,
                     sdf_dtype=jnp.bfloat16)
    h = jax.device_get(ja)
    ta = scene_assets_from_numpy(
        smplx_from_numpy(h.smplx.parents, **{f: getattr(h.smplx, f) for f in SMPLX_FIELDS}),
        vposer_from_jax(h.vposer_params), h.contact_vids, h.sdf_packed, h.grid_mins, h.grid_maxs, h.scene_verts,
    )
    x72 = (rng.normal(size=(N, 72)) * 0.3).astype(np.float32)
    x72[:, :3] = 0.0
    sidx = (np.arange(N) % 2).astype(np.int32)
    lo, hi = reg.grid_mins[sidx], reg.grid_maxs[sidx]
    cam = np.tile(np.eye(4, dtype=np.float32), (N, 1, 1))
    height = np.linspace(0.0, 0.6, N)  # from the bottom of the grid to well above the floor
    cam[:, :3, 3] = lo + (hi - lo) * np.stack([np.full(N, 0.5), height, np.full(N, 0.5)], 1)
    return dict(assets=ta, args=(x72, cam, sidx), jax=j_collision(ja, x72, cam, sidx),
                torch=collision_contact_scores(ta, x72, cam, sidx))


def test_collision_contact_scores_match_jax(scored):
    (ncj, ctj), (nct, ctt) = scored["jax"], scored["torch"]
    assert 0.0 < ctj < 1.0 and 0.0 < ncj < 1.0  # the placement both collides and clears
    assert abs(nct - ncj) <= 1.0 / (N * V) + 1e-7, (nct, ncj)
    assert ctt == ctj


def test_collision_scores_take_tensors_or_arrays(scored):
    """numpy arrays or tensors in: the same scores, as python floats."""
    tensors = [torch.from_numpy(a) for a in scored["args"]]
    got = collision_contact_scores(scored["assets"], *tensors)
    assert got == scored["torch"] and all(isinstance(s, float) for s in got)


def _clustered_bodies(rng, n_clusters=20, per_cluster=60, dim=75, spread=0.05):
    centers = rng.uniform(-3, 3, size=(n_clusters, dim))
    pts = centers[:, None, :] + rng.normal(0, spread, size=(n_clusters, per_cluster, dim))
    pts = pts.reshape(-1, dim).astype(np.float32)
    return pts[rng.permutation(len(pts))]


def _fixture(kind):
    """(bodies, true entropy), drawn as tests/test_diversity_scipy.py draws them."""
    rng = np.random.default_rng(0)
    if kind == "balanced":
        return _clustered_bodies(rng), float(np.log(20.0))
    a = _clustered_bodies(rng, n_clusters=5, per_cluster=200, spread=0.02)
    b = _clustered_bodies(rng, n_clusters=15, per_cluster=20, spread=0.02)
    p = np.array([200] * 5 + [20] * 15, np.float64)
    p /= p.sum()
    return np.concatenate([a, b], axis=0), float(-(p * np.log(p)).sum())


def _scipy_protocol(ar, k=20):
    codes, _ = scipy_vq.kmeans(ar.astype(np.float64), k, seed=1)
    vecs, dist = scipy_vq.vq(ar.astype(np.float64), codes)
    counts, _ = np.histogram(vecs, bins=len(codes))
    return float(scipy_entropy(counts)), float(np.mean(dist))


@pytest.mark.parametrize("kind", ["balanced", "unbalanced"])
def test_diversity_recovers_known_entropy_like_jax_and_scipy(kind):
    ar, true_entropy = _fixture(kind)
    ee, md = diversity_metrics(ar, k=20)
    ee_j, md_j = j_diversity(ar, k=20)
    _, md_scipy = _scipy_protocol(ar)
    assert abs(ee - true_entropy) < 0.02, (ee, true_entropy)
    assert abs(ee - ee_j) < 0.04, (ee, ee_j)
    assert md <= md_scipy * 1.02, (md, md_scipy)
    assert md <= md_j * 1.02, (md, md_j)


def test_diversity_accepts_a_tensor_and_is_seeded():
    ar, _ = _fixture("unbalanced")
    a = diversity_metrics(torch.from_numpy(ar), k=20, seed=3)
    assert a == diversity_metrics(ar, k=20, seed=3)


def test_kmeans_assigns_to_the_nearest_centroid():
    x = torch.from_numpy(_fixture("balanced")[0][:300])
    c, a = kmeans(x, k=5, num_iters=10, restarts=3, generator=torch.Generator().manual_seed(0))
    assert c.shape == (5, 75) and a.shape == (300,)
    assert torch.equal(a, torch.cdist(x, c).argmin(dim=1))
