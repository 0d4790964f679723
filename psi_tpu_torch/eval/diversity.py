"""Diversity evaluation: k-means cluster entropy and mean centroid distance.

Port of ``psi_tpu.eval.diversity`` (the protocol of the reference's
utils_eval_diversity.py:93-104: k-means with k=20, entropy of the
cluster sizes, mean euclidean distance to the assigned centroid). The
k-means is Lloyd's iteration with k-means++ seeding and several restarts
batched together, keeping the lowest-distortion codebook, as scipy's
kmeans keeps the best of its runs.

Randomness: the seeding draws uniforms from an explicit CPU
``torch.Generator`` and turns them into indices by inverse CDF on the
data's device, so a run on the card and one on the CPU pick the same
seeds. It does not reproduce JAX's PRNG stream: the metric is what is
matched (tests/test_torch_eval.py).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from psi_tpu_torch.utils.precision import strict_f32


def _sqdist(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """x [N, D], c [R, K, D] -> [R, N, K] squared distances."""
    return (x * x).sum(1)[None, :, None] + (c * c).sum(2)[:, None, :] - 2.0 * torch.matmul(x, c.transpose(1, 2))


def _kmeanspp_init(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """k-means++ seeding of R restarts from uniforms u [R, k] in [0, 1):
    the first center uniformly, each next one with probability
    proportional to its squared distance from the chosen set."""
    n = x.shape[0]
    idx = torch.clamp((u[:, 0] * n).long(), max=n - 1)
    centers = [x[idx]]  # each [R, D]
    mind = ((x[None] - centers[0][:, None]) ** 2).sum(-1)  # [R, n]
    for i in range(1, u.shape[1]):
        cdf = torch.cumsum(torch.clamp(mind, min=1e-30).double(), dim=1)
        idx = torch.searchsorted(cdf, (u[:, i] * cdf[:, -1])[:, None], right=True)[:, 0]
        c = x[torch.clamp(idx, max=n - 1)]
        centers.append(c)
        mind = torch.minimum(mind, ((x[None] - c[:, None]) ** 2).sum(-1))
    return torch.stack(centers, dim=1)  # [R, k, D]


def _lloyd(x: torch.Tensor, centroids: torch.Tensor, num_iters: int):
    """Lloyd iterations of R codebooks [R, k, D] at once; an empty cluster
    keeps its centroid. Returns (centroids, assignment [R, N], distortion [R])."""
    k = centroids.shape[1]
    for _ in range(num_iters):
        one_hot = F.one_hot(_sqdist(x, centroids).argmin(dim=2), k).to(x.dtype)  # [R, N, k]
        counts = one_hot.sum(dim=1)  # [R, k]
        new = torch.matmul(one_hot.transpose(1, 2), x) / torch.clamp(counts, min=1.0)[..., None]
        centroids = torch.where((counts > 0)[..., None], new, centroids)
    d = _sqdist(x, centroids)
    distortion = torch.sqrt(torch.clamp(d.amin(dim=2), min=0.0)).mean(dim=1)
    return centroids, d.argmin(dim=2), distortion


def kmeans(
    x: torch.Tensor, k: int = 20, num_iters: int = 50, restarts: int = 10, *, generator: torch.Generator
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Restarted k-means++ Lloyd: x [N, D] -> (centroids [k, D], assignment [N]).
    ``generator`` is a CPU generator whatever the device of x."""
    if generator.device.type != "cpu":
        raise ValueError("kmeans draws its seeding on a CPU generator, so that every device picks the same seeds")
    u = torch.rand((restarts, k), generator=generator, dtype=torch.float64).to(x.device)
    with strict_f32():
        centroids, assign, distortion = _lloyd(x, _kmeanspp_init(x, u), num_iters)
    best = distortion.argmin()
    return centroids[best], assign[best]


def diversity_metrics(body_vecs, k: int = 20, seed: int = 0) -> Tuple[float, float]:
    """(cluster entropy, mean distance to the assigned centroid) over
    [N, 72/75] body vectors (a tensor, on its device, or a numpy array)."""
    x = torch.as_tensor(body_vecs, dtype=torch.float32)
    centroids, assign = kmeans(x, k=k, generator=torch.Generator().manual_seed(seed))
    counts = torch.bincount(assign, minlength=k).double()
    p = counts / counts.sum()
    p = p[p > 0]
    entropy = -(p * torch.log(p)).sum().item()
    dists = torch.linalg.vector_norm(x - centroids[assign], dim=1)
    return entropy, dists.mean().item()
