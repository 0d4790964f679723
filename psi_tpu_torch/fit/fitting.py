"""Scene-aware fitting refinement — the serving path's optimisation loop.

Port of ``psi_tpu.fit.fitting`` (reference source/fitting_proxe.py:
42-263): refine every generated body against its scene with Adam over
L1-to-initial + VPoser z^2 + chamfer contact + SDF penetration. Each
body's parameters only touch its own loss term, so the population is one
batch and the summed loss gives every body its own gradient. Adam state
starts fresh per population (psi_tpu's semantics, not the reference's
carried-over state).

The iteration schedule is static and matches psi_tpu's block schedule
exactly (``fit_schedule``). With ``refresh_every > 1`` there are three
pass kinds:
* full — NN search over the (pruned) scene cloud and a real packed-SDF
  gather per vertex; emits the frozen state (each contact vertex's NN
  scene point, each vertex's SDF cell corners);
* nn_only — a fresh NN search, collision against the carried cells;
* cheap — contact against the frozen correspondences, collision against
  the carried cells: no search and no gathers.
``refresh_every == 1`` (the exact tier) runs a full pass every iteration
with the two-cloud-gradient ``chamfer_one_sided``.

On the card the fused tier's decode runs kernels K1 (forward) and K2
(backward) every iteration and the NN search runs kernel K3 on every
full and nn_only pass.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from psi_tpu_torch.body.decode import body_vec_to_verts
from psi_tpu_torch.body.smplx_model import make_fused_bundle
from psi_tpu_torch.gen.sample import generate_bodies
from psi_tpu_torch.geometry.bodyvec import convert_to_3D_rot, convert_to_6D_rot
from psi_tpu_torch.models.cvae_s1 import HumanCVAES1
from psi_tpu_torch.ops.chamfer import chamfer_one_sided, chamfer_one_sided_nn
from psi_tpu_torch.ops.prune import select_near_tiles
from psi_tpu_torch.ops.sdf import (
    sdf_trilinear_from_cache,
    sdf_trilinear_packed,
    sdf_trilinear_packed_cached,
)
from psi_tpu_torch.train.objective import SceneAssets
from psi_tpu_torch.utils.config import FitConfig
from psi_tpu_torch.utils.precision import strict_f32

LBS_PRECISIONS = ("high", "fast", "fused")


def _per_body_losses(
    assets: SceneAssets,
    xhr: torch.Tensor,  # [N, 75]
    xhr_init: torch.Tensor,  # [N, 75]
    cam_ext: torch.Tensor,  # [N, 4, 4]
    scene_idx: torch.Tensor,  # [N] int64
    cfg: FitConfig,
    sel=None,
    fresh_nn: Optional[bool] = None,
    fresh_sdf: Optional[bool] = None,
    fused_bundle=None,
) -> Tuple[torch.Tensor, Tuple[Dict[str, torch.Tensor], Tuple]]:
    """Summed loss with per-body terms (reference fitting_proxe.py:101-162).

    sel=None is the full pass; sel=(y_nn, sdf_cache) with fresh_nn=True,
    fresh_sdf=False the nn_only pass; with both False the cheap pass.
    Returns (sum, (metrics, (y_nn, sdf_cache))): per-body metrics [N] and
    the state the next passes carry (None entries when refresh is off).
    """
    if fresh_nn is None:
        fresh_nn = sel is None
    if fresh_sdf is None:
        fresh_sdf = sel is None
    # |d| with jnp.abs's derivative, +1 at d == 0 (torch.abs has 0 there).
    # Every fit starts at d == 0, so this sets Adam's first step on every
    # coordinate whose other terms are flat.
    d = xhr - xhr_init
    loss_rec = cfg.weight_loss_rec * torch.mean(torch.where(d >= 0, d, -d), dim=1)  # [N]

    xh = convert_to_3D_rot(xhr)  # [N, 72]
    loss_vposer = cfg.weight_loss_vposer * torch.mean(xh[:, 16:48] ** 2, dim=1)

    verts = body_vec_to_verts(
        assets.smplx, assets.vposer, xh, cam_ext,
        precision=cfg.lbs_precision, fused_bundle=fused_bundle,
    )[0]
    contact_verts = verts[:, assets.contact_vids, :]

    if sel is not None and not fresh_nn:
        y_nn = sel[0]
        d1 = torch.sum((contact_verts - y_nn) ** 2, dim=-1)  # frozen correspondence
    else:
        scene_pts = assets.scene_verts[scene_idx]
        ks = cfg.prune_scene_points
        if ks and ks < scene_pts.shape[1]:
            # keep the ~K scene points nearest each body's contact centroid
            scene_pts = select_near_tiles(scene_pts, torch.mean(contact_verts, dim=1), ks)
        if cfg.refresh_every > 1:
            d1, y_nn = chamfer_one_sided_nn(contact_verts, scene_pts)
        else:
            d1 = chamfer_one_sided(contact_verts, scene_pts)  # [N, C]
            y_nn = None
    s = torch.sqrt(d1 + 1e-4)
    loss_contact = cfg.weight_contact * torch.mean(s / (s + cfg.contact_denom_offset), dim=1)

    dims = tuple(assets.sdf_packed.shape[1:4])
    if sel is not None and not fresh_sdf:
        sdf_cache = sel[1]
        body_sdf = sdf_trilinear_from_cache(
            sdf_cache, scene_idx, verts, assets.grid_mins, assets.grid_maxs, dims
        )
    elif cfg.refresh_every > 1:
        body_sdf, (corners, base) = sdf_trilinear_packed_cached(
            assets.sdf_packed, scene_idx, verts, assets.grid_mins, assets.grid_maxs
        )
        sdf_cache = (corners.detach(), base.detach())
    else:
        body_sdf = sdf_trilinear_packed(
            assets.sdf_packed, scene_idx, verts, assets.grid_mins, assets.grid_maxs
        )
        sdf_cache = None
    neg = torch.clamp(body_sdf, max=0.0)
    cnt = torch.clamp(torch.sum(body_sdf < 0, dim=1), min=1).to(xhr.dtype)
    loss_collision = cfg.weight_collision * (-torch.sum(neg, dim=1) / cnt)

    per_body = loss_rec + loss_vposer + loss_contact + loss_collision
    metrics = {
        "rec": loss_rec,
        "vposer": loss_vposer,
        "contact": loss_contact,
        "collision": loss_collision,
        "total": per_body,
    }
    return torch.sum(per_body), (metrics, (y_nn, sdf_cache))


def fit_schedule(cfg: FitConfig) -> List[str]:
    """The pass kind of every iteration: 'full', 'nn_only' or 'cheap'.

    psi_tpu's static block structure: w = refresh_warmup warmup passes
    (all full with sdf_warmup_gathers, else one full then nn_only), then
    blocks of one full + (T-1) cheap passes, then a partial tail block.
    At num_iter=20, T=10, w=4: full at 0, 4, 14; nn_only at 1-3; the
    other 14 cheap."""
    if cfg.refresh_every <= 1:
        return ["full"] * cfg.num_iter
    w = min(cfg.refresh_warmup, cfg.num_iter)
    T = cfg.refresh_every
    kinds: List[str] = []
    if w:
        kinds += ["full"] * w if cfg.sdf_warmup_gathers else ["full"] + ["nn_only"] * (w - 1)
    n_blocks, rem = divmod(cfg.num_iter - w, T)
    for _ in range(n_blocks):
        kinds += ["full"] + ["cheap"] * (T - 1)
    if rem:
        kinds += ["full"] + ["cheap"] * (rem - 1)
    return kinds


class Adam:
    """``optax.adam(lr)`` written out (b1 0.9, b2 0.999, eps 1e-8 outside
    the square root), with the same operation order, over one tensor."""

    def __init__(self, x: torch.Tensor, lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.mu = torch.zeros_like(x)
        self.nu = torch.zeros_like(x)
        self.count = 0

    def step(self, x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        self.mu = (1 - self.b1) * g + self.b1 * self.mu
        self.nu = (1 - self.b2) * g**2 + self.b2 * self.nu
        self.count += 1
        # bias corrections in float32, as optax computes decay**count
        c = np.float32(self.count)
        bc1 = float(np.float32(1) - np.float32(self.b1) ** c)
        bc2 = float(np.float32(1) - np.float32(self.b2) ** c)
        update = (self.mu / bc1) / (torch.sqrt(self.nu / bc2) + self.eps)
        return x + (-self.lr) * update


def _fit_program(cfg: FitConfig, want_metrics: bool = True) -> Callable:
    """fit(assets, x72_init [N, 72], cam_ext [N, 4, 4], scene_idx [N]) ->
    (x72 [N, 72], final per-body metrics or None, loss_hist [num_iter, N]).

    loss_hist[i] is each body's total at iteration i, before its update.
    want_metrics=False skips the final full loss pass, which only reports
    metrics; the fitted bodies are the same either way."""
    if cfg.lbs_precision not in LBS_PRECISIONS:
        raise ValueError(f"lbs_precision must be one of {LBS_PRECISIONS}, got {cfg.lbs_precision!r}")
    for knob, off in (("cheap_collision_verts", 0), ("overlap_chunks", 1), ("remat_decode", False)):
        if getattr(cfg, knob) not in (off, None):
            raise NotImplementedError(f"FitConfig.{knob}={getattr(cfg, knob)!r} is not ported yet")
    kinds = fit_schedule(cfg)

    def fit(assets: SceneAssets, x72_init, cam_ext, scene_idx):
        scene_idx = scene_idx.to(torch.int64)
        with strict_f32(), torch.no_grad():
            xhr_init = convert_to_6D_rot(x72_init)
            # the fused kernels' constant operands: once per fit call
            bundle = make_fused_bundle(assets.smplx) if cfg.lbs_precision == "fused" else None

            def loss_fn(x, sel=None, fresh_nn=None, fresh_sdf=None):
                return _per_body_losses(
                    assets, x, xhr_init, cam_ext, scene_idx, cfg, sel, fresh_nn, fresh_sdf, bundle
                )

            xhr = xhr_init.clone()
            adam = Adam(xhr, cfg.init_lr_h)
            sel = None
            hist = []
            for kind in kinds:
                x = xhr.detach().requires_grad_(True)
                with torch.enable_grad():
                    if kind == "full":
                        loss, (metrics, new_sel) = loss_fn(x)
                    else:
                        loss, (metrics, new_sel) = loss_fn(
                            x, sel, fresh_nn=kind == "nn_only", fresh_sdf=False
                        )
                    (g,) = torch.autograd.grad(loss, x)
                xhr = adam.step(xhr, g)
                if kind != "cheap":
                    sel = new_sel
                hist.append(metrics["total"].detach())
            loss_hist = torch.stack(hist)
            x72 = convert_to_3D_rot(xhr)
            if not want_metrics:
                return x72, None, loss_hist
            _, (final, _) = loss_fn(xhr)
            return x72, {k: v.detach() for k, v in final.items()}, loss_hist

    return fit


def make_fit_step(assets: SceneAssets, cfg: FitConfig, want_metrics: bool = True) -> Callable:
    """fit(x72_init [N, 72], cam_ext [N, 4, 4], scene_idx [N]) ->
    (x72_fitted [N, 72], final per-body metrics, per-iteration loss hist)."""
    fit = _fit_program(cfg, want_metrics=want_metrics)

    def bound(x72_init, cam_ext, scene_idx):
        return fit(assets, x72_init, cam_ext, scene_idx)

    return bound


def make_generate_fit_step(
    model: HumanCVAES1, assets: SceneAssets, cfg: FitConfig, n_samples: int, want_metrics: bool = True
) -> Callable:
    """Sample a population for ONE snapshot and refine it.

    Returns run(xs [1, H, W, 2], cam_int [1, 3, 3], max_d [1], cam_ext
    [N, 4, 4], scene_idx [N], generator=None, eps=None) -> (x72 [N, 72],
    metrics, hist). eps [N, eps_d] injects the latents in place of a draw
    from ``generator``."""
    fit = _fit_program(cfg, want_metrics=want_metrics)

    def run(xs, cam_int, max_d, cam_ext, scene_idx, generator=None, eps=None):
        x72 = generate_bodies(model, xs, cam_int, max_d, n_samples, generator=generator, eps=eps)
        return fit(assets, x72, cam_ext, scene_idx)

    return run
