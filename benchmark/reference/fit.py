"""Plain generate+fit: sample a population with the CVAE, then refine it
with Adam against contact and SDF collision (PSI's fitting_proxe.py:42-263).

The refinement follows the semantics the configuration states:
* its loss: L1 to the sampled body (the derivative of |d| is +1 at 0),
  VPoser z^2, the robust contact distance of the contact vertices to their
  nearest scene points (among the ~k nearest tiles of the cloud when the
  configuration prunes), and the mean penetration depth over penetrating
  vertices;
* its schedule: with ``refresh_every`` > 1 a full pass (fresh search, fresh
  cells) at iteration 0 and every ``refresh_every`` iterations after the
  warm-up, fresh searches against the carried cells in the rest of the
  warm-up, and frozen neighbours and cells in between;
* Adam (b1 0.9, b2 0.999, eps 1e-8 outside the root, bias corrections in
  float32), with fresh moments for each population.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from benchmark.reference import body as rbody
from benchmark.reference import cvae as rcvae
from benchmark.reference import scene as rscene


def schedule(num_iter: int, refresh_every: int, warmup: int) -> List[str]:
    """The pass kind of each iteration: 'full', 'nn_only' or 'cheap'."""
    if refresh_every <= 1:
        return ["full"] * num_iter
    w = min(warmup, num_iter)
    kinds = (["full"] + ["nn_only"] * (w - 1)) if w else []
    while len(kinds) < num_iter:
        block = ["full"] + ["cheap"] * (refresh_every - 1)
        kinds += block[: num_iter - len(kinds)]
    return kinds


class Adam:
    def __init__(self, x: torch.Tensor, lr: float):
        self.lr, self.mu, self.nu, self.count = lr, torch.zeros_like(x), torch.zeros_like(x), 0

    def step(self, x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        self.mu = 0.1 * g + 0.9 * self.mu
        self.nu = (1 - 0.999) * g**2 + 0.999 * self.nu
        self.count += 1
        c = np.float32(self.count)
        bc1 = float(np.float32(1) - np.float32(0.9) ** c)
        bc2 = float(np.float32(1) - np.float32(0.999) ** c)
        return x - self.lr * ((self.mu / bc1) / (torch.sqrt(self.nu / bc2) + 1e-8))


class Scenes:
    """The raw scene data in the reference's form: grids [S, D, D, D] in the
    stated precision, bounds, and Morton-ordered clouds [S, P, 3]."""

    def __init__(self, sdf: torch.Tensor, gmins: torch.Tensor, gmaxs: torch.Tensor, clouds: torch.Tensor, num):
        self.grid = num.grid_values(sdf)
        self.gmins, self.gmaxs = gmins, gmaxs
        perms = [torch.from_numpy(rscene.morton_order(c.cpu().numpy())).to(c.device) for c in clouds]
        self.clouds = torch.stack([c[p] for c, p in zip(clouds, perms)])


def fit(fc: Dict, body: Dict, vp: Dict, contact: torch.Tensor, scenes: Scenes, num,
        x72_init: torch.Tensor, cam_ext: torch.Tensor, scene_idx: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Refine x72_init [N, 72]; fc holds the fit's settings (num_iter,
    lr, weights, contact_offset, prune, refresh_every, refresh_warmup,
    folded_joints). Returns (fitted x72 [N, 72], each body's total loss at
    every iteration before its update [num_iter, N])."""
    kinds = schedule(fc["num_iter"], fc["refresh_every"], fc["refresh_warmup"])
    D = scenes.grid.shape[1]
    xhr_init = rbody.to_6d(x72_init)
    carried = None  # (frozen neighbours, frozen cells)

    def loss(xhr, kind):
        d = xhr - xhr_init
        rec = fc["w_rec"] * torch.mean(torch.where(d >= 0, d, -d), dim=1)
        xh = rbody.to_3d(xhr)
        vpl = fc["w_vposer"] * torch.mean(xh[:, 16:48] ** 2, dim=1)
        verts = rbody.body_verts(body, vp, xh, cam_ext, num, fc["folded_joints"])
        cv = verts[:, contact]
        if kind == "cheap":
            y_nn = carried[0]
        else:
            cloud = scenes.clouds[scene_idx]
            if fc["prune"] and fc["prune"] < cloud.shape[1]:
                cloud = rscene.near_tiles(cloud, torch.mean(cv, dim=1).detach(), fc["prune"])
            y_nn = rscene.gather_points(cloud, rscene.nearest(cv.detach(), cloud))
        s = torch.sqrt(torch.sum((cv - y_nn) ** 2, dim=-1) + 1e-4)
        contact_l = fc["w_contact"] * torch.mean(s / (s + fc["contact_offset"]), dim=1)
        if kind == "full":
            sdf, cells = rscene.sdf_cells(scenes.grid, scene_idx, verts, scenes.gmins, scenes.gmaxs)
        else:
            cells = carried[1]
            sdf = rscene.sdf_from_cells(cells, scene_idx, verts, scenes.gmins, scenes.gmaxs, D)
        neg = torch.minimum(sdf, sdf.new_zeros(()))
        cnt = torch.clamp(torch.sum(sdf < 0, dim=1), min=1).to(sdf.dtype)
        coll = fc["w_collision"] * (-torch.sum(neg, dim=1) / cnt)
        return rec + vpl + contact_l + coll, (y_nn.detach(), cells)

    xhr = xhr_init.clone()
    adam = Adam(xhr, fc["lr"])
    hist = []
    for kind in kinds:
        x = xhr.detach().requires_grad_(True)
        with torch.enable_grad():
            per_body, state = loss(x, kind)
            (g,) = torch.autograd.grad(per_body.sum(), x)
        xhr = adam.step(xhr, g)
        if kind != "cheap":
            carried = state
        hist.append(per_body.detach())
    return rbody.to_3d(xhr).detach(), torch.stack(hist)


def generate(model_type: str, w: Dict, xs: torch.Tensor, cam_int: torch.Tensor, max_d: torch.Tensor,
             rows: torch.Tensor, eps) -> torch.Tensor:
    """Metric 72-D bodies, row r for snapshot rows[r] of xs [R, H, W, 2]."""
    x75 = rcvae.sample_rows(model_type, w, xs, rows, eps)
    return rbody.recover_global_T(rbody.to_3d(x75), cam_int[rows], max_d[rows])
