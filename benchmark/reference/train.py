"""Plain stage-1 CVAE training step: PSI's loss (source/train_s1.py:95-207)
with its gradient by autograd, and Adam (``torch.optim.Adam``: b1 0.9, b2
0.999, eps 1e-8).

The loss: the translation's L1 in the normalised box and in metres, the
rotation and the rest's L1, the KL of the posterior (times fca^2), the
VPoser latent's square, and, gated by f_scene, the robust contact distance
of the reconstructed body's contact vertices to the whole scene cloud and
the mean penetration depth over the batch's penetrating vertices. The body
decode and every product are float32 (or TF32 for the control).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from benchmark.reference import body as rbody
from benchmark.reference import cvae as rcvae
from benchmark.reference import scene as rscene

BUFFERS = ("running_mean", "running_var", "num_batches_tracked")


def parameters(weights: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The trainable leaves of a state dict, as fresh leaf tensors."""
    return {k: v.detach().clone().requires_grad_(True) for k, v in weights.items()
            if k.rsplit(".", 1)[-1] not in BUFFERS}


def _l1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    d = a - b
    return torch.mean(torch.where(d >= 0, d, -d))


def s1_loss(w: Dict, batch: Dict, eps: torch.Tensor, world: Dict, lc: Dict, num) -> torch.Tensor:
    """world: body, vposer, contact ids, f32 grids, bounds and the
    Morton-ordered clouds; lc: the loss weights and gates."""
    xh, cam_int, max_d = batch["xh"], batch["cam_int"], batch["max_d"]
    xhnr = rbody.to_6d(rbody.normalize_global_T(xh, cam_int, max_d))
    rec, mu, logvar = rcvae.s1_forward(w, xhnr, batch["xs"], eps)
    xh_rec = rbody.recover_global_T(rbody.to_3d(rec), cam_int, max_d)
    kl = lc["fca"] ** 2 * lc["kl"] * 0.5 * torch.mean(torch.exp(logvar) + mu**2 - 1.0 - logvar)
    rec_t = lc["rec"] * (0.5 * _l1(rec[:, :3], xhnr[:, :3]) + 0.5 * _l1(xh_rec[:, :3], xh[:, :3]))
    rec_p = lc["rec"] * _l1(rec[:, 3:], xhnr[:, 3:])
    vpl = lc["vposer"] * torch.mean(xh_rec[:, 16:48] ** 2)
    verts = rbody.body_verts(world["body"], world["vposer"], xh_rec, batch["cam_ext"], num, folded_joints=False)
    cv = verts[:, world["contact"]]
    sidx = batch["scene_idx"].to(torch.int64)
    y = world["clouds"][sidx]
    s = torch.sqrt(torch.sum((cv - rscene.gather_points(y, rscene.nearest(cv.detach(), y))) ** 2, -1) + 1e-4)
    contact = lc["f_scene"] * lc["contact"] * torch.mean(s / (s + lc["contact_offset"]))
    sdf, _ = rscene.sdf_cells(world["grid"], sidx, verts, world["gmins"], world["gmaxs"])
    pen = -torch.minimum(sdf, sdf.new_zeros(())).sum() / torch.clamp((sdf < 0).sum(), min=1).to(sdf.dtype)
    collision = lc["f_scene"] * lc["collision"] * pen
    return rec_t + rec_p + kl + vpl + contact + collision


def train_steps(weights: Dict, batches: List[Dict], eps: List[torch.Tensor], world: Dict, lc: Dict, lr: float,
                num, adam: Optional[Dict[str, Dict]] = None
                ) -> Tuple[List[float], Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Steps over the batches from ``weights`` and, where given, Adam's state
    of each parameter (``adam``: exp_avg, exp_avg_sq, step; a parameter
    without one starts fresh). Returns (each step's loss, the first step's
    gradient, the parameters' change after the last)."""
    params = parameters(weights)
    start = {k: v.detach().clone() for k, v in params.items()}
    buffers = {k: v.detach().clone() for k, v in weights.items() if k not in params}
    opt = torch.optim.Adam(list(params.values()), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    for k, s in (adam or {}).items():
        if s:
            opt.state[params[k]] = {n: (v.clone() if torch.is_tensor(v) else v) for n, v in s.items()}
    losses, first_grad = [], None
    with num.matmul_mode():
        for batch, e in zip(batches, eps):
            opt.zero_grad(set_to_none=True)
            loss = s1_loss({**buffers, **params}, batch, e, world, lc, num)
            loss.backward()
            if first_grad is None:
                first_grad = {k: (v.grad.detach().clone() if v.grad is not None else torch.zeros_like(v))
                              for k, v in params.items()}
            opt.step()
            losses.append(float(loss.detach()))
    return losses, first_grad, {k: (v.detach() - start[k]) for k, v in params.items()}
