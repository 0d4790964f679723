"""Plain PSI CVAE training steps, stage 1 and stage 2: PSI's loss
(source/train_s1.py:95-207, train_s2.py:102-210) with its gradient by
autograd, and Adam (``torch.optim.Adam``: b1 0.9, b2 0.999, eps 1e-8).

The loss: the translation's L1 in the normalised box and in metres, the
rotation and the rest's L1, the KL of the posterior (times fca^2; stage 2
has two, the global and the local VAE's, summed), the VPoser latent's
square, and, gated by f_scene, the robust contact distance of the
reconstructed body's contact vertices to the whole scene cloud and the mean
penetration depth over the batch's penetrating vertices. The body decode
and every product are float32 (or TF32 for the control).
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


def _kl(mu: torch.Tensor, logvar: torch.Tensor, lc: Dict) -> torch.Tensor:
    return lc["fca"] ** 2 * lc["kl"] * 0.5 * torch.mean(torch.exp(logvar) + mu**2 - 1.0 - logvar)


def _rec_kl(model_type: str, w: Dict, xhnr: torch.Tensor, xs: torch.Tensor, eps, lc: Dict):
    """The training forward: (the reconstruction, its KL term). Stage 2 sums
    the global and the local VAE's KL terms; its ``eps`` is the pair
    (global, local)."""
    if model_type == "s1":
        rec, mu, logvar = rcvae.s1_forward(w, xhnr, xs, eps)
        return rec, _kl(mu, logvar, lc)
    if model_type == "s2":
        rec, mu_g, logvar_g, mu_l, logvar_l = rcvae.s2_forward(w, xhnr, xs, eps[0], eps[1])
        return rec, _kl(mu_g, logvar_g, lc) + _kl(mu_l, logvar_l, lc)
    raise ValueError(f"unknown model_type {model_type!r}")


def loss(model_type: str, w: Dict, batch: Dict, eps, world: Dict, lc: Dict, num) -> torch.Tensor:
    """The training loss of the configuration's ``model_type``. world:
    body, vposer, contact ids, f32 grids, bounds and the Morton-ordered
    clouds; lc: the loss weights and gates."""
    xh, cam_int, max_d = batch["xh"], batch["cam_int"], batch["max_d"]
    xhnr = rbody.to_6d(rbody.normalize_global_T(xh, cam_int, max_d))
    rec, kl = _rec_kl(model_type, w, xhnr, batch["xs"], eps, lc)
    xh_rec = rbody.recover_global_T(rbody.to_3d(rec), cam_int, max_d)
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


def train_steps(weights: Dict, batches: List[Dict], eps: List, world: Dict, lc: Dict, lr: float,
                num, adam: Optional[Dict[str, Dict]] = None, *, model_type: str
                ) -> Tuple[List[float], Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Steps over the batches from ``weights`` and, where given, Adam's state
    of each parameter (``adam``: exp_avg, exp_avg_sq, step; a parameter
    without one starts fresh), with the loss of ``model_type`` (each step's
    ``eps``: a tensor for 's1', the pair (global, local) for 's2'). Returns
    (each step's loss, the first step's gradient, the parameters' change
    after the last)."""
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
            total = loss(model_type, {**buffers, **params}, batch, e, world, lc, num)
            total.backward()
            if first_grad is None:
                first_grad = {k: (v.grad.detach().clone() if v.grad is not None else torch.zeros_like(v))
                              for k, v in params.items()}
            opt.step()
            losses.append(float(total.detach()))
    return losses, first_grad, {k: (v.detach() - start[k]) for k, v in params.items()}
