"""The composite PSI training objective and the scene-asset bundle.

Port of ``psi_tpu.train.objective``. ``cvae_loss`` computes all six loss
terms of the reference's TrainOP.cal_loss (stage 1: source/train_s1.py:
95-207; stage 2: source/train_s2.py:102-210, which differs only in the
model forward and its two KL terms): perspective normalisation, CVAE
forward, VPoser decode, SMPL-X LBS, camera transform, chamfer contact and
SDF collision, one differentiable chain of torch calls. On the card the
contact term's nearest-neighbour search is kernel K3
(``ops/chamfer.py::nn_argmin``), once per call over the whole scene cloud
unless ``LossConfig.prune_scene_points`` is set; everything else is
PyTorch in full f32.

Scene geometry comes from a ``SceneAssets`` bundle resident on one device:
the body model, the VPoser decoder, the contact-vertex ids, every scene's
corner-packed SDF grid and bounds, and every scene's Morton-ordered,
far-padded point cloud; bodies index their scene with an int scene id.

Data-parallel training (``mesh=``): the batch is this rank's rows of the
global one, and the loss returned is this rank's share of the global
batch's, so that the shares of the ranks sum to the loss of the whole
batch, and so do their gradients. Every term but collision is a plain mean
over equal shards, so its share is the rank's mean over the rank count;
collision is a mean over the penetrating vertices of the whole batch, so
its share is the rank's own sum over the count of all ranks
(``ops/sdf.py::sdf_penetration_loss``); BatchNorm takes the whole batch's
statistics (``nn/layers.py``).

The epoch-dependent gates are plain numbers or 0-d tensors and no branch
depends on them, so the sequence of device operations is the same for
every step:
  fca      KL annealing factor min(1, ep / (0.75 * epochs))  (train_s1.py:123-125)
  f_scene  contact/collision gate 1[ep > 0.75 * epochs]      (train_s1.py:171-173,200-202)
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from psi_tpu_torch.body.decode import body_vec_to_verts
from psi_tpu_torch.body.smplx_model import SMPLXModel
from psi_tpu_torch.body.vposer import VPoser
from psi_tpu_torch.geometry.bodyvec import convert_to_3D_rot, convert_to_6D_rot
from psi_tpu_torch.geometry.camera import normalize_global_T, recover_global_T
from psi_tpu_torch.losses.terms import (
    collision_loss,
    contact_robust_loss,
    kl_normal_loss,
    l1_loss,
    vposer_reg_loss,
)
from psi_tpu_torch.ops.chamfer import chamfer_one_sided
from psi_tpu_torch.ops.prune import select_near_tiles
from psi_tpu_torch.ops.sdf import sdf_trilinear_packed
from psi_tpu_torch.utils.config import LossConfig
from psi_tpu_torch.utils.precision import strict_f32


@dataclasses.dataclass(frozen=True)
class SceneAssets:
    smplx: SMPLXModel
    vposer: VPoser
    contact_vids: torch.Tensor  # [C] int64 contact-vertex ids
    sdf_packed: torch.Tensor  # [S, D, H, W, 8] corner-packed (ops.sdf.pack_sdf_corners)
    grid_mins: torch.Tensor  # [S, 3]
    grid_maxs: torch.Tensor  # [S, 3]
    scene_verts: torch.Tensor  # [S, P, 3] (far-padded)


def scene_geometry_losses(
    assets: SceneAssets,
    xh_rec: torch.Tensor,  # [B, 72]
    cam_ext: torch.Tensor,  # [B, 4, 4]
    scene_idx: torch.Tensor,  # [B] int
    contact_denom_offset: float,
    prune_scene_points: int = 0,
    mesh=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(raw contact loss, raw collision loss) for reconstructed bodies: the
    body-decode -> chamfer -> SDF chain at the 'high' LBS tier.
    prune_scene_points > 0 restricts the contact NN search to the K scene
    points nearest each body's contact centroid; 0 searches the whole cloud.
    With a mesh the collision loss is this rank's share of the whole batch's
    (the contact loss stays this rank's mean)."""
    scene_idx = scene_idx.to(torch.int64)
    with strict_f32():
        verts, _ = body_vec_to_verts(assets.smplx, assets.vposer, xh_rec, cam_ext, precision="high")
    contact_verts = verts[:, assets.contact_vids, :]
    scene_pts = assets.scene_verts[scene_idx]  # [B, P, 3]
    if prune_scene_points and prune_scene_points < scene_pts.shape[1]:
        scene_pts = select_near_tiles(scene_pts, torch.mean(contact_verts, dim=1), prune_scene_points)
    # only the body -> scene direction enters the loss (train_s1.py:165-169)
    d1 = chamfer_one_sided(contact_verts, scene_pts)
    loss_contact = contact_robust_loss(d1, contact_denom_offset)

    body_sdf = sdf_trilinear_packed(assets.sdf_packed, scene_idx, verts, assets.grid_mins, assets.grid_maxs)
    return loss_contact, collision_loss(body_sdf, mesh)


def cvae_loss(
    model: torch.nn.Module,
    batch: Dict[str, torch.Tensor],
    assets: SceneAssets,
    fca,
    f_scene,
    cfg: LossConfig,
    model_type: str = "s1",
    train: bool = True,
    generator: Optional[torch.Generator] = None,
    eps=None,
    mesh=None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], None]:
    """(total loss, per-term metrics as 0-d tensors, None).

    batch: xs [B, H, W, 2], xh [B, 72], cam_ext [B, 4, 4], cam_int
    [B, 3, 3], max_d [B], scene_idx [B], on the model's device. The model is
    put in train mode (batch statistics, running ones updated in place) or
    eval mode as ``train`` says; psi_tpu returns the updated statistics as
    its third result, here they live in the module, so the third is None.
    The latent noise is drawn from ``generator`` (on the model's device)
    unless ``eps`` injects it: a tensor [B, 32] for 's1', a pair (eps_g,
    eps_l) for 's2'; with neither the posterior mean is decoded.
    With a mesh, the total and every term are this rank's shares of the
    global batch's (module docstring).
    """
    if model.training != train:
        model.train(train)
    xh, cam_int, cam_ext, max_d = batch["xh"], batch["cam_int"], batch["cam_ext"], batch["max_d"]
    xs = batch["xs"]
    if xs.dtype != torch.float32:
        # bf16-staged snapshots (TrainConfig.stage_bf16): the model's math stays
        # f32, only the host -> device copy is narrowed
        xs = xs.to(torch.float32)

    share = 1.0 / mesh.size if mesh is not None else 1.0  # of a mean over equal shards
    with strict_f32():
        xhn = normalize_global_T(xh, cam_int, max_d)
        xhnr = convert_to_6D_rot(xhn)

        if model_type == "s1":
            xhnr_rec, mu, logvar = model(xhnr, xs, generator=generator, eps=eps)
            loss_kl = share * (fca**2 * cfg.weight_loss_kl * kl_normal_loss(mu, logvar))
            kl_metrics = {"kl": loss_kl}
        elif model_type == "s2":
            eps_g, eps_l = eps if eps is not None else (None, None)
            xhnr_rec, mu_g, lv_g, mu_l, lv_l = model(xhnr, xs, generator=generator, eps_g=eps_g, eps_l=eps_l)
            loss_kl_g = share * (fca**2 * cfg.weight_loss_kl * kl_normal_loss(mu_g, lv_g))
            loss_kl_l = share * (fca**2 * cfg.weight_loss_kl * kl_normal_loss(mu_l, lv_l))
            loss_kl = loss_kl_g + loss_kl_l
            kl_metrics = {"kl": loss_kl, "kl_g": loss_kl_g, "kl_l": loss_kl_l}
        else:
            raise ValueError(f"unknown model_type {model_type}")

        xhn_rec = convert_to_3D_rot(xhnr_rec)
        xh_rec = recover_global_T(xhn_rec, cam_int, max_d)

        loss_rec_t = share * (cfg.weight_loss_rec_h * (
            0.5 * l1_loss(xhnr_rec[:, :3], xhnr[:, :3]) + 0.5 * l1_loss(xh_rec[:, :3], xh[:, :3])
        ))
        loss_rec_p = share * (cfg.weight_loss_rec_h * l1_loss(xhnr_rec[:, 3:], xhnr[:, 3:]))
        loss_vposer = share * (cfg.weight_loss_vposer * vposer_reg_loss(xh_rec[:, 16:48]))

        raw_contact, raw_collision = scene_geometry_losses(
            assets, xh_rec, cam_ext, batch["scene_idx"], cfg.contact_denom_offset,
            prune_scene_points=cfg.prune_scene_points, mesh=mesh,
        )
        loss_contact = share * (f_scene * cfg.weight_contact * raw_contact)
        loss_collision = f_scene * cfg.weight_collision * raw_collision

        total = loss_rec_t + loss_rec_p + loss_kl + loss_vposer + loss_contact + loss_collision
    metrics = {
        "loss": total,
        "rec_t": loss_rec_t,
        "rec_p": loss_rec_p,
        "vposer": loss_vposer,
        "contact": loss_contact,
        "collision": loss_collision,
        **kl_metrics,
    }
    return total, metrics, None
