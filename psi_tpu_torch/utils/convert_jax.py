"""Carry weights and assets across from the JAX package, as numpy arrays.

The caller fetches psi_tpu's pytrees to the host (``jax.device_get``) and
hands the numpy arrays here; this module never imports jax. Layouts:
* flax Dense kernel [in, out] -> torch Linear weight [out, in];
* flax Conv kernel HWIO -> torch Conv2d weight OIHW;
* flax BatchNorm scale/bias + batch_stats mean/var -> weight/bias +
  running_mean/running_var;
* the scene encoder's ``fc``: psi_tpu flattens NHWC features, the port
  flattens NCHW (the reference's order), so fc's input columns are
  permuted from (h, w, c) to (c, h, w) order.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch
from torch import nn

from psi_tpu_torch.body.smplx_model import SMPLX_FIELDS, SMPLXModel
from psi_tpu_torch.body.vposer import VPoser
from psi_tpu_torch.models.cvae_s1 import HumanCVAES1
from psi_tpu_torch.train.objective import SceneAssets

def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _load_dense(linear: nn.Linear, p: Mapping[str, Any]) -> None:
    linear.weight.copy_(_t(p["kernel"]).T)
    linear.bias.copy_(_t(p["bias"]))


def _load_conv(conv: nn.Conv2d, p: Mapping[str, Any]) -> None:
    conv.weight.copy_(_t(p["kernel"]).permute(3, 2, 0, 1))
    if conv.bias is not None:
        conv.bias.copy_(_t(p["bias"]))


def _load_bn(bn: nn.BatchNorm2d, p: Mapping[str, Any], stats: Mapping[str, Any]) -> None:
    bn.weight.copy_(_t(p["scale"]))
    bn.bias.copy_(_t(p["bias"]))
    bn.running_mean.copy_(_t(stats["mean"]))
    bn.running_var.copy_(_t(stats["var"]))


def _load_block(block, p, s) -> None:
    _load_conv(block.conv1, p["conv1"])
    _load_bn(block.bn1, p["bn1"], s["bn1"])
    _load_conv(block.conv2, p["conv2"])
    _load_bn(block.bn2, p["bn2"], s["bn2"])
    if block.downsample is not None:
        _load_conv(block.downsample[0], p["downsample_conv"])
        _load_bn(block.downsample[1], p["downsample_bn"], s["downsample_bn"])


@torch.no_grad()
def cvae_s1_from_jax(variables: Mapping[str, Any], image_size: Optional[int] = None) -> HumanCVAES1:
    """psi_tpu HumanCVAES1 variables {'params', 'batch_stats'} (numpy) ->
    an eval-mode port HumanCVAES1 on the CPU. Widths are read from the
    arrays; image_size defaults to the one fc's input width implies."""
    params, stats = variables["params"], variables["batch_stats"]
    scene_p, scene_s = params["scene"], stats["scene"]
    fc_in, latentD = np.shape(scene_p["fc"]["kernel"])
    f_dim = np.shape(scene_p["conv"]["kernel"])[-1]
    spatial = int(round((fc_in // f_dim) ** 0.5))
    model = HumanCVAES1(
        latentD=latentD,
        n_dim_body=np.shape(params["linear_out"]["kernel"])[1],
        eps_d=np.shape(params["mu_enc"]["kernel"])[1],
        scene_in_channels=np.shape(scene_p["resnet"]["conv1"]["kernel"])[2],
        image_size=image_size or spatial * 8,
    )
    rp, rs = scene_p["resnet"], scene_s["resnet"]
    _load_conv(model.resnet[0], rp["conv1"])
    _load_bn(model.resnet[1], rp["bn1"], rs["bn1"])
    for stage, seq in ((1, 4), (2, 5)):
        for block in range(2):
            name = f"layer{stage}_{block}"
            _load_block(model.resnet[seq][block], rp[name], rs[name])
    _load_conv(model.conv, scene_p["conv"])
    # fc: rows of the flax kernel are in (h, w, c) flatten order
    k = np.asarray(scene_p["fc"]["kernel"], np.float32).reshape(spatial, spatial, f_dim, latentD)
    model.fc.weight.copy_(torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1).reshape(latentD, -1))))
    model.fc.bias.copy_(_t(scene_p["fc"]["bias"]))
    _load_dense(model.linear_in, params["linear_in"])
    _load_dense(model.mu_enc, params["mu_enc"])
    _load_dense(model.logvar_enc, params["logvar_enc"])
    _load_dense(model.linear_latent, params["linear_latent"])
    _load_dense(model.linear_out, params["linear_out"])
    for i in range(2):
        for prefix, blocks in (("enc_rb", model.human_encoder), ("dec_rb", model.human_decoder)):
            _load_dense(blocks[i].fc1, params[f"{prefix}{i}"]["fc1"])
            _load_dense(blocks[i].fc2, params[f"{prefix}{i}"]["fc2"])
    return model.eval()


@torch.no_grad()
def vposer_from_jax(variables: Mapping[str, Any]) -> VPoser:
    """psi_tpu VPoser variables (numpy) -> the port's eval-mode decoder."""
    params = variables["params"]
    num_neurons, = np.shape(params["dec_fc1"]["bias"])
    latentD = np.shape(params["dec_fc1"]["kernel"])[0]
    num_joints = np.shape(params["dec_out"]["bias"])[0] // 6
    vp = VPoser(num_neurons=num_neurons, latentD=latentD, num_joints=num_joints)
    _load_dense(vp.bodyprior_dec_fc1, params["dec_fc1"])
    _load_dense(vp.bodyprior_dec_fc2, params["dec_fc2"])
    _load_dense(vp.bodyprior_dec_out, params["dec_out"])
    return vp.eval()


def smplx_from_numpy(parents, **arrays) -> SMPLXModel:
    """An SMPLXModel from numpy arrays named as ``SMPLX_FIELDS`` (exprdirs
    and posedirs may be None) and the kinematic-tree parents."""
    def conv(name, a):
        if a is None:
            return None
        a = np.asarray(a)
        return torch.from_numpy(a.astype(np.int64 if name == "faces" else np.float32))

    return SMPLXModel(**{f: conv(f, arrays.get(f)) for f in SMPLX_FIELDS}, parents=tuple(int(p) for p in parents))


def scene_assets_from_numpy(
    smplx: SMPLXModel,
    vposer: VPoser,
    contact_vids,
    sdf_packed,
    grid_mins,
    grid_maxs,
    scene_verts,
    device="cpu",
) -> SceneAssets:
    """SceneAssets from numpy arrays (sdf_packed may be ml_dtypes bfloat16,
    as psi_tpu stores production grids; it is kept bf16 here)."""
    sdf = np.asarray(sdf_packed)
    if sdf.dtype.name == "bfloat16":
        packed = torch.from_numpy(np.array(sdf).view(np.int16)).view(torch.bfloat16)
    else:
        packed = torch.from_numpy(sdf.astype(np.float32))
    return SceneAssets(
        smplx=smplx.to(device),
        vposer=vposer.to(device),
        contact_vids=torch.from_numpy(np.asarray(contact_vids, np.int64)).to(device),
        sdf_packed=packed.to(device),
        grid_mins=_t(grid_mins).to(device),
        grid_maxs=_t(grid_maxs).to(device),
        scene_verts=_t(scene_verts).to(device),
    )
