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

``cvae_s{1,2}_to_jax`` and ``grads_to_jax`` go the other way, so a test can
hold the port's parameters, running statistics and gradients against
psi_tpu's trees leaf by leaf.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch
from torch import nn

from psi_tpu_torch.body.smplx_model import SMPLX_FIELDS, SMPLXModel
from psi_tpu_torch.body.vposer import VPoser
from psi_tpu_torch.models.cvae_s1 import HumanCVAES1
from psi_tpu_torch.models.cvae_s2 import HumanCVAES2
from psi_tpu_torch.models.scene_encoder import SceneEncoder
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


def _load_scene_encoder(enc: SceneEncoder, scene_p, scene_s, spatial: int) -> None:
    """psi_tpu SceneEncoder params and batch_stats -> resnet, conv and fc."""
    rp, rs = scene_p["resnet"], scene_s["resnet"]
    _load_conv(enc.resnet[0], rp["conv1"])
    _load_bn(enc.resnet[1], rp["bn1"], rs["bn1"])
    for name, block in _trunk_blocks(enc):
        _load_block(block, rp[name], rs[name])
    _load_conv(enc.conv, scene_p["conv"])
    # fc: rows of the flax kernel are in (h, w, c) flatten order
    f_dim, hidden = enc.conv.out_channels, enc.fc.out_features
    k = np.asarray(scene_p["fc"]["kernel"], np.float32).reshape(spatial, spatial, f_dim, hidden)
    enc.fc.weight.copy_(torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1).reshape(hidden, -1))))
    enc.fc.bias.copy_(_t(scene_p["fc"]["bias"]))


def _trunk_blocks(enc: SceneEncoder):
    """(psi_tpu's name, the port's BasicBlock) of the trunk's four blocks."""
    return [(f"layer{stage}_{block}", enc.resnet[seq][block]) for stage, seq in ((1, 4), (2, 5)) for block in range(2)]


def _scene_widths(scene_p) -> dict:
    """(f_dim, spatial, num_hidden, in_channels) read from a scene encoder's arrays."""
    fc_in, hidden = np.shape(scene_p["fc"]["kernel"])
    f_dim = np.shape(scene_p["conv"]["kernel"])[-1]
    return dict(f_dim=f_dim, spatial=int(round((fc_in // f_dim) ** 0.5)), hidden=hidden,
                in_channels=np.shape(scene_p["resnet"]["conv1"]["kernel"])[2])


# (psi_tpu's name, the port's attribute path) of every Dense layer outside the scene encoder
_S1_DENSE = [("linear_in", "linear_in"), ("mu_enc", "mu_enc"), ("logvar_enc", "logvar_enc"),
             ("linear_latent", "linear_latent"), ("linear_out", "linear_out")] + [
    (f"{j}{i}/{fc}", f"{t}.{i}.{fc}") for j, t in (("enc_rb", "human_encoder"), ("dec_rb", "human_decoder"))
    for i in range(2) for fc in ("fc1", "fc2")]
_SUB_VAE_DENSE = [("torso_linear", "torso_linear"), ("mean_linear", "mean_linear"),
                  ("log_var_linear", "log_var_linear"), ("dec_in", "decode.0"), ("dec_out", "decode.3")] + [
    (f"enc_rb{i}/{fc}", f"encode.{i}.{fc}") for i in range(2) for fc in ("fc1", "fc2")] + [
    (f"dec_rb{i}/{fc}", f"decode.{i + 1}.{fc}") for i in range(2) for fc in ("fc1", "fc2")]


def _dense_table(module: nn.Module):
    table = _S1_DENSE if isinstance(module, HumanCVAES1) else _SUB_VAE_DENSE
    if hasattr(module, "pose_linear"):
        table = table + [("pose_linear", "pose_linear")]
    return table


def _at(tree, path: str):
    for key in path.split("/"):
        tree = tree[key]
    return tree


def _load_vae(module: SceneEncoder, params, stats, spatial: int) -> None:
    """One scene-encoder-based VAE (S1, or a sub-VAE of S2) from its flax subtree."""
    _load_scene_encoder(module, params["scene"], stats["scene"], spatial)
    for jname, tname in _dense_table(module):
        _load_dense(module.get_submodule(tname), _at(params, jname))


@torch.no_grad()
def cvae_s1_from_jax(variables: Mapping[str, Any], image_size: Optional[int] = None,
                     train: bool = False) -> HumanCVAES1:
    """psi_tpu HumanCVAES1 variables {'params', 'batch_stats'} (numpy) -> a
    port HumanCVAES1 on the CPU, in eval mode unless ``train``. Widths are
    read from the arrays; image_size defaults to the one fc's input width
    implies."""
    params, stats = variables["params"], variables["batch_stats"]
    w = _scene_widths(params["scene"])
    model = HumanCVAES1(
        latentD=w["hidden"],
        n_dim_body=np.shape(params["linear_out"]["kernel"])[1],
        eps_d=np.shape(params["mu_enc"]["kernel"])[1],
        scene_in_channels=w["in_channels"],
        image_size=image_size or w["spatial"] * 8,
    )
    _load_vae(model, params, stats, w["spatial"])
    return model.train(train)


@torch.no_grad()
def cvae_s2_from_jax(variables: Mapping[str, Any], image_size: Optional[int] = None,
                     train: bool = False) -> HumanCVAES2:
    """psi_tpu HumanCVAES2 variables (numpy) -> a port HumanCVAES2 on the
    CPU, in eval mode unless ``train``. Each sub-VAE's ``fc`` gets its own
    (h, w, c) -> (c, h, w) column permutation (f_dim 32 and 128)."""
    params, stats = variables["params"], variables["batch_stats"]
    wg, wl = _scene_widths(params["trans_vae"]["scene"]), _scene_widths(params["pose_vae"]["scene"])
    model = HumanCVAES2(
        latentD_g=wg["hidden"], latentD_l=wl["hidden"],
        n_dim_body=np.shape(params["pose_vae"]["dec_out"]["kernel"])[1] + 3,
        scene_in_channels=wg["in_channels"], image_size=image_size or wg["spatial"] * 8,
    )
    _load_vae(model.trans_vae, params["trans_vae"], stats["trans_vae"], wg["spatial"])
    _load_vae(model.pose_vae, params["pose_vae"], stats["pose_vae"], wl["spatial"])
    return model.train(train)


# ---- the way back: the port's modules laid out as flax's trees (numpy)


def _value(p: torch.Tensor) -> torch.Tensor:
    return p.detach()


def _grad(p: torch.Tensor) -> torch.Tensor:
    if p.grad is None:
        raise ValueError("grads_to_jax: a parameter has no .grad (run backward first)")
    return p.grad


def _np(t: torch.Tensor) -> np.ndarray:
    """A contiguous numpy copy: the trees are snapshots, not views of the module."""
    return np.array(t.cpu().numpy(), order="C")


def _dump_dense(linear: nn.Linear, get) -> dict:
    return {"kernel": _np(get(linear.weight).T), "bias": _np(get(linear.bias))}


def _dump_conv(conv: nn.Conv2d, get) -> dict:
    out = {"kernel": _np(get(conv.weight).permute(2, 3, 1, 0))}
    if conv.bias is not None:
        out["bias"] = _np(get(conv.bias))
    return out


def _dump_bn(bn: nn.BatchNorm2d, get) -> dict:
    return {"scale": _np(get(bn.weight)), "bias": _np(get(bn.bias))}


def _bn_stats(bn: nn.BatchNorm2d) -> dict:
    return {"mean": _np(bn.running_mean), "var": _np(bn.running_var)}


def _block_tree(block, conv, bn) -> dict:
    """A BasicBlock as flax's subtree: conv(layer) for the convolutions, bn(layer)
    for the BatchNorms (either may be None to leave that kind out)."""
    layers = [("conv1", block.conv1, conv), ("bn1", block.bn1, bn), ("conv2", block.conv2, conv),
              ("bn2", block.bn2, bn)]
    if block.downsample is not None:
        layers += [("downsample_conv", block.downsample[0], conv), ("downsample_bn", block.downsample[1], bn)]
    return {name: fn(layer) for name, layer, fn in layers if fn is not None}


def _vae_params(module: SceneEncoder, get) -> dict:
    """Inverse of ``_load_vae`` for the parameters (or, with ``get=_grad``, their gradients)."""
    conv, bn = (lambda c: _dump_conv(c, get)), (lambda b: _dump_bn(b, get))
    resnet = {"conv1": conv(module.resnet[0]), "bn1": bn(module.resnet[1])}
    for name, block in _trunk_blocks(module):
        resnet[name] = _block_tree(block, conv, bn)
    f_dim, hidden = module.conv.out_channels, module.fc.out_features
    spatial = int(round((module.fc.in_features // f_dim) ** 0.5))
    # fc back to flax's rows in (h, w, c) flatten order
    k = get(module.fc.weight).reshape(hidden, f_dim, spatial, spatial).permute(2, 3, 1, 0).reshape(-1, hidden)
    out: dict = {"scene": {"resnet": resnet, "conv": conv(module.conv),
                           "fc": {"kernel": _np(k), "bias": _np(get(module.fc.bias))}}}
    for jname, tname in _dense_table(module):
        *parents, leaf = jname.split("/")
        node = out
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = _dump_dense(module.get_submodule(tname), get)
    return out


def _vae_stats(module: SceneEncoder) -> dict:
    resnet = {"bn1": _bn_stats(module.resnet[1])}
    for name, block in _trunk_blocks(module):
        resnet[name] = _block_tree(block, None, _bn_stats)
    return {"scene": {"resnet": resnet}}


def _model_params(model: nn.Module, get) -> dict:
    if isinstance(model, HumanCVAES2):
        return {"trans_vae": _vae_params(model.trans_vae, get), "pose_vae": _vae_params(model.pose_vae, get)}
    return _vae_params(model, get)


def cvae_s1_to_jax(model: HumanCVAES1) -> dict:
    """The port's HumanCVAES1 as psi_tpu's variables {'params',
    'batch_stats'}: numpy arrays in flax's layout (Dense kernels [in, out],
    Conv kernels HWIO, fc's rows in (h, w, c) order)."""
    return {"params": _model_params(model, _value), "batch_stats": _vae_stats(model)}


def cvae_s2_to_jax(model: HumanCVAES2) -> dict:
    """The port's HumanCVAES2 as psi_tpu's variables, as ``cvae_s1_to_jax``."""
    return {"params": _model_params(model, _value),
            "batch_stats": {"trans_vae": _vae_stats(model.trans_vae), "pose_vae": _vae_stats(model.pose_vae)}}


def grads_to_jax(model: nn.Module) -> dict:
    """Every parameter's ``.grad`` of a HumanCVAES1 or HumanCVAES2, laid out
    as psi_tpu's 'params' tree, to compare with ``jax.grad``'s result."""
    return _model_params(model, _grad)


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
