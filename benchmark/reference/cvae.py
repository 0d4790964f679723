"""Plain PSI CVAEs (stage 1 and stage 2) over a dict of weights: their
samplers and their training forwards.

Written from the reference's source/cvae.py:341-534 and net_layers.py: a
ResNet-18 trunk (stem, bn1, relu, maxpool, layer1, layer2) on the NCHW
snapshot, a 3x3 conv and a linear layer make the scene feature; residual
MLPs decode the latent. The weights are keyed by the reference
checkpoint's names. BatchNorm normalises with the running statistics when
sampling (eval mode) and with the batch's (biased variance) in training.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

W = Dict[str, torch.Tensor]


def _bn(w: W, p: str, x: torch.Tensor, train: bool) -> torch.Tensor:
    if train:
        return F.batch_norm(x, None, None, w[p + ".weight"], w[p + ".bias"], True, 0.0, 1e-5)
    return F.batch_norm(x, w[p + ".running_mean"], w[p + ".running_var"], w[p + ".weight"], w[p + ".bias"],
                        False, 0.0, 1e-5)


def _block(w: W, p: str, x: torch.Tensor, stride: int, train: bool) -> torch.Tensor:
    y = F.relu(_bn(w, p + ".bn1", F.conv2d(x, w[p + ".conv1.weight"], stride=stride, padding=1), train))
    y = _bn(w, p + ".bn2", F.conv2d(y, w[p + ".conv2.weight"], padding=1), train)
    if p + ".downsample.0.weight" in w:
        x = _bn(w, p + ".downsample.1", F.conv2d(x, w[p + ".downsample.0.weight"], stride=stride), train)
    return F.relu(y + x)


def encode_scene(w: W, p: str, xs: torch.Tensor, train: bool = False) -> torch.Tensor:
    """Snapshot [B, H, W, C] (NHWC) -> scene feature [B, hidden]."""
    x = F.conv2d(xs.permute(0, 3, 1, 2), w[p + "resnet.0.weight"], stride=2, padding=3)
    x = F.max_pool2d(F.relu(_bn(w, p + "resnet.1", x, train)), 3, stride=2, padding=1)
    for layer, stride in (("resnet.4", 1), ("resnet.5", 2)):
        x = _block(w, f"{p}{layer}.0", x, stride, train)
        x = _block(w, f"{p}{layer}.1", x, 1, train)
    x = F.conv2d(x, w[p + "conv.weight"], w[p + "conv.bias"], padding=1)
    return F.linear(x.flatten(1), w[p + "fc.weight"], w[p + "fc.bias"])


def _lin(w: W, p: str, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, w[p + ".weight"], w[p + ".bias"])


def _res(w: W, p: str, x: torch.Tensor) -> torch.Tensor:
    y = F.leaky_relu(_lin(w, p + ".fc1", x), 0.01)
    return F.leaky_relu(_lin(w, p + ".fc2", y), 0.01) + x


def _mlp(w: W, p: str, x: torch.Tensor) -> torch.Tensor:
    """Linear, two residual blocks, Linear (net_layers.py's decoders)."""
    x = _lin(w, p + ".0", x)
    x = _res(w, p + ".2", _res(w, p + ".1", x))
    return _lin(w, p + ".3", x)


def s1_decode(w: W, eps: torch.Tensor, z_s: torch.Tensor) -> torch.Tensor:
    z = torch.cat([_lin(w, "linear_latent", eps), z_s], 1)
    for i in range(2):
        z = _res(w, f"human_decoder.{i}", z)
    return _lin(w, "linear_out", z)


def s2_decode(w: W, eps_g: torch.Tensor, eps_l: torch.Tensor, z_g: torch.Tensor, z_l: torch.Tensor) -> torch.Tensor:
    x_g = _mlp(w, "trans_vae.decode", torch.cat([eps_g, z_g], 1))
    torso = _lin(w, "pose_vae.torso_linear", x_g)
    return torch.cat([x_g, _mlp(w, "pose_vae.decode", torch.cat([eps_l, torso, z_l], 1))], 1)


def sample_rows(model_type: str, w: W, xs: torch.Tensor, rows: torch.Tensor, eps) -> torch.Tensor:
    """75-D normalised bodies, one a row: row r decodes latent eps[r] (S2: a
    pair) against snapshot xs[rows[r]]. Each snapshot is encoded once."""
    if model_type == "s1":
        return s1_decode(w, eps, encode_scene(w, "", xs)[rows])
    return s2_decode(w, eps[0], eps[1], encode_scene(w, "trans_vae.", xs)[rows],
                     encode_scene(w, "pose_vae.", xs)[rows])


def s1_forward(w: W, x75: torch.Tensor, xs: torch.Tensor, eps: torch.Tensor):
    """Stage 1's training forward (BatchNorm on the batch): (x_rec, mu, logvar)."""
    z_s = encode_scene(w, "", xs, train=True)
    z = torch.cat([_lin(w, "linear_in", x75), z_s], 1)
    for i in range(2):
        z = _res(w, f"human_encoder.{i}", z)
    mu, logvar = _lin(w, "mu_enc", z), _lin(w, "logvar_enc", z)
    return s1_decode(w, mu + eps * torch.exp(0.5 * logvar), z_s), mu, logvar


def _encode(w: W, p: str, x: torch.Tensor, n: int) -> torch.Tensor:
    for i in range(n):
        x = _res(w, f"{p}.{i}", x)
    return x


def s2_forward(w: W, x75: torch.Tensor, xs: torch.Tensor, eps_g: torch.Tensor, eps_l: torch.Tensor):
    """Stage 2's training forward (BatchNorm on the batch; cvae.py:372-388,
    train_s2.py:102-210): the global VAE encodes the translation, the local
    VAE the 72-D rest and the *reconstructed* translation. Returns
    (x_rec, mu_g, logvar_g, mu_l, logvar_l)."""
    z_g = encode_scene(w, "trans_vae.", xs, train=True)
    f = _encode(w, "trans_vae.encode", torch.cat([z_g, _lin(w, "trans_vae.torso_linear", x75[:, :3])], 1), 2)
    mu_g, logvar_g = _lin(w, "trans_vae.mean_linear", f), _lin(w, "trans_vae.log_var_linear", f)
    x_g = _mlp(w, "trans_vae.decode", torch.cat([mu_g + eps_g * torch.exp(0.5 * logvar_g), z_g], 1))
    z_l = encode_scene(w, "pose_vae.", xs, train=True)
    torso = _lin(w, "pose_vae.torso_linear", x_g)
    f = _encode(w, "pose_vae.encode", torch.cat([_lin(w, "pose_vae.pose_linear", x75[:, 3:]), torso, z_l], 1), 2)
    mu_l, logvar_l = _lin(w, "pose_vae.mean_linear", f), _lin(w, "pose_vae.log_var_linear", f)
    x_l = _mlp(w, "pose_vae.decode", torch.cat([mu_l + eps_l * torch.exp(0.5 * logvar_l), torso, z_l], 1))
    return torch.cat([x_g, x_l], 1), mu_g, logvar_g, mu_l, logvar_l
