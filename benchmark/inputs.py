"""Everything a run feeds the program and the reference, made from the seed
on the run's device: model weights, the SMPL-X body and the VPoser
decoder, the scenes, snapshots and latents.

One ``torch.Generator`` on the device draws each group of tensors in one
call, so set-up stays short and the same seed gives the same inputs. The
program gets these tensors through its own constructors; the reference
reads them as they are. Nothing here imports the program.
"""

from __future__ import annotations

import copy
import math
from typing import Dict, List, Tuple

import torch

from benchmark.reference.body import SMPLX_PARENTS

SEED_MASK = (1 << 63) - 1


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator for one purpose (``stream``) of one seed."""
    return torch.Generator(device=device).manual_seed((int(seed) * 1000003 + stream) & SEED_MASK)


def toy_psi(cfg: Dict, image_size: int) -> Dict:
    """A PSI configuration cut to the CPU tests' toy widths: latents 32,
    a 300-vertex body with 64 contact vertices, 16-cell SDF grids, 512-point
    clouds, snapshots of ``image_size`` px. SMPL-X's joint tree is kept."""
    cfg = copy.deepcopy(cfg)
    cfg.update(latentD=32, latentD_g=32, latentD_l=32, image_size=image_size)
    cfg["body"].update(num_verts=300, n_contact=64)
    cfg["scenes"].update(sdf_dim=16, scene_points=512)
    return cfg


def fill_weights(shapes: Dict[str, Tuple[int, ...]], gen: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """Random weights for a module's state-dict shapes, drawn in one call.

    A matrix or convolution kernel gets N(0, 1/fan_in), a bias N(0, 0.01^2);
    a BatchNorm (found by its running_mean) gets weight 1 + 0.1 N, bias
    0.1 N, running mean 0.1 N and running variance 1 + 0.1 |N|, so the
    activations stay of order one through the network."""
    names = sorted(shapes)
    sizes = [math.prod(shapes[n]) for n in names]
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    bn = {n[: -len(".running_mean")] for n in names if n.endswith(".running_mean")}
    out, o = {}, 0
    for n, k in zip(names, sizes):
        r = flat[o:o + k].reshape(shapes[n])
        o += k
        prefix, _, leaf = n.rpartition(".")
        if leaf == "num_batches_tracked":
            out[n] = torch.zeros(shapes[n], dtype=torch.int64, device=device)
        elif prefix in bn:
            out[n] = {"weight": 1.0 + 0.1 * r, "bias": 0.1 * r, "running_mean": 0.1 * r,
                      "running_var": 1.0 + 0.1 * r.abs()}[leaf]
        elif len(shapes[n]) >= 2:
            out[n] = r / math.sqrt(math.prod(shapes[n][1:]))
        else:
            out[n] = 0.01 * r
    return out


def training_start(shapes: Dict[str, Tuple[int, ...]], gen: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """Weights as a training run of the program starts them (PyTorch's
    default bound, ``utils/init.py::seeded_init_``), drawn in one call: every
    matrix or convolution kernel, and its bias, uniform in +-1/sqrt(fan_in)
    of the kernel; a BatchNorm (found by its running_mean) at identity."""
    names = sorted(shapes)
    sizes = [math.prod(shapes[n]) for n in names]
    flat = torch.rand(sum(sizes), generator=gen, device=device) * 2.0 - 1.0
    bn = {n[: -len(".running_mean")] for n in names if n.endswith(".running_mean")}
    out, o = {}, 0
    for n, k in zip(names, sizes):
        r = flat[o:o + k].reshape(shapes[n])
        o += k
        prefix, _, leaf = n.rpartition(".")
        if leaf == "num_batches_tracked":
            out[n] = torch.zeros(shapes[n], dtype=torch.int64, device=device)
        elif prefix in bn:
            out[n] = (torch.ones_like(r) if leaf in ("weight", "running_var") else torch.zeros_like(r))
        else:
            out[n] = r / math.sqrt(math.prod(shapes[prefix + ".weight"][1:]))
    return out


def make_body(cfg: Dict, gen: torch.Generator, device) -> Dict:
    """An SMPL-X body at the configuration's sizes: a template spread over
    1.6 m of height, sparse positive regressor and skinning weights (rows
    sum to 1), shape and pose bases, hand PCA bases and hand means, the
    contact vertex ids, and SMPL-X's kinematic tree."""
    b = cfg["body"]
    V, J, L, P = b["num_verts"], b["num_joints"], b["num_betas"], b["num_pca_comps"]
    if J != len(SMPLX_PARENTS):
        raise ValueError(f"the body has {J} joints; SMPL-X's tree has {len(SMPLX_PARENTS)}")
    n_pd = (J - 1) * 9 * V * 3
    normal = torch.randn(V * 3 + V * 3 * L + n_pd + 2 * P * 45 + 90, generator=gen, device=device)
    uniform = torch.rand(J * V + V * J, generator=gen, device=device)
    v_template, shapedirs, posedirs, hands_l, hands_r, hand_means = torch.split(
        normal, [V * 3, V * 3 * L, n_pd, P * 45, P * 45, 90])
    v_template = v_template.reshape(V, 3) * 0.3
    v_template[:, 1] += torch.linspace(-0.8, 0.8, V, device=device)
    pose_mean = torch.cat([torch.zeros(J * 3 - 90, device=device), hand_means * 0.05])
    jreg = uniform[: J * V].reshape(J, V) ** 8
    w = uniform[J * V:].reshape(V, J) ** 6
    contact = torch.sort(torch.randperm(V, generator=gen, device=device)[: b["n_contact"]]).values
    return {
        "v_template": v_template, "shapedirs": shapedirs.reshape(V, 3, L) * 0.01,
        "posedirs": posedirs.reshape((J - 1) * 9, V * 3) * 1e-3,
        "J_regressor": jreg / jreg.sum(1, keepdim=True), "lbs_weights": w / w.sum(1, keepdim=True),
        "hands_components_l": hands_l.reshape(P, 45) * 0.1, "hands_components_r": hands_r.reshape(P, 45) * 0.1,
        "pose_mean": pose_mean,
        "parents": SMPLX_PARENTS, "contact": contact,
    }


def make_scenes(cfg: Dict, gen: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """Rooms of a 6 m box each: an SDF grid [S, D, D, D] of a floor plane and
    a sphere obstacle (axes x, y, z; y up), its bounds, and a cloud of
    scene points drawn uniformly in the box [S, P, 3] (raw order)."""
    s = cfg["scenes"]
    S, D, P = s["num_scenes"], s["sdf_dim"], s["scene_points"]
    r = torch.rand(S * 8 + S * P * 3, generator=gen, device=device)
    par = r[: S * 8].reshape(S, 8)
    gmin = torch.tensor([-3.0, -3.0, 0.0], device=device) + 0.4 * (par[:, 0:3] - 0.5)
    gmax = torch.tensor([3.0, 3.0, 6.0], device=device) + 0.4 * (par[:, 3:6] - 0.5)
    floor = -2.5 + par[:, 6]
    center = (par[:, 0:3] - 0.5) * 2.0
    radius = 0.3 + 0.5 * par[:, 7]
    t = torch.linspace(0.0, 1.0, D, device=device)
    axes = gmin[:, None, :] + (gmax - gmin)[:, None, :] * t[None, :, None]  # [S, D, 3]
    X = axes[:, :, None, None, 0]
    Y = axes[:, None, :, None, 1]
    Z = axes[:, None, None, :, 2]
    sphere = torch.sqrt((X - center[:, 0, None, None, None]) ** 2 + (Y - center[:, 1, None, None, None]) ** 2
                        + (Z - center[:, 2, None, None, None]) ** 2) - radius[:, None, None, None]
    sdf = torch.minimum(Y - floor[:, None, None, None], sphere).contiguous()
    u = r[S * 8:].reshape(S, P, 3)
    cloud = gmin[:, None, :] + (gmax - gmin)[:, None, :] * u
    return {"sdf": sdf, "grid_mins": gmin.contiguous(), "grid_maxs": gmax.contiguous(), "cloud": cloud.contiguous()}


def make_snapshots(n: int, size: int, channels: int, gen: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """n snapshots (depth and semantics canvases in [-1, 1], NHWC), their
    intrinsics (focal 500-1100 px, principal point 250-550 px) and their
    maximum depth (4-6 m)."""
    r = torch.rand(n * size * size * channels + n * 5, generator=gen, device=device)
    xs = (r[: n * size * size * channels] * 2.0 - 1.0).reshape(n, size, size, channels)
    c = r[n * size * size * channels:].reshape(n, 5)
    cam_int = torch.zeros((n, 3, 3), device=device)
    cam_int[:, 0, 0] = 500 + 600 * c[:, 0]
    cam_int[:, 1, 1] = 500 + 600 * c[:, 1]
    cam_int[:, 0, 2] = 250 + 300 * c[:, 2]
    cam_int[:, 1, 2] = 250 + 300 * c[:, 3]
    cam_int[:, 2, 2] = 1.0
    return {"xs": xs, "cam_int": cam_int, "max_d": 4.0 + 2.0 * c[:, 4]}


def floor_placement(mean_transl: torch.Tensor, grid_min: torch.Tensor, grid_max: torch.Tensor, n: int) -> torch.Tensor:
    """Extrinsics [n, 4, 4] (identity rotation) that move a population whose
    mean translation is ``mean_transl`` to the middle of the scene's x/z
    extent at 0.8 of grid_min's height, into the floor, so that the fit has
    penetration to remove."""
    target = 0.5 * (grid_min + grid_max)
    target[1] = 0.8 * grid_min[1]
    cam = torch.eye(4, dtype=torch.float32, device=mean_transl.device).repeat(n, 1, 1)
    cam[:, :3, 3] = target - mean_transl
    return cam


def latents(model_type: str, rows: int, gen: torch.Generator, device, eps_d: int = 32):
    """The prior draws of ``rows`` bodies: [rows, eps_d] for stage 1, a pair
    of [rows, 32] for stage 2."""
    if model_type == "s1":
        return torch.randn((rows, eps_d), generator=gen, device=device)
    e = torch.randn((2, rows, 32), generator=gen, device=device)
    return (e[0], e[1])


def pick(seed: int, stream: int, n: int, k: int) -> List[int]:
    """k distinct indices of range(n) drawn from the seed (all when n <= k)."""
    if n <= k:
        return list(range(n))
    g = torch.Generator().manual_seed((int(seed) * 1000003 + stream) & SEED_MASK)
    return sorted(torch.randperm(n, generator=g)[:k].tolist())
