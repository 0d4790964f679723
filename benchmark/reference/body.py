"""Plain PyTorch body decode: rotations, the 72-D body vector, the VPoser
decoder and SMPL-X linear blend skinning.

Written from the PSI reference's equations (source/cvae.py:36-301,
human_body_prior body_model/lbs.py and vposer_smpl.py). Every tensor comes
from the caller; nothing here is shared with the program under test. The
numerics are chosen by a ``Numerics`` object (``numerics.py``): which
operands of the three large LBS contractions are rounded, and to what.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

# SMPL-X's kinematic tree (55 joints): pelvis, 21 body joints, jaw, eyes,
# 15 joints of each hand.
SMPLX_PARENTS = (
    -1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18, 19, 15, 15, 15,
    20, 25, 26, 20, 28, 29, 20, 31, 32, 20, 34, 35, 20, 37, 38,
    21, 40, 41, 21, 43, 44, 21, 46, 47, 21, 49, 50, 21, 52, 53,
)

# layout of the 72-D body vector
TRANSL, ORIENT, BETAS, VP, LHAND, RHAND = (0, 3), (3, 6), (6, 16), (16, 48), (48, 60), (60, 72)


def _normalize(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=1e-12)


def rot6d_to_matrix(x6: torch.Tensor) -> torch.Tensor:
    """[..., 6] (first two columns, row-major) -> [..., 3, 3] by Gram-Schmidt."""
    m = x6.reshape(x6.shape[:-1] + (3, 2))
    b1 = _normalize(m[..., 0])
    a2 = m[..., 1]
    b2 = _normalize(a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1)
    return torch.stack([b1, b2, torch.linalg.cross(b1, b2, dim=-1)], dim=-1)


def aa_to_matrix(aa: torch.Tensor) -> torch.Tensor:
    """Rodrigues, with the Taylor series of sin(t)/t and (1-cos t)/t^2 near 0."""
    theta2 = torch.sum(aa * aa, dim=-1, keepdim=True)
    small = theta2 < 1e-8
    safe2 = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(safe2)
    sinc = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    cosc = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / safe2)
    x, y, z = aa[..., 0], aa[..., 1], aa[..., 2]
    o = torch.zeros_like(x)
    K = torch.stack([torch.stack([o, -z, y], -1), torch.stack([z, o, -x], -1), torch.stack([-y, x, o], -1)], -2)
    return torch.eye(3, dtype=aa.dtype, device=aa.device) + sinc[..., None] * K + cosc[..., None] * (K @ K)


def matrix_to_aa(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> axis-angle through the quaternion (Shepperd's
    method, largest pivot, w >= 0), finite at the identity."""
    m = [[R[..., i, j] for j in range(3)] for i in range(3)]
    piv = torch.stack([1.0 + m[0][0] + m[1][1] + m[2][2], 1.0 + m[0][0] - m[1][1] - m[2][2],
                       1.0 - m[0][0] + m[1][1] - m[2][2], 1.0 - m[0][0] - m[1][1] + m[2][2]], dim=-1)
    s = torch.sqrt(torch.clamp(piv, min=1e-8))
    a, b, c = m[2][1] - m[1][2], m[0][2] - m[2][0], m[1][0] - m[0][1]
    d, e, f = m[0][1] + m[1][0], m[0][2] + m[2][0], m[1][2] + m[2][1]
    cands = [
        torch.stack([0.5 * s[..., 0], a / (2 * s[..., 0]), b / (2 * s[..., 0]), c / (2 * s[..., 0])], -1),
        torch.stack([a / (2 * s[..., 1]), 0.5 * s[..., 1], d / (2 * s[..., 1]), e / (2 * s[..., 1])], -1),
        torch.stack([b / (2 * s[..., 2]), d / (2 * s[..., 2]), 0.5 * s[..., 2], f / (2 * s[..., 2])], -1),
        torch.stack([c / (2 * s[..., 3]), e / (2 * s[..., 3]), f / (2 * s[..., 3]), 0.5 * s[..., 3]], -1),
    ]
    best = torch.argmax(piv, dim=-1)[..., None]
    q = torch.where(best == 0, cands[0], torch.where(best == 1, cands[1], torch.where(best == 2, cands[2], cands[3])))
    q = _normalize(torch.where(q[..., :1] < 0, -q, q))
    w, v = q[..., 0], q[..., 1:]
    s2 = torch.sum(v * v, dim=-1)
    small = s2 < 1e-12
    sin_half = torch.where(small, torch.zeros_like(s2), torch.sqrt(torch.where(small, torch.ones_like(s2), s2)))
    theta = 2.0 * torch.atan2(sin_half, w)
    scale = torch.where(small, 2.0 / torch.clamp(torch.abs(w), min=1e-8), theta / torch.clamp(sin_half, min=1e-8))
    return v * scale[..., None]


def to_6d(x72: torch.Tensor) -> torch.Tensor:
    R = aa_to_matrix(x72[..., 3:6])
    return torch.cat([x72[..., :3], R[..., :, :2].reshape(R.shape[:-2] + (6,)), x72[..., 6:]], dim=-1)


def to_3d(x75: torch.Tensor) -> torch.Tensor:
    return torch.cat([x75[..., :3], matrix_to_aa(rot6d_to_matrix(x75[..., 3:9])), x75[..., 9:]], dim=-1)


def recover_global_T(x: torch.Tensor, cam_int: torch.Tensor, max_d: torch.Tensor) -> torch.Tensor:
    """Normalised translation -> metric camera-frame translation (cvae.py:152-172)."""
    fx, fy = cam_int[..., 0, 0], cam_int[..., 1, 1]
    s = 1.0 / torch.maximum(cam_int[..., 0, 2], cam_int[..., 1, 2])
    z = (x[..., 2] + 1.0) / 2.0 * max_d
    return torch.cat([torch.stack([x[..., 0] * z / s / fx, x[..., 1] * z / s / fy, z], -1), x[..., 3:]], -1)


def normalize_global_T(x: torch.Tensor, cam_int: torch.Tensor, max_d: torch.Tensor) -> torch.Tensor:
    """Metric translation -> the CVAE's normalised box (cvae.py:141-150)."""
    fx, fy = cam_int[..., 0, 0], cam_int[..., 1, 1]
    s = 1.0 / torch.maximum(cam_int[..., 0, 2], cam_int[..., 1, 2])
    t = x[..., :3]
    z = t[..., 2]
    n = torch.stack([s * t[..., 0] * fx / (z + 1e-6), s * t[..., 1] * fy / (z + 1e-6), 2.0 * z / max_d - 1.0], -1)
    return torch.cat([n, x[..., 3:]], -1)


def vposer_decode(vp: Dict[str, torch.Tensor], z: torch.Tensor) -> torch.Tensor:
    """VPoser's decoder with dropout off: latent [B, 32] -> body pose [B, 63]."""
    x = F.leaky_relu(F.linear(z, vp["bodyprior_dec_fc1.weight"], vp["bodyprior_dec_fc1.bias"]), 0.2)
    x = F.leaky_relu(F.linear(x, vp["bodyprior_dec_fc2.weight"], vp["bodyprior_dec_fc2.bias"]), 0.2)
    x6 = F.linear(x, vp["bodyprior_dec_out.weight"], vp["bodyprior_dec_out.bias"])
    return matrix_to_aa(rot6d_to_matrix(x6.reshape(z.shape[0], -1, 6))).reshape(z.shape[0], -1)


def _rigid_transforms(rot: torch.Tensor, joints: torch.Tensor, parents) -> torch.Tensor:
    """[B, J, 3, 3], rest joints [B, J, 3] -> skinning transforms, top 3x4 rows [B, J, 12]."""
    B, J = joints.shape[:2]
    rel = torch.cat([joints[:, :1], joints[:, 1:] - joints[:, list(parents[1:])]], dim=1)
    local = torch.cat([torch.cat([rot, rel[..., None]], -1),
                       torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=rot.dtype, device=rot.device).expand(B, J, 1, 4)], -2)
    world = [local[:, 0]]
    for j in range(1, J):
        world.append(world[parents[j]] @ local[:, j])
    T = torch.stack(world, 1)
    t = T[:, :, :3, 3] - torch.einsum("bjxy,bjy->bjx", T[:, :, :3, :3], joints)
    return torch.cat([T[:, :, :3, :3], t[..., None]], -1).reshape(B, J, 12)


def body_verts(body: Dict[str, torch.Tensor], vp: Dict[str, torch.Tensor], x72: torch.Tensor,
               cam_ext: torch.Tensor, num, folded_joints: bool) -> torch.Tensor:
    """x72 [B, 72] -> camera-applied vertices [B, V, 3].

    ``folded_joints``: the rest joints from the regressor folded through the
    shape basis (J_reg v_template + (J_reg shapedirs) betas, f32), the
    production tier's; else from the shaped vertices. ``num.op`` rounds the
    operands of the three large contractions (pose correctives, shape
    basis, skinning blend)."""
    B = x72.shape[0]
    parents = body["parents"]
    J = len(parents)
    betas = x72[:, BETAS[0]:BETAS[1]]
    pose = torch.cat([
        x72[:, ORIENT[0]:ORIENT[1]], vposer_decode(vp, x72[:, VP[0]:VP[1]]),
        torch.zeros((B, 9), dtype=x72.dtype, device=x72.device),
        x72[:, LHAND[0]:LHAND[1]] @ body["hands_components_l"], x72[:, RHAND[0]:RHAND[1]] @ body["hands_components_r"],
    ], 1) + body["pose_mean"][None]
    rot = aa_to_matrix(pose.reshape(B, J, 3))
    pf = (rot[:, 1:] - torch.eye(3, dtype=rot.dtype, device=rot.device)).reshape(B, -1)
    V = body["v_template"].shape[0]
    if folded_joints:
        jt = body["J_regressor"] @ body["v_template"]
        js = torch.einsum("jv,vkl->jkl", body["J_regressor"], body["shapedirs"])
        joints = jt[None] + torch.einsum("bl,jkl->bjk", betas, js)
        # the vertex path as one product over [1 | betas | pose feature]
        cb = torch.cat([torch.ones((B, 1), dtype=x72.dtype, device=x72.device), betas, pf], 1)
        basis = torch.cat([body["v_template"].T[:, None, :], body["shapedirs"].permute(1, 2, 0),
                           body["posedirs"].reshape(-1, V, 3).permute(2, 0, 1)], 1)  # [3, C, V]
        v_posed = torch.einsum("bc,ycv->bvy", num.op(cb), num.op(basis))
    else:
        v_shaped = body["v_template"][None] + torch.einsum("bl,vkl->bvk", betas, body["shapedirs"])
        joints = torch.einsum("bvk,jv->bjk", v_shaped, body["J_regressor"])
        v_posed = v_shaped + (num.op(pf) @ num.op(body["posedirs"])).reshape(B, V, 3)
    A12 = _rigid_transforms(rot, joints, parents)
    T = torch.einsum("vj,bjz->bvz", num.op(body["lbs_weights"]), num.op(A12)).reshape(B, V, 3, 4)
    verts = torch.einsum("bvxy,bvy->bvx", T[..., :3], v_posed) + T[..., 3] + x72[:, None, TRANSL[0]:TRANSL[1]]
    return torch.einsum("bvy,bxy->bvx", verts, cam_ext[:, :3, :3]) + cam_ext[:, None, :3, 3]
