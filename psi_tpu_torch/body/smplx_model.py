"""SMPL-X body model: the tensors, a synthetic asset, and the forwards.

Port of ``psi_tpu.body.smplx_model``. ``SMPLXModel`` is a dataclass of
constant tensors; ``load_smplx_npz`` reads a SMPLX_{GENDER}.npz asset into
one; ``smplx_forward`` runs the einsum LBS tiers and
``smplx_forward_fused`` runs the vertex path through the fused skinning
kernel (K1 forward, K2 backward). ``synthetic_smplx`` builds, from a
numpy seed, exactly the arrays psi_tpu's ``synthetic_smplx`` builds, so
both packages see the same model.

SMPL-X topology: 10475 vertices, 55 joints = pelvis + 21 body + jaw +
2 eyes + 2x15 fingers; hand poses are PCA coefficients over the model's
hand components, with the hand mean folded into the pose.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from psi_tpu_torch.body.lbs import batch_rigid_transform, blend_shapes, joint_regressor_direct, lbs
from psi_tpu_torch.geometry.rot6d import aa_to_matrix
from psi_tpu_torch.ops.fused_skinning import SkinningBundle, fused_skinning_apply, make_skinning_bundle

NUM_SMPLX_VERTS = 10475
NUM_SMPLX_JOINTS = 55
NUM_BODY_JOINTS = 21

SMPLX_FIELDS = (
    "v_template", "shapedirs", "exprdirs", "posedirs", "J_regressor", "lbs_weights",
    "hands_components_l", "hands_components_r", "pose_mean", "faces",
)


@dataclasses.dataclass(frozen=True)
class SMPLXModel:
    """Constant SMPL-X tensors (float32, faces int64)."""

    v_template: torch.Tensor  # [V, 3]
    shapedirs: torch.Tensor  # [V, 3, n_betas]
    exprdirs: Optional[torch.Tensor]  # [V, 3, n_expr] or None
    posedirs: Optional[torch.Tensor]  # [(J-1)*9, V*3] or None
    J_regressor: torch.Tensor  # [J, V]
    lbs_weights: torch.Tensor  # [V, J]
    hands_components_l: torch.Tensor  # [n_pca, 45]
    hands_components_r: torch.Tensor  # [n_pca, 45]
    pose_mean: torch.Tensor  # [J*3]
    faces: torch.Tensor  # [F, 3]
    parents: Tuple[int, ...]

    @property
    def num_verts(self) -> int:
        return self.v_template.shape[0]

    @property
    def num_joints(self) -> int:
        return len(self.parents)

    def to(self, device) -> "SMPLXModel":
        moved = {f: None if getattr(self, f) is None else getattr(self, f).to(device) for f in SMPLX_FIELDS}
        return dataclasses.replace(self, **moved)


def _build_pose_mean(num_joints, hands_mean_l, hands_mean_r, flat_hand_mean: bool) -> np.ndarray:
    pose_mean = np.zeros(num_joints * 3, dtype=np.float32)
    if not flat_hand_mean:
        # hands are the last 30 joints: 15 left then 15 right
        pose_mean[-90:-45] = hands_mean_l
        pose_mean[-45:] = hands_mean_r
    return pose_mean


def load_smplx_npz(
    npz_path: str,
    num_betas: int = 10,
    num_pca_comps: int = 12,
    num_expression_coeffs: int = 10,
    flat_hand_mean: bool = False,
    use_posedirs: bool = True,
    device="cpu",
) -> SMPLXModel:
    """Load a SMPLX_{GENDER}.npz asset into an SMPLXModel.

    Field semantics follow the smplx package (and the vendored
    human_body_prior/body_model/body_model.py:34-185): shapedirs columns
    [0:num_betas] are shape, [300:300+n_expr] are expression (when the
    asset carries the 400-wide basis). posedirs [V, 3, (J-1)*9] is stored
    flat and transposed, [(J-1)*9, V*3]; the root's parent, which the asset
    stores as 2^32 - 1, becomes -1; the hand PCA bases are cut to
    ``num_pca_comps`` rows and the hand means go into ``pose_mean`` unless
    ``flat_hand_mean``.
    """
    data = np.load(npz_path, allow_pickle=True)
    v_template = np.asarray(data["v_template"], dtype=np.float32)
    shapedirs_all = np.asarray(data["shapedirs"], dtype=np.float32)
    shapedirs = shapedirs_all[:, :, :num_betas]
    exprdirs = None
    if shapedirs_all.shape[-1] >= 300 + num_expression_coeffs:
        exprdirs = shapedirs_all[:, :, 300 : 300 + num_expression_coeffs]

    posedirs = None
    if use_posedirs and "posedirs" in data:
        pd = np.asarray(data["posedirs"], dtype=np.float32)  # [V, 3, (J-1)*9]
        posedirs = pd.reshape(-1, pd.shape[-1]).T  # [(J-1)*9, V*3]

    kintree = np.asarray(data["kintree_table"], dtype=np.int64)
    parents = tuple(int(p) if p < 2**31 else -1 for p in kintree[0])
    parents = (-1,) + parents[1:]

    hands_l = np.asarray(data["hands_componentsl"], dtype=np.float32)[:num_pca_comps]
    hands_r = np.asarray(data["hands_componentsr"], dtype=np.float32)[:num_pca_comps]
    pose_mean = _build_pose_mean(
        len(parents),
        np.asarray(data["hands_meanl"], dtype=np.float32),
        np.asarray(data["hands_meanr"], dtype=np.float32),
        flat_hand_mean,
    )

    def t(a):
        return None if a is None else torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return SMPLXModel(
        v_template=t(v_template), shapedirs=t(shapedirs), exprdirs=t(exprdirs), posedirs=t(posedirs),
        J_regressor=t(np.asarray(data["J_regressor"], dtype=np.float32)),
        lbs_weights=t(np.asarray(data["weights"], dtype=np.float32)),
        hands_components_l=t(hands_l), hands_components_r=t(hands_r), pose_mean=t(pose_mean),
        faces=t(np.asarray(data["f"], dtype=np.int64).reshape(-1, 3)),
        parents=parents,
    )


def synthetic_smplx(
    num_verts: int = NUM_SMPLX_VERTS,
    num_joints: int = NUM_SMPLX_JOINTS,
    num_betas: int = 10,
    num_pca_comps: int = 12,
    seed: int = 0,
    use_posedirs: bool = True,
    device="cpu",
) -> SMPLXModel:
    """Random but structurally faithful SMPL-X asset: the same numpy draws,
    in the same order, as psi_tpu's ``synthetic_smplx``."""
    rng = np.random.default_rng(seed)
    parents = (-1,) + tuple(int(rng.integers(0, max(1, j))) for j in range(1, num_joints))

    v_template = rng.normal(0, 0.3, size=(num_verts, 3)).astype(np.float32)
    v_template[:, 1] += np.linspace(-0.8, 0.8, num_verts).astype(np.float32)

    J_reg = rng.random((num_joints, num_verts)).astype(np.float32) ** 8
    J_reg /= J_reg.sum(axis=1, keepdims=True)

    w = rng.random((num_verts, num_joints)).astype(np.float32) ** 6
    w /= w.sum(axis=1, keepdims=True)

    shapedirs = (rng.normal(0, 0.01, size=(num_verts, 3, num_betas))).astype(np.float32)
    posedirs = None
    if use_posedirs:
        pd = rng.normal(0, 1e-3, size=(num_verts, 3, (num_joints - 1) * 9)).astype(np.float32)
        posedirs = pd.reshape(-1, pd.shape[-1]).T

    hands_l = rng.normal(0, 0.1, size=(num_pca_comps, 45)).astype(np.float32)
    hands_r = rng.normal(0, 0.1, size=(num_pca_comps, 45)).astype(np.float32)
    pose_mean = _build_pose_mean(
        num_joints,
        rng.normal(0, 0.05, size=45).astype(np.float32),
        rng.normal(0, 0.05, size=45).astype(np.float32),
        flat_hand_mean=False,
    ) if num_joints == NUM_SMPLX_JOINTS else np.zeros(num_joints * 3, np.float32)

    n_faces = max(1, num_verts - 2)
    faces = np.stack(
        [np.arange(n_faces), np.arange(1, n_faces + 1), np.arange(2, n_faces + 2)], axis=1
    ) % num_verts

    def t(a):
        return None if a is None else torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return SMPLXModel(
        v_template=t(v_template), shapedirs=t(shapedirs), exprdirs=None, posedirs=t(posedirs),
        J_regressor=t(J_reg), lbs_weights=t(w), hands_components_l=t(hands_l),
        hands_components_r=t(hands_r), pose_mean=t(pose_mean), faces=t(faces.astype(np.int64)),
        parents=parents,
    )


def smplx_vertex_subset(
    model: SMPLXModel, vert_ids: torch.Tensor
) -> Tuple[SMPLXModel, Tuple[torch.Tensor, torch.Tensor]]:
    """Slice the model to the rows ``vert_ids`` (repeats allowed).

    Returns (sub_model, joints_direct): the per-vertex tensors (v_template,
    shapedirs, exprdirs, posedirs, lbs_weights) keep only those rows, and
    joints_direct is the full model's ``joint_regressor_direct`` pair, so
    ``smplx_forward(sub_model, ..., joints_direct=joints_direct)`` gives the
    full model's vertices at those rows. Used by the fit's cheap iterations
    (FitConfig.cheap_collision_verts). faces are not remapped: the sub
    model is for losses."""
    vert_ids = vert_ids.to(torch.int64)
    jd = joint_regressor_direct(model.J_regressor, model.v_template, model.shapedirs)
    P = model.posedirs
    if P is not None:
        # posedirs is [(J-1)*9, V*3]: a vertex is three adjacent columns
        P = P.reshape(-1, model.num_verts, 3)[:, vert_ids, :].reshape(P.shape[0], -1)
    sub = dataclasses.replace(
        model,
        v_template=model.v_template[vert_ids],
        shapedirs=model.shapedirs[vert_ids],
        exprdirs=None if model.exprdirs is None else model.exprdirs[vert_ids],
        posedirs=P,
        J_regressor=model.J_regressor[:, vert_ids],  # unused with joints_direct
        lbs_weights=model.lbs_weights[vert_ids],
    )
    return sub, jd


def _assemble_pose_shape(
    model: SMPLXModel,
    global_orient: torch.Tensor,
    body_pose: torch.Tensor,
    betas: torch.Tensor,
    left_hand_pose: Optional[torch.Tensor],
    right_hand_pose: Optional[torch.Tensor],
    expression: Optional[torch.Tensor],
    jaw_pose: Optional[torch.Tensor],
    leye_pose: Optional[torch.Tensor],
    reye_pose: Optional[torch.Tensor],
):
    """Shared smplx preamble: (full_pose [B, J*3], shape_coeffs, shapedirs)."""
    B = betas.shape[0]
    J = model.num_joints
    dt, dev = model.v_template.dtype, model.v_template.device
    zeros3 = torch.zeros((B, 3), dtype=dt, device=dev)
    jaw = jaw_pose if jaw_pose is not None else zeros3
    leye = leye_pose if leye_pose is not None else zeros3
    reye = reye_pose if reye_pose is not None else zeros3
    if left_hand_pose is not None:
        lh = torch.matmul(left_hand_pose, model.hands_components_l)
    else:
        lh = torch.zeros((B, 45), dtype=dt, device=dev)
    if right_hand_pose is not None:
        rh = torch.matmul(right_hand_pose, model.hands_components_r)
    else:
        rh = torch.zeros((B, 45), dtype=dt, device=dev)

    if J == NUM_SMPLX_JOINTS:
        full_pose = torch.cat([global_orient, body_pose, jaw, leye, reye, lh, rh], dim=1)
    else:
        # reduced synthetic models: global + (J-1) joints from body_pose
        full_pose = torch.cat([global_orient, body_pose[:, : (J - 1) * 3]], dim=1)
    full_pose = full_pose + model.pose_mean[None]

    shapedirs, shape_coeffs = model.shapedirs, betas
    if expression is not None and model.exprdirs is not None:
        shapedirs = torch.cat([model.shapedirs, model.exprdirs], dim=-1)
        shape_coeffs = torch.cat([betas, expression], dim=-1)
    return full_pose, shape_coeffs, shapedirs


def smplx_forward(
    model: SMPLXModel,
    transl: torch.Tensor,  # [B, 3]
    global_orient: torch.Tensor,  # [B, 3]
    betas: torch.Tensor,  # [B, n_betas]
    body_pose: torch.Tensor,  # [B, 63]
    left_hand_pose: Optional[torch.Tensor] = None,
    right_hand_pose: Optional[torch.Tensor] = None,
    expression: Optional[torch.Tensor] = None,
    jaw_pose: Optional[torch.Tensor] = None,
    leye_pose: Optional[torch.Tensor] = None,
    reye_pose: Optional[torch.Tensor] = None,
    precision: str = "high",
    joints_direct: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """SMPL-X forward: body params -> (vertices [B, V, 3], joints [B, J, 3]).
    joints_direct: see ``lbs``; required for a ``smplx_vertex_subset`` model."""
    full_pose, shape_coeffs, shapedirs = _assemble_pose_shape(
        model, global_orient, body_pose, betas,
        left_hand_pose, right_hand_pose, expression, jaw_pose, leye_pose, reye_pose,
    )
    verts, joints = lbs(
        shape_coeffs, full_pose, model.v_template, shapedirs, model.posedirs,
        model.J_regressor, model.parents, model.lbs_weights, precision=precision,
        joints_direct=joints_direct,
    )
    return verts + transl[:, None, :], joints + transl[:, None, :]


def make_fused_bundle(model: SMPLXModel) -> SkinningBundle:
    """Constant operands of ``smplx_forward_fused``. Build it ONCE outside
    an optimisation loop and pass it in: rebuilding it per loss evaluation
    re-lays-out ~65 MB of model tensors (at SMPL-X's width: the basis in
    both layouts, zero-padded)."""
    return make_skinning_bundle(model.v_template, model.shapedirs, model.posedirs, model.lbs_weights)


def fused_operands(
    model: SMPLXModel,
    transl: torch.Tensor,
    global_orient: torch.Tensor,
    betas: torch.Tensor,
    body_pose: torch.Tensor,
    left_hand_pose: Optional[torch.Tensor] = None,
    right_hand_pose: Optional[torch.Tensor] = None,
    jaw_pose: Optional[torch.Tensor] = None,
    leye_pose: Optional[torch.Tensor] = None,
    reye_pose: Optional[torch.Tensor] = None,
    cam_ext: Optional[torch.Tensor] = None,
):
    """The fused kernel's per-body operands and the posed joints.

    Returns (cb [B, C], A12 [B, J, 12], cam12 [B, 12], joints [B, J, 3]):
    cb = [1 | shape_coeffs | pose_feature] in the bundle's basis order
    (the pose block only when the model has posedirs), A12 the top 3x4 of
    the skinning transforms, cam12 = (camR | camR @ transl + camT), and
    the joints with transl and camera applied. The small stages (pose
    assembly, Rodrigues, kinematic tree, joints through the folded
    regressor) run in plain f32 torch.
    """
    full_pose, shape_coeffs, shapedirs = _assemble_pose_shape(
        model, global_orient, body_pose, betas,
        left_hand_pose, right_hand_pose, None, jaw_pose, leye_pose, reye_pose,
    )
    B = betas.shape[0]
    J = model.num_joints
    rot_mats = aa_to_matrix(full_pose.reshape(B, J, 3))
    j_template, j_shapedirs = joint_regressor_direct(model.J_regressor, model.v_template, shapedirs)
    joints_rest = j_template[None] + blend_shapes(shape_coeffs, j_shapedirs)
    posed_joints, A = batch_rigid_transform(rot_mats, joints_rest, model.parents)

    cb_parts = [torch.ones((B, 1), dtype=shape_coeffs.dtype, device=shape_coeffs.device), shape_coeffs]
    if model.posedirs is not None:
        ident = torch.eye(3, dtype=shape_coeffs.dtype, device=shape_coeffs.device)
        cb_parts.append((rot_mats[:, 1:] - ident).reshape(B, -1))
    cb = torch.cat(cb_parts, dim=1)
    A12 = A[:, :, :3, :].reshape(B, J, 12)

    if cam_ext is None:
        camR = torch.eye(3, dtype=transl.dtype, device=transl.device).expand(B, 3, 3)
        camT = torch.zeros((B, 3), dtype=transl.dtype, device=transl.device)
    else:
        camR, camT = cam_ext[:, :3, :3], cam_ext[:, :3, 3]
    t_eff = torch.einsum("bxy,by->bx", camR, transl) + camT
    cam12 = torch.cat([camR, t_eff[:, :, None]], dim=-1).reshape(B, 12)

    joints = posed_joints + transl[:, None, :]
    if cam_ext is not None:
        joints = torch.einsum("bjy,bxy->bjx", joints, camR) + camT[:, None, :]
    return cb, A12, cam12, joints


def smplx_forward_fused(
    model: SMPLXModel,
    transl: torch.Tensor,
    global_orient: torch.Tensor,
    betas: torch.Tensor,
    body_pose: torch.Tensor,
    left_hand_pose: Optional[torch.Tensor] = None,
    right_hand_pose: Optional[torch.Tensor] = None,
    jaw_pose: Optional[torch.Tensor] = None,
    leye_pose: Optional[torch.Tensor] = None,
    reye_pose: Optional[torch.Tensor] = None,
    cam_ext: Optional[torch.Tensor] = None,  # [B, 4, 4], folded into the kernel
    bundle: Optional[SkinningBundle] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``smplx_forward`` followed by ``verts_transform(verts, cam_ext)``,
    with the vertex path in the fused skinning kernel, at the bf16-operand
    tier of lbs(precision='fast'). Expression blendshapes are not
    supported on this tier (the bundle folds model.shapedirs only)."""
    cb, A12, cam12, joints = fused_operands(
        model, transl, global_orient, betas, body_pose, left_hand_pose, right_hand_pose,
        jaw_pose, leye_pose, reye_pose, cam_ext,
    )
    if bundle is None:
        bundle = make_fused_bundle(model)
    # a stale bundle would give silently wrong vertices: fail loudly instead
    if bundle.n_verts != model.num_verts:
        raise ValueError(
            f"fused bundle was built for a {bundle.n_verts}-vertex model, "
            f"got model.num_verts={model.num_verts}"
        )
    if bundle.n_feat != cb.shape[1]:
        raise ValueError(
            f"fused bundle basis has n_feat={bundle.n_feat} coefficient rows "
            f"but the assembled coefficient vector has {cb.shape[1]} "
            "(posedirs presence or n_betas mismatch between the bundle's "
            "model and this one)"
        )
    return fused_skinning_apply(cb, A12, cam12, bundle), joints
