"""BodyModel / BodyModelWithPoser — high-level body-model wrappers.

Port of ``psi_tpu.body.body_model`` (reference: human_body_prior/
body_model/body_model.py:34-458): a unified front over SMPL-X npz assets
returning a result struct with vertices/faces/joints, plus the
VPoser-latent variant whose body pose lives in the prior's latent space,
with pose randomization and a self-interpenetration untangler.

As in psi_tpu, the untangler minimises a *sphere-proxy* self-penetration
loss on subsampled vertices (the reference's path needs an external BVH
CUDA extension, body_model.py:468-475): pairs of vertices closer than
``radius`` that are apart at rest are pushed apart, plus a latent prior
pull. The minimiser is psi_tpu's own L-BFGS with a strong-Wolfe line
search, ported as ``utils.lbfgs``: the objective, the stopping rules and
the evaluation budget are psi_tpu's.

Every wrapper runs on the first card unless ``device`` says otherwise.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from psi_tpu_torch.body.smplx_model import SMPLXModel, load_smplx_npz, smplx_forward, synthetic_smplx
from psi_tpu_torch.body.vposer import VPoser, vposer_decode
from psi_tpu_torch.utils.lbfgs import lbfgs_minimize
from psi_tpu_torch.utils.tools import resolve_device


@dataclasses.dataclass
class BodyResult:
    v: torch.Tensor  # [B, V, 3]
    f: torch.Tensor  # [F, 3]
    Jtr: torch.Tensor  # [B, J, 3]


class BodyModel:
    """Callable body model over explicit pose/shape params.

    params keys (all optional, zeros by default): transl, root_orient,
    betas, pose_body [B, 63], pose_hand (left+right PCA) or
    left_hand_pose / right_hand_pose. Arrays or tensors; they are moved to
    the model's device.
    """

    def __init__(self, model: SMPLXModel, batch_size: int = 1, device=None):
        self.device = resolve_device(device, "BodyModel")
        self.model = model.to(self.device)
        self.batch_size = batch_size

    @classmethod
    def from_npz(cls, npz_path: str, batch_size: int = 1, device=None, **kw) -> "BodyModel":
        return cls(load_smplx_npz(npz_path, **kw), batch_size=batch_size, device=device)

    @classmethod
    def synthetic(cls, batch_size: int = 1, device=None, **kw) -> "BodyModel":
        return cls(synthetic_smplx(**kw), batch_size=batch_size, device=device)

    def _tensor(self, value) -> torch.Tensor:
        return torch.as_tensor(value, dtype=torch.float32, device=self.device)

    def _default(self, params: Dict[str, Any], key: str, dim: int) -> torch.Tensor:
        if key in params and params[key] is not None:
            return self._tensor(params[key])
        return torch.zeros((self.batch_size, dim), dtype=torch.float32, device=self.device)

    def __call__(self, **params) -> BodyResult:
        n_pca = self.model.hands_components_l.shape[0]
        pose_hand = params.get("pose_hand")
        if pose_hand is not None:
            lh, rh = torch.chunk(self._tensor(pose_hand), 2, dim=-1)
        else:
            lh = self._default(params, "left_hand_pose", n_pca)
            rh = self._default(params, "right_hand_pose", n_pca)
        verts, joints = smplx_forward(
            self.model,
            transl=self._default(params, "transl", 3),
            global_orient=self._default(params, "root_orient", 3),
            betas=self._default(params, "betas", self.model.shapedirs.shape[-1]),
            body_pose=self._default(params, "pose_body", 63),
            left_hand_pose=lh,
            right_hand_pose=rh,
        )
        return BodyResult(v=verts, f=self.model.faces, Jtr=joints)


class BodyModelWithPoser(BodyModel):
    """Body pose expressed as a VPoser latent (reference
    body_model.py:281-400): forward decodes poZ_body through the prior."""

    def __init__(self, model: SMPLXModel, vposer: VPoser, batch_size: int = 1, device=None):
        super().__init__(model, batch_size, device)
        self.vposer = vposer.to(self.device)
        self.poZ_body = torch.zeros((batch_size, vposer.latentD), dtype=torch.float32, device=self.device)

    def __call__(self, **params) -> BodyResult:
        poZ = self._tensor(params.pop("poZ_body", self.poZ_body))
        pose_body = vposer_decode(self.vposer, poZ)
        return super().__call__(pose_body=pose_body, **params)

    def randomize_pose(self, generator: Optional[torch.Generator] = None) -> None:
        """Draw poZ_body ~ N(0, 1) from ``generator`` (one on this model's
        device; None: a new one seeded 0) (reference body_model.py:381-400)."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        self.poZ_body = torch.randn(self.poZ_body.shape, generator=generator, device=self.device)

    def _untangle_objective(self, n_samples: int = 512, radius: float = 0.04, prior_weight: float = 0.1,
                            seed: int = 0):
        """The untangler's objective z -> penalty (psi_tpu's, :120-141): the
        proxy penalty over ``n_samples`` vertices drawn with
        ``np.random.default_rng(seed)`` plus ``prior_weight * mean(z^2)``."""
        m = self.model
        rng = np.random.default_rng(seed)
        sel = torch.from_numpy(
            np.sort(rng.choice(m.num_verts, size=min(n_samples, m.num_verts), replace=False))
        ).to(self.device)
        rest = m.v_template[sel]
        rest_d2 = torch.sum((rest[:, None, :] - rest[None, :, :]) ** 2, dim=-1)
        # pairs that are separated at rest but could collide when posed
        mask = rest_d2 > (4.0 * radius) ** 2
        b = self.batch_size

        def objective(z: torch.Tensor) -> torch.Tensor:
            pose_body = vposer_decode(self.vposer, z)
            zeros3 = z.new_zeros((b, 3))
            verts, _ = smplx_forward(m, transl=zeros3, global_orient=zeros3,
                                     betas=z.new_zeros((b, m.shapedirs.shape[-1])), body_pose=pose_body)
            p = verts[:, sel, :]
            d2 = torch.sum((p[:, :, None, :] - p[:, None, :, :]) ** 2, dim=-1)
            pen = torch.clamp(radius**2 - d2, min=0.0) * mask[None]
            return torch.sum(pen) + prior_weight * torch.mean(z**2)

        return objective

    def untangle_interpenetrations(
        self,
        max_iter: int = 30,
        n_samples: int = 512,
        radius: float = 0.04,
        prior_weight: float = 0.1,
        seed: int = 0,
    ) -> None:
        """Resolve self-interpenetration by L-BFGS over poZ_body
        (``_untangle_objective``; replaces the reference's BVH-CUDA pathway,
        body_model.py:402-458)."""
        objective = self._untangle_objective(n_samples, radius, prior_weight, seed)
        self.poZ_body = lbfgs_minimize(objective, self.poZ_body, max_iter=max_iter).x
