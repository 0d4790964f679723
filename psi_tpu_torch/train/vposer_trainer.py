"""VPoser trainer — the pose-prior VAE training loop.

Port of ``psi_tpu.train.vposer_trainer`` (reference: human_body_prior/
train/vposer_smpl.py:174-489): mesh-space L1 reconstruction x1000 through
the body model ('high' LBS) + analytic KL(q || N(0,1)), plus a
pose-space MSE term while ``epoch < pose_rec_epochs`` (vposer_smpl.py:
339-340); AdamW with weight decay on every parameter, at psi_tpu's
``optax.piecewise_constant_schedule`` (x0.5 at the optimizer-step counts
``e * steps_per_epoch`` for e in range(n//3, n, n//3), applied when the
count reaches the boundary), set before each step; best-model snapshots
named ``snapshots/TR{try:02d}_E{epoch:03d}.pt`` (vposer_smpl.py:372), torch
state dicts under the reference checkpoint's ``bodyprior_*`` names, so
``utils.convert_torch.load_vposer(work_dir)`` loads what the trainer wrote.

Randomness is explicit, as in psi_tpu: the batch order comes from one
``np.random.default_rng(seed)`` shared by training and evaluation (an
evaluation's permutation moves the next epoch's order, as in psi_tpu), and
the reparameterisation noise and the dropout masks from the trainer's own
``torch.Generator`` on its device (seed + 1), never from global state.

Runs on the first card unless ``device`` says otherwise. With a mesh
(``parallel.mesh``; data-parallel as ``TrainOP(mesh=)``): each rank trains
on B/R rows of every global batch, draws the whole batch's noise and masks
from the same generator and keeps its rows, its BatchNorms take the whole
batch's statistics, the gradients and losses are summed over the ranks
(each rank's share of a mean is scaled by 1/R), and only rank 0 writes the
log and the snapshots.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from psi_tpu_torch.body.smplx_model import SMPLXModel, smplx_forward
from psi_tpu_torch.body.vposer import VPoser
from psi_tpu_torch.data.amass import VPoserDS
from psi_tpu_torch.nn.layers import use_mesh
from psi_tpu_torch.parallel.distributed import all_reduce_sum_
from psi_tpu_torch.parallel.mesh import replicate
from psi_tpu_torch.utils.init import seeded_init_
from psi_tpu_torch.utils.precision import strict_f32
from psi_tpu_torch.utils.tools import EarlyStopping, log2file, makepath, resolve_device


@dataclasses.dataclass(frozen=True)
class VPoserTrainConfig:
    num_neurons: int = 512
    latentD: int = 32
    num_joints: int = 21
    batch_size: int = 256
    num_epochs: int = 10
    base_lr: float = 1e-3
    reg_coef: float = 1e-4  # Adam weight decay (ini: reg_coef)
    kl_coef: float = 5e-3  # vposer_smpl_defaults.ini convention
    mesh_scaler: float = 1000.0  # vposer_smpl.py:310
    pose_rec_epochs: int = 10  # pose-space MSE active below this epoch
    try_num: int = 0
    seed: int = 0
    expr_code: str = "vposer"


class VPoserTrainer:
    def __init__(
        self,
        work_dir: str,
        cfg: VPoserTrainConfig,
        dataset_dir: str,
        body_model: SMPLXModel,
        logger=None,
        mesh=None,
        device=None,
    ):
        if mesh is not None:
            if cfg.batch_size % mesh.size:
                raise ValueError(f"batch_size={cfg.batch_size} does not divide evenly over the {mesh.size}-rank mesh")
            device = mesh.device if device is None else device
        self.device = resolve_device(device, "VPoserTrainer")
        self.cfg = cfg
        self.mesh = mesh
        self.primary = mesh is None or mesh.rank == 0
        self.work_dir = makepath(work_dir) if self.primary else work_dir
        if logger is None:
            logger = log2file(os.path.join(work_dir, f"{cfg.expr_code}.log")) if self.primary else (lambda text: None)
        self.logger = logger
        self.bm = body_model.to(self.device)

        self.ds_train = VPoserDS(os.path.join(dataset_dir, "train"))
        self.ds_val = VPoserDS(os.path.join(dataset_dir, "vald"))
        self.ds_test = VPoserDS(os.path.join(dataset_dir, "test"))
        self.logger(f"Train dataset size {len(self.ds_train)}")

        vp = VPoser(num_neurons=cfg.num_neurons, latentD=cfg.latentD, num_joints=cfg.num_joints)
        self.model = seeded_init_(vp, cfg.seed).to(self.device)
        if mesh is not None:
            use_mesh(replicate(self.model, mesh), mesh)
        self.optimizer = torch.optim.AdamW(self.model.parameters(), lr=cfg.base_lr, betas=(0.9, 0.999), eps=1e-8,
                                           weight_decay=cfg.reg_coef)
        # StepLR(gamma=0.5, step=num_epochs//3) as psi_tpu's optax schedule: the
        # optimizer-step counts at which the learning rate halves
        self.steps_per_epoch = max(1, len(self.ds_train) // cfg.batch_size)
        every = max(1, cfg.num_epochs // 3)
        self.boundaries = sorted({e * self.steps_per_epoch for e in range(every, cfg.num_epochs, every)})
        self.step_count = 0  # optimizer steps taken: the schedule's count

        self.best_loss_total = np.inf
        self.best_model_fname: Optional[str] = None
        self.epochs_completed = 0
        self._rng = np.random.default_rng(cfg.seed)
        self._gen = torch.Generator(device=self.device).manual_seed(cfg.seed + 1)

    # ------------------------------------------------------------------
    def lr_at(self, count: int) -> float:
        """The learning rate of optimizer step ``count`` (0-based)."""
        return self.cfg.base_lr * 0.5 ** sum(count >= b for b in self.boundaries)

    def _decode_mesh(self, pose_aa: torch.Tensor) -> torch.Tensor:
        b = pose_aa.shape[0]
        zeros3 = pose_aa.new_zeros((b, 3))
        verts, _ = smplx_forward(
            self.bm, transl=zeros3, global_orient=zeros3,
            betas=pose_aa.new_zeros((b, self.bm.shapedirs.shape[-1])), body_pose=pose_aa, precision="high",
        )
        return verts

    def _losses(self, pose_aa: torch.Tensor, epoch: int, train: bool, eps: Optional[torch.Tensor] = None):
        """(total, losses) of this rank's rows; over a mesh each is this
        rank's share of the global batch's mean."""
        cfg = self.cfg
        drec = self.model(pose_aa, eps=eps, generator=self._gen if train else None)
        mean, std, prec = drec["mean"], drec["std"], drec["pose_aa"]
        share = 1.0 if self.mesh is None else 1.0 / self.mesh.size

        with torch.no_grad():
            mesh_orig = self._decode_mesh(pose_aa) * cfg.mesh_scaler
        mesh_rec = self._decode_mesh(prec) * cfg.mesh_scaler
        loss_mesh = (1.0 - cfg.kl_coef) * torch.mean(torch.abs(mesh_orig - mesh_rec))

        # KL(N(mean, std) || N(0, 1)), summed over latent, mean over batch
        kl = -torch.log(std) + 0.5 * (std**2 + mean**2 - 1.0)
        loss_kl = cfg.kl_coef * torch.mean(torch.sum(kl, dim=1))

        losses = {"loss_kl": loss_kl, "loss_mesh_rec": loss_mesh}
        # pose-space MSE for early epochs (vposer_smpl.py:339-340)
        pose_gate = float(epoch < cfg.pose_rec_epochs) * float(train)
        losses["loss_pose_rec"] = pose_gate * (1.0 - cfg.kl_coef) * torch.mean(torch.sum((pose_aa - prec) ** 2, dim=1))
        if share != 1.0:
            losses = {k: v * share for k, v in losses.items()}
        total = sum(losses.values())
        losses["loss_total"] = total
        return total, losses

    def _summed(self, losses: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Detached losses, summed over the ranks of the mesh."""
        losses = {k: v.detach() for k, v in losses.items()}
        if self.mesh is not None:
            names = list(losses)
            losses = dict(zip(names, all_reduce_sum_(torch.stack([losses[k] for k in names]), self.mesh).unbind()))
        return losses

    def _train_step(self, pose_aa: torch.Tensor, epoch: int, eps: Optional[torch.Tensor] = None
                    ) -> Dict[str, torch.Tensor]:
        """One AdamW step on this rank's rows ``pose_aa`` at epoch ``epoch``;
        returns the global batch's losses (detached, on the device). The
        noise comes from the trainer's generator unless ``eps`` (the global
        batch's) injects it."""
        if eps is not None and self.mesh is not None:
            lo, hi = self.mesh.rows(eps.shape[0])
            eps = eps[lo:hi]
        self.model.train()
        for group in self.optimizer.param_groups:
            group["lr"] = self.lr_at(self.step_count)
        with strict_f32():
            self.optimizer.zero_grad(set_to_none=True)
            total, losses = self._losses(pose_aa, epoch, True, eps)
            total.backward()
            if self.mesh is not None:  # the shares' sums: the global gradient
                grads = [p.grad for p in self.model.parameters()]
                flat = all_reduce_sum_(torch.cat([g.reshape(-1) for g in grads]), self.mesh)
                for g, f in zip(grads, flat.split([g.numel() for g in grads])):
                    g.copy_(f.view_as(g))
            self.optimizer.step()
        self.step_count += 1
        return self._summed(losses)

    def _place(self, batch: np.ndarray) -> torch.Tensor:
        """A global numpy batch -> this rank's rows on the device."""
        if self.mesh is not None:
            lo, hi = self.mesh.rows(batch.shape[0])
            batch = batch[lo:hi]
        return torch.from_numpy(np.ascontiguousarray(batch)).to(self.device)

    @staticmethod
    def _means(totals: Dict[str, torch.Tensor], count: int) -> Dict[str, float]:
        return {k: float(v) / max(count, 1) for k, v in totals.items()}

    # ------------------------------------------------------------------
    def train_epoch(self) -> Dict[str, float]:
        """One pass over the training split; the mean of each loss over its
        steps (summed on the device in float64, read once at the end)."""
        totals: Dict[str, torch.Tensor] = {}
        count = 0
        for batch in self.ds_train.batches(self.cfg.batch_size, self._rng):
            losses = self._train_step(self._place(batch), self.epochs_completed)
            for k, v in losses.items():
                totals[k] = totals.get(k, 0.0) + v.double()
            count += 1
        return self._means(totals, count)

    def evaluate(self, split_name: str = "vald") -> Dict[str, float]:
        """Mean losses over ``split_name`` ('vald', else the test split) in
        eval mode. A split smaller than one batch gives {} (drop_last, as in
        psi_tpu)."""
        ds = self.ds_val if split_name == "vald" else self.ds_test
        self.model.eval()
        totals: Dict[str, torch.Tensor] = {}
        count = 0
        with torch.no_grad(), strict_f32():
            for batch in ds.batches(self.cfg.batch_size, self._rng):
                _, losses = self._losses(self._place(batch), self.epochs_completed, False)
                for k, v in self._summed(losses).items():
                    totals[k] = totals.get(k, 0.0) + v.double()
                count += 1
        return self._means(totals, count)

    def save_snapshot(self) -> str:
        """Write the model's state dict (on the CPU) as this epoch's
        snapshot, on rank 0 only; returns its path on every rank."""
        fname = os.path.join(self.work_dir, "snapshots",
                             f"TR{self.cfg.try_num:02d}_E{self.epochs_completed:03d}.pt")
        if self.primary:
            makepath(fname, isfile=True)
            torch.save({k: v.detach().cpu() for k, v in self.model.state_dict().items()}, fname)
        return fname

    def perform_training(self, num_epochs: Optional[int] = None, patience: Optional[int] = None):
        num_epochs = num_epochs or self.cfg.num_epochs
        stopper = EarlyStopping(patience=patience) if patience else None
        t0 = time.time()
        for _ in range(num_epochs):
            self.epochs_completed += 1
            train_losses = self.train_epoch()
            eval_losses = self.evaluate()
            msg = (
                f"[{self.cfg.expr_code}]_TR{self.cfg.try_num:02d}_E{self.epochs_completed:03d}"
                f" train={train_losses.get('loss_total', 0):.4e} eval={eval_losses.get('loss_total', 0):.4e}"
            )
            if eval_losses.get("loss_total", np.inf) < self.best_loss_total:
                self.best_loss_total = eval_losses["loss_total"]
                self.best_model_fname = self.save_snapshot()
                self.logger(msg + " ** ")
            else:
                self.logger(msg)
            if stopper is not None and stopper(eval_losses.get("loss_total", np.inf)):
                self.logger(f"Early stopping at epoch {self.epochs_completed}")
                break
        self.logger(f"Training done in {time.time() - t0:.1f}s; best {self.best_loss_total:.4e}")
        return self.best_loss_total

    def vis_results(self, poses_aa: np.ndarray, imgpath: str, n_show: int = 4) -> str:
        """Render orig / reconstructed / sampled pose triplets to a grid PNG
        (equivalent of VPoserTrainer.vis_results, vposer_smpl.py:408-462,
        on the software renderer, on the trainer's device). The sampled
        latents come from the trainer's generator."""
        from psi_tpu_torch.viz.mesh_viewer import MeshViewer, imagearray2file

        self.model.eval()
        mv = MeshViewer(width=256, height=256, device=self.device)
        faces = self.bm.faces.cpu().numpy()
        frames = np.zeros((3, n_show, 1, 256, 256, 3), np.uint8)
        with torch.no_grad(), strict_f32():
            poses = torch.as_tensor(np.asarray(poses_aa[:n_show], np.float32), device=self.device)
            rec = self.model(poses)["pose_aa"]
            z = torch.randn((n_show, self.cfg.latentD), generator=self._gen, device=self.device)
            gen = self.model.decode_aa(z)
            for row, pose_set in enumerate([poses, rec, gen]):
                for col in range(n_show):
                    verts = self._decode_mesh(pose_set[col : col + 1])[0].cpu().numpy()
                    mv.set_meshes([(
                        verts + np.array([0, 0, 2.5]),
                        faces,
                        np.tile([0.4, 0.5, 0.85], (verts.shape[0], 1)),
                    )], densify=0)
                    frames[row, col, 0] = mv.render()
        return imagearray2file(frames, imgpath)[0]

    def load_best(self) -> VPoser:
        """Load the best snapshot into the model (every rank reads rank 0's
        file, after a collective that rank 0 joins once it has written)."""
        if self.mesh is not None:
            all_reduce_sum_(torch.zeros(1, device=self.device), self.mesh)
        sd = torch.load(self.best_model_fname, map_location=self.device, weights_only=True)
        self.model.load_state_dict(sd)
        return self.model
