"""Training loop: the train step and TrainOP, which runs it.

Port of ``psi_tpu.train.loop`` (reference source/train_s1.py:38-338 /
train_s2.py): same epoch structure, checkpoint cadence (every
``saving_per_hours`` of wall clock and every ``saving_per_epochs`` epochs),
resume from the newest checkpoint, per-step metrics and printout. The
model and the optimizer are stateful torch objects, so a step updates its
``TrainState`` in place and returns it with the metrics. One step is: zero
the gradients, ``cvae_loss``, backward, the optional global-norm clip,
Adam; all of it inside ``strict_f32`` (the backward too). On the card the
objective launches kernel K3 once per step.

Data-parallel training (``TrainOP(mesh=)``, ``parallel/mesh.py``): every rank
reads the same global batch and keeps its rows; the objective returns the
rank's share of the global loss (``train/objective.py``); after the backward
the gradients are summed over the ranks, the global-norm clip runs on the
sum, and Adam takes the same step on every rank. The latent noise is the
global batch's: every rank draws the whole batch's from the same generator
and keeps its rows. Only the primary rank writes checkpoints and
``metrics.jsonl``; the metrics it writes are the global batch's.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import os
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from psi_tpu_torch.models.cvae_s1 import HumanCVAES1
from psi_tpu_torch.models.cvae_s2 import HumanCVAES2
from psi_tpu_torch.nn.layers import use_mesh
from psi_tpu_torch.parallel.distributed import all_reduce_sum_, is_primary
from psi_tpu_torch.parallel.mesh import replicate, shard_batch
from psi_tpu_torch.train.checkpoint import load_newest_checkpoint, save_checkpoint
from psi_tpu_torch.train.objective import SceneAssets, cvae_loss
from psi_tpu_torch.utils.config import LossConfig, TrainConfig
from psi_tpu_torch.utils.init import seeded_init_
from psi_tpu_torch.utils.precision import strict_f32

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class TrainState:
    """What a step changes: the module (parameters and BatchNorm's running
    statistics), the optimizer (Adam's moments), the count of steps taken
    and the generator the latent noise is drawn from (on the model's
    device)."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int
    generator: torch.Generator


def build_model(cfg: TrainConfig) -> torch.nn.Module:
    if cfg.model_type == "s1":
        return HumanCVAES1(latentD=cfg.latentD, n_dim_body=cfg.n_dim_body, image_size=cfg.image_size)
    if cfg.model_type == "s2":
        return HumanCVAES2(latentD_g=cfg.latentD, latentD_l=cfg.latentD, n_dim_body=cfg.n_dim_body,
                           image_size=cfg.image_size)
    raise ValueError(f"unknown model_type {cfg.model_type}")


def make_optimizer(model: torch.nn.Module, lr: float) -> torch.optim.Adam:
    """``optax.adam(lr)``'s update: b1 0.9, b2 0.999, eps 1e-8 outside the root."""
    return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)


def init_state(cfg: TrainConfig, device) -> TrainState:
    """A model with weights drawn from ``cfg.seed`` on ``device``, its Adam,
    step 0 and a noise generator seeded with ``cfg.seed + 1``."""
    model = seeded_init_(build_model(cfg), cfg.seed).to(device)
    return TrainState(model, make_optimizer(model, cfg.init_lr_h), 0,
                      torch.Generator(device=device).manual_seed(cfg.seed + 1))


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float) -> None:
    """``optax.clip_by_global_norm`` in place: g * max_norm / max(norm, max_norm)
    (``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the norm)."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    scale = max_norm / torch.clamp(norm, min=max_norm)
    torch._foreach_mul_(grads, scale)


def global_noise(model: torch.nn.Module, batch_size: int, generator: torch.Generator, device):
    """The latents the model draws from ``generator`` for a batch of
    ``batch_size`` in train mode, drawn here in the same order and shapes:
    [B, 32] for S1; S2's global, then its local [B, 32]."""
    def draw(d):
        return torch.randn((batch_size, d), generator=generator, device=device, dtype=torch.float32)

    if isinstance(model, HumanCVAES2):
        return draw(model.trans_vae.zdim), draw(model.pose_vae.zdim)
    return draw(model.eps_d)


def make_train_step(
    assets: SceneAssets,
    loss_cfg: LossConfig,
    model_type: str,
    grad_clip_norm: Optional[float] = None,
    mesh=None,
) -> Callable:
    """step(state, batch, fca, f_scene, eps=None) -> (state, metrics).

    ``batch`` holds tensors on the model's device; metrics are detached 0-d
    tensors there (nothing is read back to the host). The latent noise
    comes from ``state.generator`` unless ``eps`` injects it. With a mesh,
    ``batch`` is this rank's rows of the global batch, ``eps`` (when given)
    is the global batch's, and the metrics are the global batch's."""

    def step(state: TrainState, batch, fca, f_scene, eps=None) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        params = [p for p in state.model.parameters() if p.requires_grad]
        gen = None if eps is not None else state.generator
        if mesh is not None:  # the global batch's noise, this rank's rows
            rows = next(iter(batch.values())).shape[0]
            lo, hi = mesh.rows(rows * mesh.size)
            if eps is None:
                eps = global_noise(state.model, rows * mesh.size, state.generator, mesh.device)
                gen = None
            eps = tuple(e[lo:hi] for e in eps) if isinstance(eps, tuple) else eps[lo:hi]
        with strict_f32():
            state.optimizer.zero_grad(set_to_none=True)
            total, metrics, _ = cvae_loss(
                state.model, batch, assets, fca, f_scene, loss_cfg, model_type=model_type, train=True,
                generator=gen, eps=eps, mesh=mesh,
            )
            # only the model's parameters: the assets' modules take no gradient
            total.backward(inputs=params)
            metrics = {k: v.detach() for k, v in metrics.items()}
            if mesh is not None:  # the shares' sums: the global gradient and metrics
                grads = [p.grad for p in params if p.grad is not None]  # the same set on every rank
                flat = all_reduce_sum_(torch.cat([g.reshape(-1) for g in grads]), mesh)
                for g, f in zip(grads, flat.split([g.numel() for g in grads])):
                    g.copy_(f.view_as(g))
                names = list(metrics)
                summed = all_reduce_sum_(torch.stack([metrics[k] for k in names]), mesh)
                metrics = dict(zip(names, summed.unbind()))
            if grad_clip_norm is not None:
                clip_by_global_norm_([p.grad for p in params], grad_clip_norm)
            state.optimizer.step()
        state.step += 1
        return state, metrics

    return step


def make_epoch_step(
    assets: SceneAssets,
    loss_cfg: LossConfig,
    model_type: str,
    grad_clip_norm: Optional[float] = None,
    mesh=None,
) -> Callable:
    """step_epoch(state, stacked, fca, f_scene) -> (state, metrics), where
    ``stacked`` holds K batches on a leading axis (``_stage_chunk``) and each
    metric comes back as a [K] tensor.

    psi_tpu scans the K steps inside one compiled program; here they are K
    calls of the train step over slices of the one staged chunk. The steps,
    and the noise drawn for each, are those of the per-step loop: the chunk
    size changes memory and the number of host -> device copies, never the
    result."""
    step = make_train_step(assets, loss_cfg, model_type, grad_clip_norm, mesh)

    def step_epoch(state: TrainState, stacked, fca, f_scene):
        rows = []
        for i in range(next(iter(stacked.values())).shape[0]):
            state, m = step(state, {k: v[i] for k, v in stacked.items()}, fca, f_scene)
            rows.append(m)
        return state, {k: torch.stack([m[k] for m in rows]) for k in rows[0]}

    return step_epoch


def _stage_chunk(group: List[Dict[str, np.ndarray]], stage_bf16: bool, device) -> Dict[str, torch.Tensor]:
    """Stack a chunk of host batches and move it with ONE copy per leaf:
    ``np.stack``, then (for a card) a pinned host buffer and a non-blocking
    copy. With stage_bf16 the snapshot images cross in bfloat16 (half the
    bytes; the objective upcasts on entry)."""
    device = torch.device(device)
    out = {}
    for k in group[0]:
        t = torch.from_numpy(np.stack([g[k] for g in group]))
        if k == "xs" and stage_bf16:
            t = t.to(torch.bfloat16)
        if device.type == "cuda":
            t = t.pin_memory()
        out[k] = t.to(device, non_blocking=True)
    return out


class TrainOP:
    """End-to-end training (reference TrainOP, train_s1.py:38-338).

    Runs on the first card unless ``device`` says otherwise; ``assets`` must
    live on the same device. With a mesh (data-parallel, module docstring)
    it runs on the mesh's device unless ``device`` names one, the model
    starts as rank 0's, its BatchNorms take the global batch's statistics,
    and ``cfg.batch_size`` (the global batch) must divide over the ranks."""

    def __init__(self, cfg: TrainConfig, loss_cfg: LossConfig, assets: SceneAssets, device=None, mesh=None):
        if mesh is not None:
            if cfg.batch_size % mesh.size:
                raise ValueError(f"batch_size={cfg.batch_size} does not divide evenly over the {mesh.size}-rank mesh")
            device = mesh.device if device is None else device
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError("TrainOP runs on an NVIDIA card; pass device='cpu' to train on the CPU")
            device = torch.device("cuda", 0)
        self.cfg = cfg
        self.loss_cfg = loss_cfg
        self.assets = assets
        self.device = torch.device(device)
        self.mesh = mesh
        self.state = init_state(cfg, self.device)
        if mesh is not None:
            use_mesh(replicate(self.state.model, mesh), mesh)
        self.epoch_fn = make_epoch_step(assets, loss_cfg, cfg.model_type, cfg.grad_clip_norm, mesh)

    @property
    def model(self) -> torch.nn.Module:
        return self.state.model

    def train(self, batch_gen, log_fn: Optional[Callable[[str], None]] = None) -> Dict[str, float]:
        """batch_gen: the data layer's protocol (has_next_batch / next_batch /
        reset) yielding numpy batches. Per-step metrics also stream to
        {save_dir}/metrics.jsonl. Returns the last step's metrics.

        With ``cfg.scan_epoch`` batches are staged ``scan_chunk_size`` at a
        time and each chunk's metrics are read back once, after the next
        chunk has been enqueued; otherwise each step stages its own batch
        and its metrics are read back at once (one transfer per step)."""
        cfg = self.cfg
        primary = is_primary()
        log = log_fn or (print if cfg.verbose and primary else (lambda *_: None))
        if primary:
            os.makedirs(cfg.save_dir, exist_ok=True)

        starting_ep = 0
        skip_batches = 0  # mid-epoch resume: batches of starting_ep already trained
        if cfg.resume_training:
            restored = load_newest_checkpoint(cfg.save_dir, self.state)
            if restored is not None:
                starting_ep = restored["epoch"]
                skip_batches = restored["batches_done"]
                log(f"[INFO] --resuming training from {restored['path']}")

        chunk = max(1, cfg.scan_chunk_size) if cfg.scan_epoch else 1
        last_metrics: Dict[str, float] = {}
        start_time = time.time()
        metrics_path = os.path.join(cfg.save_dir, "metrics.jsonl")
        with open(metrics_path, "a") if primary else contextlib.nullcontext() as metrics_f:

            def drain(pending) -> None:
                """One read-back for a group's metrics; one jsonl row per step."""
                nonlocal last_metrics
                ep, metrics = pending
                names = list(metrics)
                values = torch.stack([metrics[k] for k in names], dim=1).tolist()  # [steps][names]
                for row in values:
                    last_metrics = dict(zip(names, row))
                    if metrics_f is not None:
                        metrics_f.write(json.dumps({"epoch": ep + 1, **last_metrics}) + "\n")
                    if cfg.verbose and not cfg.scan_epoch:
                        log("---in [epoch {:d}]: rec_t={:f}, rec_p={:f}, kl={:f}, vp={:f}, "
                            "contact={:f}, collision={:f}".format(
                                ep + 1, last_metrics["rec_t"], last_metrics["rec_p"], last_metrics["kl"],
                                last_metrics["vposer"], last_metrics["contact"], last_metrics["collision"]))

            for ep in range(starting_ep, cfg.epoch):
                # epoch-dependent gates (train_s1.py:123-128, 171-177, 200-204)
                fca = 1.0
                if self.loss_cfg.loss_weight_anealing:
                    fca = min(1.0, max(float(ep) / (cfg.epoch * 0.75), 0.0))
                f_scene = 1.0 if ep > 0.75 * cfg.epoch else 0.0

                n_skip = skip_batches if ep == starting_ep else 0
                batches_done = n_skip
                pending = None  # (epoch, device metrics) of the group in flight

                def run_group(group) -> None:
                    nonlocal pending, batches_done, start_time
                    stacked = _stage_chunk(group, cfg.stage_bf16, self.device)
                    self.state, metrics = self.epoch_fn(self.state, stacked, fca, f_scene)
                    if pending is not None:
                        drain(pending)  # the previous group, now that this one is enqueued
                    pending = (ep, metrics)
                    if not cfg.scan_epoch:
                        drain(pending)
                        pending = None
                    batches_done += len(group)
                    # wall-clock cadence INSIDE the epoch (train_s1.py:303-310):
                    # a preemption must not eat a long epoch
                    if (time.time() - start_time) / 3600.0 >= cfg.saving_per_hours:
                        start_time = time.time()
                        save_checkpoint(cfg.save_dir, ep, self.state, batches_done=batches_done)

                group: List[Dict[str, np.ndarray]] = []
                seen = 0
                while batch_gen.has_next_batch():
                    b = batch_gen.next_batch(cfg.batch_size)
                    if b is None:
                        continue
                    seen += 1
                    if seen <= n_skip:  # mid-epoch resume: already trained
                        continue
                    b = {k: np.asarray(v) for k, v in b.items()}
                    group.append(shard_batch(b, self.mesh) if self.mesh is not None else b)
                    if len(group) == chunk:
                        run_group(group)
                        group = []
                for b in group:  # a tail shorter than a chunk: step by step
                    run_group([b])
                if pending is not None:
                    drain(pending)
                batch_gen.reset()
                if (ep + 1) % cfg.saving_per_epochs == 0:
                    save_checkpoint(cfg.save_dir, ep + 1, self.state)

        log("[INFO]: Training completes!")
        return last_metrics
