"""Checkpoint save and resume with the reference's conventions.

Port of ``psi_tpu.train.checkpoint``. Files are
``{save_dir}/epoch-{epoch:06d}.ckp`` and resume picks the mtime-newest
(reference source/train_s1.py:222-233, 303-321). The payload is the
reference's ``torch.save`` dict (train_s1.py:306-310): ``epoch``,
``model_h_state_dict`` and ``optimizer_h_state_dict``, whose keys are the
reference's, plus what an exact resume needs: the step count, the noise
generator's state and, for a mid-epoch save, ``batches_done``.
Hyperparameters stay encoded in the checkpoint *directory name*
(``checkpoint_dir_name``, the reference's README convention).
"""

from __future__ import annotations

import glob
import logging
import os
from typing import Any, Dict, Optional

import torch

logger = logging.getLogger(__name__)


def checkpoint_dir_name(
    base: str,
    model_type: str,
    batch_size: int,
    epoch: int,
    lr: float,
    loss_vposer: float,
    loss_kl: float,
    loss_contact: float,
    loss_collision: float,
    prefix: str = "checkpoints_proxtrain",
) -> str:
    """Reference naming scheme (frontend_sh_scripts/train_js.sh:30)."""
    return os.path.join(
        base,
        f"{prefix}_model{model_type.upper()}_batch{batch_size}_epoch{epoch}_LR{lr}"
        f"_LossVposer{loss_vposer}_LossKL{loss_kl}_LossContact{loss_contact}"
        f"_LossCollision{loss_collision}",
    )


def save_checkpoint(save_dir: str, epoch: int, state: Any, batches_done: int = 0) -> str:
    """Write ``state`` (a ``train.loop.TrainState``) and return the path.

    ``batches_done`` > 0 marks a MID-epoch wall-clock save (the reference
    saves every ``saving_per_hours`` inside the epoch, train_s1.py:303-310):
    ``epoch`` is then the epoch IN PROGRESS and resume continues it from
    batch ``batches_done``. The generator's state is the one after the
    noise of the batches already trained, so a resumed run draws exactly
    the noise an uninterrupted one would."""
    os.makedirs(save_dir, exist_ok=True)
    payload = {
        "epoch": int(epoch),
        "model_h_state_dict": state.model.state_dict(),
        "optimizer_h_state_dict": state.optimizer.state_dict(),
        "step": int(state.step),
        "generator_state": state.generator.get_state(),
        "generator_device": state.generator.device.type,
    }
    if batches_done:
        payload["batches_done"] = int(batches_done)
    suffix = f"-b{batches_done:05d}" if batches_done else ""
    path = os.path.join(save_dir, f"epoch-{epoch:06d}{suffix}.ckp")
    torch.save(payload, path)
    return path


def load_newest_checkpoint(save_dir: str, state: Any) -> Optional[Dict[str, Any]]:
    """Restore the mtime-newest ``epoch-*.ckp`` into ``state`` in place.

    Returns {'epoch', 'state', 'path', 'batches_done'} or None when the
    directory holds no checkpoint. A file with only ``model_h_state_dict``
    and ``epoch`` (a reference checkpoint's weights) resumes with the
    optimizer's moments, the step count and the generator as they are in
    ``state``: fresh, unless the caller set them. The generator's state is
    restored only on the kind of device it was saved on."""
    paths = sorted(glob.glob(os.path.join(save_dir, "epoch-*.ckp")), key=os.path.getmtime)
    if not paths:
        return None
    payload = torch.load(paths[-1], map_location="cpu", weights_only=True)
    state.model.load_state_dict(payload["model_h_state_dict"])
    if "optimizer_h_state_dict" in payload:
        state.optimizer.load_state_dict(payload["optimizer_h_state_dict"])
    if "generator_state" in payload:
        if payload.get("generator_device") == state.generator.device.type:
            state.generator.set_state(payload["generator_state"])
        else:
            # a CPU generator's state does not fit a card's, nor the reverse
            logger.warning("checkpoint %s was written on %s: the noise stream starts afresh on %s",
                           paths[-1], payload.get("generator_device"), state.generator.device.type)
    state.step = int(payload.get("step", 0))
    return {
        "epoch": int(payload.get("epoch", 0)),
        "state": state,
        "path": paths[-1],
        "batches_done": int(payload.get("batches_done", 0)),
    }
