"""AMASS-scale VPoser training on one NVIDIA card.

    python -m psi_tpu_torch.scripts.vposer_scale_run [--out DIR] [--epochs 8] [--frames_per_file 10500]

The port's twin of ``scripts/vposer_scale_run.py``: builds a synthetic
AMASS-sized corpus of raw mocap files (>= 100k frames after the
subsample/trim/split stages of ``data/amass.py``: 34 + 5 + 3 files of
``frames_per_file`` frames on an 8-D pose manifold, seed 0), trains the
full-size VPoser (512 neurons, latentD 32, batch 256, mesh-space L1
through the full 10475-vertex, 55-joint synthetic body model, the
reference recipe, human_body_prior/train/vposer_smpl.py:301-345) with
``VPoserTrainer`` on the card, and checks that the best snapshot reloads:
``load_best`` replays the recorded best eval loss within 1e-3 relative, and
``load_vposer(work_dir)`` decodes 256 latents equal in bits to the
trainer's model in eval mode.

Per epoch: train and eval losses, seconds, frames/s and steps/s (host clock
around synchronised work). Writes everything to DIR/vposer_scale.json
(default ``build/vposer_scale`` under the repository) and prints a markdown
table, then the card's name and power limit. Needs an NVIDIA card.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from pathlib import Path

import numpy as np
import torch

from psi_tpu_torch.utils.timing import card, nvidia_smi

SUBSETS = {"SynthCMU": 34, "SynthBML": 5, "SynthEva": 3}
SPLITS = {"train": ["SynthCMU"], "vald": ["SynthBML"], "test": ["SynthEva"]}


def make_amass_corpus(root: str, n_files_per_subset, frames_per_file: int, seed: int = 0) -> int:
    """Raw synthetic mocap npz files on a low-dimensional pose manifold:
    z [8] -> tanh random features -> 52x3 axis-angle, so the VAE has
    structure to learn (the same draws as scripts/vposer_scale_run.py)."""
    rng = np.random.default_rng(seed)
    w1 = rng.normal(0, 1.0, size=(8, 64)).astype(np.float32)
    w2 = rng.normal(0, 0.15, size=(64, 156)).astype(np.float32) / np.sqrt(64)
    total = 0
    for subset, n_files in n_files_per_subset.items():
        sub = os.path.join(root, subset)
        os.makedirs(sub, exist_ok=True)
        for i in range(n_files):
            z = rng.normal(size=(frames_per_file, 8)).astype(np.float32)
            poses = np.tanh(z @ w1) @ w2
            poses += rng.normal(0, 0.01, size=poses.shape).astype(np.float32)  # mocap jitter
            np.savez(os.path.join(sub, f"mocap_{i:03d}.npz"), poses=poses)
            total += frames_per_file
    return total


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=str, default=str(Path(__file__).resolve().parents[2] / "build" / "vposer_scale"))
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--frames_per_file", type=int, default=10500)
    args = ap.parse_args(argv)
    dev = card()
    smi = nvidia_smi()

    from psi_tpu_torch.body.smplx_model import synthetic_smplx
    from psi_tpu_torch.body.vposer import vposer_decode
    from psi_tpu_torch.data.amass import prepare_vposer_datasets
    from psi_tpu_torch.train.vposer_trainer import VPoserTrainConfig, VPoserTrainer
    from psi_tpu_torch.utils.convert_torch import load_vposer

    os.makedirs(args.out, exist_ok=True)
    amass_root = os.path.join(args.out, "amass_raw")
    prepared = os.path.join(args.out, "prepared")
    t0 = time.time()
    raw = make_amass_corpus(amass_root, SUBSETS, args.frames_per_file)
    print(f"[1/4] raw corpus: {raw} frames ({time.time() - t0:.1f} s)", flush=True)
    counts = prepare_vposer_datasets(amass_root, prepared, splits=SPLITS)
    print(f"[2/4] prepared: {counts} ({time.time() - t0:.1f} s)", flush=True)
    if args.frames_per_file >= 10500:
        assert counts["train"] >= 80_000 and sum(counts.values()) >= 100_000, counts

    print(f"[3/4] training on {torch.cuda.get_device_name(dev)}", flush=True)
    bm = synthetic_smplx(num_verts=10475, num_joints=55, seed=0)
    cfg = VPoserTrainConfig(num_neurons=512, latentD=32, num_joints=21, batch_size=256,
                            num_epochs=args.epochs, base_lr=1e-3)
    tr = VPoserTrainer(os.path.join(args.out, "work"), cfg, prepared, bm, device=dev)
    n_train = len(tr.ds_train)
    curve = [{"epoch": 0, "eval": tr.evaluate()}]
    print(f"    epoch 0 (init) eval loss_total={curve[0]['eval']['loss_total']:.4f}", flush=True)
    for ep in range(args.epochs):
        torch.cuda.synchronize(dev)
        te = time.time()
        tr.epochs_completed += 1
        train_losses = tr.train_epoch()
        torch.cuda.synchronize(dev)
        train_s = time.time() - te
        eval_losses = tr.evaluate()
        dt = time.time() - te
        row = {"epoch": ep + 1, "train": train_losses, "eval": eval_losses, "epoch_s": dt, "train_s": train_s,
               "frames_per_s": n_train / dt, "steps_per_s": tr.steps_per_epoch / train_s}
        star = ""
        if eval_losses["loss_total"] < tr.best_loss_total:
            tr.best_loss_total = eval_losses["loss_total"]
            tr.best_model_fname = tr.save_snapshot()
            star = " **"
        curve.append(row)
        print(f"    epoch {ep + 1}: train={train_losses['loss_total']:.4f} eval={eval_losses['loss_total']:.4f} "
              f"mesh={eval_losses['loss_mesh_rec']:.4f} kl={eval_losses['loss_kl']:.4f} "
              f"({dt:.1f} s, {n_train / dt:.0f} frames/s, {row['steps_per_s']:.2f} steps/s){star}", flush=True)

    print("[4/4] reload check:", tr.best_model_fname, flush=True)
    recorded = tr.best_loss_total
    tr.load_best()
    replay = tr.evaluate()["loss_total"]
    z = torch.randn((256, cfg.latentD), generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    tr.model.eval()
    with torch.no_grad():
        equal_bits = bool(torch.equal(vposer_decode(load_vposer(tr.work_dir).to(dev), z), vposer_decode(tr.model, z)))
    print(f"    recorded best={recorded:.6f} replayed={replay:.6f}; load_vposer decodes equal bits: {equal_bits}",
          flush=True)
    assert abs(replay - recorded) < 1e-3 * max(1.0, abs(recorded)), (recorded, replay)
    assert equal_bits

    payload = {"config": cfg.__dict__, "counts": counts, "n_train_frames": n_train, "curve": curve,
               "reload_recorded": recorded, "reload_replay": replay, "load_vposer_equal_bits": equal_bits,
               "card": smi}
    with open(os.path.join(args.out, "vposer_scale.json"), "w") as f:
        json.dump(payload, f, indent=1)

    print("\n| epoch | train total | eval total | eval mesh L1 | eval KL | frames/s | steps/s |")
    print("|---|---|---|---|---|---|---|")
    for row in curve:
        e = row["eval"]
        if "train" not in row:
            print(f"| 0 (init) | — | {e['loss_total']:.4f} | {e['loss_mesh_rec']:.4f} | {e['loss_kl']:.4f} | — | — |")
        else:
            print(f"| {row['epoch']} | {row['train']['loss_total']:.4f} | {e['loss_total']:.4f} | "
                  f"{e['loss_mesh_rec']:.4f} | {e['loss_kl']:.4f} | {row['frames_per_s']:.0f} | "
                  f"{row['steps_per_s']:.2f} |")
    print(smi)


if __name__ == "__main__":
    main()
