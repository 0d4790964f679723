"""Training soak fed by the native loader: scan-epoch ``TrainOP`` at full
width, every batch from ``NativeBatchGenerator``. The port's counterpart of
``scripts/bench_train_native.py``.

    python -m psi_tpu_torch.scripts.bench_train_native [--samples 6144] [--epochs 3]
        [--batch 32] [--chunk 32] [--stage_bf16] [--pack_dir DIR] [--device cpu]

Packs ``--samples`` ``SyntheticBatchGenerator`` rows (seed 0, drawn 512 at a
time, as ``psi_tpu`` draws them) with ``data/native_loader.py::pack_dataset``:
131,468 bytes a sample, 807.7 MB at the default. The pack, the checkpoint
directories and the metrics go under ``--pack_dir`` (default: a fresh
temporary directory, removed at the end); the pack is written anew on every
run. Builds ``psi_tpu``'s assets (10475 verts, 55 joints, 4 scenes, 128^3 f32
grids, 20k-point clouds, 1455 contact verts), then trains
``TrainConfig(model_type="s1", latentD=256, batch_size, scan_epoch=True,
scan_chunk_size)`` for one warm-up epoch and then ``--epochs`` timed epochs
from the same initial weights, every batch from the loader behind
``TimedGen`` (the loader's wall and calls). After the run the first chunk of
the timed run is trained again through the per-step loop (``scan_epoch``
off) from the same state and generator, and the two sets of metrics are
compared step by step. They are the same steps, but on a card they part
after the first step unless ``torch.backends.cudnn.deterministic`` is set:
cuDNN's default convolution algorithms do not sum in a fixed order.

Prints one JSON line with ``psi_tpu``'s keys (metric, steps, epochs,
batch_size, warmup_epoch_s, wall_s, steps_per_sec, samples_per_sec,
loader_wall_s, loader_occupancy, loader_calls, pack_mb, stage_bf16) and,
beside them, the K1/K2/K3 launches of the warm-up and of the timed run (K3
once a step, K1 and K2 never), the peak device memory, the
first, second and last logged loss, whether every logged metric is finite,
the scan-vs-per-step difference, and the card's name and power limit. Runs on
the first NVIDIA card unless ``--device`` names another device; without a card
and without ``--device cpu`` it raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import shutil
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

ASSET_KW = dict(num_verts=10475, num_joints=55, num_scenes=4, sdf_dim=128, scene_points=20000, n_contact=1455,
                seed=0)
LATENT_D = 256
PACK_ROWS = 512  # samples drawn from the generator at a time


class TimedGen:
    """Wraps a batch generator, accumulating the wall time spent inside
    ``next_batch`` and the number of calls. Keeps the first ``keep`` batches
    served since the last ``clear``."""

    def __init__(self, inner, keep: int = 0):
        self.inner = inner
        self.keep = keep
        self.clear()

    def clear(self) -> None:
        self.wall = 0.0
        self.calls = 0
        self.kept: List[Dict[str, np.ndarray]] = []

    def has_next_batch(self) -> bool:
        return self.inner.has_next_batch()

    def next_batch(self, batch_size=None):
        t0 = time.perf_counter()
        b = self.inner.next_batch(batch_size)
        self.wall += time.perf_counter() - t0
        self.calls += 1
        if b is not None and len(self.kept) < self.keep:
            self.kept.append(b)
        return b

    def reset(self) -> None:
        self.inner.reset()


class _Batches:
    """The batch-generator protocol over a list: one epoch serves it once."""

    def __init__(self, batches):
        self.batches, self.i = batches, 0

    def has_next_batch(self) -> bool:
        return self.i < len(self.batches)

    def next_batch(self, batch_size=None):
        self.i += 1
        return self.batches[self.i - 1]

    def reset(self) -> None:
        self.i = 0


def pack_synthetic(path: str, n: int, seed: int = 0) -> str:
    """Pack ``n`` synthetic samples (``SyntheticBatchGenerator(num_scenes=4,
    seed=seed)``, drawn ``PACK_ROWS`` at a time) into a .psipack at ``path``."""
    from psi_tpu_torch.data.native_loader import pack_dataset
    from psi_tpu_torch.data.synthetic import SyntheticBatchGenerator

    gen = SyntheticBatchGenerator(num_scenes=4, batches_per_epoch=-(-n // PACK_ROWS), seed=seed)
    chunks = [gen.next_batch(min(PACK_ROWS, n - lo)) for lo in range(0, n, PACK_ROWS)]
    cat = {k: np.concatenate([c[k] for c in chunks], axis=0) for k in chunks[0]}
    return pack_dataset(
        path,
        cat["xs"][..., 0].reshape(n, -1), cat["xs"][..., 1].reshape(n, -1),
        cat["xh"].reshape(n, -1), cat["cam_ext"].reshape(n, -1),
        cat["cam_int"].reshape(n, -1), cat["max_d"].reshape(n),
        cat["scene_idx"].astype(np.int32),
    )


def _read_rows(save_dir: str) -> List[Dict[str, float]]:
    with open(os.path.join(save_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def soak(workdir: Path, device: torch.device, samples: int = 6144, epochs: int = 3, batch: int = 32,
         chunk: int = 32, stage_bf16: bool = False) -> Tuple[Dict, List[Dict[str, float]]]:
    """Pack, warm up, train ``epochs`` timed epochs and check the first
    chunk against the per-step loop, all under ``workdir``. Returns the
    record (the JSON line's keys) and the timed run's logged metrics."""
    from psi_tpu_torch.data.native_loader import NativeBatchGenerator
    from psi_tpu_torch.data.synthetic import make_synthetic_assets
    from psi_tpu_torch.scripts.profile_fused import launch_counters
    from psi_tpu_torch.train.loop import TrainOP
    from psi_tpu_torch.utils.config import LossConfig, TrainConfig

    cuda = device.type == "cuda"
    kernels = launch_counters(split=False)

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    def zero():
        sync()
        for k in kernels:
            k.launches = 0

    workdir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    pack_path = pack_synthetic(str(workdir / f"soak_{samples}.psipack"), samples)
    pack_mb = os.path.getsize(pack_path) / 1e6
    pack_s = time.perf_counter() - t0

    assets, _ = make_synthetic_assets(**ASSET_KW, device=device)
    cfg = TrainConfig(model_type="s1", latentD=LATENT_D, batch_size=batch, epoch=epochs, scan_epoch=True,
                      scan_chunk_size=chunk, stage_bf16=stage_bf16, save_dir=str(workdir / "soak_ckpt"),
                      resume_training=False, verbose=False, saving_per_epochs=10_000)
    op = TrainOP(cfg, LossConfig(), assets, device=device)
    loader = TimedGen(NativeBatchGenerator(pack_path, batch, seed=0), keep=chunk)
    try:
        # the warm-up epoch: first launches, cuDNN's choices, the allocator's pools
        warm = TrainOP(dataclasses.replace(cfg, epoch=1, save_dir=str(workdir / "warm_ckpt")), LossConfig(), assets,
                       device=device)
        zero()
        t0 = time.perf_counter()
        warm.train(loader)
        sync()
        warm_s = time.perf_counter() - t0
        warm_launches = {k.name: k.launches for k in kernels}
        del warm
        loader.clear()  # TrainOP.train reset the loader at the end of the epoch

        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        zero()
        t0 = time.perf_counter()
        op.train(loader)
        sync()
        wall = time.perf_counter() - t0
        launches = {k.name: k.launches for k in kernels}
        peak_gb = torch.cuda.max_memory_allocated(device) / 1e9 if cuda else None
    finally:
        loader.inner.close()
    rows = _read_rows(cfg.save_dir)

    # the first chunk again, through the per-step loop from the same initial state and noise generator; the
    # first epoch's gates (fca, f_scene) are those of a one-epoch run
    step_cfg = dataclasses.replace(cfg, epoch=1, scan_epoch=False, save_dir=str(workdir / "step_ckpt"))
    TrainOP(step_cfg, LossConfig(), assets, device=device).train(_Batches(loader.kept))
    step_rows = _read_rows(step_cfg.save_dir)
    head = rows[: len(step_rows)]
    scan_diff = max(abs(a[k] - b[k]) for a, b in zip(head, step_rows) for k in b)
    scan_rel = [max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-12) for k in b) for a, b in zip(head, step_rows)]

    steps = epochs * (samples // batch)
    record = {
        "metric": "train_steps_per_sec_native_loader",
        "steps": steps,
        "epochs": epochs,
        "batch_size": batch,
        "warmup_epoch_s": warm_s,
        "wall_s": wall,
        "steps_per_sec": steps / wall,
        "samples_per_sec": steps * batch / wall,
        "loader_wall_s": loader.wall,
        "loader_occupancy": loader.wall / wall,
        "loader_calls": loader.calls,
        "pack_mb": pack_mb,
        "stage_bf16": stage_bf16,
        "samples": samples,
        "chunk": chunk,
        "pack_s": pack_s,
        "launches": launches,
        "warmup_launches": warm_launches,
        "peak_gb": peak_gb,
        "logged_steps": len(rows),
        "loss_first": rows[0]["loss"],
        "loss_after_first_update": rows[1]["loss"] if len(rows) > 1 else None,
        "loss_last": rows[-1]["loss"],
        "metrics_finite": all(math.isfinite(v) for r in rows for v in r.values()),
        "scan_vs_step_steps": len(step_rows),
        "scan_vs_step_max_abs_diff": scan_diff,
        "scan_vs_step_max_rel_diff": max(scan_rel),
        "scan_vs_step_rel_by_step": scan_rel,
        "scan_vs_step_equal": head == step_rows,
        "device": str(device),
    }
    return record, rows


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--samples", type=int, default=6144)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--chunk", type=int, default=32)
    ap.add_argument("--stage_bf16", action="store_true",
                    help="stage snapshot images in bfloat16 (half the host->device bytes per chunk)")
    ap.add_argument("--pack_dir", type=str, default=None,
                    help="directory for the pack, checkpoints and metrics (default: a fresh temporary "
                         "directory, removed at the end)")
    ap.add_argument("--device", type=str, default=None, help="default: the first NVIDIA card")
    args = ap.parse_args(argv)

    from psi_tpu_torch.utils.timing import card, nvidia_smi

    device = torch.device(args.device) if args.device else card()
    smi = nvidia_smi() if device.type == "cuda" else None
    workdir = Path(args.pack_dir) if args.pack_dir else Path(tempfile.mkdtemp(prefix="soak_"))
    try:
        record, _ = soak(workdir, device, args.samples, args.epochs, args.batch, args.chunk, args.stage_bf16)
    finally:
        if args.pack_dir is None:
            shutil.rmtree(workdir, ignore_errors=True)
    record["card"] = smi
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
