"""Secondary benchmark: full six-term training-step throughput
(SDF collision + Chamfer contact training on PROX-E-scale batches).

The port's counterpart of ``scripts/bench_train.py``: ``train/loop.py``'s
``make_train_step`` (and ``make_epoch_step`` for --scan) on the bench
assets (10475 vertices, 55 joints, 4 scenes, 128^3 SDF, 20k-point clouds,
1455 contact vertices), one warm-up step, then --reps steps on distinct
batches with the host clock around them and a ``torch.cuda.synchronize()``.
Prints one JSON line with steps/s and samples/s (and a second for --scan).

    python -m psi_tpu_torch.scripts.bench_train [--batch 32] [--model_type s1|s2] [--reps 10] [--scan K] [--prune P]

Needs an NVIDIA card.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Optional, Sequence

import torch

from psi_tpu_torch.data.synthetic import SyntheticBatchGenerator, make_synthetic_assets
from psi_tpu_torch.train.loop import _stage_chunk, init_state, make_epoch_step, make_train_step
from psi_tpu_torch.utils.config import LossConfig, TrainConfig
from psi_tpu_torch.utils.timing import card


def main(argv: Optional[Sequence[str]] = None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--model_type", type=str, default="s1")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--scan", type=int, default=0,
                    help="also time the chunked epoch path (K steps per make_epoch_step call)")
    ap.add_argument("--prune", type=int, default=0,
                    help="LossConfig.prune_scene_points (0 = exact contact NN)")
    args = ap.parse_args(argv)
    dev = card()

    assets, _ = make_synthetic_assets(
        num_verts=10475, num_joints=55, num_scenes=4, sdf_dim=128,
        scene_points=20000, n_contact=1455, seed=0, device=dev,
    )
    cfg = TrainConfig(model_type=args.model_type, latentD=256, batch_size=args.batch)
    loss_cfg = LossConfig(prune_scene_points=args.prune)
    state = init_state(cfg, dev)
    step = make_train_step(assets, loss_cfg, args.model_type)

    n_batches = max(args.reps + 1, args.scan)
    gen = SyntheticBatchGenerator(num_scenes=4, batches_per_epoch=n_batches + 1, seed=0)
    host = [gen.next_batch(args.batch) for _ in range(n_batches)]
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in b.items()} for b in host]
    fca = fs = 1.0
    lines = []

    # warm-up
    state, m = step(state, batches[0], fca, fs)
    torch.cuda.synchronize()

    t0 = time.time()
    for i in range(args.reps):
        state, m = step(state, batches[i + 1], fca, fs)
    torch.cuda.synchronize()
    dt = (time.time() - t0) / args.reps
    lines.append({
        "metric": "train_steps_per_sec",
        "value": round(1.0 / dt, 2),
        "unit": "steps/s",
        "samples_per_sec": round(args.batch / dt, 1),
        "batch": args.batch,
        "model_type": args.model_type,
    })
    print(json.dumps(lines[-1]), flush=True)

    if args.scan:
        # K steps a make_epoch_step call over one staged chunk
        K = args.scan
        epoch_fn = make_epoch_step(assets, loss_cfg, args.model_type)
        stacked = _stage_chunk(host[:K], False, dev)
        state2 = init_state(cfg, dev)
        state2, m = epoch_fn(state2, stacked, fca, fs)
        torch.cuda.synchronize()
        reps = max(1, args.reps // 2)
        t0 = time.time()
        for _ in range(reps):
            state2, m = epoch_fn(state2, stacked, fca, fs)
        torch.cuda.synchronize()
        dt = (time.time() - t0) / (reps * K)
        lines.append({
            "metric": "train_steps_per_sec_scan",
            "value": round(1.0 / dt, 2),
            "unit": "steps/s",
            "samples_per_sec": round(args.batch / dt, 1),
            "batch": args.batch,
            "scan_chunk": K,
            "model_type": args.model_type,
        })
        print(json.dumps(lines[-1]), flush=True)
    return lines


if __name__ == "__main__":
    main()
