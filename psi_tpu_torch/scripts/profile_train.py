"""Where the device time of one training step goes, for 's1' and 's2'.

    python -m psi_tpu_torch.scripts.profile_train [steps]

At the width the repo trains (``TrainConfig()``: batch 32, 128 x 128
snapshots, latentD 256, 75-D bodies, Adam at 3e-4; ``LossConfig()``: the
unpruned scene cloud; 10475 verts, 55 joints, 1455 contact verts, 4 scenes,
128^3 bf16 corner-packed SDF, 20k-point scene clouds; seeded random
weights), with both gates open (fca = f_scene = 1: all six terms, and kernel
K3 over the whole cloud, in every step). For each model type: a few warm
steps, ``steps`` (default 5) unprofiled steps for the wall clock, each on
its own staged batch, then one step under ``torch.profiler``. Prints ms per
step, the device's busy time in the profiled step (the sum of every device
kernel's and copy's time) and its share of the median step, the count of
device launches, K3's time in the step, the ten largest device operations,
the peak device memory of a step, the time to stage one batch, and beside
them the 'high' LBS decode (VPoser + SMPL-X + camera) alone at the step's
batch: forward and backward, each between a pair of CUDA events. The last
line is one JSON object with all of it. Needs an NVIDIA card; inputs come
from a seed.
"""

from __future__ import annotations

import json
import statistics
import sys
import time
from typing import Dict, List

import torch

from psi_tpu_torch.scripts.profile_fit import _device_us, device_events
from psi_tpu_torch.utils.timing import card, cuda_ms, nvidia_smi

SEED = 0
WARM = 3
ASSET_KW = dict(num_verts=10475, num_joints=55, num_scenes=4, sdf_dim=128,
                scene_points=20000, n_contact=1455, seed=SEED)
K3_KERNEL = "nn_argmin_kernel"


def lbs_high_ms(assets, batch: int, dev) -> Dict[str, float]:
    """The 'high' decode body_vec_to_verts alone at ``batch`` bodies: ms of
    its forward and of its backward from a cotangent on the vertices."""
    from psi_tpu_torch.body.decode import body_vec_to_verts
    from psi_tpu_torch.utils.precision import strict_f32

    gen = torch.Generator().manual_seed(SEED + 5)
    x = (0.3 * torch.randn((batch, 72), generator=gen)).to(dev).requires_grad_(True)
    cam = torch.eye(4, device=dev).repeat(batch, 1, 1)
    with strict_f32():
        verts = body_vec_to_verts(assets.smplx, assets.vposer, x, cam, precision="high")[0]
        g = torch.randn(verts.shape, generator=gen).to(dev)
        fwd = cuda_ms(lambda: body_vec_to_verts(assets.smplx, assets.vposer, x, cam, precision="high"))
        bwd = cuda_ms(lambda: torch.autograd.grad(verts, x, g, retain_graph=True))
    return {"fwd_ms": fwd, "bwd_ms": bwd}


def run(dev: torch.device, model_type: str, assets, steps: int = 5) -> Dict:
    from psi_tpu_torch.data.synthetic import SyntheticBatchGenerator
    from psi_tpu_torch.ops.chamfer import NN_ARGMIN
    from psi_tpu_torch.train.loop import _stage_chunk, init_state, make_train_step
    from psi_tpu_torch.utils.config import LossConfig, TrainConfig

    cfg = TrainConfig(model_type=model_type, seed=SEED)
    state = init_state(cfg, dev)
    step = make_train_step(assets, LossConfig(), model_type, cfg.grad_clip_norm)
    gen = SyntheticBatchGenerator(num_scenes=ASSET_KW["num_scenes"], batches_per_epoch=WARM + steps + 1, seed=SEED,
                                  image_size=cfg.image_size)
    host = [gen.next_batch(cfg.batch_size) for _ in range(WARM + steps + 1)]
    t0 = time.time()
    staged = _stage_chunk(host[:1], cfg.stage_bf16, dev)
    torch.cuda.synchronize()
    stage_ms = (time.time() - t0) * 1e3
    batches = [{k: v[0] for k, v in staged.items()}]
    batches += [{k: v[0] for k, v in _stage_chunk([b], cfg.stage_bf16, dev).items()} for b in host[1:]]

    def one(batch):
        nonlocal state
        t0 = time.time()
        state, metrics = step(state, batch, 1.0, 1.0)
        torch.cuda.synchronize()
        return (time.time() - t0) * 1e3, metrics

    first_ms, _ = one(batches[0])
    for b in batches[1:WARM]:
        one(b)
    torch.cuda.reset_peak_memory_stats(dev)
    launches0 = NN_ARGMIN.launches
    timed = [one(b) for b in batches[WARM:WARM + steps]]
    k3_launches = (NN_ARGMIN.launches - launches0) / steps
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    walls = [t for t, _ in timed]
    wall = statistics.median(walls)
    loss = float(timed[-1][1]["loss"])
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        one(batches[-1])
    # the optimizer's record_function range shows up on the device side too,
    # spanning its kernels: leave ranges out, or their kernels count twice
    events = [e for e in device_events(prof)
              if not (getattr(e, "is_user_annotation", False) or e.key.startswith("Optimizer."))]
    busy_ms = sum(_device_us(e) for e in events) / 1e3
    if not busy_ms > 0:
        raise RuntimeError("the profile shows no device time")
    k3 = [e for e in events if K3_KERNEL in e.key]
    res = {
        "model_type": model_type, "batch": cfg.batch_size, "first_step_ms": first_ms, "step_ms": walls,
        "median_step_ms": wall, "steps_per_s": 1e3 / wall, "last_loss": loss, "peak_gb": peak_gb,
        "stage_one_batch_ms": stage_ms, "busy_ms": busy_ms, "busy_share": busy_ms / wall,
        "device_launches": sum(e.count for e in events),
        "K3_ms": sum(_device_us(e) for e in k3) / 1e3, "K3_launches_profiled": sum(e.count for e in k3),
        "K3_launches_per_step": k3_launches,
        "top": [{"name": e.key[:100], "ms": _device_us(e) / 1e3, "launches": e.count}
                for e in sorted(events, key=_device_us, reverse=True)[:10]],
    }
    tag = f"[train {model_type}]"
    print(f"{tag} batch {cfg.batch_size}: first step {first_ms:.1f} ms; steps {', '.join(f'{w:.2f}' for w in walls)} ms, "
          f"median {wall:.3f} ms -> {res['steps_per_s']:.2f} steps/s; last loss {loss:.6f}; peak device memory "
          f"{peak_gb:.4f} GB; staging one batch {stage_ms:.2f} ms", flush=True)
    print(f"{tag} profiled step: device busy {busy_ms:.3f} ms ({100 * res['busy_share']:.1f}% of the median step), "
          f"{res['device_launches']} device launches; K3 {res['K3_ms']:.3f} ms in {res['K3_launches_profiled']} launch "
          f"({100 * res['K3_ms'] / busy_ms:.1f}% of busy, {100 * res['K3_ms'] / wall:.1f}% of the step); "
          f"K3 launches per unprofiled step {k3_launches:g}", flush=True)
    for t in res["top"]:
        print(f"{tag}   top: {t['ms']:.3f} ms, {t['launches']} launches: {t['name']}", flush=True)
    if k3_launches != 1:
        raise RuntimeError(f"K3 was launched {k3_launches} times per step, not once")
    return res


def main(argv: List[str]) -> None:
    dev = card()
    smi = nvidia_smi()
    print(f"device: {torch.cuda.get_device_name(dev)}; nvidia-smi: {smi}", flush=True)
    from psi_tpu_torch.data.synthetic import make_synthetic_assets

    assets, _ = make_synthetic_assets(**ASSET_KW, sdf_dtype=torch.bfloat16, device=dev)
    steps = int(argv[0]) if argv else 5
    out = {mt: run(dev, mt, assets, steps) for mt in ("s1", "s2")}
    lbs = lbs_high_ms(assets, out["s1"]["batch"], dev)
    print(f"[train] 'high' decode alone at batch {out['s1']['batch']}: forward {lbs['fwd_ms']:.3f} ms, backward "
          f"{lbs['bwd_ms']:.3f} ms ({100 * lbs['bwd_ms'] / out['s1']['median_step_ms']:.1f}% of the s1 step, "
          f"{100 * lbs['bwd_ms'] / out['s2']['median_step_ms']:.1f}% of the s2 step)", flush=True)
    print(json.dumps({"card": smi, "lbs_high": lbs, **out}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
