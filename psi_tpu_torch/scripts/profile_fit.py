"""Where the device time of one generate+fit call goes. The port's
counterpart of ``scripts/profile_fit.py`` (which attributes the fit's cost
on the TPU by ablation): here ``torch.profiler`` attributes it by kernel.

    python -m psi_tpu_torch.scripts.profile_fit [calls]

At the bench shapes (N=256 bodies, 10475 verts, 55 joints, 1455 contact
verts, 4 scenes, 128^3 bf16 corner-packed SDF, 20k-point scene clouds;
``HumanCVAES1(latentD=256)`` with seeded random weights, then
``FitConfig.production(num_iter=20)``): one call to warm up and read the
peak device memory, ``calls`` (default 5) unprofiled calls for the wall
clock, then one call under ``torch.profiler``. Prints the walls and
bodies/s, the device's busy time (the sum of every device kernel's and
copy's time) and its share of the median wall, the count of device launches,
the time of the hand-written kernels by group (K1, K2, K3 and the pack
launch that K1 and K2 share), the ten largest kernels, and one JSON line
with all of it. Needs an NVIDIA card; inputs come from a seed.
"""

from __future__ import annotations

import json
import statistics
import sys
import time
from typing import Dict, List

import torch

from psi_tpu_torch.utils.timing import card, nvidia_smi

SEED = 0
N_BODIES = 256
NUM_ITER = 20
ASSET_KW = dict(num_verts=10475, num_joints=55, num_scenes=4, sdf_dim=128,
                scene_points=20000, n_contact=1455, seed=SEED)
MODEL_KW = dict(latentD=256, image_size=128)
# the hand-written kernels of the fit's path, by a substring of the function's name
GROUPS = {
    "K1_main": ("skin_fwd_kernel",),
    "pack": ("skin_pack_kernel",),  # first launch of K1 and of K2: half of it belongs to each
    "K2_rest": ("skin_bwd_", "splitk_gemm_kernel", "reduce_tiles_kernel"),
    "K3": ("nn_argmin_kernel",),
}


def floor_placement(x72, grid_min, grid_max):
    """Camera extrinsics [N, 4, 4] (identity rotation) that move the
    population's mean translation to the middle of the scene's x/z extent
    at 0.8 * grid_min's height — into the synthetic floor, as
    tests/test_gen_fit_eval.py::test_fitting_reduces_scene_losses places
    its bodies — so the fit has penetration to remove."""
    target = 0.5 * (grid_min + grid_max)
    target[1] = 0.8 * grid_min[1]
    cam = torch.eye(4, dtype=torch.float32, device=x72.device).repeat(x72.shape[0], 1, 1)
    cam[:, :3, 3] = target - x72[:, :3].mean(dim=0)
    return cam


def device_events(prof) -> List:
    """The profile's device-side entries (kernels and copies), averaged by name.
    A span opened on the host (``record_function``) is mirrored onto the
    device's timeline under its own name around its kernels: those mirrors are
    left out, or the kernels count twice."""
    averages = prof.key_averages()
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    spans = {e.key for e in averages if e.device_type == cpu and e.is_user_annotation}
    return [e for e in averages if e.device_type == cuda and not (e.key in spans or e.is_user_annotation)]


def _device_us(e) -> float:
    t = getattr(e, "self_device_time_total", None)
    return float(t if t is not None else e.self_cuda_time_total)


def run(dev: torch.device, calls: int = 5) -> Dict:
    from psi_tpu_torch.data.synthetic import SyntheticBatchGenerator, make_synthetic_assets
    from psi_tpu_torch.fit.fitting import make_generate_fit_step
    from psi_tpu_torch.gen.sample import generate_bodies
    from psi_tpu_torch.models.cvae_s1 import HumanCVAES1
    from psi_tpu_torch.utils.config import FitConfig
    from psi_tpu_torch.utils.init import seeded_init_

    assets, _ = make_synthetic_assets(**ASSET_KW, sdf_dtype=torch.bfloat16, device=dev)
    model = seeded_init_(HumanCVAES1(**MODEL_KW), SEED).eval().to(dev)
    batch = SyntheticBatchGenerator(num_scenes=4, batches_per_epoch=1, seed=SEED,
                                    image_size=MODEL_KW["image_size"]).next_batch(1)
    xs, cam_int, max_d = (torch.from_numpy(batch[k]).to(dev) for k in ("xs", "cam_int", "max_d"))
    scene_idx = torch.zeros(N_BODIES, dtype=torch.int64, device=dev)
    x72_pre = generate_bodies(model, xs, cam_int, max_d, N_BODIES,
                              generator=torch.Generator(device=dev).manual_seed(SEED + 1))
    cam_ext = floor_placement(x72_pre, assets.grid_mins[0], assets.grid_maxs[0])
    step = make_generate_fit_step(model, assets, FitConfig.production(num_iter=NUM_ITER), N_BODIES,
                                  want_metrics=False)

    def call(seed: int):
        t0 = time.time()
        out = step(xs, cam_int, max_d, cam_ext, scene_idx, generator=torch.Generator(device=dev).manual_seed(seed))
        torch.cuda.synchronize()
        return time.time() - t0, out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _, (_, _, hist) = call(SEED + 1)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    walls = [call(SEED + 10 + i)[0] for i in range(calls)]
    wall = statistics.median(walls)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        call(SEED + 100)
    events = device_events(prof)
    busy_ms = sum(_device_us(e) for e in events) / 1e3
    if not busy_ms > 0:
        raise RuntimeError("the profile shows no device time")
    groups = {name: {"ms": sum(_device_us(e) for e in events if any(k in e.key for k in keys)) / 1e3,
                     "launches": sum(e.count for e in events if any(k in e.key for k in keys))}
              for name, keys in GROUPS.items()}
    half_pack = groups["pack"]["ms"] / 2
    res = {
        "walls_s": walls, "wall_s": wall, "bodies_per_s": N_BODIES / wall, "peak_gb": peak_gb,
        "loss_first": hist[0].mean().item(), "loss_last": hist[-1].mean().item(),
        "busy_ms": busy_ms, "busy_share": busy_ms / 1e3 / wall, "device_launches": sum(e.count for e in events),
        "groups": groups,
        "K1_ms": groups["K1_main"]["ms"] + half_pack, "K2_ms": groups["K2_rest"]["ms"] + half_pack,
        "K3_ms": groups["K3"]["ms"],
        "top": [{"name": e.key[:100], "ms": _device_us(e) / 1e3, "launches": e.count}
                for e in sorted(events, key=_device_us, reverse=True)[:10]],
    }
    print(f"[fit] N={N_BODIES}, {NUM_ITER} iters: walls {', '.join(f'{w:.4f}' for w in walls)} s, median "
          f"{wall:.4f} s -> {res['bodies_per_s']:.2f} bodies/s; mean loss {res['loss_first']:.6f} -> "
          f"{res['loss_last']:.6f}; peak device memory {peak_gb:.4f} GB", flush=True)
    print(f"[fit] profiled call: device busy {busy_ms:.2f} ms ({100 * res['busy_share']:.1f}% of the median wall), "
          f"{res['device_launches']} device launches", flush=True)
    for name, g in groups.items():
        print(f"[fit]   {name}: {g['ms']:.3f} ms in {g['launches']} launches ({100 * g['ms'] / busy_ms:.1f}% of busy)",
              flush=True)
    print(f"[fit]   K1 {res['K1_ms']:.3f} ms, K2 {res['K2_ms']:.3f} ms (each with half of the pack), "
          f"K3 {res['K3_ms']:.3f} ms per call", flush=True)
    for t in res["top"]:
        print(f"[fit]   top: {t['ms']:.3f} ms, {t['launches']} launches: {t['name']}", flush=True)
    return res


def main(argv: List[str]) -> None:
    dev = card()
    smi = nvidia_smi()
    print(f"device: {torch.cuda.get_device_name(dev)}; nvidia-smi: {smi}", flush=True)
    res = run(dev, int(argv[0]) if argv else 5)
    print(json.dumps({"card": smi, **res}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
