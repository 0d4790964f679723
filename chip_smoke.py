#!/usr/bin/env python3
"""Smoke test of psi_tpu_torch on one NVIDIA card: build, check, drive.

    python3 chip_smoke.py

Runs the port's main path — HumanCVAES1(latentD=256) samples 256 bodies
for one snapshot and FitConfig.production(num_iter=20) refines them — at
full SMPL-X width on synthetic assets (10475 verts, 55 joints, 4 scenes,
128^3 bf16 corner-packed SDF, 20k-point scene clouds, 1455 contact
verts), with random weights made from a seed. Phases, one line each:

  1. device   torch / CUDA versions, the card's name and power limit
  2. build    nvcc builds csrc/*.cu into build/kernels (seconds printed)
  3. K1       fused skinning forward vs its plain twin, times
  4. K2       fused skinning backward vs its twin, two runs bit-equal
  5. K3       chamfer NN argmin vs its twin at M=2048 and M=20000
  6. slice    one generate+fit call: launch counts K1=20, K2=20, K3=6,
              finite bodies, mean loss falling; then bodies/s
  7. cross    the same slice at N=16 on the CPU (twins) and on the card
              (kernels) from identical inputs: bounded drift

Any failure raises, so the exit code is not 0. With no CUDA device, or
run from a directory without the package, it fails before printing any
result. The last three lines are the per-kernel JSON, the nvidia-smi
line, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
N_BODIES = 256
NUM_ITER = 20
ASSET_KW = dict(num_verts=10475, num_joints=55, num_scenes=4, sdf_dim=128,
                scene_points=20000, n_contact=1455, seed=SEED)
N_CROSS = 16
MODEL_KW = dict(latentD=256, image_size=128)
PRUNE = 2048  # FitConfig.production()'s prune_scene_points

# Tolerances, each with its reason:
# K1: identical bf16 operands, f32 sums taken in another order over
#     C=497 basis rows and J=55 joints; verts are metre-scale.
K1_ABS_TOL = 1e-3
# K2: the same bf16-rounded intermediates, but an f32 value computed in
#     another order can round to the neighbouring bf16 (2^-8 of one term
#     among ~31k summed terms); judged relative to each output's max |twin|.
K2_REL_TOL = 1e-3
# K3: both sides evaluate the same f32 (dx^2 + dy^2) + dz^2; distances
#     agree to f32 rounding and indices differ only between equal distances.
K3_REL_TOL = 1e-5
# cross-device slice, iteration 0: the same bodies through the same math,
#     sums in another order (the CPU parity test's bound)
CROSS_LOSS0_REL_TOL = 1e-4
# cross-device slice, fitted x72: Adam amplifies rounding-level differences
#     (gradient-sign flips near zero give steps of ~lr), and at full width
#     the fit moves coordinates by tenths for a 1e-6 relative change of its
#     latents on the CPU alone. The card may drift from the CPU by at most
#     CROSS_SENS_FACTOR times that measured sensitivity, and never needs to
#     beat the bounded-drift bounds of tests/test_fused_skinning.py.
CROSS_PERTURB = 1e-6
CROSS_SENS_FACTOR = 2.0
CROSS_MAX_TOL, CROSS_MEAN_TOL = 0.25, 0.02


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 10) -> float:
    """Median device time of fn() in ms over ``reps`` launches (CUDA events),
    after one warm-up call."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def body_operands(assets, x72, cam_ext):
    """The fused kernel's operands for real bodies: (cb, A12, cam12)."""
    from psi_tpu_torch.body.smplx_model import fused_operands
    from psi_tpu_torch.body.vposer import vposer_decode
    from psi_tpu_torch.geometry.bodyvec import body_params_encapsulate

    p = body_params_encapsulate(x72)
    pose = vposer_decode(assets.vposer, p["body_pose_vp"])
    cb, A12, cam12, _ = fused_operands(
        assets.smplx, p["transl"], p["global_orient"], p["betas"], pose,
        p["left_hand_pose"], p["right_hand_pose"], cam_ext=cam_ext,
    )
    return cb, A12, cam12


def floor_placement(x72, grid_min, grid_max):
    """Camera extrinsics [N, 4, 4] (identity rotation) that move the
    population's mean translation to the middle of the scene's x/z extent
    at 0.8 * grid_min's height — into the synthetic floor, as
    tests/test_gen_fit_eval.py::test_fitting_reduces_scene_losses places
    its bodies — so the fit has penetration to remove."""
    import torch

    target = 0.5 * (grid_min + grid_max)
    target[1] = 0.8 * grid_min[1]
    cam = torch.eye(4, dtype=torch.float32, device=x72.device).repeat(x72.shape[0], 1, 1)
    cam[:, :3, 3] = target - x72[:, :3].mean(dim=0)
    return cam


def check_k1(cb, A12, cam12, bundle):
    import torch

    from psi_tpu_torch.ops.fused_skinning import fused_skinning_fwd, fused_skinning_fwd_reference

    verts = fused_skinning_fwd(cb, A12, cam12, bundle)
    ref = fused_skinning_fwd_reference(cb, A12, cam12, bundle)
    torch.cuda.synchronize()
    err = (verts - ref).abs().max().item()
    ms = cuda_ms(lambda: fused_skinning_fwd(cb, A12, cam12, bundle))
    plain_ms = cuda_ms(lambda: fused_skinning_fwd_reference(cb, A12, cam12, bundle))
    log(f"[K1] fused_skinning_fwd B={cb.shape[0]} V={bundle.n_verts} J={A12.shape[1]} C={cb.shape[1]}: "
        f"max |kernel - twin| = {err:.3e} m (tol {K1_ABS_TOL}); kernel {ms:.4f} ms, twin {plain_ms:.4f} ms")
    if not err <= K1_ABS_TOL:
        raise AssertionError(f"K1 disagrees with its twin: {err}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def check_k2(cb, A12, cam12, bundle):
    import torch

    from psi_tpu_torch.ops.fused_skinning import fused_skinning_bwd, fused_skinning_bwd_reference

    gen = torch.Generator().manual_seed(SEED + 2)
    g = torch.randn((cb.shape[0], bundle.n_verts, 3), generator=gen).to(cb.device)
    run1 = fused_skinning_bwd(cb, A12, cam12, bundle, g)
    run2 = fused_skinning_bwd(cb, A12, cam12, bundle, g)
    ref = fused_skinning_bwd_reference(cb, A12, cam12, bundle, g)
    torch.cuda.synchronize()
    bit_equal = all(torch.equal(a, b) for a, b in zip(run1, run2))
    names = ("g_cb", "g_A12", "g_cam12")
    rel = {n: ((a - r).abs().max() / r.abs().max()).item() for n, a, r in zip(names, run1, ref)}
    err = max((a - r).abs().max().item() for a, r in zip(run1, ref))
    ms = cuda_ms(lambda: fused_skinning_bwd(cb, A12, cam12, bundle, g))
    plain_ms = cuda_ms(lambda: fused_skinning_bwd_reference(cb, A12, cam12, bundle, g))
    log(f"[K2] fused_skinning_bwd: max |kernel - twin| / max |twin| = "
        + ", ".join(f"{n} {v:.3e}" for n, v in rel.items())
        + f" (tol {K2_REL_TOL}); two runs bit-equal: {bit_equal}; kernel {ms:.4f} ms, twin {plain_ms:.4f} ms")
    if not bit_equal:
        raise AssertionError("K2 is not deterministic")
    if not max(rel.values()) <= K2_REL_TOL:
        raise AssertionError(f"K2 disagrees with its twin: {rel}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def check_k3(x, y_pruned, y_full):
    import torch

    from psi_tpu_torch.ops.chamfer import nn_argmin, nn_argmin_reference

    out = {}
    for label, y in (("pruned", y_pruned), ("full", y_full)):
        ik = nn_argmin(x, y)
        it = nn_argmin_reference(x, y)
        yk = torch.gather(y, 1, ik[..., None].expand(-1, -1, 3))
        yt = torch.gather(y, 1, it[..., None].expand(-1, -1, 3))
        dk = ((x - yk) ** 2).sum(-1)
        dt = ((x - yt) ** 2).sum(-1)
        torch.cuda.synchronize()
        rel = ((dk - dt).abs() / dt.clamp(min=1e-12)).max().item()
        differ = ik != it
        agree = 1.0 - differ.float().mean().item()
        non_tie = (differ & ((dk - dt).abs() > K3_REL_TOL * dt.clamp(min=1e-12))).sum().item()
        ms = cuda_ms(lambda: nn_argmin(x, y))
        plain_ms = cuda_ms(lambda: nn_argmin_reference(x, y))
        log(f"[K3] chamfer_nn_argmin B={x.shape[0]} N={x.shape[1]} M={y.shape[1]}: max rel distance err "
            f"{rel:.3e} (tol {K3_REL_TOL}); index agreement {agree:.6f} ({int(differ.sum())} differ, "
            f"{non_tie} not ties); kernel {ms:.4f} ms, twin {plain_ms:.4f} ms")
        if not rel <= K3_REL_TOL or non_tie:
            raise AssertionError(f"K3 disagrees with its twin at {label}: rel {rel}, {non_tie} non-tie")
        out[label] = {"max_abs_err": (dk - dt).abs().max().item(), "ms": ms, "plain_ms": plain_ms}
    return out


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this check needs an NVIDIA card")
    try:
        import psi_tpu_torch
    except ImportError as e:
        raise SystemExit(f"chip_smoke: run from the repository root ({e})")
    if Path(psi_tpu_torch.__file__).resolve().parent.parent != ROOT:
        raise SystemExit(f"chip_smoke: psi_tpu_torch was imported from {psi_tpu_torch.__file__}, not {ROOT}")
    smoke(torch.device("cuda", 0))


def smoke(dev) -> None:
    """Phases 1-7 on card ``dev``; raises on the first failure."""
    import torch

    from psi_tpu_torch.data.synthetic import SyntheticBatchGenerator, make_synthetic_assets
    from psi_tpu_torch.fit.fitting import make_generate_fit_step
    from psi_tpu_torch.gen.sample import generate_bodies
    from psi_tpu_torch.models.cvae_s1 import HumanCVAES1
    from psi_tpu_torch.ops import _cuda
    from psi_tpu_torch.ops.chamfer import NN_ARGMIN
    from psi_tpu_torch.ops.fused_skinning import SKIN_BWD, SKIN_FWD, fused_skinning_fwd
    from psi_tpu_torch.ops.prune import select_near_tiles
    from psi_tpu_torch.body.smplx_model import make_fused_bundle
    from psi_tpu_torch.utils.config import FitConfig
    from psi_tpu_torch.utils.init import seeded_init_
    from psi_tpu_torch.utils.precision import strict_f32

    # ---- 1. device
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    log(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}, {kind}; nvidia-smi: {smi}")

    # ---- 2. build
    t0 = time.time()
    lib_path = _cuda.build_library()
    _cuda.library()
    log(f"[build] {time.time() - t0:.1f} s -> {lib_path}")
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        if "Used" in line or "spill" in line or "Compiling entry" in line:
            log(f"[build]   {line.strip()}")

    # ---- inputs at full width, from the seed
    t0 = time.time()
    assets, registry = make_synthetic_assets(**ASSET_KW, sdf_dtype=torch.bfloat16, device=dev)
    model = seeded_init_(HumanCVAES1(**MODEL_KW), SEED).eval().to(dev)
    batch = SyntheticBatchGenerator(num_scenes=4, batches_per_epoch=1, seed=SEED,
                                    image_size=MODEL_KW["image_size"]).next_batch(1)
    xs = torch.from_numpy(batch["xs"]).to(dev)
    cam_int = torch.from_numpy(batch["cam_int"]).to(dev)
    max_d = torch.from_numpy(batch["max_d"]).to(dev)
    scene_idx = torch.zeros(N_BODIES, dtype=torch.int64, device=dev)
    x72_pre = generate_bodies(model, xs, cam_int, max_d, N_BODIES,
                              generator=torch.Generator(device=dev).manual_seed(SEED + 1))
    cam_ext = floor_placement(x72_pre, assets.grid_mins[0], assets.grid_maxs[0])
    torch.cuda.synchronize()
    log(f"[setup] assets, model and {N_BODIES} sampled bodies in {time.time() - t0:.1f} s")

    # ---- 3-5. each kernel at the main path's shapes vs its plain twin
    with strict_f32(), torch.no_grad():
        bundle = make_fused_bundle(assets.smplx)
        cb, A12, cam12 = body_operands(assets, x72_pre, cam_ext)
        k1 = check_k1(cb, A12, cam12, bundle)
        k2 = check_k2(cb, A12, cam12, bundle)
        verts = fused_skinning_fwd(cb, A12, cam12, bundle)
        contact = verts[:, assets.contact_vids].contiguous()
        y_full = assets.scene_verts[scene_idx].contiguous()
        y_pruned = select_near_tiles(y_full, contact.mean(dim=1), PRUNE).contiguous()
        k3 = check_k3(contact, y_pruned, y_full)

    # ---- 6. the slice: one production generate+fit call through the kernels
    cfg = FitConfig.production(num_iter=NUM_ITER)
    run = make_generate_fit_step(model, assets, cfg, N_BODIES, want_metrics=False)
    kernels = (SKIN_FWD, SKIN_BWD, NN_ARGMIN)
    torch.cuda.synchronize()
    for k in kernels:
        k.launches = 0
    t0 = time.time()
    x72, _, hist = run(xs, cam_int, max_d, cam_ext, scene_idx,
                       generator=torch.Generator(device=dev).manual_seed(SEED + 1))
    torch.cuda.synchronize()
    first_s = time.time() - t0
    launches = {k.name: k.launches for k in kernels}
    want = {SKIN_FWD.name: NUM_ITER, SKIN_BWD.name: NUM_ITER, NN_ARGMIN.name: 6}
    loss0, loss_last = hist[0].mean().item(), hist[-1].mean().item()
    log(f"[slice] first call {first_s:.2f} s; launches {launches} (want {want}); "
        f"mean loss iter 0 {loss0:.6f} -> iter {NUM_ITER - 1} {loss_last:.6f}")
    if launches != want:
        raise AssertionError(f"main path launch counts {launches} != {want}")
    if x72.shape != (N_BODIES, 72) or not torch.isfinite(x72).all():
        raise AssertionError("fitted bodies are not finite [N, 72]")
    if not loss_last < loss0:
        raise AssertionError(f"mean fit loss did not fall: {loss0} -> {loss_last}")
    walls = []
    for rep in range(3):
        t0 = time.time()
        run(xs, cam_int, max_d, cam_ext, scene_idx,
            generator=torch.Generator(device=dev).manual_seed(SEED + 10 + rep))
        torch.cuda.synchronize()
        walls.append(time.time() - t0)
    wall = statistics.median(walls)
    log(f"[slice] generate+fit N={N_BODIES}, {NUM_ITER} iters: median {wall:.4f} s of {len(walls)} "
        f"({walls[0]:.4f}, {walls[1]:.4f}, {walls[2]:.4f}) -> {N_BODIES / wall:.2f} bodies/s on {smi}")

    # ---- 7. the same slice on the CPU (twins) and on the card (kernels)
    t0 = time.time()
    cpu = torch.device("cpu")
    assets_cpu, _ = make_synthetic_assets(**ASSET_KW, sdf_dtype=torch.bfloat16, device=cpu)
    model_cpu = seeded_init_(HumanCVAES1(**MODEL_KW), SEED).eval()
    eps = torch.randn((N_CROSS, model.eps_d), generator=torch.Generator().manual_seed(SEED + 3))
    runs = {}
    for name, d, m, a, scale in (
        ("cpu", cpu, model_cpu, assets_cpu, 1.0),
        ("cpu+", cpu, model_cpu, assets_cpu, 1.0 + CROSS_PERTURB),
        ("cpu-", cpu, model_cpu, assets_cpu, 1.0 - CROSS_PERTURB),
        ("cuda", dev, model, assets, 1.0),
    ):
        r = make_generate_fit_step(m, a, cfg, N_CROSS, want_metrics=False)
        x, _, h = r(xs.to(d), cam_int.to(d), max_d.to(d), cam_ext[:N_CROSS].to(d),
                    scene_idx[:N_CROSS].to(d), eps=(eps * scale).to(d))
        runs[name] = (x.cpu(), h.cpu())

    def drift(a: str, b: str):
        dd = (runs[a][0] - runs[b][0]).abs()
        return dd.max().item(), dd.mean().item()

    card = drift("cuda", "cpu")
    own = tuple(max(p, q) for p, q in zip(drift("cpu+", "cpu"), drift("cpu-", "cpu")))
    tol_max = max(CROSS_MAX_TOL, CROSS_SENS_FACTOR * own[0])
    tol_mean = max(CROSS_MEAN_TOL, CROSS_SENS_FACTOR * own[1])
    l0_cpu, l0_cuda = runs["cpu"][1][0], runs["cuda"][1][0]
    l0_rel = ((l0_cpu - l0_cuda).abs() / l0_cpu.abs().clamp(min=1e-6)).max().item()
    log(f"[cross] N={N_CROSS} CPU twins vs card kernels in {time.time() - t0:.1f} s: iter-0 loss rel "
        f"diff {l0_rel:.3e} (tol {CROSS_LOSS0_REL_TOL}); fitted x72 drift card-vs-CPU max {card[0]:.3e} "
        f"mean {card[1]:.3e}; CPU-vs-CPU with latents x(1+-{CROSS_PERTURB}) max {own[0]:.3e} "
        f"mean {own[1]:.3e}; tol max {tol_max:.3e} mean {tol_mean:.3e}")
    if not l0_rel <= CROSS_LOSS0_REL_TOL:
        raise AssertionError(f"iteration-0 losses differ: {l0_rel}")
    if not (card[0] <= tol_max and card[1] <= tol_mean):
        raise AssertionError("CPU and card slices drift apart beyond the fit's own sensitivity")

    # ---- the record
    rows = []
    for k, res in ((SKIN_FWD, k1), (SKIN_BWD, k2), (NN_ARGMIN, k3["pruned"])):
        rows.append({"name": k.name, "route": "cuda", "source": k.source, "replaces": k.replaces,
                     "launches": launches[k.name], "max_abs_err": res["max_abs_err"],
                     "ms": res["ms"], "plain_ms": res["plain_ms"]})
    log(json.dumps({"slice": {"bodies_per_s": N_BODIES / wall, "wall_s": wall, "walls_s": walls},
                    "k3_full_cloud": k3["full"]}))
    log(json.dumps({"kernels": rows}))
    log(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
