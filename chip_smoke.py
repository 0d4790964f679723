#!/usr/bin/env python3
"""Smoke test of psi_tpu_torch on one NVIDIA card: build, check, drive.

    python3 chip_smoke.py

Runs the port's main path — HumanCVAES1(latentD=256) samples 256 bodies
for one snapshot and FitConfig.production(num_iter=20) refines them — at
full SMPL-X width on synthetic assets (10475 verts, 55 joints, 4 scenes,
128^3 bf16 corner-packed SDF, 20k-point scene clouds, 1455 contact
verts), with random weights made from a seed. Phases, one line each:

  1. device   torch / CUDA versions, the card's name and power limit
  2. build    nvcc builds csrc/*.cu into build/kernels (seconds printed);
              ptxas' registers and spills, and from cuobjdump the count of
              tensor-core (HMMA) instructions in each of K1's and K2's
              kernels (none may have 0) and of fused multiply-adds (FFMA) in
              K3's (must be 0: its bits rest on no contraction)
  3. K1       fused skinning forward vs its plain twin, two runs
              bit-equal; the time of each of its two launches beside the
              whole call, its registers and shared memory, its bound
  4. K2       fused skinning backward vs its twin, two runs bit-equal;
              the time of each of its five launches beside the total
  5. K3       chamfer NN argmin vs its twin at M=2048, at M=20000 and at
              the two-sided chamfer's swapped shape (the pruned cloud's
              points against the contact vertices); int64 indices, two runs
              equal; beside the bound, the issue floor of the exact formula
  6. slice    one generate+fit call: launch counts K1=20, K2=20, K3=6,
              finite bodies, mean loss falling, peak device memory; then
              bodies/s
  7. cross    the same slice at N=16 on the CPU (twins) and on the card
              (kernels) from identical inputs: bounded drift

and then the probe path, the SDF variants and the eval scorers:

  8. P1-P4    python -m psi_tpu_torch.scripts.profile_vmem_gather's
              support, throughput and relayout phases at the script's
              shapes: each probe kernel exactly equal to its twin; kernel,
              twin and (P1, P2) torch.gather timed as one wrapper call and
              on the device alone; gathered elements/s; its hbm phase:
              ns/index of the global packed-row gather. Launch counts of
              the run.
  9. sdf      profile_sdf's five SDF lookup variants, one timed rep each
 10. eval     the fitted N=256 population of phase 6 scored on the card
              and on the CPU (collision_contact_scores, diversity_metrics
              k=20): the scores agree within stated bounds

Any failure raises, so the exit code is not 0. With no CUDA device, or
run from a directory without the package, it fails before printing any
result. The last three lines are the per-kernel JSON, the nvidia-smi
line, and {"ok": true, "device": {...}}. Each kernel's row carries its
bound: the least time the card could take for the same work, the larger of
the bytes the function must move (each input read once, each output written
once) over the card's memory rate and its operations over the card's peak
rate for their type (PEAK below), from this run's shapes; and, where one
PyTorch call computes the same function, that call's time (library_ms).
ms, plain_ms and library_ms are one wrapper call between a pair of CUDA
events, host path included; device_ms is the kernel's wrapper with the
host taken out (20 calls replayed from a CUDA graph, over 20).
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
# P1-P4: gathers copy values and P3/P4 add in the twin's order: exactly
#     equal (checked inside profile_vmem_gather's phases).
# eval, card vs CPU on the same fitted bodies: the 'high' decode differs
#     by f32 rounding, so an SDF within ~1e-6 of 0 may change sign; 1e-4
#     of the 256 x 10475 vertices is 268 of them.
EVAL_NONCOLLISION_TOL = 1e-4
#     contact is one indicator per body: at most one body may differ.
EVAL_CONTACT_TOL = 1.0 / N_BODIES
#     k-means draws the same seeds on both devices (a CPU generator); only
#     f32 distances summed in another order differ, which can flip a
#     near-tie assignment. One point changing cluster moves the entropy
#     by at most ~2 log(N) / N = 0.043 at N=256: allow two such flips.
EVAL_ENTROPY_TOL = 0.1


# Published peaks of one NVIDIA H100 SXM at its full 700 W (NVIDIA's data
# sheet, dense rates): device memory bytes/s, bf16 tensor-core FLOP/s, f32
# FLOP/s outside the tensor cores.
PEAK = {"bytes": 3.35e12, "bf16": 989e12, "f32": 67e12}


def log(msg: str) -> None:
    print(msg, flush=True)


def bound(nbytes: float, **ops: float) -> dict:
    """{"bound_ms", "bound_by"} of a function that must move ``nbytes`` and do
    ``ops`` operations, given by type (bf16=..., f32=...)."""
    t_bytes = nbytes / PEAK["bytes"] * 1e3
    t_ops = sum(n / PEAK[kind] for kind, n in ops.items()) * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def skinning_bounds(B: int, C: int, J: int, V: int) -> tuple:
    """(K1's bound, K2's bound). Both read cb, A12 (bf16), cam (f32) and the
    bf16 basis [3, C, V] and weights [J, V] once. K1 writes verts [B, V, 3]
    f32; its products are 2 B V (3C + 12J) bf16 operations, its epilogue 36
    f32 operations a vertex. K2 also reads g [B, V, 3] and writes the three
    small gradients; it does the products twice (recompute, reductions) and
    78 f32 operations a vertex between them."""
    operands = 2 * B * C + 2 * B * J * 12 + 4 * B * 12 + 2 * 3 * C * V + 2 * J * V
    verts = 4 * B * V * 3
    products = 2 * B * V * (3 * C + 12 * J)
    k1 = bound(operands + verts, bf16=products, f32=36 * B * V)
    k2 = bound(operands + verts + 4 * (B * C + B * J * 12 + B * 12), bf16=2 * products, f32=78 * B * V)
    return k1, k2


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


def stage_ms(symbol: str, args, stages, all_stages: int, stream) -> dict:
    """Device ms of each launch of a multi-launch kernel alone, after one
    full run that leaves each launch's inputs in the workspace. Direct
    library calls: they are measurements, not launches of the main path."""
    from psi_tpu_torch.ops import _cuda
    from psi_tpu_torch.utils.timing import cuda_ms

    fn = getattr(_cuda.library(), symbol)

    def run(bits):
        err = fn(*args, bits, stream)
        if err != 0:
            raise RuntimeError(f"{symbol} stages {bits}: cudaError {err}")

    run(all_stages)
    return {name: cuda_ms(lambda bit=bit: run(bit)) for name, bit in stages}


def ptxas_usage(log_text: str, kernel: str) -> str:
    """ptxas' resource line (registers, shared memory) of the entry function
    whose name holds ``kernel``, from the build log."""
    lines = log_text.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and kernel in line:
            for later in lines[i + 1:i + 6]:
                if "Used" in later:
                    return later.split(":", 1)[1].strip()
    raise AssertionError(f"no ptxas resource line for {kernel} in the build log")


def check_k1(cb, A12, cam12, bundle, build_log: str, k1_bound: dict):
    import torch

    from psi_tpu_torch.ops import _cuda
    from psi_tpu_torch.ops.fused_skinning import (FWD_ALL, FWD_STAGES, fused_skinning_fwd,
                                                  fused_skinning_fwd_reference, fwd_operands)
    from psi_tpu_torch.utils.timing import cuda_device_ms, cuda_ms

    verts = fused_skinning_fwd(cb, A12, cam12, bundle)
    again = fused_skinning_fwd(cb, A12, cam12, bundle)
    ref = fused_skinning_fwd_reference(cb, A12, cam12, bundle)
    torch.cuda.synchronize()
    bit_equal = torch.equal(verts, again)
    err = (verts - ref).abs().max().item()
    ms = cuda_ms(lambda: fused_skinning_fwd(cb, A12, cam12, bundle))
    device_ms = cuda_device_ms(lambda: fused_skinning_fwd(cb, A12, cam12, bundle))
    plain_ms = cuda_ms(lambda: fused_skinning_fwd_reference(cb, A12, cam12, bundle))
    args, _, _keep = fwd_operands(cb, A12, cam12, bundle)
    alone = stage_ms("psi_skin_fwd", args, FWD_STAGES, FWD_ALL, _cuda.stream_of(cb))
    log(f"[K1] fused_skinning_fwd B={cb.shape[0]} V={bundle.n_verts} J={A12.shape[1]} C={cb.shape[1]}: "
        f"max |kernel - twin| = {err:.3e} m (tol {K1_ABS_TOL}); two runs bit-equal: {bit_equal}; "
        f"kernel {ms:.4f} ms a call, {device_ms:.4f} ms on the device, twin {plain_ms:.4f} ms")
    log("[K1] launches alone: " + ", ".join(f"{n} {v:.4f} ms" for n, v in alone.items())
        + f"; sum {sum(alone.values()):.4f} ms; whole K1 call {ms:.4f} ms; bound {k1_bound['bound_ms']:.4f} ms "
        f"({k1_bound['bound_by']}): the main launch takes {alone['main'] / k1_bound['bound_ms']:.1f}x its bound; "
        f"ptxas: {ptxas_usage(build_log, K1_MMA_KERNEL)}, {_cuda.library().psi_skin_fwd_smem()} bytes of dynamic smem")
    if not bit_equal:
        raise AssertionError("K1 is not deterministic")
    if not err <= K1_ABS_TOL:
        raise AssertionError(f"K1 disagrees with its twin: {err}")
    return {"max_abs_err": err, "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms, "stage_ms": alone,
            "library_ms": None, **k1_bound}


# K1's and K2's kernels that compute a product: each must hold tensor-core instructions
K1_MMA_KERNEL = "skin_fwd_kernel"
K2_MMA_KERNELS = ("skin_bwd_coef_kernel", "splitk_gemm_kernel")
SKIN_KERNELS = ("skin_pack_kernel", K1_MMA_KERNEL) + K2_MMA_KERNELS + ("reduce_tiles_kernel",)


K3_KERNEL = "nn_argmin_kernel"


def sass_counts(lib_path, opcodes=("HMMA", "FFMA")):
    """{opcode: {kernel function: count of instructions whose line holds the
    opcode}} in the library's SASS, from the cuobjdump beside nvcc."""
    from psi_tpu_torch.ops import _cuda

    cuobjdump = Path(_cuda.find_nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib_path)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    counts, fn = {op: {} for op in opcodes}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            for op in opcodes:
                counts[op][fn] = 0
        elif fn is not None:
            for op in opcodes:
                if op in line:
                    counts[op][fn] += 1
    return counts


def check_k3_sass(ffma: dict) -> int:
    """Phase 2's contraction check: K3's distance must round every product
    and sum on its own, as its twin does; one FFMA in its SASS would mean
    the compiler fused some. Raises unless the kernel is there with none."""
    hits = [n for fn, n in ffma.items() if K3_KERNEL in fn]
    if not hits:
        raise AssertionError(f"{K3_KERNEL} is not in the library's SASS")
    log(f"[build]   {K3_KERNEL}: {sum(hits)} FFMA instructions (must be 0)")
    if sum(hits):
        raise AssertionError(f"K3's SASS holds {sum(hits)} fused multiply-adds: its bits would differ from the twin's")
    return sum(hits)


def check_skinning_sass(counts: dict):
    """Phase 2's tensor-core check: HMMA count of each of K1's and K2's
    kernels; raises if a kernel that computes a product has none."""
    found = {}
    for name in SKIN_KERNELS:
        hits = [n for fn, n in counts.items() if name in fn]
        if not hits:
            raise AssertionError(f"{name} is not in the library's SASS")
        found[name] = sum(hits)
        log(f"[build]   {name}: {found[name]} HMMA instructions")
    if not all(found[name] > 0 for name in (K1_MMA_KERNEL,) + K2_MMA_KERNELS):
        raise AssertionError(f"a K1 or K2 product kernel runs no tensor-core instruction: {found}")
    return found


def check_k2(cb, A12, cam12, bundle, k2_bound: dict):
    import torch

    from psi_tpu_torch.ops import _cuda
    from psi_tpu_torch.ops.fused_skinning import (BWD_ALL, BWD_STAGES, bwd_operands, fused_skinning_bwd,
                                                  fused_skinning_bwd_reference)
    from psi_tpu_torch.utils.timing import cuda_device_ms, cuda_ms

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
    device_ms = cuda_device_ms(lambda: fused_skinning_bwd(cb, A12, cam12, bundle, g))
    plain_ms = cuda_ms(lambda: fused_skinning_bwd_reference(cb, A12, cam12, bundle, g))
    args, _, _keep = bwd_operands(cb, A12, cam12, bundle, g)
    alone = stage_ms("psi_skin_bwd", args, BWD_STAGES, BWD_ALL, _cuda.stream_of(cb))
    log(f"[K2] fused_skinning_bwd: max |kernel - twin| / max |twin| = "
        + ", ".join(f"{n} {v:.3e}" for n, v in rel.items())
        + f" (tol {K2_REL_TOL}); two runs bit-equal: {bit_equal}; kernel {ms:.4f} ms a call, {device_ms:.4f} ms "
        f"on the device, twin {plain_ms:.4f} ms")
    log("[K2] launches alone: " + ", ".join(f"{n} {v:.4f} ms" for n, v in alone.items())
        + f"; sum {sum(alone.values()):.4f} ms; whole K2 call {ms:.4f} ms; twin {plain_ms:.4f} ms; "
        f"bound {k2_bound['bound_ms']:.4f} ms ({k2_bound['bound_by']})")
    if not bit_equal:
        raise AssertionError("K2 is not deterministic")
    if not max(rel.values()) <= K2_REL_TOL:
        raise AssertionError(f"K2 disagrees with its twin: {rel}")
    return {"max_abs_err": err, "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms, "rel_err": rel,
            "stage_ms": alone, "library_ms": None, **k2_bound}


def check_k3(contact, y_pruned, y_full):
    import torch

    from psi_tpu_torch.ops.chamfer import nn_argmin, nn_argmin_reference
    from psi_tpu_torch.scripts.tune_chamfer_nn import issue_floor_ms, sm_clock_under_load
    from psi_tpu_torch.utils.timing import cuda_device_ms, cuda_ms

    clocks = sm_clock_under_load(lambda: nn_argmin(contact, y_full))  # ~0.7 s of launches
    mhz, max_mhz = (float(c.strip().split()[0]) for c in clocks.split(","))
    sms = torch.cuda.get_device_properties(contact.device).multi_processor_count
    log(f"[K3] SM clock under K3's load {mhz:.0f} MHz (max {max_mhz:.0f} MHz), {sms} SMs")
    out = {}
    # swapped: the second search of the two-sided chamfer (every scene point's nearest contact vertex)
    for label, x, y in (("pruned", contact, y_pruned), ("full", contact, y_full), ("swapped", y_pruned, contact)):
        ik = nn_argmin(x, y)
        again = nn_argmin(x, y)
        it = nn_argmin_reference(x, y)
        yk = torch.gather(y, 1, ik[..., None].expand(-1, -1, 3))
        yt = torch.gather(y, 1, it[..., None].expand(-1, -1, 3))
        dk = ((x - yk) ** 2).sum(-1)
        dt = ((x - yt) ** 2).sum(-1)
        torch.cuda.synchronize()
        if ik.dtype != torch.int64 or not torch.equal(ik, again):
            raise AssertionError(f"K3 at {label}: indices are {ik.dtype}, two runs equal: {torch.equal(ik, again)}")
        rel = ((dk - dt).abs() / dt.clamp(min=1e-12)).max().item()
        differ = ik != it
        agree = 1.0 - differ.float().mean().item()
        non_tie = (differ & ((dk - dt).abs() > K3_REL_TOL * dt.clamp(min=1e-12))).sum().item()
        ms = cuda_ms(lambda: nn_argmin(x, y))
        device_ms = cuda_device_ms(lambda: nn_argmin(x, y))
        plain_ms = cuda_ms(lambda: nn_argmin_reference(x, y))
        # no single PyTorch call computes the argmin; cdist then argmin (two
        # calls, a [B, N, M] matrix through device memory) is the nearest
        cdist_ms = cuda_ms(lambda: torch.cdist(x, y).argmin(dim=-1))
        B, N, M = x.shape[0], x.shape[1], y.shape[1]
        # x and y read once, int64 idx written; per (x, y) pair 3 subtractions,
        # 3 multiplications, 2 additions and the comparison, in f32
        k3_bound = bound(4 * (3 * B * N + 3 * B * M) + 8 * B * N, f32=9 * B * N * M)
        # the bound's peak assumes every instruction a fused multiply-add; the
        # twin's formula, which K3 keeps bit for bit, is 8 that cannot fuse
        floor_ms = issue_floor_ms(B * N * M, sms, max_mhz)
        log(f"[K3] chamfer_nn_argmin B={B} N={N} M={M}: max rel distance err "
            f"{rel:.3e} (tol {K3_REL_TOL}); index agreement {agree:.6f} ({int(differ.sum())} differ, "
            f"{non_tie} not ties); int64 indices, two runs equal; kernel {ms:.4f} ms a call, {device_ms:.4f} ms "
            f"on the device, twin {plain_ms:.4f} ms, torch.cdist + argmin {cdist_ms:.4f} ms; bound "
            f"{k3_bound['bound_ms']:.4f} ms ({k3_bound['bound_by']}); issue floor of the exact formula "
            f"{floor_ms:.4f} ms at {max_mhz:.0f} MHz: the kernel takes {device_ms / floor_ms:.2f}x of it")
        if not rel <= K3_REL_TOL or non_tie:
            raise AssertionError(f"K3 disagrees with its twin at {label}: rel {rel}, {non_tie} non-tie")
        out[label] = {"max_abs_err": (dk - dt).abs().max().item(), "ms": ms, "device_ms": device_ms,
                      "plain_ms": plain_ms, "library_ms": None, "cdist_argmin_ms": cdist_ms,
                      "issue_floor_ms": floor_ms, "sm_mhz": mhz, **k3_bound}
    return out


def check_probes(dev):
    """Phase 8, the probe path: profile_vmem_gather's entry points, which
    hold each probe kernel to its twin (exactly equal) and time both.
    Returns (per-kernel results at the script's shapes, launch counts of
    the run, the hbm phase's result)."""
    from psi_tpu_torch.ops.gather_probes import CHAINED_GATHER, KERNELS, LANE_GATHER, RELAYOUT, ROW_GATHER
    from psi_tpu_torch.scripts import profile_vmem_gather

    for k in KERNELS:
        k.launches = 0
    res = profile_vmem_gather.run(dev)
    launches = {k.name: k.launches for k in KERNELS}
    log(f"[probes] launches in the probe run {launches}")
    if not all(launches.values()):
        raise AssertionError(f"a probe kernel was not launched: {launches}")
    rows = {ROW_GATHER.name: res["support"][f"row{profile_vmem_gather.R}"],
            LANE_GATHER.name: res["support"][f"lane{profile_vmem_gather.R}"],
            CHAINED_GATHER.name: res["throughput"], RELAYOUT.name: res["relayout"]}
    for name, r in rows.items():
        r.update(bound(r["bytes"], f32=r["f32_ops"]))
        log(f"[probes] {name}: bound {r['bound_ms']:.4f} ms ({r['bound_by']}), kernel {r['ms']:.4f} ms a call, "
            f"{r['device_ms']:.4f} ms on the device")
    return rows, launches, res["hbm"]


def check_eval(assets, assets_cpu, x72, cam_ext, scene_idx):
    """Phase 10: the same fitted bodies scored on the card and on the CPU."""
    import math

    import torch

    from psi_tpu_torch.eval import collision_contact_scores, diversity_metrics

    t0 = time.time()
    nc, ct = collision_contact_scores(assets, x72, cam_ext, scene_idx)
    ent, md = diversity_metrics(x72, k=20)
    torch.cuda.synchronize()
    card_s = time.time() - t0
    nc_c, ct_c = collision_contact_scores(assets_cpu, x72.cpu(), cam_ext.cpu(), scene_idx.cpu())
    ent_c, md_c = diversity_metrics(x72.cpu(), k=20)
    log(f"[eval] N={x72.shape[0]} on the card in {card_s:.2f} s: non-collision {nc:.6f} (CPU {nc_c:.6f}, "
        f"tol {EVAL_NONCOLLISION_TOL}), contact {ct:.6f} (CPU {ct_c:.6f}, tol {EVAL_CONTACT_TOL:.6f}), "
        f"diversity entropy {ent:.6f} (CPU {ent_c:.6f}, tol {EVAL_ENTROPY_TOL}), mean centroid distance "
        f"{md:.6f} (CPU {md_c:.6f})")
    if not (0.0 <= nc <= 1.0 and 0.0 <= ct <= 1.0 and 0.0 <= ent <= math.log(20) + 1e-9 and math.isfinite(md)):
        raise AssertionError("eval scores out of range")
    if not (abs(nc - nc_c) <= EVAL_NONCOLLISION_TOL and abs(ct - ct_c) <= EVAL_CONTACT_TOL
            and abs(ent - ent_c) <= EVAL_ENTROPY_TOL):
        raise AssertionError("card and CPU eval scores disagree")
    return {"non_collision": nc, "contact": ct, "entropy": ent, "mean_dist": md,
            "cpu": {"non_collision": nc_c, "contact": ct_c, "entropy": ent_c, "mean_dist": md_c}}


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
    """Phases 1-10 on card ``dev``; raises on the first failure."""
    import torch

    from psi_tpu_torch.data.synthetic import SyntheticBatchGenerator, make_synthetic_assets
    from psi_tpu_torch.fit.fitting import make_generate_fit_step
    from psi_tpu_torch.gen.sample import generate_bodies
    from psi_tpu_torch.models.cvae_s1 import HumanCVAES1
    from psi_tpu_torch.ops import _cuda
    from psi_tpu_torch.ops.chamfer import NN_ARGMIN
    from psi_tpu_torch.ops.fused_skinning import SKIN_BWD, SKIN_FWD, fused_skinning_fwd
    from psi_tpu_torch.ops.gather_probes import KERNELS as PROBES
    from psi_tpu_torch.ops.prune import select_near_tiles
    from psi_tpu_torch.body.smplx_model import make_fused_bundle
    from psi_tpu_torch.utils.config import FitConfig
    from psi_tpu_torch.utils.init import seeded_init_
    from psi_tpu_torch.utils.precision import strict_f32
    from psi_tpu_torch.scripts import profile_sdf
    from psi_tpu_torch.scripts.profile_fit import floor_placement
    from psi_tpu_torch.utils.timing import nvidia_smi

    # ---- 1. device
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    log(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}, {kind}; nvidia-smi: {smi}")

    # ---- 2. build
    t0 = time.time()
    lib_path = _cuda.build_library()
    _cuda.library()
    log(f"[build] {time.time() - t0:.1f} s -> {lib_path}")
    build_log = lib_path.with_suffix(".log").read_text()
    for line in build_log.splitlines():
        if "Used" in line or "spill" in line or "Compiling entry" in line:
            log(f"[build]   {line.strip()}")
    sass = sass_counts(lib_path)
    hmma = check_skinning_sass(sass["HMMA"])
    k3_ffma = check_k3_sass(sass["FFMA"])

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
        k1_bound, k2_bound = skinning_bounds(cb.shape[0], cb.shape[1], A12.shape[1], bundle.n_verts)
        k1 = check_k1(cb, A12, cam12, bundle, build_log, k1_bound)
        k2 = check_k2(cb, A12, cam12, bundle, k2_bound)
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
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    x72, _, hist = run(xs, cam_int, max_d, cam_ext, scene_idx,
                       generator=torch.Generator(device=dev).manual_seed(SEED + 1))
    torch.cuda.synchronize()
    first_s = time.time() - t0
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    launches = {k.name: k.launches for k in kernels}
    want = {SKIN_FWD.name: NUM_ITER, SKIN_BWD.name: NUM_ITER, NN_ARGMIN.name: 6}
    loss0, loss_last = hist[0].mean().item(), hist[-1].mean().item()
    log(f"[slice] first call {first_s:.2f} s; launches {launches} (want {want}); "
        f"mean loss iter 0 {loss0:.6f} -> iter {NUM_ITER - 1} {loss_last:.6f}; peak device memory {peak_gb:.4f} GB")
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

    # ---- 8. the probe path through P1-P4
    probes, probe_launches, hbm = check_probes(dev)

    # ---- 9. the SDF lookup variants
    sdf_ms = profile_sdf.run_variants(dev, reps=1)

    # ---- 10. the eval scorers on the fitted population, card vs CPU
    scores = check_eval(assets, assets_cpu, x72, cam_ext, scene_idx)

    # ---- the record: each kernel with the launch count of its path's run
    results = [(SKIN_FWD, k1, launches), (SKIN_BWD, k2, launches), (NN_ARGMIN, k3["pruned"], launches)]
    results += [(k, probes[k.name], probe_launches) for k in PROBES]
    rows = [{"name": k.name, "route": "cuda", "source": k.source, "replaces": k.replaces,
             "launches": counts[k.name], "max_abs_err": res["max_abs_err"],
             "ms": res["ms"], "device_ms": res["device_ms"], "plain_ms": res["plain_ms"],
             "bound_ms": res["bound_ms"],
             "bound_by": res["bound_by"], "library_ms": res["library_ms"]} for k, res, counts in results]
    log(json.dumps({"slice": {"bodies_per_s": N_BODIES / wall, "wall_s": wall, "walls_s": walls,
                              "peak_gb": peak_gb},
                    "k1": {"stage_ms": k1["stage_ms"]},
                    "k2": {"stage_ms": k2["stage_ms"], "rel_err": k2["rel_err"]}, "hmma": hmma,
                    "k3_ffma": k3_ffma, "k3_pruned": k3["pruned"], "k3_full_cloud": k3["full"],
                    "k3_swapped": k3["swapped"], "hbm_gather": hbm, "sdf_ms_per_iter": sdf_ms, "eval": scores}))
    log(json.dumps({"kernels": rows}))
    log(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
