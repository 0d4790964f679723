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
              equal; beside the bound, the issue floor of the exact formula.
              Then K1, K2 and K3 vs their twins at the other body counts of
              phases 13-14 (128, 64, 4 and 1), full width, untimed
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

and then the training path and the Stage-2 sampler:

 11. train    for 's1' and then 's2': TrainOP on the card at TrainConfig()
              and LossConfig() defaults (batch 32, 128 x 128 snapshots,
              latentD 256, Adam at 3e-4, the unpruned 20k cloud) on a
              SyntheticBatchGenerator. The gates are open from the first
              step because the run resumes a checkpoint of the initial
              state written as epoch 7 of 9 (epochs 8 and 9 are past
              0.75 * 9, so f_scene = 1 and fca = 1). Raises unless every
              metric of every step is finite, contact is nonzero in every
              step and collision in at least one, K3 was launched exactly
              once per step at M = 20000, BatchNorm's running statistics
              moved, a run resumed from the checkpoint written after step 3
              repeats step 4's metrics, and on one batch repeated for 10
              steps the loss falls from its value after Adam's first update
              (which raises it: see TRAIN_REPEAT's check). Then one
              step at batch 4 on the card against the CPU (K3's twin), same
              weights, batch and injected noise: metrics and every
              parameter's gradient (median at rounding level; the largest
              bounded by what one unit at a kink can do). Times: ms per
              step (median of the steps after the first), peak memory of a
              step, and K3 at (32, 1455, 20000): on the device, beside its
              bound, its twin (equal indices) and torch.cdist + argmin.
 12. s2       one N=256 production generate+fit with HumanCVAES2 as the
              sampler: launch counts 20/20/6, finite bodies, falling loss

 and then the file-driven path and the fit's off-by-default knobs:

 13. drivers  in a temporary directory: TestOP (on the card by default)
              writes 300 body_gen_*.pkl for phase 6's snapshot; FittingOP
              with FitConfig.production(num_iter=20), max_population=256,
              fits them through fitting_files (two chunks, the second
              padded from 44 to 256) and writes 300; a second call returns
              0. Launch counts of the two chunks asserted (each 20/20/6 plus
              its final metrics pass: one K1, one K3). The first 256 fitted
              rows against make_fit_step on the same arrays, held to the
              difference of two runs of make_fit_step (equal bits if that
              is 0), and their scores to make_fit_step's rows' (equal when
              the rows are). The fitted files scored by
              collision_contact_scores and diversity_metrics. Seconds for
              write, fit and read-back.
 14. knobs    N=256 from phase 6's bodies, each with launch counts
              asserted and its wall time: cheap_collision_verts=2048 (mean
              loss falls; final full-vertex metrics beside the default's),
              overlap_chunks=2 (each half equal in bits to the one-chunk
              fit of its 128 bodies alone; difference to one chunk of 256:
              iteration 0 to 1e-4, the fitted bodies' mean held to twice the
              default's own drift for an input moved by 1e-6, measured
              here), remat_decode (equal bits,
              K1 twice a pass, peak memory of both),
              make_generate_fit_rows (4 snapshots x 64 rows, each group in
              its own scene) and the carried-Adam mode at N=4 (serial:
              N x 20 passes at one body).

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

import dataclasses
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
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
# train, resumed run: step 4 starts from step 3's checkpoint, the very
#     parameters, moments and noise stream the uninterrupted run had there,
#     and a forward pass sums nothing with atomics; what is left is cuDNN
#     choosing another algorithm in the other process state.
TRAIN_RESUME_REL_TOL = 1e-5
# train, card vs CPU at batch 4, one step: the same math in f32, sums in
#     another order (the fit's iteration-0 bound) ...
TRAIN_METRIC_REL_TOL = 1e-4
#     ... and for each parameter e = max |card - CPU| over the largest |CPU
#     gradient| of that parameter. On the card the backward of torch.gather,
#     index_add_ and cuDNN's convolutions sums with atomics, so two runs of
#     a step on the card differ in the last bits too: a tolerance, not
#     equal bits. Over the parameters the median e is held to rounding level.
#     The largest e is not: the forward agrees to ~3e-6, so a ReLU, LeakyReLU
#     or max-pool unit whose input lies that close to 0 (or to a tie) takes
#     the other branch on the card, and one unit is one of the 4 x 16 x 16
#     terms of a channel's weight gradient: ~1/32 of that sum's size, for
#     every parameter upstream of it (measured: one unit at the output of
#     S2's local trunk at batch 4, e = 3.4e-2 there and under 2e-2 upstream,
#     1e-6 everywhere with each module's backward checked alone in f64).
TRAIN_GRAD_MEDIAN_TOL = 1e-5
TRAIN_GRAD_MAX_TOL = 5e-2
TRAIN_STEPS = 6  # steps of the TrainOP run, in two epochs; the checkpoint between them is resumed
TRAIN_REPEAT = 10  # steps on one repeated batch
TRAIN_CROSS_BATCH = 4


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


def check_path_batches(cb, A12, cam12, bundle, contact, y_pruned):
    """K1, K2 and K3 against their twins at the other body counts that phases
    13 and 14 give them, at full width: overlap_chunks=2 runs every pass at
    N/2 bodies, the vertex subset's scoring decode launches K1 at
    fit.fitting.N_SCORE bodies, and the carried-Adam mode runs its passes at
    one body and its metrics pass at N_CARRY. Slices of phase 3-5's operands, the same
    tolerances, no timing."""
    import torch

    from psi_tpu_torch.fit.fitting import N_SCORE
    from psi_tpu_torch.ops.chamfer import nn_argmin, nn_argmin_reference
    from psi_tpu_torch.ops.fused_skinning import (fused_skinning_bwd, fused_skinning_bwd_reference,
                                                  fused_skinning_fwd, fused_skinning_fwd_reference)

    out = {}
    g_all = torch.randn((cb.shape[0], bundle.n_verts, 3), generator=torch.Generator().manual_seed(SEED + 4)).to(cb.device)
    for B in (cb.shape[0] // 2, N_SCORE, N_CARRY, 1):
        ops = (cb[:B].contiguous(), A12[:B].contiguous(), cam12[:B].contiguous(), bundle)
        g, x, y = g_all[:B].contiguous(), contact[:B].contiguous(), y_pruned[:B].contiguous()
        k1_err = (fused_skinning_fwd(*ops) - fused_skinning_fwd_reference(*ops)).abs().max().item()
        k2_rel = max(((a - r).abs().max() / r.abs().max()).item()
                     for a, r in zip(fused_skinning_bwd(*ops, g), fused_skinning_bwd_reference(*ops, g)))
        k3_equal = torch.equal(nn_argmin(x, y), nn_argmin_reference(x, y))
        out[B] = {"k1_max_abs_err": k1_err, "k2_max_rel_err": k2_rel, "k3_equal": k3_equal}
        log(f"[K1-K3] at B={B}, V={bundle.n_verts}, N={x.shape[1]}, M={y.shape[1]}: K1 max |kernel - twin| {k1_err:.3e} m "
            f"(tol {K1_ABS_TOL}); K2 max |kernel - twin| / max |twin| {k2_rel:.3e} (tol {K2_REL_TOL}); K3 indices equal "
            f"the twin's: {k3_equal}")
        if not (k1_err <= K1_ABS_TOL and k2_rel <= K2_REL_TOL and k3_equal):
            raise AssertionError(f"a kernel disagrees with its twin at B={B}: {out[B]}")
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


class RepeatedBatch:
    """The data layer's protocol over ONE batch, handed out ``n`` times an epoch."""

    def __init__(self, batch, n: int):
        self.batch, self.n, self.count = batch, n, 0

    def reset(self):
        self.count = 0

    def has_next_batch(self) -> bool:
        return self.count < self.n

    def next_batch(self, batch_size: int):
        self.count += 1
        return self.batch


def open_gates_config(model_type: str, save_dir: str, dev, saving_per_epochs: int = 100):
    """TrainConfig() defaults with 9 epochs, and in ``save_dir`` a checkpoint
    of the initial state marked epoch 7: a resuming TrainOP trains epochs 8
    and 9, both past 0.75 * 9 = 6.75, so f_scene = 1 and fca = 1 in every
    step. No knob is added: the gates are where TrainOP puts them."""
    from psi_tpu_torch.train.checkpoint import save_checkpoint
    from psi_tpu_torch.train.loop import init_state
    from psi_tpu_torch.utils.config import TrainConfig

    cfg = TrainConfig(model_type=model_type, epoch=9, save_dir=save_dir, saving_per_epochs=saving_per_epochs,
                      verbose=False, seed=SEED)
    save_checkpoint(save_dir, 7, init_state(cfg, dev))
    return cfg


def read_metrics(save_dir: str):
    with open(Path(save_dir) / "metrics.jsonl") as f:
        return [json.loads(line) for line in f]


def check_train(model_type: str, dev, assets, assets_cpu, smi: str, workdir: Path):
    """Phase 11 for one model type; returns its record."""
    import math

    import torch

    from psi_tpu_torch.data.synthetic import SyntheticBatchGenerator
    from psi_tpu_torch.ops.chamfer import NN_ARGMIN
    from psi_tpu_torch.train.loop import TrainOP, _stage_chunk, init_state, make_train_step
    from psi_tpu_torch.utils.config import LossConfig, TrainConfig

    tag = f"[train {model_type}]"
    loss_cfg = LossConfig()
    M = assets.scene_verts.shape[1]
    if loss_cfg.prune_scene_points != 0 or M != ASSET_KW["scene_points"]:
        raise AssertionError("the training phase must search the whole 20k cloud")

    def batches(n):
        return SyntheticBatchGenerator(num_scenes=ASSET_KW["num_scenes"], batches_per_epoch=n, seed=SEED + 20,
                                       image_size=MODEL_KW["image_size"])

    # ---- TrainOP: two epochs of TRAIN_STEPS / 2 steps, a checkpoint between them
    half = TRAIN_STEPS // 2
    run_dir = str(workdir / f"{model_type}_run")
    cfg = open_gates_config(model_type, run_dir, dev, saving_per_epochs=8)
    op = TrainOP(cfg, loss_cfg, assets)  # no device given: the card
    if next(op.model.parameters()).device != dev:
        raise AssertionError("TrainOP did not put its model on the card")
    stats0 = {k: v.clone() for k, v in op.model.state_dict().items() if "running_" in k}
    step_ms = []
    inner = op.epoch_fn

    def timed(*args):  # one step per call here (scan_epoch is off)
        torch.cuda.synchronize()
        t0 = time.time()
        out = inner(*args)
        torch.cuda.synchronize()
        step_ms.append((time.time() - t0) * 1e3)
        return out

    op.epoch_fn = timed
    torch.cuda.synchronize()
    NN_ARGMIN.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    last = op.train(batches(half))
    torch.cuda.synchronize()
    k3_launches = NN_ARGMIN.launches
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    rows = read_metrics(run_dir)
    names = {"loss", "rec_t", "rec_p", "vposer", "contact", "collision", "kl"} | (
        {"kl_g", "kl_l"} if model_type == "s2" else set())
    if len(rows) != TRAIN_STEPS or op.state.step != TRAIN_STEPS or set(rows[0]) != names | {"epoch"}:
        raise AssertionError(f"{tag} expected {TRAIN_STEPS} logged steps with metrics {sorted(names)}")
    if not all(math.isfinite(v) for r in rows for v in r.values()):
        raise AssertionError(f"{tag} a metric is not finite: {rows}")
    if {k: v for k, v in rows[-1].items() if k != "epoch"} != last:
        raise AssertionError(f"{tag} train() did not return the last step's metrics")
    n_collision = sum(r["collision"] > 0 for r in rows)
    if not (all(r["contact"] > 0 and r["kl"] > 0 for r in rows) and n_collision > 0):
        raise AssertionError(f"{tag} a gated term is zero: {rows}")
    if k3_launches != TRAIN_STEPS:
        raise AssertionError(f"{tag} K3 launched {k3_launches} times in {TRAIN_STEPS} steps")
    moved = [k for k, v in op.model.state_dict().items() if k in stats0 and not torch.equal(v, stats0[k])]
    if len(moved) != len(stats0):
        raise AssertionError(f"{tag} {len(stats0) - len(moved)} running statistics did not move")
    median_ms = statistics.median(step_ms[1:])
    log(f"{tag} TrainOP on the card, batch {cfg.batch_size}, gates open (epochs 8 and 9 of 9): {TRAIN_STEPS} steps, every "
        f"metric finite; loss {rows[0]['loss']:.6f} -> {rows[-1]['loss']:.6f}; contact > 0 in all, collision > 0 in "
        f"{n_collision}; K3 launches {k3_launches} at M={M} (one per step); {len(moved)} running statistics moved; "
        f"first step {step_ms[0]:.1f} ms, then {', '.join(f'{t:.2f}' for t in step_ms[1:])} ms: median "
        f"{median_ms:.3f} ms a step ({1e3 / median_ms:.2f} steps/s); peak device memory {peak_gb:.4f} GB; on {smi}")

    # ---- resume from the checkpoint written after step 3 (the end of epoch 8)
    k = half
    resume_dir = workdir / f"{model_type}_resume"
    resume_dir.mkdir()
    shutil.copy(Path(run_dir) / "epoch-000008.ckp", resume_dir)
    op_r = TrainOP(dataclasses.replace(cfg, save_dir=str(resume_dir)), loss_cfg, assets)
    later = batches(half)
    for _ in range(half):  # the generator's draws of epoch 8, which the first run consumed
        later.next_batch(cfg.batch_size)
    later.reset()
    op_r.train(later)
    rows_r = read_metrics(str(resume_dir))
    if len(rows_r) != TRAIN_STEPS - k or op_r.state.step != TRAIN_STEPS:
        raise AssertionError(f"{tag} the resumed run took {len(rows_r)} steps to step {op_r.state.step}")

    def rel(a, b):
        return max(abs(a[n] - b[n]) / max(abs(b[n]), 1e-12) for n in names)

    resume_rel = rel(rows_r[0], rows[k])
    later_rel = max(rel(a, b) for a, b in zip(rows_r[1:], rows[k + 1:]))
    log(f"{tag} resumed from the checkpoint after step {k}: step {k + 1}'s metrics differ from the uninterrupted "
        f"run's by {resume_rel:.3e} relative at most (tol {TRAIN_RESUME_REL_TOL}); steps {k + 2}-{TRAIN_STEPS} by "
        f"{later_rel:.3e} (not held: the backward's atomics reach them through Adam)")
    if not resume_rel <= TRAIN_RESUME_REL_TOL:
        raise AssertionError(f"{tag} the resumed step disagrees: {rows_r[0]} vs {rows[k]}")

    # ---- one batch repeated: the loss falls
    rep_dir = str(workdir / f"{model_type}_repeat")
    op_f = TrainOP(open_gates_config(model_type, rep_dir, dev), loss_cfg, assets)
    op_f.train(RepeatedBatch(batches(1).next_batch(cfg.batch_size), TRAIN_REPEAT // 2))  # two epochs of it
    losses = [r["loss"] for r in read_metrics(rep_dir)]
    # Adam's first update moves every weight by lr in its gradient's sign, all
    # 8192 input weights of fc among them, and at lr 3e-4 that overshoots: the
    # loss after it is the largest of the run. From there it must fall.
    log(f"{tag} one batch repeated {TRAIN_REPEAT} times: loss " + ", ".join(f"{x:.4f}" for x in losses)
        + f"; before any update {losses[0]:.4f}, after Adam's first {losses[1]:.4f}, last {losses[-1]:.4f}")
    if not (len(losses) == TRAIN_REPEAT and losses[-1] < losses[1]
            and statistics.mean(losses[-3:]) < statistics.mean(losses[1:4])):
        raise AssertionError(f"{tag} the loss on a repeated batch does not fall: {losses}")

    # ---- one step at batch 4, card against CPU (K3's twin there)
    small = TrainConfig(model_type=model_type, seed=SEED, batch_size=TRAIN_CROSS_BATCH)
    host = batches(1).next_batch(TRAIN_CROSS_BATCH)
    gen = torch.Generator().manual_seed(SEED + 21)
    eps = torch.randn((TRAIN_CROSS_BATCH, 32), generator=gen)
    eps = eps if model_type == "s1" else (eps, torch.randn((TRAIN_CROSS_BATCH, 32), generator=gen))
    sides = {}
    for name, d, a in (("cpu", torch.device("cpu"), assets_cpu), ("cuda", dev, assets)):
        state = init_state(small, d)
        batch = {key: v[0] for key, v in _stage_chunk([host], False, d).items()}
        e = eps.to(d) if model_type == "s1" else tuple(x.to(d) for x in eps)
        before = NN_ARGMIN.launches
        state, metrics = make_train_step(a, loss_cfg, model_type)(state, batch, 1.0, 1.0, eps=e)
        if NN_ARGMIN.launches - before != (1 if d.type == "cuda" else 0):  # the CPU takes the twin
            raise AssertionError(f"{tag} K3 launches on {name}: {NN_ARGMIN.launches - before}")
        sides[name] = ({key: float(v) for key, v in metrics.items()},
                       {key: p.grad.detach().cpu() for key, p in state.model.named_parameters()})
    metric_rel = rel(sides["cuda"][0], sides["cpu"][0])
    grad_rel = {key: ((sides["cuda"][1][key] - g).abs().max() / g.abs().max().clamp(min=1e-30)).item()
                for key, g in sides["cpu"][1].items()}
    worst = max(grad_rel, key=grad_rel.get)
    grad_median = statistics.median(grad_rel.values())
    n_over = sum(v > 1e-3 for v in grad_rel.values())
    log(f"{tag} one step at batch {TRAIN_CROSS_BATCH}, card vs CPU (same weights, batch and noise): metrics differ by "
        f"{metric_rel:.3e} relative at most (tol {TRAIN_METRIC_REL_TOL}); max |card - CPU| / max |CPU| of a gradient, "
        f"over {len(grad_rel)} parameters: median {grad_median:.3e} (tol {TRAIN_GRAD_MEDIAN_TOL}), largest "
        f"{grad_rel[worst]:.3e} at {worst} (tol {TRAIN_GRAD_MAX_TOL}: a unit at a kink takes the other branch), "
        f"{n_over} over 1e-3")
    if not (metric_rel <= TRAIN_METRIC_REL_TOL and grad_median <= TRAIN_GRAD_MEDIAN_TOL
            and grad_rel[worst] <= TRAIN_GRAD_MAX_TOL):
        raise AssertionError(f"{tag} card and CPU disagree: metrics {metric_rel}, gradients median {grad_median}, "
                             f"largest {grad_rel[worst]} at {worst}")
    return {"step_ms": step_ms, "median_step_ms": median_ms, "peak_gb": peak_gb, "k3_launches": k3_launches,
            "steps": TRAIN_STEPS, "loss_first": rows[0]["loss"], "loss_last": rows[-1]["loss"],
            "collision_steps": n_collision, "resume_rel": resume_rel, "resume_later_rel": later_rel,
            "repeat_losses": losses, "cross_metric_rel": metric_rel, "cross_grad_rel": grad_rel[worst],
            "cross_grad_median": grad_median, "cross_grad_over_1e-3": n_over, "cross_grad_worst": worst}


def check_s2_slice(dev, assets, xs, cam_int, max_d, scene_idx, kernels, want):
    """Phase 12: the production generate+fit with the Stage-2 sampler, its
    population placed in the scene's floor as phase 6 places S1's."""
    import torch

    from psi_tpu_torch.fit.fitting import make_generate_fit_step
    from psi_tpu_torch.gen.sample import generate_bodies
    from psi_tpu_torch.scripts.profile_fit import floor_placement
    from psi_tpu_torch.models.cvae_s2 import HumanCVAES2
    from psi_tpu_torch.utils.config import FitConfig
    from psi_tpu_torch.utils.init import seeded_init_

    model = seeded_init_(HumanCVAES2(latentD_g=MODEL_KW["latentD"], latentD_l=MODEL_KW["latentD"],
                                     image_size=MODEL_KW["image_size"]), SEED).eval().to(dev)
    run = make_generate_fit_step(model, assets, FitConfig.production(num_iter=NUM_ITER), N_BODIES, want_metrics=False)
    x72_pre = generate_bodies(model, xs, cam_int, max_d, N_BODIES,
                              generator=torch.Generator(device=dev).manual_seed(SEED + 1))
    cam_ext = floor_placement(x72_pre, assets.grid_mins[0], assets.grid_maxs[0])
    torch.cuda.synchronize()
    for k in kernels:
        k.launches = 0
    t0 = time.time()
    x72, _, hist = run(xs, cam_int, max_d, cam_ext, scene_idx, generator=torch.Generator(device=dev).manual_seed(SEED + 1))
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {k.name: k.launches for k in kernels}
    loss0, loss_last = hist[0].mean().item(), hist[-1].mean().item()
    log(f"[s2] generate+fit N={N_BODIES} with HumanCVAES2 in {wall:.2f} s: launches {launches} (want {want}); mean loss "
        f"iter 0 {loss0:.6f} -> iter {NUM_ITER - 1} {loss_last:.6f}")
    if launches != want:
        raise AssertionError(f"[s2] launch counts {launches} != {want}")
    if x72.shape != (N_BODIES, 72) or not torch.isfinite(x72).all() or not loss_last < loss0:
        raise AssertionError(f"[s2] fitted bodies not finite [N, 72] or loss not falling: {loss0} -> {loss_last}")
    return {"wall_s": wall, "launches": launches, "loss_first": loss0, "loss_last": loss_last}


N_FILES = 300  # TestOP's default n_samples, the reference's per-scene population
MAX_POPULATION = 256
CHEAP_VERTS = 2048
N_CARRY = 4  # bodies of the carried-Adam run: it is serial, N x NUM_ITER passes at batch 1
ROWS_SNAPSHOTS = 4


def counted(kernels, fn):
    """(fn(), launch counts of ``kernels`` during it, wall seconds, peak GB)."""
    import torch

    torch.cuda.synchronize()
    for k in kernels:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    wall = time.time() - t0
    return out, {k.name: k.launches for k in kernels}, wall, torch.cuda.max_memory_allocated() / 1e9


def want_launches(kernels, k1: int, k2: int, k3: int) -> dict:
    return dict(zip((k.name for k in kernels), (k1, k2, k3)))


def check_launches(tag: str, got: dict, want: dict) -> None:
    if got != want:
        raise AssertionError(f"{tag} launch counts {got} != {want}")


def check_drivers(dev, model, assets, batch, cam_ext, kernels, smi: str):
    """Phase 13: generate -> files -> fit -> files -> score."""
    import pickle

    import numpy as np
    import torch

    from psi_tpu_torch.eval import collision_contact_scores, diversity_metrics
    from psi_tpu_torch.fit.fitting import FittingOP, fit_schedule, make_fit_step
    from psi_tpu_torch.gen.sample import TestOP
    from psi_tpu_torch.geometry.bodyvec import body_params_parse
    from psi_tpu_torch.utils.config import FitConfig

    cfg = FitConfig.production(num_iter=NUM_ITER)
    snapshot = {k: batch[k] for k in ("xs", "cam_int", "max_d")}
    snapshot["cam_ext"] = cam_ext[:1].cpu().numpy()
    workdir = Path(tempfile.mkdtemp(prefix="chip_smoke_files_"))
    try:
        gen_dir, fit_dir = workdir / "gen" / "scene", workdir / "fit"
        op = TestOP(model, n_samples=N_FILES, seed=SEED + 30)  # no device given: the card
        fitter = FittingOP(assets, cfg, scene_idx=0, max_population=MAX_POPULATION)
        if op.device != dev or fitter.device != dev:
            raise AssertionError("TestOP or FittingOP did not default to the card")
        t0 = time.time()
        n_written = op.test(snapshot, str(workdir / "gen"), "scene")
        write_s = time.time() - t0
        n_fitted, launches, fit_s, _ = counted(kernels, lambda: fitter.fitting_files(str(gen_dir), str(fit_dir)))
        again = fitter.fitting_files(str(gen_dir), str(fit_dir))
        # each chunk: the schedule's passes and one final metrics pass (K1 and K3, no backward)
        kinds = fit_schedule(cfg)
        chunks = -(-N_FILES // MAX_POPULATION)
        searches = sum(kind != "cheap" for kind in kinds)
        want = want_launches(kernels, chunks * (len(kinds) + 1), chunks * len(kinds), chunks * (searches + 1))

        def read(folder):
            recs = []
            for name in sorted(p.name for p in folder.iterdir()):
                with open(folder / name, "rb") as f:
                    recs.append(pickle.load(f))
            return recs

        t0 = time.time()
        gen_recs, fit_recs = read(gen_dir), read(fit_dir)
        read_s = time.time() - t0
        plain = all(type(v) is np.ndarray for r in fit_recs for v in r.values())
        names = sorted(p.name for p in fit_dir.iterdir())
        if not (n_written == n_fitted == len(fit_recs) == N_FILES and again == 0 and plain
                and names[0] == "body_gen_000900.pkl" and names[-1] == f"body_gen_{900 + N_FILES - 1:06d}.pkl"
                and fit_recs[0]["transl"].shape == (1, 3) and fit_recs[0]["body_pose"].dtype == np.float32):
            raise AssertionError(f"[drivers] wrote {n_written}, fitted {n_fitted} then {again}, read {len(fit_recs)}; "
                                 f"plain numpy records: {plain}")
        check_launches("[drivers]", launches, want)

        def stack(recs):
            x = torch.cat([body_params_parse(r) for r in recs]).to(dev)
            cam = torch.from_numpy(np.concatenate([np.asarray(r["cam_ext"], np.float32).reshape(-1, 4, 4)[:1]
                                                   for r in recs])).to(dev)
            return x, cam

        x_gen, cam_gen = stack(gen_recs)
        x_fit, cam_fit = stack(fit_recs)
        sidx = torch.zeros(N_FILES, dtype=torch.int64, device=dev)
        if not (torch.equal(cam_gen, cam_fit) and torch.isfinite(x_fit).all()):
            raise AssertionError("[drivers] fitted records lost their cam_ext or are not finite")
        # the first chunk is exactly make_fit_step on the first 256 files' arrays
        direct = make_fit_step(assets, cfg)
        head = (x_gen[:MAX_POPULATION], cam_gen[:MAX_POPULATION], sidx[:MAX_POPULATION])
        run_a, run_b = direct(*head)[0], direct(*head)[0]
        run_to_run = (run_a - run_b).abs().max().item()
        files_diff = (x_fit[:MAX_POPULATION] - run_a).abs().max().item()
        if not files_diff <= run_to_run:
            raise AssertionError(f"[drivers] files differ from make_fit_step by {files_diff}, two runs by {run_to_run}")
        # and so are its scores: the scorers on the files' rows and on make_fit_step's rows
        head_scores = [collision_contact_scores(assets, x, *head[1:]) for x in (x_fit[:MAX_POPULATION], run_a)]
        if run_to_run == 0.0 and head_scores[0] != head_scores[1]:
            raise AssertionError(f"[drivers] equal rows, other scores: files {head_scores[0]}, make_fit_step {head_scores[1]}")
        if not (abs(head_scores[0][0] - head_scores[1][0]) <= EVAL_NONCOLLISION_TOL
                and abs(head_scores[0][1] - head_scores[1][1]) <= EVAL_CONTACT_TOL):
            raise AssertionError(f"[drivers] scores of the files' rows {head_scores[0]} differ from those of "
                                 f"make_fit_step's {head_scores[1]}")
        t0 = time.time()
        nc, ct = collision_contact_scores(assets, x_fit, cam_fit, sidx)
        ent, md = diversity_metrics(x_fit, k=20)
        nc0, ct0 = collision_contact_scores(assets, x_gen, cam_gen, sidx)
        torch.cuda.synchronize()
        score_s = time.time() - t0
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    log(f"[drivers] TestOP wrote {n_written} pickles in {write_s:.2f} s; FittingOP.fitting_files fitted {n_fitted} in "
        f"{fit_s:.2f} s ({chunks} chunks of {MAX_POPULATION}, the last padded from {N_FILES - MAX_POPULATION}; "
        f"{N_FILES / fit_s:.2f} bodies/s, files included), a second call {again}; read back in {read_s:.2f} s; launches "
        f"{launches} (want {want}); first {MAX_POPULATION} rows vs make_fit_step max |diff| {files_diff:.3e} (two runs of "
        f"make_fit_step {run_to_run:.3e}), their scores (non-collision, contact) {head_scores[0]} vs {head_scores[1]}; scored in {score_s:.2f} s: non-collision {nc0:.6f} -> {nc:.6f}, contact "
        f"{ct0:.6f} -> {ct:.6f}, diversity entropy {ent:.6f}, mean centroid distance {md:.6f}; on {smi}")
    if not (0.0 <= nc <= 1.0 and 0.0 <= ct <= 1.0 and ent > 0.0):
        raise AssertionError("[drivers] scores out of range")
    return {"write_s": write_s, "fit_s": fit_s, "read_s": read_s, "score_s": score_s, "launches": launches,
            "files_vs_fit_step": files_diff, "fit_step_run_to_run": run_to_run,
            "head_scores_files": head_scores[0], "head_scores_fit_step": head_scores[1],
            "non_collision": nc, "contact": ct, "non_collision_before": nc0, "contact_before": ct0,
            "entropy": ent, "mean_dist": md}


def check_knobs(dev, model, assets, x72_init, cam_ext, scene_idx, kernels, sens_max: float, smi: str):
    """Phase 14: the three FitConfig knobs, make_generate_fit_rows and the
    carried-Adam mode, from phase 6's bodies. ``sens_max`` is phase 7's
    measured sensitivity of a fitted coordinate to a 1e-6 change of the latents."""
    import torch

    from psi_tpu_torch.data.synthetic import SyntheticBatchGenerator
    from psi_tpu_torch.fit.fitting import (fit_schedule, make_fit_step, make_fit_step_carry_opt_state,
                                           make_generate_fit_rows)
    from psi_tpu_torch.gen.sample import generate_bodies_rows
    from psi_tpu_torch.scripts.profile_fit import floor_placement
    from psi_tpu_torch.utils.config import FitConfig

    base = FitConfig.production(num_iter=NUM_ITER)
    kinds = fit_schedule(base)
    n_iter, searches = len(kinds), sum(kind != "cheap" for kind in kinds)
    args = (x72_init, cam_ext, scene_idx)
    out = {}

    def run(tag, cfg, want):
        fit = make_fit_step(assets, cfg)
        fit(*args)  # warm: the first call of a shape pays cuBLAS' and the allocator's set-up
        (x, m, h), launches, wall, peak = counted(kernels, lambda: fit(*args))
        check_launches(f"[knobs] {tag}", launches, want)
        if x.shape != (N_BODIES, 72) or not torch.isfinite(x).all():
            raise AssertionError(f"[knobs] {tag}: fitted bodies are not finite [N, 72]")
        out[tag] = {"wall_s": wall, "peak_gb": peak, "launches": launches,
                    "loss_first": h[0].mean().item(), "loss_last": h[-1].mean().item(),
                    "final": {k: v.mean().item() for k, v in m.items()}}
        return x, m, h

    # the default, with its final metrics pass (one more K1 and K3)
    x0, m0, h0 = run("default", base, want_launches(kernels, n_iter + 1, n_iter, searches + 1))

    # cheap_collision_verts: fused passes are those before the subset exists and the full ones after
    w = min(base.refresh_warmup, n_iter)
    fused = w + sum(kind == "full" for kind in kinds[w:])
    xs_, ms, hs = run("cheap_collision_verts", dataclasses.replace(base, cheap_collision_verts=CHEAP_VERTS),
                      want_launches(kernels, fused + 1 + 1, fused, searches + 1))  # + the scoring decode, + metrics
    o = out["cheap_collision_verts"]
    log(f"[knobs] cheap_collision_verts={CHEAP_VERTS}: {o['wall_s']:.4f} s (default {out['default']['wall_s']:.4f} s), launches "
        f"{o['launches']} ({fused} fused passes + the scoring decode at {min(64, N_BODIES)} bodies + the metrics pass; the "
        f"other {n_iter - fused} passes decode {assets.contact_vids.shape[0]} + <= {CHEAP_VERTS} rows through the 'fast' "
        f"einsums); mean loss {o['loss_first']:.6f} -> {o['loss_last']:.6f} (over the subset on cheap passes); final "
        f"full-vertex metrics " + ", ".join(f"{k} {v:.6f} (default {out['default']['final'][k]:.6f})" for k, v in o["final"].items())
        + f"; peak {o['peak_gb']:.4f} GB; on {smi}")
    if not o["loss_last"] < o["loss_first"]:
        raise AssertionError("[knobs] cheap_collision_verts: the mean loss did not fall")

    # the yardstick for a run of the same fit with sums taken in another order: how far the default's
    # fitted bodies move when its input moves by 1e-6 relative, here on the card at N=256 (phase 7
    # measures the same on the CPU at 16 bodies: max the figure passed in)
    plain = make_fit_step(assets, base, want_metrics=False)
    moved = [plain(x72_init * (1.0 + sign * CROSS_PERTURB), cam_ext, scene_idx) for sign in (1.0, -1.0)]
    own_last = [h[-1].mean().item() for _, _, h in moved]
    moved = [(x - x0).abs() for x, _, _ in moved]
    own_max, own_mean = max(d.max().item() for d in moved), max(d.mean().item() for d in moved)

    # overlap_chunks: the same iterates, chunk after chunk
    xc, mc, hc = run("overlap_chunks", dataclasses.replace(base, overlap_chunks=2),
                     want_launches(kernels, 2 * n_iter + 1, 2 * n_iter, 2 * searches + 1))
    d_x, d_mean, d_h = (xc - x0).abs().max().item(), (xc - x0).abs().mean().item(), (hc - h0).abs().max().item()
    d_h0 = ((hc[0] - h0[0]).abs() / h0[0].abs().clamp(min=1e-6)).max().item()
    # held on the mean: an axis-angle coordinate near pi wraps by 2 pi, so the largest of 256 x 72
    # differences is one body's wrap on either side and is printed, not held
    tol_mean = max(CROSS_MEAN_TOL, CROSS_SENS_FACTOR * own_mean)
    o = out["overlap_chunks"]
    o.update(max_diff_x72=d_x, mean_diff_x72=d_mean, max_diff_hist=d_h, iter0_rel_diff=d_h0,
             own_sensitivity_max=own_max, own_sensitivity_mean=own_mean,
             own_sensitivity_loss_last=own_last)
    log(f"[knobs] overlap_chunks=2: {o['wall_s']:.4f} s (default {out['default']['wall_s']:.4f} s), launches {o['launches']}; "
        f"difference to one chunk: iteration-0 loss {d_h0:.3e} relative (tol {CROSS_LOSS0_REL_TOL}), fitted x72 mean "
        f"{d_mean:.3e} (tol {tol_mean:.3e}) max {d_x:.3e}, loss history max {d_h:.3e}, mean final loss "
        f"{o['loss_last']:.6f} (default {out['default']['loss_last']:.6f}); the default's own drift for an input moved by "
        f"1e-6 relative: mean {own_mean:.3e} max {own_max:.3e}, mean final loss {own_last[0]:.6f} and {own_last[1]:.6f} (on the CPU at {N_CROSS} bodies: max {sens_max:.3e}); "
        f"peak {o['peak_gb']:.4f} GB; on {smi}")
    if not (d_h0 <= CROSS_LOSS0_REL_TOL and d_mean <= tol_mean):
        raise AssertionError("[knobs] overlap_chunks=2 drifts from one chunk beyond the fit's own sensitivity")
    # the check the fit's chaos cannot reach: a chunk is a fit of its own bodies at its own batch size,
    # with its own Adam moments and carried state, so each half of the two-chunk run must be the
    # one-chunk fit of that half alone, the same operations at the same shapes: equal bits (the
    # kernels and the library calls on the path are deterministic: phase 13's two runs differ by 0)
    half = N_BODIES // 2
    halves = [plain(*(a[lo:lo + half] for a in args)) for lo in (0, half)]
    x_halves, h_halves = torch.cat([x for x, _, _ in halves]), torch.cat([h for _, _, h in halves], dim=1)
    o["halves_max_diff_x72"] = (xc - x_halves).abs().max().item()
    o["halves_max_diff_hist"] = (hc - h_halves).abs().max().item()
    o["halves_bit_equal"] = torch.equal(xc, x_halves) and torch.equal(hc, h_halves)
    log(f"[knobs] overlap_chunks=2 against the one-chunk fits of bodies 0-{half - 1} and {half}-{N_BODIES - 1} alone, all "
        f"{n_iter} iterations: equal bits {o['halves_bit_equal']} (fitted x72 max |diff| {o['halves_max_diff_x72']:.3e}, loss "
        f"history {o['halves_max_diff_hist']:.3e})")
    if not o["halves_bit_equal"]:
        raise AssertionError("[knobs] overlap_chunks=2: a chunk is not the fit of its own bodies alone")

    # remat_decode: K1 again in every backward pass, equal bits
    xr, mr, hr = run("remat_decode", dataclasses.replace(base, remat_decode=True),
                     want_launches(kernels, 2 * n_iter + 1, n_iter, searches + 1))
    same = torch.equal(xr, x0) and torch.equal(hr, h0) and all(torch.equal(mr[k], m0[k]) for k in m0)
    o = out["remat_decode"]
    o["bit_equal"] = same
    log(f"[knobs] remat_decode: {o['wall_s']:.4f} s (default {out['default']['wall_s']:.4f} s), launches {o['launches']}; "
        f"bit-equal to the default: {same}; peak device memory {o['peak_gb']:.4f} GB (default "
        f"{out['default']['peak_gb']:.4f} GB); on {smi}")
    if not same:
        raise AssertionError("[knobs] remat_decode changed the fitted bits")

    # make_generate_fit_rows: 4 snapshots x 64 rows, each group fitted in its own scene
    per = N_BODIES // ROWS_SNAPSHOTS
    b = SyntheticBatchGenerator(num_scenes=ASSET_KW["num_scenes"], batches_per_epoch=1, seed=SEED + 40,
                                image_size=MODEL_KW["image_size"]).next_batch(ROWS_SNAPSHOTS)
    xs_stack, cam_int_stack, max_d_stack = (torch.from_numpy(b[k]).to(dev) for k in ("xs", "cam_int", "max_d"))
    req = torch.arange(N_BODIES, device=dev) // per
    gen = lambda: torch.Generator(device=dev).manual_seed(SEED + 41)
    pre = generate_bodies_rows(model, xs_stack, cam_int_stack, max_d_stack, req, generator=gen())
    cam_rows = torch.cat([floor_placement(pre[g * per:(g + 1) * per], assets.grid_mins[g], assets.grid_maxs[g])
                          for g in range(ROWS_SNAPSHOTS)])
    rows = make_generate_fit_rows(model, assets, base, want_metrics=False)
    rows(xs_stack, cam_int_stack, max_d_stack, req, cam_rows, req, generator=gen())
    (xg, _, hg), launches, wall, peak = counted(
        kernels, lambda: rows(xs_stack, cam_int_stack, max_d_stack, req, cam_rows, req, generator=gen()))
    check_launches("[knobs] generate_fit_rows", launches, want_launches(kernels, n_iter, n_iter, searches))
    by_group = [(hg[0, g * per:(g + 1) * per].mean().item(), hg[-1, g * per:(g + 1) * per].mean().item())
                for g in range(ROWS_SNAPSHOTS)]
    out["generate_fit_rows"] = {"wall_s": wall, "peak_gb": peak, "launches": launches, "loss_by_snapshot": by_group}
    log(f"[knobs] make_generate_fit_rows, {ROWS_SNAPSHOTS} snapshots x {per} rows, scenes 0-{ROWS_SNAPSHOTS - 1}: {wall:.4f} s "
        f"({N_BODIES / wall:.2f} bodies/s), launches {launches}; mean loss by snapshot "
        + ", ".join(f"{a:.6f} -> {z:.6f}" for a, z in by_group) + f"; on {smi}")
    if xg.shape != (N_BODIES, 72) or not torch.isfinite(xg).all() or not hg[-1].mean() < hg[0].mean():
        raise AssertionError("[knobs] generate_fit_rows: bodies not finite [N, 72] or the mean loss not falling")

    # the carried-Adam mode: serial, a full pass every iteration at one body
    carry = make_fit_step_carry_opt_state(assets, base)
    small = tuple(a[:N_CARRY] for a in args)
    (xa, ma), launches, wall, peak = counted(kernels, lambda: carry(*small))
    check_launches("[knobs] carried Adam", launches,
                   want_launches(kernels, N_CARRY * n_iter + 1, N_CARRY * n_iter, N_CARRY * n_iter + 1))
    # what the inherited moments do is judged after 2 iterations, before the
    # 20-iteration fit's own sensitivity (phase 7) swamps a rounding-level difference
    short = dataclasses.replace(base, num_iter=2)
    xa2 = make_fit_step_carry_opt_state(assets, short)(*small)[0]
    xf2 = make_fit_step(assets, dataclasses.replace(short, refresh_every=1))(*small)[0]
    # means over the coordinates: one near-zero gradient entry that changes sign moves one coordinate by ~lr
    d0 = (xa2[0] - xf2[0]).abs().mean().item()
    d_rest = (xa2[1:] - xf2[1:]).abs().mean().item()
    out["carried_adam"] = {"wall_s": wall, "launches": launches, "n": N_CARRY, "first_body_vs_fresh": d0,
                           "later_bodies_vs_fresh": d_rest, "final_total": ma["total"].mean().item()}
    log(f"[knobs] carried-Adam mode at N={N_CARRY} (serial: {N_CARRY * n_iter} passes at one body): {wall:.4f} s "
        f"({wall / (N_CARRY * n_iter) * 1e3:.2f} ms a pass), launches {launches}; final mean total "
        f"{ma['total'].mean().item():.6f}; after 2 iterations body 0 vs the fresh-state fit of full passes, mean |diff| {d0:.3e} "
        f"(the same moments at another batch size), bodies 1-{N_CARRY - 1} {d_rest:.3e} (inherited moments); on {smi}")
    if xa.shape != (N_CARRY, 72) or not torch.isfinite(xa).all() or not 10 * d0 < d_rest:
        raise AssertionError("[knobs] carried Adam: bodies not finite, body 0 not the fresh fit's, or inherited "
                             "moments made no difference")
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
    """Phases 1-14 on card ``dev``; raises on the first failure."""
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
        path_batches = check_path_batches(cb, A12, cam12, bundle, contact, y_pruned)

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

    # ---- 11. the training path, s1 then s2, through TrainOP
    from psi_tpu_torch.ops.chamfer import nn_argmin, nn_argmin_reference
    from psi_tpu_torch.utils.timing import cuda_device_ms, cuda_ms

    workdir = Path(tempfile.mkdtemp(prefix="chip_smoke_train_"))
    try:
        train = {mt: check_train(mt, dev, assets, assets_cpu, smi, workdir) for mt in ("s1", "s2")}
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    x32, y32 = contact[:32].contiguous(), y_full[:32].contiguous()
    Bt, Nt, Mt = x32.shape[0], x32.shape[1], y32.shape[1]
    if not torch.equal(nn_argmin(x32, y32), nn_argmin_reference(x32, y32)):
        raise AssertionError("K3 disagrees with its twin at the training step's shape")
    k3_train = {"device_ms": cuda_device_ms(lambda: nn_argmin(x32, y32)),
                "plain_ms": cuda_ms(lambda: nn_argmin_reference(x32, y32)),
                "cdist_argmin_ms": cuda_ms(lambda: torch.cdist(x32, y32).argmin(dim=-1)),
                **bound(4 * (3 * Bt * Nt + 3 * Bt * Mt) + 8 * Bt * Nt, f32=9 * Bt * Nt * Mt)}
    k3_train_ms = k3_train["device_ms"]
    log(f"[train] K3 at the training step's shape ({Bt}, {Nt}, {Mt}): indices equal the twin's; {k3_train_ms:.4f} ms "
        f"on the device (bound {k3_train['bound_ms']:.4f} ms, {k3_train['bound_by']}; twin {k3_train['plain_ms']:.4f} ms; "
        f"torch.cdist + argmin {k3_train['cdist_argmin_ms']:.4f} ms), "
        f"{100 * k3_train_ms / train['s1']['median_step_ms']:.1f}% of the s1 step and "
        f"{100 * k3_train_ms / train['s2']['median_step_ms']:.1f}% of the s2 step; on {smi}")

    # ---- 12. the Stage-2 sampler in front of the production fit
    s2 = check_s2_slice(dev, assets, xs, cam_int, max_d, scene_idx, kernels, want)

    # ---- 13. the file-driven path: TestOP -> files -> FittingOP -> files -> scorers
    drivers = check_drivers(dev, model, assets, batch, cam_ext, kernels, smi)

    # ---- 14. the fit's knobs, the coalesced sampler in front of the fit, the carried-Adam mode
    knobs = check_knobs(dev, model, assets, x72_pre, cam_ext, scene_idx, kernels, own[0], smi)

    # ---- the record: each kernel with the launch count of its path's run
    results = [(SKIN_FWD, k1, launches), (SKIN_BWD, k2, launches), (NN_ARGMIN, k3["pruned"], launches)]
    results += [(k, probes[k.name], probe_launches) for k in PROBES]
    rows = [{"name": k.name, "route": "cuda", "source": k.source, "replaces": k.replaces,
             "launches": counts[k.name], "max_abs_err": res["max_abs_err"],
             "ms": res["ms"], "device_ms": res["device_ms"], "plain_ms": res["plain_ms"],
             "bound_ms": res["bound_ms"],
             "bound_by": res["bound_by"], "library_ms": res["library_ms"]} for k, res, counts in results]
    # each path was driven with the counts set to 0 just before and read just after
    for row, k in zip(rows[:3], kernels):
        row["launches_by_path"] = {"generate_fit_s1": launches[k.name], "generate_fit_s2": s2["launches"][k.name],
                                   "fit_files": drivers["launches"][k.name],
                                   "fit_cheap_subset": knobs["cheap_collision_verts"]["launches"][k.name]}
    rows[2]["launches_by_path"].update(train_s1=train["s1"]["k3_launches"], train_s2=train["s2"]["k3_launches"])
    log(json.dumps({"slice": {"bodies_per_s": N_BODIES / wall, "wall_s": wall, "walls_s": walls,
                              "peak_gb": peak_gb},
                    "k1": {"stage_ms": k1["stage_ms"]},
                    "k2": {"stage_ms": k2["stage_ms"], "rel_err": k2["rel_err"]}, "hmma": hmma,
                    "k3_ffma": k3_ffma, "k3_pruned": k3["pruned"], "k3_full_cloud": k3["full"],
                    "k3_swapped": k3["swapped"], "hbm_gather": hbm, "sdf_ms_per_iter": sdf_ms, "eval": scores,
                    "train": train, "k3_train_shape": k3_train, "s2_slice": s2, "drivers": drivers,
                    "knobs": knobs, "kernels_at_path_batches": path_batches}))
    log(json.dumps({"kernels": rows}))
    log(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
