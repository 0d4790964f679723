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
              tensor-core instructions: HMMA in each of K1's and K2's
              kernels, HGMMA (wgmma) in each of the eight instances of K4/K5's
              product kernel (none may have 0), and of fused multiply-adds
              (FFMA) in K3's (must be 0: its bits rest on no contraction)
  3. K1       fused skinning forward vs its plain twin, two runs
              bit-equal; the time of each of its two launches beside the
              whole call, its registers and shared memory, its bound
  4. K2       fused skinning backward vs its twin, two runs bit-equal;
              the time of each of its five launches beside the total
  5. K3       chamfer NN argmin vs its twin at M=2048, at M=20000 and at
              the two-sided chamfer's swapped shape (the pruned cloud's
              points against the contact vertices); int64 indices, two runs
              equal; beside the bound, the issue floor of the exact formula.
              Then K1, K2 and K3 vs their twins at other body counts (128,
              64, and the carried-Adam mode's 4 and 1), full width, untimed
 5b. K4/K5    the 'high' LBS tier's split-bf16 products on phase 6's sampled
              bodies: the pose correctives [B, 486] @ posedirs [486, 31425]
              at B=256 and 32 and the blend w [10475, 55] . A12 [B, 55, 12]
              at B=256 and 1, K4 against its twin (float64 sums, within 2e-6
              of max |twin|) and K5, the gradient of the operand that varies
              per body, against its twin (<= 1% of elements differ, each by
              at most one bf16 ulp of the largest), and at B=256 K5 for the
              weights, which every body shares; two runs equal in bits; the
              pack launch's planes equal to its twin's; device time and
              effective TB/s, each of K5's two launches, the bound, the twin
              and the strict-f32 torch call the path ran before; ptxas'
              registers of each product kernel instance, 0 spill bytes
 5c. K6       the einsum decode's per-vertex tail (3x4 apply, transl,
              extrinsics) at B=256 and 32 on the same bodies: verts and the
              gradients of T, v_posed and transl within 1e-6 of max |twin|
              (the einsum chain in float64); two runs equal in bits; device
              time, effective TB/s and bound of forward and backward beside
              the strict-f32 cuBLAS chain it replaced; ptxas, 0 spill bytes.
              Its launches: [slice] 0, [eval] 1 + 0, [train] 1 + 1 a step,
              [exact] 20 + 20 a replayed 'high' call and 42 + 40 for
              cli.fitting_proxe --exact
  6. slice    one generate+fit call: launch counts K1=20, K2=20, K3=6 (K4-K6 0),
              finite bodies, mean loss falling, peak device memory; then
              bodies/s; then one more call, a replay of the fit's CUDA graph
              (the main path from a key's third call on), with the same
              launch counts asserted and the replay seen in graph_stats()
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
              k=20): the scores agree within stated bounds; the card's
              scorer launches K4 twice (one 'high' decode, no gradient)

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
              once per step at M = 20000 and K4/K5 twice each a step (the
              'high' decode and its gradient), BatchNorm's running statistics
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
              sampler: launch counts 20/20/6, finite bodies, falling loss;
              two calls more, the second a replay with 20/20/6 asserted

 and then the file-driven path and the fit's other entry points:

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
 14. paths    N=256 from phase 6's bodies, each with launch counts
              asserted and its wall time: the default fit with its final
              metrics, and its own drift for an input moved by 1e-6 (the
              yardstick phase 18 holds the sharded fit to);
              make_generate_fit_rows (4 snapshots x 64 rows, each group in
              its own scene) and the carried-Adam mode at N=4 (serial:
              N x 20 passes at one body).

 and then the serving path:

 15. serve    GenerationEngine (population 256, FitConfig.production(
              num_iter=20), max_requests 16, on the card by default) for the
              s1 and the s2 model on phase 6's assets: seconds of warmup() per
              program; generate(fit=True) with launch counts 20/20/6 and bodies
              equal in bits to make_generate_fit_step's on the same latents,
              generate(fit=False) 0/0/0 and equal to generate_bodies;
              generate_coalesced of 8 requests x 32 rows (8 snapshots, scenes
              and max_d) 20/20/6 and equal in bits to make_generate_fit_rows,
              and of 5 + 7 + 11 rows (233 padding rows, never returned); a
              ServingQueue burst of 8 threads x 32 fitted rows inside a 0.25-s
              linger (fewer than 8 program calls); a ServingRouter over both
              models serving two 256-row fitted requests submitted at the same
              moment, equal in bits to two fresh engines with the same seeds
              serving them one after the other, the TF32 flags as before; a
              20-s soak through scripts/soak_serve.py (3 clients, rows from
              {1, 4, 16, 64}, 70% fitted, a 60-request malformed storm: 0
              errors, every malformed future failed, no growth of device
              memory); python3 -m psi_tpu_torch.cli.serve as a child process
              answering a 600-body fitted request in three chunks; the time
              of make_fused_bundle, which every fitted call rebuilds.

 and then the reference's command-line entry points:

 16. cli      each main(argv) in this process, on the card by default, on
              the CLI's synthetic assets (10475 verts, 55 joints, 4 scenes,
              64^3 grids, 20k-point clouds, 1455 contact verts):
              cli.train_s1 --synthetic (two epochs of 2 batches of 32, gates
              open by resuming a checkpoint of the initial state marked
              epoch 8 of 10; K3 once a step; writes epoch-000010.ckp) ->
              cli.test_proxe_s1 --ckpt_dir on .mat snapshots written here
              (300 bodies for each of 4 test scenes) -> cli.fitting_proxe
              (its fitted pickles and launch counts equal in bits to
              FittingOP.fitting_files on the same files) -> cli.eval
              diversity and collision; cli.test_habitat on written
              cam_/depth_/seg_*.npy dumps (2 rooms x 2 cameras x 64 bodies)
              -> cli.fitting_habitat (50 iterations) -> cli.eval --dataset
              habitat; python -m psi_tpu_torch.cli.fitting_proxe as a child
              process. Launch counts and wall of each entry point; finite
              scores.

 and then scale-out and the VPoser prior:

 17. native   the C++ batch loader (g++-built) in front of TrainOP: one
              gated epoch, every sample once, the first step's metrics equal
              to the same rows through make_train_step
 18. dist     an NCCL group of one in this process, then two gloo ranks
              sharing the card (multiprocess_worker.spawn): the sharded
              generate+fit, engine and data-parallel step against the
              unsharded calls
 19. vposer   VPoserTrainer on the card at VPoserTrainConfig() (width 512,
              latentD 32, 21 joints, batch 256; the 10475-vertex, 55-joint
              body at 'high' LBS) on a make_synthetic_amass corpus of 8192 /
              1024 / 1024 frames: evaluate(), then perform_training(2), the
              eval loss falling at each epoch; ms a step (median after the
              first), steps/s, one profiled step's device launches and busy
              share, peak memory; load_best replays the best eval loss within
              1e-3 and load_vposer(work_dir) decodes 256 latents equal in bits;
              one step at batch 16 card vs CPU (same weights, injected noise
              and dropout masks: losses 1e-4, parameters' median relative
              difference 1e-5, the largest printed); vis_results' 3 x 4 PNG
              grid; one rasterize_mesh of the body at 256^2 timed, its depth
              and labels equal to the CPU's in >= 99.5% of pixels and within
              1 mm where both hit; BodyModelWithPoser.randomize_pose and
              untangle_interpenetrations() (psi_tpu's L-BFGS) lowering the
              proxy penalty; K1/K2/K3 launched 0/0/0 in the phase; K4/K5
              4/2 a training step, 4/0 an evaluation batch, 2/2 an untangle
              evaluation; the phase's seconds.

 and then the data production in front of the main path and the last
 entry points:

 20. snapshots produce_virtualcam_snapshots on scene 0 of the main path's
              registry (20k points, labelled floor or not by height) over 8
              body frames at psi_tpu's defaults (480 x 640, up to 30 cameras
              a frame) into an in-memory writer with SnapshotHDF5Writer's
              append/close (this machine has no h5py): snapshots rendered
              and written, ms a snapshot, one snapshot's device launches
              under torch.profiler, K1/K2/K3 0/0/0; the same call with
              device='cpu' on the first frame: the same rows kept with
              cam_ext equal in bits, that frame's cameras rendered again on
              both devices with raw maps equal in >= 99.5% of pixels,
              canvases within 1e-6 beyond what the differing raw pixels
              carry, body72 within 1e-5; that frame's rows decoded on the
              card and mapped by inv(cam_ext) onto the frame's world body
              within 1 mm, and off by more than 0.1 m by cam_ext as stored;
              a triangulated room (2,028 triangles) through
              rasterize_mesh, card vs CPU at >= 99.5%, timed; the first
              written snapshot's canvases, intrinsics and max_d into the
              N=256 production generate+fit in scene 0 with the row's
              cam_ext inverted (the row stores world->camera): 20/20/6,
              finite, wall beside [slice]'s; the timed fit's non-collision
              score (eval) above its samples' (the total loss is logged:
              the first Adam update raises it, as psi_tpu's does); then
              scripts.demo --n_samples 16 (21/20/7: fit_bodies' metrics
              pass), scripts.sample_body_pose, scripts.bench_sample and
              scripts.bench_train --reps 10 for s1 (K3 11 times), each
              with its output logged.

and then the paths that had not run on the card before:

 21. exact    the reference-exact fit tier (FitConfig.exact(): a full pass
              every iteration, 'high' LBS (split-bf16: K4/K5), f32 grids) at
              full width: scripts.profile_fused's six variants at
              --groups 3 --reps 1 (refresh10 fast/fused on bf16 grids,
              exact high/fast/fused, exact high unpruned: K3 at M=20000),
              each with its launch counts asserted (K1-K5 0/0/6/0/0,
              20/20/6/0/0, 0/0/20/40/40, 0/0/20/0/0, 20/20/20/0/0,
              0/0/20/40/40), finite [256, 72] bodies, the
              exact_high mean loss falling after Adam's first update; N=16
              FitConfig.exact() card vs CPU (iteration-0 losses within 1e-4,
              which TF32 would break; the fitted x72 within 2x the fit's own
              sensitivity, measured on the card for inputs moved by 1e-6);
              one exact_high call under torch.profiler, a replay of the
              fit's CUDA graph (device busy, launches, the ten largest device
              operations; 0/0/20/40/40 asserted, and the hand-written kernels
              the trace shows on the device equal to the eager first call's,
              K3's 20 among them); profile_segments at 'fused'
              and 'high' (20 iterations of each pass kind, launches
              asserted); profile_refresh_cadence at --groups 3 --reps 1
              (20/20/6, 20/20/6, 20/20/5); cli.fitting_proxe --exact on 300
              written pickles in each of two scenes (one chunk a scene:
              0/0/42/84/80), its files equal in bits to FittingOP.fitting_files
              with the CLI's exact configuration
 22. soak     scripts.bench_train_native at its defaults: 6144 synthetic
              samples packed for the native loader (807.7 MB), one warm-up
              epoch and 3 timed epochs of scan-epoch TrainOP s1 at
              TrainConfig's width (batch 32, chunk 32): 576 steps, K3 once a
              step (warm-up included), every metric finite, the loss after
              Adam's first update above the last; the timed run's first chunk
              against the per-step loop from the same state (the first step
              within 1e-5; cuDNN's default algorithms part the later ones);
              steps/s, samples/s, the loader's occupancy; then, with
              cudnn.deterministic, one-epoch runs of 1024 samples: the chunk
              equal in bits to the per-step loop, and --stage_bf16's last loss
              within 5% of f32 staging's

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
import os
import re
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
# K4: the same exact bf16 x bf16 products as its twin, which sums them in
#     float64 and rounds once; the kernel sums 16 at a time on the tensor
#     cores (truncating) and the steps in f32: of max |twin|.
K4_REL_TOL = 2e-6
# K5: the twin's cotangent blocks are f32 sums (cuBLAS on the card) in another
#     order than the kernel's, so a block rounds to the neighbouring bf16 on a
#     few elements; such an element moves by at most one bf16 ulp of the
#     operand's largest gradient.
K5_DIFFER_SHARE = 0.01
K5_ULP_REL = 2.0**-7
# K6: the twin's einsum chain in float64; the kernel's f32 FMAs a few
#     roundings off a vertex, its transl gradient a fixed-order f32 sum over
#     10,475 vertices: of each output's max |twin|.
K6_REL_TOL = 1e-6
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
SPLIT_KERNEL = "split_wgmma_kernel"  # K4 and K5's product kernel, in each of its tile, mode and route instances
SPLIT_INSTANCES = 8  # K4 and K5, each at 2 warpgroup tiles (2 x 1, 1 x 2), A read into registers or by the slab


def sass_counts(lib_path, opcodes=("HMMA", "HGMMA", "FFMA")):
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


def split_instance(name: str) -> str:
    """split_wgmma_kernel<mode, BN, WGN, route> from a mangled name."""
    m = re.search(SPLIT_KERNEL + r"ILi(\d)ELi(\d+)ELi(\d)ELb(\d)E", name)
    if m is None:
        raise AssertionError(f"not an instance of {SPLIT_KERNEL}: {name}")
    mode, bn, wgn, slab = m.groups()
    return f"{('K4', 'K5')[int(mode)]}<{bn}x{wgn},{('registers', 'slab')[int(slab)]}>"


def check_split_sass(counts: dict) -> dict:
    """Phase 2's tensor-core check for K4 and K5: every instance of their
    product kernel holds wgmma (HGMMA in the SASS)."""
    found = {split_instance(fn): n for fn, n in counts.items() if SPLIT_KERNEL in fn}
    log(f"[build]   {SPLIT_KERNEL}: {len(found)} instances, HGMMA instructions {found}")
    if len(found) != SPLIT_INSTANCES or not all(found.values()):
        raise AssertionError(f"K4/K5's product kernel: {len(found)} instances, HGMMA {found}")
    return found


def split_ptxas(log_text: str) -> dict:
    """ptxas' registers and spill bytes of each instance of K4/K5's product
    kernel, from the build log; raises unless every instance spills 0 bytes."""
    lines, found = log_text.splitlines(), {}
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and SPLIT_KERNEL in line:
            info = " ".join(x.strip() for x in lines[i + 1:i + 5] if "spill" in x or "Used" in x)
            spills = sum(int(n) for n in re.findall(r"(\d+) bytes spill", info))
            found[split_instance(line)] = {"ptxas": info, "spill_bytes": spills}
    if len(found) != SPLIT_INSTANCES or any(v["spill_bytes"] for v in found.values()):
        raise AssertionError(f"K4/K5's product kernel instances and their spills: {found}")
    return found


def split_bounds(B: int, P: int, V3: int, V: int, J: int) -> dict:
    """The bounds of K4 and K5 at the path's two products: the pose correctives
    pf [B, P] @ posedirs [P, V3] and the blend w [V, J] . A12 [B, J, 12]. Each
    reads its f32 operands once and writes its f32 output once ("bytes").
    K4 does three bf16 products of the operands' halves; K5 six (three parts
    of the f32 cotangent, each with both halves of the other operand)."""
    mm = 2 * B * P * V3
    blend = 2 * V * J * B * 12

    def of(nbytes, ops):
        return {"bytes": nbytes, **bound(nbytes, bf16=ops)}

    return {"k4_correctives": of(4 * (B * P + P * V3 + B * V3), 3 * mm),
            "k4_blend": of(4 * (V * J + B * J * 12 + B * V * 12), 3 * blend),
            "k5_correctives": of(4 * (B * V3 + P * V3 + B * P), 6 * mm),
            "k5_blend": of(4 * (V * J + B * V * 12 + B * J * 12), 6 * blend),
            "k5_weights": of(4 * (B * V * 12 + B * J * 12 + V * J), 6 * blend)}


def check_split(assets, cb, A12, build_log: str) -> dict:
    """Phase 5b: K4 and K5 against their twins at the 'high' tier's shapes on
    real bodies (phase 6's sampled population): the pose correctives at B =
    256 and 32, the blend at B = 256 and 1 (K5: A12's gradient), and at B =
    256 K5 for the weights, which every body shares; each cotangent seeded.
    Two runs equal in bits; the pack's planes equal to its twin's; the times
    of the kernel, its twin, and the strict-f32 torch call that the path ran
    before, beside the bound and the bytes a ms; ptxas' resources of every
    product kernel instance, none spilling."""
    import torch

    from psi_tpu_torch.ops import _cuda
    from psi_tpu_torch.ops import precision as tp
    from psi_tpu_torch.utils.timing import cuda_device_ms, cuda_ms

    smplx = assets.smplx
    P = smplx.posedirs.shape[0]

    def blend(w, a):
        return torch.einsum("vj,bjz->bvz", w, a)

    # name -> (a, b, the forward's Gemm, the gradients', the contraction, the operand whose gradient K5
    # serves, whether K4 is timed here, the strict-f32 call of that gradient)
    cases = {f"correctives_b{n}": (cb[:n, -P:].contiguous(), smplx.posedirs, tp.matmul_gemm, tp.matmul_grad_gemms,
                                   torch.matmul, 0, True, lambda a, b, g: g @ b.T) for n in (N_BODIES, 32)}
    cases.update({f"blend_b{n}": (smplx.lbs_weights, A12[:n].contiguous(), tp.blend_gemm, tp.blend_grad_gemms, blend,
                                  1, True, lambda a, b, g: torch.einsum("vj,bvz->bjz", a, g)) for n in (N_BODIES, 1)})
    cases[f"blend_b{N_BODIES}_weights"] = (smplx.lbs_weights, A12.contiguous(), tp.blend_gemm, tp.blend_grad_gemms,
                                           blend, 0, False, lambda a, b, g: torch.einsum("bvz,bjz->vj", g, b))
    gen = torch.Generator(device=cb.device).manual_seed(SEED + 5)
    out = {}
    for name, (a, b, gemm, grad_gemms, fn, which, fwd, library) in cases.items():
        gm = gemm(a, b)
        y1, y2 = tp.split_mm(gm), tp.split_mm(gm)
        ref = tp.split_product_reference(a, b, fn)
        g = torch.randn(gm.out_shape, generator=gen, device=cb.device)
        need = (which == 0, which == 1)
        sub = grad_gemms(a, b, g, need)[which]
        g1, g2 = tp.split_mm_grad(sub), tp.split_mm_grad(sub)
        gref = tp.split_product_grad_reference(a, b, g, fn, need)[which]
        packs_equal = all(torch.equal(tp.pack(x, grad), tp.pack_reference(x, grad)) for x, grad in
                          ((gm, False), (sub, True)))
        torch.cuda.synchronize()
        fwd_max_abs, grad_max_abs = (y1 - ref).abs().max().item(), (g1 - gref).abs().max().item()
        fwd_rel, grad_rel = fwd_max_abs / ref.abs().max().item(), grad_max_abs / gref.abs().max().item()
        # the same widened products summed in f32 by the torch call (cuBLAS), for scale
        axes = (1, 0) if fn is torch.matmul else (1, 1)
        f32_sum = fn(tp.split3(a, axes[0]).float(), tp.split3_rhs(b, axes[1]).float())
        f32_sum_rel = ((f32_sum - ref).abs().max() / ref.abs().max()).item()
        differ = (g1 != gref).double().mean().item()
        equal = torch.equal(y1, y2) and torch.equal(g1, g2)
        args, _, _keep = tp.grad_operands(sub)
        B = b.shape[0] if fn is blend else a.shape[0]
        bnd = split_bounds(B, P, smplx.posedirs.shape[1], smplx.num_verts, smplx.num_joints)
        kind = "correctives" if fn is torch.matmul else "weights" if which == 0 else "blend"
        r = {"B": B, "fwd_rel": fwd_rel, "fwd_max_abs": fwd_max_abs, "f32_sum_rel": f32_sum_rel,
             "grad_differ_share": differ, "grad_rel": grad_rel, "grad_max_abs": grad_max_abs, "equal_bits": equal,
             "packs_equal": packs_equal,
             "k5": {"ms": cuda_ms(lambda: tp.split_mm_grad(sub)), "device_ms": cuda_device_ms(lambda: tp.split_mm_grad(sub)),
                    "plain_ms": cuda_ms(lambda: tp.split_product_grad_reference(a, b, g, fn, need)),
                    "stage_ms": stage_ms("psi_split_mm_grad", args, tp.BWD_STAGES, tp.BWD_ALL, _cuda.stream_of(g)),
                    "library_ms": cuda_ms(lambda: library(a, b, g)),
                    "library_device_ms": cuda_device_ms(lambda: library(a, b, g)), **bnd[f"k5_{kind}"]}}
        if fwd:
            r["k4"] = {"ms": cuda_ms(lambda: tp.split_mm(gm)), "device_ms": cuda_device_ms(lambda: tp.split_mm(gm)),
                       "plain_ms": cuda_ms(lambda: tp.split_product_reference(a, b, fn)),
                       "library_ms": cuda_ms(lambda: fn(a, b)),
                       "library_device_ms": cuda_device_ms(lambda: fn(a, b)), **bnd[f"k4_{'correctives' if fn is torch.matmul else 'blend'}"]}
        out[name] = r
        log(f"[K4/K5] {name}: forward max |K4 - twin| / max |twin| {fwd_rel:.3e} (tol {K4_REL_TOL}; the same "
            f"products summed in f32 by torch: {f32_sum_rel:.3e}); "
            f"K5's gradient differs from the twin's on {100 * differ:.4f}% of elements (tol {100 * K5_DIFFER_SHARE}%), "
            f"by at most {grad_rel:.3e} of its largest (tol {K5_ULP_REL:.3e}); two runs equal in bits: {equal}; "
            f"packed planes equal to the twin's: {packs_equal}")
        for tag, res in (("K4", r.get("k4")), ("K5", r["k5"])):
            if res is None:
                continue
            launches = "".join(f", {n} {v:.4f}" for n, v in res.get("stage_ms", {}).items())
            log(f"[K4/K5]   {tag} {res['device_ms']:.4f} ms on the device ({res['ms']:.4f} a call{launches}), "
                f"{res['bytes'] / res['device_ms'] / 1e9:.3f} TB/s effective; bound {res['bound_ms']:.4f} ms, "
                f"{res['bound_by']}: {res['device_ms'] / res['bound_ms']:.1f}x; twin {res['plain_ms']:.4f} ms; "
                f"strict-f32 torch {res['library_device_ms']:.4f} ms on the device "
                f"({res['library_device_ms'] / res['device_ms']:.2f}x K4/K5's time)")
        if not (fwd_rel <= K4_REL_TOL and differ <= K5_DIFFER_SHARE and grad_rel <= K5_ULP_REL and equal
                and packs_equal):
            raise AssertionError(f"[K4/K5] {name}: K4 or K5 disagrees with its twin or is not deterministic: {r}")
    resources = split_ptxas(build_log)
    log("[K4/K5] ptxas: " + "; ".join(f"{k}: {v['ptxas']}" for k, v in resources.items()))
    log(f"[K4/K5] packed planes kept for constant operands: {tp.PACKS.nbytes() / 1e6:.1f} MB")
    out["ptxas"] = resources
    out["packs_mb"] = tp.PACKS.nbytes() / 1e6
    return out


def vtail_ptxas(log_text: str) -> dict:
    """ptxas' registers and spill bytes of K6's three kernels; raises on a spill."""
    lines, found = log_text.splitlines(), {}
    for name in ("vtail_fwd_kernel", "vtail_bwd_kernel", "vtail_reduce_kernel"):
        for i, line in enumerate(lines):
            if "Compiling entry function" in line and name in line:
                info = " ".join(x.strip() for x in lines[i + 1:i + 5] if "spill" in x or "Used" in x)
                found[name] = {"ptxas": info, "spill_bytes": sum(int(n) for n in re.findall(r"(\d+) bytes spill", info))}
    if len(found) != 3 or any(v["spill_bytes"] for v in found.values()):
        raise AssertionError(f"K6's kernels and their spills: {found}")
    return found


def check_vtail(assets, cb, A12, x72, cam_ext, build_log: str) -> dict:
    """Phase 5c: K6, the einsum decode's per-vertex tail, against its twin
    (the einsum chain it replaced, summed here in float64) at B = 256 and 32
    on real bodies: T from K4's blend of the sampled bodies' A12, v_posed from
    their shape and pose, their transl and extrinsics, a seeded cotangent.
    verts and the three gradients within K6_REL_TOL of max |twin|; two runs
    equal in bits; the device times of K6's forward and backward beside their
    bounds and beside the same chain in strict-f32 torch (cuBLAS's batched
    products and the elementwise glue: ``library_ms``, timed here only);
    ptxas' resources, no spill."""
    import torch

    from psi_tpu_torch.body.lbs import blend_shapes
    from psi_tpu_torch.ops import precision as tp
    from psi_tpu_torch.ops import vertex_tail as vt
    from psi_tpu_torch.utils.timing import cuda_device_ms, cuda_ms

    smplx = assets.smplx
    L, P = smplx.shapedirs.shape[-1], smplx.posedirs.shape[0]
    gen = torch.Generator(device=cb.device).manual_seed(SEED + 6)
    out = {}
    for B in (N_BODIES, 32):
        T12 = tp.split_mm(tp.blend_gemm(smplx.lbs_weights, A12[:B].contiguous()))
        v = (smplx.v_template[None] + blend_shapes(cb[:B, 1:1 + L], smplx.shapedirs)
             + (cb[:B, -P:] @ smplx.posedirs).reshape(B, -1, 3)).contiguous()
        transl, cam = x72[:B, :3].contiguous(), cam_ext[:B].contiguous()
        g = torch.randn((B, smplx.num_verts, 3), generator=gen, device=cb.device)
        V = smplx.num_verts

        def run(fn, dtype=torch.float32):
            with torch.enable_grad():
                leaves = [x.detach().to(dtype).requires_grad_() for x in (T12, v, transl)]
                y = fn(*leaves, cam.to(dtype))
                return [y.detach()] + list(torch.autograd.grad(y, leaves, g.to(dtype)))

        got, again, twin = run(vt.vertex_tail), run(vt.vertex_tail), run(vt.vertex_tail_reference, torch.float64)
        names = ("verts", "grad_T", "grad_v_posed", "grad_transl")
        err = {n: (a.double() - b).abs().max().item() for n, a, b in zip(names, got, twin)}
        rel = {n: err[n] / b.abs().max().item() for n, b in zip(names, twin)}
        equal = all(torch.equal(a, b) for a, b in zip(got, again))
        log(f"[K6] B={B}: max |K6 - twin| / max |twin| " + ", ".join(f"{n} {x:.3e}" for n, x in rel.items())
            + f" (tol {K6_REL_TOL}); two runs equal in bits: {equal}")
        if not (max(rel.values()) <= K6_REL_TOL and equal):
            raise AssertionError(f"[K6] B={B}: K6 disagrees with its twin or is not deterministic: {rel}, {equal}")

        leaves = [x.detach().requires_grad_() for x in (T12, v, transl)]

        def times(fn, backward: bool) -> dict:
            """fn's forward, or its forward and backward together (a backward runs on its forward's stream, so a
            CUDA graph captures the two together): ms a call and ms on the device."""
            def call():
                if not backward:
                    return fn(T12, v, transl, cam)
                with torch.enable_grad():
                    return torch.autograd.grad(fn(*leaves, cam), leaves, g)
            return {"ms": cuda_ms(call), "device_ms": cuda_device_ms(call)}

        k6 = [times(vt.vertex_tail, bw) for bw in (False, True)]
        chain = [times(vt.vertex_tail_reference, bw) for bw in (False, True)]  # the twin: the library call too
        r = {"B": B, "rel": rel, "max_abs_err": err, "equal_bits": equal}
        for tag, nbytes, part in (("fwd", 4 * B * V * 18 + 4 * B * 19, lambda x: x[0]),
                                  ("bwd", 4 * B * V * 33 + 4 * B * 19, lambda x: x[1] - x[0])):
            r[tag] = {"ms": part([x["ms"] for x in k6]), "device_ms": part([x["device_ms"] for x in k6]),
                      "plain_ms": part([x["ms"] for x in chain]), "library_ms": part([x["ms"] for x in chain]),
                      "library_device_ms": part([x["device_ms"] for x in chain]), "bytes": nbytes, **bound(nbytes)}
        out[f"b{B}"] = r
        for tag in ("fwd", "bwd"):
            x = r[tag]
            log(f"[K6]   {tag} {x['device_ms']:.4f} ms on the device ({x['ms']:.4f} a call), "
                f"{x['bytes'] / x['device_ms'] / 1e9:.3f} TB/s effective; bound {x['bound_ms']:.4f} ms, {x['bound_by']}: "
                f"{x['device_ms'] / x['bound_ms']:.2f}x; the cuBLAS chain it replaced {x['library_device_ms']:.4f} ms on "
                f"the device ({x['library_ms']:.4f} a call, {x['library_device_ms'] / x['device_ms']:.1f}x K6's time)")
    out["ptxas"] = vtail_ptxas(build_log)
    log("[K6] ptxas: " + "; ".join(f"{k}: {v['ptxas']}" for k, v in out["ptxas"].items()))
    return out


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
    """K1, K2 and K3 against their twins at other body counts than phase 6's,
    at full width: half the population, TWO_BODY_TILES, and the carried-Adam
    mode's, which runs its passes at one body and its metrics pass at
    N_CARRY. Slices of phase 3-5's operands, the same tolerances, no timing."""
    import torch

    from psi_tpu_torch.ops.chamfer import nn_argmin, nn_argmin_reference
    from psi_tpu_torch.ops.fused_skinning import (fused_skinning_bwd, fused_skinning_bwd_reference,
                                                  fused_skinning_fwd, fused_skinning_fwd_reference)

    out = {}
    g_all = torch.randn((cb.shape[0], bundle.n_verts, 3), generator=torch.Generator().manual_seed(SEED + 4)).to(cb.device)
    for B in (cb.shape[0] // 2, TWO_BODY_TILES, N_CARRY, 1):
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
    from psi_tpu_torch.ops.precision import SPLIT_BWD, SPLIT_FWD
    from psi_tpu_torch.ops.vertex_tail import VTAIL_BWD, VTAIL_FWD

    t0 = time.time()
    (nc, ct), split_launches, _, _ = counted((SPLIT_FWD, SPLIT_BWD, VTAIL_FWD, VTAIL_BWD),
                                             lambda: collision_contact_scores(assets, x72, cam_ext, scene_idx))
    ent, md = diversity_metrics(x72, k=20)
    torch.cuda.synchronize()
    card_s = time.time() - t0
    # one 'high' decode of the population, no gradient: K4 for the correctives and the blend, K6 for the tail
    check_launches("[eval] the collision scorer", split_launches,
                   {SPLIT_FWD.name: 2, SPLIT_BWD.name: 0, VTAIL_FWD.name: 1, VTAIL_BWD.name: 0})
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
    return {"non_collision": nc, "contact": ct, "entropy": ent, "mean_dist": md, "split_launches": split_launches,
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
    from psi_tpu_torch.ops.precision import SPLIT_BWD, SPLIT_FWD
    from psi_tpu_torch.ops.vertex_tail import VTAIL_BWD, VTAIL_FWD
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
    for k in (NN_ARGMIN, SPLIT_FWD, SPLIT_BWD, VTAIL_FWD, VTAIL_BWD):
        k.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    last = op.train(batches(half))
    torch.cuda.synchronize()
    k3_launches = NN_ARGMIN.launches
    split_launches = {k.name: k.launches for k in (SPLIT_FWD, SPLIT_BWD)}
    vtail_launches = {k.name: k.launches for k in (VTAIL_FWD, VTAIL_BWD)}
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
    # a step decodes its bodies once at 'high': K4 for the correctives and the blend, K5 for their gradients
    check_launches(f"{tag} K4/K5 in {TRAIN_STEPS} steps", split_launches,
                   {SPLIT_FWD.name: 2 * TRAIN_STEPS, SPLIT_BWD.name: 2 * TRAIN_STEPS})
    # ... and K6 once each way for its per-vertex tail
    check_launches(f"{tag} K6 in {TRAIN_STEPS} steps", vtail_launches,
                   {VTAIL_FWD.name: TRAIN_STEPS, VTAIL_BWD.name: TRAIN_STEPS})
    moved = [k for k, v in op.model.state_dict().items() if k in stats0 and not torch.equal(v, stats0[k])]
    if len(moved) != len(stats0):
        raise AssertionError(f"{tag} {len(stats0) - len(moved)} running statistics did not move")
    median_ms = statistics.median(step_ms[1:])
    log(f"{tag} TrainOP on the card, batch {cfg.batch_size}, gates open (epochs 8 and 9 of 9): {TRAIN_STEPS} steps, every "
        f"metric finite; loss {rows[0]['loss']:.6f} -> {rows[-1]['loss']:.6f}; contact > 0 in all, collision > 0 in "
        f"{n_collision}; K3 launches {k3_launches} at M={M} (one per step), K4/K5 {split_launches}, K6 {vtail_launches}; "
        f"{len(moved)} "
        f"running statistics moved; "
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
            "split_launches": split_launches, "vtail_launches": vtail_launches,
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

    def again(seed):
        return run(xs, cam_int, max_d, cam_ext, scene_idx, generator=torch.Generator(device=dev).manual_seed(seed))

    again(SEED + 2)  # the key's second call: captured
    replayed = check_replayed("[s2]", run, kernels, lambda: again(SEED + 3), want)
    return {"wall_s": wall, "launches": launches, "loss_first": loss0, "loss_last": loss_last,
            "replayed": replayed}


N_FILES = 300  # TestOP's default n_samples, the reference's per-scene population
MAX_POPULATION = 256
TWO_BODY_TILES = 64  # bodies: two of K1's 32-body tiles
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


# the device kernels of csrc/ that K1-K6 launch (their packs and reductions too): a trace's names hold them
HAND_WRITTEN = ("skin_fwd_kernel", "skin_pack_kernel", "skin_bwd_coef_kernel", "splitk_gemm_kernel",
                "reduce_tiles_kernel", "nn_argmin_kernel", "split_wgmma_kernel", "split_reduce_kernel",
                "split_pack_kernel", "vtail_fwd_kernel", "vtail_bwd_kernel", "vtail_reduce_kernel")


def hand_written_on_device(fn):
    """(fn(), the profile, {device kernel name: launches} of the hand-written
    kernels in one profiled run of fn): what ran on the card, from the trace,
    whether fn launched them itself or replayed a CUDA graph that holds them."""
    import torch

    from psi_tpu_torch.scripts.profile_fit import device_events

    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    return out, prof, {e.key: e.count for e in device_events(prof) if any(h in e.key for h in HAND_WRITTEN)}


def check_replayed(tag: str, run, kernels, fn, want: dict) -> dict:
    """The main path's launches: one more call of ``run``'s program, which
    must be a replay of its CUDA graph (a key's third or later call). The
    launch counts of ``kernels`` during it must equal ``want``, and the
    replay must be counted in ``run.graph_stats()``."""
    before = run.graph_stats()
    _, launches, wall, _ = counted(kernels, fn)
    after = run.graph_stats()
    log(f"{tag} replayed call {wall:.4f} s: launches {launches} (want {want}); graph_stats {after}")
    check_launches(f"{tag} replayed call", launches, want)
    if not (after["replays"] == before["replays"] + 1 and after["eager"] == before["eager"]
            and after["captures"] == before["captures"] == 1 and after["graphs"] == 1):
        raise AssertionError(f"{tag} the call did not replay the program's one graph: {before} -> {after}")
    return {"wall_s": wall, "launches": launches, "graph_stats": after}


def want_launches(kernels, k1: int, k2: int, k3: int, k4: int = 0, k5: int = 0, *k6: int) -> dict:
    """K1..K5's wanted counts, and K6's (forward, backward) where given, for as many of them as ``kernels`` names."""
    return dict(zip((k.name for k in kernels), (k1, k2, k3, k4, k5, *k6)))


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


def check_fit_paths(dev, model, assets, x72_init, cam_ext, scene_idx, kernels, sens_max: float, smi: str):
    """Phase 14: the default fit and its own drift, make_generate_fit_rows and
    the carried-Adam mode, from phase 6's bodies. ``sens_max`` is phase 7's
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

    # the default, with its final metrics pass (one more K1 and K3)
    fit = make_fit_step(assets, base)
    fit(*args)  # warm: the first call of a shape pays cuBLAS' and the allocator's set-up
    (x0, m0, h0), launches, wall, peak = counted(kernels, lambda: fit(*args))
    check_launches("[paths] default", launches, want_launches(kernels, n_iter + 1, n_iter, searches + 1))
    if x0.shape != (N_BODIES, 72) or not torch.isfinite(x0).all():
        raise AssertionError("[paths] default: fitted bodies are not finite [N, 72]")
    out["default"] = {"wall_s": wall, "peak_gb": peak, "launches": launches,
                      "loss_first": h0[0].mean().item(), "loss_last": h0[-1].mean().item(),
                      "final": {k: v.mean().item() for k, v in m0.items()}}

    # the yardstick for a run of the same fit with sums taken in another order: how far the default's
    # fitted bodies move when its input moves by 1e-6 relative, here on the card at N=256 (phase 7
    # measures the same on the CPU at 16 bodies: max the figure passed in)
    plain = make_fit_step(assets, base, want_metrics=False)
    moved = [plain(x72_init * (1.0 + sign * CROSS_PERTURB), cam_ext, scene_idx) for sign in (1.0, -1.0)]
    own_last = [h[-1].mean().item() for _, _, h in moved]
    moved = [(x - x0).abs() for x, _, _ in moved]
    own = {"max": max(d.max().item() for d in moved), "mean": max(d.mean().item() for d in moved),
           "loss_last": own_last}
    out["own_sensitivity"] = own
    log(f"[paths] default fit: {wall:.4f} s, launches {launches}, mean loss {h0[0].mean().item():.6f} -> "
        f"{h0[-1].mean().item():.6f}, peak {peak:.4f} GB; its own drift for an input moved by {CROSS_PERTURB} relative: "
        f"mean {own['mean']:.3e} max {own['max']:.3e}, mean final loss {own_last[0]:.6f} and {own_last[1]:.6f} (on the "
        f"CPU at {N_CROSS} bodies: max {sens_max:.3e}); on {smi}")

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
    check_launches("[paths] generate_fit_rows", launches, want_launches(kernels, n_iter, n_iter, searches))
    by_group = [(hg[0, g * per:(g + 1) * per].mean().item(), hg[-1, g * per:(g + 1) * per].mean().item())
                for g in range(ROWS_SNAPSHOTS)]
    out["generate_fit_rows"] = {"wall_s": wall, "peak_gb": peak, "launches": launches, "loss_by_snapshot": by_group}
    log(f"[paths] make_generate_fit_rows, {ROWS_SNAPSHOTS} snapshots x {per} rows, scenes 0-{ROWS_SNAPSHOTS - 1}: {wall:.4f} s "
        f"({N_BODIES / wall:.2f} bodies/s), launches {launches}; mean loss by snapshot "
        + ", ".join(f"{a:.6f} -> {z:.6f}" for a, z in by_group) + f"; on {smi}")
    if xg.shape != (N_BODIES, 72) or not torch.isfinite(xg).all() or not hg[-1].mean() < hg[0].mean():
        raise AssertionError("[paths] generate_fit_rows: bodies not finite [N, 72] or the mean loss not falling")

    # the carried-Adam mode: serial, a full pass every iteration at one body
    carry = make_fit_step_carry_opt_state(assets, base)
    small = tuple(a[:N_CARRY] for a in args)
    (xa, ma), launches, wall, peak = counted(kernels, lambda: carry(*small))
    check_launches("[paths] carried Adam", launches,
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
    log(f"[paths] carried-Adam mode at N={N_CARRY} (serial: {N_CARRY * n_iter} passes at one body): {wall:.4f} s "
        f"({wall / (N_CARRY * n_iter) * 1e3:.2f} ms a pass), launches {launches}; final mean total "
        f"{ma['total'].mean().item():.6f}; after 2 iterations body 0 vs the fresh-state fit of full passes, mean |diff| {d0:.3e} "
        f"(the same moments at another batch size), bodies 1-{N_CARRY - 1} {d_rest:.3e} (inherited moments); on {smi}")
    if xa.shape != (N_CARRY, 72) or not torch.isfinite(xa).all() or not 10 * d0 < d_rest:
        raise AssertionError("[paths] carried Adam: bodies not finite, body 0 not the fresh fit's, or inherited "
                             "moments made no difference")
    return out


SERVE_MAX_REQUESTS = 16
SERVE_BURST = 8  # client threads of the queue burst, and requests of the full coalesced call
SERVE_LINGER_S = 0.25
SERVE_SOAK_S = 20.0
SERVE_STORM = 60
SERVE_BUCKET_S = 5.0
# serve, device memory between programs: nothing a request allocates outlives it, so the idle reading
#     after the soak and the last bucket's least reading may exceed the first's only by what the caching
#     allocator's bookkeeping of a new block size could add: a few MB of ~250 held.
SERVE_MEM_TOL_MB = 8.0
SERVE_CLI_BODIES = 600
SERVE_PART_ROWS = 100  # a request for fewer rows than the population: the rest is dropped


def check_serve(dev, model, assets, batch, cam_ext, kernels, want, smi: str):
    """Phase 15: the serving path through its entry points; returns its record."""
    import os
    import threading

    import numpy as np
    import torch

    from psi_tpu_torch.body.smplx_model import make_fused_bundle
    from psi_tpu_torch.data.synthetic import SyntheticBatchGenerator
    from psi_tpu_torch.fit.fitting import make_generate_fit_rows, make_generate_fit_step
    from psi_tpu_torch.gen.sample import generate_bodies
    from psi_tpu_torch.models.cvae_s2 import HumanCVAES2
    from psi_tpu_torch.scripts import soak_serve
    from psi_tpu_torch.serve import GenerationEngine, ServingQueue, ServingRouter
    from psi_tpu_torch.utils.config import FitConfig
    from psi_tpu_torch.utils.init import seeded_init_
    from psi_tpu_torch.utils.precision import strict_f32
    from psi_tpu_torch.utils.timing import cuda_ms

    cfg = FitConfig.production(num_iter=NUM_ITER)
    zero = want_launches(kernels, 0, 0, 0)
    model2 = seeded_init_(HumanCVAES2(latentD_g=MODEL_KW["latentD"], latentD_l=MODEL_KW["latentD"],
                                      image_size=MODEL_KW["image_size"]), SEED).eval().to(dev)
    models = {"s1": model, "s2": model2}
    out = {}

    def engine(mt, seed):
        e = GenerationEngine(models[mt], assets, population=N_BODIES, fit_cfg=cfg, seed=seed,
                             max_requests=SERVE_MAX_REQUESTS)  # no device given: the card
        if e.device != dev:
            raise AssertionError("GenerationEngine did not default to the card")
        return e

    tf32_before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)

    # ---- warmup, program by program
    engines = {mt: engine(mt, SEED + 50) for mt in models}
    out["warmup_s"] = {mt: {p: e.warmup(programs=(p,)) for p in e.WARMUP_PROGRAMS} for mt, e in engines.items()}
    for mt, w in out["warmup_s"].items():
        log(f"[serve] warmup of the {mt} engine, seconds per program: " + ", ".join(f"{p} {t:.3f}" for p, t in w.items())
            + f"; all four {sum(w.values()):.3f} s; on {smi}")
    eng = engines["s1"]

    # ---- one request alone: the snapshot of phase 6, placed in the floor
    snap = {k: batch[k] for k in ("xs", "cam_int", "max_d")}
    snap["cam_ext"] = cam_ext[:1].cpu().numpy()
    xs, cam_int, max_d = (torch.from_numpy(batch[k]).to(dev) for k in ("xs", "cam_int", "max_d"))
    scene_idx = torch.zeros(N_BODIES, dtype=torch.int64, device=dev)
    eps = torch.randn((N_BODIES, model.eps_d), generator=torch.Generator().manual_seed(SEED + 51)).to(dev)
    res, launches, wall, _ = counted(kernels, lambda: eng.generate(snap, fit=True, scene_idx=0, eps=eps))
    check_launches("[serve] generate(fit=True)", launches, want)
    out["launches_single_fit"] = launches
    direct = make_generate_fit_step(model, assets, cfg, N_BODIES, want_metrics=False)
    x_direct, _, hist = direct(xs, cam_int.reshape(1, 3, 3), max_d.reshape(1), cam_ext[:1].expand(N_BODIES, 4, 4).contiguous(),
                               scene_idx, eps=eps)
    same = np.array_equal(res.bodies, x_direct.cpu().numpy())
    loss0, loss_last = hist[0].mean().item(), hist[-1].mean().item()
    single_fit_s = res.latency_s
    log(f"[serve] generate(fit=True) N={N_BODIES}: {res.latency_s:.4f} s end to end ({N_BODIES / res.latency_s:.2f} bodies/s), "
        f"launches {launches}; bodies equal in bits make_generate_fit_step's on the same latents: {same}; mean loss of that "
        f"program {loss0:.6f} -> {loss_last:.6f}; on {smi}")
    if not (same and res.fitted and res.bodies.shape == (N_BODIES, 72) and np.isfinite(res.bodies).all() and loss_last < loss0):
        raise AssertionError("[serve] the fitted request is not make_generate_fit_step's, or its loss does not fall")
    res0, launches0, _, _ = counted(kernels, lambda: eng.generate(snap, n_samples=SERVE_PART_ROWS, fit=False, eps=eps))
    check_launches("[serve] generate(fit=False)", launches0, zero)
    same0 = np.array_equal(res0.bodies, generate_bodies(model, xs, cam_int, max_d, N_BODIES, eps=eps)[:SERVE_PART_ROWS].cpu().numpy())
    log(f"[serve] generate(fit=False), {SERVE_PART_ROWS} of {N_BODIES} rows: {res0.latency_s * 1e3:.2f} ms end to end, launches {launches0}; "
        f"equal in bits to generate_bodies' first {SERVE_PART_ROWS}: {same0}")
    if not (same0 and not res0.fitted and res0.bodies.shape == (SERVE_PART_ROWS, 72)):
        raise AssertionError("[serve] the generate-only request is not generate_bodies'")
    out.update(single_fit_s=single_fit_s, single_generate_s=res0.latency_s, single_fit_bit_equal=same,
               loss_first=loss0, loss_last=loss_last)

    # ---- a full coalesced call: 8 requests x 32 rows, each with its own snapshot, camera, scene and max_d
    per = N_BODIES // SERVE_BURST
    b = SyntheticBatchGenerator(num_scenes=ASSET_KW["num_scenes"], batches_per_epoch=1, seed=SEED + 52,
                                image_size=MODEL_KW["image_size"]).next_batch(SERVE_BURST)
    reqs = [{"batch": {k: b[k][i:i + 1] for k in ("xs", "cam_int", "cam_ext", "max_d")}, "n_samples": per,
             "scene_idx": int(b["scene_idx"][i])} for i in range(SERVE_BURST)]
    results, launches, wall, _ = counted(kernels, lambda: eng.generate_coalesced(reqs, fit=True, eps=eps))
    check_launches("[serve] generate_coalesced(fit=True)", launches, want)
    out["launches_coalesced_fit"] = launches
    # the same call by hand: the engine's 16 slots (the unused ones zero images, identity intrinsics, max_d 6)
    R = SERVE_MAX_REQUESTS
    xs_stack = np.zeros((R,) + b["xs"].shape[1:], np.float32)
    cam_int_stack = np.tile(np.eye(3, dtype=np.float32)[None], (R, 1, 1))
    max_d_stack = np.full((R,), 6.0, np.float32)
    xs_stack[:SERVE_BURST], cam_int_stack[:SERVE_BURST], max_d_stack[:SERVE_BURST] = b["xs"], b["cam_int"], b["max_d"]
    req_idx = np.repeat(np.arange(SERVE_BURST), per)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    rows = make_generate_fit_rows(model, assets, cfg, want_metrics=False)
    x_rows, _, _ = rows(to(xs_stack), to(cam_int_stack), to(max_d_stack), to(req_idx), to(b["cam_ext"][req_idx]),
                        to(b["scene_idx"][req_idx].astype(np.int64)), eps=eps)
    got = np.concatenate([r.bodies for r in results])
    same_rows = np.array_equal(got, x_rows.cpu().numpy())
    log(f"[serve] generate_coalesced(fit=True), {SERVE_BURST} requests x {per} rows, {SERVE_BURST} snapshots: "
        f"{results[0].latency_s:.4f} s ({N_BODIES / results[0].latency_s:.2f} bodies/s), launches {launches}; equal in bits to "
        f"make_generate_fit_rows on the same latents: {same_rows}")
    if not (same_rows and all(r.bodies.shape == (per, 72) and r.batch_size == SERVE_BURST and r.fitted for r in results)):
        raise AssertionError("[serve] the coalesced call is not make_generate_fit_rows'")
    ragged = (5, 7, 11)
    few = eng.generate_coalesced([dict(r, n_samples=n) for r, n in zip(reqs, ragged)], fit=True)
    finite = all(np.isfinite(r.bodies).all() for r in few)
    log(f"[serve] generate_coalesced(fit=True) of {ragged} rows ({N_BODIES - sum(ragged)} padding rows): shapes "
        f"{[r.bodies.shape for r in few]}, every returned row finite: {finite}; {few[0].latency_s:.4f} s")
    if not (finite and [r.bodies.shape for r in few] == [(n, 72) for n in ragged] and all(r.batch_size == 3 for r in few)):
        raise AssertionError("[serve] the ragged coalesced call returned other rows than it was asked for")
    out.update(coalesced_fit_s=results[0].latency_s, coalesced_fit_bit_equal=same_rows, ragged_fit_s=few[0].latency_s)

    # ---- the queue: 8 clients, one 32-row fitted request each, inside one linger window
    def together(fns):
        """Each fn in its own thread, released at once; their results in order."""
        gate, got = threading.Barrier(len(fns)), [None] * len(fns)

        def work(i):
            gate.wait(60)
            got[i] = fns[i]()

        threads = [threading.Thread(target=work, args=(i,)) for i in range(len(fns))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        return got

    q = ServingQueue(eng, linger_s=SERVE_LINGER_S)
    burst = together([lambda r=r: q.submit(r["batch"], n_samples=per, fit=True, scene_idx=r["scene_idx"]).result(timeout=300)
                      for r in reqs])
    q.stop()
    stats = q.stats()
    log(f"[serve] ServingQueue, {SERVE_BURST} threads x one {per}-row fitted request, linger {SERVE_LINGER_S} s: "
        f"{stats['batches']} program calls for {stats['requests']} requests, batch sizes {[r.batch_size for r in burst]}; "
        f"latency p50 {stats['latency_p50_s']:.4f} s p99 {stats['latency_p99_s']:.4f} s (linger included; a single request "
        f"alone {single_fit_s:.4f} s)")
    if not (stats["requests"] == SERVE_BURST and stats["batches"] < SERVE_BURST and any(r.batch_size > 1 for r in burst)
            and stats["latency_p50_s"] <= stats["latency_p99_s"]
            and all(r.bodies.shape == (per, 72) and np.isfinite(r.bodies).all() for r in burst)):
        raise AssertionError(f"[serve] the burst did not coalesce: {stats}")
    out["burst"] = {"batches": stats["batches"], "batch_sizes": [r.batch_size for r in burst],
                    "p50_s": stats["latency_p50_s"], "p99_s": stats["latency_p99_s"]}

    # ---- concurrent equals serial: s1 and s2 each serve one full population at the same moment
    seeds = {"s1": SEED + 60, "s2": SEED + 61}
    full = {mt: reqs[i] for i, mt in enumerate(models)}
    router = ServingRouter({mt: engine(mt, seeds[mt]) for mt in models}, linger_s=0.005)
    t0 = time.time()
    conc = together([lambda mt=mt: router.submit(full[mt]["batch"], n_samples=None, fit=True, scene_idx=full[mt]["scene_idx"],
                                                 model=mt).result(timeout=300) for mt in models])
    conc_s = time.time() - t0
    router.stop()
    serial, serial_s = [], 0.0
    for mt in models:
        sq = ServingQueue(engine(mt, seeds[mt]), linger_s=0.005)
        t0 = time.time()
        serial.append(sq.submit(full[mt]["batch"], n_samples=None, fit=True, scene_idx=full[mt]["scene_idx"]).result(timeout=300))
        serial_s += time.time() - t0
        sq.stop()
    equal = [np.array_equal(a.bodies, c.bodies) for a, c in zip(conc, serial)]
    diffs = [float(np.abs(a.bodies - c.bodies).max()) for a, c in zip(conc, serial)]
    tf32_after = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    with strict_f32():
        inside = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    log(f"[serve] ServingRouter, s1 and s2 each one {N_BODIES}-row fitted request at the same moment: {conc_s:.4f} s for both "
        f"(one after the other on fresh engines with the same seeds: {serial_s:.4f} s); bodies equal in bits {equal} "
        f"(max |diff| {diffs}); TF32 flags (matmul, cuDNN) before the phase {tf32_before}, after {tf32_after}, inside "
        f"strict_f32 {inside}")
    if not (all(equal) and tf32_after == tf32_before and inside == (False, False)
            and all(r.bodies.shape == (N_BODIES, 72) and r.batch_size == 1 for r in conc)):
        raise AssertionError("[serve] two models served at once differ from the same two served in turn, or TF32 leaked")
    out["concurrent"] = {"concurrent_s": conc_s, "serial_s": serial_s, "bit_equal": equal, "tf32": list(tf32_after)}

    # ---- a short soak
    soak = soak_serve.run(eng, duration=SERVE_SOAK_S, storm=SERVE_STORM, bucket_s=SERVE_BUCKET_S,
                          log=lambda m: log(f"[serve soak] {m}"))
    grew_idle = soak["device_after_mb"]["allocated"] - soak["device_before_mb"]["allocated"]
    held = [b["device_mb"] for b in soak["buckets"] if b["device_mb"] is not None]  # the drain's bucket may have no reading
    grew_buckets = held[-1] - held[0]
    log(f"[serve] soak {soak['wall_s']:.1f} s: {soak['requests']} requests, {soak['errors']} errors, {soak['rows']} bodies "
        f"({soak['bodies_per_s']:.2f} bodies/s served), {soak['requests_per_batch']:.2f} requests a program call; p50 "
        f"{soak['p50_ms']:.1f} ms p99 {soak['p99_ms']:.1f} ms (fitted {soak['fit_p50_ms']:.1f} / {soak['fit_p99_ms']:.1f}, "
        f"generate-only {soak['gen_p50_ms']:.1f} / {soak['gen_p99_ms']:.1f}); storm {soak['storm']}; device memory between "
        f"programs: first bucket {held[0]:.2f} MB, last {held[-1]:.2f} MB "
        f"({grew_buckets:+.2f}); idle before {soak['device_before_mb']['allocated']:.2f} MB, after "
        f"{soak['device_after_mb']['allocated']:.2f} MB ({grew_idle:+.2f}; tol {SERVE_MEM_TOL_MB}); on {smi}")
    if not (soak["errors"] == 0 and soak["storm"] == {"malformed": SERVE_STORM, "failed_cleanly": SERVE_STORM,
                                                       "post_storm_ok": True}
            and soak["requests"] > 0 and grew_idle <= SERVE_MEM_TOL_MB and grew_buckets <= SERVE_MEM_TOL_MB):
        raise AssertionError(f"[serve] the soak failed: errors {soak['errors_sample']}, storm {soak['storm']}, device memory "
                             f"{grew_idle:+.2f} / {grew_buckets:+.2f} MB")
    out["soak"] = soak

    # ---- the CLI as a child process
    workdir = Path(tempfile.mkdtemp(prefix="chip_smoke_serve_"))
    try:
        lines = "\n".join([json.dumps({"id": "big", "n_samples": SERVE_CLI_BODIES, "fit": True}),
                           json.dumps({"id": "small", "n_samples": 32}), "stats", "quit"]) + "\n"
        t0 = time.time()
        child = subprocess.run([sys.executable, "-m", "psi_tpu_torch.cli.serve", "--synthetic", "--population", str(N_BODIES),
                                "--out_dir", str(workdir / "out")], input=lines, capture_output=True, text=True,
                               cwd=ROOT, timeout=600)
        cli_s = time.time() - t0
        if child.returncode != 0:
            raise AssertionError(f"[serve] the CLI exited with {child.returncode}: {child.stderr[-2000:]}")
        recs = [json.loads(l) for l in child.stdout.strip().splitlines()]
        ready, closing = recs[0], recs[-1]
        chunks = [r for r in recs if r.get("id") == "big"]
        small = [r for r in recs if r.get("id") == "small"]
        sizes = [N_BODIES] * (SERVE_CLI_BODIES // N_BODIES) + [SERVE_CLI_BODIES % N_BODIES]
        shapes = [np.load(r["out"]).shape for r in chunks + small]
        log(f"[serve] python3 -m psi_tpu_torch.cli.serve --synthetic --population {N_BODIES} as a child process, {cli_s:.1f} s in "
            f"all: ready after warmup {ready.get('warmup_s')} s ({ready.get('warmup_programs')}); a fitted request of "
            f"{SERVE_CLI_BODIES} bodies in chunks {[r.get('n') for r in chunks]} at {[r.get('latency_s') for r in chunks]} s, final "
            f"{[r.get('final') for r in chunks]}; 32 generate-only bodies at {[r.get('latency_s') for r in small]} s; files "
            f"{shapes}; closing stats {closing}")
        if not (ready.get("status") == "ready" and ready["models"] == ["s1"] and not any("error" in r for r in recs)
                and [r["n"] for r in chunks] == sizes and [r["chunk"] for r in chunks] == list(range(len(sizes)))
                and [r["final"] for r in chunks] == [False] * (len(sizes) - 1) + [True]
                and all(r["n_chunks"] == len(sizes) for r in chunks)
                and shapes == [(n, 72) for n in sizes] + [(32, 72)]
                and sum("stats" in r for r in recs) == 2 and closing["stats"]["requests"] == len(sizes) + 1
                and all(np.isfinite(np.load(r["out"])).all() for r in chunks + small)):
            raise AssertionError(f"[serve] the CLI's records are not the expected ones: {recs}")
        out["cli"] = {"wall_s": cli_s, "warmup_s": ready["warmup_s"], "chunk_latency_s": [r["latency_s"] for r in chunks],
                      "generate_latency_s": small[0]["latency_s"], "stats": closing["stats"]}
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    # ---- what every fitted call rebuilds (fit/fitting.py builds the bundle inside the fit)
    with strict_f32(), torch.no_grad():
        bundle_ms = cuda_ms(lambda: make_fused_bundle(assets.smplx))
    out["make_fused_bundle_ms"] = bundle_ms
    log(f"[serve] make_fused_bundle, rebuilt by every fitted call: {bundle_ms:.4f} ms a call, {100 * bundle_ms / 1e3 / single_fit_s:.2f}% "
        f"of the single fitted request's {single_fit_s:.4f} s; on {smi}")
    return out


CLI_TRAIN_BATCHES = 2  # batches an epoch of cli.train_s1 --synthetic; it trains two epochs
CLI_SNAPSHOT_HW = (424, 512)  # depth/seg maps of the .mat snapshots, written here
CLI_HABITAT_ROOMS = 2  # rooms of MP3D_ROOMS with written sensor dumps
CLI_HABITAT_CAMS = 2  # cameras a room
CLI_HABITAT_SAMPLES = 64  # bodies a camera: cli.test_habitat's default is 200
CLI_HABITAT_HW = (480, 640)


def write_cli_inputs(root: Path, rng):
    """The files the entry points read, in the reference's formats: a PROX-E
    ``snapshot_for_testing/<scene>_00/rec_000000.mat`` for each test scene
    (scipy.io.savemat: raw depth and seg maps, the cam struct, a fitted
    body) and Habitat ``cam_/depth_/seg_*.npy`` dumps (cam_*.npy a pickled
    dict) for CLI_HABITAT_ROOMS rooms. Returns (proxe_root, dump_root)."""
    import numpy as np
    import scipy.io

    from psi_tpu_torch.cli.fitting import MP3D_ROOMS
    from psi_tpu_torch.data.hdf5 import PROX_TEST_SCENES

    proxe_root, dump_root = root / "proxe", root / "habitat_dumps"
    for scene in PROX_TEST_SCENES:
        d = proxe_root / "snapshot_for_testing" / f"{scene}_00"
        d.mkdir(parents=True)
        h, w = CLI_SNAPSHOT_HW
        ext = np.eye(4)
        ext[:3, 3] = rng.uniform(-1.0, 1.0, 3)
        body = {k: rng.normal(0.0, 0.3, (1, n)).astype(np.float32) for k, n in (
            ("transl", 3), ("global_orient", 3), ("betas", 10), ("body_pose", 32),
            ("left_hand_pose", 12), ("right_hand_pose", 12))}
        scipy.io.savemat(str(d / "rec_000000.mat"), {
            "depth": rng.uniform(0.5, 8.0, (h, w)).astype(np.float32),
            "seg": rng.integers(0, 42, (h, w)).astype(np.float32),
            "cam": {"intrinsic": np.array([[500.0, 0, w / 2], [0, 500.0, h / 2], [0, 0, 1]]), "extrinsic": ext},
            "body": body})
    for room in MP3D_ROOMS[:CLI_HABITAT_ROOMS]:
        d = dump_root / room
        d.mkdir(parents=True)
        h, w = CLI_HABITAT_HW
        for i in range(CLI_HABITAT_CAMS):
            cam_ext = np.eye(4, dtype=np.float32)
            cam_ext[:3, 3] = rng.uniform(-1.0, 1.0, 3)
            f = max(h, w) / 2.0
            cam_int = np.array([[f, 0, w / 2.0], [0, f, h / 2.0], [0, 0, 1.0]], np.float32)
            np.save(d / f"depth_{i}.npy", rng.uniform(0.5, 8.0, (h, w)).astype(np.float32))
            np.save(d / f"seg_{i}.npy", rng.integers(0, 42, (h, w)).astype(np.int32))
            np.save(d / f"cam_{i}.npy", {"cam_ext": cam_ext, "cam_int": cam_int})
    return proxe_root, dump_root


def read_pickles(folder: Path) -> dict:
    """Every body_gen_*.pkl under ``folder``, by its path relative to it."""
    import pickle

    recs = {}
    for p in sorted(folder.rglob("body_gen_*.pkl")):
        with open(p, "rb") as f:
            recs[str(p.relative_to(folder))] = pickle.load(f)
    return recs


def same_bits_records(a: dict, b: dict) -> bool:
    """The same files, each with the same keys and equal arrays."""
    import numpy as np

    return a.keys() == b.keys() and all(
        a[n].keys() == b[n].keys() and all(np.array_equal(a[n][k], b[n][k]) for k in a[n]) for n in a)


def check_cli(dev, kernels, smi: str):
    """Phase 16: the reference's entry points, each through its ``main(argv)``
    in this process (so that the launch counts can be read around it), with
    no --device: the card. train_s1 -> test_proxe_s1 -> fitting_proxe -> eval,
    then test_habitat -> fitting_habitat -> eval, then fitting_proxe as a
    child process. Returns the phase's record."""
    import argparse
    import contextlib
    import io
    import math
    import re

    import numpy as np
    import torch

    from psi_tpu_torch.cli import eval as cli_eval
    from psi_tpu_torch.cli import fitting_habitat, fitting_proxe, test_habitat, test_proxe_s1, train_s1
    from psi_tpu_torch.cli.common import build_assets
    from psi_tpu_torch.cli.fitting import MP3D_ROOMS
    from psi_tpu_torch.data.hdf5 import PROX_TEST_SCENES
    from psi_tpu_torch.fit.fitting import FittingOP
    from psi_tpu_torch.train.checkpoint import save_checkpoint
    from psi_tpu_torch.train.loop import init_state
    from psi_tpu_torch.utils.config import FitConfig, TrainConfig

    t_phase = time.time()
    out = {"wall_s": {}, "launches": {}}

    def run(name, fn, argv):
        """fn(argv) with the counts set to 0 just before and read just after;
        returns its standard output."""
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            _, launches, wall, _ = counted(kernels, lambda: fn(argv))
        out["wall_s"][name], out["launches"][name] = wall, launches
        log(f"[cli] {name} {' '.join(argv)}: {wall:.2f} s, launches {launches}")
        return buf.getvalue()

    read_dir, same_bits = read_pickles, same_bits_records

    def scores(text: str):
        return {k: float(v) for k, v in re.findall(r"(\w+)=(-?[\d.]+|nan|inf)", text)}

    workdir = Path(tempfile.mkdtemp(prefix="chip_smoke_cli_"))
    try:
        proxe_root, dump_root = write_cli_inputs(workdir, np.random.default_rng(SEED + 60))
        ckpt, gen, fit, direct = (workdir / n for n in ("ckpt", "gen", "fit", "direct"))

        # ---- train_s1 --synthetic: the gates open as open_gates_config opens them (a checkpoint of the
        # initial state marked epoch 8 of 10: epochs 9 and 10 are past 0.75 * 10, so f_scene = 1 and
        # fca = 1), and the end of epoch 10 is TrainConfig's saving_per_epochs: a checkpoint is written
        save_checkpoint(str(ckpt), 8, init_state(TrainConfig(model_type="s1", seed=SEED), dev))
        run("train_s1", train_s1.main, ["--synthetic", "--save_dir", str(ckpt), "--num_epoch", "10",
                                        "--synthetic_batches", str(CLI_TRAIN_BATCHES)])
        steps = 2 * CLI_TRAIN_BATCHES
        rows = read_metrics(str(ckpt))
        if not ((ckpt / "epoch-000010.ckp").exists() and len(rows) == steps
                and all(math.isfinite(v) for r in rows for v in r.values())):
            raise AssertionError(f"[cli] train_s1 wrote no epoch-10 checkpoint or not {steps} finite steps: {rows}")
        if out["launches"]["train_s1"][kernels[2].name] != steps:
            raise AssertionError(f"[cli] train_s1 launched K3 {out['launches']['train_s1']} times in {steps} steps")

        # ---- test_proxe_s1 from that checkpoint, on the .mat snapshots
        run("test_proxe_s1", test_proxe_s1.main, ["--ckpt_dir", str(ckpt), "--proxe_path", str(proxe_root),
                                                  "--output_dir", str(gen)])
        n_gen = len(read_dir(gen))
        if n_gen != 300 * len(PROX_TEST_SCENES):
            raise AssertionError(f"[cli] test_proxe_s1 wrote {n_gen} pickles")

        # ---- fitting_proxe, then FittingOP.fitting_files on the same files: equal bits and counts
        text = run("fitting_proxe", fitting_proxe.main, [str(gen), str(fit), "--synthetic"])
        fitted = read_dir(fit)
        args = argparse.Namespace(synthetic=True, proxe_path=None, device=None)
        assets, registry = build_assets(args, sdf_dtype=torch.bfloat16, device=dev)
        cfg = FitConfig(init_lr_h=0.1, num_iter=20, contact_denom_offset=0.01, weight_loss_rec=1.0,
                        weight_loss_vposer=0.01, weight_contact=0.1, weight_collision=0.5, refresh_every=10,
                        lbs_precision="fused", prune_scene_points=2048)

        def fit_directly():
            for si, scene in enumerate(PROX_TEST_SCENES):
                FittingOP(assets, cfg, scene_idx=si % registry.num_scenes).fitting_files(
                    str(gen / scene), str(direct / scene))

        _, direct_launches, direct_s, _ = counted(kernels, fit_directly)
        equal = same_bits(fitted, read_dir(direct))
        log(f"[cli] FittingOP.fitting_files on the same files: {direct_s:.2f} s, launches {direct_launches}; "
            f"{len(fitted)} fitted pickles, equal in bits to the CLI's: {equal}; {text.strip().splitlines()[-1]}")
        if not (len(fitted) == n_gen and equal and direct_launches == out["launches"]["fitting_proxe"]):
            raise AssertionError(f"[cli] fitting_proxe differs from FittingOP.fitting_files: {len(fitted)} files, "
                                 f"equal bits {equal}, launches {out['launches']['fitting_proxe']} vs {direct_launches}")
        if not all(v > 0 for v in out["launches"]["fitting_proxe"].values()):
            raise AssertionError(f"[cli] fitting_proxe did not launch every kernel: {out['launches']['fitting_proxe']}")
        if not all(np.isfinite(v).all() for r in fitted.values() for v in r.values()):
            raise AssertionError("[cli] a fitted pickle is not finite")

        # ---- eval on the fitted files
        div = scores(run("eval_diversity", cli_eval.main, ["--results_dir", str(fit), "--mode", "diversity"]))
        col = scores(run("eval_collision", cli_eval.main, ["--results_dir", str(fit), "--mode", "collision",
                                                           "--synthetic"]))

        # ---- the Habitat path on written sensor dumps, fewer bodies a camera than the default
        log(f"[cli] test_habitat at --n_samples {CLI_HABITAT_SAMPLES} (default 200) over {CLI_HABITAT_ROOMS} rooms x "
            f"{CLI_HABITAT_CAMS} cameras, to keep the phase short")
        hab_gen, hab_fit = workdir / "hab_gen", workdir / "hab_fit"
        run("test_habitat", test_habitat.main, ["--dump_root", str(dump_root), "--output_dir", str(hab_gen),
                                                "--n_samples", str(CLI_HABITAT_SAMPLES)])
        run("fitting_habitat", fitting_habitat.main, [str(hab_gen), str(hab_fit), "--synthetic"])
        hab = read_dir(hab_fit)
        per_room = CLI_HABITAT_CAMS * CLI_HABITAT_SAMPLES
        names = sorted(hab)
        if not (len(hab) == CLI_HABITAT_ROOMS * per_room and names[0] == f"{MP3D_ROOMS[0]}/body_gen_000000.pkl"
                and names[per_room - 1] == f"{MP3D_ROOMS[0]}/body_gen_{per_room - 1:06d}.pkl"
                and all(np.isfinite(v).all() for r in hab.values() for v in r.values())):
            raise AssertionError(f"[cli] the habitat path fitted {len(hab)} pickles: {names[:2]} ... {names[-2:]}")
        hab_col = scores(run("eval_collision_habitat", cli_eval.main, [
            "--results_dir", str(hab_fit), "--mode", "collision", "--dataset", "habitat", "--synthetic"]))

        # ---- the -m entry as a child process, on the card
        t0 = time.time()
        child = subprocess.run([sys.executable, "-m", "psi_tpu_torch.cli.fitting_proxe", str(gen),
                                str(workdir / "fit_child"), "--synthetic"], capture_output=True, text=True,
                               cwd=ROOT, timeout=600)
        out["wall_s"]["fitting_proxe_child"] = time.time() - t0
        if child.returncode != 0:
            raise AssertionError(f"[cli] python -m psi_tpu_torch.cli.fitting_proxe exited {child.returncode}: "
                                 f"{child.stderr[-2000:]}")
        child_fit = read_dir(workdir / "fit_child")
        child_equal = same_bits(child_fit, fitted)
        log(f"[cli] python -m psi_tpu_torch.cli.fitting_proxe as a child process: "
            f"{out['wall_s']['fitting_proxe_child']:.2f} s, {len(child_fit)} pickles, equal in bits to the in-process "
            f"CLI's: {child_equal}; {child.stdout.strip().splitlines()[-1]}")
        if len(child_fit) != n_gen or not all(np.isfinite(v).all() for r in child_fit.values() for v in r.values()):
            raise AssertionError(f"[cli] the child process fitted {len(child_fit)} pickles or not finite ones")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    values = {**div, **col, **{f"habitat_{k}": v for k, v in hab_col.items()}}
    out.update(scores=values, child_equal_bits=child_equal, direct_launches=direct_launches, direct_s=direct_s)
    out["phase_s"] = time.time() - t_phase
    log(f"[cli] scores {values}; phase {out['phase_s']:.1f} s; on {smi}")
    if not (len(values) == 6 and all(math.isfinite(v) for v in values.values())):
        raise AssertionError(f"[cli] scores missing or not finite: {values}")
    return out


NATIVE_BATCHES = 4  # batches of TrainConfig().batch_size in the pack: one epoch
NATIVE_METRIC_REL_TOL = TRAIN_RESUME_REL_TOL  # the same step twice in one process: only cuDNN's choice may differ
# chamfer_nn_cpu vs K3: both evaluate (dx^2 + dy^2) + dz^2 in f32; a tie may pick another index, never
#     another distance beyond f32 rounding of metre-scale coordinates
NATIVE_DIST_TOL = 1e-5


class _Recording:
    """A batch generator that keeps every batch it hands out."""

    def __init__(self, gen):
        self.gen, self.served = gen, []

    def has_next_batch(self):
        return self.gen.has_next_batch()

    def next_batch(self, batch_size):
        b = self.gen.next_batch(batch_size)
        if b is not None:
            self.served.append(b)
        return b

    def reset(self):
        self.gen.reset()


def check_native(dev, assets, contact, y_pruned, smi: str, workdir: Path):
    """Phase 17: the native batch loader in front of TrainOP; returns its record."""
    import math

    import numpy as np
    import torch

    from psi_tpu_torch.data import native_loader as nl
    from psi_tpu_torch.data.synthetic import SyntheticBatchGenerator
    from psi_tpu_torch.ops.chamfer import NN_ARGMIN, nn_argmin
    from psi_tpu_torch.train.checkpoint import save_checkpoint
    from psi_tpu_torch.train.loop import TrainOP, _stage_chunk, init_state, make_train_step
    from psi_tpu_torch.utils.config import LossConfig, TrainConfig

    out = {}
    out["built_here"] = not nl.library_path().exists()
    t0 = time.time()
    lib_path = nl.build_library()
    nl.get_lib()
    out["build_s"] = time.time() - t0
    log(f"[native] {'g++ built and loaded' if out['built_here'] else 'loaded the already built'} {lib_path.name} "
        f"in {out['build_s']:.2f} s")

    # chamfer_nn_cpu, the host twin, against K3 at the fit's shape for one body
    x, y = contact[:1].contiguous(), y_pruned[:1].contiguous()
    ik = nn_argmin(x, y)[0].cpu().numpy()
    xh, yh = x[0].cpu().numpy(), y[0].cpu().numpy()
    dh, ih = nl.chamfer_nn_cpu(xh, yh)
    e = xh - yh[ik]
    dk = (e[:, 0] * e[:, 0] + e[:, 1] * e[:, 1]) + e[:, 2] * e[:, 2]
    out["chamfer_max_abs_err"] = float(np.abs(dk - dh).max())
    out["chamfer_index_agree"] = float((ik == ih).mean())
    log(f"[native] chamfer_nn_cpu vs K3 at {tuple(x.shape[:2]) + (y.shape[1],)}: squared distances max abs diff "
        f"{out['chamfer_max_abs_err']:.3e} (tol {NATIVE_DIST_TOL}), indices equal for "
        f"{100 * out['chamfer_index_agree']:.2f}%")
    if not out["chamfer_max_abs_err"] <= NATIVE_DIST_TOL:
        raise AssertionError("[native] chamfer_nn_cpu and K3 disagree")

    # the reference HDF5's streams (row 0 a placeholder, then the samples), packed as hdf5_to_pack packs
    # what data/hdf5.py::_load_streams reads from such a file (rows 1..n); the HDF5 file itself is written
    # and read, and its pack held to psi_tpu's, by tests/test_torch_native_loader.py, where h5py is installed
    cfg = TrainConfig(model_type="s1", epoch=9, save_dir=str(workdir / "native_run"), saving_per_epochs=100,
                      verbose=False, seed=SEED)
    n = NATIVE_BATCHES * cfg.batch_size
    gen = SyntheticBatchGenerator(num_scenes=ASSET_KW["num_scenes"], batches_per_epoch=1, seed=SEED + 30,
                                  image_size=MODEL_KW["image_size"])
    src = gen.next_batch(n + 1)
    rows = {k: v[1:] for k, v in src.items()}
    t0 = time.time()
    pack = nl.pack_dataset(str(workdir / "train.psipack"), rows["xs"][..., 0], rows["xs"][..., 1], rows["xh"],
                           rows["cam_ext"], rows["cam_int"], rows["max_d"], rows["scene_idx"])
    out["pack_s"] = time.time() - t0
    loader = _Recording(nl.NativeBatchGenerator(pack, cfg.batch_size, seed=SEED))

    # one epoch with both gates open: resume a checkpoint of the initial state marked epoch 8 of 9
    save_checkpoint(cfg.save_dir, 8, init_state(cfg, dev))
    op = TrainOP(cfg, LossConfig(), assets)  # no device given: the card
    step_ms, inner = [], op.epoch_fn

    def timed(*args):
        torch.cuda.synchronize()
        t = time.time()
        res = inner(*args)
        torch.cuda.synchronize()
        step_ms.append((time.time() - t) * 1e3)
        return res

    op.epoch_fn = timed
    torch.cuda.synchronize()
    NN_ARGMIN.launches = 0
    t0 = time.time()
    op.train(loader)
    torch.cuda.synchronize()
    out["epoch_s"] = time.time() - t0
    out["k3_launches"] = NN_ARGMIN.launches
    logged = read_metrics(cfg.save_dir)
    loader.gen.close()
    M = assets.scene_verts.shape[1]
    if len(logged) != NATIVE_BATCHES or not all(math.isfinite(v) for r in logged for v in r.values()):
        raise AssertionError(f"[native] expected {NATIVE_BATCHES} finite metric rows: {logged}")
    if out["k3_launches"] != NATIVE_BATCHES or M != ASSET_KW["scene_points"]:
        raise AssertionError(f"[native] K3 launched {out['k3_launches']} times in {NATIVE_BATCHES} steps at M={M}")
    # every sample exactly once: each served body row is one of the pack's, and all of them appear
    index = {r.tobytes(): i for i, r in enumerate(rows["xh"])}
    served = [index[r.tobytes()] for b in loader.served for r in b["xh"]]
    if sorted(served) != list(range(n)):
        raise AssertionError("[native] the epoch did not serve every sample exactly once")
    # the first batch as the arrays hold it, in the loader's order, through the same step from the same state
    first = [index[r.tobytes()] for r in loader.served[0]["xh"]]
    direct = {k: v[first] for k, v in rows.items()}
    for k, v in loader.served[0].items():
        if not np.array_equal(v, direct[k].astype(v.dtype)):
            raise AssertionError(f"[native] the loader's {k} differs from the arrays' rows")
    state = init_state(cfg, dev)
    step = make_train_step(assets, LossConfig(), cfg.model_type, cfg.grad_clip_norm)
    _, ref = step(state, {k: v[0] for k, v in _stage_chunk([direct], cfg.stage_bf16, dev).items()}, 1.0, 1.0)
    rel = max(abs(logged[0][k] - ref[k].item()) / max(abs(ref[k].item()), 1e-12) for k in ref)
    out.update(first_step_rel_diff=rel, step_ms=step_ms, median_step_ms=statistics.median(step_ms[1:]))
    log(f"[native] TrainOP s1 on the card from NativeBatchGenerator, batch {cfg.batch_size}, one epoch of {n} "
        f"samples (packed in {out['pack_s']:.3f} s): {len(logged)} steps, every metric finite, each sample served "
        f"once, K3 {out['k3_launches']} launches at M={M}; loss {logged[0]['loss']:.6f} -> {logged[-1]['loss']:.6f}; "
        f"first step's metrics vs the same rows from the arrays through make_train_step: max rel diff {rel:.3e} "
        f"(tol {NATIVE_METRIC_REL_TOL}); {out['epoch_s']:.3f} s for the epoch, steps "
        f"{', '.join(f'{t:.2f}' for t in step_ms)} ms (median after the first {out['median_step_ms']:.3f} ms); "
        f"library build {out['build_s']:.2f} s; on {smi}")
    if not rel <= NATIVE_METRIC_REL_TOL:
        raise AssertionError("[native] the first step's metrics differ from the same batch's")
    return out


DIST_TIMEOUT_S = 300  # both ranks of phase 18, from start to results; past it the phase fails
DIST_REPS = 2  # runs of each call on the two ranks: the first in a fresh process pays its warm-up
DIST_TRAIN_REL_TOL = 1e-5  # world size 1: gradients of the same step, only the backward's atomics may differ
# two ranks: tests/test_multichip.py's bounds for the same comparison
DIST_LOSS_REL_TOL, DIST_GRAD_REL_TOL, DIST_BN_TOL = 1e-5, 5e-3, 1e-5


def _walls(walls) -> str:
    return f"{walls[0]:.3f} s first, then " + ", ".join(f"{w:.3f}" for w in walls[1:]) + " s"


def _grad_rel(a: dict, b: dict) -> float:
    import torch

    return max((torch.linalg.vector_norm((a[k] - b[k]).double()) /
                (torch.linalg.vector_norm(b[k].double()) + 1e-12)).item() for k in b)


def check_dist(dev, model, model_cpu, assets, assets_cpu, xs, cam_int, max_d, cam_ext, scene_idx, batch, kernels,
               want, own_mean: float, smi: str, workdir: Path):
    """Phase 18: the population-sharded fit, the sharded engine and data-parallel training, first over NCCL
    at world size 1 in this process, then over gloo on two worker processes sharing the card."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from psi_tpu_torch.data.synthetic import SyntheticBatchGenerator
    from psi_tpu_torch.fit.fitting import make_generate_fit_step
    from psi_tpu_torch.parallel.distributed import ensure_distributed
    from psi_tpu_torch.parallel.mesh import make_mesh
    from psi_tpu_torch.scripts import multiprocess_worker
    from psi_tpu_torch.serve import GenerationEngine
    from psi_tpu_torch.train.loop import TrainOP, _stage_chunk, init_state, make_train_step
    from psi_tpu_torch.utils.config import FitConfig, LossConfig, TrainConfig

    out = {}
    cfg = FitConfig.production(num_iter=NUM_ITER)
    tcfg = TrainConfig(model_type="s1", save_dir=str(workdir / "dist_train"), verbose=False, seed=SEED)
    eps = torch.randn((N_BODIES, model.eps_d), generator=torch.Generator().manual_seed(SEED + 60))
    eps_d = eps.to(dev)
    tbatch = SyntheticBatchGenerator(num_scenes=ASSET_KW["num_scenes"], batches_per_epoch=1, seed=SEED + 61,
                                     image_size=MODEL_KW["image_size"]).next_batch(tcfg.batch_size)
    staged = {k: v[0] for k, v in _stage_chunk([tbatch], False, dev).items()}
    snap = {k: batch[k] for k in ("xs", "cam_int", "max_d")}
    snap["cam_ext"] = cam_ext[:1].cpu().numpy()
    tol_mean = max(CROSS_MEAN_TOL, CROSS_SENS_FACTOR * own_mean)

    # ---- 1. NCCL, world size 1, on this card, in this process
    t0 = time.time()
    ensure_distributed(init_method=f"file://{workdir}/nccl_store", num_processes=1, process_id=0, device=dev)
    try:
        mesh = make_mesh(device=dev)
        if mesh.backend != "nccl" or mesh.size != 1:
            raise AssertionError(f"[dist] expected an NCCL group of 1, got {mesh}")
        plain = make_generate_fit_step(model, assets, cfg, N_BODIES, want_metrics=False)
        sharded = make_generate_fit_step(model, assets, cfg, N_BODIES, want_metrics=False, mesh=mesh)
        args = (xs, cam_int, max_d, cam_ext, scene_idx)
        (xu, _, hu), lu, wu, _ = counted(kernels, lambda: plain(*args, eps=eps_d))
        (xm, _, hm), lm, wm, _ = counted(kernels, lambda: sharded(*args, eps=eps_d))
        check_launches("[dist] NCCL world 1 generate+fit", lm, want)
        check_launches("[dist] unsharded generate+fit", lu, want)
        if not (torch.equal(xm, xu) and torch.equal(hm, hu)):
            raise AssertionError("[dist] NCCL world size 1: the sharded generate+fit is not the unsharded one in bits")

        def one_step(m):
            op = TrainOP(tcfg, LossConfig(), assets, mesh=m) if m is not None else TrainOP(tcfg, LossConfig(), assets)
            op.state, met = op.epoch_fn(op.state, {k: v[None] for k, v in staged.items()}, 1.0, 1.0)
            return {k: v[0] for k, v in met.items()}, {n: p.grad.clone() for n, p in op.model.named_parameters()}

        (mu, gu), (mu2, gu2), (mm, gm) = one_step(None), one_step(None), one_step(mesh)
        metrics_equal = all(torch.equal(mm[k], mu[k]) for k in mu)
        grads_equal = sum(torch.equal(gm[k], gu[k]) for k in gu)
        rel_m, rel_u = _grad_rel(gm, gu), _grad_rel(gu2, gu)
        out["nccl_world1"] = dict(launches=lm, fit_wall_s=wm, plain_fit_wall_s=wu, train_metrics_equal=metrics_equal,
                                  grads_equal=grads_equal, n_grads=len(gu), grad_rel=rel_m, grad_rel_unsharded_twice=rel_u,
                                  wall_s=time.time() - t0)
        log(f"[dist] NCCL, world size 1, cuda:0: generate+fit N={N_BODIES} equal in bits to the unsharded call "
            f"(bodies and loss history), launches {lm}; {wm:.4f} s vs {wu:.4f} s unsharded; TrainOP(mesh=) step at "
            f"batch {tcfg.batch_size}: metrics equal in bits {metrics_equal}, gradients equal in bits {grads_equal} of "
            f"{len(gu)}, largest relative difference {rel_m:.3e} (tol {DIST_TRAIN_REL_TOL}; two unsharded steps "
            f"{rel_u:.3e}: the backward sums with atomics); on {smi}")
        if not (metrics_equal and rel_m <= DIST_TRAIN_REL_TOL):
            raise AssertionError("[dist] NCCL world size 1: the TrainOP(mesh=) step differs from the unsharded one")
    finally:
        dist.destroy_process_group()

    # ---- 2. two ranks on this one card over gloo (NCCL refuses two ranks on one device)
    t0 = time.time()
    teps = torch.randn((tcfg.batch_size, model.eps_d), generator=torch.Generator().manual_seed(SEED + 63))
    cpu = lambda t: t.detach().cpu()
    spec_dir = workdir / "dist"
    spec_dir.mkdir()
    torch.save({"assets": assets_cpu, "model": model_cpu, "calls": [
        dict(name="genfit", kind="generate_fit_step", cfg=cfg, n=N_BODIES, want_metrics=False,
             args=tuple(cpu(a) for a in args), eps=eps, reps=DIST_REPS),
        dict(name="engine", kind="engine", population=N_BODIES, fit_cfg=cfg, seed=SEED + 62,
             requests=[("generate", dict(batch=snap, fit=True, scene_idx=0, eps=eps))], reps=DIST_REPS),
        dict(name="train", kind="train_steps", train_cfg=tcfg, loss_cfg=LossConfig(), batches=[tbatch], eps=[teps],
             reps=DIST_REPS),
    ]}, spec_dir / "fit_spec.pt")
    spec_s = time.time() - t0
    ranks = multiprocess_worker.spawn(spec_dir, "fit", 2, device=f"cuda:{dev.index}", backend="gloo",
                                      timeout_s=DIST_TIMEOUT_S)
    workers_s = time.time() - t0 - spec_s
    # the unsharded twins on the card, from the same inputs
    eng = GenerationEngine(model, assets, population=N_BODIES, fit_cfg=cfg, seed=SEED + 62)
    ref_engine = torch.from_numpy(eng.generate(snap, fit=True, scene_idx=0, eps=eps_d).bodies)
    state = init_state(tcfg, dev)
    _, ref_m = make_train_step(assets, LossConfig(), "s1")(state, staged, 1.0, 1.0, eps=teps.to(dev))
    ref_g = {n: p.grad.detach().cpu() for n, p in state.model.named_parameters()}
    ref_bn = {k: v.cpu() for k, v in state.model.state_dict().items() if "running_" in k}
    xu_c, hu_c = xu.cpu(), hu.cpu()
    parts = []
    for r, res in enumerate(ranks):
        g, e, t = res["genfit"], res["engine"], res["train"]
        check_launches(f"[dist] rank {r} generate+fit", g["launches"], want)
        check_launches(f"[dist] rank {r} engine request", e["launches"], want)
        check_launches(f"[dist] rank {r} train step", t["launches"], want_launches(kernels, 0, 0, 1))
        d = (g["x72"] - xu_c).abs()
        l0 = ((g["hist"][0] - hu_c[0]).abs() / hu_c[0].abs().clamp(min=1e-6)).max().item()
        de = (torch.from_numpy(e["requests"][0][0]) - ref_engine).abs()
        loss_rel = abs(t["metrics"][0]["loss"].item() - ref_m["loss"].item()) / abs(ref_m["loss"].item())
        g_rel = _grad_rel(t["grads"], ref_g)
        bn = max(((t["state_dict"][k] - v).abs() / (1 + v.abs())).max().item() for k, v in ref_bn.items())
        parts.append(dict(fit_mean=d.mean().item(), fit_max=d.max().item(), iter0_rel=l0, engine_mean=de.mean().item(),
                          engine_max=de.max().item(), loss_rel=loss_rel, grad_rel=g_rel, bn_diff=bn,
                          launches={k: res[k]["launches"] for k in res}, walls_s={k: res[k]["walls_s"] for k in res}))
        p = parts[-1]
        if not (l0 <= CROSS_LOSS0_REL_TOL and p["fit_mean"] <= tol_mean and p["engine_mean"] <= tol_mean):
            raise AssertionError(f"[dist] rank {r}: the sharded fit drifts beyond the fit's own sensitivity: {p}")
        if not (loss_rel <= DIST_LOSS_REL_TOL and g_rel <= DIST_GRAD_REL_TOL and bn <= DIST_BN_TOL):
            raise AssertionError(f"[dist] rank {r}: the data-parallel step differs from the unsharded one: {p}")
    if not torch.equal(ranks[0]["genfit"]["x72"], ranks[1]["genfit"]["x72"]):
        raise AssertionError("[dist] the two ranks returned different populations")
    out["gloo_two_ranks"] = dict(ranks=parts, spec_s=spec_s, workers_s=workers_s, wall_s=time.time() - t0,
                                 tol_mean=tol_mean)
    for r, p in enumerate(parts):
        log(f"[dist] gloo rank {r} of 2 on cuda:{dev.index}: generate+fit N={N_BODIES} ({N_BODIES // 2} rows a rank) "
            f"launches {p['launches']['genfit']}, {_walls(p['walls_s']['genfit'])}; vs the unsharded call: iteration-0 "
            f"loss {p['iter0_rel']:.3e} relative (tol {CROSS_LOSS0_REL_TOL}), fitted x72 mean {p['fit_mean']:.3e} "
            f"(tol {tol_mean:.3e}: {CROSS_SENS_FACTOR} x the default's own drift for an input moved by "
            f"{CROSS_PERTURB}, [paths]) max {p['fit_max']:.3e}; GenerationEngine(mesh=) fitted request "
            f"{p['launches']['engine']}, {_walls(p['walls_s']['engine'])}, mean {p['engine_mean']:.3e} max "
            f"{p['engine_max']:.3e}; train step s1 batch {tcfg.batch_size} ({tcfg.batch_size // 2} a rank) "
            f"{_walls(p['walls_s']['train'])}: loss {p['loss_rel']:.3e} relative (tol {DIST_LOSS_REL_TOL}), largest "
            f"gradient relative norm {p['grad_rel']:.3e} (tol {DIST_GRAD_REL_TOL}), BatchNorm running statistics "
            f"{p['bn_diff']:.3e} (tol {DIST_BN_TOL})")
    log(f"[dist] two gloo ranks: spec written in {spec_s:.2f} s, both workers started, ran and returned in "
        f"{workers_s:.2f} s (the phase {out['gloo_two_ranks']['wall_s']:.2f} s); the two ranks share one card, so "
        f"no speed-up is measured or claimed; on {smi}")
    return out


VPOSER_BM_KW = dict(num_verts=10475, num_joints=55, seed=SEED)  # synthetic_smplx at SMPL-X's width
VPOSER_FRAMES = (8192, 1024)  # make_synthetic_amass: train frames; vald and test frames each
VPOSER_EPOCHS = 2
VPOSER_CROSS_BATCH = 16
VPOSER_LOSS_REL_TOL = 1e-4  # one step card vs CPU, same weights, noise and masks: the losses
VPOSER_PARAM_MEDIAN_TOL = 1e-5  # ... and the updated parameters' median relative difference (largest printed)
VPOSER_RELOAD_REL_TOL = 1e-3  # load_best replays the recorded best eval loss (scripts/vposer_scale_run.py)
VPOSER_HW = 256  # vis_results' and the timed rasterization's image side
VPOSER_RASTER_SHARE = 0.995  # pixels whose depth and label equal the CPU's
VPOSER_RASTER_MM = 1e-3 + 1e-6  # depth where both hit: within one 1-mm quantum


def _vposer_param_rels(a, b) -> list:
    import torch

    return [(torch.linalg.vector_norm((a[k] - b[k]).double()) / (torch.linalg.vector_norm(b[k].double()) + 1e-30)
             ).item() for k in b if b[k].is_floating_point()]


def check_vposer(dev, kernels, smi: str, workdir: Path):
    """Phase 19: the VPoser prior's trainer at full width, its snapshots, one step card vs CPU, the renderer
    behind vis_results, and the body-model untangler; returns its record."""
    import numpy as np
    import torch

    from psi_tpu_torch.body.body_model import BodyModelWithPoser
    from psi_tpu_torch.body.smplx_model import synthetic_smplx
    from psi_tpu_torch.body.vposer import vposer_decode
    from psi_tpu_torch.data.amass import make_synthetic_amass
    from psi_tpu_torch.nn import layers
    from psi_tpu_torch.ops.precision import SPLIT_BWD, SPLIT_FWD
    from psi_tpu_torch.scripts.profile_fit import _device_us, device_events
    from psi_tpu_torch.train.vposer_trainer import VPoserTrainConfig, VPoserTrainer
    from psi_tpu_torch.utils.convert_torch import load_vposer
    from psi_tpu_torch.utils.timing import cuda_ms
    from psi_tpu_torch.viz.render import rasterize_mesh

    out = {}
    t_phase = time.time()
    data = workdir / "amass"
    make_synthetic_amass(str(data), n_train=VPOSER_FRAMES[0], n_val=VPOSER_FRAMES[1], seed=SEED)
    bm = synthetic_smplx(**VPOSER_BM_KW)
    cfg = VPoserTrainConfig()
    torch.cuda.synchronize()
    for k in kernels:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    tr = VPoserTrainer(str(workdir / "vposer_work"), cfg, str(data), bm, logger=lambda text: None)  # the card

    # ---- training: evaluate, then perform_training(2), with each step timed and each evaluation kept
    step_ms, evals = [], []
    inner_step, inner_eval = tr._train_step, tr.evaluate

    def timed_step(*args, **kw):
        torch.cuda.synchronize()
        t = time.time()
        res = inner_step(*args, **kw)
        torch.cuda.synchronize()
        step_ms.append((time.time() - t) * 1e3)
        return res

    def kept_eval(split_name="vald"):
        evals.append(inner_eval(split_name))
        return evals[-1]

    tr._train_step, tr.evaluate = timed_step, kept_eval
    split = (SPLIT_FWD, SPLIT_BWD)
    for k in split:
        k.launches = 0
    t0 = time.time()
    tr.evaluate()
    best = tr.perform_training(VPOSER_EPOCHS)
    torch.cuda.synchronize()
    out["train_s"] = time.time() - t0
    out["split_launches_training"] = {k.name: k.launches for k in split}
    tr._train_step, tr.evaluate = inner_step, inner_eval
    out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    out["eval_loss_total"] = [e["loss_total"] for e in evals]
    out["eval"] = evals
    out["steps"] = len(step_ms)
    out["median_step_ms"] = statistics.median(step_ms[1:])
    out["steps_per_s"] = 1e3 / out["median_step_ms"]
    out["first_step_ms"] = step_ms[0]
    curve = out["eval_loss_total"]
    if len(curve) != VPOSER_EPOCHS + 1 or not all(np.isfinite(curve)) or not all(b < a for a, b in
                                                                                  zip(curve, curve[1:])):
        raise AssertionError(f"[vposer] the eval loss did not fall at every epoch: {curve}")
    if out["steps"] != VPOSER_EPOCHS * (VPOSER_FRAMES[0] // cfg.batch_size):
        raise AssertionError(f"[vposer] {out['steps']} steps in {VPOSER_EPOCHS} epochs")
    # a step decodes the batch twice at 'high' (the original, no gradient, and the reconstruction): K4 4 times,
    # K5 twice; an evaluation batch decodes twice without gradients
    eval_batches = len(evals) * (VPOSER_FRAMES[1] // cfg.batch_size)
    check_launches("[vposer] evaluate + perform_training", out["split_launches_training"],
                   {SPLIT_FWD.name: 4 * (out["steps"] + eval_batches), SPLIT_BWD.name: 2 * out["steps"]})

    # one step under the profiler: device launches and busy time
    batch = next(tr.ds_train.batches(cfg.batch_size, np.random.default_rng(SEED + 70)))
    pose = torch.from_numpy(batch).to(dev)
    tr._train_step(pose, tr.epochs_completed)  # warm
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        tr._train_step(pose, tr.epochs_completed)
        torch.cuda.synchronize()
        prof_ms = (time.time() - t0) * 1e3
    events = device_events(prof)
    busy_ms = sum(_device_us(e) for e in events) / 1e3
    if not busy_ms > 0:
        raise AssertionError("[vposer] the profiled step shows no device time")
    out.update(profiled_step_ms=prof_ms, busy_ms=busy_ms, busy_share=busy_ms / out["median_step_ms"],
               device_launches=sum(e.count for e in events),
               top=[{"name": e.key[:80], "ms": _device_us(e) / 1e3, "launches": e.count}
                    for e in sorted(events, key=_device_us, reverse=True)[:5]])
    log(f"[vposer] VPoserTrainer on the card at VPoserTrainConfig() (width {cfg.num_neurons}, latentD "
        f"{cfg.latentD}, {cfg.num_joints} joints, batch {cfg.batch_size}; body {VPOSER_BM_KW['num_verts']} verts, "
        f"{VPOSER_BM_KW['num_joints']} joints, 'high' LBS; {VPOSER_FRAMES[0]} / {VPOSER_FRAMES[1]} / "
        f"{VPOSER_FRAMES[1]} frames): eval loss_total {' -> '.join(f'{v:.4f}' for v in curve)} over "
        f"{VPOSER_EPOCHS} epochs (best {best:.4f}); {out['steps']} steps, first {out['first_step_ms']:.2f} ms, median "
        f"after it {out['median_step_ms']:.3f} ms ({out['steps_per_s']:.2f} steps/s); {out['train_s']:.2f} s in all; "
        f"peak device memory {out['peak_gb']:.4f} GB; on {smi}")
    log(f"[vposer] one profiled step: {prof_ms:.2f} ms, {out['device_launches']} device launches, device busy "
        f"{busy_ms:.3f} ms ({100 * out['busy_share']:.1f}% of the median step); largest: "
        + "; ".join(f"{t['name']} {t['ms']:.3f} ms x{t['launches']}" for t in out["top"]))

    # ---- reload: load_best replays the best eval loss; load_vposer decodes what the trainer's model decodes
    recorded = tr.best_loss_total
    tr.load_best()
    replay = tr.evaluate()["loss_total"]
    z = torch.randn((N_BODIES, cfg.latentD), generator=torch.Generator(device=dev).manual_seed(SEED + 71), device=dev)
    tr.model.eval()
    with torch.no_grad():
        loaded = load_vposer(str(workdir / "vposer_work")).to(dev)
        equal_bits = torch.equal(vposer_decode(loaded, z), vposer_decode(tr.model, z))
    rel = abs(replay - recorded) / max(1.0, abs(recorded))
    out.update(reload_recorded=recorded, reload_replay=replay, reload_rel=rel, load_vposer_equal_bits=equal_bits,
               snapshot=os.path.basename(tr.best_model_fname))
    log(f"[vposer] load_best {out['snapshot']}: recorded best {recorded:.6f}, replayed {replay:.6f} (rel "
        f"{rel:.3e}, tol {VPOSER_RELOAD_REL_TOL}); load_vposer(work_dir) decodes {N_BODIES} latents equal in bits "
        f"to the trainer's model in eval mode: {equal_bits}")
    if not (rel <= VPOSER_RELOAD_REL_TOL and equal_bits):
        raise AssertionError("[vposer] the best snapshot does not reload")

    # ---- one step at batch 16, card vs CPU: the same weights, injected noise and dropout masks
    small = dataclasses.replace(cfg, batch_size=VPOSER_CROSS_BATCH)
    state = {k: v.detach().cpu() for k, v in tr.model.state_dict().items()}
    g = torch.Generator().manual_seed(SEED + 72)
    eps = torch.randn((VPOSER_CROSS_BATCH, cfg.latentD), generator=g)
    masks = [torch.rand((VPOSER_CROSS_BATCH, cfg.num_neurons), generator=g) < 0.9 for _ in range(2)]
    cross_pose = torch.from_numpy(batch[:VPOSER_CROSS_BATCH])
    real_mask = layers.dropout_mask
    res = {}
    try:
        for name, d in (("cpu", torch.device("cpu")), ("cuda", dev)):
            feed = list(masks)
            layers.dropout_mask = lambda shape, keep, gen, device: feed.pop(0).to(device)
            t2 = VPoserTrainer(str(workdir / f"vposer_cross_{name}"), small, str(data), bm, logger=lambda text: None,
                               device=d)
            t2.model.load_state_dict(state)
            t2.epochs_completed = 1
            losses = t2._train_step(cross_pose.to(d), 1, eps=eps.to(d))
            if feed:
                raise AssertionError("[vposer] the step did not draw both dropout masks")
            res[name] = ({k: float(v) for k, v in losses.items()},
                         {k: v.detach().cpu() for k, v in t2.model.state_dict().items()})
    finally:
        layers.dropout_mask = real_mask
    loss_rel = max(abs(res["cuda"][0][k] - v) / max(abs(v), 1e-12) for k, v in res["cpu"][0].items())
    rels = _vposer_param_rels(res["cuda"][1], res["cpu"][1])
    out.update(cross_loss_rel=loss_rel, cross_param_median=statistics.median(rels), cross_param_max=max(rels),
               cross_losses=res["cpu"][0])
    log(f"[vposer] one step at batch {VPOSER_CROSS_BATCH}, card vs CPU, same weights, noise and dropout masks: "
        f"losses max rel diff {loss_rel:.3e} (tol {VPOSER_LOSS_REL_TOL}); updated parameters and statistics, "
        f"relative norm of the difference: median {out['cross_param_median']:.3e} (tol {VPOSER_PARAM_MEDIAN_TOL}), "
        f"largest {out['cross_param_max']:.3e}")
    if not (loss_rel <= VPOSER_LOSS_REL_TOL and out["cross_param_median"] <= VPOSER_PARAM_MEDIAN_TOL):
        raise AssertionError("[vposer] the card's step differs from the CPU's")

    # ---- rendering: vis_results' grid, and one timed rasterization of the full body against the CPU's
    t0 = time.time()
    png = tr.vis_results(batch[:4], str(workdir / "vposer_vis.png"), n_show=4)
    out["vis_s"] = time.time() - t0
    if not (os.path.exists(png) and os.path.getsize(png) > 0):
        raise AssertionError("[vposer] vis_results wrote no PNG")
    with torch.no_grad():
        verts = tr._decode_mesh(pose[:1])[0] + torch.tensor([0.0, 0.0, 2.5], device=dev)
    f = 1.5 * VPOSER_HW
    cam = torch.tensor([[f, 0, VPOSER_HW / 2], [0, f, VPOSER_HW / 2], [0, 0, 1]], device=dev)
    labels = (torch.arange(verts.shape[0], device=dev) % 40) + 1
    faces = bm.faces.to(dev)
    raster = lambda v, fc, lb, c: rasterize_mesh(v, fc, lb, c, VPOSER_HW, VPOSER_HW)
    out["raster_ms"] = cuda_ms(lambda: raster(verts, faces, labels, cam), reps=5)
    dk, sk = (t.cpu() for t in raster(verts, faces, labels, cam))
    t0 = time.time()
    dc, sc = raster(verts.cpu(), faces.cpu(), labels.cpu(), cam.cpu())
    out["raster_cpu_s"] = time.time() - t0
    same = ((dk == dc) & (sk == sc)).double().mean().item()
    both = (dk > 0) & (dc > 0)
    depth_max = (dk - dc)[both].abs().max().item() if both.any() else 0.0
    out.update(raster_equal_share=same, raster_depth_max=depth_max, raster_covered=(dc > 0).double().mean().item())
    log(f"[vposer] vis_results 3 x 4 grid at {VPOSER_HW}^2 -> {os.path.basename(png)} "
        f"({os.path.getsize(png)} bytes) in {out['vis_s']:.2f} s; rasterize_mesh of the {verts.shape[0]}-vertex, "
        f"{faces.shape[0]}-face body at {VPOSER_HW}^2: {out['raster_ms']:.3f} ms on the card (CPU "
        f"{out['raster_cpu_s']:.2f} s); {100 * out['raster_covered']:.2f}% of pixels covered; depth and label equal "
        f"to the CPU's in {100 * same:.3f}% of pixels (tol {100 * VPOSER_RASTER_SHARE}%), depth where both hit within "
        f"{depth_max:.3e} m (tol {VPOSER_RASTER_MM})")
    if not (same >= VPOSER_RASTER_SHARE and depth_max <= VPOSER_RASTER_MM and out["raster_covered"] > 0):
        raise AssertionError("[vposer] the card's rasterization differs from the CPU's")

    # ---- the body model: randomize_pose, then untangle_interpenetrations at its defaults
    bmp = BodyModelWithPoser(bm, tr.model)  # the card
    bmp.randomize_pose(torch.Generator(device=dev).manual_seed(SEED + 73))
    objective = bmp._untangle_objective()
    with torch.no_grad():
        before = objective(bmp.poZ_body).item()
    evaluations, build_objective = [0], bmp._untangle_objective

    def counting_objective(*args, **kw):  # the L-BFGS evaluations of untangle's objective, counted
        fn = build_objective(*args, **kw)

        def evaluate(z):
            evaluations[0] += 1
            return fn(z)
        return evaluate

    bmp._untangle_objective = counting_objective
    _, split_untangle, out["untangle_s"], _ = counted(split, bmp.untangle_interpenetrations)
    out.update(untangle_evaluations=evaluations[0], split_launches_untangle=split_untangle)
    # each evaluation decodes the body once at 'high' with the latent's gradient: K4 twice, K5 twice
    check_launches("[vposer] untangle_interpenetrations", split_untangle,
                   {SPLIT_FWD.name: 2 * evaluations[0], SPLIT_BWD.name: 2 * evaluations[0]})
    with torch.no_grad():
        after = objective(bmp.poZ_body).item()
    out.update(untangle_before=before, untangle_after=after)
    log(f"[vposer] BodyModelWithPoser on the card: randomize_pose, untangle_interpenetrations() at its defaults "
        f"(psi_tpu's L-BFGS, at most 30 iterations, 512 vertices, radius 0.04) in {out['untangle_s']:.3f} s: proxy "
        f"objective {before:.6f} -> {after:.6f}; {evaluations[0]} evaluations, K4/K5 {split_untangle}; "
        f"evaluate + perform_training K4/K5 {out['split_launches_training']}")
    if not (np.isfinite(after) and after < before):
        raise AssertionError("[vposer] the untangler did not lower the penalty")

    out["launches"] = {k.name: k.launches for k in kernels}
    out["phase_s"] = time.time() - t_phase
    log(f"[vposer] K1/K2/K3 launches during the phase {out['launches']} (want 0/0/0: 'high' LBS, no chamfer); "
        f"the phase {out['phase_s']:.2f} s; on {smi}")
    check_launches("[vposer] the phase", out["launches"], want_launches(kernels, 0, 0, 0))
    return out


SNAP_FRAMES = 8  # body frames of the production call
SNAP_HW = (480, 640)  # psi_tpu's render_hw default
SNAP_CAMS = 30  # psi_tpu's max_cams_per_frame default
SNAP_FLOOR_SHARE = 0.1  # the lowest tenth of the cloud's height is labelled floor (2), the rest other (5)
SNAP_EQUAL_SHARE = 0.995  # raw depth and seg pixels equal card vs CPU (as [vposer]'s rasterization)
SNAP_CANVAS_TOL = 1e-6  # canvases card vs CPU, beside what the raw pixels that differ carry (2 d / max)
SNAP_BODY_TOL = 1e-5  # stored body vectors card vs CPU
SNAP_FRAME_TOL = 1e-3  # m: a row's body mapped by inv(cam_ext) vs the frame's world body
SNAP_FRAME_WRONG = 0.1  # m: the least error of the same body mapped by cam_ext as stored
SNAP_ROOM_GRID = 13  # quads a side of each face of the rasterized room: 6 x 13^2 x 2 = 2028 triangles


class _SnapshotRows:
    """SnapshotHDF5Writer's append/close, keeping the rows in memory (the
    card's machine has no h5py; the HDF5 side is held on the CPU by
    tests/test_torch_snapshots.py)."""

    def __init__(self):
        self.rows, self.closed = [], False

    def append(self, *row):
        self.rows.append(row)

    def close(self):
        self.closed = True


def snapshot_frames(rng, s_min, s_max, n: int):
    """n body frames (VPoser latent pose) standing about 1 m over the cloud's floor near its middle."""
    import numpy as np

    mid = 0.5 * (s_min + s_max)
    frames = []
    for _ in range(n):
        transl = np.array([[mid[0], mid[1], s_min[2] + 1.0]]) + rng.normal(0, 0.3, (1, 3))
        frames.append({"transl": transl.astype(np.float32),
                       "global_orient": (rng.normal(size=(1, 3)) * 0.3).astype(np.float32),
                       "betas": np.zeros((1, 10), np.float32),
                       "body_pose": (rng.normal(size=(1, 32)) * 0.3).astype(np.float32),
                       "left_hand_pose": np.zeros((1, 12), np.float32),
                       "right_hand_pose": np.zeros((1, 12), np.float32)})
    return frames


def room_mesh(s_min, s_max, n: int = SNAP_ROOM_GRID):
    """The box (s_min, s_max) as six faces of n x n quads, two triangles each;
    labels per vertex: floor 2, ceiling 22, walls 1."""
    import numpy as np

    t = np.linspace(0.0, 1.0, n + 1)
    u, v = (a.reshape(-1) for a in np.meshgrid(t, t, indexing="ij"))
    lo, hi = np.asarray(s_min, np.float64), np.asarray(s_max, np.float64)
    verts, faces, labels = [], [], []
    for axis in range(3):
        for side, label in ((0, 2 if axis == 2 else 1), (1, 22 if axis == 2 else 1)):
            p = np.empty((len(u), 3))
            a, b = [i for i in range(3) if i != axis]
            p[:, axis] = hi[axis] if side else lo[axis]
            p[:, a] = lo[a] + u * (hi[a] - lo[a])
            p[:, b] = lo[b] + v * (hi[b] - lo[b])
            off = sum(len(x) for x in verts)
            for i in range(n):
                for j in range(n):
                    q = off + i * (n + 1) + j
                    faces += [[q, q + n + 1, q + 1], [q + 1, q + n + 1, q + n + 2]]
            verts.append(p)
            labels.append(np.full(len(p), label))
    return (np.concatenate(verts).astype(np.float32), np.asarray(faces, np.int32),
            np.concatenate(labels).astype(np.int32))


def _raw_agreement(a, b) -> tuple:
    """(share of pixels equal in both maps, depth's and seg's largest difference)."""
    import numpy as np

    same = float(np.mean((a[0] == b[0]) & (a[1] == b[1])))
    return same, float(np.abs(a[0] - b[0]).max()), float(np.abs(a[1] - b[1]).max())


def check_snapshots(dev, model, assets, registry, kernels, slice_wall: float, smi: str, workdir: Path):
    """Phase 20: snapshot production on scene 0 at psi_tpu's defaults, one frame of it card vs CPU, one
    rasterized snapshot card vs CPU, a snapshot's canvases into the production generate+fit, then the demo,
    the pose example and the two benches; returns its record."""
    import contextlib
    import copy
    import io

    import numpy as np
    import torch

    from psi_tpu_torch.body.decode import body_vec_to_verts
    from psi_tpu_torch.data import snapshots
    from psi_tpu_torch.eval import collision_contact_scores
    from psi_tpu_torch.fit.fitting import make_generate_fit_step
    from psi_tpu_torch.gen.sample import generate_bodies
    from psi_tpu_torch.geometry.bodyvec import body_params_parse
    from psi_tpu_torch.scripts import bench_sample, bench_train, demo, sample_body_pose
    from psi_tpu_torch.scripts.profile_fit import _device_us, device_events
    from psi_tpu_torch.utils.config import FitConfig
    from psi_tpu_torch.utils.precision import strict_f32
    from psi_tpu_torch.utils.timing import cuda_ms
    from psi_tpu_torch.viz.render import rasterize_mesh

    out = {}
    t_phase = time.time()
    verts = registry.verts_stack[0, : registry.n_verts[0]]
    s_min, s_max = verts.min(axis=0), verts.max(axis=0)
    labels = np.where(verts[:, 2] < s_min[2] + SNAP_FLOOR_SHARE * (s_max[2] - s_min[2]), 2, 5).astype(np.int32)
    frames = snapshot_frames(np.random.default_rng(SEED + 80), s_min, s_max, SNAP_FRAMES)

    # ---- the production call on the card: 8 frames x up to 30 cameras at 480 x 640
    rows = _SnapshotRows()
    n, launches, wall, peak = counted(kernels, lambda: snapshots.produce_virtualcam_snapshots(
        verts, labels, frames, assets.smplx, assets.vposer, rows, sceneid=0, render_hw=SNAP_HW,
        max_cams_per_frame=SNAP_CAMS, seed=SEED, device=dev))
    # the candidate cameras, drawn as the call draws them (host numpy; a frame's draws precede the next frame's)
    rng = np.random.default_rng(SEED)
    planes = snapshots.room_box_planes(s_min, s_max)
    cams = [snapshots.get_new_cams(planes, s_min, s_max, np.asarray(f["transl"]).reshape(3), rng=rng,
                                   max_cams=SNAP_CAMS) for f in frames]
    rendered = sum(len(c) for c in cams)
    out.update(written=n, rendered=rendered, candidates_max=SNAP_FRAMES * SNAP_CAMS, wall_s=wall,
               s_per_snapshot=wall / rendered, s_per_written=wall / max(n, 1), peak_gb=peak, launches=launches,
               frames=SNAP_FRAMES, hw=list(SNAP_HW), scene_points=int(len(verts)))
    log(f"[snapshots] produce_virtualcam_snapshots on scene 0 ({len(verts)} points, floor the lowest "
        f"{SNAP_FLOOR_SHARE:.0%} of its height) over {SNAP_FRAMES} frames at {SNAP_HW[0]}x{SNAP_HW[1]}, up to "
        f"{SNAP_CAMS} cameras a frame: {rendered} rendered, {n} written (not occluded) in {wall:.3f} s = "
        f"{out['s_per_snapshot'] * 1e3:.2f} ms a rendered snapshot, {out['s_per_written'] * 1e3:.2f} ms a written "
        f"one; peak device memory {peak:.4f} GB; K1/K2/K3 {launches}; on {smi}")
    check_launches("[snapshots] production", launches, want_launches(kernels, 0, 0, 0))
    if not (n == len(rows.rows) > 0 and rendered <= SNAP_FRAMES * SNAP_CAMS):
        raise AssertionError(f"[snapshots] {n} rows written of {rendered} rendered")
    for depth, seg, body72, cam_ext, cam_int, max_d, sceneid in rows.rows:
        if not (depth.shape == seg.shape == (128, 128) and body72.shape == (72,) and np.isfinite(body72).all()
                and np.isfinite(depth).all() and 0 < max_d <= 6.0 and sceneid == 0):
            raise AssertionError("[snapshots] a written row is malformed")

    # device launches and busy time of one snapshot (render, readback; the preprocessing is the host's)
    vt = torch.as_tensor(verts, device=dev)
    lt = torch.as_tensor(labels, device=dev)
    cam_int = rows.rows[0][4]
    one = lambda: snapshots.render_scene_snapshot(vt, lt, cams[0][0], cam_int, *SNAP_HW, device=dev)
    one()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        one()
        torch.cuda.synchronize()
        out["profiled_snapshot_ms"] = (time.time() - t0) * 1e3
    events = device_events(prof)
    out["device_launches_a_snapshot"] = sum(e.count for e in events)
    out["device_busy_ms_a_snapshot"] = sum(_device_us(e) for e in events) / 1e3
    log(f"[snapshots] one snapshot under torch.profiler: {out['profiled_snapshot_ms']:.3f} ms, "
        f"{out['device_launches_a_snapshot']} device launches (kernels and copies), device busy "
        f"{out['device_busy_ms_a_snapshot']:.3f} ms")

    # ---- card vs CPU on frame 0: the same call with device='cpu' keeps the same rows with the same cameras;
    # frame 0's cameras rendered again on both devices (untimed) give the raw maps behind those rows
    cpu = torch.device("cpu")
    rows_cpu = _SnapshotRows()
    smplx_cpu, vposer_cpu = assets.smplx.to(cpu), copy.deepcopy(assets.vposer).to(cpu)
    t0 = time.time()
    n_cpu = snapshots.produce_virtualcam_snapshots(verts, labels, frames[:1], smplx_cpu, vposer_cpu, rows_cpu,
                                                   sceneid=0, render_hw=SNAP_HW, max_cams_per_frame=SNAP_CAMS,
                                                   seed=SEED, device="cpu")
    cpu_frame_s = time.time() - t0
    cams0 = cams[0]
    key = {np.linalg.inv(np.asarray(c, np.float64)).astype(np.float32).tobytes(): i for i, c in enumerate(cams0)}
    rows0 = [r for r in rows.rows if r[3].tobytes() in key]
    idx_card = [key[r[3].tobytes()] for r in rows0]
    idx_cpu = [key.get(r[3].tobytes(), -1) for r in rows_cpu.rows]
    cams_equal = len(rows0) == len(rows_cpu.rows) and all(np.array_equal(a[3], b[3]) for a, b in zip(rows0, rows_cpu.rows))
    again = {d: [snapshots.render_scene_snapshot(verts, labels, c, cam_int, *SNAP_HW, device=d) for c in cams0]
             for d in (dev, "cpu")}
    agree = [_raw_agreement((a["depth_raw"], a["seg_raw"]), (b["depth_raw"], b["seg_raw"]))
             for a, b in zip(again[dev], again["cpu"])]
    share = min(a[0] for a in agree)
    canvas_excess, body_diff, replay_diff = 0.0, 0.0, 0.0
    for r_card, r_cpu, i in zip(rows0, rows_cpu.rows, idx_cpu):
        sk, sc = again[dev][i], again["cpu"][i]
        replay_diff = max(replay_diff, float(np.abs(r_card[0] - sk["depth"]).max()),
                          float(np.abs(r_card[1] - sk["seg"]).max()))
        # data_preprocessing clamps depth at 6 m and labels at 41, then scales by the map's maximum to [-1, 1]
        # and resizes (a convex combination): a raw pixel moved by d moves the canvas by at most 2 d / max
        for a, b, raw_k, raw_c, cap in ((r_card[0], r_cpu[0], sk["depth_raw"], sc["depth_raw"], 6.0),
                                        (r_card[1], r_cpu[1], sk["seg_raw"], sc["seg_raw"], 41.0)):
            carried = 2 * float(np.abs(raw_k - raw_c).max()) / max(float(np.minimum(raw_c, cap).max()), 1e-6)
            canvas_excess = max(canvas_excess, float(np.abs(a - b).max()) - carried)
        body_diff = max(body_diff, float(np.abs(r_card[2] - r_cpu[2]).max()))
    out["cross"] = dict(cpu_frame_s=cpu_frame_s, cameras=len(cams0), cameras_equal=cams_equal, rows_cpu=n_cpu,
                        rows_card=len(idx_card), rows_equal=idx_card == idx_cpu, raw_equal_share_min=share,
                        raw_depth_max=max(a[1] for a in agree), raw_seg_max=max(a[2] for a in agree),
                        canvas_excess=canvas_excess, body_max=body_diff, replay_canvas_max=replay_diff)
    c = out["cross"]
    log(f"[snapshots] frame 0 card vs CPU (device='cpu', {cpu_frame_s:.2f} s): {len(cams0)} candidate cameras; "
        f"rows kept card {idx_card} vs CPU {idx_cpu}, their cam_ext equal in bits {cams_equal}; the {len(cams0)} "
        f"cameras rendered again: raw depth and seg equal in {100 * share:.3f}% of pixels at least (tol "
        f"{100 * SNAP_EQUAL_SHARE}%), largest differences {c['raw_depth_max']:.3e} m, {c['raw_seg_max']:.0f}; the "
        f"rows' canvases vs the card's render again {replay_diff:.3e}, card vs CPU beyond what differing raw pixels "
        f"carry (2 d / max) {canvas_excess:.3e} (tol {SNAP_CANVAS_TOL}); body72 {body_diff:.3e} (tol {SNAP_BODY_TOL})")
    if not (cams_equal and idx_card == idx_cpu and n_cpu == len(idx_cpu) > 0 and share >= SNAP_EQUAL_SHARE
            and replay_diff <= SNAP_CANVAS_TOL and canvas_excess <= SNAP_CANVAS_TOL and body_diff <= SNAP_BODY_TOL):
        raise AssertionError("[snapshots] the card's frame differs from the CPU's")

    # ---- the camera frame on the card: a row's body decoded in its camera and mapped by the inverse of its
    # cam_ext (world->camera, psi_tpu's convention for virtual cameras) is frame 0's world body; by cam_ext itself
    # it is not
    with torch.no_grad(), strict_f32():
        decode = lambda x72, ext: body_vec_to_verts(
            assets.smplx, assets.vposer, torch.as_tensor(np.asarray(x72, np.float32), device=dev).reshape(-1, 72),
            torch.as_tensor(np.asarray(ext, np.float32), device=dev).reshape(-1, 4, 4))[0]
        world = decode(body_params_parse(frames[0]).numpy(), np.eye(4))
        x0 = np.stack([r[2] for r in rows0])
        ext0 = np.stack([r[3] for r in rows0]).astype(np.float64)
        inv_err = (decode(x0, np.linalg.inv(ext0)) - world).abs().amax().item()
        raw_err = (decode(x0, ext0) - world).abs().amax().item()
    out["camera_frame"] = dict(rows=len(rows0), inverted_max_m=inv_err, as_stored_max_m=raw_err)
    log(f"[snapshots] frame 0's {len(rows0)} rows decoded on the card: mapped by inv(cam_ext) the body is frame "
        f"0's world body within {inv_err:.3e} m (tol {SNAP_FRAME_TOL}); mapped by cam_ext as stored it is off by "
        f"{raw_err:.3f} m (want > {SNAP_FRAME_WRONG} m)")
    if not (inv_err <= SNAP_FRAME_TOL and raw_err > SNAP_FRAME_WRONG):
        raise AssertionError("[snapshots] the rows' bodies and cameras do not place frame 0's body")

    # ---- the mesh path: one snapshot of a triangulated room through rasterize_mesh, card vs CPU
    room_v, room_f, room_l = room_mesh(s_min, s_max)
    cam2world = cams0[0]
    mesh_snap = lambda d: snapshots.render_scene_snapshot(room_v, room_l, cam2world, cam_int, *SNAP_HW,
                                                          scene_faces=room_f, device=d)
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.time()
        mk = mesh_snap(dev)
        walls.append((time.time() - t0) * 1e3)
    world2cam = torch.as_tensor(mk["cam_ext"], device=dev)
    out["mesh"] = dict(triangles=int(len(room_f)), snapshot_ms=statistics.median(walls), snapshot_walls_ms=walls,
                       raster_ms=cuda_ms(lambda: rasterize_mesh(
                           torch.as_tensor(room_v, device=dev), torch.as_tensor(room_f, device=dev),
                           torch.as_tensor(room_l, device=dev), torch.as_tensor(cam_int, device=dev), *SNAP_HW,
                           cam_ext=world2cam), reps=5))
    t0 = time.time()
    mc = mesh_snap("cpu")
    out["mesh"]["cpu_s"] = time.time() - t0
    m_same, m_depth, m_seg = _raw_agreement((mk["depth_raw"], mk["seg_raw"]), (mc["depth_raw"], mc["seg_raw"]))
    out["mesh"].update(equal_share=m_same, depth_max=m_depth, seg_max=m_seg,
                       covered=float(np.mean(mc["depth_raw"] > 0)))
    log(f"[snapshots] rasterized room ({len(room_f)} triangles) from frame 0's first camera at "
        f"{SNAP_HW[0]}x{SNAP_HW[1]}: render_scene_snapshot {out['mesh']['snapshot_ms']:.2f} ms (median of 3), "
        f"rasterize_mesh alone {out['mesh']['raster_ms']:.3f} ms on the card, CPU {out['mesh']['cpu_s']:.2f} s; "
        f"{100 * out['mesh']['covered']:.2f}% of pixels covered; raw maps equal in {100 * m_same:.3f}% of pixels "
        f"(tol {100 * SNAP_EQUAL_SHARE}%), largest differences {m_depth:.3e} m, {m_seg:.0f}")
    if not (m_same >= SNAP_EQUAL_SHARE and out["mesh"]["covered"] > 0.5):
        raise AssertionError("[snapshots] the card's rasterized snapshot differs from the CPU's")

    # ---- into the main path: the first written snapshot's canvases, N=256 sampled and fitted in scene 0
    depth, seg, _, cam_ext, row_int, max_d, _ = rows.rows[0]
    xs = torch.from_numpy(np.stack([depth, seg], axis=-1)[None]).to(dev)
    # the row's cam_ext is world->camera (psi_tpu's convention for virtual cameras); the fit maps camera-frame
    # bodies into the scene with verts_transform(verts, cam_ext), so it is handed the camera->world inverse
    cam2world = np.linalg.inv(cam_ext.astype(np.float64)).astype(np.float32)
    cam_ext_n = torch.from_numpy(np.tile(cam2world[None], (N_BODIES, 1, 1))).to(dev)
    scene_idx = torch.zeros(N_BODIES, dtype=torch.int64, device=dev)
    run = make_generate_fit_step(model, assets, FitConfig.production(num_iter=NUM_ITER), N_BODIES, want_metrics=False)
    args = (xs, torch.from_numpy(row_int[None]).to(dev), torch.tensor([max_d], device=dev), cam_ext_n, scene_idx)
    # the latents drawn up front, so that the samples each fit starts from can be scored
    eps = [torch.randn((N_BODIES, model.eps_d), generator=torch.Generator(device=dev).manual_seed(SEED + 90 + rep),
                       device=dev) for rep in range(3)]
    fits = [counted(kernels, lambda: run(*args, eps=e)) for e in eps]
    (x72, _, hist), gf_launches, _, gf_peak = fits[0]
    gf_walls = [f[2] for f in fits]
    curve = hist.mean(dim=1).tolist()
    out["generate_fit"] = dict(launches=gf_launches, walls_s=gf_walls, wall_s=statistics.median(gf_walls),
                               slice_wall_s=slice_wall, loss=curve, peak_gb=gf_peak, max_d=float(max_d))
    log(f"[snapshots] a written snapshot's canvases (max_d {float(max_d):.3f} m) -> HumanCVAES1 samples "
        f"{N_BODIES} -> FitConfig.production(num_iter={NUM_ITER}) in scene 0 with the row's inverted cam_ext: launches "
        f"{gf_launches}; mean total loss at iterations 0, 1, 4, 14, {NUM_ITER - 1}: "
        f"{', '.join(f'{curve[i]:.6f}' for i in (0, 1, 4, 14, NUM_ITER - 1))}; walls "
        f"{', '.join(f'{w:.4f}' for w in gf_walls)} s (median {out['generate_fit']['wall_s']:.4f} s; [slice] "
        f"{slice_wall:.4f} s); peak {gf_peak:.4f} GB")
    check_launches("[snapshots] generate+fit", gf_launches, want_launches(kernels, NUM_ITER, NUM_ITER, 6))
    if x72.shape != (N_BODIES, 72) or not (torch.isfinite(x72).all() and torch.isfinite(hist).all()):
        raise AssertionError("[snapshots] the snapshot-fed fit's bodies or losses are not finite")
    # The samples sit in free space: the first Adam update raises the total (the L1-to-sample term starts at 0;
    # psi_tpu's fit does the same, tests/test_torch_free_space_fit.py), so the total is logged, not held to
    # fall. What the fit must do is take the bodies out of the scene: the timed fit's own samples and result,
    # scored by the eval's collision_contact_scores
    samples = generate_bodies(model, xs, args[1], args[2], N_BODIES, eps=eps[0])
    scores = {name: collision_contact_scores(assets, x, cam_ext_n, scene_idx) for name, x in
              (("samples", samples), ("fitted", x72))}
    out["generate_fit"]["scores"] = {k: dict(non_collision=v[0], contact=v[1]) for k, v in scores.items()}
    log(f"[snapshots] the timed fit's samples -> its bodies: non-collision {scores['samples'][0]:.6f} -> "
        f"{scores['fitted'][0]:.6f}, contact {scores['samples'][1]:.6f} -> {scores['fitted'][1]:.6f}")
    if not scores["fitted"][0] > scores["samples"][0]:
        raise AssertionError(f"[snapshots] the fit did not take the bodies out of the scene: {scores}")

    # ---- the last entry points, each on the card by default, with its output
    out["scripts"] = {}

    def script(name, fn, want, *argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            res, got, wall, _ = counted(kernels, lambda: fn(*argv))
        out["scripts"][name] = dict(wall_s=wall, launches=got, stdout=buf.getvalue().splitlines())
        for line in buf.getvalue().splitlines():
            log(f"[snapshots] {name} | {line}")
        log(f"[snapshots] {name}: {wall:.2f} s, launches {got}")
        check_launches(f"[snapshots] {name}", got, want)
        return res

    res = script("demo", demo.main, want_launches(kernels, NUM_ITER + 1, NUM_ITER, 7),
                 ["--out", str(workdir / "demo"), "--n_samples", "16"])
    if not (os.path.getsize(res["png"]) > 0 and np.isfinite([res["non_collision"], res["contact"],
                                                               res["entropy"]]).all()):
        raise AssertionError("[snapshots] the demo wrote no PNG or no finite scores")
    res = script("sample_body_pose", sample_body_pose.main, want_launches(kernels, 0, 0, 0),
                 ["--out", str(workdir / "poses.png")])
    if not (os.path.getsize(workdir / "poses.png") > 0 and res["frames"].min() < 255):
        raise AssertionError("[snapshots] sample_body_pose drew nothing")
    out["bench_sample"] = script("bench_sample", bench_sample.main, want_launches(kernels, 0, 0, 0))
    out["bench_train"] = script("bench_train", bench_train.main, want_launches(kernels, 0, 0, 11),
                                ["--reps", "10", "--model_type", "s1"])
    out["phase_s"] = time.time() - t_phase
    log(f"[snapshots] the phase {out['phase_s']:.2f} s; on {smi}")
    return out


EXACT_GROUPS, EXACT_REPS = 3, 1  # profile_fused's and profile_refresh_cadence's protocol, cut in depth
EXACT_SEGMENT_REPS = 2  # profile_segments' timed calls a segment (the script's default is 5)
EXACT_CROSS_N = 16
EXACT_CLI_SCENES = 2  # PROX-E test scenes with N_FILES written pickles: the CLI's FittingOP fits each as one chunk
# [soak]: bench_train_native at its defaults. Its first chunk through scan_epoch against the per-step loop: the same
#     steps, but cuDNN's default convolution algorithms do not sum in a fixed order, so only the first step is the
#     same step twice ([native]'s bound); the later ones part chaotically (found up to 4e-2 relative by step 32 on
#     the card, and bf16 and f32 staging's loss at one step 5.9% apart after 192). So the comparisons
#     that must not see that noise run with torch.backends.cudnn.deterministic, on one-epoch runs of
#     SOAK_DET_SAMPLES: scan against per-step in equal bits, and --stage_bf16 against f32 staging within
#     tests/test_torch_train_loop.py::test_stage_bf16_trains_close_to_f32_staging's 5%.
SOAK_SCAN_REL_TOL = TRAIN_RESUME_REL_TOL
SOAK_DET_SAMPLES = 32 * 32  # one chunk of 32 batches of 32
SOAK_BF16_REL_TOL = 0.05


def check_exact(dev, model, assets, batch, x72_pre, cam_ext, kernels, smi: str, workdir: Path):
    """Phase 21: the reference-exact fit tier (FitConfig.exact(): a full pass every iteration, 'high' LBS with its
    split-bf16 products on K4/K5, f32 grids) at full width: profile_fused's six variants, N=16 card vs CPU, one exact call profiled,
    profile_segments at 'fused' and 'high', profile_refresh_cadence, and cli.fitting_proxe --exact against
    FittingOP.fitting_files. Returns its record."""
    import argparse
    import contextlib
    import io

    import numpy as np
    import torch

    from psi_tpu_torch.cli import fitting_proxe
    from psi_tpu_torch.cli.common import build_assets
    from psi_tpu_torch.data.hdf5 import PROX_TEST_SCENES
    from psi_tpu_torch.fit.fitting import FittingOP, make_fit_step
    from psi_tpu_torch.gen.sample import TestOP
    from psi_tpu_torch.ops.precision import SPLIT_BWD, SPLIT_FWD
    from psi_tpu_torch.ops.vertex_tail import VTAIL_BWD, VTAIL_FWD
    from psi_tpu_torch.scripts import profile_fused, profile_refresh_cadence, profile_segments
    from psi_tpu_torch.scripts.profile_fit import _device_us, device_events
    from psi_tpu_torch.utils.config import FitConfig

    t_phase = time.time()
    out = {}
    assets_f32 = profile_fused.bench_assets(dev)
    # the 'high' tier's K4 and K5 beside K1-K3, then K6 (counted where a run counts every one of them)
    kernels = tuple(kernels) + (SPLIT_FWD, SPLIT_BWD, VTAIL_FWD, VTAIL_BWD)
    per_call = 2 * NUM_ITER  # at 'high' a pass launches K4 for the correctives and the blend, K5 for their gradients

    # ---- profile_fused's six variants, launches asserted
    out["variants"] = profile_fused.run(dev, EXACT_GROUPS, EXACT_REPS, assets=(assets_f32, assets))
    for name, r in out["variants"].items():
        check_launches(f"[exact] {name}", r["launches"], want_launches(kernels, *r["expected_launches"]))
        if r["out_shape"] != [N_BODIES, 72] or not r["finite"]:
            raise AssertionError(f"[exact] {name}: fitted bodies not finite [N, 72] ({r['out_shape']})")
    for name, want in (("exact_high", (0, 0, NUM_ITER, per_call, per_call)),
                       ("exact_high_m20000", (0, 0, NUM_ITER, per_call, per_call)),
                       ("exact_fused", (NUM_ITER, NUM_ITER, NUM_ITER))):
        check_launches(f"[exact] {name}", out["variants"][name]["launches"], want_launches(kernels, *want))
    high = out["variants"]["exact_high"]
    log(f"[exact] exact_high mean loss iter 0 {high['loss_first']:.6f}, iter 1 {high['loss_second']:.6f} -> iter "
        f"{NUM_ITER - 1} {high['loss_last']:.6f}")
    # judged from the value after Adam's first update, which moves every coordinate by ~lr and raises the total
    if not high["loss_last"] < high["loss_second"]:
        raise AssertionError(f"[exact] exact_high's mean loss did not fall after the first update: {high}")

    # ---- FitConfig.exact() at N=16: card against CPU, beside the fit's own sensitivity on the card
    cfg = FitConfig.exact(num_iter=NUM_ITER)
    cpu = torch.device("cpu")
    t0 = time.time()
    assets_cpu = profile_fused.bench_assets(cpu)
    x16, cam16 = x72_pre[:EXACT_CROSS_N], cam_ext[:EXACT_CROSS_N]
    sidx16 = torch.zeros(EXACT_CROSS_N, dtype=torch.int64, device=dev)
    runs = {}
    for name, d, a, scale in (("cpu", cpu, assets_cpu, 1.0), ("cuda", dev, assets_f32, 1.0),
                              ("cuda+", dev, assets_f32, 1.0 + CROSS_PERTURB),
                              ("cuda-", dev, assets_f32, 1.0 - CROSS_PERTURB)):
        x, _, h = make_fit_step(a, cfg, want_metrics=False)((x16 * scale).to(d), cam16.to(d), sidx16.to(d))
        runs[name] = (x.cpu(), h.cpu())
    del assets_cpu

    def drift(a: str, b: str):
        dd = (runs[a][0] - runs[b][0]).abs()
        return dd.max().item(), dd.mean().item()

    card = drift("cuda", "cpu")
    own = tuple(max(p, q) for p, q in zip(drift("cuda+", "cuda"), drift("cuda-", "cuda")))
    tol_max, tol_mean = CROSS_SENS_FACTOR * own[0], CROSS_SENS_FACTOR * own[1]
    l0_cpu, l0_cuda = runs["cpu"][1][0], runs["cuda"][1][0]
    l0_rel = ((l0_cpu - l0_cuda).abs() / l0_cpu.abs().clamp(min=1e-6)).max().item()
    l0_mean_rel = abs(l0_cpu.mean().item() - l0_cuda.mean().item()) / abs(l0_cpu.mean().item())
    out["cross"] = {"l0_rel": l0_rel, "l0_mean_rel": l0_mean_rel, "card_max": card[0], "card_mean": card[1],
                    "own_max": own[0], "own_mean": own[1], "s": time.time() - t0}
    log(f"[exact] N={EXACT_CROSS_N} FitConfig.exact() CPU vs card in {out['cross']['s']:.1f} s: iter-0 loss rel diff "
        f"{l0_rel:.3e} per body, {l0_mean_rel:.3e} of the mean (tol {CROSS_LOSS0_REL_TOL}); fitted x72 drift "
        f"card-vs-CPU max {card[0]:.3e} mean {card[1]:.3e}; card-vs-card with inputs x(1+-{CROSS_PERTURB}) max "
        f"{own[0]:.3e} mean {own[1]:.3e}; tol max {tol_max:.3e} mean {tol_mean:.3e}")
    if not l0_rel <= CROSS_LOSS0_REL_TOL:
        raise AssertionError(f"[exact] iteration-0 losses differ card vs CPU: {l0_rel} (TF32 left on?)")
    if not (card[0] <= tol_max and card[1] <= tol_mean):
        raise AssertionError("[exact] CPU and card fits drift apart beyond the fit's own sensitivity")

    # ---- one exact_high call under torch.profiler: the main path's, a replay of the program's graph, with its
    # launches counted (Kernel.launches) and measured on the device (the trace) against the eager first call's
    xs, cam_b, sidx_b = profile_fused.fit_inputs(np.random.default_rng(SEED + 95), N_BODIES, 3, dev)
    fit = make_fit_step(assets_f32, cfg, want_metrics=False)
    _, _, eager_on_device = hand_written_on_device(lambda: fit(xs[0], cam_b, sidx_b))
    fit(xs[1], cam_b, sidx_b)  # the key's second call: captured
    profiled = []

    def profiled_replay():
        profiled.append(hand_written_on_device(lambda: fit(xs[2], cam_b, sidx_b)))

    out["replayed"] = check_replayed("[exact] exact_high", fit, kernels, profiled_replay,
                                     want_launches(kernels, 0, 0, NUM_ITER, per_call, per_call, NUM_ITER, NUM_ITER))
    ((_, prof, replay_on_device),) = profiled
    out["replayed"]["on_device"] = replay_on_device
    log(f"[exact] hand-written kernels on the device: eager call {eager_on_device}; replayed call {replay_on_device}")
    nn_on_device = sum(n for name, n in replay_on_device.items() if "nn_argmin_kernel" in name)
    if replay_on_device != eager_on_device or nn_on_device != NUM_ITER:
        raise AssertionError(f"[exact] the replay ran other hand-written kernels on the device than the eager call: "
                             f"{replay_on_device} != {eager_on_device} (K3 {nn_on_device}, want {NUM_ITER})")
    events = device_events(prof)
    busy_ms = sum(_device_us(e) for e in events) / 1e3
    if not busy_ms > 0:
        raise AssertionError("[exact] the profile shows no device time")
    out["profile"] = {"busy_ms": busy_ms, "busy_share": busy_ms / 1e3 / high["median_s"],
                      "device_launches": sum(e.count for e in events),
                      "top": [{"name": e.key[:100], "ms": _device_us(e) / 1e3, "launches": e.count}
                              for e in sorted(events, key=_device_us, reverse=True)[:10]]}
    log(f"[exact] one exact_high call profiled: device busy {busy_ms:.2f} ms "
        f"({100 * out['profile']['busy_share']:.1f}% of the median wall {high['median_s']:.4f} s), "
        f"{out['profile']['device_launches']} device launches")
    for t in out["profile"]["top"]:
        log(f"[exact]   top: {t['ms']:.3f} ms, {t['launches']} launches: {t['name']}")

    # ---- profile_segments at 'fused' and 'high', profile_refresh_cadence
    out["segments"] = {}
    for tier in ("fused", "high"):
        out["segments"][tier] = profile_segments.run(dev, tier, assets=assets, reps=EXACT_SEGMENT_REPS)
        for name, r in out["segments"][tier].items():
            fresh_nn, _, _ = profile_segments.SEGMENTS[name]
            k12, k45 = (NUM_ITER if tier == "fused" else 0), (per_call if tier == "high" else 0)
            check_launches(f"[exact] segment {name} at {tier}", r["launches"],
                           want_launches(kernels, k12, k12, NUM_ITER if fresh_nn else 0, k45, k45))
    out["cadence"] = profile_refresh_cadence.run(dev, EXACT_GROUPS, EXACT_REPS, assets=assets)
    for name, want in (("refresh10", (20, 20, 6)), ("refresh15", (20, 20, 6)), ("refresh20", (20, 20, 5))):
        check_launches(f"[exact] {name}", out["cadence"][name]["launches"], want_launches(kernels, *want))

    # ---- cli.fitting_proxe --exact on written files, against FittingOP.fitting_files with the CLI's configuration
    gen, fit_dir, direct = workdir / "gen", workdir / "fit", workdir / "direct"
    snapshot = {k: batch[k] for k in ("xs", "cam_int", "max_d")}
    snapshot["cam_ext"] = cam_ext[:1].cpu().numpy()
    op = TestOP(model, n_samples=N_FILES, seed=SEED + 90)
    scenes = PROX_TEST_SCENES[:EXACT_CLI_SCENES]
    for scene in scenes:
        op.test(snapshot, str(gen), scene)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _, cli_launches, cli_s, _ = counted(kernels, lambda: fitting_proxe.main(
            [str(gen), str(fit_dir), "--synthetic", "--exact"]))
    args = argparse.Namespace(synthetic=True, proxe_path=None, device=None)
    assets_cli, registry = build_assets(args, sdf_dtype=None, device=dev)
    cli_cfg = FitConfig(init_lr_h=0.1, num_iter=NUM_ITER, contact_denom_offset=0.01, weight_loss_rec=1.0,
                        weight_loss_vposer=0.01, weight_contact=0.1, weight_collision=0.5, refresh_every=1,
                        lbs_precision="high", prune_scene_points=PRUNE)

    def fit_directly():
        for si, scene in enumerate(scenes):
            FittingOP(assets_cli, cli_cfg, scene_idx=si % registry.num_scenes).fitting_files(
                str(gen / scene), str(direct / scene))

    _, direct_launches, direct_s, _ = counted(kernels, fit_directly)
    fitted = read_pickles(fit_dir)
    equal = same_bits_records(fitted, read_pickles(direct))
    # a chunk a scene: 20 passes and the final metrics pass (K4 twice and K6 once, no gradient)
    want = want_launches(kernels, 0, 0, len(scenes) * (NUM_ITER + 1), len(scenes) * (per_call + 2),
                         len(scenes) * per_call, len(scenes) * (NUM_ITER + 1), len(scenes) * NUM_ITER)
    finite = all(np.isfinite(v).all() for r in fitted.values() for v in r.values())
    banner = buf.getvalue().strip().splitlines()
    out["cli_fitting_proxe_exact"] = {"launches": cli_launches, "wall_s": cli_s, "direct_launches": direct_launches,
                                      "direct_s": direct_s, "files": len(fitted), "equal_bits": equal}
    log(f"[exact] cli.fitting_proxe --exact on {len(scenes)} scenes x {N_FILES} written files: {cli_s:.2f} s, "
        f"launches {cli_launches} (want {want}); FittingOP.fitting_files with the CLI's exact configuration "
        f"{direct_s:.2f} s, launches {direct_launches}; {len(fitted)} fitted pickles, equal in bits: {equal}; "
        f"{banner[0]}")
    check_launches("[exact] cli.fitting_proxe --exact", cli_launches, want)
    check_launches("[exact] FittingOP.fitting_files, exact", direct_launches, want)
    if not (len(fitted) == len(scenes) * N_FILES and equal and finite and "EXACT" in banner[0]):
        raise AssertionError(f"[exact] cli.fitting_proxe --exact: {len(fitted)} files, equal bits {equal}, "
                             f"finite {finite}, banner {banner[0]!r}")
    out["phase_s"] = time.time() - t_phase
    log(f"[exact] the phase {out['phase_s']:.2f} s; on {smi}")
    return out


def check_soak(dev, kernels, smi: str, workdir: Path):
    """Phase 22: scripts.bench_train_native at its defaults (6144 packed samples, a warm-up epoch, 3 timed epochs of
    scan-epoch TrainOP s1 at TrainConfig's width, batch 32, chunk 32), then one-epoch runs of SOAK_DET_SAMPLES at f32
    and at --stage_bf16 staging with deterministic cuDNN. Returns its record."""
    import torch

    from psi_tpu_torch.scripts import bench_train_native

    t_phase = time.time()
    rec, rows = bench_train_native.soak(workdir / "f32", dev)
    shutil.rmtree(workdir / "f32", ignore_errors=True)  # the 808-MB pack
    per_epoch = rec["samples"] // rec["batch_size"]
    steps = rec["epochs"] * per_epoch
    log(f"[soak] bench_train_native: {rec['steps']} steps in {rec['wall_s']:.2f} s -> {rec['steps_per_sec']:.2f} "
        f"steps/s, {rec['samples_per_sec']:.1f} samples/s; loader {rec['loader_wall_s']:.3f} s in "
        f"{rec['loader_calls']} calls (occupancy {rec['loader_occupancy']:.4f}); warm-up epoch "
        f"{rec['warmup_epoch_s']:.2f} s; pack {rec['pack_mb']:.1f} MB in {rec['pack_s']:.2f} s; launches "
        f"{rec['launches']} (warm-up {rec['warmup_launches']}); peak device memory {rec['peak_gb']:.4f} GB; loss "
        f"{rec['loss_first']:.6f} -> {rec['loss_after_first_update']:.6f} (after the first update) -> "
        f"{rec['loss_last']:.6f}; the first chunk through the per-step loop: max abs diff "
        f"{rec['scan_vs_step_max_abs_diff']:.3e}, rel {rec['scan_vs_step_max_rel_diff']:.3e}, equal in bits: "
        f"{rec['scan_vs_step_equal']}; on {smi}")
    if not (rec["steps"] == steps == rec["logged_steps"] == len(rows) == rec["loader_calls"]):
        raise AssertionError(f"[soak] {rec['logged_steps']} steps logged, {rec['loader_calls']} loader calls, "
                             f"want {steps}")
    check_launches("[soak] the timed epochs", rec["launches"], want_launches(kernels, 0, 0, steps))
    check_launches("[soak] the warm-up epoch", rec["warmup_launches"], want_launches(kernels, 0, 0, per_epoch))
    if not rec["metrics_finite"]:
        raise AssertionError("[soak] a logged metric is not finite")
    if not rec["loss_after_first_update"] > rec["loss_last"]:
        raise AssertionError(f"[soak] the loss did not fall after Adam's first update: {rec['loss_after_first_update']}"
                             f" -> {rec['loss_last']}")
    if not (rec["scan_vs_step_steps"] == rec["chunk"] and rec["scan_vs_step_rel_by_step"][0] <= SOAK_SCAN_REL_TOL):
        raise AssertionError(f"[soak] the first step differs from the per-step loop's: {rec['scan_vs_step_rel_by_step']}")

    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        det, det_rows = bench_train_native.soak(workdir / "det", dev, samples=SOAK_DET_SAMPLES, epochs=1)
        bf16, bf16_rows = bench_train_native.soak(workdir / "bf16", dev, samples=SOAK_DET_SAMPLES, epochs=1,
                                                  stage_bf16=True)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
        shutil.rmtree(workdir / "det", ignore_errors=True)
        shutil.rmtree(workdir / "bf16", ignore_errors=True)
    rel = abs(bf16["loss_last"] - det["loss_last"]) / abs(det["loss_last"])
    log(f"[soak] the first chunk against the per-step loop, relative by step: "
        f"{', '.join(f'{v:.1e}' for v in rec['scan_vs_step_rel_by_step'])}; with cudnn.deterministic, "
        f"{det['steps']} steps: max rel {det['scan_vs_step_max_rel_diff']:.3e}, equal in bits: "
        f"{det['scan_vs_step_equal']}; --stage_bf16 there: loss at the end of the epoch {bf16['loss_last']:.6f} vs f32 "
        f"staging {det['loss_last']:.6f} (rel {rel:.3e}, tol {SOAK_BF16_REL_TOL}), {bf16['steps_per_sec']:.2f} "
        f"steps/s, occupancy {bf16['loader_occupancy']:.4f}")
    if not det["scan_vs_step_equal"]:
        raise AssertionError("[soak] with deterministic cuDNN the chunked epoch differs from the per-step loop")
    if not (bf16["metrics_finite"] and len(bf16_rows) == len(det_rows) and bf16["loss_last"] != det["loss_last"]
            and rel <= SOAK_BF16_REL_TOL):
        raise AssertionError("[soak] bf16 staging does not train close to f32 staging")
    for r in (det, bf16):
        check_launches("[soak] a one-epoch run", r["launches"], want_launches(kernels, 0, 0, r["steps"]))
    out = {"f32": rec, "bf16": bf16, "bf16_rel_loss": rel, "deterministic_cudnn": det, "phase_s": time.time() - t_phase}
    log(f"[soak] the phase {out['phase_s']:.2f} s; on {smi}")
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
    """Phases 1-22 on card ``dev``; raises on the first failure."""
    import torch

    from psi_tpu_torch.data.synthetic import SyntheticBatchGenerator, make_synthetic_assets
    from psi_tpu_torch.fit.fitting import make_generate_fit_step
    from psi_tpu_torch.gen.sample import generate_bodies
    from psi_tpu_torch.models.cvae_s1 import HumanCVAES1
    from psi_tpu_torch.ops import _cuda
    from psi_tpu_torch.ops.chamfer import NN_ARGMIN
    from psi_tpu_torch.ops.fused_skinning import SKIN_BWD, SKIN_FWD, fused_skinning_fwd
    from psi_tpu_torch.ops.gather_probes import KERNELS as PROBES
    from psi_tpu_torch.ops.precision import SPLIT_BWD, SPLIT_FWD
    from psi_tpu_torch.ops.prune import select_near_tiles
    from psi_tpu_torch.ops.vertex_tail import VTAIL_BWD, VTAIL_FWD
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
    split_hgmma = check_split_sass(sass["HGMMA"])
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
        split = check_split(assets, cb, A12, build_log)
        vtail = check_vtail(assets, cb, A12, x72_pre, cam_ext, build_log)

    # ---- 6. the slice: one production generate+fit call through the kernels
    cfg = FitConfig.production(num_iter=NUM_ITER)
    run = make_generate_fit_step(model, assets, cfg, N_BODIES, want_metrics=False)
    kernels = (SKIN_FWD, SKIN_BWD, NN_ARGMIN)
    torch.cuda.synchronize()
    high_only = (SPLIT_FWD, SPLIT_BWD, VTAIL_FWD, VTAIL_BWD)  # K4-K6: the einsum tiers' kernels
    for k in kernels + high_only:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    x72, _, hist = run(xs, cam_int, max_d, cam_ext, scene_idx,
                       generator=torch.Generator(device=dev).manual_seed(SEED + 1))
    torch.cuda.synchronize()
    first_s = time.time() - t0
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    launches = {k.name: k.launches for k in kernels}
    launches_split = {k.name: k.launches for k in high_only}
    check_launches("[slice] K4-K6 (the production fit decodes at 'fused')", launches_split,
                   {k.name: 0 for k in high_only})
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
    replayed = check_replayed(
        "[slice]", run, kernels + high_only,
        lambda: run(xs, cam_int, max_d, cam_ext, scene_idx,
                    generator=torch.Generator(device=dev).manual_seed(SEED + 13)),
        {**want, **{k.name: 0 for k in high_only}})

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

    # ---- 14. the default fit's own drift, the coalesced sampler in front of the fit, the carried-Adam mode
    paths = check_fit_paths(dev, model, assets, x72_pre, cam_ext, scene_idx, kernels, own[0], smi)

    # ---- 15. the serving path: engine, queue, router, soak, the CLI as a child process
    serve = check_serve(dev, model, assets, batch, cam_ext, kernels, want, smi)

    # ---- 16. the reference's entry points: train, test_proxe, fitting, eval, test_habitat
    cli = check_cli(dev, kernels, smi)

    # ---- 17-18. the native batch loader; the sharded fit, the sharded engine and data-parallel training
    workdir = Path(tempfile.mkdtemp(prefix="chip_smoke_scale_"))
    try:
        native = check_native(dev, assets, contact, y_pruned, smi, workdir)
        dist_rec = check_dist(dev, model, model_cpu, assets, assets_cpu, xs, cam_int, max_d, cam_ext, scene_idx,
                              batch, kernels, want, paths["own_sensitivity"]["mean"], smi, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    # ---- 19. the VPoser prior's trainer, the renderer behind vis_results, the body-model wrappers
    workdir = Path(tempfile.mkdtemp(prefix="chip_smoke_vposer_"))
    try:
        vposer = check_vposer(dev, kernels, smi, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    # ---- 20. the snapshot production into the main path; the demo, the pose example and the two benches
    workdir = Path(tempfile.mkdtemp(prefix="chip_smoke_snapshots_"))
    try:
        snaps = check_snapshots(dev, model, assets, registry, kernels, wall, smi, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    # ---- 21. the reference-exact fit tier at full width; the fit's profiling scripts; cli.fitting_proxe --exact
    workdir = Path(tempfile.mkdtemp(prefix="chip_smoke_exact_"))
    try:
        exact = check_exact(dev, model, assets, batch, x72_pre, cam_ext, kernels, smi, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    # ---- 22. the native loader in front of scan-epoch training at full width (scripts.bench_train_native)
    workdir = Path(tempfile.mkdtemp(prefix="chip_smoke_soak_"))
    try:
        soak = check_soak(dev, kernels, smi, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    # ---- the record: each kernel with the launch count of its path's run (K4-K6: the exact tier at 'high')
    results = [(SKIN_FWD, k1, launches), (SKIN_BWD, k2, launches), (NN_ARGMIN, k3["pruned"], launches)]
    exact_high = exact["variants"]["exact_high"]["launches"]
    split_main = split[f"correctives_b{N_BODIES}"]
    results += [(SPLIT_FWD, {**split_main["k4"], "max_abs_err": split_main["fwd_max_abs"]}, exact_high),
                (SPLIT_BWD, {**split_main["k5"], "max_abs_err": split_main["grad_max_abs"]}, exact_high)]
    vt_main, exact_replayed = vtail[f"b{N_BODIES}"], exact["replayed"]["launches"]
    results += [(VTAIL_FWD, {**vt_main["fwd"], "max_abs_err": vt_main["max_abs_err"]["verts"]}, exact_replayed),
                (VTAIL_BWD, {**vt_main["bwd"], "max_abs_err": max(v for n, v in vt_main["max_abs_err"].items()
                                                                  if n != "verts")}, exact_replayed)]
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
                                   "serve_single_fit": serve["launches_single_fit"][k.name],
                                   "serve_coalesced_fit": serve["launches_coalesced_fit"][k.name],
                                   "cli_fitting_proxe": cli["launches"]["fitting_proxe"][k.name],
                                   "cli_fitting_habitat": cli["launches"]["fitting_habitat"][k.name]}
        row["launches_by_path"].update(
            dist_nccl_world1_generate_fit=dist_rec["nccl_world1"]["launches"][k.name],
            **{f"dist_gloo_rank{r}_{c}": p["launches"][c][k.name] for r, p in enumerate(dist_rec["gloo_two_ranks"]["ranks"])
               for c in ("genfit", "engine", "train")}, vposer_phase=vposer["launches"][k.name],
            snapshots_generate_fit=snaps["generate_fit"]["launches"][k.name],
            demo=snaps["scripts"]["demo"]["launches"][k.name],
            **{v: exact["variants"][v]["launches"][k.name] for v in ("exact_high", "exact_high_m20000", "exact_fused")},
            **{v: exact["cadence"][v]["launches"][k.name] for v in ("refresh15", "refresh20")},
            cli_fitting_proxe_exact=exact["cli_fitting_proxe_exact"]["launches"][k.name],
            soak_train_s1=soak["f32"]["launches"][k.name])
    rows[2]["launches_by_path"].update(train_s1=train["s1"]["k3_launches"], train_s2=train["s2"]["k3_launches"],
                                       cli_train_s1=cli["launches"]["train_s1"][NN_ARGMIN.name],
                                       native_train_s1=native["k3_launches"])
    # K4/K5 on every path that decodes at 'high', each counted from 0 just before it and read just after
    for row, k in zip(rows[3:5], (SPLIT_FWD, SPLIT_BWD)):
        row["launches_by_path"] = {
            **{v: exact["variants"][v]["launches"][k.name] for v in ("exact_high", "exact_high_m20000",
                                                                     "exact_fused")},
            **{f"segment_{n}_high": r["launches"][k.name] for n, r in exact["segments"]["high"].items()},
            "cli_fitting_proxe_exact": exact["cli_fitting_proxe_exact"]["launches"][k.name],
            "train_s1_6_steps": train["s1"]["split_launches"][k.name],
            "train_s2_6_steps": train["s2"]["split_launches"][k.name],
            "vposer_evaluate_and_train": vposer["split_launches_training"][k.name],
            "vposer_untangle": vposer["split_launches_untangle"][k.name], "eval_scorer": scores["split_launches"][k.name],
            "generate_fit_s1": launches_split[k.name]}
    # K6 on the exact tier's replayed call, the exact CLI, training and the production slice
    for row, k in zip(rows[5:7], (VTAIL_FWD, VTAIL_BWD)):
        row["launches_by_path"] = {
            "exact_high_replayed": exact["replayed"]["launches"][k.name],
            "cli_fitting_proxe_exact": exact["cli_fitting_proxe_exact"]["launches"][k.name],
            "train_s1_6_steps": train["s1"]["vtail_launches"][k.name],
            "train_s2_6_steps": train["s2"]["vtail_launches"][k.name], "eval_scorer": scores["split_launches"][k.name],
            "generate_fit_s1": launches_split[k.name]}
    log(json.dumps({"slice": {"bodies_per_s": N_BODIES / wall, "wall_s": wall, "walls_s": walls,
                              "peak_gb": peak_gb, "replayed": replayed},
                    "k1": {"stage_ms": k1["stage_ms"]},
                    "k2": {"stage_ms": k2["stage_ms"], "rel_err": k2["rel_err"]}, "hmma": hmma,
                    "split_hgmma": split_hgmma, "k4_k5": split, "k6": vtail,
                    "k3_ffma": k3_ffma, "k3_pruned": k3["pruned"], "k3_full_cloud": k3["full"],
                    "k3_swapped": k3["swapped"], "hbm_gather": hbm, "sdf_ms_per_iter": sdf_ms, "eval": scores,
                    "train": train, "k3_train_shape": k3_train, "s2_slice": s2, "drivers": drivers,
                    "fit_paths": paths, "kernels_at_path_batches": path_batches, "serve": serve, "cli": cli,
                    "native": native, "dist": dist_rec, "vposer": vposer, "snapshots": snaps, "exact": exact,
                    "soak": soak}))
    log(json.dumps({"kernels": rows}))
    log(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
