"""Time K3's design choices at the fit's and the training shapes, without touching the tree.

    python -m psi_tpu_torch.scripts.tune_chamfer_nn [R,THREADS,TILE,CHUNK[,fma] ...]

Each argument is one variant of the ``NN_*`` constants of
``csrc/chamfer_nn.cu``: x points a thread, threads a block, y points a
shared-memory tile, y points a chunk (one compare against the best per
chunk); with no argument a built-in list is tried. ``fma`` also lets the
distance contract into fused multiply-adds: it may give other bits and is
timed as a yardstick of what exactness costs, never committed. For each
variant a copy of the source with those constants is built under
``build/tune/``. Beside them one more source, held in this file and used
nowhere else, carries the routes that were weighed against the committed
design:

* ``simt``    one x point a thread, three scalar shared-memory loads and a
              compare with two selects per pair, int32 indices: the first
              port's kernel, the yardstick every variant's indices must equal.
* ``point``   4 x points a thread and float4 y, but `if (d < best)` per pair.
* ``rescan``  the chunk's minimum by fminf; when it improves on the best,
              the chunk's distances, still in registers, are scanned for
              the first equal one at once (a branch in the hot loop).
* ``fmin``    the committed scan (a chunk's minimum, one compare a chunk, the
              index recovered once a tile) with the minimum by fminf, one
              instruction a pair, in place of the three-way integer minimum
              on the distances' bit patterns; tiles staged by plain loads.
* ``plain``   the committed scan, its tiles staged by plain loads into one
              buffer instead of the cp.async ring.

All ``nvcc`` runs start together. Every entry point runs at (B, N, M) =
(256, 1455, 2048), the fit's pruned shape, (256, 1455, 20000), the full
scene cloud, and the swapped (256, 2048, 1455) of the two-sided chamfer, on
the clouds chip_smoke.py builds (contact vertices of 256 sampled bodies
against a Morton-ordered scene cloud) and, at the first shape, on uniform
noise; its indices are compared bit for bit with the committed kernel's,
and it is timed on the device alone (calls captured in a CUDA graph, median
of 10 replays), in two rounds. Prints ptxas' registers and spills, the SM
clock under load and the issue floor of the exact formula (8 instructions a
pair that cannot fuse, 4 warp instructions a clock and SM). Needs an NVIDIA
card.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from typing import Callable, Dict, List, Tuple

import torch

from psi_tpu_torch.ops import _cuda
from psi_tpu_torch.ops import chamfer as ch
from psi_tpu_torch.utils.timing import card, cuda_device_ms, nvidia_smi

SEED = 0
B, N, M_PRUNED = 256, 1455, 2048
CONSTANTS = (
    (r"constexpr int NN_R = \d+;", "constexpr int NN_R = {0};"),
    (r"constexpr int NN_THREADS = \d+;", "constexpr int NN_THREADS = {1};"),
    (r"constexpr int NN_TILE = \d+;", "constexpr int NN_TILE = {2};"),
    (r"constexpr int NN_CHUNK = \d+;", "constexpr int NN_CHUNK = {3};"),
)
EXACT = "return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));"
FUSED = "return fmaf(dz, dz, fmaf(dy, dy, dx * dx));"
# (R, THREADS, TILE, CHUNK[, "fma"])
DEFAULT_VARIANTS = [(4, 128, 1024, 16), (4, 128, 1024, 8), (4, 128, 1024, 4), (4, 128, 1024, 32), (4, 128, 512, 16),
                    (4, 128, 512, 32), (4, 128, 1536, 16), (4, 256, 1024, 16), (4, 64, 1024, 16), (8, 64, 1024, 16),
                    (8, 64, 1024, 32), (8, 64, 512, 32), (8, 128, 1024, 16), (2, 256, 1024, 16), (2, 128, 1024, 32),
                    (6, 64, 1024, 16), (4, 96, 1024, 16), (4, 128, 1024, 16, "fma"), (8, 64, 1024, 16, "fma")]
_SIG = _cuda.SIGNATURES["psi_nn_argmin"]
SM_ISSUE_LANES = 128  # 4 warp instructions a clock and SM, 32 lanes each
EXACT_INSTRUCTIONS = 8  # 3 subtractions, 3 multiplications, 2 additions: none may fuse

ROUTES_CU = r"""
// Routes weighed against the committed K3 (csrc/chamfer_nn.cu): built and
// timed by tune_chamfer_nn.py only.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
namespace {

__device__ __forceinline__ float dist2(float px, float py, float pz, float qx, float qy, float qz) {
  const float dx = px - qx, dy = py - qy, dz = pz - qz;
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// the first port's kernel: one thread a point, a block per (x tile, body)
constexpr int S_THREADS = 256, S_TILE = 1024;
__global__ void simt_kernel(const float* __restrict__ x, const float* __restrict__ y, int32_t* __restrict__ idx,
                            int N, int M) {
  __shared__ float ys[3][S_TILE];
  const int b = blockIdx.y;
  const int i = blockIdx.x * S_THREADS + threadIdx.x;
  const bool valid = i < N;
  float px = 0.f, py = 0.f, pz = 0.f;
  if (valid) {
    const float* p = x + ((size_t)b * N + i) * 3;
    px = p[0]; py = p[1]; pz = p[2];
  }
  const float* yb = y + (size_t)b * M * 3;
  float best = INFINITY;
  int best_j = 0;
  for (int m0 = 0; m0 < M; m0 += S_TILE) {
    const int cnt = min(S_TILE, M - m0);
    __syncthreads();
    for (int t = threadIdx.x; t < cnt; t += S_THREADS) {
      const float* q = yb + (size_t)(m0 + t) * 3;
      ys[0][t] = q[0]; ys[1][t] = q[1]; ys[2][t] = q[2];
    }
    __syncthreads();
    if (valid) {
      for (int t = 0; t < cnt; ++t) {
        const float d = dist2(px, py, pz, ys[0][t], ys[1][t], ys[2][t]);
        if (d < best) { best = d; best_j = m0 + t; }
      }
    }
  }
  if (valid) idx[(size_t)b * N + i] = best_j;
}

// R x points a thread, y as float4, tiles staged by plain loads into one buffer
constexpr int THREADS = 128, R = 4, TILE = 1024, CHUNK = 8;
enum Mode { POINT, RESCAN, FMIN, PLAIN };

template <int MODE>
__global__ void __launch_bounds__(THREADS)
route_kernel(const float* __restrict__ x, const float* __restrict__ y, long long* __restrict__ idx,
             int N, int M, int blocks_per_body) {
  __shared__ float4 tile[TILE];
  const int b = blockIdx.x / blocks_per_body;
  const int i0 = (blockIdx.x - b * blocks_per_body) * (R * THREADS) + threadIdx.x;
  float px[R], py[R], pz[R], best[R];
  int chunk_j[R], best_j[R];
  #pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = i0 + r * THREADS;
    px[r] = py[r] = pz[r] = 0.f;
    if (i < N) {
      const float* p = x + ((size_t)b * N + i) * 3;
      px[r] = p[0]; py[r] = p[1]; pz[r] = p[2];
    }
    best[r] = INFINITY; chunk_j[r] = -1; best_j[r] = 0;
  }
  const float* yb = y + (size_t)b * M * 3;
  for (int m0 = 0; m0 < M; m0 += TILE) {
    const int cnt = min(TILE, M - m0);
    const int padded = (cnt + CHUNK - 1) / CHUNK * CHUNK;
    __syncthreads();
    for (int t = threadIdx.x; t < padded; t += THREADS) {
      const float* q = yb + (size_t)(m0 + t) * 3;
      tile[t] = t < cnt ? make_float4(q[0], q[1], q[2], 0.f) : make_float4(INFINITY, INFINITY, INFINITY, 0.f);
    }
    __syncthreads();
    for (int t = 0; t < padded; t += CHUNK) {
      if (MODE == POINT) {
        #pragma unroll
        for (int c = 0; c < CHUNK; ++c) {
          const float4 q = tile[t + c];
          #pragma unroll
          for (int r = 0; r < R; ++r) {
            const float d = dist2(px[r], py[r], pz[r], q.x, q.y, q.z);
            if (d < best[r]) { best[r] = d; best_j[r] = m0 + t + c; }
          }
        }
      } else if (MODE == RESCAN) {
        float4 q[CHUNK];
        #pragma unroll
        for (int c = 0; c < CHUNK; ++c) q[c] = tile[t + c];
        #pragma unroll
        for (int r = 0; r < R; ++r) {
          float d[CHUNK];
          float cmin = INFINITY;
          #pragma unroll
          for (int c = 0; c < CHUNK; ++c) {
            d[c] = dist2(px[r], py[r], pz[r], q[c].x, q[c].y, q[c].z);
            cmin = fminf(cmin, d[c]);
          }
          if (cmin < best[r]) {
            int first = 0;
            #pragma unroll
            for (int c = CHUNK - 1; c >= 0; --c)
              if (d[c] == cmin) first = c;
            best[r] = cmin;
            best_j[r] = m0 + t + first;
          }
        }
      } else if (MODE == FMIN) {
        float cmin[R];
        #pragma unroll
        for (int r = 0; r < R; ++r) cmin[r] = best[r];
        #pragma unroll
        for (int c = 0; c < CHUNK; ++c) {
          const float4 q = tile[t + c];
          #pragma unroll
          for (int r = 0; r < R; ++r) cmin[r] = fminf(cmin[r], dist2(px[r], py[r], pz[r], q.x, q.y, q.z));
        }
        #pragma unroll
        for (int r = 0; r < R; ++r) {
          if (cmin[r] < best[r]) chunk_j[r] = m0 + t;
          best[r] = cmin[r];
        }
      } else {  // PLAIN: the committed scan. Distances are >= +0, +inf or the positive canonical NaN: they order as signed integers
        int cmin[R];
        #pragma unroll
        for (int r = 0; r < R; ++r) cmin[r] = __float_as_int(best[r]);
        #pragma unroll
        for (int c = 0; c < CHUNK; c += 2) {
          const float4 q0 = tile[t + c], q1 = tile[t + c + 1];
          #pragma unroll
          for (int r = 0; r < R; ++r)
            cmin[r] = __vimin3_s32(cmin[r], __float_as_int(dist2(px[r], py[r], pz[r], q0.x, q0.y, q0.z)),
                                   __float_as_int(dist2(px[r], py[r], pz[r], q1.x, q1.y, q1.z)));
        }
        #pragma unroll
        for (int r = 0; r < R; ++r) {
          if (cmin[r] < __float_as_int(best[r])) chunk_j[r] = m0 + t;
          best[r] = __int_as_float(cmin[r]);
        }
      }
    }
    if (MODE == FMIN || MODE == PLAIN) {
      #pragma unroll
      for (int r = 0; r < R; ++r) {
        if (chunk_j[r] >= m0) {
          const float4* q = tile + (chunk_j[r] - m0);
          int first = 0;
          #pragma unroll
          for (int c = CHUNK - 1; c >= 0; --c)
            if (dist2(px[r], py[r], pz[r], q[c].x, q[c].y, q[c].z) == best[r]) first = c;
          best_j[r] = chunk_j[r] + first;
        }
      }
    }
  }
  #pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = i0 + r * THREADS;
    if (i < N) idx[(size_t)b * N + i] = best_j[r];
  }
}

template <int MODE>
int launch_route(const void* x, const void* y, void* idx, int B, int N, int M, void* stream) {
  const int bpb = (N + R * THREADS - 1) / (R * THREADS);
  route_kernel<MODE><<<B * bpb, THREADS, 0, (cudaStream_t)stream>>>((const float*)x, (const float*)y,
                                                                      (long long*)idx, N, M, bpb);
  return cudaGetLastError();
}
}  // namespace

extern "C" int tune_nn_simt(const void* x, const void* y, void* idx, int B, int N, int M, void* stream) {
  if (B > 65535) return cudaErrorInvalidValue;
  simt_kernel<<<dim3((N + S_THREADS - 1) / S_THREADS, B), S_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)y, (int32_t*)idx, N, M);
  return cudaGetLastError();
}
extern "C" int tune_nn_point(const void* x, const void* y, void* idx, int B, int N, int M, void* stream) {
  return launch_route<POINT>(x, y, idx, B, N, M, stream);
}
extern "C" int tune_nn_rescan(const void* x, const void* y, void* idx, int B, int N, int M, void* stream) {
  return launch_route<RESCAN>(x, y, idx, B, N, M, stream);
}
extern "C" int tune_nn_fmin(const void* x, const void* y, void* idx, int B, int N, int M, void* stream) {
  return launch_route<FMIN>(x, y, idx, B, N, M, stream);
}
extern "C" int tune_nn_plain(const void* x, const void* y, void* idx, int B, int N, int M, void* stream) {
  return launch_route<PLAIN>(x, y, idx, B, N, M, stream);
}
"""
ROUTES = ("tune_nn_simt", "tune_nn_point", "tune_nn_rescan", "tune_nn_fmin", "tune_nn_plain")


def scene_clouds(dev: torch.device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(contact [256, 1455, 3], y_pruned [256, 2048, 3], y_full [256, 20000, 3]):
    K3's operands in the production fit, built as chip_smoke.py builds them."""
    from psi_tpu_torch.body.smplx_model import fused_operands, make_fused_bundle
    from psi_tpu_torch.body.vposer import vposer_decode
    from psi_tpu_torch.data.synthetic import SyntheticBatchGenerator, make_synthetic_assets
    from psi_tpu_torch.gen.sample import generate_bodies
    from psi_tpu_torch.geometry.bodyvec import body_params_encapsulate
    from psi_tpu_torch.models.cvae_s1 import HumanCVAES1
    from psi_tpu_torch.ops.fused_skinning import fused_skinning_fwd
    from psi_tpu_torch.ops.prune import select_near_tiles
    from psi_tpu_torch.scripts.profile_fit import ASSET_KW, MODEL_KW, floor_placement
    from psi_tpu_torch.utils.init import seeded_init_
    from psi_tpu_torch.utils.precision import strict_f32

    assets, _ = make_synthetic_assets(**ASSET_KW, sdf_dtype=torch.bfloat16, device=dev)
    model = seeded_init_(HumanCVAES1(**MODEL_KW), SEED).eval().to(dev)
    batch = SyntheticBatchGenerator(num_scenes=4, batches_per_epoch=1, seed=SEED,
                                    image_size=MODEL_KW["image_size"]).next_batch(1)
    xs, cam_int, max_d = (torch.from_numpy(batch[k]).to(dev) for k in ("xs", "cam_int", "max_d"))
    scene_idx = torch.zeros(B, dtype=torch.int64, device=dev)
    x72 = generate_bodies(model, xs, cam_int, max_d, B, generator=torch.Generator(device=dev).manual_seed(SEED + 1))
    cam_ext = floor_placement(x72, assets.grid_mins[0], assets.grid_maxs[0])
    with strict_f32(), torch.no_grad():
        p = body_params_encapsulate(x72)
        pose = vposer_decode(assets.vposer, p["body_pose_vp"])
        cb, A12, cam12, _ = fused_operands(assets.smplx, p["transl"], p["global_orient"], p["betas"], pose,
                                           p["left_hand_pose"], p["right_hand_pose"], cam_ext=cam_ext)
        verts = fused_skinning_fwd(cb, A12, cam12, make_fused_bundle(assets.smplx))
        contact = verts[:, assets.contact_vids].contiguous()
        y_full = assets.scene_verts[scene_idx].contiguous()
        y_pruned = select_near_tiles(y_full, contact.mean(dim=1), M_PRUNED).contiguous()
    return contact, y_pruned, y_full


def sm_clock_under_load(fn: Callable) -> str:
    """nvidia-smi's SM clock (and its maximum) read while fn's launches run."""
    for _ in range(300):
        fn()
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    torch.cuda.synchronize()
    return out


def issue_floor_ms(pairs: int, sms: int, mhz: float) -> float:
    """The least time for ``pairs`` exact distances: EXACT_INSTRUCTIONS warp
    instructions per 32 pairs, 4 a clock on each of ``sms`` SMs, at ``mhz``."""
    return pairs * EXACT_INSTRUCTIONS / (sms * SM_ISSUE_LANES) / (mhz * 1e3)


def _usage(log: str, kernel: str) -> str:
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry" in line and kernel in line:
            return " | ".join(x.strip().replace("ptxas info    : ", "") for x in lines[i + 1:i + 4]
                              if "Used" in x or "spill" in x)
    return ""


def main(argv: List[str]) -> None:
    dev = card()
    variants = [tuple(a.split(",")) for a in argv] or DEFAULT_VARIANTS
    variants = [tuple(int(f) for f in v[:4]) + tuple(v[4:]) for v in variants]
    if any(len(v) not in (4, 5) or v[4:] not in ((), ("fma",)) for v in variants):
        raise SystemExit(__doc__)
    print(f"device: {torch.cuda.get_device_name(dev)}; nvidia-smi: {nvidia_smi()}", flush=True)
    src = (_cuda.CSRC / "chamfer_nn.cu").read_text()
    out_dir = _cuda.BUILD_DIR.parent / "tune"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _cuda.find_nvcc()
    texts = {"nn_routes": ROUTES_CU}
    for v in variants:
        text = src
        for pattern, repl in CONSTANTS:
            text, n = re.subn(pattern, repl.format(*v), text)
            if n != 1:
                raise RuntimeError(f"{pattern} matches {n} lines of chamfer_nn.cu")
        if v[4:]:
            if text.count(EXACT) != 1:
                raise RuntimeError("the exact distance line is not in chamfer_nn.cu once")
            text = text.replace(EXACT, FUSED)
        texts["nn_" + "_".join(map(str, v))] = text
    builds = []
    for stem, text in texts.items():
        cu = out_dir / f"{stem}.cu"
        cu.write_text(text)
        cmd = [nvcc, *_cuda.NVCC_FLAGS, "-o", str(cu.with_suffix(".so")), str(cu)]
        builds.append((stem, cu.with_suffix(".so"),
                       subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))

    contact, y_pruned, y_full = scene_clouds(dev)
    g = torch.Generator(device=dev).manual_seed(SEED)
    cases: Dict[str, Tuple[torch.Tensor, torch.Tensor, int]] = {  # x, y, calls a graph
        "fit 256x1455x2048": (contact, y_pruned, 20),
        "full 256x1455x20000": (contact, y_full, 4),
        "swapped 256x2048x1455": (y_pruned, contact, 20),
        "noise 256x1455x2048": (torch.rand((B, N, 3), generator=g, device=dev),
                                torch.rand((B, M_PRUNED, 3), generator=g, device=dev), 20),
    }
    committed = {name: ch.nn_argmin(x, y) for name, (x, y, _) in cases.items()}
    for name, (x, y, _) in cases.items():
        if name != "full 256x1455x20000":  # the twin takes ~0.25 s there: chip_smoke.py holds that shape
            equal = torch.equal(committed[name], ch.nn_argmin_reference(x, y))
            print(f"{name}: the committed kernel's indices equal the twin's: {equal}", flush=True)

    # (label, entry point, dtype of its index, ptxas usage)
    entries: List[Tuple[str, Callable, torch.dtype, str]] = []
    for stem, so, proc in builds:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(f"{stem}: nvcc failed\n{log[-3000:]}", flush=True)
            continue
        lib = ctypes.CDLL(str(so))
        for sym in (ROUTES if stem == "nn_routes" else ("psi_nn_argmin",)):
            fn = getattr(lib, sym)
            fn.argtypes, fn.restype = _SIG, ctypes.c_int
            if stem == "nn_routes":
                kernel = "simt_kernel" if sym == "tune_nn_simt" else f"Li{ROUTES.index(sym) - 1}E"
                entries.append((sym, fn, torch.int32 if sym == "tune_nn_simt" else torch.int64, _usage(log, kernel)))
            else:
                entries.append((f"R,THREADS,TILE,CHUNK={stem[3:]}", fn, torch.int64, _usage(log, "nn_argmin_kernel")))

    x, y, _ = cases["full 256x1455x20000"]
    clocks = sm_clock_under_load(lambda: ch.nn_argmin(x, y))
    mhz, max_mhz = (float(c.strip().split()[0]) for c in clocks.split(","))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(f"SM clock under K3's load {mhz:.0f} MHz (max {max_mhz:.0f} MHz), {sms} SMs", flush=True)
    for name, (x, y, _) in cases.items():
        pairs = x.shape[0] * x.shape[1] * y.shape[1]
        print(f"{name}: issue floor of the exact formula {issue_floor_ms(pairs, sms, mhz):.4f} ms at {mhz:.0f} MHz, "
              f"{issue_floor_ms(pairs, sms, max_mhz):.4f} ms at {max_mhz:.0f} MHz", flush=True)

    for rnd in range(2):
        for name, (x, y, calls) in cases.items():
            ms = cuda_device_ms(lambda: ch.nn_argmin(x, y), calls=calls)
            print(f"round {rnd} {name} committed kernel (wrapper): {ms:.4f} ms on the device", flush=True)
            for label, fn, dtype, usage in entries:
                idx = torch.full(x.shape[:2], -1, dtype=dtype, device=dev)

                def launch():
                    err = fn(x.data_ptr(), y.data_ptr(), idx.data_ptr(), x.shape[0], x.shape[1], y.shape[1],
                             _cuda.stream_of(x))
                    if err != 0:
                        raise RuntimeError(f"cudaError {err}")

                try:
                    launch()
                    torch.cuda.synchronize()
                    differ = int((idx.long() != committed[name]).sum())
                    ms = cuda_device_ms(launch, calls=calls)
                except RuntimeError as e:
                    print(f"round {rnd} {name} {label}: {e}", flush=True)
                    continue
                print(f"round {rnd} {name} {label}: {ms:.4f} ms on the device; indices that differ from the "
                      f"committed kernel's: {differ}" + (f"; {usage}" if rnd == 0 and usage else ""), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
