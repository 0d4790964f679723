"""Time P1's and P2's design choices at the probe's shape, without touching the tree.

    python -m psi_tpu_torch.scripts.tune_gather_probes [STRIP,CHUNK,LANE_ROWS ...]

Each argument is one variant of the constants of ``csrc/gather_probes.cu``:
P1's strip width (table columns staged per block) and row chunk (output
rows per block), and P2's rows per block; with no argument a built-in list
is tried. For each, a copy of the source with those constants is built
under ``build/tune/``. Beside them one more source, held in this file and
used nowhere else, carries the routes that were weighed against the
committed ones:

* ``l2``       P1 and P2 with no staging: every thread reads the table
               through L2. The yardstick of what staging costs.
* ``cluster``  P1 in thread-block clusters of 2, 4 or 8 along the row
               chunks: each block stages its share of the strip's rows once
               and all gather through distributed shared memory.
* ``bulk``     P2 staged by one bulk asynchronous copy on an mbarrier,
               started by one thread, in place of 16-byte cp.async.

All ``nvcc`` runs start together. Every entry point runs on a seeded
[2304, 128] f32 table with int32 indices, must equal the plain twin
exactly, and is timed on the device alone (20 launches captured in a CUDA
graph, median of 10 replays, over 20), in two rounds over all variants;
``torch.gather`` on ready int64 indices stands beside them. Then the host's
side: the time of one wrapper call between a pair of CUDA events for the
committed kernels and for ``torch.gather``, the timer's floor (an empty
pair), and the host's own time per call of the wrapper's parts. Needs an
NVIDIA card.
"""

from __future__ import annotations

import ctypes
import re
import statistics
import subprocess
import sys
import time
from typing import Callable, Dict, List, Tuple

import torch

from psi_tpu_torch.ops import _cuda
from psi_tpu_torch.ops import gather_probes as gp
from psi_tpu_torch.utils.timing import card, cuda_device_ms, cuda_ms, nvidia_smi

ROWS, L = 2304, 128
CONSTANTS = (
    (r"constexpr int ROW_STRIP = \d+;", "constexpr int ROW_STRIP = {0};"),
    (r"constexpr int ROW_CHUNK = \d+;", "constexpr int ROW_CHUNK = {1};"),
    (r"constexpr int LANE_ROWS = \d+;", "constexpr int LANE_ROWS = {2};"),
)
# (ROW_STRIP, ROW_CHUNK, LANE_ROWS): a chunk must be a whole number of 4-column units per thread
DEFAULT_VARIANTS = [(8, 128, 16), (8, 256, 8), (8, 384, 32), (8, 768, 16), (8, 1152, 16), (8, 2304, 16),
                    (4, 256, 16), (4, 512, 16), (4, 768, 16), (4, 2304, 16), (16, 128, 16), (16, 256, 16),
                    (16, 576, 16)]
_SIG = _cuda.SIGNATURES["psi_probe_row_gather"]  # every entry here: (t, idx, out, rows, L, stream)

ROUTES_CU = r"""
// Routes weighed against the committed P1 and P2 (csrc/gather_probes.cu):
// built and timed by tune_gather_probes.py only. L % 8 == 0 and 16-byte
// aligned operands, as at the probe's shape.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
namespace cg = cooperative_groups;
namespace {
constexpr int THREADS = 256;
constexpr int STRIP = 8;
constexpr int LANE_ROWS = 16;

__device__ __forceinline__ float pick(const float* s, int src, int n, int pitch) {
  return ((unsigned)src < (unsigned)n) ? s[src * pitch] : NAN;
}
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

// no staging: 4 outputs a thread, the table read through L2
template <bool kRows>
__global__ void gather_l2_kernel(const float* __restrict__ t, const int32_t* __restrict__ idx,
                                 float* __restrict__ out, int rows, int L) {
  const int u = blockIdx.x * THREADS + threadIdx.x;  // 4-column unit
  if (u >= rows * (L / 4)) return;
  const int i = u / (L / 4), j = 4 * (u % (L / 4));
  const int4 ix = __ldg(reinterpret_cast<const int4*>(idx) + u);
  float4 v;
  if (kRows) {
    const float* s = t + j;
    v = make_float4(pick(s, ix.x, rows, L), pick(s + 1, ix.y, rows, L), pick(s + 2, ix.z, rows, L),
                    pick(s + 3, ix.w, rows, L));
  } else {
    const float* s = t + (size_t)i * L;
    v = make_float4(pick(s, ix.x, L, 1), pick(s, ix.y, L, 1), pick(s, ix.z, L, 1), pick(s, ix.w, L, 1));
  }
  reinterpret_cast<float4*>(out)[u] = v;
}

// P1 in clusters along y: block `rank` of a cluster stages rows
// [rank * share, (rank + 1) * share) of its strip; a gather goes to the
// owner's shared memory. gridDim.y blocks split the output rows evenly.
__global__ void row_gather_cluster_kernel(const float* __restrict__ t, const int32_t* __restrict__ r,
                                          float* __restrict__ out, int rows, int L, int share) {
  extern __shared__ __align__(16) float smem[];  // [share][STRIP]
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int c0 = blockIdx.x * STRIP;
  const int s0 = rank * share, s1 = min(rows, s0 + share);
  for (int u = threadIdx.x; u < (s1 - s0) * 2; u += THREADS) {
    const int i = s0 + u / 2, h = 4 * (u % 2);
    cp_async16(smem + (i - s0) * STRIP + h, t + (size_t)i * L + c0 + h);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  cluster.sync();
  const int chunk = (rows + gridDim.y - 1) / gridDim.y;
  const int i0 = blockIdx.y * chunk, i1 = min(rows, i0 + chunk);
  for (int u = threadIdx.x; u < (i1 - i0) * 2; u += THREADS) {
    const int i = i0 + u / 2, h = 4 * (u % 2);
    const size_t o = (size_t)i * L + c0 + h;
    const int4 ix = __ldg(reinterpret_cast<const int4*>(r + o));
    const int src[4] = {ix.x, ix.y, ix.z, ix.w};
    float v[4];
    #pragma unroll
    for (int c = 0; c < 4; ++c) {
      v[c] = NAN;
      if ((unsigned)src[c] < (unsigned)rows) {
        const int owner = src[c] / share;
        const float* remote = cluster.map_shared_rank(smem, owner);
        v[c] = remote[(src[c] - owner * share) * STRIP + h + c];
      }
    }
    *reinterpret_cast<float4*>(out + o) = make_float4(v[0], v[1], v[2], v[3]);
  }
  cluster.sync();  // no block leaves while another may still read its shared memory
}

// P2 with its rows staged by one bulk copy
__global__ void lane_gather_bulk_kernel(const float* __restrict__ t, const int32_t* __restrict__ l,
                                        float* __restrict__ out, int rows, int L) {
  extern __shared__ __align__(128) float span[];  // [LANE_ROWS][L]
  __shared__ __align__(8) unsigned long long bar;
  const int r0 = blockIdx.x * LANE_ROWS;
  const int nr = min(LANE_ROWS, rows - r0);
  const size_t base = (size_t)r0 * L;
  const unsigned bar_addr = (unsigned)__cvta_generic_to_shared(&bar);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar_addr), "r"(1) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned bytes = (unsigned)(nr * L * sizeof(float));
    const unsigned dst = (unsigned)__cvta_generic_to_shared(span);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar_addr), "r"(bytes) : "memory");
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
                 ::"r"(dst), "l"(t + base), "r"(bytes), "r"(bar_addr) : "memory");
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int4 head[LANE_ROWS / 8];
  #pragma unroll
  for (int k = 0; k < LANE_ROWS / 8; ++k) {
    const int row = warp + k * 8;
    head[k] = make_int4(-1, -1, -1, -1);
    if (row < nr && 4 * lane < L) head[k] = __ldg(reinterpret_cast<const int4*>(l + base + (size_t)row * L) + lane);
  }
  unsigned done = 0;
  while (!done) {
    asm volatile("{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(bar_addr), "r"(0) : "memory");
  }
  #pragma unroll
  for (int k = 0; k < LANE_ROWS / 8; ++k) {
    const int row = warp + k * 8;
    if (row >= nr) break;
    const float* s = span + row * L;
    for (int j = 4 * lane; j < L; j += 128) {
      const size_t o = base + (size_t)row * L + j;
      const int4 ix = (j == 4 * lane) ? head[k] : __ldg(reinterpret_cast<const int4*>(l + o));
      *reinterpret_cast<float4*>(out + o) =
          make_float4(pick(s, ix.x, L, 1), pick(s, ix.y, L, 1), pick(s, ix.z, L, 1), pick(s, ix.w, L, 1));
    }
  }
}

bool takes(const void* a, const void* b, const void* c, int rows, int L) {
  return rows > 0 && L > 0 && L % 8 == 0 && (((uintptr_t)a | (uintptr_t)b | (uintptr_t)c) & 15) == 0;
}

template <bool kRows>
int launch_l2(const void* t, const void* idx, void* out, int rows, int L, void* stream) {
  if (!takes(t, idx, out, rows, L)) return cudaErrorInvalidValue;
  const int units = rows * (L / 4);
  gather_l2_kernel<kRows><<<(units + THREADS - 1) / THREADS, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)t, (const int32_t*)idx, (float*)out, rows, L);
  return cudaGetLastError();
}

int launch_cluster(const void* t, const void* r, void* out, int rows, int L, void* stream, int size) {
  if (!takes(t, r, out, rows, L)) return cudaErrorInvalidValue;
  const int share = (rows + size - 1) / size;
  const size_t smem = (size_t)share * STRIP * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(row_gather_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         232448);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(L / STRIP, size);  // one cluster a strip: the strip is staged once
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = size;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, row_gather_cluster_kernel, (const float*)t, (const int32_t*)r, (float*)out, rows,
                           L, share);
  return err != cudaSuccess ? err : cudaGetLastError();
}
}  // namespace

extern "C" int tune_row_l2(const void* t, const void* r, void* out, int rows, int L, void* stream) {
  return launch_l2<true>(t, r, out, rows, L, stream);
}
extern "C" int tune_lane_l2(const void* t, const void* l, void* out, int rows, int L, void* stream) {
  return launch_l2<false>(t, l, out, rows, L, stream);
}
extern "C" int tune_row_cluster2(const void* t, const void* r, void* out, int rows, int L, void* stream) {
  return launch_cluster(t, r, out, rows, L, stream, 2);
}
extern "C" int tune_row_cluster4(const void* t, const void* r, void* out, int rows, int L, void* stream) {
  return launch_cluster(t, r, out, rows, L, stream, 4);
}
extern "C" int tune_row_cluster8(const void* t, const void* r, void* out, int rows, int L, void* stream) {
  return launch_cluster(t, r, out, rows, L, stream, 8);
}
extern "C" int tune_lane_bulk(const void* t, const void* l, void* out, int rows, int L, void* stream) {
  if (!takes(t, l, out, rows, L)) return cudaErrorInvalidValue;
  lane_gather_bulk_kernel<<<(rows + LANE_ROWS - 1) / LANE_ROWS, THREADS, (size_t)LANE_ROWS * L * sizeof(float),
                            (cudaStream_t)stream>>>((const float*)t, (const int32_t*)l, (float*)out, rows, L);
  return cudaGetLastError();
}
"""
ROUTES = {"row": ("tune_row_l2", "tune_row_cluster2", "tune_row_cluster4", "tune_row_cluster8"),
          "lane": ("tune_lane_l2", "tune_lane_bulk")}


def _entry(lib: ctypes.CDLL, symbol: str):
    fn = getattr(lib, symbol)
    fn.argtypes, fn.restype = _SIG, ctypes.c_int
    return fn


def _host_us(fn: Callable, calls: int = 2000) -> float:
    """The host's time for one fn() in microseconds: a loop of calls on the
    host clock, the device drained before and after (it is never the slower)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e6


def _in_turns(fns: Dict[str, Callable], reps: int = 200) -> Dict[str, float]:
    """Median ms of one call of each fn between its own pair of CUDA events,
    the fns taken in turns so that a drift of the host reaches all alike."""
    times: Dict[str, List[float]] = {name: [] for name in fns}
    for fn in fns.values():
        fn()
    for _ in range(reps):
        for name, fn in fns.items():
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end))
    return {name: statistics.median(v) for name, v in times.items()}


def main(argv: List[str]) -> None:
    dev = card()
    variants = [tuple(int(x) for x in a.split(",")) for a in argv] or DEFAULT_VARIANTS
    if any(len(v) != 3 for v in variants):
        raise SystemExit(__doc__)
    print(f"device: {torch.cuda.get_device_name(dev)}; nvidia-smi: {nvidia_smi()}", flush=True)
    src = (_cuda.CSRC / "gather_probes.cu").read_text()
    out_dir = _cuda.BUILD_DIR.parent / "tune"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _cuda.find_nvcc()
    texts = {"routes": ROUTES_CU}
    for v in variants:
        text = src
        for pattern, repl in CONSTANTS:
            text, n = re.subn(pattern, repl.format(*v), text)
            if n != 1:
                raise RuntimeError(f"{pattern} matches {n} lines of gather_probes.cu")
        texts["probes_" + "_".join(map(str, v))] = text
    builds = []
    for stem, text in texts.items():
        cu = out_dir / f"{stem}.cu"
        cu.write_text(text)
        cmd = [nvcc, *_cuda.NVCC_FLAGS, "-o", str(cu.with_suffix(".so")), str(cu)]
        builds.append((stem, cu.with_suffix(".so"),
                       subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))

    g = torch.Generator(device=dev).manual_seed(0)
    t = torch.randn((ROWS, L), generator=g, device=dev)
    idx = {"row": torch.randint(0, ROWS, (ROWS, L), generator=g, device=dev, dtype=torch.int32),
           "lane": torch.randint(0, L, (ROWS, L), generator=g, device=dev, dtype=torch.int32)}
    idx64 = {k: v.long() for k, v in idx.items()}
    twin = {"row": gp.row_gather_reference(t, idx["row"]), "lane": gp.lane_gather_reference(t, idx["lane"])}
    out = torch.empty_like(t)

    # (label, which gather, entry point)
    entries: List[Tuple[str, str, Callable]] = []
    for stem, so, proc in builds:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(f"{stem}: nvcc failed\n{log[-3000:]}", flush=True)
            continue
        for line in log.splitlines():
            if "spill" in line and "0 bytes spill stores, 0 bytes spill loads" not in line:
                print(f"{stem}: {line.strip()}", flush=True)
        lib = ctypes.CDLL(str(so))
        if stem == "routes":
            entries += [(sym, which, _entry(lib, sym)) for which, syms in ROUTES.items() for sym in syms]
        else:
            strip, chunk, lane_rows = stem.split("_")[1:]
            entries.append((f"P1 strip {strip} chunk {chunk}", "row", _entry(lib, "psi_probe_row_gather")))
            entries.append((f"P2 rows {lane_rows}", "lane", _entry(lib, "psi_probe_lane_gather")))

    def launch(fn, which):
        # the current stream is asked at every launch: under capture it is the graph's
        err = fn(t.data_ptr(), idx[which].data_ptr(), out.data_ptr(), ROWS, L, _cuda.stream_of(t))
        if err != 0:
            raise RuntimeError(f"cudaError {err}")

    library = {"row": lambda: torch.gather(t, 0, idx64["row"]), "lane": lambda: torch.gather(t, 1, idx64["lane"])}
    for rnd in range(2):
        for which in ("row", "lane"):
            print(f"round {rnd} torch.gather ({which}): {cuda_device_ms(library[which]):.5f} ms on the device",
                  flush=True)
        seen = set()
        for label, which, fn in entries:
            if (label, which) in seen:  # P2's rows repeat across P1's variants
                continue
            seen.add((label, which))
            try:
                out.fill_(float("inf"))
                launch(fn, which)
                torch.cuda.synchronize()
                equal = torch.equal(out, twin[which])
                ms = cuda_device_ms(lambda: launch(fn, which))
            except RuntimeError as e:
                print(f"round {rnd} {label}: {e}", flush=True)
                continue
            print(f"round {rnd} {label}: {ms:.5f} ms on the device; equal to the twin: {equal}", flush=True)

    # the host's side of the committed kernels
    wrappers: Dict[str, Callable] = {
        "empty pair of events": lambda: None,
        "row_gather": lambda: gp.row_gather(t, idx["row"]),
        "torch.gather(t, 0, i64)": library["row"],
        "lane_gather": lambda: gp.lane_gather(t, idx["lane"]),
        "torch.gather(t, 1, i64)": library["lane"],
    }
    for rnd in range(3):
        turns = _in_turns(wrappers)
        print(f"round {rnd} one call between a pair of events, median of 200 taken in turns: "
              + ", ".join(f"{name} {ms:.5f} ms" for name, ms in turns.items()), flush=True)
    print("the same, each timed alone (median of 50): "
          + ", ".join(f"{name} {cuda_ms(fn, 50):.5f} ms" for name, fn in wrappers.items()), flush=True)
    entry = _entry(_cuda.library(), "psi_probe_lane_gather")
    args = (t.data_ptr(), idx["lane"].data_ptr(), out.data_ptr(), ROWS, L, _cuda.stream_of(t))
    parts: Dict[str, Callable] = {
        **{k: v for k, v in wrappers.items() if k != "empty pair of events"},
        "psi_probe_lane_gather through ctypes alone": lambda: entry(*args),
        "torch.empty_like": lambda: torch.empty_like(t),
        "_takes_twin": lambda: gp._takes_twin(t, idx["lane"], 2, "lane_gather"),
        "stream_of": lambda: _cuda.stream_of(t),
        "three data_ptr": lambda: (t.data_ptr(), idx["lane"].data_ptr(), out.data_ptr()),
    }
    for rnd in range(2):
        print(f"round {rnd} host time of one call, mean of 2000: "
              + ", ".join(f"{name} {_host_us(fn):.3f} us" for name, fn in parts.items()), flush=True)
    for name in ("row_gather", "lane_gather"):
        print(f"spread of 5 device timings of {name}: "
              + ", ".join(f"{cuda_device_ms(wrappers[name]):.5f}" for _ in range(5)) + " ms", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
