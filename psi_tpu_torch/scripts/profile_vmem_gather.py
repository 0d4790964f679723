"""Can a shared-memory gather beat the global-memory gather for the
trilinear SDF corner fetch? Port of ``scripts/profile_vmem_gather.py``.

    python -m psi_tpu_torch.scripts.profile_vmem_gather [support|throughput|relayout|hbm ...]

The fit's SDF lookup is one packed 8-float row gathered from device
memory per body vertex (``ops/sdf.py::sdf_trilinear_packed``). The
candidate replacement stages a sub-box of the SDF in fast on-chip memory
and fetches the corners from there. The phases measure the primitives
alone, at the JAX script's shapes:

  support     P1 (row gather, axis 0) and P2 (lane gather, axis 1) on
              [rows, 128] f32 tables, rows in {8, 128, 512, 2304}
  throughput  P3: 8 chained lane gathers per body, 256 bodies x [512, 128]
  relayout    P4: 7 x ([18, 128] -> [2304, 1] broadcast to [2304, 128]) per
              body, 256 bodies; bound by writing its 288 MiB output
  hbm         the packed-row gather from device memory (plain torch
              indexing): 256 x 10475 indices into 4 x 128^3 8-float rows

Each kernel phase holds the kernel to its plain twin (exactly equal) and
times both with CUDA events, by two timers: one wrapper call between a pair
of events (median of 10 after a warm-up; mostly the call's host path when
the kernel takes microseconds) and the device's time alone (20 calls
captured in a CUDA graph, the replay's time over 20). P1 and P2 also stand
beside the one PyTorch call that computes them (``torch.gather`` on
int64 indices; P3 and P4 have no such call). Each result carries the
bytes the function must move (inputs read once, output written once) and
its f32 operations, from which a caller works out its bound. The last line
sets the global gather's ns per index beside the shared-memory gathers'
elements per second. Needs an NVIDIA card; inputs come from a seed.
"""

from __future__ import annotations

import sys
from typing import Dict, List

import torch

from psi_tpu_torch.ops import gather_probes as gp
from psi_tpu_torch.utils.timing import card, cuda_device_ms, cuda_ms, nvidia_smi

R, L = 2304, 128  # table shape: 48x48 (x, y) rows, 128 (z) lanes
SUPPORT_ROWS = (8, 128, 512, 2304)
PHASES = ("support", "throughput", "relayout", "hbm")


def _generator(dev: torch.device) -> torch.Generator:
    return torch.Generator(device=dev).manual_seed(0)


def _nbytes(*tensors: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _held_to_twin(tag: str, what: str, kernel_fn, twin_fn, elems: int, inputs, f32_ops: int = 0,
                  library_fn=None) -> Dict:
    """Run kernel and twin once, require equal outputs, time both (and the
    one PyTorch call that computes the same, if there is one) as a wrapper
    call and on the device alone; one line."""
    out, ref = kernel_fn(), twin_fn()
    torch.cuda.synchronize()
    equal = torch.equal(out, ref)
    err = (out - ref).abs().max().item()
    fns = {"kernel": kernel_fn, "twin": twin_fn}
    if library_fn is not None:
        fns["library call"] = library_fn
    call = {name: cuda_ms(fn) for name, fn in fns.items()}
    device = {name: cuda_device_ms(fn) for name, fn in fns.items()}
    rate = elems / (call["kernel"] * 1e-3)
    print(f"[{tag}] {what}: kernel == twin: {equal} (max abs err {err:.3e}, tol 0); "
          + ", ".join(f"{name} {call[name]:.4f} ms a call, {device[name]:.4f} ms on the device" for name in fns)
          + f"; {rate / 1e9:.2f} G elems/s", flush=True)
    if not equal:
        raise AssertionError(f"{tag} {what}: kernel disagrees with its twin (max abs err {err})")
    return {"max_abs_err": err, "ms": call["kernel"], "plain_ms": call["twin"], "library_ms": call.get("library call"),
            "device_ms": device["kernel"], "plain_device_ms": device["twin"],
            "library_device_ms": device.get("library call"), "elems_per_s": rate,
            "bytes": _nbytes(*inputs, out), "f32_ops": f32_ops}


def support(dev: torch.device) -> Dict[str, Dict]:
    """P1 and P2 at each table height; keys 'row<rows>' and 'lane<rows>'."""
    g = _generator(dev)
    out = {}
    for rows in SUPPORT_ROWS:
        t = torch.randn((rows, L), generator=g, device=dev)
        ri = torch.randint(0, rows, (rows, L), generator=g, device=dev, dtype=torch.int32)
        li = torch.randint(0, L, (rows, L), generator=g, device=dev, dtype=torch.int32)
        ri64, li64 = ri.long(), li.long()
        out[f"row{rows}"] = _held_to_twin(
            "P1", f"row gather (axis=0) [{rows},{L}]",
            lambda: gp.row_gather(t, ri), lambda: gp.row_gather_reference(t, ri), rows * L, (t, ri),
            library_fn=lambda: torch.gather(t, 0, ri64))
        out[f"lane{rows}"] = _held_to_twin(
            "P2", f"lane gather (axis=1) [{rows},{L}]",
            lambda: gp.lane_gather(t, li), lambda: gp.lane_gather_reference(t, li), rows * L, (t, li),
            library_fn=lambda: torch.gather(t, 1, li64))
    return out


def throughput(dev: torch.device, n_gathers: int = 8, grid_n: int = 256, rows: int = 512) -> Dict:
    """P3: per body, n_gathers lane gathers on a [rows, 128] table."""
    g = _generator(dev)
    t = torch.randn((grid_n, rows, L), generator=g, device=dev)
    li = torch.randint(0, L, (grid_n, rows, L), generator=g, device=dev, dtype=torch.int32)
    res = _held_to_twin(
        "P3", f"{n_gathers} chained lane gathers x {grid_n} bodies x [{rows},{L}]",
        lambda: gp.chained_gather(t, li, n_gathers), lambda: gp.chained_gather_reference(t, li, n_gathers),
        n_gathers * grid_n * rows * L, (t, li), f32_ops=n_gathers * grid_n * rows * L)  # one add per gathered element
    res["us_per_gather"] = res["ms"] * 1e3 / (n_gathers * grid_n)
    print(f"[P3] {res['us_per_gather']:.4f} us per [{rows},{L}] gather", flush=True)
    return res


def relayout(dev: torch.device, grid_n: int = 256, n_arrays: int = 7) -> Dict:
    """P4: per body, n_arrays [18, 128] -> [2304, 1] relayouts summed and
    broadcast to [2304, 128]."""
    c = torch.randn((grid_n, R // L, L), generator=_generator(dev), device=dev)
    res = _held_to_twin(
        "P4", f"{n_arrays} x (18,128)->(2304,1) per body x {grid_n}",
        lambda: gp.relayout(c, n_arrays, L), lambda: gp.relayout_reference(c, n_arrays, L), grid_n * R * L, (c,),
        f32_ops=2 * n_arrays * grid_n * R)  # c + k, then the running sum, per row
    written = 4 * grid_n * R * L
    res["write_bytes_per_s"] = written / (res["ms"] * 1e-3)
    res["us_per_relayout"] = res["ms"] * 1e3 / (n_arrays * grid_n)
    print(f"[P4] bound by writing {written / 2**20:.0f} MiB: {res['write_bytes_per_s'] / 1e9:.1f} GB/s; "
          f"{res['us_per_relayout']:.4f} us per relayout", flush=True)
    return res


def hbm(dev: torch.device, n_bodies: int = 256, n_verts: int = 10475, dim: int = 128) -> Dict:
    """The packed-row gather from device memory, as the fit's SDF lookup does it."""
    g = _generator(dev)
    rows = torch.randn((4 * dim ** 3, 8), generator=g, device=dev)
    idx = torch.randint(0, rows.shape[0], (n_bodies, n_verts), generator=g, device=dev)
    ms = cuda_ms(lambda: rows[idx].sum(dim=-1))
    n_idx = n_bodies * n_verts
    res = {"ms": ms, "ns_per_index": ms * 1e6 / n_idx, "indices_per_s": n_idx / (ms * 1e-3)}
    print(f"[hbm] packed 8-float rows, {n_idx} indices into {rows.shape[0]} rows: {ms:.4f} ms/call, "
          f"{res['ns_per_index']:.4f} ns/index ({res['indices_per_s'] / 1e9:.2f} G indices/s)", flush=True)
    return res


def run(dev: torch.device, phases=PHASES) -> Dict[str, Dict]:
    """The named phases in order; returns each phase's results."""
    fns = {"support": support, "throughput": throughput, "relayout": relayout, "hbm": hbm}
    unknown = [p for p in phases if p not in fns]
    if unknown:
        raise ValueError(f"unknown phases {unknown}; choose from {list(fns)}")
    out = {p: fns[p](dev) for p in phases}
    if "hbm" in out and "throughput" in out:
        print(f"[compare] global packed-row gather {out['hbm']['ns_per_index']:.4f} ns/index "
              f"({out['hbm']['indices_per_s'] / 1e9:.2f} G rows/s) vs shared-memory chained lane gathers "
              f"{out['throughput']['elems_per_s'] / 1e9:.2f} G elems/s", flush=True)
    return out


def main(argv: List[str]) -> None:
    dev = card()
    print(f"device: {torch.cuda.get_device_name(dev)}; nvidia-smi: {nvidia_smi()}", flush=True)
    run(dev, argv or PHASES)


if __name__ == "__main__":
    main(sys.argv[1:])
