"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell is an entry of ``BENCHMARK.json``'s
``workloads``; its configuration file and its traffic file
(``benchmark/traffic/<traffic>.json``, whose ``generator`` names the general
generator in ``benchmark/generators/``) are found by name. The run builds its
inputs from the seed, sets up and warms up the program, measures for
``--seconds``, and then checks the window's results against the plain
reference. ``--trace 0`` prints the cell's end-to-end metrics, ``--trace 1``
its per-layer metrics, each read by ``benchmark/metrics/<name>.py`` from the
profiled part of the window and the program's counters.

The last line of standard output is one JSON object: correct, attempted,
failed, metrics, device, with ``--trace 1`` a breakdown, and last the
compared numbers beside their limits, which also end standard error. Without
a card (or with fewer than the cell asks for), or without the program beside
the benchmark, it prints no result and exits non-zero.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "psi_tpu")
BENCH_DIR = Path(__file__).resolve().parent


def process_start() -> float:
    """The wall time at which this process started (Linux), else now."""
    try:
        ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


T_START = process_start()


def cache_env(root: Path) -> None:
    """Set before torch is imported: every build and kernel cache inside the
    checkout, at fixed paths; no library loads JAX; one CPU thread for torch's
    and numpy's own CPU work (the window's host work is the launching thread's,
    and idle worker threads that spin share its cores)."""
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(root / "build" / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(root / "build" / "triton"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ["OMP_NUM_THREADS"] = "1"
    os.environ["MKL_NUM_THREADS"] = "1"


@dataclasses.dataclass
class Run:
    cell: Dict
    config: Dict
    traffic: Dict
    seed: int
    device: object


@contextlib.contextmanager
def steady():
    """Around the window: keep the launching thread on one core and out of the
    collector's way, so that the host's noise moves a host-bound window less.
    The objects set-up made are frozen out of the cyclic collector's scans
    (``gc.freeze``), and this thread, the one that drives the window, stays on
    the last core it may use; threads that set-up started keep their own
    placement. Both are undone afterwards."""
    gc.collect()
    gc.freeze()
    cores = sorted(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity") else []
    if len(cores) > 1:
        os.sched_setaffinity(0, {cores[-1]})
    try:
        yield
    finally:
        if len(cores) > 1:
            os.sched_setaffinity(0, set(cores))
        gc.unfreeze()


def load_cell(root: Path, name: str):
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {c["name"]: c for c in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((BENCH_DIR / "traffic" / f"{cell['traffic']}.json").read_text())
    return bench, cell, config, traffic


def cell_metrics(bench: Dict, cell: str, trace: bool) -> List[Dict]:
    """The metrics this cell reports: end-to-end without a trace, per-layer with one."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def load_reader(name: str):
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", BENCH_DIR / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


@dataclasses.dataclass
class Context:
    """What a per-layer reader reads: the traced window, the generator's counters, the run."""

    trace: object
    counters: Dict
    run: Run


def execute(bench: Dict, cell: Dict, config: Dict, traffic: Dict, seed: int, seconds: float, trace: bool,
            device, t_start: float) -> Optional[Dict]:
    """Set up, measure, check. Returns the result object."""
    import torch

    from benchmark.trace import Tracer

    run = Run(cell, config, traffic, seed, device)
    drv = importlib.import_module(f"benchmark.generators.{traffic['generator']}").Generator(run)
    drv.setup()
    setup_s = time.time() - t_start
    # without a trace, a cell with an end-to-end metric from the device's trace times the device over its window
    clock = not trace and any(m.get("source") == "device_trace" for m in cell_metrics(bench, cell["name"], False))
    tracer = Tracer(trace, float(traffic.get("trace_seconds", seconds)), device, clock=clock)
    with steady():
        e2e, counters = drv.window(seconds, tracer)
    cuda = device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    drv.release()
    if cuda:
        torch.cuda.empty_cache()
    compared = drv.check()
    limits = traffic["limits"]
    correct = all(math.isfinite(compared.get(k, math.inf)) and compared[k] <= lim for k, lim in limits.items())
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else device.type,
           "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    metrics = {}
    out = {"correct": bool(correct), "attempted": int(counters.get("attempted", counters.get("calls", 0))),
           "failed": int(counters.get("failed", 0))}
    if trace:
        view = tracer.view
        dev["busy_s"] = view.busy_s
        dev["window_s"] = view.window_s
        ctx = Context(view, counters, run)
        for m in cell_metrics(bench, cell["name"], True):
            v = load_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        out["breakdown"] = {"device_ops": view.top_ops(), "idle_gaps": view.idle_gaps()}
    else:
        e2e = dict(e2e, setup_s=setup_s)
        for m in cell_metrics(bench, cell["name"], False):
            metrics[m["name"]] = {"value": float(e2e[m["name"]]), "unit": m["unit"]}
    out["metrics"] = metrics
    out["device"] = dev
    out["compared"] = {k: {"value": compared.get(k, math.inf), "limit": lim} for k, lim in limits.items()}
    for k, v in out["compared"].items():
        print(f"compared {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    return out


def emit(out: Dict) -> int:
    """Print the result line, unless the process has loaded JAX or the JAX
    package by now: the window, the check and the readers are all behind it."""
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {', '.join(found)}", file=sys.stderr)
        return 4
    sys.stdout.flush()
    print(json.dumps(out), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = Path.cwd()
    cache_env(root)
    bench, cell, config, traffic = load_cell(root, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell['chips']} NVIDIA card(s); {n} found", file=sys.stderr)
        return 2
    if importlib.util.find_spec("psi_tpu_torch") is None:
        print("the program (psi_tpu_torch) is not beside the benchmark", file=sys.stderr)
        return 3
    out = execute(bench, cell, config, traffic, args.seed, args.seconds, bool(args.trace),
                  torch.device("cuda", 0), T_START)
    return emit(out)


if __name__ == "__main__":
    sys.exit(main())
