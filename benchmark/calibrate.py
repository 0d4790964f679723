"""Readings that the limits of ``correct`` are set from: for each seed, the
compared numbers of the program against the reference (sound runs), and of
the control (the reference computed one precision step below what the
configuration states, put in the program's place), at the cell's own size
and load, in one process.

    python3 -m benchmark.calibrate --workload <cell> --seeds 1,2,3 [--control_seeds 1,2,3]
        [--fault_seeds 1,2,3] [--seconds 3] [--out build/calibrate/<cell>.jsonl]

One JSON line per seed (its program readings, with the control's where
asked), and with ``--fault_seeds`` one a seed and planted fault
(``benchmark/faults.py``). Needs the card the cell asks for.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import sys
import time
from pathlib import Path

from benchmark.run import Run, cache_env, load_cell


def readings(cell, config, traffic, seed: int, seconds: float, device, control: bool, fault: str = ""):
    import contextlib

    import torch

    from benchmark import faults
    from benchmark.trace import Tracer

    drv = importlib.import_module(f"benchmark.generators.{traffic['generator']}").Generator(Run(cell, config, traffic, seed, device))
    t0 = time.time()
    with faults.plant(fault, traffic["generator"]) if fault else contextlib.nullcontext():
        drv.setup()
        e2e, counters = drv.window(seconds, Tracer(False, 0.0, device))
    drv.release()
    out = {"seed": seed, "fault": fault, "setup_s": time.time() - t0 - seconds, "e2e": e2e, "counters": counters,
           "program": drv.check()}
    if control:
        out["control"] = drv.control()
    del drv
    gc.collect()
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control_seeds", default="")
    ap.add_argument("--fault_seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    root = Path.cwd()
    cache_env(root)
    _, cell, config, traffic = load_cell(root, args.workload)
    import torch

    if not torch.cuda.is_available():
        print("calibration needs an NVIDIA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    ctrl = {int(s) for s in args.control_seeds.split(",") if s}
    seeds = [int(s) for s in args.seeds.split(",") if s]
    out = Path(args.out or f"build/calibrate/{args.workload}.jsonl")
    out.parent.mkdir(parents=True, exist_ok=True)
    with out.open("a") as f:
        from benchmark.faults import NAMES

        runs = [(s, s in ctrl, "") for s in seeds + sorted(ctrl - set(seeds))]
        runs += [(int(s), False, f) for f in NAMES for s in args.fault_seeds.split(",") if s]
        for s, with_control, fault in runs:
            r = readings(cell, config, traffic, s, args.seconds, device, with_control, fault)
            r["workload"] = args.workload
            line = json.dumps(r)
            print(line, flush=True)
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
