"""Time K1's main launch for several tile shapes, without touching the tree.

    python -m psi_tpu_torch.scripts.tune_skin_fwd TV,TB,WARPS_N,THREADS,MIN_BLOCKS [...]

Each argument is one variant of the ``FW_*`` constants of
``csrc/fused_skinning.cu``: vertices and bodies per block, warps along
the bodies, threads per block, and the blocks an SM that ptxas must leave
registers for. For each, a copy of the source with those constants is built
under ``build/tune/`` (all ``nvcc`` runs started together), loaded with
ctypes, run once at B=256, V=10475, J=55 on seeded operands and compared
bit for bit with the committed kernel's output, and its main launch (the
``stages`` bit 2 of ``psi_skin_fwd``) is timed with CUDA events: median and
minimum of 50, in two rounds over all variants. Prints ptxas' register and
spill lines beside the times. Needs an NVIDIA card.
"""

from __future__ import annotations

import ctypes
import re
import statistics
import subprocess
import sys
from typing import List

import numpy as np
import torch

from psi_tpu_torch.ops import _cuda
from psi_tpu_torch.ops import fused_skinning as fs
from psi_tpu_torch.utils.timing import card, nvidia_smi

B, V, J = 256, 10475, 55
CONSTANTS = (
    (r"constexpr int FW_TV = \d+, FW_TB = \d+;", "constexpr int FW_TV = {0}, FW_TB = {1};"),
    (r"constexpr int FW_WARPS_N = \d+;", "constexpr int FW_WARPS_N = {2};"),
    (r"constexpr int FW_THREADS = \d+;", "constexpr int FW_THREADS = {3};"),
    (r"constexpr int FW_MIN_BLOCKS = \d+;", "constexpr int FW_MIN_BLOCKS = {4};"),
)


def _operands(dev: torch.device):
    """The bundle of a synthetic SMPL-X-width model and seeded (cb, A12, cam12)."""
    from psi_tpu_torch.body.smplx_model import make_fused_bundle, synthetic_smplx

    bundle = make_fused_bundle(synthetic_smplx(num_verts=V, num_joints=J, seed=0))
    bundle = fs.SkinningBundle(*(x.to(dev) if isinstance(x, torch.Tensor) else x for x in bundle))
    rng = np.random.default_rng(1)
    ops = tuple(torch.from_numpy(rng.normal(0, s, shape).astype(np.float32)).to(dev)
                for s, shape in ((0.3, (B, bundle.n_feat)), (0.5, (B, J, 12)), (1.0, (B, 12))))
    return bundle, ops


def _ms(fn, reps: int = 50):
    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), min(times)


def main(argv: List[str]) -> None:
    dev = card()
    variants = [tuple(int(x) for x in a.split(",")) for a in argv]
    if not variants or any(len(v) != 5 for v in variants):
        raise SystemExit(__doc__)
    print(f"device: {torch.cuda.get_device_name(dev)}; nvidia-smi: {nvidia_smi()}", flush=True)
    src = (_cuda.CSRC / "fused_skinning.cu").read_text()
    out_dir = _cuda.BUILD_DIR.parent / "tune"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _cuda.find_nvcc()
    builds = []
    for v in variants:
        text = src
        for pattern, repl in CONSTANTS:
            text, n = re.subn(pattern, repl.format(*v), text)
            if n != 1:
                raise RuntimeError(f"{pattern} matches {n} lines of fused_skinning.cu")
        stem = out_dir / ("skin_fwd_" + "_".join(map(str, v)))
        stem.with_suffix(".cu").write_text(text)
        cmd = [nvcc, *_cuda.NVCC_FLAGS, "-o", str(stem.with_suffix(".so")), str(stem.with_suffix(".cu"))]
        builds.append((v, stem.with_suffix(".so"), subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                                     stderr=subprocess.STDOUT, text=True)))
    bundle, ops = _operands(dev)
    ref = fs.fused_skinning_fwd(*ops, bundle)
    args, out, _keep = fs.fwd_operands(*ops, bundle)
    stream = _cuda.stream_of(ops[0])
    libs = []
    for v, so, proc in builds:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(f"{v}: nvcc failed\n{log[-2000:]}", flush=True)
            continue
        lines = log.splitlines()
        usage = next((" | ".join(x.strip() for x in lines[i + 2:i + 4]) for i, line in enumerate(lines)
                      if "Compiling entry" in line and "skin_fwd_kernel" in line), "")
        fn = ctypes.CDLL(str(so)).psi_skin_fwd
        fn.argtypes, fn.restype = _cuda.SIGNATURES["psi_skin_fwd"], ctypes.c_int
        libs.append((v, fn, usage))
    for rnd in range(2):
        for v, fn, usage in libs:
            out.zero_()
            err = fn(*args, fs.FWD_ALL, stream)
            torch.cuda.synchronize()
            if err != 0:
                print(f"{v}: cudaError {err}", flush=True)
                continue
            median, least = _ms(lambda: fn(*args, 2, stream))
            print(f"round {rnd} TV,TB,WARPS_N,THREADS,MIN_BLOCKS={v}: main launch median {median:.4f} ms, min "
                  f"{least:.4f} ms; bits equal to the committed kernel's: {torch.equal(out, ref)}"
                  + (f"; {usage}" if rnd == 0 else ""), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
