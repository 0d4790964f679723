"""What does a row gather from device memory cost, by row width, dtype and
index locality? Port of ``scripts/profile_gather.py``; informs the SDF
lookup's design (one row per vertex, 2.68M rows per fit iteration).

    python -m psi_tpu_torch.scripts.profile_gather

Each case gathers B x N = 256 x 10475 rows from a table of 4 x 128^3 rows,
20 times with the index shifted by the loop counter, and sums each row
(upcast to f32) into an accumulator. Indices are random, sorted along
each body, or local (a random base per body plus offsets below 65536).
Reported per gather: ms and ns per row (CUDA events over 3 runs after a
warm-up). Tables and indices are made on the card from a seed; the widest
table, 128 f32 columns, is 4.3 GB. Needs an NVIDIA card.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from psi_tpu_torch.utils.timing import card, nvidia_smi

B, N = 256, 10475
R = 4 * 128 * 128 * 128  # table rows (4 scenes x 128^3)
ITERS = 20
CASES = [  # (width, dtype, index mode), in the JAX script's order
    (8, torch.float32, "random"), (8, torch.float16, "random"), (16, torch.float32, "random"),
    (32, torch.float32, "random"), (128, torch.float32, "random"), (1, torch.float32, "random"),
    (8, torch.float32, "sorted"), (8, torch.float32, "local"), (8, torch.bfloat16, "random"),
]


def _indices(g: torch.Generator, mode: str, dev: torch.device) -> torch.Tensor:
    if mode == "local":
        base = torch.randint(0, R - 70000, (B, 1), generator=g, device=dev)
        return base + torch.randint(0, 65536, (B, N), generator=g, device=dev)
    idx = torch.randint(0, R, (B, N), generator=g, device=dev)
    return torch.sort(idx, dim=1).values if mode == "sorted" else idx


def harness(dev: torch.device, width: int, dtype: torch.dtype, mode: str, reps: int = 3) -> Dict:
    g = torch.Generator(device=dev).manual_seed(0)
    table = torch.randn((R, width), generator=g, device=dev).to(dtype)
    idxs = [_indices(g, mode, dev) for _ in range(reps + 1)]

    def run(idx):
        acc = torch.zeros((B, N), device=dev)
        for i in range(ITERS):
            # the index moves with the loop counter, as in the JAX scan
            acc = acc + table[(idx + i) % R].float().sum(dim=-1)
        return acc

    total = run(idxs[0]).sum()  # warm-up
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        total = total + run(idxs[1 + i]).sum()
    end.record()
    end.synchronize()
    ms_iter = start.elapsed_time(end) / reps / ITERS
    res = {"width": width, "dtype": str(dtype).replace("torch.", ""), "mode": mode,
           "ms_per_iter": ms_iter, "ns_per_row": ms_iter * 1e6 / (B * N)}
    print(f"width={width:<4} {res['dtype']:<9} {mode:<7} {ms_iter:9.4f} ms/iter  "
          f"{res['ns_per_row']:8.4f} ns/row  (acc={total.item():.3g})", flush=True)
    return res


def run_all(dev: torch.device) -> List[Dict]:
    return [harness(dev, *case) for case in CASES]


def main() -> None:
    dev = card()
    print(f"device: {torch.cuda.get_device_name(dev)}; nvidia-smi: {nvidia_smi()}", flush=True)
    run_all(dev)


if __name__ == "__main__":
    main()
