"""Serving soak: sustained mixed-size load through ServingQueue on the card.

The port's counterpart of ``scripts/soak_serve.py``. Drives the production
serving stack (population 256, FitConfig.production(num_iter=20), bf16
corner-packed 128^3 SDF grids, 10475 vertices, 20k-point scene clouds,
``HumanCVAES1(latentD=256)`` with seeded random weights) with mixed-size
generate and generate+fit requests from 3 client threads (rows drawn from
{1, 4, 16, 64}, 70% fitted, at most 4 requests in flight a client), and
reports:

  - per bucket (30 s unless --bucket): requests, p50/p99 end-to-end latency
  - queue depth sampled once a second (max per bucket)
  - host RSS sampled once a second (leak check for the host)
  - torch.cuda.memory_allocated and max_memory_allocated, read while no
    program runs (under the engine's lock); the least reading of a bucket is
    the bucket's (leak check for the card; the baseline is read after one
    request of each kind has gone through the queue's worker thread)
  - a malformed storm at the half-way mark (200 requests unless --storm:
    negative, non-integer, missing-snapshot and mis-shaped; every future
    must fail cleanly; the next valid request must still complete)

    python -m psi_tpu_torch.scripts.soak_serve [--duration S] [--tiny] [--storm N] [--bucket S] [--device D]

Needs an NVIDIA card. ``--tiny --device cpu`` runs the same load at toy
sizes on the CPU, to check the script itself; the full size is never run
on the CPU.
"""

from __future__ import annotations

import argparse
import json
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

SEED = 0
TINY_ASSETS = dict(num_verts=100, num_joints=12, num_scenes=2, sdf_dim=16, scene_points=200, n_contact=32)
FULL_ASSETS = dict(num_verts=10475, num_joints=55, num_scenes=4, sdf_dim=128, scene_points=20000, n_contact=1455)
ROWS = (1, 4, 16, 64)
FIT_SHARE = 0.7  # fit-heavy: the expensive path
CLIENTS = 3
IN_FLIGHT = 4  # per client: keeps the offered load about steady


def rss_mb() -> float:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS"):
                return int(line.split()[1]) / 1024.0
    return float("nan")


def make_snapshot(rng, depth):
    return {
        "xs": rng.normal(size=(1, 128, 128, 2)).astype(np.float32),
        "cam_int": np.eye(3, dtype=np.float32)[None] * 500,
        "cam_ext": np.eye(4, dtype=np.float32)[None],
        "max_d": np.asarray([depth], np.float32),
    }


def build_engine(device: torch.device, tiny: bool):
    """The soak's engine: the production stack, or with ``tiny`` a toy one."""
    from psi_tpu_torch.data.synthetic import make_synthetic_assets
    from psi_tpu_torch.models.cvae_s1 import HumanCVAES1
    from psi_tpu_torch.serve import GenerationEngine
    from psi_tpu_torch.utils.config import FitConfig
    from psi_tpu_torch.utils.init import seeded_init_

    if tiny:
        asset_kw, population, num_iter = dict(TINY_ASSETS), 16, 2
    else:
        asset_kw, population, num_iter = dict(FULL_ASSETS, sdf_dtype=torch.bfloat16), 256, 20
    assets, _ = make_synthetic_assets(**asset_kw, seed=SEED, device=device)
    model = seeded_init_(HumanCVAES1(latentD=256), SEED)
    return GenerationEngine(model, assets, population=population,
                            fit_cfg=FitConfig.production(num_iter=num_iter), seed=SEED, device=device)


def device_mb(engine) -> Optional[Dict[str, float]]:
    """Device memory in MB while none of the engine's programs runs, or None
    on the CPU."""
    if engine.device.type != "cuda":
        return None
    with engine._lock:
        return {"allocated": torch.cuda.memory_allocated(engine.device) / 1e6,
                "max_allocated": torch.cuda.max_memory_allocated(engine.device) / 1e6}


def run(engine, duration: float = 330.0, storm: int = 200, bucket_s: float = 30.0,
        log: Callable[[str], None] = print) -> Dict:
    """The soak on a warmed ``engine``; returns the record that ``main`` prints."""
    from psi_tpu_torch.serve import ServingQueue

    q = ServingQueue(engine)
    stop = threading.Event()
    lat_lock = threading.Lock()
    latencies = []  # (t_done, latency_s, fitted, rows)
    errors: List[str] = []

    def settle(fut, fit, rows):
        try:
            r = fut.result(timeout=120)
            with lat_lock:
                latencies.append((time.time(), r.latency_s, fit, rows))
        except Exception as e:  # noqa: BLE001 - the soak counts every failure
            with lat_lock:
                errors.append(repr(e))

    def client(cid):
        rng = np.random.default_rng(cid)
        pending = []
        while not stop.is_set():
            rows = int(rng.choice(ROWS))
            fit = bool(rng.random() < FIT_SHARE)
            fut = q.submit(make_snapshot(rng, float(rng.uniform(3, 6))), n_samples=rows, fit=fit)
            pending.append((fut, fit, rows))
            while len(pending) >= IN_FLIGHT and not stop.is_set():
                settle(*pending.pop(0))
            time.sleep(0.002)
        for item in pending:
            settle(*item)

    depth_samples, rss_samples, mem_samples = [], [], []  # (t, value)

    def monitor():
        while not stop.is_set():
            now = time.time()
            depth_samples.append((now, q._q.qsize()))
            mem = device_mb(engine)
            if mem is not None:
                mem_samples.append((time.time(), mem))
            rss_samples.append((now, rss_mb()))
            time.sleep(1.0)

    # one request of each kind before the clock starts: the worker thread gets its own cuBLAS handle
    # and workspace at its first product (some 35 MB, once a thread), which belongs in the baseline
    warm_rng = np.random.default_rng(998)
    for fit in (False, True):
        q.submit(make_snapshot(warm_rng, 5.0), n_samples=1, fit=fit).result(timeout=300)
    warm = q.stats()
    mem_before = device_mb(engine)
    threads = [threading.Thread(target=client, args=(c,), daemon=True) for c in range(CLIENTS)]
    mon = threading.Thread(target=monitor, daemon=True)
    t0 = time.time()
    mon.start()
    for t in threads:
        t.start()

    # half-way malformed storm
    time.sleep(duration / 2)
    rng = np.random.default_rng(999)
    storm_futs = []
    for k in range(storm):
        kind = k % 4
        if kind == 0:
            f = q.submit(make_snapshot(rng, 5.0), n_samples=-3, fit=True)
        elif kind == 1:
            f = q.submit(make_snapshot(rng, 5.0), n_samples="many", fit=True)
        elif kind == 2:
            f = q.submit({"cam_int": np.eye(3, dtype=np.float32)}, n_samples=4)  # missing xs
        else:
            bad = make_snapshot(rng, 5.0)
            bad["xs"] = np.zeros((7,), np.float32)  # wrong rank
            f = q.submit(bad, n_samples=4, fit=False)
        storm_futs.append(f)
    failed = 0
    for f in storm_futs:
        try:
            f.result(timeout=60)
        except Exception:  # noqa: BLE001 - a malformed request must fail, whatever it raises
            failed += 1
    # the queue must still serve a valid request after the storm
    ok = q.submit(make_snapshot(rng, 5.0), n_samples=8, fit=True).result(timeout=120)
    storm_done = {"malformed": len(storm_futs), "failed_cleanly": failed,
                  "post_storm_ok": bool(ok.bodies.shape == (8, 72) and np.isfinite(ok.bodies).all())}
    log(f"[storm] {storm_done}")

    time.sleep(max(0.0, duration - (time.time() - t0)))
    stop.set()
    for t in threads:
        t.join(timeout=180)
    mon.join(timeout=30)
    q.stop()
    wall = time.time() - t0
    mem_after = device_mb(engine)

    buckets = []
    log(f"{'bucket':>7} {'reqs':>5} {'req/s':>7} {'p50_ms':>8} {'p99_ms':>8} {'maxdepth':>8} {'rss_mb':>8} "
        f"{'dev_mb':>9} {'dev_max_mb':>10}")
    for b in range(int(np.ceil(wall / bucket_s))):
        lo, hi = t0 + bucket_s * b, t0 + bucket_s * (b + 1)
        ls = [l for (t, l, _, _) in latencies if lo <= t < hi]
        ds = [d for (t, d) in depth_samples if lo <= t < hi]
        rs = [r for (t, r) in rss_samples if lo <= t < hi]
        ms = [m for (t, m) in mem_samples if lo <= t < hi]
        if not ls:
            continue
        row = {"bucket": b, "requests": len(ls), "requests_per_s": len(ls) / min(bucket_s, wall - bucket_s * b),
               "p50_ms": float(np.percentile(ls, 50) * 1e3), "p99_ms": float(np.percentile(ls, 99) * 1e3),
               "max_depth": max(ds) if ds else 0, "rss_mb": rs[-1] if rs else None,
               "device_mb": min(m["allocated"] for m in ms) if ms else None,
               "device_max_mb": max(m["max_allocated"] for m in ms) if ms else None}
        buckets.append(row)
        # the last bucket is the drain after the monitor has stopped: it may hold no sample
        rss = f"{row['rss_mb']:>8.1f}" if rs else f"{'-':>8}"
        dev = f"{row['device_mb']:>9.2f} {row['device_max_mb']:>10.2f}" if ms else f"{'-':>9} {'-':>10}"
        log(f"{b:>7} {row['requests']:>5} {row['requests_per_s']:>7.2f} {row['p50_ms']:>8.1f} {row['p99_ms']:>8.1f} "
            f"{row['max_depth']:>8} {rss} {dev}")

    def pct(ls, p):
        return float(np.percentile(ls, p) * 1e3) if ls else float("nan")

    ls = [l for (_, l, _, _) in latencies]
    fit_ls = [l for (_, l, f, _) in latencies if f]
    gen_ls = [l for (_, l, f, _) in latencies if not f]
    rows_total = sum(r for (_, _, _, r) in latencies)
    stats = {k: q.stats()[k] - warm[k] for k in ("requests", "batches")}  # without the two that warmed the worker
    res = {
        "wall_s": wall, "requests": len(ls), "errors": len(errors), "errors_sample": errors[:5], "rows": rows_total,
        "bodies_per_s": rows_total / wall, "batches": stats["batches"],
        "requests_per_batch": stats["requests"] / max(stats["batches"], 1),
        "p50_ms": pct(ls, 50), "p99_ms": pct(ls, 99), "fit_p50_ms": pct(fit_ls, 50), "fit_p99_ms": pct(fit_ls, 99),
        "gen_p50_ms": pct(gen_ls, 50), "gen_p99_ms": pct(gen_ls, 99),
        "rss_first_mb": rss_samples[0][1] if rss_samples else float("nan"),
        "rss_last_mb": rss_samples[-1][1] if rss_samples else float("nan"),
        "device_before_mb": mem_before, "device_after_mb": mem_after, "buckets": buckets, "storm": storm_done,
    }
    log(f"SOAK wall={wall:.0f}s requests={len(ls)} errors={len(errors)} rows={rows_total} "
        f"({res['bodies_per_s']:.2f} bodies/s served) batches={stats['batches']} "
        f"coalesce={res['requests_per_batch']:.2f} req/batch")
    log(f"  all  p50={res['p50_ms']:.0f}ms p99={res['p99_ms']:.0f}ms | fit p50={res['fit_p50_ms']:.0f} "
        f"p99={res['fit_p99_ms']:.0f} | gen p50={res['gen_p50_ms']:.0f} p99={res['gen_p99_ms']:.0f}")
    log(f"  rss {res['rss_first_mb']:.0f} -> {res['rss_last_mb']:.0f} MB (delta "
        f"{res['rss_last_mb'] - res['rss_first_mb']:+.0f}); storm={storm_done}")
    if mem_before is not None:
        log(f"  device memory allocated, idle: {mem_before['allocated']:.2f} MB before -> {mem_after['allocated']:.2f} MB "
            f"after (delta {mem_after['allocated'] - mem_before['allocated']:+.2f}); max allocated "
            f"{mem_after['max_allocated']:.2f} MB")
    if errors:
        log(f"  errors sample: {errors[:5]}")
    return res


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--duration", type=float, default=330.0, help="seconds of load")
    p.add_argument("--tiny", action="store_true", help="toy sizes (population 16, 2 iterations)")
    p.add_argument("--storm", type=int, default=200, help="malformed requests at half time")
    p.add_argument("--bucket", type=float, default=30.0, help="seconds per reported bucket")
    p.add_argument("--device", type=str, default=None, help="default: the first NVIDIA card; 'cpu' only with --tiny")
    args = p.parse_args(argv)

    smi = None
    if args.device == "cpu":
        if not args.tiny:
            raise SystemExit("needs an NVIDIA card: the full-size soak is not run on the CPU (--tiny --device cpu is)")
        device = torch.device("cpu")
    else:
        from psi_tpu_torch.utils.timing import card, nvidia_smi

        card()
        device = torch.device(args.device or "cuda:0")
        smi = nvidia_smi()
        print(f"device: {torch.cuda.get_device_name(device)}; nvidia-smi: {smi}", flush=True)

    log = lambda msg: print(msg, flush=True)
    engine = build_engine(device, args.tiny)
    t_warm = engine.warmup()
    log(f"warmup {t_warm:.1f}s  population={engine.population} iters={engine.fit_cfg.num_iter}")
    res = run(engine, duration=args.duration, storm=args.storm, bucket_s=args.bucket, log=log)
    print(json.dumps({"card": smi, "warmup_s": t_warm, **res}), flush=True)


if __name__ == "__main__":
    main()
