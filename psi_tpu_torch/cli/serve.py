"""Serving CLI: JSONL requests on stdin -> JSONL responses on stdout.

Port of ``psi_tpu.cli.serve``.

Request:  {"id": "r1", "npz": "<path to snapshot npz with xs/cam_int/cam_ext/max_d>",
           "n_samples": 32, "fit": true, "scene_idx": 0, "model": "s1"}
Response: {"id": "r1", "n": 32, "latency_s": ..., "batch_size": ..., "out": "<path written>"}

Requests are micro-batched: lines arriving while a program call is in
flight (or within the linger window) coalesce into ONE program call
(ServingQueue). ``batch_size`` in the response says how many requests
shared it. The line ``stats`` emits queue statistics including
p50/p99 end-to-end latency and queue wait and the median program call;
a stats record is also emitted at shutdown.

STREAMING: a request whose n_samples exceeds the population is
served as multiple chunk sub-requests; one response record per chunk is
emitted AS IT COMPLETES, with "chunk"/"n_chunks"/"final" fields, so a
client asking for thousands of bodies sees the first population-size
batch at single-request latency.

WARMUP: --warmup selects which of the four serving programs run once
before "ready" (all/none/comma list) — deployments that use one path
skip the others' first-call costs.

The server runs on the first NVIDIA card unless --device names another
device, and exits with an error without one.

  python -m psi_tpu_torch.cli.serve --ckpt_dir ckpts --population 256 [--synthetic]
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--model_type", type=str, default="s1", choices=["s1", "s2"])
    p.add_argument("--ckpt_dir", type=str, default=None)
    p.add_argument(
        "--model", action="append", default=None, metavar="TYPE[=CKPT_DIR]",
        help="serve this model (repeatable, e.g. --model s1=ckpts/s1 --model s2=ckpts/s2); "
        "requests pick one via their 'model' field (default: first). "
        "Overrides --model_type/--ckpt_dir.",
    )
    p.add_argument("--population", type=int, default=256)
    p.add_argument("--latentD", type=int, default=256)
    p.add_argument("--out_dir", type=str, default="serve_out")
    p.add_argument("--linger_ms", type=float, default=5.0,
                   help="micro-batch window after the first queued request")
    p.add_argument("--refresh_every", type=int, default=10,
                   help="fit-loss selection-refresh schedule (production "
                   "default 10; 1 = full loss every iteration; contact "
                   "candidate pruning still applies — see "
                   "--prune_scene_points)")
    p.add_argument("--lbs_precision", type=str, default="fused",
                   choices=["high", "fast", "fused"],
                   help="LBS tier inside the fit loss (production default "
                   "'fused' = one CUDA kernel for the whole vertex path)")
    p.add_argument("--prune_scene_points", type=int, default=2048,
                   help="contact-NN candidate set size (0 = exact full-scene "
                   "NN search; with refresh_every=1 and 0 here the fit is "
                   "fully reference-exact)")
    p.add_argument("--warmup", type=str, default="all",
                   help="comma-separated serving programs to run once before "
                   "'ready': subset of single,single_fit,coalesced,"
                   "coalesced_fit; 'all' (default) or 'none'. A skipped "
                   "program pays its first-call costs on its first live "
                   "request — select only what the deployment uses")
    from psi_tpu_torch.cli.common import add_asset_args

    add_asset_args(p)
    return p


def main(argv=None, stdin=None, stdout=None):
    args = build_parser().parse_args(argv)
    stdin = stdin or sys.stdin
    stdout = stdout or sys.stdout

    import numpy as np

    from psi_tpu_torch.cli.common import build_assets, resolve_device
    from psi_tpu_torch.serve import GenerationEngine, ServingRouter
    from psi_tpu_torch.train.checkpoint import load_newest_checkpoint
    from psi_tpu_torch.train.loop import init_state
    from psi_tpu_torch.utils.config import FitConfig, TrainConfig

    # model roster: repeatable --model TYPE[=CKPT_DIR], else the single
    # --model_type/--ckpt_dir pair
    roster = []
    for spec in args.model or [f"{args.model_type}={args.ckpt_dir or ''}"]:
        mtype, _, ckpt = spec.partition("=")
        if mtype in (r[0] for r in roster):
            raise SystemExit(
                f"duplicate --model {mtype!r}: model names route requests, so two "
                f"checkpoints cannot share one (the second would silently win)"
            )
        roster.append((mtype, ckpt or None))

    device = resolve_device(args.device)
    assets, _ = build_assets(args, device=device)
    engines = {}
    for mtype, ckpt_dir in roster:
        cfg = TrainConfig(model_type=mtype, latentD=args.latentD)
        state = init_state(cfg, device)
        if ckpt_dir:
            load_newest_checkpoint(ckpt_dir, state)  # in place; None when the directory has none
        engines[mtype] = GenerationEngine(
            state.model, assets, population=args.population,
            fit_cfg=FitConfig(
                refresh_every=args.refresh_every,
                lbs_precision=args.lbs_precision,
                prune_scene_points=args.prune_scene_points,
            ),
            device=device,
        )

    if args.warmup == "none":
        programs = ()
    elif args.warmup == "all":
        programs = None  # engine default: all four
    else:
        programs = tuple(s for s in args.warmup.split(",") if s)
    per_model_warm = {
        name: round(e.warmup(programs=programs), 2) if programs != () else 0.0
        for name, e in engines.items()
    }
    print(
        json.dumps({
            "status": "ready", "warmup_s": round(sum(per_model_warm.values()), 2),
            "warmup_per_model_s": per_model_warm,
            "warmup_programs": list(programs) if programs is not None else "all",
            "models": list(engines),
        }),
        file=stdout, flush=True,
    )

    q = ServingRouter(engines, linger_s=args.linger_ms / 1000.0)
    os.makedirs(args.out_dir, exist_ok=True)

    import queue as _queue
    import threading

    done_q: "_queue.Queue" = _queue.Queue()
    # the responder thread and the main loop (stats lines) share stdout;
    # a lock keeps each JSONL record atomic (print writes the payload
    # and the newline separately)
    out_lock = threading.Lock()

    def _emit(obj):
        with out_lock:
            print(json.dumps(obj), file=stdout, flush=True)

    def _responder():
        # prints responses in submission order as results resolve; the
        # main thread stays free to read stdin, so bursts coalesce.
        # Streamed (chunked) requests emit one record per chunk as it
        # lands — the client sees partial populations immediately.
        while True:
            item = done_q.get()
            if item is None:
                return
            rid, fut, chunk, n_chunks = item
            try:
                res = fut.result()
            except Exception as e:
                err = {"id": rid, "error": str(e)}
                if n_chunks > 1:
                    err["chunk"] = chunk
                _emit(err)
                continue
            suffix = f".chunk{chunk:03d}" if n_chunks > 1 else ""
            out_path = os.path.join(args.out_dir, f"{rid}{suffix}.npy")
            np.save(out_path, res.bodies)
            rec = {
                "id": rid, "n": int(res.bodies.shape[0]),
                "latency_s": round(res.latency_s, 4),
                "batch_size": res.batch_size, "out": out_path,
            }
            if n_chunks > 1:
                rec["chunk"] = chunk
                rec["n_chunks"] = n_chunks
                rec["final"] = chunk == n_chunks - 1
            _emit(rec)

    responder = threading.Thread(target=_responder, daemon=True)
    responder.start()

    for line in stdin:
        line = line.strip()
        if not line:
            continue
        if line == "quit":
            break
        if line == "stats":
            _emit({"stats": q.stats()})
            continue
        # a malformed line (bad JSON, missing npz file) must fail only
        # ITS request — other coalesced clients are in flight on this
        # same loop, so tearing down the server here would abandon them
        req = None
        try:
            req = json.loads(line)
            batch = dict(np.load(req["npz"])) if "npz" in req else {
                "xs": np.zeros((1, 128, 128, 2), np.float32),
                "cam_int": np.eye(3, dtype=np.float32)[None] * 500,
                "cam_ext": np.eye(4, dtype=np.float32)[None],
                "max_d": np.asarray([6.0], np.float32),
            }
        except Exception as e:
            rid = req.get("id", "req") if isinstance(req, dict) else "req"
            _emit({"id": rid, "error": f"{type(e).__name__}: {e}"})
            continue
        rid = req.get("id", "req")
        n_req = req.get("n_samples")
        kw = dict(fit=req.get("fit", False), scene_idx=req.get("scene_idx", 0),
                  model=req.get("model"))
        if n_req is not None and int(n_req) > args.population:
            # STREAMING: a population larger than the engine's is served
            # as ceil(n/population) chunk sub-requests through the
            # same coalescing queue; each chunk's record is emitted the
            # moment it completes ("chunk"/"n_chunks"/"final" fields)
            n_req = int(n_req)
            sizes = [args.population] * (n_req // args.population)
            if n_req % args.population:
                sizes.append(n_req % args.population)
            for ci, sz in enumerate(sizes):
                fut = q.submit(batch, n_samples=sz, **kw)
                done_q.put((rid, fut, ci, len(sizes)))
        else:
            fut = q.submit(batch, n_samples=n_req, **kw)
            done_q.put((rid, fut, 0, 1))

    q.stop()  # drains outstanding requests
    done_q.put(None)
    responder.join()
    _emit({"stats": q.stats()})


if __name__ == "__main__":
    main()
