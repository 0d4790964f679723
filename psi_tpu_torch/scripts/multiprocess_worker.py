"""One rank of a multi-process run: the population-sharded fit and
data-parallel training over a process group.

The port's counterpart of ``scripts/multiprocess_worker.py``. The caller
writes a spec with ``torch.save`` to ``OUT_DIR/{mode}_spec.pt`` and starts
one worker per rank (``spawn``); each joins the group through a file store
in OUT_DIR, moves the spec's assets, model and inputs to its device, runs
each of the spec's calls over the mesh and saves what it returns, on the
CPU, to ``OUT_DIR/{mode}_r{rank}.pt``. The caller holds those against the
unsharded calls on the same inputs.

    python -m psi_tpu_torch.scripts.multiprocess_worker OUT_DIR {fit,train} \
        --rank R --world W [--device cpu|cuda:0] [--backend gloo|nccl] [--threads N]

The mode names the spec and the results. A spec holds a list of calls,
each a dict with a ``name``, a ``kind`` and optionally ``reps`` (runs of the
call, each from the same inputs); every call returns the K1/K2/K3 launches of
this rank in its last run and the wall seconds of each run beside its
results:

* the fit's (mode ``fit``): ``fit_step`` (``make_fit_step(mesh=)``),
  ``generate_fit_step``, ``generate_fit_rows`` (their ``mesh=`` forms):
  bodies, metrics, loss history; ``engine`` (``GenerationEngine(mesh=)``: a
  list of ``generate`` / ``generate_coalesced`` requests): bodies;
* training's (mode ``train``): ``train_steps`` (``make_train_step(mesh=)``
  over the global batches of the spec, from the spec's weights: per-step
  metrics, the summed gradients of the first step, the weights and
  BatchNorm buffers after the last; both gates open) and ``trainop``
  (``TrainOP(mesh=)`` for the spec's epochs from a
  ``SyntheticBatchGenerator``, into ``save_dir`` with ``{rank}`` filled in);
  each on its own ``assets`` or else the spec's; ``vposer_epochs``
  (``VPoserTrainer(mesh=)`` on the spec's body model and prepared dataset,
  from the seed's weights, into ``work_dir`` with ``{rank}`` filled in: the
  losses of each ``train_epoch`` and ``evaluate``, the state dict after).

The spec is unpickled: pass only a file this program's caller wrote.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch


def _to(obj, device):
    """Tensors, modules, SceneAssets and containers of them on ``device``."""
    from psi_tpu_torch.train.objective import SceneAssets

    if isinstance(obj, (torch.Tensor, torch.nn.Module)):
        return obj.to(device)
    if isinstance(obj, SceneAssets):
        return dataclasses.replace(obj, **{f.name: _to(getattr(obj, f.name), device)
                                           for f in dataclasses.fields(obj)})
    if hasattr(obj, "to") and dataclasses.is_dataclass(obj):  # SMPLXModel
        return obj.to(device)
    if isinstance(obj, dict):
        return {k: _to(v, device) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to(v, device) for v in obj)
    return obj


def _assets(call: Dict, spec: Dict):
    return call["assets"] if "assets" in call else spec["assets"]


def _cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_cpu(v) for v in obj)
    return obj


def _kernels():
    from psi_tpu_torch.ops.chamfer import NN_ARGMIN
    from psi_tpu_torch.ops.fused_skinning import SKIN_BWD, SKIN_FWD

    return SKIN_FWD, SKIN_BWD, NN_ARGMIN


def _counted(fn, device):
    """(fn(), {kernel: launches during it}, wall seconds)."""
    ks = _kernels()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    for k in ks:
        k.launches = 0
    t0 = time.time()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out, {k.name: k.launches for k in ks}, time.time() - t0


def _fit_call(call: Dict, spec: Dict, mesh, device) -> Dict:
    from psi_tpu_torch.fit.fitting import make_fit_step, make_generate_fit_rows, make_generate_fit_step

    assets, model = spec["assets"], spec.get("model")
    args = call["args"]
    kind, cfg, wm = call["kind"], call["cfg"], call.get("want_metrics", True)
    if kind == "fit_step":
        run = make_fit_step(assets, cfg, want_metrics=wm, mesh=mesh)
    elif kind == "generate_fit_step":
        run = make_generate_fit_step(model, assets, cfg, call["n"], want_metrics=wm, mesh=mesh)
    elif kind == "generate_fit_rows":
        run = make_generate_fit_rows(model, assets, cfg, want_metrics=wm, mesh=mesh)
    else:
        raise ValueError(f"unknown fit call kind {kind!r}")
    x72, metrics, hist = run(*args) if kind == "fit_step" else run(*args, eps=call["eps"])
    return {"x72": x72, "metrics": metrics, "hist": hist}


def _engine_call(call: Dict, spec: Dict, mesh, device) -> Dict:
    from psi_tpu_torch.serve.engine import GenerationEngine

    eng = GenerationEngine(spec["model"], spec["assets"], population=call["population"], fit_cfg=call["fit_cfg"],
                           seed=call.get("seed", 0), mesh=mesh)
    out = []
    for method, kw in call["requests"]:
        res = getattr(eng, method)(**_to(kw, device))
        out.append([r.bodies for r in (res if isinstance(res, list) else [res])])
    return {"requests": out}


def _train_steps(call: Dict, spec: Dict, mesh, device) -> Dict:
    from psi_tpu_torch.nn.layers import use_mesh
    from psi_tpu_torch.parallel.mesh import replicate, shard_batch
    from psi_tpu_torch.train.loop import _stage_chunk, init_state, make_train_step

    cfg = call["train_cfg"]
    state = init_state(cfg, device)
    if call.get("state_dict") is not None:
        state.model.load_state_dict(call["state_dict"])
    use_mesh(replicate(state.model, mesh), mesh)
    step = make_train_step(_assets(call, spec), call["loss_cfg"], cfg.model_type, cfg.grad_clip_norm,
                           mesh)
    metrics, grads = [], None
    for i, batch in enumerate(call["batches"]):
        staged = {k: v[0] for k, v in _stage_chunk([shard_batch(batch, mesh)], False, device).items()}
        eps = call["eps"][i] if call.get("eps") is not None else None
        state, m = step(state, staged, 1.0, 1.0, eps=eps)  # both gates open
        metrics.append(m)
        if grads is None:
            grads = {n: p.grad.clone() for n, p in state.model.named_parameters() if p.grad is not None}
    return {"metrics": metrics, "grads": grads, "state_dict": state.model.state_dict()}


def _trainop(call: Dict, spec: Dict, mesh, device) -> Dict:
    from psi_tpu_torch.data.synthetic import SyntheticBatchGenerator
    from psi_tpu_torch.train.loop import TrainOP

    cfg = dataclasses.replace(call["train_cfg"], save_dir=call["train_cfg"].save_dir.format(rank=mesh.rank))
    op = TrainOP(cfg, call["loss_cfg"], _assets(call, spec), mesh=mesh)
    last = op.train(SyntheticBatchGenerator(**call["batch_gen"]), log_fn=lambda *_: None)
    return {"last_metrics": last, "state_dict": op.model.state_dict()}


def _vposer_epochs(call: Dict, spec: Dict, mesh, device) -> Dict:
    from psi_tpu_torch.train.vposer_trainer import VPoserTrainer

    tr = VPoserTrainer(call["work_dir"].format(rank=mesh.rank), call["cfg"], call["dataset_dir"], call["body_model"],
                       mesh=mesh)
    epochs = []
    for _ in range(call["epochs"]):
        tr.epochs_completed += 1
        epochs.append({"train": tr.train_epoch(), "eval": tr.evaluate()})
    return {"epochs": epochs, "state_dict": tr.model.state_dict()}


CALLS = {"fit_step": _fit_call, "generate_fit_step": _fit_call, "generate_fit_rows": _fit_call,
         "engine": _engine_call, "train_steps": _train_steps, "trainop": _trainop,
         "vposer_epochs": _vposer_epochs}


def run_rank(out_dir: str, mode: str, rank: int, world: int, device: str, backend: Optional[str] = None) -> None:
    """Join the group, run the spec's calls, save this rank's results."""
    import torch.distributed as dist

    from psi_tpu_torch.parallel.distributed import ensure_distributed
    from psi_tpu_torch.parallel.mesh import make_mesh

    dev = torch.device(device)
    ensure_distributed(init_method=f"file://{os.path.abspath(out_dir)}/store", num_processes=world,
                       process_id=rank, backend=backend, device=dev)
    try:
        mesh = make_mesh(world, device=dev)
        spec = torch.load(os.path.join(out_dir, f"{mode}_spec.pt"), map_location="cpu", weights_only=False)
        spec = {k: _to(v, dev) if k in ("assets", "model") else v for k, v in spec.items()}
        results = {}
        for call in spec["calls"]:
            fn, walls = CALLS[call["kind"]], []
            for _ in range(call.get("reps", 1)):  # each rep from the same inputs: the first pays the warm-up
                res, launches, wall = _counted(lambda: fn(_to(call, dev), spec, mesh, dev), dev)
                walls.append(wall)
            results[call["name"]] = dict(res, launches=launches, walls_s=walls)
        torch.save(_cpu(results), os.path.join(out_dir, f"{mode}_r{rank}.pt"))
    finally:
        dist.destroy_process_group()
    print(f"DONE r{rank}", flush=True)


def spawn(out_dir, mode: str, world: int, device: Optional[str] = None, timeout_s: float = 600.0,
          backend: Optional[str] = None, threads: Optional[int] = None) -> List[Dict]:
    """Run ``world`` workers on the spec in ``out_dir`` and return each rank's
    results. ``device`` is every rank's (None: rank r on card r). Raises
    RuntimeError, with every rank's output, when a rank exits non-zero or the
    run outlasts ``timeout_s`` (every rank is then killed)."""
    out_dir = Path(out_dir)
    (out_dir / "store").unlink(missing_ok=True)
    cmd = [sys.executable, "-m", "psi_tpu_torch.scripts.multiprocess_worker", str(out_dir), mode,
           "--world", str(world)]
    if device:
        cmd += ["--device", device]
    if backend:
        cmd += ["--backend", backend]
    if threads:
        cmd += ["--threads", str(threads)]
    root = str(Path(__file__).resolve().parents[2])
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, [root, os.environ.get("PYTHONPATH")])))
    logs = [open(out_dir / f"{mode}_r{r}.log", "w+") for r in range(world)]
    procs = [subprocess.Popen(cmd + ["--rank", str(r)], stdout=logs[r], stderr=subprocess.STDOUT, env=env)
             for r in range(world)]
    deadline = time.time() + timeout_s
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) or time.time() > deadline:
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        texts = []
        for f in logs:
            f.seek(0)
            texts.append(f.read())
            f.close()
    codes = [p.returncode for p in procs]
    if any(c != 0 for c in codes):
        hung = time.time() > deadline
        detail = "\n".join(f"--- rank {r} (exit {c}):\n{t[-3000:]}" for r, (c, t) in enumerate(zip(codes, texts)))
        raise RuntimeError(f"{mode} workers {'hung past ' + str(timeout_s) + ' s' if hung else 'failed'}: "
                           f"exit codes {codes}\n{detail}")
    return [torch.load(out_dir / f"{mode}_r{r}.pt", weights_only=False) for r in range(world)]


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("out_dir")
    p.add_argument("mode", choices=["fit", "train"])
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--world", type=int, required=True)
    p.add_argument("--device", type=str, default=None,
                   help="this rank's device (default: card RANK); 'cpu' runs the kernels' plain versions")
    p.add_argument("--backend", type=str, default=None, help="default: nccl on a card, gloo on the CPU")
    p.add_argument("--threads", type=int, default=None, help="torch.set_num_threads for this rank")
    args = p.parse_args(argv)
    if args.threads:
        torch.set_num_threads(args.threads)
    device = args.device or f"cuda:{args.rank}"
    run_rank(args.out_dir, args.mode, args.rank, args.world, device, args.backend)


if __name__ == "__main__":
    main()
