"""Serving engine: fixed-shape generate(+fit) with request coalescing.

Port of ``psi_tpu.serve.engine``. The reference has no serving stack;
this is the production path: every program runs at one fixed population
size. A single request pads into that shape; CONCURRENT requests are
coalesced by ``ServingQueue`` into one program call: population rows are
partitioned across the queued requests and each row is conditioned on its
own request's snapshot by a gather on the device
(``gen.sample.generate_bodies_rows``), so N small requests cost one
program call instead of N. Exposed as an in-process API plus a JSONL
stdin/stdout loop (``psi_tpu_torch.cli.serve``) so it composes with any
process-level server.

The engine runs on one device: the first NVIDIA card unless the caller
names another (``device='cpu'`` in the tests). A fitted request on a card
launches the fused skinning kernels and the chamfer argmin through
``fit.fitting``; nothing here answers from the CPU when a launch fails.
There is no compile step on this side: ``warmup`` pays what a first request
would (the kernel library's build or load, the shared-memory opt-ins, the
cuDNN and cuBLAS handles and algorithm choice, the allocator's growth).

Over several ranks (``mesh=``, ``parallel/mesh.py``) the engine is SPMD:
every rank holds one, built with the same arguments and seed, and calls
``generate`` / ``generate_coalesced`` with the same arguments. Every rank
samples the whole population and fits its rows (``fit.fitting``); each
returns the whole result. The population must divide evenly over the ranks.
``ServingQueue``, ``ServingRouter`` and ``cli.serve`` stay single-process, as
psi_tpu's have no mesh.
"""

from __future__ import annotations

import collections
import dataclasses
import queue
import threading
import time
from concurrent.futures import Future
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from psi_tpu_torch.fit.fitting import make_generate_fit_rows, make_generate_fit_step
from psi_tpu_torch.gen.sample import Eps, Model, generate_bodies, generate_bodies_rows
from psi_tpu_torch.parallel.mesh import replicate
from psi_tpu_torch.train.objective import SceneAssets
from psi_tpu_torch.utils.config import FitConfig


def _validate_rows(n_samples, population: int) -> int:
    """Row count for a request: None means the full population; anything
    else must be a positive integer. A negative count would turn the
    row-partition slice assignments in generate_coalesced into
    negative-length slices, corrupting OTHER requests' rows in the same
    micro-batch — so reject it here and fail only this request."""
    if n_samples is None:
        return population
    n = int(n_samples)
    if n < 1:
        raise ValueError(f"n_samples must be >= 1, got {n_samples!r}")
    return min(n, population)


@dataclasses.dataclass
class ServeResult:
    bodies: np.ndarray  # [n, 72]
    fitted: bool
    latency_s: float
    batch_size: int = 1  # requests coalesced into the program call


def _resolve_device(device) -> torch.device:
    """``device`` with its index filled in; None is the first card, and an
    error without one."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("GenerationEngine runs on an NVIDIA card; pass device='cpu' to serve on the CPU")
        return torch.device("cuda", 0)
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


class GenerationEngine:
    """Sample a population for a scene snapshot and optionally refine it in
    the same call, at one fixed population size.

    ``model`` is a HumanCVAES1 or a HumanCVAES2 with its weights in it; it is
    moved to the engine's device here, once. ``assets`` must already live on
    that device (``make_assets(..., device=)``): they are tens of megabytes
    and are not copied behind the caller's back. With a mesh the device is
    the mesh's unless ``device`` names one, and the weights are rank 0's."""

    def __init__(
        self,
        model: Model,
        assets: SceneAssets,
        population: int = 256,
        fit_cfg: Optional[FitConfig] = None,
        seed: int = 0,
        max_requests: int = 16,
        device=None,
        mesh=None,
    ):
        if mesh is not None:
            if population % mesh.size != 0:
                raise ValueError(f"population={population} must divide evenly over the {mesh.size}-rank mesh")
            device = mesh.device if device is None else device
        self.device = _resolve_device(device)
        for name in ("scene_verts", "sdf_packed", "contact_vids"):
            if getattr(assets, name).device != self.device:
                raise ValueError(f"assets.{name} is on {getattr(assets, name).device}, the engine on {self.device}")
        self.model = model.to(self.device)
        if mesh is not None:
            replicate(self.model, mesh)
        self.mesh = mesh
        self.population = population
        # serving default is the production fit stack; pass FitConfig.exact()
        # for reference-exact refinement semantics
        self.fit_cfg = fit_cfg or FitConfig.production()
        self.max_requests = max_requests  # fixed request-slot count of a coalesced call
        self.assets = assets
        # want_metrics=False: ServeResult carries bodies only, so the
        # final-state metrics pass — a full exact loss evaluation — would be
        # computed and thrown away on every request.
        self._genfit = make_generate_fit_step(self.model, assets, self.fit_cfg, population, want_metrics=False,
                                              mesh=mesh)
        self._genfit_rows = make_generate_fit_rows(self.model, assets, self.fit_cfg, want_metrics=False, mesh=mesh)
        self._generator = torch.Generator(device=self.device).manual_seed(seed)
        # one program at a time: the generator, the model's train/eval toggle
        # (gen.sample.eval_mode) and the kernels' launch counts are not re-entrant
        self._lock = threading.Lock()

    def _dummy_batch(self, image_size: int = 128) -> Dict[str, np.ndarray]:
        batch = {
            "xs": np.zeros((1, image_size, image_size, 2), np.float32),
            "cam_int": np.eye(3, dtype=np.float32)[None] * 500,
            "cam_ext": np.eye(4, dtype=np.float32)[None],
            "max_d": np.asarray([6.0], np.float32),
        }
        batch["cam_int"][0, 2, 2] = 1.0
        return batch

    WARMUP_PROGRAMS = ("single", "single_fit", "coalesced", "coalesced_fit")

    def warmup(self, image_size: int = 128, programs: Optional[Sequence[str]] = None) -> float:
        """Run the selected serving programs once on a dummy snapshot — by
        default all four: single-request and coalesced, each with and without
        fitting. A path skipped here makes its first live request pay the
        first-call costs after 'ready'. ``programs`` selects a subset (names
        in WARMUP_PROGRAMS). Returns warmup seconds."""
        sel = tuple(programs) if programs is not None else self.WARMUP_PROGRAMS
        unknown = set(sel) - set(self.WARMUP_PROGRAMS)
        if unknown:
            raise ValueError(f"unknown warmup programs {sorted(unknown)}; "
                             f"valid: {self.WARMUP_PROGRAMS}")
        t0 = time.time()
        batch = self._dummy_batch(image_size)
        reqs = [
            {"batch": batch, "n_samples": 1, "scene_idx": 0},
            {"batch": batch, "n_samples": 1, "scene_idx": 0},
        ]
        if "single" in sel:
            self.generate(batch, fit=False, scene_idx=0)
        if "single_fit" in sel:
            self.generate(batch, fit=True, scene_idx=0)
        if "coalesced" in sel:
            self.generate_coalesced(reqs, fit=False)
        if "coalesced_fit" in sel:
            self.generate_coalesced(reqs, fit=True)
        return time.time() - t0

    def _stage(self, a: np.ndarray, dtype=np.float32) -> torch.Tensor:
        """One host array onto the engine's device in one copy (through a
        pinned buffer, not waited for, when that is a card)."""
        t = torch.from_numpy(np.ascontiguousarray(a, dtype=dtype))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _noise(self, eps: Eps) -> dict:
        """Injected latents as they are, else a draw from the engine's generator."""
        return dict(eps=eps) if eps is not None else dict(generator=self._generator)

    def generate(
        self,
        batch: Dict[str, np.ndarray],
        n_samples: Optional[int] = None,
        fit: bool = False,
        scene_idx: int = 0,
        eps: Eps = None,
    ) -> ServeResult:
        """batch: one scene snapshot (xs [1,H,W,2], cam_int [1,3,3],
        cam_ext [1,4,4], max_d [1]). n_samples <= population (the program
        always runs at the full population size; extras are dropped).
        eps: latents on the engine's device in place of a draw from its
        generator ([population, eps_d], or S2's pair)."""
        n = _validate_rows(n_samples, self.population)
        t0 = time.time()
        with self._lock:
            xs = self._stage(batch["xs"])
            cam_int = self._stage(np.asarray(batch["cam_int"], np.float32).reshape(1, 3, 3))
            max_d = self._stage(np.asarray(batch["max_d"], np.float32).reshape(1))
            if fit:
                cam_ext = self._stage(
                    np.broadcast_to(
                        np.asarray(batch["cam_ext"], np.float32).reshape(1, 4, 4),
                        (self.population, 4, 4),
                    )
                )
                sidx = self._stage(np.full((self.population,), scene_idx, np.int64), np.int64)
                x72, _, _ = self._genfit(xs, cam_int, max_d, cam_ext, sidx, **self._noise(eps))
            else:
                x72 = generate_bodies(self.model, xs, cam_int, max_d, self.population, **self._noise(eps))
            out = x72[:n].cpu().numpy()
        return ServeResult(bodies=out, fitted=fit, latency_s=time.time() - t0)

    def generate_coalesced(
        self, requests: Sequence[Dict[str, Any]], fit: bool = False, eps: Eps = None
    ) -> List[ServeResult]:
        """Run several requests as ONE program call: population rows are
        partitioned across the requests, each row conditioned on its own
        request's snapshot. requests: dicts with keys ``batch`` (snapshot
        dict), ``n_samples``, ``scene_idx``. Sum of n_samples must fit in
        the population; at most ``max_requests`` requests.
        Returns one ServeResult per request, in order."""
        if len(requests) > self.max_requests:
            raise ValueError(f"{len(requests)} requests > max_requests={self.max_requests}")
        counts = [_validate_rows(r.get("n_samples"), self.population) for r in requests]
        if sum(counts) > self.population:
            raise ValueError(f"sum(n_samples)={sum(counts)} exceeds population={self.population}")

        R = self.max_requests  # fixed slot count
        img = np.asarray(requests[0]["batch"]["xs"], np.float32)
        xs_stack = np.zeros((R,) + img.shape[1:], np.float32)
        cam_int_stack = np.tile(np.eye(3, dtype=np.float32)[None], (R, 1, 1))
        max_d_stack = np.full((R,), 6.0, np.float32)
        req_idx = np.zeros((self.population,), np.int64)
        cam_ext_rows = np.tile(np.eye(4, dtype=np.float32)[None], (self.population, 1, 1))
        sidx_rows = np.zeros((self.population,), np.int64)

        offset = 0
        for ri, (req, n) in enumerate(zip(requests, counts)):
            b = req["batch"]
            arr = np.asarray(b["xs"], np.float32)
            if arr.shape[-3:] != img.shape[-3:]:
                # a silent reshape would condition rows on a scrambled
                # image; ServingQueue groups by shape so this only fires
                # on direct mis-use of generate_coalesced
                raise ValueError(
                    f"request {ri} snapshot shape {arr.shape} does not match "
                    f"the group's {img.shape}"
                )
            xs_stack[ri] = arr.reshape(img.shape[1:])
            cam_int_stack[ri] = np.asarray(b["cam_int"], np.float32).reshape(3, 3)
            max_d_stack[ri] = np.asarray(b["max_d"], np.float32).reshape(-1)[0]
            req_idx[offset : offset + n] = ri
            cam_ext_rows[offset : offset + n] = np.asarray(b["cam_ext"], np.float32).reshape(-1, 4, 4)[:1]
            sidx_rows[offset : offset + n] = int(req.get("scene_idx", 0))
            offset += n
        # padding rows recompute request 0 (req_idx stays 0); give them
        # request 0's extrinsics/scene too so a degenerate identity-cam
        # fit can't go NaN and muddy debugging — they are discarded on
        # slice-out either way
        if offset < self.population:
            cam_ext_rows[offset:] = cam_ext_rows[0]
            sidx_rows[offset:] = sidx_rows[0]

        t0 = time.time()
        with self._lock:
            xs_d, cam_int_d, max_d_d = self._stage(xs_stack), self._stage(cam_int_stack), self._stage(max_d_stack)
            req_d = self._stage(req_idx, np.int64)
            if fit:
                x72, _, _ = self._genfit_rows(
                    xs_d, cam_int_d, max_d_d, req_d, self._stage(cam_ext_rows), self._stage(sidx_rows, np.int64),
                    **self._noise(eps),
                )
            else:
                x72 = generate_bodies_rows(self.model, xs_d, cam_int_d, max_d_d, req_d, **self._noise(eps))
            host = x72.cpu().numpy()
        latency = time.time() - t0

        results, offset = [], 0
        for n in counts:
            results.append(
                ServeResult(
                    bodies=host[offset : offset + n].copy(), fitted=fit,
                    latency_s=latency, batch_size=len(requests),
                )
            )
            offset += n
        return results


_STOP = object()


@dataclasses.dataclass
class _Queued:
    req: Dict[str, Any]
    fit: bool
    future: Future
    submit_t: float
    rows: int = 0  # validated at submit time
    img_shape: tuple = ()


class ServingQueue:
    """Micro-batching front end over a GenerationEngine.

    Concurrent ``submit()`` calls coalesce: a worker thread drains the
    queue into groups (same fit flag, total rows <= population, at most
    ``engine.max_requests`` requests), lingering ``linger_s`` after the
    first request of a group to let a burst accumulate, then runs each
    group as one ``generate_coalesced`` program call. Latency is
    end-to-end (submit -> result ready) and tracked for p50/p99.
    """

    def __init__(self, engine: GenerationEngine, linger_s: float = 0.005):
        self.engine = engine
        self.linger_s = linger_s
        self._q: "queue.Queue[Any]" = queue.Queue()
        self._carry: Optional[Any] = None
        self._stats_lock = threading.Lock()
        # bounded window: a long-running server must not leak one float
        # per request forever (p50/p99 over the last 100k is plenty)
        self._latencies: "collections.deque[float]" = collections.deque(maxlen=100_000)
        self._requests = 0
        self._batches = 0
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def submit(
        self,
        batch: Dict[str, np.ndarray],
        n_samples: Optional[int] = None,
        fit: bool = False,
        scene_idx: int = 0,
    ) -> Future:
        """Enqueue one request; returns a Future resolving to ServeResult.

        Malformed requests (non-integer n_samples, missing/odd-shaped
        snapshot) fail THEIR future here instead of reaching the worker
        thread — one bad request must never wedge the queue."""
        fut: Future = Future()
        try:
            rows = _validate_rows(n_samples, self.engine.population)
            img_shape = tuple(np.asarray(batch["xs"]).shape[1:])
        except Exception as e:
            fut.set_exception(e)
            return fut
        self._q.put(
            _Queued(
                req={"batch": batch, "n_samples": rows, "scene_idx": scene_idx},
                fit=fit, future=fut, submit_t=time.time(),
                rows=rows, img_shape=img_shape,
            )
        )
        return fut

    def stop(self):
        """Drain outstanding requests, then stop the worker."""
        self._q.put(_STOP)
        self._worker.join()

    def stats(self) -> Dict[str, Any]:
        with self._stats_lock:
            lat = np.asarray(self._latencies, np.float64)
            out = {"requests": self._requests, "batches": self._batches}
        if lat.size:
            out["latency_p50_s"] = float(np.percentile(lat, 50))
            out["latency_p99_s"] = float(np.percentile(lat, 99))
        return out

    def latencies_snapshot(self) -> List[float]:
        """Copy of the per-request end-to-end latencies (for aggregation
        by a router without touching queue internals)."""
        with self._stats_lock:
            return list(self._latencies)

    def _compatible(self, first, nxt, rows) -> bool:
        """May nxt share first's program call? Same fit flag, room in the
        population, and the same snapshot shape (coalesced rows stack
        into one xs tensor)."""
        return (
            nxt.fit == first.fit
            and rows + nxt.rows <= self.engine.population
            and nxt.img_shape == first.img_shape
        )

    def _next_group(self) -> Optional[List[_Queued]]:
        first = self._carry
        self._carry = None
        if first is None:
            first = self._q.get()
        if first is _STOP:
            return None
        group, rows = [first], first.rows
        deadline = time.time() + self.linger_s
        while rows < self.engine.population and len(group) < self.engine.max_requests:
            timeout = deadline - time.time()
            try:
                nxt = self._q.get(timeout=max(timeout, 0.0)) if timeout > 0 else self._q.get_nowait()
            except queue.Empty:
                break
            if nxt is _STOP:
                self._carry = _STOP
                break
            if not self._compatible(first, nxt, rows):
                self._carry = nxt  # incompatible: starts the next group
                break
            group.append(nxt)
            rows += nxt.rows
        return group

    def _run(self):
        while True:
            group = self._next_group()
            if group is None:
                return
            try:
                results = self.engine.generate_coalesced([g.req for g in group], fit=group[0].fit)
            except Exception as e:  # surface failures to every caller in the group
                for g in group:
                    g.future.set_exception(e)
                continue
            done_t = time.time()
            with self._stats_lock:
                self._batches += 1
                self._requests += len(group)
                for g in group:
                    self._latencies.append(done_t - g.submit_t)
            for g, r in zip(group, results):
                r.latency_s = done_t - g.submit_t  # end-to-end, incl. queue wait
                g.future.set_result(r)


class ServingRouter:
    """Multi-model front end: one ServingQueue per engine (e.g. the
    one-stage and two-stage CVAEs served side by side), requests routed
    by model name. Each queue micro-batches independently, so s1 and s2
    populations never share a program; the device interleaves their
    launches (each engine holds its own lock).

    The reference ships two model families behind distinct scripts
    (test_proxe_s1.py / test_proxe_s2.py); here both are resident behind
    one API.
    """

    def __init__(self, engines: Dict[str, GenerationEngine], linger_s: float = 0.005):
        if not engines:
            raise ValueError("ServingRouter needs at least one engine")
        self.engines = dict(engines)
        self.default = next(iter(self.engines))
        self.queues = {name: ServingQueue(e, linger_s=linger_s) for name, e in self.engines.items()}

    def submit(
        self,
        batch: Dict[str, np.ndarray],
        n_samples: Optional[int] = None,
        fit: bool = False,
        scene_idx: int = 0,
        model: Optional[str] = None,
    ) -> Future:
        name = model or self.default
        if name not in self.queues:
            fut: Future = Future()
            fut.set_exception(KeyError(f"unknown model {name!r}; have {sorted(self.queues)}"))
            return fut
        return self.queues[name].submit(batch, n_samples=n_samples, fit=fit, scene_idx=scene_idx)

    def stats(self) -> Dict[str, Any]:
        """Aggregate stats (same schema as ServingQueue.stats) plus a
        per-model breakdown under 'models'."""
        per = {name: q.stats() for name, q in self.queues.items()}
        lat = []
        for q in self.queues.values():
            lat.extend(q.latencies_snapshot())
        out: Dict[str, Any] = {
            "requests": sum(p["requests"] for p in per.values()),
            "batches": sum(p["batches"] for p in per.values()),
            "models": per,
        }
        if lat:
            arr = np.asarray(lat, np.float64)
            out["latency_p50_s"] = float(np.percentile(arr, 50))
            out["latency_p99_s"] = float(np.percentile(arr, 99))
        return out

    def stop(self):
        for q in self.queues.values():
            q.stop()
