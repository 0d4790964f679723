"""Scene-aware fitting refinement — the serving path's optimisation loop.

Port of ``psi_tpu.fit.fitting`` (reference source/fitting_proxe.py:
42-263): refine every generated body against its scene with Adam over
L1-to-initial + VPoser z^2 + chamfer contact + SDF penetration. Each
body's parameters only touch its own loss term, so the population is one
batch and the summed loss gives every body its own gradient. Adam state
starts fresh per population (psi_tpu's semantics, not the reference's
carried-over state).

The iteration schedule is static and matches psi_tpu's block schedule
exactly (``fit_schedule``). With ``refresh_every > 1`` there are three
pass kinds:
* full — NN search over the (pruned) scene cloud and a real packed-SDF
  gather per vertex; emits the frozen state (each contact vertex's NN
  scene point, each vertex's SDF cell corners);
* nn_only — a fresh NN search, collision against the carried cells;
* cheap — contact against the frozen correspondences, collision against
  the carried cells: no search and no gathers.
``refresh_every == 1`` (the exact tier) runs a full pass every iteration
with the two-cloud-gradient ``chamfer_one_sided``.

On the card the fused tier's decode runs kernels K1 (forward) and K2
(backward) every iteration and the NN search runs kernel K3 on every
full and nn_only pass.

Under a profiler (``utils.profiling.span``) each iteration opens
``psi.fit.pass.<kind>`` and, inside it, ``psi.fit.decode``,
``psi.fit.contact``, ``psi.fit.collision``, ``psi.fit.backward`` and
``psi.fit.adam``; the sampler in front of a fit opens ``psi.sample``.

The drivers: ``fit_bodies`` (one call), ``make_generate_fit_step`` and
``make_generate_fit_rows`` (sampler in front of the fit, one snapshot or
one per row), ``make_fit_step_carry_opt_state`` (the reference's Adam
carried from body to body, serial) and ``FittingOP`` (numpy populations
and the reference's ``body_gen_*.pkl`` files).

Three of psi_tpu's fit modes (decode recomputation, population chunks and
a vertex subset on the cheap passes) are refused when a fit is built with
one switched on (``_check_config``): on the H100 each was slower than this
one loop, and the subset also changed the iterates.

On the card the fit replays a CUDA graph (``_FitProgram``): the first call
with a given device, input shapes and dtypes and ``SceneAssets`` object runs
as above, the second captures the whole call (every pass, its backward, Adam
and the metrics pass) into one ``torch.cuda.CUDAGraph`` and replays it, and
later calls only replay: one graph launch in place of some 36,500 kernel
launches from the host, the same kernels in the same order. A replayed call
opens one span, ``psi.fit.replay``, and none of the ones above. The CPU and
a mesh stay eager.

Population sharding (``mesh=`` of ``make_fit_step``, ``make_generate_fit_step``
and ``make_generate_fit_rows``; ``parallel/mesh.py``): every rank is given the
whole population and fits its own rows [r N/R, (r+1) N/R). Each body's loss
is its own, so no collective runs inside an iteration; the fitted rows, the
metrics and the loss history are gathered at the end, and every rank returns
the whole population's.
"""

from __future__ import annotations

import os
import pickle
import threading
import warnings
import weakref
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from psi_tpu_torch.body.decode import body_vec_to_verts
from psi_tpu_torch.body.smplx_model import make_fused_bundle
from psi_tpu_torch.gen.sample import Model, generate_bodies, generate_bodies_rows
from psi_tpu_torch.geometry.bodyvec import (
    body_params_encapsulate_list,
    body_params_parse,
    convert_to_3D_rot,
    convert_to_6D_rot,
)
from psi_tpu_torch.ops import _cuda
from psi_tpu_torch.ops.chamfer import chamfer_one_sided, chamfer_one_sided_nn
from psi_tpu_torch.ops.precision import PACKS
from psi_tpu_torch.ops.prune import select_near_tiles
from psi_tpu_torch.ops.sdf import (
    sdf_trilinear_from_cache,
    sdf_trilinear_packed,
    sdf_trilinear_packed_cached,
)
from psi_tpu_torch.parallel.distributed import gather_rows
from psi_tpu_torch.train.objective import SceneAssets
from psi_tpu_torch.utils.config import FitConfig
from psi_tpu_torch.utils.precision import strict_f32
from psi_tpu_torch.utils.profiling import span

LBS_PRECISIONS = ("high", "fast", "fused")


def _per_body_losses(
    assets: SceneAssets,
    xhr: torch.Tensor,  # [N, 75]
    xhr_init: torch.Tensor,  # [N, 75]
    cam_ext: torch.Tensor,  # [N, 4, 4]
    scene_idx: torch.Tensor,  # [N] int64
    cfg: FitConfig,
    sel=None,
    fresh_nn: Optional[bool] = None,
    fresh_sdf: Optional[bool] = None,
    fused_bundle=None,
) -> Tuple[torch.Tensor, Tuple[Dict[str, torch.Tensor], Tuple]]:
    """Summed loss with per-body terms (reference fitting_proxe.py:101-162).

    sel=None is the full pass; sel=(y_nn, sdf_cache) with fresh_nn=True,
    fresh_sdf=False the nn_only pass; with both False the cheap pass.
    Returns (sum, (metrics, (y_nn, sdf_cache))): per-body metrics [N] and
    the state the next passes carry (None entries when refresh is off).
    """
    if fresh_nn is None:
        fresh_nn = sel is None
    if fresh_sdf is None:
        fresh_sdf = sel is None
    # |d| with jnp.abs's derivative, +1 at d == 0 (torch.abs has 0 there).
    # Every fit starts at d == 0, so this sets Adam's first step on every
    # coordinate whose other terms are flat.
    d = xhr - xhr_init
    loss_rec = cfg.weight_loss_rec * torch.mean(torch.where(d >= 0, d, -d), dim=1)  # [N]

    xh = convert_to_3D_rot(xhr)  # [N, 72]
    loss_vposer = cfg.weight_loss_vposer * torch.mean(xh[:, 16:48] ** 2, dim=1)

    with span("psi.fit.decode"):
        verts = body_vec_to_verts(
            assets.smplx, assets.vposer, xh, cam_ext, precision=cfg.lbs_precision, fused_bundle=fused_bundle
        )[0]

    with span("psi.fit.contact"):
        contact_verts = verts[:, assets.contact_vids, :]
        if sel is not None and not fresh_nn:
            y_nn = sel[0]
            d1 = torch.sum((contact_verts - y_nn) ** 2, dim=-1)  # frozen correspondence
        else:
            scene_pts = assets.scene_verts[scene_idx]
            ks = cfg.prune_scene_points
            if ks and ks < scene_pts.shape[1]:
                # keep the ~K scene points nearest each body's contact centroid
                scene_pts = select_near_tiles(scene_pts, torch.mean(contact_verts, dim=1), ks)
            if cfg.refresh_every > 1:
                d1, y_nn = chamfer_one_sided_nn(contact_verts, scene_pts)
            else:
                d1 = chamfer_one_sided(contact_verts, scene_pts)  # [N, C]
                y_nn = None
        s = torch.sqrt(d1 + 1e-4)
        loss_contact = cfg.weight_contact * torch.mean(s / (s + cfg.contact_denom_offset), dim=1)

    with span("psi.fit.collision"):
        dims = tuple(assets.sdf_packed.shape[1:4])
        if sel is not None and not fresh_sdf:
            sdf_cache = sel[1]
            body_sdf = sdf_trilinear_from_cache(
                sdf_cache, scene_idx, verts, assets.grid_mins, assets.grid_maxs, dims
            )
        elif cfg.refresh_every > 1:
            body_sdf, (corners, base) = sdf_trilinear_packed_cached(
                assets.sdf_packed, scene_idx, verts, assets.grid_mins, assets.grid_maxs
            )
            sdf_cache = (corners.detach(), base.detach())
        else:
            body_sdf = sdf_trilinear_packed(
                assets.sdf_packed, scene_idx, verts, assets.grid_mins, assets.grid_maxs
            )
            sdf_cache = None
        # min(sdf, 0) with jnp.minimum's derivative, 0.5 at sdf == 0 (torch.clamp
        # passes all of the gradient there)
        neg = torch.minimum(body_sdf, body_sdf.new_zeros(()))
        cnt = torch.clamp(torch.sum(body_sdf < 0, dim=1), min=1).to(xhr.dtype)
        loss_collision = cfg.weight_collision * (-torch.sum(neg, dim=1) / cnt)

    per_body = loss_rec + loss_vposer + loss_contact + loss_collision
    metrics = {
        "rec": loss_rec,
        "vposer": loss_vposer,
        "contact": loss_contact,
        "collision": loss_collision,
        "total": per_body,
    }
    return torch.sum(per_body), (metrics, (y_nn, sdf_cache))


def fit_schedule(cfg: FitConfig) -> List[str]:
    """The pass kind of every iteration: 'full', 'nn_only' or 'cheap'.

    psi_tpu's static block structure: w = refresh_warmup warmup passes
    (all full with sdf_warmup_gathers, else one full then nn_only), then
    blocks of one full + (T-1) cheap passes, then a partial tail block.
    At num_iter=20, T=10, w=4: full at 0, 4, 14; nn_only at 1-3; the
    other 14 cheap."""
    if cfg.refresh_every <= 1:
        return ["full"] * cfg.num_iter
    w = min(cfg.refresh_warmup, cfg.num_iter)
    T = cfg.refresh_every
    kinds: List[str] = []
    if w:
        kinds += ["full"] * w if cfg.sdf_warmup_gathers else ["full"] + ["nn_only"] * (w - 1)
    n_blocks, rem = divmod(cfg.num_iter - w, T)
    for _ in range(n_blocks):
        kinds += ["full"] + ["cheap"] * (T - 1)
    if rem:
        kinds += ["full"] + ["cheap"] * (rem - 1)
    return kinds


class Adam:
    """``optax.adam(lr)`` written out (b1 0.9, b2 0.999, eps 1e-8 outside
    the square root), with the same operation order, over one tensor."""

    def __init__(self, x: torch.Tensor, lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.mu = torch.zeros_like(x)
        self.nu = torch.zeros_like(x)
        self.count = 0

    def step(self, x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        self.mu = (1 - self.b1) * g + self.b1 * self.mu
        self.nu = (1 - self.b2) * g**2 + self.b2 * self.nu
        self.count += 1
        # bias corrections in float32, as optax computes decay**count
        c = np.float32(self.count)
        bc1 = float(np.float32(1) - np.float32(self.b1) ** c)
        bc2 = float(np.float32(1) - np.float32(self.b2) ** c)
        update = (self.mu / bc1) / (torch.sqrt(self.nu / bc2) + self.eps)
        return x + (-self.lr) * update


# one capture at a time in the process: a capture must not record another thread's launches
_CAPTURE_LOCK = threading.Lock()


def _on_card(t: torch.Tensor) -> bool:
    """Whether ``t`` lives on a card, where a fit can be graphed."""
    return t.is_cuda


class _Graph:
    """A fit program's one graph slot: the key it holds and, once the key's
    second call has captured it, the graph, its static inputs and outputs,
    the hand-written kernels' launches it recorded, the packed planes it was
    served (with their sources' versions), and strong references to what it
    reads outside its own memory pool."""

    def __init__(self, key: tuple, assets: SceneAssets):
        self.key = key
        self.assets = weakref.ref(assets)
        self.graph = None  # None: the key has been seen once, and ran eagerly
        self.failed = False  # its capture raised: the key stays eager
        self.static_in = self.static_out = None
        self.recorded: List[Tuple[_cuda.Kernel, int]] = []
        self.packed: List[tuple] = []  # (weak reference to a source, its version at capture, planes)
        self.keep = ()
        self.stream = None  # the stream of the last replay

    def holds(self, key: tuple, assets: SceneAssets) -> bool:
        """Whether a call with ``key`` and ``assets`` may use this slot: the
        same key, the same live ``SceneAssets`` (not a new one at a dead one's
        id), and every packed plane the graph read still its source's."""
        if self.key != key or self.assets() is not assets:
            return False
        return all(src() is not None and src()._version == version for src, version, _ in self.packed)


class _FitProgram:
    """``fit`` of ``_fit_program``, replayed from a CUDA graph on the card.

    A call is graphed when its tensors are on the card and there is no mesh.
    Its key is the device, the inputs' shapes and dtypes and the
    ``SceneAssets`` object (held weakly: a new one never meets an old graph).
    The program holds one graph: every caller gives a program one key (a
    fixed population, one ``SceneAssets``), and a new key takes the slot. The
    first call of a key runs eagerly, which also warms what is built lazily
    (the kernel library, cuBLAS, the packed planes of ``ops.precision.PACKS``);
    the second captures the call and replays it; later calls copy their
    inputs into the graph's, replay it and return clones of its outputs,
    never its buffers, with no synchronize. A packed plane whose source
    changed in place since the capture drops the graph (the call runs eagerly
    and repacks, the next one captures anew). A capture that raises is warned
    of and its key stays eager."""

    def __init__(self, run: Callable, graphed: bool):
        self.run = run
        self.graphed = graphed
        self.lock = threading.Lock()  # the slot, the static buffers and the replays
        self.slot: Optional[_Graph] = None
        self.stats = {"eager": 0, "captures": 0, "replays": 0, "failed_captures": 0}

    def graph_stats(self) -> Dict[str, int]:
        """Calls run eagerly, captures, replays (a capturing call replays
        too), failed captures, and the graphs held (0 or 1)."""
        with self.lock:
            return {**self.stats, "graphs": int(self.slot is not None and self.slot.graph is not None)}

    def __call__(self, assets: SceneAssets, x72_init, cam_ext, scene_idx):
        ins = (x72_init, cam_ext, scene_idx)
        if self.graphed and all(_on_card(t) for t in ins):
            key = (x72_init.device, *(tuple(t.shape) for t in ins), *(t.dtype for t in ins), id(assets))
            with self.lock:
                slot = self.slot
                if slot is None or not slot.holds(key, assets):
                    self.slot = _Graph(key, assets)  # seen once: this call runs eagerly
                elif not slot.failed and (slot.graph is not None or self._capture(slot, assets, ins)):
                    return self._replay(slot, ins)
                self.stats["eager"] += 1
        else:
            with self.lock:
                self.stats["eager"] += 1
        return self.run(assets, *ins)

    def _capture(self, slot: _Graph, assets: SceneAssets, ins) -> bool:
        """Capture the call into ``slot``; on failure warn, count it and
        leave the key eager."""
        static_in = tuple(torch.empty_like(t, memory_format=torch.contiguous_format).copy_(t) for t in ins)
        graph = torch.cuda.CUDAGraph()
        try:
            with _CAPTURE_LOCK, PACKS.served() as packed:
                before = [k.captured for k in _cuda.KERNELS]
                with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                    static_out = self.run(assets, *static_in)
                recorded = [(k, k.captured - b) for k, b in zip(_cuda.KERNELS, before) if k.captured != b]
        except Exception as e:  # noqa: BLE001 - whatever broke the capture, the eager call still runs
            warnings.warn(f"fit: CUDA graph capture failed, calls of this shape stay eager: {e!r}", RuntimeWarning)
            slot.failed = True
            self.stats["failed_captures"] += 1
            return False
        slot.graph, slot.static_in, slot.static_out, slot.recorded = graph, static_in, static_out, recorded
        slot.packed = packed
        slot.keep = tuple(vars(assets).values())
        self.stats["captures"] += 1
        return True

    def _replay(self, slot: _Graph, ins):
        with span("psi.fit.replay"):
            stream = torch.cuda.current_stream(ins[0].device)
            if slot.stream is not None and slot.stream != stream:
                stream.wait_stream(slot.stream)  # the last replay's clones before its buffers are reused
            slot.stream = stream
            for dst, src in zip(slot.static_in, ins):
                dst.copy_(src)
            slot.graph.replay()
            x72, final, hist = slot.static_out
            out = (x72.clone(), None if final is None else {k: v.clone() for k, v in final.items()}, hist.clone())
        for k, n in slot.recorded:
            k.count(n)
        self.stats["replays"] += 1
        return out


def _check_config(cfg: FitConfig) -> None:
    """Raise ValueError for a ``FitConfig`` the port does not run: an unknown
    ``lbs_precision``, or one of psi_tpu's three fit modes switched on. Their
    "off" values (``remat_decode`` false, ``overlap_chunks`` None or under 2,
    ``cheap_collision_verts`` <= 0) are accepted."""
    if cfg.lbs_precision not in LBS_PRECISIONS:
        raise ValueError(f"lbs_precision must be one of {LBS_PRECISIONS}, got {cfg.lbs_precision!r}")
    for name, on in (("remat_decode", bool(cfg.remat_decode)), ("overlap_chunks", int(cfg.overlap_chunks or 1) > 1),
                     ("cheap_collision_verts", cfg.cheap_collision_verts > 0)):
        if on:
            raise ValueError(f"FitConfig.{name}={getattr(cfg, name)!r}: the port does not run this mode "
                             "(slower than the default fit on the card); leave it off")


def _fit_program(cfg: FitConfig, want_metrics: bool = True, mesh=None) -> _FitProgram:
    """fit(assets, x72_init [N, 72], cam_ext [N, 4, 4], scene_idx [N]) ->
    (x72 [N, 72], final per-body metrics or None, loss_hist [num_iter, N]).

    loss_hist[i] is each body's total at iteration i, before its update.
    want_metrics=False skips the final full loss pass, which only reports
    metrics; the fitted bodies are the same either way. With a mesh this rank
    fits its rows of the N it is given, and the results are gathered; N must
    divide evenly over the mesh. On the card, calls are replayed from CUDA
    graphs (``_FitProgram``)."""
    _check_config(cfg)
    kinds = fit_schedule(cfg)

    def fit(assets: SceneAssets, x72_init, cam_ext, scene_idx):
        scene_idx = scene_idx.to(torch.int64)
        lo_r, hi_r = mesh.rows(x72_init.shape[0]) if mesh is not None else (0, x72_init.shape[0])
        with strict_f32(), torch.no_grad():
            xhr_init = convert_to_6D_rot(x72_init[lo_r:hi_r])
            cam_r, sidx_r = cam_ext[lo_r:hi_r], scene_idx[lo_r:hi_r]
            # the fused kernels' constant operands: once per fit call
            bundle = make_fused_bundle(assets.smplx) if cfg.lbs_precision == "fused" else None

            def loss_fn(x, sel=None, fresh_nn=None, fresh_sdf=None):
                return _per_body_losses(assets, x, xhr_init, cam_r, sidx_r, cfg, sel, fresh_nn, fresh_sdf, bundle)

            xhr = xhr_init.clone()
            adam = Adam(xhr, cfg.init_lr_h)
            sel = None
            hist = []
            for kind in kinds:
                with span(f"psi.fit.pass.{kind}"):
                    x = xhr.detach().requires_grad_(True)
                    with torch.enable_grad():
                        if kind == "full":
                            loss, (metrics, new_sel) = loss_fn(x)
                        else:
                            loss, (metrics, new_sel) = loss_fn(x, sel, fresh_nn=kind == "nn_only", fresh_sdf=False)
                        with span("psi.fit.backward"):
                            (g,) = torch.autograd.grad(loss, x)
                    with span("psi.fit.adam"):
                        xhr = adam.step(xhr, g)
                    if kind != "cheap":
                        sel = new_sel
                    hist.append(metrics["total"].detach())
            loss_hist = torch.stack(hist)
            x72 = convert_to_3D_rot(xhr)
            final = None
            if want_metrics:
                _, (final, _) = loss_fn(xhr)
                final = {k: v.detach() for k, v in final.items()}
            if mesh is not None:
                x72, loss_hist = gather_rows(x72, mesh), gather_rows(loss_hist, mesh, dim=1)
                if final is not None:
                    names = list(final)
                    stacked = gather_rows(torch.stack([final[k] for k in names], dim=1), mesh)
                    final = dict(zip(names, stacked.unbind(dim=1)))
            return x72, final, loss_hist

    return _FitProgram(fit, graphed=mesh is None)


def make_fit_step(assets: SceneAssets, cfg: FitConfig, want_metrics: bool = True, mesh=None) -> Callable:
    """fit(x72_init [N, 72], cam_ext [N, 4, 4], scene_idx [N]) ->
    (x72_fitted [N, 72], final per-body metrics, per-iteration loss hist).
    mesh: population-sharded (see the module docstring); every rank passes
    the same N bodies and gets all N back."""
    fit = _fit_program(cfg, want_metrics=want_metrics, mesh=mesh)

    def bound(x72_init, cam_ext, scene_idx):
        return fit(assets, x72_init, cam_ext, scene_idx)

    bound.graph_stats = fit.graph_stats
    return bound


def make_generate_fit_step(
    model: Model, assets: SceneAssets, cfg: FitConfig, n_samples: int, want_metrics: bool = True, mesh=None
) -> Callable:
    """Sample a population for ONE snapshot and refine it.

    Returns run(xs [1, H, W, 2], cam_int [1, 3, 3], max_d [1], cam_ext
    [N, 4, 4], scene_idx [N], generator=None, eps=None) -> (x72 [N, 72],
    metrics, hist). ``model`` is a HumanCVAES1 or a HumanCVAES2; eps
    injects the latents in place of a draw from ``generator`` (a tensor
    [N, eps_d] for S1, a pair of [N, 32] tensors for S2). With a mesh every
    rank samples all N rows (the same generator state or eps on every rank
    gives the unsharded call's rows) and only the fit is sharded."""
    fit = _fit_program(cfg, want_metrics=want_metrics, mesh=mesh)

    def run(xs, cam_int, max_d, cam_ext, scene_idx, generator=None, eps=None):
        x72 = generate_bodies(model, xs, cam_int, max_d, n_samples, generator=generator, eps=eps)
        return fit(assets, x72, cam_ext, scene_idx)

    run.graph_stats = fit.graph_stats
    return run


def make_generate_fit_rows(model: Model, assets: SceneAssets, cfg: FitConfig, want_metrics: bool = True,
                           mesh=None) -> Callable:
    """``make_generate_fit_step`` for a coalesced batch of snapshots: row r
    of the population is sampled for snapshot ``req_idx[r]`` and refined.

    Returns run(xs_stack [R, H, W, 2], cam_int_stack [R, 3, 3], max_d_stack
    [R], req_idx [P], cam_ext_rows [P, 4, 4], sidx_rows [P], generator=None,
    eps=None) -> (x72 [P, 72], metrics, hist). With a mesh, as
    ``make_generate_fit_step``: all P rows sampled on every rank, the fit
    sharded."""
    fit = _fit_program(cfg, want_metrics=want_metrics, mesh=mesh)

    def run(xs_stack, cam_int_stack, max_d_stack, req_idx, cam_ext_rows, sidx_rows, generator=None, eps=None):
        x72 = generate_bodies_rows(model, xs_stack, cam_int_stack, max_d_stack, req_idx,
                                   generator=generator, eps=eps)
        return fit(assets, x72, cam_ext_rows, sidx_rows)

    run.graph_stats = fit.graph_stats
    return run


def fit_bodies(assets: SceneAssets, x72_init, cam_ext, scene_idx, cfg: Optional[FitConfig] = None):
    """One-shot convenience wrapper around ``make_fit_step``."""
    return make_fit_step(assets, cfg or FitConfig())(x72_init, cam_ext, scene_idx)


def make_fit_step_carry_opt_state(assets: SceneAssets, cfg: FitConfig) -> Callable:
    """The reference's quirk: ONE Adam state shared serially across bodies.

    The reference builds a single Adam optimizer per scene and loops over the
    body files, resetting only the parameter per body while the moments and
    the bias-correction step count run on (fitting_proxe.py:73-74,175). This
    mode does exactly that, so that the quirk's effect can be measured
    against the fresh-state default: a serial loop over bodies at batch 1, a
    full pass every iteration whatever ``refresh_every`` says, then one
    population-wide metrics pass. Not a production path.

    Returns fit(x72_init [N, 72], cam_ext [N, 4, 4], scene_idx [N]) ->
    (x72 [N, 72], final per-body metrics): two values, no loss history."""
    _check_config(cfg)

    def fit(x72_init, cam_ext, scene_idx):
        scene_idx = scene_idx.to(torch.int64)
        with strict_f32(), torch.no_grad():
            xhr_init_all = convert_to_6D_rot(x72_init)
            bundle = make_fused_bundle(assets.smplx) if cfg.lbs_precision == "fused" else None
            adam = Adam(xhr_init_all[0:1], cfg.init_lr_h)
            fitted = []
            for b in range(xhr_init_all.shape[0]):
                xhr_init1, cam1, sidx1 = xhr_init_all[b : b + 1], cam_ext[b : b + 1], scene_idx[b : b + 1]
                xhr = xhr_init1.clone()
                for _ in range(cfg.num_iter):
                    x = xhr.detach().requires_grad_(True)
                    with torch.enable_grad():
                        loss, _ = _per_body_losses(assets, x, xhr_init1, cam1, sidx1, cfg, fused_bundle=bundle)
                        (g,) = torch.autograd.grad(loss, x)
                    xhr = adam.step(xhr, g)
                fitted.append(xhr)
            xhr_all = torch.cat(fitted)
            _, (final, _) = _per_body_losses(
                assets, xhr_all, xhr_init_all, cam_ext, scene_idx, cfg, fused_bundle=bundle
            )
            return convert_to_3D_rot(xhr_all), {k: v.detach() for k, v in final.items()}

    return fit


class FittingOP:
    """File-driven fit with the reference's pickle IO (fitting_proxe.py:
    167-263): reads ``body_gen_*.pkl`` dicts, fits the whole population in
    one call per chunk, writes the refined pickles.

    Runs on the first card unless ``device`` says otherwise; ``assets`` must
    live on the same device. cam_post: an optional 4x4 right-composed onto
    every cam_ext before the fit (the Habitat driver's axis flip,
    fitting_habitat.py:177-184). Populations over ``max_population`` are
    fitted in chunks of exactly that size, the last one padded by repeating
    its last row (the padding's results are dropped), so every chunk has one
    shape."""

    def __init__(
        self,
        assets: SceneAssets,
        cfg: FitConfig,
        scene_idx: int,
        verbose: bool = False,
        max_population: int = 512,
        cam_post: Optional[np.ndarray] = None,
        device=None,
    ):
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError("FittingOP runs on an NVIDIA card; pass device='cpu' to fit on the CPU")
            device = torch.device("cuda", 0)
        self.assets = assets
        self.cfg = cfg
        self.scene_idx = scene_idx
        self.verbose = verbose
        self.max_population = max_population
        self.cam_post = None if cam_post is None else np.asarray(cam_post, np.float32).reshape(4, 4)
        self.device = torch.device(device)
        self._fit = make_fit_step(assets, cfg)

    def _fit_arrays(self, x72: np.ndarray, cam_ext: np.ndarray):
        """One fit call: numpy in, numpy out (x72, metrics, hist)."""
        to = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(self.device)
        scene_idx = torch.full((x72.shape[0],), self.scene_idx, dtype=torch.int64, device=self.device)
        x_fitted, metrics, hist = self._fit(to(x72), to(cam_ext), scene_idx)
        return x_fitted.cpu().numpy(), {k: v.cpu().numpy() for k, v in metrics.items()}, hist.cpu().numpy()

    def fit_population(self, x72: np.ndarray, cam_ext: np.ndarray) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
        """x72 [n, 72], cam_ext [n, 4, 4] -> (fitted x72 [n, 72], per-body
        final metrics). With ``verbose``, a population that fits one call
        prints its mean loss per iteration."""
        n = x72.shape[0]
        if self.cam_post is not None:
            cam_ext = np.asarray(cam_ext, np.float32) @ self.cam_post
        if n <= self.max_population:
            x_fitted, metrics, hist = self._fit_arrays(x72, cam_ext)
            if self.verbose:
                for ii, row in enumerate(hist):
                    print(f"[INFO][fitting] iter={ii:d}, mean_total={float(row.mean()):f}")
            return x_fitted, metrics

        cap = self.max_population
        outs, mets = [], []
        for lo in range(0, n, cap):
            chunk, cams = x72[lo : lo + cap], cam_ext[lo : lo + cap]
            keep = chunk.shape[0]
            if keep < cap:
                chunk = np.concatenate([chunk, np.repeat(chunk[-1:], cap - keep, 0)], 0)
                cams = np.concatenate([cams, np.repeat(cams[-1:], cap - keep, 0)], 0)
            x_fitted, metrics, _ = self._fit_arrays(chunk, cams)
            outs.append(x_fitted[:keep])
            mets.append({k: v[:keep] for k, v in metrics.items()})
        return np.concatenate(outs, axis=0), {k: np.concatenate([m[k] for m in mets], axis=0) for k in mets[0]}

    def fitting_files(self, gen_dir: str, fit_dir: str, max_files: int = 1200) -> int:
        """Read ``body_gen_{i:06d}.pkl`` for i < max_files from ``gen_dir``,
        fit them together and write the results under the same names to
        ``fit_dir``. Inputs that are missing and outputs that exist are
        skipped, so a second call resumes (fitting_proxe.py:257-260).
        Returns the number fitted."""
        items = []
        for ii in range(max_files):
            inp = os.path.join(gen_dir, f"body_gen_{ii:06d}.pkl")
            out = os.path.join(fit_dir, f"body_gen_{ii:06d}.pkl")
            if not os.path.exists(inp) or os.path.exists(out):
                continue
            with open(inp, "rb") as f:
                items.append((ii, pickle.load(f)))
        if not items:
            return 0

        x72 = np.concatenate([body_params_parse(d).numpy() for _, d in items], axis=0)
        # the reference's files hold cam_ext tiled [n_samples, 4, 4]: row 0
        cam_ext = np.concatenate(
            [np.asarray(d["cam_ext"], np.float32).reshape(-1, 4, 4)[:1] for _, d in items]
        )
        x_fitted, _ = self.fit_population(x72, cam_ext)

        os.makedirs(fit_dir, exist_ok=True)
        for (ii, d), rec in zip(items, body_params_encapsulate_list(x_fitted)):
            rec["cam_ext"] = np.asarray(d["cam_ext"])
            rec["cam_int"] = np.asarray(d.get("cam_int"))
            with open(os.path.join(fit_dir, f"body_gen_{ii:06d}.pkl"), "wb") as f:
                pickle.dump(rec, f)
        return len(items)
