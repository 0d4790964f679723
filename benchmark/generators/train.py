"""Closed loop of CVAE training steps, every batch from the native loader.

The program's entry is ``train/loop.py::make_train_step(assets, LossConfig(...), model_type)`` over one
``TrainState`` (the model, ``make_optimizer``'s Adam, a noise generator), fed as ``TrainOP`` feeds it at
``TrainConfig()`` defaults: ``NativeBatchGenerator`` over a pack of ``samples`` rows written from the seed under
``TMPDIR`` at set-up, each batch staged by ``_stage_chunk``, the step's metrics read back after it, the loader
reset at each epoch's end, both gates open. The latents of every step are drawn by the benchmark and injected.

Set-up takes the first ``checked_steps`` steps through the same call and feed; the check follows them with
the reference from the same weights, batches and latents and compares the first step's loss (the later
steps' losses part on round-off as far as TF32's do), the norm of each leaf's first gradient (each
parameter's ``.grad`` as Adam read it) and the norm of each leaf's change after those steps, by the worst
leaf; leaves whose reference gradient is under a thousandth of the median leaf's move by
round-off alone under Adam and are left out of the change.

The window holds one of its own steps for the check: the first that starts a new epoch (the loader
reshuffled and reset), or its first step where the window starts none. The program's state before that
step (parameters, buffers, Adam's moments and count) is kept, and with it the step's batch, latents, loss,
the gradient Adam read (each parameter's ``.grad`` after the step) and the parameters after it. The
reference takes that step from the kept state (the hundreds of steps before it cannot be followed on
round-off) and the check reads the step's loss, its gradient and the parameters' change, by the worst leaf
as above; the traffic file's ``limits`` say which are compared. No gradient is worked out from Adam's first
moment, (m1 - b1 m0) / (1 - b1): where the moment is far larger than the gradient, as stage 2's local VAE
reaches ~1e12 against gradients of ~10 by its 60th step, that difference keeps none of the gradient's
digits. A state left unchanged shows in the change, not in the gradient. ``train_device_ms_per_step`` is the
card's busy time over the whole window (``trace.DeviceClock``) over every step of it; the steps over the
window's wall, which ends with the last step's metrics read back, are ``steps_per_s.train``, read from the
untraced rest of a traced run: the host paces them, and they move with its speed from run to run.

The configuration's ``model_type`` picks the model and the reference's loss. Stage 1 draws a step's latents
as one [B, eps_d] tensor; stage 2 as the pair (global, local), each [B, eps_d], in that order, as
``train/loop.py::global_noise`` draws them. Both sides get the same latents. The model starts from the
traffic's ``weights`` (``WEIGHTS``): stage 2 trained at these settings from the ``random`` spread overflows
(the local VAE's log-variance) within a window on some seeds, so its mix starts as the program's own
training run does.
"""

from __future__ import annotations

import math
import shutil
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np
import torch

from benchmark import inputs, system
from benchmark.faults import patched
from benchmark.reference import train as rtrain
from benchmark.reference.numerics import CONTROL, STATED, Numerics
from benchmark.reference.scene import morton_order


# the CPU tests' toy run: the traffic's overrides, and the configuration cut to toy widths (the native
# loader's snapshots stay at 128 px)
TOY = {"batch_size": 8, "samples": 64, "trace_seconds": 0.5}


def toy_config(cfg: Dict) -> Dict:
    return inputs.toy_psi(cfg, image_size=128)


# the model's starting weights, by the traffic's ``weights``: spread so that activations stay of order one
# (``inputs.fill_weights``; also the genfit cells'), or as the program's own training run starts them
WEIGHTS = {"random": inputs.fill_weights, "training_start": inputs.training_start}


def output_bias(model: torch.nn.Module) -> str:
    """The bias of the model's output layer, the last ``nn.Linear`` it
    registers: stage 1's ``linear_out``, stage 2's local decoder's last."""
    return [n for n, m in model.named_modules() if isinstance(m, torch.nn.Linear)][-1] + ".bias"


def plant(fault: str):
    """``benchmark/faults.py``'s faults in the training step, for either
    stage: Adam steps nothing (unchanged_state); the loss is taken over the
    first half of the batch and of its latents (half_batch); every step's
    update is nudged by 1e-3 in each element of the output layer's bias
    (altered_answer)."""
    import psi_tpu_torch.train.loop as loop

    if fault == "unchanged_state":
        class Still(torch.optim.Adam):
            def step(self, closure=None):
                return None

        return patched(loop, "make_optimizer", lambda m, lr: Still(m.parameters(), lr=lr))
    if fault == "half_batch":
        inner = loop.cvae_loss

        def halved(model, batch, *a, eps=None, **k):
            h = (eps[0] if isinstance(eps, tuple) else eps).shape[0] // 2
            eps = tuple(e[:h] for e in eps) if isinstance(eps, tuple) else eps[:h]
            return inner(model, {n: v[:h] for n, v in batch.items()}, *a, eps=eps, **k)

        return patched(loop, "cvae_loss", halved)
    if fault == "altered_answer":
        inner_o = loop.make_optimizer

        def nudged(model, lr):
            opt = inner_o(model, lr)
            step = opt.step
            leaf = dict(model.named_parameters())[output_bias(model)]

            def stepped(closure=None):
                out = step(closure)
                with torch.no_grad():
                    leaf.add_(1e-3)
                return out

            opt.step = stepped
            return opt

        return patched(loop, "make_optimizer", nudged)
    raise ValueError(f"unknown fault {fault!r}")


def make_pack_arrays(n: int, cfg: Dict, gen: torch.Generator, device) -> Dict[str, np.ndarray]:
    """n training samples: snapshots, bodies in front of their cameras,
    cameras (a random rotation and offset), intrinsics, depth and scene."""
    size = cfg["image_size"]
    snaps = inputs.make_snapshots(n, size, cfg["scene_in_channels"], gen, device)
    r = torch.randn((n, 72 + 6), generator=gen, device=device)
    u = torch.rand((n, 2), generator=gen, device=device)
    xh = r[:, :72] * 0.3
    xh[:, 2] = (0.5 + 0.4 * u[:, 0]) * snaps["max_d"]
    cam_ext = torch.eye(4, device=device).repeat(n, 1, 1)
    from benchmark.reference.body import aa_to_matrix
    cam_ext[:, :3, :3] = aa_to_matrix(r[:, 72:75] * 0.3)
    cam_ext[:, :3, 3] = r[:, 75:78] * 0.5
    sid = (u[:, 1] * cfg["scenes"]["num_scenes"]).to(torch.int32).clamp(max=cfg["scenes"]["num_scenes"] - 1)
    host = lambda t: t.cpu().numpy()
    xs = host(snaps["xs"])
    return {"depth": xs[..., 0], "seg": xs[..., 1], "body": host(xh), "cam_ext": host(cam_ext),
            "cam_int": host(snaps["cam_int"]), "max_d": host(snaps["max_d"]), "sceneid": host(sid)}


def leaf_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor], keep=None) -> float:
    """The worst leaf's |norm(prog) - norm(ref)| over the larger of the
    leaf's reference norm and the median leaf's. Infinite where a norm is
    not finite (a side overflowed: ``max`` would pass over a NaN) or no leaf
    is kept."""
    names = [k for k in ref if keep is None or k in keep]
    rn = {k: float(ref[k].norm()) for k in names}
    med = float(np.median(list(rn.values()))) if rn else math.nan
    gaps = [abs(float(prog[k].norm()) - rn[k]) / max(rn[k], med, 1e-30) for k in names]
    return max(gaps) if gaps and all(map(math.isfinite, gaps)) else math.inf


class Generator:
    def __init__(self, run):
        self.run = run
        self.cfg, self.tr, self.dev, self.seed = run.config, run.traffic, run.device, run.seed

    def setup(self) -> None:
        from psi_tpu_torch.data.native_loader import NativeBatchGenerator, pack_dataset
        from psi_tpu_torch.train.loop import TrainState, _stage_chunk, make_optimizer, make_train_step
        from psi_tpu_torch.utils.config import LossConfig

        cfg, tr, dev, seed = self.cfg, self.tr, self.dev, self.seed
        init = WEIGHTS[tr.get("weights", "random")]
        self.weights = init(system.model_shapes(cfg), inputs.generator(seed, 1, dev), dev)
        self.vposer = inputs.fill_weights(system.vposer_shapes(cfg), inputs.generator(seed, 2, dev), dev)
        self.body = inputs.make_body(cfg, inputs.generator(seed, 3, dev), dev)
        self.scenes = inputs.make_scenes(cfg, inputs.generator(seed, 4, dev), dev)
        self.assets = system.build_assets(cfg, self.body, self.vposer, self.scenes, None, dev)
        model = system.build_model(cfg, self.weights, dev)
        lw = tr["loss"]
        loss_cfg = LossConfig(weight_loss_rec_h=lw["rec"], weight_loss_vposer=lw["vposer"], weight_loss_kl=lw["kl"],
                              weight_contact=lw["contact"], weight_collision=lw["collision"],
                              contact_denom_offset=lw["contact_offset"], prune_scene_points=0)
        self.state = TrainState(model, make_optimizer(model, tr["lr"]), 0, torch.Generator(device=dev))
        self.step_fn = make_train_step(self.assets, loss_cfg, cfg["model_type"])
        # TrainOP stages a group of one batch and steps its slice 0
        self.stage = lambda b: {k: v[0] for k, v in _stage_chunk([b], False, dev).items()}
        self.dir = Path(tempfile.mkdtemp(prefix="psi_bench_pack_"))
        pack = pack_dataset(str(self.dir / "train.psipack"),
                            **make_pack_arrays(tr["samples"], cfg, inputs.generator(seed, 5, dev), dev))
        self.loader = NativeBatchGenerator(pack, tr["batch_size"], seed=seed % (1 << 31))
        self.noise = inputs.generator(seed, 6, dev)
        self.loader_s = 0.0
        self.first: List[Tuple[Dict, torch.Tensor, float]] = []
        n = tr["checked_steps"]
        for i in range(max(n, tr["warmup_steps"])):
            batch, eps, metrics = self._step()
            if i < n:
                self.first.append((batch, eps, float(metrics["loss"])))
            if i == 0:
                self.grad1 = self._grads()
            if i == n - 1:
                self.change = {k: (p.detach() - self.weights[k]) for k, p in self.state.model.named_parameters()}
        self.loader_s = 0.0

    def _next_batch(self) -> Dict[str, np.ndarray]:
        t0 = time.perf_counter()
        if not self.loader.has_next_batch():
            self.loader.reset()
        b = self.loader.next_batch(self.tr["batch_size"])
        self.loader_s += time.perf_counter() - t0
        return b

    def _step(self):
        """One step as TrainOP takes it at its defaults: fetch, stage, step,
        read the metrics back."""
        b = self._next_batch()
        eps = self._latents()
        self.state, m = self.step_fn(self.state, self.stage(b), self.tr["fca"], self.tr["f_scene"], eps=eps)
        names = list(m)
        return b, eps, dict(zip(names, torch.stack([m[k] for k in names]).tolist()))

    def _latents(self):
        """A step's latents: [B, eps_d] for stage 1; stage 2's global, then its local."""
        draw = lambda: torch.randn((self.tr["batch_size"], self.cfg["eps_d"]), generator=self.noise, device=self.dev)
        return draw() if self.cfg["model_type"] == "s1" else (draw(), draw())

    def _state(self) -> Dict[str, Dict]:
        """The training state, copied: parameters and buffers (``weights``)
        and Adam's state of each parameter (``adam``)."""
        model, opt = self.state.model, self.state.optimizer
        copy = lambda v: v.detach().clone() if torch.is_tensor(v) else v
        return {"weights": {k: copy(v) for k, v in model.state_dict().items()},
                "adam": {k: {n: copy(v) for n, v in opt.state[p].items()} for k, p in model.named_parameters()}}

    def _grads(self) -> Dict[str, torch.Tensor]:
        """Each parameter's gradient as the optimizer read it in the last step."""
        return {k: (p.grad.detach().clone() if p.grad is not None else torch.zeros_like(p))
                for k, p in self.state.model.named_parameters()}

    def window(self, seconds: float, tracer) -> Tuple[Dict[str, float], Dict]:
        dev = self.dev
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        self.loader_s = 0.0
        self.held = None
        steps = 0
        tracer.start()
        t0 = time.perf_counter()
        while True:
            starts = not self.loader.has_next_batch()
            hold = self.held is None or (starts and not self.held["epoch_start"])
            if hold:
                before = self._state()
            with torch.profiler.record_function("bench.train_step"):
                batch, eps, metrics = self._step()
            if hold:
                after = {k: p.detach().clone() for k, p in self.state.model.named_parameters()}
                self.held = {"epoch_start": starts, "step": steps, "before": before, "batch": batch, "eps": eps,
                             "loss": float(metrics["loss"]), "grad": self._grads(), "after": after}
            steps += 1
            tracer.tick(steps)
            if time.perf_counter() - t0 >= seconds:
                break
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t_end = time.perf_counter()
        tracer.tick(steps, force=True)
        wall = t_end - t0
        counters = {"calls": steps, "traced_calls": tracer.units, "window_s": wall, "loader_s": self.loader_s,
                    "held_step": self.held["step"], "held_epoch_start": self.held["epoch_start"],
                    **tracer.untraced(steps, t0, t_end)}
        e2e = {}
        if tracer.device_busy_s is not None:
            e2e["train_device_ms_per_step"] = 1e3 * tracer.device_busy_s / steps
        return e2e, counters

    def release(self) -> None:
        self.loader.close()
        shutil.rmtree(self.dir, ignore_errors=True)
        del self.state, self.step_fn, self.assets

    def _world(self, num: Numerics) -> Dict:
        sc = self.scenes
        clouds = torch.stack([c[torch.from_numpy(morton_order(c.cpu().numpy())).to(self.dev)] for c in sc["cloud"]])
        return {"body": self.body, "vposer": self.vposer, "contact": self.body["contact"],
                "grid": num.grid_values(sc["sdf"]), "gmins": sc["grid_mins"], "gmaxs": sc["grid_maxs"],
                "clouds": clouds}

    def _batch(self, b: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(np.asarray(v)).to(self.dev) for k, v in b.items()}

    def _reference(self, num: Numerics):
        """The reference's first steps from the seed's weights."""
        tr = self.tr
        lc = dict(tr["loss"], fca=tr["fca"], f_scene=tr["f_scene"])
        batches = [self._batch(b) for b, _, _ in self.first]
        eps = [e for _, e, _ in self.first]
        return rtrain.train_steps(self.weights, batches, eps, self._world(num), lc, tr["lr"], num,
                                  model_type=self.cfg["model_type"])

    def _reference_held(self, num: Numerics):
        """The reference's step of the window's held step, from the program's state before it."""
        tr, h = self.tr, self.held
        lc = dict(tr["loss"], fca=tr["fca"], f_scene=tr["f_scene"])
        return rtrain.train_steps(h["before"]["weights"], [self._batch(h["batch"])], [h["eps"]], self._world(num),
                                  lc, tr["lr"], num, adam=h["before"]["adam"], model_type=self.cfg["model_type"])

    def _held(self):
        """The program's held step: (its loss, its gradient, the parameters' change)."""
        h = self.held
        return [h["loss"]], h["grad"], {k: a - h["before"]["weights"][k] for k, a in h["after"].items()}

    def check(self, num: Numerics = None) -> Dict[str, float]:
        """The first steps (``loss1_gap``, ``grad_gap``, ``change_gap``) and the
        window's held step (``win_loss_gap``, ``win_grad_gap``, ``win_change_gap``).
        ``num``: put the reference in the program's place, computed so (the control)."""
        first = lambda: ([l for _, _, l in self.first], self.grad1, self.change)
        out = {}
        for names, ref_fn, prog_fn in ((("loss1_gap", "grad_gap", "change_gap"), self._reference, first),
                                       (("win_loss_gap", "win_grad_gap", "win_change_gap"), self._reference_held,
                                        self._held)):
            ref_loss, ref_g, ref_d = ref_fn(STATED["exact"])
            loss, g, d = prog_fn() if num is None else ref_fn(num)
            norms = {k: float(v.norm()) for k, v in ref_g.items()}
            med = float(np.median(list(norms.values())))
            moved = {k for k, n in norms.items() if n >= 1e-3 * med}
            out.update(zip(names, (abs(loss[0] - ref_loss[0]) / abs(ref_loss[0]), leaf_gap(g, ref_g),
                                   leaf_gap(d, ref_d, keep=moved))))
        return out

    def control(self) -> Dict[str, float]:
        return self.check(CONTROL["exact"])
