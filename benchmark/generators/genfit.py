"""Closed loop of population calls: sample a population for one snapshot
and fit it to its scene, back to back from one caller.

The program's entry is ``make_generate_fit_step(model, assets, FitConfig.<tier>(num_iter), population,
want_metrics=False)``. Set-up makes ``pool`` inputs from the seed: a snapshot of one of the scenes (in
turn), its latents, and the extrinsics that put the population into that scene's floor (from the
reference sampler's mean translation). Call i takes input i mod pool. ``bodies_per_s`` is every body
sampled and fitted over the whole window, which ends when the last call that started in it has
finished.

The check runs the reference's generate+fit on ``check_calls`` of the window's calls, drawn from the
seed, and reads (``gaps``): each body's total loss at iteration 0 (the sampler, the decode, contact and
collision; the largest relative gap), at iteration 1 (after the first Adam step; the population's 75th
percentile) and at iterations 2 to 4 (the largest of their 75th percentiles), and the fitted population
(``population_gaps``). The traffic file's ``limits`` say which readings are compared. A single fitted
body is not held by itself: 20 Adam steps part some bodies' paths on round-off alone (the program
against itself with the extrinsics moved by 1e-6 parts a few bodies by 0.05-0.09 a coordinate), so the
fitted population is held by its quantiles.
"""

from __future__ import annotations

import time
from typing import Dict, List, Tuple

import torch

from benchmark import inputs, system
from benchmark.faults import patched
from benchmark.reference import body as rbody
from benchmark.reference import fit as rfit
from benchmark.reference.numerics import CONTROL, STATED, Numerics


# the CPU tests' toy run: the traffic's overrides, and the configuration cut to toy widths
TOY = {"population": 8, "num_iter": 12, "pool": 4, "trace_seconds": 0.5, "fit": {"prune": 128}}


def toy_config(cfg: Dict) -> Dict:
    return inputs.toy_psi(cfg, image_size=32)


def plant(fault: str):
    """``benchmark/faults.py``'s faults in the generate+fit call: the fit's
    Adam returns the bodies as it got them (unchanged_state); every other
    body of the population takes no gradient, the sum rescaled to the whole
    (half_batch); body 0 of every sampled population is moved by 0.5 m in
    height (altered_answer)."""
    import psi_tpu_torch.fit.fitting as fitting

    if fault == "unchanged_state":
        return patched(fitting.Adam, "step", lambda self, x, g: x)
    if fault == "half_batch":
        inner = fitting._per_body_losses

        def half_loss(assets, xhr, *a, **k):
            total, rest = inner(assets, xhr, *a, **k)
            per = rest[0]["total"]
            return per[::2].sum() * (per.shape[0] / per[::2].shape[0]), rest

        return patched(fitting, "_per_body_losses", half_loss)
    if fault == "altered_answer":
        inner_g = fitting.generate_bodies

        def sampled(*a, **k):
            x72 = inner_g(*a, **k)
            return torch.cat([x72[:1] + 0.5 * (torch.arange(72, device=x72.device) == 1), x72[1:]])

        return patched(fitting, "generate_bodies", sampled)
    raise ValueError(f"unknown fault {fault!r}")


class Reference:
    """The reference's generate+fit over the raw inputs, in given numerics."""

    def __init__(self, cfg: Dict, tr: Dict, raw: Dict, num: Numerics):
        self.cfg, self.tr, self.raw, self.num = cfg, tr, raw, num
        self.scenes = rfit.Scenes(raw["scenes"]["sdf"], raw["scenes"]["grid_mins"], raw["scenes"]["grid_maxs"],
                                  raw["scenes"]["cloud"], num)
        prod = tr["tier"] == "production"
        w = tr["fit"]
        self.fc = dict(num_iter=tr["num_iter"], lr=w["lr"], w_rec=w["weight_rec"], w_vposer=w["weight_vposer"],
                       w_contact=w["weight_contact"], w_collision=w["weight_collision"],
                       contact_offset=w["contact_offset"], prune=w["prune"],
                       refresh_every=w["refresh_every"] if prod else 1, refresh_warmup=w["refresh_warmup"],
                       folded_joints=prod)

    def sample(self, xs, cam_int, max_d, rows, eps) -> torch.Tensor:
        with self.num.matmul_mode(), torch.no_grad():
            return rfit.generate(self.cfg["model_type"], self.raw["weights"], xs, cam_int, max_d, rows, eps)

    def generate_fit(self, xs, cam_int, max_d, rows, eps, cam_ext, scene_idx):
        """(fitted x72, each body's loss at each iteration, the sampled x72)."""
        x72 = self.sample(xs, cam_int, max_d, rows, eps)
        with self.num.matmul_mode():
            fitted, hist = rfit.fit(self.fc, self.raw["body"], self.raw["vposer"], self.raw["body"]["contact"],
                                    self.scenes, self.num, x72, cam_ext, scene_idx)
        return fitted, hist, x72


def make_raw(cfg: Dict, seed: int, device) -> Dict:
    """Weights, body, VPoser and scenes of one seed."""
    return {
        "weights": inputs.fill_weights(system.model_shapes(cfg), inputs.generator(seed, 1, device), device),
        "vposer": inputs.fill_weights(system.vposer_shapes(cfg), inputs.generator(seed, 2, device), device),
        "body": inputs.make_body(cfg, inputs.generator(seed, 3, device), device),
        "scenes": inputs.make_scenes(cfg, inputs.generator(seed, 4, device), device),
    }


def population_gaps(x_prog: torch.Tensor, x_ref: torch.Tensor, x_init: torch.Tensor) -> Dict[str, float]:
    """Fitted populations compared (see the module docstring): the median
    body's median coordinate gap, and the mean over bodies of the relative
    gap of how far each body moved from its sample (a body left unfitted
    reads 1). The distances are taken in the 6-D rotation form that the fit
    moves in: the axis-angle that a 72-D body stores turns to its opposite
    near a half turn, a jump of ~2 pi between two equal rotations."""
    body = (x_prog - x_ref).abs().median(dim=1).values
    prog, ref, init = (rbody.to_6d(x) for x in (x_prog, x_ref, x_init))
    moved_ref = (ref - init).norm(dim=1)
    moved = ((prog - init).norm(dim=1) - moved_ref).abs() / moved_ref.clamp(min=1e-6)
    return {"fit_median_gap": float(torch.quantile(body, 0.5)), "fit_move_gap": float(moved.mean())}


def gaps(x_prog, h_prog, x_ref, h_ref, x_init) -> Dict[str, float]:
    """The compared numbers of one call: each body's loss at iteration 0
    (the largest relative gap), at iteration 1 (after the first Adam step;
    the population's 75th percentile) and at iterations 2 to 4 (the largest
    of the three 75th percentiles: Adam's later updates, with moments and
    bias corrections past their first step), and the fitted population
    (``population_gaps``)."""
    rel = (h_prog[:5] - h_ref[:5]).abs() / h_ref[:5].abs().clamp(min=1e-6)
    q75 = torch.quantile(rel, 0.75, dim=1)
    return {"loss0_gap": float(rel[0].max()), "loss1_q75_gap": float(q75[1]),
            "loss2to4_q75_gap": float(q75[2:5].max()), **population_gaps(x_prog, x_ref, x_init)}


class Generator:
    def __init__(self, run):
        self.run = run
        self.cfg, self.tr, self.dev, self.seed = run.config, run.traffic, run.device, run.seed

    def setup(self) -> None:
        from psi_tpu_torch.fit.fitting import make_generate_fit_step
        from psi_tpu_torch.utils.config import FitConfig

        cfg, tr, dev, seed = self.cfg, self.tr, self.dev, self.seed
        self.raw = make_raw(cfg, seed, dev)
        prod = tr["tier"] == "production"
        self.model = system.build_model(cfg, self.raw["weights"], dev)
        self.assets = system.build_assets(cfg, self.raw["body"], self.raw["vposer"], self.raw["scenes"],
                                          torch.bfloat16 if prod else None, dev)
        fit_cfg = (FitConfig.production if prod else FitConfig.exact)(num_iter=tr["num_iter"])
        self.step = make_generate_fit_step(self.model, self.assets, fit_cfg, tr["population"], want_metrics=False)
        self.ref = Reference(cfg, tr, self.raw, STATED[tr["tier"]])
        self.pool = self._pool(seed)
        for p in range(min(tr["warmup_calls"], tr["pool"])):
            self._call(p)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def _pool(self, seed: int) -> List[Dict]:
        """The pool's inputs, each with its floor placement."""
        cfg, tr, dev = self.cfg, self.tr, self.dev
        P, N = tr["pool"], tr["population"]
        S = cfg["scenes"]["num_scenes"]
        snaps = inputs.make_snapshots(P, cfg["image_size"], cfg["scene_in_channels"],
                                      inputs.generator(seed, 5, dev), dev)
        eps = inputs.latents(cfg["model_type"], P * N, inputs.generator(seed, 6, dev), dev, cfg.get("eps_d", 32))
        sc = self.raw["scenes"]
        zeros = torch.zeros(N, dtype=torch.int64, device=dev)
        pool = []
        for p in range(P):
            e = eps[p * N:(p + 1) * N] if torch.is_tensor(eps) else (eps[0][p * N:(p + 1) * N], eps[1][p * N:(p + 1) * N])
            s = p % S
            item = {"xs": snaps["xs"][p:p + 1], "cam_int": snaps["cam_int"][p:p + 1],
                    "max_d": snaps["max_d"][p:p + 1], "eps": e, "scene_idx": zeros + s}
            x72 = self.ref.sample(item["xs"], item["cam_int"], item["max_d"], zeros, e)
            item["cam_ext"] = inputs.floor_placement(x72[:, :3].mean(0), sc["grid_mins"][s],
                                                     sc["grid_maxs"][s], N)
            pool.append(item)
        return pool

    def _call(self, p: int):
        it = self.pool[p]
        x72, _, hist = self.step(it["xs"], it["cam_int"], it["max_d"], it["cam_ext"], it["scene_idx"], eps=it["eps"])
        return x72, hist

    def window(self, seconds: float, tracer) -> Tuple[Dict[str, float], Dict]:
        dev, P = self.dev, self.tr["pool"]
        self.outs = []
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        tracer.start()
        t0 = time.perf_counter()
        while True:
            with torch.profiler.record_function("bench.genfit_call"):
                self.outs.append(self._call(len(self.outs) % P))
            tracer.tick(len(self.outs))
            if time.perf_counter() - t0 >= seconds:
                break
        tracer.tick(len(self.outs), force=True)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t_end = time.perf_counter()
        wall = t_end - t0
        n = len(self.outs)
        counters = {"calls": n, "traced_calls": tracer.units, "window_s": wall, **tracer.untraced(n, t0, t_end)}
        return {"bodies_per_s": n * self.tr["population"] / wall}, counters

    def release(self) -> None:
        del self.step, self.model, self.assets

    def check(self, num: Numerics = None) -> Dict[str, float]:
        """The compared numbers, the worst over the checked calls. ``num``:
        put the reference in the program's place, computed so (the control)."""
        P = self.tr["pool"]
        ref = self.ref
        sub = Reference(self.cfg, self.tr, self.raw, num) if num is not None else None
        worst: Dict[str, float] = {}
        for i in inputs.pick(self.seed, 7, len(self.outs), self.tr["check_calls"]):
            it = self.pool[i % P]
            args = (it["xs"], it["cam_int"], it["max_d"], torch.zeros_like(it["scene_idx"]), it["eps"],
                    it["cam_ext"], it["scene_idx"])
            x_ref, h_ref, x_init = ref.generate_fit(*args)
            x_prog, h_prog = sub.generate_fit(*args)[:2] if sub is not None else self.outs[i]
            for k, v in gaps(x_prog, h_prog, x_ref, h_ref, x_init).items():
                worst[k] = max(worst.get(k, 0.0), v) if v == v else float("inf")
        return worst

    def control(self) -> Dict[str, float]:
        return self.check(CONTROL[self.tr["tier"]])
