"""Configuration dataclasses, the same as ``psi_tpu.utils.config``.

The fields, defaults and constructors are psi_tpu's, unchanged, so one
``FitConfig`` drives both packages in the parity tests (reference:
source/train_s1.py:345-423). The comments describe what each field
selects in this package. ``fit/fitting.py`` honours every ``FitConfig``
field except three of psi_tpu's fit modes, which it refuses when a fit is
built with one of them switched on (their comments say why).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """Loss weights (reference train_s1.py:416-423, train_js.sh:9-27)."""

    weight_loss_rec_h: float = 1.0
    weight_loss_vposer: float = 1e-3
    weight_loss_kl: float = 0.1
    weight_contact: float = 1e-2
    weight_collision: float = 1e-1
    loss_weight_anealing: bool = True  # reference spelling kept in CLI
    contact_denom_offset: float = 1.0
    # contact-chamfer candidate pruning for the TRAINING loss, same
    # scheme as FitConfig.prune_scene_points. 0 = exact reference
    # semantics.
    prune_scene_points: int = 0


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training loop configuration (reference train_s1.py:392-413)."""

    model_type: str = "s1"  # 's1' | 's2'
    image_size: int = 128  # snapshot canvas side (batch_gen_hdf5.py:359)
    batch_size: int = 32
    epoch: int = 30
    init_lr_h: float = 3e-4
    latentD: int = 256
    use_cont_rot: bool = True
    save_dir: str = "checkpoints"
    resume_training: bool = True
    saving_per_hours: float = 2.0  # wall-clock checkpoint cadence (train_s1.py:303-310)
    saving_per_epochs: int = 10  # epoch checkpoint cadence (train_s1.py:316-321)
    contact_part: Tuple[str, ...] = (
        "back", "butt", "L_Hand", "R_Hand", "L_Leg", "R_Leg", "thighs",
    )
    verbose: bool = True
    seed: int = 0
    # data paths (None -> synthetic fixture)
    train_data_path: Optional[str] = None
    scene_verts_path: Optional[str] = None
    scene_sdf_path: Optional[str] = None
    human_model_path: Optional[str] = None
    vposer_ckpt_path: Optional[str] = None
    contact_id_folder: Optional[str] = None
    scene_model_ckpt: Optional[str] = None
    # optimizer robustness (off by default = reference parity; the raw
    # Adam + exp(logvar) KL objective can spike early in training)
    grad_clip_norm: Optional[float] = None
    # run each epoch in chunks of scan_chunk_size batches staged on the
    # device at once (psi_tpu: chunked lax.scan programs)
    scan_epoch: bool = False
    scan_chunk_size: int = 32
    # stage snapshot images to the device in bfloat16 (the model upcasts
    # to f32 on entry); lossy for the depth channel — opt-in
    stage_bf16: bool = False
    # parallelism
    num_devices: Optional[int] = None  # None -> all available

    @property
    def n_dim_body(self) -> int:
        return 75 if self.use_cont_rot else 72


@dataclasses.dataclass(frozen=True)
class FitConfig:
    """Fitting refinement configuration (reference fitting_proxe.py:227-247).

    The dataclass DEFAULTS are the reference-exact loss semantics (full
    NN search + real SDF gathers every iteration, 'high' LBS) — the
    parity contract for library callers. The serving and bench entry
    points use ``FitConfig.production()`` (selection refresh + fused
    LBS); ``FitConfig.exact()`` restores the reference semantics.
    """

    init_lr_h: float = 0.1
    num_iter: int = 20
    weight_loss_rec: float = 1.0
    weight_loss_vposer: float = 0.01
    weight_contact: float = 0.1
    weight_collision: float = 0.5
    contact_denom_offset: float = 0.01  # 1.0 for habitat (fitting_habitat.py:141)
    # contact chamfer: per-iteration candidate pruning — keep the ~K
    # scene points nearest each body's contact centroid before the NN
    # search, selected tile-granularly over the Morton-ordered scene
    # cloud (ops/prune.py::select_near_tiles). 0 = the full cloud.
    prune_scene_points: int = 2048
    # psi_tpu: recompute the decode in the backward pass instead of keeping
    # its residuals. The port refuses True: on the H100 it gave the same bits
    # 1.28-1.84x slower and saved no memory. Kept so that one config file
    # serves both packages.
    remat_decode: bool = False
    # selection-refresh mode (refresh_every > 1): a FULL loss pass (NN
    # search over the pruned cloud, packed-grid SDF gather per vertex)
    # runs only every refresh_every-th iteration; in between, collision
    # is evaluated against each vertex's frozen grid-cell patch
    # (ops/sdf.py::sdf_trilinear_from_cache) and contact against each
    # contact vertex's frozen NN scene point
    # (ops/chamfer.py::chamfer_one_sided_nn). 1 = a full pass every
    # iteration (the exact reference path).
    refresh_every: int = 1
    # the first refresh_warmup iterations run fresh passes: Adam's early
    # steps are the largest (~lr per coordinate), so frozen state is
    # stalest then.
    refresh_warmup: int = 4
    # LBS precision inside the fit loss: 'high' = f32 with the two large
    # contractions as split-bf16 products (ops/precision.py, psi_tpu's);
    # 'fast' = bf16 operands with
    # f32 accumulation for the three large LBS contractions; 'fused' =
    # the whole LBS vertex path (blendshapes + skinning + transl +
    # camera) as one kernel pair at the 'fast' tier
    # (ops/fused_skinning.py).
    lbs_precision: str = "high"
    # Packed-SDF gather cadence within the warmup: False keeps the real
    # gather at iteration 0 and at every post-warmup refresh, while
    # warmup iterations 1..w-1 re-search NN correspondences but reuse the
    # iteration-0 cell cache for collision (the nn_only pass kind). Only
    # consulted when refresh_every > 1.
    sdf_warmup_gathers: bool = False
    # psi_tpu: K > 0 decodes only the contact vertices plus K collision
    # rows on the passes that read the carried SDF cells. The port refuses
    # K > 0: on the H100 it was no faster (0.96-1.12x the default's time),
    # left the fit 4.3% worse, and its subset, built from host arrays in the
    # middle of the loop, cannot join the fit's CUDA graph. Kept so that one
    # config file serves both packages.
    cheap_collision_verts: int = 0
    # psi_tpu: step the population as C chunks, each with its own Adam, in
    # every iteration. The port refuses C > 1: each body's fit is its own, so
    # the chunks give the batched fit's bodies, and on the H100 C = 2 took
    # 1.68-2.37x the default's time. Kept so that one config file serves
    # both packages.
    overlap_chunks: int = 1

    @classmethod
    def production(cls, **overrides) -> "FitConfig":
        """The throughput configuration: selection-refresh blocks (a
        full loss pass every 10th iteration after a 4-iteration NN-only
        warmup) + the fused LBS kernels. Pair with bf16 packed SDF grids
        (make_assets(sdf_dtype=torch.bfloat16)) for the full production
        stack. FitConfig.exact() restores reference semantics."""
        kw = dict(refresh_every=10, lbs_precision="fused")
        kw.update(overrides)
        return cls(**kw)

    @classmethod
    def exact(cls, **overrides) -> "FitConfig":
        """Reference-exact loss semantics (= the dataclass defaults,
        spelled explicitly): NN search + real packed-grid SDF gathers
        every Adam iteration, 'high' LBS. prune_scene_points=2048 is
        kept; pass prune_scene_points=0 for the fully-exact NN search."""
        kw = dict(refresh_every=1, lbs_precision="high")
        kw.update(overrides)
        return cls(**kw)


def save_config(cfg, path: str) -> None:
    with open(path, "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=2, default=str)


def load_config(cls, path: str):
    with open(path) as f:
        d = json.load(f)
    if "contact_part" in d and isinstance(d["contact_part"], list):
        d["contact_part"] = tuple(d["contact_part"])
    return cls(**d)
