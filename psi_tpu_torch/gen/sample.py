"""Generation: sample body populations for scene snapshots.

Port of ``psi_tpu.gen.sample`` (reference source/test_proxe_s1.py:31-134,
test_proxe_s2.py, test_habitat_s{1,2}.py): encode the snapshot
once, broadcast the feature over the population, sample the CVAE prior
(``HumanCVAES1``, or ``HumanCVAES2``'s chained global and local priors),
convert 6D -> axis-angle and recover the metric global translation.
``generate_bodies`` serves one snapshot, ``generate_bodies_rows`` a
coalesced batch of snapshots with one body per population row, and
``generate_bodies_line`` a latent line sweep. All three run the model in
eval mode (running BatchNorm statistics) whatever mode it was left in, and
restore that mode. ``TestOP`` is the file-writing driver on top of
``generate_bodies``: it emits the reference's ``body_gen_{i:06d}.pkl``.

Latents come from ``generator`` (on the model's device) unless ``eps`` is
given: a tensor [N, eps_d] for ``HumanCVAES1``, a pair (eps_g, eps_l) of
[N, 32] tensors for ``HumanCVAES2``.

Under a mesh (``fit.fitting``'s ``mesh=``, ``GenerationEngine(mesh=)``) the
sampler is not sharded: every rank samples the whole population from a
generator in the same state, or the same injected ``eps``, so its rows are
the unsharded call's rows bit for bit, and only the fit after it splits the
rows over the ranks. The scene trunk runs once and the decoder for the
population's rows, a small share of a generate+fit call.
"""

from __future__ import annotations

import contextlib
import os
import pickle
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from psi_tpu_torch.geometry.bodyvec import body_params_encapsulate_list, convert_to_3D_rot
from psi_tpu_torch.geometry.camera import recover_global_T
from psi_tpu_torch.models.cvae_s1 import HumanCVAES1
from psi_tpu_torch.models.cvae_s2 import HumanCVAES2

Model = Union[HumanCVAES1, HumanCVAES2]
Eps = Union[None, torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]


@contextlib.contextmanager
def eval_mode(model: torch.nn.Module):
    """Run a block with ``model`` in eval mode and gradients off, then put
    it back in the mode it was in."""
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            yield
    finally:
        model.train(was_training)


def _noise(model: Model, generator: Optional[torch.Generator], eps: Eps) -> dict:
    """The models' noise keywords from the callers' (generator, eps)."""
    if isinstance(model, HumanCVAES2):
        eps_g, eps_l = eps if eps is not None else (None, None)
        return dict(generator=generator, eps_g=eps_g, eps_l=eps_l)
    return dict(generator=generator, eps=eps)


def generate_bodies(
    model: Model,
    xs: torch.Tensor,  # [1, H, W, 2] snapshot
    cam_int: torch.Tensor,  # [1, 3, 3]
    max_d: torch.Tensor,  # [1]
    n_samples: int,
    generator: Optional[torch.Generator] = None,
    eps: Eps = None,
) -> torch.Tensor:
    """[n_samples, 72] metric body vectors for one snapshot. The scene
    trunk (each of S2's two) runs once, not n_samples times."""
    with eval_mode(model):
        xhnr = model.sample_n(xs, n_samples, **_noise(model, generator, eps))
        xhn = convert_to_3D_rot(xhnr)
        cam_int_n = cam_int.reshape(1, 3, 3).expand(n_samples, 3, 3)
        max_d_n = max_d.reshape(1).expand(n_samples)
        return recover_global_T(xhn, cam_int_n, max_d_n)


def generate_bodies_rows(
    model: Model,
    xs_stack: torch.Tensor,  # [R, H, W, 2] the distinct snapshots
    cam_int_stack: torch.Tensor,  # [R, 3, 3]
    max_d_stack: torch.Tensor,  # [R]
    req_idx: torch.Tensor,  # [P] int: the snapshot of each population row
    generator: Optional[torch.Generator] = None,
    eps: Eps = None,
) -> torch.Tensor:
    """[P, 72]: one body per population row, row r conditioned on snapshot
    xs_stack[req_idx[r]]. The trunk encodes the R snapshots once and the
    features are gathered per row."""
    req_idx = req_idx.to(torch.int64)
    noise = _noise(model, generator, eps)
    with eval_mode(model):
        if isinstance(model, HumanCVAES2):
            z_g, z_l = model.encode_scenes(xs_stack)
            xhnr = model.sample_with_feats(z_g[req_idx], z_l[req_idx], **noise)
        else:
            xhnr = model.sample_with_feat(model.encode_scene(xs_stack)[req_idx], **noise)
        xhn = convert_to_3D_rot(xhnr)
        return recover_global_T(xhn, cam_int_stack[req_idx], max_d_stack.reshape(-1)[req_idx])


def generate_bodies_line(
    model: HumanCVAES1,
    xs: torch.Tensor,
    cam_int: torch.Tensor,
    max_d: torch.Tensor,
    n_samples: int,
    z_range: float = 3.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Latent line sweep for interpolation studies: eps_i is a constant
    vector sweeping [-z_range, z_range) (reference cvae.py:516-534).
    Returns (x72 [N, 72], eps [N, eps_d])."""
    vals = torch.arange(-z_range, z_range, 2.0 * z_range / n_samples, dtype=torch.float32, device=xs.device)
    eps = vals[:n_samples, None].expand(n_samples, model.eps_d).contiguous()
    return generate_bodies(model, xs, cam_int, max_d, n_samples, eps=eps), eps


class TestOP:
    """Generation driver that writes the reference's pickles
    (test_proxe_s1.py:31-134). ``model`` is a HumanCVAES1 or a HumanCVAES2.

    Runs on the first card unless ``device`` says otherwise; the model is
    moved there. One generator on that device, seeded with ``seed``, supplies
    the latents of every call that injects none."""

    __test__ = False  # a driver named after the reference's, not a test class

    def __init__(self, model: Model, n_samples: int = 300, seed: int = 0, device=None):
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError("TestOP runs on an NVIDIA card; pass device='cpu' to generate on the CPU")
            device = torch.device("cuda", 0)
        self.device = torch.device(device)
        self.model = model.to(self.device)
        self.n_samples = n_samples
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    @classmethod
    def from_checkpoint(cls, model: Model, ckpt_dir: str, n_samples: int = 300, seed: int = 0, device=None) -> "TestOP":
        """``model`` with the weights of the newest ``epoch-*.ckp`` under
        ``ckpt_dir``; raises FileNotFoundError when there is none. The
        checkpoint's optimizer moments and training noise stream go into a
        throwaway state: generation keeps its own seeded generator."""
        from psi_tpu_torch.train.checkpoint import load_newest_checkpoint
        from psi_tpu_torch.train.loop import TrainState, make_optimizer

        op = cls(model, n_samples=n_samples, seed=seed, device=device)
        scratch = TrainState(op.model, make_optimizer(op.model, 0.0), 0, torch.Generator(device=op.device))
        if load_newest_checkpoint(ckpt_dir, scratch) is None:
            raise FileNotFoundError(f"no epoch-*.ckp under {ckpt_dir}")
        return op

    def generate(self, batch: Dict[str, np.ndarray], generator: Optional[torch.Generator] = None,
                 eps: Eps = None) -> torch.Tensor:
        """batch: one test snapshot (xs [1, H, W, 2], cam_int [1, 3, 3] or
        [3, 3], max_d [1]) as numpy arrays -> [n_samples, 72] on the device."""
        to = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(self.device)
        if eps is None and generator is None:
            generator = self.generator
        return generate_bodies(
            self.model, to(batch["xs"]), to(batch["cam_int"]).reshape(1, 3, 3), to(batch["max_d"]).reshape(1),
            self.n_samples, generator=generator, eps=eps,
        )

    def test(self, batch: Dict[str, np.ndarray], output_dir: str, scene_name: str, idx_offset: int = 900) -> int:
        """Write ``n_samples`` pickles for the snapshot into
        ``output_dir/scene_name``, numbered from ``idx_offset`` (the
        reference's +900, test_proxe_s1.py:131), each with the snapshot's
        ``cam_ext`` and ``cam_int`` attached. Returns the count."""
        xh = self.generate(batch)
        outdir = os.path.join(output_dir, scene_name)
        os.makedirs(outdir, exist_ok=True)
        recs = body_params_encapsulate_list(xh.cpu().numpy())
        for ii, rec in enumerate(recs):
            rec["cam_ext"] = np.asarray(batch["cam_ext"])
            rec["cam_int"] = np.asarray(batch["cam_int"])
            with open(os.path.join(outdir, f"body_gen_{ii + idx_offset:06d}.pkl"), "wb") as f:
                pickle.dump(rec, f)
        return len(recs)
