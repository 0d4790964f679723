"""psi_tpu_torch's result renderer and the VPoser trainer's grid:
``show_generated_results`` on pickles the port's TestOP wrote, against
psi_tpu's on assets with the same weights (rendered images equal in >= 99.9%
of pixels, as tests/test_torch_viz.py holds the renderer), and
``VPoserTrainer.vis_results`` writing its 3 x n_show PNG grid. Kept apart
from tests/test_torch_viz.py because psi_tpu's side takes ~20 s on the CPU.
"""

import os
import pickle

import numpy as np
import torch

from psi_tpu.viz import show_results as j_show_results
from psi_tpu_torch.viz import show_results

torch.set_num_threads(1)
EQUAL_SHARE = 0.999


def test_show_generated_results_on_testop_pickles_matches_psi_tpu(tmp_path):
    """The port's TestOP writes 3 pickles; both packages render them into
    the same scene from assets that carry the same weights."""
    from psi_tpu.data.synthetic import make_synthetic_assets as j_make_synthetic_assets
    from psi_tpu_torch.data.synthetic import SyntheticBatchGenerator
    from psi_tpu_torch.gen.sample import TestOP
    from psi_tpu_torch.models.cvae_s1 import HumanCVAES1
    from psi_tpu_torch.utils.init import seeded_init_
    from test_torch_train_objective import port_assets

    ja, reg = j_make_synthetic_assets(num_verts=120, num_joints=12, num_scenes=2, sdf_dim=16, scene_points=300,
                                      n_contact=32)
    ta = port_assets(ja)
    b = SyntheticBatchGenerator(num_scenes=2, batches_per_epoch=1, seed=0, image_size=32).next_batch(1)
    b = {k: b[k] for k in ("xs", "cam_int", "max_d")}
    b["cam_ext"] = np.eye(4, dtype=np.float32)[None]
    b["cam_ext"][0, 2, 3] = 3.0
    model = seeded_init_(HumanCVAES1(latentD=32, image_size=32), 0).eval()
    assert TestOP(model, n_samples=3, seed=0, device="cpu").test(b, str(tmp_path), "scene") == 3
    scene = reg.verts_stack[0, : reg.n_verts[0]]
    labels = np.arange(len(scene)) % 40
    cam_int = np.array([[150, 0, 80], [0, 150, 60], [0, 0, 1]], np.float32)
    view = np.eye(4, dtype=np.float32)
    view[2, 3] = 4.0
    kw = dict(image_hw=(120, 160), view_cam_ext=view)
    outs = show_results.show_generated_results(ta, str(tmp_path / "scene"), scene, labels, cam_int,
                                               str(tmp_path / "t"), **kw)
    jouts = j_show_results.show_generated_results(ja, str(tmp_path / "scene"), scene, labels, cam_int,
                                                  str(tmp_path / "j"), **kw)
    assert [os.path.basename(p) for p in outs] == [os.path.basename(p) for p in jouts] == \
        ["body_000.png", "body_001.png", "body_002.png", "all_bodies.png"]
    from PIL import Image

    for t, j in zip(outs, jouts):
        ti, ji = np.asarray(Image.open(t)), np.asarray(Image.open(j))
        assert ti.shape == (120, 160, 3) and (ti < 250).any(), t
        assert (ti == ji).all(axis=-1).mean() >= EQUAL_SHARE, t
    with open(os.path.join(tmp_path, "scene", sorted(os.listdir(tmp_path / "scene"))[0]), "rb") as f:
        assert "cam_ext" in pickle.load(f)


def test_vis_results_writes_its_grid(tmp_path):
    from PIL import Image

    from psi_tpu_torch.body.smplx_model import synthetic_smplx
    from psi_tpu_torch.data.amass import make_synthetic_amass
    from psi_tpu_torch.train.vposer_trainer import VPoserTrainConfig, VPoserTrainer

    make_synthetic_amass(str(tmp_path / "data"), n_train=32, n_val=16)
    cfg = VPoserTrainConfig(num_neurons=32, batch_size=8, num_epochs=1, num_joints=21)
    tr = VPoserTrainer(str(tmp_path / "w"), cfg, str(tmp_path / "data"),
                       synthetic_smplx(num_verts=60, num_joints=22, seed=0), device="cpu")
    poses = np.random.default_rng(0).normal(0, 0.3, (4, 63)).astype(np.float32)
    out = tr.vis_results(poses, str(tmp_path / "vis.png"), n_show=2)
    img = np.asarray(Image.open(out))
    assert img.shape == (3 * 256, 2 * 256, 3) and (img < 250).any()
