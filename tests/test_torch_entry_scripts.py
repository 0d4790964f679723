"""The last entry points: HumanCVAES1.sample, the demo, the VPoser sampling
example and the sampling and training benches, and the package's lazy
top-level names, held to psi_tpu's.

``HumanCVAES1.sample`` takes psi_tpu's weights (convert_jax) and, through
the one draw it makes (``models.cvae_s1.prior_draw``), the normals
``jax.random.normal`` gives psi_tpu's ``sample(x_s, key)``; held to 1e-5.
The demo runs on the CPU with ``make_synthetic_assets`` patched to narrow
widths, as tests/test_torch_cli.py patches ``build_assets``. The pose
example's decoded poses are held to psi_tpu's ``vposer_decode`` on the same
latents (psi_tpu's VPoser weights carried over through a checkpoint file)
within 1e-5.
"""

import contextlib
import io
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import psi_tpu
import psi_tpu_torch
from psi_tpu.body.vposer import synthetic_vposer_params
from psi_tpu.body.vposer import vposer_decode as j_vposer_decode
from psi_tpu_torch.models import cvae_s1
from psi_tpu_torch.scripts import demo, sample_body_pose
from psi_tpu_torch.utils.convert_jax import vposer_from_jax
from test_torch_train_objective import make_world

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5
LAZY_NAMES = ["HumanCVAES1", "HumanCVAES2", "SMPLXModel", "load_smplx_npz", "smplx_forward", "VPoser",
              "SceneAssets", "TrainOP", "FittingOP", "fit_bodies", "TestOP", "generate_bodies", "GenerationEngine",
              "chamfer_distance", "sdf_trilinear"]


@pytest.fixture(scope="module")
def world():
    return make_world(seed=3)


def test_sample_draws_one_latent_a_row_as_psi_tpu_does(world, monkeypatch):
    jm, v, build = world["models"]["s1"]
    xs = world["batch"]["xs"][:3]
    key = jax.random.PRNGKey(17)
    want = np.asarray(jm.apply(v, jnp.asarray(xs), key, method=jm.sample))
    model = build().eval()
    drawn = []

    def jax_draw(n, d, like, generator=None, eps=None):
        assert eps is None and like.shape[0] == n
        drawn.append((n, d))
        return torch.from_numpy(np.array(jax.random.normal(key, (n, d), jnp.float32)))

    monkeypatch.setattr(cvae_s1, "prior_draw", jax_draw)
    with torch.no_grad():
        got = model.sample(torch.from_numpy(xs))
    assert drawn == [(3, model.eps_d)] and got.shape == (3, 75)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


def test_sample_is_sample_with_eps_of_the_generators_normals(world):
    _, _, build = world["models"]["s1"]
    model = build().eval()
    xs = torch.from_numpy(world["batch"]["xs"][:2])
    with torch.no_grad():
        got = model.sample(xs, generator=torch.Generator().manual_seed(5))
        eps = torch.randn((2, model.eps_d), generator=torch.Generator().manual_seed(5))
        np.testing.assert_array_equal(got.numpy(), model.sample_with_eps(xs, eps).numpy())


def _narrow_assets(real):
    def make(**kw):
        kw.update(num_verts=300, n_contact=64, sdf_dim=16, scene_points=400)
        return real(**kw)

    return make


def test_demo_runs_on_the_cpu_and_writes_its_png(tmp_path, monkeypatch):
    from PIL import Image

    monkeypatch.setattr(demo, "make_synthetic_assets", _narrow_assets(demo.make_synthetic_assets))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = demo.main(["--out", str(tmp_path), "--n_samples", "2", "--device", "cpu"])
    text = buf.getvalue()
    assert re.findall(r"^\[(\d)/5\]", text, re.M) == ["1", "2", "3", "4", "5"]
    assert "sampled 2 bodies" in text and text.rstrip().endswith("done.")
    m = re.search(r"non-collision=([\d.]+) contact=([\d.]+) diversity entropy=([\d.]+)", text)
    assert m and all(np.isfinite(float(g)) for g in m.groups())
    loss0, loss1 = out["loss"]
    assert np.isfinite(loss0) and np.isfinite(loss1) and out["x_fit"].shape == (2, 72)
    img = np.asarray(Image.open(tmp_path / "demo_bodies.png"))
    assert img.shape == (480, 640, 3) and img.min() < 255  # something was drawn on the white background


def test_sample_body_pose_decodes_psi_tpus_poses(tmp_path):
    """psi_tpu's VPoser weights through a state-dict file and --vposer_ckpt:
    the script's poses equal psi_tpu's vposer_decode of the script's latents."""
    variables = jax.device_get(synthetic_vposer_params(3))
    ckpt = tmp_path / "vposer.pt"
    torch.save(vposer_from_jax(variables).state_dict(), ckpt)
    out_png = tmp_path / "poses.png"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = sample_body_pose.main(["--n", "3", "--out", str(out_png), "--vposer_ckpt", str(ckpt),
                                     "--device", "cpu"])
    want = np.asarray(j_vposer_decode(variables, jnp.asarray(out["z"].numpy())))
    assert out["z"].shape == (3, 32) and out["pose_aa"].shape == (3, 63)
    np.testing.assert_allclose(out["pose_aa"].numpy(), want, atol=TOL, rtol=0)
    # the same generator seed draws the same latents every run
    z = torch.randn((3, 32), generator=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(out["z"].numpy(), z.numpy())
    assert out["verts"].shape == (3, 600, 3) and out_png.exists()
    assert out["frames"].shape == (1, 3, 1, 200, 200, 3) and out["frames"].min() < 255
    assert "sampled 3 poses" in buf.getvalue() and f"wrote {out_png}" in buf.getvalue()


@pytest.mark.parametrize("script", ["bench_sample", "bench_train"])
def test_benches_need_a_card(script):
    r = subprocess.run([sys.executable, "-m", f"psi_tpu_torch.scripts.{script}"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode != 0
    assert "needs an NVIDIA card" in r.stdout + r.stderr


def test_demo_and_pose_example_need_a_card_unless_told_otherwise(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main, argv in ((demo.main, ["--out", str(tmp_path / "d")]),
                       (sample_body_pose.main, ["--out", str(tmp_path / "p.png")])):
        with pytest.raises(RuntimeError, match="NVIDIA card"):
            main(argv)
    assert not any(tmp_path.iterdir())


def test_lazy_top_level_names_resolve_to_their_modules():
    """The 15 names of psi_tpu's top-level API, each the object its port
    module defines; an unknown name is an AttributeError in both packages."""
    import importlib

    for name in LAZY_NAMES:
        assert getattr(psi_tpu_torch, name) is getattr(importlib.import_module(psi_tpu_torch._LAZY[name]), name)
        assert getattr(psi_tpu, name) is not None
    assert sorted(psi_tpu_torch._LAZY) == sorted(LAZY_NAMES)
    for pkg in (psi_tpu_torch, psi_tpu):
        with pytest.raises(AttributeError):
            pkg.no_such_name  # noqa: B018
    code = ("import sys, psi_tpu_torch\n"
            "loaded = sorted(m for m in sys.modules if m.startswith('psi_tpu_torch.'))\n"
            "assert not loaded, loaded\n"
            "assert psi_tpu_torch.TrainOP.__module__ == 'psi_tpu_torch.train.loop'\n"
            "assert psi_tpu_torch.sdf_trilinear.__module__ == 'psi_tpu_torch.ops.sdf'\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'optax', 'psi_tpu'))\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
