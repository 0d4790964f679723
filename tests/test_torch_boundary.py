"""The port's boundary: psi_tpu_torch never imports JAX or psi_tpu, and
chip_smoke.py has no CPU fallback."""

import pkgutil
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import psi_tpu_torch

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "psi_tpu_torch"
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|flax|optax|psi_tpu)(\.|\s|$)", re.M)


def _run(code_or_args, cwd, timeout=300):
    args = ["-c", code_or_args] if isinstance(code_or_args, str) else code_or_args
    return subprocess.run([sys.executable, *args], cwd=cwd, capture_output=True, text=True, timeout=timeout)


def test_port_modules_load_without_jax():
    """Importing the slice's entry points, and then every module of the
    package, leaves jax, flax, optax and psi_tpu out of sys.modules."""
    modules = [m.name for m in pkgutil.walk_packages([str(PKG)], prefix="psi_tpu_torch.")]
    code = (
        "import sys, importlib\n"
        "import psi_tpu_torch.fit.fitting, psi_tpu_torch.gen.sample, psi_tpu_torch.train.loop\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'optax', 'psi_tpu'))\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    r = _run(code, ROOT)
    assert r.returncode == 0, r.stdout + r.stderr
    assert len(modules) > 20


def test_scripts_and_eval_load_without_jax():
    """The profiling entry points and the eval scorers, imported alone,
    leave jax, flax, optax and psi_tpu out of sys.modules."""
    code = (
        "import sys\n"
        "import psi_tpu_torch.eval, psi_tpu_torch.scripts.profile_vmem_gather\n"
        "import psi_tpu_torch.scripts.profile_gather, psi_tpu_torch.scripts.profile_sdf\n"
        "import psi_tpu_torch.scripts.profile_fit, psi_tpu_torch.scripts.tune_skin_fwd\n"
        "import psi_tpu_torch.scripts.tune_gather_probes, psi_tpu_torch.scripts.tune_chamfer_nn\n"
        "import psi_tpu_torch.scripts.profile_train, psi_tpu_torch.scripts.profile_fused\n"
        "import psi_tpu_torch.scripts.profile_segments, psi_tpu_torch.scripts.profile_refresh_cadence\n"
        "import psi_tpu_torch.scripts.bench_train_native\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'optax', 'psi_tpu'))\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    r = _run(code, ROOT)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize("script", ["profile_vmem_gather", "profile_gather", "profile_sdf", "profile_fit",
                                    "tune_skin_fwd", "tune_gather_probes", "tune_chamfer_nn", "profile_train",
                                    "soak_serve", "bench_serve_gen", "vposer_scale_run", "profile_fused",
                                    "profile_segments", "profile_refresh_cadence", "bench_train_native"])
def test_profiling_entry_points_fail_without_a_card(script):
    """A measurement never falls back to the CPU."""
    r = _run(["-m", f"psi_tpu_torch.scripts.{script}"], ROOT)
    assert r.returncode != 0
    assert "needs an NVIDIA card" in r.stdout + r.stderr


def test_serving_modules_load_without_jax():
    """The serving package, the CLI modules and the two serving scripts,
    imported alone, leave jax, flax, optax and psi_tpu out of sys.modules."""
    code = (
        "import sys\n"
        "import psi_tpu_torch.serve, psi_tpu_torch.serve.engine, psi_tpu_torch.cli, psi_tpu_torch.cli.common\n"
        "import psi_tpu_torch.cli.serve, psi_tpu_torch.scripts.soak_serve, psi_tpu_torch.scripts.bench_serve_gen\n"
        "import psi_tpu_torch.utils.convert_torch, psi_tpu_torch.data.plyio, psi_tpu_torch.data.hdf5\n"
        "assert psi_tpu_torch.serve.__all__ == ['GenerationEngine', 'ServeResult', 'ServingQueue', 'ServingRouter']\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'optax', 'psi_tpu'))\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    r = _run(code, ROOT)
    assert r.returncode == 0, r.stdout + r.stderr


def test_serve_cli_help_runs_with_jax_blocked():
    """``python -m psi_tpu_torch.cli.serve --help`` with every import of jax,
    flax, optax or psi_tpu turned into an error: exit code 0 and the flags."""
    code = (
        "import runpy, sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'psi_tpu'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "sys.argv = ['psi_tpu_torch.cli.serve', '--help']\n"
        "runpy.run_module('psi_tpu_torch.cli.serve', run_name='__main__')\n"
    )
    r = _run(code, ROOT)
    assert r.returncode == 0, r.stdout + r.stderr
    for flag in ("--model", "--population", "--warmup", "--device", "--synthetic", "--lbs_precision"):
        assert flag in r.stdout, flag


CLI_ENTRY_POINTS = ["train", "train_s1", "train_s2", "test_proxe", "test_proxe_s1", "test_proxe_s2", "test_habitat",
                    "fitting", "fitting_proxe", "fitting_habitat", "eval"]
INGEST_MODULES = ["psi_tpu_torch.ops.resize", "psi_tpu_torch.data.preprocessing", "psi_tpu_torch.data.matfile",
                  "psi_tpu_torch.data.hdf5"]


def test_ingest_and_cli_modules_load_without_jax_h5py_or_scipy():
    """The data ingest and the entry points, imported alone, leave jax,
    flax, optax and psi_tpu out of sys.modules, and h5py and scipy too: the
    functions that read an HDF5 or a .mat file import them."""
    modules = INGEST_MODULES + [f"psi_tpu_torch.cli.{m}" for m in CLI_ENTRY_POINTS]
    code = (
        "import sys, importlib\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'optax', 'psi_tpu', 'h5py', 'scipy'))\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    r = _run(code, ROOT)
    assert r.returncode == 0, r.stdout + r.stderr
    walked = {m.name for m in pkgutil.walk_packages([str(PKG)], prefix="psi_tpu_torch.")}
    assert set(modules) <= walked


def test_cli_entry_points_help_runs_with_jax_blocked():
    """``python -m psi_tpu_torch.cli.<name> --help`` for every entry point,
    with every import of jax, flax, optax or psi_tpu an error: each prints
    its usage with --device."""
    code = (
        "import contextlib, io, runpy, sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'psi_tpu'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        f"for name in {CLI_ENTRY_POINTS!r}:\n"
        "    sys.argv = ['psi_tpu_torch.cli.' + name, 'gen', 'fit', '--help']\n"
        "    buf = io.StringIO()\n"
        "    try:\n"
        "        with contextlib.redirect_stdout(buf):\n"
        "            runpy.run_module('psi_tpu_torch.cli.' + name, run_name='__main__')\n"
        "    except SystemExit as e:\n"
        "        assert e.code == 0, (name, e.code)\n"
        "    assert 'usage:' in buf.getvalue() and '--device' in buf.getvalue(), name\n"
        "    print('OK', name)\n"
    )
    r = _run(code, ROOT)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.split() == [w for n in CLI_ENTRY_POINTS for w in ("OK", n)]


def test_no_jax_or_psi_tpu_import_in_port_sources():
    offenders = [
        f"{p.relative_to(ROOT)}: {m.group(0).strip()}"
        for p in sorted(PKG.rglob("*.py"))
        for m in FORBIDDEN.finditer(p.read_text())
    ]
    assert not offenders, offenders
    assert FORBIDDEN.search("from psi_tpu.ops import x") and not FORBIDDEN.search("from psi_tpu_torch.ops import x")


def test_training_modules_are_in_the_walk_and_chip_smoke_imports_no_jax():
    """The new slice's modules are among those the walk above imports, and
    chip_smoke.py itself names neither JAX nor psi_tpu in an import."""
    modules = {m.name for m in pkgutil.walk_packages([str(PKG)], prefix="psi_tpu_torch.")}
    assert {"psi_tpu_torch.losses.terms", "psi_tpu_torch.models.cvae_s2", "psi_tpu_torch.train.objective",
            "psi_tpu_torch.train.loop", "psi_tpu_torch.train.checkpoint",
            "psi_tpu_torch.scripts.profile_train"} <= modules
    assert not FORBIDDEN.search((ROOT / "chip_smoke.py").read_text())


def test_contact_term_never_falls_back_to_the_twin():
    """The objective's contact term hands its clouds to K3's wrapper, which
    takes the twin only for CPU tensors and refuses what is neither cpu nor
    cuda."""
    from psi_tpu_torch.ops.chamfer import chamfer_one_sided

    with pytest.raises(ValueError):
        chamfer_one_sided(torch.zeros((1, 4, 3), device="meta"), torch.zeros((1, 9, 3), device="meta"))


def test_chip_smoke_fails_without_a_card():
    """On a CPU-only machine chip_smoke exits non-zero and prints no result."""
    r = _run(["chip_smoke.py"], ROOT)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_chip_smoke_fails_outside_the_repository(tmp_path):
    """Alone in a directory, the script finds no package and fails."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _run(["chip_smoke.py"], tmp_path)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_cuda_tensors_never_fall_back_to_twins(monkeypatch):
    """A wrapper given a non-CPU tensor launches its kernel or raises: here
    the kernel library cannot be built, and the error propagates."""
    from psi_tpu_torch.ops import _cuda, chamfer

    def no_library():
        raise RuntimeError("no kernel library here")

    monkeypatch.setattr(_cuda, "library", no_library)
    x = torch.zeros((1, 4, 3), device="meta")
    with pytest.raises(ValueError):  # neither cpu nor cuda: refused outright
        chamfer.nn_argmin(x, x)
    assert psi_tpu_torch.__version__


def test_probe_wrappers_take_twins_only_for_cpu_tensors():
    from psi_tpu_torch.ops import gather_probes as gp

    t = torch.zeros((2, 8, 128), device="meta")
    i = torch.zeros((2, 8, 128), dtype=torch.int32, device="meta")
    for call in (lambda: gp.row_gather(t[0], i[0]), lambda: gp.lane_gather(t[0], i[0]),
                 lambda: gp.chained_gather(t, i), lambda: gp.relayout(t)):
        with pytest.raises(ValueError):  # neither cpu nor cuda: refused outright
            call()


SCALE_OUT_MODULES = ["psi_tpu_torch.parallel", "psi_tpu_torch.parallel.mesh", "psi_tpu_torch.parallel.distributed",
                     "psi_tpu_torch.parallel.launcher", "psi_tpu_torch.data.native_loader",
                     "psi_tpu_torch.scripts.multiprocess_worker", "psi_tpu_torch.scripts.launch_sweep"]


def test_scale_out_modules_are_in_the_walk_and_load_without_jax():
    """The process-group layer, the native loader and the two scale-out
    scripts are among the walked modules, and imported alone they leave jax,
    flax, optax and psi_tpu out of sys.modules (and build nothing)."""
    walked = {m.name for m in pkgutil.walk_packages([str(PKG)], prefix="psi_tpu_torch.")}
    assert set(SCALE_OUT_MODULES) <= walked
    code = (
        "import sys, importlib\n"
        f"for m in {SCALE_OUT_MODULES!r}: importlib.import_module(m)\n"
        "import psi_tpu_torch.data.native_loader as nl\n"
        "assert nl._lib is None\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'optax', 'psi_tpu'))\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    r = _run(code, ROOT)
    assert r.returncode == 0, r.stdout + r.stderr


def test_train_cli_num_devices_help_runs_with_jax_blocked():
    """``python -m psi_tpu_torch.cli.train --num_devices 2 --help`` with every
    import of jax, flax, optax or psi_tpu an error: exit code 0, and the help
    says what --num_devices does."""
    code = (
        "import runpy, sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'psi_tpu'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "sys.argv = ['psi_tpu_torch.cli.train', '--num_devices', '2', '--help']\n"
        "runpy.run_module('psi_tpu_torch.cli.train', run_name='__main__')\n"
    )
    r = _run(code, ROOT)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "--num_devices" in r.stdout and "gloo" in r.stdout and "NCCL" in r.stdout


VPOSER_SLICE_MODULES = ["psi_tpu_torch.utils.tools", "psi_tpu_torch.utils.profiling", "psi_tpu_torch.data.amass",
                        "psi_tpu_torch.train.vposer_trainer", "psi_tpu_torch.body.body_model",
                        "psi_tpu_torch.viz", "psi_tpu_torch.viz.colors", "psi_tpu_torch.viz.render",
                        "psi_tpu_torch.viz.show_results", "psi_tpu_torch.viz.mesh_viewer",
                        "psi_tpu_torch.scripts.vposer_scale_run"]


def test_vposer_slice_modules_are_in_the_walk_and_load_without_jax():
    """The VPoser trainer, the body-model wrappers and the renderer are among
    the walked modules, and imported alone they leave jax, flax, optax and
    psi_tpu out of sys.modules."""
    walked = {m.name for m in pkgutil.walk_packages([str(PKG)], prefix="psi_tpu_torch.")}
    assert set(VPOSER_SLICE_MODULES) <= walked
    code = (
        "import sys, importlib\n"
        f"for m in {VPOSER_SLICE_MODULES!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'optax', 'psi_tpu'))\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    r = _run(code, ROOT)
    assert r.returncode == 0, r.stdout + r.stderr


def test_vposer_slice_entry_points_take_the_first_card_and_raise_without_one(tmp_path, monkeypatch):
    """device=None is cuda:0 when a card is there; without one VPoserTrainer,
    BodyModel, BodyModelWithPoser, MeshViewer and render_color raise rather
    than fall back to the CPU."""
    import numpy as np

    from psi_tpu_torch.body.body_model import BodyModel, BodyModelWithPoser
    from psi_tpu_torch.body.smplx_model import synthetic_smplx
    from psi_tpu_torch.body.vposer import synthetic_vposer
    from psi_tpu_torch.data.amass import make_synthetic_amass
    from psi_tpu_torch.train.vposer_trainer import VPoserTrainConfig, VPoserTrainer
    from psi_tpu_torch.utils.tools import resolve_device
    from psi_tpu_torch.viz.mesh_viewer import MeshViewer
    from psi_tpu_torch.viz.show_results import render_color

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device(None, "x") == torch.device("cuda", 0)
    assert resolve_device("cpu", "x") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    make_synthetic_amass(str(tmp_path / "data"), n_train=8, n_val=8)
    smplx = synthetic_smplx(num_verts=30, num_joints=22)
    calls = {
        "VPoserTrainer": lambda: VPoserTrainer(str(tmp_path / "w"), VPoserTrainConfig(num_neurons=8, batch_size=4),
                                               str(tmp_path / "data"), smplx),
        "BodyModel": lambda: BodyModel(smplx),
        "BodyModelWithPoser": lambda: BodyModelWithPoser(smplx, synthetic_vposer(0)),
        "MeshViewer": lambda: MeshViewer(width=8, height=8),
        "render_color": lambda: render_color(np.zeros((2, 3)), np.zeros((2, 3)), np.eye(3), 4, 4),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="NVIDIA card"):
            call()
    assert not (tmp_path / "w").exists()


SNAPSHOT_SLICE_MODULES = ["psi_tpu_torch.data.labelmap", "psi_tpu_torch.viz.sphere", "psi_tpu_torch.data.snapshots",
                          "psi_tpu_torch.scripts.demo", "psi_tpu_torch.scripts.sample_body_pose",
                          "psi_tpu_torch.scripts.bench_sample", "psi_tpu_torch.scripts.bench_train"]


def test_snapshot_slice_modules_are_in_the_walk_and_load_without_jax_or_h5py():
    """The snapshot production and the last entry points are among the walked
    modules, and imported alone they leave jax, flax, optax, psi_tpu, h5py and
    scipy out of sys.modules: the HDF5 writer and the .mat packer import them
    when they run (the card's machine has no h5py)."""
    walked = {m.name for m in pkgutil.walk_packages([str(PKG)], prefix="psi_tpu_torch.")}
    assert set(SNAPSHOT_SLICE_MODULES) <= walked
    code = (
        "import sys, importlib\n"
        f"for m in {SNAPSHOT_SLICE_MODULES!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'optax', 'psi_tpu', 'h5py', 'scipy'))\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    r = _run(code, ROOT)
    assert r.returncode == 0, r.stdout + r.stderr
