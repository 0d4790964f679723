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
        "import psi_tpu_torch.scripts.profile_train\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'optax', 'psi_tpu'))\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    r = _run(code, ROOT)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize("script", ["profile_vmem_gather", "profile_gather", "profile_sdf", "profile_fit",
                                    "tune_skin_fwd", "tune_gather_probes", "tune_chamfer_nn", "profile_train"])
def test_profiling_entry_points_fail_without_a_card(script):
    """A measurement never falls back to the CPU."""
    r = _run(["-m", f"psi_tpu_torch.scripts.{script}"], ROOT)
    assert r.returncode != 0
    assert "needs an NVIDIA card" in r.stdout + r.stderr


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
