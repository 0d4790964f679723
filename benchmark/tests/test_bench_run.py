"""The command as the checker runs it: without a card it prints no result
and exits non-zero, also from a directory that holds only the benchmark;
and a run that loads JAX after its window, in the check or a reader, prints
no result either."""

import importlib
import shutil
import subprocess
import sys
import time
import types

import pytest
import torch

from benchmark import run as brun
from benchmark.tests.helpers import ROOT, bench, cell_args

ARGS = ["-m", "benchmark.run", "--workload", "s2_fit_exact", "--seed", "3000000123", "--seconds", "1", "--trace", "0"]


def run_in(cwd):
    return subprocess.run([sys.executable, *ARGS], cwd=cwd, capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    r = run_in(ROOT)
    assert r.returncode != 0 and r.stdout.strip() == "", r.stdout
    assert "NVIDIA" in r.stderr


def test_benchmark_alone_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    r = run_in(tmp_path)
    assert r.returncode != 0 and r.stdout.strip() == "", r.stdout


def test_jax_loaded_by_the_check_withholds_the_result(monkeypatch, capsys):
    cell = bench()["workloads"][0]
    cfg, tr = cell_args(cell["config"], cell["traffic"])
    gen = importlib.import_module(f"benchmark.generators.{tr['generator']}").Generator
    check = gen.check

    def check_loading_jax(self, *a, **k):
        monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
        return check(self, *a, **k)

    monkeypatch.setattr(gen, "check", check_loading_jax)
    b = {"end_to_end": [{"name": "setup_s", "unit": "s"}], "per_layer": []}
    out = brun.execute(b, {"name": "toy", "chips": 1}, cfg, tr, 2**33 + 11, 0.5, False, torch.device("cpu"),
                       time.time())
    capsys.readouterr()
    assert brun.emit(out) == 4
    got = capsys.readouterr()
    assert got.out == "" and "jax" in got.err
    monkeypatch.delitem(sys.modules, "jax")
    assert brun.emit(out) == 0 and '"correct"' in capsys.readouterr().out
