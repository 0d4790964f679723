"""BENCHMARK.json against the contract the harness is built to: names,
units, files found by name, cells, metrics and the check's budget."""

import contextlib
import importlib
import json
import re

import pytest

from benchmark import faults
from benchmark.run import BENCH_DIR, cell_metrics
from benchmark.tests.helpers import ROOT, bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_top_level_keys():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark"] and b["command"][:3] == ["python3", "-m", "benchmark.run"]
    assert 1 <= b["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_and_units():
    b = bench()
    names = [c["name"] for c in b["configs"]] + [w["name"] for w in b["workloads"]]
    names += [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in b["workloads"]] + [k for c in b["configs"] for k in c["reduced"]]:
        assert NAME.match(n), n
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher"), m
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace"), m
    for w in b["workloads"]:
        assert len(w["why"]) <= 200 and "\n" not in w["why"] and w["chips"] in (1, 4)


def test_everything_is_found_by_name():
    b = bench()
    confs = {c["name"]: c for c in b["configs"]}
    for w in b["workloads"]:
        json.loads((ROOT / confs[w["config"]]["file"]).read_text())
        tr = json.loads((BENCH_DIR / "traffic" / f"{w['traffic']}.json").read_text())
        assert hasattr(importlib.import_module(f"benchmark.generators.{tr['generator']}"), "Generator")
        assert tr["limits"]
    for m in b["per_layer"]:
        assert (BENCH_DIR / "metrics" / f"{m['name']}.py").is_file(), m["name"]
    used = {w["config"] for w in b["workloads"]}
    assert used == set(confs)


GENERATORS = sorted({json.loads(p.read_text())["generator"] for p in (BENCH_DIR / "traffic").glob("*.json")})


@pytest.mark.parametrize("name", GENERATORS)
def test_every_generator_owns_its_toy_run_and_faults(name):
    """Every generator that a traffic file names, a cell's or not, gives
    what the tests and ``faults.plant`` read from it: ``Generator``, its toy
    traffic (``TOY``) and configuration (``toy_config``), and a planter of
    each fault that raises on a name it does not know."""
    mod = importlib.import_module(f"benchmark.generators.{name}")
    assert hasattr(mod, "Generator") and isinstance(mod.TOY, dict) and callable(mod.toy_config)
    for fault in faults.NAMES:
        planted = faults.plant(fault, name)
        assert isinstance(planted, contextlib.AbstractContextManager), (name, fault)
    with pytest.raises(ValueError):
        mod.plant("no_such_fault")


def test_plant_raises_for_an_unknown_generator_or_fault():
    with pytest.raises(ValueError):
        faults.plant("half_batch", "no_such_generator")
    with pytest.raises(ValueError):
        faults.plant("no_such_fault", GENERATORS[0])


def test_each_cell_reports_what_its_layers_move():
    b = bench()
    for w in b["workloads"]:
        e2e = {m["name"] for m in cell_metrics(b, w["name"], False)}
        layer = cell_metrics(b, w["name"], True)
        assert "setup_s" in e2e and len(e2e) >= 2 and layer, w["name"]
        for m in layer:
            assert m["moves"] in e2e, (w["name"], m["name"])
    layers = {}
    for m in b["per_layer"]:
        layers.setdefault(m["layer"], m["layer"])


def test_check_budget_fits():
    b = bench()
    secs = 2 + 14 * 24
    assert secs * (b["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    four = sum(w["chips"] == 4 for w in b["workloads"])
    assert four <= max(1, len(b["workloads"]) // 4)
