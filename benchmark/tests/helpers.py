"""Toy sizes of the cells, for the CPU tests: each traffic generator
(``benchmark/generators/<name>.py``) gives its own, as ``TOY`` (the traffic's
overrides, a nested group merged key by key) and ``toy_config(cfg)`` (the
configuration cut to toy widths), so that a run takes seconds."""

from __future__ import annotations

import copy
import importlib
import json
from pathlib import Path
from typing import Dict

ROOT = Path(__file__).resolve().parents[2]


def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def mixes():
    """Every cell's traffic mix, with the configuration it runs on."""
    return {w["traffic"]: w["config"] for w in bench()["workloads"]}


def generator(name: str):
    """The traffic generator's module."""
    return importlib.import_module(f"benchmark.generators.{name}")


def toy_config(cfg: Dict, generator_name: str) -> Dict:
    """A configuration cut to the toy widths of a generator."""
    return generator(generator_name).toy_config(copy.deepcopy(cfg))


def toy_traffic(tr: Dict, **over) -> Dict:
    """A traffic mix at its generator's toy sizes, then ``over``."""
    tr = copy.deepcopy(tr)
    for k, v in generator(tr["generator"]).TOY.items():
        tr[k] = dict(tr.get(k, {}), **v) if isinstance(v, dict) else v
    tr.update(copy.deepcopy(over))
    return tr


def config(name: str, generator_name: str) -> Dict:
    """The configuration file ``name``, cut for the generator's toy run."""
    return toy_config(json.loads((ROOT / "benchmark" / "configs" / f"{name}.json").read_text()), generator_name)


def traffic(name: str, **over) -> Dict:
    """The traffic file ``name`` at its generator's toy sizes."""
    return toy_traffic(json.loads((ROOT / "benchmark" / "traffic" / f"{name}.json").read_text()), **over)


def cell_args(cfg_name: str, traffic_name: str, **over):
    """(config, traffic) of a toy cell."""
    tr = traffic(traffic_name, **over)
    return config(cfg_name, tr["generator"]), tr
