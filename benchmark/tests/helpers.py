"""Toy sizes of the cells, for the CPU tests: every width cut so that a
run takes seconds; the SMPL-X joint tree and the snapshot side of the
native loader (128) are kept."""

from __future__ import annotations

import copy
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def mixes():
    """Every cell's traffic mix, with the configuration it runs on."""
    return {w["traffic"]: w["config"] for w in bench()["workloads"]}


def config(name: str, image_size: int = 32):
    cfg = json.loads((ROOT / "benchmark" / "configs" / f"{name}.json").read_text())
    cfg.update(latentD=32, latentD_g=32, latentD_l=32, image_size=image_size)
    cfg["body"].update(num_verts=300, n_contact=64)
    cfg["scenes"].update(sdf_dim=16, scene_points=512)
    return cfg


def traffic(name: str, **over):
    tr = json.loads((ROOT / "benchmark" / "traffic" / f"{name}.json").read_text())
    small = {"genfit": dict(population=8, num_iter=12, pool=4, trace_seconds=0.5),
             "train": dict(batch_size=8, samples=64, trace_seconds=0.5)}[tr["generator"]]
    tr.update(small)
    if "fit" in tr:
        tr["fit"] = dict(tr["fit"], prune=128)
    tr.update(over)
    return copy.deepcopy(tr)


def cell_args(cfg_name: str, traffic_name: str, **over):
    """(config, traffic) of a toy cell; the training cell keeps 128-px snapshots."""
    tr = traffic(traffic_name, **over)
    return config(cfg_name, 128 if tr["generator"] == "train" else 32), tr
