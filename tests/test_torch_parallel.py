"""psi_tpu_torch.parallel in one process: the job launcher (as
tests/test_misc.py:15-35 holds psi_tpu's), the sweep's jobs, and the mesh
helpers with no process group. Nothing here starts a group."""

import argparse
import sys

import numpy as np
import pytest
import torch

from psi_tpu.parallel import launcher as jlauncher
from psi_tpu.parallel.mesh import pad_to_multiple as j_pad_to_multiple
from psi_tpu_torch.parallel import distributed, launcher
from psi_tpu_torch.parallel.mesh import Mesh, make_mesh, pad_to_multiple, shard_batch
from psi_tpu_torch.scripts import launch_sweep


def test_launcher_success_and_retry(tmp_path):
    marker = tmp_path / "attempts.txt"
    script = tmp_path / "flaky.py"  # fails twice, then succeeds
    script.write_text(
        "import sys, os\n"
        f"p = {str(marker)!r}\n"
        "n = int(open(p).read()) if os.path.exists(p) else 0\n"
        "open(p, 'w').write(str(n + 1))\n"
        "sys.exit(0 if n >= 2 else 1)\n"
    )
    jobs = [
        launcher.JobSpec("ok", [sys.executable, "-c", "print('hi')"], max_retries=3),
        launcher.JobSpec("flaky", [sys.executable, str(script)], max_retries=5),
    ]
    by_name = {r.name: r for r in launcher.run_jobs(jobs, max_parallel=2, log_fn=lambda *_: None)}
    assert by_name["ok"].returncode == 0 and by_name["ok"].attempts == 1
    assert by_name["flaky"].returncode == 0 and by_name["flaky"].attempts == 3


def test_launcher_gives_up_after_its_retries_and_kills_at_its_timeout():
    jobs = [launcher.JobSpec("bad", [sys.executable, "-c", "import sys; sys.exit(3)"], max_retries=2),
            launcher.JobSpec("slow", [sys.executable, "-c", "import time; time.sleep(30)"], max_retries=1,
                             timeout_s=0.5)]
    by_name = {r.name: r for r in launcher.run_jobs(jobs, max_parallel=2, log_fn=lambda *_: None)}
    assert (by_name["bad"].returncode, by_name["bad"].attempts) == (3, 2)
    assert by_name["slow"].returncode == -9 and by_name["slow"].wall_s < 10


def test_scene_sweep_jobs_name_the_ports_entry_points():
    jobs = launcher.scene_sweep_jobs("psi_tpu_torch.cli.fitting", ["MPH16", "N3OpenArea"], ["gen", "fit"],
                                     python="py")
    ref = jlauncher.scene_sweep_jobs("psi_tpu_torch.cli.fitting", ["MPH16", "N3OpenArea"], ["gen", "fit"],
                                     python="py")
    assert [(j.name, list(j.argv)) for j in jobs] == [(j.name, list(j.argv)) for j in ref]
    assert jobs[0].argv == ["py", "-m", "psi_tpu_torch.cli.fitting", "gen", "fit", "--scene", "MPH16"]
    assert (jobs[0].max_retries, jobs[0].timeout_s) == (500, 12 * 3600)


@pytest.mark.parametrize("what, modules", [("train", ["psi_tpu_torch.cli.train"] * 2),
                                           ("fitting", ["psi_tpu_torch.cli.fitting"])])
def test_launch_sweep_jobs_run_the_ports_entry_points(what, modules):
    args = argparse.Namespace(what=what, variants=["s1", "s2"], gen="g", fit="f", max_retries=7,
                              extra=["--synthetic"])
    jobs = launch_sweep.build_jobs(args)
    assert [j.argv[2] for j in jobs] == modules
    assert all(j.max_retries == 7 and j.argv[-1] == "--synthetic" for j in jobs)


def test_single_process_helpers():
    assert distributed.ensure_distributed() is False  # no coordinator: nothing done
    assert not torch.distributed.is_initialized()
    assert distributed.is_primary() is True


def test_pad_to_multiple_is_psi_tpus():
    for n in range(0, 20):
        for k in (1, 2, 3, 8):
            assert pad_to_multiple(n, k) == j_pad_to_multiple(n, k) == -(-n // k) * k


def test_make_mesh_raises_without_a_group():
    with pytest.raises(RuntimeError, match="initialised process group"):
        make_mesh()
    with pytest.raises(RuntimeError, match="initialised process group"):
        distributed.global_mesh()


def test_shard_batch_keeps_this_ranks_rows():
    batch = {"xh": np.arange(12).reshape(6, 2), "scene_idx": torch.arange(6)}
    for rank, rows in ((0, [0, 1, 2]), (1, [3, 4, 5])):
        mesh = Mesh(rank=rank, size=2, device=torch.device("cpu"), group=None, backend="gloo")
        got = shard_batch(batch, mesh)
        np.testing.assert_array_equal(got["xh"], batch["xh"][rows])
        assert got["scene_idx"].tolist() == rows
    with pytest.raises(ValueError, match="divide evenly"):
        shard_batch({"xh": np.zeros((5, 2))}, Mesh(rank=0, size=2, device=torch.device("cpu"), group=None,
                                                     backend="gloo"))


def test_ensure_distributed_needs_the_size_and_rank(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.delenv("RANK", raising=False)
    with pytest.raises(ValueError, match="size and this rank"):
        distributed.ensure_distributed(coordinator_address="localhost:1", device="cpu")
    assert not torch.distributed.is_initialized()
