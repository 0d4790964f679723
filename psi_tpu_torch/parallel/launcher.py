"""Job-level parallelism: map work items over processes with retries.

Port of ``psi_tpu.parallel.launcher`` (subprocess and the standard library
only, copied). Equivalent of the reference's HTCondor scale-out
(cluster_mpi/htcondor_submission.sub:14-31: 1 job per (scene x model)
work item, 12 h MaxTime, 500 auto-retries via periodic_hold/release).
Here: a local process launcher with per-item retry and timeout, for
fanning (scene x variant) sweeps over cards; with the idempotent
skip-if-output-exists convention of ``FittingOP.fitting_files`` it gives
the same crash-restart elasticity.
"""

from __future__ import annotations

import dataclasses
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence


@dataclasses.dataclass
class JobSpec:
    """One work item: a command to run (argv list)."""

    name: str
    argv: Sequence[str]
    max_retries: int = 500  # htcondor_submission.sub:21
    timeout_s: float = 12 * 3600  # htcondor_submission.sub:24 (12 h MaxTime)


@dataclasses.dataclass
class JobResult:
    name: str
    returncode: int
    attempts: int
    wall_s: float


def run_jobs(
    jobs: Sequence[JobSpec],
    max_parallel: int = 1,
    log_fn=print,
) -> List[JobResult]:
    """Run jobs with bounded parallelism and per-job retry."""
    results: List[JobResult] = []
    pending = list(jobs)
    running: Dict[str, dict] = {}
    attempts: Dict[str, int] = {j.name: 0 for j in jobs}
    t_start: Dict[str, float] = {}

    while pending or running:
        while pending and len(running) < max_parallel:
            job = pending.pop(0)
            attempts[job.name] += 1
            t_start.setdefault(job.name, time.time())
            log_fn(f"[launcher] start {job.name} (attempt {attempts[job.name]})")
            proc = subprocess.Popen(list(job.argv), stdout=sys.stdout, stderr=sys.stderr)
            running[job.name] = {"proc": proc, "job": job, "t0": time.time()}

        time.sleep(0.2)
        for name in list(running):
            entry = running[name]
            proc, job = entry["proc"], entry["job"]
            rc = proc.poll()
            if rc is None:
                if time.time() - entry["t0"] > job.timeout_s:
                    proc.kill()
                    proc.wait()
                    rc = -9
                else:
                    continue
            del running[name]
            if rc == 0:
                results.append(JobResult(name, 0, attempts[name], time.time() - t_start[name]))
                log_fn(f"[launcher] done {name}")
            elif attempts[name] < job.max_retries:
                pending.append(job)  # retry (periodic_release semantics)
            else:
                results.append(JobResult(name, rc, attempts[name], time.time() - t_start[name]))
                log_fn(f"[launcher] FAILED {name} rc={rc}")
    return results


def scene_sweep_jobs(
    module: str,
    scenes: Sequence[str],
    common_args: Sequence[str],
    python: Optional[str] = None,
) -> List[JobSpec]:
    """One job per scene, calling a psi_tpu_torch.cli module."""
    py = python or sys.executable
    return [
        JobSpec(name=s, argv=[py, "-m", module, *common_args, "--scene", s])
        for s in scenes
    ]
