"""Job-level sweep launcher: fan (model variant) or (dataset) work items over
processes with retries — the HTCondor-submission equivalent
(cluster_mpi/htcondor_submission.sub semantics) on ``parallel/launcher.py``.

The port's counterpart of ``scripts/launch_sweep.py``: each job runs one of
``psi_tpu_torch.cli``'s entry points, on the first card unless ``--extra``
passes ``--device``.

    python -m psi_tpu_torch.scripts.launch_sweep --what fitting --gen results --fit fitted
    python -m psi_tpu_torch.scripts.launch_sweep --what train --variants s1 s2
"""

from __future__ import annotations

import argparse
import sys


def build_jobs(args):
    from psi_tpu_torch.parallel.launcher import JobSpec

    if args.what == "train":
        return [JobSpec(name=f"train_{v}",
                        argv=[sys.executable, "-m", "psi_tpu_torch.cli.train", "--model_type", v,
                              "--save_dir", f"checkpoints_{v}", *args.extra],
                        max_retries=args.max_retries)
                for v in args.variants]
    return [JobSpec(name=f"fitting_{ds}",
                    argv=[sys.executable, "-m", "psi_tpu_torch.cli.fitting", args.gen, args.fit,
                          "--dataset", ds, *args.extra],
                    max_retries=args.max_retries)
            for ds in ["proxe"]]


def main(argv=None):
    ap = argparse.ArgumentParser(description="Fan training or fitting jobs over processes with retries")
    ap.add_argument("--what", choices=["train", "fitting"], default="fitting")
    ap.add_argument("--variants", nargs="*", default=["s1"])
    ap.add_argument("--gen", type=str, default="results")
    ap.add_argument("--fit", type=str, default="fitted")
    ap.add_argument("--max_parallel", type=int, default=1)
    ap.add_argument("--max_retries", type=int, default=500)  # htcondor_submission.sub:21
    ap.add_argument("--extra", nargs="*", default=["--synthetic"])
    args = ap.parse_args(argv)

    from psi_tpu_torch.parallel.launcher import run_jobs

    results = run_jobs(build_jobs(args), max_parallel=args.max_parallel)
    failed = [r for r in results if r.returncode != 0]
    print(f"[sweep] {len(results) - len(failed)}/{len(results)} jobs succeeded")
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
