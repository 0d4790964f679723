"""Evaluation CLI: diversity + collision/contact over generated pickles.

Port of ``psi_tpu.cli.eval``. Reference surface:
utils/utils_eval_diversity.py (k-means k=20 entropy over all generated
vectors) and utils/utils_eval_collision_habitat.py (non-collision / contact
scores over <=8000 bodies per room). The scorers run on the first NVIDIA
card unless --device names another device.

  python -m psi_tpu_torch.cli.eval --results_dir results --mode diversity
  python -m psi_tpu_torch.cli.eval --results_dir results --mode collision \
      [--proxe_path ... | --synthetic]
"""

from __future__ import annotations

import argparse
import glob
import os
import pickle

import numpy as np


def _load_pickles(results_dir: str, max_files: int = 8000):
    recs = []
    for p in sorted(glob.glob(os.path.join(results_dir, "**", "body_gen_*.pkl"), recursive=True))[:max_files]:
        with open(p, "rb") as f:
            recs.append((p, pickle.load(f)))
    return recs


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--results_dir", type=str, required=True)
    p.add_argument("--mode", type=str, default="diversity", choices=["diversity", "collision"])
    p.add_argument("--dataset", type=str, default="proxe", choices=["proxe", "habitat"])
    p.add_argument("--k", type=int, default=20)
    p.add_argument("--max_files", type=int, default=8000)
    from psi_tpu_torch.cli.common import add_asset_args

    add_asset_args(p)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    import torch

    from psi_tpu_torch.cli.common import resolve_device
    from psi_tpu_torch.geometry.bodyvec import body_params_parse

    device = resolve_device(args.device)
    recs = _load_pickles(args.results_dir, args.max_files)
    if not recs:
        print("[ERROR] no body_gen_*.pkl under", args.results_dir)
        return

    x72 = torch.cat([body_params_parse(r) for _, r in recs]).to(device)

    if args.mode == "diversity":
        from psi_tpu_torch.eval import diversity_metrics

        entropy, mean_dist = diversity_metrics(x72, k=args.k)
        print(f"[INFO] diversity: cluster_entropy={entropy:.4f}, mean_dist={mean_dist:.4f}")
    else:
        from psi_tpu_torch.cli.common import build_assets
        from psi_tpu_torch.eval import collision_contact_scores

        assets, registry = build_assets(args, device=device)
        cam_ext = np.concatenate(
            [np.asarray(r["cam_ext"], np.float32).reshape(-1, 4, 4)[:1] for _, r in recs]
        )
        if args.dataset == "habitat":
            # habitat world -> camera y/z flip, right-composed as in the
            # reference eval (utils_eval_collision_habitat.py:163-168)
            from psi_tpu_torch.data.matfile import HABITAT_T_MAT

            cam_ext = cam_ext @ HABITAT_T_MAT
        # scene index from the parent directory name when it matches the registry
        scene_idx = np.array(
            [
                registry.index_of(os.path.basename(os.path.dirname(p)))
                if os.path.basename(os.path.dirname(p)) in registry.names
                else 0
                for p, _ in recs
            ],
            np.int32,
        )
        nc, ct = collision_contact_scores(assets, x72, cam_ext, scene_idx)
        print(f"[INFO] non_collision_score={nc:.4f}, contact_score={ct:.4f}")


if __name__ == "__main__":
    main()
