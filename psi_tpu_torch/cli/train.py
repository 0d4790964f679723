"""Training CLI — reference flag surface (train_s1.py:345-366,
frontend_sh_scripts/train_js.sh) for both stages.

Port of ``psi_tpu.cli.train``. Trains on the first NVIDIA card unless
--device names another device. ``--num_devices`` keeps psi_tpu's flag:
None or 1 trains on the one device with no process group; N > 1 starts N
worker processes joined in one group, rank r on card r over NCCL (an error
when fewer than N cards are present), or all on the CPU over gloo with
``--device cpu``. Each rank reads the same batches and trains on its rows
of each (``TrainOP(mesh=)``); rank 0 writes the checkpoints and
metrics.jsonl. A rank that fails stops the others and the run's exit code.

  python -m psi_tpu_torch.cli.train --model_type s1 --save_dir ckpts \
      --batch_size 32 --num_epoch 30 --lr_h 0.0003 \
      --weight_loss_vposer 0.001 --weight_loss_kl 0.1 \
      --weight_loss_contact 0.01 --weight_loss_collision 0.1 \
      [--proxe_path ... | --synthetic]
"""

from __future__ import annotations

import argparse
import glob
import multiprocessing
import os
import shutil
import tempfile
import time


def build_parser():
    p = argparse.ArgumentParser(description="Train the PSI scene-conditioned CVAE (PyTorch, NVIDIA card)")
    p.add_argument("--model_type", type=str, default="s1", choices=["s1", "s2"])
    p.add_argument("--save_dir", type=str, default=os.getcwd())
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--lr_h", type=float, default=3e-4)
    p.add_argument("--num_epoch", type=int, default=30)
    p.add_argument("--weight_loss_vposer", type=float, default=1e-3)
    p.add_argument("--weight_loss_kl", type=float, default=1e-1)
    p.add_argument("--weight_loss_contact", type=float, default=1e-1)
    p.add_argument("--weight_loss_collision", type=float, default=1e-1)
    p.add_argument("--use_all", type=int, default=0, help="use train+test scenes")
    p.add_argument("--only_vircam", type=int, default=0, help="only virtualcams samples")
    p.add_argument("--latentD", type=int, default=256)
    p.add_argument("--grad_clip_norm", type=float, default=None)
    p.add_argument("--num_devices", type=int, default=None,
                   help="data-parallel size: None or 1 trains in this process on one device; N > 1 "
                   "starts N ranks, one a card (NCCL), or N CPU ranks (gloo) with --device cpu")
    p.add_argument("--synthetic_batches", type=int, default=4, help="batches/epoch in --synthetic mode")
    p.add_argument(
        "--prune_scene_points", type=int, default=0,
        help="contact-NN candidate pruning for the training chamfer term "
        "(0 = reference-exact full-cloud NN, the default; 2048 = the "
        "fit's Morton-tile pruning)")
    from psi_tpu_torch.cli.common import add_asset_args

    add_asset_args(p)
    return p


def find_hdf5(proxe_path: str, prefix: str):
    """The newest-named ``{prefix}*.hdf5`` under ``proxe_path`` as a list of
    one, or []: both naming generations are accepted (virtualcams.hdf5 /
    virtualcams_v2.hdf5, train_s1.py:386-389)."""
    hits = sorted(glob.glob(os.path.join(proxe_path, f"{prefix}*.hdf5")))
    return hits[-1:] if hits else []


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.num_devices is not None and args.num_devices > 1:
        spawn_ranks(args)
        return
    from psi_tpu_torch.cli.common import resolve_device

    train(args, resolve_device(args.device))


def spawn_ranks(args) -> None:
    """Train on ``args.num_devices`` ranks, one process each, joined through a
    file store in a fresh temporary directory. Raises SystemExit when a rank
    exits non-zero (the others are stopped) or, before starting any, when
    fewer cards are present than ranks asked for."""
    import torch

    n = args.num_devices
    if args.device is None or torch.device(args.device).type == "cuda":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n:
            raise SystemExit(f"--num_devices {n} asks for {n} NVIDIA cards, {have} present")
    store_dir = tempfile.mkdtemp(prefix="psi_train_ranks_")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(args, r, n, f"file://{store_dir}/store"), name=f"rank{r}")
             for r in range(n)]
    try:
        for p in procs:
            p.start()
        while any(p.exitcode is None for p in procs):
            if any(p.exitcode not in (None, 0) for p in procs):
                break
            time.sleep(0.2)
        failed = [(p.name, p.exitcode) for p in procs if p.exitcode not in (None, 0)]
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
            p.join()
        shutil.rmtree(store_dir, ignore_errors=True)
    if failed:
        raise SystemExit(f"training ranks failed: {failed}")


def _rank_main(args, rank: int, world: int, init_method: str) -> None:
    """One rank of ``spawn_ranks``: join the group, train on this rank's rows."""
    import torch
    import torch.distributed as dist

    from psi_tpu_torch.parallel.distributed import ensure_distributed
    from psi_tpu_torch.parallel.mesh import make_mesh

    device = torch.device("cpu") if args.device is not None and torch.device(args.device).type == "cpu" \
        else torch.device("cuda", rank)
    ensure_distributed(init_method=init_method, num_processes=world, process_id=rank, device=device)
    try:
        train(args, device, make_mesh(device=device))
    finally:
        dist.destroy_process_group()


def train(args, device, mesh=None) -> None:
    """The training run ``args`` describe, on ``device`` (over ``mesh``)."""
    from psi_tpu_torch.cli.common import build_assets
    from psi_tpu_torch.train.loop import TrainOP
    from psi_tpu_torch.utils.config import LossConfig, TrainConfig

    cfg = TrainConfig(
        model_type=args.model_type,
        batch_size=args.batch_size,
        epoch=args.num_epoch,
        init_lr_h=args.lr_h,
        latentD=args.latentD,
        save_dir=args.save_dir,
        grad_clip_norm=args.grad_clip_norm,
    )
    loss_cfg = LossConfig(
        weight_loss_vposer=args.weight_loss_vposer,
        weight_loss_kl=args.weight_loss_kl,
        weight_contact=args.weight_loss_contact,
        weight_collision=args.weight_loss_collision,
        prune_scene_points=args.prune_scene_points,
    )

    assets, registry = build_assets(args, device=device)

    if args.synthetic or args.proxe_path is None:
        from psi_tpu_torch.data.synthetic import SyntheticBatchGenerator

        batch_gen = SyntheticBatchGenerator(
            num_scenes=registry.num_scenes, batches_per_epoch=args.synthetic_batches
        )
    else:
        from psi_tpu_torch.data.hdf5 import BatchGeneratorWithSceneMesh

        train_files = find_hdf5(args.proxe_path, "virtualcams")
        if not args.only_vircam:
            train_files += find_hdf5(args.proxe_path, "realcams")
        batch_gen = BatchGeneratorWithSceneMesh(
            train_files, mode="all" if args.use_all else "train", registry=registry
        )

    op = TrainOP(cfg, loss_cfg, assets, device=device, mesh=mesh)
    op.train(batch_gen)


if __name__ == "__main__":
    main()
