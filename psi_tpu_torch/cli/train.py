"""Training CLI — reference flag surface (train_s1.py:345-366,
frontend_sh_scripts/train_js.sh) for both stages.

Port of ``psi_tpu.cli.train``. Trains on the first NVIDIA card unless
--device names another device. ``--num_devices`` keeps psi_tpu's flag:
None or 1 trains on the one device; a larger value is refused until
multi-GPU training is ported (ROADMAP A13).

  python -m psi_tpu_torch.cli.train --model_type s1 --save_dir ckpts \
      --batch_size 32 --num_epoch 30 --lr_h 0.0003 \
      --weight_loss_vposer 0.001 --weight_loss_kl 0.1 \
      --weight_loss_contact 0.01 --weight_loss_collision 0.1 \
      [--proxe_path ... | --synthetic]
"""

from __future__ import annotations

import argparse
import glob
import os


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
                   help="data-parallel size (None or 1 = one device; more needs multi-GPU "
                   "training, not ported yet: ROADMAP A13)")
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
        raise SystemExit(f"--num_devices {args.num_devices}: multi-GPU training is not ported yet "
                         "(ROADMAP A13); pass --num_devices 1 or leave it out")

    from psi_tpu_torch.cli.common import build_assets, resolve_device
    from psi_tpu_torch.train.loop import TrainOP
    from psi_tpu_torch.utils.config import LossConfig, TrainConfig

    device = resolve_device(args.device)
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

    op = TrainOP(cfg, loss_cfg, assets, device=device)
    op.train(batch_gen)


if __name__ == "__main__":
    main()
