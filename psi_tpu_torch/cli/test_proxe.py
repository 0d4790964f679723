"""Generation CLI for PROX-E test scenes (reference: test_proxe_s1.py /
test_proxe_s2.py __main__): loads the newest checkpoint, samples
n_samples bodies per test scene snapshot, writes body_gen_*.pkl.

Port of ``psi_tpu.cli.test_proxe``. Without --ckpt_dir the model's weights
are drawn from a seeded ``torch.Generator`` (``utils/init.py``). Runs on
the first NVIDIA card unless --device names another device.

  python -m psi_tpu_torch.cli.test_proxe --model_type s1 --ckpt_dir ... \
      --output_dir results --n_samples 300 [--proxe_path ... | --synthetic]
"""

from __future__ import annotations

import argparse
import os


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--model_type", type=str, default="s1", choices=["s1", "s2"])
    p.add_argument("--ckpt_dir", type=str, required=False, default=None)
    p.add_argument("--output_dir", type=str, default="results_prox")
    p.add_argument("--n_samples", type=int, default=300)
    p.add_argument("--latentD", type=int, default=256)
    p.add_argument("--seed", type=int, default=0)
    from psi_tpu_torch.cli.common import add_asset_args

    add_asset_args(p)
    return p


def make_test_op(args, device):
    """TestOP for --model_type / --latentD: the newest checkpoint of
    --ckpt_dir, else fresh weights from the seed 0, as psi_tpu's fresh model
    comes from PRNGKey(0). --seed seeds the latents."""
    from psi_tpu_torch.gen.sample import TestOP
    from psi_tpu_torch.train.loop import build_model
    from psi_tpu_torch.utils.config import TrainConfig
    from psi_tpu_torch.utils.init import seeded_init_

    cfg = TrainConfig(model_type=args.model_type, latentD=args.latentD)
    model = seeded_init_(build_model(cfg), cfg.seed)
    if args.ckpt_dir:
        return TestOP.from_checkpoint(model, args.ckpt_dir, n_samples=args.n_samples, seed=args.seed, device=device)
    return TestOP(model, n_samples=args.n_samples, seed=args.seed, device=device)


def main(argv=None):
    args = build_parser().parse_args(argv)

    from psi_tpu_torch.cli.common import resolve_device
    from psi_tpu_torch.data.hdf5 import PROX_TEST_SCENES

    op = make_test_op(args, resolve_device(args.device))

    if args.synthetic or args.proxe_path is None:
        from psi_tpu_torch.data.synthetic import SyntheticBatchGenerator

        gen = SyntheticBatchGenerator(num_scenes=len(PROX_TEST_SCENES), batches_per_epoch=4)
        for scene in PROX_TEST_SCENES:
            b = gen.next_batch(1)
            batch = {k: v[:1] for k, v in b.items()}
            n = op.test(batch, args.output_dir, scene)
            print(f"[INFO] {scene}: wrote {n} samples")
    else:
        from psi_tpu_torch.data.matfile import load_test_snapshot

        snapshot_root = os.path.join(args.proxe_path, "snapshot_for_testing")
        for d in sorted(os.listdir(snapshot_root)):
            scene = d.split("_")[0]
            if scene not in PROX_TEST_SCENES:
                continue
            batch = load_test_snapshot(os.path.join(snapshot_root, d, "rec_000000.mat"))
            n = op.test(batch, args.output_dir, scene)
            print(f"[INFO] {scene}: wrote {n} samples")


if __name__ == "__main__":
    main()
