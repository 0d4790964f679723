"""Generation CLI for MP3D-R / Habitat rooms (reference:
test_habitat_s1.py / test_habitat_s2.py): iterate each room's sensor
dumps (cam_/depth_/seg_*.npy), sample n_samples bodies per camera,
write body_gen_*.pkl per room, numbered on across the room's cameras.

Port of ``psi_tpu.cli.test_habitat``; the model comes as in
``cli.test_proxe``. Runs on the first NVIDIA card unless --device names
another device.

  python -m psi_tpu_torch.cli.test_habitat --dump_root <habitat_dumps> \
      --output_dir results_habitat --n_samples 200 [--synthetic]
"""

from __future__ import annotations

import argparse
import glob
import os


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--model_type", type=str, default="s1", choices=["s1", "s2"])
    p.add_argument("--ckpt_dir", type=str, default=None)
    p.add_argument("--dump_root", type=str, default=None, help="root of per-room npy sensor dumps")
    p.add_argument("--output_dir", type=str, default="results_habitat")
    p.add_argument("--n_samples", type=int, default=200)  # test_habitat_s1.py:240
    p.add_argument("--latentD", type=int, default=256)
    p.add_argument("--seed", type=int, default=0)
    from psi_tpu_torch.cli.common import add_asset_args

    add_asset_args(p)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    from psi_tpu_torch.cli.common import resolve_device
    from psi_tpu_torch.cli.fitting import MP3D_ROOMS
    from psi_tpu_torch.cli.test_proxe import make_test_op

    op = make_test_op(args, resolve_device(args.device))

    if args.synthetic or args.dump_root is None:
        from psi_tpu_torch.data.synthetic import SyntheticBatchGenerator

        gen = SyntheticBatchGenerator(num_scenes=len(MP3D_ROOMS), batches_per_epoch=len(MP3D_ROOMS))
        for room in MP3D_ROOMS:
            b = gen.next_batch(1)
            n = op.test({k: v[:1] for k, v in b.items()}, args.output_dir, room, idx_offset=0)
            print(f"[INFO] {room}: wrote {n} samples")
        return

    from psi_tpu_torch.data.matfile import load_habitat_snapshot

    for room_dir in sorted(glob.glob(os.path.join(args.dump_root, "*"))):
        room = os.path.basename(room_dir)
        cams = sorted(glob.glob(os.path.join(room_dir, "cam_*.npy")))
        offset = 0
        for cam_file in cams:
            cam_id = int(os.path.splitext(os.path.basename(cam_file))[0].split("_")[-1])
            batch = load_habitat_snapshot(room_dir, cam_id)
            n = op.test(batch, args.output_dir, room, idx_offset=offset)
            offset += n
        print(f"[INFO] {room}: wrote {offset} samples over {len(cams)} cameras")


if __name__ == "__main__":
    main()
