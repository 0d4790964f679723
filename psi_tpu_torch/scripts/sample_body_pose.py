"""Tutorial: sample body poses from the VPoser prior and decode meshes
(equivalent of human_body_prior/tutorials/sample_body_pose.py).

The port's counterpart of ``examples/sample_body_pose.py``:

    python -m psi_tpu_torch.scripts.sample_body_pose [--n 5] [--out poses.png] [--vposer_ckpt PATH]
        [--smplx_npz SMPLX_NEUTRAL.npz] [--device cpu]

z ~ N(0, 1) is drawn from a seeded ``torch.Generator``, decoded by VPoser,
posed by SMPL-X and rasterized into a grid of ``MeshViewer`` renders. Runs
on the first NVIDIA card unless --device names another device (an error
without a card).
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

from psi_tpu_torch.body.smplx_model import load_smplx_npz, smplx_forward, synthetic_smplx
from psi_tpu_torch.body.vposer import synthetic_vposer, vposer_decode
from psi_tpu_torch.utils.convert_torch import load_vposer
from psi_tpu_torch.utils.tools import resolve_device
from psi_tpu_torch.viz.mesh_viewer import MeshViewer, imagearray2file

VIEW_HW = 200  # each grid cell's side


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=5)
    ap.add_argument("--out", type=str, default="sampled_poses.png")
    ap.add_argument("--vposer_ckpt", type=str, default=None, help="torch snapshot dir/file (else random weights)")
    ap.add_argument("--smplx_npz", type=str, default=None, help="SMPLX_NEUTRAL.npz (else synthetic body)")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: the first NVIDIA card; an error without one)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device, "sample_body_pose")

    vp = load_vposer(args.vposer_ckpt) if args.vposer_ckpt else synthetic_vposer(seed=0)
    vp = vp.to(dev)
    body = load_smplx_npz(args.smplx_npz) if args.smplx_npz else synthetic_smplx(num_verts=600, num_joints=55)
    body = body.to(dev)

    # z ~ N(0, 1) -> 21-joint axis-angle poses (VPoser.sample_poses semantics)
    z = torch.randn((args.n, vp.latentD), generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    zeros = lambda d: torch.zeros((args.n, d), device=dev)
    with torch.no_grad():
        pose_aa = vposer_decode(vp, z)
        print(f"sampled {args.n} poses, axis-angle shape {tuple(pose_aa.shape)}")
        verts, joints = smplx_forward(body, transl=zeros(3), global_orient=zeros(3), betas=zeros(10),
                                      body_pose=pose_aa)
    print(f"decoded meshes: verts {tuple(verts.shape)}, joints {tuple(joints.shape)}")

    # render a grid
    mv = MeshViewer(width=VIEW_HW, height=VIEW_HW, device=dev)
    frames = np.zeros((1, args.n, 1, VIEW_HW, VIEW_HW, 3), np.uint8)
    faces = body.faces.cpu().numpy()
    verts_np = verts.cpu().numpy()
    for i in range(args.n):
        mv.set_meshes([(
            verts_np[i] + np.array([0, 0, 2.5]),
            faces,
            np.tile([0.4, 0.5, 0.85], (verts_np.shape[1], 1)),
        )], densify=0)
        frames[0, i, 0] = mv.render()
    imagearray2file(frames, args.out)
    print(f"wrote {args.out}")
    return {"z": z, "pose_aa": pose_aa, "verts": verts, "frames": frames}


if __name__ == "__main__":
    main()
