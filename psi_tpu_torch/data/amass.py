"""AMASS data preparation for VPoser training (a copy of
``psi_tpu.data.amass``: numpy only, the same draws in the same order).

Rebuild of human_body_prior/data/prepare_data.py + dataloader.py: stage
1 subsamples AMASS mocap npz files (keep ~30% of frames, trim the
first/last 10% of each sequence, prepare_data.py:43-110), stage 2
shuffles/splits, stage 3 writes final per-split arrays. Storage is
plain .npz (no pytables dependency); the dataset slices body joints
1:22 from the 52-joint AMASS pose (dataloader.py:33-57).
"""

from __future__ import annotations

import glob
import os
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from psi_tpu_torch.utils.tools import makepath

NUM_AMASS_JOINTS = 52  # root + 21 body + 30 hands


def subsample_amass_npz(
    npz_path: str, keep_rate: float = 0.3, trim_rate: float = 0.1, rng: Optional[np.random.Generator] = None
) -> Optional[np.ndarray]:
    """One mocap npz -> [n_kept, 52*3] poses (or None if unusable)."""
    rng = rng or np.random.default_rng(0)
    try:
        data = np.load(npz_path)
        poses = np.asarray(data["poses"], np.float32)
    except Exception:
        return None
    n = poses.shape[0]
    if n < 10:
        return None
    lo, hi = int(n * trim_rate), int(n * (1.0 - trim_rate))
    poses = poses[lo:hi]
    keep = rng.random(poses.shape[0]) < keep_rate
    poses = poses[keep]
    if poses.shape[0] == 0:
        return None
    return poses[:, : NUM_AMASS_JOINTS * 3]


def prepare_vposer_datasets(
    amass_dir: str,
    out_dir: str,
    splits: Dict[str, Sequence[str]] = None,
    keep_rate: float = 0.3,
    seed: int = 0,
) -> Dict[str, int]:
    """AMASS root (subdirs of npz mocaps) -> {out_dir}/{split}/data.npz.

    splits maps split name -> list of AMASS sub-dataset dir names
    (the reference's amass_splits convention)."""
    rng = np.random.default_rng(seed)
    splits = splits or {"train": ["*"], "vald": [], "test": []}
    counts = {}
    for split, subsets in splits.items():
        pose_list: List[np.ndarray] = []
        for sub in subsets:
            for npz in sorted(glob.glob(os.path.join(amass_dir, sub, "**", "*.npz"), recursive=True)):
                p = subsample_amass_npz(npz, keep_rate=keep_rate, rng=rng)
                if p is not None:
                    pose_list.append(p)
        if pose_list:
            poses = np.concatenate(pose_list, axis=0)
            rng.shuffle(poses)
        else:
            poses = np.zeros((0, NUM_AMASS_JOINTS * 3), np.float32)
        makepath(os.path.join(out_dir, split))
        np.savez(os.path.join(out_dir, split, "data.npz"), pose=poses)
        counts[split] = poses.shape[0]
    return counts


class VPoserDS:
    """Per-split dataset yielding 21-joint body poses [63]
    (dataloader.py:33-57: slices joints 1:22)."""

    def __init__(self, dataset_dir: str):
        path = os.path.join(dataset_dir, "data.npz")
        self.pose = np.load(path)["pose"].astype(np.float32)

    def __len__(self) -> int:
        return self.pose.shape[0]

    def __getitem__(self, idx) -> Dict[str, np.ndarray]:
        full = self.pose[idx].reshape(-1, 3)
        return {"pose_aa": full[1:22].reshape(-1)}

    def batches(self, batch_size: int, rng: np.random.Generator, drop_last: bool = True) -> Iterator[np.ndarray]:
        idx = rng.permutation(len(self))
        for i in range(0, len(idx) - (batch_size - 1 if drop_last else 0), batch_size):
            sel = idx[i : i + batch_size]
            if drop_last and len(sel) < batch_size:
                break
            yield self.pose[sel].reshape(len(sel), -1, 3)[:, 1:22].reshape(len(sel), -1)


def make_synthetic_amass(out_dir: str, n_train: int = 512, n_val: int = 128, seed: int = 0) -> None:
    """Random pose arrays in the prepared-dataset format (tests/CI)."""
    rng = np.random.default_rng(seed)
    for split, n in [("train", n_train), ("vald", n_val), ("test", n_val)]:
        makepath(os.path.join(out_dir, split))
        np.savez(
            os.path.join(out_dir, split, "data.npz"),
            pose=(rng.normal(0, 0.4, size=(n, NUM_AMASS_JOINTS * 3))).astype(np.float32),
        )
