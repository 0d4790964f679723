"""Test-snapshot .mat parsing (PROX-E) and Habitat npy sensor dumps.

Port of ``psi_tpu.data.matfile`` (numpy, copied).

Equivalent of BatchGeneratorTest (reference: source/batch_gen_hdf5.py:
619-797): parse one scene snapshot .mat (raw depth/seg maps + cam
struct + fitted body), run the 128x128 canvas preprocessing, invert the
extrinsics (np.linalg.inv, batch_gen_hdf5.py:738), and return the batch
dict the generation path consumes. Habitat dumps (cam_/depth_/seg_*.npy,
test_habitat_s1.py:173-188) go through the same preprocessing.
"""

from __future__ import annotations

import glob
import os
import random
from typing import Dict, List, Optional

import numpy as np

from psi_tpu_torch.data.preprocessing import data_preprocessing


def load_test_snapshot(mat_path: str) -> Dict[str, np.ndarray]:
    """One .mat -> dict(xs [1,128,128,2], max_d [1], cam_int [1,3,3],
    cam_ext [1,4,4], xh [1,72])."""
    import scipy.io as sio

    data = sio.loadmat(mat_path)
    depth_raw = np.asarray(data["depth"], np.float32)
    seg_raw = np.asarray(data["seg"], np.float32)

    depth, _, max_d = data_preprocessing(depth_raw, "depth")
    seg, _, _ = data_preprocessing(seg_raw, "seg")

    cam_int = np.asarray(data["cam"][0][0]["intrinsic"], np.float32).reshape(1, 3, 3)
    cam_ext = np.linalg.inv(np.asarray(data["cam"][0][0]["extrinsic"], np.float64)).astype(np.float32).reshape(1, 4, 4)

    body = data["body"][0][0]
    xh = np.concatenate(
        [
            np.asarray(body["transl"], np.float32),
            np.asarray(body["global_orient"], np.float32),
            np.asarray(body["betas"], np.float32),
            np.asarray(body["body_pose"], np.float32),
            np.asarray(body["left_hand_pose"], np.float32),
            np.asarray(body["right_hand_pose"], np.float32),
        ],
        axis=-1,
    ).reshape(1, -1)

    xs = np.stack([depth, seg], axis=-1)[None]  # [1, 128, 128, 2]
    return {
        "xs": xs,
        "max_d": np.asarray([max_d], np.float32),
        "cam_int": cam_int,
        "cam_ext": cam_ext,
        "xh": xh,
    }


class BatchGeneratorTest:
    """Iterates *.mat snapshots of one test scene (reference interface)."""

    def __init__(self, dataset_path: str, seed: int = 0):
        self.rec_list: List[str] = glob.glob(os.path.join(dataset_path, "*.mat"))
        self._rng = random.Random(seed)
        self._rng.shuffle(self.rec_list)
        self.index_rec = 0

    def reset(self):
        self.index_rec = 0
        self._rng.shuffle(self.rec_list)

    def has_next_batch(self) -> bool:
        return self.index_rec < len(self.rec_list)

    def next_batch(self, batch_size: int = 1) -> Optional[Dict[str, np.ndarray]]:
        outs = []
        for _ in range(batch_size):
            if not self.has_next_batch():
                return None
            outs.append(load_test_snapshot(self.rec_list[self.index_rec]))
            self.index_rec += 1
        batch = {k: np.concatenate([o[k] for o in outs], axis=0) for k in outs[0]}
        if np.isnan(batch["xs"]).any():
            return None
        return batch


def load_habitat_snapshot(dump_dir: str, cam_id: int) -> Dict[str, np.ndarray]:
    """Habitat sensor dump triplet -> generation batch dict.

    Reference format (test_habitat_s1.py:173-188): ``cam_{i}.npy`` is a
    pickled 0-d object array read as ``np.load(f, allow_pickle=True,
    encoding='latin1').item()`` -> dict with keys ``cam_ext`` [4,4] and
    ``cam_int`` [3,3]; ``depth_{i}.npy`` / ``seg_{i}.npy`` are raw [H,W]
    sensor maps. A bare 4x4 matrix in cam_*.npy is also accepted (then a
    90-deg-HFOV pinhole intrinsic is synthesized).

    Reference quirk preserved: BOTH maps run through preprocessing with
    modality='depth' (test_habitat_s1.py:181-184 passes 'depth' for the
    seg map too, clamping labels at 6.0 before the [-1,1] rescale).
    """
    depth_raw = np.load(os.path.join(dump_dir, f"depth_{cam_id}.npy")).astype(np.float32)
    seg_raw = np.load(os.path.join(dump_dir, f"seg_{cam_id}.npy")).astype(np.float32)
    cam = np.load(
        os.path.join(dump_dir, f"cam_{cam_id}.npy"), allow_pickle=True, encoding="latin1"
    )

    depth, _, max_d = data_preprocessing(depth_raw, "depth")
    seg, _, _ = data_preprocessing(seg_raw, "depth")  # sic — reference behavior

    cam_int = None
    if cam.dtype == object:
        params = cam.item()
        cam_ext = np.asarray(params["cam_ext"], np.float32).reshape(1, 4, 4)
        if "cam_int" in params:
            cam_int = np.asarray(params["cam_int"], np.float32).reshape(1, 3, 3)
    elif cam.shape == (4, 4):
        cam_ext = cam.astype(np.float32).reshape(1, 4, 4)
    else:
        cam_ext = np.eye(4, dtype=np.float32).reshape(1, 4, 4)

    if cam_int is None:
        h, w = depth_raw.shape
        f = max(h, w) / 2.0  # 90-deg HFOV pinhole, the habitat default
        cam_int = np.array(
            [[f, 0, w / 2.0], [0, f, h / 2.0], [0, 0, 1.0]], np.float32
        ).reshape(1, 3, 3)

    xs = np.stack([depth, seg], axis=-1)[None]
    return {
        "xs": xs,
        "max_d": np.asarray([max_d], np.float32),
        "cam_int": cam_int,
        "cam_ext": cam_ext,
    }


# Habitat -> camera coordinate fix: y/z axis flip composed with the
# extrinsics (reference fitting_habitat.py:179-184).
HABITAT_T_MAT = np.array(
    [[1.0, 0.0, 0.0, 0.0],
     [0.0, -1.0, 0.0, 0.0],
     [0.0, 0.0, -1.0, 0.0],
     [0.0, 0.0, 0.0, 1.0]],
    np.float32,
)
