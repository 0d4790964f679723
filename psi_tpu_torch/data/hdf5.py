"""Training data: PROX-E snapshot HDF5 reader.

Port of ``psi_tpu.data.hdf5`` (numpy, copied; ``h5py`` is imported by the
function that reads a file, so the package imports without it).
Equivalent of BatchGeneratorWithSceneMesh (reference:
source/batch_gen_hdf5.py:33-265): reads virtualcams/realcams HDF5
(keys depth, seg, body, cam_ext, cam_int, max_d, sceneid — written by
utils/utils_convert2hdf5.py:55-61), filters to the train/test scene
split, shuffles, and yields batch dicts. Scene geometry is NOT carried
per batch — batches hold an int32 ``scene_idx`` into the device-resident
scene stacks (see psi_tpu_torch.data.scenes); a scene of the file that the
registry lacks gets -1. Batches stay numpy dicts: ``TrainOP.train`` stages
them (train/loop.py::_stage_chunk).

Row 0 of each HDF5 is a placeholder and skipped, the reference's [1:]
convention (batch_gen_hdf5.py:60-67). The bad-PROX-fit batch rejection
(|body z| > max depth, batch_gen_hdf5.py:211-214) is kept.
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from psi_tpu_torch.data.scenes import SceneRegistry, load_scene_registry

PROX_SCENES = [
    "BasementSittingBooth", "MPH1Library", "MPH8", "MPH11", "MPH16",
    "MPH112", "N0SittingBooth", "N0Sofa", "N3Library", "N3Office",
    "N3OpenArea", "Werkraum",
]
PROX_TRAIN_SCENES = [
    "BasementSittingBooth", "MPH8", "MPH11", "MPH112", "N0Sofa",
    "N3Library", "N3Office", "Werkraum",
]
PROX_TEST_SCENES = ["MPH16", "MPH1Library", "N0SittingBooth", "N3OpenArea"]


def _load_streams(dataset_path: Union[str, Sequence[str]]):
    import h5py

    keys = ["depth", "seg", "body", "cam_ext", "cam_int", "max_d", "sceneid"]
    paths = [dataset_path] if isinstance(dataset_path, str) else list(dataset_path)
    parts = {k: [] for k in keys}
    for p in paths:
        with h5py.File(p, "r") as f:
            for k in keys:
                parts[k].append(np.asarray(f[k][1:]))  # row 0 is a placeholder
    return {k: np.concatenate(v, axis=0) for k, v in parts.items()}


class BatchGeneratorWithSceneMesh:
    """next_batch(B) -> dict(xs, xh, cam_ext, cam_int, max_d, scene_idx) | None."""

    def __init__(
        self,
        dataset_path: Union[str, Sequence[str]],
        scene_verts_path: Optional[str] = None,
        scene_sdf_path: Optional[str] = None,
        mode: str = "train",
        registry: Optional[SceneRegistry] = None,
        scene_name_list: Optional[List[str]] = None,
        seed: int = 0,
    ):
        self.scene_name_list = scene_name_list or PROX_SCENES
        streams = _load_streams(dataset_path)
        self.depth = streams["depth"].astype(np.float32)
        self.seg = streams["seg"].astype(np.float32)
        self.body = streams["body"].astype(np.float32).reshape(self.depth.shape[0], -1)
        self.cam_ext = streams["cam_ext"].astype(np.float32).reshape(-1, 4, 4)
        self.cam_int = streams["cam_int"].astype(np.float32).reshape(-1, 3, 3)
        self.max_d = streams["max_d"].astype(np.float32).reshape(-1)
        self.sceneid = streams["sceneid"].astype(np.int64).reshape(-1)

        if mode == "train":
            sub = PROX_TRAIN_SCENES
        elif mode == "test":
            sub = PROX_TEST_SCENES
        elif mode == "all":
            sub = None
        else:
            raise ValueError(f"unknown mode {mode}")

        if sub is not None:
            sub_ids = {self.scene_name_list.index(x) for x in sub if x in self.scene_name_list}
            self.index = [int(i) for i in np.where(np.isin(self.sceneid, list(sub_ids)))[0]]
        else:
            self.index = list(range(self.sceneid.shape[0]))
        self._rng = random.Random(seed)
        self._rng.shuffle(self.index)
        self.n_samples = len(self.index)
        self.index_rec = 0

        if registry is not None:
            self.registry = registry
        else:
            assert scene_verts_path and scene_sdf_path
            self.registry = load_scene_registry(
                scene_verts_path, scene_sdf_path, self.scene_name_list
            )
        # map HDF5 sceneid -> registry row
        self._sceneid_to_reg = np.array(
            [self.registry.index_of(n) if n in self.registry.names else -1
             for n in self.scene_name_list],
            dtype=np.int32,
        )

    def reset(self):
        self.index_rec = 0
        self._rng.shuffle(self.index)

    def has_next_batch(self) -> bool:
        return self.index_rec < self.n_samples

    def next_batch(self, batch_size: int) -> Optional[Dict[str, np.ndarray]]:
        lb = self.index_rec
        ub = min(lb + batch_size, self.n_samples)
        self.index_rec += batch_size
        if ub - lb < batch_size:
            return None
        idx = sorted(self.index[lb:ub])

        depth = self.depth[idx].reshape(batch_size, 128, 128)
        seg = self.seg[idx].reshape(batch_size, 128, 128)
        body = self.body[idx]
        max_d = self.max_d[idx]

        # bad-PROX-fit rejection (batch_gen_hdf5.py:211-214)
        if np.abs(body[:, 2]).max() > np.abs(max_d).max():
            return None

        xs = np.stack([depth, seg], axis=-1)  # NHWC
        return {
            "xs": xs,
            "xh": body,
            "cam_ext": self.cam_ext[idx],
            "cam_int": self.cam_int[idx],
            "max_d": max_d,
            "scene_idx": self._sceneid_to_reg[self.sceneid[idx]],
        }
