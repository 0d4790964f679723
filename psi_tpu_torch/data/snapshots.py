"""Scene snapshot production: render depth/semantics from real + virtual
cameras, pair with body fits, pack to HDF5.

Port of ``psi_tpu.data.snapshots`` (rebuild of
utils/utils_prox_snapshots_realcam.py, utils_prox_snapshots_virtualcam.py
and utils_convert2hdf5.py, the Open3D offscreen capture replaced by the
software renderer of ``viz.render``):

* camera placement (``room_box_planes``, ``look_at_body``,
  ``get_new_cams``) is numpy on the host, copied: the same
  ``np.random.Generator`` seed gives the same cameras in bits, the single
  scalar jitter added to all three coordinates (:118 there) included;
* ``pelvis_offset`` / ``update_globalRT_for_smplx`` decode the body on the
  device of the ``SMPLXModel`` and ``VPoser`` handed in; the rotations go
  through float32 where psi_tpu casts, the 4x4 products stay float64;
* ``render_scene_snapshot`` renders on the device (``device=None``: the
  first card, or an error without one); the preprocessing to 128x128
  canvases and the returned dict stay numpy, as in psi_tpu;
* ``SnapshotHDF5Writer`` writes psi_tpu's layout (keys, shapes, float32,
  chunked and resizable, row 0 a zero placeholder) and imports ``h5py`` in
  its constructor, so the module imports without it.

Two reference behaviours are kept as psi_tpu has them. The stored
``cam_ext`` of a virtual-camera row is world->camera and the stored body is
in that camera's frame, while ``data.matfile.load_test_snapshot`` stores
camera->world and the fit and the objective map camera-frame bodies into the
scene with ``verts_transform(verts, cam_ext)``. And
``produce_virtualcam_snapshots`` reuses the first frame's pelvis offset
``delta_T`` for every later frame of the call.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from psi_tpu_torch.body.smplx_model import SMPLXModel, smplx_forward
from psi_tpu_torch.body.vposer import VPoser, vposer_decode
from psi_tpu_torch.data.preprocessing import data_preprocessing
from psi_tpu_torch.geometry.bodyvec import body_params_parse
from psi_tpu_torch.geometry.rot6d import aa_to_matrix, matrix_to_aa
from psi_tpu_torch.utils.tools import resolve_device
from psi_tpu_torch.viz.render import rasterize_mesh, render_depth_semantics


# ---------------------------------------------------------------------------
# virtual camera placement
# ---------------------------------------------------------------------------


def _plane_inner_normal(quad: np.ndarray, toward: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """quad: [4, 3] corners; normal oriented toward ``toward``."""
    v1, v2, v3, v4 = quad
    n = np.cross(v2 - v1, v3 - v1)
    n = n / np.linalg.norm(n)
    c = quad.mean(axis=0)
    if np.dot(n, toward - c) < 0:
        n = -n
    return n, c


def room_box_planes(box_min: np.ndarray, box_max: np.ndarray) -> Dict[str, np.ndarray]:
    """Axis-aligned room box -> the six boundary quads (walls/floor/ceiling),
    the format of the reference's PROXE_box_verts.json entries."""
    x0, y0, z0 = box_min
    x1, y1, z1 = box_max

    def quad(pts):
        return np.asarray(pts, np.float64)

    return {
        "floor": quad([[x0, y0, z0], [x1, y0, z0], [x1, y1, z0], [x0, y1, z0]]),
        "ceiling": quad([[x0, y0, z1], [x1, y0, z1], [x1, y1, z1], [x0, y1, z1]]),
        "wall_1": quad([[x0, y0, z0], [x0, y1, z0], [x0, y1, z1], [x0, y0, z1]]),
        "wall_2": quad([[x1, y0, z0], [x1, y1, z0], [x1, y1, z1], [x1, y0, z1]]),
        "wall_3": quad([[x0, y0, z0], [x1, y0, z0], [x1, y0, z1], [x0, y0, z1]]),
        "wall_4": quad([[x0, y1, z0], [x1, y1, z0], [x1, y1, z1], [x0, y1, z1]]),
    }


def look_at_body(cam_T: np.ndarray, body_T: np.ndarray) -> np.ndarray:
    """Camera rotation whose +z looks at the body (the reference's axis
    construction, utils_prox_snapshots_virtualcam.py:143-155)."""
    cam_z = body_T - cam_T
    cam_z = cam_z / np.linalg.norm(cam_z)
    cam_x = np.array([cam_z[1], -cam_z[0], 0.0])
    n = np.linalg.norm(cam_x)
    degenerate = n < 1e-8  # looking straight along +/-z
    if degenerate:
        cam_x = np.array([1.0, 0.0, 0.0])
    else:
        cam_x = cam_x / n
    if not degenerate and abs(cam_z[2]) > 1e-8:
        cam_y = np.array([cam_z[0], cam_z[1], -(cam_z[0] ** 2 + cam_z[1] ** 2) / cam_z[2]])
        cam_y = cam_y / np.linalg.norm(cam_y)
    else:
        cam_y = np.cross(cam_z, cam_x)
    return np.stack([cam_x, -cam_y, cam_z], axis=1)


def get_new_cams(
    planes: Dict[str, np.ndarray],
    s_min: np.ndarray,
    s_max: np.ndarray,
    body_T: np.ndarray,
    scene_grid_nodes: int = 10,
    dist_range: Tuple[float, float] = (1.65, 6.5),
    jitter: float = 0.5,
    rng: Optional[np.random.Generator] = None,
    max_cams: int = 30,
) -> List[np.ndarray]:
    """Candidate camera-to-world [4, 4] matrices looking at the body."""
    rng = rng or np.random.default_rng(0)
    normals = {k: _plane_inner_normal(q, body_T) for k, q in planes.items()}
    ceiling_z = normals["ceiling"][1][2]

    nz = max(scene_grid_nodes // 3, 3)
    xs = np.linspace(s_min[0], s_max[0], scene_grid_nodes)
    ys = np.linspace(s_min[1], s_max[1], scene_grid_nodes)
    zs = np.linspace(body_T[2], ceiling_z, nz)

    cams = []
    for i in range(1, scene_grid_nodes - 1):
        for j in range(1, scene_grid_nodes - 1):
            for k in range(1, nz - 1):
                # one scalar draw jitters all three coordinates (psi_tpu's draw)
                cam_T = np.array([xs[i], ys[j], zs[k]]) + jitter * rng.standard_normal()
                d = np.linalg.norm(cam_T - body_T)
                if d <= dist_range[0] or d >= dist_range[1]:
                    continue
                inside = all(
                    np.dot(cam_T - c, n) >= 0 for n, c in normals.values()
                )
                if not inside:
                    continue
                mat = np.eye(4)
                mat[:3, :3] = look_at_body(cam_T, body_T)
                mat[:3, 3] = cam_T
                cams.append(mat)
    if len(cams) > max_cams:
        sel = rng.choice(len(cams), size=max_cams, replace=False)
        cams = [cams[int(s)] for s in sel]
    return cams


# ---------------------------------------------------------------------------
# body global R/T re-expression
# ---------------------------------------------------------------------------


def pelvis_offset(smplx: SMPLXModel, vposer: VPoser, body_params: Dict[str, np.ndarray]) -> np.ndarray:
    """delta_T: root-joint position with zero transl/orient (:221-234),
    decoded on the body model's device with its 'high' LBS."""
    dev = smplx.v_template.device
    pose = torch.from_numpy(np.asarray(body_params["body_pose"], np.float32)).to(dev)
    with torch.no_grad():
        if pose.shape[-1] == 32:
            pose_aa = vposer_decode(vposer, pose.reshape(1, 32))
        else:
            pose_aa = pose.reshape(1, -1)
        zeros = torch.zeros((1, 3), dtype=torch.float32, device=dev)
        betas = torch.from_numpy(np.asarray(body_params["betas"], np.float32).reshape(1, -1)).to(dev)
        _, joints = smplx_forward(smplx, transl=zeros, global_orient=zeros, betas=betas, body_pose=pose_aa)
    return joints[0, 0].cpu().numpy()


def update_globalRT_for_smplx(
    body_params: Dict[str, np.ndarray],
    trans_list: Sequence[np.ndarray],
    smplx: Optional[SMPLXModel] = None,
    vposer: Optional[VPoser] = None,
    delta_T: Optional[np.ndarray] = None,
) -> Tuple[List[Dict[str, np.ndarray]], np.ndarray]:
    """Re-express global_orient/transl under each [4, 4] transform.

    The SMPL-X ``transl`` is not the rotation pivot — the pelvis is; the
    calibration adds delta_T before transforming and removes it after
    (:236-256). The 3x3 rotations are float32 (on the host), the 4x4
    products float64, where psi_tpu has them."""
    if delta_T is None:
        delta_T = pelvis_offset(smplx, vposer, body_params)

    aa = np.asarray(body_params["global_orient"], np.float64).reshape(3)
    R_mat = aa_to_matrix(torch.from_numpy(aa[None].astype(np.float32))).numpy()[0]
    T = np.asarray(body_params["transl"], np.float64).reshape(3)
    body_mat = np.eye(4)
    body_mat[:3, :3] = R_mat
    body_mat[:3, 3] = T + delta_T

    out = []
    for trans in trans_list:
        new_mat = np.asarray(trans, np.float64) @ body_mat
        new_aa = matrix_to_aa(torch.from_numpy(new_mat[None, :3, :3].astype(np.float32))).numpy()[0]
        p = dict(body_params)
        p["global_orient"] = new_aa.reshape(1, 3)
        p["transl"] = (new_mat[:3, 3] - delta_T).reshape(1, 3)
        out.append(p)
    return out, delta_T


def is_body_occluded(
    body_transl: np.ndarray, cam_int: np.ndarray, depth: np.ndarray, probe: int = 10
) -> bool:
    """Depth-probe occlusion test at the projected body center (:342-378).
    The projection centres on (w/2, h/2), not on the intrinsics' principal
    point, as psi_tpu's does."""
    T = np.asarray(body_transl).reshape(3)
    h, w = depth.shape
    fx, fy = cam_int[0, 0], cam_int[1, 1]
    if T[2] <= 1e-6:
        return True
    cx = int(T[0] * fx / T[2] + w / 2)
    cy = int(T[1] * fy / T[2] + h / 2)
    if cx <= probe or cx > w - probe or cy <= probe or cy > h - probe:
        return True
    patch = depth[max(cy - probe, 0) : cy + probe, max(cx - probe, 0) : cx + probe]
    valid = patch[patch > 0]  # zero depth = no geometry = nothing to occlude
    if valid.size == 0:
        return False
    return bool(np.mean(valid) <= T[2])


# ---------------------------------------------------------------------------
# snapshot rendering + packing
# ---------------------------------------------------------------------------


def render_scene_snapshot(
    scene_verts,
    scene_labels,
    cam2world: np.ndarray,
    cam_int: np.ndarray,
    height: int = 480,
    width: int = 640,
    scene_faces=None,
    device=None,
) -> Dict[str, np.ndarray]:
    """Depth + semantics from one camera (the Open3D capture replacement);
    returns raw maps plus the preprocessed 128x128 canvases, all numpy.
    With scene_faces the true triangle rasterizer renders hole-free maps;
    otherwise points are z-buffer splatted. The render runs on ``device``
    (None: the first card, or an error without one); the scene may be
    handed over as tensors already there, which are then not copied."""
    dev = resolve_device(device, "render_scene_snapshot")
    world2cam = np.linalg.inv(np.asarray(cam2world, np.float64)).astype(np.float32)
    on = lambda a, dt: torch.as_tensor(a, dtype=dt, device=dev)
    verts, labels = on(scene_verts, torch.float32), on(scene_labels, torch.int32)
    cam_int_t, cam_ext_t = on(np.asarray(cam_int, np.float32), torch.float32), on(world2cam, torch.float32)
    if scene_faces is not None and len(scene_faces):
        depth, seg = rasterize_mesh(verts, on(scene_faces, torch.int32), labels, cam_int_t, height, width,
                                    cam_ext=cam_ext_t)
    else:
        depth, seg = render_depth_semantics(verts, labels, cam_int_t, height, width, cam_ext=cam_ext_t)
    depth = depth.cpu().numpy()
    seg = seg.cpu().numpy()
    depth_c, _, max_d = data_preprocessing(depth, "depth")
    seg_c, _, _ = data_preprocessing(seg, "seg")
    return {
        "depth_raw": depth,
        "seg_raw": seg,
        "depth": depth_c,
        "seg": seg_c,
        "max_d": np.float32(max_d),
        "cam_ext": world2cam,
        "cam_int": np.asarray(cam_int, np.float32),
    }


def produce_virtualcam_snapshots(
    scene_verts: np.ndarray,
    scene_labels: np.ndarray,
    body_params_list: Sequence[Dict[str, np.ndarray]],
    smplx: SMPLXModel,
    vposer: VPoser,
    writer: "SnapshotHDF5Writer",
    sceneid: int,
    cam_int: Optional[np.ndarray] = None,
    render_hw: Tuple[int, int] = (480, 640),
    max_cams_per_frame: int = 30,
    seed: int = 0,
    planes: Optional[Dict[str, np.ndarray]] = None,
    device=None,
) -> int:
    """The virtual-camera snapshot main loop
    (utils_prox_snapshots_virtualcam.py:390-554): for each body frame,
    place candidate cameras, re-express the body's global R/T in each
    camera frame, render depth+semantics, reject occluded views, append
    to the HDF5. Returns the number of snapshots written. The scene goes to
    ``device`` (None: the first card, or an error) once for the call; the
    body is decoded where ``smplx`` and ``vposer`` are."""
    dev = resolve_device(device, "produce_virtualcam_snapshots")
    rng = np.random.default_rng(seed)
    s_min = scene_verts.min(axis=0)
    s_max = scene_verts.max(axis=0)
    if planes is None:
        planes = room_box_planes(s_min, s_max)
    h, w = render_hw
    if cam_int is None:
        f = max(h, w)
        cam_int = np.array([[f, 0, w / 2.0], [0, f, h / 2.0], [0, 0, 1.0]], np.float32)
    verts_t = torch.as_tensor(np.asarray(scene_verts, np.float32), device=dev)
    labels_t = torch.as_tensor(np.asarray(scene_labels, np.int32), device=dev)

    written = 0
    delta_T = None  # the first frame's pelvis offset serves every later frame (psi_tpu's behaviour)
    for body_params in body_params_list:
        body_T = np.asarray(body_params["transl"]).reshape(3)
        cams = get_new_cams(
            planes, s_min, s_max, body_T, rng=rng, max_cams=max_cams_per_frame
        )
        if not cams:
            continue
        world2cam_list = [np.linalg.inv(c) for c in cams]
        new_params_list, delta_T = update_globalRT_for_smplx(
            body_params, world2cam_list, smplx, vposer, delta_T=delta_T
        )
        for cam2world, new_params in zip(cams, new_params_list):
            snap = render_scene_snapshot(
                verts_t, labels_t, cam2world, cam_int, height=h, width=w, device=dev
            )
            if is_body_occluded(new_params["transl"], cam_int, snap["depth_raw"]):
                continue
            body72 = body_params_parse(new_params).numpy().reshape(72)
            writer.append(
                snap["depth"], snap["seg"], body72, snap["cam_ext"],
                snap["cam_int"], snap["max_d"], sceneid,
            )
            written += 1
    return written


def matfiles_to_hdf5(mat_glob_dir: str, out_path: str, scene_name_list: Sequence[str]) -> int:
    """Pack per-frame snapshot .mat files into the training HDF5
    (utils_convert2hdf5.py flow): parse, preprocess, reject bad fits.
    Scene id comes from the filename's leading scene token. A file that
    does not load is skipped, as psi_tpu skips it."""
    from psi_tpu_torch.data.matfile import load_test_snapshot

    writer = SnapshotHDF5Writer(out_path)
    n = 0
    for mat in sorted(glob.glob(os.path.join(mat_glob_dir, "**", "*.mat"), recursive=True)):
        try:
            d = load_test_snapshot(mat)
        except Exception:
            continue
        body = d["xh"].reshape(-1)
        if body.shape[0] < 72 or abs(body[2]) > d["max_d"][0]:
            continue  # bad PROX fit (utils_convert2hdf5.py:89-99)
        scene_token = os.path.basename(mat).split("_")[0]
        parent_token = os.path.basename(os.path.dirname(mat)).split("_")[0]
        sceneid = 0
        for tok in (scene_token, parent_token):
            if tok in scene_name_list:
                sceneid = scene_name_list.index(tok)
                break
        writer.append(
            d["xs"][0, :, :, 0], d["xs"][0, :, :, 1], body[:72],
            d["cam_ext"][0], d["cam_int"][0], float(d["max_d"][0]), sceneid,
        )
        n += 1
    writer.close()
    return n


class SnapshotHDF5Writer:
    """Streaming resizable-dataset HDF5 packer (utils_convert2hdf5.py).

    Keys and the row-0 placeholder convention match the reference so
    BatchGeneratorWithSceneMesh reads the output directly."""

    KEYS = ("depth", "seg", "body", "cam_ext", "cam_int", "max_d", "sceneid")
    SHAPES = {"depth": (128, 128), "seg": (128, 128), "body": (72,), "cam_ext": (4, 4), "cam_int": (3, 3),
              "max_d": (), "sceneid": ()}

    def __init__(self, path: str):
        import h5py

        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.f = h5py.File(path, "w")
        self._initialized = False

    def _init_datasets(self):
        for k in self.KEYS:
            s = self.SHAPES[k]
            # row 0 stays a zero placeholder (readers skip it)
            self.f.create_dataset(k, shape=(1,) + s, maxshape=(None,) + s, dtype=np.float32, chunks=True)
        self._initialized = True

    def append(
        self,
        depth: np.ndarray,
        seg: np.ndarray,
        body72: np.ndarray,
        cam_ext: np.ndarray,
        cam_int: np.ndarray,
        max_d: float,
        sceneid: int,
    ):
        sample = {
            "depth": depth.reshape(128, 128), "seg": seg.reshape(128, 128),
            "body": np.asarray(body72).reshape(72), "cam_ext": cam_ext.reshape(4, 4),
            "cam_int": cam_int.reshape(3, 3), "max_d": np.float32(max_d),
            "sceneid": np.float32(sceneid),
        }
        if not self._initialized:
            self._init_datasets()
        for k in self.KEYS:
            ds = self.f[k]
            n = ds.shape[0]
            ds.resize(n + 1, axis=0)
            ds[n] = sample[k]

    def close(self):
        self.f.close()
