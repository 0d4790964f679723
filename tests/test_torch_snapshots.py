"""Snapshot production: psi_tpu_torch.data.snapshots (and data.labelmap,
viz.sphere) against psi_tpu's on the same numpy inputs from a seed.

Camera placement is numpy in both packages and is held in bits (the same
``default_rng`` seed, the same cameras). The body's re-expression decodes
the pelvis through VPoser and SMPL-X: both packages' LBS is patched to
``exact=True`` (plain f32), and the ``_high_lbs`` tests run both at their
default 'high' (split-bf16 products on both sides); the results are held to
1e-5 either way. The renderer is held as tests/test_torch_viz.py holds it: raw maps
equal in >= 99.9% of pixels (a camera transform's matmul may round a
triangle's depth to the next millimetre), canvases within 1e-6 of psi_tpu's
preprocessing of the same raw maps, ``max_d`` and ``cam_ext`` equal. The
HDF5 files are read across packages.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from psi_tpu.body import smplx_model as j_smplx_model
from psi_tpu.body.lbs import lbs as j_lbs
from psi_tpu.body.smplx_model import synthetic_smplx as j_synthetic_smplx
from psi_tpu.body.vposer import synthetic_vposer_params
from psi_tpu.data import labelmap as j_labelmap
from psi_tpu.data import snapshots as j_snap
from psi_tpu.data.matfile import load_test_snapshot as j_load_test_snapshot
from psi_tpu.data.preprocessing import data_preprocessing as j_data_preprocessing
from psi_tpu.viz import sphere as j_sphere
from psi_tpu_torch.body import smplx_model as t_smplx_model
from psi_tpu_torch.body.decode import body_vec_to_verts
from psi_tpu_torch.body.lbs import lbs as t_lbs
from psi_tpu_torch.body.smplx_model import synthetic_smplx
from psi_tpu_torch.data import labelmap, snapshots
from psi_tpu_torch.data.matfile import load_test_snapshot
from psi_tpu_torch.geometry.bodyvec import body_params_parse
from psi_tpu_torch.geometry.camera import verts_transform
from psi_tpu_torch.utils.convert_jax import vposer_from_jax
from psi_tpu_torch.viz import sphere
from test_torch_data_ingest import _write_mat

torch.set_num_threads(1)
BODY_TOL = 1e-5
EQUAL_SHARE = 0.999
CANVAS_TOL = 1e-6
HW = (120, 160)
N_VERTS = 80


@pytest.fixture(autouse=True)
def exact_jax_lbs(monkeypatch):
    monkeypatch.setattr(j_smplx_model, "lbs", functools.partial(j_lbs, exact=True))
    monkeypatch.setattr(t_smplx_model, "lbs", functools.partial(t_lbs, exact=True))


@pytest.fixture
def split_lbs(monkeypatch):
    """Both packages back at their default 'high' LBS (split-bf16)."""
    monkeypatch.setattr(j_smplx_model, "lbs", j_lbs)
    monkeypatch.setattr(t_smplx_model, "lbs", t_lbs)


@pytest.fixture(scope="module")
def bodies():
    """Both packages' body model (the same seeded arrays) and VPoser (psi_tpu's
    random weights carried over)."""
    vp = jax.device_get(synthetic_vposer_params(0))
    return (j_synthetic_smplx(num_verts=N_VERTS, num_joints=55, seed=0), vp,
            synthetic_smplx(num_verts=N_VERTS, num_joints=55, seed=0), vposer_from_jax(vp))


def _body_params(rng, latent=True):
    return {
        "transl": np.array([[0.0, 0.0, 1.0]], np.float32) + rng.normal(0, 0.3, (1, 3)).astype(np.float32),
        "global_orient": (rng.normal(size=(1, 3)) * 0.3).astype(np.float32),
        "betas": (rng.normal(size=(1, 10)) * 0.5).astype(np.float32),
        "body_pose": (rng.normal(size=(1, 32 if latent else 63)) * 0.3).astype(np.float32),
        "left_hand_pose": np.zeros((1, 12), np.float32),
        "right_hand_pose": np.zeros((1, 12), np.float32),
    }


def _room(rng, n_floor=40, n_clutter=500):
    """A dense floor plane and a box of clutter, labelled floor (2) and other (5)."""
    g = np.stack(np.meshgrid(np.linspace(-4, 4, n_floor), np.linspace(-4, 4, n_floor), [0.0]), -1).reshape(-1, 3)
    clutter = rng.uniform([-2, -2, 0], [2, 2, 2.5], size=(n_clutter, 3))
    verts = np.concatenate([g, clutter]).astype(np.float32)
    labels = np.concatenate([np.full(len(g), 2), np.full(len(clutter), 5)]).astype(np.int32)
    return verts, labels


def _cam_int(f=150.0, h=HW[0], w=HW[1]):
    return np.array([[f, 0, w / 2.0], [0, f, h / 2.0], [0, 0, 1]], np.float32)


class RecordingWriter:
    """SnapshotHDF5Writer's append/close, keeping every row in memory."""

    def __init__(self):
        self.rows, self.closed = [], False

    def append(self, *row):
        self.rows.append(row)

    def close(self):
        self.closed = True


# ---- the copied numpy modules


def test_labelmap_and_spheres_equal_psi_tpus():
    np.testing.assert_array_equal(labelmap.ADE20K_TO_MPCAT40, j_labelmap.ADE20K_TO_MPCAT40)
    assert labelmap.ADE20K_TO_MPCAT40.dtype == j_labelmap.ADE20K_TO_MPCAT40.dtype
    seg = np.random.default_rng(0).integers(-5, 200, (7, 9))
    np.testing.assert_array_equal(labelmap.look_up_ade2mp3d(seg), j_labelmap.look_up_ade2mp3d(seg))
    for radius, sub in ((1.0, 0), (2.0, 1), (0.3, 2)):
        for a, b in zip(sphere.icosphere(radius, sub), j_sphere.icosphere(radius, sub)):
            np.testing.assert_array_equal(a, b)
    pts = np.random.default_rng(1).normal(size=(5, 3))
    for a, b in zip(sphere.points_to_spheres(pts, 0.05, 1), j_sphere.points_to_spheres(pts, 0.05, 1)):
        np.testing.assert_array_equal(a, b)


# ---- camera placement, in bits


def test_room_box_planes_and_look_at_body_equal_in_bits():
    rng = np.random.default_rng(2)
    lo, hi = rng.uniform(-4, -2, 3), rng.uniform(2, 4, 3)
    ours, theirs = snapshots.room_box_planes(lo, hi), j_snap.room_box_planes(lo, hi)
    assert list(ours) == list(theirs)
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k])
    cases = [(rng.normal(size=3), rng.normal(size=3)) for _ in range(20)]
    cases += [(np.zeros(3), np.array([0.0, 0, 2.0])), (np.zeros(3), np.array([0.0, 0, -2.0])),  # degenerate
              (np.zeros(3), np.array([1.0, 2.0, 0.0]))]  # level view: cam_z[2] == 0
    for cam_T, body_T in cases:
        R = snapshots.look_at_body(cam_T, body_T)
        np.testing.assert_array_equal(R, j_snap.look_at_body(cam_T, body_T))
        assert np.all(np.isfinite(R))


@pytest.mark.parametrize("max_cams", [4, 1000])
def test_get_new_cams_equal_in_bits_from_the_same_seed(max_cams):
    """The same draws in the same order: one scalar jitter a candidate, then
    the subsample beyond max_cams; the generators end in the same state."""
    lo, hi = np.array([-3.0, -3.5, 0.0], np.float32), np.array([3.2, 3.0, 3.0], np.float32)
    planes = snapshots.room_box_planes(lo, hi)
    for body_T in (np.array([0.0, 0.0, 1.0]), np.array([1.0, -0.5, 0.8])):
        r1, r2 = np.random.default_rng(5), np.random.default_rng(5)
        ours = snapshots.get_new_cams(planes, lo, hi, body_T, rng=r1, max_cams=max_cams)
        theirs = j_snap.get_new_cams(planes, lo, hi, body_T, rng=r2, max_cams=max_cams)
        assert len(ours) == len(theirs) > 0
        assert len(ours) == max_cams if max_cams < 10 else len(ours) > 10
        for a, b in zip(ours, theirs):
            np.testing.assert_array_equal(a, b)
        assert r1.standard_normal() == r2.standard_normal()


def test_is_body_occluded_equal_on_a_grid_of_cases():
    rng = np.random.default_rng(3)
    cam = _cam_int(f=100.0, h=64, w=64)
    maps = [np.full((64, 64), 10.0, np.float32), np.full((64, 64), 1.0, np.float32), np.zeros((64, 64), np.float32),
            rng.uniform(0.5, 6.0, (64, 64)).astype(np.float32) * (rng.uniform(size=(64, 64)) > 0.5)]
    seen = set()
    for depth in maps:
        for x in np.linspace(-1.5, 1.5, 7):
            for z in (-1.0, 0.0, 0.5, 3.0, 8.0):
                T = np.array([[x, 0.3 * x, z]])
                ours = snapshots.is_body_occluded(T, cam, depth)
                assert ours == j_snap.is_body_occluded(T, cam, depth)
                seen.add(ours)
    assert seen == {True, False}


# ---- the body's re-expression


def test_pelvis_offset_and_update_globalRT_match_psi_tpu(bodies):
    _pelvis_matches(bodies)


def test_pelvis_offset_and_update_globalRT_match_psi_tpu_high_lbs(bodies, split_lbs):
    _pelvis_matches(bodies)


def _pelvis_matches(bodies):
    jsm, jvp, sm, vp = bodies
    rng = np.random.default_rng(4)
    for latent in (True, False):
        params = _body_params(rng, latent)
        d_ours = snapshots.pelvis_offset(sm, vp, params)
        d_theirs = j_snap.pelvis_offset(jsm, jvp, params)
        assert d_ours.dtype == d_theirs.dtype == np.float32
        np.testing.assert_allclose(d_ours, d_theirs, atol=BODY_TOL, rtol=0)
        trans = []
        for _ in range(4):
            t = np.eye(4)
            q = np.linalg.qr(rng.normal(size=(3, 3)))[0]
            t[:3, :3] = q * np.sign(np.linalg.det(q))  # a rotation
            t[:3, 3] = rng.normal(size=3)
            trans.append(t)
        ours, d1 = snapshots.update_globalRT_for_smplx(params, trans, sm, vp)
        theirs, d2 = j_snap.update_globalRT_for_smplx(params, trans, jsm, jvp)
        np.testing.assert_allclose(d1, d2, atol=BODY_TOL, rtol=0)
        for a, b in zip(ours, theirs):
            assert set(a) == set(b)
            for k in ("global_orient", "transl"):
                assert a[k].dtype == np.asarray(b[k]).dtype, k  # f32 rotations, f64 translations
                np.testing.assert_allclose(a[k], np.asarray(b[k]), atol=BODY_TOL, rtol=0, err_msg=k)
        # a given delta_T is used as it is, in both
        ours, _ = snapshots.update_globalRT_for_smplx(params, trans[:1], delta_T=d2)
        theirs, _ = j_snap.update_globalRT_for_smplx(params, trans[:1], delta_T=d2)
        np.testing.assert_allclose(ours[0]["transl"], theirs[0]["transl"], atol=BODY_TOL, rtol=0)


# ---- rendering


def _assert_snapshots_agree(ours, theirs):
    """Raw maps equal in >= 99.9% of pixels. Each canvas within 1e-6 of
    psi_tpu's preprocessing of the same raw map, and of psi_tpu's own canvas
    within 1e-6 plus what the raw pixels that differ carry through: a raw
    value moved by d moves the canvas by at most 2 d / max (the scaling to
    [-1, 1], then a resize that is a convex combination)."""
    assert set(ours) == set(theirs)
    for raw, k in (("depth_raw", "depth"), ("seg_raw", "seg")):
        theirs_raw = np.asarray(theirs[raw])
        assert np.mean(ours[raw] == theirs_raw) >= EQUAL_SHARE, raw
        canvas, _, top = j_data_preprocessing(ours[raw], k)
        np.testing.assert_allclose(ours[k], np.asarray(canvas), atol=CANVAS_TOL, rtol=0, err_msg=k)
        carried = 2 * np.abs(ours[raw] - theirs_raw).max() / top
        np.testing.assert_allclose(ours[k], theirs[k], atol=CANVAS_TOL + carried, rtol=0, err_msg=k)
    assert ours["max_d"] == theirs["max_d"] and ours["max_d"].dtype == np.float32
    np.testing.assert_array_equal(ours["cam_ext"], theirs["cam_ext"])
    np.testing.assert_array_equal(ours["cam_int"], theirs["cam_int"])


def _plane_room_mesh(n=8):
    """A floor and one back wall, triangulated, labelled per vertex."""
    xs = np.linspace(-3, 3, n)
    floor = np.stack(np.meshgrid(xs, xs, [0.0]), -1).reshape(-1, 3)
    wall = np.stack(np.meshgrid(xs, [3.0], np.linspace(0, 3, n)), -1).reshape(-1, 3)
    faces = []
    for off in (0, n * n):
        for i in range(n - 1):
            for j in range(n - 1):
                a = off + i * n + j
                faces += [[a, a + 1, a + n], [a + 1, a + n + 1, a + n]]
    verts = np.concatenate([floor, wall]).astype(np.float32)
    labels = np.concatenate([np.full(n * n, 2), np.full(n * n, 1)]).astype(np.int32)
    return verts, np.asarray(faces, np.int32), labels


@pytest.mark.parametrize("mesh", [False, True])
def test_render_scene_snapshot_matches_psi_tpu(mesh):
    rng = np.random.default_rng(6)
    if mesh:
        verts, faces, labels = _plane_room_mesh()
    else:
        (verts, labels), faces = _room(rng), None
    planes = snapshots.room_box_planes(verts.min(0), verts.max(0))
    cams = snapshots.get_new_cams(planes, verts.min(0), verts.max(0), np.array([0.0, 0.5, 1.0]),
                                  rng=np.random.default_rng(0), max_cams=3)
    assert cams
    for cam2world in cams:
        ours = snapshots.render_scene_snapshot(verts, labels, cam2world, _cam_int(), *HW, scene_faces=faces,
                                               device="cpu")
        theirs = j_snap.render_scene_snapshot(verts, labels, cam2world, _cam_int(), *HW, scene_faces=faces)
        _assert_snapshots_agree(ours, theirs)
        assert np.any(ours["depth_raw"] > 0) and ours["depth"].shape == (128, 128)
    # the scene handed over as tensors already on the device gives the same snapshot
    again = snapshots.render_scene_snapshot(torch.from_numpy(verts), torch.from_numpy(labels), cams[0], _cam_int(),
                                            *HW, scene_faces=None if faces is None else torch.from_numpy(faces),
                                            device="cpu")
    first = snapshots.render_scene_snapshot(verts, labels, cams[0], _cam_int(), *HW, scene_faces=faces,
                                            device="cpu")
    for k in first:
        np.testing.assert_array_equal(again[k], first[k])


def test_snapshot_with_faces_is_hole_free_as_psi_tpus():
    """tests/test_rasterize.py's snapshot case: a coarse plane at z=4 through
    render_scene_snapshot with scene_faces, hole-free, equal to psi_tpu's."""
    n = 6
    xs = np.linspace(-3, 3, n)
    verts = np.stack(np.meshgrid(xs, xs, [4.0]), -1).reshape(-1, 3)
    faces = np.asarray([f for i in range(n - 1) for j in range(n - 1)
                        for f in ([i * n + j, i * n + j + 1, i * n + j + n],
                                  [i * n + j + 1, i * n + j + n + 1, i * n + j + n])], np.int32)
    labels = np.full(len(verts), 2, np.int32)
    cam_int = np.array([[100, 0, 60], [0, 100, 40], [0, 0, 1]], np.float32)
    ours = snapshots.render_scene_snapshot(verts, labels, np.eye(4), cam_int, height=80, width=120,
                                           scene_faces=faces, device="cpu")
    theirs = j_snap.render_scene_snapshot(verts, labels, np.eye(4), cam_int, height=80, width=120, scene_faces=faces)
    _assert_snapshots_agree(ours, theirs)
    np.testing.assert_array_equal(ours["depth_raw"], np.asarray(theirs["depth_raw"]))
    assert (ours["depth_raw"] > 0).all()
    np.testing.assert_allclose(ours["depth_raw"], 4.0, atol=5e-3)


def test_rendering_needs_a_card_unless_told_otherwise(bodies, monkeypatch):
    _, _, sm, vp = bodies
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    verts, labels = _room(np.random.default_rng(0), 4, 10)
    with pytest.raises(RuntimeError, match="NVIDIA card"):
        snapshots.render_scene_snapshot(verts, labels, np.eye(4), _cam_int(), *HW)
    writer = RecordingWriter()
    with pytest.raises(RuntimeError, match="NVIDIA card"):
        snapshots.produce_virtualcam_snapshots(verts, labels, [], sm, vp, writer, 0)
    assert not writer.rows


def _produce(pkg, bodies_pair, verts, labels, params_list, **kw):
    writer = RecordingWriter()
    sm, vp = bodies_pair
    extra = {"device": "cpu"} if pkg is snapshots else {}
    n = pkg.produce_virtualcam_snapshots(verts, labels, params_list, sm, vp, writer, sceneid=3,
                                         render_hw=HW, **kw, **extra)
    assert n == len(writer.rows)
    return writer.rows


def _assert_rows_agree(ours, theirs):
    assert len(ours) == len(theirs) > 0
    for a, b in zip(ours, theirs):
        depth, seg, body72, cam_ext, cam_int, max_d, sceneid = a
        np.testing.assert_allclose(depth, b[0], atol=CANVAS_TOL, rtol=0)
        np.testing.assert_allclose(seg, b[1], atol=CANVAS_TOL, rtol=0)
        assert body72.shape == (72,) and body72.dtype == np.float32
        np.testing.assert_allclose(body72, np.asarray(b[2]), atol=BODY_TOL, rtol=0)
        np.testing.assert_array_equal(cam_ext, b[3])  # the same camera, in bits
        np.testing.assert_array_equal(cam_int, b[4])
        assert max_d == b[5] and sceneid == b[6] == 3


def test_produce_virtualcam_snapshots_matches_psi_tpu(bodies):
    """Three frames (the later ones reuse the first frame's delta_T in both
    packages), the default intrinsics, up to 5 cameras a frame: the same rows
    in the same order."""
    _produce_matches(bodies)


def test_produce_virtualcam_snapshots_matches_psi_tpu_high_lbs(bodies, split_lbs):
    _produce_matches(bodies)


def _produce_matches(bodies):
    jsm, jvp, sm, vp = bodies
    rng = np.random.default_rng(7)
    verts, labels = _room(rng)
    params_list = [_body_params(rng) for _ in range(3)]
    ours = _produce(snapshots, (sm, vp), verts, labels, params_list, max_cams_per_frame=5, seed=2)
    theirs = _produce(j_snap, (jsm, jvp), verts, labels, params_list, max_cams_per_frame=5, seed=2)
    _assert_rows_agree(ours, theirs)
    assert len({r[3].tobytes() for r in ours}) == len(ours) > 3  # distinct cameras, more than one frame's


def test_virtual_camera_rows_store_world_to_camera_as_psi_tpu_does(bodies, tmp_path):
    """Known reference behaviour, held in both packages: a virtual-camera
    row's body is in the camera frame and its cam_ext is world->camera, so
    the stored cam_ext maps the decoded body to the world-frame body only when
    inverted; load_test_snapshot's cam_ext (camera->world) maps directly, as
    the fit's verts_transform(verts, cam_ext) expects."""
    import scipy.io

    jsm, jvp, sm, vp = bodies
    rng = np.random.default_rng(8)
    verts, labels = _room(rng)
    params = _body_params(rng)
    ours = _produce(snapshots, (sm, vp), verts, labels, [params], max_cams_per_frame=2, seed=1)
    theirs = _produce(j_snap, (jsm, jvp), verts, labels, [params], max_cams_per_frame=2, seed=1)
    _assert_rows_agree(ours, theirs)

    @torch.no_grad()
    def decode(x72, ext):
        x = torch.as_tensor(np.asarray(x72, np.float32)).reshape(1, 72)
        return body_vec_to_verts(sm, vp, x, torch.as_tensor(np.asarray(ext, np.float32)).reshape(1, 4, 4))[0][0]

    world = decode(body_params_parse(params).numpy(), np.eye(4))
    scale = world.abs().max().item()
    for body72, cam_ext in ((r[2], r[3]) for r in ours):
        np.testing.assert_allclose(decode(body72, np.linalg.inv(cam_ext)).numpy(), world.numpy(), atol=1e-4)
        assert (decode(body72, cam_ext) - world).abs().max().item() > 0.1 * scale

    # the same body seen by a real camera whose .mat extrinsic is that
    # world->camera matrix: load_test_snapshot stores its inverse
    E = ours[0][3].astype(np.float64)
    cam_params, _ = snapshots.update_globalRT_for_smplx(params, [E], sm, vp)
    body = {k: np.asarray(v, np.float32).reshape(1, -1) for k, v in cam_params[0].items()}
    mat = str(tmp_path / "rec_000000.mat")
    scipy.io.savemat(mat, {"depth": np.full((60, 80), 3.0, np.float32), "seg": np.ones((60, 80), np.float32),
                           "cam": {"intrinsic": _cam_int(h=60, w=80).astype(np.float64), "extrinsic": E},
                           "body": body})
    d, jd = load_test_snapshot(mat), j_load_test_snapshot(mat)
    np.testing.assert_array_equal(d["cam_ext"], jd["cam_ext"])
    np.testing.assert_array_equal(d["xh"], jd["xh"])
    cam_frame = decode(d["xh"][0], np.eye(4))
    mapped = verts_transform(cam_frame[None], torch.from_numpy(d["cam_ext"]))[0]
    np.testing.assert_allclose(mapped.numpy(), world.numpy(), atol=1e-4)
    np.testing.assert_allclose(decode(d["xh"][0], d["cam_ext"][0]).numpy(), world.numpy(), atol=1e-4)


# ---- HDF5 packing


def _write_rows(writer_cls, path, rows):
    w = writer_cls(path)
    for r in rows:
        w.append(*r)
    w.close()


def _random_rows(rng, n):
    return [(rng.uniform(-1, 1, (128, 128)).astype(np.float32), rng.uniform(-1, 1, (128, 128)).astype(np.float32),
             rng.normal(0, 0.3, 72).astype(np.float32), rng.normal(size=(4, 4)).astype(np.float32),
             _cam_int(), np.float32(rng.uniform(4, 6)), int(rng.integers(0, 12))) for _ in range(n)]


def _layout(path):
    import h5py

    with h5py.File(path, "r") as f:
        return {k: (f[k].shape, f[k].maxshape, f[k].dtype, f[k].chunks, np.asarray(f[k][:])) for k in f}


def test_hdf5_files_cross_between_the_packages(tmp_path):
    """The port's file and psi_tpu's, from the same rows: the same layout
    (keys, shapes, float32, chunked and resizable, row 0 zero) and values; each
    package's BatchGeneratorWithSceneMesh reads the other's file alike."""
    pytest.importorskip("h5py")
    from psi_tpu.data.hdf5 import BatchGeneratorWithSceneMesh as JGen
    from psi_tpu.data.hdf5 import PROX_SCENES
    from psi_tpu.data.scenes import synthetic_scene_registry as j_registry
    from psi_tpu_torch.data.hdf5 import BatchGeneratorWithSceneMesh
    from psi_tpu_torch.data.scenes import synthetic_scene_registry

    rows = _random_rows(np.random.default_rng(9), 7)
    ours, theirs = str(tmp_path / "ours.hdf5"), str(tmp_path / "theirs.hdf5")
    _write_rows(snapshots.SnapshotHDF5Writer, ours, rows)
    _write_rows(j_snap.SnapshotHDF5Writer, theirs, rows)
    a, b = _layout(ours), _layout(theirs)
    assert list(a) == list(b) and set(a) == set(snapshots.SnapshotHDF5Writer.KEYS)
    for k in a:
        assert a[k][:4] == b[k][:4], k
        assert a[k][0][0] == 8 and a[k][1][0] is None and a[k][2] == np.float32
        np.testing.assert_array_equal(a[k][4], b[k][4])
        assert not np.any(a[k][4][0])  # the row-0 placeholder

    reg, jreg = synthetic_scene_registry(num_scenes=12, dim=8, num_verts=50), j_registry(12, 8, 50)
    reg.names, jreg.names = list(PROX_SCENES), list(PROX_SCENES)
    for path in (ours, theirs):
        g, jg = BatchGeneratorWithSceneMesh(path, mode="all", registry=reg), JGen(path, mode="all", registry=jreg)
        assert g.n_samples == jg.n_samples == 7 and g.index == jg.index
        x, y = g.next_batch(3), jg.next_batch(3)
        assert set(x) == set(y)
        for k in x:
            np.testing.assert_array_equal(x[k], np.asarray(y[k]), err_msg=k)


def test_matfiles_to_hdf5_packs_what_psi_tpu_packs(tmp_path):
    """.mat snapshots under scene folders (one file unreadable, one body
    behind the depth clamp): the same count and the same rows."""
    pytest.importorskip("h5py")
    rng = np.random.default_rng(10)
    names = ["MPH16", "N0Sofa", "Werkraum"]
    for i, name in enumerate(names):
        folder = tmp_path / "mats" / f"{name}_00"
        folder.mkdir(parents=True)
        for j in range(2):
            _write_mat(str(folder / f"{name}_{j:06d}.mat"), rng, (60, 80))
        if i == 1:
            (folder / "broken.mat").write_bytes(b"not a mat file")
    far = tmp_path / "mats" / "Werkraum_00" / "Werkraum_000009.mat"
    _, body = _write_mat(str(far), rng, (60, 80))
    import scipy.io

    data = scipy.io.loadmat(str(far))
    data["body"][0][0]["transl"][0, 2] = 50.0  # a bad fit: deeper than the clamped depth
    scipy.io.savemat(str(far), {k: v for k, v in data.items() if not k.startswith("__")})

    ours, theirs = str(tmp_path / "ours.hdf5"), str(tmp_path / "theirs.hdf5")
    n = snapshots.matfiles_to_hdf5(str(tmp_path / "mats"), ours, names)
    jn = j_snap.matfiles_to_hdf5(str(tmp_path / "mats"), theirs, names)
    assert n == jn == 6
    a, b = _layout(ours), _layout(theirs)
    for k in a:
        assert a[k][:4] == b[k][:4], k
        np.testing.assert_allclose(a[k][4], b[k][4], atol=CANVAS_TOL, rtol=0, err_msg=k)
    np.testing.assert_array_equal(a["sceneid"][4][1:], [0, 0, 1, 1, 2, 2])
