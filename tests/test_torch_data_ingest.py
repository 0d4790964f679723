"""The data ingest: psi_tpu_torch's resize, preprocessing, .mat / .npy
snapshot loaders and HDF5 batch generator, held to psi_tpu's on the same
files.

Fixtures are written here: HDF5 files as tests/test_data.py writes them,
Habitat cam_/depth_/seg_*.npy dumps as tests/test_habitat_realformat.py
writes them, and PROX-E .mat snapshots with scipy.io.savemat in the layout
``load_test_snapshot`` reads (raw depth and seg maps, the cam struct, a
fitted body).

Tolerances: ``resize_bilinear`` within 2e-7 of ``jax.image.resize`` (the
same half-pixel bilinear weights, products summed in another order; found
0 at 480x640 and 1080x1920, 1.2e-7 at the rest); the 128x128 canvases and
the batches' ``xs`` within 1e-6 (they are that resize of values in
[-1, 1]); every other array, index and count exactly equal.
"""

import os

import jax
import numpy as np
import pytest
import torch

from psi_tpu.data import hdf5 as j_hdf5
from psi_tpu.data import matfile as j_matfile
from psi_tpu.data.preprocessing import data_preprocessing as j_data_preprocessing
from psi_tpu.data.scenes import synthetic_scene_registry as j_synthetic_scene_registry
from psi_tpu.ops.resize import resize_bilinear as j_resize_bilinear
from psi_tpu_torch.data import hdf5, matfile
from psi_tpu_torch.data.preprocessing import data_preprocessing
from psi_tpu_torch.data.scenes import synthetic_scene_registry
from psi_tpu_torch.ops.resize import resize_bilinear

torch.set_num_threads(1)
RESIZE_TOL = 2e-7
CANVAS_TOL = 1e-6
# (in_h, in_w, out_h, out_w): the ratios data_preprocessing meets, down and up
RATIOS = [(480, 640, 96, 128), (1080, 1920, 72, 128), (424, 512, 104, 128), (256, 256, 128, 128),
          (64, 64, 128, 128)]


# ---- resize

@pytest.mark.parametrize("h,w,oh,ow", RATIOS)
def test_resize_matches_jax_image_resize(h, w, oh, ow):
    x = np.random.default_rng(h + w).uniform(-1, 1, (h, w)).astype(np.float32)
    ours = resize_bilinear(torch.from_numpy(x), oh, ow)
    theirs = np.asarray(j_resize_bilinear(x, oh, ow))
    assert ours.shape == (oh, ow) and ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), theirs, rtol=0, atol=RESIZE_TOL)


def test_resize_keeps_leading_axes():
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(2, 3, 40, 30)).astype(np.float32))
    out = resize_bilinear(x, 20, 16)
    assert out.shape == (2, 3, 20, 16)
    for i in range(2):
        for j in range(3):
            assert torch.equal(out[i, j], resize_bilinear(x[i, j], 20, 16))


# ---- data_preprocessing

@pytest.mark.parametrize("shape", [(240, 320), (320, 240), (128, 128), (424, 512), (1080, 1920)])
@pytest.mark.parametrize("modality", ["depth", "seg"])
def test_preprocessing_matches_psi_tpu(shape, modality):
    rng = np.random.default_rng(shape[0])
    img = rng.uniform(0, 8, size=shape) if modality == "depth" else rng.integers(0, 60, size=shape)
    canvas, factor, max_val = data_preprocessing(img.astype(np.float32), modality)
    j_canvas, j_factor, j_max_val = j_data_preprocessing(img.astype(np.float32), modality)
    assert type(canvas) is np.ndarray and canvas.dtype == np.float32 and canvas.shape == (128, 128)
    np.testing.assert_allclose(canvas, j_canvas, rtol=0, atol=CANVAS_TOL)
    assert factor == j_factor and max_val == j_max_val


def test_preprocessing_matches_the_reference_recipe():
    """tests/test_data.py's torch transcription of batch_gen_hdf5.py:359-441."""
    import torch.nn.functional as tF

    rng = np.random.default_rng(0)
    for shape in [(240, 320), (320, 240), (128, 128)]:
        img = rng.uniform(0, 8, size=shape).astype(np.float32)
        canvas, _, max_val = data_preprocessing(img, "depth")
        t = torch.tensor(img)
        t[t > 6.0] = 6.0
        mv = torch.max(t)
        ts = 2 * t / mv - 1.0
        h, w = shape
        ref = torch.zeros(128, 128)
        if h >= w:
            tw = int(w * (128.0 / h)) // 2 * 2
            ref[:, 64 - tw // 2: 64 - tw // 2 + tw] = tF.interpolate(
                ts.view(1, 1, h, w), size=[128, tw], mode="bilinear", align_corners=False)[0, 0]
        else:
            th = int(h * (128.0 / w)) // 2 * 2
            ref[64 - th // 2: 64 - th // 2 + th, :] = tF.interpolate(
                ts.view(1, 1, h, w), size=[th, 128], mode="bilinear", align_corners=False)[0, 0]
        np.testing.assert_allclose(canvas, ref.numpy(), atol=1e-5)
        assert max_val == float(mv)


def test_clamps_even_width_and_centred_canvas():
    seg = np.array([[50.0, 10.0], [41.0, 80.0]], np.float32)
    assert data_preprocessing(seg, "seg", target_domain_size=[4, 4])[2] == 41.0
    depth = np.full((6, 5), 9.0, np.float32)
    depth[0, 0] = 1.0
    canvas, factor, max_val = data_preprocessing(depth, "depth", target_domain_size=(12, 12))
    assert max_val == 6.0 and factor == 2.0
    # width 5 * 2 = 10, already even: columns 1..10 hold the image, 0 and 11 the zero canvas
    assert (canvas[:, 0] == 0).all() and (canvas[:, 11] == 0).all() and (canvas[:, 1:11] != 0).any()
    # an odd scaled width rounds down to even: 7 * (12 / 9) = 9.33 -> 8 columns, centred at 2..9
    canvas, _, _ = data_preprocessing(np.ones((9, 7), np.float32) * 3.0, "depth", target_domain_size=(12, 12))
    assert (canvas[:, :2] == 0).all() and (canvas[:, 10:] == 0).all() and (canvas[:, 2:10] == 1.0).all()


# ---- the scene split and the registry (C2)

def test_scene_split_constants_are_psi_tpus():
    assert hdf5.PROX_SCENES == j_hdf5.PROX_SCENES and len(hdf5.PROX_SCENES) == 12
    assert hdf5.PROX_TRAIN_SCENES == j_hdf5.PROX_TRAIN_SCENES
    assert hdf5.PROX_TEST_SCENES == j_hdf5.PROX_TEST_SCENES
    assert set(hdf5.PROX_TRAIN_SCENES) | set(hdf5.PROX_TEST_SCENES) == set(hdf5.PROX_SCENES)
    assert not set(hdf5.PROX_TRAIN_SCENES) & set(hdf5.PROX_TEST_SCENES)


def test_registry_index_of_is_psi_tpus():
    reg = synthetic_scene_registry(num_scenes=3, dim=8, num_verts=20, seed=2)
    j_reg = j_synthetic_scene_registry(num_scenes=3, dim=8, num_verts=20, seed=2)
    assert reg.names == j_reg.names
    for name in reg.names:
        assert reg.index_of(name) == j_reg.index_of(name)
    assert [reg.index_of(n) for n in reg.names] == [0, 1, 2]
    for r in (reg, j_reg):
        with pytest.raises(ValueError):
            r.index_of("NoSuchScene")


# ---- HDF5

def _write_hdf5(path, scene_ids, rng, bad_row=None):
    """tests/test_data.py's file: row 0 a placeholder, sceneid as f64."""
    import h5py

    n = len(scene_ids)
    with h5py.File(path, "w") as f:
        f["depth"] = rng.uniform(-1, 1, size=(n + 1, 1, 128, 128)).astype(np.float32)
        f["seg"] = rng.uniform(-1, 1, size=(n + 1, 1, 128, 128)).astype(np.float32)
        body = rng.normal(size=(n + 1, 1, 72)).astype(np.float32)
        body[:, :, 2] = 3.0
        if bad_row is not None:
            body[bad_row + 1, 0, 2] = 50.0  # |z| beyond every max depth: a bad PROX fit
        f["body"] = body
        cam_ext = np.tile(np.eye(4, dtype=np.float32), (n + 1, 1, 1, 1))
        cam_ext[:, 0, :3, 3] = rng.normal(size=(n + 1, 3))
        f["cam_ext"] = cam_ext
        f["cam_int"] = np.tile(np.eye(3, dtype=np.float32), (n + 1, 1, 1, 1))
        f["max_d"] = rng.uniform(4.0, 6.0, size=(n + 1, 1)).astype(np.float32)
        f["sceneid"] = np.concatenate([[0], scene_ids]).astype(np.float64).reshape(-1, 1)


@pytest.fixture(scope="module")
def h5_file(tmp_path_factory):
    pytest.importorskip("h5py")
    path = str(tmp_path_factory.mktemp("h5") / "virtualcams.hdf5")
    # train scenes 0 (BasementSittingBooth), 2 (MPH8), 11 (Werkraum); test scene 4 (MPH16)
    _write_hdf5(path, np.array([0, 4, 2, 11] * 6), np.random.default_rng(7))
    return path


def _registries(names):
    """psi_tpu's and the port's registry of 4 scenes, rows named ``names``."""
    out = []
    for make in (synthetic_scene_registry, j_synthetic_scene_registry):
        reg = make(num_scenes=len(names), dim=8, num_verts=50)
        reg.names = list(names)
        out.append(reg)
    return out


def _assert_batches_equal(ours, theirs):
    assert (ours is None) == (theirs is None)
    if ours is None:
        return
    assert list(ours) == list(theirs)
    for k in ours:
        assert type(ours[k]) is np.ndarray and ours[k].dtype == theirs[k].dtype and ours[k].shape == theirs[k].shape, k
        if k == "xs":
            np.testing.assert_allclose(ours[k], theirs[k], rtol=0, atol=CANVAS_TOL)
        else:
            np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)


def test_load_streams_skips_row_0_as_psi_tpu_does(h5_file):
    ours, theirs = hdf5._load_streams([h5_file, h5_file]), j_hdf5._load_streams([h5_file, h5_file])
    assert list(ours) == list(theirs)
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
    assert ours["sceneid"].shape[0] == 48


@pytest.mark.parametrize("mode,n_samples", [("train", 18), ("test", 6), ("all", 24)])
def test_hdf5_batches_equal_psi_tpus(h5_file, mode, n_samples):
    # MPH8 is absent from this registry: its rows carry scene_idx -1
    reg, j_reg = _registries(["Werkraum", "MPH16", "BasementSittingBooth", "N0Sofa"])
    gen = hdf5.BatchGeneratorWithSceneMesh(h5_file, mode=mode, registry=reg, seed=3)
    j_gen = j_hdf5.BatchGeneratorWithSceneMesh(h5_file, mode=mode, registry=j_reg, seed=3)
    assert gen.n_samples == j_gen.n_samples == n_samples and gen.index == j_gen.index
    seen = set()
    for epoch in range(2):
        while j_gen.has_next_batch():
            assert gen.has_next_batch()
            b, jb = gen.next_batch(4), j_gen.next_batch(4)
            _assert_batches_equal(b, jb)
            if b is not None:
                assert b["xs"].shape == (4, 128, 128, 2) and b["xh"].shape == (4, 72)
                seen.update(b["scene_idx"].tolist())
        assert not gen.has_next_batch()
        gen.reset()
        j_gen.reset()
        assert gen.index == j_gen.index
    want = {"train": {2, 0, -1}, "test": {1}, "all": {2, 1, 0, -1}}[mode]
    assert seen == want


def test_hdf5_batch_rows_are_sorted_and_bad_fits_rejected(tmp_path):
    pytest.importorskip("h5py")
    path = str(tmp_path / "realcams.hdf5")
    _write_hdf5(path, np.zeros(8, np.int64), np.random.default_rng(1), bad_row=5)
    reg, j_reg = _registries(hdf5.PROX_SCENES)
    gen = hdf5.BatchGeneratorWithSceneMesh(path, mode="train", registry=reg, seed=0)
    j_gen = j_hdf5.BatchGeneratorWithSceneMesh(path, mode="train", registry=j_reg, seed=0)
    streams = hdf5._load_streams(path)
    rejected = 0
    while gen.has_next_batch():
        rows = sorted(gen.index[gen.index_rec:gen.index_rec + 4])
        b, jb = gen.next_batch(4), j_gen.next_batch(4)
        _assert_batches_equal(b, jb)
        if b is None:
            rejected += 1
            assert 5 in rows
        else:
            np.testing.assert_array_equal(b["xh"], streams["body"][rows].reshape(4, 72))
    assert rejected == 1


def test_hdf5_generator_needs_a_registry_or_paths(h5_file):
    with pytest.raises(ValueError):
        hdf5.BatchGeneratorWithSceneMesh(h5_file, mode="val", registry=_registries(hdf5.PROX_SCENES)[0])
    with pytest.raises(AssertionError):
        hdf5.BatchGeneratorWithSceneMesh(h5_file, mode="train")


# ---- PROX-E .mat snapshots

def _write_mat(path, rng, shape=(424, 512), nan=False):
    import scipy.io

    h, w = shape
    depth = rng.uniform(0.5, 8.0, (h, w)).astype(np.float32)
    if nan:
        depth[3, 3] = np.nan
    ext = np.eye(4)
    ext[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    ext[:3, 3] = rng.uniform(-2, 2, 3)
    body = {k: rng.normal(0, 0.3, (1, n)).astype(np.float32) for k, n in (
        ("transl", 3), ("global_orient", 3), ("betas", 10), ("body_pose", 32),
        ("left_hand_pose", 12), ("right_hand_pose", 12))}
    scipy.io.savemat(path, {
        "depth": depth, "seg": rng.integers(0, 60, (h, w)).astype(np.float32),
        "cam": {"intrinsic": np.array([[500.0, 0, w / 2], [0, 500.0, h / 2], [0, 0, 1]]), "extrinsic": ext},
        "body": body})
    return ext, body


@pytest.mark.parametrize("shape", [(424, 512), (1080, 1920), (480, 360)])
def test_load_test_snapshot_equals_psi_tpus(tmp_path, shape):
    path = str(tmp_path / "rec_000000.mat")
    ext, body = _write_mat(path, np.random.default_rng(shape[1]), shape)
    ours, theirs = matfile.load_test_snapshot(path), j_matfile.load_test_snapshot(path)
    _assert_batches_equal(ours, theirs)
    assert ours["xs"].shape == (1, 128, 128, 2) and ours["xh"].shape == (1, 72)
    # the extrinsic's inverse, taken in f64, then f32; the body in the reference's order
    np.testing.assert_array_equal(ours["cam_ext"][0], np.linalg.inv(ext).astype(np.float32))
    np.testing.assert_array_equal(ours["xh"][0, :3], body["transl"][0])
    np.testing.assert_array_equal(ours["xh"][0, -12:], body["right_hand_pose"][0])
    assert ours["max_d"][0] == 6.0  # the depth clamp


def test_batch_generator_test_equals_psi_tpus(tmp_path):
    rng = np.random.default_rng(4)
    for i in range(5):
        _write_mat(str(tmp_path / f"rec_{i:06d}.mat"), rng, (120, 160), nan=(i == 3))
    gen, j_gen = matfile.BatchGeneratorTest(str(tmp_path), seed=2), j_matfile.BatchGeneratorTest(str(tmp_path), seed=2)
    assert gen.rec_list == j_gen.rec_list and len(gen.rec_list) == 5
    for _ in range(2):
        nones = 0
        while j_gen.has_next_batch():
            b, jb = gen.next_batch(2), j_gen.next_batch(2)
            _assert_batches_equal(b, jb)
            nones += b is None
        assert not gen.has_next_batch() and nones >= 1  # the NaN snapshot's batch, and a short tail
        gen.reset()
        j_gen.reset()
        assert gen.rec_list == j_gen.rec_list


# ---- Habitat .npy dumps

H, W = 240, 320


def _write_room(room_dir, n_cams=2, seed=0, bare=()):
    """tests/test_habitat_realformat.py's dumps; cameras in ``bare`` get a bare 4x4 matrix."""
    rng = np.random.RandomState(seed)
    os.makedirs(room_dir, exist_ok=True)
    for i in range(n_cams):
        depth = rng.uniform(0.5, 8.0, size=(H, W)).astype(np.float32)
        seg = rng.randint(0, 42, size=(H, W)).astype(np.int32)
        theta = rng.uniform(0, 2 * np.pi)
        c, s = np.cos(theta), np.sin(theta)
        cam_ext = np.eye(4, dtype=np.float32)
        cam_ext[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
        cam_ext[:3, 3] = rng.uniform(-2, 2, size=3).astype(np.float32)
        f = max(H, W) / 2.0
        cam_int = np.array([[f, 0, W / 2.0], [0, f, H / 2.0], [0, 0, 1.0]], np.float32)
        np.save(os.path.join(room_dir, f"depth_{i}.npy"), depth)
        np.save(os.path.join(room_dir, f"seg_{i}.npy"), seg)
        np.save(os.path.join(room_dir, f"cam_{i}.npy"), cam_ext if i in bare else {"cam_ext": cam_ext, "cam_int": cam_int})


@pytest.mark.parametrize("cam_id", [0, 1])
def test_load_habitat_snapshot_equals_psi_tpus(tmp_path, cam_id):
    _write_room(str(tmp_path), n_cams=2, seed=3, bare=(1,))
    ours, theirs = matfile.load_habitat_snapshot(str(tmp_path), cam_id), j_matfile.load_habitat_snapshot(str(tmp_path), cam_id)
    _assert_batches_equal(ours, theirs)
    assert ours["xs"].shape == (1, 128, 128, 2) and ours["max_d"][0] == 6.0
    if cam_id == 0:  # the pickled dict's own intrinsics
        params = np.load(str(tmp_path / "cam_0.npy"), allow_pickle=True, encoding="latin1").item()
        np.testing.assert_array_equal(ours["cam_int"][0], params["cam_int"])
        np.testing.assert_array_equal(ours["cam_ext"][0], params["cam_ext"])
    else:  # a bare 4x4: the synthesized 90-degree pinhole
        np.testing.assert_array_equal(ours["cam_int"][0], [[160, 0, 160], [0, 160, 120], [0, 0, 1]])


def test_habitat_seg_map_goes_through_modality_depth(tmp_path):
    """The reference quirk (test_habitat_s1.py:181-184): the seg map is
    preprocessed as depth, so labels clamp at 6, not 41."""
    _write_room(str(tmp_path), n_cams=1, seed=5)
    batch = matfile.load_habitat_snapshot(str(tmp_path), 0)
    seg_raw = np.load(str(tmp_path / "seg_0.npy")).astype(np.float32)
    np.testing.assert_array_equal(batch["xs"][0, :, :, 1], data_preprocessing(seg_raw, "depth")[0])
    assert not np.allclose(batch["xs"][0, :, :, 1], data_preprocessing(seg_raw, "seg")[0])


def test_habitat_t_mat_is_psi_tpus():
    np.testing.assert_array_equal(matfile.HABITAT_T_MAT, j_matfile.HABITAT_T_MAT)
    assert matfile.HABITAT_T_MAT.dtype == np.float32
    p = np.array([0.5, 0.2, -2.0, 1.0], np.float32)
    np.testing.assert_array_equal(matfile.HABITAT_T_MAT @ p, np.array([0.5, -0.2, 2.0, 1.0], np.float32))


def test_ingest_runs_without_jax_arrays():
    """The port's ingest hands back numpy, never a jax array."""
    canvas, _, _ = data_preprocessing(np.ones((10, 20), np.float32), "depth")
    assert type(canvas) is np.ndarray and not isinstance(canvas, jax.Array)
