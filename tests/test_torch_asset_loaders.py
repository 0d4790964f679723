"""The asset loaders behind build_assets: psi_tpu_torch's against psi_tpu's
on the same files.

No PROX, SMPL-X or VPoser file is in the repository, so the files are
synthetic ones written in the real layouts, as tests/test_real_npz_format.py
and tests/test_data.py write them: a SMPLX_NEUTRAL.npz with the 400-wide
shapedirs, the uint32(-1) root in kintree_table and 45 hand components; two
scenes_downsampled/*.ply (one binary, one ascii, with different vertex counts
and SDF dims) with scenes_sdf/{scene}.json and {scene}_sdf.npy;
body_segments/{part}.json; a VPoser directory with two snapshots/*.pt state
dicts under the reference's key names (the older one holds other weights).

Tolerances: every array that a loader copies, slices, transposes or casts
is held exactly; the decoded pose (a 512-wide MLP, 6D -> matrices ->
axis-angle, f32 sums in another order) to 1e-5 absolute on angles of order 1.
"""

import argparse
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from psi_tpu.body.smplx_model import load_smplx_npz as j_load_smplx_npz
from psi_tpu.body.vposer import vposer_decode as j_vposer_decode
from psi_tpu.cli.common import build_assets as j_build_assets
from psi_tpu.data.hdf5 import PROX_SCENES as J_PROX_SCENES
from psi_tpu.data.plyio import read_ply as j_read_ply
from psi_tpu.data.scenes import load_scene_registry as j_load_scene_registry
from psi_tpu.geometry.contact import DEFAULT_CONTACT_PARTS as J_PARTS
from psi_tpu.geometry.contact import get_contact_ids as j_get_contact_ids
from psi_tpu.utils.convert_torch import load_vposer_params as j_load_vposer_params
from psi_tpu_torch.body.smplx_model import SMPLX_FIELDS, load_smplx_npz, smplx_forward
from psi_tpu_torch.body.vposer import VPoser, vposer_decode
from psi_tpu_torch.cli.common import build_assets
from psi_tpu_torch.data import hdf5
from psi_tpu_torch.data.plyio import read_ply
from psi_tpu_torch.data.scenes import load_scene_registry
from psi_tpu_torch.geometry.contact import DEFAULT_CONTACT_PARTS, get_contact_ids
from psi_tpu_torch.utils.convert_torch import load_vposer, vposer_from_state_dict

torch.set_num_threads(1)
V, J = 150, 55
SCENES = ("SceneBinary", "SceneAscii")
POSE_ATOL = 1e-5


class RefVPoser(nn.Module):
    """The reference VPoser's parameters under its own names (vposer_smpl.py)."""

    def __init__(self, nf=63, nn_=512, latentD=32):
        super().__init__()
        self.bodyprior_enc_bn1 = nn.BatchNorm1d(nf)
        self.bodyprior_enc_fc1 = nn.Linear(nf, nn_)
        self.bodyprior_enc_bn2 = nn.BatchNorm1d(nn_)
        self.bodyprior_enc_fc2 = nn.Linear(nn_, nn_)
        self.bodyprior_enc_mu = nn.Linear(nn_, latentD)
        self.bodyprior_enc_logvar = nn.Linear(nn_, latentD)
        self.bodyprior_dec_fc1 = nn.Linear(latentD, nn_)
        self.bodyprior_dec_fc2 = nn.Linear(nn_, nn_)
        self.bodyprior_dec_out = nn.Linear(nn_, 21 * 6)


def _ref_vposer(seed):
    torch.manual_seed(seed)
    m = RefVPoser()
    with torch.no_grad():
        for bn in (m.bodyprior_enc_bn1, m.bodyprior_enc_bn2):
            bn.running_mean.normal_(0, 0.3)
            bn.running_var.uniform_(0.5, 2.0)
    return m


def _write_smplx(path, rng):
    kintree = np.zeros((2, J), np.uint32)
    kintree[0, 0] = np.uint32(2**32 - 1)  # root parent = -1 as uint32
    for j in range(1, J):
        kintree[0, j] = rng.integers(0, j)
    kintree[1] = np.arange(J)
    np.savez(
        path,
        v_template=rng.normal(0, 0.3, (V, 3)).astype(np.float64),
        shapedirs=rng.normal(0, 0.01, (V, 3, 400)).astype(np.float64),
        posedirs=rng.normal(0, 1e-3, (V, 3, (J - 1) * 9)).astype(np.float64),
        J_regressor=np.abs(rng.normal(0, 1, (J, V))).astype(np.float64),
        kintree_table=kintree.astype(np.int64),
        weights=np.abs(rng.normal(0, 1, (V, J))).astype(np.float64),
        hands_componentsl=rng.normal(0, 0.1, (45, 45)).astype(np.float64),
        hands_componentsr=rng.normal(0, 0.1, (45, 45)).astype(np.float64),
        hands_meanl=rng.normal(0, 0.05, 45).astype(np.float64),
        hands_meanr=rng.normal(0, 0.05, 45).astype(np.float64),
        f=rng.integers(0, V, (200, 3)).astype(np.int64),
    )


def _write_ply(path, verts, faces, binary):
    fmt = "binary_little_endian" if binary else "ascii"
    header = (f"ply\nformat {fmt} 1.0\ncomment a scene\nelement vertex {len(verts)}\n"
              "property float x\nproperty float y\nproperty float z\n"
              f"element face {len(faces)}\nproperty list uchar int vertex_indices\nend_header\n").encode()
    if binary:
        body = verts.astype("<f4").tobytes() + b"".join(np.uint8(3).tobytes() + f.astype("<i4").tobytes() for f in faces)
    else:
        body = ("".join(f"{x:.6f} {y:.6f} {z:.6f}\n" for x, y, z in verts)
                + "".join(f"3 {a} {b} {c}\n" for a, b, c in faces)).encode()
    with open(path, "wb") as f:
        f.write(header + body)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A dataset tree in the real layouts; returns its paths."""
    rng = np.random.default_rng(0)
    base = tmp_path_factory.mktemp("assets")
    os.makedirs(base / "models" / "smplx")
    _write_smplx(base / "models" / "smplx" / "SMPLX_NEUTRAL.npz", rng)

    prox = base / "proxe"
    for d in ("scenes_downsampled", "scenes_sdf", "body_segments"):
        os.makedirs(prox / d)
    for name, n_verts, dim, binary in zip(SCENES, (60, 45), (8, 6), (True, False)):
        verts = rng.uniform(-2, 2, (n_verts, 3)).astype(np.float32)
        faces = rng.integers(0, n_verts, (20, 3)).astype(np.int32)
        _write_ply(prox / "scenes_downsampled" / f"{name}.ply", verts, faces, binary)
        lo = rng.uniform(-3, -2, 3)
        with open(prox / "scenes_sdf" / f"{name}.json", "w") as f:
            json.dump({"dim": dim, "min": lo.tolist(), "max": (lo + 5.0).tolist()}, f)
        np.save(prox / "scenes_sdf" / f"{name}_sdf.npy", rng.normal(0, 0.5, dim**3).astype(np.float32))
    for part in J_PARTS:
        with open(prox / "body_segments" / f"{part}.json", "w") as f:  # with repeats, unsorted
            json.dump({"verts_ind": rng.integers(0, V, 12).tolist(), "faces_ind": rng.integers(0, 200, 9).tolist()}, f)

    vp = base / "vposer"
    os.makedirs(vp / "snapshots")
    old, new = _ref_vposer(1), _ref_vposer(2)
    torch.save(old.state_dict(), vp / "snapshots" / "TR00_E099.pt")
    torch.save(new.state_dict(), vp / "snapshots" / "TR00_E010.pt")  # newest by mtime, not by name
    os.utime(vp / "snapshots" / "TR00_E099.pt", (1_000_000, 1_000_000))
    os.utime(vp / "snapshots" / "TR00_E010.pt", (2_000_000, 2_000_000))
    return argparse.Namespace(base=base, proxe=prox, smplx=str(base / "models" / "smplx" / "SMPLX_NEUTRAL.npz"),
                              vposer=str(vp), newest=new, oldest=old)


def _args(root, **kw):
    return argparse.Namespace(synthetic=False, proxe_path=str(root.proxe), human_model_path=str(root.base / "models"),
                              vposer_ckpt_path=root.vposer, device="cpu", **kw)


def _assert_same_smplx(t, j):
    assert t.parents == j.parents
    for f in SMPLX_FIELDS:
        a, b = getattr(t, f), getattr(j, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f)


def test_load_smplx_npz_gives_psi_tpus_arrays(root):
    t, j = load_smplx_npz(root.smplx), j_load_smplx_npz(root.smplx)
    _assert_same_smplx(t, j)
    assert t.num_verts == V and t.num_joints == J and t.parents[0] == -1 and min(t.parents[1:]) >= 0
    assert t.shapedirs.shape == (V, 3, 10) and t.exprdirs.shape == (V, 3, 10)
    assert t.posedirs.shape == ((J - 1) * 9, V * 3) and t.posedirs.is_contiguous()
    assert t.hands_components_l.shape == (12, 45) and t.faces.dtype == torch.int64 and t.faces.shape == (200, 3)
    assert t.v_template.dtype == torch.float32 and t.pose_mean[-90:].abs().max() > 0 and t.pose_mean[:-90].abs().max() == 0
    raw = np.load(root.smplx)
    np.testing.assert_array_equal(t.exprdirs.numpy(), raw["shapedirs"][:, :, 300:310].astype(np.float32))
    np.testing.assert_array_equal(t.posedirs.numpy()[5].reshape(V, 3), raw["posedirs"][:, :, 5].astype(np.float32))


def test_load_smplx_npz_options_follow_psi_tpu(root):
    kw = dict(num_betas=7, num_pca_comps=6, num_expression_coeffs=4, flat_hand_mean=True, use_posedirs=False)
    t, j = load_smplx_npz(root.smplx, **kw), j_load_smplx_npz(root.smplx, **kw)
    _assert_same_smplx(t, j)
    assert t.posedirs is None and t.pose_mean.abs().max() == 0 and t.shapedirs.shape[-1] == 7
    assert t.hands_components_r.shape == (6, 45) and t.exprdirs.shape[-1] == 4


def test_a_loaded_model_runs_the_forward_with_expression(root):
    m = load_smplx_npz(root.smplx)
    B = 2
    z = lambda *s: torch.zeros(s)
    expr = torch.from_numpy(np.random.default_rng(1).normal(size=(B, 10)).astype(np.float32))
    verts, joints = smplx_forward(m, z(B, 3), z(B, 3), z(B, 10), z(B, 63), z(B, 12), z(B, 12), expression=expr, jaw_pose=z(B, 3))
    flat, _ = smplx_forward(m, z(B, 3), z(B, 3), z(B, 10), z(B, 63), z(B, 12), z(B, 12), jaw_pose=z(B, 3))
    assert verts.shape == (B, V, 3) and joints.shape == (B, J, 3) and torch.isfinite(verts).all()
    assert not torch.allclose(verts, flat)


@pytest.mark.parametrize("binary", [True, False], ids=["binary", "ascii"])
def test_read_ply_gives_psi_tpus_arrays(root, binary):
    path = str(root.proxe / "scenes_downsampled" / f"{SCENES[0 if binary else 1]}.ply")
    (v, f), (vj, fj) = read_ply(path), j_read_ply(path)
    np.testing.assert_array_equal(v, vj)
    np.testing.assert_array_equal(f, fj)
    assert v.dtype == np.float64 and f.dtype == np.int32 and v.shape == ((60 if binary else 45), 3) and f.shape == (20, 3)


def test_read_ply_refuses_big_endian_and_takes_a_mesh_without_faces(tmp_path):
    p = tmp_path / "be.ply"
    p.write_bytes(b"ply\nformat binary_big_endian 1.0\nelement vertex 0\nproperty float x\nend_header\n")
    with pytest.raises(ValueError, match="unsupported PLY"):
        read_ply(str(p))
    q = tmp_path / "points.ply"
    q.write_bytes(b"ply\nformat ascii 1.0\nelement vertex 2\nproperty float x\nproperty float y\nproperty float z\n"
                  b"end_header\n0 1 2\n3 4 5\n")
    v, f = read_ply(str(q))
    assert v.tolist() == [[0, 1, 2], [3, 4, 5]] and f.shape == (0, 3)


def test_load_scene_registry_gives_psi_tpus_registry(root):
    paths = (str(root.proxe / "scenes_downsampled"), str(root.proxe / "scenes_sdf"), list(SCENES))
    t, j = load_scene_registry(*paths), j_load_scene_registry(*paths)
    assert t.names == j.names == list(SCENES) and t.num_scenes == 2
    for f in ("sdf_stack", "grid_mins", "grid_maxs", "verts_stack", "n_verts"):
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f), err_msg=f)
    for a, b in zip(t.faces, j.faces):
        np.testing.assert_array_equal(a, b)
    # grids of dims 8 and 6 padded to 8, clouds of 60 and 45 points padded to 60 with far points
    assert t.sdf_stack.shape == (2, 8, 8, 8) and t.verts_stack.shape == (2, 60, 3) and t.n_verts.tolist() == [60, 45]
    assert (t.verts_stack[1, 45:] == 1.0e5).all() and t.faces[0].max() < 60


def test_get_contact_ids_gives_psi_tpus_ids(root):
    folder = str(root.proxe / "body_segments")
    (v, f), (vj, fj) = get_contact_ids(folder), j_get_contact_ids(folder)
    np.testing.assert_array_equal(v, vj)
    np.testing.assert_array_equal(f, fj)
    assert DEFAULT_CONTACT_PARTS == J_PARTS and v.dtype == np.int32 and f.dtype == np.int32
    first = np.unique(json.load(open(os.path.join(folder, "back.json")))["verts_ind"])
    np.testing.assert_array_equal(v[: len(first)], first)  # per part: deduplicated, ascending
    one, _ = get_contact_ids(folder, ["thighs"])
    assert len(one) < len(v)
    with pytest.raises(FileNotFoundError):
        get_contact_ids(folder, ["tail"])


def test_scene_name_constants_are_psi_tpus():
    assert hdf5.PROX_SCENES == J_PROX_SCENES and len(hdf5.PROX_SCENES) == 12


def test_load_vposer_takes_the_newest_snapshot_and_decodes_as_psi_tpu(root):
    vp = load_vposer(root.vposer)
    assert isinstance(vp, VPoser) and not vp.training
    for k, v in vp.state_dict().items():
        assert torch.equal(v, root.newest.state_dict()[k]), k  # newest by mtime, copied exactly
    assert not torch.equal(vp.bodyprior_dec_out.weight, root.oldest.bodyprior_dec_out.weight)
    z = np.random.default_rng(3).normal(0, 1, (5, 32)).astype(np.float32)
    want = np.asarray(j_vposer_decode(j_load_vposer_params(root.vposer), jnp.asarray(z)))
    with torch.no_grad():
        got = vposer_decode(vp, torch.from_numpy(z)).numpy()
    assert got.shape == want.shape == (5, 63)
    np.testing.assert_allclose(got, want, atol=POSE_ATOL, rtol=0)


def test_load_vposer_takes_a_file_an_npz_and_only_when_trusted_a_pickled_module(root, tmp_path):
    sd = root.newest.state_dict()
    pt = tmp_path / "one.pt"
    torch.save(sd, pt)
    npz = tmp_path / "converted.npz"
    np.savez(npz, **{k: v.numpy() for k, v in sd.items()})
    flat = tmp_path / "flat"  # a directory without snapshots/: its own *.pt
    os.makedirs(flat)
    torch.save(sd, flat / "weights.pt")
    pickled = tmp_path / "module.pt"
    torch.save(root.newest, pickled)
    for path in (pt, npz, flat):
        vp = load_vposer(str(path))
        assert all(torch.equal(v, sd[k]) for k, v in vp.state_dict().items()), path
    with pytest.raises(Exception, match="[Ww]eights"):  # weights_only=True refuses to unpickle a module
        load_vposer(str(pickled))
    trusted = load_vposer(str(pickled), trusted=True)
    assert all(torch.equal(v, sd[k]) for k, v in trusted.state_dict().items())
    with pytest.raises(ValueError):
        load_vposer(None)
    os.makedirs(tmp_path / "empty")
    with pytest.raises(FileNotFoundError):
        load_vposer(str(tmp_path / "empty"))


def test_vposer_from_state_dict_sizes_the_decoder_and_names_what_is_missing():
    small = {"bodyprior_dec_fc1.weight": np.zeros((16, 8), np.float32), "bodyprior_dec_fc1.bias": np.zeros(16, np.float32),
             "bodyprior_dec_fc2.weight": np.zeros((16, 16), np.float32), "bodyprior_dec_fc2.bias": np.zeros(16, np.float32),
             "bodyprior_dec_out.weight": np.ones((5 * 6, 16), np.float32), "bodyprior_dec_out.bias": np.zeros(30, np.float32)}
    vp = vposer_from_state_dict(small)
    assert vp.num_joints == 5 and vp.bodyprior_dec_fc1.in_features == 8 and vp.bodyprior_dec_out.weight.sum() == 30 * 16
    del small["bodyprior_dec_out.bias"]
    with pytest.raises(KeyError, match="bodyprior_dec_out.bias"):
        vposer_from_state_dict(small)


def test_build_assets_from_real_paths_gives_psi_tpus_assets_and_serves(root):
    """Both packages' build_assets on the same tree, then one fitted request
    through the port's engine on the result."""
    from psi_tpu_torch.models.cvae_s1 import HumanCVAES1
    from psi_tpu_torch.serve import GenerationEngine
    from psi_tpu_torch.utils.config import FitConfig
    from psi_tpu_torch.utils.init import seeded_init_

    (ta, treg), (ja, jreg) = build_assets(_args(root), scene_names=list(SCENES)), j_build_assets(_args(root), list(SCENES))
    ja = jax.device_get(ja)
    _assert_same_smplx(ta.smplx, ja.smplx)
    for f in ("contact_vids", "sdf_packed", "grid_mins", "grid_maxs", "scene_verts"):
        np.testing.assert_array_equal(getattr(ta, f).numpy(), np.asarray(getattr(ja, f)), err_msg=f)
    assert treg.names == jreg.names and ta.sdf_packed.dtype == torch.float32 and ta.contact_vids.dtype == torch.int64
    z = np.random.default_rng(4).normal(0, 1, (3, 32)).astype(np.float32)
    with torch.no_grad():
        np.testing.assert_allclose(vposer_decode(ta.vposer, torch.from_numpy(z)).numpy(),
                                   np.asarray(j_vposer_decode(ja.vposer_params, jnp.asarray(z))), atol=POSE_ATOL, rtol=0)
    half = build_assets(_args(root), scene_names=list(SCENES), sdf_dtype=torch.bfloat16)[0]
    assert half.sdf_packed.dtype == torch.bfloat16 and torch.equal(half.sdf_packed, ta.sdf_packed.to(torch.bfloat16))

    eng = GenerationEngine(seeded_init_(HumanCVAES1(latentD=32, image_size=32), 0), ta, population=4,
                           fit_cfg=FitConfig.production(num_iter=3, refresh_every=2, refresh_warmup=1, prune_scene_points=32),
                           max_requests=2, device="cpu")
    snap = {"xs": np.zeros((1, 32, 32, 2), np.float32), "cam_int": np.eye(3, dtype=np.float32)[None] * 500,
            "cam_ext": np.eye(4, dtype=np.float32)[None], "max_d": np.asarray([6.0], np.float32)}
    r = eng.generate(snap, fit=True, scene_idx=1)
    assert r.bodies.shape == (4, 72) and r.fitted and np.isfinite(r.bodies).all()
    unfitted = GenerationEngine(eng.model, ta, population=4, fit_cfg=eng.fit_cfg, max_requests=2, device="cpu").generate(snap)
    assert not np.allclose(r.bodies, unfitted.bodies)  # the same seed's sample, moved by the fit
