"""psi_tpu_torch's software renderer, mesh viewer and result renderer
against psi_tpu's on the same inputs.

The rasterizer evaluates each (pixel, triangle) pair with psi_tpu's
formulas and takes an integer minimum, so it is held to equal depth and
labels: exactly on tests/test_rasterize.py's analytic cases, and on
>= 99.9% of pixels of a seeded random mesh with the rest within 1 mm (a
camera transform's matmul may round differently); the splatter and the
rendered images the same way (the result renderer and the trainer's grid:
tests/test_torch_show_results.py). The fifth analytic case (a coarse plane is
hole-free) is rasterized directly here; psi_tpu reaches it through
``data.snapshots.render_scene_snapshot``, which tests/test_torch_snapshots.py
holds to psi_tpu's on the same case.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psi_tpu.viz import mesh_viewer as j_mesh_viewer
from psi_tpu.viz.colors import BODY_COLORS as J_BODY_COLORS
from psi_tpu.viz.colors import MPCAT40_PALETTE as J_PALETTE
from psi_tpu.viz import render as j_render
from psi_tpu.viz import show_results as j_show_results
from psi_tpu_torch.viz import mesh_viewer, render, show_results
from psi_tpu_torch.viz.colors import BODY_COLORS, MPCAT40_PALETTE, mpcat40_color

torch.set_num_threads(1)
EQUAL_SHARE = 0.999
MM = 1e-3 + 1e-6


def _cam(f=100.0, px=32.0, py=32.0):
    return np.asarray([[f, 0, px], [0, f, py], [0, 0, 1]], np.float32)


def _both_rasterize(verts, faces, labels, cam, h, w, cam_ext=None):
    jd, js = j_render.rasterize_mesh(jnp.asarray(verts), jnp.asarray(faces), jnp.asarray(labels), jnp.asarray(cam),
                                     h, w, cam_ext=None if cam_ext is None else jnp.asarray(cam_ext))
    td, ts = render.rasterize_mesh(torch.from_numpy(verts), torch.from_numpy(faces), torch.from_numpy(labels),
                                   torch.from_numpy(cam), h, w,
                                   cam_ext=None if cam_ext is None else torch.from_numpy(cam_ext))
    return (np.asarray(jd), np.asarray(js)), (td.numpy(), ts.numpy())


def _exact(verts, faces, labels, cam, h, w):
    (jd, js), (td, ts) = _both_rasterize(verts, faces, labels, cam, h, w)
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_array_equal(ts, js)
    return td, ts


def _plane_mesh(n=6, z=4.0):
    xs = np.linspace(-3, 3, n)
    verts = np.stack(np.meshgrid(xs, xs, [z]), -1).reshape(-1, 3).astype(np.float32)
    faces = []
    for i in range(n - 1):
        for j in range(n - 1):
            a = i * n + j
            faces += [[a, a + 1, a + n], [a + 1, a + n + 1, a + n]]
    return verts, np.asarray(faces, np.int32)


# ---- tests/test_rasterize.py's five cases, each equal to psi_tpu's


def test_fullscreen_quad_exact_depth():
    z, s = 2.0, 2.0
    verts = np.array([[-s, -s, z], [s, -s, z], [s, s, z], [-s, s, z]], np.float32)
    d, seg = _exact(verts, np.array([[0, 1, 2], [0, 2, 3]], np.int32), np.full(4, 7, np.int32), _cam(), 64, 64)
    assert (d > 0).all()
    np.testing.assert_allclose(d, z, atol=2e-3)
    assert (seg == 7).all()


def test_zbuffer_ordering_and_labels():
    s = 3.0
    verts = np.array([[-s, -s, 4], [s, -s, 4], [s, s, 4], [-s, s, 4],
                      [-0.2, -0.2, 1], [0.2, -0.2, 1], [0.0, 0.25, 1]], np.float32)
    faces = np.array([[0, 1, 2], [0, 2, 3], [4, 5, 6]], np.int32)
    d, seg = _exact(verts, faces, np.array([9, 9, 9, 9, 3, 3, 3], np.int32), _cam(), 64, 64)
    assert abs(d[32, 32] - 1.0) < 2e-3 and seg[32, 32] == 3
    assert abs(d[2, 2] - 4.0) < 4e-3 and seg[2, 2] == 9


def test_winding_independence():
    verts = np.array([[-1, -1, 2], [1, -1, 2], [0, 1, 2]], np.float32)
    labels = np.full(3, 5, np.int32)
    d1, _ = _exact(verts, np.array([[0, 1, 2]], np.int32), labels, _cam(), 64, 64)
    d2, _ = _exact(verts, np.array([[0, 2, 1]], np.int32), labels, _cam(), 64, 64)
    np.testing.assert_array_equal(d1 > 0, d2 > 0)


def test_behind_camera_culled():
    verts = np.array([[-1, -1, -2], [1, -1, -2], [0, 1, -2]], np.float32)
    d, _ = _exact(verts, np.array([[0, 1, 2]], np.int32), np.full(3, 5, np.int32), _cam(), 32, 32)
    assert d.max() == 0.0


def test_coarse_plane_is_hole_free():
    verts, faces = _plane_mesh()
    cam = np.array([[100, 0, 60], [0, 100, 40], [0, 0, 1]], np.float32)
    d, seg = _exact(verts, faces, np.full(len(verts), 2, np.int32), cam, 80, 120)
    assert (d > 0).all() and (seg == 2).all()
    np.testing.assert_allclose(d, 4.0, atol=5e-3)


# ---- a seeded random mesh, with and without a camera transform


@pytest.fixture(scope="module")
def mesh():
    rng = np.random.default_rng(0)
    verts = rng.normal(0, 0.4, (300, 3)).astype(np.float32)
    verts[:, 2] += 3.0
    faces = rng.integers(0, 300, (700, 3)).astype(np.int32)
    labels = rng.integers(0, 42, 300).astype(np.int32)
    ext = np.eye(4, dtype=np.float32)
    ext[:3, :3] = np.array([[0.96, 0.0, -0.28], [0.0, 1.0, 0.0], [0.28, 0.0, 0.96]], np.float32)
    ext[:3, 3] = [0.1, -0.2, 0.3]
    return verts, faces, labels, np.array([[90, 0, 40], [0, 90, 30], [0, 0, 1]], np.float32), ext


def _agree(jd, js, td, ts):
    same = (jd == td) & (js == ts)
    assert same.mean() >= EQUAL_SHARE, same.mean()
    assert np.abs(jd - td).max() <= MM
    return same.mean()


@pytest.mark.parametrize("with_ext", [False, True])
def test_rasterize_random_mesh_matches_psi_tpu(mesh, with_ext):
    verts, faces, labels, cam, ext = mesh
    (jd, js), (td, ts) = _both_rasterize(verts, faces, labels, cam, 60, 80, ext if with_ext else None)
    assert (jd > 0).mean() > 0.3
    _agree(jd, js, td, ts)


@pytest.mark.parametrize("with_ext", [False, True])
def test_splatting_random_points_matches_psi_tpu(mesh, with_ext):
    verts, _, labels, cam, ext = mesh
    e = ext if with_ext else None
    jd, js = j_render.render_depth_semantics(jnp.asarray(verts), jnp.asarray(labels), jnp.asarray(cam), 60, 80,
                                             cam_ext=None if e is None else jnp.asarray(e), splat_radius=1)
    td, ts = render.render_depth_semantics(torch.from_numpy(verts), torch.from_numpy(labels), torch.from_numpy(cam),
                                           60, 80, cam_ext=None if e is None else torch.from_numpy(e))
    assert (np.asarray(jd) > 0).mean() > 0.1
    _agree(np.asarray(jd), np.asarray(js), td.numpy(), ts.numpy())


def test_project_points_and_upsample_mesh_match_psi_tpu(mesh):
    verts, faces, _, cam, ext = mesh
    juv, jz = j_render.project_points(jnp.asarray(verts), jnp.asarray(cam), jnp.asarray(ext))
    tuv, tz = render.project_points(torch.from_numpy(verts), torch.from_numpy(cam), torch.from_numpy(ext))
    np.testing.assert_allclose(tuv.numpy(), np.asarray(juv), rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), rtol=1e-6, atol=1e-6)
    for it in (1, 2):
        tv, tf = render.upsample_mesh(verts, faces[:50], iterations=it)
        jv, jf = j_render.upsample_mesh(verts, faces[:50], iterations=it)
        np.testing.assert_array_equal(tv, jv)
        np.testing.assert_array_equal(tf, jf)


def test_render_color_and_mesh_viewer_match_psi_tpu(mesh):
    verts, faces, labels, _, _ = mesh
    colors = mpcat40_color(labels)
    assert np.array_equal(MPCAT40_PALETTE, J_PALETTE) and all(np.array_equal(BODY_COLORS[k], v)
                                                              for k, v in J_BODY_COLORS.items())
    cam = np.array([[120, 0, 40], [0, 120, 30], [0, 0, 1]], np.float32)
    ji = j_show_results.render_color(verts, colors, cam, 60, 80)
    ti = show_results.render_color(verts, colors, cam, 60, 80, device="cpu")
    assert ti.dtype == np.uint8 and (ti == ji).all(axis=-1).mean() >= EQUAL_SHARE
    views = []
    for vm in (j_mesh_viewer.MeshViewer(width=80, height=60),
               mesh_viewer.MeshViewer(width=80, height=60, device="cpu")):
        vm.set_meshes([(verts - np.array([0, 0, 3.0]), faces, colors)], densify=0)
        mesh_img = vm.render()
        vm.set_meshes([(verts - np.array([0, 0, 3.0]), None, None)])
        views.append((mesh_img, vm.render()))
    for j, t in zip(*views):
        assert (t == j).all(axis=-1).mean() >= EQUAL_SHARE
        assert (t < 250).any()  # something was drawn
    empty = mesh_viewer.MeshViewer(width=8, height=6, device="cpu")
    assert (empty.render() == 255).all()


def test_save_snapshot_and_imagearray2file(tmp_path, mesh):
    from PIL import Image

    verts, faces, labels, _, _ = mesh
    mv = mesh_viewer.MeshViewer(width=40, height=30, device="cpu")
    mv.set_cam(np.eye(4, dtype=np.float32))
    mv.set_meshes([(verts, faces, mpcat40_color(labels))])
    path = mv.save_snapshot(str(tmp_path / "a" / "snap.png"))
    assert np.asarray(Image.open(path)).shape == (30, 40, 3)
    grid = np.random.default_rng(0).integers(0, 255, (2, 3, 4, 5, 6, 3)).astype(np.uint8)
    (png,) = mesh_viewer.imagearray2file(grid[:, :, :1], str(tmp_path / "g.png"))
    assert np.array_equal(np.asarray(Image.open(png)), grid[:, :, 0].transpose(0, 2, 1, 3, 4).reshape(10, 18, 3))
    jpng = j_mesh_viewer.imagearray2file(grid[:, :, :1], str(tmp_path / "j.png"))[0]
    assert np.array_equal(np.asarray(Image.open(png)), np.asarray(Image.open(jpng)))
    (gif,) = mesh_viewer.imagearray2file(grid.astype(np.float32) / 255.0, str(tmp_path / "g.gif"))
    assert os.path.getsize(gif) > 0 and Image.open(gif).n_frames == 4


def test_renderers_need_a_card_unless_told_otherwise(monkeypatch, mesh):
    verts, _, labels, cam, _ = mesh
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="NVIDIA card"):
        mesh_viewer.MeshViewer(width=8, height=8)
    with pytest.raises(RuntimeError, match="NVIDIA card"):
        show_results.render_color(verts, mpcat40_color(labels), cam, 8, 8)
