"""Result visualization: render scene + generated bodies to PNG.

Port of ``psi_tpu.viz.show_results`` (equivalent of the reference's
utils/utils_show_test_results{,_habitat}.py, Open3D windows there; the
software renderer here): load generated/fitted body_gen_*.pkl files,
decode SMPL-X meshes, transform by cam_ext, and render shaded color
images from one or more viewpoints. The z-buffer runs on a torch device;
palettes and shading are numpy, as in psi_tpu; PNGs are written with zlib
(``write_png``), so rendering needs no imaging package.
"""

from __future__ import annotations

import glob
import os
import pickle
import struct
import zlib
from typing import List, Optional, Tuple

import numpy as np
import torch

from psi_tpu_torch.body.decode import body_vec_to_verts
from psi_tpu_torch.geometry.bodyvec import body_params_parse
from psi_tpu_torch.utils.tools import resolve_device
from psi_tpu_torch.viz.colors import BODY_COLORS, mpcat40_color
from psi_tpu_torch.viz.render import render_depth_semantics


def write_png(path: str, img: np.ndarray) -> str:
    """An [H, W, 3] uint8 image as an 8-bit RGB PNG, with zlib alone (no
    imaging package is needed to write the renderer's results)."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    h, w, _ = img.shape
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))  # filter type 0 on every row

    def chunk(tag: bytes, data: bytes) -> bytes:
        return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))
    return path


def quantize_colors(colors: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per-point colors -> (palette [K, 3] of 6-bit levels, label 0..K-1 per
    point), K <= 63 (labels wrap past 63, as in psi_tpu)."""
    uniq, inv = np.unique(np.round(colors * 63).astype(np.int32), axis=0, return_inverse=True)
    if len(uniq) > 63:  # quantize palette if needed
        inv = inv % 63
        uniq = uniq[:63]
    return uniq, inv


def shade(depth: np.ndarray, label: np.ndarray, palette: np.ndarray) -> np.ndarray:
    """Palette colors dimmed by depth, background white -> [H, W, 3] uint8."""
    palette = np.concatenate([np.zeros((1, 3)), palette / 63.0], axis=0)
    img = palette[np.clip(label, 0, len(palette) - 1)]
    # depth-based dimming for a simple shading cue
    d = depth.copy()
    d[d == 0] = d.max() if d.max() > 0 else 1.0
    s = 1.0 - 0.35 * (d - d.min()) / max(d.max() - d.min(), 1e-6)
    img = np.clip(img * s[..., None], 0, 1)
    img[label == 0] = 1.0  # background white
    return (img * 255).astype(np.uint8)


def render_color(
    verts: np.ndarray,
    colors: np.ndarray,
    cam_int: np.ndarray,
    height: int,
    width: int,
    cam_ext: Optional[np.ndarray] = None,
    splat_radius: int = 1,
    device=None,
) -> np.ndarray:
    """Point-splat color render with simple depth-based shading -> [H, W, 3].
    The z-buffer runs on ``device`` (None: the first card, or an error)."""
    dev = resolve_device(device, "render_color")
    uniq_colors, inv = quantize_colors(colors)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    depth, label = render_depth_semantics(
        f32(verts), torch.as_tensor(inv + 1, device=dev), f32(cam_int), height, width,
        cam_ext=f32(cam_ext) if cam_ext is not None else None, splat_radius=splat_radius,
    )
    return shade(depth.cpu().numpy(), label.cpu().numpy().astype(np.int32), uniq_colors)


def show_generated_results(
    assets,
    results_dir: str,
    scene_verts: np.ndarray,
    scene_labels: np.ndarray,
    cam_int: np.ndarray,
    out_dir: str,
    image_hw: Tuple[int, int] = (480, 640),
    max_bodies: int = 20,
    view_cam_ext: Optional[np.ndarray] = None,
) -> List[str]:
    """Render up to max_bodies generated bodies into the scene; one PNG per
    body plus a combined view (reference renders 2 views/body,
    utils_show_test_results.py:150-205). Decodes and renders on the
    device of ``assets`` (a ``SceneAssets``)."""
    dev = assets.smplx.v_template.device
    os.makedirs(out_dir, exist_ok=True)
    h, w = image_hw
    scene_colors = mpcat40_color(scene_labels)

    pkls = sorted(glob.glob(os.path.join(results_dir, "body_gen_*.pkl")))[:max_bodies]
    outfiles = []
    all_body_verts = []
    for p in pkls:
        with open(p, "rb") as f:
            rec = pickle.load(f)
        x72 = body_params_parse(rec).reshape(1, -1).to(dev)
        cam_ext = np.asarray(rec["cam_ext"], np.float32).reshape(1, 4, 4)
        with torch.no_grad():
            verts, _ = body_vec_to_verts(assets.smplx, assets.vposer, x72, torch.from_numpy(cam_ext).to(dev))
        # bodies are generated in the camera frame; map to world via inv(cam_ext)
        inv_ext = np.linalg.inv(cam_ext[0])
        bv = verts[0].cpu().numpy() @ inv_ext[:3, :3].T + inv_ext[:3, 3]
        all_body_verts.append(bv)

    for i, bv in enumerate(all_body_verts):
        verts = np.concatenate([scene_verts, bv], axis=0)
        colors = np.concatenate(
            [scene_colors, np.tile(BODY_COLORS["blue"], (len(bv), 1))], axis=0
        )
        img = render_color(verts, colors, cam_int, h, w, cam_ext=view_cam_ext, device=dev)
        outfiles.append(write_png(os.path.join(out_dir, f"body_{i:03d}.png"), img))

    if all_body_verts:
        verts = np.concatenate([scene_verts] + all_body_verts, axis=0)
        colors = np.concatenate(
            [scene_colors]
            + [np.tile(BODY_COLORS["blue"], (len(b), 1)) for b in all_body_verts],
            axis=0,
        )
        img = render_color(verts, colors, cam_int, h, w, cam_ext=view_cam_ext, device=dev)
        outfiles.append(write_png(os.path.join(out_dir, "all_bodies.png"), img))
    return outfiles
