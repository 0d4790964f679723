"""Offscreen MeshViewer on the software renderer.

Port of ``psi_tpu.viz.mesh_viewer`` (API-parity with
human_body_prior/mesh/mesh_viewer.py, pyrender there): set_cam /
set_meshes / render / save_snapshot, plus the imagearray2file grid writer
from tools/visualization_tools.py:30-170 (png with zlib; gif/mp4 via
imageio). The z-buffer runs on the viewer's torch device.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from psi_tpu_torch.utils.tools import resolve_device
from psi_tpu_torch.viz.render import rasterize_mesh
from psi_tpu_torch.viz.show_results import quantize_colors, render_color, shade, write_png


class MeshViewer:
    """``device``: where the rasterizer runs (None: the first card, or an
    error without one)."""

    def __init__(self, width: int = 800, height: int = 800, use_offscreen: bool = True, device=None):
        self.device = resolve_device(device, "MeshViewer")
        self.width = width
        self.height = height
        f = 1.5 * max(width, height)
        self.cam_int = np.array(
            [[f, 0, width / 2.0], [0, f, height / 2.0], [0, 0, 1.0]], np.float32
        )
        self.cam_ext = np.eye(4, dtype=np.float32)
        self.cam_ext[2, 3] = 2.5  # default: camera 2.5m back
        self._meshes: List[Tuple[np.ndarray, np.ndarray]] = []  # (verts, colors)
        self._faces: List[Optional[np.ndarray]] = []

    def set_cam(self, cam_ext: np.ndarray, cam_int: Optional[np.ndarray] = None) -> None:
        self.cam_ext = np.asarray(cam_ext, np.float32)
        if cam_int is not None:
            self.cam_int = np.asarray(cam_int, np.float32)

    def set_meshes(
        self,
        meshes: Sequence[Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]],
        group_name: str = "static",
        densify: int = 1,
    ) -> None:
        """meshes: list of (verts, faces, vertex_colors|None). Meshes with
        faces render through the triangle rasterizer (hole-free); pure
        point sets fall back to z-buffer splatting."""
        self._meshes = []
        self._faces = []
        for item in meshes:
            verts, faces = item[0], item[1]
            colors = item[2] if len(item) > 2 and item[2] is not None else np.full((len(verts), 3), 0.6)
            self._meshes.append((np.asarray(verts, np.float32), np.asarray(colors, np.float32)))
            self._faces.append(np.asarray(faces, np.int32) if faces is not None and len(faces) else None)

    def render(self) -> np.ndarray:
        if not self._meshes:
            return np.full((self.height, self.width, 3), 255, np.uint8)
        verts = np.concatenate([m[0] for m in self._meshes], axis=0)
        colors = np.concatenate([m[1] for m in self._meshes], axis=0)

        if all(f is not None for f in self._faces):
            # quantized per-vertex colors -> label ids (as in render_color)
            uniq, inv = quantize_colors(colors)
            offset, faces_all = 0, []
            for (v, _), f in zip(self._meshes, self._faces):
                faces_all.append(f + offset)
                offset += len(v)
            faces_cat = np.concatenate(faces_all, axis=0)
            on = lambda a: torch.as_tensor(a, device=self.device)
            depth, label = rasterize_mesh(
                on(verts), on(faces_cat), on(inv + 1), on(self.cam_int), self.height, self.width,
                cam_ext=on(self.cam_ext),
            )
            return shade(depth.cpu().numpy(), label.cpu().numpy().astype(np.int32), uniq)

        return render_color(verts, colors, self.cam_int, self.height, self.width, cam_ext=self.cam_ext,
                            device=self.device)

    def save_snapshot(self, path: str) -> str:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        return write_png(path, self.render())


def imagearray2file(img_array: np.ndarray, outpath: str, fps: int = 10) -> List[str]:
    """[R, C, T, H, W, 3] uint8/float grid -> png (T=1), gif, or mp4.

    Grid cells tile rows x cols per frame (visualization_tools.py:30-170).
    A png is written with zlib (``write_png``); gif and mp4 need imageio."""
    arr = np.asarray(img_array)
    if arr.dtype != np.uint8:
        arr = np.clip(arr, 0, 255).astype(np.uint8) if arr.max() > 1.5 else (arr * 255).astype(np.uint8)
    R, C, T, H, W, _ = arr.shape
    frames = [
        arr[:, :, t].transpose(0, 2, 1, 3, 4).reshape(R * H, C * W, 3) for t in range(T)
    ]
    os.makedirs(os.path.dirname(outpath) or ".", exist_ok=True)
    ext = os.path.splitext(outpath)[1].lower()
    if ext == ".png" or T == 1 and ext not in (".gif", ".mp4"):
        write_png(outpath, frames[0])
        return [outpath]
    import imageio

    if ext == ".gif":
        imageio.mimwrite(outpath, frames, duration=1.0 / fps)
    else:
        imageio.mimwrite(outpath, frames, fps=fps)
    return [outpath]
