"""Rotation representations: 6D continuous <-> rotation matrix <-> axis-angle.

Port of ``psi_tpu.geometry.rot6d`` (the reference's
``ContinousRotReprDecoder``, source/cvae.py:36-89, and the torchgeometry
conversions it calls). Batched over leading dims, differentiable, and
safe at the singularities: the gradient is finite at angle 0 in
``aa_to_matrix`` and at the identity in ``quat_to_aa``.

Conventions (as in psi_tpu):
* the 6D representation is the first two *columns* of the rotation
  matrix, flattened row-major: [r00, r01, r10, r11, r20, r21];
* decoding Gram-Schmidts column 0, orthogonalises column 1 and takes the
  cross product for column 2.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def _normalize(v: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """L2-normalise, matching torch.nn.functional.normalize (eps=1e-12)."""
    n = torch.linalg.vector_norm(v, dim=dim, keepdim=True)
    return v / torch.clamp(n, min=1e-12)


def rot6d_to_matrix(x6: torch.Tensor) -> torch.Tensor:
    """[..., 6] continuous 6D representation -> [..., 3, 3] rotation matrix."""
    m = x6.reshape(x6.shape[:-1] + (3, 2))
    a1 = m[..., 0]
    a2 = m[..., 1]
    b1 = _normalize(a1)
    dot = torch.sum(b1 * a2, dim=-1, keepdim=True)
    b2 = _normalize(a2 - dot * b1)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-1)


def matrix_to_rot6d(R: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] rotation matrix -> [..., 6] (first two columns, row-major)."""
    return R[..., :, :2].reshape(R.shape[:-2] + (6,))


def aa_to_matrix(aa: torch.Tensor) -> torch.Tensor:
    """Axis-angle [..., 3] -> rotation matrix [..., 3, 3] (Rodrigues).

    sin(t)/t and (1 - cos t)/t^2 switch to their Taylor series near 0.
    ``torch.where`` differentiates both branches, so the division uses a
    sanitised theta^2 (the double-where): without it the gradient at
    t = 0 is 0 * NaN = NaN.
    """
    theta2 = torch.sum(aa * aa, dim=-1, keepdim=True)  # [..., 1]
    small = theta2 < 1e-8
    safe2 = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(safe2)
    sinc = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    cosc = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / safe2)

    x, y, z = aa[..., 0], aa[..., 1], aa[..., 2]
    zeros = torch.zeros_like(x)
    K = torch.stack(
        [
            torch.stack([zeros, -z, y], dim=-1),
            torch.stack([z, zeros, -x], dim=-1),
            torch.stack([-y, x, zeros], dim=-1),
        ],
        dim=-2,
    )  # [..., 3, 3] skew of the unnormalised axis-angle
    K2 = torch.matmul(K, K)
    eye = torch.eye(3, dtype=aa.dtype, device=aa.device)
    return eye + sinc[..., None] * K + cosc[..., None] * K2


def matrix_to_quat(R: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] rotation matrix -> unit quaternion [..., 4] (w, x, y, z).

    Branchless Shepperd's method: all four candidates are computed and the
    one with the largest pivot is selected, which is stable at angle pi.
    """
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]

    tr = m00 + m11 + m22
    qw2 = 1.0 + tr
    qx2 = 1.0 + m00 - m11 - m22
    qy2 = 1.0 - m00 + m11 - m22
    qz2 = 1.0 - m00 - m11 + m22

    def safe_sqrt(v):
        return torch.sqrt(torch.clamp(v, min=_EPS))

    sw = safe_sqrt(qw2)  # = 2|w|
    sx = safe_sqrt(qx2)
    sy = safe_sqrt(qy2)
    sz = safe_sqrt(qz2)

    q_w = torch.stack(
        [0.5 * sw, (m21 - m12) / (2.0 * sw), (m02 - m20) / (2.0 * sw), (m10 - m01) / (2.0 * sw)],
        dim=-1,
    )
    q_x = torch.stack(
        [(m21 - m12) / (2.0 * sx), 0.5 * sx, (m01 + m10) / (2.0 * sx), (m02 + m20) / (2.0 * sx)],
        dim=-1,
    )
    q_y = torch.stack(
        [(m02 - m20) / (2.0 * sy), (m01 + m10) / (2.0 * sy), 0.5 * sy, (m12 + m21) / (2.0 * sy)],
        dim=-1,
    )
    q_z = torch.stack(
        [(m10 - m01) / (2.0 * sz), (m02 + m20) / (2.0 * sz), (m12 + m21) / (2.0 * sz), 0.5 * sz],
        dim=-1,
    )

    pivots = torch.stack([qw2, qx2, qy2, qz2], dim=-1)  # [..., 4]
    best = torch.argmax(pivots, dim=-1)[..., None]  # first maximum, as jnp.argmax
    q = torch.where(best == 0, q_w, torch.where(best == 1, q_x, torch.where(best == 2, q_y, q_z)))
    # canonical sign w >= 0: the minimal-angle axis-angle
    q = torch.where(q[..., :1] < 0, -q, q)
    return _normalize(q)


def quat_to_aa(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion [..., 4] (w, x, y, z) -> axis-angle [..., 3].

    |v| is taken as the square root of a sanitised |v|^2: at the identity
    (v = 0) a plain norm has an infinite derivative, which the
    unselected ``where`` branch would turn into a NaN gradient.
    """
    w = q[..., 0]
    v = q[..., 1:]
    s2 = torch.sum(v * v, dim=-1)
    small = s2 < 1e-12  # |sin(theta/2)| < 1e-6
    sin_half = torch.sqrt(torch.where(small, torch.ones_like(s2), s2))
    sin_half = torch.where(small, torch.zeros_like(s2), sin_half)
    theta = 2.0 * torch.atan2(sin_half, w)
    # aa = v * theta / sin_half; near zero theta / sin_half -> 2 / w
    scale = torch.where(
        small,
        2.0 / torch.clamp(torch.abs(w), min=_EPS),
        theta / torch.clamp(sin_half, min=_EPS),
    )
    return v * scale[..., None]


def matrix_to_aa(R: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] rotation matrix -> axis-angle [..., 3] (via the quaternion)."""
    return quat_to_aa(matrix_to_quat(R))


def aa_to_rot6d(aa: torch.Tensor) -> torch.Tensor:
    """Axis-angle [..., 3] -> 6D representation [..., 6]."""
    return matrix_to_rot6d(aa_to_matrix(aa))


def rot6d_to_aa(x6: torch.Tensor) -> torch.Tensor:
    """6D representation [..., 6] -> axis-angle [..., 3]."""
    return matrix_to_aa(rot6d_to_matrix(x6))
