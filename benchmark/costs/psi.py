"""Operations and bytes of each piece of PSI's work, from shapes alone.

Each piece is counted once, whatever implements it: its operands are read
once and its result written once, and a product of an [M, K] and a [K, N]
operand is 2 M N K operations. Times are the least the chip could take
against the published peaks of one NVIDIA H100 SXM at 700 W (dense): 989
TFLOP/s bf16 on the tensor cores, 67 TFLOP/s float32 outside them, 3.35
TB/s of device memory.

Where this differs from the port's own per-kernel bounds: the 'high'
tier's products (K4, and K5 for their gradients) are counted here as one
float32-exact product each, read and written once, whatever number of
split bf16 products an implementation runs; the fused vertex path (K1, K2)
is counted as the port counts it.
"""

from __future__ import annotations

from typing import Dict

PEAK_BF16 = 989e12  # FLOP/s
PEAK_F32 = 67e12  # FLOP/s, not on the tensor cores
PEAK_BYTES = 3.35e12  # bytes/s


def bound_s(nbytes: float, bf16: float = 0.0, f32: float = 0.0) -> float:
    """Least seconds for work that moves ``nbytes`` and does these operations."""
    return max(nbytes / PEAK_BYTES, bf16 / PEAK_BF16 + f32 / PEAK_F32)


def skinning(B: int, C: int, J: int, V: int) -> Dict[str, float]:
    """The fused vertex path at B bodies: forward (verts = camera . blend(A12,
    w) . (cb . basis)) and its backward. Both read cb, A12 (bf16), the camera
    (f32), the bf16 basis [3, C, V] and weights [J, V]; the forward writes
    the vertices [B, V, 3] f32 and does 2 B V (3C + 12J) bf16 operations and
    36 f32 a vertex; the backward also reads the vertices' cotangent and
    writes the three small gradients, does the products twice and 78 f32
    operations a vertex."""
    operands = 2 * B * C + 2 * B * J * 12 + 4 * B * 12 + 2 * 3 * C * V + 2 * J * V
    verts = 4 * B * V * 3
    products = 2 * B * V * (3 * C + 12 * J)
    return {
        "fwd_s": bound_s(operands + verts, bf16=products, f32=36 * B * V),
        "bwd_s": bound_s(operands + verts + 4 * (B * C + B * J * 12 + B * 12), bf16=2 * products, f32=78 * B * V),
    }


def product(M: int, K: int, N: int) -> Dict[str, float]:
    """One float32 product [M, K] x [K, N], read and written once."""
    flops = 2 * M * K * N
    nbytes = 4 * (M * K + K * N + M * N)
    return {"flops": flops, "bytes": nbytes, "s": bound_s(nbytes, bf16=flops)}


def high_products(B: int, P: int, V: int, J: int) -> Dict[str, Dict[str, float]]:
    """The 'high' tier's two products at B bodies and their gradients with
    respect to the bodies' operands: the pose correctives pf [B, P] @
    posedirs [P, 3V], the skinning blend w [V, J] . A12 [B, J, 12]; then
    g_pf = g [B, 3V] @ posedirs^T and g_A12 = w^T . g_T [B, V, 12]."""
    return {
        "correctives": product(B, P, 3 * V),
        "blend": product(V, J, 12 * B),
        "correctives_grad": product(B, 3 * V, P),
        "blend_grad": product(J, V, 12 * B),
    }


def high_pass_s(B: int, P: int, V: int, J: int) -> float:
    return sum(p["s"] for p in high_products(B, P, V, J).values())


def linear(B: int, n_in: int, n_out: int) -> float:
    return 2.0 * B * n_in * n_out


def conv(B: int, c_in: int, c_out: int, k: int, h_out: int, w_out: int) -> float:
    return 2.0 * B * c_in * c_out * k * k * h_out * w_out


def trunk_flops(B: int, c_in: int, size: int, f_dim: int, hidden: int) -> float:
    """ResNet-18 stem, layer1, layer2, the 3x3 conv and the feature linear
    on B snapshots of size x size."""
    s2, s4, s8 = size // 2, size // 4, size // 8
    f = conv(B, c_in, 64, 7, s2, s2)
    f += 4 * conv(B, 64, 64, 3, s4, s4)
    f += conv(B, 64, 128, 3, s8, s8) + 3 * conv(B, 128, 128, 3, s8, s8) + conv(B, 64, 128, 1, s8, s8)
    f += conv(B, 128, f_dim, 3, s8, s8)
    return f + linear(B, f_dim * s8 * s8, hidden)


def sampler_flops(cfg: Dict, snapshots: int, rows: int) -> float:
    """The CVAE prior sampler: the trunk(s) on the snapshots, the decoder on the rows."""
    size, c = cfg["image_size"], cfg["scene_in_channels"]
    if cfg["model_type"] == "s1":
        h = cfg["latentD"]
        dec = linear(rows, cfg["eps_d"], h) + 4 * linear(rows, 2 * h, 2 * h) + linear(rows, 2 * h, cfg["n_dim_body"])
        return trunk_flops(snapshots, c, size, 32, h) + dec
    hg, hl = cfg["latentD_g"], cfg["latentD_l"]
    g = linear(rows, hg + 32, 32) + 4 * linear(rows, 32, 32) + linear(rows, 32, 3)
    loc = linear(rows, 3, hl) + linear(rows, 2 * hl + 32, 128) + 4 * linear(rows, 128, 128) + linear(
        rows, 128, cfg["n_dim_body"] - 3)
    return trunk_flops(snapshots, c, size, 32, hg) + trunk_flops(snapshots, c, size, 128, hl) + g + loc


def vposer_decode_flops(cfg: Dict, B: int) -> float:
    v = cfg["vposer"]
    return linear(B, v["latentD"], v["num_neurons"]) + linear(B, v["num_neurons"], v["num_neurons"]) + linear(
        B, v["num_neurons"], v["num_joints"] * 6)


def decode_flops(cfg: Dict, B: int) -> float:
    """One decode of B bodies, forward: VPoser and the LBS vertex path (shape
    and pose bases, blend, skinning), without the small per-joint work."""
    b = cfg["body"]
    V, J, L = b["num_verts"], b["num_joints"], b["num_betas"]
    P = (J - 1) * 9
    vertex = 2.0 * B * V * 3 * (1 + L + P) + 2.0 * B * V * J * 12 + 2.0 * B * V * 12
    return vposer_decode_flops(cfg, B) + vertex


def contact_flops(B: int, n_contact: int, candidates: int) -> float:
    """Exact nearest-neighbour search: 8 operations a pair (3 subtractions,
    3 squares, 2 additions)."""
    return 8.0 * B * n_contact * candidates


def genfit_call_flops(cfg: Dict, population: int, num_iter: int, searches: int, candidates: int) -> float:
    """A generate+fit call: the sampler once, then per iteration the decode
    forward and backward (about 3x the forward) and, on ``searches`` of the
    iterations, the contact search."""
    n_c = cfg["body"]["n_contact"]
    return (sampler_flops(cfg, 1, population) + num_iter * 3.0 * decode_flops(cfg, population)
            + searches * contact_flops(population, n_c, candidates))


def train_step_flops(cfg: Dict, B: int, cloud: int) -> float:
    """A training step at batch B: the trunk (stage 2: both trunks), the
    encoder and decoder MLPs and the body decode, forward and backward
    (about 3x the forward), and the contact search over the whole cloud.
    Stage 2's decoders and trunks are its sampler's; its encoders add the
    global VAE's torso layer, the local VAE's pose layer, their ResBlocks
    and their mean and variance heads."""
    n = cfg["n_dim_body"]
    if cfg["model_type"] == "s1":
        h, e = cfg["latentD"], cfg["eps_d"]
        mlp = (linear(B, n, h) + 4 * linear(B, 2 * h, 2 * h) + 2 * linear(B, 2 * h, e)
               + linear(B, e, h) + 4 * linear(B, 2 * h, 2 * h) + linear(B, 2 * h, n))
        fwd = trunk_flops(B, cfg["scene_in_channels"], cfg["image_size"], 32, h) + mlp
    else:
        hg, hl = cfg["latentD_g"], cfg["latentD_l"]
        enc_g = linear(B, 3, hg) + 4 * linear(B, 2 * hg, 2 * hg) + 2 * linear(B, 2 * hg, 32)
        enc_l = linear(B, n - 3, hl) + 4 * linear(B, 3 * hl, 3 * hl) + 2 * linear(B, 3 * hl, 32)
        fwd = sampler_flops(cfg, B, B) + enc_g + enc_l
    return 3.0 * (fwd + decode_flops(cfg, B)) + contact_flops(B, cfg["body"]["n_contact"], cloud)
