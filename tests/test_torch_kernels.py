"""The CUDA kernels K1, K2 and K3 against their plain twins, on the card.

Every test here needs an NVIDIA card and skips without one: the kernels
have no CPU mode, and their twins' agreement with psi_tpu is checked on
the CPU by test_torch_fused_skinning.py and test_torch_chamfer.py. This
file imports neither JAX nor psi_tpu, so it runs on a machine that has
only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

(``--noconftest`` skips tests/conftest.py, which sets JAX up.) Inputs are
made with numpy from a seed. Shapes include ragged edges: bodies not a
multiple of a block's body tile, vertices not a multiple of a vertex
tile, clouds not a multiple of a shared-memory tile.
"""

import numpy as np
import pytest
import torch

from psi_tpu_torch.body.smplx_model import fused_operands, synthetic_smplx
from psi_tpu_torch.ops import chamfer as tch
from psi_tpu_torch.ops import fused_skinning as tfs

torch.set_num_threads(1)

# (B, V, J): the CPU parity shape, and a ragged one at SMPL-X's joint count
SKIN_SHAPES = [(5, 300, 12), (13, 1001, 55)]
# (B, N, M): N ragged against 256 threads, M across and ragged against 1024-point tiles
NN_SHAPES = [(3, 200, 700), (2, 300, 3000)]


@pytest.fixture
def card():
    """The CUDA kernels have no CPU mode: these tests need a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _skinning_case(shape, dev):
    """Bundle, (cb, A12, cam12) and a cotangent g on ``dev``, from a seed."""
    B, V, J = shape
    model = synthetic_smplx(num_verts=V, num_joints=J, seed=0)
    rng = np.random.default_rng(1)
    cam = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    th = rng.normal(0, 0.3, B)
    cam[:, 0, 0], cam[:, 0, 1], cam[:, 1, 0], cam[:, 1, 1] = np.cos(th), -np.sin(th), np.sin(th), np.cos(th)
    cam[:, :3, 3] = rng.normal(0, 0.5, (B, 3))

    def t(a):
        return torch.from_numpy(a.astype(np.float32))

    with torch.no_grad():
        ops = fused_operands(
            model, transl=t(rng.normal(0, 0.5, (B, 3))), global_orient=t(rng.normal(0, 0.3, (B, 3))),
            betas=t(rng.normal(0, 1.0, (B, 10))), body_pose=t(rng.normal(0, 0.3, (B, 63))),
            left_hand_pose=t(rng.normal(0, 0.5, (B, 12))) if J == 55 else None,
            right_hand_pose=t(rng.normal(0, 0.5, (B, 12))) if J == 55 else None,
            cam_ext=t(cam),
        )[:3]
    bundle = tfs.make_skinning_bundle(model.v_template, model.shapedirs, model.posedirs, model.lbs_weights)
    bundle = tfs.SkinningBundle(*(x.to(dev) for x in bundle[:4]), bundle.n_verts, bundle.n_feat)
    g = t(rng.normal(0, 1.0, (B, V, 3)))
    return bundle, tuple(o.to(dev) for o in ops), g.to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SKIN_SHAPES)
def test_k1_kernel_matches_twin(shape, card):
    bundle, ops, _ = _skinning_case(shape, card)
    n = tfs.SKIN_FWD.launches
    vk = tfs.fused_skinning_fwd(*ops, bundle)
    assert tfs.SKIN_FWD.launches == n + 1
    vt = tfs.fused_skinning_fwd_reference(*ops, bundle)
    torch.cuda.synchronize()
    assert vk.shape == (shape[0], shape[1], 3)
    # the same bf16 operands; f32 sums over C and J in another order
    assert (vk - vt).abs().max().item() < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SKIN_SHAPES)
def test_k2_kernel_matches_twin_and_is_deterministic(shape, card):
    bundle, ops, g = _skinning_case(shape, card)
    n = tfs.SKIN_BWD.launches
    k1 = tfs.fused_skinning_bwd(*ops, bundle, g)
    k2 = tfs.fused_skinning_bwd(*ops, bundle, g)
    assert tfs.SKIN_BWD.launches == n + 2
    tw = tfs.fused_skinning_bwd_reference(*ops, bundle, g)
    torch.cuda.synchronize()
    for a, b, t in zip(k1, k2, tw):
        assert a.shape == t.shape
        assert torch.equal(a, b)  # no atomics: bit-identical runs
        # an f32 value computed in another order can round to the
        # neighbouring bf16 before the reduction (2^-8 of one summand)
        assert ((a - t).abs().max() / t.abs().max()).item() < 1e-3


@pytest.mark.cuda
def test_fused_apply_autograd_runs_both_kernels(card):
    bundle, ops, g = _skinning_case(SKIN_SHAPES[1], card)
    args = [o.clone().requires_grad_(True) for o in ops]
    n = (tfs.SKIN_FWD.launches, tfs.SKIN_BWD.launches)
    out = tfs.fused_skinning_apply(*args, bundle)
    out.backward(g)
    assert (tfs.SKIN_FWD.launches, tfs.SKIN_BWD.launches) == (n[0] + 1, n[1] + 1)
    for a, b in zip(args, tfs.fused_skinning_bwd(*ops, bundle, g)):
        assert torch.equal(a.grad, b)


@pytest.mark.cuda
def test_skinning_rejects_operands_it_does_not_take(card):
    bundle, (cb, A12, cam12), _ = _skinning_case(SKIN_SHAPES[0], card)
    with pytest.raises(ValueError):  # basis width does not match cb
        tfs.fused_skinning_fwd(cb[:, :-1].contiguous(), A12, cam12, bundle)
    with pytest.raises(ValueError):  # bundle left on another device
        tfs.fused_skinning_fwd(cb, A12, cam12, bundle._replace(w_jv=bundle.w_jv.cpu()))


def _clouds(shape, dev):
    B, N, M = shape
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1.0, (B, N, 3)).astype(np.float32)
    y = rng.uniform(-2, 2, (B, M, 3)).astype(np.float32)
    y[:, -20:] = 1.0e5  # registry-style far padding never wins
    return torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", NN_SHAPES)
def test_k3_kernel_matches_twin(shape, card):
    x, y = _clouds(shape, card)
    n = tch.NN_ARGMIN.launches
    ik = tch.nn_argmin(x, y)
    assert tch.NN_ARGMIN.launches == n + 1
    it = tch.nn_argmin_reference(x, y)
    torch.cuda.synchronize()
    assert ik.shape == it.shape == shape[:2]
    dk = ((x - tch._gather_points(y, ik)) ** 2).sum(-1)
    dt = ((x - tch._gather_points(y, it)) ** 2).sum(-1)
    # both evaluate the same f32 distance; winners differ only between
    # points at equal distance
    assert torch.equal(dk, dt)


@pytest.mark.cuda
def test_k3_kernel_ties_go_to_lowest_index(card):
    y = torch.zeros((1, 3000, 3), device=card)  # 3000 identical points, across tiles
    x = torch.ones((1, 300, 3), device=card)
    assert int(tch.nn_argmin(x, y).max()) == 0


@pytest.mark.cuda
def test_chamfer_gradients_on_card_match_cpu(card):
    """chamfer_one_sided's forward and its scatter backward, on the card
    through K3 and on the CPU through the twin: the same winners, the
    same f32 math, summed in another order by index_add_ (1e-6)."""
    x, y = _clouds(NN_SHAPES[1], card)
    w = torch.from_numpy(np.random.default_rng(1).normal(size=NN_SHAPES[1][:2]).astype(np.float32))
    grads = []
    for dev in (card, torch.device("cpu")):
        xd = x.detach().to(dev).requires_grad_(True)
        yd = y.detach().to(dev).requires_grad_(True)
        d = tch.chamfer_one_sided(xd, yd)
        (d * w.to(dev)).sum().backward()
        grads.append((d.detach().cpu(), xd.grad.cpu(), yd.grad.cpu()))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


@pytest.mark.cuda
def test_nn_argmin_rejects_operands_it_does_not_take(card):
    x, y = _clouds(NN_SHAPES[0], card)
    with pytest.raises(TypeError):
        tch.nn_argmin(x.double(), y.double())
    with pytest.raises(ValueError):
        tch.nn_argmin(x, y.cpu())
