"""Fused skinning: the port's twins of K1/K2 vs psi_tpu's Pallas kernels.

psi_tpu runs its Pallas kernels in interpret mode on the CPU
(ops/fused_skinning.py:370). Both packages get the same model, the same
bundle contents and the same cb / A12 / cam12 from numpy. The CUDA
kernels vs the twins are in test_torch_kernels.py, which runs on a card
without JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psi_tpu.body.smplx_model import synthetic_smplx as j_synthetic_smplx
from psi_tpu.ops import fused_skinning as jfs
from psi_tpu_torch.body.smplx_model import fused_operands, synthetic_smplx
from psi_tpu_torch.ops import fused_skinning as tfs

torch.set_num_threads(1)
B, V, J = 5, 300, 12


@pytest.fixture(scope="module")
def setup():
    jm = j_synthetic_smplx(num_verts=V, num_joints=J, seed=0)
    tm = synthetic_smplx(num_verts=V, num_joints=J, seed=0)
    rng = np.random.default_rng(1)
    cam = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    th = rng.normal(0, 0.3, B)
    cam[:, 0, 0], cam[:, 0, 1], cam[:, 1, 0], cam[:, 1, 1] = np.cos(th), -np.sin(th), np.sin(th), np.cos(th)
    cam[:, :3, 3] = rng.normal(0, 0.5, (B, 3))
    with torch.no_grad():
        cb, A12, cam12, _ = fused_operands(
            tm,
            transl=torch.from_numpy(rng.normal(0, 0.5, (B, 3)).astype(np.float32)),
            global_orient=torch.from_numpy(rng.normal(0, 0.3, (B, 3)).astype(np.float32)),
            betas=torch.from_numpy(rng.normal(0, 1.0, (B, 10)).astype(np.float32)),
            body_pose=torch.from_numpy(rng.normal(0, 0.3, (B, 63)).astype(np.float32)),
            cam_ext=torch.from_numpy(cam),
        )
    ops = tuple(t.numpy() for t in (cb, A12, cam12))
    g = rng.normal(0, 1.0, (B, V, 3)).astype(np.float32)
    jb = jfs.make_skinning_bundle(jm.v_template, jm.shapedirs, jm.posedirs, jm.lbs_weights)
    return jb, tfs.make_skinning_bundle(tm.v_template, tm.shapedirs, tm.posedirs, tm.lbs_weights), ops, g


def _t(ops):
    return tuple(torch.from_numpy(o) for o in ops)


def test_bundle_matches_jax_layout(setup):
    """The unpadded bundle holds exactly psi_tpu's bf16 basis and weights."""
    jb, tb, _, _ = setup
    C = tb.n_feat
    assert (tb.n_verts, C) == (jb.n_verts, jb.n_feat) == (V, 1 + 10 + (J - 1) * 9)
    for y in range(3):
        np.testing.assert_array_equal(
            tb.base_cv[y].float().numpy(), np.asarray(jb.base_cv[y][:C, :V].astype(jnp.float32))
        )
        np.testing.assert_array_equal(tb.base_vc[y].float().numpy(), tb.base_cv[y].float().numpy().T)
    np.testing.assert_array_equal(tb.w_vj.float().numpy(), np.asarray(jb.w_vj[:V, :J].astype(jnp.float32)))
    np.testing.assert_array_equal(tb.w_jv.float().numpy(), tb.w_vj.float().numpy().T)


def test_k1_twin_matches_pallas_interpret(setup):
    """Same bf16 operands, f32 sums in another order: ~1e-6, held to 1e-4."""
    jb, tb, ops, _ = setup
    vj = np.asarray(jfs.fused_skinning_apply(*map(jnp.asarray, ops), jb))
    vt = tfs.fused_skinning_fwd_reference(*_t(ops), tb).numpy()
    assert vt.shape == (B, V, 3)
    np.testing.assert_allclose(vt, vj, atol=1e-4, rtol=0)


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max())


def test_k2_twin_matches_jax_vjp(setup):
    """Twin backward vs jax.vjp through psi_tpu's _bwd_kernel (interpret).
    Both round the same intermediates to bf16, computed from f32 values
    in another order, so a value near a rounding boundary can land on the
    neighbouring bf16 (2^-8 of one summand). Measured ~3e-7 of each
    output's largest entry; held to 1e-4."""
    jb, tb, ops, g = setup
    _, vjp = jax.vjp(lambda *a: jfs.fused_skinning_apply(*a, jb), *map(jnp.asarray, ops))
    gj = vjp(jnp.asarray(g))
    gt = tfs.fused_skinning_bwd_reference(*_t(ops), tb, torch.from_numpy(g))
    for name, a, b in zip(("g_cb", "g_A12", "g_cam12"), gt, gj):
        assert a.shape == b.shape, name
        assert _rel(a.numpy(), b) < 1e-4, (name, _rel(a.numpy(), b))


def test_k2_twin_matches_autograd_through_k1_twin(setup):
    """Autograd through the K1 twin differentiates the rounding as the
    identity (no bf16 rounding of the backward's intermediates); the K2
    twin rounds them as the TPU kernel does. g_cb sums ~3V rounded terms
    that largely cancel, so the gap is ~1e-2 of its largest entry
    (measured 0.97e-2 on random operands): held to 3e-2."""
    _, tb, ops, g = setup
    args = [t.clone().requires_grad_(True) for t in _t(ops)]
    torch.autograd.backward(tfs.fused_skinning_fwd_reference(*args, tb), torch.from_numpy(g))
    gt = tfs.fused_skinning_bwd_reference(*_t(ops), tb, torch.from_numpy(g))
    for a, b in zip(gt, args):
        assert _rel(a.numpy(), b.grad.numpy()) < 3e-2


def test_apply_autograd_routes_through_k2_twin(setup):
    """fused_skinning_apply's backward on CPU tensors is exactly the K2 twin."""
    _, tb, ops, g = setup
    args = [t.clone().requires_grad_(True) for t in _t(ops)]
    out = tfs.fused_skinning_apply(*args, tb)
    np.testing.assert_array_equal(out.detach().numpy(), tfs.fused_skinning_fwd_reference(*_t(ops), tb).numpy())
    out.backward(torch.from_numpy(g))
    for a, b in zip(args, tfs.fused_skinning_bwd_reference(*_t(ops), tb, torch.from_numpy(g))):
        np.testing.assert_array_equal(a.grad.numpy(), b.numpy())


def test_cpu_path_never_builds_kernels(setup):
    """A CPU tensor takes the twin: no launch is counted."""
    _, tb, ops, g = setup
    before = (tfs.SKIN_FWD.launches, tfs.SKIN_BWD.launches)
    tfs.fused_skinning_fwd(*_t(ops), tb)
    tfs.fused_skinning_bwd(*_t(ops), tb, torch.from_numpy(g))
    assert (tfs.SKIN_FWD.launches, tfs.SKIN_BWD.launches) == before
