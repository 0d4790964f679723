"""The fused-skinning bundle's padded operands, the layout K1 and K2 read.

The kernels (csrc/fused_skinning.cu) stage their operands with 16-byte
copies and tile them without ragged edges, so the bundle carries the basis
and the weights zero-padded: C to a multiple of PAD_C, V of PAD_V, J of
PAD_J. These tests hold the padded copies, in their valid region, to the
unpadded operands rebuilt from the model tensors and to psi_tpu's own
padded bundle, to exact zeros in the padding, their row pitches to
multiples of 8 bf16 (16 bytes), and the twins computed from them to the
twins computed from unpadded operands.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psi_tpu.body.smplx_model import synthetic_smplx as j_synthetic_smplx
from psi_tpu.ops import fused_skinning as jfs
from psi_tpu_torch.body.smplx_model import synthetic_smplx
from psi_tpu_torch.ops import fused_skinning as tfs

torch.set_num_threads(1)
# (V, J): the CPU parity shape, SMPL-X's joint count, and the card tests'
# shape that is ragged on every padded axis
SHAPES = [(300, 12), (1001, 55), (2051, 55)]


@pytest.fixture(scope="module", params=SHAPES, ids=lambda s: f"V{s[0]}_J{s[1]}")
def bundles(request):
    V, J = request.param
    tm = synthetic_smplx(num_verts=V, num_joints=J, seed=0)
    jm = j_synthetic_smplx(num_verts=V, num_joints=J, seed=0)
    tb = tfs.make_skinning_bundle(tm.v_template, tm.shapedirs, tm.posedirs, tm.lbs_weights)
    jb = jfs.make_skinning_bundle(jm.v_template, jm.shapedirs, jm.posedirs, jm.lbs_weights)
    return tb, jb, V, J, _unpadded(tm)


def _unpadded(tm):
    """(base [3, C, V], w_jv [J, V]) in bf16, from the model tensors: rows
    [v_template | shapedirs | posedirs], as psi_tpu's bundle orders them."""
    V = tm.lbs_weights.shape[0]
    base = torch.cat([tm.v_template.T[:, None, :], tm.shapedirs.permute(1, 2, 0),
                      tm.posedirs.reshape(-1, V, 3).permute(2, 0, 1)], dim=1)
    return base.to(torch.bfloat16).contiguous(), tm.lbs_weights.T.to(torch.bfloat16).contiguous()


def _f(t):
    return t.float().numpy()


def test_padded_shapes_and_row_pitches(bundles):
    tb, _, V, J, (base, _) = bundles
    C = tb.n_feat
    Cp, Vp, Jp = (-(-C // tfs.PAD_C) * tfs.PAD_C, -(-V // tfs.PAD_V) * tfs.PAD_V, -(-J // tfs.PAD_J) * tfs.PAD_J)
    assert tb.base_cvp.shape == (3, Cp, Vp) and tb.base_vcp.shape == (3, Vp, Cp)
    assert tb.w_jvp.shape == (Jp, Vp) and tb.w_vjp.shape == (Vp, Jp)
    tensors = [t for t in tb if isinstance(t, torch.Tensor)]
    assert len(tensors) == 4  # the padded copies only: no unpadded layout is kept
    for t in tensors:
        assert t.dtype == torch.bfloat16 and t.is_contiguous()
        assert t.stride(-2) % 8 == 0  # every row starts on a 16-byte boundary
    # the valid widths ride along as integers
    assert (tb.n_feat, tb.n_verts, tb.n_joints) == (base.shape[1], V, J)


def test_padded_operands_equal_unpadded_in_valid_region(bundles):
    tb, _, V, J, (base, w_jv) = bundles
    C = tb.n_feat
    np.testing.assert_array_equal(_f(tb.base_cvp[:, :C, :V]), _f(base))
    np.testing.assert_array_equal(_f(tb.base_vcp[:, :V, :C]), _f(base.transpose(1, 2)))
    np.testing.assert_array_equal(_f(tb.w_jvp[:J, :V]), _f(w_jv))
    np.testing.assert_array_equal(_f(tb.w_vjp[:V, :J]), _f(w_jv.T))


def test_padding_is_exactly_zero(bundles):
    tb, _, V, J, _ = bundles
    C = tb.n_feat
    for t, valid in ((tb.base_cvp, (slice(None), slice(0, C), slice(0, V))),
                     (tb.base_vcp, (slice(None), slice(0, V), slice(0, C))),
                     (tb.w_jvp, (slice(0, J), slice(0, V))),
                     (tb.w_vjp, (slice(0, V), slice(0, J)))):
        pad = t.clone()
        pad[valid] = 0
        assert int(torch.count_nonzero(pad)) == 0


def test_padded_operands_equal_psi_tpu_bundle(bundles):
    """psi_tpu pads to its own multiples (C to 128, V to 256, J to 128):
    both hold the same bf16 values where both have room, zeros elsewhere."""
    tb, jb, V, J, _ = bundles
    Cp, Vp = tb.base_cvp.shape[1:]
    Jp = tb.w_jvp.shape[0]
    for y in range(3):
        jc = np.asarray(jb.base_cv[y].astype(jnp.float32))
        c, v = min(Cp, jc.shape[0]), min(Vp, jc.shape[1])
        np.testing.assert_array_equal(_f(tb.base_cvp[y, :c, :v]), jc[:c, :v])
        np.testing.assert_array_equal(_f(tb.base_vcp[y, :v, :c]), np.asarray(jb.base_vc[y].astype(jnp.float32))[:v, :c])
    jw = np.asarray(jb.w_vj.astype(jnp.float32))
    v, j = min(Vp, jw.shape[0]), min(Jp, jw.shape[1])
    np.testing.assert_array_equal(_f(tb.w_vjp[:v, :j]), jw[:v, :j])
    np.testing.assert_array_equal(_f(tb.w_jvp[:j, :v]), np.asarray(jb.w_jv.astype(jnp.float32))[:j, :v])


def test_twins_from_padded_copies_equal_twins_from_unpadded_operands(bundles):
    """The twins read the valid region of the padded copies. Given a bundle
    that holds the unpadded operands themselves (Cp = C, Vp = V, Jp = J) they
    must return the same bits: the padding never enters a sum. B = 7 bodies,
    not a multiple of 8."""
    tb, _, V, J, (base, w_jv) = bundles
    C = tb.n_feat
    bare = tfs.SkinningBundle(base, base.transpose(1, 2).contiguous(), w_jv, w_jv.T.contiguous(), V, C, J)
    rng = np.random.default_rng(3)
    cb, A12, cam12, g = (torch.from_numpy(rng.normal(0, s, shape).astype(np.float32))
                         for s, shape in ((0.3, (7, C)), (0.5, (7, J, 12)), (1.0, (7, 12)), (1.0, (7, V, 3))))
    np.testing.assert_array_equal(tfs.fused_skinning_fwd_reference(cb, A12, cam12, tb).numpy(),
                                  tfs.fused_skinning_fwd_reference(cb, A12, cam12, bare).numpy())
    for a, b in zip(tfs.fused_skinning_bwd_reference(cb, A12, cam12, tb, g),
                    tfs.fused_skinning_bwd_reference(cb, A12, cam12, bare, g)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
