"""The fused-skinning bundle's padded operands, the layout K2 reads.

K2 (csrc/fused_skinning.cu) stages its operands with 16-byte copies and
tiles them without ragged edges, so the bundle carries zero-padded copies
of the basis and the weights: C to a multiple of PAD_C, V of PAD_V, J of
PAD_J. These tests hold the padded copies to the unpadded ones and to
psi_tpu's own padded bundle in their valid region, to exact zeros in the
padding, and their row pitches to multiples of 8 bf16 (16 bytes).
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
    return tb, jb, V, J


def _f(t):
    return t.float().numpy()


def test_padded_shapes_and_row_pitches(bundles):
    tb, _, V, J = bundles
    C = tb.n_feat
    Cp, Vp, Jp = (-(-C // tfs.PAD_C) * tfs.PAD_C, -(-V // tfs.PAD_V) * tfs.PAD_V, -(-J // tfs.PAD_J) * tfs.PAD_J)
    assert tb.base_cvp.shape == (3, Cp, Vp) and tb.base_vcp.shape == (3, Vp, Cp)
    assert tb.w_jvp.shape == (Jp, Vp) and tb.w_vjp.shape == (Vp, Jp)
    for t in tb[:6]:
        assert t.dtype == torch.bfloat16 and t.is_contiguous()
    for t in (tb.base_cvp, tb.base_vcp, tb.w_jvp, tb.w_vjp):
        assert t.stride(-2) % 8 == 0  # every row starts on a 16-byte boundary
    # K1 keeps reading the unpadded layouts
    assert tb.base_cv.shape == (3, C, V) and tb.w_jv.shape == (J, V)


def test_padded_operands_equal_unpadded_in_valid_region(bundles):
    tb, _, V, J = bundles
    C = tb.n_feat
    np.testing.assert_array_equal(_f(tb.base_cvp[:, :C, :V]), _f(tb.base_cv))
    np.testing.assert_array_equal(_f(tb.base_vcp[:, :V, :C]), _f(tb.base_cv.transpose(1, 2)))
    np.testing.assert_array_equal(_f(tb.w_jvp[:J, :V]), _f(tb.w_jv))
    np.testing.assert_array_equal(_f(tb.w_vjp[:V, :J]), _f(tb.w_jv.T))


def test_padding_is_exactly_zero(bundles):
    tb, _, V, J = bundles
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
    tb, jb, V, J = bundles
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

