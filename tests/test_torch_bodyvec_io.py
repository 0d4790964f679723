"""The pickle codecs: psi_tpu_torch.geometry.bodyvec's body_params_parse,
body_params_encapsulate_list and body_params_encapsulate_latent vs psi_tpu's,
on the same numpy arrays made from a seed.

The codecs slice and concatenate, they compute nothing: every comparison is
exact (values, dtypes, shapes and key order), no tolerance.
"""

import pickle

import numpy as np
import pytest
import torch

from psi_tpu.geometry import bodyvec as jbv
from psi_tpu_torch.geometry import bodyvec as tbv

N = 5
KEYS = ["transl", "global_orient", "betas", "body_pose", "left_hand_pose", "right_hand_pose"]


@pytest.fixture(scope="module")
def x72():
    return np.random.default_rng(0).normal(0, 1, (N, 72)).astype(np.float32)


def _assert_same_records(ours, theirs):
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert list(a) == list(b)
        for k in a:
            va, vb = a[k], np.asarray(b[k])
            assert type(va) is np.ndarray and va.dtype == vb.dtype and va.shape == vb.shape, k
            np.testing.assert_array_equal(va, vb)


def test_encapsulate_list_matches_jax_key_for_key(x72):
    ours = tbv.body_params_encapsulate_list(x72)
    _assert_same_records(ours, jbv.body_params_encapsulate_list(x72))
    assert list(ours[0]) == KEYS
    assert all(v.shape == (1, w) and v.dtype == np.float32
               for v, w in zip(ours[0].values(), (3, 3, 10, 32, 12, 12)))


def test_encapsulate_latent_matches_jax_and_carries_z(x72):
    eps = np.random.default_rng(1).normal(0, 1, (N, 32)).astype(np.float32)
    ours = tbv.body_params_encapsulate_latent(x72, eps)
    _assert_same_records(ours, jbv.body_params_encapsulate_latent(x72, eps))
    assert list(ours[0]) == KEYS + ["z"] and ours[2]["z"].shape == (1, 32)
    np.testing.assert_array_equal(ours[2]["z"][0], eps[2])


@pytest.mark.parametrize("n_eps", [N - 1, N + 1])
def test_encapsulate_latent_rejects_a_batch_mismatch(x72, n_eps):
    eps = np.zeros((n_eps, 32), np.float32)
    with pytest.raises(ValueError, match="eps batch"):
        tbv.body_params_encapsulate_latent(x72, eps)
    with pytest.raises(ValueError):
        jbv.body_params_encapsulate_latent(x72, eps)


def test_parse_matches_jax_and_inverts_encapsulate(x72):
    recs = tbv.body_params_encapsulate_list(x72)
    for i, rec in enumerate(recs):
        got = tbv.body_params_parse(rec)
        assert torch.is_tensor(got) and got.dtype == torch.float32 and got.shape == (1, 72)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jbv.body_params_parse(rec)))
        np.testing.assert_array_equal(got.numpy(), x72[i : i + 1])
    # the tensor codec's dict, batched: parse o encapsulate is the identity there too
    t = torch.from_numpy(x72)
    assert torch.equal(tbv.body_params_parse(tbv.body_params_encapsulate(t)), t)


def test_parse_takes_body_pose_as_an_alias_and_casts_to_float32(x72):
    rec = tbv.body_params_encapsulate_list(x72.astype(np.float64))[0]
    assert "body_pose" in rec and "body_pose_vp" not in rec
    got = tbv.body_params_parse(rec)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), x72[:1])
    named = dict(rec)
    named["body_pose_vp"] = named.pop("body_pose")
    assert torch.equal(tbv.body_params_parse(named), got)
    both = dict(rec, body_pose_vp=np.zeros((1, 32), np.float32))  # the proper key wins, as in psi_tpu
    np.testing.assert_array_equal(tbv.body_params_parse(both).numpy(), np.asarray(jbv.body_params_parse(both)))


def test_records_pickle_as_plain_numpy(x72):
    """What reaches pickle.dump holds numpy arrays only, and a record
    written from psi_tpu's codec reads back through the port's parser."""
    blob = pickle.dumps(tbv.body_params_encapsulate_list(x72)[1])
    assert b"torch" not in blob and b"jax" not in blob
    back = pickle.loads(pickle.dumps(jbv.body_params_encapsulate_list(x72)[1]))
    np.testing.assert_array_equal(tbv.body_params_parse(back).numpy(), x72[1:2])
