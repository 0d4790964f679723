"""The native host runtime: psi_tpu_torch.data.native_loader against psi_tpu's
and against numpy, on the same arrays and files.

The port builds the repository's native/psi_native.cpp into
build/native/libpsi_native_<hash>.so; psi_tpu's module builds the same
source beside it. Packs and batches are compared byte for byte (both run
the same C++ on the same arrays); the nearest-neighbour distances within
1e-5 of numpy's (f32 sums in another order), indices equal.
"""

import json

import h5py
import numpy as np
import pytest
import torch

from psi_tpu.data import native_loader as jnl
from psi_tpu_torch.data import native_loader as nl
from psi_tpu_torch.data.synthetic import SyntheticBatchGenerator, make_synthetic_assets
from psi_tpu_torch.train.loop import TrainOP
from psi_tpu_torch.utils.config import LossConfig, TrainConfig

torch.set_num_threads(1)


def _arrays(rng, n):
    return dict(
        depth=rng.normal(size=(n, 128 * 128)).astype(np.float32),
        seg=rng.normal(size=(n, 128 * 128)).astype(np.float32),
        body=rng.normal(size=(n, 72)).astype(np.float32),
        cam_ext=np.tile(np.eye(4, dtype=np.float32).reshape(1, 16), (n, 1)),
        cam_int=np.tile(np.eye(3, dtype=np.float32).reshape(1, 9), (n, 1)),
        max_d=np.full(n, 6.0, np.float32),
        sceneid=(np.arange(n) % 3).astype(np.int32),
    )


def _write_hdf5(path, rng, n):
    """The reference layout: row 0 of every stream is a placeholder."""
    with h5py.File(path, "w") as f:
        f["depth"] = rng.normal(size=(n + 1, 1, 128, 128)).astype(np.float32)
        f["seg"] = rng.normal(size=(n + 1, 1, 128, 128)).astype(np.float32)
        f["body"] = rng.normal(size=(n + 1, 72)).astype(np.float32)
        f["cam_ext"] = np.tile(np.eye(4, dtype=np.float32), (n + 1, 1, 1))
        f["cam_int"] = np.tile(np.eye(3, dtype=np.float32), (n + 1, 1, 1))
        f["max_d"] = np.full((n + 1, 1), 6.0, np.float32)
        f["sceneid"] = (np.arange(n + 1) % 2).reshape(-1, 1).astype(np.float64)
    return str(path)


def test_chamfer_nn_cpu_matches_numpy_and_psi_tpu():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(200, 3)).astype(np.float32)
    y = rng.normal(size=(333, 3)).astype(np.float32)
    dist, idx = nl.chamfer_nn_cpu(x, y)
    d = ((x[:, None, :] - y[None, :, :]) ** 2).sum(-1)
    np.testing.assert_allclose(dist, d.min(1), atol=1e-5)
    np.testing.assert_array_equal(idx, d.argmin(1))
    jd, ji = jnl.chamfer_nn_cpu(x, y)
    np.testing.assert_array_equal(dist, jd)
    np.testing.assert_array_equal(idx, ji)


@pytest.mark.parametrize("x, y", [(np.zeros((4, 2)), np.zeros((5, 3))), (np.zeros(12), np.zeros((5, 3))),
                                  (np.zeros((4, 3)), np.zeros((0, 3)))])
def test_chamfer_nn_cpu_refuses_what_the_library_would_misread(x, y):
    """Only [N, 3] against a non-empty [M, 3] reaches the pointers."""
    with pytest.raises(ValueError, match=r"x \[N, 3\] and y \[M, 3\]"):
        nl.chamfer_nn_cpu(x, y)


def test_pack_equals_psi_tpus_byte_for_byte(tmp_path):
    a = _arrays(np.random.default_rng(1), 12)
    nl.pack_dataset(str(tmp_path / "port.psipack"), *a.values())
    jnl.pack_dataset(str(tmp_path / "jax.psipack"), *a.values())
    assert (tmp_path / "port.psipack").read_bytes() == (tmp_path / "jax.psipack").read_bytes()


def test_hdf5_to_pack_equals_psi_tpus_byte_for_byte(tmp_path):
    h5 = _write_hdf5(tmp_path / "x.hdf5", np.random.default_rng(2), 8)
    nl.hdf5_to_pack(h5, str(tmp_path / "port.psipack"))
    jnl.hdf5_to_pack(h5, str(tmp_path / "jax.psipack"))
    assert (tmp_path / "port.psipack").read_bytes() == (tmp_path / "jax.psipack").read_bytes()
    gen = nl.NativeBatchGenerator(str(tmp_path / "port.psipack"), batch_size=2)
    assert gen.n_samples == 8 and gen.next_batch() is not None
    gen.close()


def test_batches_equal_psi_tpus_over_two_epochs(tmp_path):
    path = str(tmp_path / "d.psipack")
    nl.pack_dataset(path, *_arrays(np.random.default_rng(3), 20).values())
    ours, theirs = nl.NativeBatchGenerator(path, 4, seed=0), jnl.NativeBatchGenerator(path, 4, seed=0)
    for _ in range(2):
        n = 0
        while ours.has_next_batch():
            assert theirs.has_next_batch()
            a, b = ours.next_batch(), theirs.next_batch()
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
            n += 1
        assert n == 5 and not theirs.has_next_batch()
        ours.reset()
        theirs.reset()
    ours.close()


def test_pack_loader_roundtrip(tmp_path):
    """tests/test_native.py's round trip: every sample once an epoch, shuffled,
    and an epoch after reset."""
    a = _arrays(np.random.default_rng(4), 20)
    path = str(tmp_path / "data.psipack")
    nl.pack_dataset(path, *a.values())
    gen = nl.NativeBatchGenerator(path, batch_size=4, seed=0)
    assert gen.n_samples == 20
    seen = []
    while gen.has_next_batch():
        b = gen.next_batch()
        assert b["xs"].shape == (4, 128, 128, 2) and b["xh"].shape == (4, 72)
        assert b["cam_ext"].shape == (4, 4, 4) and set(np.unique(b["scene_idx"])) <= {0, 1, 2}
        seen.append(b["xh"])
    assert len(seen) == 5
    seen = np.concatenate(seen)
    np.testing.assert_array_equal(seen[np.lexsort(seen.T)], a["body"][np.lexsort(a["body"].T)])
    assert not np.array_equal(seen, a["body"])  # shuffled
    gen.reset()
    assert gen.has_next_batch() and gen.next_batch() is not None
    with pytest.raises(ValueError, match="batches of 4"):
        gen.next_batch(8)
    gen.close()


def test_trainop_epoch_from_the_native_loader(tmp_path):
    """One CPU TrainOP epoch (s1, 128 x 128 snapshots, batch 4) from the pack:
    one finite metrics.jsonl row a step."""
    path = str(tmp_path / "d.psipack")
    gen = SyntheticBatchGenerator(num_scenes=2, batches_per_epoch=3, seed=5)  # 128 x 128 snapshots
    b = [gen.next_batch(4) for _ in range(3)]
    cat = {k: np.concatenate([x[k] for x in b]) for k in b[0]}
    nl.pack_dataset(path, cat["xs"][..., 0], cat["xs"][..., 1], cat["xh"], cat["cam_ext"], cat["cam_int"],
                    cat["max_d"], cat["scene_idx"])
    assets, _ = make_synthetic_assets(num_verts=128, num_joints=12, num_scenes=2, sdf_dim=16, scene_points=300,
                                      n_contact=32)
    cfg = TrainConfig(model_type="s1", latentD=32, batch_size=4, epoch=1, save_dir=str(tmp_path / "ckpt"),
                      verbose=False)
    TrainOP(cfg, LossConfig(), assets, device="cpu").train(nl.NativeBatchGenerator(path, 4, seed=0))
    rows = [json.loads(line) for line in open(tmp_path / "ckpt" / "metrics.jsonl")]
    assert len(rows) == 3 and all(np.isfinite(v) for r in rows for v in r.values())


def test_build_writes_only_under_build_native(tmp_path, monkeypatch):
    """The library lands in build/native under a name hashed from the source;
    the source's directory is left as it was."""
    assert nl.library_path().parent == nl.ROOT / "build" / "native"
    src = tmp_path / "native" / "psi_native.cpp"
    src.parent.mkdir()
    src.write_bytes(nl.SRC_PATH.read_bytes())
    monkeypatch.setattr(nl, "SRC_PATH", src)
    monkeypatch.setattr(nl, "BUILD_DIR", tmp_path / "build" / "native")
    out = nl.build_library()
    assert out.parent == tmp_path / "build" / "native" and out.name.startswith("libpsi_native_")
    assert sorted(p.name for p in src.parent.iterdir()) == ["psi_native.cpp"]
    assert [p.name for p in out.parent.iterdir()] == [out.name]


def test_a_failed_build_raises_with_the_compilers_output(tmp_path, monkeypatch):
    src = tmp_path / "psi_native.cpp"
    src.write_text("this is not C++;\n")
    monkeypatch.setattr(nl, "SRC_PATH", src)
    monkeypatch.setattr(nl, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(nl, "_lib", None)
    with pytest.raises(RuntimeError, match=r"(?s)g\+\+ failed .*error: "):
        nl.get_lib()
    assert nl.native_available() is False
    assert list((tmp_path / "build").iterdir()) == []  # the temporary file is gone too
