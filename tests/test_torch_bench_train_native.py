"""``psi_tpu_torch.scripts.bench_train_native`` (the native-loader training
soak) on the CPU: its pack against the one ``scripts/bench_train_native.py``
writes, and one run at narrow body widths with ``--device cpu``.

* The pack: psi_tpu's script is run up to the end of its packing code (its
  ``make_synthetic_assets`` stops it) with the port's
  ``SyntheticBatchGenerator`` in place of psi_tpu's: the two generators draw
  the same numbers, but psi_tpu's rotation matrices differ from the port's
  by one ulp in ``cam_ext``, so "the same generator" is the port's. The two
  .psipack files must be equal byte for byte.
* The run: bodies of 300 vertices, 12 joints, 16^3 grids, 512-point clouds,
  32 contact vertices, latentD 32 (the pack's 128x128 images are the
  loader's fixed size); 16 samples, batch 4, chunk 2, 2 epochs after the
  warm-up epoch. K3 runs its plain twin on the CPU; the twin is wrapped to
  count as a launch. Exact counts; the chunked epoch equal in bits to the
  per-step loop (the CPU's sums are deterministic).
"""

import ast
import importlib.util
import json
import tempfile
from pathlib import Path

import pytest
import torch

import psi_tpu.data.synthetic as j_synthetic
from psi_tpu_torch.data import native_loader as nl
from psi_tpu_torch.data.native_loader import NativeBatchGenerator
from psi_tpu_torch.data.synthetic import SyntheticBatchGenerator
from psi_tpu_torch.ops import chamfer
from psi_tpu_torch.scripts import bench_train_native as soak_script

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
JAX_SCRIPT = ROOT / "scripts" / "bench_train_native.py"
NARROW = dict(num_verts=300, num_joints=12, num_scenes=4, sdf_dim=16, scene_points=512, n_contact=32, seed=0)
SAMPLES, BATCH, CHUNK, EPOCHS = 16, 4, 2, 2


class _Stop(Exception):
    pass


def _jax_script_pack(monkeypatch, tmp_path, n):
    """The pack psi_tpu's script writes for ``--samples n``, from the port's generator."""
    spec = importlib.util.spec_from_file_location("j_bench_train_native", JAX_SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    def stop(*a, **k):
        raise _Stop

    monkeypatch.setattr(j_synthetic, "SyntheticBatchGenerator", SyntheticBatchGenerator)
    monkeypatch.setattr(j_synthetic, "make_synthetic_assets", stop)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    monkeypatch.setattr("sys.argv", ["bench_train_native.py", "--samples", str(n)])
    with pytest.raises(_Stop):
        mod.main()
    return tmp_path / f"soak_{n}.psipack"


def test_pack_equals_psi_tpus_script_byte_for_byte(monkeypatch, tmp_path):
    n = 64
    (tmp_path / "jax").mkdir()
    theirs = _jax_script_pack(monkeypatch, tmp_path / "jax", n)
    ours = soak_script.pack_synthetic(str(tmp_path / "port.psipack"), n)
    a, b = Path(ours).read_bytes(), theirs.read_bytes()
    assert len(a) == len(b) > n * 131_468
    assert a == b


class _RecordingLoader(NativeBatchGenerator):
    """The native loader, keeping the body rows it serves in each epoch."""

    epochs = []

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        _RecordingLoader.epochs = [[]]

    def next_batch(self, batch_size=None):
        b = super().next_batch(batch_size)
        if b is not None:
            _RecordingLoader.epochs[-1].extend(r.tobytes() for r in b["xh"])
        return b

    def reset(self):
        super().reset()
        _RecordingLoader.epochs.append([])


@pytest.fixture(scope="module")
def narrow_run(tmp_path_factory):
    """main(--device cpu) at narrow body widths: (record, served rows by epoch, pack rows, K3 twin calls)."""
    mp = pytest.MonkeyPatch()
    calls = []
    twin = chamfer.nn_argmin_reference

    def counted_twin(x, y):
        calls.append(x.shape)
        chamfer.NN_ARGMIN.launches += 1
        return twin(x, y)

    work = tmp_path_factory.mktemp("soak")
    try:
        mp.setattr(soak_script, "ASSET_KW", NARROW)
        mp.setattr(soak_script, "LATENT_D", 32)
        mp.setattr(chamfer, "nn_argmin_reference", counted_twin)
        mp.setattr(nl, "NativeBatchGenerator", _RecordingLoader)
        rec = soak_script.main(["--samples", str(SAMPLES), "--batch", str(BATCH), "--chunk", str(CHUNK),
                                "--epochs", str(EPOCHS), "--device", "cpu", "--pack_dir", str(work)])
        loader = NativeBatchGenerator(str(work / f"soak_{SAMPLES}.psipack"), SAMPLES, seed=0)
        pack_rows = sorted(r.tobytes() for r in loader.next_batch()["xh"])
        loader.close()
    finally:
        mp.undo()
    return rec, _RecordingLoader.epochs, pack_rows, calls


def test_narrow_run_counts_steps_loader_calls_and_k3_launches(narrow_run):
    rec, _, _, calls = narrow_run
    steps = EPOCHS * (SAMPLES // BATCH)
    assert rec["steps"] == rec["logged_steps"] == rec["loader_calls"] == steps
    assert rec["launches"] == {"fused_skinning_fwd": 0, "fused_skinning_bwd": 0, "chamfer_nn_argmin": steps}
    assert rec["warmup_launches"]["chamfer_nn_argmin"] == SAMPLES // BATCH
    # one search a step, over the whole cloud at the batch's size; then the per-step check's CHUNK steps
    assert len(calls) == steps + SAMPLES // BATCH + CHUNK
    assert all(c == (BATCH, NARROW["n_contact"], 3) for c in calls)


def test_narrow_run_serves_every_sample_once_an_epoch(narrow_run):
    _, epochs, pack_rows, _ = narrow_run
    assert epochs[-1] == []  # TrainOP.train resets the loader at the end of every epoch
    served = epochs[:-1]
    assert len(served) == 1 + EPOCHS  # the warm-up and the timed epochs
    for e in served:
        assert sorted(e) == pack_rows
    assert served[0] != served[1]  # each epoch reshuffled


def test_narrow_run_record(narrow_run):
    rec, _, _, _ = narrow_run
    assert 0.0 <= rec["loader_occupancy"] <= 1.0
    assert rec["metrics_finite"] and rec["device"] == "cpu" and rec["card"] is None and rec["peak_gb"] is None
    assert rec["pack_mb"] == pytest.approx(SAMPLES * 131_468 / 1e6, abs=1e-3)
    assert rec["steps_per_sec"] == pytest.approx(rec["steps"] / rec["wall_s"])


def test_json_keys_are_a_superset_of_psi_tpus(narrow_run):
    rec, _, _, _ = narrow_run
    tree = ast.parse(JAX_SCRIPT.read_text())
    dicts = [d for d in ast.walk(tree) if isinstance(d, ast.Dict)
             and any(isinstance(k, ast.Constant) and k.value == "metric" for k in d.keys)]
    assert len(dicts) == 1
    theirs = {k.value for k in dicts[0].keys}
    assert "loader_occupancy" in theirs and theirs <= set(rec)
    assert rec["metric"] == "train_steps_per_sec_native_loader"


def test_chunked_epoch_equals_the_per_step_loop(narrow_run):
    rec, _, _, _ = narrow_run
    assert rec["scan_vs_step_steps"] == CHUNK
    assert rec["scan_vs_step_equal"] and rec["scan_vs_step_rel_by_step"] == [0.0] * CHUNK


def test_main_prints_one_json_line(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    monkeypatch.setattr(soak_script, "ASSET_KW", NARROW)
    monkeypatch.setattr(soak_script, "LATENT_D", 32)
    rec = soak_script.main(["--samples", "8", "--batch", "4", "--chunk", "2", "--epochs", "1", "--device", "cpu",
                            "--stage_bf16"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line) == json.loads(json.dumps(rec)) and rec["stage_bf16"] and rec["steps"] == 2
    assert not list(tmp_path.iterdir())  # its default directory is removed


def test_raises_without_a_card_unless_given_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs an NVIDIA card"):
        soak_script.main(["--samples", "8"])
