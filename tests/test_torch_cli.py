"""The reference's entry points: psi_tpu_torch.cli.{train, test_proxe,
test_habitat, fitting, eval} and their shims, held to psi_tpu.cli's.

Every ``main`` builds the CLI's assets through ``cli.common.build_assets``.
Here both packages' ``build_assets`` are patched to hand out
tests/test_torch_fit_drivers.py's narrow world (128 vertices, 12 joints, 3
scenes, 16^3 SDF, 300 scene points, 32 contact vertices: the same arrays in
each package) and a registry whose row 1 is named MPH16, the scene that
world's bodies (``jax_files``: psi_tpu's TestOP pickles) are placed in. So
``cli.fitting`` and ``cli.eval`` find MPH16 through ``registry.index_of``.

Tolerances: fitted bodies through ``cli.fitting --exact --num_iter 3``
within test_fit_population_matches_jax's bounds of psi_tpu's: its drift
bounds (max 5e-3, mean 5e-4) and rtol 1e-3 / atol 2e-5, here on x72 itself
(the same 'high' f32 math summed in another order, through three Adam
steps); the scores that ``cli.eval`` prints equal psi_tpu's to the printed
digit. Port against port (the CLI against the FittingOP or TestOP it
calls on the same files): equal bits.
"""

import argparse
import contextlib
import glob
import io
import os
import pickle
import re
import shutil

import numpy as np
import pytest
import torch

from psi_tpu.cli import common as j_common
from psi_tpu.cli import eval as j_eval
from psi_tpu.cli import fitting as j_fitting
from psi_tpu.cli import fitting_habitat as j_fitting_habitat
from psi_tpu.cli import fitting_proxe as j_fitting_proxe
from psi_tpu.cli import test_habitat as j_test_habitat
from psi_tpu.cli import test_proxe as j_test_proxe
from psi_tpu.cli import test_proxe_s1 as j_test_proxe_s1
from psi_tpu.cli import test_proxe_s2 as j_test_proxe_s2
from psi_tpu.cli import train as j_train
from psi_tpu.cli import train_s1 as j_train_s1
from psi_tpu.cli import train_s2 as j_train_s2
from psi_tpu.data.scenes import synthetic_scene_registry as j_synthetic_scene_registry
from psi_tpu_torch.cli import common, fitting, fitting_habitat, fitting_proxe, test_habitat, test_proxe
from psi_tpu_torch.cli import eval as cli_eval
from psi_tpu_torch.cli import test_proxe_s1, test_proxe_s2, train, train_s1, train_s2
from psi_tpu_torch.data.matfile import HABITAT_T_MAT, load_test_snapshot
from psi_tpu_torch.data.scenes import synthetic_scene_registry
from psi_tpu_torch.fit.fitting import FittingOP
from psi_tpu_torch.gen.sample import TestOP
from psi_tpu_torch.geometry.bodyvec import body_params_encapsulate_list
from psi_tpu_torch.train.checkpoint import save_checkpoint
from psi_tpu_torch.train.loop import build_model, init_state
from psi_tpu_torch.utils.config import FitConfig, TrainConfig
from psi_tpu_torch.utils.init import seeded_init_
from test_torch_data_ingest import _write_mat, _write_room
from test_torch_fit_drivers import _assert_drift, _load, _stack, jax_files, snapshot, world  # noqa: F401 - fixtures

torch.set_num_threads(1)
NAMES = ["N3OpenArea", "MPH16", "MPH1Library"]
CPU = ["--device", "cpu"]
PARSERS = {"train": (train, j_train), "test_proxe": (test_proxe, j_test_proxe),
           "test_habitat": (test_habitat, j_test_habitat), "fitting": (fitting, j_fitting),
           "eval": (cli_eval, j_eval)}
SHIMS = {"train_s1": (train_s1, j_train_s1), "train_s2": (train_s2, j_train_s2),
         "test_proxe_s1": (test_proxe_s1, j_test_proxe_s1), "test_proxe_s2": (test_proxe_s2, j_test_proxe_s2),
         "fitting_proxe": (fitting_proxe, j_fitting_proxe), "fitting_habitat": (fitting_habitat, j_fitting_habitat)}
# cli.fitting's proxe configuration (fitting_proxe.py:139), as --exact sets it
EXACT_PROXE = dict(init_lr_h=0.1, contact_denom_offset=0.01, weight_loss_rec=1.0, weight_loss_vposer=0.01,
                   weight_contact=0.1, weight_collision=0.5, refresh_every=1, lbs_precision="high",
                   prune_scene_points=2048)


@pytest.fixture(scope="module", autouse=True)
def narrow_assets(world):  # noqa: F811 - the imported fixture
    """Both packages' build_assets return the narrow world; the port's records
    the keywords of every call."""
    calls = []
    regs = []
    for make in (synthetic_scene_registry, j_synthetic_scene_registry):
        reg = make(num_scenes=3, dim=16, num_verts=300, seed=0)
        reg.names = list(NAMES)
        regs.append(reg)

    def port_build(args, **kw):
        calls.append(kw)
        return world["tassets"], regs[0]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(common, "build_assets", port_build)
        mp.setattr(j_common, "build_assets", lambda args, **kw: (world["jassets"], regs[1]))
        yield calls


def _printed(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(argv)
    return buf.getvalue()


def _records(folder):
    return {os.path.relpath(p, folder): _load(p) for p in sorted(glob.glob(os.path.join(folder, "**", "*.pkl"),
                                                                           recursive=True))}


def _same_bits(a, b):
    return a.keys() == b.keys() and all(
        a[n].keys() == b[n].keys() and all(np.array_equal(a[n][k], b[n][k]) for k in a[n]) for n in a)


# ---- parsers, flag for flag

def _flags(parser):
    return {tuple(a.option_strings) or a.dest: (a.dest, a.default, a.choices, a.required, a.type, a.nargs,
                                               type(a).__name__)
            for a in parser._actions if not isinstance(a, argparse._HelpAction)}


@pytest.mark.parametrize("name", sorted(PARSERS))
def test_parser_is_psi_tpus_plus_device(name):
    ours, theirs = (_flags(m.build_parser()) for m in PARSERS[name])
    device = ours.pop(("--device",))
    assert ours == theirs
    assert device[0] == "device" and device[1] is None and device[4] is str


@pytest.mark.parametrize("name", sorted(SHIMS))
def test_shim_forwards_as_psi_tpus(name, monkeypatch):
    got = {}
    for key, mod in zip(("ours", "theirs"), SHIMS[name]):
        monkeypatch.setattr(mod, "_main", lambda argv, key=key: got.__setitem__(key, list(argv)))
        mod.main(["gen", "fit", "--num_iter", "2"])
    assert got["ours"] == got["theirs"]
    assert "--dataset" in got["ours"] or "--model_type" in got["ours"]


def test_fitting_shims_read_sys_argv(monkeypatch):
    got = []
    monkeypatch.setattr(fitting_habitat, "_main", got.append)
    monkeypatch.setattr("sys.argv", ["fitting_habitat", "g", "f", "--exact"])
    fitting_habitat.main()
    assert got == [["g", "f", "--dataset", "habitat", "--exact"]]


# ---- no card, no --device: refused

@pytest.mark.parametrize("name,argv", [
    ("train", ["--synthetic"]), ("test_proxe", ["--synthetic"]), ("test_habitat", ["--synthetic"]),
    ("fitting", ["gen", "fit", "--synthetic"]), ("eval", ["--results_dir", "r", "--mode", "collision"])])
def test_entry_point_without_device_refuses_on_a_machine_with_no_card(name, argv, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit, match="--device cpu"):
        PARSERS[name][0].main(argv)
    assert not os.listdir(tmp_path)  # nothing written


# ---- cli.fitting

@pytest.fixture(scope="module")
def fitted_dirs(jax_files, tmp_path_factory):  # noqa: F811
    """psi_tpu's TestOP pickles in gen/MPH16, fitted by both CLIs at --exact --num_iter 3."""
    root = tmp_path_factory.mktemp("cli_fit")
    gen = root / "gen"
    shutil.copytree(jax_files[0], gen / "MPH16")
    argv = [str(gen), None, "--num_iter", "3", "--exact"]
    argv[1] = str(root / "fit_jax")
    j_text = _printed(j_fitting.main, argv)
    argv[1] = str(root / "fit_port")
    text = _printed(fitting.main, argv + CPU)
    return gen, root / "fit_jax", root / "fit_port", j_text, text


def test_fitting_exact_matches_psi_tpu(fitted_dirs):
    gen, fit_jax, fit_port, j_text, text = fitted_dirs
    assert sorted(os.listdir(fit_port)) == ["MPH16"]
    ours, theirs = _records(str(fit_port)), _records(str(fit_jax))
    assert list(ours) == list(theirs) and len(ours) == 7
    x, xj = _stack(str(fit_port / "MPH16")), _stack(str(fit_jax / "MPH16"))
    _assert_drift(x, xj)
    np.testing.assert_allclose(x, xj, rtol=1e-3, atol=2e-5)  # found: max 1.5e-4, 0.40 of the bound
    for name, rec in ours.items():
        assert list(rec) == list(theirs[name])
        for k in ("cam_ext", "cam_int"):
            np.testing.assert_allclose(rec[k], theirs[name][k], rtol=1e-3, atol=2e-5, err_msg=k)
    # the banner and the summary lines, word for word
    assert text.splitlines() == j_text.splitlines()
    assert text.splitlines()[0].startswith("[INFO] fit mode: EXACT")


def test_fitting_is_fittingop_in_the_registrys_scene(fitted_dirs, world, tmp_path, narrow_assets):  # noqa: F811
    """The CLI's files equal, in bits, FittingOP.fitting_files with the
    proxe configuration on the scene registry.index_of('MPH16') names, on f32
    grids (--exact asks for no sdf_dtype)."""
    gen, _, fit_port, _, _ = fitted_dirs
    FittingOP(world["tassets"], FitConfig(num_iter=3, **EXACT_PROXE), scene_idx=1, device="cpu").fitting_files(
        str(gen / "MPH16"), str(tmp_path / "MPH16"))
    assert _same_bits(_records(str(fit_port)), _records(str(tmp_path)))
    narrow_assets.clear()
    fitting.main([str(gen), str(tmp_path / "again"), "--num_iter", "1", "--max_files", "902"] + CPU)
    assert narrow_assets[-1]["sdf_dtype"] is torch.bfloat16 and narrow_assets[-1]["scene_names"] is not None
    assert sorted(os.listdir(tmp_path / "again" / "MPH16")) == ["body_gen_000900.pkl", "body_gen_000901.pkl"]


def test_fitting_production_banner_and_unknown_scene_fallback(jax_files, world, tmp_path):  # noqa: F811
    """The default is the production tier; a scene the registry lacks takes
    row si % num_scenes (N0SittingBooth: si 2 -> row 2)."""
    shutil.copytree(jax_files[0], tmp_path / "gen" / "N0SittingBooth")
    text = _printed(fitting.main, [str(tmp_path / "gen"), str(tmp_path / "fit"), "--num_iter", "2",
                                   "--max_files", "903"] + CPU)
    assert text.splitlines()[0] == ("[INFO] fit mode: PRODUCTION (approximate: refresh_every=10, lbs_precision=fused, "
                                    "bf16 packed SDF grids; protocol-validated vs --exact in EVAL_SYNTH.md)")
    assert text.splitlines()[-1] == "[INFO] fitting finish: 3 bodies total"
    cfg = FitConfig(init_lr_h=0.1, num_iter=2, contact_denom_offset=0.01, weight_loss_rec=1.0,
                    weight_loss_vposer=0.01, weight_contact=0.1, weight_collision=0.5, refresh_every=10,
                    lbs_precision="fused", prune_scene_points=2048)
    FittingOP(world["tassets"], cfg, scene_idx=2, device="cpu").fitting_files(
        str(tmp_path / "gen" / "N0SittingBooth"), str(tmp_path / "direct" / "N0SittingBooth"), max_files=903)
    assert _same_bits(_records(str(tmp_path / "fit")), _records(str(tmp_path / "direct")))


# ---- cli.eval

@pytest.mark.parametrize("dataset", ["proxe", "habitat"])
def test_eval_collision_prints_psi_tpus_scores(fitted_dirs, dataset):
    _, _, fit_port, _, _ = fitted_dirs
    argv = ["--results_dir", str(fit_port), "--mode", "collision", "--dataset", dataset]
    ours, theirs = _printed(cli_eval.main, argv + CPU), _printed(j_eval.main, argv)
    assert re.fullmatch(r"\[INFO\] non_collision_score=[\d.]+, contact_score=[\d.]+\n", ours)
    assert ours == theirs


def test_eval_collision_finds_the_scene_by_directory_name(fitted_dirs, world, tmp_path):  # noqa: F811
    """MPH16 is registry row 1; a directory the registry lacks scores in row 0."""
    from psi_tpu_torch.eval import collision_contact_scores

    _, _, fit_port, _, _ = fitted_dirs
    shutil.copytree(fit_port / "MPH16", tmp_path / "Elsewhere")
    recs = list(_records(str(fit_port)).values())
    x = np.concatenate([_stack(str(fit_port / "MPH16"))])
    cam = np.concatenate([np.asarray(r["cam_ext"], np.float32).reshape(-1, 4, 4)[:1] for r in recs])
    for folder, row in ((fit_port, 1), (tmp_path, 0)):
        nc, ct = collision_contact_scores(world["tassets"], x, cam, np.full(len(recs), row))
        out = _printed(cli_eval.main, ["--results_dir", str(folder), "--mode", "collision"] + CPU)
        assert out == f"[INFO] non_collision_score={nc:.4f}, contact_score={ct:.4f}\n"


def test_eval_diversity_prints_psi_tpus_scores(tmp_path):
    """Four well-separated clusters of 6 bodies, k=4: both k-means find them."""
    rng = np.random.default_rng(3)
    centres = rng.normal(0, 5, (4, 72)).astype(np.float32)
    x = np.concatenate([c + rng.normal(0, 0.01, (6, 72)).astype(np.float32) for c in centres])
    for i, rec in enumerate(body_params_encapsulate_list(x)):
        folder = tmp_path / f"room{i % 2}"
        folder.mkdir(exist_ok=True)
        with open(folder / f"body_gen_{i:06d}.pkl", "wb") as f:
            pickle.dump(rec, f)
    argv = ["--results_dir", str(tmp_path), "--mode", "diversity", "--k", "4"]
    ours, theirs = _printed(cli_eval.main, argv + CPU), _printed(j_eval.main, argv)
    assert ours == theirs == f"[INFO] diversity: cluster_entropy={np.log(4):.4f}, mean_dist={ours.split('=')[-1]}"
    assert _printed(cli_eval.main, ["--results_dir", str(tmp_path / "none")] + CPU).startswith("[ERROR] no body_gen")


# ---- cli.train

def test_train_one_epoch_on_the_cpu(tmp_path):
    save = tmp_path / "ckpt"
    _printed(train.main, ["--synthetic", "--save_dir", str(save), "--batch_size", "4", "--num_epoch", "1",
                          "--latentD", "32", "--synthetic_batches", "2", "--num_devices", "1"] + CPU)
    rows = [line for line in open(save / "metrics.jsonl")]
    assert len(rows) == 2 and all("nan" not in r for r in rows)
    assert not glob.glob(str(save / "*.ckp"))  # epoch 1 is not a multiple of saving_per_epochs (10)


@pytest.mark.parametrize("only_vircam", [0, 1])
def test_train_reads_the_newest_hdf5_files(tmp_path, monkeypatch, only_vircam):
    """Without --synthetic, cli.train trains on the newest-named
    virtualcams*.hdf5 (and realcams*.hdf5 unless --only_vircam) under
    --proxe_path; --use_all 1 takes every scene."""
    from psi_tpu_torch.data import hdf5
    from test_torch_data_ingest import _write_hdf5

    pytest.importorskip("h5py")
    for i, name in enumerate(["virtualcams.hdf5", "virtualcams_v2.hdf5", "realcams.hdf5"]):
        _write_hdf5(str(tmp_path / name), np.array([4, 1] * 4), np.random.default_rng(i))  # MPH16, MPH1Library
    opened = []

    class Spy(hdf5.BatchGeneratorWithSceneMesh):
        def __init__(self, paths, **kw):
            opened.append((list(paths), kw["mode"]))
            super().__init__(paths, **kw)

    monkeypatch.setattr(hdf5, "BatchGeneratorWithSceneMesh", Spy)
    save = tmp_path / "ckpt"
    train.main(["--proxe_path", str(tmp_path), "--save_dir", str(save), "--batch_size", "4", "--num_epoch", "1",
                "--latentD", "32", "--use_all", "1", "--only_vircam", str(only_vircam)] + CPU)
    files = [str(tmp_path / "virtualcams_v2.hdf5")] + ([] if only_vircam else [str(tmp_path / "realcams.hdf5")])
    assert opened == [(files, "all")]
    assert len(open(save / "metrics.jsonl").readlines()) == 2 * len(files)


def test_train_refuses_more_than_one_device(tmp_path):
    """More ranks than cards: refused before any rank starts, naming both
    counts (``--device cpu`` would run them as CPU ranks instead)."""
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    ask = max(2, have + 1)
    with pytest.raises(SystemExit, match=f"--num_devices {ask} asks for {ask} NVIDIA cards, {have} present"):
        train.main(["--synthetic", "--num_devices", str(ask), "--save_dir", str(tmp_path)])
    assert not os.listdir(tmp_path)


def test_train_resumes_and_test_proxe_generates_from_its_checkpoint(tmp_path):
    """cli.train_s1 resumes a checkpoint marked epoch 9 of 10, trains epoch
    10 and writes epoch-000010.ckp; cli.test_proxe_s1 --ckpt_dir generates
    from it what TestOP.from_checkpoint does, and not what fresh weights do."""
    ckpt = tmp_path / "ckpt"
    save_checkpoint(str(ckpt), 9, init_state(TrainConfig(model_type="s1", latentD=32), "cpu"))
    _printed(train_s1.main, ["--synthetic", "--save_dir", str(ckpt), "--batch_size", "4", "--num_epoch", "10",
                             "--latentD", "32", "--synthetic_batches", "2"] + CPU)
    assert os.path.exists(ckpt / "epoch-000010.ckp") and len(open(ckpt / "metrics.jsonl").readlines()) == 2
    argv = ["--latentD", "32", "--n_samples", "3", "--synthetic"] + CPU
    test_proxe_s1.main(argv + ["--ckpt_dir", str(ckpt), "--output_dir", str(tmp_path / "cli")])
    test_proxe_s1.main(argv + ["--output_dir", str(tmp_path / "fresh")])
    cfg = TrainConfig(model_type="s1", latentD=32)
    op = TestOP.from_checkpoint(seeded_init_(build_model(cfg), 0), str(ckpt), n_samples=3, device="cpu")
    from psi_tpu_torch.data.synthetic import SyntheticBatchGenerator

    gen = SyntheticBatchGenerator(num_scenes=4, batches_per_epoch=4)
    for scene in ("MPH16", "MPH1Library", "N0SittingBooth", "N3OpenArea"):
        op.test({k: v[:1] for k, v in gen.next_batch(1).items()}, str(tmp_path / "direct"), scene)
    cli, direct, fresh = (_records(str(tmp_path / d)) for d in ("cli", "direct", "fresh"))
    assert len(cli) == 12 and _same_bits(cli, direct) and not _same_bits(cli, fresh)


# ---- cli.test_proxe and cli.test_habitat

def test_test_proxe_synthetic_writes_psi_tpus_layout(tmp_path):
    argv = ["--latentD", "32", "--n_samples", "4", "--synthetic"]
    test_proxe.main(argv + CPU + ["--output_dir", str(tmp_path / "ours")])
    j_test_proxe.main(argv + ["--output_dir", str(tmp_path / "theirs")])
    ours, theirs = _records(str(tmp_path / "ours")), _records(str(tmp_path / "theirs"))
    assert list(ours) == list(theirs) and len(ours) == 16
    assert list(ours)[0] == os.path.join("MPH16", "body_gen_000900.pkl")
    for name, rec in ours.items():
        assert list(rec) == list(theirs[name])
        for k, v in rec.items():
            assert v.dtype == np.asarray(theirs[name][k]).dtype and v.shape == np.asarray(theirs[name][k]).shape
        # the same synthetic snapshots: the same cameras (the extrinsics' rotation is
        # built from axis-angle in each package: f32 rounding apart)
        np.testing.assert_allclose(rec["cam_ext"], theirs[name]["cam_ext"], rtol=0, atol=1e-6)
        np.testing.assert_array_equal(rec["cam_int"], theirs[name]["cam_int"])


def test_test_proxe_reads_mat_snapshots(tmp_path):
    rng = np.random.default_rng(2)
    for d in ("MPH16_00", "N3OpenArea_03", "Werkraum_00"):  # Werkraum is a training scene: skipped
        (tmp_path / "proxe" / "snapshot_for_testing" / d).mkdir(parents=True)
        _write_mat(str(tmp_path / "proxe" / "snapshot_for_testing" / d / "rec_000000.mat"), rng, (120, 160))
    text = _printed(test_proxe_s2.main, ["--latentD", "32", "--n_samples", "2", "--proxe_path",
                                         str(tmp_path / "proxe"), "--output_dir", str(tmp_path / "out")] + CPU)
    assert text.splitlines() == ["[INFO] MPH16: wrote 2 samples", "[INFO] N3OpenArea: wrote 2 samples"]
    recs = _records(str(tmp_path / "out"))
    assert list(recs) == [os.path.join(s, f"body_gen_{i:06d}.pkl") for s in ("MPH16", "N3OpenArea") for i in (900, 901)]
    snap = load_test_snapshot(str(tmp_path / "proxe" / "snapshot_for_testing" / "N3OpenArea_03" / "rec_000000.mat"))
    np.testing.assert_array_equal(recs[os.path.join("N3OpenArea", "body_gen_000901.pkl")]["cam_ext"], snap["cam_ext"])


def test_test_habitat_synthetic_numbers_from_0_in_seven_rooms(tmp_path):
    test_habitat.main(["--latentD", "32", "--n_samples", "3", "--synthetic", "--output_dir", str(tmp_path)] + CPU)
    recs = _records(str(tmp_path))
    assert len(recs) == 21 and sorted(os.listdir(tmp_path)) == sorted(fitting.MP3D_ROOMS)
    assert fitting.MP3D_ROOMS == j_fitting.MP3D_ROOMS
    assert sorted(os.listdir(tmp_path / fitting.MP3D_ROOMS[0])) == [f"body_gen_{i:06d}.pkl" for i in range(3)]


def test_habitat_pipeline_on_real_format_dumps(world, tmp_path):  # noqa: F811
    """tests/test_habitat_realformat.py's pipeline: two cameras of 3 bodies
    numbered 0-5, each pickle with its camera; the habitat fit right-composes
    HABITAT_T_MAT, as FittingOP(cam_post=HABITAT_T_MAT) on the same files."""
    room = fitting.MP3D_ROOMS[0]
    _write_room(str(tmp_path / "dumps" / room), n_cams=2, seed=5)
    test_habitat.main(["--dump_root", str(tmp_path / "dumps"), "--output_dir", str(tmp_path / "gen"),
                       "--n_samples", "3", "--latentD", "32"] + CPU)
    gen = _records(str(tmp_path / "gen"))
    assert list(gen) == [os.path.join(room, f"body_gen_{i:06d}.pkl") for i in range(6)]
    cam1 = np.load(str(tmp_path / "dumps" / room / "cam_1.npy"), allow_pickle=True).item()
    np.testing.assert_array_equal(gen[os.path.join(room, "body_gen_000004.pkl")]["cam_ext"].reshape(4, 4),
                                  cam1["cam_ext"])
    fitting_habitat.main([str(tmp_path / "gen"), str(tmp_path / "fit"), "--num_iter", "2"] + CPU)
    cfg = FitConfig(init_lr_h=0.1, num_iter=2, contact_denom_offset=1.0, weight_loss_rec=1.0,
                    weight_loss_vposer=0.01, weight_contact=0.1, weight_collision=0.5, refresh_every=10,
                    lbs_precision="fused", prune_scene_points=2048)
    # the room is not in the registry: row si % 3 = 0
    FittingOP(world["tassets"], cfg, scene_idx=0, cam_post=HABITAT_T_MAT, device="cpu").fitting_files(
        str(tmp_path / "gen" / room), str(tmp_path / "direct" / room), max_files=10000)
    fit = _records(str(tmp_path / "fit"))
    assert len(fit) == 6 and _same_bits(fit, _records(str(tmp_path / "direct")))
    assert all(np.isfinite(v).all() for r in fit.values() for v in r.values())
