"""The JSONL serving loop: psi_tpu_torch.cli.serve, held to psi_tpu.cli.serve.

tests/test_serve.py's four CLI tests, one for one, with ``--device cpu``;
then the parser against psi_tpu's (the same flags with the same defaults,
plus ``--device``), the roster's rules, and a checkpoint reaching the engine.

The CLI builds the reference's synthetic assets (10475 vertices, 55 joints,
4 scenes, 64^3 f32 grids, 20000 scene points, 1455 contact vertices). Every
``main`` call would build them again, a few seconds each, so a module fixture
builds them once through the real ``build_assets`` (its synthetic branch is
checked there) and hands the same objects to every call by patching
``psi_tpu_torch.cli.common.build_assets``.
"""

import argparse
import io
import json

import numpy as np
import pytest
import torch

from psi_tpu.cli import serve as j_cli_serve
from psi_tpu_torch.cli import common
from psi_tpu_torch.cli import serve as cli_serve

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def shared_assets():
    args = argparse.Namespace(synthetic=True, proxe_path=None, device="cpu")
    assets, registry = common.build_assets(args)
    assert assets.smplx.num_verts == 10475 and assets.smplx.num_joints == 55 and registry.num_scenes == 4
    assert assets.sdf_packed.shape == (4, 64, 64, 64, 8) and assets.sdf_packed.dtype == torch.float32
    assert assets.scene_verts.shape == (4, 20000, 3) and assets.contact_vids.shape == (1455,)
    assert assets.scene_verts.device.type == "cpu"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(common, "build_assets", lambda a, **kw: (assets, registry))
        yield assets


def _serve(argv, lines):
    stdout = io.StringIO()
    cli_serve.main(argv + ["--device", "cpu"], stdin=io.StringIO(lines), stdout=stdout)
    return [json.loads(l) for l in stdout.getvalue().strip().splitlines()]


def test_serve_cli_loop(tmp_path):
    reqs = (
        json.dumps({"id": "a", "n_samples": 3})
        + "\n"
        + json.dumps({"id": "b", "n_samples": 1})
        + "\nstats\nquit\n"
    )
    lines = _serve(
        ["--latentD", "32", "--population", "4", "--synthetic", "--out_dir", str(tmp_path),
         "--linger_ms", "250"], reqs)
    assert lines[0]["status"] == "ready"
    assert lines[0]["warmup_programs"] == "all" and lines[0]["models"] == ["s1"]
    assert lines[0]["warmup_s"] > 0 and lines[0]["warmup_per_model_s"] == {"s1": lines[0]["warmup_s"]}
    by_id = {l["id"]: l for l in lines if "id" in l}
    assert by_id["a"]["n"] == 3 and by_id["b"]["n"] == 1
    assert "batch_size" in by_id["a"]
    out = np.load(by_id["a"]["out"])
    assert out.shape == (3, 72)
    stats_lines = [l for l in lines if "stats" in l]
    assert stats_lines, "stats line missing"
    final = stats_lines[-1]["stats"]
    assert final["requests"] == 2
    assert "latency_p50_s" in final and "latency_p99_s" in final


def test_serve_cli_multi_model(tmp_path):
    reqs = (
        json.dumps({"id": "a", "n_samples": 2, "model": "s2"})
        + "\n"
        + json.dumps({"id": "b", "n_samples": 1})
        + "\nquit\n"
    )
    lines = _serve(
        ["--latentD", "32", "--population", "4", "--synthetic", "--out_dir", str(tmp_path),
         "--model", "s1", "--model", "s2", "--linger_ms", "20"], reqs)
    assert lines[0]["status"] == "ready" and lines[0]["models"] == ["s1", "s2"]
    by_id = {l["id"]: l for l in lines if "id" in l}
    assert by_id["a"]["n"] == 2 and by_id["b"]["n"] == 1
    final = [l for l in lines if "stats" in l][-1]["stats"]
    assert final["requests"] == 2
    assert final["models"]["s2"]["requests"] == 1


def test_serve_cli_malformed_lines(tmp_path):
    """Bad JSON / missing npz path emit an error record and the loop keeps
    serving subsequent requests."""
    reqs = (
        "this is not json\n"
        + json.dumps({"id": "missing", "npz": str(tmp_path / "nope.npz"), "n_samples": 1})
        + "\n"
        + json.dumps({"id": "ok", "n_samples": 2})
        + "\nquit\n"
    )
    lines = _serve(
        ["--latentD", "32", "--population", "4", "--synthetic", "--out_dir", str(tmp_path),
         "--linger_ms", "20"], reqs)
    errors = [l for l in lines if "error" in l]
    assert len(errors) == 2
    assert any(l.get("id") == "missing" for l in errors)
    by_id = {l["id"]: l for l in lines if "id" in l and "error" not in l}
    assert by_id["ok"]["n"] == 2  # server survived the bad lines


def test_serve_cli_streaming_chunks(tmp_path):
    """n_samples > population streams ceil(n/pop) chunk records, each
    with chunk/n_chunks/final fields and its own output file."""
    reqs = json.dumps({"id": "big", "n_samples": 10}) + "\nquit\n"
    lines = _serve(
        ["--latentD", "32", "--population", "4", "--synthetic", "--out_dir", str(tmp_path),
         "--linger_ms", "20", "--warmup", "coalesced"], reqs)
    ready = lines[0]
    assert ready["warmup_programs"] == ["coalesced"]
    chunks = [l for l in lines if l.get("id") == "big" and "error" not in l]
    assert [c["chunk"] for c in chunks] == [0, 1, 2]
    assert all(c["n_chunks"] == 3 for c in chunks)
    assert [c["n"] for c in chunks] == [4, 4, 2]
    assert [c["final"] for c in chunks] == [False, False, True]
    total = sum(np.load(c["out"]).shape[0] for c in chunks)
    assert total == 10


def test_a_request_reads_its_snapshot_file_and_a_failed_future_becomes_an_error_record(tmp_path):
    """A snapshot read from an npz file is served; an unknown model's and a
    negative count's futures become error records, a chunked one with its chunk."""
    rng = np.random.default_rng(0)
    npz = tmp_path / "snap.npz"
    np.savez(npz, xs=rng.uniform(-1, 1, (1, 128, 128, 2)).astype(np.float32), cam_int=np.eye(3, dtype=np.float32)[None] * 400,
             cam_ext=np.eye(4, dtype=np.float32)[None], max_d=np.asarray([5.0], np.float32))
    reqs = "\n".join([json.dumps({"id": "file", "npz": str(npz), "n_samples": 2}),
                      json.dumps({"id": "nomodel", "n_samples": 1, "model": "s9"}),
                      json.dumps({"id": "neg", "n_samples": -2}),
                      json.dumps({"id": "bigbad", "n_samples": 6, "model": "s9"}), "", "quit"]) + "\n"
    lines = _serve(["--latentD", "32", "--population", "4", "--synthetic", "--out_dir", str(tmp_path / "out"),
                    "--linger_ms", "5", "--warmup", "none"], reqs)
    assert lines[0] == {"status": "ready", "warmup_s": 0.0, "warmup_per_model_s": {"s1": 0.0}, "warmup_programs": [],
                        "models": ["s1"]}
    recs = [l for l in lines if "id" in l]
    assert [r["id"] for r in recs] == ["file", "nomodel", "neg", "bigbad", "bigbad"]  # submission order
    assert recs[0]["n"] == 2 and np.load(recs[0]["out"]).shape == (2, 72) and np.isfinite(np.load(recs[0]["out"])).all()
    assert "unknown model" in recs[1]["error"] and "n_samples" in recs[2]["error"]
    assert [r["chunk"] for r in recs[3:]] == [0, 1] and all("error" in r for r in recs[3:])
    assert lines[-1]["stats"]["requests"] == 1


def test_parser_has_psi_tpus_flags_and_defaults_and_a_device():
    ours = {a.dest: a for a in cli_serve.build_parser()._actions}
    theirs = {a.dest: a for a in j_cli_serve.build_parser()._actions}
    assert set(ours) - set(theirs) == {"device"} and set(theirs) <= set(ours)
    for dest, a in theirs.items():
        b = ours[dest]
        assert (b.option_strings, b.default, b.type, b.choices, b.nargs) == (
            a.option_strings, a.default, a.type, a.choices, a.nargs), dest
    assert ours["device"].default is None
    assert "one CUDA kernel" in ours["lbs_precision"].help and "Pallas" not in cli_serve.build_parser().format_help()


def test_roster_refuses_a_duplicate_name_and_the_default_device_needs_a_card(tmp_path):
    with pytest.raises(SystemExit, match="duplicate --model"):
        _serve(["--synthetic", "--model", "s1", "--model", "s1=elsewhere", "--out_dir", str(tmp_path)], "quit\n")
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="--device cpu"):
            cli_serve.main(["--synthetic", "--out_dir", str(tmp_path)], stdin=io.StringIO("quit\n"), stdout=io.StringIO())
        assert common.resolve_device("cpu") == torch.device("cpu")


def test_a_checkpoint_directory_reaches_the_engine(tmp_path, monkeypatch):
    """--model s1=DIR: the newest epoch-*.ckp's weights are in the engine's
    model, and the engine gets the CLI's fit configuration, not production()."""
    import psi_tpu_torch.serve as serve_pkg
    from psi_tpu_torch.train.checkpoint import save_checkpoint
    from psi_tpu_torch.train.loop import init_state
    from psi_tpu_torch.utils.config import FitConfig, TrainConfig

    state = init_state(TrainConfig(model_type="s1", latentD=32, seed=9), "cpu")
    save_checkpoint(str(tmp_path / "ck"), 3, state)
    seen = []

    class Spy(serve_pkg.GenerationEngine):
        def __init__(self, model, assets, **kw):
            seen.append((model, kw))
            super().__init__(model, assets, **kw)

    monkeypatch.setattr(serve_pkg, "GenerationEngine", Spy)
    lines = _serve(["--latentD", "32", "--population", "4", "--synthetic", "--out_dir", str(tmp_path / "out"),
                    "--warmup", "none", "--model", f"s1={tmp_path / 'ck'}", "--model", f"s2={tmp_path / 'empty'}",
                    "--refresh_every", "5", "--lbs_precision", "fast", "--prune_scene_points", "64"], "quit\n")
    assert lines[0]["models"] == ["s1", "s2"] and lines[-1]["stats"]["requests"] == 0
    (m1, kw1), (m2, _) = seen
    for (k, a), b in zip(m1.state_dict().items(), state.model.state_dict().values()):
        assert torch.equal(a, b), k
    fresh = init_state(TrainConfig(model_type="s1", latentD=32), "cpu").model
    assert not all(torch.equal(a, b) for a, b in zip(m1.state_dict().values(), fresh.state_dict().values()))
    assert type(m2).__name__ == "HumanCVAES2"  # a directory without a checkpoint: the seeded initial weights
    assert kw1["fit_cfg"] == FitConfig(refresh_every=5, lbs_precision="fast", prune_scene_points=64)
    assert kw1["population"] == 4 and kw1["device"] == torch.device("cpu")
