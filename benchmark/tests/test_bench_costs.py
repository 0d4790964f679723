"""The cost counts pinned against hand-worked values (and the port's
per-kernel bounds for the fused vertex path, counted the same way)."""

import json

import pytest

from benchmark.costs import psi
from benchmark.tests.helpers import ROOT

V, J, P, C = 10475, 55, 486, 1 + 10 + 486


def test_correctives_at_256():
    c = psi.high_products(256, P, V, J)["correctives"]
    assert c["flops"] == 2 * 256 * 486 * 31425 == 7_819_545_600
    assert c["bytes"] == 4 * (256 * 486 + 486 * 31425 + 256 * 31425) == 93_767_064
    assert c["s"] * 1e3 == pytest.approx(0.02799, abs=5e-5)


def test_blend_at_256():
    b = psi.high_products(256, P, V, J)["blend"]
    assert b["flops"] == 2 * 10475 * 55 * 12 * 256
    assert b["s"] * 1e3 == pytest.approx(0.0393, abs=5e-5)
    # the gradients read and write the same sizes: one pass ~ 2 x (0.028 + 0.039) ms
    assert psi.high_pass_s(256, P, V, J) * 1e3 == pytest.approx(0.1346, abs=5e-4)


def test_fused_vertex_path_at_256():
    s = psi.skinning(256, C, J, V)
    assert s["fwd_s"] * 1e3 == pytest.approx(0.0195, abs=5e-5)
    assert s["bwd_s"] * 1e3 == pytest.approx(0.0265, abs=5e-5)


def test_call_and_step_operations():
    cfg = json.loads((ROOT / "benchmark" / "configs" / "psi_s1.json").read_text())
    # decode forward at 256: vertex path 2*256*10475*3*497 + blend 2*256*10475*55*12 + skin 2*256*10475*12
    vertex = 2 * 256 * V * 3 * C + 2 * 256 * V * J * 12 + 2 * 256 * V * 12
    vp = 2 * 256 * (32 * 512 + 512 * 512 + 512 * 126)
    assert psi.decode_flops(cfg, 256) == vertex + vp
    call = psi.genfit_call_flops(cfg, 256, 20, 6, 2048)
    assert 0.7e12 < call < 0.8e12
    assert psi.contact_flops(256, 1455, 2048) == 8 * 256 * 1455 * 2048
    step = psi.train_step_flops(cfg, 32, 20000)
    assert 60e9 < step < 90e9


def test_s2_step_operations():
    """Stage 2's step: both trunks (scene features 32 and 128 wide), every
    linear layer of its two VAEs once forward, the body decode, all three
    times over, and the contact search."""
    cfg = json.loads((ROOT / "benchmark" / "configs" / "psi_s2.json").read_text())
    B = 32
    trunks = psi.trunk_flops(B, 2, 128, 32, 256) + psi.trunk_flops(B, 2, 128, 128, 256)
    io = [(3, 256), (512, 512), (512, 512), (512, 512), (512, 512), (512, 32), (512, 32),  # global encoder
          (288, 32), (32, 32), (32, 32), (32, 32), (32, 32), (32, 3),  # global decoder
          (72, 256), (3, 256), (768, 768), (768, 768), (768, 768), (768, 768), (768, 32), (768, 32),  # local encoder
          (544, 128), (128, 128), (128, 128), (128, 128), (128, 128), (128, 72)]  # local decoder
    mlp = sum(2 * B * i * o for i, o in io)
    want = 3 * (trunks + mlp + psi.decode_flops(cfg, B)) + 8 * B * 1455 * 20000
    assert psi.train_step_flops(cfg, B, 20000) == pytest.approx(want, rel=1e-12)
    assert 130e9 < want < 160e9
