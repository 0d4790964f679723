"""The CUDA kernels K1-K3, K6 and P1-P4 against their plain twins, on the card.

Every test here needs an NVIDIA card and skips without one: the kernels
have no CPU mode, and their twins' agreement with psi_tpu is checked on
the CPU by test_torch_fused_skinning.py, test_torch_chamfer.py and
test_torch_gather_probes.py. This
file imports neither JAX nor psi_tpu, so it runs on a machine that has
only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

(``--noconftest`` skips tests/conftest.py, which sets JAX up.) Inputs are
made with numpy from a seed. Shapes include ragged edges: bodies not a
multiple of a block's body tile, vertices not a multiple of a vertex
tile, clouds not a multiple of a shared-memory tile.
"""

import math

import numpy as np
import pytest
import torch

from psi_tpu_torch.body.smplx_model import fused_operands, synthetic_smplx
from psi_tpu_torch.ops import chamfer as tch
from psi_tpu_torch.ops import fused_skinning as tfs
from psi_tpu_torch.ops import gather_probes as gp

torch.set_num_threads(1)

# (B, V, J): the CPU parity shape, a ragged one at SMPL-X's joint count, and
# one that spans several of K1's and K2's body and vertex tiles (32 x 32 in
# K1 and the coefficient pass, 64-row blocks in the reductions), has more
# than 64 bodies but no multiple of 32, and is ragged on every padded axis
# (bodies to 64, vertices to 256, basis rows to 64); then 64 bodies (exactly
# two body tiles) and 1 (the carried-Adam mode's serial loop, K1 and K2)
SKIN_SHAPES = [(5, 300, 12), (13, 1001, 55), (130, 2051, 55), (64, 2051, 55), (1, 2051, 55)]
# K1 also at a shape smaller than one tile on every axis
K1_SHAPES = SKIN_SHAPES + [(1, 17, 3)]
# K3's tiles: a block covers NN_R * NN_THREADS x points, a shared-memory tile
# holds NN_TILE y points, one compare a NN_CHUNK of them (csrc/chamfer_nn.cu)
NN_BLOCK, NN_TILE, NN_CHUNK = 4 * 128, 1024, 16
# (B, N, M): the CPU parity shape; M across and ragged against the tiles; N = 1
# and one off a block either way; M = 1, one off a tile and one off a chunk
# either way; the two-sided chamfer's swapped shape (many x, few y)
NN_SHAPES = [(3, 200, 700), (2, 300, 3000), (2, 1, 50), (2, NN_BLOCK - 1, 40), (2, NN_BLOCK + 1, 40),
             (3, 7, 1), (2, 40, NN_TILE - 1), (2, 40, NN_TILE + 1), (2, 40, NN_CHUNK - 1), (2, 40, NN_CHUNK + 1),
             (2, 3000, 300)]


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
    bundle = tfs.SkinningBundle(*(x.to(dev) if isinstance(x, torch.Tensor) else x for x in bundle))
    g = t(rng.normal(0, 1.0, (B, V, 3)))
    return bundle, tuple(o.to(dev) for o in ops), g.to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", K1_SHAPES)
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
@pytest.mark.parametrize("shape", K1_SHAPES)
def test_k1_kernel_is_deterministic_and_writes_only_its_output(shape, card):
    """Two runs give equal bits (nothing is summed across blocks), and with
    the output placed inside a larger buffer of sentinels, every float
    outside [B, V, 3] keeps its sentinel: the ragged tiles' stores are masked."""
    bundle, ops, _ = _skinning_case(shape, card)
    B, V, _ = shape
    n, guard, sentinel = B * V * 3, 4099, -12345.0  # an odd guard: the output starts only 4-byte aligned
    buf = torch.full((n + 2 * guard,), sentinel, device=card)
    args, out, _keep = tfs.fwd_operands(*ops, bundle, out=buf[guard:guard + n].view(B, V, 3))
    tfs.SKIN_FWD.launch(card, *args, tfs.FWD_ALL, torch.cuda.current_stream(card).cuda_stream)
    again = tfs.fused_skinning_fwd(*ops, bundle)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    assert bool((buf[:guard] == sentinel).all()) and bool((buf[guard + n:] == sentinel).all())
    assert bool((out != sentinel).all())  # and every vertex was written


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
        tfs.fused_skinning_fwd(cb, A12, cam12, bundle._replace(w_vjp=bundle.w_vjp.cpu()))


def _cut_vertex_padding(bundle):
    """The bundle with 8 fewer padded vertices: still >= V, no longer a multiple of 256."""
    Vp = bundle.base_cvp.shape[2] - 8
    return bundle._replace(base_cvp=bundle.base_cvp[:, :, :Vp].contiguous(),
                           base_vcp=bundle.base_vcp[:, :Vp].contiguous(),
                           w_jvp=bundle.w_jvp[:, :Vp].contiguous(), w_vjp=bundle.w_vjp[:Vp].contiguous())


@pytest.mark.cuda
def test_k1_rejects_padding_it_does_not_take(card):
    """K1 tiles the bundle's padded widths without ragged edges: a width
    that is not a multiple of its tiles is refused, not read past."""
    bundle, ops, _ = _skinning_case(SKIN_SHAPES[0], card)
    n = tfs.SKIN_FWD.launches
    with pytest.raises(RuntimeError):
        tfs.fused_skinning_fwd(*ops, _cut_vertex_padding(bundle))
    assert tfs.SKIN_FWD.launches == n


@pytest.mark.cuda
def test_k2_rejects_padding_it_does_not_take(card):
    """K2 tiles the bundle's padded widths without ragged edges: a width
    that is not a multiple of its tiles is refused, not read past."""
    bundle, ops, g = _skinning_case(SKIN_SHAPES[0], card)
    n = tfs.SKIN_BWD.launches
    with pytest.raises(RuntimeError):
        tfs.fused_skinning_bwd(*ops, _cut_vertex_padding(bundle), g)
    assert tfs.SKIN_BWD.launches == n


def _clouds(shape, dev):
    B, N, M = shape
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1.0, (B, N, 3)).astype(np.float32)
    y = rng.uniform(-2, 2, (B, M, 3)).astype(np.float32)
    if M > 20:
        y[:, -20:] = 1.0e5  # registry-style far padding never wins
    return torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)


def _sq_dist_to(x, y, idx):
    return ((x - tch._gather_points(y, idx)) ** 2).sum(-1)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", NN_SHAPES)
def test_k3_kernel_matches_twin(shape, card):
    x, y = _clouds(shape, card)
    n = tch.NN_ARGMIN.launches
    ik = tch.nn_argmin(x, y)
    assert tch.NN_ARGMIN.launches == n + 1
    it = tch.nn_argmin_reference(x, y)
    torch.cuda.synchronize()
    assert ik.shape == it.shape == shape[:2] and ik.dtype == torch.int64
    # both evaluate the same f32 distance; winners differ only between
    # points at equal distance
    assert torch.equal(_sq_dist_to(x, y, ik), _sq_dist_to(x, y, it))


@pytest.mark.cuda
def test_k3_kernel_ties_go_to_lowest_index(card):
    y = torch.zeros((1, 3000, 3), device=card)  # 3000 identical points, across tiles
    x = torch.ones((1, 300, 3), device=card)
    assert int(tch.nn_argmin(x, y).max()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("first,second", [
    (NN_TILE - 3, NN_TILE + 5),  # the copies lie in two shared-memory tiles
    (NN_TILE + 2 * NN_CHUNK + 3, NN_TILE + 2 * NN_CHUNK + 9),  # in one unrolled chunk
    (NN_CHUNK - 1, NN_CHUNK),  # in neighbouring chunks
    (5, 2 * NN_TILE + 40),  # in the first tile and the last, ragged one
])
def test_k3_kernel_duplicate_points_go_to_the_lowest_index(first, second, card):
    """The nearest y point stands twice in the cloud: the lower copy wins,
    wherever the two fall against the tiles and the chunks."""
    x, y = _clouds((2, 70, 2 * NN_TILE + 100), card)
    y[:, first] = y[:, second] = x[:, 11] + 1e-3  # nearer to x[11] than any other point
    idx = tch.nn_argmin(x, y)
    assert idx[:, 11].tolist() == [first, first]
    assert torch.equal(idx, tch.nn_argmin_reference(x, y))


@pytest.mark.cuda
def test_k3_kernel_folds_many_bodies_into_the_grid(card):
    """More bodies than a grid's second axis takes (65535): the body is
    folded into the first."""
    x, y = _clouds((70000, 3, 5), card)
    ik = tch.nn_argmin(x, y)
    assert torch.equal(ik, tch.nn_argmin_reference(x, y))


@pytest.mark.cuda
def test_k3_kernel_is_deterministic_and_writes_only_its_output(card):
    """Two runs give equal indices, and with the int64 output placed inside
    a larger buffer of sentinels every word outside [B, N] keeps its sentinel
    and every word inside is written."""
    from psi_tpu_torch.ops import _cuda

    B, N, M = 3, NN_BLOCK + 37, 1500
    x, y = _clouds((B, N, M), card)
    guard, sentinel = 1031, -7
    buf = torch.full((B * N + 2 * guard,), sentinel, dtype=torch.int64, device=card)
    tch.NN_ARGMIN.launch(card, x.data_ptr(), y.data_ptr(), buf[guard:].data_ptr(), B, N, M, _cuda.stream_of(x))
    out = buf[guard:guard + B * N].view(B, N)
    assert torch.equal(out, tch.nn_argmin(x, y)) and torch.equal(out, tch.nn_argmin(x, y))
    assert bool((buf[:guard] == sentinel).all()) and bool((buf[guard + B * N:] == sentinel).all())
    assert int(out.min()) >= 0 and int(out.max()) < M


@pytest.mark.cuda
def test_k3_kernel_gives_index_0_when_no_distance_is_finite(card):
    """Every distance +inf (y at inf) or NaN (x at inf too): nothing is below
    the initial +inf, and the index stays 0, as a `d < best` scan leaves it."""
    x = torch.zeros((2, 40, 3), device=card)
    x[1] = float("inf")
    y = torch.full((2, 50, 3), float("inf"), device=card)
    assert int(tch.nn_argmin(x, y).abs().max()) == 0
    y[:, 33] = 0.25  # one finite point: body 0 takes it, body 1 (inf - 0.25 = inf) still has none
    assert tch.nn_argmin(x, y)[0].unique().tolist() == [33] and int(tch.nn_argmin(x, y)[1].max()) == 0


@pytest.mark.cuda
def test_chamfer_distance_on_card_matches_cpu(card):
    """The two-sided chamfer on the card (two K3 searches) and on the CPU
    (the twin): the same winners; the distances, recomputed by each device's
    own elementwise kernels, agree to 1e-6 (absolute, and relative where a y
    point gathers many terms); so do the gradients, and not to the bit,
    because index_add_ sums with atomics on the card, in an order that may
    change from run to run."""
    x, y = _clouds((2, 3000, 300), card)
    y = y[:, :-20].contiguous()  # every y point is a query too: keep the clouds near each other
    rng = np.random.default_rng(1)
    w1 = torch.from_numpy(rng.normal(size=(2, 3000)).astype(np.float32))
    w2 = torch.from_numpy(rng.normal(size=(2, 280)).astype(np.float32))
    res = []
    for dev in (card, torch.device("cpu")):
        xd = x.detach().to(dev).requires_grad_(True)
        yd = y.detach().to(dev).requires_grad_(True)
        n = tch.NN_ARGMIN.launches
        d1, d2 = tch.chamfer_distance(xd, yd)
        assert tch.NN_ARGMIN.launches == n + (2 if dev.type == "cuda" else 0)
        ((d1 * w1.to(dev)).sum() + (d2 * w2.to(dev)).sum()).backward()
        res.append((d1.detach().cpu(), d2.detach().cpu(), xd.grad.cpu(), yd.grad.cpu()))
    for a, b in zip(*res):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    i_card = tch.chamfer_with_idx(x, y)[2:]
    i_cpu = tch.chamfer_with_idx(x.cpu(), y.cpu())[2:]
    assert all(a.dtype == torch.int64 and torch.equal(_sq_dist_to(*c, a), _sq_dist_to(*c, b.to(card)))
               for a, b, c in zip(i_card, i_cpu, ((x, y), (y, x))))


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


# P1-P4, the shared-memory gather probes. (rows, L): rows ragged against
# the 256-row chunk, L ragged against the 16-column strip, the probe
# script's four heights, an L that is no multiple of 4 (the 4-byte route),
# and tables tall enough that the strip narrows to 8 and to 4 columns (still
# 16-byte copies) and to 2 (4-byte copies).
ROW_SHAPES = [(8, 128), (300, 128), (2304, 128), (5000, 100), (128, 128), (512, 128), (300, 100), (37, 130),
              (7300, 8), (15000, 8), (15000, 6)]
# (rows, L): rows ragged against the 16-row block, the four heights, an L
# that is no multiple of 4, and rows wide enough (over 768 floats) that a
# block's 16 of them need the shared-memory opt-in
LANE_SHAPES = [(8, 128), (37, 128), (2304, 128), (20, 200), (128, 128), (512, 128), (23, 130), (21, 1000)]
# (G, rows, L, n_gathers)
CHAINED_SHAPES = [(3, 37, 128, 8), (5, 512, 128, 8), (2, 17, 100, 3)]
# (G, A, B, lanes): G*A*B rows ragged against a block's 8 warps
RELAYOUT_SHAPES = [(3, 18, 128, 128), (5, 3, 7, 64)]


def _table(shape, hi, dev, seed=0):
    rng = np.random.default_rng(seed)
    t = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
    idx = torch.from_numpy(rng.integers(0, hi, shape).astype(np.int32)).to(dev)
    return t, idx


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ROW_SHAPES)
def test_p1_row_gather_matches_twin(shape, card):
    t, r = _table(shape, shape[0], card)
    n = gp.ROW_GATHER.launches
    out = gp.row_gather(t, r)
    assert gp.ROW_GATHER.launches == n + 1
    assert torch.equal(out, gp.row_gather_reference(t, r))  # a gather copies values


@pytest.mark.cuda
@pytest.mark.parametrize("shape", LANE_SHAPES)
def test_p2_lane_gather_matches_twin(shape, card):
    t, l = _table(shape, shape[1], card)
    n = gp.LANE_GATHER.launches
    out = gp.lane_gather(t, l)
    assert gp.LANE_GATHER.launches == n + 1
    assert torch.equal(out, gp.lane_gather_reference(t, l))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CHAINED_SHAPES)
def test_p3_chained_gather_matches_twin(shape, card):
    G, rows, L, n_gathers = shape
    t, l = _table((G, rows, L), L, card)
    n = gp.CHAINED_GATHER.launches
    out = gp.chained_gather(t, l, n_gathers)
    assert gp.CHAINED_GATHER.launches == n + 1
    assert torch.equal(out, gp.chained_gather_reference(t, l, n_gathers))  # the same k order


@pytest.mark.cuda
@pytest.mark.parametrize("shape", RELAYOUT_SHAPES)
def test_p4_relayout_matches_twin(shape, card):
    G, A, B, lanes = shape
    c, _ = _table((G, A, B), 1, card)
    n = gp.RELAYOUT.launches
    out = gp.relayout(c, 7, lanes)
    assert gp.RELAYOUT.launches == n + 1
    assert out.shape == (G, A * B, lanes)
    assert torch.equal(out, gp.relayout_reference(c, 7, lanes))


@pytest.mark.cuda
def test_p3_takes_indices_mod_L_like_its_twin(card):
    t, _ = _table((2, 20, 128), 1, card)
    l = torch.from_numpy(np.random.default_rng(5).integers(-300, 300, (2, 20, 128)).astype(np.int32)).to(card)
    assert torch.equal(gp.chained_gather(t, l), gp.chained_gather_reference(t, l))


@pytest.mark.cuda
def test_probes_give_nan_for_an_index_outside_the_table(card):
    t, r = _table((40, 128), 40, card)
    r[3, 5] = 40
    l = r.clone()
    l[3, 5] = -1
    assert torch.isnan(gp.row_gather(t, r)[3, 5])
    assert torch.isnan(gp.lane_gather(t, l)[3, 5])
    assert int(torch.isnan(gp.row_gather(t, r)).sum()) == 1


def _odd_view(x):
    """A contiguous copy of ``x`` whose storage starts 4 bytes past a
    16-byte boundary."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    view = buf[1:].view(x.shape)
    view.copy_(x)
    assert view.is_contiguous() and view.data_ptr() % 16 == 4
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("odd", ["table", "indices", "both"])
def test_p1_p2_take_a_view_at_an_odd_offset(odd, card):
    """A contiguous view that is only 4-byte aligned is taken by the 4-byte
    route, and read rightly."""
    t, r = _table((300, 128), 300, card)
    _, l = _table((300, 128), 128, card, seed=1)
    tv = _odd_view(t) if odd != "indices" else t
    rv, lv = (_odd_view(r), _odd_view(l)) if odd != "table" else (r, l)
    assert torch.equal(gp.row_gather(tv, rv), gp.row_gather_reference(t, r))
    assert torch.equal(gp.lane_gather(tv, lv), gp.lane_gather_reference(t, l))


@pytest.mark.cuda
def test_p1_p2_refuse_a_strided_view(card):
    t, r = _table((64, 256), 64, card)
    with pytest.raises(ValueError):
        gp.row_gather(t[:, ::2], r[:, ::2])
    with pytest.raises(ValueError):
        gp.lane_gather(t[:, :128], r[:, :128])


@pytest.mark.cuda
@pytest.mark.parametrize("L", [128, 130])
def test_p1_p2_nan_on_both_routes_and_equal_runs(L, card):
    """An index outside the table gives NaN and nothing else changes, on the
    16-byte route (L = 128) and the 4-byte route (L = 130); two runs give
    equal bits."""
    t, r = _table((300, L), 300, card)
    _, l = _table((300, L), L, card, seed=1)
    r[7, 9], r[299, L - 1], l[7, 9], l[0, 0] = 300, -1, L, -5
    for fn, idx, ref_fn, bad in ((gp.row_gather, r, gp.row_gather_reference, [(7, 9), (299, L - 1)]),
                                 (gp.lane_gather, l, gp.lane_gather_reference, [(7, 9), (0, 0)])):
        out, again = fn(t, idx), fn(t, idx)
        assert torch.equal(out.nan_to_num(nan=123.0), again.nan_to_num(nan=123.0))
        assert int(torch.isnan(out).sum()) == 2 and all(bool(torch.isnan(out[i, j])) for i, j in bad)
        safe = idx.clone()
        for i, j in bad:
            safe[i, j] = 0
        ref = ref_fn(t, safe)
        for i, j in bad:
            ref[i, j] = float("nan")
        assert torch.equal(out.nan_to_num(nan=123.0), ref.nan_to_num(nan=123.0))


@pytest.mark.cuda
@pytest.mark.parametrize("guard", [4096, 4099])
@pytest.mark.parametrize("shape", [(300, 128), (37, 130), (2304, 128)])
def test_p1_p2_write_only_their_output(shape, guard, card):
    """With the output placed inside a larger buffer of sentinels (16-byte
    aligned after 4096 floats, 4-byte aligned after 4099), every float
    outside it keeps its sentinel and every float inside is written."""
    from psi_tpu_torch.ops import _cuda

    rows, L = shape
    t, r = _table(shape, rows, card)
    _, l = _table(shape, L, card, seed=1)
    n, sentinel = rows * L, -12345.0
    for kernel, idx, ref in ((gp.ROW_GATHER, r, gp.row_gather_reference(t, r)),
                             (gp.LANE_GATHER, l, gp.lane_gather_reference(t, l))):
        buf = torch.full((n + 2 * guard,), sentinel, device=card)
        out = buf[guard:guard + n].view(rows, L)
        kernel.launch(card, t.data_ptr(), idx.data_ptr(), out.data_ptr(), rows, L, _cuda.stream_of(t))
        torch.cuda.synchronize()
        assert torch.equal(out, ref)
        assert bool((buf[:guard] == sentinel).all()) and bool((buf[guard + n:] == sentinel).all())


@pytest.mark.cuda
def test_probes_opt_in_to_large_shared_memory_once(card):
    """P1 at 2304 rows (74 KB a block) and P2 at L = 1000 (64 KB) need the
    opt-in above 48 KB: it is made at a kernel's first such launch on a
    device and never again."""
    from psi_tpu_torch.ops import _cuda

    t, r = _table((2304, 128), 2304, card)
    tw, lw = _table((21, 1000), 1000, card)
    gp.row_gather(t, r)
    gp.lane_gather(tw, lw)
    made = _cuda.library().psi_probe_smem_opt_ins()
    assert 2 <= made <= 5  # at most one for each of P1's and P2's two routes and P3
    for _ in range(3):
        gp.row_gather(t, r)
        gp.lane_gather(tw, lw)
    t2, r2 = _table((5000, 100), 5000, card)  # 160 KB a block, the same kernel
    assert torch.equal(gp.row_gather(t2, r2), gp.row_gather_reference(t2, r2))
    assert _cuda.library().psi_probe_smem_opt_ins() == made


@pytest.mark.cuda
def test_launch_binds_its_entry_point_once(card):
    """Kernel.launch looks its C function up at the first launch and keeps
    it; the count goes up by one a launch."""
    t, l = _table((37, 128), 128, card)
    gp.lane_gather(t, l)
    entry, n = gp.LANE_GATHER._entry, gp.LANE_GATHER.launches
    assert entry is not None
    gp.lane_gather(t, l)
    assert gp.LANE_GATHER._entry is entry and gp.LANE_GATHER.launches == n + 1


_TWO_THREADS = """
import sys, threading
from pathlib import Path
import torch
from psi_tpu_torch.ops import _cuda, chamfer, gather_probes as gp
_cuda.BUILD_DIR = Path(sys.argv[1])  # empty: the first launch has to build
dev = torch.device("cuda", 0)
g = torch.Generator().manual_seed(0)
x, y = torch.randn((3, 200, 3), generator=g).to(dev), torch.randn((3, 700, 3), generator=g).to(dev)
t = torch.randn((300, 128), generator=g).to(dev)
i = torch.randint(0, 300, (300, 128), generator=g, dtype=torch.int32).to(dev)
gate, out = threading.Barrier(2), {}
def first(name, fn):
    gate.wait(60)
    try:
        out[name] = fn()
    except BaseException as e:
        out[name] = e
threads = [threading.Thread(target=first, args=("k3", lambda: chamfer.nn_argmin(x, y))),
           threading.Thread(target=first, args=("p1", lambda: gp.row_gather(t, i)))]
[th.start() for th in threads]
[th.join(600) for th in threads]
torch.cuda.synchronize()
for name, v in out.items():
    if isinstance(v, BaseException):
        raise v
assert torch.equal(out["k3"], chamfer.nn_argmin_reference(x, y)), "K3 differs from its twin"
assert torch.equal(out["p1"], gp.row_gather_reference(t, i)), "P1 differs from its twin"
built = sorted(p.name for p in _cuda.BUILD_DIR.iterdir())
assert [n for n in built if n.endswith(".so")] == [_cuda.library_path().name], built
print("OK", chamfer.NN_ARGMIN.launches, gp.ROW_GATHER.launches)
"""


@pytest.mark.cuda
def test_two_threads_launching_their_first_kernels_together_build_once(card, tmp_path):
    """In a fresh process whose build directory is empty, one thread launches
    K3 and another P1 at the same moment: the library is built once (no
    temporary file is left and none was shared), both results equal their
    twins. The repository's own build directory is not touched."""
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    r = subprocess.run([sys.executable, "-c", _TWO_THREADS, str(tmp_path / "kernels")], cwd=root,
                       capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.strip().splitlines()[-1] == "OK 1 1"


@pytest.mark.cuda
def test_probes_reject_operands_they_do_not_take(card):
    t, r = _table((8, 128), 8, card)
    with pytest.raises(TypeError):
        gp.row_gather(t, r.long())
    with pytest.raises(ValueError):
        gp.lane_gather(t, r.cpu())


# ---- the training path: K3 through scene_geometry_losses and the train step

TRAIN_ASSETS = dict(num_verts=300, num_joints=12, num_scenes=3, sdf_dim=16, scene_points=777, n_contact=45)


def _train_world(dev, model_type="s1", batch=5):
    """Tiny assets (a ragged 777-point cloud: no multiple of K3's tile or
    chunk), a model and one batch on ``dev``, all from seeds."""
    from psi_tpu_torch.data.synthetic import SyntheticBatchGenerator, make_synthetic_assets
    from psi_tpu_torch.train.loop import _stage_chunk, init_state
    from psi_tpu_torch.utils.config import TrainConfig

    assets, _ = make_synthetic_assets(**TRAIN_ASSETS, device=dev)
    state = init_state(TrainConfig(model_type=model_type, latentD=32, image_size=32, batch_size=batch, seed=0), dev)
    host = SyntheticBatchGenerator(num_scenes=3, batches_per_epoch=1, seed=4, image_size=32).next_batch(batch)
    staged = {k: v[0] for k, v in _stage_chunk([host], False, dev).items()}
    gen = torch.Generator().manual_seed(9)
    eps = [torch.randn((batch, 32), generator=gen).to(dev) for _ in range(2)]
    return assets, state, staged, (eps[0] if model_type == "s1" else tuple(eps))


@pytest.mark.cuda
def test_scene_geometry_losses_launch_k3_on_the_unpruned_ragged_cloud(card):
    """The same bodies on the card and on the CPU: a CUDA tensor launches K3
    (once, over all 777 points), a CPU tensor takes the twin (no launch), and
    the two losses and their gradients agree (f32 sums in another order:
    1e-5 relative on the losses, 1e-4 of the largest gradient entry)."""
    from psi_tpu_torch.train.objective import scene_geometry_losses

    out = {}
    for dev in (torch.device("cpu"), card):
        assets, _, batch, _ = _train_world(dev)
        x = (batch["xh"] * 1.0).requires_grad_(True)
        n = tch.NN_ARGMIN.launches
        contact, collision = scene_geometry_losses(assets, x, batch["cam_ext"], batch["scene_idx"], 1.0)
        assert tch.NN_ARGMIN.launches - n == (1 if dev.type == "cuda" else 0)
        (g,) = torch.autograd.grad(contact + collision, x)
        out[dev.type] = (contact.item(), collision.item(), g.cpu())
    assert out["cpu"][0] > 0
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-5)
    np.testing.assert_allclose(out["cuda"][1], out["cpu"][1], rtol=1e-5, atol=1e-8)
    assert (out["cuda"][2] - out["cpu"][2]).abs().max() <= 1e-4 * out["cpu"][2].abs().max()


@pytest.mark.cuda
def test_pruned_scene_geometry_losses_also_launch_k3(card):
    from psi_tpu_torch.train.objective import scene_geometry_losses

    assets, _, batch, _ = _train_world(card)
    n = tch.NN_ARGMIN.launches
    pruned, _ = scene_geometry_losses(assets, batch["xh"], batch["cam_ext"], batch["scene_idx"], 1.0,
                                      prune_scene_points=256)
    full, _ = scene_geometry_losses(assets, batch["xh"], batch["cam_ext"], batch["scene_idx"], 1.0)
    assert tch.NN_ARGMIN.launches - n == 2
    assert pruned.item() >= full.item() > 0  # a subset of the cloud cannot be nearer


@pytest.mark.cuda
@pytest.mark.parametrize("model_type", ["s1", "s2"])
def test_train_step_on_the_card_matches_the_cpu(model_type, card):
    """One step at small width, same weights, batch and injected noise: the
    metrics within 1e-4 relative, every parameter's gradient within 1e-3 of
    that parameter's largest |CPU gradient| (on the card the backward of
    gather, index_add_ and cuDNN's convolutions sums with atomics), one K3
    launch on the card and none on the CPU."""
    from psi_tpu_torch.train.loop import make_train_step
    from psi_tpu_torch.utils.config import LossConfig

    sides = {}
    for dev in (torch.device("cpu"), card):
        assets, state, batch, eps = _train_world(dev, model_type)
        n = tch.NN_ARGMIN.launches
        state, metrics = make_train_step(assets, LossConfig(), model_type)(state, batch, 0.7, 1.0, eps=eps)
        assert tch.NN_ARGMIN.launches - n == (1 if dev.type == "cuda" else 0)
        assert state.step == 1 and state.model.training
        sides[dev.type] = ({k: v.item() for k, v in metrics.items()},
                           {k: p.grad.cpu() for k, p in state.model.named_parameters()})
    for k, v in sides["cpu"][0].items():
        np.testing.assert_allclose(sides["cuda"][0][k], v, rtol=1e-4, atol=1e-8, err_msg=k)
    for k, g in sides["cpu"][1].items():
        assert (sides["cuda"][1][k] - g).abs().max() <= 1e-3 * g.abs().max() + 1e-12, k


@pytest.mark.cuda
def test_trainop_defaults_to_the_card_and_resumes_there(card, tmp_path):
    """TrainOP with no device trains on the card (K3 once a step), and a
    second TrainOP resumes its checkpoint, the card generator's state included."""
    from psi_tpu_torch.data.synthetic import SyntheticBatchGenerator, make_synthetic_assets
    from psi_tpu_torch.train.loop import TrainOP
    from psi_tpu_torch.utils.config import LossConfig, TrainConfig

    assets, _ = make_synthetic_assets(**TRAIN_ASSETS, device=card)
    cfg = TrainConfig(latentD=32, image_size=32, batch_size=4, epoch=2, save_dir=str(tmp_path), saving_per_epochs=1,
                      verbose=False, scan_epoch=True, scan_chunk_size=2, stage_bf16=True)
    gen = SyntheticBatchGenerator(num_scenes=3, batches_per_epoch=3, seed=1, image_size=32)
    op = TrainOP(cfg, LossConfig(), assets)
    n = tch.NN_ARGMIN.launches
    last = op.train(gen)
    assert tch.NN_ARGMIN.launches - n == 6 and op.state.step == 6 and np.isfinite(last["loss"])
    assert next(op.model.parameters()).device.type == "cuda"
    op2 = TrainOP(cfg, LossConfig(), assets)
    op2.train(gen)
    assert op2.state.step == 6
    assert torch.equal(torch.randn(3, generator=op.state.generator, device=card),
                       torch.randn(3, generator=op2.state.generator, device=card))


# ---- the file-driven fit and the carried-Adam mode on the card

def _fit_world(dev, n=6):
    from psi_tpu_torch.data.synthetic import make_synthetic_assets

    assets, _ = make_synthetic_assets(**TRAIN_ASSETS, sdf_dtype=torch.bfloat16, device=dev)
    rng = np.random.default_rng(2)
    x72 = torch.from_numpy(rng.normal(0, 0.2, (n, 72)).astype(np.float32)).to(dev)
    cam = torch.eye(4, device=dev).repeat(n, 1, 1)
    target = 0.5 * (assets.grid_mins[0] + assets.grid_maxs[0])
    target[1] = 0.8 * assets.grid_mins[0, 1]
    cam[:, :3, 3] = target - x72[:, :3].mean(dim=0)
    return assets, x72, cam, torch.zeros(n, dtype=torch.int64, device=dev)


def _skin_launches():
    return tfs.SKIN_FWD.launches, tfs.SKIN_BWD.launches, tch.NN_ARGMIN.launches


@pytest.mark.cuda
def test_carried_adam_and_drivers_run_on_the_card(card, tmp_path):
    """The serial mode launches K1 and K2 at one body; FittingOP and TestOP
    default to the card and write plain numpy pickles."""
    import pickle

    from psi_tpu_torch.fit.fitting import FittingOP, make_fit_step_carry_opt_state
    from psi_tpu_torch.gen.sample import TestOP
    from psi_tpu_torch.models.cvae_s1 import HumanCVAES1
    from psi_tpu_torch.utils.config import FitConfig
    from psi_tpu_torch.utils.init import seeded_init_

    assets, x72, cam, sidx = _fit_world(card, n=3)
    before = _skin_launches()
    x, m = make_fit_step_carry_opt_state(assets, FitConfig.production(num_iter=2))(x72, cam, sidx)
    assert tuple(a - b for a, b in zip(_skin_launches(), before)) == (3 * 2 + 1, 3 * 2, 3 * 2 + 1)
    assert x.device.type == "cuda" and torch.isfinite(x).all() and m["total"].shape == (3,)

    op = TestOP(seeded_init_(HumanCVAES1(latentD=32, image_size=32), 0), n_samples=5)
    assert op.device.type == "cuda" and next(op.model.parameters()).device.type == "cuda"
    rng = np.random.default_rng(0)
    batch = dict(xs=rng.uniform(-1, 1, (1, 32, 32, 2)).astype(np.float32), max_d=np.array([4.0], np.float32),
                 cam_int=np.array([[[30.0, 0, 16], [0, 30.0, 16], [0, 0, 1]]], np.float32),
                 cam_ext=cam[:1].cpu().numpy())
    assert op.test(batch, str(tmp_path), "gen", idx_offset=0) == 5
    fit = FittingOP(assets, FitConfig.production(num_iter=3, prune_scene_points=256), 0, max_population=4)
    assert fit.device.type == "cuda"
    assert fit.fitting_files(str(tmp_path / "gen"), str(tmp_path / "fit")) == 5
    with open(tmp_path / "fit" / "body_gen_000004.pkl", "rb") as f:
        rec = pickle.load(f)
    assert all(type(v) is np.ndarray for v in rec.values()) and rec["transl"].shape == (1, 3)
    assert fit.fitting_files(str(tmp_path / "gen"), str(tmp_path / "fit")) == 0


# ---- K4 and K5, the split-bf16 products of the 'high' LBS tier

def _split_case(name, dev):
    """(a, b, the split product, its contraction) on ``dev``, from a seed:
    the correctives at a ragged width (K = 99 and 486: not a multiple of a
    wgmma k step or of a ring stage of 64; N = 900 and 3001: not of a
    128-column panel), at one body, 32 (one 64-row tile, the warpgroups on
    two column halves) and 130 (past a block's 128 rows); the blend at 13
    bodies and at one; a batched product, a transposed (strided) lhs, and a
    2-D lhs under a batched rhs (its gradient sums over the batch)."""
    from psi_tpu_torch.ops import precision as tp

    rng = np.random.default_rng(3)

    def t(*shape, scale=1.0):
        return torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32)).to(dev)

    def blend(w, a):
        return torch.einsum("vj,bjz->bvz", w, a)

    cases = {
        "correctives": lambda: (t(5, 99), t(99, 900, scale=0.01), tp.matmul_f32x3, torch.matmul),
        "correctives_b1": lambda: (t(1, 486), t(486, 3001, scale=0.01), tp.matmul_f32x3, torch.matmul),
        "correctives_b32": lambda: (t(32, 486), t(486, 3001, scale=0.01), tp.matmul_f32x3, torch.matmul),
        "correctives_b130": lambda: (t(130, 486), t(486, 777, scale=0.01), tp.matmul_f32x3, torch.matmul),
        "blend": lambda: (t(2051, 55).abs(), t(13, 55, 12),
                          lambda w, a: tp.einsum_f32x3("vj,bjz->bvz", w, a, 1, 1), blend),
        "blend_b1": lambda: (t(2051, 55).abs(), t(1, 55, 12),
                             lambda w, a: tp.einsum_f32x3("vj,bjz->bvz", w, a, 1, 1), blend),
        "batched": lambda: (t(4, 32, 55), t(4, 55, 16), tp.matmul_f32x3, torch.matmul),
        "strided_lhs": lambda: (t(70, 33).T, t(70, 41), tp.matmul_f32x3, torch.matmul),
        "shared_lhs": lambda: (t(40, 70), t(3, 70, 50), tp.matmul_f32x3, torch.matmul),
    }
    return cases[name]()


SPLIT_CASES = ("correctives", "correctives_b1", "correctives_b32", "correctives_b130", "blend", "blend_b1",
               "batched", "strided_lhs", "shared_lhs")


def _split_grads_close(got, want):
    """K5 against the twin: the same bf16 cotangent blocks but for f32 sums
    in another order, so on <= 1% of the elements a block rounds to the
    neighbouring bf16; such an element moves by at most one bf16 ulp of the
    operand's largest gradient (2^-7 of it)."""
    differ = got != want
    assert differ.float().mean().item() <= 0.01
    assert ((got - want).abs().max() / want.abs().max()).item() <= 2.0**-7


@pytest.mark.cuda
@pytest.mark.parametrize("name", SPLIT_CASES)
def test_k4_k5_match_their_twins_and_are_deterministic(name, card):
    from psi_tpu_torch.ops import precision as tp
    from psi_tpu_torch.utils.precision import strict_f32

    a, b, split, fn = _split_case(name, card)
    with strict_f32():
        n = (tp.SPLIT_FWD.launches, tp.SPLIT_BWD.launches)
        x, y = a.clone().requires_grad_(True), b.clone().requires_grad_(True)
        out = split(x, y)
        again = split(a, b)
        g = torch.randn(out.shape, generator=torch.Generator(device=card).manual_seed(4), device=card)
        out.backward(g)
        assert (tp.SPLIT_FWD.launches, tp.SPLIT_BWD.launches) == (n[0] + 2, n[1] + 2)
        ref = tp.split_product_reference(a, b, fn)
        gref = tp.split_product_grad_reference(a, b, g, fn)
        x2, y2 = a.clone().requires_grad_(True), b.clone().requires_grad_(True)
        split(x2, y2).backward(g)
    torch.cuda.synchronize()
    assert out.shape == ref.shape and torch.equal(out, again)
    # the same exact bf16 products, the twin's sums in float64
    assert ((out - ref).abs().max() / ref.abs().max()).item() <= 2e-6
    for t1, t2, want in ((x, x2, gref[0]), (y, y2, gref[1])):
        assert torch.equal(t1.grad, t2.grad)  # no atomics: equal bits
        _split_grads_close(t1.grad, want)


@pytest.mark.cuda
def test_k5_serves_the_gradient_of_a_shared_operand(card):
    """The blend's weights serve every body and a 2-D lhs every product of
    a batched rhs: their gradients sum over the batch inside K5's grouped
    contraction, before the bf16 rounding, and match the twin; one K5 launch
    each, and the operand the batch does not share gets none."""
    from psi_tpu_torch.ops import precision as tp

    for name, shared in (("blend", 0), ("shared_lhs", 0)):
        a, b, split, fn = _split_case(name, card)
        w = a.clone().requires_grad_(True)
        out = split(w, b)
        g = torch.randn(out.shape, generator=torch.Generator(device=card).manual_seed(5), device=card)
        n = tp.SPLIT_BWD.launches
        out.backward(g)
        assert tp.SPLIT_BWD.launches == n + 1
        torch.cuda.synchronize()
        _split_grads_close(w.grad, tp.split_product_grad_reference(a, b, g, fn, (True, False))[shared])


@pytest.mark.cuda
def test_k4_writes_only_its_output(card):
    """The output placed inside a buffer of sentinels at a ragged shape:
    every float outside [T, M, N] keeps its sentinel, every one inside is written."""
    from psi_tpu_torch.ops import precision as tp

    a, b, _, _ = _split_case("blend", card)
    gm = tp.blend_gemm(a, b)
    n, guard, sentinel = math.prod(gm.out_shape), 1031, -12345.0
    buf = torch.full((n + 2 * guard,), sentinel, device=card)
    out = tp.split_mm(gm, out=buf[guard:guard + n].view(gm.out_shape))
    torch.cuda.synchronize()
    assert torch.equal(out, tp.split_mm(gm))
    assert bool((buf[:guard] == sentinel).all()) and bool((buf[guard + n:] == sentinel).all())
    assert bool((out != sentinel).all())


@pytest.mark.cuda
def test_pack_matches_its_twin_and_the_cache_follows_its_source(card):
    """The pack launch's planes equal pack_reference's in bits, for K4's and
    K5's layouts, a grouped contraction and a batched B; a B that takes no
    gradient is packed once, repacked after an in-place change, and the
    product follows the change."""
    from psi_tpu_torch.ops import precision as tp

    rng = np.random.default_rng(9)
    w = torch.from_numpy(rng.random((2051, 55)).astype(np.float32)).to(card)
    a12 = torch.from_numpy(rng.normal(size=(13, 55, 12)).astype(np.float32)).to(card)
    bb = torch.from_numpy(rng.normal(size=(4, 55, 16)).astype(np.float32)).to(card)
    g = torch.ones(13, 2051, 12, device=card)
    for gm, grad in ((tp.blend_gemm(w, a12), False), (tp.blend_grad_gemms(w, a12, g, (True, True))[0], True),
                     (tp.blend_grad_gemms(w, a12, g, (True, True))[1], True),
                     (tp.matmul_gemm(torch.ones(4, 32, 55, device=card), bb), False)):
        tp.PACKS.clear()
        assert torch.equal(tp.pack(gm, grad), tp.pack_reference(gm, grad))
    tp.PACKS.clear()
    pd = torch.from_numpy(rng.normal(size=(486, 3001)).astype(np.float32) * 0.01).to(card)
    pf = torch.from_numpy(rng.normal(size=(32, 486)).astype(np.float32)).to(card)
    n = tp.SPLIT_PACK.launches
    first = tp.matmul_f32x3(pf, pd)
    assert torch.equal(tp.matmul_f32x3(pf, pd), first) and tp.SPLIT_PACK.launches == n + 1
    pd.mul_(2.0)
    second = tp.matmul_f32x3(pf, pd)
    torch.cuda.synchronize()
    assert tp.SPLIT_PACK.launches == n + 2 and torch.equal(second, 2.0 * first)
    del pd
    assert tp.PACKS.nbytes() == 0


# ---- K6: the einsum decode's per-vertex tail (ops/vertex_tail.py)

# (B, V): the exact fit's population, a training batch, one body; all at
# SMPL-X's 10,475 vertices (no multiple of the kernel's 256-vertex block)
VTAIL_SHAPES = [(256, 10475), (32, 10475), (1, 10475)]
VTAIL_REL_TOL = 1e-6  # of max |twin|: f32 FMAs against the twin summed in float64


def _vtail_case(B, V, dev, seed=0):
    """(T12, v_posed, transl, cam_ext, cotangent) on ``dev``, T12 blended-
    transform-like (rotation-sized 3x3, metre-sized translation column)."""
    rng = np.random.default_rng(seed)
    T = rng.normal(0, 0.3, (B, V, 3, 4))
    T[..., :3] += np.eye(3)
    cam = np.tile(np.eye(4), (B, 1, 1))
    th = rng.normal(0, 0.3, B)
    cam[:, 0, 0], cam[:, 0, 2], cam[:, 2, 0], cam[:, 2, 2] = np.cos(th), np.sin(th), -np.sin(th), np.cos(th)
    cam[:, :3, 3] = rng.normal(0, 2.0, (B, 3))
    arrays = (T.reshape(B, V, 12), rng.normal(0, 0.5, (B, V, 3)), rng.normal(0, 1.0, (B, 3)), cam,
              rng.normal(0, 1.0, (B, V, 3)))
    return [torch.from_numpy(a.astype(np.float32)).to(dev) for a in arrays]


def _vtail_run(fn, T12, v, transl, cam, g):
    """fn's output and its gradients to T12, v_posed and transl for cotangent g."""
    leaves = [x.detach().clone().requires_grad_() for x in (T12, v, transl)]
    out = fn(*leaves, cam)
    out.backward(g)
    return [out.detach()] + [x.grad for x in leaves]


def _vtail_twin64(T12, v, transl, cam, g):
    from psi_tpu_torch.ops import vertex_tail as vt

    d = [x.double() for x in (T12, v, transl, g)]
    return _vtail_run(vt.vertex_tail_reference, d[0], d[1], d[2], None if cam is None else cam.double(), d[3])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", VTAIL_SHAPES)
@pytest.mark.parametrize("with_cam", [True, False])
def test_k6_forward_and_backward_match_twin(shape, with_cam, card):
    """verts, grad_T, grad_v_posed and grad_transl within 1e-6 of max |twin|
    (the twin's einsum chain in float64 on the card); one K6 launch forward
    and one backward."""
    from psi_tpu_torch.ops import vertex_tail as vt

    T12, v, transl, cam, g = _vtail_case(*shape, card)
    cam = cam if with_cam else None
    f0, b0 = vt.VTAIL_FWD.launches, vt.VTAIL_BWD.launches
    got = _vtail_run(vt.vertex_tail, T12, v, transl, cam, g)
    torch.cuda.synchronize()
    assert (vt.VTAIL_FWD.launches - f0, vt.VTAIL_BWD.launches - b0) == (1, 1)
    for name, a, b in zip(("verts", "grad_T", "grad_v_posed", "grad_transl"), got, _vtail_twin64(T12, v, transl, cam, g)):
        assert a.dtype == torch.float32 and a.shape == b.shape, name
        err = (a.double() - b).abs().max().item()
        assert err <= VTAIL_REL_TOL * b.abs().max().item(), (name, err, b.abs().max().item())


@pytest.mark.cuda
def test_k6_two_runs_give_equal_bits(card):
    from psi_tpu_torch.ops import vertex_tail as vt

    case = _vtail_case(256, 10475, card, seed=1)
    first = _vtail_run(vt.vertex_tail, *case)
    second = _vtail_run(vt.vertex_tail, *case)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_k6_captures_into_a_cuda_graph_and_replays(card):
    """Forward and backward captured into one CUDA graph: a replay on new
    inputs copied into the static tensors gives the eager call's bits."""
    from psi_tpu_torch.ops import vertex_tail as vt

    T12, v, transl, cam, g = _vtail_case(32, 10475, card, seed=2)
    static = [x.clone() for x in (T12, v, transl, cam, g)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the capture
        _vtail_run(vt.vertex_tail, *static)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    captured = vt.VTAIL_FWD.captured, vt.VTAIL_BWD.captured
    with torch.cuda.graph(graph):
        outs = _vtail_run(vt.vertex_tail, *static)
    assert (vt.VTAIL_FWD.captured - captured[0], vt.VTAIL_BWD.captured - captured[1]) == (1, 1)
    fresh = _vtail_case(32, 10475, card, seed=3)
    for s, x in zip(static, fresh):
        s.copy_(x)
    graph.replay()
    torch.cuda.synchronize()
    for a, b in zip(outs, _vtail_run(vt.vertex_tail, *fresh)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_k6_rejects_operands_it_does_not_take(card):
    """bf16 operands, non-contiguous operands, a T12 off 16-byte alignment and
    a cam_ext that requires a gradient all raise; nothing falls back."""
    from psi_tpu_torch.ops import vertex_tail as vt

    T12, v, transl, cam, _ = _vtail_case(3, 300, card)
    with pytest.raises(TypeError):
        vt.vertex_tail(T12.bfloat16(), v, transl, cam)
    with pytest.raises(TypeError):
        vt.vertex_tail(T12, v.bfloat16(), transl, cam)
    with pytest.raises(ValueError, match="contiguous"):
        vt.vertex_tail(T12.transpose(0, 1).contiguous().transpose(0, 1), v, transl, cam)
    with pytest.raises(ValueError, match="contiguous"):
        vt.vertex_tail(T12, v, torch.cat([transl, transl], 1)[:, :3], cam)
    with pytest.raises(ValueError, match="aligned"):
        vt.vertex_tail(torch.cat([T12.reshape(-1), T12.reshape(-1)[:1]])[1:].reshape(T12.shape), v, transl, cam)
    with pytest.raises(ValueError, match="gradient"):
        vt.vertex_tail(T12, v, transl, cam.clone().requires_grad_())


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["high", "fast"])
def test_decode_on_the_card_runs_k6_once_each_way(precision, card):
    """body_vec_to_verts with extrinsics on the card: one K6 launch forward
    and one backward, verts within 1e-4 m of the CPU's (its twin)."""
    from psi_tpu_torch.body.decode import body_vec_to_verts
    from psi_tpu_torch.body.smplx_model import synthetic_smplx
    from psi_tpu_torch.body.vposer import synthetic_vposer
    from psi_tpu_torch.ops import vertex_tail as vt

    smplx, vposer = synthetic_smplx(num_verts=2051, num_joints=55, seed=0), synthetic_vposer(seed=0)
    rng = np.random.default_rng(5)
    x72 = torch.from_numpy((rng.normal(size=(13, 72)) * 0.3).astype(np.float32))
    cam = _vtail_case(13, 1, "cpu")[3]
    cpu = body_vec_to_verts(smplx, vposer, x72, cam, precision=precision)[0]
    f0, b0 = vt.VTAIL_FWD.launches, vt.VTAIL_BWD.launches
    x = x72.to(card).requires_grad_()
    verts = body_vec_to_verts(smplx.to(card), vposer.to(card), x, cam.to(card), precision=precision)[0]
    verts.sum().backward()
    torch.cuda.synchronize()
    assert (vt.VTAIL_FWD.launches - f0, vt.VTAIL_BWD.launches - b0) == (1, 1)
    assert torch.isfinite(x.grad).all()
    tol = 1e-4 if precision == "high" else 2.5e-2
    assert (verts.detach().cpu() - cpu).abs().max().item() <= tol
