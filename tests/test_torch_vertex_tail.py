"""The einsum decode's per-vertex tail (``ops/vertex_tail.py``) on the CPU.

On a CPU tensor ``vertex_tail`` is its plain twin, and the twin is the
chain the decode ran before kernel K6 existed: the 3x4 apply of ``lbs``,
``+ transl`` in ``smplx_forward`` and ``verts_transform`` in
``body_vec_to_verts``. These tests hold the twin to that chain in bits, the
decode's vertices and gradients to the decode with that chain in bits on
both einsum tiers, the twin's gradient to finite differences in float64,
and the benchmark's reader of K6's device time to its kernels alone. K6
itself is held to the twin on the card (``test_torch_kernels.py``).
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark.run import Context, load_reader
from benchmark.trace import TraceView
from psi_tpu_torch.body import lbs as lbs_module
from psi_tpu_torch.body.decode import body_vec_to_verts
from psi_tpu_torch.body.smplx_model import synthetic_smplx
from psi_tpu_torch.body.vposer import synthetic_vposer
from psi_tpu_torch.geometry.camera import verts_transform
from psi_tpu_torch.ops import vertex_tail as vt

torch.set_num_threads(1)


def old_chain(T12, v_posed, transl, cam_ext):
    """The decode's tail as lbs, smplx_forward and body_vec_to_verts wrote it."""
    B = T12.shape[0]
    T34 = T12.reshape(B, -1, 3, 4)
    verts = torch.einsum("bvxy,bvy->bvx", T34[..., :3], v_posed) + T34[..., 3]
    if transl is not None:
        verts = verts + transl[:, None, :]
    if cam_ext is not None:
        verts = verts_transform(verts, cam_ext)
    return verts


def _cams(rng, n, dtype=np.float32):
    cam = np.tile(np.eye(4), (n, 1, 1))
    th = rng.normal(0, 0.3, n)
    cam[:, 0, 0], cam[:, 0, 2], cam[:, 2, 0], cam[:, 2, 2] = np.cos(th), np.sin(th), -np.sin(th), np.cos(th)
    cam[:, :3, 3] = rng.normal(0, 0.5, (n, 3))
    return torch.from_numpy(cam.astype(dtype))


def _operands(B, V, dtype=np.float32, seed=0):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(a.astype(dtype))  # noqa: E731
    return (t(rng.normal(0, 1.0, (B, V, 12))), t(rng.normal(0, 0.5, (B, V, 3))), t(rng.normal(0, 0.5, (B, 3))),
            _cams(rng, B, dtype))


@pytest.mark.parametrize("shape", [(1, 1), (3, 257), (4, 1000)])
@pytest.mark.parametrize("with_transl", [True, False])
@pytest.mark.parametrize("with_cam", [True, False])
def test_twin_is_the_old_chain_in_bits(shape, with_transl, with_cam):
    T12, v, transl, cam = _operands(*shape)
    transl = transl if with_transl else None
    cam = cam if with_cam else None
    got = vt.vertex_tail(T12, v, transl, cam)
    assert torch.equal(got, old_chain(T12, v, transl, cam))
    assert torch.equal(got, vt.vertex_tail_reference(T12, v, transl, cam))


@pytest.mark.parametrize("with_transl", [True, False])
@pytest.mark.parametrize("with_cam", [True, False])
def test_twin_gradcheck_float64(with_transl, with_cam):
    T12, v, transl, cam = _operands(2, 5, np.float64, seed=1)
    args = [T12.requires_grad_(), v.requires_grad_()]
    if with_transl:
        args.append(transl.requires_grad_())

    def f(T, p, *tr):
        return vt.vertex_tail(T, p, tr[0] if tr else None, cam if with_cam else None)

    assert torch.autograd.gradcheck(f, tuple(args))


def test_twin_gradients_are_the_old_chains_in_bits():
    T12, v, transl, cam = _operands(3, 300, seed=2)
    g = torch.from_numpy(np.random.default_rng(3).normal(size=(3, 300, 3)).astype(np.float32))
    grads = []
    for fn in (vt.vertex_tail, old_chain):
        leaves = [x.clone().requires_grad_() for x in (T12, v, transl)]
        (fn(*leaves, cam) * g).sum().backward()
        grads.append([x.grad for x in leaves])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_wrapper_refuses_a_device_it_has_no_route_for():
    T12, v, transl, cam = (x.to("meta") for x in _operands(2, 7))
    with pytest.raises(ValueError, match="cpu or cuda"):
        vt.vertex_tail(T12, v, transl, cam)


@pytest.fixture(scope="module")
def body():
    return synthetic_smplx(num_verts=400, num_joints=55, seed=0), synthetic_vposer(seed=0)


def _decode_with_old_chain(monkeypatch):
    """Route lbs's tail through the old chain (its per-vertex apply, then
    transl and the camera as smplx_forward and the decode applied them)."""
    monkeypatch.setattr(lbs_module, "vertex_tail", old_chain)


@pytest.mark.parametrize("precision", ["high", "fast"])
@pytest.mark.parametrize("with_cam", [True, False])
def test_decode_verts_and_gradients_unchanged_on_the_cpu(body, precision, with_cam, monkeypatch):
    smplx, vposer = body
    rng = np.random.default_rng(4)
    B = 3
    x72 = torch.from_numpy((rng.normal(size=(B, 72)) * 0.3).astype(np.float32))
    cam = _cams(rng, B) if with_cam else None
    g = torch.from_numpy(rng.normal(size=(B, 400, 3)).astype(np.float32))
    gj = torch.from_numpy(rng.normal(size=(B, 55, 3)).astype(np.float32))

    def run():
        x = x72.clone().requires_grad_()
        verts, joints = body_vec_to_verts(smplx, vposer, x, cam, precision=precision)
        ((verts * g).sum() + (joints * gj).sum()).backward()
        return verts.detach(), joints.detach(), x.grad

    new = run()
    _decode_with_old_chain(monkeypatch)
    old = run()
    for a, b in zip(new, old):
        assert torch.equal(a, b)


# the benchmark's reader of K6's device time, on hand-built traces of two calls
class _Event:
    def __init__(self, name, start_us, end_us, device):
        self._n, self._s, self._d = name, start_us * 1000, (end_us - start_us) * 1000
        self._dev = torch.autograd.DeviceType.CUDA if device else torch.autograd.DeviceType.CPU

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return self._dev

    def is_user_annotation(self):
        return self._n.startswith(("bench.", "psi."))


VTAIL_KERNELS = [
    "(anonymous namespace)::vtail_fwd_kernel(float const*, float const*, float const*, float const*, float*, int)",
    "(anonymous namespace)::vtail_bwd_kernel(float const*, float const*, float const*, float const*, float*, float*, "
    "float*, int)",
    "(anonymous namespace)::vtail_reduce_kernel(float const*, float*, int, int)",
]
OTHER = [
    "void (anonymous namespace)::split_wgmma_kernel<1, 64, 1, true>((anonymous namespace)::Lhs, __nv_bfloat16 const*, "
    "(anonymous namespace)::Out, float*)",
    "(anonymous namespace)::reduce_tiles_kernel(float const*, float const*, float const*, float*, float*, float*, int)",
    "(anonymous namespace)::nn_argmin_kernel(float const*, float const*, long long*, int, int, int)",
    "void gemv2N_kernel<int, int, float, float, float, float, 128, 2, 4, 4, 1, false>()",
    "void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>, std::array<char*, 3ul> >",
]
# the patterns of the benchmark's readers that were there before K6
OTHER_PATTERNS = ("split_", "skin_", "splitk_gemm_kernel", "reduce_tiles_kernel", "nn_argmin")


def _trace(names, calls=2):
    ev = []
    for c in range(calls):
        o = c * 10_000
        ev.append(_Event("bench.genfit_call", o, o + 9_999, False))
        ev += [_Event(n, o + 100 * (i + 1), o + 100 * (i + 1) + 40, True) for i, n in enumerate(names)]
    prof = SimpleNamespace(profiler=SimpleNamespace(kineto_results=SimpleNamespace(events=lambda: ev)))
    return TraceView(prof, 0, calls * 10_000_000)


def _ctx(trace, traced_calls=2):
    return Context(trace, {"traced_calls": traced_calls}, None)


def test_vertex_tail_reader_counts_k6_alone_per_call():
    read = load_reader("device_ms.vertex_tail.genfit")
    assert read(_ctx(_trace(VTAIL_KERNELS + OTHER))) == pytest.approx(3 * 0.040)
    assert read(_ctx(_trace(OTHER))) == 0.0  # the production tier: K6 never runs
    assert read(_ctx(None)) is None
    assert read(_ctx(_trace(OTHER), traced_calls=0)) is None


def test_k6_names_match_no_other_reader():
    f32 = load_reader("device_ms.f32_products.genfit").__globals__["PATTERNS"]
    for name in VTAIL_KERNELS:
        assert not any(p in name for p in f32 + OTHER_PATTERNS), name
    assert not any("vtail_" in n for n in OTHER)
