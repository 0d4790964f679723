"""The probes P1-P4 of scripts/profile_vmem_gather.py: the port's plain
twins vs the Pallas kernels in interpret mode, on the CPU.

The script is loaded with importlib and its kernel bodies are called
through pl.pallas_call exactly as the script builds each call, with
interpret=True. P4's call fails as the script writes it (a self-calling
jit, and an [R, L] value stored into a [1, R, L] block), so its body is
re-created here with squeezed block dims, (None, A, L) -> (None, R, L),
and the failure itself is a test. Gathers copy values,
and P3/P4 add in the same order on both sides: tolerance 0.
"""

import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from psi_tpu_torch.ops import gather_probes as gp

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def probes():
    spec = importlib.util.spec_from_file_location("profile_vmem_gather", ROOT / "scripts" / "profile_vmem_gather.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _support_call(kern, rows, lanes):
    """check_support's pallas_call, in interpret mode."""
    return pl.pallas_call(
        kern,
        out_shape=jax.ShapeDtypeStruct((rows, lanes), jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 2,
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        interpret=True,
    )


@pytest.mark.parametrize("rows", [8, 100, 128])
@pytest.mark.parametrize("axis", [0, 1])
def test_support_twins_match_pallas(probes, rows, axis):
    """P1 (axis 0) and P2 (axis 1) at the script's L = 128."""
    L = probes.L
    rng = np.random.default_rng(rows)
    t = rng.standard_normal((rows, L)).astype(np.float32)
    idx = rng.integers(0, rows if axis == 0 else L, (rows, L)).astype(np.int32)
    kern = probes._row_gather_kernel if axis == 0 else probes._lane_gather_kernel
    want = np.asarray(_support_call(kern, rows, L)(jnp.asarray(t), jnp.asarray(idx)))
    fn = gp.row_gather if axis == 0 else gp.lane_gather
    got = fn(torch.from_numpy(t), torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("grid_n, rows, n_gathers, lo, hi", [
    (1, 8, 8, 0, 128), (3, 16, 8, 0, 128), (4, 5, 3, 0, 128),
    (2, 8, 8, -300, 300),  # indices outside [0, L): both sides take them mod L, floored
])
def test_chained_twin_matches_pallas(probes, grid_n, rows, n_gathers, lo, hi):
    """P3: measure_throughput's call at small sizes."""
    L = probes.L
    rng = np.random.default_rng(grid_n * 100 + rows)
    t = rng.standard_normal((grid_n, rows, L)).astype(np.float32)
    li = rng.integers(lo, hi, (grid_n, rows, L)).astype(np.int32)
    spec = pl.BlockSpec((1, rows, L), lambda n: (n, 0, 0), memory_space=pltpu.VMEM)
    call = pl.pallas_call(
        functools.partial(probes._chained_kernel, n_gathers),
        grid=(grid_n,),
        out_shape=jax.ShapeDtypeStruct((grid_n, rows, L), jnp.float32),
        in_specs=[spec] * 2,
        out_specs=spec,
        interpret=True,
    )
    want = np.asarray(call(jnp.asarray(t), jnp.asarray(li)))
    got = gp.chained_gather(torch.from_numpy(t), torch.from_numpy(li), n_gathers).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("grid_n, a, n_arrays", [(1, 1, 7), (4, 2, 7), (2, 1, 3)])
def test_relayout_twin_matches_pallas(probes, grid_n, a, n_arrays):
    """P4: measure_relayout.kern's body with squeezed blocks, c [G, a, L]
    -> [G, a*L, L]."""
    L = probes.L
    R = a * L

    def kern(c_ref, o_ref):  # measure_relayout.kern with R = a * L
        acc = jnp.zeros((R, L), jnp.float32)
        for k in range(n_arrays):
            x = (c_ref[...] + k).reshape(R, 1)
            acc = acc + jnp.broadcast_to(x, (R, L))
        o_ref[...] = acc

    c = np.random.default_rng(grid_n + a).standard_normal((grid_n, a, L)).astype(np.float32)
    call = pl.pallas_call(
        kern,
        grid=(grid_n,),
        out_shape=jax.ShapeDtypeStruct((grid_n, R, L), jnp.float32),
        in_specs=[pl.BlockSpec((None, a, L), lambda n: (n, 0, 0), memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((None, R, L), lambda n: (n, 0, 0), memory_space=pltpu.VMEM),
        interpret=True,
    )
    want = np.asarray(call(jnp.asarray(c)))
    got = gp.relayout(torch.from_numpy(c), n_arrays, L).numpy()
    np.testing.assert_array_equal(got, want)


def test_relayout_as_written_fails_in_interpret_mode(probes, monkeypatch, capsys):
    """The script's own measure_relayout, its pallas_call in interpret mode,
    fails twice over, and the port computes what the body means instead:
    * `f = jax.jit(lambda a: f(a))` (scripts/profile_vmem_gather.py:145)
      calls itself, and the script's try reports a RecursionError;
    * the kernel, called directly, stores an [R, L] value into its
      [1, R, L] block (:135) and raises."""
    calls = []

    def pallas_call(kern, **kw):
        calls.append(pl.pallas_call(kern, interpret=True, **kw))
        return calls[-1]

    monkeypatch.setattr(probes, "pl", type("pl", (), {"pallas_call": staticmethod(pallas_call),
                                                      "BlockSpec": pl.BlockSpec}))
    probes.measure_relayout(grid_n=1)
    out = capsys.readouterr().out
    assert "[relayout] FAILED - RecursionError" in out, out
    with pytest.raises(ValueError, match="shape"):
        calls[0](jnp.zeros((1, 18, probes.L), jnp.float32))


def test_wrappers_refuse_mismatched_operands():
    t = torch.zeros((8, 128))
    with pytest.raises(ValueError):
        gp.row_gather(t, torch.zeros((8, 64), dtype=torch.int32))
    with pytest.raises(ValueError):
        gp.chained_gather(t, torch.zeros((8, 128), dtype=torch.int32))  # not [G, rows, L]
    with pytest.raises(ValueError):
        gp.relayout(torch.zeros((2, 1, 128)), lanes=6)
