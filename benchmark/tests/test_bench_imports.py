"""No module of the benchmark imports JAX or the JAX package (compared by
whole top-level names: the port's name begins with the JAX package's), and
the plain reference imports nothing of the program."""

import ast

import pytest

from benchmark.run import BENCH_DIR

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "psi_tpu"}


def imported(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(BENCH_DIR.rglob("*.py")), ids=lambda p: str(p.relative_to(BENCH_DIR)))
def test_no_jax(path):
    assert not set(imported(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH_DIR / "reference").rglob("*.py")), ids=lambda p: p.name)
def test_reference_stands_alone(path):
    """The reference imports torch, numpy, the standard library and itself."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        names = [a.name for a in node.names] if isinstance(node, ast.Import) else (
            [node.module] if isinstance(node, ast.ImportFrom) and node.module else [])
        for n in names:
            top = n.split(".")[0]
            assert top in {"torch", "numpy", "math", "typing", "dataclasses", "contextlib", "__future__"} or (
                n.startswith("benchmark.reference")), n
