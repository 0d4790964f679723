"""Faults planted in the program under the timed path, for the check of
``correct``: each has to make a run come out not correct. Used by the CPU
tests (``tests/test_bench_correct.py``) and by ``calibrate --faults`` on the
card at the cells' own sizes.

* unchanged_state: the optimizer returns its state as it got it;
* half_batch: half of the batch is left out and the mean taken over the rest;
* altered_answer: an answer is altered where it is produced.

Each traffic generator (``benchmark/generators/<name>.py``) plants them in
its own path through its ``plant(fault)``; ``plant`` here finds it by the
traffic's ``generator``.
"""

from __future__ import annotations

import contextlib
import importlib
from typing import Iterator

NAMES = ("unchanged_state", "half_batch", "altered_answer")


@contextlib.contextmanager
def patched(obj, name: str, value) -> Iterator[None]:
    """``obj.name`` set to ``value`` for the block, and back after it."""
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def plant(fault: str, generator: str):
    """A context manager that plants ``fault`` for a cell whose traffic
    generator is ``generator``: the generator module's own ``plant``.
    Raises for a fault not in ``NAMES`` and for a generator with no module
    or no ``plant``."""
    if fault not in NAMES:
        raise ValueError(f"unknown fault {fault!r}")
    module = f"benchmark.generators.{generator}"
    try:
        mod = importlib.import_module(module)
    except ModuleNotFoundError as e:
        if e.name != module:
            raise
        raise ValueError(f"unknown generator {generator!r}") from e
    if not hasattr(mod, "plant"):
        raise ValueError(f"generator {generator!r} plants no faults")
    return mod.plant(fault)
