"""The control, on the card: the reference computed one precision step below
what the configuration states, put in the program's place, fails the check
(at a small size a test run holds), while the program passes it.

    python3 -m pytest -m cuda benchmark/tests/test_bench_control.py
"""

import pytest
import torch

from benchmark.calibrate import readings
from benchmark.tests.helpers import cell_args, mixes

MIXES = mixes()


@pytest.mark.cuda
@pytest.mark.parametrize("mix", sorted(MIXES))
def test_control_fails_program_passes(mix):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    cfg, tr = cell_args(MIXES[mix], mix)
    r = readings({"name": mix, "chips": 1}, cfg, tr, 2**32 + 99, 1.0, torch.device("cuda", 0), True)
    lim = tr["limits"]
    assert all(r["program"][k] <= v for k, v in lim.items()), r["program"]
    assert any(r["control"][k] > v for k, v in lim.items()), r["control"]
