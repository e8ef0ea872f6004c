"""The check's control, the reference summed in float16 in the program's
place, comes out not correct: at a small size on the CPU, and at each
cell's own size on the card."""

import pytest

from benchmark import control
from benchmark.harness import spec
from benchmark.tests.conftest import SMALL

CELLS = [w["name"] for w in spec.load()["workloads"]]


@pytest.mark.parametrize("seed", [11, 2 ** 31 + 5, 3 ** 25])
@pytest.mark.parametrize("workload", CELLS)
def test_the_control_fails_at_a_small_size(workload, seed):
    checks = control.control_checks(workload, seed, "float16", "cpu",
                                    config_override=SMALL)
    assert checks["outputs_compared"]["value"] >= 1
    assert checks["mismatched_bytes"]["value"] > 0


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_the_control_fails_at_the_cells_size(workload, cuda_device):
    for seed in (21, 2 ** 31 + 6, 3 ** 26):
        checks = control.control_checks(workload, seed, "float16",
                                        str(cuda_device))
        assert checks["mismatched_bytes"]["value"] > 0
