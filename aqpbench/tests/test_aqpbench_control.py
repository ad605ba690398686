"""The precision control: the reference in the program's place, one
precision below the configuration's, is not correct by the cell's limit.
At a tiny size on the CPU here; ``aqpbench/control.py`` reads it on the
card at the cell's own size."""
import pytest

from aqpbench import spec

CELLS = ["flights.build", "power.build"]


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_the_limit(workload):
    import torch
    from aqpbench import control
    limit = spec.cell(workload)["config"]["limits"]["synopsis_gap"]
    got = control.reading(workload, 77, torch.device("cpu"), rows=20_000,
                          n_samples=4_000)
    assert got > limit
