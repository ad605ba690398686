"""A short run of each cell on the card, through the harness as the
benchmark runs it; skips without a card (the fixture decides)."""
import pytest

CELLS = ["flights.build", "power.build"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_cuda_short_run(cuda, run_tiny, workload, trace):
    res = run_tiny(workload, seconds=1.0, trace=trace, device=cuda)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["metrics"]
