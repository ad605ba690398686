"""Shared set-up of the benchmark's tests: the checkout and its ``src/``
on the import path, the port's torch on one intra-op thread, tiny sizes,
and the ``cuda`` fixture that decides about the card inside a test."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

# A cell at a size a CPU test can hold: its table's rows and N_s.
TINY = {"rows": 10_000, "n_samples": 2_000}


@pytest.fixture(autouse=True)
def _one_thread():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _run_tiny(workload: str, seed: int = 20240601, seconds: float = 0.5,
              trace: bool = False, root=ROOT, device=None):
    """One run of a cell through the harness, on the CPU unless a device
    is given, at ``TINY`` sizes."""
    import time

    import torch
    from aqpbench import harness
    dev = device or torch.device("cpu")
    res, _ = harness.run_cell(workload, seed, seconds, trace, dev,
                              time.perf_counter(), root=root, **TINY)
    return res


@pytest.fixture
def run_tiny():
    return _run_tiny
