"""Entry point of the benchmark: ``python3 aqpbench/run.py --workload
<name> --seed <n> --seconds <s> --trace <0|1>``, from the root of a
checkout. It puts the checkout and its ``src/`` (the ``repro_torch``
package under test) on the import path itself."""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# One process with few threads: the host math (NumPy's BLAS, torch's CPU
# ops) on one thread each, so no pool spins against the serving threads.
for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[_var] = "1"

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from aqpbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))
