"""The rows a rolling deployment holds after a cycle of the
``append_rebuild`` traffic, worked out again from the seed and the
configuration alone: nothing the loop rendered or the program holds is read.

The stream: day ``i`` is pool day ``i mod pool_days``, and pool day ``j`` is
the configuration's table made at ``day_rows`` rows from seed stream
``(5, j)`` of ``--seed``, for calendar day ``j`` (``make(rows, seed, day)``).
A full-size window ends well inside the pool, so its calendar runs on.
Set-up ingests days ``0 .. retained_days - 1``; cycle ``k`` drops the
oldest day and appends day ``retained_days + k - 1``, so afterwards days
``k .. k + retained_days - 1`` are held, oldest first.
"""
from __future__ import annotations

import numpy as np

from aqpbench import common, spec

# The seed stream of the pool's days.
DAY_STREAM = 5


def day_rows(config: dict, rows: int | None = None) -> int:
    """Rows a day: the configuration's, or scaled by ``rows`` over the
    retained rows where a test shrinks the cell."""
    if not rows:
        return config["day_rows"]
    return max(1, round(config["day_rows"] * rows / config["rows"]))


def retained(config: dict, mix: dict, seed: int, cycle: int,
             rows: int | None = None, root=spec.ROOT) -> dict:
    """The raw table held after cycle ``cycle`` (0: set-up's ingest)."""
    n = day_rows(config, rows)
    make = spec.table(config["table"], root)
    seeds = common.Seeds(seed)
    days = [make(n, seeds(DAY_STREAM, j), j)
            for j in (i % mix["pool_days"]
                      for i in range(cycle, cycle + config["retained_days"]))]
    return {k: np.concatenate([d[k] for d in days]) for k in days[0]}
