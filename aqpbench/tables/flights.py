"""The ``flights`` table, made from a seed: a synthetic stand-in for the
paper's Flights table (US DOT 2015 flight delays and cancellations;
PairwiseHist, arXiv:2401.12018, Table 4), mixed categorical and numeric
columns with NULLs. Frozen from ``repro_torch.aqp.datasets.flights`` and
``_zipf_p`` (commit 9bf584f). A configuration names it by its file name
(``"table"``)."""
from __future__ import annotations

import numpy as np


def make(n: int, seed: int) -> dict:
    """Flight delays & cancellations (mixed categorical/numeric, nulls)."""
    rng = np.random.default_rng(seed)
    airlines = np.array(["AA", "DL", "UA", "WN", "B6", "AS", "NK", "F9", "HA",
                         "VX", "OO", "EV", "MQ", "US"])
    airports = np.array([f"A{i:03d}" for i in range(120)])
    airline = airlines[rng.choice(len(airlines), n, p=_zipf_p(len(airlines), 1.3, rng))]
    origin = airports[rng.choice(len(airports), n, p=_zipf_p(len(airports), 1.2, rng))]
    dest = airports[rng.choice(len(airports), n, p=_zipf_p(len(airports), 1.2, rng))]
    month = rng.integers(1, 13, n).astype(float)
    dow = rng.integers(1, 8, n).astype(float)
    dist = np.round(rng.gamma(2.2, 380.0, n) + 69)
    air_time = np.round(dist / 7.7 + rng.normal(18, 9, n), 1)  # correlated pair (Fig. 7)
    dep_delay = np.round(rng.exponential(12.0, n) - 4.0)
    arr_delay = np.round(dep_delay + rng.normal(-2, 12, n))
    sched = np.round(rng.uniform(300, 1439, n))
    taxi_out = np.round(np.abs(rng.normal(16, 7, n)))
    cancelled = (rng.random(n) < 0.015).astype(float)
    # Cancelled flights have no airborne stats (missing values).
    for col in (air_time, arr_delay):
        col[cancelled == 1] = np.nan
    dep_delay[rng.random(n) < 0.01] = np.nan
    return {
        "airline": airline, "origin": origin, "dest": dest,
        "month": month, "day_of_week": dow, "sched_dep": sched,
        "dep_delay": dep_delay, "taxi_out": taxi_out, "distance": dist,
        "air_time": air_time, "arr_delay": arr_delay, "cancelled": cancelled,
    }


def _zipf_p(k: int, a: float, rng) -> np.ndarray:
    p = 1.0 / np.arange(1, k + 1) ** a
    return p / p.sum()
