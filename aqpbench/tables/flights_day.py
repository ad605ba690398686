"""The ``flights_day`` table: one day of the Flights stand-in, as a rolling
deployment receives it. The paper's Flights table is the US DOT 2015 flight
delays and cancellations (PairwiseHist, arXiv:2401.12018, Table 4).

The columns and their draws are those of ``tables/flights.py``, but for two
things that a single day fixes and the year-long table does not:

- ``month`` and ``day_of_week`` are the calendar's for the day, the same on
  every row: day 0 is Thursday 1 January 2015, and ``day_of_week`` runs from
  1 (Monday) to 7 (Sunday) as in the source;
- ``origin`` and ``dest`` range over 322 airports, the source's airport list,
  where ``tables/flights.py`` keeps 120.

A configuration names it by its file name (``"table"``).
"""
from __future__ import annotations

import datetime

import numpy as np

# The source's airport list (the airports of the 2015 release).
AIRPORTS = 322
FIRST_DAY = datetime.date(2015, 1, 1)


def make(n: int, seed: int, day: int = 0) -> dict:
    """``n`` flights of day ``day`` of 2015 (counted from 0, modulo 365)."""
    rng = np.random.default_rng(seed)
    airlines = np.array(["AA", "DL", "UA", "WN", "B6", "AS", "NK", "F9", "HA",
                         "VX", "OO", "EV", "MQ", "US"])
    airports = np.array([f"A{i:03d}" for i in range(AIRPORTS)])
    airline = airlines[rng.choice(len(airlines), n, p=_zipf_p(len(airlines), 1.3))]
    origin = airports[rng.choice(len(airports), n, p=_zipf_p(len(airports), 1.2))]
    dest = airports[rng.choice(len(airports), n, p=_zipf_p(len(airports), 1.2))]
    date = FIRST_DAY + datetime.timedelta(days=day % 365)
    month = np.full(n, float(date.month))
    dow = np.full(n, float(date.isoweekday()))
    dist = np.round(rng.gamma(2.2, 380.0, n) + 69)
    air_time = np.round(dist / 7.7 + rng.normal(18, 9, n), 1)
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


def _zipf_p(k: int, a: float) -> np.ndarray:
    p = 1.0 / np.arange(1, k + 1) ** a
    return p / p.sum()
