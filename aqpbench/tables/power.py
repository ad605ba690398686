"""The ``power`` table, made from a seed: a synthetic stand-in for the
paper's Power table (UCI "Individual household electric power consumption";
PairwiseHist, arXiv:2401.12018, Table 4) with its measures' shapes and
correlations. Frozen from ``repro_torch.aqp.datasets.power`` (commit
9bf584f). A configuration names it by its file name (``"table"``)."""
from __future__ import annotations

import numpy as np


def make(n: int, seed: int) -> dict:
    """Household electric power consumption (10 columns, quantized floats)."""
    rng = np.random.default_rng(seed)
    ts = np.arange(n, dtype=np.float64) * 60.0
    hour = (ts / 3600.0) % 24
    daily = 0.6 + 0.5 * np.exp(-((hour - 19) ** 2) / 8) + 0.2 * np.exp(-((hour - 7) ** 2) / 4)
    gap = np.round(np.abs(daily * rng.gamma(2.0, 0.6, n)), 3)
    grp = np.round(np.abs(rng.normal(0.12, 0.08, n)), 3)
    voltage = np.round(rng.normal(240.0, 3.2, n), 1)
    intensity = np.round(gap * 1000.0 / voltage / 0.95 + rng.normal(0, 0.2, n), 1)
    sub1 = np.round(np.clip(gap * rng.beta(2, 8, n) * 16, 0, None))
    sub2 = np.round(np.clip(gap * rng.beta(2, 6, n) * 13, 0, None))
    sub3 = np.round(np.clip(gap * rng.beta(4, 6, n) * 18, 0, None))
    day = np.floor(ts / 86400.0) % 31 + 1
    month = np.floor(ts / (86400.0 * 30)) % 12 + 1
    return {
        "ts": ts, "month": month, "day": day,
        "global_active_power": gap, "global_reactive_power": grp,
        "voltage": voltage, "global_intensity": intensity,
        "sub_metering_1": sub1, "sub_metering_2": sub2, "sub_metering_3": sub3,
    }
