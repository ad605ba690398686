"""Synthetic dataset suite modeled on the paper's 11 evaluation datasets
(Table 4) — offline stand-ins with matching schema *shape* and statistics:
mixed numeric/categorical, quantized sensor readings, strong pair
correlations, heavy skew, and missing values from asynchronous sources.

Also provides an IDEBench-style ``scale_up`` (§6: normalisation + Gaussian
perturbation resampling).
"""
from __future__ import annotations

import numpy as np

REGISTRY = {}


def dataset(name):
    def deco(fn):
        REGISTRY[name] = fn
        return fn
    return deco


@dataset("power")
def power(n: int = 500_000, seed: int = 0) -> dict:
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


@dataset("flights")
def flights(n: int = 500_000, seed: int = 1) -> dict:
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


@dataset("iot_temp")
def iot_temp(n: int = 400_000, seed: int = 2) -> dict:
    """Temperature IoT on GCP-style: 5 columns, single source."""
    rng = np.random.default_rng(seed)
    ts = np.arange(n, dtype=np.float64) * 30.0
    device = np.array([f"dev{i}" for i in range(8)])[rng.integers(0, 8, n)]
    base = 21.0 + 4.0 * np.sin(ts / 86400.0 * 2 * np.pi)
    temp = np.round(base + rng.normal(0, 0.6, n), 1)
    humidity = np.round(np.clip(55 - (temp - 21) * 2.5 + rng.normal(0, 3, n), 5, 95), 1)
    battery = np.round(np.clip(100 - ts / ts.max() * 60 + rng.normal(0, 2, n), 0, 100))
    return {"ts": ts, "device": device, "temp": temp,
            "humidity": humidity, "battery": battery}


@dataset("aqua")
def aqua(n: int = 300_000, seed: int = 3) -> dict:
    """Aquaponics ponds: multi-source columns sharing a timestamp ->
    asynchronous sampling -> many nulls (like Aqua/Build in the paper)."""
    rng = np.random.default_rng(seed)
    ts = np.sort(rng.uniform(0, 90 * 86400, n)).round()
    pond = np.array([f"pond{i}" for i in range(6)])[rng.integers(0, 6, n)]
    cols = {"ts": ts, "pond": pond}
    for k, (mean, sd, decimals, p_present) in enumerate([
            (7.1, 0.4, 2, 0.55), (26.0, 2.0, 1, 0.6), (5.2, 1.1, 2, 0.5),
            (180.0, 40.0, 0, 0.45), (0.45, 0.2, 2, 0.5), (3.1, 0.9, 1, 0.55),
            (12.0, 3.0, 1, 0.4), (650.0, 120.0, 0, 0.45), (1.8, 0.6, 2, 0.5),
            (95.0, 20.0, 0, 0.4), (0.08, 0.04, 3, 0.45)]):
        vals = np.round(np.abs(rng.normal(mean, sd, n)), decimals)
        vals[rng.random(n) > p_present] = np.nan  # asynchronous source
        cols[f"sensor_{k}"] = vals
    return cols


@dataset("taxi")
def taxi(n: int = 400_000, seed: int = 4) -> dict:
    """Chicago taxi trips: strongly correlated fare/miles/seconds + skew."""
    rng = np.random.default_rng(seed)
    miles = np.round(rng.gamma(1.4, 2.6, n), 1)
    seconds = np.round(miles * 160 + np.abs(rng.normal(250, 150, n)))
    fare = np.round(3.25 + miles * 2.25 + seconds * 0.005 + rng.normal(0, 1, n), 2)
    fare = np.clip(fare, 3.25, None)
    tips = np.round(np.where(rng.random(n) < 0.55, fare * rng.beta(2, 8, n), 0), 2)
    payment = np.array(["card", "cash", "mobile", "other"])[
        rng.choice(4, n, p=[0.55, 0.35, 0.08, 0.02])]
    company = np.array([f"co{i}" for i in range(16)])[
        rng.choice(16, n, p=_zipf_p(16, 1.5, rng))]
    pickup = rng.integers(1, 78, n).astype(float)
    dropoff = rng.integers(1, 78, n).astype(float)
    tolls = np.round(np.where(rng.random(n) < 0.03, rng.uniform(1, 8, n), 0), 2)
    tips[rng.random(n) < 0.02] = np.nan
    return {"trip_miles": miles, "trip_seconds": seconds, "fare": fare,
            "tips": tips, "tolls": tolls, "payment_type": payment,
            "company": company, "pickup_area": pickup, "dropoff_area": dropoff}


@dataset("gas")
def gas(n: int = 300_000, seed: int = 5) -> dict:
    """Home gas-sensor array: drifting baselines + correlated channels."""
    rng = np.random.default_rng(seed)
    ts = np.arange(n, dtype=np.float64)
    drift = np.cumsum(rng.normal(0, 0.01, n))
    cols = {"ts": ts}
    base = 12.0 + drift
    for k in range(8):
        gain = 1.0 + 0.15 * k
        cols[f"r{k}"] = np.round(base * gain + rng.normal(0, 0.4, n), 2)
    cols["temp"] = np.round(24 + 3 * np.sin(ts / 5000) + rng.normal(0, 0.3, n), 1)
    cols["humidity"] = np.round(48 - 2 * np.sin(ts / 5000) + rng.normal(0, 1, n), 1)
    cols["co_ppm"] = np.round(np.abs(rng.gamma(1.2, 2.0, n)), 1)
    return cols


def _zipf_p(k: int, a: float, rng) -> np.ndarray:
    p = 1.0 / np.arange(1, k + 1) ** a
    return p / p.sum()


def load(name: str, n: int | None = None, seed: int | None = None) -> dict:
    fn = REGISTRY[name]
    kwargs = {}
    if n is not None:
        kwargs["n"] = n
    if seed is not None:
        kwargs["seed"] = seed
    return fn(**kwargs)


def scale_up(table: dict, factor: int, seed: int = 0,
             noise_frac: float = 0.02) -> dict:
    """IDEBench-style scale-up: bootstrap resample + Gaussian perturbation of
    numeric columns (categoricals resampled as-is)."""
    rng = np.random.default_rng(seed)
    n = len(next(iter(table.values())))
    m = n * factor
    idx = rng.integers(0, n, m)
    out = {}
    for name, col in table.items():
        arr = np.asarray(col)[idx]
        if arr.dtype.kind == "f":
            finite = np.isfinite(arr)
            sd = np.nanstd(np.asarray(col, np.float64))
            decimals = _infer_decimals(np.asarray(col, np.float64))
            noise = rng.normal(0, max(sd, 1e-9) * noise_frac, m)
            arr = np.where(finite, np.round(arr + noise, decimals), arr)
        out[name] = arr
    return out


def _infer_decimals(col: np.ndarray, max_decimals: int = 6) -> int:
    finite = col[np.isfinite(col)][:10000]
    for p in range(max_decimals + 1):
        if np.all(np.abs(finite * 10**p - np.round(finite * 10**p)) < 1e-6):
            return p
    return max_decimals
