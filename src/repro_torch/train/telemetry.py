"""Training-telemetry AQP: the paper's technique applied to the LM framework.

A 1000-node training fleet emits billions of telemetry rows (per-step loss,
grad-norm, step-time, per-host straggler timings). PairwiseHist gives sub-ms
approximate queries over that stream without a database — the paper's
Edge-analytics story applied to cluster health:

    tel = TelemetryStore()
    tel.record(step=i, loss=..., grad_norm=..., step_time=..., host=h)
    tel.build()                    # compressed store + synopsis
    tel.query("SELECT AVG(step_time) FROM t WHERE step > 1000")
    tel.query("SELECT MAX(step_time) FROM t WHERE host = 'host7'")  # stragglers

The port of ``src/repro/train/telemetry.py``: the synopsis is built by the
port's ``AQPFramework`` on ``device`` (``None``: CUDA, where the build's
2-D refinement launches the pair kernels K3/K4); queries run on the host
engine, with no fast path, as in the reference.
"""
from __future__ import annotations

import numpy as np

from repro_torch.device import resolve_device


class TelemetryStore:
    def __init__(self, params=None, device=None):
        self._rows = []
        self._params = params
        self._device = resolve_device(device)
        self._framework = None

    def record(self, **fields):
        self._rows.append(fields)
        self._framework = None  # synopsis is stale

    def extend(self, rows: list):
        self._rows.extend(rows)
        self._framework = None

    def _table(self) -> dict:
        keys = sorted({k for row in self._rows for k in row})
        out = {}
        for k in keys:
            vals = [row.get(k) for row in self._rows]
            if all(isinstance(v, (int, float)) or v is None for v in vals):
                out[k] = np.array([np.nan if v is None else float(v)
                                   for v in vals])
            else:
                out[k] = np.array([str(v) for v in vals])
        return out

    def build(self):
        from repro_torch.aqp.engine import AQPFramework
        from repro_torch.core.types import BuildParams
        if not self._rows:
            raise ValueError("no telemetry recorded")
        params = self._params or BuildParams(
            n_samples=min(len(self._rows), 100_000))
        self._framework = AQPFramework(params, device=self._device).ingest(
            self._table())
        return self

    def query(self, sql: str):
        if self._framework is None:
            self.build()
        return self._framework.query(sql)

    def straggler_report(self, factor: float = 1.5) -> dict:
        """Hosts whose AVG(step_time) exceeds ``factor`` x the global median
        step time — the hot-spare trigger heuristic used by the train loop.
        All statistics come from the synopsis (sub-ms, no table scan)."""
        table = self._table()
        if "step_time" not in table or "host" not in table:
            return {}
        med = self.query("SELECT MEDIAN(step_time) FROM t")
        if med.estimate is None:
            return {}
        thresh = factor * med.estimate
        out = {}
        for host in np.unique(table["host"]):
            res = self.query(
                f"SELECT AVG(step_time) FROM t WHERE host = '{host}'")
            if res.estimate is not None and res.estimate > thresh:
                out[str(host)] = (res.estimate, thresh)
        return out
