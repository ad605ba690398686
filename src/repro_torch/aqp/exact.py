"""Exact query engine over raw in-memory tables — the ground truth.

SQL-standard NULL semantics: comparisons with NULL are false; aggregates
ignore NULL; COUNT(col) counts non-null, COUNT(*) counts rows.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import sql as sqlmod


class ExactEngine:
    def __init__(self, table: dict):
        self.table = {k: np.asarray(v) for k, v in table.items()}
        self.n = len(next(iter(self.table.values())))

    def _mask(self, node) -> np.ndarray:
        if node is None:
            return np.ones(self.n, bool)
        if isinstance(node, sqlmod.RawCond):
            col = self.table[node.col]
            if col.dtype.kind in ("U", "S", "O"):
                sval = str(node.value)
                eq = col.astype(str) == sval
                if node.op == "=":
                    return eq
                if node.op in ("!=", "<>"):
                    return ~eq
                raise ValueError(f"range op on categorical column {node.col}")
            x = col.astype(np.float64)
            v = float(node.value)
            with np.errstate(invalid="ignore"):
                out = {
                    "=": x == v, "!=": x != v, "<>": x != v,
                    "<": x < v, "<=": x <= v, ">": x > v, ">=": x >= v,
                }[node.op]
            return out & np.isfinite(x)  # NULL comparisons are false
        masks = [self._mask(ch) for ch in node.children]
        out = masks[0]
        for m in masks[1:]:
            out = (out & m) if node.kind == "and" else (out | m)
        return out

    def query(self, sql_text: str):
        q = sqlmod.parse_sql(sql_text)
        mask = self._mask(q.where)
        if q.group_by is not None:
            gcol = self.table[q.group_by].astype(str)
            out = {}
            for val in np.unique(gcol[mask]):
                sub = mask & (gcol == val)
                r = self._agg(q.func, q.agg_col, sub)
                if r is not None and (q.func != "COUNT" or r > 0):
                    out[val] = r
            return out
        return self._agg(q.func, q.agg_col, mask)

    def _agg(self, func: str, col: str, mask: np.ndarray):
        if func == "COUNT":
            if col == "*":
                return float(mask.sum())
            x = self.table[col]
            if x.dtype.kind in ("U", "S", "O"):
                return float(mask.sum())
            return float((mask & np.isfinite(x.astype(np.float64))).sum())
        x = self.table[col].astype(np.float64)
        v = x[mask & np.isfinite(x)]
        if v.size == 0:
            return None
        return float({
            "SUM": v.sum(), "AVG": v.mean(), "MIN": v.min(), "MAX": v.max(),
            "MEDIAN": np.median(v), "VAR": v.var(),
        }[func])

    def selectivity(self, sql_text: str) -> float:
        q = sqlmod.parse_sql(sql_text)
        return float(self._mask(q.where).sum()) / self.n
