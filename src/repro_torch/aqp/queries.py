"""Random query generation following the paper's evaluation protocol (§6):

  * aggregation in {COUNT, SUM, AVG, MIN, MAX, MEDIAN, VAR} on numeric cols;
  * 1–5 predicate conditions, AND/OR mixes, ops {<, <=, >, >=, =, !=};
  * equality predicates preferentially on categorical/low-cardinality cols;
  * minimum-selectivity rejection (10^-5 initial experiments, 10^-6 scaled).
"""
from __future__ import annotations

import numpy as np

from repro_torch.aqp.exact import ExactEngine

AGGS_INITIAL = ("COUNT", "SUM", "AVG")
AGGS_FULL = ("COUNT", "SUM", "AVG", "MIN", "MAX", "MEDIAN", "VAR")


def _literal(rng, col):
    arr = np.asarray(col)
    if arr.dtype.kind in ("U", "S", "O"):
        vals = np.unique(arr.astype(str))
        return f"'{rng.choice(vals)}'", True
    x = arr.astype(np.float64)
    x = x[np.isfinite(x)]
    q = rng.uniform(0.02, 0.98)
    v = float(np.quantile(x, q))
    if np.allclose(x, np.round(x)):
        return str(int(round(v))), False
    return f"{v:.4f}", False


def generate_queries(table: dict, n_queries: int, seed: int = 0,
                     aggs=AGGS_FULL, max_preds: int = 5,
                     min_selectivity: float = 1e-5,
                     max_tries_factor: int = 30,
                     table_name: str = "t") -> list[str]:
    rng = np.random.default_rng(seed)
    exact = ExactEngine(table)
    names = list(table.keys())
    numeric = [c for c in names
               if np.asarray(table[c]).dtype.kind not in ("U", "S", "O")]
    out = []
    tries = 0
    while len(out) < n_queries and tries < n_queries * max_tries_factor:
        tries += 1
        func = rng.choice(aggs)
        agg_col = rng.choice(numeric)
        n_preds = int(rng.integers(1, max_preds + 1))
        conds = []
        for _ in range(n_preds):
            col = rng.choice(names)
            lit, is_cat = _literal(rng, table[col])
            if is_cat:
                op = rng.choice(["=", "!="], p=[0.8, 0.2])
            else:
                op = rng.choice(["<", "<=", ">", ">=", "=", "!="],
                                p=[0.24, 0.24, 0.24, 0.24, 0.02, 0.02])
            conds.append(f"{col} {op} {lit}")
        glue = [" AND " if rng.random() < 0.75 else " OR "
                for _ in range(len(conds) - 1)]
        where = conds[0]
        for g, c in zip(glue, conds[1:]):
            where += g + c
        sql = f"SELECT {func}({agg_col}) FROM {table_name} WHERE {where}"
        try:
            if exact.selectivity(sql) < min_selectivity:
                continue
            if exact.query(sql) is None:
                continue
        except (ValueError, KeyError):
            continue
        out.append(sql)
    return out


def relative_error(est, exact) -> float:
    """The paper's relative error metric (%); sMAPE-style guard at 0."""
    if est is None or exact is None:
        return 100.0
    if exact == 0:
        return 0.0 if abs(est) < 1e-9 else 100.0
    return abs(est - exact) / abs(exact) * 100.0
