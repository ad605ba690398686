"""The port's comparison baselines against the reference's.

``SamplingAQP`` and ``HistProductAQP`` are host NumPy in both packages: on
the same table, queries and seed they must return the reference's
``(est, lo, hi)`` for every query and the same ``size_bytes()``.
"""
import numpy as np
import pytest

from repro_torch.aqp import baselines
from repro_torch.aqp.datasets import load
from repro_torch.aqp.queries import AGGS_FULL, generate_queries


@pytest.fixture(scope="module", params=["power", "flights"])
def table_and_queries(request):
    table = load(request.param, n=6000)
    queries = generate_queries(table, 40, seed=17, aggs=AGGS_FULL,
                               max_preds=3, min_selectivity=1e-3)
    return table, queries


@pytest.mark.parametrize("name", ["SamplingAQP", "HistProductAQP"])
def test_baseline_matches_reference(table_and_queries, name):
    from repro.aqp import baselines as ref_baselines
    table, queries = table_and_queries
    port = getattr(baselines, name)(table, n_sample=2000, seed=3)
    ref = getattr(ref_baselines, name)(table, n_sample=2000, seed=3)
    assert port.size_bytes() == ref.size_bytes() > 0
    answered = 0
    for sql in queries:
        got, want = port.query(sql), ref.query(sql)
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            if w is None:
                assert g is None, sql
            else:
                np.testing.assert_array_equal(g, w, err_msg=sql)
        answered += got[0] is not None
    assert answered > len(queries) // 2
