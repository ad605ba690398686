"""Port copy of tests/test_templates.py on ``repro_torch.serve.aqp``, on the
CPU (``device="cpu"``).

Zero-parse plan templates: fingerprint -> PlanTemplate bind fidelity.

The contract under test is *bit-for-bit equality*: a template-hit plan must
be indistinguishable — ``canonical_key`` and executed results — from the
plan the cold ``parse_sql`` -> ``plan_query`` path produces for the same
text, across every template shape the engine supports (consolidation, OR
trees, GROUP BY expansion, categorical literals, COUNT(*)). On top of
that, the serving integration: the template-hit path performs ZERO
``parse_sql`` calls (counter-based), deferred wave binds group by template,
epoch bumps invalidate compiled templates, and the planner pool offload
returns identical answers.
"""
import threading

import numpy as np
import pytest

from repro_torch.aqp.engine import AQPFramework
from repro_torch.core import sql as sqlmod
from repro_torch.core.query import PlanError
from repro_torch.core.types import BuildParams
from repro_torch.serve.aqp import AQPServer

TIMEOUT = 30


def _make_table(n=8_000, seed=11):
    rng = np.random.default_rng(seed)
    return {
        "a": rng.integers(0, 500, n).astype(float),
        "b": np.abs(rng.normal(100, 30, n)).round(),
        "c": rng.integers(0, 50, n).astype(float),
        "cat": np.array(["r", "g", "b", "c", "m", "y"])[
            rng.integers(0, 6, n)],
    }


@pytest.fixture(scope="module")
def framework():
    return AQPFramework(BuildParams(n_samples=4_000, seed=2),
                        use_compression=False,
                        device="cpu").ingest(_make_table())


def _server(framework, **kwargs):
    kwargs.setdefault("mode", "numpy")
    return AQPServer(**kwargs, device="cpu").register("t", framework)


# Shape corpus: (template, literal dicts). Covers plain AND, same-column
# consolidation, OR/nested trees, COUNT(*), MIN/MAX snapping, categorical
# string literals (seen and unseen), and GROUP BY expansion.
CORPUS = [
    ("SELECT COUNT(*) FROM t WHERE a > {p} AND b < {q}",
     [dict(p=100, q=130), dict(p=250.5, q=90), dict(p=-5, q=1.1e2)]),
    ("SELECT SUM(b) FROM t WHERE a >= {p} AND a <= {q}",
     [dict(p=50, q=400), dict(p=0, q=499)]),
    ("SELECT AVG(b) FROM t WHERE a < {p} OR c > {q}",
     [dict(p=100, q=40), dict(p=350, q=10)]),
    ("SELECT MIN(b) FROM t WHERE b > {p} AND b < {q} AND c > {r}",
     [dict(p=60, q=160, r=5), dict(p=90, q=140, r=20)]),
    ("SELECT MAX(b) FROM t WHERE (a < {p} OR c > {q}) AND b > {r}",
     [dict(p=100, q=40, r=70), dict(p=400, q=45, r=100)]),
    ("SELECT COUNT(*) FROM t WHERE cat = '{p}' AND a > {q}",
     [dict(p="r", q=100), dict(p="g", q=250), dict(p="zz", q=10)]),
    ("SELECT COUNT(b) FROM t WHERE a < {p} GROUP BY cat",
     [dict(p=300), dict(p=120)]),
    ("SELECT COUNT(*) FROM t GROUP BY cat WHERE b > {p}",
     [dict(p=90), dict(p=140)]),
    ("SELECT VAR(b) FROM t",
     [dict()]),
]


def _instances(shape, variants):
    return [shape.format(**v) for v in variants]


# ------------------------------------------------------ engine-level fidelity


def test_template_bind_bit_for_bit(framework):
    eng = framework.engine
    for shape, variants in CORPUS:
        texts = _instances(shape, variants)
        tmpl = eng.plan_template(sqlmod.parse_sql(texts[0]))
        fps = [sqlmod.fingerprint_sql(t) for t in texts]
        assert len({fp.shape for fp in fps}) == 1
        batch = tmpl.bind_batch([fp.literals for fp in fps])
        for text, fp, bplan in zip(texts, fps, batch):
            cold = eng.plan_sql(text)
            for hot in (tmpl.bind(fp.literals), bplan):
                assert hot.canonical_key() == cold.canonical_key(), text
                assert ([lf.canonical_key() for lf in hot.leaf_plans]
                        == [lf.canonical_key() for lf in cold.leaf_plans])
                rc, rh = eng.execute_plan(cold), eng.execute_plan(hot)
                assert rc.as_tuple() == rh.as_tuple(), text
                assert rc.groups == rh.groups, text


def test_template_slot_count_guard(framework):
    eng = framework.engine
    tmpl = eng.plan_template(
        sqlmod.parse_sql("SELECT COUNT(*) FROM t WHERE a > 1 AND b < 2"))
    assert tmpl.n_slots == 2
    with pytest.raises(PlanError):
        tmpl.bind((1.0,))
    with pytest.raises(PlanError):
        tmpl.bind_batch([(1.0, 2.0), (3.0,)])


def test_template_bad_literal_matches_cold_error(framework):
    # A quoted non-numeric literal on a numeric column fails identically on
    # the template path and the cold path (same encode, same exception).
    eng = framework.engine
    good = "SELECT COUNT(*) FROM t WHERE a = 5"
    bad = "SELECT COUNT(*) FROM t WHERE a = 'oops'"
    tmpl = eng.plan_template(sqlmod.parse_sql(good))
    fp = sqlmod.fingerprint_sql(bad)
    assert fp.shape == sqlmod.fingerprint_sql(good).shape
    with pytest.raises(ValueError):
        eng.plan_sql(bad)
    with pytest.raises(ValueError):
        tmpl.bind(fp.literals)
    # Batch fallback still binds the good rows.
    good_fp = sqlmod.fingerprint_sql(good)
    with pytest.raises(ValueError):
        tmpl.bind_batch([good_fp.literals, fp.literals])


def test_canonical_key_memoized(framework):
    plan = framework.engine.plan_sql("SELECT COUNT(*) FROM t WHERE a > 9")
    k1 = plan.canonical_key()
    assert plan._ckey == k1
    assert plan.canonical_key() is k1          # cached string, not rebuilt


def test_group_by_leaf_exec_col_invariant(framework):
    # Satellite: _expand_group_by computes exec_col once per plan; every
    # leaf must agree, and match the documented min-column rule.
    plan = framework.engine.plan_sql(
        "SELECT COUNT(*) FROM t WHERE b > 90 GROUP BY cat")
    exec_cols = {leaf.exec_col for leaf in plan.leaf_plans}
    assert len(exec_cols) == 1
    gcol = plan.group_by
    bcol = framework.engine.ph.col_index("b")
    assert exec_cols == {min(gcol, bcol)}


# ------------------------------------------------------- serving integration


def test_server_template_hits_skip_parse_entirely(framework):
    srv = _server(framework)
    shape = "SELECT COUNT(*) FROM t WHERE a > {p} AND b < {q}"
    # Cold: compiles the template (parses exactly this query).
    cold = srv.query(shape.format(p=42, q=150))
    # Hit phase: distinct literals (no plan/result-cache hits possible) —
    # the zero-parse guarantee, asserted by counting parse_sql calls.
    hits = [shape.format(p=p, q=q)
            for p in (10, 60, 110, 210, 310) for q in (80, 120, 160)]
    before = sqlmod.parse_calls()
    res = srv.query_batch(hits)
    assert sqlmod.parse_calls() == before
    assert cold.estimate is not None
    for sql, r in zip(hits, res):
        assert r.as_tuple() == framework.engine.query(sql).as_tuple()
    snap = srv.stats()
    tc = snap["totals"]["template_cache"]
    assert tc["hits"] >= len(hits)
    assert tc["hit_rate"] > 0
    srv.close()


def test_server_template_group_by_deferred_bind(framework):
    srv = _server(framework)
    shape = "SELECT COUNT(b) FROM t WHERE a < {p} GROUP BY cat"
    srv.query(shape.format(p=777))            # compile
    sqls = [shape.format(p=p) for p in (50, 150, 250)]
    want = [framework.engine.query(s) for s in sqls]   # parses; outside count
    before = sqlmod.parse_calls()
    got = [srv.query(s) for s in sqls]
    assert sqlmod.parse_calls() == before
    for g, w in zip(got, want):
        assert g.groups == w.groups
    srv.close()


def test_server_templates_off_still_serves(framework):
    srv = _server(framework, plan_templates=False)
    sql = "SELECT COUNT(*) FROM t WHERE a > 33 AND b < 170"
    assert (srv.query(sql).as_tuple()
            == framework.engine.query(sql).as_tuple())
    assert srv.stats()["totals"]["template_cache"]["hits"] == 0
    srv.close()


def test_template_cache_epoch_invalidation():
    table = _make_table(n=4_000, seed=21)
    fw = AQPFramework(BuildParams(n_samples=2_000, seed=3),
                      use_compression=False, device="cpu").ingest(table)
    srv = _server(fw)
    shape = "SELECT COUNT(*) FROM t WHERE a > {p}"
    srv.query(shape.format(p=10))
    assert srv.query(shape.format(p=20)).estimate is not None
    fw.append_rows({k: np.asarray(v)[:50] for k, v in table.items()})
    fw.rebuild(table)
    # Old-epoch template must not answer post-rebuild queries: the purge +
    # epoch-keyed get force a cold re-plan (which recompiles the template).
    sql = shape.format(p=30)
    got = srv.query(sql)
    assert got.as_tuple() == fw.engine.query(sql).as_tuple()
    tmpl_entry = srv.template_cache.get(
        sqlmod.fingerprint_sql(sql).shape, srv.catalog.epoch)
    assert tmpl_entry is not None and tmpl_entry.epoch == fw.epoch
    srv.close()


def test_server_bad_template_literal_fails_only_that_query(framework):
    srv = _server(framework)
    shape = "SELECT COUNT(*) FROM t WHERE a = {p}"
    srv.query(shape.format(p=5))              # compile the shape
    good = srv.submit(shape.format(p=7))
    bad = srv.submit("SELECT COUNT(*) FROM t WHERE a = 'oops'")
    srv.flush()
    assert good.result(timeout=TIMEOUT).estimate is not None
    with pytest.raises(ValueError):
        bad.result(timeout=TIMEOUT)
    srv.close()


def test_planner_pool_equivalence_and_errors(framework):
    srv = _server(framework, planner_workers=2)
    sqls = [f"SELECT COUNT(*) FROM t WHERE a > {p} AND c < {q}"
            for p in (10, 90, 170) for q in (20, 45)]
    res = srv.query_batch(sqls)
    for sql, r in zip(sqls, res):
        assert r.as_tuple() == framework.engine.query(sql).as_tuple()
    # Cold planning errors surface on the future, same as inline planning.
    fut = srv.submit("SELECT COUNT(*) FROM nope WHERE a > 1")
    with pytest.raises(PlanError):
        fut.result(timeout=TIMEOUT)
    srv.close()


def test_planner_pool_concurrent_submitters(framework):
    srv = _server(framework, planner_workers=2)
    shapes = ["SELECT COUNT(*) FROM t WHERE a > {} AND b < 150",
              "SELECT SUM(b) FROM t WHERE c > {}"]
    futs, lock = [], threading.Lock()

    def blast(seed):
        rng = np.random.default_rng(seed)
        mine = [srv.submit(shapes[i % 2].format(int(rng.integers(0, 400))))
                for i in range(20)]
        with lock:
            futs.extend(mine)

    threads = [threading.Thread(target=blast, args=(s,)) for s in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    srv.flush()
    for fut in futs:
        r = fut.result(timeout=TIMEOUT)
        assert r.estimate is not None and not r.rejected
    srv.close()


def test_explain_and_metrics_label_plan_path(framework):
    srv = _server(framework, trace_enabled=True)
    shape = "SELECT AVG(b) FROM t WHERE a > {p}"
    cold = srv.query(shape.format(p=111))
    hot = srv.query(shape.format(p=222))
    assert cold.explain["plan_path"] == "full"
    assert hot.explain["plan_path"] == "template"
    # Exact-text repeat: plan-cache hit, then served from the result cache.
    again = srv.query(shape.format(p=222))
    assert again.explain["plan_path"] == "plan_cache"
    assert again.explain["result_cache_hit"]
    stages = srv.stats()["totals"]["stages"]
    assert stages["plan_full"]["p50_ms"] is not None
    assert stages["plan_template_hit"]["p50_ms"] is not None
    srv.close()
