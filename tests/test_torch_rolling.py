"""A rolling window on the port's framework: the oldest rows expired, new
ones appended, ``rebuild()`` ingesting what is held. Each rebuild is, bit
for bit, a fresh framework's ``ingest`` of the same rows; the ingest's own
span tree and counters are published with the epoch."""
import contextlib

import numpy as np
import pytest
import torch

from repro_torch.aqp.engine import AQPFramework
from repro_torch.core.types import BuildParams

from test_torch_build import assert_same_synopsis

DAY = 700
DAYS = 4
PARAMS = dict(n_samples=2_000, seed=11)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _day(seed: int, n: int = DAY) -> dict:
    """One day of a small mixed table: a text column, a fixed-point one with
    NULLs, two integral ones (one correlated with it)."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 300, n).astype(float)
    y = np.round(x * 0.4 + rng.normal(0, 8, n), 1)
    y[rng.random(n) < 0.05] = np.nan
    return {"carrier": np.array(["AA", "DL", "UA", "WN"])[
                rng.choice(4, n, p=[0.4, 0.3, 0.2, 0.1])],
            "x": x, "y": y, "z": rng.integers(0, 12, n).astype(float)}


def _concat(days) -> dict:
    return {k: np.concatenate([d[k] for d in days]) for k in days[0]}


def _framework() -> AQPFramework:
    return AQPFramework(BuildParams(**PARAMS), device="cpu")


def _assert_same_ingest(got: AQPFramework, want: AQPFramework):
    assert_same_synopsis(got.synopsis, want.synopsis)
    assert got.synopsis.n_rows == want.synopsis.n_rows
    a, b = got.compressed, want.compressed
    for f in ("bases", "base_ids", "base_bits", "total_bits", "null_mask",
              "sentinels"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)
    for x, y in zip(a.deviations, b.deviations):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(got.preprocessed.data,
                                  want.preprocessed.data)


def test_rolling_rebuild_is_a_fresh_ingest():
    """Three cycles of expire a day, append the next, rebuild: stale with
    a fresh epoch after each call, and each rebuild the synopsis, bases and
    codes of a fresh ingest of the last ``DAYS`` days, oldest first."""
    days = [_day(100 + i) for i in range(DAYS + 3)]
    fw = _framework().ingest(_concat(days[:DAYS]))
    for k in range(1, 4):
        epoch = fw.epoch
        fw.expire_rows(DAY)
        assert fw.is_stale and fw.epoch > epoch
        epoch = fw.epoch
        fw.append_rows(days[DAYS + k - 1])
        assert fw.is_stale and fw.epoch > epoch
        with pytest.raises(RuntimeError, match="stale"):
            fw.query("SELECT COUNT(*) FROM t")
        epoch = fw.epoch
        fw.rebuild()
        assert not fw.is_stale and fw.epoch > epoch
        assert fw.synopsis.n_rows == DAYS * DAY
        _assert_same_ingest(
            fw, _framework().ingest(_concat(days[k:k + DAYS])))


@pytest.mark.parametrize("expire", [0, DAY, DAYS * DAY + 300])
def test_expiry_runs_from_the_oldest_held_row(expire):
    """Expiry counts rows from the oldest held one, into the appended
    batches once the retained table is spent."""
    days = [_day(200 + i) for i in range(DAYS + 2)]
    fw = _framework().ingest(_concat(days[:DAYS]))
    fw.append_rows(days[DAYS])
    fw.append_rows(days[DAYS + 1])
    fw.expire_rows(expire)
    fw.rebuild()
    whole = _concat(days)
    want = {k: v[expire:] for k, v in whole.items()}
    _assert_same_ingest(fw, _framework().ingest(want))


def test_rebuild_with_base_table_merges_the_batches():
    """``rebuild(base_table)``: the given table, then the batches appended
    since; afterwards the merged rows are what is held."""
    days = [_day(300 + i) for i in range(3)]
    fw = _framework().ingest(days[0])
    fw.append_rows(days[2])
    fw.rebuild(days[1])
    want = _framework().ingest(_concat(days[1:]))
    _assert_same_ingest(fw, want)
    fw.expire_rows(DAY)
    fw.rebuild()
    _assert_same_ingest(fw, _framework().ingest(days[2]))


@pytest.mark.parametrize("cycle", ["rebuild_base", "expire_rebuild"])
def test_rebuild_matches_the_reference_package(cycle):
    """One cycle on the port, ``append_rows`` then ``rebuild(base_table)``,
    or ``expire_rows``, ``append_rows`` and ``rebuild()``, gives the
    reference package's synopsis and bases for its ``append_rows`` and
    ``rebuild(base_table)`` of the same rows."""
    from repro.aqp.engine import AQPFramework as RefFramework
    from repro.core.types import BuildParams as RefParams
    days = [_day(800 + i) for i in range(DAYS + 1)]
    ref = RefFramework(RefParams(**PARAMS)).ingest(_concat(days[:DAYS]))
    ref.append_rows(days[DAYS])
    ref.rebuild(_concat(days[1:DAYS]))
    fw = _framework().ingest(_concat(days[:DAYS]))
    if cycle == "rebuild_base":
        fw.append_rows(days[DAYS])
        fw.rebuild(_concat(days[1:DAYS]))
    else:
        fw.expire_rows(DAY)
        fw.append_rows(days[DAYS])
        fw.rebuild()
    assert_same_synopsis(ref.synopsis, fw.synopsis)
    np.testing.assert_array_equal(np.asarray(ref.compressed.bases),
                                  fw.compressed.bases)


@pytest.mark.parametrize("direct", ["ingest", "ingest_compressed"])
def test_direct_ingest_drops_pending_appends_and_expiry(direct):
    """An ``ingest`` or ``ingest_compressed`` replaces what is held, so
    batches appended and rows expired before it do not reach a later
    rebuild."""
    from repro_torch.gd.greedygd import GreedyGD
    days = [_day(900 + i) for i in range(3)]
    fw = _framework().ingest(days[0])
    fw.expire_rows(DAY // 2)
    fw.append_rows(days[1])
    if direct == "ingest":
        fw.ingest(days[2])
        fw.rebuild()
        _assert_same_ingest(fw, _framework().ingest(days[2]))
        return
    pp = fw.preprocessed
    fw.ingest_compressed(GreedyGD(device="cpu").compress(pp.data),
                         pp.columns)
    with pytest.raises(ValueError, match="no raw table"):
        fw.rebuild()
    fw.append_rows(days[2])
    fw.rebuild()
    _assert_same_ingest(fw, _framework().ingest(days[2]))


def test_retention_rejects_what_it_cannot_do():
    from repro_torch.gd.greedygd import GreedyGD
    days = [_day(400), _day(401)]
    fw = _framework().ingest(days[0])
    fw.append_rows(days[1])
    with pytest.raises(ValueError, match="expire"):
        fw.expire_rows(2 * DAY + 1)
    with pytest.raises(ValueError, match="expire"):
        fw.expire_rows(-1)
    fw.expire_rows(2 * DAY - 1)
    with pytest.raises(ValueError, match="expire"):
        fw.expire_rows(2)
    cold = _framework()
    cold.ingest_compressed(
        GreedyGD(device="cpu").compress(fw.preprocessed.data),
        fw.preprocessed.columns)
    with pytest.raises(ValueError, match="no raw table"):
        cold.rebuild()


INGEST_TREE = {"merge": None, "preprocess": None,
               "preprocess_categorical": "preprocess",
               "preprocess_numeric": "preprocess", "gd_compress": None,
               "gd_missing": "gd_compress", "gd_plan": "gd_compress",
               "gd_encode": "gd_compress", "build": None}


def test_ingest_span_tree_and_counters():
    """A rebuild's timeline: ``merge``, ``preprocess`` (a span a column
    by its kind), ``gd_compress`` (``gd_missing``, ``gd_plan``,
    ``gd_encode``), ``build``, in that order and each inside its parent;
    its rows and bases counted; the build's own tree as before."""
    days = [_day(500 + i) for i in range(DAYS + 1)]
    fw = _framework().ingest(_concat(days[:DAYS]))
    first = fw.timings
    assert "merge" not in first["ingest_phase_s"]
    fw.expire_rows(DAY)
    fw.append_rows(days[DAYS])
    fw.rebuild()
    t = fw.timings
    events = t["ingest_timeline"]
    names = [ev["name"] for ev in events]
    assert [n for n in names if INGEST_TREE[n] is None] == [
        "merge", "preprocess", "gd_compress", "build"]
    assert names.count("preprocess_categorical") == 1
    assert names.count("preprocess_numeric") == 3
    assert set(names) == set(INGEST_TREE)
    for ev in events:
        up = ev["parent"]
        assert (None if up is None else events[up]["name"]) == \
            INGEST_TREE[ev["name"]]
        if up is not None:
            assert events[up]["t0"] <= ev["t0"] <= ev["t1"] <= \
                events[up]["t1"]
    assert [ev["column"] for ev in events
            if ev["name"].startswith("preprocess_")] == list(days[0])
    counts = t["ingest_counts"]
    assert counts["preprocess_rows"] == counts["gd_rows_encoded"] == \
        DAYS * DAY
    assert counts["gd_bases"] == len(fw.compressed.bases)
    phase = t["ingest_phase_s"]
    assert t["preprocess_s"] == phase["preprocess"]
    assert t["compress_s"] == phase["gd_compress"]
    assert t["build_synopsis_s"] == phase["build"]
    assert "pair_phase" in fw.synopsis.build_stats["phase_s"]
    assert not any(ev["name"] in INGEST_TREE
                   for ev in fw.synopsis.build_stats["timeline"])


GD_SPANS = ["gd_missing", "gd_plan", "gd_encode"]


@pytest.mark.parametrize("days,search_rows", [(2, None), (4, None),
                                              (2, 500), (4, 500)])
def test_gd_counts_its_device_work(days, search_rows):
    """GreedyGD's transfers: the matrix uploaded once (``gd_missing``, one
    read of the sentinels and maxima), one read a greedy step
    (``gd_plan_steps``) and the search rows' upload where there are more
    rows than ``search_rows`` (``gd_plan``), the shifts' upload, the count
    of bases and four downloads (``gd_encode``): constants, whatever the
    rows."""
    from repro_torch.gd.greedygd import GreedyGD
    fw = _framework()
    if search_rows:
        fw.gd = GreedyGD(search_rows=search_rows, device=fw.device)
    fw.ingest(_concat([_day(800 + i) for i in range(days)]))
    events = fw.timings["ingest_timeline"]
    gd = {ev["name"]: ev.get("counts", {}) for ev in events
          if ev["name"].startswith("gd_") and ev["name"] != "gd_compress"}
    assert [ev["name"] for ev in events if ev["name"] in gd] == GD_SPANS
    d = fw.preprocessed.d
    steps = gd["gd_plan"]["gd_plan_steps"]
    assert steps >= 1
    assert gd["gd_plan"]["d2h_reads"] == steps
    assert gd["gd_plan"]["h2d_copies"] == (2 if search_rows else 1)
    assert gd["gd_missing"] == {"h2d_copies": 1, "d2h_reads": 1,
                                "h2d_bytes": days * DAY * d * 8}
    assert gd["gd_encode"] == {"h2d_copies": 1, "h2d_bytes": d * 8,
                               "d2h_reads": 5}
    counts = fw.timings["ingest_counts"]
    assert counts["gd_plan_steps"] == steps
    assert counts["h2d_copies"] == (4 if search_rows else 3)


def test_gd_and_preprocess_record_nothing_without_a_timeline():
    from repro_torch.gd.greedygd import GreedyGD
    from repro_torch.gd.preprocess import preprocess_table
    from repro_torch.obs.timeline import BuildTimeline
    pp = preprocess_table(_day(600))
    GreedyGD(device="cpu").compress(pp.data)
    tl = BuildTimeline()
    with tl.phase("outer"):
        GreedyGD(device="cpu").compress(pp.data)
    assert [ev["name"] for ev in tl.events] == [
        "outer", "gd_missing", "gd_plan", "gd_encode"]
    assert tl.totals()["gd_rows_encoded"] == DAY


@pytest.mark.parametrize("profiled", [True, False])
def test_ingest_spans_are_profiler_annotations(monkeypatch, profiled):
    """Under a recording ``torch.profiler`` each ingest span is a user
    annotation of its name, nested as the spans nest; with none recording
    no ``record_function`` is entered."""
    entered = []

    class Counting(torch.profiler.record_function):
        def __enter__(self):
            entered.append(self.name)
            return super().__enter__()

    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    fw = _framework().ingest(_day(700))
    fw.append_rows(_day(701))
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    with prof if profiled else contextlib.nullcontext():
        fw.rebuild()
    ingest = [ev["name"] for ev in fw.timings["ingest_timeline"]]
    if not profiled:
        assert entered == []
        return
    assert [n for n in entered if n in INGEST_TREE] == ingest
    notes = {e.name: e for e in prof.events()
             if e.is_user_annotation and e.name in ("build", "gd_plan",
                                                    "gd_compress")}
    up = notes["gd_plan"].cpu_parent
    while up is not None and up.name != "gd_compress":
        up = up.cpu_parent
    assert up is not None
    first_build = [e for e in prof.events() if e.is_user_annotation
                   and e.name == "refine_1d"][0]
    up = first_build.cpu_parent
    while up is not None and up.name != "build":
        up = up.cpu_parent
    assert up is not None
