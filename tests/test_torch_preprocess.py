"""The port's categorical pre-processing against the JAX package's: codes
bit for bit (NaN where missing), the same ``categories`` and ``ColumnInfo``,
on each of the three ways the port makes a column's sort keys; and the
``path`` and ``preprocess_str_rows`` that its span records."""
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest

from repro.gd.preprocess import preprocess_column as reference_column
from repro_torch.gd.preprocess import preprocess_column
from repro_torch.obs.timeline import BuildTimeline

NULL = "\0NULL\0"


def _flights_days(days: int, rows: int) -> dict:
    """``days`` days of the benchmark's ``flights_day`` table, concatenated
    as ``rebuild()`` concatenates its held rows."""
    path = Path(__file__).resolve().parents[1] / "aqpbench" / "tables" / \
        "flights_day.py"
    spec = importlib.util.spec_from_file_location("flights_day", path)
    table = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(table)
    made = [table.make(rows, 40 + j, j) for j in range(days)]
    return {k: np.concatenate([d[k] for d in made])
            for k in ("airline", "origin", "dest")}


def _u(values, width=None):
    arr = np.array(values)
    return arr if width is None else arr.astype(f"<U{width}")


RNG = np.random.default_rng(7)
FLIGHTS = _flights_days(3, 2_000)

# (case, column, the path its keys take)
CASES = [
    ("ascii_u2", np.array(["AA", "DL", "UA"])[RNG.choice(3, 500)], "packed"),
    ("ascii_u4", np.array(["A001", "A002", "B7", "Z"])[RNG.choice(4, 500)],
     "packed"),
    ("ascii_u16", _u(["SOUTHWEST", "DELTA", "UNITED", "DELTA"] * 30, 16),
     "values"),
    ("non_ascii_u16", _u(["é", "✈", "e", "é", "✈", "é", "AB"], 16),
     "values"),
    ("non_ascii_packed", _u(["é", "✈", "e", "é", "✈✈", "é", "AB"]),
     "packed"),
    ("ascii_63_bits", _u(["ABCDEFGHI", "A", "ABCDEFGHI", "Z"]), "packed"),
    ("ascii_70_bits", _u(["ABCDEFGHIJ", "A", "ABCDEFGHIJ", "Z"]), "values"),
    ("latin_64_bits", _u(["éééééééé", "A", "éA", "A", "Aé"]), "values"),
    ("emoji_51_bits", _u(["🛫", "a", "🛫a", "🛫🛫🛫"]), "packed"),
    ("emoji_68_bits", _u(["🛫", "a", "🛫a", "🛫🛫🛫🛫"]), "values"),
    ("prefixes", _u(["A", "AB", "A B", "AB", "A", "A B", "", "A\0B"]),
     "packed"),
    ("ties", _u(["d", "b", "c", "a", "c", "a", "d", "b", "e"]), "packed"),
    ("one_category", _u(["WN"] * 40), "packed"),
    ("empty", np.array([], dtype="<U2"), "packed"),
    ("sentinel", _u([NULL, "AA", "\0NULL", "DL", "AA", NULL]), "packed"),
    ("bytes", np.array([b"AA", b"DL", b"AA", b"", b"UA"]), "objects"),
    ("objects", np.array(["AA", None, np.nan, "DL", 3, 2.5, "AA", None,
                          np.float32("nan"), b"UA"], dtype=object),
     "objects"),
    ("objects_all_missing", np.array([None, np.nan, None], dtype=object),
     "objects"),
    ("big_endian", _u(["AA", "DL", "AA"]).astype(">U2"), "packed"),
    ("flights_airline", FLIGHTS["airline"], "packed"),
    ("flights_origin", FLIGHTS["origin"], "packed"),
    ("flights_dest", FLIGHTS["dest"], "packed"),
]


def _coded(column):
    """``preprocess_column`` under a timeline: codes, info, its one
    ``preprocess_categorical`` span and the timeline's counter totals."""
    tl = BuildTimeline()
    with tl.phase("preprocess"):
        codes, info = preprocess_column(column, "c")
    spans = [ev for ev in tl.events if ev["name"] == "preprocess_categorical"]
    assert len(spans) == 1 and spans[0]["column"] == "c"
    return codes, info, spans[0], tl.totals()


@pytest.mark.parametrize("case,column,path", CASES,
                         ids=[c[0] for c in CASES])
def test_categorical_matches_reference(case, column, path):
    want_codes, want_info = reference_column(column, "c")
    got_codes, got_info, ev, _ = _coded(column)
    assert ev["path"] == path
    assert got_codes.dtype == want_codes.dtype == np.float64
    assert got_codes.shape == want_codes.shape
    np.testing.assert_array_equal(np.isnan(got_codes), np.isnan(want_codes))
    np.testing.assert_array_equal(got_codes, want_codes)
    assert dataclasses.asdict(got_info) == dataclasses.asdict(want_info)
    assert [type(c) for c in got_info.categories] == \
        [str] * len(want_info.categories)


def test_categorical_path_and_counter():
    """A ``U`` column's span names its key path and converts no row one
    by one; an ``O`` column's is ``"objects"`` and counts its rows; with no
    timeline nothing is recorded."""
    _, _, ev, totals = _coded(FLIGHTS["origin"])
    assert ev["path"] == "packed"
    assert ev["counts"] == {"preprocess_str_rows": 0}
    assert totals["preprocess_str_rows"] == 0
    _, _, ev, totals = _coded(_u(["SOUTHWEST", "DELTA"], 16))
    assert ev["path"] == "values"
    assert totals["preprocess_str_rows"] == 0
    objects = np.array(["AA", None, "DL", np.nan, "AA"], dtype=object)
    _, _, ev, totals = _coded(objects)
    assert ev["path"] == "objects"
    assert totals["preprocess_str_rows"] == objects.size
    off = BuildTimeline(enabled=False)
    with off.phase("preprocess"):
        preprocess_column(objects, "c")
    assert off.events == []
    codes, info = preprocess_column(objects, "c")
    assert info.categories == ("AA", "DL")
    np.testing.assert_array_equal(codes, [0.0, np.nan, 1.0, np.nan, 0.0])
