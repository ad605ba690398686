"""The readers of the build's own spans and counters: each on a
hand-made window record, nothing with no builds, and nothing from builds
whose program records no such span or counter."""
import pytest

READERS = ("decompress_s", "presort_sort_s", "pair_d2h_reads",
           "pair_h2d_copies", "h2d_mb")


def _build(decode, sort, reads, copies, h2d_bytes):
    return {"pair_phase_s": 2.0,
            "phase_s": {"sample": decode + 0.1, "decompress_rows": decode,
                        "pair_phase": 2.0, "pair_presort": sort + 0.2,
                        "presort_sort": sort},
            "counts": {"pair_phase": {"d2h_reads": reads,
                                      "h2d_copies": copies,
                                      "h2d_bytes": h2d_bytes // 2},
                       "pair_upload": {"h2d_copies": 8,
                                       "h2d_bytes": h2d_bytes // 4}},
            "count_totals": {"d2h_reads": reads + 20,
                             "h2d_copies": copies + 50,
                             "h2d_bytes": h2d_bytes}}


@pytest.mark.parametrize("metric, want", [
    ("decompress_s", 0.2), ("presort_sort_s", 1.5),
    ("pair_d2h_reads", 300.0), ("pair_h2d_copies", 1100.0),
    ("h2d_mb", 50.0)])
def test_reader_takes_the_mean_over_builds(metric, want):
    from aqpbench import spec
    rec = {"kind": "build",
           "builds": [_build(0.1, 1.0, 200, 1000, 40_000_000),
                      _build(0.3, 2.0, 400, 1200, 60_000_000)]}
    assert spec.reader(metric)(rec) == pytest.approx(want)


@pytest.mark.parametrize("metric", READERS)
def test_reader_reads_nothing_without_its_source(metric):
    from aqpbench import spec
    read = spec.reader(metric)
    assert read({"kind": "build", "builds": []}) is None
    assert read({"kind": "build"}) is None
    # Builds of a program that records neither the spans nor the counts.
    older = {"pair_phase_s": 2.0,
             "phase_s": {"sample": 0.1, "pair_phase": 2.0,
                         "pair_presort": 1.5}}
    assert read({"kind": "build", "builds": [older, older]}) is None


def test_readers_count_a_missing_counter_as_zero():
    """A pair phase that read nothing from the device still counts as a
    build with no reads."""
    from aqpbench import spec
    one = _build(0.1, 1.0, 200, 1000, 40_000_000)
    some = dict(one, counts={"pair_phase": {"h2d_copies": 10}})
    none = dict(one, counts={})
    rec = {"kind": "build", "builds": [one, some, none]}
    assert spec.reader("pair_d2h_reads")(rec) == pytest.approx(200 / 3)
    assert spec.reader("pair_h2d_copies")(rec) == pytest.approx(1010 / 3)
