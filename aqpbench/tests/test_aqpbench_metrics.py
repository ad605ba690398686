"""End-to-end metrics over all the work of the window, moved by one
injected stall; roofline shares against hand counts; the run-time check
for JAX modules by whole top-level names."""
import sys
import types

import pytest


def test_build_s_counts_the_share_inside_the_window():
    from aqpbench.loops.rebuild import build_s
    steady = [(k, k * 2.0, k * 2.0 + 2.0, None) for k in range(5)]  # 10 s
    assert build_s(9.0, 9.0, steady) == pytest.approx(2.0)
    # One stalled build of 5 s moves it.
    stalled = [(0, 0.0, 2.0, None), (1, 2.0, 7.0, None),
               (2, 7.0, 9.0, None), (3, 9.0, 11.0, None)]
    assert build_s(9.0, 9.0, stalled) == pytest.approx(3.0)


def test_roofline_against_hand_counts():
    from aqpbench import trace as tr
    # K3 over 8 pairs of 1,000 rows into 32 x 32 f64 bins: two int64 ids
    # and an f64 weight a point read, the 8 x 1,024 f64 output written.
    b3, o3 = tr.flat_hist_counts(8, 1000, 8, 32, 32)
    assert b3 == 8 * 1000 * 24 + 8 * 1024 * 8 and o3 == 8000
    # K4 over 2 pairs of 500 rows, f32 weights, 4 x 16 bins.
    b4, o4 = tr.flat_hist_counts(2, 500, 4, 4, 16)
    assert b4 == 2 * 500 * 20 + 2 * 64 * 4 and o4 == 1000
    bound3, bound4 = tr.bound_s(b3, o3), tr.bound_s(b4, o4)
    assert bound3 == pytest.approx(b3 / 3.35e12)
    rec = tr.LaunchRecorder()
    rec.flat_hist = [("k3", bound3), ("k4", bound4), ("k3", bound3)]
    ev = [("void elementwise_kernel<FillFunctor<double>>", 0.0, 1e-6),
          ("void flat_hist_kernel<double>(...)", 0.1, 0.1 + 3e-6),
          ("Memcpy DtoH", 0.2, 0.3),
          ("void flat_hist_kernel<float>(...)", 1.0, 1.0 + 10 * bound4),
          ("void flat_hist_kernel<double>(...)", 2.0, 2.0 + 4e-6)]
    got = tr.rooflines(ev, rec)
    # K3's time includes the zeroing of its output: 4 + 4 us for 2 bounds.
    assert got["k3"] == pytest.approx(100 * 2 * bound3 / 8e-6)
    assert got["k4"] == pytest.approx(10.0)
    # A launch count that differs from the trace's gives nothing.
    rec.flat_hist.append(("k4", bound4))
    assert tr.rooflines(ev, rec) == {}


def test_readers_take_the_window_record():
    from aqpbench import spec
    stats = [{"pair_phase_s": 2.0, "n_pairs": 66,
              "phase_s": {"pair_presort": 1.5, "pair_phase": 2.0,
                          "refine_1d": 0.25}},
             {"pair_phase_s": 3.0, "n_pairs": 66,
              "phase_s": {"pair_presort": 1.5, "pair_phase": 3.0,
                          "refine_1d": 0.75}}]
    rec = {"kind": "build", "builds": stats, "busy_s": 3.0,
           "window_s": 30.0, "rooflines": {"k3": 47.0}}
    read = {m: spec.reader(m)(rec) for m in (
        "pair_phase_s", "presort_share", "refine_1d_s", "k3_roofline",
        "k4_roofline", "idle_share.build")}
    assert read == {"pair_phase_s": 2.5, "presort_share": 60.0,
                    "refine_1d_s": 0.5, "k3_roofline": 47.0,
                    "k4_roofline": None,
                    "idle_share.build": pytest.approx(90.0)}
    empty = {m: spec.reader(m)({"builds": []}) for m in read}
    assert set(empty.values()) == {None}


def test_busy_and_idle():
    from aqpbench import trace as tr
    ev = [("a", 0.1, 0.2), ("b", 0.15, 0.3), ("c", 0.5, 0.6)]
    assert tr.busy_s(ev, 0.0, 1.0) == pytest.approx(0.3)
    assert tr.idle_gaps(ev, 0.0, 1.0) == [(0.0, 0.1), (0.3, 0.5), (0.6, 1.0)]
    lab = dict(tr.labelled_gaps(tr.idle_gaps(ev, 0.0, 1.0),
                                [("x", 0.0, 0.45), ("y", 0.35, 0.4)]))
    assert lab["y"] == pytest.approx(0.05)
    assert lab["x"] == pytest.approx(0.2)
    assert lab["other"] == pytest.approx(0.45)


def test_forbidden_modules_compare_whole_names(monkeypatch):
    from aqpbench import harness
    for name in ("repro_torch", "repro_torch.core", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert not (set(harness.forbidden_modules())
                & {"repro_torch", "jaxtyping", "flaxen"})
    monkeypatch.setitem(sys.modules, "repro.core",
                        types.ModuleType("repro.core"))
    assert "repro" in harness.forbidden_modules()


def test_no_card_no_result(monkeypatch, capsys):
    import torch
    from aqpbench import harness
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for var in ("TORCH_EXTENSIONS_DIR", "TRITON_CACHE_DIR", "USE_FLAX",
                "USE_JAX"):
        monkeypatch.setenv(var, "")     # restored after the test
    rc = harness.main(["--workload", "flights.build", "--seed", "1",
                       "--seconds", "1", "--trace", "0"], 0.0)
    assert rc != 0
    assert capsys.readouterr().out == ""
