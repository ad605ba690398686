"""A run with the timed path broken underneath comes out not correct:
once for each fault the build cells can have. The harness's look for a
chip is skipped; the rest of a run is driven on the CPU at a tiny size."""
import pytest


@pytest.mark.parametrize("workload", ["flights.build", "power.build"])
def test_build_returns_its_state_unchanged(run_tiny, monkeypatch, workload):
    """Every rebuild publishes the synopsis of the build before it (the
    window's first, set-up's)."""
    from repro_torch.aqp import engine
    orig_ingest = engine.AQPFramework.ingest
    orig = engine.AQPFramework.ingest_compressed
    last = {}

    def ingest(self, table):
        orig_ingest(self, table)
        last["syn"] = self.synopsis
        return self

    def unchanged(self, compressed, columns):
        orig(self, compressed, columns)
        self.synopsis, last["syn"] = last["syn"], self.synopsis
        return self
    monkeypatch.setattr(engine.AQPFramework, "ingest", ingest)
    monkeypatch.setattr(engine.AQPFramework, "ingest_compressed", unchanged)
    res = run_tiny(workload)
    assert not res["correct"]


@pytest.mark.parametrize("workload", ["flights.build", "power.build"])
def test_build_leaves_out_half_the_sample(run_tiny, monkeypatch, workload):
    from repro_torch.core import build
    orig = build.decompress_rows

    def half(ct, rows=None):
        out = orig(ct, rows)
        return out[: len(out) // 2] if rows is not None else out
    monkeypatch.setattr(build, "decompress_rows", half)
    res = run_tiny(workload)
    assert not res["correct"]


def test_build_count_altered_where_produced(run_tiny, monkeypatch):
    from repro_torch.core import refine
    orig = refine.pair_metadata_batch

    def altered(*a, **k):
        out = list(orig(*a, **k))
        out[0] = out[0].clone()
        out[0].view(-1)[0] += 1.0
        return tuple(out)
    monkeypatch.setattr(refine, "pair_metadata_batch", altered)
    res = run_tiny("flights.build")
    assert not res["correct"]
