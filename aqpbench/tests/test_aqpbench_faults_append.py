"""A run of ``flights.append_rebuild`` with the retention broken underneath
comes out not correct: once for each fault a rolling window can have. The
harness's look for a chip is skipped; the rest of a run is driven on the CPU
at a tiny size."""
CELL = "flights.append_rebuild"


def test_rebuild_publishes_the_previous_cycles_synopsis(run_tiny,
                                                        monkeypatch):
    from repro_torch.aqp import engine
    orig_ingest = engine.AQPFramework.ingest
    orig_rebuild = engine.AQPFramework.rebuild
    last = {}

    def ingest(self, table):
        orig_ingest(self, table)
        last["syn"] = self.synopsis
        return self

    def previous(self, base_table=None):
        orig_rebuild(self, base_table)
        self.synopsis, last["syn"] = last["syn"], self.synopsis
        return self
    monkeypatch.setattr(engine.AQPFramework, "ingest", ingest)
    monkeypatch.setattr(engine.AQPFramework, "rebuild", previous)
    res = run_tiny(CELL)
    assert not res["correct"]


def test_expiry_ignored(run_tiny, monkeypatch):
    """The oldest day stays: the table grows a day a cycle."""
    from repro_torch.aqp import engine
    monkeypatch.setattr(engine.AQPFramework, "expire_rows",
                        lambda self, n: self._publish(None))
    res = run_tiny(CELL)
    assert not res["correct"]


def test_appended_day_lost(run_tiny, monkeypatch):
    from repro_torch.aqp import engine
    monkeypatch.setattr(engine.AQPFramework, "append_rows",
                        lambda self, table: self._publish(None))
    res = run_tiny(CELL)
    assert not res["correct"]
