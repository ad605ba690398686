"""Mean synopsis build (s) of a cycle of the window (ingest timeline span
build: the whole of build_pairwise_hist from the compressed table)."""


def read(rec):
    c = [s["phase_s"]["build"] for s in rec.get("cycles") or []
         if "build" in s.get("phase_s", {})]
    return sum(c) / len(c) if c else None
