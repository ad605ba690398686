"""Mean pre-processing (s) of a cycle of the window (ingest timeline span
preprocess: the retained month's raw columns to integer codes)."""


def read(rec):
    c = [s["phase_s"]["preprocess"] for s in rec.get("cycles") or []
         if "preprocess" in s.get("phase_s", {})]
    return sum(c) / len(c) if c else None
