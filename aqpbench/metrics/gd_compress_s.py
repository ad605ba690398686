"""Mean GreedyGD compression (s) of a cycle of the window (ingest timeline
span gd_compress: sentinel codes, the base search, the encoding)."""


def read(rec):
    c = [s["phase_s"]["gd_compress"] for s in rec.get("cycles") or []
         if "gd_compress" in s.get("phase_s", {})]
    return sum(c) / len(c) if c else None
