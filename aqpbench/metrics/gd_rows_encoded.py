"""Mean rows handed to GreedyGD's compress a cycle of the window (ingest
counter gd_rows_encoded): the whole retained table while nothing is
incremental."""


def read(rec):
    c = [s["counts"]["gd_rows_encoded"] for s in rec.get("cycles") or []
         if "gd_rows_encoded" in s.get("counts", {})]
    return sum(c) / len(c) if c else None
