"""Mean decode (s) of the sampled rows a build (build timeline span
decompress_rows, inside sample): the front end's part of a build."""


def read(rec):
    b = [s["phase_s"]["decompress_rows"] for s in rec.get("builds") or []
         if "decompress_rows" in s.get("phase_s", {})]
    return sum(b) / len(b) if b else None
