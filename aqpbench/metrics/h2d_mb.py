"""Mean megabytes (1e6 bytes) a build copies from the host to the device
(build counter h2d_bytes over the whole build)."""


def read(rec):
    b = [s["count_totals"].get("h2d_bytes", 0) / 1e6
         for s in rec.get("builds") or [] if "count_totals" in s]
    return sum(b) / len(b) if b else None
