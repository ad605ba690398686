"""Mean pair phase (s) of the window's builds, from each build's
build_stats: the compacting 2-D scheduler and refinement."""


def read(rec):
    b = rec.get("builds") or []
    if not b:
        return None
    return sum(s["pair_phase_s"] for s in b) / len(b)
