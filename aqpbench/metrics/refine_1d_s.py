"""Mean 1-D refinement (s) of the window's builds (build timeline
phase refine_1d)."""


def read(rec):
    b = rec.get("builds") or []
    if not b:
        return None
    return sum(s["phase_s"].get("refine_1d", 0.0) for s in b) / len(b)
