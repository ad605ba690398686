"""Share (%) of the window's pair phases spent in the host presort
(build timeline: pair_presort over pair_phase)."""


def read(rec):
    b = rec.get("builds") or []
    if not b:
        return None
    pre = sum(s["phase_s"].get("pair_presort", 0.0) for s in b)
    pair = sum(s["phase_s"].get("pair_phase", 0.0) for s in b)
    return 100.0 * pre / pair if pair > 0 else None
