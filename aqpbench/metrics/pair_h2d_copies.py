"""Mean host-to-device copies in a build's pair phase (build counter
h2d_copies under the pair_phase span)."""


def read(rec):
    b = [s["counts"].get("pair_phase", {}).get("h2d_copies", 0)
         for s in rec.get("builds") or [] if "counts" in s]
    return sum(b) / len(b) if b else None
