"""Mean blocking reads of a device value by the host in a build's pair
phase (build counter d2h_reads under the pair_phase span)."""


def read(rec):
    b = [s["counts"].get("pair_phase", {}).get("d2h_reads", 0)
         for s in rec.get("builds") or [] if "counts" in s]
    return sum(b) / len(b) if b else None
