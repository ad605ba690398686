"""Mean host presort sorting (s) a build (build timeline span
presort_sort: the composite keys, two stable argsorts a pair, the
permutation gathers and the run flags)."""


def read(rec):
    b = [s["phase_s"]["presort_sort"] for s in rec.get("builds") or []
         if "presort_sort" in s.get("phase_s", {})]
    return sum(b) / len(b) if b else None
