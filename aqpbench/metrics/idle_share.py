"""Share (%) of the traced window in which the device ran nothing
(torch.profiler: kernels, copies and memsets merged). It reads every
``idle_share.<kind>`` entry; the entry's name says which end-to-end metric
its cells report."""


def read(rec):
    if not rec.get("window_s"):
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])
