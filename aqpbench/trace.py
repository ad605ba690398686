"""What a ``--trace 1`` run reads from the device: the profiler's device
operations over the window, each kernel launch's shapes, and the arithmetic
that turns them into busy time, idle gaps and roofline shares.

Frozen from ``chip_smoke.py`` (commit 9bf584f): the H100 peaks and
``bound_ms``; the K3/K4 byte and operation counts of ``_hist_case``; the
interval merge of ``_profile_report``. Nothing here imports JAX or the JAX
package.
"""
from __future__ import annotations

import contextlib
import time

# H100 SXM peaks (NVIDIA data sheet): device memory and fp32 without tensor
# cores (the kernels keep fp32 IEEE; construction counts are fp32 adds).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

# Kernel kinds of the port and the device kernels that a launch of each
# runs (the CUDA names in ``src/repro_torch/kernels/csrc``).
FLAT_HIST = ("flat_hist_kernel",)
# A K3/K4 launch zeroes its output just before the kernel adds into it;
# the counts include writing that output, so its time is the launch's.
ZEROING = ("FillFunctor", "Memset")
KINDS = {"batched_hist2d": "k3", "batched_subbin_hist": "k4"}


def bound_s(n_bytes: float, n_ops: float) -> float:
    """The least time the card could take: bytes at HBM speed or fp32
    operations at the fp32 peak, whichever is longer."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S)


def flat_hist_counts(p: int, n: int, w_bytes: int, ka: int,
                     kb: int) -> tuple[int, int]:
    """K3/K4: the two int64 id rows and the weights read once, the
    (P, ka * kb) output written once; one add a point."""
    n_bytes = p * n * (8 + 8 + w_bytes) + p * ka * kb * w_bytes
    return n_bytes, p * n


class LaunchRecorder:
    """Records each K3/K4 launch (kind, bound seconds) in launch order, by
    wrapping the port's launch function while it is installed. A call
    counts as a launch when the port's own launch counter moves."""

    def __init__(self):
        self.flat_hist: list[tuple[str, float]] = []

    @contextlib.contextmanager
    def installed(self):
        from repro_torch.kernels.hist2d import ops as hist2d_ops
        from repro_torch.kernels.subbin import ops as subbin_ops
        orig_flat = {m: m.flat_hist_cuda for m in (hist2d_ops, subbin_ops)}

        def flat(orig):
            def wrapped(a, b, weights, ka, kb, counter, key):
                before = counter[key]
                got = orig(a, b, weights, ka, kb, counter, key)
                if counter[key] != before:
                    p, n = weights.shape
                    w_bytes = 8 if weights.dtype.itemsize == 8 else 4
                    self.flat_hist.append(
                        (KINDS[key],
                         bound_s(*flat_hist_counts(p, n, w_bytes, ka, kb))))
                return got
            return wrapped

        for m, f in orig_flat.items():
            m.flat_hist_cuda = flat(f)
        try:
            yield self
        finally:
            for m, f in orig_flat.items():
                m.flat_hist_cuda = f


class DeviceTrace:
    """``torch.profiler`` over the window, CUDA activity only (kernels,
    copies, memsets). ``events`` holds (name, start s, end s) on the host's
    ``perf_counter`` clock after ``stop``. On a CPU device (the tests) it
    traces the host and keeps no event."""

    def __init__(self, device):
        self.device = device
        self.events: list[tuple[str, float, float]] = []
        self._prof = None

    def start(self):
        from torch.profiler import ProfilerActivity, profile
        act = (ProfilerActivity.CUDA if self.device.type == "cuda"
               else ProfilerActivity.CPU)
        self._prof = profile(activities=[act])
        self._prof.__enter__()

    def stop(self):
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        # The profiler's clock is the wall clock in ns; one reading of both
        # clocks maps it onto perf_counter.
        wall_ns, perf = time.time_ns(), time.perf_counter()
        self._prof.__exit__(None, None, None)
        raw = self._prof.profiler.kineto_results.events()
        cuda = torch.autograd.DeviceType.CUDA
        out = []
        for e in raw:
            if e.device_type() != cuda or e.is_user_annotation():
                continue
            t0 = perf + (e.start_ns() - wall_ns) * 1e-9
            out.append((e.name(), t0, t0 + e.duration_ns() * 1e-9))
        out.sort(key=lambda ev: ev[1])
        self.events = out
        self._prof = None


def busy_s(events, lo: float, hi: float) -> float:
    """Seconds in [lo, hi] in which some device operation ran: the
    intervals merged and clipped to the window."""
    busy, end = 0.0, lo
    for _, k0, k1 in events:
        k0, k1 = max(k0, end, lo), min(k1, hi)
        if k1 > k0:
            busy += k1 - k0
            end = k1
    return busy


def idle_gaps(events, lo: float, hi: float) -> list[tuple[float, float]]:
    """The intervals of [lo, hi] in which the device ran nothing."""
    gaps, end = [], lo
    for _, k0, k1 in events:
        if k0 > end:
            gaps.append((end, min(k0, hi)))
        end = max(end, k1)
        if end >= hi:
            break
    if end < hi:
        gaps.append((end, hi))
    return [(a, b) for a, b in gaps if b > a]


def per_launch_device_s(events, names: tuple, zeroing=()) -> list[float]:
    """Device seconds of each launch of a kernel family, in launch order:
    a launch starts at an event of ``names[0]`` and takes the events of the
    other names that follow it, and with ``zeroing`` the last zero-fill
    since the family's previous launch (its output's)."""
    out, fill = [], 0.0
    for name, t0, t1 in events:
        if names[0] in name:
            out.append(t1 - t0 + fill)
            fill = 0.0
        elif out and any(n in name for n in names[1:]):
            out[-1] += t1 - t0
        elif zeroing and any(n in name for n in zeroing):
            fill = t1 - t0
    return out


def rooflines(events, recorder: LaunchRecorder) -> dict:
    """``{kind: percent}``: each kind's bound seconds over its device
    seconds, launches matched to the trace in launch order. A family whose
    launch count differs from the trace's gives nothing."""
    records = recorder.flat_hist
    dev = per_launch_device_s(events, FLAT_HIST, ZEROING)
    if not records or len(dev) != len(records):
        return {}
    sums: dict[str, list[float]] = {}
    for (kind, bound), t in zip(records, dev):
        acc = sums.setdefault(kind, [0.0, 0.0])
        acc[0] += bound
        acc[1] += t
    return {kind: 100.0 * bound / t for kind, (bound, t) in sums.items()
            if t > 0}


def top_ops(events, lo: float, hi: float, n: int = 10) -> list:
    """The device operations that took most time in [lo, hi], by name."""
    by_name: dict[str, float] = {}
    for name, t0, t1 in events:
        d = min(t1, hi) - max(t0, lo)
        if d > 0:
            key = name[:96]
            by_name[key] = by_name.get(key, 0.0) + d
    return sorted(by_name.items(), key=lambda kv: -kv[1])[:n]


def labelled_gaps(gaps, spans, n: int = 10) -> list:
    """Idle seconds summed by what the host was doing: each piece of a gap
    goes to the shortest host span (name, t0, t1) that covers it, the rest
    to ``"other"``; the ``n`` largest. One sweep over sorted boundaries."""
    marks = []
    for name, s0, s1 in spans:
        if s1 > s0:
            marks.append((s0, 1, (s1 - s0, name, s0)))
            marks.append((s1, -1, (s1 - s0, name, s0)))
    for g0, g1 in gaps:
        marks.append((g0, 2, None))
        marks.append((g1, -2, None))
    marks.sort(key=lambda m: (m[0], m[1]))
    by_name: dict[str, float] = {}
    active: list = []
    in_gap, prev = 0, None
    for t, kind, key in marks:
        if in_gap and prev is not None and t > prev:
            name = min(active)[1] if active else "other"
            by_name[name] = by_name.get(name, 0.0) + (t - prev)
        prev = t
        if kind == 1:
            active.append(key)
        elif kind == -1:
            active.remove(key)
        else:
            in_gap += 1 if kind == 2 else -1
    return sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
