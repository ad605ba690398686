"""Observability of the port: spans, per-query traces, build timelines,
Perfetto export.

The serving stack (``repro_torch.serve.aqp``) threads a per-query
``QueryTrace`` through submit -> admission -> wave -> resolution and records
spans into a lock-free ring-buffer ``Tracer``; the construction stack
records a ``BuildTimeline`` (a tree of spans with host/device transfer
counters, and ``torch.profiler`` ranges while a profiler records) into
``PairwiseHist.build_stats``. Both sides export to Chrome/Perfetto
``trace_event`` JSON via ``repro_torch.obs.export`` (open the artifact at
https://ui.perfetto.dev).
"""
from repro_torch.obs.export import (spans_to_events,  # noqa: F401
                                    timeline_to_events, trace_json,
                                    validate_trace_events, write_trace)
from repro_torch.obs.timeline import BuildTimeline  # noqa: F401
from repro_torch.obs.trace import (NOOP_SPAN, QueryTrace, Span,  # noqa: F401
                                   Tracer)
