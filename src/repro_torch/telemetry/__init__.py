"""Telemetry: round-span tracing with device fences, per-round metrics and
provenance-stamped event logs.

* :mod:`trace`      — nested monotonic-clock spans whose exit waits on the
                      CUDA events :meth:`Span.fence` recorded, and the
                      :class:`Stopwatch` timer of the launch scripts;
* :mod:`metrics`    — per-round gauges and run counters, from values the
                      drivers already fetched;
* :mod:`sinks`      — the JSONL event log (crash-tolerant append), an
                      in-memory sink for tests, the console sink that
                      ``verbose=True`` turns on;
* :mod:`profile`    — opt-in ``torch.profiler`` windows;
* :mod:`provenance` — the environment stamp (torch/CUDA/cuDNN versions,
                      device name and count, the card's power limit, CPU
                      count, git sha, timestamp);
* :mod:`session`    — the :class:`Telemetry` config and the per-run
                      :class:`TelemetrySession`.

Telemetry does not touch the math: it draws from no random stream and
fetches nothing, so a run with it on gives the History of a run with it off
(``tests/test_torch_telemetry.py``).  Off, it queues no device work and
waits on nothing; on, it adds only its fences.
"""
from .metrics import MetricsRegistry, jit_cache_stats, pool_gauges, round_gauges
from .profile import ProfileHook
from .provenance import provenance
from .session import (DISABLED, NULL_SESSION, NullSession, Telemetry, TelemetrySession,
                      resolve_telemetry)
from .sinks import ConsoleSink, JSONLSink, MemorySink, MultiSink, Sink, read_jsonl
from .trace import NULL_SPAN, NULL_TRACER, Span, Stopwatch, Tracer

__all__ = [
    "Telemetry", "TelemetrySession", "NullSession", "NULL_SESSION",
    "DISABLED", "resolve_telemetry",
    "Tracer", "Span", "Stopwatch", "NULL_TRACER", "NULL_SPAN",
    "MetricsRegistry", "round_gauges", "pool_gauges", "jit_cache_stats",
    "Sink", "JSONLSink", "MemorySink", "ConsoleSink", "MultiSink",
    "read_jsonl",
    "ProfileHook", "provenance",
]
