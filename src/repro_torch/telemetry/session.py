"""The :class:`Telemetry` config object and the per-run session it opens.

``Telemetry`` is a frozen, declarative config — *what* to record and where
to send it — safe to embed in :class:`~repro_torch.core.ProtocolConfig`, pass as a
driver kwarg, or share across several runs (each run opens its own
session).  :class:`TelemetrySession` is the runtime: it owns the span
tracer, the metrics registry, the sink fan-out (serialised under one lock so
the RoundFeeder's producer thread can emit concurrently with the main loop)
and the optional profiler hook, and it stamps every run with a provenance
header (``run_start`` event).

``resolve_telemetry`` is the drivers' single entry point.  It implements the
``verbose=True`` back-compat contract — verbose is now an alias for the
console sink — and returns the shared no-op session when telemetry is
disabled, so the hot loop's cost in the disabled case is a handful of no-op
method calls per round.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, Dict, Optional, Tuple

from .metrics import MetricsRegistry, jit_cache_stats, round_gauges
from .profile import ProfileHook
from .provenance import provenance
from .sinks import ConsoleSink, JSONLSink, Sink
from .trace import NULL_SPAN, NULL_TRACER, NullSpan, Tracer


@dataclasses.dataclass(frozen=True)
class Telemetry:
    """Declarative telemetry config, threaded through
    ``ProtocolConfig.telemetry`` / the drivers' ``telemetry=`` kwarg, the
    and the launch scripts.

    ``jsonl``      — path of the append-only JSONL event log (None = off).
    ``console``    — per-round console lines (what ``verbose=True`` enables).
    ``sinks``      — extra :class:`~repro_torch.telemetry.sinks.Sink` instances
                     (e.g. a :class:`MemorySink` for tests); the session
                     emits to these but does NOT close them, so one sink can
                     observe several runs.
    ``spans``      — emit phase spans (off leaves only round records).
    ``jit_stats``  — include the kernel-library stats (``jit_cache_stats``)
                     in round records.
    ``profile_dir``/``profile_rounds`` — windowed ``torch.profiler`` trace
                     (see :mod:`repro_torch.telemetry.profile`).
    """
    enabled: bool = True
    jsonl: Optional[str] = None
    console: bool = False
    sinks: Tuple[Sink, ...] = ()
    spans: bool = True
    jit_stats: bool = False
    profile_dir: Optional[str] = None
    profile_rounds: Optional[Tuple[int, int]] = None

    def session(self, run: str = "", **meta: Any) -> "TelemetrySession":
        """Open a per-run session (emits the provenance-stamped
        ``run_start`` header immediately)."""
        return TelemetrySession(self, run=run, meta=meta)


DISABLED = Telemetry(enabled=False)


class TelemetrySession:
    """One run's live telemetry.  Use as a context manager (``close`` emits
    the ``run_end`` summary and closes owned sinks)."""

    enabled = True

    def __init__(self, cfg: Telemetry, run: str = "",
                 meta: Optional[Dict[str, Any]] = None):
        self.cfg = cfg
        self.run = run
        self.metrics = MetricsRegistry()
        self._lock = threading.Lock()
        self._sinks = list(cfg.sinks)
        self._owned: list = []
        if cfg.jsonl:
            s = JSONLSink(cfg.jsonl)
            self._sinks.append(s)
            self._owned.append(s)
        if cfg.console:
            s = ConsoleSink()
            self._sinks.append(s)
            self._owned.append(s)
        self.tracer = Tracer(self._emit) if cfg.spans else NULL_TRACER
        self._profile = (ProfileHook(cfg.profile_dir, cfg.profile_rounds)
                         if cfg.profile_dir else None)
        self._closed = False
        self._emit({"event": "run_start", "provenance": provenance(),
                    **(meta or {})})

    # -- events -------------------------------------------------------------

    def _emit(self, event: Dict[str, Any]) -> None:
        event.setdefault("run", self.run)
        with self._lock:
            for s in self._sinks:
                s.emit(event)

    def emit(self, event: Dict[str, Any]) -> None:
        """Emit a custom event (must carry an ``event`` kind key)."""
        self._emit(event)

    # -- spans --------------------------------------------------------------

    def span(self, name: str, **attrs: Any):
        """A nested phase span (``with tel.span("round.step", round=t) as
        sp: ...; sp.fence(outputs)``)."""
        return self.tracer.span(name, **attrs)

    # -- per-round metrics --------------------------------------------------

    def record_round(self, t: int, rec: Dict[str, Any],
                     feeder_depth: Optional[int] = None,
                     **extra: Any) -> None:
        """Fold one driver History record into the metrics registry and emit
        the per-round ``round`` event.  Everything read here is a host-side
        Python value the driver already fetched — no device sync."""
        self.metrics.observe_round(rec)
        event: Dict[str, Any] = {"event": "round", "t": int(t)}
        event.update(round_gauges(rec, feeder_depth))
        if self.cfg.jit_stats:
            event["jit"] = jit_cache_stats()
        event.update(extra)
        self._emit(event)

    # -- profiler window ----------------------------------------------------

    def profile_tick(self, t: int) -> None:
        """Advance the optional ``torch.profiler`` window to round ``t``."""
        if self._profile is not None:
            self._profile.tick(t)

    # -- lifecycle ----------------------------------------------------------

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self._profile is not None:
            self._profile.close()
        self._emit({"event": "run_end", "metrics": self.metrics.snapshot()})
        for s in self._owned:
            s.close()

    def __enter__(self) -> "TelemetrySession":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class NullSession:
    """The disabled session: every method is a no-op and ``span`` returns
    the shared :class:`NullSpan`.  A single instance serves every disabled
    run — it holds no state and ``close`` does nothing."""

    enabled = False
    metrics = None
    run = ""

    def span(self, name: str, **attrs: Any) -> NullSpan:
        return NULL_SPAN

    def emit(self, event: Dict[str, Any]) -> None:
        pass

    def record_round(self, t: int, rec: Dict[str, Any],
                     feeder_depth: Optional[int] = None,
                     **extra: Any) -> None:
        pass

    def profile_tick(self, t: int) -> None:
        pass

    def close(self) -> None:
        pass

    def __enter__(self) -> "NullSession":
        return self

    def __exit__(self, *exc) -> None:
        pass


NULL_SESSION = NullSession()


class _BorrowedSession:
    """A caller-owned session as seen by a driver: everything delegates to
    the real session except lifecycle — the driver's ``close``/``__exit__``
    must not end a session it did not open."""

    __slots__ = ("_inner",)

    def __init__(self, inner: TelemetrySession):
        self._inner = inner

    def __getattr__(self, name: str):
        return getattr(self._inner, name)

    def close(self) -> None:
        pass

    def __enter__(self) -> "_BorrowedSession":
        return self

    def __exit__(self, *exc) -> None:
        pass


def resolve_telemetry(telemetry: Optional[Telemetry], verbose: bool = False,
                      run: str = "", **meta: Any):
    """The drivers' telemetry entry point.

    * ``telemetry=None, verbose=False`` — the shared no-op session.
    * ``telemetry=None, verbose=True``  — console sink only (the historical
      ``verbose`` prints, now uniform across drivers).
    * a :class:`Telemetry` config — a fresh session; ``verbose=True``
      additionally forces the console sink on (back-compat alias).
    * an already-open :class:`TelemetrySession` (or ``NULL_SESSION``) —
      borrowed: the driver records into it but a driver-side ``close`` is a
      no-op, so one session can observe several runs and the caller decides
      when it ends.
    """
    if isinstance(telemetry, NullSession):
        return telemetry
    if isinstance(telemetry, TelemetrySession):
        return _BorrowedSession(telemetry)
    if telemetry is None:
        if not verbose:
            return NULL_SESSION
        telemetry = Telemetry(console=True)
    if not telemetry.enabled:
        return NULL_SESSION
    if verbose and not telemetry.console:
        telemetry = dataclasses.replace(telemetry, console=True)
    return telemetry.session(run=run, **meta)


__all__ = ["DISABLED", "NULL_SESSION", "NullSession", "Telemetry", "TelemetrySession",
           "resolve_telemetry"]
