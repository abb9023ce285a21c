"""Span tracer: nested phase timing on the monotonic clock, with explicit
device fences.

A :class:`Tracer` produces :class:`Span` records — name, duration on
``time.perf_counter``, nesting path and thread — and hands each finished
span to an ``emit`` callback (the session's sinks).  Spans nest per thread
(the stack lives in ``threading.local``), so the round feeder's thread
traces its assembly without interleaving with the main thread's spans.

CUDA work is queued, not run, when Python returns, so a span around
``runner.accept(...)`` measures only the queueing unless it waits for the
card.  :meth:`Span.fence` records a ``torch.cuda.Event`` on the current
stream of each CUDA tensor it is given, at the moment it is called; the
span's exit synchronizes those events before it reads the clock.  The card's
work is then charged to the span that queued it, and the next span (the
fetch) measures only its own cost.  A fence waits; it copies nothing.  On
the CPU there is nothing to wait for, and the null span fences nothing.

:class:`Stopwatch` is the plain monotonic timer of the launch scripts.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List

import torch


class Stopwatch:
    """``with Stopwatch() as sw: ...`` then read ``sw.elapsed`` (seconds on
    the ``perf_counter`` clock)."""

    def __enter__(self) -> "Stopwatch":
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.elapsed = time.perf_counter() - self.t0


def _cuda_tensors(tree: Any, out: List[torch.Tensor]) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        if tree.device.type == "cuda":
            out.append(tree)
    elif isinstance(tree, dict):
        for v in tree.values():
            _cuda_tensors(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _cuda_tensors(v, out)
    return out


class Span:
    """One live span, created by :meth:`Tracer.span` and used as a context
    manager."""

    __slots__ = ("name", "attrs", "_tracer", "_t0", "_events")

    def __init__(self, tracer: "Tracer", name: str, attrs: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self._events: List[torch.cuda.Event] = []

    def fence(self, *tensors: Any) -> None:
        """Charge the card's work that produces ``tensors`` (tensors or
        lists/tuples/dicts of them) to this span: an event recorded now on
        each CUDA tensor's current stream, synchronized at exit."""
        seen = set()
        for t in _cuda_tensors(tensors, []):
            stream = torch.cuda.current_stream(t.device)
            if stream in seen:
                continue
            seen.add(stream)
            ev = torch.cuda.Event()
            ev.record(stream)
            self._events.append(ev)

    def __enter__(self) -> "Span":
        self._tracer._push(self.name)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        for ev in self._events:
            ev.synchronize()
        dur = time.perf_counter() - self._t0
        path, depth = self._tracer._pop()
        event = {"event": "span", "name": self.name, "path": path,
                 "depth": depth, "dur_s": dur,
                 "thread": threading.current_thread().name}
        if exc_type is not None:
            event["error"] = exc_type.__name__
        event.update(self.attrs)
        self._tracer._emit(event)


class Tracer:
    """Factory of nested spans.  ``emit`` receives one dict per finished
    span (children before parents).  Each thread nests on its own."""

    def __init__(self, emit: Callable[[Dict[str, Any]], None]):
        self._emit = emit
        self._local = threading.local()

    def _stack(self) -> List[str]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _push(self, name: str) -> None:
        self._stack().append(name)

    def _pop(self) -> tuple:
        stack = self._stack()
        path = "/".join(stack)
        stack.pop()
        return path, len(stack)

    def span(self, name: str, **attrs: Any) -> Span:
        return Span(self, name, attrs)


class NullSpan:
    """The disabled tracer's span: every operation is a no-op."""

    __slots__ = ()

    def fence(self, *tensors: Any) -> None:
        pass

    def __enter__(self) -> "NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass


NULL_SPAN = NullSpan()


class NullTracer:
    __slots__ = ()

    def span(self, name: str, **attrs: Any) -> NullSpan:
        return NULL_SPAN


NULL_TRACER = NullTracer()

__all__ = ["NULL_SPAN", "NULL_TRACER", "NullSpan", "NullTracer", "Span", "Stopwatch",
           "Tracer"]
