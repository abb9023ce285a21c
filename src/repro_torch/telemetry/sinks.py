"""Telemetry sinks: where events go.

Every sink consumes plain-dict events (spans, per-round metric records, run
start/end markers):

* :class:`JSONLSink` — one JSON object per line, crash-tolerant append:
  each event is flushed as a complete line, an existing file whose tail was
  torn by a crash is newline-healed before new events are appended, and
  :func:`read_jsonl` skips torn or unparseable lines instead of failing;
* :class:`MemorySink` — an in-process event list, for tests;
* :class:`ConsoleSink` — one uniform line per protocol round (what the
  drivers' ``verbose=True`` turns on).
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List

import numpy as np
import torch


def materialize(event: Any) -> Any:
    """An event tree as Python values, ready for ``json.dumps``.  Numpy
    arrays and CPU tensors become (nested) lists or scalars.  The drivers
    emit only values they have already fetched, so a CUDA tensor here is a
    caller's mistake and raises: a sink never adds a device-to-host copy of
    its own."""
    if isinstance(event, dict):
        return {k: materialize(v) for k, v in event.items()}
    if isinstance(event, (list, tuple)):
        return [materialize(v) for v in event]
    if isinstance(event, (str, bool, int, float)) or event is None:
        return event
    if isinstance(event, np.generic):
        return event.item()
    if isinstance(event, torch.Tensor):
        if event.device.type != "cpu":
            raise TypeError(f"telemetry event holds a tensor on {event.device}: "
                            f"fetch it before emitting it")
        return event.item() if event.ndim == 0 else event.tolist()
    if isinstance(event, np.ndarray):
        return event.item() if event.ndim == 0 else event.tolist()
    return event


def _jsonable(o: Any) -> Any:
    """Last-resort encoder for types that survive :func:`materialize`."""
    if hasattr(o, "tolist"):
        return o.tolist()
    return str(o)


class Sink:
    """Event consumer.  ``emit`` is called from several threads in turn (the
    session serialises the calls under its lock)."""

    def emit(self, event: Dict[str, Any]) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class MemorySink(Sink):
    """Collects events in a list (``sink.events``)."""

    def __init__(self) -> None:
        self.events: List[Dict[str, Any]] = []

    def emit(self, event: Dict[str, Any]) -> None:
        self.events.append(event)

    def of(self, kind: str) -> List[Dict[str, Any]]:
        """Events of one kind (``event == kind``)."""
        return [e for e in self.events if e.get("event") == kind]


class JSONLSink(Sink):
    """Append-only JSONL event log.  Every event is one complete, flushed
    line, so a crash tears at most the line in flight; on open, a file whose
    last byte is not a newline is healed with one, so the torn fragment
    stays a line of its own (the reader skips it)."""

    def __init__(self, path: str, fsync: bool = False):
        self.path = path
        self._fsync = fsync
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        needs_heal = False
        if os.path.exists(path) and os.path.getsize(path) > 0:
            with open(path, "rb") as f:
                f.seek(-1, os.SEEK_END)
                needs_heal = f.read(1) != b"\n"
        self._f = open(path, "a", encoding="utf-8")
        if needs_heal:
            self._f.write("\n")
            self._f.flush()

    def emit(self, event: Dict[str, Any]) -> None:
        self._f.write(json.dumps(materialize(event), default=_jsonable) + "\n")
        self._f.flush()
        if self._fsync:
            os.fsync(self._f.fileno())

    def close(self) -> None:
        if not self._f.closed:
            self._f.flush()
            self._f.close()


def read_jsonl(path: str) -> List[Dict[str, Any]]:
    """The complete events of a JSONL log, in file order; torn or
    unparseable lines are skipped."""
    events: List[Dict[str, Any]] = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                events.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    return events


class ConsoleSink(Sink):
    """One line per protocol round; fields a driver's record lacks (vanilla
    SL has no selection) are left out."""

    def __init__(self, stream=None):
        self._stream = stream

    def emit(self, event: Dict[str, Any]) -> None:
        if event.get("event") != "round":
            return
        parts = [f"[{event.get('run', '?')}] t={int(event.get('t', -1)):3d}"]
        acc = event.get("test_acc")
        parts.append(f"acc={acc:.4f}" if acc is not None else "acc=nan")
        for key, tag in (("selected", "sel"), ("selected_honest", "honest"),
                         ("accepted", "accepted"), ("detections", "det")):
            if key in event:
                parts.append(f"{tag}={event[key]}")
        if "train_loss" in event:
            parts.append(f"tloss={event['train_loss']:.4f}")
        if "val_losses" in event:
            parts.append("vloss=[" + ",".join(f"{v:.4f}" for v in event["val_losses"])
                         + "]")
        print(" ".join(parts), flush=True, file=self._stream)


class MultiSink(Sink):
    def __init__(self, sinks):
        self.sinks = list(sinks)

    def emit(self, event: Dict[str, Any]) -> None:
        for s in self.sinks:
            s.emit(event)

    def close(self) -> None:
        for s in self.sinks:
            s.close()


__all__ = ["ConsoleSink", "JSONLSink", "MemorySink", "MultiSink", "Sink", "materialize",
           "read_jsonl"]
