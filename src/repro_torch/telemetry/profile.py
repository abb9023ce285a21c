"""Opt-in ``torch.profiler`` windows.

Spans say where a round's wall-clock time goes; the profiler says what the
card did inside the step.  The hook profiles a window of rounds (a whole run
would give gigabytes of trace) and exports one Chrome trace into
``trace_dir`` when the window closes.  A profiler that cannot start warns
once and profiling stops for the run; it never raises.

Drivers call :meth:`ProfileHook.tick` once at the top of every round (or
block); :meth:`close` ends a window a short run left open.
"""
from __future__ import annotations

import os
import warnings
from typing import Optional, Tuple

DEFAULT_WINDOW = (1, 2)   # round 1 only: after round 0's first-call set-up


class ProfileHook:
    """Profiles rounds ``t`` with ``start <= t < stop`` (CPU and, where
    there is one, CUDA activity) into ``trace_dir/trace_<start>_<stop>.json``."""

    def __init__(self, trace_dir: str, rounds: Optional[Tuple[int, int]] = None):
        self.trace_dir = trace_dir
        self.start, self.stop = rounds if rounds is not None else DEFAULT_WINDOW
        self._prof = None
        self._broken = False

    def tick(self, t: int) -> None:
        """Advance the window to round ``t``, before any of its work is
        queued."""
        if self._broken:
            return
        if self._prof is not None and t >= self.stop:
            self._stop()
        if self._prof is None and self.start <= t < self.stop:
            self._start()

    def _start(self) -> None:
        try:
            import torch
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            prof = profile(activities=acts)
            prof.__enter__()
            self._prof = prof
        except Exception as e:  # noqa: BLE001 — profiling is best-effort
            self._broken = True
            warnings.warn(f"telemetry: torch.profiler unavailable ({type(e).__name__}: "
                          f"{e}); profiling disabled for this run", stacklevel=3)

    def _stop(self) -> None:
        prof, self._prof = self._prof, None
        try:
            prof.__exit__(None, None, None)
            os.makedirs(self.trace_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(
                self.trace_dir, f"trace_{self.start}_{self.stop}.json"))
        except Exception as e:  # noqa: BLE001
            self._broken = True
            warnings.warn(f"telemetry: torch.profiler export failed ({type(e).__name__}: "
                          f"{e})", stacklevel=3)

    def close(self) -> None:
        if self._prof is not None:
            self._stop()


__all__ = ["DEFAULT_WINDOW", "ProfileHook"]
