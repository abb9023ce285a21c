"""Metrics registry: per-round gauges and run counters.

Host-only and fetch-free: every value recorded arrives as a Python number
the driver has already fetched (the batched path's one fetch a round or a
block, and the CommMeter accounting), so recording adds no device sync.

``round_gauges`` maps one History record into the gauges of a ``round``
event; ``jit_cache_stats`` is the port's counterpart of the reference's
compiled-program census: PyTorch runs eagerly, so what the port has to
report is its kernel libraries — the ones loaded, the seconds each build in
this process took, the persistent cache's directory, entries, hits and
misses (``core/compile_cache.py``) — and a snapshot of the launch counters.
"""
from __future__ import annotations

from typing import Any, Dict, Optional


class MetricsRegistry:
    """Counters accumulate across the run; gauges hold the latest value."""

    def __init__(self) -> None:
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}

    def inc(self, name: str, value: float = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + value

    def set(self, name: str, value: float) -> None:
        self.gauges[name] = value

    def snapshot(self) -> Dict[str, Any]:
        return {"counters": dict(self.counters), "gauges": dict(self.gauges)}

    def observe_round(self, rec: Dict[str, Any]) -> None:
        """Fold one driver round record into the counters."""
        self.inc("rounds")
        if rec.get("accepted", True):
            self.inc("rounds_accepted")
        self.inc("detections", int(rec.get("detections", 0)))
        if rec.get("selected_honest"):
            self.inc("honest_selections")


_ROUND_FIELDS = ("selected", "accepted", "detections", "selected_honest",
                 "honest_cluster_exists", "test_acc", "train_loss",
                 "val_losses", "train_losses")


def round_gauges(rec: Dict[str, Any],
                 feeder_depth: Optional[int] = None) -> Dict[str, Any]:
    """The gauges of one round out of a History record: the selection
    outcome, losses, the CommMeter deltas (the drivers reset the meter each
    round) and the feeder's queue depth."""
    out: Dict[str, Any] = {k: rec[k] for k in _ROUND_FIELDS if k in rec}
    if "comm" in rec:
        out["comm"] = dict(rec["comm"])
    if feeder_depth is not None:
        out["feeder_depth"] = int(feeder_depth)
    return out


def pool_gauges(t0s: Dict[str, int], k: int, lanes: int,
                jobs_done: int, jobs_total: int) -> Dict[str, Any]:
    """The gauges of a job pool's block: which jobs held a lane (and each
    one's first round), the block length K, the lane count and the queue's
    progress — scheduler state the pool's driver already holds."""
    return {"jobs": dict(t0s), "k": int(k), "lanes": int(lanes),
            "active": len(t0s), "jobs_done": int(jobs_done),
            "jobs_total": int(jobs_total)}


def jit_cache_stats() -> Dict[str, Any]:
    """The port's kernel libraries: ``libraries`` (loaded in this process),
    ``build_seconds`` (each build this process ran), ``launches`` (a
    snapshot of ``kernels.build.LAUNCHES``) and ``persistent_cache_*`` (the
    library directory, its entries, this process's hits and misses, from
    :func:`repro_torch.core.compile_cache.compile_cache_stats`).  Host-side
    only."""
    from ..core.compile_cache import compile_cache_stats
    from ..kernels import build
    return {"libraries": sorted(build._LOADED),
            "build_seconds": {k: round(v, 6) for k, v in build.BUILD_SECONDS.items()},
            "launches": dict(build.LAUNCHES), **compile_cache_stats()}


__all__ = ["MetricsRegistry", "jit_cache_stats", "pool_gauges", "round_gauges"]
