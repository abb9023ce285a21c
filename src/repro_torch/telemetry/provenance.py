"""Run provenance: the environment stamp every trace carries.

A time without the software and hardware that produced it cannot be
compared across commits or machines, and an H100 may be capped below its
700 W, when it runs slower under load.  The stamp records the torch, CUDA
and cuDNN versions, the device's name and count, the card's name and power
limit as ``nvidia-smi --query-gpu=name,power.limit`` reports them, the CPU
count, the repository's git revision and a timestamp.  Every lookup falls
back to ``None``: provenance never breaks a run.
"""
from __future__ import annotations

import os
import platform
import shutil
import subprocess
import sys
import time
from functools import lru_cache
from typing import Any, Dict, List, Optional


def _run(cmd: List[str], cwd: Optional[str] = None) -> Optional[str]:
    try:
        return subprocess.run(cmd, cwd=cwd, capture_output=True, text=True,
                              timeout=10, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None


@lru_cache(maxsize=1)
def _git_sha() -> Optional[str]:
    """The checkout's revision (``-dirty`` when it has local changes); None
    outside a git checkout."""
    root = os.path.dirname(os.path.abspath(__file__))
    sha = _run(["git", "rev-parse", "HEAD"], cwd=root)
    if not sha:
        return None
    dirty = _run(["git", "status", "--porcelain"], cwd=root)
    return sha + ("-dirty" if dirty else "")


@lru_cache(maxsize=1)
def gpu_power() -> Optional[List[Dict[str, str]]]:
    """``[{"name", "power_limit"}]`` per card from ``nvidia-smi``; None
    where there is no ``nvidia-smi``."""
    if shutil.which("nvidia-smi") is None:
        return None
    out = _run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"])
    if out is None:
        return None
    cards = []
    for line in out.splitlines():
        name, _, limit = line.rpartition(",")
        cards.append({"name": name.strip(), "power_limit": limit.strip()})
    return cards


@lru_cache(maxsize=1)
def _static_provenance() -> Dict[str, Any]:
    out: Dict[str, Any] = {
        "python": sys.version.split()[0],
        "platform": platform.platform(),
        "cpu_count": os.cpu_count(),
        "git_sha": _git_sha(),
    }
    try:
        import torch
        out["torch"] = torch.__version__
        out["cuda"] = torch.version.cuda
        out["cudnn"] = (torch.backends.cudnn.version()
                        if torch.backends.cudnn.is_available() else None)
        cuda = torch.cuda.is_available()
        out["backend"] = "cuda" if cuda else "cpu"
        out["device_kind"] = torch.cuda.get_device_name(0) if cuda else None
        out["device_count"] = torch.cuda.device_count() if cuda else 0
    except Exception:  # noqa: BLE001 — provenance must never break a run
        out.setdefault("torch", None)
    out["gpus"] = gpu_power()
    return out


def provenance(**extra: Any) -> Dict[str, Any]:
    """The environment stamp; the lookups are cached, the timestamp (epoch
    seconds and UTC ISO) is fresh per call."""
    out = dict(_static_provenance())
    now = time.time()
    out["timestamp"] = now
    out["timestamp_utc"] = time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(now))
    out.update(extra)
    return out


__all__ = ["gpu_power", "provenance"]
