"""The persistent cache of the port's compiled kernels.

The reference (``repro/core/compile_cache.py``) points JAX's on-disk
compilation cache at a directory and counts its hits and misses.  The port
runs eagerly; what it compiles is its CUDA kernel libraries
(``kernels/build.py``), one ``nvcc`` build a ``csrc/*.cu`` source.  Each
library is named by a hash of its source, the headers it includes and the
flags, so a directory of them is safe to share between processes and hosts:
an edited source gets a new name, and a library is moved into place only
once complete.  ``enable_compile_cache(path)`` points the builds at such a
directory; without it they go to ``build/repro_torch_kernels/`` at the
repository root.

``compile_cache_stats()`` reports the reference's four keys: the directory
in use, the libraries in it, and this process's hits (a library found
there the first time the process needed it) and misses (a library ``nvcc``
built).
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional

from ..kernels import build

ENV_VAR = "REPRO_COMPILE_CACHE"


def enable_compile_cache(path: Optional[str] = None) -> Optional[str]:
    """Put the kernel libraries in ``path`` from now on.

    ``path=None`` falls back to the ``REPRO_COMPILE_CACHE`` environment
    variable; if that is unset too, this is a no-op returning ``None`` (the
    libraries stay in ``build/repro_torch_kernels/``).  Returns the
    directory in use otherwise.  Idempotent: a repeated call re-points the
    directory; a library already loaded stays loaded."""
    d = path if path is not None else os.environ.get(ENV_VAR)
    if not d:
        return None
    build.set_build_dir(d)
    return d


def compile_cache_stats() -> Dict[str, Any]:
    """The cache's state for telemetry: the directory the libraries go to,
    the number of libraries in it, and this process's hits and misses."""
    d = build.BUILD_DIR
    entries = 0
    if d.is_dir():
        entries = sum(1 for p in d.iterdir() if p.is_file() and p.suffix == ".so")
    return {"persistent_cache_dir": str(d),
            "persistent_cache_entries": entries,
            "persistent_cache_hits": build.CACHE["hits"],
            "persistent_cache_misses": build.CACHE["misses"]}


__all__ = ["ENV_VAR", "compile_cache_stats", "enable_compile_cache"]
