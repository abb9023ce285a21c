"""Kernel entries as seen by an op counter.

Each public entry of ``kernels/ops.py`` (and the backward of each kernel's
``autograd.Function``) runs inside :func:`entry`, which tells the innermost
observer (``launch/op_analysis.py``'s counter) the kernel's name and
operands.  The counter then counts the call as one operation whose work
comes from ``launch/roofline.py``'s formula for that kernel, and does not
count the operations inside it (the plain version's on the CPU, the meta
rule's empty outputs on the ``meta`` device).  With no observer installed
an entry costs one list test.
"""
from __future__ import annotations

import contextlib
from typing import Any, List

#: the installed observers, innermost last; each has ``kernel(name,
#: operands, config)``, a context manager
OBSERVERS: List[Any] = []


@contextlib.contextmanager
def entry(name: str, *operands, **config):
    """Run the body as kernel ``name`` on ``operands`` (its tensors, in the
    order ``launch.roofline``'s work function for ``name`` takes them) with
    ``config`` (window, causal, format, ...)."""
    if not OBSERVERS:
        yield
        return
    with OBSERVERS[-1].kernel(name, operands, config):
        yield


def is_meta(*tensors) -> bool:
    """True where a tensor lies on the ``meta`` device (shapes and dtypes,
    no storage): the meta rule's branch."""
    return any(t.device.type == "meta" for t in tensors)


__all__ = ["OBSERVERS", "entry", "is_meta"]
