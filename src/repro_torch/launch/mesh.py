"""Process groups for the cluster axis over several cards (the counterpart
of the reference's ``repro/launch/mesh.py``).

The reference lays Pigeon-SL's clusters over a mesh axis ("pod"): each pod
trains its clusters, and the only cross-pod collectives are the R-sized
loss all-gather and the winner's reduction.  The port runs the same
program in SPMD form with ``torch.distributed``: one process a card, every
rank calling the same driver with the same arguments and returning the same
result (``core/runner.py``, ``placement="sharded"``).  NCCL is the backend
on the card, gloo on the CPU.

Starting a group:

  * :func:`init_group` — join the default process group: from torchrun's
    environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``), from explicit
    arguments, or, with neither, a group of one through a file store (one
    card, or an in-process audit).  Under NCCL each rank binds
    ``torch.cuda.set_device(local_rank)`` before anything launches: the
    kernels launch onto the current device's stream.
  * :func:`spawn` — ``world`` processes on this host, each joining one
    group through a ``file://`` store in a fresh temporary directory (no
    TCP port), each running ``target(*args)``; returns the ranks' results in
    rank order.  The children are joined with a deadline and killed when it
    passes, so a hung collective fails its caller instead of hanging it.

The reference's production mesh with its data and model axes (tensor and
expert parallelism) has no counterpart yet: :func:`make_production_mesh`
and :func:`data_axes` raise.
"""
from __future__ import annotations

import contextlib
import datetime
import os
import queue as queue_mod
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from ..core.protocol import MULTI_CARD_SLICE

#: seconds a collective may wait before the group raises
GROUP_TIMEOUT_S = 120.0

#: the file store directory of a group of one this process started
_STORE_DIRS: List[str] = []


def default_backend() -> str:
    """NCCL where a CUDA card is visible, gloo otherwise."""
    return "nccl" if torch.cuda.is_available() else "gloo"


def init_group(backend: Optional[str] = None, *, rank: Optional[int] = None,
               world_size: Optional[int] = None, init_method: Optional[str] = None,
               timeout_s: float = GROUP_TIMEOUT_S) -> int:
    """Join the default process group and return this process's rank.

    Without ``rank``/``world_size`` they come from torchrun's environment
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``; ``init_method`` then defaults
    to ``env://``); with no such environment either, the group is one rank
    through a file store in a fresh temporary directory.  Under NCCL the
    rank binds its card (``LOCAL_RANK``, else the rank, modulo the visible
    cards) before the group starts."""
    backend = backend or default_backend()
    env = os.environ
    local_rank = None
    if rank is None and "RANK" in env and "WORLD_SIZE" in env:
        rank, world_size = int(env["RANK"]), int(env["WORLD_SIZE"])
        local_rank = int(env.get("LOCAL_RANK", rank))
        init_method = init_method or "env://"
    if rank is None:
        rank, world_size = 0, 1
    if init_method is None:
        if world_size != 1:
            raise ValueError("init_group with world_size > 1 needs an init_method "
                             "(or torchrun's environment)")
        _STORE_DIRS.append(tempfile.mkdtemp(prefix="repro_group_"))
        init_method = "file://" + os.path.join(_STORE_DIRS[-1], "store")
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("backend='nccl' needs a CUDA card")
        local = rank if local_rank is None else local_rank
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return rank


def close_group() -> None:
    """Leave the default process group (and forget the meshes built on it)."""
    from ..core.runner import forget_meshes
    forget_meshes()
    if dist.is_initialized():
        dist.destroy_process_group()
    while _STORE_DIRS:
        shutil.rmtree(_STORE_DIRS.pop(), ignore_errors=True)


@contextlib.contextmanager
def group_of_one(backend: Optional[str] = None):
    """This process as a group of one rank for the block (the sharded
    placement on one card, or on the CPU), unless a group is already up;
    a group it started it closes."""
    started = not dist.is_initialized()
    if started:
        init_group(backend)
    try:
        yield
    finally:
        if started:
            close_group()


def _child(rank: int, world: int, backend: str, init_method: str, timeout_s: float,
           threads: Optional[int], target: Callable, args: tuple, results) -> None:
    """One spawned rank: join the group, run the target, report."""
    try:
        if threads is not None:
            torch.set_num_threads(threads)
        init_group(backend, rank=rank, world_size=world, init_method=init_method,
                   timeout_s=timeout_s)
        try:
            out = target(*args)
        finally:
            close_group()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))   # the parent raises it
        raise


def spawn(target: Callable, world: int, backend: Optional[str] = None,
          deadline_s: float = 300.0, args: Sequence[Any] = (),
          threads: Optional[int] = None) -> List[Any]:
    """Run ``target(*args)`` on ``world`` spawned ranks of one group and
    return their results in rank order.

    ``target`` must pickle (a module-level function) and so must its
    results.  The group's store is a file in a fresh temporary directory,
    removed afterwards; its collectives time out a little inside
    ``deadline_s``.  A rank that raises, dies or outlives the deadline ends
    every rank (killed) and raises here: a ``RuntimeError`` carrying the
    failing rank's traceback, or a ``TimeoutError``.  ``threads`` sets each
    rank's intra-op threads."""
    import torch.multiprocessing as mp
    backend = backend or default_backend()
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    store_dir = tempfile.mkdtemp(prefix="repro_spawn_")
    init_method = "file://" + os.path.join(store_dir, "store")
    timeout_s = max(1.0, 0.9 * deadline_s)
    procs = [ctx.Process(target=_child, args=(r, world, backend, init_method, timeout_s,
                                              threads, target, tuple(args), results),
                         daemon=True)
             for r in range(world)]
    end = time.monotonic() + deadline_s
    out: dict = {}
    try:
        for p in procs:
            p.start()
        while len(out) < world:
            try:
                rank, ok, value = results.get(timeout=0.2)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode is not None]
                if dead:
                    # a rank may exit just after putting its result: drain once more
                    try:
                        rank, ok, value = results.get(timeout=1.0)
                    except queue_mod.Empty:
                        raise RuntimeError(f"rank {dead[0]} of {world} died with exit "
                                           f"code {procs[dead[0]].exitcode}") from None
                elif time.monotonic() > end:
                    raise TimeoutError(f"{world} ranks did not finish within "
                                       f"{deadline_s:.0f} s (a hung collective?)")
                else:
                    continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world} failed:\n{value}")
            out[rank] = value
        for p in procs:
            p.join(timeout=max(0.0, end - time.monotonic()) + 5.0)
        return [out[r] for r in range(world)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=5.0)
        results.close()
        shutil.rmtree(store_dir, ignore_errors=True)


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's ("pod",) "data", "model" production mesh: its data
    and model axes need tensor parallelism, which the port has not yet."""
    raise NotImplementedError(f"make_production_mesh (the data and model axes) comes with "
                              f"{MULTI_CARD_SLICE}")


def data_axes(mesh) -> tuple:
    """The reference's batch-carrying axes of a production mesh."""
    raise NotImplementedError(f"data_axes (the data and model axes) comes with "
                              f"{MULTI_CARD_SLICE}")


__all__ = ["GROUP_TIMEOUT_S", "close_group", "data_axes", "default_backend", "group_of_one",
           "init_group", "make_production_mesh", "spawn"]
