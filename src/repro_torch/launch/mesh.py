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

The data and model axes (tensor and expert parallelism, the reference's
``make_production_mesh``): :func:`make_mesh` lays a ``(pod,) data, model``
mesh over the group's ranks (:class:`Mesh`: a process group a slice of
each axis), :func:`make_production_mesh` the reference's 16 x 16 or 2 x 16
x 16 (abstract without a group, as the dry run reads it under
:func:`fake_group`), :func:`data_axes` its batch axes.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import math
import os
import queue as queue_mod
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from ..core.runner import CLUSTER_AXIS, ClusterMesh

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


#: the reference's production mesh: one pod of 16 x 16, or two
PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh(ClusterMesh):
    """A mesh over the ranks of the default group, row-major (the last axis
    fastest, so a ``model`` group is consecutive ranks, one host's cards),
    with a process group a ranks' slice of each axis (``groups``; None for
    an axis of size 1).  Built by :func:`make_mesh` (a collective); an
    abstract mesh (no group: the dry run's shapes) has no groups.

    The round runner's cluster axis is :meth:`pod_view`, a
    :class:`~repro_torch.core.runner.ClusterMesh` over this rank's ``pod``
    group; the parallel model's axes are :meth:`parallel`."""
    groups: Dict[str, Any] = dataclasses.field(default_factory=dict)
    _subgroups: Dict[Any, Any] = dataclasses.field(default_factory=dict)

    def group_of(self, axis: str):
        return self.groups.get(axis)

    def parallel(self, cluster_axis: Optional[str] = None):
        """This rank's ``models.parallel.Parallel`` view of the batch and
        ``model`` axes: the data axis spans ``pod`` and ``data`` (the
        reference's ``batch_shardings``), less ``cluster_axis`` where the
        round lays its clusters on it (a ``StackedModel``'s view)."""
        from ..models.parallel import Parallel
        shape = self.shape
        axes = batch_axes(self, cluster_axis)
        size, rank = 1, 0
        for ax in axes:
            size, rank = size * shape[ax], rank * shape[ax] + self.coord(ax)
        return Parallel(model_size=shape.get("model", 1), model_rank=self._coord("model"),
                        model_group=self.groups.get("model"), data_size=size, data_rank=rank,
                        data_group=self._group_over(axes), mesh=self,
                        data_axes=axes or ("data",))

    def _coord(self, axis: str) -> int:
        return self.coord(axis) if axis in self.axis_names else 0

    def _group_over(self, axes: Sequence[str]):
        """The group over ``axes`` (None where they span one rank)."""
        live = [ax for ax in axes if self.shape[ax] > 1]
        if not live:
            return None
        return self.groups.get(live[0] if len(live) == 1 else ",".join(live))

    def panel_group(self, share: int, axes: Sequence[str] = ()):
        """The group of the ranks that split one set of KV heads' sequence
        (``models.parallel.cache_panels``): the ``share`` consecutive
        ``model`` ranks that hold them, times every coordinate of ``axes``;
        a collective the first time, None on an abstract mesh."""
        key = (share, tuple(axes))
        if key not in self._subgroups:
            self._subgroups[key] = None
            if self.groups:
                self._subgroups[key], _ = dist.new_subgroups_by_enumeration(
                    _partition(self.dims, self.axis_names, axes, share))
        return self._subgroups[key]

    def model_subgroup(self, share: int):
        """The group of the ``share`` consecutive ``model`` ranks this rank
        is among (a KV head's ranks); a collective the first time."""
        if share not in self._subgroups:
            if not self.groups:
                self._subgroups[share] = None
            else:
                lists = [list(range(start, start + share))
                         for start in range(0, self.size, share)]
                self._subgroups[share], _ = dist.new_subgroups_by_enumeration(lists)
        return self._subgroups[share]

    def pod_view(self) -> ClusterMesh:
        """The ``("pod",)`` mesh the round runner lays its cluster axis on:
        this rank's index along ``pod`` and the group of the ranks with its
        ``data`` and ``model`` coordinates."""
        if CLUSTER_AXIS not in self.axis_names:
            return ClusterMesh((CLUSTER_AXIS,), (1,), 0, 1, None)
        p = self.shape[CLUSTER_AXIS]
        return ClusterMesh((CLUSTER_AXIS,), (p,), self.coord(CLUSTER_AXIS), p,
                           self.groups.get(CLUSTER_AXIS))


def _axis_lists(dims: Sequence[int], i: int) -> List[List[int]]:
    """The rank lists of axis ``i``'s slices of a row-major mesh."""
    stride = math.prod(dims[i + 1:])
    size = math.prod(dims)
    lists = []
    for r in range(size):
        if (r // stride) % dims[i] == 0:
            lists.append([r + j * stride for j in range(dims[i])])
    return lists


def _partition(dims: Sequence[int], axes: Sequence[str], over: Sequence[str],
               share: int = 1) -> List[List[int]]:
    """The rank lists of a row-major mesh whose members differ only along
    the axes ``over`` (and, with ``share`` > 1, within a block of ``share``
    consecutive ``model`` coordinates), each in rank order."""
    classes: Dict[tuple, List[int]] = {}
    for r in range(math.prod(dims)):
        coords, rest = [], r
        for d in reversed(dims):
            coords.append(rest % d)
            rest //= d
        key = tuple(c // share if ax == "model" else c
                    for ax, c in zip(axes, reversed(coords)) if ax not in over)
        classes.setdefault(key, []).append(r)
    return list(classes.values())


def make_mesh(dims: Sequence[int], axes: Sequence[str]) -> Mesh:
    """The mesh ``dims`` x ``axes`` over the ranks of the default group (a
    collective: every rank builds the same meshes in the same order).  Its
    size must be the group's."""
    from ..core.runner import require_group
    rank, world = require_group()
    dims, axes = tuple(int(d) for d in dims), tuple(axes)
    if len(dims) != len(axes):
        raise ValueError(f"mesh dims {dims} and axes {axes} differ in length")
    if math.prod(dims) != world:
        raise ValueError(f"a mesh of {dims} ({math.prod(dims)} ranks) over a group of "
                         f"{world}: the shapes do not match")
    groups: Dict[str, Any] = {}
    for i, ax in enumerate(axes):
        if dims[i] == 1:
            groups[ax] = None
        elif dims[i] == world:
            groups[ax] = dist.group.WORLD
        else:
            groups[ax], _ = dist.new_subgroups_by_enumeration(_axis_lists(dims, i))
    over = [ax for ax, d in zip(axes, dims) if ax in ("pod", "data") and d > 1]
    if len(over) == 2:
        # a plain model's batch axes: pod and data together
        both = math.prod(d for ax, d in zip(axes, dims) if ax in over)
        groups[",".join(over)] = (dist.group.WORLD if both == world else
                                  dist.new_subgroups_by_enumeration(
                                      _partition(dims, axes, over))[0])
    return Mesh(axes, dims, rank, world, None, groups)


def abstract_mesh(dims: Sequence[int], axes: Sequence[str]) -> Mesh:
    """A mesh of shapes only (no group, no collective): what the shardings
    read."""
    dims = tuple(int(d) for d in dims)
    return Mesh(tuple(axes), dims, 0, math.prod(dims), None, {})


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production mesh, ``("data", "model")`` (16, 16) or
    ``("pod", "data", "model")`` (2, 16, 16).  With no group up it is
    abstract (the dry run's shapes); over a group of that size it is laid
    over its ranks; over a group of another size N the ``model`` axis takes
    every rank, (1, N) or (1, 1, N) (a group of one gives (1, 1))."""
    dims, axes = PRODUCTION[multi_pod]
    if not dist.is_initialized():
        return abstract_mesh(dims, axes)
    world = dist.get_world_size()
    if world != math.prod(dims):
        dims = (1,) * (len(axes) - 1) + (world,)
    return make_mesh(dims, axes)


def data_axes(mesh) -> tuple:
    """Axis names that carry the batch dimension."""
    return tuple(n for n in mesh.axis_names if n in ("pod", "data"))


def batch_axes(mesh, cluster_axis: Optional[str] = None) -> tuple:
    """:func:`data_axes` less the round's ``cluster_axis``."""
    return tuple(n for n in data_axes(mesh) if n != cluster_axis)


@contextlib.contextmanager
def fake_group(world: int, rank: int = 0):
    """This process as rank ``rank`` of a fake process group of ``world``
    ranks (``torch.testing``'s ``FakeStore`` and backend ``"fake"``: every
    collective returns at once, nothing moves): the dry run's stand-in for
    the production mesh's 256 or 512 cards.  Closed after the block."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("fake_group needs no process group to be up")
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world)
    try:
        yield
    finally:
        close_group()


__all__ = ["GROUP_TIMEOUT_S", "Mesh", "PRODUCTION", "abstract_mesh", "batch_axes",
           "close_group", "data_axes", "default_backend", "fake_group", "group_of_one",
           "init_group", "make_mesh", "make_production_mesh", "spawn"]
