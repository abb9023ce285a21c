"""The batched Pigeon round: R clusters trained as one stacked program.

Pigeon-SL's global round trains R = N + 1 clusters independently from the
same theta^t, validates each on the shared set D_o, and keeps the best one
that passes the handoff check.  :class:`RoundRunner` runs that round over a
:class:`RoundSpec` — the per-round programs over the cluster-stacked model
(``core/split.py``) — with two entries:

  * :meth:`RoundRunner.candidates` — all R candidate outcomes, selection left
    to the host selector (``selection.select_host``: param-tamper threat
    models, whose handoff noise is drawn per visited candidate);
  * :meth:`RoundRunner.accept` — the fused cascade on the device: train,
    validate, policy score, rank, handoff verify (the ``tamper_check`` kernel
    over all R candidates in one launch) and commit, with nothing read back
    to the host; the caller fetches the one ``(2R + 3,)`` vector;
  * :meth:`RoundRunner.accept_block` — K ``accept`` rounds back to back on
    the device, their K vectors stacked into one ``(K, 2R + 3)`` tensor the
    caller fetches once;
  * :meth:`RoundRunner.sweep` / :meth:`RoundRunner.sweep_block` — S whole
    protocol replicas (seeds) a round, each selecting its own winner, no
    verify stage (the multi-seed sweep);
  * :meth:`RoundRunner.pool_accept_block` — J jobs' ``accept_block`` in
    one program, with a lane mask, one ``(J, K, 2R + 3)`` tensor a block
    (the job pool);
  * :meth:`RoundRunner.round` / :meth:`RoundRunner.round_block` — the
    launch layer's round: train, validate, the policy's winner
    (:func:`masked_argmin`) and :func:`broadcast_winner` into every slot,
    ``(vlosses, sel)`` left on the device; K of them with one stacked
    ``(vlosses (K, R), sels (K,))`` for one fetch.  Under
    ``params_stacked`` the parameters are the stacked model itself, each
    slot training its own (``launch/steps.py``).

The sweep and the pool run the **replica form**: L thetas (``split.replicas``)
trained as one stacked program of L * R slots, replica-major.  Every
stacked layer and wire kernel works per slot (a replica's convolutions run
at its solo round's shapes, ``models/cnn.py::StackedConv``), and the AP
differentiates the sum of the slots' independent losses, so each slot gets
exactly its own gradients: a replica computes what its solo R-slot round
computes.  The policy and the cascade then run on each replica's own R
rows.

The reference maps its per-cluster program over the cluster axis with
``jax.vmap`` (``placement="vmap"``) or lays the axis over a device mesh
(``placement="sharded"``, ``shard_map``).  Here the cluster axis is written
out in the stacked model, the single-card counterpart of the vmap
placement.  The sharded placement lays it over the ranks of a
``torch.distributed`` process group (``launch/mesh.py``; NCCL on the card,
gloo on the CPU), SPMD: every rank calls an entry with the same full
inputs, trains its slice of the clusters (:class:`ClusterMesh`, the largest
divisor of R that fits the group), all-gathers the selection features in
one collective, scores, ranks and verifies alike, and takes the winner from
one masked f32 all-reduce a parameter (:func:`psum_pick`), so every rank
returns the same result.  The sweep lays its S x R grid over a ``("seed",
"pod")`` mesh, the pool its job lanes over the ranks.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from .split import replicas

PLACEMENTS = ("vmap", "sharded")


def check_placement(placement: str) -> None:
    if placement not in PLACEMENTS:
        raise ValueError(f"placement={placement!r} must be one of {PLACEMENTS}")


# ---------------------------------------------------------------------------
# the cluster axis over the ranks of a process group
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class ClusterMesh:
    """The first ``size`` ranks of the default process group laid out as
    the reference's mesh: ``("pod",)`` (the cluster axis) or ``("seed",
    "pod")`` (the sweep's replica grid), row-major, so rank ``i`` sits at
    ``divmod(i, shape["pod"])``.  ``group`` is the process group of those
    ranks (None: the default group, when every rank is in the mesh); a rank
    past ``size`` is outside the mesh, trains nothing, and receives each
    result from rank 0 (:meth:`share`).  Built collectively by every rank
    (:func:`cluster_mesh`, :func:`sweep_mesh`)."""
    axis_names: Tuple[str, ...]
    dims: Tuple[int, ...]
    rank: int
    world: int
    group: Any = None

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.dims))

    @property
    def size(self) -> int:
        n = 1
        for d in self.dims:
            n *= d
        return n

    @property
    def member(self) -> bool:
        return self.rank < self.size

    def coord(self, axis: str) -> int:
        """This rank's index along ``axis`` (ranks outside the mesh: 0)."""
        if not self.member:
            return 0
        i = self.axis_names.index(axis)
        stride = 1
        for d in self.dims[i + 1:]:
            stride *= d
        return (self.rank // stride) % self.dims[i]

    def pod_view(self) -> "ClusterMesh":
        """The mesh the round runner lays its cluster axis on: itself; a
        mesh with ``data``/``model`` axes of size > 1 is a
        ``launch.mesh.Mesh``, whose pod view is its ``pod`` group."""
        auto = {a: d for a, d in self.shape.items()
                if a not in (SEED_AXIS, CLUSTER_AXIS) and d > 1}
        if auto:
            raise ValueError(f"a mesh with the axes {auto} has a process group a slice of "
                             f"each: build it with launch.mesh.make_mesh")
        return self

    def device(self) -> torch.device:
        """Where the group's collectives take their tensors."""
        return (torch.device("cuda", torch.cuda.current_device())
                if dist.get_backend() == "nccl" else torch.device("cpu"))

    def share(self, tensors: Optional[Sequence[torch.Tensor]]) -> List[torch.Tensor]:
        """Rank 0's ``tensors`` on every rank of the default group: the
        mesh's ranks pass theirs (equal to rank 0's) and get them back, a
        rank outside the mesh passes None and gets rank 0's.  With every
        rank in the mesh nothing moves.  Otherwise the shapes and dtypes
        travel first (two small broadcasts), then each tensor."""
        if self.size == self.world:
            return list(tensors)
        dev = self.device()
        if self.member:
            head = [len(tensors)]
            for t in tensors:
                head += [_DTYPES.index(t.dtype), t.dim(), *t.shape]
            n = _host_ints([len(head)], dev)
        else:
            n = torch.zeros(1, dtype=torch.int64, device=dev)
        dist.broadcast(n, 0)
        if self.member:
            h = _host_ints(head, dev)
        else:
            h = torch.zeros(int(n.item()), dtype=torch.int64, device=dev)
        dist.broadcast(h, 0)
        out = []
        if self.member:
            for t in tensors:
                buf = t.contiguous().to(dev)
                dist.broadcast(buf, 0)
                out.append(buf.to(t.device))
            return out
        head = h.tolist()
        at = 1
        for _ in range(head[0]):
            dtype, ndim = _DTYPES[head[at]], head[at + 1]
            shape = head[at + 2:at + 2 + ndim]
            at += 2 + ndim
            buf = torch.empty(shape, dtype=dtype, device=dev)
            dist.broadcast(buf, 0)
            out.append(buf)
        return out


def _host_ints(values: Sequence[int], dev: torch.device) -> torch.Tensor:
    """Host integers on ``dev`` without a synchronizing copy (a pinned
    buffer and a non-blocking copy on the card): a mesh rank sends them
    within a round."""
    t = torch.tensor(values, dtype=torch.int64)
    return t.pin_memory().to(dev, non_blocking=True) if dev.type == "cuda" else t


#: the mesh axes the sharded placement lays out (the reference's
#: ``cluster_axis`` and ``seed_axis`` arguments, which no caller varies)
CLUSTER_AXIS = "pod"
SEED_AXIS = "seed"

_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.int64, torch.int32,
           torch.uint8, torch.bool, torch.float64)

#: meshes built on the current default group, by layout: building one is a
#: collective (``new_group``), so every rank builds each layout once, in the
#: same order
_MESHES: Dict[tuple, ClusterMesh] = {}


def forget_meshes() -> None:
    """Drop the cached meshes (their groups die with the default group)."""
    _MESHES.clear()


def _largest_divisor(n: int, cap: int) -> int:
    """Largest divisor of ``n`` that is <= ``cap`` (>= 1 always: a cap of
    zero or below degrades to the trivial divisor)."""
    d = max(1, min(n, cap))
    while n % d:
        d -= 1
    return d


def sweep_factors(s: int, r: int, n: int) -> Tuple[int, int]:
    """The reference's ``(seed, pod)`` factorisation of ``n`` ranks: the
    (divisor of S) x (divisor of R) covering the most ranks, ties to the
    wider cluster axis, never below the widest 1-D cluster mesh."""
    n = max(1, n)
    best_s, best_r = 1, _largest_divisor(r, n)
    for sn in range(1, min(s, n) + 1):
        if s % sn:
            continue
        rn = _largest_divisor(r, n // sn)
        if sn * rn > best_s * best_r or (sn * rn == best_s * best_r and rn > best_r):
            best_s, best_r = sn, rn
    return best_s, best_r


def require_group() -> Tuple[int, int]:
    """(rank, world size) of the default process group; raises without one."""
    if not dist.is_initialized():
        raise RuntimeError("placement='sharded' runs on a torch.distributed process group "
                           "and none is initialized: start the ranks with "
                           "repro_torch.launch.mesh.spawn or torchrun, or call "
                           "launch.mesh.init_group() (a group of one on one card)")
    return dist.get_rank(), dist.get_world_size()


def _mesh(axis_names: Tuple[str, ...], dims: Tuple[int, ...]) -> ClusterMesh:
    rank, world = require_group()
    key = (axis_names, dims, world)
    mesh = _MESHES.get(key)
    if mesh is None:
        size = 1
        for d in dims:
            size *= d
        group = None if size == world else dist.new_group(list(range(size)))
        mesh = ClusterMesh(axis_names, dims, rank, world, group)
        _MESHES[key] = mesh
    return mesh


def cluster_mesh(r: int, max_devices: Optional[int] = None) -> ClusterMesh:
    """The 1-D ``("pod",)`` mesh over the largest divisor of R that fits the
    group (and ``max_devices``): each rank then carries an equal R_local
    slice of the cluster axis.  Collective: every rank calls it."""
    _, world = require_group()
    n = min(world, max_devices if max_devices else world)
    return _mesh((CLUSTER_AXIS,), (_largest_divisor(r, n),))


def sweep_mesh(s: int, r: int, max_devices: Optional[int] = None) -> ClusterMesh:
    """The 2-D ``("seed", "pod")`` mesh of the multi-seed sweep
    (:func:`sweep_factors` of the group's ranks).  Collective."""
    _, world = require_group()
    n = min(world, max_devices if max_devices else world)
    return _mesh((SEED_AXIS, CLUSTER_AXIS), sweep_factors(s, r, n))


#: the mesh axes the reference leaves to GSPMD ("auto"), which the port runs
#: as data parallelism and as tensor and expert parallelism
AUTO_AXES = ("data", "model")


def check_partial_auto_backend(mesh, manual_axes) -> Dict[str, int]:
    """The reference runs the axes of a mesh beyond the manual ones
    (``"data"``, ``"model"``) as GSPMD-auto; the port runs them as data and
    tensor parallelism (``models/parallel.py``, a ``launch.mesh.Mesh``):
    returns ``{axis: size}`` of those of size > 1.  An axis that is
    neither manual nor one of :data:`AUTO_AXES` raises.  ``mesh`` is a
    :class:`ClusterMesh` or any object with a ``shape`` mapping."""
    manual = {manual_axes} if isinstance(manual_axes, str) else set(manual_axes)
    auto = {a: n for a, n in dict(mesh.shape).items() if a not in manual}
    unknown = sorted(a for a in auto if a not in AUTO_AXES)
    if unknown:
        raise ValueError(f"mesh axes {unknown} are neither the manual {sorted(manual)} nor "
                         f"the auto {list(AUTO_AXES)}")
    return {a: n for a, n in auto.items() if n > 1}


# ---------------------------------------------------------------------------
# shared primitives
# ---------------------------------------------------------------------------

def onehot_select(stacked: nn.Module, sel: torch.Tensor):
    """Slot ``sel`` (0-d int64 on the device) of each parameter of a
    cluster-stacked half, by gathering: a one-hot product would let an Inf
    in a losing slot reach the winner through ``0 * inf``, and ``sel``
    never becomes a Python int (no host sync)."""
    idx = sel.reshape(1)
    return [torch.index_select(p, 0, idx)[0] for p in stacked.parameters()]


@torch.no_grad()
def commit(plain: nn.Module, stacked: nn.Module, sel: torch.Tensor,
           accepted: torch.Tensor) -> nn.Module:
    """Write slot ``sel`` of ``stacked`` into ``plain`` in place where
    ``accepted`` (0-d bool on the device), keep ``plain`` otherwise."""
    for p, w in zip(plain.parameters(), onehot_select(stacked, sel)):
        p.copy_(torch.where(accepted, w, p))
    return plain


@torch.no_grad()
def broadcast_winner(stacked, sel: torch.Tensor):
    """The paper's winner hand-off on stacked halves (a module or a tuple of
    them), in place: every slot of each parameter takes slot ``sel`` (0-d
    int64 on the device; never read on the host).  Returns ``stacked``."""
    for half in (stacked if isinstance(stacked, (tuple, list)) else (stacked,)):
        for p, w in zip(half.parameters(), onehot_select(half, sel)):
            p.copy_(w.expand_as(p))
    return stacked


class LaneVal(NamedTuple):
    """Validation sets one per replica, ``x0 (L, D_o, ...)`` and ``y0 (L,
    D_o)`` (the pool's jobs each bring their own); a plain ``(x0, y0)``
    pair is shared by every slot."""
    x0: torch.Tensor
    y0: torch.Tensor


def slot_val(val, n: int):
    """``(x0, y0)`` for an n-slot stack: a shared set broadcast to every
    slot (x0 a view, y0 as it is), or a :class:`LaneVal` repeated over each
    replica's n / L slots."""
    x0, y0 = val
    if not isinstance(val, LaneVal):
        return x0.expand((n,) + tuple(x0.shape)), y0

    def per_slot(a):
        lanes, rest = a.shape[0], tuple(a.shape[1:])
        return a[:, None].expand((lanes, n // lanes) + rest).reshape((n,) + rest)

    return per_slot(x0), per_slot(y0)


@dataclasses.dataclass(frozen=True)
class RoundSpec:
    """The programs of one Pigeon round over the cluster-stacked model.

    ``train_cluster(theta, inputs) -> (stacked_params, train_aux)`` — every
    cluster's training phase from theta, all R at once; in the replica form
    (``theta`` a list of L thetas, the sweep and the pool) all L * R.

    ``validate(stacked_params, val) -> (vlosses (R,), val_aux)`` — the
    shared-set validation forward (Section III-C); ``val_aux`` holds the
    (R, D_o, d_c) cut activations the tamper check compares against.

    ``combine(stacked_params, inputs) -> stacked_params`` — applied between
    train and validate when set: SplitFed's FedAvg, which turns the train
    phase's per-client lanes into the per-cluster models (the reference's
    ``combine`` runs inside its vmap over clusters; here the cluster axis is
    written out, so the hook reads the (R, M_bar) layout off ``inputs``).

    Selection hooks, for the policies that need them:
    ``validate_sharded(stacked_params, val, k) -> (vlosses, (R, k') shard
    losses, val_aux)``, ``train_summary(train_aux) -> (R,)`` and
    ``message_stats(train_aux) -> (R, M_bar, S)``.

    ``handoff_acts(stacked_params, val) -> (R, D_o, d_c)`` — the
    re-transmission the next round's first clients would produce from each
    candidate's handed-off parameters, which the verify stage holds against
    ``val_aux`` under ``VerifyConfig(recompute=True)``.

    The sharded placement's hooks: ``lead(inputs) -> (R,)`` or ``(L, R)``,
    the leading axes of a round's inputs (the replica form's L lanes, the
    clusters); ``take(inputs, lanes, clusters) -> inputs``, the slice of
    those axes a rank keeps (``lanes`` None for a plain round, ``clusters``
    None for every cluster of each kept lane)."""
    train_cluster: Callable[[Any, Any], Tuple[Any, Any]]
    validate: Callable[[Any, Any], Tuple[torch.Tensor, Any]]
    combine: Optional[Callable[[Any, Any], Any]] = None
    validate_sharded: Optional[Callable] = None
    handoff_acts: Optional[Callable[[Any, Any], torch.Tensor]] = None
    train_summary: Optional[Callable[[Any], torch.Tensor]] = None
    message_stats: Optional[Callable[[Any], torch.Tensor]] = None
    lead: Optional[Callable[[Any], Tuple[int, ...]]] = None
    take: Optional[Callable[[Any, Optional[slice], Optional[slice]], Any]] = None


@dataclasses.dataclass(frozen=True)
class VerifyConfig:
    """The fused cascade's verification stage: compare each candidate's
    handoff transmission with its validation-time activations (the
    ``tamper_check`` kernel) and reject candidates beyond ``tol``.

    ``recompute`` says where the transmission comes from: True re-derives
    it from the handed-off parameters (``RoundSpec.handoff_acts``, one
    batched client forward; B1 then reads two distinct tensors), False
    reuses the validation activations (B1's aliased route, one read).  The
    drivers' fused path runs with False: it runs only without param-tamper
    families (those take the host cascade), where the re-transmission
    equals the validation activations by construction, so the kernel sees
    identical inputs and returns exactly 0.  The masked cascade, the kernel
    and the Table I re-transmission accounting stay live either way."""
    enabled: bool = True
    tol: float = 1e-4
    recompute: bool = True


def _train(spec: RoundSpec, params, inputs):
    """Every cluster's training phase, then the ``combine`` hook."""
    new_p, aux = spec.train_cluster(params, inputs)
    if spec.combine is not None:
        new_p = spec.combine(new_p, inputs)
    return new_p, aux


def cluster_map(spec: RoundSpec, params, inputs, val):
    """Train + validate every cluster: ``(stacked_params, train_aux,
    vlosses (R,), val_aux)`` — the one copy of the round math."""
    new_p, aux = _train(spec, params, inputs)
    vloss, vaux = spec.validate(new_p, val)
    return new_p, aux, vloss, vaux


def _check_shards(spec: RoundSpec, policy) -> None:
    if policy.shard_count > 0 and spec.validate_sharded is None:
        raise ValueError(f"selection policy {policy.name!r} needs sharded "
                         f"validation, which this RoundSpec does not provide")


def _check_stats(spec: RoundSpec, policy) -> None:
    if policy.needs_message_stats and spec.message_stats is None:
        raise ValueError(f"selection policy {policy.name!r} needs "
                         f"transmitted-message statistics, which this "
                         f"RoundSpec does not surface")


def check_policy(spec: RoundSpec, policy) -> None:
    """Raise, before any work, the error a round over ``spec`` would raise
    for a feature ``policy`` scores that the spec lacks."""
    _check_shards(spec, policy)
    _check_stats(spec, policy)


def select_map(spec: RoundSpec, policy, params, inputs, val):
    """:func:`cluster_map` + the per-shard losses ``(R, K)`` when ``policy``
    shards the shared set (else None)."""
    _check_shards(spec, policy)
    if policy.shard_count <= 0:
        return (*cluster_map(spec, params, inputs, val), None)
    new_p, aux = _train(spec, params, inputs)
    vloss, shard_l, vaux = spec.validate_sharded(new_p, val, policy.shard_count)
    return new_p, aux, vloss, vaux, shard_l


def policy_context(spec: RoundSpec, policy, aux, vlosses, shard_losses):
    """The in-program :class:`~repro_torch.selection.ScoreContext`."""
    from ..selection import ScoreContext
    _check_stats(spec, policy)
    stats = spec.message_stats(aux) if policy.needs_message_stats else None
    return ScoreContext(vlosses=vlosses, shard_losses=shard_losses,
                        message_stats=stats)


def policy_scores(policy, ctx):
    """(scores f32, eligibility) with the all-ineligible fallback applied."""
    scores = policy.score(ctx).to(torch.float32)
    elig = policy.eligible(ctx, scores)
    elig = torch.where(elig.any(), elig, torch.ones_like(elig))
    return scores, elig


def masked_argmin(scores: torch.Tensor, elig: torch.Tensor) -> torch.Tensor:
    """The winner rule without verification: argmin with ineligible
    candidates at +inf."""
    return torch.argmin(torch.where(elig, scores, float("inf")))


def _spec_train_summary(spec: RoundSpec, aux, vlosses):
    if spec.train_summary is None:
        return torch.zeros_like(vlosses, dtype=torch.float32)
    return spec.train_summary(aux).to(torch.float32)


def _rows(tree, rows: slice):
    """Rows ``rows`` of every tensor of a train aux (a tensor or a tuple)."""
    if isinstance(tree, tuple):
        return tuple(_rows(t, rows) for t in tree)
    return tree[rows]


def _by_replica(tree, n: int):
    """(n * R, ...) -> (n, R, ...) for every tensor of a train aux."""
    if isinstance(tree, tuple):
        return tuple(_by_replica(t, n) for t in tree)
    return tree.reshape((n, -1) + tuple(tree.shape[1:]))


def replica_scores(spec: RoundSpec, policy, aux, vlosses, shard_losses, n: int):
    """Each of n replicas' ``(rows, scores, eligibility)``: the policy on
    that replica's own R rows of the stacked round's outcome, so its scores
    are the ones its solo round computes (a policy's robust z-scores run
    across the round's clusters and clients)."""
    r = vlosses.shape[0] // n
    out = []
    for l in range(n):
        rows = slice(l * r, (l + 1) * r)
        ctx = policy_context(spec, policy, _rows(aux, rows), vlosses[rows],
                             None if shard_losses is None else shard_losses[rows])
        out.append((rows, *policy_scores(policy, ctx)))
    return out


def sweep_map(spec: RoundSpec, params, inputs, val, policy=None):
    """One global round of S independent protocol replicas as one stacked
    program of S * R slots: per replica, the policy's winner over its own R
    scores (:func:`masked_argmin`; no verify stage and no rollback — the
    winner always carries), written into that replica's theta in place.
    ``params`` is the list of S thetas; ``inputs`` the replica round
    payload (``protocol_round_spec``).  Returns ``(params, train_aux (S, R,
    ...), vlosses (S, R), sels (S,))``, all on the device: nothing is read
    back."""
    from ..selection import ARGMIN
    policy = ARGMIN if policy is None else policy
    thetas = replicas(params)
    new_p, aux, vlosses, _, shard_l = select_map(spec, policy, thetas, inputs, val)
    scored = replica_scores(spec, policy, aux, vlosses, shard_l, len(thetas))
    sels = torch.stack([masked_argmin(scores, elig) for _, scores, elig in scored])
    carry = torch.ones((), dtype=torch.bool, device=vlosses.device)
    for (rows, _, _), sel, theta in zip(scored, sels, thetas):
        for plain, stacked in zip(theta, new_p):
            commit(plain, stacked, rows.start + sel, carry)
    n = len(thetas)
    return thetas, _by_replica(aux, n), vlosses.reshape(n, -1), sels


# ---------------------------------------------------------------------------
# the sharded placement's collectives
# ---------------------------------------------------------------------------

def _gather_rows(x: torch.Tensor, mesh: ClusterMesh) -> torch.Tensor:
    """(n, ...) on each of the mesh's ranks -> (size * n, ...), rank order
    (no gradient flows through a collective)."""
    from ..models.parallel import collective
    return collective("all_gather", x.detach().contiguous(), mesh.group, size=mesh.size)


def _pack(parts: Sequence[Optional[torch.Tensor]], rows: int) -> torch.Tensor:
    """Per-slot features, each leading with ``rows``, as one (rows, F) f32
    matrix: one all-gather carries them all."""
    return torch.cat([p.reshape(rows, -1).to(torch.float32) for p in parts if p is not None],
                     dim=1)


def _unpack(packed: torch.Tensor, parts: Sequence[Optional[torch.Tensor]], lead):
    """:func:`_pack`'s columns back into tensors of leading shape ``lead``
    and each part's own trailing shape and dtype (None stays None)."""
    out, at = [], 0
    for p in parts:
        if p is None:
            out.append(None)
            continue
        tail = tuple(p.shape[1:])
        n = 1
        for d in tail:
            n *= d
        col = packed[..., at:at + n].reshape(tuple(lead) + tail)
        out.append(col > 0.5 if p.dtype == torch.bool else col.to(p.dtype))
        at += n
    return out


def _aux_leaves(aux) -> List[torch.Tensor]:
    return list(aux) if isinstance(aux, tuple) else [aux]


def _aux_tree(leaves: Sequence[torch.Tensor]):
    return leaves[0] if len(leaves) == 1 else tuple(leaves)


def _params(tree) -> List[torch.Tensor]:
    """The parameters of a module, a (gamma, phi) pair or a list of pairs."""
    if isinstance(tree, nn.Module):
        return list(tree.parameters())
    return [p for t in tree for p in _params(t)]


def _slot_pick(stacked: torch.Tensor, mine: torch.Tensor) -> torch.Tensor:
    """This rank's share of the winner of one leaf, in f32: the slot whose
    ``mine`` flag is set, zeros where none is.  ``torch.where`` slot by slot,
    never a product (a losing slot's Inf cannot reach the winner through
    ``0 * inf``), and one slot's f32 temporary at a time."""
    stacked = stacked.detach()
    acc = torch.zeros(stacked.shape[1:], dtype=torch.float32, device=stacked.device)
    for i in range(stacked.shape[0]):
        acc = torch.where(mine[i], stacked[i].to(torch.float32), acc)
    return acc


def psum_pick(stacked_leaves, sel: torch.Tensor, lo: int, mesh: ClusterMesh):
    """The global winner ``sel`` of each leaf out of this rank's slots
    ``lo ..``: one masked f32 all-reduce (SUM) a leaf, cast back to the
    leaf's dtype, leaf by leaf (a generator: an LM's f32 temporary stays one
    leaf in size).  The reference's ``_psum_pick``."""
    from ..models.parallel import collective
    mine = None
    for x in stacked_leaves:
        if mine is None:
            mine = torch.arange(lo, lo + x.shape[0], device=x.device) == sel
        yield collective("all_reduce", _slot_pick(x, mine), mesh.group).to(x.dtype)


class _Gathered(nn.Module):
    """Stacked halves gathered from every rank: the parameters in the
    local halves' order, each with all R slots (what the host cascade's
    ``res_params`` reads)."""

    def __init__(self, tensors: Sequence[torch.Tensor]):
        super().__init__()
        self.slots = nn.ParameterList([nn.Parameter(t, requires_grad=False)
                                       for t in tensors])


class RoundRunner:
    """Runs a :class:`RoundSpec`; see the module docstring for the entries.
    ``select`` binds a :class:`~repro_torch.selection.SelectionPolicy`
    (default argmin); ``verify`` configures the tamper-check stage of
    :meth:`accept` and of the entries built on it.  ``params_stacked`` says
    the parameters are already cluster-stacked, each slot training its own
    (the launch layer's layout, :meth:`round` and :meth:`round_block` only);
    otherwise one theta goes into every slot (the protocol layout).

    ``placement="vmap"`` runs every slot on this card.  ``"sharded"`` lays
    the cluster axis over the ranks of the process group (the reference's
    ``shard_map`` over :data:`CLUSTER_AXIS`): every rank calls the entry with
    the same full inputs and keeps its R_local slice (``RoundSpec.take``),
    the selection features are all-gathered so every rank scores, ranks and
    verifies alike, and the winner reaches every rank through one masked
    f32 all-reduce a parameter (:func:`psum_pick`); every rank returns the
    same result.  ``mesh`` defaults to :func:`cluster_mesh` of the call's R
    (:func:`sweep_mesh` for the sweep, the job count for the pool)."""

    def __init__(self, spec: RoundSpec, *, placement: str = "vmap",
                 mesh: Optional[ClusterMesh] = None, select=None,
                 verify: Optional[VerifyConfig] = None, params_stacked: bool = False):
        from ..selection import ARGMIN
        check_placement(placement)
        self.spec = spec
        self.placement = placement
        self.mesh = mesh
        self.select = ARGMIN if select is None else select
        self.verify = VerifyConfig() if verify is None else verify
        self.params_stacked = params_stacked
        if mesh is not None:
            check_partial_auto_backend(mesh, (SEED_AXIS, CLUSTER_AXIS))

    @property
    def sharded(self) -> bool:
        return self.placement == "sharded"

    # -- the sharded layout ---------------------------------------------------

    def _cluster_slice(self, n: int, what: str = "R") -> Tuple[ClusterMesh, int, int]:
        """(mesh, lo, n_local): this rank's slice of the n entries the
        cluster axis carries (over this rank's pod group where the mesh
        has data or model axes: :meth:`ClusterMesh.pod_view`)."""
        ax = CLUSTER_AXIS
        mesh = self.mesh.pod_view() if self.mesh is not None else cluster_mesh(n)
        d = mesh.shape[ax]
        if n % d:
            raise ValueError(f"{what}={n} not divisible by mesh axis {ax!r}={d}")
        n_local = n // d
        return mesh, mesh.coord(ax) * n_local, n_local

    def _take(self, inputs, lanes: Optional[slice], clusters: Optional[slice]):
        if self.spec.take is None:
            raise ValueError("placement='sharded' needs the RoundSpec take hook")
        return self.spec.take(inputs, lanes, clusters)

    def _lead(self, inputs) -> Tuple[int, ...]:
        if self.spec.lead is None:
            raise ValueError("placement='sharded' needs the RoundSpec lead hook")
        return self.spec.lead(inputs)

    def _gathered_context(self, aux, vloss, shard_l, mesh, extra=()):
        """All-gather this rank's selection features (and ``extra`` per-slot
        tensors) in one collective: the R-row ScoreContext every rank scores
        alike, and the gathered ``extra``."""
        from ..selection import ScoreContext
        spec, policy = self.spec, self.select
        _check_stats(spec, policy)
        stats = spec.message_stats(aux) if policy.needs_message_stats else None
        parts = [vloss, shard_l, stats, *extra]
        rows = vloss.shape[0]
        out = _unpack(_gather_rows(_pack(parts, rows), mesh), parts, (mesh.size * rows,))
        vl, sh, st = out[:3]
        return ScoreContext(vlosses=vl, shard_losses=sh, message_stats=st), out[3:]

    # -- entries --------------------------------------------------------------

    def candidates(self, params, inputs, val):
        """(stacked_params, train_aux, vlosses (R,), val_aux) for theta =
        ``params``, which stays as it was.  Sharded: each rank trains its
        slice and every output is all-gathered to its R rows, so the host
        cascade runs alike on every rank."""
        if not self.sharded:
            return cluster_map(self.spec, params, inputs, val)
        r = self._lead(inputs)[-1]
        mesh, lo, n = self._cluster_slice(r)
        counts = [len(_params(half)) for half in params]
        if mesh.member:
            new_p, aux, vloss, vaux = cluster_map(
                self.spec, params, self._take(inputs, None, slice(lo, lo + n)), val)
            flat = [_gather_rows(t, mesh)
                    for t in [*_params(new_p), vloss, vaux, *_aux_leaves(aux)]]
        else:
            flat = None
        flat = mesh.share(flat)
        stacks, at = [], 0
        for c in counts:
            stacks.append(_Gathered(flat[at:at + c]))
            at += c
        vloss, vaux, aux = flat[at], flat[at + 1], _aux_tree(flat[at + 2:])
        return tuple(stacks), aux, vloss, vaux

    def _check_verify(self) -> None:
        if self.params_stacked:
            raise ValueError("the acceptance cascade requires the protocol layout "
                             "(params_stacked=False): the commit stage resolves the R "
                             "candidates back to one theta")
        if (self.verify.enabled and self.verify.recompute
                and self.spec.handoff_acts is None):
            raise ValueError("verify.enabled with recompute needs the RoundSpec "
                             "handoff_acts hook")

    def _verify_passed(self, new_p, vaux, val):
        """Per-candidate handoff verification: the transmission (re-derived
        from the handed-off parameters under ``verify.recompute``, else the
        validation activations themselves, see :class:`VerifyConfig`)
        against the validation-time activations, all candidates of the
        stack (R, or L * R in the replica form; a rank's own slice under the
        sharded placement) in one ``tamper_verdict`` call (one launch of B1
        on the card; the aliased call reads the activations once).  Returns
        the bool pass mask and the distances."""
        from ..kernels.ops import tamper_verdict
        if self.verify.recompute:
            return tamper_verdict(vaux, self.spec.handoff_acts(new_p, val),
                                  self.verify.tol)
        return tamper_verdict(vaux, vaux, self.verify.tol)

    def _passed(self, new_p, vaux, val, vlosses):
        if self.verify.enabled:
            return self._verify_passed(new_p, vaux, val)[0]
        return torch.ones_like(vlosses, dtype=torch.bool)

    def _accept_lanes(self, params, inputs, val, active=None):
        """The fused cascade over one theta or the replica form: train and
        validate every slot, verify every candidate in one call, then per
        replica score, rank and commit its winner into its theta in place
        (kept where every candidate fails, and where ``active``, an (L,)
        bool device mask, is False).  Returns ``(thetas, fetches (L, 2R +
        3))``, the fetches on the device."""
        from ..selection import masked_first_accept, pack_fetch
        self._check_verify()
        spec, policy = self.spec, self.select
        thetas = replicas(params)
        new_p, aux, vlosses, vaux, shard_l = select_map(spec, policy, params, inputs,
                                                        val)
        passed = self._passed(new_p, vaux, val, vlosses)
        summary = _spec_train_summary(spec, aux, vlosses)
        fetches = []
        for l, (rows, scores, elig) in enumerate(
                replica_scores(spec, policy, aux, vlosses, shard_l, len(thetas))):
            sel, det, acc = masked_first_accept(scores, elig, passed[rows])
            keep = acc if active is None else acc & active[l]
            for plain, stacked in zip(thetas[l], new_p):
                commit(plain, stacked, rows.start + sel, keep)
            fetches.append(pack_fetch(vlosses[rows], summary[rows], sel, det, acc))
        return thetas, torch.stack(fetches)

    def accept(self, params, inputs, val):
        """The fused round acceptance: ``(committed theta, fetch)``.  The
        winner is written into ``params``' modules in place (kept as they
        were when every candidate fails); ``fetch`` is the
        ``selection.pack_fetch`` vector, still on the device.  Sharded:
        each rank verifies its own candidates (B1 over R_local) and the pass
        flags are gathered with the features before the cascade, as in the
        reference's ``_sharded_accept``."""
        if not self.sharded:
            thetas, fetches = self._accept_lanes(params, inputs, val)
            return thetas[0], fetches[0]
        from ..selection import masked_first_accept, pack_fetch
        self._check_verify()
        spec, policy = self.spec, self.select
        r = self._lead(inputs)[-1]
        mesh, lo, n = self._cluster_slice(r)
        theta = _params(params)
        if mesh.member:
            new_p, aux, vloss, vaux, shard_l = select_map(
                spec, policy, params, self._take(inputs, None, slice(lo, lo + n)), val)
            passed = self._passed(new_p, vaux, val, vloss)
            ctx, (summary, passed) = self._gathered_context(
                aux, vloss, shard_l, mesh, (_spec_train_summary(spec, aux, vloss), passed))
            scores, elig = policy_scores(policy, ctx)
            sel, det, acc = masked_first_accept(scores, elig, passed)
            with torch.no_grad():
                for p, w in zip(theta, psum_pick(_params(new_p), sel, lo, mesh)):
                    p.copy_(torch.where(acc, w, p))
            fetch = pack_fetch(ctx.vlosses, summary, sel, det, acc)
            shared = [*theta, fetch]
        else:
            shared = None
        shared = mesh.share(shared)
        if not mesh.member:
            _load(theta, shared)
        return params, shared[-1]

    def round(self, params, inputs, val):
        """One launch-layer round: every slot trained and validated, the
        policy's winner (:func:`masked_argmin` over its scores) broadcast
        into every slot in place.  Returns ``(stacked_params, vlosses (R,),
        sel)``, ``sel`` a 0-d tensor on the device; nothing is read back.
        The stacked parameters are ``params`` under ``params_stacked``,
        else the halves the round built from theta = ``params``.  Sharded:
        ``params`` (under ``params_stacked``) holds this rank's R_local
        slots, and the returned ``vlosses`` all R."""
        spec, policy = self.spec, self.select
        if not self.sharded:
            new_p, aux, vlosses, _, shard_l = select_map(spec, policy, params, inputs, val)
            scores, elig = policy_scores(policy, policy_context(spec, policy, aux, vlosses,
                                                                shard_l))
            sel = masked_argmin(scores, elig)
            return broadcast_winner(new_p, sel), vlosses, sel
        r = self._lead(inputs)[-1]
        mesh, lo, n = self._cluster_slice(r)
        if not mesh.member:
            if not self.params_stacked:
                raise ValueError("a rank outside the mesh holds no candidates: the sharded "
                                 "round there needs params_stacked=True")
            *winner, vlosses, sel = mesh.share(None)
            with torch.no_grad():
                for p, w in zip(_params(params), winner):
                    p.copy_(w.expand_as(p))
            return params, vlosses, sel
        new_p, aux, vloss, _, shard_l = select_map(
            spec, policy, params, self._take(inputs, None, slice(lo, lo + n)), val)
        ctx, _ = self._gathered_context(aux, vloss, shard_l, mesh)
        sel = masked_argmin(*policy_scores(policy, ctx))
        leaves = _params(new_p)
        with torch.no_grad():
            for p, w in zip(leaves, psum_pick(leaves, sel, lo, mesh)):
                p.copy_(w.expand_as(p))
        mesh.share([p[0] for p in leaves] + [ctx.vlosses, sel])
        return new_p, ctx.vlosses, sel

    def round_block(self, params, block_inputs, val):
        """K :meth:`round` rounds back to back over stacked parameters, each
        round training from the winner the one before broadcast:
        ``(params, (vlosses (K, R), sels (K,)))`` for the caller's one
        fetch; nothing here reads the device back."""
        if not self.params_stacked:
            raise ValueError("round_block carries the stacked parameters from round "
                             "to round: it needs params_stacked=True")
        vls, sels = [], []
        for inputs in block_inputs:
            params, vlosses, sel = self.round(params, inputs, val)
            vls.append(vlosses)
            sels.append(sel)
        return params, (torch.stack(vls), torch.stack(sels))

    def sweep(self, params, inputs, val):
        """One round of S replicas: :func:`sweep_map` under this runner's
        policy.  Sharded: the S x R replica grid over the ``(seed, pod)``
        mesh; each rank trains its (S_local, R_local) block, the features
        are all-gathered, every rank picks every seed's winner, and one
        masked f32 all-reduce a parameter of an (S, ...) stack carries every
        seed's winner to every rank (each seed's winner sits on one rank)."""
        if not self.sharded:
            return sweep_map(self.spec, params, inputs, val, self.select)
        from ..selection import ScoreContext
        spec, policy = self.spec, self.select
        s, r = self._lead(inputs)
        sax, ax = SEED_AXIS, CLUSTER_AXIS
        mesh = self.mesh if self.mesh is not None else sweep_mesh(s, r)
        sn, rn = mesh.shape[sax], mesh.shape[ax]
        if s % sn or r % rn:
            raise ValueError(f"(S={s}, R={r}) not divisible by mesh axes ({sax!r}={sn}, "
                             f"{ax!r}={rn})")
        s_l, r_l = s // sn, r // rn
        s_lo, r_lo = mesh.coord(sax) * s_l, mesh.coord(ax) * r_l
        thetas = replicas(params)
        if not mesh.member:
            shared = mesh.share(None)
            _load(_params(thetas), shared)
            vlosses, *aux, sels = shared[len(_params(thetas)):]
            return thetas, _aux_tree(aux), vlosses, sels
        local = self._take(inputs, slice(s_lo, s_lo + s_l), slice(r_lo, r_lo + r_l))
        new_p, aux, vloss, _, shard_l = select_map(spec, policy, thetas[s_lo:s_lo + s_l],
                                                   local, val)
        _check_stats(spec, policy)
        stats = spec.message_stats(aux) if policy.needs_message_stats else None
        parts = [vloss, shard_l, stats, *_aux_leaves(aux)]
        rows = vloss.shape[0]
        grid = _gather_rows(_pack(parts, rows), mesh)
        grid = (grid.reshape(sn, rn, s_l, r_l, -1).permute(0, 2, 1, 3, 4)
                .reshape(s, r, -1))
        vl, sh, st, *aux_g = _unpack(grid, parts, (s, r))
        sels = torch.stack([masked_argmin(*policy_scores(policy, ScoreContext(
            vlosses=vl[i], shard_losses=None if sh is None else sh[i],
            message_stats=None if st is None else st[i]))) for i in range(s)])
        new_leaves = _params(new_p)                 # (S_l * R_l, ...) each
        with torch.no_grad():
            for k, x in enumerate(new_leaves):
                out = torch.zeros((s,) + tuple(x.shape[1:]), dtype=torch.float32,
                                  device=x.device)
                for i in range(s_l):
                    mine = torch.arange(r_lo, r_lo + r_l, device=x.device) == sels[s_lo + i]
                    out[s_lo + i] = _slot_pick(x[i * r_l:(i + 1) * r_l], mine)
                dist.all_reduce(out, group=mesh.group)
                for j, theta in enumerate(thetas):
                    _params(theta)[k].copy_(out[j].to(x.dtype))
        aux = _aux_tree(aux_g)
        mesh.share([*_params(thetas), vl, *_aux_leaves(aux), sels])
        return thetas, aux, vl, sels

    def sweep_block(self, params, block_inputs, val):
        """K :meth:`sweep` rounds back to back: ``(params, (vlosses (K, S,
        R), train losses (K, S, R), sels (K, S)))``, the train losses each
        cluster's mean client loss (the spec's ``train_summary``).  The
        caller fetches the three once; nothing here reads the device
        back."""
        vls, tls, sels = [], [], []
        for inputs in block_inputs:
            params, aux, vlosses, sel = self.sweep(params, inputs, val)
            vls.append(vlosses)
            tls.append(_spec_train_summary(self.spec, aux, vlosses))
            sels.append(sel)
        return params, (torch.stack(vls), torch.stack(tls), torch.stack(sels))

    def accept_block(self, params, block_inputs, val):
        """K fused acceptance rounds back to back: ``(committed theta,
        fetches)``.  ``block_inputs`` holds the K rounds' ``accept`` inputs
        in round order; each round commits its winner into ``params``'
        modules in place before the next one trains from them, and the K
        ``pack_fetch`` vectors stack into one ``(K, 2R + 3)`` tensor on the
        device — the block's one fetch is the caller's.  Nothing here reads
        the device back."""
        self._check_verify()
        fetches = []
        for inputs in block_inputs:
            params, fetch = self.accept(params, inputs, val)
            fetches.append(fetch)
        return params, torch.stack(fetches)

    def pool_accept_block(self, params_j, block_inputs, val_j, active_j):
        """J jobs' round blocks as one program: K rounds of the fused
        cascade over the replica form, one lane a job.  ``params_j`` is the
        list of J thetas (updated in place); ``block_inputs`` the K rounds'
        replica payloads in round order (``jobs.pool_rounds``); ``val_j =
        (x0 (J, D_o, ...), y0 (J, D_o))``, each job's own validation set
        (:class:`LaneVal`); ``active_j`` a (J,) bool device mask.  Each round
        verifies all J * R candidates in one ``tamper_verdict`` call (one B1
        launch) and runs selection and the cascade per lane; a lane's
        commit is masked by its acceptance and ``active_j``, so an idle
        lane's placeholder payload changes nothing.  Returns ``(params_j,
        fetches (J, K, 2R + 3))``; nothing here reads the device back.  At
        J = 1 this is the solo R-slot ``accept_block`` program.

        Sharded: the JOB axis lies over the mesh (:data:`CLUSTER_AXIS`), each
        rank running its J_local lanes with no cross-lane collective; the
        fetches and the lanes' thetas are then all-gathered, so every rank
        holds every job's state."""
        self._check_verify()
        if not self.sharded:
            return params_j, self._pool_lanes(params_j, block_inputs, LaneVal(*val_j),
                                              active_j)
        thetas = list(params_j)
        mesh, lo, n = self._cluster_slice(len(thetas), "J")
        leaves = [_params(t) for t in thetas]
        if mesh.member:
            lanes = slice(lo, lo + n)
            fetches = _gather_rows(self._pool_lanes(
                thetas[lanes], [self._take(inputs, lanes, None) for inputs in block_inputs],
                LaneVal(val_j[0][lanes], val_j[1][lanes]), active_j[lanes]), mesh)
            with torch.no_grad():
                for k in range(len(leaves[0])):
                    g = _gather_rows(torch.stack([leaves[j][k].to(torch.float32)
                                                  for j in range(lo, lo + n)]), mesh)
                    for j in range(len(thetas)):
                        leaves[j][k].copy_(g[j].to(leaves[j][k].dtype))
            shared = [p for ls in leaves for p in ls] + [fetches]
        else:
            shared = None
        shared = mesh.share(shared)
        if not mesh.member:
            _load([p for ls in leaves for p in ls], shared)
        return thetas, shared[-1]

    def _pool_lanes(self, thetas, block_inputs, val: LaneVal, active):
        """K rounds of :meth:`_accept_lanes` over the lanes ``thetas``:
        their fetches stacked to (lanes, K, 2R + 3)."""
        fetches = []
        for inputs in block_inputs:
            thetas, fetch = self._accept_lanes(thetas, inputs, val, active)
            fetches.append(fetch)
        return torch.stack(fetches, dim=1)


@torch.no_grad()
def _load(params: Sequence[torch.Tensor], tensors: Sequence[torch.Tensor]) -> None:
    """Copy the first ``len(params)`` of ``tensors`` into ``params`` in
    place (a rank outside the mesh taking rank 0's results)."""
    for p, t in zip(params, tensors):
        p.copy_(t)


# ---------------------------------------------------------------------------
# the protocol-level binding (SplitModule + AttackVec lanes)
# ---------------------------------------------------------------------------

def sharded_validation_losses(ap_loss, phi, acts: torch.Tensor, y0: torch.Tensor,
                              k: int, lead: int = 0) -> torch.Tensor:
    """Per-shard shared-set losses over ``effective_shards(k, D_o)`` equal
    slices of the sample axis, axis ``lead`` of ``acts`` and of ``y0``:
    ``(k',)`` for a plain ``ap_loss`` (``lead`` 0), ``(R, k')`` for a
    stacked one (``lead`` 1, ``y0`` a label set a slot) — the one copy of
    the median-of-means shard arithmetic, shared by the fused spec and the
    host selector."""
    from ..selection import effective_shards
    d_o = acts.shape[lead]
    kk = effective_shards(k, d_o)
    n = d_o // kk
    return torch.stack([ap_loss(phi, acts.narrow(lead, i * n, n), y0.narrow(lead, i * n, n))
                        for i in range(kk)], dim=-1)


def make_train_summary(with_stats: bool):
    """Per-cluster mean client loss out of the (losses[, stats]) aux."""

    def train_summary(aux):
        losses = aux[0] if with_stats else aux
        return torch.mean(losses, dim=-1)

    return train_summary


def protocol_lead(inputs) -> Tuple[int, ...]:
    """``(R,)`` of a round's payload, ``(L, R)`` of a replica payload (the
    seeds' leading axes)."""
    return tuple(inputs[3].shape[:-1])


def protocol_take(inputs, lanes: Optional[slice], clusters: Optional[slice]):
    """A rank's slice of a protocol payload: clusters ``clusters`` of a
    round, or lanes ``lanes`` x clusters ``clusters`` of a replica payload
    (its AttackVec rows replica-major).  The batches are views; nothing
    is copied to the host."""
    xs, ys, avec, seeds = inputs
    clusters = slice(None) if clusters is None else clusters
    if seeds.ndim == 2:
        return xs[clusters], ys[clusters], avec.rows(clusters), seeds[clusters]
    lanes = slice(None) if lanes is None else lanes
    return (xs[lanes, clusters], ys[lanes, clusters],
            avec.block(seeds.shape[0], lanes, clusters), seeds[lanes, clusters])


def protocol_round_spec(module, lr: float, with_stats: bool = False,
                        quant: Optional[str] = None) -> RoundSpec:
    """The Pigeon round over a ``SplitModule``'s stacked form.
    ``inputs = (xs (R, M_bar, E, B, ...), ys (R, M_bar, E, B), avec, seeds)``
    with an (R, M_bar)-laned AttackVec and the (R, M_bar) host array of
    per-turn noise seeds; ``val = (x0, y0)``.  Client positions run in
    chain order, each one an E-step turn in all R clusters at once.

    The replica form (``theta`` a list of L thetas) takes ``xs (L, R,
    M_bar, E, B, ...)``, ``ys (L, R, M_bar, E, B)``, an ``(L * R,
    M_bar)``-laned AttackVec (``AttackVec.cat``) and ``seeds (L, R,
    M_bar)``, and trains the L * R slots as one stack; ``val`` is shared or
    a :class:`LaneVal`."""
    from .protocol import turn_generator
    from .split import (client_update_vec_impl, client_update_vec_stats_impl,
                        stack_replicas)

    stacked = module.stacked

    def train_cluster(theta, inputs):
        xs, ys, avec, seeds = inputs
        lead = seeds.ndim - 1                  # (R,) or, in the replica form, (L, R)
        m_bar = seeds.shape[-1]
        device = ys.device
        g, p = stack_replicas(module, replicas(theta), seeds.shape[-2])
        seeds = seeds.reshape(-1, m_bar)
        losses, stats = [], []
        for j in range(m_bar):
            gens = [turn_generator(s, device) for s in seeds[:, j]]
            data = tuple(a.select(lead, j).flatten(0, lead - 1).transpose(0, 1)
                         for a in (xs, ys))
            if with_stats:
                g, p, loss, st = client_update_vec_stats_impl(
                    module, avec.client(j), g, p, data, lr, gens, quant=quant)
                stats.append(st)
            else:
                g, p, loss = client_update_vec_impl(
                    module, avec.client(j), g, p, data, lr, gens, quant=quant)
            losses.append(loss)
        losses = torch.stack(losses, dim=1)                       # (slots, M_bar)
        return (g, p), ((losses, torch.stack(stats, dim=1)) if with_stats
                        else losses)

    def _slots(g) -> int:
        return next(g.parameters()).shape[0]          # the stacked slot axis

    @torch.no_grad()
    def handoff_acts(theta, val):
        x0, _ = slot_val(val, _slots(theta[0]))
        return stacked.client_forward(theta[0], x0)

    def _validate(theta, val):
        (g, p) = theta
        x0, y0 = slot_val(val, _slots(g))
        acts = stacked.client_forward(g, x0)
        return stacked.ap_losses(p, acts, y0), acts, y0

    @torch.no_grad()
    def validate(theta, val):
        vloss, acts, _ = _validate(theta, val)
        return vloss, acts

    @torch.no_grad()
    def validate_sharded(theta, val, k):
        vloss, acts, y0 = _validate(theta, val)
        if not isinstance(val, LaneVal):            # the shared set, a view a slot
            y0 = y0.expand(acts.shape[:1] + tuple(y0.shape))
        shard_losses = sharded_validation_losses(stacked.ap_losses, theta[1],
                                                 acts, y0, k, lead=1)
        return vloss, shard_losses, acts

    return RoundSpec(
        train_cluster, validate,
        validate_sharded=validate_sharded,
        handoff_acts=handoff_acts,
        train_summary=make_train_summary(with_stats),
        message_stats=(lambda aux: aux[1]) if with_stats else None,
        lead=protocol_lead, take=protocol_take)


def protocol_runner(module, lr: float, with_stats: bool = False, select=None,
                    quant: Optional[str] = None, *, placement: str = "vmap",
                    mesh: Optional[ClusterMesh] = None) -> RoundRunner:
    """The candidates runner of the host-cascade batched path (and the
    sweep's)."""
    return RoundRunner(protocol_round_spec(module, lr, with_stats, quant),
                       select=select, placement=placement, mesh=mesh)


def protocol_accept_runner(module, lr: float, select, tamper_check: bool,
                           tamper_tol: float, quant: Optional[str] = None, *,
                           placement: str = "vmap",
                           mesh: Optional[ClusterMesh] = None) -> RoundRunner:
    """The fused-acceptance runner of the default batched path.  It runs
    only without param-tamper families (``engine.pigeon_round_accept``
    checks it), where the re-transmission equals the validation activations
    by construction: ``recompute=False``, B1's aliased route (see
    :class:`VerifyConfig`)."""
    spec = protocol_round_spec(module, lr,
                               with_stats=select.needs_message_stats,
                               quant=quant)
    return RoundRunner(spec, select=select, placement=placement, mesh=mesh,
                       verify=VerifyConfig(enabled=tamper_check, tol=tamper_tol,
                                           recompute=False))


__all__ = ["ClusterMesh", "LaneVal", "PLACEMENTS", "RoundRunner", "RoundSpec",
           "VerifyConfig", "broadcast_winner", "check_partial_auto_backend",
           "check_placement", "check_policy", "cluster_map", "cluster_mesh", "commit",
           "forget_meshes", "make_train_summary", "masked_argmin", "onehot_select",
           "policy_context", "policy_scores", "protocol_accept_runner", "protocol_lead",
           "protocol_round_spec", "protocol_runner", "protocol_take", "psum_pick",
           "replica_scores", "require_group", "select_map", "sharded_validation_losses",
           "slot_val", "sweep_factors", "sweep_map", "sweep_mesh"]
