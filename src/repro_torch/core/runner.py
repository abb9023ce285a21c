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
(``placement="sharded"``).  Here the cluster axis is written out in the
stacked model, which is the single-card counterpart of the vmap placement;
``run_pigeon`` refuses the sharded one.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch
from torch import nn

from .split import replicas


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
    ``val_aux`` under ``VerifyConfig(recompute=True)``."""
    train_cluster: Callable[[Any, Any], Tuple[Any, Any]]
    validate: Callable[[Any, Any], Tuple[torch.Tensor, Any]]
    combine: Optional[Callable[[Any, Any], Any]] = None
    validate_sharded: Optional[Callable] = None
    handoff_acts: Optional[Callable[[Any, Any], torch.Tensor]] = None
    train_summary: Optional[Callable[[Any], torch.Tensor]] = None
    message_stats: Optional[Callable[[Any], torch.Tensor]] = None


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


class RoundRunner:
    """Runs a :class:`RoundSpec` on one card; see the module docstring for
    the entries.  ``select`` binds a
    :class:`~repro_torch.selection.SelectionPolicy` (default argmin);
    ``verify`` configures the tamper-check stage of :meth:`accept` and of
    the entries built on it.  ``params_stacked`` says the parameters are
    already cluster-stacked, each slot training its own (the launch
    layer's layout, :meth:`round` and :meth:`round_block` only); otherwise
    one theta goes into every slot (the protocol layout)."""

    def __init__(self, spec: RoundSpec, *, select=None,
                 verify: Optional[VerifyConfig] = None, params_stacked: bool = False):
        from ..selection import ARGMIN
        self.spec = spec
        self.select = ARGMIN if select is None else select
        self.verify = VerifyConfig() if verify is None else verify
        self.params_stacked = params_stacked

    def candidates(self, params, inputs, val):
        """(stacked_params, train_aux, vlosses (R,), val_aux) for theta =
        ``params``, which stays as it was."""
        return cluster_map(self.spec, params, inputs, val)

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
        stack (R, or L * R in the replica form) in one ``tamper_verdict``
        call (one launch of B1 on the card; the aliased call reads the
        activations once).  Returns the bool pass mask and the distances."""
        from ..kernels.ops import tamper_verdict
        if self.verify.recompute:
            return tamper_verdict(vaux, self.spec.handoff_acts(new_p, val),
                                  self.verify.tol)
        return tamper_verdict(vaux, vaux, self.verify.tol)

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
        if self.verify.enabled:
            passed, _ = self._verify_passed(new_p, vaux, val)
        else:
            passed = torch.ones_like(vlosses, dtype=torch.bool)
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
        ``selection.pack_fetch`` vector, still on the device."""
        thetas, fetches = self._accept_lanes(params, inputs, val)
        return thetas[0], fetches[0]

    def round(self, params, inputs, val):
        """One launch-layer round: every slot trained and validated, the
        policy's winner (:func:`masked_argmin` over its scores) broadcast
        into every slot in place.  Returns ``(stacked_params, vlosses (R,),
        sel)``, ``sel`` a 0-d tensor on the device; nothing is read back.
        The stacked parameters are ``params`` under ``params_stacked``,
        else the halves the round built from theta = ``params``."""
        spec, policy = self.spec, self.select
        new_p, aux, vlosses, _, shard_l = select_map(spec, policy, params, inputs, val)
        scores, elig = policy_scores(policy, policy_context(spec, policy, aux, vlosses,
                                                            shard_l))
        sel = masked_argmin(scores, elig)
        return broadcast_winner(new_p, sel), vlosses, sel

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
        policy."""
        return sweep_map(self.spec, params, inputs, val, self.select)

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
        J = 1 this is the solo R-slot ``accept_block`` program."""
        self._check_verify()
        val = LaneVal(*val_j)
        fetches = []
        for inputs in block_inputs:
            params_j, fetch = self._accept_lanes(params_j, inputs, val, active_j)
            fetches.append(fetch)
        return params_j, torch.stack(fetches, dim=1)


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
        message_stats=(lambda aux: aux[1]) if with_stats else None)


def protocol_runner(module, lr: float, with_stats: bool = False, select=None,
                    quant: Optional[str] = None) -> RoundRunner:
    """The candidates runner of the host-cascade batched path."""
    return RoundRunner(protocol_round_spec(module, lr, with_stats, quant),
                       select=select)


def protocol_accept_runner(module, lr: float, select, tamper_check: bool,
                           tamper_tol: float,
                           quant: Optional[str] = None) -> RoundRunner:
    """The fused-acceptance runner of the default batched path.  It runs
    only without param-tamper families (``engine.pigeon_round_accept``
    checks it), where the re-transmission equals the validation activations
    by construction: ``recompute=False``, B1's aliased route (see
    :class:`VerifyConfig`)."""
    spec = protocol_round_spec(module, lr,
                               with_stats=select.needs_message_stats,
                               quant=quant)
    return RoundRunner(spec, select=select,
                       verify=VerifyConfig(enabled=tamper_check, tol=tamper_tol,
                                           recompute=False))


__all__ = ["LaneVal", "RoundRunner", "RoundSpec", "VerifyConfig", "broadcast_winner",
           "check_policy", "cluster_map", "commit", "make_train_summary", "masked_argmin",
           "onehot_select", "policy_context", "policy_scores", "protocol_accept_runner",
           "protocol_round_spec", "protocol_runner", "replica_scores", "select_map",
           "sharded_validation_losses", "slot_val", "sweep_map"]
