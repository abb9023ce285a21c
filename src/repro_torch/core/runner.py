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
    over all R candidates in one call) and commit, with nothing read back
    to the host; the caller fetches the one ``(2R + 3,)`` vector.

The reference maps its per-cluster program over the cluster axis with
``jax.vmap`` (``placement="vmap"``) or lays the axis over a device mesh
(``placement="sharded"``).  Here the cluster axis is written out in the
stacked model, which is the single-card counterpart of the vmap placement;
``run_pigeon`` refuses the sharded one.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch
from torch import nn

from .protocol import _not_ported

#: where the parts of the reference's runner this slice does not run will
#: come from
ROUND_BLOCK_SLICE = ("the round-block slice (RoundRunner.accept_block, "
                     "engine.assemble_block)")
SWEEP_SLICE = "the multi-seed sweep slice (RoundRunner.sweep, run_pigeon_sweep)"
LAUNCH_SLICE = "the launch-layer slice (RoundRunner.round, launch/steps.py)"
JOB_POOL_SLICE = "the job-pool slice (RoundRunner.pool_accept_block, jobs/)"


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


@dataclasses.dataclass(frozen=True)
class RoundSpec:
    """The programs of one Pigeon round over the cluster-stacked model.

    ``train_cluster(theta, inputs) -> (stacked_params, train_aux)`` — every
    cluster's training phase from theta, all R at once.

    ``validate(stacked_params, val) -> (vlosses (R,), val_aux)`` — the
    shared-set validation forward (Section III-C); ``val_aux`` holds the
    (R, D_o, d_c) cut activations the tamper check compares against.

    Selection hooks, for the policies that need them:
    ``validate_sharded(stacked_params, val, k) -> (vlosses, (R, k') shard
    losses, val_aux)``, ``train_summary(train_aux) -> (R,)`` and
    ``message_stats(train_aux) -> (R, M_bar, S)``."""
    train_cluster: Callable[[Any, Any], Tuple[Any, Any]]
    validate: Callable[[Any, Any], Tuple[torch.Tensor, Any]]
    validate_sharded: Optional[Callable] = None
    train_summary: Optional[Callable[[Any], torch.Tensor]] = None
    message_stats: Optional[Callable[[Any], torch.Tensor]] = None


@dataclasses.dataclass(frozen=True)
class VerifyConfig:
    """The fused cascade's verification stage: compare each candidate's
    handoff transmission with its validation-time activations (the
    ``tamper_check`` kernel) and reject candidates beyond ``tol``.

    The fused path runs only without param-tamper families (those take the
    host cascade), where the re-transmission from the handed-off parameters
    equals the validation activations by construction; the stage therefore
    holds the validation activations against themselves (the reference's
    ``recompute=False``), the kernel sees identical inputs and returns
    exactly 0.  The masked cascade, the kernel and the Table I
    re-transmission accounting stay live all the same."""
    enabled: bool = True
    tol: float = 1e-4


def cluster_map(spec: RoundSpec, params, inputs, val):
    """Train + validate every cluster: ``(stacked_params, train_aux,
    vlosses (R,), val_aux)`` — the one copy of the round math."""
    new_p, aux = spec.train_cluster(params, inputs)
    vloss, vaux = spec.validate(new_p, val)
    return new_p, aux, vloss, vaux


def select_map(spec: RoundSpec, policy, params, inputs, val):
    """:func:`cluster_map` + the per-shard losses ``(R, K)`` when ``policy``
    shards the shared set (else None)."""
    if policy.shard_count <= 0:
        return (*cluster_map(spec, params, inputs, val), None)
    if spec.validate_sharded is None:
        raise ValueError(f"selection policy {policy.name!r} needs sharded "
                         f"validation, which this RoundSpec does not provide")
    new_p, aux = spec.train_cluster(params, inputs)
    vloss, shard_l, vaux = spec.validate_sharded(new_p, val, policy.shard_count)
    return new_p, aux, vloss, vaux, shard_l


def policy_context(spec: RoundSpec, policy, aux, vlosses, shard_losses):
    """The in-program :class:`~repro_torch.selection.ScoreContext`."""
    from ..selection import ScoreContext
    stats = None
    if policy.needs_message_stats:
        if spec.message_stats is None:
            raise ValueError(f"selection policy {policy.name!r} needs "
                             f"transmitted-message statistics, which this "
                             f"RoundSpec does not surface")
        stats = spec.message_stats(aux)
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


class RoundRunner:
    """Runs a :class:`RoundSpec` on one card; see the module docstring for
    the two entries.  ``select`` binds a
    :class:`~repro_torch.selection.SelectionPolicy` (default argmin);
    ``verify`` configures :meth:`accept`'s tamper-check stage."""

    def __init__(self, spec: RoundSpec, *, select=None,
                 verify: Optional[VerifyConfig] = None):
        from ..selection import ARGMIN
        self.spec = spec
        self.select = ARGMIN if select is None else select
        self.verify = VerifyConfig() if verify is None else verify

    def candidates(self, params, inputs, val):
        """(stacked_params, train_aux, vlosses (R,), val_aux) for theta =
        ``params``, which stays as it was."""
        return cluster_map(self.spec, params, inputs, val)

    def _verify_passed(self, vaux):
        """Per-candidate handoff verification: the transmission (the
        validation activations, see :class:`VerifyConfig`) against the
        validation-time activations, all R candidates in one
        ``tamper_distance`` call.  Returns the (R,) bool pass mask and the
        distances."""
        from ..kernels.ops import tamper_distance
        dists = tamper_distance(vaux, vaux)
        return dists <= self.verify.tol, dists

    def accept(self, params, inputs, val):
        """The fused round acceptance: ``(committed theta, fetch)``.  The
        winner is written into ``params``' modules in place (kept as they
        were when every candidate fails); ``fetch`` is the
        ``selection.pack_fetch`` vector, still on the device."""
        from ..selection import masked_first_accept, pack_fetch
        spec, policy = self.spec, self.select
        new_p, aux, vlosses, vaux, shard_l = select_map(spec, policy, params,
                                                        inputs, val)
        ctx = policy_context(spec, policy, aux, vlosses, shard_l)
        scores, elig = policy_scores(policy, ctx)
        if self.verify.enabled:
            passed, _ = self._verify_passed(vaux)
        else:
            passed = torch.ones_like(elig)
        sel, det, acc = masked_first_accept(scores, elig, passed)
        committed = tuple(commit(plain, stacked, sel, acc)
                          for plain, stacked in zip(params, new_p))
        fetch = pack_fetch(vlosses, _spec_train_summary(spec, aux, vlosses),
                           sel, det, acc)
        return committed, fetch

    def round(self, *args):
        _not_ported("RoundRunner.round", LAUNCH_SLICE)

    def sweep(self, *args):
        _not_ported("RoundRunner.sweep", SWEEP_SLICE)

    def accept_block(self, *args):
        _not_ported("RoundRunner.accept_block", ROUND_BLOCK_SLICE)

    def pool_accept_block(self, *args):
        _not_ported("RoundRunner.pool_accept_block", JOB_POOL_SLICE)


# ---------------------------------------------------------------------------
# the protocol-level binding (SplitModule + AttackVec lanes)
# ---------------------------------------------------------------------------

def sharded_validation_losses(ap_loss, phi, acts: torch.Tensor, y0: torch.Tensor,
                              k: int) -> torch.Tensor:
    """Per-shard shared-set losses over ``effective_shards(k, D_o)`` equal
    slices of the sample axis (second to last of ``acts``): ``(k',)`` for a
    plain ``ap_loss``, ``(R, k')`` for a stacked one — the one copy of the
    median-of-means shard arithmetic, shared by the fused spec and the host
    selector."""
    from ..selection import effective_shards
    kk = effective_shards(k, y0.shape[0])
    n = y0.shape[0] // kk
    return torch.stack([ap_loss(phi, acts[..., i * n:(i + 1) * n, :],
                                y0[i * n:(i + 1) * n]) for i in range(kk)], dim=-1)


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
    chain order, each one an E-step turn in all R clusters at once."""
    from .protocol import turn_generator
    from .split import (client_update_vec_impl, client_update_vec_stats_impl,
                        stack_params)

    stacked = module.stacked

    def train_cluster(theta, inputs):
        xs, ys, avec, seeds = inputs
        gamma, phi = theta
        r, m_bar = ys.shape[:2]
        device = ys.device
        g, p = stack_params(module, gamma, phi, r)
        losses, stats = [], []
        for j in range(m_bar):
            gens = [turn_generator(s, device) for s in seeds[:, j]]
            data = (xs[:, j].transpose(0, 1), ys[:, j].transpose(0, 1))
            if with_stats:
                g, p, loss, st = client_update_vec_stats_impl(
                    module, avec.client(j), g, p, data, lr, gens, quant=quant)
                stats.append(st)
            else:
                g, p, loss = client_update_vec_impl(
                    module, avec.client(j), g, p, data, lr, gens, quant=quant)
            losses.append(loss)
        losses = torch.stack(losses, dim=1)                       # (R, M_bar)
        return (g, p), ((losses, torch.stack(stats, dim=1)) if with_stats
                        else losses)

    def _acts(g, x0):
        r = next(g.parameters()).shape[0]            # the stacked R axis
        return stacked.client_forward(g, x0.expand((r,) + tuple(x0.shape)))

    @torch.no_grad()
    def validate(theta, val):
        (g, p), (x0, y0) = theta, val
        acts = _acts(g, x0)
        return stacked.ap_losses(p, acts, y0), acts

    @torch.no_grad()
    def validate_sharded(theta, val, k):
        vloss, acts = validate(theta, val)
        shard_losses = sharded_validation_losses(stacked.ap_losses, theta[1],
                                                 acts, val[1], k)
        return vloss, shard_losses, acts

    return RoundSpec(
        train_cluster, validate,
        validate_sharded=validate_sharded,
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
    checks it); see :class:`VerifyConfig`."""
    spec = protocol_round_spec(module, lr,
                               with_stats=select.needs_message_stats,
                               quant=quant)
    return RoundRunner(spec, select=select,
                       verify=VerifyConfig(enabled=tamper_check, tol=tamper_tol))


__all__ = ["RoundRunner", "RoundSpec", "VerifyConfig", "cluster_map", "commit", "make_train_summary",
           "masked_argmin", "onehot_select", "policy_context",
           "policy_scores", "protocol_accept_runner", "protocol_round_spec",
           "protocol_runner", "select_map", "sharded_validation_losses"]
