"""Batched cluster-parallel protocol engine.

Pigeon-SL's global round trains R = N+1 clusters independently from the same
theta^t.  The sequential engine (``protocol.py``) runs one client turn at a
time; this engine stacks the R clusters' batches, per-slot attack state and
per-turn noise seeds into leading-axis tensors and runs the round through
the :class:`~repro_torch.core.runner.RoundRunner`: one E-step turn per
client position in all R clusters at once, M_bar positions a round.

Equivalence with the sequential engine (``tests/test_torch_engine.py``):
both consume the numpy batch-sampling stream and the run's noise-seed stream
in the same order — cluster-major, then client — every turn draws its noise
from a generator seeded with its slot's seed, the vectorised attack hooks
are ``torch.where``-masked versions of the same arithmetic, and the
CommMeter accounting goes through the same helpers.  Seeded runs therefore
select the same clusters, with validation losses equal within float
tolerance and bit-identical message counts.

SplitFed (the Section V baseline) binds the same runner to its own round:
every client of every cluster trains at once, as one lane of an (R *
M_bar)-stacked model, from the cluster's incoming theta, and the
``combine`` hook (FedAvg) averages each cluster's M_bar lanes into its
model before validation.
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import dataclasses

import numpy as np
import torch

from ..adversary import ThreatModel
from .protocol import (ClientData, CommMeter, ProtocolConfig, _count_params,
                       account_client_turn, account_handoff_recheck,
                       round_client_seeds, sample_batch_idx)
from .runner import (RoundRunner, RoundSpec, VerifyConfig, protocol_accept_runner,
                     protocol_round_spec, protocol_runner)
from .split import (SplitModule, _stacked, client_update_vec_impl,
                    client_update_vec_stats_impl, stack_params, unstack_slot)


# ---------------------------------------------------------------------------
# host-side assembly: batches, seeds and attack state for one round
# ---------------------------------------------------------------------------

def assemble_round_batches(rng: np.random.Generator, data: ClientData,
                           clusters: Sequence[Sequence[int]],
                           pcfg: ProtocolConfig, device: torch.device
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample every client's (E, B) mini-batches for the round, consuming the
    numpy RNG in the sequential engine's order (cluster-major, then client),
    gathered straight into one (R, M_bar, E, B, ...) host buffer and moved
    to ``device`` in one copy."""
    r, m_bar = len(clusters), len(clusters[0])
    xs = np.empty((r, m_bar, pcfg.E, pcfg.B) + data.x.shape[2:], dtype=data.x.dtype)
    ys = np.empty((r, m_bar, pcfg.E, pcfg.B) + data.y.shape[2:], dtype=data.y.dtype)
    for i, cluster in enumerate(clusters):
        for j, client in enumerate(cluster):
            idx = sample_batch_idx(rng, data.x[client].shape[0], pcfg.E, pcfg.B)
            np.take(data.x[client], idx, axis=0, out=xs[i, j])
            np.take(data.y[client], idx, axis=0, out=ys[i, j])
    return torch.from_numpy(xs).to(device), torch.from_numpy(ys).to(device)


def assemble_round(rng: np.random.Generator, seed_gen: torch.Generator,
                   data: ClientData, clusters: Sequence[Sequence[int]],
                   pcfg: ProtocolConfig, tm: ThreatModel, t: int,
                   device: torch.device):
    """One round's payload ``(xs, ys, avec, seeds)``: the stacked batches and
    AttackVec on ``device``, and the (R, M_bar) host array of per-turn noise
    seeds (:func:`~repro_torch.core.protocol.round_client_seeds`).  The one
    copy of the stream consumption order of the batched engine."""
    xs, ys = assemble_round_batches(rng, data, clusters, pcfg, device)
    seeds = round_client_seeds(seed_gen, clusters)
    avec = tm.attack_vec_for_clusters(clusters, t).to(device)
    return xs, ys, avec, seeds


def _account_turns(meter: CommMeter, pcfg: ProtocolConfig, clusters, d_c: int,
                   d_cl: int) -> None:
    for cluster in clusters:
        for j in range(len(cluster)):
            account_client_turn(meter, pcfg, d_c, d_cl, handoff=j < len(cluster) - 1)


# ---------------------------------------------------------------------------
# protocol-facing drivers (same result structure as the sequential loops)
# ---------------------------------------------------------------------------

def train_round_batched(module: SplitModule, theta, clusters, data: ClientData,
                        pcfg: ProtocolConfig, tm: ThreatModel, t: int,
                        rng: np.random.Generator, seed_gen: torch.Generator,
                        meter: CommMeter, d_c: int, x0: torch.Tensor,
                        y0: torch.Tensor, with_stats: bool = False
                        ) -> List[Dict[str, Any]]:
    """All R candidates of round t in one stacked pass, selection left to
    the host selector (``selection.select_host``, the param-tamper path; the
    default path is :func:`pigeon_round_accept`).  Each result holds a view
    into the stacked candidates; ``protocol.res_params`` / ``res_vacts``
    take out only the ones the selector visits."""
    payload = assemble_round(rng, seed_gen, data, clusters, pcfg, tm, t, x0.device)
    (gs, ps), aux, vlosses, vacts = protocol_runner(
        module, pcfg.lr, with_stats, quant=pcfg.comm.quant).candidates(
        theta, payload, (x0, y0))
    losses, stats = aux if with_stats else (aux, None)
    _account_turns(meter, pcfg, clusters, d_c, _count_params(theta[0]))

    losses = losses.cpu().numpy()
    vlosses = vlosses.cpu().numpy()
    stats = None if stats is None else stats.cpu().numpy()
    results = []
    for r, cluster in enumerate(clusters):
        res = dict(vloss=float(vlosses[r]), cluster=cluster,
                   train_loss=float(np.mean(losses[r])),
                   _stacked=(theta, gs, ps, vacts, r))
        if stats is not None:
            res["msg_stats"] = stats[r]
        results.append(res)
    return results


def pigeon_round_accept(module: SplitModule, theta, clusters, data: ClientData,
                        pcfg: ProtocolConfig, tm: ThreatModel, t: int,
                        rng: np.random.Generator, seed_gen: torch.Generator,
                        meter: CommMeter, d_c: int, x0: torch.Tensor,
                        y0: torch.Tensor, policy):
    """The default batched round: training, validation and the whole
    acceptance cascade (policy score -> rank -> handoff verify -> commit) on
    the device, then the round's one fetch.  Returns ``(theta', record)``,
    theta' being theta's modules updated in place; ``record`` carries the
    History fields (val_losses / train_losses / selected / detections /
    accepted).  Only for threat models without handoff (param-tamper)
    attacks: those draw noise per visited candidate on the host."""
    from ..selection import unpack_fetch
    if tm.has_param_tamper:
        raise ValueError("param-tamper threat models must use the host "
                         "selection cascade")
    payload = assemble_round(rng, seed_gen, data, clusters, pcfg, tm, t, x0.device)
    runner = protocol_accept_runner(module, pcfg.lr, policy,
                                    pcfg.tamper_check, pcfg.tamper_tol,
                                    quant=pcfg.comm.quant)
    theta, fetch = runner.accept(theta, payload, (x0, y0))
    _account_turns(meter, pcfg, clusters, d_c, _count_params(theta[0]))

    vlosses, tlosses, selected, detections, accepted = unpack_fetch(
        fetch.cpu().numpy(), len(clusters))          # the round's one host sync
    if pcfg.tamper_check:
        # one R-recipient re-transmission per visited candidate, as the host
        # cascade charges per visit (the failures + the accepted one)
        account_handoff_recheck(meter, pcfg, int(x0.shape[0]), d_c,
                                detections + (1 if accepted else 0))
    record = dict(val_losses=[float(v) for v in vlosses],
                  train_losses=[float(v) for v in tlosses],
                  selected=selected, detections=detections, accepted=accepted)
    return theta, record


def train_cluster_batched(module: SplitModule, theta, cluster, data: ClientData,
                          pcfg: ProtocolConfig, tm: ThreatModel, t: int,
                          rng: np.random.Generator, seed_gen: torch.Generator,
                          meter: CommMeter, d_c: int):
    """One cluster's client chain as a stack of one (the Pigeon-SL+
    sub-rounds).  Stream consumption matches the sequential
    ``train_cluster``.  Returns (gamma, phi, mean client loss)."""
    device = next(theta[0].parameters()).device
    payload = assemble_round(rng, seed_gen, data, [cluster], pcfg, tm, t, device)
    x0 = torch.from_numpy(data.x0[:1]).to(device)
    y0 = torch.from_numpy(data.y0[:1]).to(device)
    (gs, ps), losses, _, _ = protocol_runner(
        module, pcfg.lr, quant=pcfg.comm.quant).candidates(
        theta, payload, (x0, y0))
    _account_turns(meter, pcfg, [cluster], d_c, _count_params(theta[0]))
    return (unstack_slot(theta[0], gs, 0), unstack_slot(theta[1], ps, 0),
            float(np.mean(losses[0].cpu().numpy())))


# ---------------------------------------------------------------------------
# SplitFed: all M clients update in parallel (no within-cluster chain)
# ---------------------------------------------------------------------------

@torch.no_grad()
def fedavg(module: SplitModule, lanes, r: int):
    """FedAvg of each cluster's clients: (R * M_bar)-stacked halves, lanes
    cluster-major, -> R-stacked halves holding each cluster's mean over its
    M_bar lanes."""
    gl, pl = lanes
    device = next(gl.parameters()).device
    with torch.device(device):
        out = _stacked(module).make(r)
    for src, dst in zip((gl, pl), out):
        for big, mean in zip(src.parameters(), dst.parameters()):
            mean.copy_(big.reshape((r, -1) + tuple(big.shape[1:])).mean(dim=1))
    return out


def splitfed_round_spec(module: SplitModule, lr: float, with_stats: bool = False,
                        quant=None) -> RoundSpec:
    """SplitFed's round as a RoundRunner binding: the train phase runs every
    client of every cluster as one lane of an (R * M_bar)-stacked model
    (one E-step turn for all of them, from the cluster's incoming theta),
    the ``combine`` hook averages each cluster's lanes (:func:`fedavg`), and
    validation is the Pigeon round's.  ``inputs`` are the Pigeon round's
    (``assemble_round``).  Its wire messages are (R * M_bar * B, d_c) for B2
    and (R * M_bar, B, d_c) for B3."""
    from .protocol import turn_generator

    def train_cluster(theta, inputs):
        xs, ys, avec, seeds = inputs
        r, m_bar = ys.shape[:2]
        lanes = r * m_bar
        device = ys.device
        g, p = stack_params(module, theta[0], theta[1], lanes)
        gens = [turn_generator(s, device) for s in seeds.reshape(-1)]
        data = (xs.reshape((lanes,) + tuple(xs.shape[2:])).transpose(0, 1),
                ys.reshape((lanes,) + tuple(ys.shape[2:])).transpose(0, 1))
        if with_stats:
            g, p, loss, st = client_update_vec_stats_impl(
                module, avec.flat(), g, p, data, lr, gens, quant=quant)
            return (g, p), (loss.reshape(r, m_bar), st.reshape(r, m_bar, -1))
        g, p, loss = client_update_vec_impl(module, avec.flat(), g, p, data, lr, gens,
                                            quant=quant)
        return (g, p), loss.reshape(r, m_bar)

    def combine(lanes, inputs):
        return fedavg(module, lanes, inputs[1].shape[0])

    return dataclasses.replace(protocol_round_spec(module, lr, with_stats, quant),
                               train_cluster=train_cluster, combine=combine)


def splitfed_runner(module: SplitModule, lr: float, with_stats: bool = False,
                    quant=None) -> RoundRunner:
    """The candidates runner of SplitFed's host-selected batched path."""
    return RoundRunner(splitfed_round_spec(module, lr, with_stats, quant))


def splitfed_accept_runner(module: SplitModule, lr: float, select, quant=None
                           ) -> RoundRunner:
    """SplitFed's fused-selection runner: the policy cascade with the verify
    stage off (no chained handoff to tamper with)."""
    spec = splitfed_round_spec(module, lr, with_stats=select.needs_message_stats,
                               quant=quant)
    return RoundRunner(spec, select=select, verify=VerifyConfig(enabled=False))


#: SplitFed's payload is the Pigeon round's: the batches in the sequential
#: loop's order and one noise seed a client, (R, M_bar), drawn cluster-major
#: from the run's seed generator (the reference's per-client key splits)
assemble_splitfed_round = assemble_round


def splitfed_round_batched(module: SplitModule, theta, clusters, data: ClientData,
                           pcfg: ProtocolConfig, tm: ThreatModel, t: int,
                           rng: np.random.Generator, seed_gen: torch.Generator,
                           x0: torch.Tensor, y0: torch.Tensor,
                           with_stats: bool = False) -> List[Dict[str, Any]]:
    """Batched SplitFed round, selection left to the caller (the host
    path).  Each result holds a view into the stacked cluster models;
    ``protocol.res_params`` takes out only the selected one."""
    payload = assemble_splitfed_round(rng, seed_gen, data, clusters, pcfg, tm, t,
                                      x0.device)
    (g_avg, p_avg), aux, vlosses, vacts = splitfed_runner(
        module, pcfg.lr, with_stats, quant=pcfg.comm.quant).candidates(
        theta, payload, (x0, y0))
    vlosses = vlosses.cpu().numpy()
    stats = aux[1].cpu().numpy() if with_stats else None
    results = []
    for r, cluster in enumerate(clusters):
        res = dict(vloss=float(vlosses[r]), cluster=cluster,
                   _stacked=(theta, g_avg, p_avg, vacts, r))
        if stats is not None:
            res["msg_stats"] = stats[r]
        results.append(res)
    return results


def splitfed_round_accept(module: SplitModule, theta, clusters, data: ClientData,
                          pcfg: ProtocolConfig, tm: ThreatModel, t: int,
                          rng: np.random.Generator, seed_gen: torch.Generator,
                          x0: torch.Tensor, y0: torch.Tensor, policy):
    """SplitFed's default batched round: FedAvg per cluster and the policy
    selection cascade on the device, then the round's one fetch.  Returns
    ``(theta', record)`` like :func:`pigeon_round_accept` (``detections``
    always 0 and ``accepted`` always True: no handoff verify stage)."""
    from ..selection import unpack_fetch
    payload = assemble_splitfed_round(rng, seed_gen, data, clusters, pcfg, tm, t,
                                      x0.device)
    runner = splitfed_accept_runner(module, pcfg.lr, policy, quant=pcfg.comm.quant)
    theta, fetch = runner.accept(theta, payload, (x0, y0))
    vlosses, tlosses, selected, detections, accepted = unpack_fetch(
        fetch.cpu().numpy(), len(clusters))          # the round's one host sync
    record = dict(val_losses=[float(v) for v in vlosses],
                  train_losses=[float(v) for v in tlosses],
                  selected=selected, detections=detections, accepted=accepted)
    return theta, record


__all__ = ["assemble_round", "assemble_round_batches", "assemble_splitfed_round", "fedavg",
           "pigeon_round_accept", "round_client_seeds", "splitfed_accept_runner",
           "splitfed_round_accept", "splitfed_round_batched", "splitfed_round_spec",
           "splitfed_runner", "train_cluster_batched", "train_round_batched"]
