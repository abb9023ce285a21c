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

Round blocks: :func:`assemble_block` gathers K rounds' batches into one
``(K, R, M_bar, E, B, ...)`` host buffer (one host-to-device copy a block),
consuming the streams exactly as K per-round assemblies would, and
:func:`pigeon_block_accept` / :func:`splitfed_block_accept` run the K
rounds through ``RoundRunner.accept_block`` with one fetch a block.

The multi-seed sweep (:func:`run_pigeon_sweep`): S whole Pigeon-SL replicas
in lockstep, each seed's streams those of its solo ``run_pigeon(engine=
"batched")``, trained as one stacked program of S * R slots
(``RoundRunner.sweep``, the replica form), each seed selecting its own
winner; one fetch a round or a block.

Every driver entry takes ``placement``: ``"vmap"`` (the stacked round on
this card) or ``"sharded"`` (the cluster axis over the ranks of a process
group, ``runner.RoundRunner``).  Under the sharded placement every rank
assembles the whole round as the vmap path does, so the streams stay in
step, and the runner keeps the rank's clusters of it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from .. import DeviceLike, resolve_device
from ..adversary import HONEST, Attack, AttackVec, ThreatModel, resolve_threat_model
from ..telemetry import NULL_SESSION
from .clustering import cluster_is_honest, make_clusters
from .protocol import (ClientData, CommMeter, History, ProtocolConfig, _count_params,
                       account_client_turn, account_handoff_recheck,
                       round_client_seeds, sample_batch_idx, visited_candidates)
from .runner import (RoundRunner, RoundSpec, VerifyConfig, protocol_accept_runner,
                     protocol_round_spec, protocol_runner)
from .split import (SplitModule, _stacked, client_update_vec_impl,
                    client_update_vec_stats_impl, stack_params, unstack_slot)


# ---------------------------------------------------------------------------
# host-side assembly: batches, seeds and attack state for one round
# ---------------------------------------------------------------------------

def assemble_round_batches(rng: np.random.Generator, data: ClientData,
                           clusters: Sequence[Sequence[int]],
                           pcfg: ProtocolConfig, device: Optional[torch.device],
                           out: Optional[Tuple[np.ndarray, np.ndarray]] = None):
    """Sample every client's (E, B) mini-batches for the round, consuming the
    numpy RNG in the sequential engine's order (cluster-major, then client),
    gathered straight into one (R, M_bar, E, B, ...) host buffer and moved
    to ``device`` in one copy.  ``out=(xs, ys)`` gathers into those host
    buffers instead (views of a block's buffer, pinned staging) and returns
    them unmoved."""
    r, m_bar = len(clusters), len(clusters[0])
    if out is None:
        xs = np.empty((r, m_bar, pcfg.E, pcfg.B) + data.x.shape[2:], dtype=data.x.dtype)
        ys = np.empty((r, m_bar, pcfg.E, pcfg.B) + data.y.shape[2:], dtype=data.y.dtype)
    else:
        xs, ys = out
    for i, cluster in enumerate(clusters):
        for j, client in enumerate(cluster):
            idx = sample_batch_idx(rng, data.x[client].shape[0], pcfg.E, pcfg.B)
            np.take(data.x[client], idx, axis=0, out=xs[i, j])
            np.take(data.y[client], idx, axis=0, out=ys[i, j])
    if out is not None:
        return xs, ys
    return torch.from_numpy(xs).to(device), torch.from_numpy(ys).to(device)


def assemble_round(rng: np.random.Generator, seed_gen: torch.Generator,
                   data: ClientData, clusters: Sequence[Sequence[int]],
                   pcfg: ProtocolConfig, tm: ThreatModel, t: int,
                   device: Optional[torch.device],
                   out: Optional[Tuple[np.ndarray, np.ndarray]] = None):
    """One round's payload ``(xs, ys, avec, seeds)``: the stacked batches and
    AttackVec on ``device``, and the (R, M_bar) host array of per-turn noise
    seeds (:func:`~repro_torch.core.protocol.round_client_seeds`).  The one
    copy of the stream consumption order of the batched engine: the
    synchronous path, the round feeder's thread and the block assembler all
    call it.  With ``out`` the batches land in those host buffers and
    nothing moves (the AttackVec stays on the CPU)."""
    xs, ys = assemble_round_batches(rng, data, clusters, pcfg, device, out=out)
    seeds = round_client_seeds(seed_gen, clusters)
    avec = tm.attack_vec_for_clusters(clusters, t)
    return xs, ys, avec if out is not None else avec.to(device), seeds


def staged_round(stager, rng: np.random.Generator, seed_gen: torch.Generator,
                 data: ClientData, clusters: Sequence[Sequence[int]],
                 pcfg: ProtocolConfig, tm: ThreatModel, t: int):
    """:func:`assemble_round` through a
    :class:`~repro_torch.data.pipeline.DeviceStager`: the batches gathered
    into its pinned buffers and copied without blocking; returns the
    ``Staged`` payload the consumer adopts."""
    r, m_bar = len(clusters), len(clusters[0])
    xs, ys = stager.host_buffers(_batch_specs(data, pcfg, (r, m_bar)))
    xs, ys, avec, seeds = assemble_round(rng, seed_gen, data, clusters, pcfg, tm, t,
                                         None, out=(xs, ys))
    return stager.copy(xs, ys, avec, (seeds,))


def _batch_specs(data: ClientData, pcfg: ProtocolConfig, lead: Tuple[int, ...]):
    tail = (pcfg.E, pcfg.B)
    return (((*lead, *tail, *data.x.shape[2:]), data.x.dtype),
            ((*lead, *tail, *data.y.shape[2:]), data.y.dtype))


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
                        y0: torch.Tensor, with_stats: bool = False, prefetched=None,
                        telemetry=None, placement: str = "vmap") -> List[Dict[str, Any]]:
    """All R candidates of round t in one stacked pass, selection left to
    the host selector (``selection.select_host``, the param-tamper path; the
    default path is :func:`pigeon_round_accept`).  Each result holds a view
    into the stacked candidates; ``protocol.res_params`` / ``res_vacts``
    take out only the ones the selector visits.  ``prefetched`` is the
    round's payload when the round feeder assembled it (the streams are
    then already consumed, in this order).  ``placement="sharded"``: each
    rank trains its slice and the candidates are all-gathered, so the host
    selector runs alike on every rank."""
    tel = NULL_SESSION if telemetry is None else telemetry
    payload = _payload(prefetched, tel, t, rng, seed_gen, data, clusters, pcfg, tm,
                       x0.device)
    with tel.span("round.step", round=t) as sp:
        (gs, ps), aux, vlosses, vacts = protocol_runner(
            module, pcfg.lr, with_stats, quant=pcfg.comm.quant,
            placement=placement).candidates(theta, payload, (x0, y0))
        sp.fence(vlosses)
    losses, stats = aux if with_stats else (aux, None)
    _account_turns(meter, pcfg, clusters, d_c, _count_params(theta[0]))

    losses, vlosses, stats = _fetch_together(losses, vlosses, stats)  # one host sync
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
                        y0: torch.Tensor, policy, prefetched=None, telemetry=None,
                        placement: str = "vmap"):
    """The default batched round: training, validation and the whole
    acceptance cascade (policy score -> rank -> handoff verify -> commit) on
    the device, then the round's one fetch.  Returns ``(theta', record)``,
    theta' being theta's modules updated in place; ``record`` carries the
    History fields (val_losses / train_losses / selected / detections /
    accepted).  Only for threat models without handoff (param-tamper)
    attacks: those draw noise per visited candidate on the host.
    ``prefetched`` and ``placement`` as in :func:`train_round_batched`."""
    from ..selection import unpack_fetch
    if tm.has_param_tamper:
        raise ValueError("param-tamper threat models must use the host "
                         "selection cascade")
    tel = NULL_SESSION if telemetry is None else telemetry
    payload = _payload(prefetched, tel, t, rng, seed_gen, data, clusters, pcfg, tm,
                       x0.device)
    runner = protocol_accept_runner(module, pcfg.lr, policy,
                                    pcfg.tamper_check, pcfg.tamper_tol,
                                    quant=pcfg.comm.quant, placement=placement)
    with tel.span("round.step", round=t) as sp:
        theta, fetch = runner.accept(theta, payload, (x0, y0))
        sp.fence(fetch)
    _account_turns(meter, pcfg, clusters, d_c, _count_params(theta[0]))
    with tel.span("round.fetch", round=t):
        vlosses, tlosses, selected, detections, accepted = unpack_fetch(
            fetch.cpu().numpy(), len(clusters))      # the round's one host sync
    if pcfg.tamper_check:
        account_handoff_recheck(meter, pcfg, int(x0.shape[0]), d_c,
                                visited_candidates(detections, accepted))
    return theta, _record(vlosses, tlosses, selected, detections, accepted)


def _fetch_together(*tensors):
    """The f32 tensors (None skipped) read back in one transfer: numpy arrays
    of their shapes, bit-equal to reading each alone."""
    live = [t for t in tensors if t is not None]
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in live]).cpu().numpy()
    out, at = [], 0
    for t in tensors:
        if t is None:
            out.append(None)
            continue
        out.append(flat[at:at + t.numel()].reshape(tuple(t.shape)))
        at += t.numel()
    return out


def _record(vlosses, tlosses, selected, detections, accepted) -> Dict[str, Any]:
    """The History fields of one fetched round."""
    return dict(val_losses=[float(v) for v in vlosses],
                train_losses=[float(v) for v in tlosses],
                selected=selected, detections=detections, accepted=accepted)


def _payload(prefetched, tel, t, rng, seed_gen, data, clusters, pcfg, tm, device):
    """The round's payload: the feeder's (adopted onto the current stream)
    or assembled here, inside a ``round.assemble`` span (SplitFed's payload
    is the Pigeon round's)."""
    from ..data.pipeline import DeviceStager
    if prefetched is not None:
        return DeviceStager.adopt(prefetched)
    with tel.span("round.assemble", round=t):
        return assemble_round(rng, seed_gen, data, clusters, pcfg, tm, t, device)


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
                    quant=None, *, placement: str = "vmap") -> RoundRunner:
    """The candidates runner of SplitFed's host-selected batched path."""
    return RoundRunner(splitfed_round_spec(module, lr, with_stats, quant),
                       placement=placement)


def splitfed_accept_runner(module: SplitModule, lr: float, select, quant=None, *,
                           placement: str = "vmap") -> RoundRunner:
    """SplitFed's fused-selection runner: the policy cascade with the verify
    stage off (no chained handoff to tamper with).  Under the sharded
    placement each rank trains its clusters' clients and FedAvg stays the
    ``combine`` hook inside them."""
    spec = splitfed_round_spec(module, lr, with_stats=select.needs_message_stats,
                               quant=quant)
    return RoundRunner(spec, select=select, verify=VerifyConfig(enabled=False),
                       placement=placement)


#: SplitFed's payload is the Pigeon round's: the batches in the sequential
#: loop's order and one noise seed a client, (R, M_bar), drawn cluster-major
#: from the run's seed generator (the reference's per-client key splits)
assemble_splitfed_round = assemble_round


def splitfed_round_batched(module: SplitModule, theta, clusters, data: ClientData,
                           pcfg: ProtocolConfig, tm: ThreatModel, t: int,
                           rng: np.random.Generator, seed_gen: torch.Generator,
                           x0: torch.Tensor, y0: torch.Tensor,
                           with_stats: bool = False, prefetched=None,
                           telemetry=None, placement: str = "vmap") -> List[Dict[str, Any]]:
    """Batched SplitFed round, selection left to the caller (the host
    path).  Each result holds a view into the stacked cluster models;
    ``protocol.res_params`` takes out only the selected one."""
    tel = NULL_SESSION if telemetry is None else telemetry
    payload = _payload(prefetched, tel, t, rng, seed_gen, data, clusters, pcfg, tm,
                       x0.device)
    with tel.span("round.step", round=t) as sp:
        (g_avg, p_avg), aux, vlosses, vacts = splitfed_runner(
            module, pcfg.lr, with_stats, quant=pcfg.comm.quant,
            placement=placement).candidates(theta, payload, (x0, y0))
        sp.fence(vlosses)
    vlosses, stats = _fetch_together(vlosses, aux[1] if with_stats else None)
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
                          x0: torch.Tensor, y0: torch.Tensor, policy,
                          prefetched=None, telemetry=None, placement: str = "vmap"):
    """SplitFed's default batched round: FedAvg per cluster and the policy
    selection cascade on the device, then the round's one fetch.  Returns
    ``(theta', record)`` like :func:`pigeon_round_accept` (``detections``
    always 0 and ``accepted`` always True: no handoff verify stage)."""
    from ..selection import unpack_fetch
    tel = NULL_SESSION if telemetry is None else telemetry
    payload = _payload(prefetched, tel, t, rng, seed_gen, data, clusters, pcfg, tm,
                       x0.device)
    runner = splitfed_accept_runner(module, pcfg.lr, policy, quant=pcfg.comm.quant,
                                    placement=placement)
    with tel.span("round.step", round=t) as sp:
        theta, fetch = runner.accept(theta, payload, (x0, y0))
        sp.fence(fetch)
    with tel.span("round.fetch", round=t):
        fetched = unpack_fetch(fetch.cpu().numpy(), len(clusters))  # the one host sync
    return theta, _record(*fetched)


# ---------------------------------------------------------------------------
# round blocks: K host-assembled rounds, one fetch
# ---------------------------------------------------------------------------

def assemble_block(rng: np.random.Generator, seed_gen: torch.Generator,
                   data: ClientData, pcfg: ProtocolConfig, tm: ThreatModel, t0: int,
                   k: int, device: Optional[torch.device], out=None, stager=None):
    """The payload of the block of rounds ``t0 .. t0+k-1``: for each round
    in turn the cluster draw, then that round's :func:`assemble_round` —
    exactly the per-round order, so after it the streams stand where K
    per-round assemblies leave them (the fused path draws nothing after
    assembly, so this is the end-of-block state a checkpoint stores) — with
    every round's batches gathered into ONE ``(K, R, M_bar, E, B, ...)``
    host buffer (per-round ``out=`` views), moved in one copy.

    ``out=(xs_k, ys_k)`` gathers into the caller's buffers and returns the
    rest raw (the K AttackVecs on the CPU, the seeds) without moving
    anything; ``stager`` gathers into its pinned buffers and copies without
    blocking (a ``Staged`` block the consumer adopts).  Returns
    ``(clusters_k, block)`` with ``block = (xs_k, ys_k, avecs, seeds_k)``."""
    m_bar = pcfg.M // pcfg.R
    if out is not None:
        xs_k, ys_k = out
    elif stager is not None:
        xs_k, ys_k = stager.host_buffers(_batch_specs(data, pcfg, (k, pcfg.R, m_bar)))
    else:
        (xshape, xdt), (yshape, ydt) = _batch_specs(data, pcfg, (k, pcfg.R, m_bar))
        xs_k, ys_k = np.empty(xshape, xdt), np.empty(yshape, ydt)
    clusters_k, avecs, seeds = [], [], []
    for i in range(k):
        clusters = make_clusters(rng, pcfg.M, pcfg.R)
        _, _, avec, seed = assemble_round(rng, seed_gen, data, clusters, pcfg, tm, t0 + i,
                                          None, out=(xs_k[i], ys_k[i]))
        clusters_k.append(clusters)
        avecs.append(avec)
        seeds.append(seed)
    seeds_k = np.stack(seeds)
    if out is not None:
        return clusters_k, (xs_k, ys_k, avecs, seeds_k)
    if stager is not None:
        return clusters_k, stager.copy(xs_k, ys_k, tuple(avecs), (seeds_k,))
    return clusters_k, (torch.from_numpy(xs_k).to(device),
                        torch.from_numpy(ys_k).to(device),
                        tuple(a.to(device) for a in avecs), seeds_k)


#: SplitFed's block is the Pigeon block (its round payload is the Pigeon
#: round's)
assemble_splitfed_block = assemble_block


def block_rounds(block) -> List[Tuple]:
    """The K per-round ``accept`` inputs of a block payload (views)."""
    xs_k, ys_k, avecs, seeds_k = block
    return [(xs_k[i], ys_k[i], avecs[i], seeds_k[i]) for i in range(len(avecs))]


def _block_accept(runner, theta, clusters_k, t0: int, block, x0, y0, tel):
    from ..data.pipeline import DeviceStager
    from ..selection import unpack_block_fetch
    k = len(clusters_k)
    block = DeviceStager.adopt(block)
    with tel.span("block.step", round=t0, k=k) as sp:
        theta, fetches = runner.accept_block(theta, block_rounds(block), (x0, y0))
        sp.fence(fetches)
    with tel.span("block.fetch", round=t0, k=k):
        fetched = fetches.cpu().numpy()              # the block's one host sync
    return theta, [_record(*row) for row in unpack_block_fetch(fetched,
                                                               len(clusters_k[0]))]


def pigeon_block_accept(module: SplitModule, theta, clusters_k, pcfg: ProtocolConfig,
                        tm: ThreatModel, t0: int, block, x0: torch.Tensor,
                        y0: torch.Tensor, policy, telemetry=None, placement: str = "vmap"):
    """K consecutive fused acceptance rounds with one ``(K, 2R+3)`` fetch,
    the block form of :func:`pigeon_round_accept`: ``(theta', records)``,
    one History record a round.  No CommMeter accounting here: the driver
    replays each round's charges from the records and ``clusters_k``.  The
    same precondition as the per-round accept: no param-tamper families."""
    if tm.has_param_tamper:
        raise ValueError("param-tamper threat models must use the host "
                         "selection cascade")
    runner = protocol_accept_runner(module, pcfg.lr, policy, pcfg.tamper_check,
                                    pcfg.tamper_tol, quant=pcfg.comm.quant,
                                    placement=placement)
    return _block_accept(runner, theta, clusters_k, t0, block, x0, y0,
                         NULL_SESSION if telemetry is None else telemetry)


def splitfed_block_accept(module: SplitModule, theta, clusters_k, pcfg: ProtocolConfig,
                          t0: int, block, x0: torch.Tensor, y0: torch.Tensor, policy,
                          telemetry=None, placement: str = "vmap"):
    """SplitFed's round block: K FedAvg and selection-cascade rounds, one
    fetch — the block form of :func:`splitfed_round_accept`."""
    runner = splitfed_accept_runner(module, pcfg.lr, policy, quant=pcfg.comm.quant,
                                    placement=placement)
    return _block_accept(runner, theta, clusters_k, t0, block, x0, y0,
                         NULL_SESSION if telemetry is None else telemetry)


# ---------------------------------------------------------------------------
# the multi-seed sweep: S whole protocol replicas in lockstep
# ---------------------------------------------------------------------------

def sweep_round(module: SplitModule, lr: float, thetas, inputs, val, policy=None,
                quant: Optional[str] = None, placement: str = "vmap"):
    """One global round of S independent protocol replicas through
    ``RoundRunner.sweep``: per seed the cluster-parallel round, the
    policy's selection and the winner's carry, all S * R clusters as one
    stacked program.  ``thetas`` is the list of S thetas (updated in
    place); ``inputs`` the replica round payload
    (``runner.protocol_round_spec``).  Returns ``(thetas, train_aux (S, R,
    ...), vlosses (S, R), sels (S,))``, on the device."""
    with_stats = policy is not None and policy.needs_message_stats
    return protocol_runner(module, lr, with_stats, policy, quant,
                           placement=placement).sweep(thetas, inputs, val)


@torch.no_grad()
def evaluate_sweep(module: SplitModule, gammas, phis, x_test: np.ndarray,
                   y_test: np.ndarray, batch: int = 500) -> np.ndarray:
    """Per-seed test accuracy: each seed's ``module.predict`` over the test
    set in :func:`~repro_torch.core.protocol.evaluate`'s chunks (so each
    count is its solo run's), the correct counts kept on the device in one
    ``(S,)`` vector and fetched once."""
    if x_test.shape[0] == 0:
        return np.zeros(len(gammas))
    device = next(gammas[0].parameters()).device
    correct = torch.zeros(len(gammas), dtype=torch.int64, device=device)
    for i in range(0, x_test.shape[0], batch):
        xb = torch.from_numpy(x_test[i : i + batch]).to(device)
        yb = torch.from_numpy(y_test[i : i + batch]).to(device)
        correct += torch.stack([torch.sum(torch.argmax(module.predict(g, p, xb), dim=-1) == yb)
                                for g, p in zip(gammas, phis)])
    return correct.cpu().numpy() / float(np.prod(y_test.shape))   # the one fetch


def assemble_sweep_block(rngs, seed_gens, data: ClientData, pcfg: ProtocolConfig,
                         tm: ThreatModel, t0: int, k: int, device: Optional[torch.device]):
    """The sweep's rounds ``t0 .. t0+k-1``: per seed, :func:`assemble_block`
    on that seed's own streams (its solo run's order), all gathered into
    one ``(K, S, R, M_bar, E, B, ...)`` host buffer and moved in one copy.
    Returns ``(clusters (per seed, K partitions), the K replica round
    payloads)``."""
    s, m_bar = len(rngs), pcfg.M // pcfg.R
    (xshape, xdt), (yshape, ydt) = _batch_specs(data, pcfg, (k, s, pcfg.R, m_bar))
    xs, ys = np.empty(xshape, xdt), np.empty(yshape, ydt)
    clusters, avecs, seeds = [], [], []
    for i, (rng, gen) in enumerate(zip(rngs, seed_gens)):
        clusters_k, (_, _, avecs_k, seeds_k) = assemble_block(
            rng, gen, data, pcfg, tm, t0, k, None, out=(xs[:, i], ys[:, i]))
        clusters.append(clusters_k)
        avecs.append(avecs_k)
        seeds.append(seeds_k)
    xs_d, ys_d = torch.from_numpy(xs).to(device), torch.from_numpy(ys).to(device)
    seeds = np.stack(seeds, axis=1)                          # (K, S, R, M_bar)
    return clusters, [(xs_d[i], ys_d[i], AttackVec.cat([a[i] for a in avecs]).to(device),
                       seeds[i]) for i in range(k)]


def run_pigeon_sweep(module: SplitModule, data: ClientData, pcfg: ProtocolConfig,
                     malicious: Optional[Set[int]] = None, attack: Attack = HONEST,
                     seeds: Sequence[int] = (0, 1, 2), verbose: bool = False,
                     placement: str = "vmap", threat_model: Optional[ThreatModel] = None,
                     selection="argmin", quant: Optional[str] = None, telemetry=None,
                     block: int = 1, *, device: DeviceLike = None) -> List[History]:
    """S whole Pigeon-SL replicas (one a seed) advanced in lockstep: each
    round trains the S * R clusters as one stacked program and selects each
    seed's winner on the device (``selection``, per seed; no verify stage,
    no rollback), one fetch a round.  Each seed's streams are its solo
    ``run_pigeon(engine="batched")``'s (numpy, the init, the noise seeds),
    so its History holds the solo run's clusters, selections and losses;
    the records carry no ``accepted`` or ``detections`` (the winner always
    carries; the CommMeter charges one handoff re-check a round).

    * ``block`` — up to ``block`` rounds through ``RoundRunner.sweep_block``
      with one fetch; blocks end at eval rounds.
    * ``placement`` — ``"vmap"`` (one card) or ``"sharded"`` (the S x R
      replica grid over a ``(seed, pod)`` mesh of the process group's
      ranks, ``runner.sweep_mesh``; every rank returns every seed's
      History).  ``device``, ``quant``, ``threat_model``, ``telemetry`` as
      in ``run_pigeon``.  Param-tamper threat models raise: the handoff
      check is not modelled here."""
    from ..data.pipeline import plan_blocks
    from ..selection import resolve_policy
    from ..telemetry import resolve_telemetry
    from .comm import CommConfig
    from .protocol import (_check_engine, _eval_round, _run_state, _writes, check_block,
                           cut_width, replayed_meter)

    _check_engine("batched", placement)
    _stacked(module)                     # raises for a model with no stacked form
    dev = resolve_device(device)
    block = check_block(block, "batched", eval_every=pcfg.eval_every)
    if quant is not None:
        pcfg = dataclasses.replace(pcfg, comm=CommConfig(quant=quant))
    policy = resolve_policy(selection)
    tm = resolve_threat_model(malicious, attack, threat_model)
    if tm.has_param_tamper:
        raise ValueError("run_pigeon_sweep does not model the param-tamper handoff "
                         "check; use run_pigeon(engine=...) per seed")
    seeds = tuple(int(s) for s in seeds)
    rngs, seed_gens, thetas = [], [], []
    for s in seeds:                      # each seed's preamble: its solo run's
        rng, theta, seed_gen, _, _ = _run_state(module, dataclasses.replace(pcfg, seed=s),
                                                dev)
        rngs.append(rng)
        thetas.append(theta)
        seed_gens.append(seed_gen)
    x0 = torch.from_numpy(data.x0).to(dev)
    y0 = torch.from_numpy(data.y0).to(dev)
    d_o = data.x0.shape[0]
    d_cl = _count_params(thetas[0][0])
    d_c = cut_width(module, thetas[0][0], x0)
    hists = [History() for _ in seeds]
    tel = resolve_telemetry((telemetry if telemetry is not None else pcfg.telemetry)
                            if _writes(placement) else None,
                            run="sweep", placement=placement, block=block, T=pcfg.T,
                            M=pcfg.M, R=pcfg.R, seeds=list(seeds), selection=policy.name,
                            device=str(dev))
    runner = protocol_runner(module, pcfg.lr, policy.needs_message_stats, policy,
                             pcfg.comm.quant, placement=placement)
    segments = plan_blocks(0, pcfg.T, block, lambda t: _eval_round(t, pcfg))
    kind = "block" if block > 1 else "round"
    carried = dict(detections=0, accepted=True)       # the winner always carries
    try:
        for t0, k in segments:
            tel.profile_tick(t0)
            at = dict(round=t0, k=k) if block > 1 else dict(round=t0)
            with tel.span(f"{kind}.assemble", **at):
                clusters_sk, rounds = assemble_sweep_block(rngs, seed_gens, data, pcfg, tm,
                                                           t0, k, dev)
            with tel.span(f"{kind}.step", **at) as sp:
                thetas, (vl_k, tl_k, sels_k) = runner.sweep_block(thetas, rounds, (x0, y0))
                sp.fence(sels_k)
            with tel.span(f"{kind}.fetch", **at):      # the round's or block's one sync
                fetched = torch.cat([vl_k.flatten(), tl_k.flatten(),
                                     sels_k.flatten().to(torch.float32)]).cpu().numpy()
            n = vl_k.numel()
            vl_k = fetched[:n].reshape(vl_k.shape)
            tl_k = fetched[n:2 * n].reshape(vl_k.shape)
            sels_k = fetched[2 * n:].reshape(sels_k.shape).astype(np.int64)
            for i in range(k):
                t = t0 + i
                # accounting is analytic and the same for every seed
                meter = dataclasses.asdict(replayed_meter(pcfg, clusters_sk[0][i], carried,
                                                          d_o, d_c, d_cl))
                accs = None
                if _eval_round(t, pcfg):
                    # an eval round ends its block: thetas are round t's
                    with tel.span("round.eval", round=t):
                        accs = evaluate_sweep(module, [th[0] for th in thetas],
                                              [th[1] for th in thetas], data.x_test,
                                              data.y_test, pcfg.eval_batch)
                for j, seed in enumerate(seeds):
                    clusters, sel = clusters_sk[j][i], int(sels_k[i, j])
                    rec = dict(
                        round=t,
                        clusters=clusters,
                        val_losses=[float(v) for v in vl_k[i, j]],
                        train_losses=[float(v) for v in tl_k[i, j]],
                        selected=sel,
                        selected_honest=cluster_is_honest(clusters[sel], tm.malicious),
                        honest_cluster_exists=any(cluster_is_honest(c, tm.malicious)
                                                  for c in clusters),
                        comm=dict(meter),
                    )
                    if accs is not None:
                        rec["test_acc"] = float(accs[j])
                    hists[j].rounds.append(rec)
                    tel.record_round(t, rec, seed=seed)
                if verbose and _writes(placement):
                    acc_str = "" if accs is None else " acc=" + "/".join(
                        f"{a:.3f}" for a in accs)
                    print(f"[sweep] t={t:3d} sel={sels_k[i].tolist()}{acc_str}")
    finally:
        tel.close()
    return hists


__all__ = ["assemble_block", "assemble_round", "assemble_round_batches",
           "assemble_splitfed_block", "assemble_splitfed_round", "assemble_sweep_block",
           "block_rounds", "evaluate_sweep", "fedavg", "pigeon_block_accept",
           "pigeon_round_accept", "round_client_seeds", "run_pigeon_sweep",
           "splitfed_accept_runner", "splitfed_block_accept", "splitfed_round_accept",
           "splitfed_round_batched", "splitfed_round_spec", "splitfed_runner",
           "staged_round", "sweep_round", "train_cluster_batched", "train_round_batched",
           "visited_candidates"]
