"""The job pool: concurrent Pigeon-SL jobs in shared stacked programs.

Many small protocol runs (one a tenant) each pay their own dispatch and host
syncs a round when run alone.  The pool packs them:

* :class:`JobSpec` — one job: module, data, protocol config, threat model,
  selection policy, wire format, checkpoint and resume knobs.
* :class:`JobPool` — validates the specs and buckets the compatible ones
  (the same module, lr, M, R, E, B, tamper settings, policy, wire and data
  shapes: everything that shapes the round's program).  Seeds, horizons T,
  threat models and eval and checkpoint cadences stay free per job: a
  threat model is lane data (``AttackVec`` lanes), not program.
* :func:`run_job_pool` — runs each bucket block by block through
  ``RoundRunner.pool_accept_block``: J jobs as the lanes of one stacked
  program of J * R slots (the replica form), an idle lane masked, one
  ``(J, K, 2R + 3)`` fetch a block.  A job that finishes frees its lane,
  which the bucket's queue refills between blocks; the fetch fans out to
  each job's History, checkpoints and telemetry round events.

Each job's History is its solo ``run_pigeon(engine="batched")``'s: a lane
trains its slots as its solo round does (``core/runner.py``, the replica
form), each lane's assembly consumes its job's streams in the solo order,
and the CommMeter replay is the solo block path's (``replayed_meter``).

Preconditions, checked up front and raising (a pooled lane cannot fall back
to host-side selection): no param-tamper threat models, no Pigeon-SL+, and a
model with a cluster-stacked form.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from .. import DeviceLike, resolve_device
from ..adversary import HONEST, Attack, AttackVec, ThreatModel, resolve_threat_model
from ..selection import resolve_policy, unpack_block_fetch
from ..telemetry import pool_gauges, resolve_telemetry
from .comm import CommConfig
from .protocol import (ClientData, History, ProtocolConfig, _check_engine, _count_params,
                       _pigeon_record, _run_state, _stager, _terminal_history, check_block,
                       cut_width, evaluate, replayed_meter)
from .runner import protocol_accept_runner
from .split import SplitModule, _stacked


@dataclasses.dataclass(frozen=True, eq=False)
class JobSpec:
    """One tenant's Pigeon-SL run, as the pool sees it.

    ``name`` keys the job's History, checkpoints and telemetry tags and is
    unique within a pool.  ``threat_model`` / ``(malicious, attack)``
    resolve as in ``run_pigeon``; ``selection`` is a policy name or
    instance; ``quant`` overrides ``pcfg.comm`` as ``run_pigeon``'s does."""
    name: str
    module: SplitModule
    data: ClientData
    pcfg: ProtocolConfig
    malicious: Optional[Set[int]] = None
    attack: Attack = HONEST
    threat_model: Optional[ThreatModel] = None
    selection: Any = "argmin"
    quant: Optional[str] = None
    checkpoint_path: Optional[str] = None
    checkpoint_every: int = 1
    resume: bool = False


def _resolved_pcfg(spec: JobSpec) -> ProtocolConfig:
    if spec.quant is None:
        return spec.pcfg
    return dataclasses.replace(spec.pcfg, comm=CommConfig(quant=spec.quant))


def validate_job(spec: JobSpec, block: int = 1) -> Tuple[Any, ThreatModel, ProtocolConfig]:
    """Resolve and check one spec for the pool: ``(policy, threat_model,
    resolved pcfg)``.  What ``run_pigeon`` degrades per run (a param-tamper
    threat model pins selection to the host cascade) raises here; the solo
    :func:`check_block` warnings still apply per job."""
    policy = resolve_policy(spec.selection)
    tm = resolve_threat_model(spec.malicious, spec.attack, spec.threat_model)
    pcfg = _resolved_pcfg(spec)
    if tm.has_param_tamper:
        raise ValueError(f"job {spec.name!r}: param-tamper threat models need host-side "
                         f"selection (handoff noise per visited candidate) and cannot run "
                         f"in a job pool — run it solo via run_pigeon")
    if pcfg.M % pcfg.R:
        raise ValueError(f"job {spec.name!r}: M={pcfg.M} not divisible by R={pcfg.R}")
    _stacked(spec.module)                # raises for a model with no stacked form
    check_block(block, "batched", eval_every=pcfg.eval_every,
                checkpoint_path=spec.checkpoint_path,
                checkpoint_every=spec.checkpoint_every)
    return policy, tm, pcfg


def bucket_key(spec: JobSpec) -> tuple:
    """Everything that shapes or parameterises the pool's program: jobs
    with one key share one runner; seed, T, threat model and the sync
    cadences are data or host schedule."""
    pcfg = _resolved_pcfg(spec)
    d = spec.data
    return (spec.module, pcfg.lr, pcfg.M, pcfg.R, pcfg.E, pcfg.B,
            pcfg.tamper_check, pcfg.tamper_tol, resolve_policy(spec.selection),
            pcfg.comm.quant,
            d.x.shape, d.x.dtype.str, d.y.shape, d.y.dtype.str,
            d.x0.shape, d.x0.dtype.str, d.y0.shape, d.y0.dtype.str)


class JobPool:
    """Validated, bucketed job queue.  :meth:`buckets` gives the job
    indices of each bucket, buckets in first-seen order, jobs in submission
    order (the lane-refill order)."""

    def __init__(self, specs: Sequence[JobSpec], *, block: int = 1,
                 placement: str = "vmap"):
        _check_engine("batched", placement)
        names = [s.name for s in specs]
        if len(set(names)) != len(names):
            dupes = sorted({n for n in names if names.count(n) > 1})
            raise ValueError(f"duplicate job names in pool: {dupes}")
        if not specs:
            raise ValueError("empty job pool")
        self.specs = list(specs)
        self.block = block
        self.placement = placement
        self._resolved = [validate_job(s, block) for s in specs]
        self._buckets: Dict[tuple, List[int]] = {}
        for i, s in enumerate(specs):
            self._buckets.setdefault(bucket_key(s), []).append(i)

    def buckets(self) -> List[List[int]]:
        return list(self._buckets.values())

    def resolved(self, i: int) -> Tuple[Any, ThreatModel, ProtocolConfig]:
        return self._resolved[i]


# ---------------------------------------------------------------------------
# per-job protocol state (the solo preamble)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _JobState:
    spec: JobSpec
    policy: Any
    tm: ThreatModel
    pcfg: ProtocolConfig
    rng: np.random.Generator
    seed_gen: torch.Generator
    param_gen: torch.Generator
    theta: Tuple[torch.nn.Module, torch.nn.Module]   # on the device, updated in place
    t: int                          # the next round to run
    hist: History
    d_cl: int
    d_c: int
    d_o: int
    x0: torch.Tensor
    y0: torch.Tensor
    terminal: bool = False          # resumed past T-1: nothing to train

    def ckpt_due(self, t: int) -> bool:
        return self.spec.checkpoint_path is not None and (
            (t + 1) % self.spec.checkpoint_every == 0 or t == self.pcfg.T - 1)

    def is_sync(self, t: int) -> bool:
        return t % self.pcfg.eval_every == 0 or t == self.pcfg.T - 1 or self.ckpt_due(t)


def _init_job(spec: JobSpec, policy, tm: ThreatModel, pcfg: ProtocolConfig,
              dev: torch.device) -> _JobState:
    """``run_pigeon``'s preamble for one job: the same draws in the same
    order, the same on-stream resume, the same terminal-resume record."""
    rng, theta, seed_gen, param_gen, start_round = _run_state(
        spec.module, pcfg, dev, spec.checkpoint_path, spec.resume)
    x0 = torch.from_numpy(spec.data.x0).to(dev)
    st = _JobState(spec=spec, policy=policy, tm=tm, pcfg=pcfg, rng=rng, seed_gen=seed_gen,
                   param_gen=param_gen, theta=theta, t=start_round, hist=History(),
                   d_cl=_count_params(theta[0]), d_c=cut_width(spec.module, theta[0], x0),
                   d_o=spec.data.x0.shape[0], x0=x0,
                   y0=torch.from_numpy(spec.data.y0).to(dev))
    if start_round >= pcfg.T:
        st.terminal = True
        st.hist = _terminal_history(spec.module, theta, spec.data, pcfg,
                                    spec.checkpoint_path, start_round, who=f"job {spec.name!r}")
    return st


# ---------------------------------------------------------------------------
# the pool's schedule: fixed up front, so the feeder can run ahead
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _BlockPlan:
    """One pool block: each lane's job index (-1 for an idle lane), each
    active lane's first round, and the block length K: the least of the
    active lanes' solo segment lengths, so a lane's sync round is always
    the last round it runs in a block (``lane_block_len``)."""
    assign: Tuple[int, ...]
    t0s: Tuple[int, ...]
    k: int


def plan_pool(states: Sequence[_JobState], order: Sequence[int], lanes: int,
              block: int) -> List[_BlockPlan]:
    """The whole pool's block schedule, computed before any round runs.
    Lane occupancy and block lengths depend only on the jobs' horizons and
    sync cadences, never on training outcomes, so the round feeder can
    assemble blocks ahead without changing any job's stream order."""
    from ..data.pipeline import lane_block_len
    queue = [i for i in order if not states[i].terminal]
    lane_job = [-1] * lanes
    lane_t = [0] * lanes
    for lane in range(lanes):
        if queue:
            j = queue.pop(0)
            lane_job[lane] = j
            lane_t[lane] = states[j].t
    plans: List[_BlockPlan] = []
    while any(j >= 0 for j in lane_job):
        k = min(lane_block_len(lane_t[l], states[j].pcfg.T, block, states[j].is_sync)
                for l, j in enumerate(lane_job) if j >= 0)
        plans.append(_BlockPlan(tuple(lane_job), tuple(lane_t), k))
        for lane, j in enumerate(lane_job):
            if j < 0:
                continue
            lane_t[lane] += k
            if lane_t[lane] >= states[j].pcfg.T:
                if queue:
                    nxt = queue.pop(0)
                    lane_job[lane] = nxt
                    lane_t[lane] = states[nxt].t
                else:
                    lane_job[lane] = -1
    return plans


# ---------------------------------------------------------------------------
# running the pool
# ---------------------------------------------------------------------------

def pool_rounds(block) -> List[Tuple]:
    """The K per-round replica payloads of a pool block ``(xs (J, K, R,
    M_bar, E, B, ...), ys, avecs (K of (J * R, M_bar)), seeds (J, K, R,
    M_bar))``: round i's lanes, views."""
    xs, ys, avecs, seeds = block
    return [(xs[:, i], ys[:, i], avec, seeds[:, i]) for i, avec in enumerate(avecs)]


def _replay_lane_rounds(st: _JobState, clusters_k, records, t0: int, snap, tel,
                        writes: bool = True) -> None:
    """One lane's rows of the pool's fetch as History records, CommMeter
    charges, evaluations, checkpoints and telemetry round events — the solo
    block path's replay, so the records are the solo run's.  An eval or
    checkpoint round is the lane's last round of the block (``plan_pool``),
    so ``st.theta`` is then that round's theta.  ``writes`` False (a rank
    other than 0 under the sharded placement) skips the checkpoints."""
    from ..checkpoint import job_checkpoint_metadata, save_checkpoint
    pcfg, spec = st.pcfg, st.spec
    for i, sel in enumerate(records):
        t, clusters = t0 + i, clusters_k[i]
        meter = replayed_meter(pcfg, clusters, sel, st.d_o, st.d_c, st.d_cl)
        rec = _pigeon_record(t, clusters, st.tm, meter, sel)
        if t % pcfg.eval_every == 0 or t == pcfg.T - 1:
            with tel.span("round.eval", round=t, job=spec.name):
                rec["test_acc"] = evaluate(spec.module, st.theta[0], st.theta[1],
                                           spec.data.x_test, spec.data.y_test,
                                           pcfg.eval_batch)
        st.hist.rounds.append(rec)
        if st.ckpt_due(t) and writes:
            with tel.span("round.checkpoint", round=t, job=spec.name):
                save_checkpoint(spec.checkpoint_path, st.theta,
                                job_checkpoint_metadata(t, snap, job=spec.name))
        tel.record_round(t, rec, job=spec.name)


def _run_bucket(states: List[_JobState], block: int, lanes: Optional[int], prefetch: int,
                tel, dev: torch.device, placement: str = "vmap") -> None:
    """One bucket's jobs through its shared pool program."""
    from .protocol import _writes
    from ..checkpoint import protocol_state_metadata
    from ..data.pipeline import DeviceStager, RoundFeeder
    from .engine import _batch_specs, _record, assemble_block

    runnable = [i for i, st in enumerate(states) if not st.terminal]
    if not runnable:
        return
    n_lanes = max(1, min(lanes if lanes else len(runnable), len(runnable)))
    plans = plan_pool(states, range(len(states)), n_lanes, block)
    st0 = states[runnable[0]]
    pcfg0, data0 = st0.pcfg, st0.spec.data
    runner = protocol_accept_runner(st0.spec.module, pcfg0.lr, st0.policy,
                                    pcfg0.tamper_check, pcfg0.tamper_tol,
                                    quant=pcfg0.comm.quant, placement=placement)
    writes = _writes(placement)
    m_bar = pcfg0.M // pcfg0.R
    stager = _stager(dev, prefetch)

    def _make_block(b):
        """Block b's payload: each active lane's K rounds assembled from its
        own job's streams by the solo block path's ``assemble_block``, into
        lane views of one ``(J, K, R, M_bar, E, B, ...)`` host buffer (one
        host-to-device copy a block); an idle lane copies the first active
        lane's payload (masked on the device, no stream consumed).  The
        stream snapshots for block-end checkpoints are taken right after
        each lane's assembly: the fused path draws nothing afterwards."""
        plan = plans[b]
        specs = _batch_specs(data0, pcfg0, (n_lanes, plan.k, pcfg0.R, m_bar))
        if stager is not None:
            xs, ys = stager.host_buffers(specs)
        else:
            xs, ys = (np.empty(shape, dt) for shape, dt in specs)
        per_lane: List[Optional[tuple]] = [None] * n_lanes
        avecs: List[Optional[list]] = [None] * n_lanes
        seeds: List[Optional[np.ndarray]] = [None] * n_lanes
        for lane, j in enumerate(plan.assign):
            if j < 0:
                continue
            st = states[j]
            clusters_k, (_, _, avecs[lane], seeds[lane]) = assemble_block(
                st.rng, st.seed_gen, st.spec.data, st.pcfg, st.tm, plan.t0s[lane],
                plan.k, None, out=(xs[lane], ys[lane]))
            snap = (protocol_state_metadata(st.rng, st.seed_gen, st.param_gen)
                    if st.spec.checkpoint_path is not None else None)
            per_lane[lane] = (clusters_k, snap)
        first = next(lane for lane, j in enumerate(plan.assign) if j >= 0)
        for lane, j in enumerate(plan.assign):
            if j < 0:
                xs[lane], ys[lane] = xs[first], ys[first]
                avecs[lane], seeds[lane] = avecs[first], seeds[first]
        avecs_k = tuple(AttackVec.cat([a[i] for a in avecs]) for i in range(plan.k))
        seeds_j = np.stack(seeds)                              # (J, K, R, M_bar)
        if stager is not None:
            return per_lane, stager.copy(xs, ys, avecs_k, (seeds_j,))
        return per_lane, (torch.from_numpy(xs).to(dev), torch.from_numpy(ys).to(dev),
                          tuple(a.to(dev) for a in avecs_k), seeds_j)

    feeder = RoundFeeder(_make_block, 0, len(plans), depth=prefetch, telemetry=tel)
    jobs_done = 0
    idle = None                          # an idle lane's placeholder theta
    prev_assign: Optional[Tuple[int, ...]] = None
    try:
        for b, plan in enumerate(plans):
            wait = (tel.span("pool.feeder_wait", block=b, depth=feeder.qsize())
                    if prefetch > 0 else tel.span("block.assemble", block=b, k=plan.k))
            with wait:
                per_lane, payload = feeder.get(b)
            if plan.assign != prev_assign:
                # lane churn: seat each lane's theta and validation set
                if idle is None and -1 in plan.assign:
                    idle = tuple(copy.deepcopy(m) for m in st0.theta)
                thetas = [states[j].theta if j >= 0 else idle for j in plan.assign]
                seated = [states[j] if j >= 0 else st0 for j in plan.assign]
                val_j = (torch.stack([st.x0 for st in seated]),
                         torch.stack([st.y0 for st in seated]))
                active_j = torch.tensor([j >= 0 for j in plan.assign], device=dev)
                prev_assign = plan.assign
            with tel.span("pool.step", block=b, k=plan.k,
                          active=sum(j >= 0 for j in plan.assign)) as sp:
                thetas, fetches = runner.pool_accept_block(
                    thetas, pool_rounds(DeviceStager.adopt(payload)), val_j, active_j)
                sp.fence(fetches)
            with tel.span("pool.fetch", block=b, k=plan.k):
                fetched = fetches.cpu().numpy()          # the pool block's one sync
            for lane, j in enumerate(plan.assign):
                if j < 0:
                    continue
                st = states[j]
                clusters_k, snap = per_lane[lane]
                records = [_record(*row) for row in unpack_block_fetch(fetched[lane],
                                                                      st.pcfg.R)]
                _replay_lane_rounds(st, clusters_k, records, plan.t0s[lane], snap, tel,
                                    writes)
                st.t = plan.t0s[lane] + plan.k
                jobs_done += st.t >= st.pcfg.T
            t0s = {states[j].spec.name: plan.t0s[lane]
                   for lane, j in enumerate(plan.assign) if j >= 0}
            tel.emit({"event": "pool_block", "block": b,
                      **pool_gauges(t0s, plan.k, n_lanes, jobs_done, len(runnable))})
    finally:
        feeder.close()


def run_job_pool(specs: Sequence[JobSpec], *, block: int = 1, placement: str = "vmap",
                 lanes: Optional[int] = None, prefetch: int = 0, telemetry=None,
                 verbose: bool = False, device: DeviceLike = None) -> Dict[str, History]:
    """Run a pool of Pigeon-SL jobs through shared stacked programs:
    ``{spec.name: History}``, each History its solo
    ``run_pigeon(engine="batched")``'s.

    * ``block`` — rounds a lane runs between fetches (the solo ``block``);
      a pool block runs K = the least of its active lanes' solo segment
      lengths, so every lane's eval and checkpoint rounds hold.
    * ``lanes`` — lanes a bucket (default one a job).  With fewer lanes than
      jobs, a finished job frees its lane and the queue refills it between
      blocks.
    * ``prefetch`` — assemble pool block b+1 on the round feeder's thread
      while block b runs (the schedule is fixed up front, so every job's
      streams keep their order).
    * ``placement`` — ``"vmap"`` (one card) or ``"sharded"``: a bucket's
      lanes over the ranks of the process group (``runner.cluster_mesh`` of
      the lane count), each rank running its lanes with no cross-lane
      collective; the fetches and the lanes' thetas are all-gathered after
      each block, so every rank returns every job's History.  Only rank 0
      writes checkpoints and telemetry.  ``device`` as in ``run_pigeon``."""
    from .protocol import _writes
    pool = JobPool(specs, block=block, placement=placement)
    dev = resolve_device(device)
    writes = _writes(placement)
    tel = resolve_telemetry(telemetry if writes else None, verbose=verbose and writes,
                            run="pool", jobs=len(specs),
                            block=block, placement=placement, lanes=lanes or 0,
                            buckets=len(pool.buckets()), device=str(dev))
    states: Dict[int, _JobState] = {}
    try:
        for bucket in pool.buckets():
            for i in bucket:
                states[i] = _init_job(pool.specs[i], *pool.resolved(i), dev)
            _run_bucket([states[i] for i in bucket], block, lanes, prefetch, tel, dev,
                        placement)
    finally:
        tel.close()
    return {pool.specs[i].name: states[i].hist for i in sorted(states)}


__all__ = ["JobPool", "JobSpec", "bucket_key", "plan_pool", "pool_rounds", "run_job_pool",
           "validate_job"]
