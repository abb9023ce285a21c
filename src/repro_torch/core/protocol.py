"""Protocol drivers: Pigeon-SL (Algorithm 1) and Pigeon-SL+, on the
sequential engine (one client turn at a time) or the batched engine
(``engine.py``: the R clusters of a round as one stacked program), and the
paper's baselines: vanilla SL (one chain of all M clients) and clustered
SplitFed (each cluster's clients in parallel, FedAvg, selection by the
shared-set loss), SplitFed on both engines.

Every driver returns a ``History`` whose per-round records include test
accuracy, per-cluster validation losses, the selected cluster, whether that
cluster was honest, tamper-detection events, and message-count accounting
(floats and wire bytes transmitted, client passes) so that Table I's
complexity formulas can be checked against the measured counts.

Randomness: the numpy streams (clustering, batch sampling) are consumed in
exactly the reference's order, so cluster lists and batches match it bit for
bit.  The initial parameters are drawn on a CPU ``torch.Generator`` seeded
from ``pcfg.seed`` and then moved to the device, so a CPU run and a card run
start from the same parameters.  Noise follows one discipline in both
engines: each round draws one seed per (cluster, client) slot from the run's
CPU seed generator, cluster-major (:func:`round_client_seeds`), and each
client turn draws its attack noise, step by step, from a generator on the
run's device seeded with its slot's seed — so the two engines consume
identical noise.  The host selector's handoff-tampering noise comes from a
separate generator on the device.

Multi-round execution (batched engine): ``prefetch`` assembles round t+1 on
the round feeder's thread while the card runs round t, ``block=K`` runs up
to K rounds with one fetch, and ``checkpoint_path``/``resume`` save and
restore theta and all three random streams.  Each gives the History of the
plain per-round run: the assembly consumes the streams in the same order,
and the per-round records and CommMeter charges are replayed from the
fetched vectors.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch
from torch import nn

from .. import DeviceLike, resolve_device
from ..adversary import HONEST, Attack, ThreatModel, resolve_threat_model
from ..selection import host_score_context, resolve_policy, score_and_rank, select_host
from ..telemetry import NULL_SESSION, Telemetry, resolve_telemetry
from .clustering import cluster_is_honest, make_clusters
from .comm import FLOAT_BYTES, CommConfig, message_bytes
from .runner import PLACEMENTS, require_group
from .split import SplitModule, client_update, client_update_stats
from .validation import validation_loss

ENGINES = ("sequential", "batched")


@dataclasses.dataclass(frozen=True)
class ProtocolConfig:
    M: int                    # total clients
    N: int = 0                # tolerated malicious clients; R = N + 1
    T: int = 50               # global rounds
    E: int = 10               # mini-batch updates per client turn
    B: int = 64               # mini-batch size
    lr: float = 1e-3
    seed: int = 0
    tamper_check: bool = True
    tamper_tol: float = 1e-4
    eval_every: int = 1
    eval_batch: int = 500
    comm: CommConfig = CommConfig()
    # observability (spans, sinks, profiler windows; see repro_torch.telemetry);
    # None = off.  A driver's ``telemetry=`` argument takes precedence.
    telemetry: Optional[Telemetry] = None

    @property
    def R(self) -> int:
        return self.N + 1

    @property
    def quant(self) -> Optional[str]:
        """Cut-layer wire format (``None`` = f32) — see :mod:`.comm`."""
        return self.comm.quant


@dataclasses.dataclass
class ClientData:
    """Per-client local shards + the shared/reference and test sets (numpy,
    host memory; batches move to the device when sampled)."""
    x: np.ndarray             # (M, D_m, ...)
    y: np.ndarray             # (M, D_m)
    x0: np.ndarray            # (D_o, ...) shared validation inputs
    y0: np.ndarray            # (D_o,)
    x_test: np.ndarray
    y_test: np.ndarray


@dataclasses.dataclass
class CommMeter:
    """Message accounting in float-counts (Table I units: d_c, d_CL) and in
    wire bytes.  Float counts are format-independent; the ``*_bytes`` fields
    measure the actual wire (quantized cut-layer exchanges charge
    ``itemsize*elements + 4 bytes/row``; validation pushes and parameter
    handoffs always travel f32)."""
    activation_floats: int = 0      # cut-layer activations, both directions
    gradient_floats: int = 0        # cut-layer gradients
    param_floats: int = 0           # client-side parameter handoffs (d_CL)
    validation_floats: int = 0      # shared-set activations for validation/check
    client_passes: int = 0          # forward(+backward) passes through gamma (F_CL)
    activation_bytes: int = 0       # wire bytes of the uplink cut activations
    gradient_bytes: int = 0         # wire bytes of the downlink cut gradients
    param_bytes: int = 0            # wire bytes of parameter handoffs (f32)
    validation_bytes: int = 0       # wire bytes of validation pushes (f32)

    def total_comm(self) -> int:
        return (self.activation_floats + self.gradient_floats
                + self.param_floats + self.validation_floats)

    def total_bytes(self) -> int:
        return (self.activation_bytes + self.gradient_bytes
                + self.param_bytes + self.validation_bytes)

    def exchange_bytes(self) -> int:
        """Wire bytes of the two quantizable cut-layer message streams."""
        return self.activation_bytes + self.gradient_bytes


@dataclasses.dataclass
class History:
    rounds: List[Dict[str, Any]] = dataclasses.field(default_factory=list)

    def series(self, key):
        return [r.get(key) for r in self.rounds]


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _count_params(module: nn.Module) -> int:
    return int(sum(p.numel() for p in module.parameters()))


def sample_batch_idx(rng: np.random.Generator, n: int, e: int, b: int) -> np.ndarray:
    """(E, B) mini-batch indices for one client turn — the reference's
    single batch-sampling primitive, consumed identically."""
    return rng.integers(0, n, size=(e, b))


def round_client_seeds(gen: torch.Generator,
                       clusters: Sequence[Sequence[int]]) -> np.ndarray:
    """One noise seed per (cluster, client) slot of a round, (R, M_bar)
    int64, drawn from the run's CPU seed generator in cluster-major order —
    the counterpart of the reference's per-turn key splits, shared by both
    engines."""
    shape = (len(clusters), len(clusters[0]))
    return torch.randint(0, 2 ** 62, shape, generator=gen).numpy()


def turn_generator(seed, device: torch.device) -> torch.Generator:
    """The generator one client turn draws its attack noise from."""
    return torch.Generator(device=device).manual_seed(int(seed))


def _sample_batches(rng: np.random.Generator, x: np.ndarray, y: np.ndarray,
                    e: int, b: int, device: torch.device
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    idx = sample_batch_idx(rng, x.shape[0], e, b)
    return (torch.from_numpy(x[idx]).to(device),
            torch.from_numpy(y[idx]).to(device))


def account_client_turn(meter: CommMeter, pcfg: ProtocolConfig, d_c: int,
                        d_cl: int, handoff: bool) -> None:
    """Table I accounting for one client's turn (E batches of B samples:
    activations up, cut gradients down, plus the intra-cluster parameter
    handoff).  Each batch is one (B, d_c) message per direction under
    ``pcfg.comm.quant``; handoffs stay f32."""
    quant = pcfg.comm.quant
    n_samples = pcfg.E * pcfg.B
    meter.client_passes += n_samples
    meter.activation_floats += n_samples * d_c
    meter.gradient_floats += n_samples * d_c
    meter.activation_bytes += pcfg.E * message_bytes(quant, pcfg.B, d_c)
    meter.gradient_bytes += pcfg.E * message_bytes(quant, pcfg.B, d_c)
    if handoff:
        account_param_transfer(meter, d_cl)


def account_validation(meter: CommMeter, d_o: int, d_c: int) -> None:
    """One cluster's shared-set validation push (Section III-C) — always f32:
    quantizing the message the tamper check and selection scores read would
    let an attacker hide inside quantization noise."""
    meter.validation_floats += d_o * d_c
    meter.validation_bytes += d_o * d_c * FLOAT_BYTES
    meter.client_passes += d_o


def account_param_transfer(meter: CommMeter, n_floats: int) -> None:
    """A parameter transfer of ``n_floats`` f32 values (handoffs,
    broadcasts)."""
    meter.param_floats += n_floats
    meter.param_bytes += n_floats * FLOAT_BYTES


def account_handoff_recheck(meter: CommMeter, pcfg: ProtocolConfig, d_o: int,
                            d_c: int, visited: int = 1) -> None:
    """Tamper-check replay of the R-candidate handoff chain for ``visited``
    inspected candidates (shared-set push per cluster, f32)."""
    meter.validation_floats += visited * pcfg.R * d_o * d_c
    meter.validation_bytes += visited * pcfg.R * d_o * d_c * FLOAT_BYTES
    meter.client_passes += visited * pcfg.R * d_o


def account_splitfed_round(meter: CommMeter, pcfg: ProtocolConfig, clusters,
                           d_o: int, d_c: int, d_cl: int) -> None:
    """One SplitFed round's message accounting, analytic and so the same on
    both engines: every client runs its E x B exchanges from the same
    incoming params and uploads its client-side params for the FedAvg
    combine; each cluster pushes one shared-set validation; the selected
    cluster's client params broadcast to all M clients for the next
    round."""
    for cluster in clusters:
        for _ in cluster:
            account_client_turn(meter, pcfg, d_c, d_cl, handoff=True)
        account_validation(meter, d_o, d_c)
    account_param_transfer(meter, sum(len(c) for c in clusters) * d_cl)


@torch.no_grad()
def evaluate(module: SplitModule, gamma: nn.Module, phi: nn.Module,
             x_test: np.ndarray, y_test: np.ndarray, batch: int = 500) -> float:
    """Test accuracy; the correct-count stays on the device until one final
    sync."""
    if x_test.shape[0] == 0:
        return 0.0      # empty test set: zero correct out of zero, not a crash
    device = next(gamma.parameters()).device
    correct = torch.zeros((), dtype=torch.int64, device=device)
    for i in range(0, x_test.shape[0], batch):
        xb = torch.from_numpy(x_test[i : i + batch]).to(device)
        yb = torch.from_numpy(y_test[i : i + batch]).to(device)
        logits = module.predict(gamma, phi, xb)
        correct += torch.sum(torch.argmax(logits, dim=-1) == yb)
    return float(correct) / float(np.prod(y_test.shape))


# ---------------------------------------------------------------------------
# cluster-wise vanilla-SL training pass (lines 3-20 of Algorithm 1)
# ---------------------------------------------------------------------------

def train_cluster(module: SplitModule, gamma: nn.Module, phi: nn.Module,
                  cluster: Sequence[int], data: ClientData, pcfg: ProtocolConfig,
                  tm: ThreatModel, t: int, rng: np.random.Generator,
                  seeds: Sequence[int], meter: CommMeter, d_c: int,
                  collect_stats: bool = False):
    """One cluster's within-cluster client chain, on copies of (gamma, phi):
    theta^t stays as it was for the other clusters.  ``seeds`` holds one
    noise seed per client (:func:`round_client_seeds`).  With
    ``collect_stats`` additionally returns the (M_bar, S) per-client
    transmitted-message statistics; the parameter/loss arithmetic is the
    same either way."""
    gamma, phi = copy.deepcopy(gamma), copy.deepcopy(phi)
    device = next(gamma.parameters()).device
    d_cl = _count_params(gamma)
    losses, stats = [], []
    for j, client in enumerate(cluster):
        xs, ys = _sample_batches(rng, data.x[client], data.y[client], pcfg.E,
                                 pcfg.B, device)
        gen = turn_generator(seeds[j], device)
        a = tm.attack_for(client, t)
        if collect_stats:
            gamma, phi, loss, st = client_update_stats(
                module, a, gamma, phi, (xs, ys), pcfg.lr, gen,
                quant=pcfg.comm.quant)
            stats.append(st.cpu().numpy())
        else:
            gamma, phi, loss = client_update(module, a, gamma, phi, (xs, ys),
                                             pcfg.lr, gen,
                                             quant=pcfg.comm.quant)
        losses.append(float(loss))
        account_client_turn(meter, pcfg, d_c, d_cl, handoff=j < len(cluster) - 1)
    if collect_stats:
        return gamma, phi, float(np.mean(losses)), np.stack(stats)
    return gamma, phi, float(np.mean(losses))


@torch.no_grad()
def cut_width(module: SplitModule, gamma: nn.Module, x0: torch.Tensor) -> int:
    """d_c: per-sample width of the cut-layer activation message."""
    return int(np.prod(module.client_forward(gamma, x0[:1]).shape[1:]))


# ---------------------------------------------------------------------------
# Pigeon-SL / Pigeon-SL+
# ---------------------------------------------------------------------------

def res_params(res: Dict[str, Any]) -> Tuple[nn.Module, nn.Module]:
    """(gamma, phi) of one cluster result.  The batched engine's results are
    views into its stacked candidates; only the clusters the selector
    inspects are taken out as plain modules."""
    if "gamma" not in res:
        from .split import unstack_slot
        theta, gs, ps, _, r = res["_stacked"]
        res["gamma"] = unstack_slot(theta[0], gs, r)
        res["phi"] = unstack_slot(theta[1], ps, r)
    return res["gamma"], res["phi"]


def res_vacts(res: Dict[str, Any]) -> torch.Tensor:
    """The cluster's validation-time cut activations (for the handoff
    check)."""
    if "vacts" not in res:
        _, _, _, vacts, r = res["_stacked"]
        res["vacts"] = vacts[r]
    return res["vacts"]


def _train_round(module: SplitModule, theta, clusters, data: ClientData,
                 pcfg: ProtocolConfig, tm: ThreatModel, t: int,
                 rng: np.random.Generator, seed_gen: torch.Generator,
                 meter: CommMeter, d_c: int, x0: torch.Tensor, y0: torch.Tensor,
                 with_stats: bool = False, telemetry=None) -> List[Dict[str, Any]]:
    """Train all R clusters of round t from the same theta^t, one after
    another.  results[r] holds gamma/phi/vloss/vacts/cluster/train_loss (and
    msg_stats)."""
    tel = NULL_SESSION if telemetry is None else telemetry
    seeds = round_client_seeds(seed_gen, clusters)
    results = []
    with tel.span("round.step", round=t):
        for cluster, row in zip(clusters, seeds):
            out = train_cluster(module, theta[0], theta[1], cluster, data, pcfg,
                                tm, t, rng, row, meter, d_c, collect_stats=with_stats)
            g, p, train_loss = out[:3]
            vloss, vacts = validation_loss(module, g, p, x0, y0)
            res = dict(gamma=g, phi=p, vloss=float(vloss), vacts=vacts,
                       cluster=cluster, train_loss=train_loss)
            if with_stats:
                res["msg_stats"] = out[3]
            results.append(res)
    return results


def _noise_generators(init_gen: torch.Generator, device: torch.device
                      ) -> Tuple[torch.Generator, torch.Generator]:
    """The run's noise streams, seeded from the init stream after the
    parameters were drawn: the CPU generator of the per-turn seeds (drawn on
    the host, so no engine waits on the device for them) and the device
    generator of the host selector's handoff-tampering noise."""
    seeds = [int(torch.randint(0, 2 ** 62, (1,), generator=init_gen))
             for _ in range(2)]
    return (torch.Generator().manual_seed(seeds[0]),
            torch.Generator(device=device).manual_seed(seeds[1]))


def _check_engine(engine: str, placement: str = "vmap", prefetch: int = 0) -> None:
    """Validate the execution knobs as the reference does; the sharded
    placement also needs a process group (``launch/mesh.py``)."""
    if engine not in ENGINES:
        raise ValueError(f"engine={engine!r} must be one of {ENGINES}")
    if placement not in PLACEMENTS:
        raise ValueError(f"placement={placement!r} must be one of {PLACEMENTS}")
    if placement != "vmap" and engine != "batched":
        raise ValueError(f"placement={placement!r} requires engine='batched' "
                         f"(the sequential engine has no cluster axis to place)")
    if prefetch > 0 and engine != "batched":
        raise ValueError(f"prefetch={prefetch} requires engine='batched' "
                         f"(the sequential engine assembles per client turn)")
    if placement == "sharded":
        require_group()


def _writes(placement: str) -> bool:
    """Whether this process writes a run's checkpoints and telemetry: on
    one card always; under the sharded placement the group's rank 0 only
    (every rank computes the same History)."""
    if placement != "sharded":
        return True
    import torch.distributed as dist
    return dist.get_rank() == 0


@torch.no_grad()
def _broadcast_theta(theta) -> None:
    """Rank 0's theta on every rank, in place: after work every rank did
    alike (Pigeon-SL+'s sub-rounds under the sharded placement), so that no
    rank can drift from another by a bit."""
    import torch.distributed as dist
    for half in theta:
        for p in half.parameters():
            dist.broadcast(p.data, 0)


def check_block(block: int, engine: str = "batched", *, plus: bool = False,
                has_param_tamper: bool = False, force_host_selection: bool = False,
                eval_every: int = 1, checkpoint_path: Optional[str] = None,
                checkpoint_every: int = 1) -> int:
    """Validate the round-block knobs and return the block size that runs.

    Impossible combinations raise.  Where round t+1's data depends on round
    t's selection — Pigeon-SL+'s sub-rounds, param-tamper handoff noise, the
    host cascade — the block is forced to 1 with a warning, so callers can
    pass ``block=`` unconditionally (``prefetch`` falls back the same way).
    ``eval_every=1`` and ``checkpoint_every=1`` make every round a sync
    round: the block is kept, with a warning that it degrades to per-round
    execution."""
    import warnings
    if block < 1:
        raise ValueError(f"block={block} must be >= 1")
    if checkpoint_every < 1:
        raise ValueError(f"checkpoint_every={checkpoint_every} must be >= 1")
    if block == 1:
        return 1
    if engine != "batched":
        raise ValueError(f"block={block} requires engine='batched' (the sequential "
                         f"engine runs one client turn at a time and cannot chain rounds)")
    if plus:
        warnings.warn(f"block={block} forced to 1: Pigeon-SL+ sub-rounds sample the "
                      f"previous round's selected cluster, so round t+1's host "
                      f"assembly cannot run before round t's selection", stacklevel=3)
        return 1
    if has_param_tamper:
        warnings.warn(f"block={block} forced to 1: param-tamper threat models draw "
                      f"handoff noise per visited candidate during host-side "
                      f"selection, which is per-round", stacklevel=3)
        return 1
    if force_host_selection:
        warnings.warn(f"block={block} forced to 1: the host-side cascade needs every "
                      f"round's candidates on the host", stacklevel=3)
        return 1
    if eval_every == 1:
        warnings.warn(f"block={block} degrades to per-round execution: eval_every=1 "
                      f"makes every round an eval sync point — raise pcfg.eval_every "
                      f"to let rounds fuse", stacklevel=3)
    elif checkpoint_path is not None and checkpoint_every == 1:
        warnings.warn(f"block={block} degrades to per-round execution: "
                      f"checkpoint_every=1 checkpoints every round — raise "
                      f"checkpoint_every to let rounds fuse", stacklevel=3)
    return block


def _stager(dev: torch.device, prefetch: int):
    """The pinned staging of the feeder and block paths on a CUDA device
    (``prefetch + 1`` slots); None on the CPU, where a payload is the host
    buffer itself."""
    if dev.type != "cuda":
        return None
    from ..data.pipeline import DeviceStager
    return DeviceStager(dev, slots=prefetch + 1)


def _eval_round(t: int, pcfg: ProtocolConfig) -> bool:
    return t % pcfg.eval_every == 0 or t == pcfg.T - 1


def _evaluate_into(rec, module, theta, data: ClientData, pcfg: ProtocolConfig, t: int,
                   tel) -> None:
    if _eval_round(t, pcfg):
        with tel.span("round.eval", round=t):
            rec["test_acc"] = evaluate(module, theta[0], theta[1], data.x_test,
                                       data.y_test, pcfg.eval_batch)


def visited_candidates(detections: int, accepted: bool) -> int:
    """The candidates the cascade inspected, each one R-recipient handoff
    re-transmission as the host cascade charges it: the failures and the
    accepted one."""
    return detections + (1 if accepted else 0)


def replayed_meter(pcfg: ProtocolConfig, clusters, sel: Dict[str, Any], d_o: int,
                   d_c: int, d_cl: int) -> CommMeter:
    """One fused round's charges, replayed on the host from its fetched
    record (the block path, the sweep, the job pool): the client turns, the
    handoff re-checks of the visited candidates, the validation pushes and
    the winner's broadcast — what the per-round path charges as it goes."""
    meter = CommMeter()
    for cluster in clusters:
        for j in range(len(cluster)):
            account_client_turn(meter, pcfg, d_c, d_cl, handoff=j < len(cluster) - 1)
    if pcfg.tamper_check:
        account_handoff_recheck(meter, pcfg, d_o, d_c,
                                visited_candidates(sel["detections"], sel["accepted"]))
    for _ in clusters:
        account_validation(meter, d_o, d_c)
    if sel["accepted"]:
        account_param_transfer(meter, pcfg.R * d_cl)
    return meter


def _pigeon_record(t: int, clusters, tm: ThreatModel, meter: CommMeter,
                   sel: Dict[str, Any]) -> Dict[str, Any]:
    """One round's History record out of its selection outcome."""
    return dict(
        round=t,
        clusters=clusters,
        val_losses=sel["val_losses"],
        train_losses=sel["train_losses"],
        selected=sel["selected"],
        accepted=sel["accepted"],
        selected_honest=cluster_is_honest(clusters[sel["selected"]], tm.malicious),
        honest_cluster_exists=any(cluster_is_honest(c, tm.malicious) for c in clusters),
        detections=sel["detections"],
        comm=dataclasses.asdict(meter),
    )


def _resume(checkpoint_path: str, theta, rng: np.random.Generator,
            seed_gen: torch.Generator, param_gen: torch.Generator) -> int:
    """Restore theta (in place) and the three streams from a checkpoint;
    returns the first round still to run (0 with no checkpoint, and with a
    corrupt one, after a warning)."""
    import warnings
    from ..checkpoint import (CorruptCheckpointError, load_checkpoint,
                              restore_protocol_state, restore_pytree)
    try:
        _, meta = load_checkpoint(checkpoint_path)
        if "rng_state" not in meta:
            raise CorruptCheckpointError("no random-stream snapshot in its manifest")
        restore_pytree(checkpoint_path, theta)
        restore_protocol_state(rng, seed_gen, param_gen, meta)
        return int(meta.get("round", -1)) + 1
    except FileNotFoundError:
        return 0
    except CorruptCheckpointError as e:
        warnings.warn(f"ignoring corrupt checkpoint {checkpoint_path!r} ({e}); "
                      f"starting from round 0", stacklevel=3)
        return 0


def _run_state(module: SplitModule, pcfg: ProtocolConfig, dev: torch.device,
               checkpoint_path: Optional[str] = None, resume: bool = False):
    """A Pigeon-SL run's preamble (``run_pigeon``'s, and each job's of the
    pool): the numpy stream, theta drawn from the CPU init stream and moved
    to ``dev``, the two noise generators seeded from the init stream, and
    with ``resume`` theta and the three streams restored from the
    checkpoint.  Returns ``(rng, theta, seed_gen, param_gen, start_round)``."""
    rng = np.random.default_rng(pcfg.seed)
    init_gen = torch.Generator().manual_seed(pcfg.seed)
    theta = tuple(copy.deepcopy(m).to(dev) for m in module.init(init_gen))
    seed_gen, param_gen = _noise_generators(init_gen, dev)
    start_round = 0
    if resume and checkpoint_path is not None:
        start_round = _resume(checkpoint_path, theta, rng, seed_gen, param_gen)
    return rng, theta, seed_gen, param_gen, start_round


def _terminal_history(module: SplitModule, theta, data: ClientData, pcfg: ProtocolConfig,
                      checkpoint_path: Optional[str], start_round: int,
                      who: str = "resume") -> History:
    """The History of a resume whose checkpoint already covers the last
    round: its restored state's test accuracy, rather than an empty
    History."""
    import warnings
    warnings.warn(f"{who}: checkpoint {checkpoint_path!r} is at round "
                  f"{start_round - 1} >= T-1 = {pcfg.T - 1}; nothing left to train "
                  f"— returning the restored final state", stacklevel=3)
    hist = History()
    hist.rounds.append(dict(round=start_round - 1, resumed_terminal=True,
                            test_acc=evaluate(module, theta[0], theta[1], data.x_test,
                                              data.y_test, pcfg.eval_batch)))
    return hist


def run_pigeon(module: SplitModule, data: ClientData, pcfg: ProtocolConfig,
               malicious: Optional[Set[int]] = None, attack: Attack = HONEST,
               plus: bool = False, *, engine: str = "sequential",
               placement: str = "vmap", prefetch: int = 0, block: int = 1,
               checkpoint_every: int = 1, threat_model: Optional[ThreatModel] = None,
               selection="argmin", quant: Optional[str] = None,
               device: DeviceLike = None, verbose: bool = False,
               checkpoint_path: Optional[str] = None, resume: bool = False,
               telemetry=None, _force_host_selection: bool = False) -> History:
    """Pigeon-SL (Algorithm 1): each round trains the R clusters from
    theta^t, validates them on the shared set, and runs the acceptance
    cascade (rank -> handoff check -> commit or roll back).

    * ``engine`` — ``"sequential"`` (one client turn at a time, host
      cascade) or ``"batched"`` (the R clusters as one stacked program; the
      whole cascade runs on the device and the round reads back one vector,
      except for param-tamper threat models, which take the host cascade,
      as does ``_force_host_selection``).  Both select the same clusters and
      count bit-identical messages.
    * ``placement`` — batched engine only: ``"vmap"`` (one card) or
      ``"sharded"``: the cluster axis over the ranks of a
      ``torch.distributed`` process group (``launch/mesh.py``; one process
      a card, every rank calling with the same arguments and returning the
      same History).  Each rank trains R / d clusters of the mesh
      (``runner.cluster_mesh``); the features are all-gathered and the
      winner all-reduced.  Pigeon-SL+'s sub-rounds run on every rank alike
      (rank 0's theta broadcast after them); only rank 0 writes
      checkpoints and telemetry, every rank reads on ``resume``.
    * ``device`` — the CUDA card by default (raises without one); ``"cpu"``
      on request.
    * ``quant`` — cut-layer wire format shorthand (``"int8"`` /
      ``"fp8_e4m3"``; ``None`` keeps ``pcfg.comm``).
    * ``selection`` — ``"argmin"`` (the paper's rule),
      ``"median_of_means"``, ``"loss_plus_distance"``, ``"trimmed"`` or a
      policy instance.
    * ``plus`` — Pigeon-SL+: R-1 extra sub-rounds on the selected cluster
      after an accepted round.
    * ``prefetch`` — batched engine only: assemble up to ``prefetch``
      rounds ahead on the round feeder's thread
      (``data/pipeline.py::RoundFeeder``; on a CUDA card through pinned
      staging buffers and a copy stream), consuming the streams in the
      synchronous order.  Synchronous for Pigeon-SL+ and param-tamper
      threat models, whose round t+1 depends on round t's selection.
    * ``block`` — batched engine only: run up to ``block`` consecutive
      rounds through ``RoundRunner.accept_block`` with one ``(K, 2R+3)``
      fetch, the per-round History and CommMeter replayed from it.  Blocks
      end at eval and checkpoint rounds; :func:`check_block` forces 1 where
      rounds cannot chain.
    * ``checkpoint_path`` / ``checkpoint_every`` / ``resume`` — after round
      t with ``(t+1) % checkpoint_every == 0`` (and after the last), save
      theta and the three random streams atomically; ``resume`` continues
      from the last checkpoint on-stream, reproducing the uninterrupted run.
      A corrupt checkpoint is skipped with a warning.
    * ``telemetry`` — a :class:`~repro_torch.telemetry.Telemetry` config or
      an open session (borrowed, not closed); overrides
      ``pcfg.telemetry``.  ``verbose=True`` adds the console sink.  The
      History is the same with it on or off.
    """
    _check_engine(engine, placement, prefetch)
    if engine == "batched":
        from .split import _stacked
        _stacked(module)                 # raises for a model with no stacked form
    dev = resolve_device(device)
    if quant is not None:
        pcfg = dataclasses.replace(pcfg, comm=CommConfig(quant=quant))
    policy = resolve_policy(selection)
    tm = resolve_threat_model(malicious, attack, threat_model)
    block = check_block(block, engine, plus=plus, has_param_tamper=tm.has_param_tamper,
                        force_host_selection=_force_host_selection,
                        eval_every=pcfg.eval_every, checkpoint_path=checkpoint_path,
                        checkpoint_every=checkpoint_every)
    # The fused on-device cascade covers every message-level threat model;
    # handoff (param-tamper) attacks draw their noise per visited candidate
    # on the host, so they pin selection to the host cascade.
    fused = engine == "batched" and not tm.has_param_tamper and not _force_host_selection
    rng, theta, seed_gen, param_gen, start_round = _run_state(module, pcfg, dev,
                                                              checkpoint_path, resume)
    if start_round >= pcfg.T:
        return _terminal_history(module, theta, data, pcfg, checkpoint_path, start_round)
    x0 = torch.from_numpy(data.x0).to(dev)
    y0 = torch.from_numpy(data.y0).to(dev)
    d_o = data.x0.shape[0]
    d_cl = _count_params(theta[0])
    d_c = cut_width(module, theta[0], x0)
    hist = History()
    writes = _writes(placement)
    tel = resolve_telemetry(
        (telemetry if telemetry is not None else pcfg.telemetry) if writes else None,
        verbose=verbose and writes,
        run=f"pigeon{'+' if plus else ''}", engine=engine, placement=placement,
        prefetch=prefetch, block=block, T=pcfg.T, M=pcfg.M, R=pcfg.R,
        selection=policy.name, fused_selection=fused, device=str(dev))

    def _ckpt_due(t: int) -> bool:
        return checkpoint_path is not None and (
            (t + 1) % checkpoint_every == 0 or t == pcfg.T - 1)

    def _snapshot():
        from ..checkpoint import protocol_state_metadata
        return (protocol_state_metadata(rng, seed_gen, param_gen)
                if checkpoint_path is not None else None)

    def _checkpoint(t: int, snap) -> None:
        if _ckpt_due(t) and writes:
            from ..checkpoint import job_checkpoint_metadata, save_checkpoint
            with tel.span("round.checkpoint", round=t):
                save_checkpoint(checkpoint_path, theta, job_checkpoint_metadata(
                    t, snap if snap is not None else _snapshot()))

    if block > 1:
        # Round blocks (check_block leaves only the fused path here): K
        # rounds with one fetch, the records and CommMeter charges replayed
        # per round.  Blocks end at sync rounds, since theta surfaces only
        # after a block's last round; the K-round assembly goes through the
        # feeder (block-indexed), so prefetch overlaps block b+1's assembly
        # with block b on the card.
        from ..data.pipeline import RoundFeeder, plan_blocks
        from .engine import assemble_block, pigeon_block_accept

        segments = plan_blocks(start_round, pcfg.T, block,
                               lambda t: _eval_round(t, pcfg) or _ckpt_due(t))
        stager = _stager(dev, prefetch)

        def _make_block(b):
            t0, k = segments[b]
            clusters_k, payload = assemble_block(rng, seed_gen, data, pcfg, tm, t0, k,
                                                 dev, stager=stager)
            # the fused path draws nothing after assembly: the streams'
            # state now is the synchronous state at the block's end
            return clusters_k, payload, _snapshot()

        feeder = RoundFeeder(_make_block, 0, len(segments), depth=prefetch, telemetry=tel)
        try:
            for b, (t0, k) in enumerate(segments):
                tel.profile_tick(t0)
                wait = (tel.span("round.feeder_wait", round=t0, depth=feeder.qsize())
                        if prefetch > 0 else tel.span("block.assemble", round=t0, k=k))
                with wait:
                    clusters_k, payload, snap = feeder.get(b)
                theta, records = pigeon_block_accept(module, theta, clusters_k, pcfg, tm,
                                                     t0, payload, x0, y0, policy,
                                                     telemetry=tel, placement=placement)
                for i, sel in enumerate(records):
                    t, clusters = t0 + i, clusters_k[i]
                    meter = replayed_meter(pcfg, clusters, sel, d_o, d_c, d_cl)
                    rec = _pigeon_record(t, clusters, tm, meter, sel)
                    # an eval round ends its block, so theta is round t's
                    _evaluate_into(rec, module, theta, data, pcfg, t, tel)
                    hist.rounds.append(rec)
                    _checkpoint(t, snap)
                    tel.record_round(t, rec, feeder_depth=(feeder.qsize()
                                                           if prefetch > 0 else None))
        finally:
            feeder.close()
            tel.close()
        return hist

    # The round feeder: round t+1's assembly overlaps round t on the card.
    # Synchronous where sampling depends on round t's outcome: Pigeon-SL+
    # sub-rounds sample the selected cluster, and param-tamper threat models
    # draw handoff noise during selection.
    feeder = None
    if engine == "batched" and prefetch > 0 and not plus and not tm.has_param_tamper:
        from ..data.pipeline import RoundFeeder
        from .engine import assemble_round, staged_round
        stager = _stager(dev, prefetch)

        def _make_round(t):
            clusters = make_clusters(rng, pcfg.M, pcfg.R)
            if stager is not None:
                payload = staged_round(stager, rng, seed_gen, data, clusters, pcfg, tm, t)
            else:
                payload = assemble_round(rng, seed_gen, data, clusters, pcfg, tm, t, dev)
            # the streams' state right after round t's assembly is the
            # synchronous end-of-round-t state (no sub-rounds, no handoff
            # noise on this path): round t's checkpoint stores it
            return clusters, payload, _snapshot()

        feeder = RoundFeeder(_make_round, start_round, pcfg.T, depth=prefetch,
                             telemetry=tel)
    if engine == "batched":
        from .engine import (pigeon_round_accept, train_cluster_batched,
                             train_round_batched)

    try:
        for t in range(start_round, pcfg.T):
            tel.profile_tick(t)
            meter = CommMeter()
            if feeder is not None:
                with tel.span("round.feeder_wait", round=t, depth=feeder.qsize()):
                    clusters, prefetched, snap = feeder.get(t)
            else:
                clusters, prefetched, snap = make_clusters(rng, pcfg.M, pcfg.R), None, None
            if fused:
                theta, sel = pigeon_round_accept(
                    module, theta, clusters, data, pcfg, tm, t, rng, seed_gen,
                    meter, d_c, x0, y0, policy, prefetched=prefetched, telemetry=tel,
                    placement=placement)
            else:
                if engine == "batched":
                    results = train_round_batched(
                        module, theta, clusters, data, pcfg, tm, t, rng, seed_gen, meter,
                        d_c, x0, y0, with_stats=policy.needs_message_stats,
                        prefetched=prefetched, telemetry=tel, placement=placement)
                else:
                    results = _train_round(module, theta, clusters, data, pcfg, tm, t,
                                           rng, seed_gen, meter, d_c, x0, y0,
                                           with_stats=policy.needs_message_stats,
                                           telemetry=tel)
                with tel.span("round.select", round=t):
                    outcome = select_host(policy, module, results, theta, tm, t,
                                          param_gen, pcfg, meter, x0, y0, d_c)
                theta = outcome.theta
                sel = dict(selected=outcome.selected, accepted=outcome.accepted,
                           detections=outcome.detections,
                           val_losses=[res["vloss"] for res in results],
                           train_losses=[res["train_loss"] for res in results])
                # the candidates are done with: free them before the
                # sub-rounds and the next round train (an LM's candidate is
                # gigabytes)
                del results, outcome
            sel_cluster = clusters[sel["selected"]]
            for _ in clusters:
                account_validation(meter, d_o, d_c)
            if sel["accepted"]:
                # broadcast to next first clients (no broadcast happens when
                # every cluster failed the tamper check and theta^t is kept)
                account_param_transfer(meter, pcfg.R * d_cl)

            # Pigeon-SL+: R-1 extra sub-rounds on the selected cluster — only
            # when the round was accepted: re-training a tamper-flagged
            # cluster from theta^t would hand a detected attacker R-1 free
            # extra turns.
            if plus and sel["accepted"]:
                with tel.span("round.subrounds", round=t, n=pcfg.R - 1):
                    for _ in range(pcfg.R - 1):
                        if engine == "batched":
                            g, p, _ = train_cluster_batched(module, theta, sel_cluster,
                                                            data, pcfg, tm, t, rng,
                                                            seed_gen, meter, d_c)
                        else:
                            seeds = round_client_seeds(seed_gen, [sel_cluster])[0]
                            g, p, _ = train_cluster(module, theta[0], theta[1],
                                                    sel_cluster, data, pcfg, tm, t,
                                                    rng, seeds, meter, d_c)
                        theta = (g, p)
                        account_param_transfer(meter, _count_params(g))  # subround handoff
                    if placement == "sharded":
                        _broadcast_theta(theta)

            rec = _pigeon_record(t, clusters, tm, meter, sel)
            _evaluate_into(rec, module, theta, data, pcfg, t, tel)
            hist.rounds.append(rec)
            _checkpoint(t, snap)
            tel.record_round(t, rec, feeder_depth=(feeder.qsize()
                                                   if feeder is not None else None))
    finally:
        if feeder is not None:
            feeder.close()
        tel.close()
    return hist


def run_pigeon_plus(module: SplitModule, data: ClientData, pcfg: ProtocolConfig,
                    malicious: Optional[Set[int]] = None, attack: Attack = HONEST,
                    **kwargs) -> History:
    """Pigeon-SL+ (throughput-matched variant): :func:`run_pigeon` with the
    R-1 extra selected-cluster sub-rounds enabled."""
    return run_pigeon(module, data, pcfg, malicious, attack, plus=True, **kwargs)


# ---------------------------------------------------------------------------
# vanilla SL (the paper's baseline)
# ---------------------------------------------------------------------------

def run_vanilla_sl(module: SplitModule, data: ClientData, pcfg: ProtocolConfig,
                   malicious: Optional[Set[int]] = None, attack: Attack = HONEST,
                   verbose: bool = False, threat_model: Optional[ThreatModel] = None,
                   quant: Optional[str] = None, telemetry=None, *,
                   device: DeviceLike = None) -> History:
    """Vanilla SL: each round one chain of all M clients in a random order
    (no clusters, no selection, no check), its last client handing off to
    the next round.  ``telemetry``/``verbose`` as in :func:`run_pigeon`."""
    dev = resolve_device(device)
    if quant is not None:
        pcfg = dataclasses.replace(pcfg, comm=CommConfig(quant=quant))
    tm = resolve_threat_model(malicious, attack, threat_model)
    rng = np.random.default_rng(pcfg.seed)
    init_gen = torch.Generator().manual_seed(pcfg.seed)
    gamma, phi = (copy.deepcopy(m).to(dev) for m in module.init(init_gen))
    seed_gen, _ = _noise_generators(init_gen, dev)
    d_c = cut_width(module, gamma, torch.from_numpy(data.x0[:1]).to(dev))
    hist = History()
    tel = resolve_telemetry(telemetry if telemetry is not None else pcfg.telemetry,
                            verbose=verbose, run="vanilla", T=pcfg.T, M=pcfg.M,
                            device=str(dev))
    try:
        for t in range(pcfg.T):
            tel.profile_tick(t)
            meter = CommMeter()
            order = rng.permutation(pcfg.M).tolist()
            seeds = round_client_seeds(seed_gen, [order])[0]
            with tel.span("round.step", round=t):
                gamma, phi, train_loss = train_cluster(module, gamma, phi, order, data,
                                                       pcfg, tm, t, rng, seeds, meter, d_c)
            account_param_transfer(meter, _count_params(gamma))   # hand-off to round t+1
            rec = dict(round=t, train_loss=train_loss, comm=dataclasses.asdict(meter))
            _evaluate_into(rec, module, (gamma, phi), data, pcfg, t, tel)
            hist.rounds.append(rec)
            tel.record_round(t, rec)
    finally:
        tel.close()
    return hist


# ---------------------------------------------------------------------------
# SplitFed baseline (Section V: SFL + our clustering & validation selection)
# ---------------------------------------------------------------------------

@torch.no_grad()
def _average(modules: Sequence[nn.Module]) -> nn.Module:
    """FedAvg of plain halves: each parameter the mean of the clients'."""
    out = copy.deepcopy(modules[0])
    for p, *ps in zip(out.parameters(), *(m.parameters() for m in modules)):
        p.copy_(torch.stack(ps).mean(dim=0))
    return out


def _splitfed_round(module: SplitModule, theta, clusters, data: ClientData,
                    pcfg: ProtocolConfig, tm: ThreatModel, t: int,
                    rng: np.random.Generator, seed_gen: torch.Generator,
                    x0: torch.Tensor, y0: torch.Tensor, with_stats: bool
                    ) -> List[Dict[str, Any]]:
    """SplitFed's round on the sequential engine: every client of every
    cluster trains from theta^t, one turn after another (cluster-major, the
    batched engine's stream order), and each cluster's model is the mean of
    its clients'."""
    device = x0.device
    seeds = round_client_seeds(seed_gen, clusters)
    results = []
    for cluster, row in zip(clusters, seeds):
        gs, ps, sts = [], [], []
        for client, seed in zip(cluster, row):
            xs, ys = _sample_batches(rng, data.x[client], data.y[client], pcfg.E,
                                     pcfg.B, device)
            gen = turn_generator(seed, device)
            a = tm.attack_for(client, t)
            g, p = copy.deepcopy(theta[0]), copy.deepcopy(theta[1])
            if with_stats:
                g, p, _, st = client_update_stats(module, a, g, p, (xs, ys), pcfg.lr,
                                                  gen, quant=pcfg.comm.quant)
                sts.append(st.cpu().numpy())
            else:
                g, p, _ = client_update(module, a, g, p, (xs, ys), pcfg.lr, gen,
                                        quant=pcfg.comm.quant)
            gs.append(g)
            ps.append(p)
        g_avg, p_avg = _average(gs), _average(ps)
        vloss, vacts = validation_loss(module, g_avg, p_avg, x0, y0)
        res = dict(gamma=g_avg, phi=p_avg, vacts=vacts, vloss=float(vloss),
                   cluster=cluster)
        if sts:
            res["msg_stats"] = np.stack(sts)
        results.append(res)
    return results


def run_splitfed(module: SplitModule, data: ClientData, pcfg: ProtocolConfig,
                 malicious: Optional[Set[int]] = None, attack: Attack = HONEST,
                 verbose: bool = False, engine: str = "sequential",
                 placement: str = "vmap", prefetch: int = 0, block: int = 1,
                 threat_model: Optional[ThreatModel] = None, selection="argmin",
                 quant: Optional[str] = None, telemetry=None,
                 _force_host_selection: bool = False, *,
                 device: DeviceLike = None) -> History:
    """Clustered SplitFed: clients inside a cluster train *in parallel* from
    the same incoming params; the cluster model is the FedAvg of its
    clients, and the policy (``selection``) picks a cluster by its
    shared-set validation.  No handoff check, no sub-round.

    * ``engine`` — ``"sequential"`` (one client turn at a time) or
      ``"batched"`` (all R * M_bar clients as one stacked program; the
      FedAvg combine, validation and the selection cascade on the device,
      one fetch a round; ``_force_host_selection`` keeps the batched
      training and selects on the host instead).  Both engines select the
      same clusters and count bit-identical messages.
    * ``device``, ``quant``, ``selection``, ``telemetry``, ``verbose``,
      ``placement`` — as :func:`run_pigeon` (sharded: each rank trains its
      clusters' clients, FedAvg staying inside them).
    * ``prefetch``, ``block`` — as :func:`run_pigeon`.  SplitFed's sampling
      never depends on the previous round's selection, so the feeder runs at
      full depth and blocks chain under every threat model; blocks end only
      at eval rounds."""
    _check_engine(engine, placement, prefetch)
    if engine == "batched":
        from .split import _stacked
        _stacked(module)                 # raises for a model with no stacked form
    dev = resolve_device(device)
    if quant is not None:
        pcfg = dataclasses.replace(pcfg, comm=CommConfig(quant=quant))
    policy = resolve_policy(selection)
    fused = engine == "batched" and not _force_host_selection
    block = check_block(block, engine, force_host_selection=_force_host_selection,
                        eval_every=pcfg.eval_every)
    tm = resolve_threat_model(malicious, attack, threat_model)
    rng = np.random.default_rng(pcfg.seed)
    init_gen = torch.Generator().manual_seed(pcfg.seed)
    theta = tuple(copy.deepcopy(m).to(dev) for m in module.init(init_gen))
    seed_gen, _ = _noise_generators(init_gen, dev)
    x0 = torch.from_numpy(data.x0).to(dev)
    y0 = torch.from_numpy(data.y0).to(dev)
    d_o = data.x0.shape[0]
    d_cl = _count_params(theta[0])
    d_c = cut_width(module, theta[0], x0)
    hist = History()
    writes = _writes(placement)
    tel = resolve_telemetry(
        (telemetry if telemetry is not None else pcfg.telemetry) if writes else None,
        verbose=verbose and writes,
        run="sfl", engine=engine, placement=placement, prefetch=prefetch, block=block,
        T=pcfg.T, M=pcfg.M, R=pcfg.R, selection=policy.name, fused_selection=fused,
        device=str(dev))

    def _record(t, clusters, selected, val_losses):
        meter = CommMeter()
        account_splitfed_round(meter, pcfg, clusters, d_o, d_c, d_cl)
        rec = dict(round=t, selected=selected, val_losses=val_losses,
                   selected_honest=cluster_is_honest(clusters[selected], tm.malicious),
                   comm=dataclasses.asdict(meter))
        _evaluate_into(rec, module, theta, data, pcfg, t, tel)
        hist.rounds.append(rec)
        return rec

    if block > 1:
        # K FedAvg and selection-cascade rounds, one fetch a block; the
        # accounting is analytic, so the per-round replay is exact
        from ..data.pipeline import RoundFeeder, plan_blocks
        from .engine import assemble_splitfed_block, splitfed_block_accept

        segments = plan_blocks(0, pcfg.T, block, lambda t: _eval_round(t, pcfg))
        stager = _stager(dev, prefetch)

        def _make_block(b):
            t0, k = segments[b]
            return assemble_splitfed_block(rng, seed_gen, data, pcfg, tm, t0, k, dev,
                                           stager=stager)

        feeder = RoundFeeder(_make_block, 0, len(segments), depth=prefetch, telemetry=tel)
        try:
            for b, (t0, k) in enumerate(segments):
                tel.profile_tick(t0)
                wait = (tel.span("round.feeder_wait", round=t0, depth=feeder.qsize())
                        if prefetch > 0 else tel.span("block.assemble", round=t0, k=k))
                with wait:
                    clusters_k, payload = feeder.get(b)
                theta, records = splitfed_block_accept(module, theta, clusters_k, pcfg,
                                                       t0, payload, x0, y0, policy,
                                                       telemetry=tel, placement=placement)
                for i, sel in enumerate(records):
                    rec = _record(t0 + i, clusters_k[i], sel["selected"],
                                  sel["val_losses"])
                    tel.record_round(t0 + i, rec, feeder_depth=(feeder.qsize()
                                                                if prefetch > 0 else None))
        finally:
            feeder.close()
            tel.close()
        return hist

    feeder = None
    if engine == "batched" and prefetch > 0:
        from ..data.pipeline import RoundFeeder
        from .engine import assemble_splitfed_round, staged_round
        stager = _stager(dev, prefetch)

        def _make_round(t):
            clusters = make_clusters(rng, pcfg.M, pcfg.R)
            if stager is not None:
                return clusters, staged_round(stager, rng, seed_gen, data, clusters,
                                              pcfg, tm, t)
            return clusters, assemble_splitfed_round(rng, seed_gen, data, clusters, pcfg,
                                                     tm, t, dev)

        feeder = RoundFeeder(_make_round, 0, pcfg.T, depth=prefetch, telemetry=tel)
    if engine == "batched":
        from .engine import splitfed_round_accept, splitfed_round_batched

    try:
        for t in range(pcfg.T):
            tel.profile_tick(t)
            if feeder is not None:
                with tel.span("round.feeder_wait", round=t, depth=feeder.qsize()):
                    clusters, prefetched = feeder.get(t)
            else:
                clusters, prefetched = make_clusters(rng, pcfg.M, pcfg.R), None
            if fused:
                theta, sel = splitfed_round_accept(module, theta, clusters, data, pcfg,
                                                   tm, t, rng, seed_gen, x0, y0, policy,
                                                   prefetched=prefetched, telemetry=tel,
                                                   placement=placement)
                selected, val_losses = sel["selected"], sel["val_losses"]
            else:
                if engine == "batched":
                    results = splitfed_round_batched(
                        module, theta, clusters, data, pcfg, tm, t, rng, seed_gen, x0, y0,
                        policy.needs_message_stats, prefetched=prefetched, telemetry=tel,
                        placement=placement)
                else:
                    with tel.span("round.step", round=t):
                        results = _splitfed_round(module, theta, clusters, data, pcfg, tm,
                                                  t, rng, seed_gen, x0, y0,
                                                  policy.needs_message_stats)
                with tel.span("round.select", round=t):
                    ctx = host_score_context(policy, module, results, y0)
                    _, elig, order = score_and_rank(policy, ctx)
                    selected = int(next(c for c in order if elig[c]))
                    theta = res_params(results[selected])
                val_losses = [res["vloss"] for res in results]
                del results
            rec = _record(t, clusters, selected, val_losses)
            tel.record_round(t, rec, feeder_depth=(feeder.qsize()
                                                   if feeder is not None else None))
    finally:
        if feeder is not None:
            feeder.close()
        tel.close()
    return hist


__all__ = ["ClientData", "CommMeter", "ENGINES", "History", "PLACEMENTS", "ProtocolConfig",
           "account_client_turn", "check_block", "account_handoff_recheck",
           "account_param_transfer", "account_splitfed_round", "account_validation",
           "cut_width",
           "evaluate", "res_params", "res_vacts", "round_client_seeds",
           "replayed_meter", "run_pigeon", "run_pigeon_plus", "run_splitfed",
           "run_vanilla_sl", "sample_batch_idx", "train_cluster",
           "turn_generator", "visited_candidates"]
