"""Protocol drivers: Pigeon-SL (Algorithm 1) and Pigeon-SL+, on the
sequential engine (one client turn at a time) or the batched engine
(``engine.py``: the R clusters of a round as one stacked program).

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
from ..selection import resolve_policy, select_host
from .clustering import cluster_is_honest, make_clusters
from .comm import FLOAT_BYTES, CommConfig, message_bytes
from .split import SplitModule, client_update, client_update_stats
from .validation import validation_loss

#: where the parts of the reference the port does not run yet will come from
MULTI_ROUND_SLICE = "the multi-round slice (checkpoint/, telemetry/)"
PIPELINE_SLICE = "the host-pipeline slice (data/pipeline.py RoundFeeder)"
DRIVERS_SLICE = "a later slice of the protocol drivers"
MULTI_CARD_SLICE = ("a multi-card slice (the cluster axis over several cards "
                    "with torch.distributed)")

ENGINES = ("sequential", "batched")
PLACEMENTS = ("vmap", "sharded")


def _not_ported(what: str, where: str):
    raise NotImplementedError(f"{what} is not ported yet; it comes with {where}")


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
                 with_stats: bool = False) -> List[Dict[str, Any]]:
    """Train all R clusters of round t from the same theta^t, one after
    another.  results[r] holds gamma/phi/vloss/vacts/cluster/train_loss (and
    msg_stats)."""
    seeds = round_client_seeds(seed_gen, clusters)
    results = []
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


def _check_engine(engine: str, placement: str = "vmap", prefetch: int = 0,
                  block: int = 1) -> None:
    """Validate the execution knobs as the reference does, then refuse the
    ones the port does not run yet."""
    from .runner import ROUND_BLOCK_SLICE
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
    if block < 1:
        raise ValueError(f"block={block} must be >= 1")
    if block > 1 and engine != "batched":
        raise ValueError(f"block={block} requires engine='batched' (the "
                         f"sequential engine cannot chain rounds)")
    if placement == "sharded":
        _not_ported('placement="sharded"', MULTI_CARD_SLICE)
    if prefetch > 0:
        _not_ported("prefetch", PIPELINE_SLICE)
    if block > 1:
        _not_ported("block", ROUND_BLOCK_SLICE)


def run_pigeon(module: SplitModule, data: ClientData, pcfg: ProtocolConfig,
               malicious: Optional[Set[int]] = None, attack: Attack = HONEST,
               plus: bool = False, *, engine: str = "sequential",
               placement: str = "vmap", prefetch: int = 0, block: int = 1,
               threat_model: Optional[ThreatModel] = None,
               selection="argmin", quant: Optional[str] = None,
               device: DeviceLike = None, verbose: bool = False,
               checkpoint_path: Optional[str] = None, resume: bool = False,
               telemetry=None) -> History:
    """Pigeon-SL (Algorithm 1): each round trains the R clusters from
    theta^t, validates them on the shared set, and runs the acceptance
    cascade (rank -> handoff check -> commit or roll back).

    * ``engine`` — ``"sequential"`` (one client turn at a time, host
      cascade) or ``"batched"`` (the R clusters as one stacked program; the
      whole cascade runs on the device and the round reads back one vector,
      except for param-tamper threat models, which take the host cascade).
      Both select the same clusters and count bit-identical messages.
    * ``placement`` — batched engine only: ``"vmap"`` (one card).
    * ``device`` — the CUDA card by default (raises without one); ``"cpu"``
      on request.
    * ``quant`` — cut-layer wire format shorthand (``"int8"`` /
      ``"fp8_e4m3"``; ``None`` keeps ``pcfg.comm``).
    * ``selection`` — ``"argmin"`` (the paper's rule),
      ``"median_of_means"``, ``"loss_plus_distance"``, ``"trimmed"`` or a
      policy instance.
    * ``plus`` — Pigeon-SL+: R-1 extra sub-rounds on the selected cluster
      after an accepted round.

    ``placement="sharded"``, ``prefetch``, ``block``,
    ``checkpoint_path``/``resume`` and ``telemetry``/``verbose`` are not
    ported yet and raise."""
    _check_engine(engine, placement, prefetch, block)
    if engine == "batched":
        from .split import _stacked
        _stacked(module)                 # raises for a model with no stacked form
    if checkpoint_path is not None or resume:
        _not_ported("checkpoint_path/resume", MULTI_ROUND_SLICE)
    if telemetry is not None or verbose:
        _not_ported("telemetry/verbose", MULTI_ROUND_SLICE)
    dev = resolve_device(device)
    if quant is not None:
        pcfg = dataclasses.replace(pcfg, comm=CommConfig(quant=quant))
    policy = resolve_policy(selection)
    tm = resolve_threat_model(malicious, attack, threat_model)
    rng = np.random.default_rng(pcfg.seed)
    init_gen = torch.Generator().manual_seed(pcfg.seed)
    theta = tuple(copy.deepcopy(m).to(dev) for m in module.init(init_gen))
    seed_gen, param_gen = _noise_generators(init_gen, dev)
    x0 = torch.from_numpy(data.x0).to(dev)
    y0 = torch.from_numpy(data.y0).to(dev)
    d_o = data.x0.shape[0]
    d_cl = _count_params(theta[0])
    d_c = cut_width(module, theta[0], x0)
    hist = History()
    # The fused on-device cascade covers every message-level threat model;
    # handoff (param-tamper) attacks draw their noise per visited candidate
    # on the host, so they pin selection to the host cascade.
    fused = engine == "batched" and not tm.has_param_tamper
    if engine == "batched":
        from .engine import (pigeon_round_accept, train_cluster_batched,
                             train_round_batched)

    for t in range(pcfg.T):
        meter = CommMeter()
        clusters = make_clusters(rng, pcfg.M, pcfg.R)
        if fused:
            theta, sel_rec = pigeon_round_accept(
                module, theta, clusters, data, pcfg, tm, t, rng, seed_gen,
                meter, d_c, x0, y0, policy)
            selected, accepted = sel_rec["selected"], sel_rec["accepted"]
            detections = sel_rec["detections"]
            val_losses, train_losses = sel_rec["val_losses"], sel_rec["train_losses"]
        else:
            train = train_round_batched if engine == "batched" else _train_round
            results = train(module, theta, clusters, data, pcfg, tm, t, rng,
                            seed_gen, meter, d_c, x0, y0,
                            with_stats=policy.needs_message_stats)
            outcome = select_host(policy, module, results, theta, tm, t,
                                  param_gen, pcfg, meter, x0, y0, d_c)
            theta = outcome.theta
            selected, accepted = outcome.selected, outcome.accepted
            detections = outcome.detections
            val_losses = [res["vloss"] for res in results]
            train_losses = [res["train_loss"] for res in results]
            # the candidates are done with: free them before the sub-rounds
            # and the next round train (an LM's candidate is gigabytes)
            del results, outcome
        sel_cluster = clusters[selected]
        for _ in clusters:
            account_validation(meter, d_o, d_c)
        if accepted:
            # broadcast to next first clients (no broadcast happens when
            # every cluster failed the tamper check and theta^t is kept)
            account_param_transfer(meter, pcfg.R * d_cl)

        # Pigeon-SL+: R-1 extra sub-rounds on the selected cluster — only
        # when the round was accepted: re-training a tamper-flagged cluster
        # from theta^t would hand a detected attacker R-1 free extra turns.
        if plus and accepted:
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

        rec = dict(
            round=t,
            clusters=clusters,
            val_losses=val_losses,
            train_losses=train_losses,
            selected=selected,
            accepted=accepted,
            selected_honest=cluster_is_honest(sel_cluster, tm.malicious),
            honest_cluster_exists=any(cluster_is_honest(c, tm.malicious)
                                      for c in clusters),
            detections=detections,
            comm=dataclasses.asdict(meter),
        )
        if t % pcfg.eval_every == 0 or t == pcfg.T - 1:
            rec["test_acc"] = evaluate(module, theta[0], theta[1], data.x_test,
                                       data.y_test, pcfg.eval_batch)
        hist.rounds.append(rec)
    return hist


def run_pigeon_plus(module: SplitModule, data: ClientData, pcfg: ProtocolConfig,
                    malicious: Optional[Set[int]] = None, attack: Attack = HONEST,
                    **kwargs) -> History:
    """Pigeon-SL+ (throughput-matched variant): :func:`run_pigeon` with the
    R-1 extra selected-cluster sub-rounds enabled."""
    return run_pigeon(module, data, pcfg, malicious, attack, plus=True, **kwargs)


def run_vanilla_sl(*args, **kwargs) -> History:
    """Vanilla SL (the paper's baseline): not ported yet."""
    _not_ported("run_vanilla_sl", DRIVERS_SLICE)


def run_splitfed(*args, **kwargs) -> History:
    """Clustered SplitFed (Section V baseline): not ported yet."""
    _not_ported("run_splitfed", DRIVERS_SLICE)


def run_pigeon_sweep(*args, **kwargs) -> History:
    """S seeded protocol replicas in lockstep: not ported yet."""
    from .runner import SWEEP_SLICE
    _not_ported("run_pigeon_sweep", SWEEP_SLICE)


__all__ = ["ClientData", "CommMeter", "ENGINES", "History", "ProtocolConfig",
           "account_client_turn", "account_handoff_recheck",
           "account_param_transfer", "account_validation", "cut_width",
           "evaluate", "res_params", "res_vacts", "round_client_seeds",
           "run_pigeon", "run_pigeon_plus", "run_pigeon_sweep", "run_splitfed",
           "run_vanilla_sl", "sample_batch_idx", "train_cluster",
           "turn_generator"]
