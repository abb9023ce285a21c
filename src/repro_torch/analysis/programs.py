"""The audited program catalog: every batched round entry and the two wire
kernels (the reference's ``repro/analysis/programs.py``).

One tiny fixed task (MNIST, 4 clients, 32-sample shards) is enough: the
audited invariants (dtypes, host reads, the carry in place, the fetch
arity) do not depend on the shapes, and the tiny config keeps the whole
audit within the test tier's budget.  Cells resolve through the same
runner factories the drivers use (``protocol_accept_runner``,
``splitfed_accept_runner``, ``protocol_runner``), so the auditor runs the
entry the drivers run.

The reference's placements are ``vmap`` and ``sharded``; the port's
cluster axis is written out in the stacked model, its single-card
counterpart of the vmap placement, so those cells are named ``@batched``.
The ``@sharded`` cells (:data:`SHARDED_CELLS`) run the same entries under
``placement="sharded"`` in this process as a group of one rank (gloo on
the CPU, NCCL on the card; started by the cell when no group is), so the
audit holds the sharded bodies, their collectives included, to the same
invariants.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

SEED = 0
BLOCK_K = 2
SWEEP_SEEDS = (0, 1)
POOL_LANES = 2

#: the reference's sharded cells, each run in-process as a group of one rank
SHARDED_CELLS = ("pigeon/accept@sharded", "pigeon/accept_block@sharded",
                 "pigeon/round@sharded", "pigeon/pool_accept_block@sharded",
                 "sweep/sweep@sharded")


@dataclasses.dataclass
class TinyContext:
    """Deterministically built inputs shared by every program cell."""
    module: Any
    data: Any
    pcfg: Any
    tm: Any
    device: torch.device
    theta: Any
    thetas: Any                     # one theta a sweep seed (the replica form)
    x0: torch.Tensor
    y0: torch.Tensor
    round_payload: Any
    block_payload: Any              # the K = BLOCK_K rounds' accept inputs
    sweep_payload: Any
    sweep_block_payload: Any
    pool_block_payload: Any         # J = POOL_LANES lanes x K = BLOCK_K rounds
    pool_val: Any
    pool_active: torch.Tensor


def build_context(device="cpu") -> TinyContext:
    from ..adversary import HONEST, resolve_threat_model
    from ..core import ProtocolConfig, from_cnn
    from ..core.clustering import make_clusters
    from ..core.engine import assemble_block, assemble_round, assemble_sweep_block, block_rounds
    from ..core.protocol import _run_state
    from ..data import build_image_task

    dev = torch.device(device)
    data, cfg = build_image_task("mnist", m_clients=4, d_m=32, d_o=16, n_test=32, seed=SEED)
    module = from_cnn(cfg)
    # eval_every=2 so that the block=2 driver cells run a real two-round block
    pcfg = ProtocolConfig(M=4, N=1, T=2, E=1, B=4, lr=0.05, seed=SEED, eval_every=2)
    tm = resolve_threat_model(set(), HONEST, None)

    rng, theta, seed_gen, _, _ = _run_state(module, pcfg, dev)
    x0, y0 = torch.from_numpy(data.x0).to(dev), torch.from_numpy(data.y0).to(dev)
    clusters = make_clusters(rng, pcfg.M, pcfg.R)
    round_payload = assemble_round(rng, seed_gen, data, clusters, pcfg, tm, 0, dev)
    _, block = assemble_block(rng, seed_gen, data, pcfg, tm, 0, BLOCK_K, dev)

    # the sweep: one replica a seed, each on its solo run's streams
    states = [_run_state(module, dataclasses.replace(pcfg, seed=s), dev) for s in SWEEP_SEEDS]
    thetas = [st[1] for st in states]
    _, sweep_rounds = assemble_sweep_block([st[0] for st in states], [st[2] for st in states],
                                           data, pcfg, tm, 0, BLOCK_K, dev)
    # the pool: J lanes of the replica payload (a lane's content never shapes
    # the entry), each lane its own validation set, every lane active
    return TinyContext(
        module=module, data=data, pcfg=pcfg, tm=tm, device=dev, theta=theta, thetas=thetas,
        x0=x0, y0=y0, round_payload=round_payload, block_payload=block_rounds(block),
        sweep_payload=sweep_rounds[0], sweep_block_payload=sweep_rounds,
        pool_block_payload=sweep_rounds, pool_val=(torch.stack([x0] * POOL_LANES),
                                                   torch.stack([y0] * POOL_LANES)),
        pool_active=torch.ones(POOL_LANES, dtype=torch.bool, device=dev))


@dataclasses.dataclass(frozen=True)
class ProgramCell:
    """One audited program: a runner entry, or a kernel."""
    name: str                       # e.g. "pigeon/accept@batched"
    placement: str                  # "batched" | "sharded" | "kernel"
    realize: Callable[[TinyContext], Tuple[Callable, tuple, Tuple[int, ...]]]
    #        ctx -> (fn, args, carry_argnums)
    fetch_leaves: Callable[[TinyContext], int]


def _pigeon_runner(ctx: TinyContext, selection: str = "argmin", placement: str = "vmap"):
    from ..core.runner import protocol_accept_runner
    from ..selection import resolve_policy
    return protocol_accept_runner(ctx.module, ctx.pcfg.lr, resolve_policy(selection),
                                  ctx.pcfg.tamper_check, ctx.pcfg.tamper_tol,
                                  quant=ctx.pcfg.comm.quant, placement=placement)


def _splitfed_runner(ctx: TinyContext):
    from ..core.engine import splitfed_accept_runner
    from ..selection import resolve_policy
    return splitfed_accept_runner(ctx.module, ctx.pcfg.lr, resolve_policy("argmin"),
                                  quant=ctx.pcfg.comm.quant)


def _sweep_runner(ctx: TinyContext, placement: str = "vmap"):
    from ..core.runner import protocol_runner
    from ..selection import resolve_policy
    policy = resolve_policy("argmin")
    return protocol_runner(ctx.module, ctx.pcfg.lr, policy.needs_message_stats, policy,
                           ctx.pcfg.comm.quant, placement=placement)


def _sharded(runner_of):
    """The sharded form of a cell's runner (audited inside a group of one
    rank, :func:`~repro_torch.analysis.budgets.measure_program_budgets`)."""
    def runner(ctx: TinyContext):
        return runner_of(ctx, placement="sharded")
    return runner


def _theta(ctx):
    return copy.deepcopy(ctx.theta)


def _thetas(ctx):
    return copy.deepcopy(ctx.thetas)


def _round_args(ctx):
    return (_theta(ctx), ctx.round_payload, (ctx.x0, ctx.y0))


def _block_args(ctx):
    return (_theta(ctx), ctx.block_payload, (ctx.x0, ctx.y0))


def _sweep_args(ctx):
    return (_thetas(ctx), ctx.sweep_payload, (ctx.x0, ctx.y0))


def _sweep_block_args(ctx):
    return (_thetas(ctx), ctx.sweep_block_payload, (ctx.x0, ctx.y0))


def _pool_block_args(ctx):
    return (_thetas(ctx), ctx.pool_block_payload, ctx.pool_val, ctx.pool_active)


def _entry_cell(runner_of, entry: str, args_of, carry: bool = True):
    def realize(ctx: TinyContext):
        return getattr(runner_of(ctx), entry), args_of(ctx), ((0,) if carry else ())
    return realize


def _quant_cell(stats: bool):
    def realize(ctx: TinyContext):
        from ..kernels import ops
        x = torch.from_numpy(np.linspace(-3, 3, 32 * 16, dtype=np.float32).reshape(32, 16))
        fn = ops.quant_roundtrip_stats if stats else ops.quant_roundtrip
        return (lambda v: fn(v, "int8")), (x.to(ctx.device),), ()
    return realize


def _theta_leaves(ctx) -> int:
    return sum(1 for half in ctx.theta for _ in half.parameters())


CELLS: List[ProgramCell] = [
    # the pigeon accept cascade: the default batched driver path
    ProgramCell("pigeon/accept@batched", "batched",
                _entry_cell(_pigeon_runner, "accept", _round_args), lambda c: 1),
    ProgramCell("pigeon/accept_block@batched", "batched",
                _entry_cell(_pigeon_runner, "accept_block", _block_args), lambda c: 1),
    # a non-argmin policy (the message-stats lane active)
    ProgramCell("pigeon/accept@batched+loss_plus_distance", "batched",
                _entry_cell(lambda c: _pigeon_runner(c, "loss_plus_distance"), "accept",
                            _round_args), lambda c: 1),
    # the launch layer's round: the winner broadcast into fresh stacked halves
    # (no carry), (stacked halves, vlosses, sel) left on the device
    ProgramCell("pigeon/round@batched", "batched",
                _entry_cell(_pigeon_runner, "round", _round_args, carry=False),
                lambda c: _theta_leaves(c) + 2),
    # SplitFed's FedAvg and policy cascade
    ProgramCell("splitfed/accept@batched", "batched",
                _entry_cell(_splitfed_runner, "accept", _round_args), lambda c: 1),
    ProgramCell("splitfed/accept_block@batched", "batched",
                _entry_cell(_splitfed_runner, "accept_block", _block_args), lambda c: 1),
    # the job pool: J jobs as the lanes of the accept_block program, one
    # stacked (J, K, 2R + 3) fetch
    ProgramCell("pigeon/pool_accept_block@batched", "batched",
                _entry_cell(_pigeon_runner, "pool_accept_block", _pool_block_args),
                lambda c: 1),
    # the multi-seed sweep: (train losses, vlosses, sels) a round or block
    ProgramCell("sweep/sweep@batched", "batched",
                _entry_cell(_sweep_runner, "sweep", _sweep_args), lambda c: 3),
    ProgramCell("sweep/sweep_block@batched", "batched",
                _entry_cell(_sweep_runner, "sweep_block", _sweep_block_args), lambda c: 3),
    # the wire kernels (B2, B3): (deq, scales) and (deq, scales, stats)
    # the sharded placement, a group of one rank: the same entries with their
    # all-gathers and masked all-reduces
    ProgramCell("pigeon/accept@sharded", "sharded",
                _entry_cell(_sharded(_pigeon_runner), "accept", _round_args), lambda c: 1),
    ProgramCell("pigeon/accept_block@sharded", "sharded",
                _entry_cell(_sharded(_pigeon_runner), "accept_block", _block_args),
                lambda c: 1),
    ProgramCell("pigeon/round@sharded", "sharded",
                _entry_cell(_sharded(_pigeon_runner), "round", _round_args, carry=False),
                lambda c: _theta_leaves(c) + 2),
    ProgramCell("pigeon/pool_accept_block@sharded", "sharded",
                _entry_cell(_sharded(_pigeon_runner), "pool_accept_block",
                            _pool_block_args), lambda c: 1),
    ProgramCell("sweep/sweep@sharded", "sharded",
                _entry_cell(_sharded(_sweep_runner), "sweep", _sweep_args), lambda c: 3),
    ProgramCell("kernels/quant_roundtrip@int8", "kernel", _quant_cell(stats=False),
                lambda c: 2),
    ProgramCell("kernels/quant_roundtrip_stats@int8", "kernel", _quant_cell(stats=True),
                lambda c: 3),
]

#: a port cell's name in the reference's catalog
REFERENCE_NAMES = {c.name: c.name.replace("@batched", "@vmap")
                   .replace("kernels/quant_roundtrip", "kernels/quant_dequant")
                   for c in CELLS}


def select_cells(placements: Tuple[str, ...] = ("batched", "sharded", "kernel"),
                 names: Optional[Tuple[str, ...]] = None) -> List[ProgramCell]:
    cells = [c for c in CELLS if c.placement in placements]
    if names:
        cells = [c for c in cells if c.name in names]
    return cells


__all__ = ["BLOCK_K", "CELLS", "POOL_LANES", "ProgramCell", "REFERENCE_NAMES", "SEED",
           "SHARDED_CELLS", "SWEEP_SEEDS", "TinyContext", "build_context",
           "select_cells"]
