"""The step functions and their input specs (the reference's
``repro/launch/steps.py``).

  * ``train_step(batch)``               — one SL mini-batch update of the
                                          split network (client and AP
                                          halves in one differentiation)
                                          -> loss; over a ``StackedModel``
                                          every slot's update at once ->
                                          (R,) losses.
  * ``prefill_step(batch)``             — full-sequence forward, last-token
                                          logits (B, 1, V) f32.
  * ``serve_step(cache, tokens, index, memory=None)`` — ONE new token
                                          against the KV cache (an
                                          encoder-decoder's cross-attention
                                          over ``memory``) -> (logits f32,
                                          cache).
  * ``pigeon_round_step(batches, val_batch)`` — the paper's global round over
                                          R cluster slots of a
                                          ``StackedModel``: every slot's
                                          train step, the shared-set
                                          validation loss, the policy's
                                          winner and its broadcast into
                                          every slot -> (vlosses, sel).

The model holds its parameters, so a step takes none and updates them in
place.  The round makers are thin adapters over
``core.runner.RoundRunner.round`` (``params_stacked``): this module only
supplies the model-level binding (:func:`launch_round_spec`).
:func:`make_pigeon_round_step_shardmap` lays the cluster axis over the
ranks of a process group, and a mesh's data and model axes over each
pod's ranks (``models/parallel.py``).

:func:`input_specs` builds one (architecture x input shape) step with its
arguments as tensors on the ``meta`` device (shapes and dtypes, nothing
allocated), the reference's ``ShapeDtypeStruct`` stand-ins; with a mesh the
model is one rank's part of the parallel model.  :func:`instrument_step`
wraps any step so that each call emits one telemetry span.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from ..core.runner import (CLUSTER_AXIS, RoundRunner, RoundSpec, check_partial_auto_backend,
                           check_policy, cluster_mesh)
from ..core.split import sgd_update
from ..kernels import ops as kops
from ..models.blocks import DTYPES
from ..models.config import ModelConfig
from ..models.model import Model, StackedModel, build_plan
from ..models.parallel import all_reduce_grads, gather_from
from ..models.transformer import ENCDEC
from .shapes import SHAPES, InputShape, shape_settings


def make_train_step(model: nn.Module, lr: float = 1e-3,
                    quant: Optional[str] = None) -> Callable:
    """One train step: ``loss = train_step(batch)`` differentiates the loss
    with respect to every parameter and applies ``p -= lr * g`` in place,
    in the parameter's dtype, as the reference's step does.  With ``quant``
    the loss routes through the model's gamma/phi cut and
    :func:`kernels.ops.quant_cut_exchange`, a straight-through wire whose
    forward quantizes the uplink activations and whose backward quantizes
    the downlink cut gradient (B2 both ways on the card), a row a sample.
    ``quant=None`` is the plain ``model.loss`` path.

    Over a :class:`StackedModel` the batch is n slots' ``(n, B, S)`` and the
    step returns the (n,) losses: each slot takes its own step (the slots
    share no parameter, so the gradient of the losses' sum is each slot's
    own), the reference's train step under its vmap over clusters.

    Over a parallel model (``model.par``: a mesh's data and model axes) the
    step takes the whole batch, trains on this data rank's rows (the loss
    is the whole batch's mean) and sums the gradients over ``data`` before
    the update: every rank then holds its shards of the same model."""
    stacked = isinstance(model, StackedModel)
    params = list(model.parameters())
    halves = model.split_params() if quant is not None else None
    par = model.par

    def loss_of(batch):
        if halves is None:
            return model.loss(batch) if stacked else model.loss(batch)[0]
        gamma, phi = halves
        if stacked:
            acts = kops.quant_cut_exchange(model.client_forward(gamma, batch["tokens"]),
                                           quant, lead=2)
            return model.ap_losses(phi, acts, batch["labels"], batch.get("mask"))
        acts = kops.quant_cut_exchange(model.client_forward(gamma, batch), quant)
        return model.ap_forward(phi, acts, batch)[0]

    def train_step(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        loss = loss_of(par.batch_rows(batch, 1 if stacked else 0))
        sgd_update(model, all_reduce_grads(torch.autograd.grad(loss.sum(), params), par), lr)
        return loss.detach()

    return train_step


def make_prefill_step(model: Model) -> Callable:
    """``prefill_step(batch)`` -> the last position's logits (B, 1, V) f32;
    an encoder-decoder's batch carries its ``frames``, which the forward
    encodes.  A parallel model runs this data rank's rows and returns the
    whole batch's logits (the vocab panels and the rows all-gathered)."""
    par = model.par

    @torch.inference_mode()
    def prefill_step(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        h, _ = model.forward(par.batch_rows(batch))
        # last-position logits — the serving prefill output
        if par.trivial:
            return (h[:, -1:, :] @ model.head.w).to(torch.float32)
        logits = model.head_logits(h[:, -1:, :]).to(torch.float32)
        return gather_from(logits, par.data_group, par.data_size, dim=0)
    return prefill_step


def instrument_step(fn: Callable, telemetry, name: str) -> Callable:
    """``fn`` wrapped so that every call emits one span ``name`` (with its
    call index) into ``telemetry``, fenced on the step's outputs, so the
    span covers the card's work; ``fn`` itself when telemetry is None or
    disabled."""
    if telemetry is None or not getattr(telemetry, "enabled", False):
        return fn
    calls = iter(range(1 << 62))

    def traced(*args, **kwargs):
        with telemetry.span(name, call=next(calls)) as sp:
            out = fn(*args, **kwargs)
            sp.fence(out)
            return out

    return traced


def make_serve_step(model: Model) -> Callable:
    """``serve_step(cache, tokens, index, memory=None)`` -> (logits f32,
    cache); ``memory`` is an encoder-decoder's encoder output.  A parallel
    model's cache holds this rank's rows and KV heads
    (``model.init_cache``); the step takes the whole batch's tokens and
    returns the whole batch's logits.  Where the cache's panels span the
    data axis (``seq_shard`` or a batch of 1) every data rank holds every
    row: the step then splits no rows and gathers no logits over ``data``."""
    par = model.par

    def serve_step(cache, tokens: torch.Tensor, index: int,
                   memory: Optional[torch.Tensor] = None):
        panels = getattr(cache, "panels", None)
        split = par.data_size > 1 and not (panels is not None and panels.rows_whole)
        if split:
            tokens = par.local_rows(tokens)
            memory = None if memory is None else par.local_rows(memory)
        logits, cache = model.decode_step(cache, tokens, index, memory)
        logits = logits.to(torch.float32)
        if split:
            logits = gather_from(logits, par.data_group, par.data_size, dim=0)
        return logits, cache
    return serve_step


# ---------------------------------------------------------------------------
# the round programs over a cluster-stacked LM
# ---------------------------------------------------------------------------

def _every_slot(model: StackedModel, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The shared batch as every slot's (views)."""
    return {k: v.expand((model.n,) + tuple(v.shape)) for k, v in batch.items()}


def launch_round_spec(model: StackedModel, lr: float = 1e-3,
                      quant: Optional[str] = None) -> RoundSpec:
    """The launch-layer binding of the RoundRunner's RoundSpec: one train
    step a slot (:func:`make_train_step` over the stacked model, in place)
    and the shared-set validation loss.  ``params`` is ``model`` itself.

    ``validate_sharded`` slices the validation batch into (up to) k equal
    shards for the median-of-means selection family; there is no
    ``message_stats`` hook — the launch layer runs plain train steps, not
    the SL message exchange — so anomaly-scoring policies
    (loss_plus_distance) are rejected when a round step is built.

    ``quant`` applies the straight-through quantized cut-layer wire to the
    train steps only; the shared-set validation forward stays exact."""
    from ..selection import effective_shards
    train = make_train_step(model, lr, quant=quant)

    def train_cluster(params, batches):
        return params, train(batches)           # (R,) train losses

    par = model.par

    def val_loss(params, val_batch):
        # a parallel model validates this data rank's rows: the loss is
        # the whole set's mean
        return params.loss(_every_slot(params, par.batch_rows(val_batch)))

    @torch.no_grad()
    def validate(params, val_batch):
        return val_loss(params, val_batch), None

    @torch.no_grad()
    def validate_sharded(params, val_batch, k):
        b = val_batch["tokens"].shape[0]
        kk = effective_shards(k, b)
        n = b // kk
        losses = torch.stack([val_loss(
            params, {name: v[i * n:(i + 1) * n] for name, v in val_batch.items()})
            for i in range(kk)], dim=-1)
        # the reported vloss stays the exact full-batch loss (a masked mean
        # of per-shard means would over-weight padding-light shards); the
        # shards feed only the median-of-means score
        return val_loss(params, val_batch), losses, None

    return RoundSpec(train_cluster, validate, validate_sharded=validate_sharded,
                     train_summary=lambda aux: aux,
                     lead=lambda batches: (batches["tokens"].shape[0],),
                     take=lambda batches, lanes, clusters: {
                         name: v[clusters] for name, v in batches.items()})


def make_pigeon_round_step(model: StackedModel, lr: float = 1e-3,
                           selection: str = "argmin", quant: Optional[str] = None,
                           block: int = 1) -> Callable:
    """One Pigeon-SL global round over the R slots of ``model``:
    ``round_step(batches, val_batch) -> (vlosses (R,), sel)`` with
    ``batches`` {"tokens", "labels"} of (R, B, S) per-slot batches and
    ``val_batch`` the shared (D_o, S) set every slot evaluates (Section
    III-C).  Afterwards every slot holds the winner; ``sel`` stays on the
    device.  ``selection`` names any loss-based policy (argmin /
    median_of_means / trimmed).

    ``block > 1`` returns the round-block step: ``batches`` lead with the K
    rounds' axis (K, R, B, S), and the step runs K rounds, each from the
    winner of the one before, returning ``(vlosses (K, R), sels (K,))``."""
    return _round_steps(model, lr, selection, quant, block)


def _round_steps(model: StackedModel, lr: float, selection: str, quant: Optional[str],
                 block: int, **placement) -> Callable:
    """The round step (or, with ``block > 1``, the round-block step) over
    ``model`` through a RoundRunner of ``placement`` (its keyword
    arguments)."""
    from ..selection import resolve_policy
    if block < 1:
        raise ValueError(f"block={block} must be >= 1")
    policy = resolve_policy(selection)
    spec = launch_round_spec(model, lr, quant=quant)
    check_policy(spec, policy)
    runner = RoundRunner(spec, select=policy, params_stacked=True, **placement)

    def round_step(batches, val_batch):
        _, vlosses, sel = runner.round(model, batches, val_batch)
        return vlosses, sel

    def round_block_step(block_batches, val_batch):
        k = block_batches["tokens"].shape[0]
        if k != block:
            raise ValueError(f"{k} rounds of batches for a block of {block}")
        rounds = [{name: v[i] for name, v in block_batches.items()} for i in range(k)]
        return runner.round_block(model, rounds, val_batch)[1]

    return round_block_step if block > 1 else round_step


def make_pigeon_plus_round_step(model: StackedModel, lr: float = 1e-3,
                                quant: Optional[str] = None) -> Callable:
    """The Pigeon-SL+ round over the slots:
    ``plus_round(batches, val_batch, plus_batches) -> (vlosses, sel)``.
    After the round (every slot holds the winner), the winner trains on
    every slot's ``plus_batches`` at once, one step a slot, and the slots'
    f32 mean is broadcast back into every slot: the extra updates flow
    into the winning cluster's parameters only."""
    base = make_pigeon_round_step(model, lr, quant=quant)
    train = make_train_step(model, lr, quant=quant)

    def plus_round(batches, val_batch, plus_batches):
        vlosses, sel = base(batches, val_batch)
        train(plus_batches)
        with torch.no_grad():
            for p in model.parameters():
                p.copy_(p.to(torch.float32).mean(dim=0).to(p.dtype).expand_as(p))
        return vlosses, sel

    return plus_round


def make_pigeon_round_step_shardmap(model: StackedModel, mesh=None, lr: float = 1e-3,
                                    selection: str = "argmin", quant: Optional[str] = None,
                                    block: int = 1) -> Callable:
    """The Pigeon-SL round with the cluster axis over the ranks of the
    process group (``placement="sharded"``): ``round_step(batches,
    val_batch) -> (vlosses (R,), sel)``, the arguments
    :func:`make_pigeon_round_step`'s, the same on every rank.  ``mesh`` is a
    ``("pod",)`` :class:`~repro_torch.core.runner.ClusterMesh` (by default
    ``cluster_mesh(R)`` at each call), or a ``launch.mesh.Mesh`` over
    (``pod``, ``data``, ``model``): the slots over ``pod`` and, within a
    pod, ``model`` the parallel model of the mesh (built with
    ``mesh.parallel("pod")``), each pod's training and validation batches split
    over ``data`` (``launch.shardings.pigeon_round_shardings``).  ``model``
    is this rank's ``StackedModel`` of R / pods slots; each pod trains and
    validates its slice of ``batches``, the R losses are all-gathered over
    ``pod``, every rank picks the winner alike, and one masked f32
    all-reduce a parameter over ``pod`` puts the winner into every slot of
    every rank.  ``block > 1`` as in :func:`make_pigeon_round_step`.  The
    reference's ``for_execution`` switch (lowering or running) has no
    counterpart: the port always runs."""
    if mesh is not None:
        auto = check_partial_auto_backend(mesh, (CLUSTER_AXIS,))
        par = model.par
        if (auto.get("model", 1), auto.get("data", 1)) != (par.model_size, par.data_size):
            raise ValueError(f"the mesh's data and model axes {auto} are not the model's "
                             f"(data {par.data_size}, model {par.model_size}): build it "
                             f"with the mesh's parallel view")
    return _round_steps(model, lr, selection, quant, block, placement="sharded", mesh=mesh)


# ---------------------------------------------------------------------------
# input_specs — one (arch, shape) step and its arguments on the meta device
# ---------------------------------------------------------------------------

_META = torch.device("meta")


def _meta(shape: Tuple[int, ...], dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=_META)


def batch_struct(cfg: ModelConfig, shape: InputShape, cluster_dim: int = 0
                 ) -> Dict[str, torch.Tensor]:
    """One training/prefill batch as meta tensors (``cluster_dim`` R > 0
    adds a leading slot axis)."""
    b, s = shape.global_batch, shape.seq_len
    lead = (cluster_dim,) if cluster_dim else ()
    dt = DTYPES[cfg.dtype]
    if cfg.arch_type == "vlm":
        npx = cfg.n_prefix_tokens
        return {"patches": _meta(lead + (b, npx, cfg.d_model), dt),
                "tokens": _meta(lead + (b, s - npx), torch.int32),
                "labels": _meta(lead + (b, s - npx), torch.int32)}
    if cfg.arch_type in ENCDEC:
        s_half = s // 2
        return {"frames": _meta(lead + (b, s_half, cfg.d_model), dt),
                "tokens": _meta(lead + (b, s_half), torch.int32),
                "labels": _meta(lead + (b, s_half), torch.int32)}
    return {"tokens": _meta(lead + (b, s), torch.int32),
            "labels": _meta(lead + (b, s), torch.int32)}


def decode_structs(cfg: ModelConfig, model: Model, shape: InputShape,
                   seq_shard: bool = False):
    """(tokens, index, cache, memory) of ``serve_step`` as meta tensors;
    ``model`` lives on the meta device, its cache laid out by
    ``model.init_cache(..., seq_shard)``.  ``memory`` is an
    encoder-decoder's (B, min(4,096, S // 8), d_model) encoder output, None
    for the other families (the reference's)."""
    b, s = shape.global_batch, shape.seq_len
    memory = None
    if cfg.arch_type in ENCDEC:
        memory = _meta((b, min(4096, s // 8), cfg.d_model), DTYPES[cfg.dtype])
    return (_meta((b, 1), torch.int32), _meta((), torch.int32),
            model.init_cache(b, s, seq_shard), memory)


@dataclasses.dataclass
class LoweringSpec:
    """A step, its arguments (meta tensors) and the model whose parameters
    it holds (on the meta device)."""
    fn: Callable
    args: Tuple
    model: nn.Module


def apply_shape_settings(cfg: ModelConfig, shape: InputShape) -> ModelConfig:
    return dataclasses.replace(cfg, **shape_settings(shape))


def input_specs(cfg: ModelConfig, shape_name: str, mesh=None, *, pigeon_clusters: int = 0,
                seq_shard_cache: bool = False, lr: float = 1e-3,
                optimizations: Tuple[str, ...] = (), selection: str = "argmin",
                quant: Optional[str] = None) -> LoweringSpec:
    """The step and its meta-tensor arguments for one (architecture x
    input shape): train (or, with ``pigeon_clusters`` R, the Pigeon-SL
    round over an R-slot :class:`StackedModel`; ``pigeon_batch_split``
    gives each slot global_batch / R, ``pigeon_plus`` the Pigeon-SL+
    round, ``pigeon_shardmap`` the round with the cluster axis over the
    process group's ranks: the model then holds R / d slots, d the
    ``cluster_mesh(R)`` size, or the mesh's ``pod`` axis), prefill or
    decode.  ``selection`` names the round's policy, ``quant`` the train
    steps' wire.  A decode step's arguments are (cache, tokens, index),
    and an encoder-decoder's memory after them.

    With ``mesh`` (``launch.mesh.Mesh``, the reference's
    ``input_specs(cfg, shape, mesh)``) the model is this rank's part of the
    parallel model over the mesh's data and model axes, a round's clusters
    lie over its ``pod`` axis (the arguments stay
    the whole batch's, as the reference's global arrays; the steps take
    this rank's rows), and a decode's cache is this rank's part of the
    reference's ``cache_shardings(seq_shard=seq_shard_cache or global_batch
    == 1)`` layout (``Model.init_cache``): its sequence split over the ranks
    that hold the same KV heads, and under ``seq_shard`` over the data
    axes too."""
    shape = SHAPES[shape_name]
    cfg = apply_shape_settings(cfg, shape)
    if optimizations:
        cfg = dataclasses.replace(
            cfg, optimizations=tuple(cfg.optimizations) + tuple(optimizations))
    plan = build_plan(cfg)

    if shape.kind == "train" and pigeon_clusters:
        r = pigeon_clusters
        par = None if mesh is None else mesh.parallel(CLUSTER_AXIS)
        model = StackedModel(cfg, plan, r, _META, par)
        # "pigeon_batch_split": each cluster trains global_batch/R, so the
        # robust round costs the same tokens a step as plain data parallelism
        per_cluster_b = (shape.global_batch // r
                         if "pigeon_batch_split" in cfg.optimizations else shape.global_batch)
        batches = batch_struct(cfg, dataclasses.replace(shape, global_batch=per_cluster_b),
                               cluster_dim=r)
        val_batch = batch_struct(cfg, dataclasses.replace(
            shape, global_batch=max(16, shape.global_batch // 8)))
        if "pigeon_plus" in cfg.optimizations:
            plus_batches = batch_struct(cfg, dataclasses.replace(
                shape, global_batch=per_cluster_b), cluster_dim=r)
            return LoweringSpec(make_pigeon_plus_round_step(model, lr, quant=quant),
                                (batches, val_batch, plus_batches), model)
        over_pods = mesh is not None and mesh.shape.get(CLUSTER_AXIS, 1) > 1
        if "pigeon_shardmap" in cfg.optimizations or over_pods:
            # a mesh's pod axis carries the clusters (the reference's
            # pigeon_round_shardings): the sharded placement lays them out
            if mesh is None:
                mesh = cluster_mesh(r)
            elif CLUSTER_AXIS not in mesh.axis_names:
                raise ValueError(f"pigeon_shardmap over a mesh needs its {CLUSTER_AXIS!r} axis "
                                 f"(the multi-pod mesh); this one is {mesh.shape}")
            pods = mesh.shape[CLUSTER_AXIS]
            model = StackedModel(cfg, plan, r // pods, _META, par)
            fn = make_pigeon_round_step_shardmap(model, mesh, lr, selection=selection,
                                                 quant=quant)
            return LoweringSpec(fn, (batches, val_batch), model)
        fn = make_pigeon_round_step(model, lr, selection=selection, quant=quant)
        return LoweringSpec(fn, (batches, val_batch), model)

    model = Model(cfg, plan, _META, None if mesh is None else mesh.parallel())
    if shape.kind == "train":
        return LoweringSpec(make_train_step(model, lr, quant=quant),
                            (batch_struct(cfg, shape),), model)
    if shape.kind == "prefill":
        return LoweringSpec(make_prefill_step(model), (batch_struct(cfg, shape),), model)
    seq_shard = seq_shard_cache or shape.global_batch == 1
    tokens, index, cache, memory = decode_structs(cfg, model, shape, seq_shard)
    args = (cache, tokens, index) + (() if memory is None else (memory,))
    return LoweringSpec(make_serve_step(model), args, model)


__all__ = ["LoweringSpec", "apply_shape_settings", "batch_struct", "decode_structs",
           "input_specs", "instrument_step", "launch_round_spec",
           "make_pigeon_plus_round_step", "make_pigeon_round_step",
           "make_pigeon_round_step_shardmap", "make_prefill_step", "make_serve_step",
           "make_train_step"]
