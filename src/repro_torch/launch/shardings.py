"""Sharding rules: parameters, batches and decode caches over a mesh's
``pod``, ``data`` and ``model`` axes (the reference's
``repro/launch/shardings.py``, its rule table copied as it is into
``models/parallel.py``, which derives each parameter's layout from it).

Strategy, the reference's:
  * batch dims over ("pod", "data"), or over the data axes left beside a
    cluster axis;
  * weight matrices tensor-parallel over "model": the projection's output
    dim for the up-projections, its input dim for the down-projections
    (Megatron's pattern: one all-reduce a block);
  * MoE expert banks expert-parallel over "model";
  * vocab (embedding rows, head columns) over "model";
  * everything small replicated.
A dim is sharded only when the axis divides it; otherwise the rule falls
through to replication.

A spec is a tuple with one entry a dim: an axis name, a tuple of axis
names, or None (the reference's ``PartitionSpec``).  The port names each
parameter by the reference's pytree path (``"stacks/0/attn/wq/w"``, a
stack's leaves with their layer axis first) and shape, as ``convert.py``
joins them (:func:`param_shapes`), so the specs compare leaf for leaf.

The port's parallel model (``models/parallel.py``) holds each parameter's
local shard and records its layout on it (``parallel.mark_by_rule``: the
spec's, or a named departure): :func:`shard_params` takes each rank's
shard out of the whole tensors (a sectioned layout section by section) and
:func:`gather_params` puts the whole back together.  The departures: a KV
head held whole on the ranks whose query heads read it where the axis
exceeds the KV heads, a layer whole where the axis does not divide its
heads (Qwen2.5-14B's attention, xLSTM-1.3B's mixers at 16), MLA's
``w_dkv`` whole, Mamba2's and the mLSTM's concatenated projections cut by
sections, the sLSTM whole; :func:`param_shardings` still returns the
reference's spec, and :func:`param_bytes` a rank's bytes beside it.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Iterator, Optional, Sequence, Tuple

import torch
from torch import nn

from ..models.parallel import _RULES, Spec, _spec_for_leaf, collective, layout  # noqa: F401

# ---------------------------------------------------------------------------
# the reference's leaf paths of the port's models
# ---------------------------------------------------------------------------

def whole_shape(p: torch.Tensor) -> Tuple[int, ...]:
    """The whole tensor's shape of a (possibly sharded) parameter."""
    shape = list(p.shape)
    lay = layout(p)
    if lay is not None:
        shape[lay.dim] = lay.whole_size(shape[lay.dim])
    return tuple(shape)


def _stack_leaves(stack, prefix: str, slots: int
                  ) -> Iterator[Tuple[str, Tuple[int, ...], int]]:
    """(reference path, whole shape, the bytes this rank holds) of each of
    a stack's leaves."""
    layers = 1 if stack.kind == "shared_attn" else stack.n
    for name, p in stack.layers[0].named_parameters():
        shape = whole_shape(p)
        if stack.kind != "shared_attn":
            shape = (shape[:1] + (stack.n,) + shape[1:]) if slots else (stack.n,) + shape
        yield f"{prefix}/{name.replace('.', '/')}", shape, p.numel() * p.element_size() * layers


def _leaves(model: nn.Module) -> Iterator[Tuple[str, Tuple[int, ...], int]]:
    """(reference path, whole shape, the bytes this rank holds) of each of
    a port ``Model``'s or ``StackedModel``'s leaves (a stacked model's lead
    with the slot axis, the reference's cluster dim)."""
    slots = getattr(model, "n", 0) if hasattr(model, "load_slot") else 0

    def one(path, p):
        return path, whole_shape(p), p.numel() * p.element_size()

    yield one("embed", model.embedding)
    for i, stack in enumerate(model.stacks):
        yield from _stack_leaves(stack, f"stacks/{i}", slots)
    yield one("final_norm/scale", model.final_norm.scale)
    yield one("head/w", model.head.w)
    enc = getattr(model, "encoder", None)
    if enc is not None:
        yield from _stack_leaves(enc.stacks[0], "encoder/stacks/0", 0)
        yield one("encoder/norm/scale", enc.norm.scale)


def param_shapes(model: nn.Module) -> Dict[str, Tuple[int, ...]]:
    """{reference path: whole shape} of a port ``Model`` or
    ``StackedModel`` (whose leaves lead with the slot axis, the reference's
    cluster dim), parameter by parameter in the reference's layout."""
    return {path: shape for path, shape, _ in _leaves(model)}


def param_bytes(model: nn.Module, mesh, cluster_axis: Optional[str] = None
                ) -> Dict[str, Tuple[int, int]]:
    """{reference path: (the bytes this rank holds, ``local_bytes`` of
    :func:`param_shardings`' spec)} of a port model over ``mesh``; where
    they differ the port departs from the reference's layout (a whole
    layer, a shared KV head, a sectioned or whole projection).  Over
    ``cluster_axis`` the model is this rank's share of the slots (the
    sharded round), and the spec's slot dim is all of them."""
    pods = mesh.shape[cluster_axis] if cluster_axis is not None else 1
    leaves = [(path, (shape[0] * pods,) + shape[1:] if pods > 1 else shape, held)
              for path, shape, held in _leaves(model)]
    specs = param_shardings({path: shape for path, shape, _ in leaves}, mesh, cluster_axis)
    elt = model.embedding.element_size()
    return {path: (held, local_bytes(shape, elt, specs[path], mesh))
            for path, shape, held in leaves}


def _shapes(tree) -> Dict[str, Tuple[int, ...]]:
    if isinstance(tree, nn.Module):
        return param_shapes(tree)
    return {k: tuple(getattr(v, "shape", v)) for k, v in tree.items()}


def param_shardings(params, mesh, cluster_axis: Optional[str] = None) -> Dict[str, Spec]:
    """{reference path: spec} of a port model (or a {path: shape} dict).
    If ``cluster_axis`` is given, every leaf is assumed to carry a leading
    cluster-replica dim sharded over that axis (the multi-pod Pigeon
    layout)."""
    model_size = mesh.shape["model"]
    return {path: _spec_for_leaf(path, shape, model_size, cluster_axis=cluster_axis,
                                 cluster_dim=cluster_axis is not None)
            for path, shape in _shapes(params).items()}


def _data_axes(mesh, cluster_axis: Optional[str] = None):
    dp = [n for n in mesh.axis_names if n in ("pod", "data") and n != cluster_axis]
    return tuple(dp) if len(dp) > 1 else (dp[0] if dp else None)


def batch_shardings(batch_shape: Dict[str, Any], mesh,
                    cluster_axis: Optional[str] = None) -> Dict[str, Spec]:
    """Batch dim over ("pod","data") (or ("data",) on one pod).  If
    cluster_axis is set, a leading cluster dim is sharded over it and the
    batch goes over the remaining data axes."""
    dp_axes = _data_axes(mesh, cluster_axis)

    def one(shape):
        spec = [dp_axes] + [None] * (len(shape) - 1)
        if cluster_axis is not None:
            spec = [cluster_axis] + spec[:len(shape) - 1]
        return tuple(spec[:len(shape)])

    return {k: one(tuple(v.shape)) for k, v in batch_shape.items()}


def cache_paths(cache) -> Dict[str, Tuple[int, ...]]:
    """{"stack/name": shape} of a decode cache (a tuple of dicts)."""
    return {f"{i}/{k}": tuple(t.shape) for i, c in enumerate(cache) for k, t in c.items()}


def cache_shardings(cache_shape, mesh, batch: int, seq_shard: bool = False
                    ) -> Dict[str, Spec]:
    """Decode-cache shardings.

    Default: shard the cache batch dim over ("pod","data") when divisible,
    the kv-heads dim over "model" when divisible, else the cache sequence
    over "model".  ``seq_shard=True`` (long-context flash-decoding layout)
    shards the *sequence* dim of attention caches over the data axes
    instead.  The port's ``Model.init_cache`` holds a rank's part of this
    layout: where the spec puts ``model`` on the sequence, the ranks that
    hold the same KV heads split it; under ``seq_shard`` the data ranks
    too (and the model ranks keep their KV heads, so a rank holds no more
    than this spec gives it)."""
    shape_of = mesh.shape
    dp = tuple(n for n in mesh.axis_names if n in ("pod", "data"))
    dp_size = int(math.prod([shape_of[a] for a in dp]))
    model_size = shape_of["model"]
    dp_axes = dp if len(dp) > 1 else dp[0]
    shapes = cache_shape if isinstance(cache_shape, dict) else cache_paths(cache_shape)

    def one(name: str, shape):
        spec = [None] * len(shape)
        bdim = 1 if len(shape) >= 2 and shape[0] != batch else 0
        last = name.split("/")[-1]
        if last in ("k", "v") or "latent" in name or "k_rope" in name:
            sdim = bdim + 1
            if seq_shard and shape[sdim] % dp_size == 0:
                spec[sdim] = dp_axes
            elif shape[bdim] % dp_size == 0:
                spec[bdim] = dp_axes
            if len(shape) >= sdim + 3 and shape[sdim + 1] % model_size == 0:
                spec[sdim + 1] = "model"
            elif spec[sdim] is None and shape[sdim] % model_size == 0:
                spec[sdim] = "model"
        else:
            if shape[bdim] % dp_size == 0:
                spec[bdim] = dp_axes
            if len(shape) > bdim + 1 and shape[bdim + 1] % model_size == 0:
                spec[bdim + 1] = "model"
        return tuple(spec)

    return {name: one(name, tuple(shape)) for name, shape in shapes.items()}


def replicated(mesh) -> Spec:
    return ()


def pigeon_sweep_shardings(stacked_params, batches, val_batch, mesh,
                           seed_axis: str = "seed", cluster_axis: str = "pod"):
    """The (params, batches, val) spec triple of the multi-seed sweep
    round: per-seed carried params lead with the seed axis, per-replica
    batches with (seed, cluster), and the shared set D_o sharded over any
    intra-replica "data" axis."""
    p_shard = param_shardings(stacked_params, mesh, cluster_axis=seed_axis)
    lead = (seed_axis, cluster_axis)

    def one(shape):
        spec = list(lead[:len(shape)]) + [None] * (len(shape) - 2)
        return tuple(spec[:len(shape)])

    b_shard = {k: one(tuple(v.shape)) for k, v in batches.items()}
    data_ax = "data" if "data" in mesh.axis_names else None
    v_shard = {k: (data_ax,) + (None,) * (v.dim() - 1) for k, v in val_batch.items()}
    return p_shard, b_shard, v_shard


def pigeon_round_shardings(stacked_params, batches, val_batch, mesh,
                           cluster_axis: str = "pod"):
    """The (params, batches, val) spec triple of a Pigeon round step:
    stacked cluster replicas and per-cluster batches over the cluster axis,
    and the shared set D_o replicated across pods but sharded over the data
    axis within a pod."""
    p_shard = param_shardings(stacked_params, mesh, cluster_axis=cluster_axis)
    b_shard = batch_shardings(batches, mesh, cluster_axis=cluster_axis)
    v_shard = {k: ("data",) + (None,) * (v.dim() - 1) for k, v in val_batch.items()}
    return p_shard, b_shard, v_shard


def local_bytes(shape: Sequence[int], elt: int, spec: Spec, mesh) -> int:
    """The bytes one rank holds of a tensor of ``shape`` laid out by
    ``spec``."""
    sizes = mesh.shape
    n = math.prod(shape) * elt
    for entry in spec:
        for ax in (entry if isinstance(entry, tuple) else (entry,)):
            if ax is not None:
                n //= sizes[ax]
    return n


# ---------------------------------------------------------------------------
# the whole tensors and each rank's shards
# ---------------------------------------------------------------------------

def _piece(whole: torch.Tensor, lay) -> torch.Tensor:
    """Piece ``lay.index`` of ``whole`` under the layout ``lay``
    (``parallel.Layout``): a contiguous chunk, or each section's chunk (a
    whole section as it is) concatenated."""
    if lay.sections is None:
        return whole.chunk(lay.parts, dim=lay.dim)[lay.index]
    sections = whole.split([n for n, _ in lay.sections], dim=lay.dim)
    return torch.cat([t.chunk(lay.parts, dim=lay.dim)[lay.index] if split else t
                      for t, (_, split) in zip(sections, lay.sections)], dim=lay.dim)


@torch.no_grad()
def shard_param(p: torch.Tensor, whole: torch.Tensor, name: str = "") -> None:
    """Copy ``p``'s shard (its layout, ``parallel.mark``) out of ``whole``."""
    lay = layout(p)
    piece = whole if lay is None else _piece(whole, lay)
    if piece.shape != p.shape:
        raise ValueError(f"{name}: shard {tuple(piece.shape)} for a parameter "
                         f"{tuple(p.shape)}")
    p.copy_(piece.to(p.device))


def shard_params(model: nn.Module, whole: Dict[str, torch.Tensor]) -> nn.Module:
    """Copy each parameter's shard out of ``whole`` (the whole model's
    ``named_parameters()`` dict, the same names) into ``model``, this rank's
    part of the parallel model; returns ``model``."""
    params = dict(model.named_parameters())
    if sorted(params) != sorted(whole):
        raise ValueError("shard_params: the whole model's parameters and this rank's differ")
    for name, p in params.items():
        shard_param(p, whole[name], name)
    return model


@torch.no_grad()
def gather_param(p: torch.Tensor, par=None) -> torch.Tensor:
    """The whole tensor of one parameter of this rank's part of the
    parallel model (``par`` its view of the mesh), on every rank: a sharded
    parameter's pieces all-gathered over ``model`` (a KV head held by
    several ranks taken once, a whole section from the first rank); a
    replicated one as it is."""
    lay = layout(p)
    if lay is None or par is None or par.model_size == 1:
        return p.detach().clone()
    every = collective("all_gather", p.detach().contiguous(), par.model_group,
                       size=par.model_size).chunk(par.model_size, dim=0)
    share = par.model_size // lay.parts
    pieces = [every[j * share] for j in range(lay.parts)]
    if lay.sections is None:
        return torch.cat(pieces, dim=lay.dim)
    cut = [t.split(lay.local_sizes(), dim=lay.dim) for t in pieces]
    return torch.cat([torch.cat([c[i] for c in cut], dim=lay.dim) if split else cut[0][i]
                      for i, (_, split) in enumerate(lay.sections)], dim=lay.dim)


def gather_params(model: nn.Module) -> Dict[str, torch.Tensor]:
    """:func:`gather_param` of each of ``model``'s parameters, by name."""
    par = getattr(model, "par", None)
    return {name: gather_param(p, par) for name, p in model.named_parameters()}


__all__ = ["batch_shardings", "cache_paths", "cache_shardings",
           "gather_param", "gather_params", "local_bytes", "param_bytes", "param_shapes",
           "param_shardings",
           "pigeon_round_shardings", "pigeon_sweep_shardings", "replicated",
           "shard_param", "shard_params", "whole_shape"]
