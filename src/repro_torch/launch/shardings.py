"""Sharding rules: parameters, batches and decode caches over a mesh's
``pod``, ``data`` and ``model`` axes (the reference's
``repro/launch/shardings.py``, its rule table copied as it is).

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
local shard and records its layout on it (``parallel.mark``):
:func:`shard_params` takes each rank's shard out of the whole tensors and
:func:`gather_params` puts the whole back together.  Where the model axis
exceeds a GQA model's KV heads the reference's rule splits inside a head;
the port holds each KV head whole on the ranks whose query heads read it,
and where the axis does not divide the query heads (Qwen2.5-14B's 40 at
16, which the reference splits mid-head) the attention block whole on each
model rank, while :func:`param_shardings` still returns the reference's
spec.
"""
from __future__ import annotations

import math
import re
from typing import Any, Dict, Iterator, Optional, Sequence, Tuple

import torch
from torch import nn

from ..models.parallel import collective, layout

Spec = Tuple[Any, ...]

# leaf-name patterns -> which logical dim gets the "model" axis.
# dims are indexed from the END of the shape so stacked leading dims are
# transparent ("-1" = last dim, "-2" = second-to-last).
_RULES = [
    (r"embed$", -2),                    # (V, D) shard vocab rows
    (r"head/w$", -1),                   # (D, V) shard vocab cols
    (r"(wq|wk|wv)/w$", -1),             # (D, H*hd) shard heads-out
    (r"(wq|wk|wv)/b$", -1),
    (r"wo/w$", -2),                     # (H*hd, D) shard heads-in
    (r"(gate|up)/w$", -1),              # (D, F) shard ffn-out
    (r"down/w$", -2),                   # (F, D) shard ffn-in
    (r"moe/(gate|up)$", -3),            # (E, D, F) expert parallel
    (r"moe/down$", -3),                 # (E, F, D) expert parallel
    (r"shared/(gate|up)/w$", -1),
    (r"shared/down/w$", -2),
    (r"in_proj/w$", -1),                # mamba (D, d_in_proj)
    (r"out_proj/w$", -2),               # mamba (di, D)
    (r"w_dkv/w$", -1),                  # MLA down-proj
    (r"(w_uk|w_uv)/w$", -1),            # MLA up-proj (rank, H*hd)
    (r"w_if/w$", -1),
    (r"r$", None),                      # slstm recurrent: replicate
]


def _spec_for_leaf(path: str, shape: Tuple[int, ...], model_size: int,
                   model_axis: str = "model", cluster_axis: Optional[str] = None,
                   cluster_dim: bool = False) -> Spec:
    """cluster_dim: the leaf carries a leading cluster-replica dim (sharded
    over cluster_axis); the name rules then apply to the remaining dims."""
    ndim = len(shape)
    lead = 1 if (cluster_dim and cluster_axis is not None) else 0
    spec = [None] * ndim
    for pat, dim in _RULES:
        if re.search(pat, path):
            if dim is not None:
                d = ndim + dim
                if lead <= d < ndim and shape[d] % model_size == 0 and shape[d] >= model_size:
                    spec[d] = model_axis
            break
    if lead:
        spec[0] = cluster_axis
    return tuple(spec)


# ---------------------------------------------------------------------------
# the reference's leaf paths of the port's models
# ---------------------------------------------------------------------------

def whole_shape(p: torch.Tensor) -> Tuple[int, ...]:
    """The whole tensor's shape of a (possibly sharded) parameter."""
    shape = list(p.shape)
    lay = layout(p)
    if lay is not None:
        dim, parts, _ = lay
        shape[dim] *= parts
    return tuple(shape)


def _stack_leaves(stack, prefix: str, slots: int) -> Iterator[Tuple[str, Tuple[int, ...]]]:
    for name, p in stack.layers[0].named_parameters():
        shape = whole_shape(p)
        if stack.kind != "shared_attn":
            shape = (shape[:1] + (stack.n,) + shape[1:]) if slots else (stack.n,) + shape
        yield f"{prefix}/{name.replace('.', '/')}", shape


def param_shapes(model: nn.Module) -> Dict[str, Tuple[int, ...]]:
    """{reference path: whole shape} of a port ``Model`` or
    ``StackedModel`` (whose leaves lead with the slot axis, the reference's
    cluster dim), parameter by parameter in the reference's layout."""
    slots = getattr(model, "n", 0) if hasattr(model, "load_slot") else 0
    out = {"embed": whole_shape(model.embedding)}
    for i, stack in enumerate(model.stacks):
        out.update(_stack_leaves(stack, f"stacks/{i}", slots))
    out["final_norm/scale"] = whole_shape(model.final_norm.scale)
    out["head/w"] = whole_shape(model.head.w)
    enc = getattr(model, "encoder", None)
    if enc is not None:
        out.update(_stack_leaves(enc.stacks[0], "encoder/stacks/0", 0))
        out["encoder/norm/scale"] = whole_shape(enc.norm.scale)
    return out


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

@torch.no_grad()
def shard_param(p: torch.Tensor, whole: torch.Tensor, name: str = "") -> None:
    """Copy ``p``'s shard (its layout, ``parallel.mark``) out of ``whole``."""
    lay = layout(p)
    piece = whole if lay is None else whole.chunk(lay[1], dim=lay[0])[lay[2]]
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
    several ranks taken once); a replicated one as it is."""
    lay = layout(p)
    if lay is None or par is None or par.model_size == 1:
        return p.detach().clone()
    dim, parts, _ = lay
    every = collective("all_gather", p.detach().contiguous(), par.model_group,
                       size=par.model_size).chunk(par.model_size, dim=0)
    share = par.model_size // parts
    return torch.cat([every[j * share] for j in range(parts)], dim=dim)


def gather_params(model: nn.Module) -> Dict[str, torch.Tensor]:
    """:func:`gather_param` of each of ``model``'s parameters, by name."""
    par = getattr(model, "par", None)
    return {name: gather_param(p, par) for name, p in model.named_parameters()}


__all__ = ["batch_shardings", "cache_paths", "cache_shardings",
           "gather_param", "gather_params", "local_bytes", "param_shapes", "param_shardings",
           "pigeon_round_shardings", "pigeon_sweep_shardings", "replicated",
           "shard_param", "shard_params", "whole_shape"]
