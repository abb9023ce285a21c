"""Tensor and data parallelism over a ``torch.distributed`` mesh: the
collectives the port's parallel model makes, with no counterpart in the
reference (which leaves the layout to GSPMD and the collectives to XLA).

A :class:`Parallel` is one rank's view of the mesh's ``data`` and
``model`` axes (``launch/mesh.py::Mesh.parallel``): the process group of
each, its size and this rank's index.  The model's modules take one and
hold the local shard of each weight (``launch/shardings.py`` lays the
whole tensor out), Megatron's pattern:

  * column-parallel products (``wq``, ``wk``, ``wv``, SwiGLU's ``gate``
    and ``up``, the MoE's experts): the input enters through
    :func:`copy_to` (forward identity, backward an all-reduce of the
    input's gradient over ``model``), each rank computes its columns;
  * row-parallel products (``wo``, ``down``): each rank's partial sum
    leaves through :func:`reduce_from` (forward an all-reduce over
    ``model``, backward identity), one all-reduce a block;
  * the vocab-parallel embedding (:func:`vocab_embed`: rows over
    ``model``, a masked lookup, then one all-reduce) and head
    (``kernels/ops.py::parallel_cross_entropy``, B4 on each rank's panel;
    :func:`gather_from` for logits);
  * the ``data`` axis (a mesh's batch axes: ``data``, and ``pod`` where it
    carries no clusters): each rank holds its rows of the batch; the loss
    reduces its sums over ``data`` (:func:`reduce_from`), and the train
    step sums the gradients over ``data`` (:func:`all_reduce_grads`).

A projection whose output concatenates sections (Mamba2's ``in_proj``
[z, x, B, C, dt], the mLSTM's ``up`` [x_inner, z] and ``w_if`` [i, f]) has
a sectioned :class:`Layout`: each section is split by heads or held whole.
A weight (or section) every rank holds whole and uses for its own heads
(MLA's ``w_dkv`` and ``kv_norm``, Mamba2's B and C, the mLSTM's x_inner)
takes its gradient summed over ``model`` (:func:`shared_grad`,
:func:`shared_sections`); a norm over a width the ranks split (Mamba2's
and the mLSTM's ``out_norm``) all-reduces its sums of squares both ways
(:func:`sum_over`, ``blocks.rms_norm``).

Where the model axis does not divide a layer's dim (:meth:`Parallel.divides`,
the reference's rule: Qwen2.5-14B's 40 heads, InternVL2-26B's vocab of
92,553 or xLSTM-1.3B's 4 heads at 16), the layer runs whole on each model
rank (:meth:`Parallel.over` gives it a view of model axis 1): its weights
are replicated, it makes no model collective, and its gradient is not
summed over ``model`` (every rank computes it whole from the same input).
The sLSTM always runs so: its recurrence couples every head.

A decode cache whose KV heads several ranks hold is sharded on its sequence
(:class:`Panels`): the ranks that hold the same KV heads split those heads'
positions among them (the model ranks that share a KV head, or every model
rank for a whole attention block or MLA's latent cache, which has no head
axis) and, under ``seq_shard`` or a batch of 1, the data ranks too.  Each
rank runs B6's partial mode (MLA: its plain absorbed partial) over its
panel and :func:`combine_panels` merges the partials with one all-gather.

Every collective goes through :func:`collective`, which counts its calls
and bytes by kind in :data:`COLLECTIVES` (the dry run's per-rank record).
On the ``meta`` device it counts and moves nothing.  Under an axis of size
1 every function here returns its input untouched and counts nothing, so a
model built with :data:`SINGLE` computes bit for bit what the plain model
computes.
"""
from __future__ import annotations

import dataclasses
import re
from collections import defaultdict
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

#: calls and bytes a rank's collectives moved, by kind ("all_reduce",
#: "all_gather", ...); :func:`reset_collectives` zeroes them
COLLECTIVES: Dict[str, Dict[str, int]] = defaultdict(lambda: {"calls": 0, "bytes": 0})

def reset_collectives() -> Dict[str, Dict[str, int]]:
    """Zero the counter; returns what it held."""
    held = {k: dict(v) for k, v in COLLECTIVES.items()}
    COLLECTIVES.clear()
    return held


def collective_totals() -> Dict[str, Any]:
    """{"bytes": all kinds' bytes, "calls": ..., "by_kind": {kind: bytes},
    "counts": {kind: calls}} of the counter."""
    return {"bytes": sum(v["bytes"] for v in COLLECTIVES.values()),
            "calls": sum(v["calls"] for v in COLLECTIVES.values()),
            "by_kind": {k: v["bytes"] for k, v in sorted(COLLECTIVES.items())},
            "counts": {k: v["calls"] for k, v in sorted(COLLECTIVES.items())}}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def collective(kind: str, t: torch.Tensor, group, op=dist.ReduceOp.SUM,
               size: int = 1) -> torch.Tensor:
    """The one place a collective runs: ``kind`` "all_reduce" (in place on
    ``t``, returned) or "all_gather" (``size`` ranks' contiguous ``t``
    concatenated along dim 0, in rank order).  Counted by kind: the bytes a
    rank sends (its tensor).  On the ``meta`` device nothing moves."""
    rec = COLLECTIVES[kind]
    rec["calls"] += 1
    rec["bytes"] += _nbytes(t)
    if kind == "all_reduce":
        if t.device.type != "meta":
            dist.all_reduce(t, op=op, group=group)
        return t
    if kind == "all_gather":
        out = torch.empty((size * t.shape[0],) + tuple(t.shape[1:]), dtype=t.dtype,
                          device=t.device)
        if t.device.type != "meta":
            dist.all_gather_into_tensor(out, t, group=group)
        return out
    raise ValueError(f"unknown collective {kind!r}")


@dataclasses.dataclass(frozen=True, eq=False)
class Parallel:
    """One rank's ``data`` and ``model`` axes: each axis's size, this
    rank's index along it and its process group (None at size 1).
    ``kv_group(share)`` gives the group of the ``share`` consecutive model
    ranks that hold one KV head whole (built collectively by the mesh).
    ``data_axes`` names the mesh axes the data axis spans (``("data",)``,
    or ``("pod", "data")`` where ``pod`` carries no clusters)."""
    model_size: int = 1
    model_rank: int = 0
    model_group: Any = None
    data_size: int = 1
    data_rank: int = 0
    data_group: Any = None
    mesh: Any = None
    data_axes: Tuple[str, ...] = ("data",)

    @property
    def trivial(self) -> bool:
        return self.model_size == 1 and self.data_size == 1

    def kv_group(self, share: int):
        """The group of the ``share`` model ranks that hold this rank's KV
        head (a collective the first time, through the mesh)."""
        if share == 1:
            return None
        if self.mesh is None:
            raise ValueError("a KV head shared by several model ranks needs the mesh's "
                             "groups (launch.mesh.make_mesh)")
        return self.mesh.model_subgroup(share)

    def local_rows(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This data rank's rows of a global batch tensor along ``dim``."""
        if self.data_size == 1:
            return x
        n = x.shape[dim]
        if n % self.data_size:
            raise ValueError(f"batch dim {n} not divisible by the data axis "
                             f"{self.data_size}")
        step = n // self.data_size
        return x.narrow(dim, self.data_rank * step, step)

    def batch_rows(self, batch: Dict[str, torch.Tensor], dim: int = 0
                   ) -> Dict[str, torch.Tensor]:
        return {k: self.local_rows(v, dim) for k, v in batch.items()}

    def divides(self, n: int) -> bool:
        """Whether the model axis splits a dim of ``n`` (heads, vocab rows,
        FFN columns, experts) into equal pieces: the reference's rule
        (``shardings._spec_for_leaf``: n % m == 0 and n >= m)."""
        return n % self.model_size == 0 and n >= self.model_size

    def over(self, *dims: int) -> "Parallel":
        """The view a layer with these dims runs under: this one where the
        model axis divides every dim, else the whole view (model axis 1,
        the same data axis): the layer held whole on each model rank, no
        model collective, its gradient not summed over ``model``."""
        if self.model_size == 1 or all(self.divides(n) for n in dims):
            return self
        return self.whole()

    def whole(self) -> "Parallel":
        """This view with a model axis of 1 (the data axis kept)."""
        return dataclasses.replace(self, model_size=1, model_rank=0, model_group=None)


#: the trivial view: no axis, every function the identity
SINGLE = Parallel()


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return collective("all_reduce", g.contiguous().clone(), ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, op):
        return collective("all_reduce", x.contiguous().clone(), group, op)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def copy_to(x: torch.Tensor, group, size: int) -> torch.Tensor:
    """Megatron's ``f``: identity forward, the gradient all-reduced (SUM)
    over ``group`` backward: the input of a column-parallel product."""
    if size == 1:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _CopyTo.apply(x, group)
    return x


def reduce_from(x: torch.Tensor, group, size: int, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """Megatron's ``g``: an all-reduce (SUM unless ``op``) over ``group``
    forward, identity backward: the output of a row-parallel product, a
    loss's sums over ``data``."""
    if size == 1:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _ReduceFrom.apply(x, group, op)
    return collective("all_reduce", x.contiguous().clone(), group, op)


def enter(x: torch.Tensor, par: "Parallel") -> torch.Tensor:
    """:func:`copy_to` over ``par``'s model axis: a block's input."""
    return copy_to(x, par.model_group, par.model_size)


def leave(y: torch.Tensor, par: "Parallel") -> torch.Tensor:
    """:func:`reduce_from` over ``par``'s model axis: a block's output."""
    return reduce_from(y, par.model_group, par.model_size)


class _SharedGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, group):
        ctx.group = group
        return w.view_as(w)

    @staticmethod
    def backward(ctx, g):
        return collective("all_reduce", g.contiguous().clone(), ctx.group), None


def shared_grad(w: torch.Tensor, group) -> torch.Tensor:
    """A weight held whole on several ranks that each use it for part of
    the work (a KV head read by the query heads of ``share`` ranks):
    identity forward, its gradient summed over ``group`` backward, so each
    copy takes the whole gradient and the copies stay equal."""
    if group is None or not (torch.is_grad_enabled() and w.requires_grad):
        return w
    return _SharedGrad.apply(w, group)


def gather_from(x: torch.Tensor, group, size: int, dim: int = -1) -> torch.Tensor:
    """The ``size`` ranks' ``x`` concatenated along ``dim`` in rank order
    (no gradient: logits for the serve path)."""
    if size == 1:
        return x
    parts = collective("all_gather", x.detach().contiguous(), group, size=size)
    return torch.cat(parts.chunk(size, dim=0), dim=dim)


def vocab_rows(table: torch.Tensor, tokens: torch.Tensor, par: Parallel) -> torch.Tensor:
    """This rank's part of the vocab-parallel lookup, before its reduce:
    the rows of ``table`` (V/m, D), this rank's rows of the whole (V, D)
    embedding, for the tokens that fall in them, zeros for the others."""
    if par.model_size == 1:
        return table[tokens]
    v_local = table.shape[0]
    local = tokens - par.model_rank * v_local
    inside = (local >= 0) & (local < v_local)
    rows = table[torch.where(inside, local, torch.zeros_like(local))]
    return rows * inside[..., None].to(rows.dtype)


def vocab_embed(table: torch.Tensor, tokens: torch.Tensor, par: Parallel) -> torch.Tensor:
    """The vocab-parallel lookup: :func:`vocab_rows`, then one all-reduce
    over ``model`` sums the ranks' rows."""
    return reduce_from(vocab_rows(table, tokens, par), par.model_group, par.model_size)


def all_reduce_grads(grads: Sequence[torch.Tensor], par: Parallel) -> Sequence[torch.Tensor]:
    """The gradients summed over ``data`` (in place, one all-reduce a
    tensor), the data-parallel step's reduction."""
    if par.data_size == 1:
        return grads
    for g in grads:
        collective("all_reduce", g, par.data_group)
    return grads


class Layout(NamedTuple):
    """A parameter's piece of the whole tensor: piece ``index`` of ``parts``
    along ``dim`` (negative, counted from the end, so a stacked slot axis is
    transparent).  ``sections`` None: ``parts`` equal contiguous pieces.
    Else the whole dim is the concatenation of sections ((whole size,
    split), ...), each either cut in ``parts`` equal pieces (``split``) or
    held whole on every rank; the piece is the sections' pieces
    concatenated in order (Mamba2's ``in_proj`` [z, x, B, C, dt], the
    mLSTM's ``up`` [x_inner, z] and ``w_if`` [i, f])."""
    dim: int
    parts: int
    index: int
    sections: Optional[Tuple[Tuple[int, bool], ...]] = None

    def local_sizes(self) -> Tuple[int, ...]:
        """Each section's size in a piece."""
        return tuple(n // self.parts if split else n for n, split in self.sections)

    def whole_size(self, local: int) -> int:
        """The whole dim of a piece ``local`` wide."""
        if self.sections is None:
            return local * self.parts
        return sum(n for n, _ in self.sections)


#: a sharding spec: one entry a dim, an axis name, a tuple of them or None
#: (the reference's ``PartitionSpec``)
Spec = Tuple[Any, ...]

#: the reference's sharding rules (``repro/launch/shardings.py``, its table
#: copied as it is; ``launch/shardings.py`` lays whole tensors out by them)
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


def mark(p: torch.nn.Parameter, dim: int, parts: int, index: int,
         sections: Optional[Sequence[Tuple[int, bool]]] = None) -> torch.nn.Parameter:
    """Record on ``p`` its :class:`Layout`: what
    ``launch/shardings.py::shard_params`` and ``gather_params`` read."""
    p.tp_layout = Layout(dim, parts, index, None if sections is None else tuple(sections))
    return p


def layout(p: torch.Tensor) -> Optional[Layout]:
    """The :class:`Layout` of a marked parameter, None if replicated."""
    return getattr(p, "tp_layout", None)


def mark_by_rule(module: torch.nn.Module, par: "Parallel", prefix: str = "",
                 departures: Optional[Dict[str, Optional[Layout]]] = None) -> None:
    """Record the layout of each of ``module``'s parameters under ``par``,
    derived from the reference's spec (:func:`_spec_for_leaf`) of its path
    ``prefix + name``: piece ``par.model_rank`` of m along the dim its rule puts ``model`` on
    (the whole dim, m pieces of this one, always divides), replicated where
    the rule replicates; but where ``departures`` names the parameter, its
    :class:`Layout` there (None: held whole).  Nothing under a model axis
    of 1."""
    if par.model_size == 1:
        return
    departures = departures or {}
    for name, p in module.named_parameters():
        if name in departures:
            if departures[name] is not None:
                p.tp_layout = departures[name]
            continue
        spec = _spec_for_leaf(prefix + name.replace(".", "/"), tuple(p.shape), 1)
        if "model" in spec:
            mark(p, spec.index("model") - len(spec), par.model_size, par.model_rank)


class _SharedSections(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, group, dim, spans):
        ctx.group, ctx.dim, ctx.spans = group, dim, spans
        return w.view_as(w)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        pieces = [g.narrow(ctx.dim, lo, n) for lo, n in ctx.spans]
        flat = collective("all_reduce", torch.cat([p.reshape(-1) for p in pieces]), ctx.group)
        for p, part in zip(pieces, flat.split([p.numel() for p in pieces])):
            p.copy_(part.view_as(p))
        return g, None, None, None


def shared_sections(w: torch.Tensor, group) -> torch.Tensor:
    """A sectioned parameter (:class:`Layout`) whose whole sections every
    rank holds and uses for its part of the work (Mamba2's B and C
    columns, the mLSTM's ``x_inner``): identity forward; backward, the
    gradient of those sections summed over ``group`` in one all-reduce
    (the split sections' stay the rank's own), so the copies stay equal."""
    lay = layout(w)
    if (group is None or lay is None or lay.sections is None
            or not (torch.is_grad_enabled() and w.requires_grad)):
        return w
    spans, lo = [], 0
    for (_, split), n in zip(lay.sections, lay.local_sizes()):
        if not split:
            spans.append((lo, n))
        lo += n
    dim = lay.dim % w.dim()
    return _SharedSections.apply(w, group, dim, tuple(spans))


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return collective("all_reduce", x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return collective("all_reduce", g.contiguous().clone(), ctx.group), None


def sum_over(x: torch.Tensor, par: "Parallel") -> torch.Tensor:
    """The sum over ``par``'s model axis of a partial sum that every rank
    then reads for its own part (an RMS norm's sum of squares over a dim
    the ranks split): an all-reduce forward and, since each rank's result
    feeds only its own columns, an all-reduce of the gradient backward."""
    if par.model_size == 1:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _SumOver.apply(x, par.model_group)
    return collective("all_reduce", x.contiguous().clone(), par.model_group)


def heads_layout(par: Parallel, n_heads: int, n_kv_heads: int):
    """(local query heads, local KV heads, KV pieces, this rank's KV piece,
    share): the query heads split evenly over ``model``; the KV heads too
    where the axis divides them, else each KV head held whole on the
    ``share = m / Hkv`` ranks whose query heads read it.  None where the
    block runs whole on each model rank: the axis does not divide the
    query heads, or it and the KV heads divide neither way."""
    m = par.model_size
    if not par.divides(n_heads):
        return None
    if n_kv_heads % m == 0:
        return n_heads // m, n_kv_heads // m, m, par.model_rank, 1
    if m % n_kv_heads:
        return None
    share = m // n_kv_heads
    return n_heads // m, 1, n_kv_heads, par.model_rank // share, share


@dataclasses.dataclass(frozen=True, eq=False)
class Panels:
    """A decode cache's sequence layout on this rank: ``count`` panels of
    ``length`` positions, this rank holding panel ``index`` (the absolute
    positions [base, base + length)); ``group`` the ``count`` ranks'
    process group (group rank = panel index; None on an abstract mesh);
    ``rows_whole`` where every data rank holds the whole batch (the panels
    span the data axis: ``seq_shard`` or a batch of 1).  ``count`` 1: the
    whole sequence here."""
    count: int = 1
    index: int = 0
    length: int = 0
    group: Any = None
    rows_whole: bool = False

    @property
    def base(self) -> int:
        return self.index * self.length

    def holds(self, position: int) -> bool:
        return 0 <= position - self.base < self.length


def cache_panels(par: Parallel, share: int, max_seq: int, seq_shard: bool) -> Panels:
    """The panels of a decode cache of ``max_seq`` positions whose KV heads
    ``share`` model ranks hold (1: the rank's own; m / Hkv: a shared KV
    head; m: a whole attention block): those ranks split the sequence, and
    with ``seq_shard`` the data ranks too (the panel group is then the
    product, ordered by data rank, then model rank, as the global ranks
    are).  Each panel holds ceil(max_seq / count) positions."""
    over_data = seq_shard and par.data_size > 1
    count = share * (par.data_size if over_data else 1)
    index = (par.data_rank * share if over_data else 0) + par.model_rank % share
    group = None
    if count > 1 and par.mesh is not None:
        group = par.mesh.panel_group(share, par.data_axes if over_data else ())
    return Panels(count, index, -(-max_seq // count), group, over_data)


def combine_panels(out: torch.Tensor, lse: torch.Tensor, panels: Panels,
                   dtype: torch.dtype) -> torch.Tensor:
    """The attention over every panel from this rank's partial (out f32
    (B, 1, H, D), lse f32 (B, 1, H): ``kernels.ops.decode_attention_partial``):
    one all-gather of the packed pair over the panel group, then
    ``combine_partials`` in panel order on every rank, so that the ranks'
    results are bit-equal -> (B, 1, H, D) in ``dtype``."""
    from ..kernels.decode_attention import combine_partials
    packed = torch.cat([out, lse[..., None]], dim=-1).contiguous()
    every = collective("all_gather", packed, panels.group, size=panels.count)
    every = every.view((panels.count,) + tuple(packed.shape))
    return combine_partials(every[..., :-1], every[..., -1], dtype)


def optional(par: Optional[Parallel]) -> Parallel:
    return SINGLE if par is None else par


__all__ = ["COLLECTIVES", "Layout", "Panels", "Parallel", "SINGLE", "all_reduce_grads",
           "cache_panels", "collective", "collective_totals", "combine_panels", "copy_to",
           "enter", "gather_from", "heads_layout", "layout", "leave", "mark", "mark_by_rule",
           "optional",
           "reduce_from", "reset_collectives", "shared_grad", "shared_sections", "sum_over",
           "vocab_embed", "vocab_rows"]
