"""Mixture-of-Experts layer with top-k routing and capacity-based dispatch:
the reference's ``repro/models/moe.py``, in its own formulation.

Tokens are placed into a static ``(n_experts, capacity, d_model)`` buffer at
``(expert, slot)``, the slot a (token, k) pair's place in its expert's
queue; the experts run as grouped products ((E, C, D) x (E, D, F), one
``torch.bmm`` each, as the reference computes them outside any kernel);
tokens past an expert's capacity are dropped (contribute zero).  What must
match the reference exactly, and how:

  * **Top-k ties** go to the lower expert index, as ``jax.lax.top_k``
    breaks them: a stable descending sort of the probabilities, its first k
    (``torch.topk`` prefers the higher index on the CPU).
  * **Slot order**: the slot cumsum runs over the (token, k) pairs
    token-major, each token's k ids in descending weight, so the same
    pairs are dropped past capacity.
  * **Router precision**: ``x @ router`` in the weights' dtype, then f32.
  * **Dropped pairs**: the reference adds a zero source into slot
    ``capacity - 1``; each kept (expert, slot) pair is unique, so the port
    index-assigns the kept pairs (no accumulating add, so no atomics in
    bf16) and sends the dropped ones' zeros to a spare row: the same
    buffer.
  * **Aux loss**: ``E * sum_e f_e p_e * router_aux_weight`` a layer.

The work is a function of the weights (:func:`moe_forward`), which the
plain :class:`MoE` and the cluster-stacked :class:`StackedMoE` (a call a
slot on views of its stacked weights, so that routing and dropping in a
slot are bit-equal to its plain model's) both call.  The reference's
shard-local dispatch (``shard``/``shard_groups``, ``"moe_shard"``: the
slot cumsum and the capacity per group of T/16 tokens, so other pairs drop)
runs where the reference's condition takes it, on one card or over a
mesh's data and model axes (experts over ``model``, whole groups a data
rank).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .blocks import SwiGLU, dense_init
from .parallel import collective, enter, leave, mark_by_rule, optional, reduce_from


class MoEConfig(NamedTuple):
    d_model: int
    d_expert: int            # per-expert FFN hidden size
    n_experts: int           # routed experts
    top_k: int
    n_shared: int = 0        # always-on shared experts (DeepSeek style)
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    shard: bool = False      # "moe_shard": the reference's shard-local dispatch
    shard_groups: int = 0    # its groups (16), 0 for the global dispatch


class MoEWeights(NamedTuple):
    """One layer's weights: router (D, E), gate and up (E, D, F), down (E,
    F, D), and the shared SwiGLU's (gate, up, down) kernels or None."""
    router: torch.Tensor
    gate: torch.Tensor
    up: torch.Tensor
    down: torch.Tensor
    shared: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None


def capacity(n_tokens: int, cfg: MoEConfig) -> int:
    """Slots an expert: ``ceil(T k cf / E)`` rounded up to a multiple of 8,
    at least 8."""
    c = int(math.ceil(n_tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts))
    return max(8, -(-c // 8) * 8)


def _mean_over_tokens(x: torch.Tensor, n_global: int, par) -> torch.Tensor:
    """The mean over the whole batch's tokens of a per-token (T, E) tensor:
    with a ``data`` axis the sums all-reduced (forward; the gradient of
    each rank's own tokens flows back unreduced)."""
    if par.data_size == 1:
        return x.mean(dim=0)
    return reduce_from(x.sum(dim=0), par.data_group, par.data_size) / n_global


def route(router: torch.Tensor, cfg: MoEConfig, x_flat: torch.Tensor, par=None
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(weights (T, k) in x's dtype, ids (T, k) int64, aux f32 scalar):
    the top-k of the router's softmax (ties to the lower expert), the
    weights renormalised over the k, and the Switch-style load-balance
    loss (over the whole batch: with ``par``'s data axis its two means
    are all-reduced)."""
    par = optional(par)
    logits = (x_flat @ router).to(torch.float32)                   # (T, E)
    probs = torch.softmax(logits, dim=-1)
    sorted_p, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, ids = sorted_p[:, :cfg.top_k], order[:, :cfg.top_k]
    weights = weights / torch.clamp_min(weights.sum(-1, keepdim=True), 1e-9)
    n_global = x_flat.shape[0] * par.data_size
    pe = _mean_over_tokens(probs, n_global, par)                   # (E,)
    fe = _mean_over_tokens(F.one_hot(ids, cfg.n_experts).to(torch.float32).sum(dim=1),
                           n_global, par)
    aux = cfg.n_experts * torch.sum(fe * pe) * cfg.router_aux_weight
    return weights.to(x_flat.dtype), ids, aux


def dispatch(ids: torch.Tensor, cfg: MoEConfig, cap: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(slot (T*k,), keep (T*k,) bool) of the (token, k) pairs, token-major:
    a pair's place in its expert's queue, and whether it is within
    ``cap``."""
    slot, keep = dispatch_groups(ids, cfg, 1, cap)
    return slot[0], keep[0]


def dispatch_groups(ids: torch.Tensor, cfg: MoEConfig, groups: int, cap: int,
                    offset: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(slot (G, T/G*k), keep (G, T/G*k) bool): :func:`dispatch` within
    each of ``groups`` consecutive groups of tokens (the reference's
    shard-local dispatch: the slot cumsum and the capacity per group);
    ``offset`` (E,) the pairs earlier data ranks put in each expert's
    queue (the global dispatch over a data axis)."""
    flat = ids.reshape(groups, -1)
    onehot = F.one_hot(flat, cfg.n_experts)                        # (G, Tk, E)
    pos = torch.cumsum(onehot, dim=1) - 1
    slot = torch.gather(pos, 2, flat[..., None])[..., 0]
    if offset is not None:
        slot = slot + offset[flat]
    return slot, slot < cap


def _swiglu(gate: torch.Tensor, up: torch.Tensor, down: torch.Tensor,
            x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ gate) * (x @ up)) @ down


def local_dispatch_taken(cfg: MoEConfig, n_tokens: int) -> bool:
    """The reference's condition for the shard-local dispatch
    (``moe.py:105``), on the whole batch's token count."""
    g = cfg.shard_groups
    return bool(g) and n_tokens % g == 0 and n_tokens >= g * cfg.n_experts


def moe_forward(w: MoEWeights, cfg: MoEConfig, x: torch.Tensor, par=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (out (B, S, D), aux f32 scalar).  The reference's
    global dispatch, or, under ``shard`` (``"moe_shard"``) where
    :func:`local_dispatch_taken`, its shard-local dispatch
    (``_moe_forward_local_dispatch``): G = ``shard_groups`` groups of T/G
    tokens, each with its own slot cumsum and ``capacity(T/G)``.

    With ``par`` (``models.parallel``): x holds this data rank's rows (the
    condition, the capacity and the aux loss are the whole batch's: a data
    rank holds whole groups, 16 a multiple of the data axis; the global
    dispatch offsets its slots by the earlier data ranks' pairs, one
    all-gather of (E,) counts); ``w``'s banks hold this model rank's E/m
    experts.  Each rank dispatches into its own experts' (G, E/m, C, D)
    buffer, runs them with ``torch.bmm``, gathers its pairs (zero for
    experts it does not hold) and one all-reduce over ``model`` sums the
    ranks' outputs (the shared expert's partial sums with them)."""
    par = optional(par)
    b, s, d = x.shape
    t, k, e = b * s, cfg.top_k, cfg.n_experts
    x_flat = x.reshape(t, d)
    weights, ids, aux = route(w.router, cfg, x_flat, par)
    t_global = t * par.data_size
    offset = None
    if local_dispatch_taken(cfg, t_global):
        g = cfg.shard_groups
        if g % par.data_size:
            raise ValueError(f"the shard-local dispatch's {g} groups do not split over the "
                             f"data axis {par.data_size}")
        groups, cap = g // par.data_size, capacity(t_global // g, cfg)
    else:
        groups, cap = 1, capacity(t_global, cfg)
        if par.data_size > 1:
            counts = F.one_hot(ids.reshape(-1), e).sum(dim=0, keepdim=True)
            every = collective("all_gather", counts, par.data_group, size=par.data_size)
            offset = every[:par.data_rank].sum(dim=0)
    slot, keep = dispatch_groups(ids, cfg, groups, cap, offset)
    x_in = enter(x_flat, par)
    out = _expert_pairs(w, x_in, ids, weights, slot, keep, groups, cap, par)
    if w.shared is not None:
        out = out + _swiglu(*w.shared, x_in)
    return leave(out, par).view(b, s, d), aux


def _expert_pairs(w: MoEWeights, x_flat: torch.Tensor, ids: torch.Tensor,
                  weights: torch.Tensor, slot: torch.Tensor, keep: torch.Tensor, groups: int,
                  cap: int, par) -> torch.Tensor:
    """The routed experts' combined output (T, D) of this rank's experts:
    each kept pair of an expert held here writes its (group, expert, slot)
    row of the (G E_l cap, D) buffer, once; every other pair writes its
    zeroed source into one spare row past the buffer (no accumulating add;
    no host sync).  The experts run as three ``torch.bmm``s over (E_l, G
    cap, D); each pair gathers its row back (zero where dropped or held
    elsewhere) and the top-k combine weights them."""
    t, d = x_flat.shape
    k = ids.shape[1]
    e_local = w.gate.shape[0]
    flat_ids = ids.reshape(groups, -1)
    if par.model_size > 1:
        e0 = par.model_rank * e_local
        use = keep & (flat_ids >= e0) & (flat_ids < e0 + e_local)
        local_ids = flat_ids - e0
        weights = enter(weights, par)
    else:
        use, local_ids = keep, flat_ids
    g_idx = torch.arange(groups, device=ids.device)[:, None]
    n_rows = groups * e_local * cap
    row = torch.where(use, (g_idx * e_local + local_ids) * cap + slot,
                      torch.full_like(slot, n_rows)).reshape(-1)
    use = use.reshape(-1)
    src = x_flat[:, None, :].expand(t, k, d).reshape(t * k, d) * use[:, None].to(x_flat.dtype)
    buf = x_flat.new_zeros((n_rows + 1, d)).index_put((row,), src)[:n_rows]
    if groups == 1:
        buf = buf.view(e_local, cap, d)
    else:
        buf = buf.view(groups, e_local, cap, d).transpose(0, 1).reshape(e_local, groups * cap, d)
    h = F.silu(torch.bmm(buf, w.gate)) * torch.bmm(buf, w.up)
    out_buf = torch.bmm(h, w.down)
    if groups > 1:
        out_buf = out_buf.view(e_local, groups, cap, d).transpose(0, 1)
    out_buf = out_buf.reshape(n_rows, d)
    # gather back (a pair not used here reads row 0 and is zeroed), combine
    gathered = out_buf[torch.where(use, row, torch.zeros_like(row))] * \
        use[:, None].to(x_flat.dtype)
    return torch.einsum("tkd,tk->td", gathered.view(t, k, d), weights)


def moe_forward_reference(w: MoEWeights, cfg: MoEConfig, x: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The exact loop over experts (E times the work; tests only): no
    capacity, every routed pair kept."""
    b, s, d = x.shape
    x_flat = x.reshape(b * s, d)
    weights, ids, aux = route(w.router, cfg, x_flat)
    out = torch.zeros_like(x_flat)
    for ex in range(cfg.n_experts):
        y = _swiglu(w.gate[ex], w.up[ex], w.down[ex], x_flat)
        w_e = torch.sum(torch.where(ids == ex, weights, torch.zeros_like(weights)), dim=1)
        out = out + y * w_e[:, None].to(y.dtype)
    if w.shared is not None:
        out = out + _swiglu(*w.shared, x_flat)
    return out.view(b, s, d), aux


def _moe_view(cfg: MoEConfig, par):
    """The view a MoE block runs under: expert-parallel where the model
    axis divides the experts and the shared expert's width, else whole on
    each model rank (``Parallel.over``)."""
    dims = (cfg.n_experts,) + ((cfg.n_shared * cfg.d_expert,) if cfg.n_shared else ())
    return optional(par).over(*dims)


class MoE(nn.Module):
    """The routed experts (router, gate, up, down) and the optional shared
    SwiGLU (``n_shared * d_expert`` wide).  ``forward(x)`` -> (out, aux).
    With ``par`` of model axis m > 1 the banks hold this rank's E/m
    experts and the shared SwiGLU its F/m columns (see
    :func:`moe_forward`); where m does not divide both, the block runs
    whole on each model rank."""

    def __init__(self, cfg: MoEConfig, *, dtype: torch.dtype = torch.float32, device=None,
                 par=None):
        super().__init__()
        self.cfg = cfg
        self.par = par = _moe_view(cfg, par)
        kw = dict(dtype=dtype, device=device)
        e, d, f = cfg.n_experts // par.model_size, cfg.d_model, cfg.d_expert
        self.router = nn.Parameter(torch.empty((d, cfg.n_experts), **kw))
        self.gate = nn.Parameter(torch.empty((e, d, f), **kw))
        self.up = nn.Parameter(torch.empty((e, d, f), **kw))
        self.down = nn.Parameter(torch.empty((e, f, d), **kw))
        self.shared = SwiGLU(d, cfg.n_shared * f, par=par, **kw) if cfg.n_shared else None
        mark_by_rule(self, par, prefix="moe/")

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The reference's ``moe_init``: the router a dense kernel, the
        experts truncated normals over fan-in."""
        self.router.copy_(dense_init(generator, *self.router.shape))
        for p in (self.gate, self.up, self.down):
            w = torch.empty(p.shape, dtype=torch.float32, device=generator.device)
            torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
            p.copy_(w / math.sqrt(p.shape[1]))
        if self.shared is not None:
            self.shared.reset_parameters(generator)

    def weights(self) -> MoEWeights:
        shared = (None if self.shared is None else
                  (self.shared.gate.w, self.shared.up.w, self.shared.down.w))
        return MoEWeights(self.router, self.gate, self.up, self.down, shared)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return moe_forward(self.weights(), self.cfg, x, self.par)


class StackedMoE(nn.Module):
    """n slots' :class:`MoE` (the same parameters, each with a leading slot
    axis): x (n, B, S, D) -> (out (n, B, S, D), aux (n,)), one
    :func:`moe_forward` a slot over views of the stacked weights."""

    def __init__(self, cfg: MoEConfig, n: int, *, dtype: torch.dtype = torch.float32,
                 device=None, par=None):
        super().__init__()
        self.cfg = cfg
        self.par = par = _moe_view(cfg, par)
        kw = dict(dtype=dtype, device=device)
        e, d, f = cfg.n_experts // par.model_size, cfg.d_model, cfg.d_expert
        self.router = nn.Parameter(torch.zeros((n, d, cfg.n_experts), **kw))
        self.gate = nn.Parameter(torch.zeros((n, e, d, f), **kw))
        self.up = nn.Parameter(torch.zeros((n, e, d, f), **kw))
        self.down = nn.Parameter(torch.zeros((n, e, f, d), **kw))
        if cfg.n_shared:
            from .blocks import StackedSwiGLU
            self.shared = StackedSwiGLU(n, d, cfg.n_shared * f, par=par, **kw)
        else:
            self.shared = None
        mark_by_rule(self, par, prefix="moe/")

    def slot_weights(self, r: int) -> MoEWeights:
        shared = (None if self.shared is None else
                  (self.shared.gate.w[r], self.shared.up.w[r], self.shared.down.w[r]))
        return MoEWeights(self.router[r], self.gate[r], self.up[r], self.down[r], shared)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        outs = [moe_forward(self.slot_weights(r), self.cfg, xr, self.par)
                for r, xr in enumerate(x)]
        return torch.stack([o for o, _ in outs]), torch.stack([a for _, a in outs])


__all__ = ["MoE", "MoEConfig", "MoEWeights", "StackedMoE", "capacity", "dispatch_groups",
           "local_dispatch_taken",
           "dispatch", "moe_forward", "moe_forward_reference", "route"]
