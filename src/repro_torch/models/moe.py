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
shard-local dispatch (``shard``/``shard_groups``, ``"moe_shard"``) is
multi-card and raises.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .blocks import SwiGLU, dense_init


class MoEConfig(NamedTuple):
    d_model: int
    d_expert: int            # per-expert FFN hidden size
    n_experts: int           # routed experts
    top_k: int
    n_shared: int = 0        # always-on shared experts (DeepSeek style)
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    shard: bool = False      # the reference's mesh constraints: multi-card
    shard_groups: int = 0


class MoEWeights(NamedTuple):
    """One layer's weights: router (D, E), gate and up (E, D, F), down (E,
    F, D), and the shared SwiGLU's (gate, up, down) kernels or None."""
    router: torch.Tensor
    gate: torch.Tensor
    up: torch.Tensor
    down: torch.Tensor
    shared: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None


def check_config(cfg: MoEConfig) -> None:
    if cfg.shard or cfg.shard_groups:
        from ..core.protocol import MULTI_CARD_SLICE
        raise NotImplementedError(
            f"the MoE's shard-local dispatch (optimizations 'moe_shard': experts over a "
            f"mesh axis) comes with {MULTI_CARD_SLICE}")


def capacity(n_tokens: int, cfg: MoEConfig) -> int:
    """Slots an expert: ``ceil(T k cf / E)`` rounded up to a multiple of 8,
    at least 8."""
    c = int(math.ceil(n_tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts))
    return max(8, -(-c // 8) * 8)


def route(router: torch.Tensor, cfg: MoEConfig, x_flat: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(weights (T, k) in x's dtype, ids (T, k) int64, aux f32 scalar):
    the top-k of the router's softmax (ties to the lower expert), the
    weights renormalised over the k, and the Switch-style load-balance
    loss."""
    logits = (x_flat @ router).to(torch.float32)                   # (T, E)
    probs = torch.softmax(logits, dim=-1)
    sorted_p, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, ids = sorted_p[:, :cfg.top_k], order[:, :cfg.top_k]
    weights = weights / torch.clamp_min(weights.sum(-1, keepdim=True), 1e-9)
    pe = probs.mean(dim=0)                                         # (E,)
    fe = F.one_hot(ids, cfg.n_experts).to(torch.float32).sum(dim=(0, 1)) / x_flat.shape[0]
    aux = cfg.n_experts * torch.sum(fe * pe) * cfg.router_aux_weight
    return weights.to(x_flat.dtype), ids, aux


def dispatch(ids: torch.Tensor, cfg: MoEConfig, cap: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(slot (T*k,), keep (T*k,) bool) of the (token, k) pairs, token-major:
    a pair's place in its expert's queue, and whether it is within
    ``cap``."""
    flat_ids = ids.reshape(-1)
    onehot = F.one_hot(flat_ids, cfg.n_experts)                    # (T*k, E)
    pos = torch.cumsum(onehot, dim=0) - 1
    slot = torch.gather(pos, 1, flat_ids[:, None])[:, 0]
    return slot, slot < cap


def _swiglu(gate: torch.Tensor, up: torch.Tensor, down: torch.Tensor,
            x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ gate) * (x @ up)) @ down


def moe_forward(w: MoEWeights, cfg: MoEConfig, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (out (B, S, D), aux f32 scalar), the reference's
    global dispatch."""
    check_config(cfg)
    b, s, d = x.shape
    t, k, e = b * s, cfg.top_k, cfg.n_experts
    x_flat = x.reshape(t, d)
    weights, ids, aux = route(w.router, cfg, x_flat)
    cap = capacity(t, cfg)
    slot, keep = dispatch(ids, cfg, cap)
    flat_ids = ids.reshape(-1)
    # each kept pair writes its (expert, slot) row of the (E * cap, D)
    # buffer, once; a dropped pair writes its zeroed source into one spare
    # row past the buffer (no accumulating add; no host sync)
    row = torch.where(keep, flat_ids * cap + slot, torch.full_like(slot, e * cap))
    src = x_flat[:, None, :].expand(t, k, d).reshape(t * k, d) * keep[:, None].to(x.dtype)
    buf = x.new_zeros((e * cap + 1, d)).index_put((row,), src)[:e * cap].view(e, cap, d)
    h = F.silu(torch.bmm(buf, w.gate)) * torch.bmm(buf, w.up)
    out_buf = torch.bmm(h, w.down).view(e * cap, d)
    # gather back (a dropped pair reads slot cap - 1 and is zeroed), combine
    slot_c = torch.where(keep, slot, torch.full_like(slot, cap - 1))
    gathered = out_buf[flat_ids * cap + slot_c] * keep[:, None].to(x.dtype)
    out = torch.einsum("tkd,tk->td", gathered.view(t, k, d), weights)
    if w.shared is not None:
        out = out + _swiglu(*w.shared, x_flat)
    return out.view(b, s, d), aux


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


class MoE(nn.Module):
    """The routed experts (router, gate, up, down) and the optional shared
    SwiGLU (``n_shared * d_expert`` wide).  ``forward(x)`` -> (out, aux)."""

    def __init__(self, cfg: MoEConfig, *, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        kw = dict(dtype=dtype, device=device)
        e, d, f = cfg.n_experts, cfg.d_model, cfg.d_expert
        self.router = nn.Parameter(torch.empty((d, e), **kw))
        self.gate = nn.Parameter(torch.empty((e, d, f), **kw))
        self.up = nn.Parameter(torch.empty((e, d, f), **kw))
        self.down = nn.Parameter(torch.empty((e, f, d), **kw))
        self.shared = SwiGLU(d, cfg.n_shared * f, **kw) if cfg.n_shared else None

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
        return moe_forward(self.weights(), self.cfg, x)


class StackedMoE(nn.Module):
    """n slots' :class:`MoE` (the same parameters, each with a leading slot
    axis): x (n, B, S, D) -> (out (n, B, S, D), aux (n,)), one
    :func:`moe_forward` a slot over views of the stacked weights."""

    def __init__(self, cfg: MoEConfig, n: int, *, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.cfg = cfg
        kw = dict(dtype=dtype, device=device)
        e, d, f = cfg.n_experts, cfg.d_model, cfg.d_expert
        self.router = nn.Parameter(torch.zeros((n, d, e), **kw))
        self.gate = nn.Parameter(torch.zeros((n, e, d, f), **kw))
        self.up = nn.Parameter(torch.zeros((n, e, d, f), **kw))
        self.down = nn.Parameter(torch.zeros((n, e, f, d), **kw))
        if cfg.n_shared:
            from .blocks import StackedSwiGLU
            self.shared = StackedSwiGLU(n, d, cfg.n_shared * f, **kw)
        else:
            self.shared = None

    def slot_weights(self, r: int) -> MoEWeights:
        shared = (None if self.shared is None else
                  (self.shared.gate.w[r], self.shared.up.w[r], self.shared.down.w[r]))
        return MoEWeights(self.router[r], self.gate[r], self.up[r], self.down[r], shared)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        outs = [moe_forward(self.slot_weights(r), self.cfg, xr) for r, xr in enumerate(x)]
        return torch.stack([o for o, _ in outs]), torch.stack([a for _, a in outs])


__all__ = ["MoE", "MoEConfig", "MoEWeights", "StackedMoE", "capacity", "check_config",
           "dispatch", "moe_forward", "moe_forward_reference", "route"]
