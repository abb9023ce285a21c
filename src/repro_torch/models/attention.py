"""Grouped-query attention (GQA) with RoPE, QK-norm, QKV bias and a sliding
window: the reference's ``repro/models/attention.py``, GQA part.

The forward over a sequence (prefill and training) runs
:func:`kernels.ops.flash_attention` (B5, with its backward when a gradient
is recorded) and each decode step :func:`kernels.ops.decode_attention` (B6)
over the KV cache; on a CPU tensor both take their plain versions, which
compute the reference's ``attend`` (scores materialised, GQA by repeating
the KV heads, masked with -1e30, softmax in f32).  The window is an argument of each call
(0 = full attention), so one module serves a local or a global layer.

:class:`StackedGQA` is the cluster-stacked form (n slots) the batched
round trains: its projections run a product a slot, and the slot axis is
folded into the batch axis for the norms' arithmetic, the rotary embedding
and B5, which then takes all n slots' attention in one launch a layer (and
its backward in one more).

The encoder-decoder's attention runs B5 non-causal (``causal=False``):
:meth:`GQA.encode` is the encoder's bidirectional self-attention (rope on
0..S-1, no qk-norm, as the reference's ``_encdec_enc_layer``) and
:func:`gqa_cross_forward` the decoder's cross-attention over the encoder's
memory (no rope, no qk-norm, any Sq and Sk; in decode too, Sq = 1), each
differentiable through B5's non-causal backward on the card.

The decode cache of a layer is a pair of (B, max_seq, Hkv, D) tensors; a
step writes the new token's key and value in place at ``index`` (the
reference's ``dynamic_update_slice``, without copying the cache).  Under a
sequence-sharded cache (``parallel.Panels``: the ranks that hold the same
KV heads split their positions) a rank holds (B, S / G, Hkv_local, D): the
rank whose panel holds ``index`` writes the token, every rank runs B6's
partial mode over its panel (for all the query heads of its KV heads, the
ranks that split them all-gathering their ``q`` first) and the panels'
partials combine over the panel group (``parallel.combine_panels``).

Where the model axis does not divide the query heads (Qwen2.5-14B's 40 at
16), or it and the KV heads divide neither way, the block runs whole on
each model rank (``parallel.heads_layout`` gives None): every weight
replicated, no ``enter``/``leave``, no ``shared_grad``, its gradient the
rank's own; its decode cache holds every KV head, split over the whole
model axis.

MLA (DeepSeek-V2's multi-head latent attention; the reference's
``mla_init``, ``mla_forward``, ``init_mla_cache``, ``mla_decode``) stays
plain PyTorch (B5's plain version, ``attend_plain``), as the reference's
``attend`` is: its q/k head is
``head_dim + rope_dim`` wide (192) and its v ``head_dim`` (128), which B5
takes neither of.  The content path is rope-free, so a decode step caches
the normalised latent (``kv_lora_rank``) and the shared rope key
(``rope_dim``) and scores in the absorbed form ``q_c W_uk latent + q_r
k_rope``.  :func:`mla_forward` and :func:`mla_decode` are functions of the
weights, which :class:`MLA` and the cluster-stacked :class:`StackedMLA` (a
call a slot, on views of its stacked weights) both call.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

from ..kernels import ops
from ..kernels.flash_attention import NEG_INF, attend_plain, causal_mask
from .blocks import Linear, RMSNorm, StackedLinear, StackedRMSNorm, apply_rope, rms_norm
from .parallel import (Layout, Panels, combine_panels, enter, gather_from, heads_layout, leave,
                       mark_by_rule, optional, shared_grad)


class AttnConfig(NamedTuple):
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope_theta: float = 10000.0
    qkv_bias: bool = False
    qk_norm: bool = False


class HeadLayout(NamedTuple):
    """A rank's part of a GQA block: ``cfg`` its heads, ``par`` the view its
    products run under (model axis 1 where the block is whole), ``kv_group``
    the ranks whose shared KV weights' gradients sum (None), ``kv_layout``
    (KV pieces, this rank's piece), ``share`` the model ranks that hold this
    rank's KV heads (they split the heads' decode cache on its sequence),
    ``split_q`` whether those ranks split the KV heads' query heads among
    them, and ``q_slot`` this rank's place among them."""
    cfg: AttnConfig
    par: Any
    kv_group: Any = None
    kv_layout: Tuple[int, int] = (1, 0)
    share: int = 1
    split_q: bool = False
    q_slot: int = 0


def _local_heads(cfg: AttnConfig, par) -> HeadLayout:
    """This rank's :class:`HeadLayout`: with ``par`` of model axis m > 1 the
    rank holds H/m query heads and Hkv/m KV heads, or, where m exceeds the
    KV heads, one KV head whole, shared by the m/Hkv ranks whose query heads
    read it (Megatron's layout; the reference's rule splits inside a head
    there, which B5 cannot run); where the axis does not divide the query
    heads the block whole (``parallel.heads_layout`` None), its cache split
    over all m model ranks."""
    par = optional(par)
    if par.model_size == 1:
        return HeadLayout(cfg, par)
    lay = heads_layout(par, cfg.n_heads, cfg.n_kv_heads)
    if lay is None:
        return HeadLayout(cfg, par.whole(), share=par.model_size)
    h, kv, parts, index, share = lay
    return HeadLayout(cfg._replace(n_heads=h, n_kv_heads=kv), par, par.kv_group(share),
                      (parts, index), share, share > 1, par.model_rank % share)


def _mark_heads(attn: nn.Module, par, kv_layout) -> None:
    """The spec's layout (``wq`` and its bias heads-out, ``wo`` heads-in),
    but ``wk``/``wv`` by KV head where the model ranks share one (the spec
    splits inside a head there)."""
    parts, index = kv_layout
    shared = parts != par.model_size
    departures = {f"{lin}.{leaf}": Layout(-1, parts, index)
                  for lin in ("wk", "wv") for leaf in ("w", "b") if shared}
    mark_by_rule(attn, par, departures=departures)


def _kv_proj(lin: nn.Module, x: torch.Tensor, group) -> torch.Tensor:
    """``lin(x)`` with a KV weight shared by several ranks: its gradient
    summed over their ``group`` (``parallel.shared_grad``)."""
    if group is None:
        return lin(x)
    return lin(x, shared_grad(lin.w, group), None if lin.b is None else shared_grad(lin.b, group))


def _heads(y: torch.Tensor, h: int, cfg: AttnConfig) -> torch.Tensor:
    """A projection (..., S, h D) as (folded batch, S, h, D)."""
    return y.reshape(-1, y.shape[-2], h, cfg.head_dim)


def _head_norm(norm: nn.Module, x: torch.Tensor, par) -> torch.Tensor:
    """The q/k norm over head_dim; under a model axis its scale (whole on
    every rank, each applying it to its own heads) takes the gradient
    summed over ``model``."""
    if par.model_size == 1:
        return norm(x)
    scale = shared_grad(norm.scale, par.model_group)
    if isinstance(norm, StackedRMSNorm):
        xf = x.to(torch.float32)
        y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + norm.eps)
        view = scale.view((scale.shape[0],) + (1,) * (x.dim() - 2) + (scale.shape[-1],))
        return (y * view.to(torch.float32)).to(x.dtype)
    return rms_norm(x, scale, norm.eps)


class GQA(nn.Module):
    """Causal GQA self-attention: projections ``wq, wk, wv, wo`` (+ q/k
    RMSNorm over head_dim when ``qk_norm``).  With ``par`` (``models.
    parallel``) of model axis m > 1 the module holds this rank's heads
    (``cfg`` is then the rank's, see :func:`_local_heads`): ``wq``,
    ``wk``, ``wv`` column-parallel, ``wo`` row-parallel with one all-reduce
    over ``model``; B5 and B6 run on the local heads and a cache of the
    local KV heads."""

    def __init__(self, cfg: AttnConfig, *, dtype: torch.dtype = torch.float32, device=None,
                 par=None):
        super().__init__()
        self.heads = _local_heads(cfg, par)
        self.cfg, self.par, self.kv_group, kv_layout = self.heads[:4]
        cfg = self.cfg
        kw = dict(dtype=dtype, device=device)
        hd = cfg.head_dim
        self.wq = Linear(cfg.d_model, cfg.n_heads * hd, bias=cfg.qkv_bias, **kw)
        self.wk = Linear(cfg.d_model, cfg.n_kv_heads * hd, bias=cfg.qkv_bias, **kw)
        self.wv = Linear(cfg.d_model, cfg.n_kv_heads * hd, bias=cfg.qkv_bias, **kw)
        self.wo = Linear(cfg.n_heads * hd, cfg.d_model, **kw)
        if cfg.qk_norm:
            self.q_norm = RMSNorm(hd, **kw)
            self.k_norm = RMSNorm(hd, **kw)
        _mark_heads(self, self.par, kv_layout)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for mod in self.children():
            mod.reset_parameters(generator)

    def _project(self, x: torch.Tensor, positions: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """x (B, S, d_model) -> q (B, S, H, D), k and v (B, S, Hkv, D), with
        the norms and the rotary embedding applied."""
        cfg = self.cfg
        b, s, _ = x.shape
        q = self.wq(x).view(b, s, cfg.n_heads, cfg.head_dim)
        k = _kv_proj(self.wk, x, self.kv_group).view(b, s, cfg.n_kv_heads, cfg.head_dim)
        v = _kv_proj(self.wv, x, self.kv_group).view(b, s, cfg.n_kv_heads, cfg.head_dim)
        if cfg.qk_norm:
            q = _head_norm(self.q_norm, q, self.par)
            k = _head_norm(self.k_norm, k, self.par)
        return (apply_rope(q, positions, cfg.rope_theta),
                apply_rope(k, positions, cfg.rope_theta), v)

    def forward(self, x: torch.Tensor, positions: torch.Tensor, window: int) -> torch.Tensor:
        """Prefill: causal attention over the whole sequence (``window`` 0
        for full attention)."""
        cfg = self.cfg
        b, s, _ = x.shape
        q, k, v = self._project(enter(x, self.par), positions)
        out = ops.flash_attention(q, k, v, window=window)
        return leave(self.wo(out.reshape(b, s, cfg.n_heads * cfg.head_dim)), self.par)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """The encoder's bidirectional self-attention over x (..., S,
        d_model) (a stacked form's slot axis folded into the batch): rope
        on positions 0..S-1, no qk-norm even where the config sets it,
        every key live (B5 non-causal)."""
        cfg = self.cfg
        s = x.shape[-2]
        x = enter(x, self.par)
        pos = torch.arange(s, device=x.device)
        q = _heads(self.wq(x), cfg.n_heads, cfg)
        k = _heads(_kv_proj(self.wk, x, self.kv_group), cfg.n_kv_heads, cfg)
        v = _heads(_kv_proj(self.wv, x, self.kv_group), cfg.n_kv_heads, cfg)
        out = ops.flash_attention(apply_rope(q, pos, cfg.rope_theta),
                                  apply_rope(k, pos, cfg.rope_theta), v, causal=False)
        return leave(self.wo(out.reshape(x.shape[:-1] + (cfg.n_heads * cfg.head_dim,))),
                     self.par)

    def decode(self, x: torch.Tensor, cache: Dict[str, torch.Tensor], index: int,
               window: int, panels: Optional[Panels] = None) -> torch.Tensor:
        """One decode step: x (B, 1, d_model) is the token at position
        ``index`` (host int).  Writes its key and value into ``cache`` ((B,
        max_seq, Hkv, D) tensors) in place and attends over positions <=
        ``index``; under ``panels`` (a sequence-sharded cache, this rank's
        panel (B, S / G, Hkv, D)) the rank whose panel holds ``index``
        writes, and the panels' partials combine."""
        cfg = self.cfg
        b = x.shape[0]
        pos = torch.full((1,), index, dtype=torch.int64, device=x.device)
        q, k_new, v_new = self._project(enter(x, self.par), pos)
        if panels is None or panels.count == 1:
            cache["k"][:, index] = k_new[:, 0].to(cache["k"].dtype)
            cache["v"][:, index] = v_new[:, 0].to(cache["v"].dtype)
            out = ops.decode_attention(q, cache["k"], cache["v"], index, window=window)
        else:
            if panels.holds(index):
                cache["k"][:, index - panels.base] = k_new[:, 0].to(cache["k"].dtype)
                cache["v"][:, index - panels.base] = v_new[:, 0].to(cache["v"].dtype)
            out = self._panel_attention(q, cache, index, window, panels)
        return leave(self.wo(out.reshape(b, 1, cfg.n_heads * cfg.head_dim)), self.par)

    def _panel_attention(self, q: torch.Tensor, cache: Dict[str, torch.Tensor], index: int,
                         window: int, panels: Panels) -> torch.Tensor:
        """B6's partial mode over this rank's panel for every query head of
        its KV heads (the ranks that split them all-gather ``q``), the
        panels combined; returns this rank's heads (B, 1, H_local, D)."""
        lay = self.heads
        h = q.shape[2]
        if lay.split_q:
            q = gather_from(q, lay.kv_group, lay.share, dim=2)
        out, lse = ops.decode_attention_partial(q, cache["k"], cache["v"], index,
                                                base=panels.base, window=window)
        out = combine_panels(out, lse, panels, q.dtype)
        return out[:, :, lay.q_slot * h:(lay.q_slot + 1) * h] if lay.split_q else out


def gqa_cross_forward(attn: nn.Module, x: torch.Tensor, memory: torch.Tensor) -> torch.Tensor:
    """The reference's ``gqa_cross_forward``: x (..., Sq, d_model) attends
    to every position of ``memory`` (..., Sk, d_model), which gives K and V,
    with ``attn``'s projections (a :class:`GQA`, or a :class:`StackedGQA`
    over n slots' x and memory); no rope, no qk-norm; B5 non-causal, any Sq
    and Sk.  Under a model axis ``attn`` holds this rank's heads: x and the
    memory (whole on every rank) enter, K and V are the rank's heads of
    the memory, ``wo``'s partial sums leave."""
    cfg, par = attn.cfg, attn.par
    x, memory = enter(x, par), enter(memory, par)
    q = _heads(attn.wq(x), cfg.n_heads, cfg)
    k = _heads(_kv_proj(attn.wk, memory, attn.kv_group), cfg.n_kv_heads, cfg)
    v = _heads(_kv_proj(attn.wv, memory, attn.kv_group), cfg.n_kv_heads, cfg)
    out = ops.flash_attention(q, k, v, causal=False)
    return leave(attn.wo(out.reshape(x.shape[:-1] + (cfg.n_heads * cfg.head_dim,))), par)


class StackedGQA(nn.Module):
    """n slots' :class:`GQA` (the same parameters, each with a leading slot
    axis): x (n, B, S, d_model) -> (n, B, S, d_model), causal over S, or
    (``encode``, :func:`gqa_cross_forward`) the encoder-decoder's
    non-causal forms."""

    def __init__(self, cfg: AttnConfig, n: int, *, dtype: torch.dtype = torch.float32,
                 device=None, par=None):
        super().__init__()
        self.heads = _local_heads(cfg, par)
        self.cfg, self.par, self.kv_group, kv_layout = self.heads[:4]
        cfg = self.cfg
        kw = dict(dtype=dtype, device=device)
        hd = cfg.head_dim
        self.wq = StackedLinear(n, cfg.d_model, cfg.n_heads * hd, bias=cfg.qkv_bias, **kw)
        self.wk = StackedLinear(n, cfg.d_model, cfg.n_kv_heads * hd, bias=cfg.qkv_bias, **kw)
        self.wv = StackedLinear(n, cfg.d_model, cfg.n_kv_heads * hd, bias=cfg.qkv_bias, **kw)
        self.wo = StackedLinear(n, cfg.n_heads * hd, cfg.d_model, **kw)
        if cfg.qk_norm:
            self.q_norm = StackedRMSNorm(n, hd, **kw)
            self.k_norm = StackedRMSNorm(n, hd, **kw)
        _mark_heads(self, self.par, kv_layout)

    def forward(self, x: torch.Tensor, positions: torch.Tensor, window: int) -> torch.Tensor:
        cfg = self.cfg
        n, b, s, _ = x.shape
        hd = cfg.head_dim
        x = enter(x, self.par)
        q = self.wq(x).view(n, b, s, cfg.n_heads, hd)
        k = _kv_proj(self.wk, x, self.kv_group).view(n, b, s, cfg.n_kv_heads, hd)
        v = _kv_proj(self.wv, x, self.kv_group).view(n * b, s, cfg.n_kv_heads, hd)
        if cfg.qk_norm:
            q = _head_norm(self.q_norm, q, self.par)
            k = _head_norm(self.k_norm, k, self.par)
        q = apply_rope(q.view(n * b, s, cfg.n_heads, hd), positions, cfg.rope_theta)
        k = apply_rope(k.view(n * b, s, cfg.n_kv_heads, hd), positions, cfg.rope_theta)
        out = ops.flash_attention(q, k, v, window=window)
        return leave(self.wo(out.reshape(n, b, s, cfg.n_heads * hd)), self.par)

    encode = GQA.encode


def init_kv_cache(layers: int, batch: int, max_seq: int, cfg: AttnConfig,
                  dtype: torch.dtype, device=None) -> Dict[str, torch.Tensor]:
    """Zeroed decode cache {"k", "v"} of ``layers`` layers, each (B,
    max_seq, Hkv, D), on a leading layer axis (the reference's stacked
    layout)."""
    shape = (layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    return {name: torch.zeros(shape, dtype=dtype, device=device) for name in ("k", "v")}


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------

class MLAConfig(NamedTuple):
    d_model: int
    n_heads: int
    head_dim: int
    kv_lora_rank: int
    rope_dim: int = 64            # the decoupled rope sub-dimension
    rope_theta: float = 10000.0
    q_chunk: int = 0


class MLAWeights(NamedTuple):
    """One layer's MLA kernels (and the latent's norm scale)."""
    wq: torch.Tensor              # (D, H (hd + rd))
    w_dkv: torch.Tensor           # (D, rank + rd)
    kv_norm: torch.Tensor         # (rank,)
    w_uk: torch.Tensor            # (rank, H hd)
    w_uv: torch.Tensor            # (rank, H hd)
    wo: torch.Tensor              # (H hd, D)


def mla_forward(w: MLAWeights, cfg: MLAConfig, x: torch.Tensor, positions: torch.Tensor
                ) -> torch.Tensor:
    """Causal MLA over a sequence, x (B, S, d_model); query chunks of
    ``cfg.q_chunk`` (the reference's ``attend_chunked``) when S exceeds
    it."""
    b, s, _ = x.shape
    h, hd, rd, rank = cfg.n_heads, cfg.head_dim, cfg.rope_dim, cfg.kv_lora_rank
    q_full = (x @ w.wq).view(b, s, h, hd + rd)
    q_c, q_r = q_full[..., :hd], q_full[..., hd:]
    dkv = x @ w.w_dkv
    latent = rms_norm(dkv[..., :rank], w.kv_norm)
    k_rope = dkv[..., rank:].reshape(b, s, 1, rd)
    k_c = (latent @ w.w_uk).view(b, s, h, hd)
    v = (latent @ w.w_uv).view(b, s, h, hd)
    q_r = apply_rope(q_r, positions, cfg.rope_theta)
    k_r = apply_rope(k_rope, positions, cfg.rope_theta).expand(b, s, h, rd)
    q = torch.cat([q_c, q_r], dim=-1)
    k = torch.cat([k_c, k_r], dim=-1)
    # scores scaled by 1/sqrt(hd + rd), q's width
    chunk = ops.largest_divisor(s, cfg.q_chunk) if cfg.q_chunk and s > cfg.q_chunk else s
    outs = [attend_plain(q[:, i:i + chunk], k, v, causal_mask(positions[i:i + chunk], positions))
            for i in range(0, s, chunk)]
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
    return out.reshape(b, s, h * hd) @ w.wo


def _mla_query(w: MLAWeights, cfg: MLAConfig, x: torch.Tensor, index: int):
    """A decode step's absorbed query and the token's cache entries: x (B,
    1, d_model) at ``index`` -> (q_lat (B, 1, H, rank), q_r (B, 1, H, rd)
    roped, the normalised latent (B, 1, rank), the roped k_rope (B, rd))."""
    b = x.shape[0]
    h, hd, rd, rank = cfg.n_heads, cfg.head_dim, cfg.rope_dim, cfg.kv_lora_rank
    pos = torch.full((1,), index, dtype=torch.int64, device=x.device)
    q_full = (x @ w.wq).view(b, 1, h, hd + rd)
    q_c, q_r = q_full[..., :hd], apply_rope(q_full[..., hd:], pos, cfg.rope_theta)
    dkv = x @ w.w_dkv
    latent_new = rms_norm(dkv[..., :rank], w.kv_norm)
    k_rope_new = apply_rope(dkv[..., rank:].reshape(b, 1, 1, rd), pos, cfg.rope_theta)
    q_lat = torch.einsum("bqhd,rhd->bqhr", q_c, w.w_uk.view(rank, h, hd))
    return q_lat, q_r, latent_new, k_rope_new.reshape(b, rd)


def _mla_out(w: MLAWeights, cfg: MLAConfig, ctx: torch.Tensor) -> torch.Tensor:
    """The latent context (B, 1, H, rank) through ``w_uv`` and ``wo``."""
    b, h, hd, rank = ctx.shape[0], cfg.n_heads, cfg.head_dim, cfg.kv_lora_rank
    out = torch.einsum("bqhr,rhd->bqhd", ctx, w.w_uv.view(rank, h, hd))
    return out.reshape(b, 1, h * hd) @ w.wo


def _mla_scores(q_lat, q_r, latent, k_rope, cfg: MLAConfig) -> torch.Tensor:
    """The absorbed scores (B, H, 1, S) in f32, scaled by 1/sqrt(hd + rd)."""
    scores = (torch.einsum("bqhr,bkr->bhqk", q_lat, latent)
              + torch.einsum("bqhd,bkd->bhqk", q_r, k_rope))
    return scores.to(torch.float32) * (1.0 / math.sqrt(cfg.head_dim + cfg.rope_dim))


def mla_decode(w: MLAWeights, cfg: MLAConfig, x: torch.Tensor,
               cache: Dict[str, torch.Tensor], index: int) -> torch.Tensor:
    """One decode step: x (B, 1, d_model) at position ``index`` (host int).
    Writes the token's latent and rope key into ``cache`` ({"latent" (B,
    max_seq, rank), "k_rope" (B, max_seq, rd)}) in place, and scores the
    absorbed form over positions <= ``index``."""
    q_lat, q_r, latent_new, k_rope_new = _mla_query(w, cfg, x, index)
    latent, k_rope = cache["latent"], cache["k_rope"]
    latent[:, index] = latent_new[:, 0].to(latent.dtype)
    k_rope[:, index] = k_rope_new.to(k_rope.dtype)
    scores = _mla_scores(q_lat, q_r, latent, k_rope, cfg)
    valid = torch.arange(latent.shape[1], device=x.device) <= index
    scores = torch.where(valid[None, None, None], scores,
                         torch.full((), NEG_INF, device=x.device))
    probs = torch.softmax(scores, dim=-1).to(latent.dtype)
    return _mla_out(w, cfg, torch.einsum("bhqk,bkr->bqhr", probs, latent))


def mla_decode_partial(q_lat: torch.Tensor, q_r: torch.Tensor, latent: torch.Tensor,
                       k_rope: torch.Tensor, index: int, base: int, cfg: MLAConfig
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The absorbed attention over one panel of a sequence-sharded latent
    cache: latent (B, S_local, rank) and k_rope (B, S_local, rd) hold the
    absolute positions [base, base + S_local), ``index`` is absolute.
    Returns (the latent context f32 (B, 1, H, rank) normalised by the
    panel's own softmax sum, lse f32 (B, 1, H)); a panel with no live key
    gives 0 and -inf (``decode_attention.combine_partials`` merges G
    panels', as it does B6's)."""
    scores = _mla_scores(q_lat, q_r, latent, k_rope, cfg)           # (B, H, 1, S)
    live = base + torch.arange(latent.shape[1], device=latent.device) <= index
    scores = scores.masked_fill(~live[None, None, None], float("-inf"))
    lse = torch.logsumexp(scores, dim=-1)                              # (B, H, 1)
    safe = torch.where(torch.isfinite(lse), lse, torch.zeros((), device=lse.device))
    probs = torch.exp(scores - safe[..., None])
    ctx = torch.einsum("bhqk,bkr->bqhr", probs, latent.to(torch.float32))
    return ctx, lse.transpose(1, 2)


def _no_window(window: int) -> None:
    """MLA attends over every earlier position, as the reference's does."""
    if window:
        raise ValueError(f"MLA takes no sliding window (got {window})")


def _mla_layout(cfg: MLAConfig, par):
    """(this rank's config, the view its products run under): H/m heads
    where the model axis divides the heads, else the block whole."""
    par = optional(par).over(cfg.n_heads)
    return cfg._replace(n_heads=cfg.n_heads // par.model_size), par


def _mark_mla(attn: nn.Module, par) -> None:
    """The spec's layout (``wq``, ``w_uk``, ``w_uv`` heads-out, ``wo``
    heads-in, ``kv_norm`` replicated), but ``w_dkv`` whole on every rank:
    the spec cuts its rank + rope columns across the latent and the rope
    key, and ``kv_norm`` reads the latent whole."""
    mark_by_rule(attn, par, departures={"w_dkv.w": None})


def _mla_weights(attn: nn.Module) -> MLAWeights:
    """The layer's weights, the shared ``w_dkv`` and ``kv_norm`` taking
    their gradient summed over ``model`` (each rank's heads read the whole
    latent)."""
    group = attn.par.model_group
    return MLAWeights(attn.wq.w, shared_grad(attn.w_dkv.w, group),
                      shared_grad(attn.kv_norm.scale, group), attn.w_uk.w, attn.w_uv.w,
                      attn.wo.w)


class MLA(nn.Module):
    """Multi-head latent attention: ``wq``, the joint KV compression
    ``w_dkv`` (latent and the shared rope key), ``kv_norm`` on the latent,
    the up-projections ``w_uk``, ``w_uv`` and ``wo``.  With ``par`` of
    model axis m > 1 the module holds H/m heads (``cfg`` is then the
    rank's): ``wq``, ``w_uk``, ``w_uv`` column-parallel, ``wo``
    row-parallel, ``w_dkv`` and ``kv_norm`` whole; where m does not divide
    the heads, the block whole.  Its decode cache, which has no head axis,
    is split on its sequence over the model ranks (``parallel.Panels``)."""

    def __init__(self, cfg: MLAConfig, *, dtype: torch.dtype = torch.float32, device=None,
                 par=None):
        super().__init__()
        self.cfg, self.par = cfg, par = _mla_layout(cfg, par)
        kw = dict(dtype=dtype, device=device)
        h, hd, rd, rank = cfg.n_heads, cfg.head_dim, cfg.rope_dim, cfg.kv_lora_rank
        self.wq = Linear(cfg.d_model, h * (hd + rd), **kw)
        self.w_dkv = Linear(cfg.d_model, rank + rd, **kw)
        self.kv_norm = RMSNorm(rank, **kw)
        self.w_uk = Linear(rank, h * hd, **kw)
        self.w_uv = Linear(rank, h * hd, **kw)
        self.wo = Linear(h * hd, cfg.d_model, **kw)
        _mark_mla(self, par)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for mod in self.children():
            mod.reset_parameters(generator)

    def weights(self) -> MLAWeights:
        return _mla_weights(self)

    def forward(self, x: torch.Tensor, positions: torch.Tensor, window: int = 0
                ) -> torch.Tensor:
        _no_window(window)
        return leave(mla_forward(self.weights(), self.cfg, enter(x, self.par), positions),
                     self.par)

    def decode(self, x: torch.Tensor, cache: Dict[str, torch.Tensor], index: int,
               window: int = 0, panels: Optional[Panels] = None) -> torch.Tensor:
        """One decode step (:func:`mla_decode`); under ``panels`` (the latent
        cache split on its sequence: this rank's panel) the rank whose panel
        holds ``index`` writes the token, the model ranks all-gather their
        heads' ``q_lat`` and ``q_r``, each scores every head over its panel
        (:func:`mla_decode_partial`), the panels' partials combine
        (``parallel.combine_panels``) and each rank keeps its heads for
        ``w_uv``, ``wo`` and the reduce over ``model``."""
        _no_window(window)
        w = self.weights()
        if panels is None or panels.count == 1:
            return leave(mla_decode(w, self.cfg, x, cache, index), self.par)
        q_lat, q_r, latent_new, k_rope_new = _mla_query(w, self.cfg, x, index)
        latent, k_rope = cache["latent"], cache["k_rope"]
        if panels.holds(index):
            latent[:, index - panels.base] = latent_new[:, 0].to(latent.dtype)
            k_rope[:, index - panels.base] = k_rope_new.to(k_rope.dtype)
        par, h, rank = self.par, self.cfg.n_heads, self.cfg.kv_lora_rank
        q = gather_from(torch.cat([q_lat, q_r.to(q_lat.dtype)], dim=-1), par.model_group,
                        par.model_size, dim=2)
        ctx, lse = mla_decode_partial(q[..., :rank], q[..., rank:], latent, k_rope, index,
                                      panels.base, self.cfg)
        ctx = combine_panels(ctx, lse, panels, latent.dtype)
        ctx = ctx[:, :, par.model_rank * h:(par.model_rank + 1) * h]
        return leave(_mla_out(w, self.cfg, ctx), par)


class StackedMLA(nn.Module):
    """n slots' :class:`MLA` (the same parameters, each with a leading slot
    axis): x (n, B, S, d_model), one :func:`mla_forward` a slot over views
    of the stacked weights; ``par`` as :class:`MLA`'s."""

    def __init__(self, cfg: MLAConfig, n: int, *, dtype: torch.dtype = torch.float32,
                 device=None, par=None):
        super().__init__()
        self.cfg, self.par = cfg, par = _mla_layout(cfg, par)
        kw = dict(dtype=dtype, device=device)
        h, hd, rd, rank = cfg.n_heads, cfg.head_dim, cfg.rope_dim, cfg.kv_lora_rank
        self.wq = StackedLinear(n, cfg.d_model, h * (hd + rd), **kw)
        self.w_dkv = StackedLinear(n, cfg.d_model, rank + rd, **kw)
        self.kv_norm = StackedRMSNorm(n, rank, **kw)
        self.w_uk = StackedLinear(n, rank, h * hd, **kw)
        self.w_uv = StackedLinear(n, rank, h * hd, **kw)
        self.wo = StackedLinear(n, h * hd, cfg.d_model, **kw)
        _mark_mla(self, par)

    def forward(self, x: torch.Tensor, positions: torch.Tensor, window: int = 0
                ) -> torch.Tensor:
        _no_window(window)
        w = _mla_weights(self)
        x = enter(x, self.par)
        return leave(torch.stack([mla_forward(MLAWeights(*(t[r] for t in w)), self.cfg, xr,
                                              positions) for r, xr in enumerate(x)]), self.par)


def init_mla_cache(layers: int, batch: int, max_seq: int, cfg: MLAConfig,
                   dtype: torch.dtype, device=None) -> Dict[str, torch.Tensor]:
    """Zeroed MLA decode cache of ``layers`` layers: {"latent" (layers, B,
    max_seq, rank), "k_rope" (layers, B, max_seq, rope_dim)}, rank + rope
    wide instead of 2 H D."""
    return {"latent": torch.zeros((layers, batch, max_seq, cfg.kv_lora_rank), dtype=dtype,
                                  device=device),
            "k_rope": torch.zeros((layers, batch, max_seq, cfg.rope_dim), dtype=dtype,
                                  device=device)}


__all__ = ["AttnConfig", "GQA", "HeadLayout", "MLA", "MLAConfig", "MLAWeights", "StackedGQA",
           "StackedMLA", "gqa_cross_forward", "init_kv_cache", "init_mla_cache", "mla_decode",
           "mla_forward"]
