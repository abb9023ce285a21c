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
from .parallel import (Panels, combine_panels, enter, gather_from, heads_layout, leave, mark,
                       optional, shared_grad)


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
    """wq (and its bias) heads-out over ``model``, wk/wv by KV head, wo
    heads-in."""
    if par.model_size == 1:
        return
    m, r = par.model_size, par.model_rank
    for lin, (parts, index) in ((attn.wq, (m, r)), (attn.wk, kv_layout),
                                (attn.wv, kv_layout)):
        mark(lin.w, -1, parts, index)
        if lin.b is not None:
            mark(lin.b, -1, parts, index)
    mark(attn.wo.w, -2, m, r)


def _kv_proj(lin: nn.Module, x: torch.Tensor, group) -> torch.Tensor:
    """``lin(x)`` with a KV weight shared by several ranks: its gradient
    summed over their ``group`` (``parallel.shared_grad``)."""
    if group is None:
        return lin(x)
    if isinstance(lin, StackedLinear):
        w = shared_grad(lin.w, group)
        y = torch.stack([xi @ wi for xi, wi in zip(x, w)])
        return y if lin.b is None else y + shared_grad(lin.b, group)[:, None, None, :]
    y = x @ shared_grad(lin.w, group)
    return y if lin.b is None else y + shared_grad(lin.b, group)


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
        """The encoder's bidirectional self-attention over x (B, S, d_model):
        rope on positions 0..S-1, no qk-norm even where the config sets it,
        every key live (B5 non-causal)."""
        cfg = self.cfg
        b, s, _ = x.shape
        pos = torch.arange(s, device=x.device)
        q = apply_rope(self.wq(x).view(b, s, cfg.n_heads, cfg.head_dim), pos, cfg.rope_theta)
        k = apply_rope(self.wk(x).view(b, s, cfg.n_kv_heads, cfg.head_dim), pos, cfg.rope_theta)
        v = self.wv(x).view(b, s, cfg.n_kv_heads, cfg.head_dim)
        out = ops.flash_attention(q, k, v, causal=False)
        return self.wo(out.reshape(b, s, cfg.n_heads * cfg.head_dim))

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


def gqa_cross_forward(attn: GQA, x: torch.Tensor, memory: torch.Tensor) -> torch.Tensor:
    """The reference's ``gqa_cross_forward``: x (B, Sq, d_model) attends to
    every position of ``memory`` (B, Sk, d_model), which gives K and V, with
    ``attn``'s projections; no rope, no qk-norm; B5 non-causal, any Sq and
    Sk."""
    cfg = attn.cfg
    b, sq, _ = x.shape
    sk = memory.shape[1]
    q = attn.wq(x).view(b, sq, cfg.n_heads, cfg.head_dim)
    k = attn.wk(memory).view(b, sk, cfg.n_kv_heads, cfg.head_dim)
    v = attn.wv(memory).view(b, sk, cfg.n_kv_heads, cfg.head_dim)
    out = ops.flash_attention(q, k, v, causal=False)
    return attn.wo(out.reshape(b, sq, cfg.n_heads * cfg.head_dim))


class StackedGQA(nn.Module):
    """n slots' :class:`GQA` (the same parameters, each with a leading slot
    axis): x (n, B, S, d_model) -> (n, B, S, d_model), causal over S."""

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


def mla_decode(w: MLAWeights, cfg: MLAConfig, x: torch.Tensor,
               cache: Dict[str, torch.Tensor], index: int) -> torch.Tensor:
    """One decode step: x (B, 1, d_model) at position ``index`` (host int).
    Writes the token's latent and rope key into ``cache`` ({"latent" (B,
    max_seq, rank), "k_rope" (B, max_seq, rd)}) in place, and scores the
    absorbed form over positions <= ``index``."""
    b = x.shape[0]
    h, hd, rd, rank = cfg.n_heads, cfg.head_dim, cfg.rope_dim, cfg.kv_lora_rank
    pos = torch.full((1,), index, dtype=torch.int64, device=x.device)
    q_full = (x @ w.wq).view(b, 1, h, hd + rd)
    q_c, q_r = q_full[..., :hd], apply_rope(q_full[..., hd:], pos, cfg.rope_theta)
    dkv = x @ w.w_dkv
    latent_new = rms_norm(dkv[..., :rank], w.kv_norm)
    k_rope_new = apply_rope(dkv[..., rank:].reshape(b, 1, 1, rd), pos, cfg.rope_theta)
    latent, k_rope = cache["latent"], cache["k_rope"]
    latent[:, index] = latent_new[:, 0].to(latent.dtype)
    k_rope[:, index] = k_rope_new.reshape(b, rd).to(k_rope.dtype)
    q_lat = torch.einsum("bqhd,rhd->bqhr", q_c, w.w_uk.view(rank, h, hd))
    scores = (torch.einsum("bqhr,bkr->bhqk", q_lat, latent)
              + torch.einsum("bqhd,bkd->bhqk", q_r, k_rope))
    scores = scores.to(torch.float32) * (1.0 / math.sqrt(hd + rd))
    valid = torch.arange(latent.shape[1], device=x.device) <= index
    scores = torch.where(valid[None, None, None], scores,
                         torch.full((), NEG_INF, device=x.device))
    probs = torch.softmax(scores, dim=-1).to(latent.dtype)
    ctx = torch.einsum("bhqk,bkr->bqhr", probs, latent)
    out = torch.einsum("bqhr,rhd->bqhd", ctx, w.w_uv.view(rank, h, hd))
    return out.reshape(b, 1, h * hd) @ w.wo


def _no_window(window: int) -> None:
    """MLA attends over every earlier position, as the reference's does."""
    if window:
        raise ValueError(f"MLA takes no sliding window (got {window})")


class MLA(nn.Module):
    """Multi-head latent attention: ``wq``, the joint KV compression
    ``w_dkv`` (latent and the shared rope key), ``kv_norm`` on the latent,
    the up-projections ``w_uk``, ``w_uv`` and ``wo``."""

    def __init__(self, cfg: MLAConfig, *, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        kw = dict(dtype=dtype, device=device)
        h, hd, rd, rank = cfg.n_heads, cfg.head_dim, cfg.rope_dim, cfg.kv_lora_rank
        self.wq = Linear(cfg.d_model, h * (hd + rd), **kw)
        self.w_dkv = Linear(cfg.d_model, rank + rd, **kw)
        self.kv_norm = RMSNorm(rank, **kw)
        self.w_uk = Linear(rank, h * hd, **kw)
        self.w_uv = Linear(rank, h * hd, **kw)
        self.wo = Linear(h * hd, cfg.d_model, **kw)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for mod in self.children():
            mod.reset_parameters(generator)

    def weights(self) -> MLAWeights:
        return MLAWeights(self.wq.w, self.w_dkv.w, self.kv_norm.scale, self.w_uk.w,
                          self.w_uv.w, self.wo.w)

    def forward(self, x: torch.Tensor, positions: torch.Tensor, window: int = 0
                ) -> torch.Tensor:
        _no_window(window)
        return mla_forward(self.weights(), self.cfg, x, positions)

    def decode(self, x: torch.Tensor, cache: Dict[str, torch.Tensor], index: int,
               window: int = 0, panels: Optional[Panels] = None) -> torch.Tensor:
        """``panels`` is whole here: ``init_cache`` refuses an MLA cache
        over several (item 14.3)."""
        _no_window(window)
        return mla_decode(self.weights(), self.cfg, x, cache, index)


class StackedMLA(nn.Module):
    """n slots' :class:`MLA` (the same parameters, each with a leading slot
    axis): x (n, B, S, d_model), one :func:`mla_forward` a slot over views
    of the stacked weights."""

    def __init__(self, cfg: MLAConfig, n: int, *, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.cfg = cfg
        kw = dict(dtype=dtype, device=device)
        h, hd, rd, rank = cfg.n_heads, cfg.head_dim, cfg.rope_dim, cfg.kv_lora_rank
        self.wq = StackedLinear(n, cfg.d_model, h * (hd + rd), **kw)
        self.w_dkv = StackedLinear(n, cfg.d_model, rank + rd, **kw)
        self.kv_norm = StackedRMSNorm(n, rank, **kw)
        self.w_uk = StackedLinear(n, rank, h * hd, **kw)
        self.w_uv = StackedLinear(n, rank, h * hd, **kw)
        self.wo = StackedLinear(n, h * hd, cfg.d_model, **kw)

    def forward(self, x: torch.Tensor, positions: torch.Tensor, window: int = 0
                ) -> torch.Tensor:
        _no_window(window)
        return torch.stack([mla_forward(MLAWeights(
            self.wq.w[r], self.w_dkv.w[r], self.kv_norm.scale[r], self.w_uk.w[r],
            self.w_uv.w[r], self.wo.w[r]), self.cfg, xr, positions) for r, xr in enumerate(x)])


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
