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

The decode cache of a layer is a pair of (B, max_seq, Hkv, D) tensors; a
step writes the new token's key and value in place at ``index`` (the
reference's ``dynamic_update_slice``, without copying the cache).  MLA
comes with the MLA/MoE slice.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
from torch import nn

from ..kernels import ops
from .blocks import Linear, RMSNorm, StackedLinear, StackedRMSNorm, apply_rope


class AttnConfig(NamedTuple):
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope_theta: float = 10000.0
    qkv_bias: bool = False
    qk_norm: bool = False


class GQA(nn.Module):
    """Causal GQA self-attention: projections ``wq, wk, wv, wo`` (+ q/k
    RMSNorm over head_dim when ``qk_norm``)."""

    def __init__(self, cfg: AttnConfig, *, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        kw = dict(dtype=dtype, device=device)
        hd = cfg.head_dim
        self.wq = Linear(cfg.d_model, cfg.n_heads * hd, bias=cfg.qkv_bias, **kw)
        self.wk = Linear(cfg.d_model, cfg.n_kv_heads * hd, bias=cfg.qkv_bias, **kw)
        self.wv = Linear(cfg.d_model, cfg.n_kv_heads * hd, bias=cfg.qkv_bias, **kw)
        self.wo = Linear(cfg.n_heads * hd, cfg.d_model, **kw)
        if cfg.qk_norm:
            self.q_norm = RMSNorm(hd, **kw)
            self.k_norm = RMSNorm(hd, **kw)

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
        k = self.wk(x).view(b, s, cfg.n_kv_heads, cfg.head_dim)
        v = self.wv(x).view(b, s, cfg.n_kv_heads, cfg.head_dim)
        if cfg.qk_norm:
            q = self.q_norm(q)
            k = self.k_norm(k)
        return (apply_rope(q, positions, cfg.rope_theta),
                apply_rope(k, positions, cfg.rope_theta), v)

    def forward(self, x: torch.Tensor, positions: torch.Tensor, window: int) -> torch.Tensor:
        """Prefill: causal attention over the whole sequence (``window`` 0
        for full attention)."""
        cfg = self.cfg
        b, s, _ = x.shape
        q, k, v = self._project(x, positions)
        out = ops.flash_attention(q, k, v, window=window)
        return self.wo(out.reshape(b, s, cfg.n_heads * cfg.head_dim))

    def decode(self, x: torch.Tensor, cache: Dict[str, torch.Tensor], index: int,
               window: int) -> torch.Tensor:
        """One decode step: x (B, 1, d_model) is the token at position
        ``index`` (host int).  Writes its key and value into ``cache`` ((B,
        max_seq, Hkv, D) tensors) in place and attends over positions <=
        ``index``."""
        cfg = self.cfg
        b = x.shape[0]
        pos = torch.full((1,), index, dtype=torch.int64, device=x.device)
        q, k_new, v_new = self._project(x, pos)
        cache["k"][:, index] = k_new[:, 0].to(cache["k"].dtype)
        cache["v"][:, index] = v_new[:, 0].to(cache["v"].dtype)
        out = ops.decode_attention(q, cache["k"], cache["v"], index, window=window)
        return self.wo(out.reshape(b, 1, cfg.n_heads * cfg.head_dim))


class StackedGQA(nn.Module):
    """n slots' :class:`GQA` (the same parameters, each with a leading slot
    axis): x (n, B, S, d_model) -> (n, B, S, d_model), causal over S."""

    def __init__(self, cfg: AttnConfig, n: int, *, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.cfg = cfg
        kw = dict(dtype=dtype, device=device)
        hd = cfg.head_dim
        self.wq = StackedLinear(n, cfg.d_model, cfg.n_heads * hd, bias=cfg.qkv_bias, **kw)
        self.wk = StackedLinear(n, cfg.d_model, cfg.n_kv_heads * hd, bias=cfg.qkv_bias, **kw)
        self.wv = StackedLinear(n, cfg.d_model, cfg.n_kv_heads * hd, bias=cfg.qkv_bias, **kw)
        self.wo = StackedLinear(n, cfg.n_heads * hd, cfg.d_model, **kw)
        if cfg.qk_norm:
            self.q_norm = StackedRMSNorm(n, hd, **kw)
            self.k_norm = StackedRMSNorm(n, hd, **kw)

    def forward(self, x: torch.Tensor, positions: torch.Tensor, window: int) -> torch.Tensor:
        cfg = self.cfg
        n, b, s, _ = x.shape
        hd = cfg.head_dim
        q = self.wq(x).view(n, b, s, cfg.n_heads, hd)
        k = self.wk(x).view(n, b, s, cfg.n_kv_heads, hd)
        v = self.wv(x).view(n * b, s, cfg.n_kv_heads, hd)
        if cfg.qk_norm:
            q = self.q_norm(q)
            k = self.k_norm(k)
        q = apply_rope(q.view(n * b, s, cfg.n_heads, hd), positions, cfg.rope_theta)
        k = apply_rope(k.view(n * b, s, cfg.n_kv_heads, hd), positions, cfg.rope_theta)
        out = ops.flash_attention(q, k, v, window=window)
        return self.wo(out.reshape(n, b, s, cfg.n_heads * hd))


def init_kv_cache(layers: int, batch: int, max_seq: int, cfg: AttnConfig,
                  dtype: torch.dtype, device=None) -> Dict[str, torch.Tensor]:
    """Zeroed decode cache {"k", "v"} of ``layers`` layers, each (B,
    max_seq, Hkv, D), on a leading layer axis (the reference's stacked
    layout)."""
    shape = (layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    return {name: torch.zeros(shape, dtype=dtype, device=device) for name in ("k", "v")}


__all__ = ["AttnConfig", "GQA", "StackedGQA", "init_kv_cache"]
