"""Building blocks: the dense initialiser and the mean cross-entropy (the
split CNNs), and the dense decoder's layers (``repro/models/blocks.py``):
embedding init, :class:`Linear`, :class:`RMSNorm`, :class:`SwiGLU` and the
rotary embedding; and their cluster-stacked forms for the batched round
(:class:`StackedLinear`, :class:`StackedRMSNorm`, :class:`StackedSwiGLU`).
:class:`LayerNorm` and :class:`GeluMLP` (the reference's ``layernorm`` and
``gelu_mlp``) complete the module; no model of the reference calls them.

The decoder's modules allocate their parameters uninitialised on the
device and dtype they are given; ``reset_parameters(generator)`` draws them
as the reference's ``*_init`` functions do, in f32 on the generator's
device, and casts.  Dense kernels keep the reference's (d_in, d_out)
layout, so reference parameters load unchanged.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from . import parallel
from .parallel import enter, leave, mark_by_rule, optional

#: ModelConfig.dtype -> torch dtype
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def dense_init(generator: torch.Generator, d_in: int, d_out: int) -> torch.Tensor:
    """Truncated-normal (fan-in) initialisation of a (d_in, d_out) dense
    kernel, drawn on ``generator``'s device."""
    w = torch.empty((d_in, d_out), dtype=torch.float32, device=generator.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return w / math.sqrt(d_in)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy ``logsumexp(logits) - logits[label]`` (f32)."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.mean(lse - picked)


def cross_entropy_stacked(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-cluster mean cross-entropy of cluster-stacked logits (R, B, n):
    (R,) f32.  ``labels`` is (R, B), or (B,) shared by every cluster."""
    logits = logits.to(torch.float32)
    labels = labels.expand(logits.shape[:-1])
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.mean(lse - picked, dim=-1)


def embed_init(generator: torch.Generator, vocab: int, d_model: int) -> torch.Tensor:
    """N(0, 0.02^2) (vocab, d_model) f32 table, drawn on ``generator``'s
    device (the reference's ``embed_init``; the LM head uses it too)."""
    w = torch.randn((vocab, d_model), generator=generator, device=generator.device)
    return w.mul_(0.02)


class Linear(nn.Module):
    """``x @ w (+ b)`` with a (d_in, d_out) kernel; the bias starts at 0."""

    def __init__(self, d_in: int, d_out: int, bias: bool = False, *,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.w = nn.Parameter(torch.empty((d_in, d_out), dtype=dtype, device=device))
        self.b = (nn.Parameter(torch.empty((d_out,), dtype=dtype, device=device))
                  if bias else None)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.w.copy_(dense_init(generator, *self.w.shape))
        if self.b is not None:
            self.b.zero_()

    def forward(self, x: torch.Tensor, w: Optional[torch.Tensor] = None,
                b: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``x @ w (+ b)``; ``w`` and ``b`` in the parameters' places (views
        of them through one of ``models.parallel``'s gradient functions)."""
        y = x @ (self.w if w is None else w)
        b = self.b if b is None else b
        return y if b is None else y + b


class RMSNorm(nn.Module):
    """Root-mean-square norm over the last axis, computed in f32 and cast
    back to the input's dtype (eps 1e-6); the scale starts at 1.  With
    ``par`` the axis is split over its model axis (this rank's ``dim``
    columns and scale): the mean of squares is the ranks' sums, all-reduced
    (:func:`_mean_square`)."""

    def __init__(self, dim: int, *, dtype: torch.dtype = torch.float32, device=None,
                 eps: float = 1e-6, par=None):
        super().__init__()
        self.eps = eps
        self.par = optional(par)
        self.scale = nn.Parameter(torch.empty((dim,), dtype=dtype, device=device))

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.scale.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.scale, self.eps, self.par)


def _mean_square(xf: torch.Tensor, par) -> torch.Tensor:
    """The mean of squares over the last axis of f32 ``xf``; where ``par``'s
    model axis splits that axis, the local sums of squares summed over it
    (``parallel.sum_over``: one all-reduce of a (..., 1) tensor) over the
    whole width."""
    if par is None or par.model_size == 1:
        return torch.mean(xf * xf, dim=-1, keepdim=True)
    total = parallel.sum_over(torch.sum(xf * xf, dim=-1, keepdim=True), par)
    return total / (xf.shape[-1] * par.model_size)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6, par=None
             ) -> torch.Tensor:
    """:class:`RMSNorm` as a function of its scale (and ``par``)."""
    xf = x.to(torch.float32)
    y = xf * torch.rsqrt(_mean_square(xf, par) + eps)
    return (y * scale.to(torch.float32)).to(x.dtype)


class LayerNorm(nn.Module):
    """Layer norm over the last axis, computed in f32 with the biased
    variance (``jnp.var``) and cast back to the input's dtype (eps 1e-5);
    the scale starts at 1, the bias at 0."""

    def __init__(self, dim: int, *, dtype: torch.dtype = torch.float32, device=None,
                 eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.empty((dim,), dtype=dtype, device=device))
        self.bias = nn.Parameter(torch.empty((dim,), dtype=dtype, device=device))

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.scale.fill_(1.0)
        self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.float32)
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.var(xf, dim=-1, keepdim=True, correction=0)
        y = (xf - mu) * torch.rsqrt(var + self.eps)
        return (y * self.scale.to(torch.float32) + self.bias.to(torch.float32)).to(x.dtype)


class GeluMLP(nn.Module):
    """``down(gelu(up(x)))`` with biases; GELU's tanh approximation, the
    default of ``jax.nn.gelu``."""

    def __init__(self, d_model: int, d_ff: int, *, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.up = Linear(d_model, d_ff, bias=True, **kw)
        self.down = Linear(d_ff, d_model, bias=True, **kw)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.up.reset_parameters(generator)
        self.down.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down(F.gelu(self.up(x), approximate="tanh"))


class SwiGLU(nn.Module):
    """``down(silu(gate(x)) * up(x))``.  With ``par`` (``models.parallel``)
    of model axis m > 1 the FFN width is this rank's F/m: ``gate`` and
    ``up`` column-parallel, ``down`` row-parallel, one all-reduce over
    ``model`` at the output; where m does not divide F the FFN runs whole
    on each model rank (``Parallel.over``)."""

    def __init__(self, d_model: int, d_ff: int, *, dtype: torch.dtype = torch.float32,
                 device=None, par=None):
        super().__init__()
        self.par = par = optional(par).over(d_ff)
        kw = dict(dtype=dtype, device=device)
        f = d_ff // par.model_size
        self.gate = Linear(d_model, f, **kw)
        self.up = Linear(d_model, f, **kw)
        self.down = Linear(f, d_model, **kw)
        mark_by_rule(self, par)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for lin in (self.gate, self.up, self.down):
            lin.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = enter(x, self.par)
        return leave(self.down(F.silu(self.gate(x)) * self.up(x)), self.par)


def _slot_view(p: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A stacked (n, dim) parameter shaped to broadcast over x (n, ..., dim)."""
    return p.view((p.shape[0],) + (1,) * (x.dim() - 2) + (p.shape[-1],))


class StackedLinear(nn.Module):
    """n slots' :class:`Linear`: w (n, d_in, d_out), b (n, d_out).  x (n,
    ..., d_in) -> (n, ..., d_out), one product a slot over views of the
    stacked weight (not one batched product), so that slot r computes what
    its plain layer computes."""

    def __init__(self, n: int, d_in: int, d_out: int, bias: bool = False, *,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.w = nn.Parameter(torch.zeros((n, d_in, d_out), dtype=dtype, device=device))
        self.b = (nn.Parameter(torch.zeros((n, d_out), dtype=dtype, device=device))
                  if bias else None)

    def forward(self, x: torch.Tensor, w: Optional[torch.Tensor] = None,
                b: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``w`` and ``b`` as :class:`Linear`'s."""
        w = self.w if w is None else w
        b = self.b if b is None else b
        if b is None:
            return torch.stack([xi @ wi for xi, wi in zip(x, w)])
        return torch.stack([xi @ wi + bi for xi, wi, bi in zip(x, w, b)])


class StackedRMSNorm(nn.Module):
    """n slots' :class:`RMSNorm`: scale (n, dim) over x (n, ..., dim).  The
    normalisation runs over all slots at once, each slot then scaled by its
    own row; ``par`` as :class:`RMSNorm`'s."""

    def __init__(self, n: int, dim: int, *, dtype: torch.dtype = torch.float32,
                 device=None, eps: float = 1e-6, par=None):
        super().__init__()
        self.eps = eps
        self.par = optional(par)
        self.scale = nn.Parameter(torch.zeros((n, dim), dtype=dtype, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.float32)
        y = xf * torch.rsqrt(_mean_square(xf, self.par) + self.eps)
        return (y * _slot_view(self.scale, x).to(torch.float32)).to(x.dtype)


class StackedSwiGLU(nn.Module):
    """n slots' :class:`SwiGLU`: the products a slot, SiLU and the gate's
    product over all slots at once; ``par`` as :class:`SwiGLU`'s (one
    all-reduce for all slots)."""

    def __init__(self, n: int, d_model: int, d_ff: int, *,
                 dtype: torch.dtype = torch.float32, device=None, par=None):
        super().__init__()
        self.par = par = optional(par).over(d_ff)
        kw = dict(dtype=dtype, device=device)
        f = d_ff // par.model_size
        self.gate = StackedLinear(n, d_model, f, **kw)
        self.up = StackedLinear(n, d_model, f, **kw)
        self.down = StackedLinear(n, f, d_model, **kw)
        mark_by_rule(self, par)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = enter(x, self.par)
        return leave(self.down(F.silu(self.gate(x)) * self.up(x)), self.par)


def rope_frequencies(head_dim: int, theta: float = 10000.0, device=None) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0
               ) -> torch.Tensor:
    """Rotate channel pairs (i, i + head_dim/2).  x: (..., seq, heads,
    head_dim); positions: (seq,).  Computed in f32, cast back."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    angles = positions[:, None].to(torch.float32) * freqs          # (seq, hd/2)
    cos = torch.cos(angles)[:, None, :]
    sin = torch.sin(angles)[:, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


__all__ = ["DTYPES", "GeluMLP", "LayerNorm", "Linear", "RMSNorm", "StackedLinear",
           "StackedRMSNorm", "StackedSwiGLU", "SwiGLU", "apply_rope", "cross_entropy",
           "cross_entropy_stacked", "dense_init", "embed_init", "rms_norm", "rope_frequencies"]
