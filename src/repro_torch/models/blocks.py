"""Building blocks: the dense initialiser and the mean cross-entropy (the
split CNNs), and the dense decoder's layers (``repro/models/blocks.py``):
embedding init, :class:`Linear`, :class:`RMSNorm`, :class:`SwiGLU` and the
rotary embedding.

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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x @ self.w
        return y if self.b is None else y + self.b


class RMSNorm(nn.Module):
    """Root-mean-square norm over the last axis, computed in f32 and cast
    back to the input's dtype (eps 1e-6); the scale starts at 1."""

    def __init__(self, dim: int, *, dtype: torch.dtype = torch.float32, device=None,
                 eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.empty((dim,), dtype=dtype, device=device))

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.scale.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.float32)
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + self.eps)
        return (y * self.scale.to(torch.float32)).to(x.dtype)


class SwiGLU(nn.Module):
    """``down(silu(gate(x)) * up(x))``."""

    def __init__(self, d_model: int, d_ff: int, *, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.gate = Linear(d_model, d_ff, **kw)
        self.up = Linear(d_model, d_ff, **kw)
        self.down = Linear(d_ff, d_model, **kw)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for lin in (self.gate, self.up, self.down):
            lin.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down(F.silu(self.gate(x)) * self.up(x))


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


__all__ = ["DTYPES", "Linear", "RMSNorm", "SwiGLU", "apply_rope", "cross_entropy",
           "cross_entropy_stacked", "dense_init", "embed_init", "rope_frequencies"]
