"""Building blocks the split CNNs need: the dense initialiser and the mean
cross-entropy."""
from __future__ import annotations

import math

import torch


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


__all__ = ["cross_entropy", "cross_entropy_stacked", "dense_init"]
