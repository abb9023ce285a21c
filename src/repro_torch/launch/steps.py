"""The serving step functions (the reference's ``repro/launch/steps.py``,
its prefill and serve steps).

  * ``prefill_step(batch)``             — full-sequence forward, last-token
                                          logits (B, 1, V) f32.
  * ``serve_step(cache, tokens, index)`` — ONE new token against the KV
                                          cache -> (logits f32, cache).

The model holds its parameters, so a step takes none.  The training step
and the Pigeon-SL round over an LM come with the training slice; the
reference's sharded (mesh) programs have no single-card counterpart.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from ..models.model import Model


def make_prefill_step(model: Model) -> Callable:
    @torch.inference_mode()
    def prefill_step(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        h, _ = model.forward(batch)
        # last-position logits — the serving prefill output
        return (h[:, -1:, :] @ model.head.w).to(torch.float32)
    return prefill_step


def make_serve_step(model: Model) -> Callable:
    def serve_step(cache, tokens: torch.Tensor, index: int):
        logits, cache = model.decode_step(cache, tokens, index)
        return logits.to(torch.float32), cache
    return serve_step


__all__ = ["make_prefill_step", "make_serve_step"]
