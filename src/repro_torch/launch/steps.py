"""The step functions (the reference's ``repro/launch/steps.py``).

  * ``train_step(batch)``               — one SL mini-batch update of the
                                          split network (client and AP
                                          halves in one differentiation)
                                          -> loss.
  * ``prefill_step(batch)``             — full-sequence forward, last-token
                                          logits (B, 1, V) f32.
  * ``serve_step(cache, tokens, index)`` — ONE new token against the KV
                                          cache -> (logits f32, cache).

The model holds its parameters, so a step takes none and the train step
updates them in place.  The reference's round programs
(``launch_round_spec``, ``make_pigeon_round_step``,
``make_pigeon_plus_round_step``) need a cluster-stacked LM and come with it
(ROADMAP.md Queue A item 5); its sharded (mesh) programs have no
single-card counterpart.  :func:`instrument_step` wraps any step so that
each call emits one telemetry span.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..core.split import sgd_update
from ..kernels import ops as kops
from ..models.model import Model


def make_train_step(model: Model, lr: float = 1e-3,
                    quant: Optional[str] = None) -> Callable:
    """One train step: ``loss = train_step(batch)`` differentiates the loss
    with respect to every parameter and applies ``p -= lr * g`` in place,
    in the parameter's dtype, as the reference's step does.  With ``quant``
    the loss routes through the model's gamma/phi cut and
    :func:`kernels.ops.quant_cut_exchange`, a straight-through wire whose
    forward quantizes the uplink activations and whose backward quantizes
    the downlink cut gradient (B2 both ways on the card).  ``quant=None``
    is the plain ``model.loss`` path."""
    params = list(model.parameters())
    halves = model.split_params() if quant is not None else None

    def loss_of(batch):
        if halves is None:
            return model.loss(batch)
        gamma, phi = halves
        acts = kops.quant_cut_exchange(model.client_forward(gamma, batch), quant)
        return model.ap_forward(phi, acts, batch)

    def train_step(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        loss, _ = loss_of(batch)
        sgd_update(model, torch.autograd.grad(loss, params), lr)
        return loss.detach()

    return train_step


def make_prefill_step(model: Model) -> Callable:
    @torch.inference_mode()
    def prefill_step(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        h, _ = model.forward(batch)
        # last-position logits — the serving prefill output
        return (h[:, -1:, :] @ model.head.w).to(torch.float32)
    return prefill_step


def instrument_step(fn: Callable, telemetry, name: str) -> Callable:
    """``fn`` wrapped so that every call emits one span ``name`` (with its
    call index) into ``telemetry``, fenced on the step's outputs, so the
    span covers the card's work; ``fn`` itself when telemetry is None or
    disabled."""
    if telemetry is None or not getattr(telemetry, "enabled", False):
        return fn
    calls = iter(range(1 << 62))

    def traced(*args, **kwargs):
        with telemetry.span(name, call=next(calls)) as sp:
            out = fn(*args, **kwargs)
            sp.fence(out)
            return out

    return traced


def make_serve_step(model: Model) -> Callable:
    def serve_step(cache, tokens: torch.Tensor, index: int):
        logits, cache = model.decode_step(cache, tokens, index)
        return logits.to(torch.float32), cache
    return serve_step


__all__ = ["instrument_step", "make_prefill_step", "make_serve_step", "make_train_step"]
