"""Split-learning abstraction: the gamma/phi decomposition and the vanilla-SL
mini-batch message flow (FwdProp / BackProp of Algorithms 2 & 3).

``_sl_exchange`` reproduces the paper's four-message exchange, with attack
hooks at each tampering point:

  client --- g(x, gamma), y --->  AP        (activation + label messages)
  client <---  d loss / d c  ---  AP        (cut-layer gradient message)

The client backward starts from its own cut activations with exactly the
(possibly tampered) cut gradient it received — no gradient bypasses the cut.

gamma and phi are ``nn.Module``s (``ClientCNN`` / ``APHead`` for the CNNs);
an SGD step updates their parameters in place.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, List, Optional, Tuple

import torch
from torch import nn

from ..adversary import (Attack, flip_labels, poison_inputs,
                         tamper_activation, tamper_gradient)
from ..adversary.families import Noise
from ..kernels import ops as kops
from ..kernels.quant_exchange import message_stats

MESSAGE_STAT_NAMES = ("dispersion", "support_residual")
N_MESSAGE_STATS = len(MESSAGE_STAT_NAMES)


@dataclasses.dataclass(frozen=True)
class SplitModule:
    """Functional view of a split model: ``init`` builds (gamma, phi) on the
    CPU from a CPU ``torch.Generator``; the rest are plain functions of the
    modules and tensors."""
    init: Callable[[torch.Generator], Tuple[nn.Module, nn.Module]]
    client_forward: Callable[[nn.Module, torch.Tensor], torch.Tensor]
    ap_loss: Callable[[nn.Module, torch.Tensor, torch.Tensor], torch.Tensor]
    predict: Callable[[nn.Module, nn.Module, torch.Tensor], torch.Tensor]
    n_classes: int = 10


def from_cnn(cfg) -> SplitModule:
    from ..models import cnn as cnn_mod
    from ..models.blocks import cross_entropy

    return SplitModule(
        init=lambda gen: cnn_mod.cnn_init(gen, cfg),
        client_forward=lambda g, x: g(x),
        ap_loss=lambda p, a, y: cross_entropy(p(a), y),
        predict=lambda g, p, x: p(g(x)),
        n_classes=cfg.n_classes,
    )


# ---------------------------------------------------------------------------
# the SL mini-batch exchange with attack hooks
# ---------------------------------------------------------------------------

def _sl_exchange(module: SplitModule, gamma: nn.Module, phi: nn.Module,
                 x: torch.Tensor, y: torch.Tensor, noise: Optional[Noise],
                 poison, send_labels, send_acts, recv_grad,
                 with_stats: bool = False, quant: Optional[str] = None):
    """One FwdProp/BackProp exchange.  Returns (g_gamma, g_phi, loss) — the
    gradients as lists in ``parameters()`` order — plus the transmitted
    message's :func:`message_stats` when ``with_stats``.

    The attack hooks sit where the taxonomy places them: ``poison`` on the
    client's inputs, ``send_labels`` / ``send_acts`` on the messages before
    transmission, ``recv_grad`` on the cut gradient after reception.
    Stochastic hooks draw from ``noise``: the run's generator (on its
    device), or — for a test that hands both implementations the same draw —
    the standard-normal noise of the one stochastic hook.

    ``quant`` compresses the two cut-layer wire messages through the
    quantize->dequantize round trip.  Sender-side attacks apply *before*
    transmission and then quantize with the message, so the AP scores and
    backpropagates through exactly the dequantized message; ``recv_grad``
    applies *after* the cut gradient is dequantized.  Under ``with_stats``
    the fused kernel emits the stats of that dequantized uplink message.
    """
    x_used = poison(x)
    y_sent = send_labels(y)
    gamma_params = list(gamma.parameters())
    phi_params = list(phi.parameters())

    acts = module.client_forward(gamma, x_used)
    acts_sent = send_acts(acts.detach(), noise)
    stats = None
    if quant is not None:
        flat = acts_sent.reshape(acts_sent.shape[0], -1).to(torch.float32).contiguous()
        if with_stats:
            deq, _, stats = kops.quant_roundtrip_stats(flat, quant)
        else:
            deq, _ = kops.quant_roundtrip(flat, quant)
        acts_sent = deq.reshape(acts_sent.shape).to(acts_sent.dtype)

    # The AP differentiates w.r.t. phi and the message it received.
    acts_recv = acts_sent.detach().requires_grad_(True)
    loss = module.ap_loss(phi, acts_recv, y_sent)
    *g_phi, g_acts = torch.autograd.grad(loss, phi_params + [acts_recv])

    if quant is not None:
        gflat = g_acts.reshape(g_acts.shape[0], -1).to(torch.float32).contiguous()
        gdeq, _ = kops.quant_roundtrip(gflat, quant)
        g_acts = gdeq.reshape(g_acts.shape).to(g_acts.dtype)
    g_acts_recv = recv_grad(g_acts, noise)
    # The client backward consumes exactly the received cut gradient.
    g_gamma = list(torch.autograd.grad(acts, gamma_params,
                                       grad_outputs=g_acts_recv.to(acts.dtype)))
    loss = loss.detach()
    if with_stats:
        if stats is None:
            stats = message_stats(acts_sent)
        return g_gamma, list(g_phi), loss, stats
    return g_gamma, list(g_phi), loss


def sl_minibatch_grads(module: SplitModule, attack: Attack, gamma: nn.Module,
                       phi: nn.Module, x: torch.Tensor, y: torch.Tensor,
                       noise: Optional[Noise], with_stats: bool = False,
                       quant: Optional[str] = None):
    """The exchange with a static ``Attack``."""
    return _sl_exchange(
        module, gamma, phi, x, y, noise,
        lambda x_: poison_inputs(attack, x_),
        lambda y_: flip_labels(attack, y_, module.n_classes),
        lambda a, n: tamper_activation(attack, a, n),
        lambda g, n: tamper_gradient(attack, g, n),
        with_stats=with_stats, quant=quant)


def sgd_update(params: nn.Module, grads: List[torch.Tensor], lr: float) -> nn.Module:
    """``p - lr * g`` for every parameter, written in place (the reference
    returns new arrays; nothing here keeps the old values)."""
    with torch.no_grad():
        for p, g in zip(params.parameters(), grads):
            p.sub_(g.to(p.dtype) * lr)
    return params


def _client_update(grads_fn, gamma: nn.Module, phi: nn.Module,
                   data: Tuple[torch.Tensor, torch.Tensor], lr: float,
                   gen: Optional[torch.Generator], with_stats: bool = False):
    """E mini-batch SGD updates for one client (lines 10-18 of Algorithm 1),
    generic over the exchange implementation.  data = (xs, ys) with
    xs: (E, B, ...), ys: (E, B).  Updates gamma and phi in place; with
    ``with_stats`` additionally returns the client's mean per-batch
    :func:`message_stats` vector."""
    xs, ys = data
    losses, stats = [], []
    for x, y in zip(xs, ys):
        out = grads_fn(gamma, phi, x, y, gen)
        g_gamma, g_phi, loss = out[:3]
        sgd_update(gamma, g_gamma, lr)
        sgd_update(phi, g_phi, lr)
        losses.append(loss)
        if with_stats:
            stats.append(out[3])
    loss = torch.mean(torch.stack(losses))
    if with_stats:
        return gamma, phi, loss, torch.mean(torch.stack(stats), dim=0)
    return gamma, phi, loss


def client_update(module: SplitModule, attack: Attack, gamma: nn.Module,
                  phi: nn.Module, data: Tuple[torch.Tensor, torch.Tensor],
                  lr: float, gen: Optional[torch.Generator], *,
                  quant: Optional[str] = None):
    """One client's turn; returns (gamma, phi, mean loss), updated in place."""
    return _client_update(partial(sl_minibatch_grads, module, attack, quant=quant),
                          gamma, phi, data, lr, gen)


def client_update_stats(module: SplitModule, attack: Attack, gamma: nn.Module,
                        phi: nn.Module, data: Tuple[torch.Tensor, torch.Tensor],
                        lr: float, gen: Optional[torch.Generator], *,
                        quant: Optional[str] = None):
    """:func:`client_update` + the client's mean transmitted-message
    statistics, for selection policies that score message anomalies.  The
    parameter/loss arithmetic is the same as :func:`client_update`'s."""
    return _client_update(
        partial(sl_minibatch_grads, module, attack, with_stats=True, quant=quant),
        gamma, phi, data, lr, gen, with_stats=True)


__all__ = ["MESSAGE_STAT_NAMES", "N_MESSAGE_STATS", "SplitModule",
           "client_update", "client_update_stats", "from_cnn", "message_stats",
           "sgd_update", "sl_minibatch_grads"]
