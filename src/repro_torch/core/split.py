"""Split-learning abstraction: the gamma/phi decomposition and the vanilla-SL
mini-batch message flow (FwdProp / BackProp of Algorithms 2 & 3).

``_sl_exchange`` reproduces the paper's four-message exchange, with attack
hooks at each tampering point:

  client --- g(x, gamma), y --->  AP        (activation + label messages)
  client <---  d loss / d c  ---  AP        (cut-layer gradient message)

The client backward starts from its own cut activations with exactly the
(possibly tampered) cut gradient it received — no gradient bypasses the cut.

gamma and phi are ``nn.Module``s (``ClientCNN`` / ``APHead`` for the CNNs,
``ClientLM`` / ``APLM`` for an LM via :func:`from_lm`, and their stacked
forms); an SGD step updates their parameters in place.

The batched round runs the same exchange on cluster-stacked halves
(:class:`StackedSplit`): messages carry a leading R axis, the attack hooks
are the ``AttackVec`` dispatchers, and the AP differentiates the *sum over
clusters* of the per-cluster mean losses — the clusters share no parameter,
so each receives exactly its own gradients.
"""
from __future__ import annotations

import copy
import dataclasses
import math
from functools import partial
from typing import Callable, List, Optional, Sequence, Tuple

import torch
from torch import nn

from ..adversary import (Attack, AttackVec, flip_labels, flip_labels_vec,
                         poison_inputs, poison_inputs_vec, tamper_activation,
                         tamper_activation_vec, tamper_gradient,
                         tamper_gradient_vec)
from ..adversary.families import Noise
from ..kernels import ops as kops
from ..kernels.quant_exchange import message_stats

MESSAGE_STAT_NAMES = ("dispersion", "support_residual")
N_MESSAGE_STATS = len(MESSAGE_STAT_NAMES)


@dataclasses.dataclass(frozen=True)
class StackedSplit:
    """The cluster-stacked form of a split model, for the batched round.
    ``make(r, replicas=1)`` builds zeroed halves for R clusters (L * R
    slots, replica-major, for ``replicas`` L: the replica form) on the
    current default device, whose ``parameters()`` follow the plain halves'
    order with a leading slot axis each."""
    make: Callable[..., Tuple[nn.Module, nn.Module]]
    client_forward: Callable[[nn.Module, torch.Tensor], torch.Tensor]  # (R, B, ...) -> (R, B, d_c)
    ap_losses: Callable[[nn.Module, torch.Tensor, torch.Tensor], torch.Tensor]  # -> (R,)


@dataclasses.dataclass(frozen=True)
class SplitModule:
    """Functional view of a split model: ``init`` builds (gamma, phi) on the
    CPU from a CPU ``torch.Generator``; the rest are plain functions of the
    modules and tensors.  ``stacked`` is the cluster-stacked form the batched
    round needs (None: the model runs on the sequential engine only)."""
    init: Callable[[torch.Generator], Tuple[nn.Module, nn.Module]]
    client_forward: Callable[[nn.Module, torch.Tensor], torch.Tensor]
    ap_loss: Callable[[nn.Module, torch.Tensor, torch.Tensor], torch.Tensor]
    predict: Callable[[nn.Module, nn.Module, torch.Tensor], torch.Tensor]
    n_classes: int = 10
    stacked: Optional[StackedSplit] = None


def from_cnn(cfg) -> SplitModule:
    from ..models import cnn as cnn_mod
    from ..models.blocks import cross_entropy, cross_entropy_stacked

    return SplitModule(
        init=lambda gen: cnn_mod.cnn_init(gen, cfg),
        client_forward=lambda g, x: g(x),
        ap_loss=lambda p, a, y: cross_entropy(p(a), y),
        predict=lambda g, p, x: p(g(x)),
        n_classes=cfg.n_classes,
        stacked=StackedSplit(
            make=lambda r, replicas=1: cnn_mod.cnn_stacked(cfg, r, replicas),
            client_forward=lambda g, x: g(x),
            ap_losses=lambda p, a, y: cross_entropy_stacked(p(a), y)),
    )


#: why no Pigeon-SL round runs over an encoder-decoder
ENCDEC_ROUND = ("from_lm takes no encoder-decoder (arch_type 'audio'/'encdec'): the "
                "reference's from_lm sends tokens only, so its encode finds no 'frames', and "
                "no Pigeon-SL round over an encoder-decoder exists to port; serve or train "
                "one through launch.serve and launch.steps.make_train_step")


def from_lm(model) -> SplitModule:
    """Adapt a ``repro_torch.models.Model`` (token batches) to the
    SplitModule interface: x = tokens (B, S); y = labels (B, S).  gamma and
    phi are the model's ``split_params`` halves (``ClientLM``, ``APLM``);
    the AP's loss goes through B4.  ``init`` draws the parameters on the
    model's device, from a seed taken from the generator it is given: a
    model built on the card is drawn there (a CPU draw of an 8 B model takes
    minutes), one built on the CPU on the CPU, so runs on either device from
    one template start alike.  The cluster-stacked form is the
    ``models.StackedModel`` of the model's config (any family but the
    encoder-decoder): x (R, B, S) tokens, y (R, B, S) labels, a shared (D_o, S) label
    set broadcast to every slot.  An encoder-decoder raises
    :data:`ENCDEC_ROUND`."""
    from ..models.model import StackedModel
    from ..models.transformer import ENCDEC
    if model.cfg.arch_type in ENCDEC:
        raise ValueError(ENCDEC_ROUND)

    def make(r: int, replicas: int = 1):
        return StackedModel(model.cfg, model.plan, replicas * r).split_params()

    def init(gen: torch.Generator):
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=gen))
        model.init(torch.Generator(device=model.device).manual_seed(seed))
        return model.split_params()

    def ap_loss(phi, acts, labels):
        return model.ap_forward(phi, acts, {"tokens": labels, "labels": labels})[0]

    def predict(gamma, phi, tokens):
        return model.merge_params(gamma, phi).logits({"tokens": tokens})

    return SplitModule(init=init,
                       client_forward=lambda g, tokens: model.client_forward(
                           g, {"tokens": tokens}),
                       ap_loss=ap_loss, predict=predict, n_classes=model.cfg.vocab,
                       stacked=StackedSplit(make=make, client_forward=lambda g, x: g(x),
                                            ap_losses=lambda p, a, y: p(a, y)))


# ---------------------------------------------------------------------------
# cluster-stacked parameters
# ---------------------------------------------------------------------------

def _stacked(module: SplitModule) -> StackedSplit:
    if module.stacked is None:
        raise NotImplementedError("this split model has no cluster-stacked form, so it "
                                  "runs on the sequential engine only")
    return module.stacked


def replicas(theta) -> List[Tuple[nn.Module, nn.Module]]:
    """``theta`` as a list of ``(gamma, phi)`` pairs: one plain theta, or
    the L thetas of the replica form (the sweep's seeds, the pool's jobs),
    which a stacked round trains in L * R slots."""
    return [theta] if isinstance(theta[0], nn.Module) else list(theta)


@torch.no_grad()
def stack_replicas(module: SplitModule, thetas: Sequence[Tuple[nn.Module, nn.Module]],
                   r: int) -> Tuple[nn.Module, nn.Module]:
    """Cluster-stacked halves of L * R slots, replica-major: slots
    ``l * R .. l * R + R - 1`` hold ``thetas[l]``.  Built on the thetas'
    device (no host->device copy).  Every stacked layer works per slot (a
    batched product; a grouped convolution a replica), so a slot computes
    what it would in an R-slot stack."""
    device = next(thetas[0][0].parameters()).device
    with torch.device(device):
        sg, sp = _stacked(module).make(r, replicas=len(thetas))
    for half, stacked in enumerate((sg, sp)):
        for l, theta in enumerate(thetas):
            for big, p in zip(stacked.parameters(), theta[half].parameters()):
                slots = big[l * r:(l + 1) * r]
                slots.copy_(p.expand_as(slots))
    return sg, sp


def stack_params(module: SplitModule, gamma: nn.Module, phi: nn.Module,
                 r: int) -> Tuple[nn.Module, nn.Module]:
    """Cluster-stacked halves holding ``(gamma, phi)`` in each of R slots."""
    return stack_replicas(module, [(gamma, phi)], r)


@torch.no_grad()
def unstack_slot(template: nn.Module, stacked: nn.Module, r: int) -> nn.Module:
    """Slot ``r`` of a stacked half as a plain module (a copy of
    ``template``, the plain half it was stacked from)."""
    out = copy.deepcopy(template)
    for p, big in zip(out.parameters(), stacked.parameters()):
        p.copy_(big[r])
    return out


# ---------------------------------------------------------------------------
# the SL mini-batch exchange with attack hooks
# ---------------------------------------------------------------------------

def _sl_exchange(module: SplitModule, gamma: nn.Module, phi: nn.Module,
                 x: torch.Tensor, y: torch.Tensor, noise: Optional[Noise],
                 poison, send_labels, send_acts, recv_grad,
                 with_stats: bool = False, quant: Optional[str] = None,
                 lead: int = 1):
    """One FwdProp/BackProp exchange.  Returns (g_gamma, g_phi, loss) — the
    gradients as lists in ``parameters()`` order — plus the transmitted
    message's :func:`message_stats` when ``with_stats``.

    ``lead`` is the number of leading sample axes: 1 for one cluster's batch
    on the plain halves, 2 for R clusters' batches ``(R, B, ...)`` on the
    cluster-stacked halves, where ``loss`` and the stats come per cluster,
    ``(R,)`` and ``(R, 2)``.

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
    if lead == 1:
        forward, ap_loss = module.client_forward, module.ap_loss
    else:
        forward, ap_loss = _stacked(module).client_forward, _stacked(module).ap_losses
    x_used = poison(x)
    y_sent = send_labels(y)
    gamma_params = list(gamma.parameters())
    phi_params = list(phi.parameters())

    acts = forward(gamma, x_used)
    acts_sent = send_acts(acts.detach(), noise)
    rows = math.prod(acts_sent.shape[:lead])      # one wire row per sample
    stats = None
    if quant is not None:
        msgs = acts_sent.reshape(acts_sent.shape[:lead] + (-1,))
        msgs = msgs.to(torch.float32).contiguous()
        if with_stats:
            deq, _, stats = kops.quant_roundtrip_stats(msgs, quant)
        else:
            deq, _ = kops.quant_roundtrip(msgs.reshape(rows, -1), quant)
        acts_sent = deq.reshape(acts_sent.shape).to(acts_sent.dtype)

    # The AP differentiates w.r.t. phi and the message it received (for R
    # stacked clusters: the sum of their independent mean losses).
    acts_recv = acts_sent.detach().requires_grad_(True)
    loss = ap_loss(phi, acts_recv, y_sent)
    *g_phi, g_acts = torch.autograd.grad(loss.sum(), phi_params + [acts_recv])

    if quant is not None:
        gflat = g_acts.reshape(rows, -1).to(torch.float32).contiguous()
        gdeq, _ = kops.quant_roundtrip(gflat, quant)
        g_acts = gdeq.reshape(g_acts.shape).to(g_acts.dtype)
    g_acts_recv = recv_grad(g_acts, noise)
    # The client backward consumes exactly the received cut gradient.
    g_gamma = list(torch.autograd.grad(acts, gamma_params,
                                       grad_outputs=g_acts_recv.to(acts.dtype)))
    loss = loss.detach()
    if with_stats:
        if stats is None:
            stats = (message_stats(acts_sent) if lead == 1
                     else torch.stack([message_stats(a) for a in acts_sent]))
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


def sl_minibatch_grads_vec(module: SplitModule, av: AttackVec, gamma: nn.Module,
                           phi: nn.Module, x: torch.Tensor, y: torch.Tensor,
                           noise, with_stats: bool = False,
                           quant: Optional[str] = None):
    """The exchange of R stacked clusters, one client position each:
    ``av`` holds that position's ``(R,)`` lanes, ``x``/``y`` are
    ``(R, B, ...)``/``(R, B)``, and ``noise`` is one generator per slot (or
    the drawn noise).  Returns per-cluster losses ``(R,)``."""
    return _sl_exchange(
        module, gamma, phi, x, y, noise,
        lambda x_: poison_inputs_vec(av, x_),
        lambda y_: flip_labels_vec(av, y_, module.n_classes),
        lambda a, n: tamper_activation_vec(av, a, n),
        lambda g, n: tamper_gradient_vec(av, g, n),
        with_stats=with_stats, quant=quant, lead=2)


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
    xs: (E, B, ...), ys: (E, B) — or (E, R, B, ...), (E, R, B) for R stacked
    clusters, whose losses and stats then come per cluster.  Updates gamma
    and phi in place; with ``with_stats`` additionally returns the client's
    mean per-batch :func:`message_stats` vector."""
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
    loss = torch.mean(torch.stack(losses), dim=0)
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


def client_update_vec_impl(module: SplitModule, av: AttackVec, gamma: nn.Module,
                           phi: nn.Module, data: Tuple[torch.Tensor, torch.Tensor],
                           lr: float, noise: Optional[Sequence[torch.Generator]], *,
                           quant: Optional[str] = None):
    """One client position's turn in each of R stacked clusters: ``data`` is
    (xs (E, R, B, ...), ys (E, R, B)), ``noise`` one generator per slot.
    Returns (gamma, phi, per-cluster mean losses (R,)), updated in place."""
    return _client_update(partial(sl_minibatch_grads_vec, module, av, quant=quant),
                          gamma, phi, data, lr, noise)


def client_update_vec_stats_impl(module: SplitModule, av: AttackVec,
                                 gamma: nn.Module, phi: nn.Module,
                                 data: Tuple[torch.Tensor, torch.Tensor],
                                 lr: float, noise: Optional[Sequence[torch.Generator]], *,
                                 quant: Optional[str] = None):
    """:func:`client_update_vec_impl` + each cluster's mean message
    statistics ``(R, S)``."""
    return _client_update(
        partial(sl_minibatch_grads_vec, module, av, with_stats=True, quant=quant),
        gamma, phi, data, lr, noise, with_stats=True)


__all__ = ["MESSAGE_STAT_NAMES", "N_MESSAGE_STATS", "SplitModule",
           "StackedSplit", "client_update", "client_update_stats",
           "client_update_vec_impl", "client_update_vec_stats_impl",
           "from_cnn", "from_lm", "message_stats", "sgd_update",
           "replicas", "sl_minibatch_grads", "sl_minibatch_grads_vec", "stack_params",
           "stack_replicas", "unstack_slot"]
