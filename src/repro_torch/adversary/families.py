"""Built-in attack families: the static hooks and the vectorised hooks of
the batched round, which share one arithmetic helper per family wherever the
math is not trivial.

Importing this module populates ``repro_torch.adversary.registry.REGISTRY``.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Sequence, Union

import numpy as np
import torch

from . import specs
from .registry import (CODE_ACTIVATION, CODE_BACKDOOR, CODE_GRAD_NOISE,
                       CODE_GRAD_SCALE, CODE_LABEL_FLIP, CODE_REPLAY,
                       AttackFamily, lane, register, slot_noise)
from .specs import Attack

#: a generator to draw standard-normal noise from, or the drawn noise itself
Noise = Union[torch.Generator, torch.Tensor]


def _normal(noise: Noise, like: torch.Tensor) -> torch.Tensor:
    """Standard-normal f32 noise of ``like``'s shape on its device."""
    if isinstance(noise, torch.Generator):
        return torch.randn(like.shape, generator=noise, dtype=torch.float32,
                           device=like.device)
    if noise is None:
        raise ValueError("this attack family draws noise: pass a generator "
                         "or the noise tensor")
    if tuple(noise.shape) != tuple(like.shape):
        raise ValueError(f"noise of shape {tuple(noise.shape)} for a message "
                         f"of shape {tuple(like.shape)}")
    return noise.to(device=like.device, dtype=torch.float32)


# ---------------------------------------------------------------------------
# shared arithmetic helpers
# ---------------------------------------------------------------------------

def _blend(acts: torch.Tensor, n: torch.Tensor, keep, rest, lead: int
           ) -> torch.Tensor:
    """``keep * acts + rest * n`` with ``n`` norm-matched per sample: the
    first ``lead`` axes index samples (1 for a batch, 2 for a
    cluster-stacked batch)."""
    a = acts.to(torch.float32)
    dims = tuple(range(lead, acts.dim()))
    g_norm = torch.sqrt(torch.sum(torch.square(a), dim=dims, keepdim=True))
    n_norm = torch.sqrt(torch.sum(torch.square(n), dim=dims, keepdim=True))
    n_scaled = n * (g_norm / torch.clamp_min(n_norm, 1e-12))
    return (keep * a + rest * n_scaled).to(acts.dtype)


def _noise_blend(acts: torch.Tensor, noise: Noise, keep: float) -> torch.Tensor:
    """Keep a ``keep`` fraction of the true cut activation and replace the
    rest with Gaussian noise norm-matched per sample (leading axis = batch).
    ``keep`` and ``1 - keep`` are rounded to f32 first, as the reference
    computes them."""
    keep32 = np.float32(keep)
    rest32 = np.float32(1.0) - keep32
    return _blend(acts, _normal(noise, acts), float(keep32), float(rest32), 1)


def _noise_blend_vec(av, acts: torch.Tensor, noise) -> torch.Tensor:
    """:func:`_noise_blend` per slot of a cluster-stacked message, with the
    keep lane in f32 (``1 - keep`` in f32, as the static path rounds it)."""
    keep = lane(av.act_keep, acts).to(torch.float32)
    n = slot_noise(av, CODE_ACTIVATION, noise, acts)
    return _blend(acts, n, keep, 1.0 - keep, 2)


def _replay_acts(acts: torch.Tensor) -> torch.Tensor:
    """Stale/replay: re-transmit the first sample's captured cut-activation
    message for every sample of the batch."""
    return acts[:1].expand(acts.shape).contiguous()


def _replay_acts_vec(acts: torch.Tensor) -> torch.Tensor:
    return acts[:, :1].expand(acts.shape).contiguous()


def _stamp_trigger(x: torch.Tensor, frac: float, value: float) -> torch.Tensor:
    """Backdoor trigger: overwrite the first ``round(frac * d)`` features of
    each flattened sample with ``value``."""
    flat = x.reshape(x.shape[0], -1).clone()
    d = flat.shape[1]
    k = max(1, int(np.round(np.float32(frac) * np.float32(d))))
    flat[:, :k] = float(np.float32(value))
    return flat.reshape(x.shape)


def _stamp_trigger_vec(av, x: torch.Tensor) -> torch.Tensor:
    """:func:`_stamp_trigger` per slot of a cluster-stacked batch: the
    trigger size and value come from the slot's lanes, in f32 as the static
    path rounds them."""
    flat = x.reshape(x.shape[0], x.shape[1], -1)
    d = flat.shape[2]
    k = torch.clamp_min(torch.round(av.trig_frac.to(torch.float32) * float(d)), 1.0)
    mask = torch.arange(d, device=x.device)[None, :] < k[:, None]
    value = av.trig_value.to(x.dtype)[:, None, None]
    return torch.where(mask[:, None, :], value, flat).reshape(x.shape)


def _grad_noise(g: torch.Tensor, noise: Noise, std: float) -> torch.Tensor:
    return (g.to(torch.float32)
            + float(np.float32(std)) * _normal(noise, g)).to(g.dtype)


def _grad_noise_vec(av, g: torch.Tensor, noise) -> torch.Tensor:
    n = slot_noise(av, CODE_GRAD_NOISE, noise, g)
    return (g.to(torch.float32) + lane(av.noise_std, g) * n).to(g.dtype)


def _tamper_params(a: Attack, params: torch.nn.Module,
                   noise: Union[torch.Generator, Sequence[torch.Tensor]]
                   ) -> torch.nn.Module:
    """``params + param_scale * N(0, I)`` per parameter, on a copy.  ``noise``
    is a generator or one standard-normal tensor per ``params.parameters()``
    entry, in that order."""
    out = copy.deepcopy(params)
    leaves = list(out.parameters())
    if not isinstance(noise, torch.Generator) and len(noise) != len(leaves):
        raise ValueError(f"{len(noise)} noise tensors for {len(leaves)} parameters")
    with torch.no_grad():
        for i, p in enumerate(leaves):
            n = _normal(noise if isinstance(noise, torch.Generator) else noise[i], p)
            p.add_(float(np.float32(a.param_scale)) * n)
    return out


# ---------------------------------------------------------------------------
# continuous-parameter ramp rules
# ---------------------------------------------------------------------------

def _scale_keep(a: Attack, s: float) -> Attack:
    return dataclasses.replace(a, act_keep=1.0 - (1.0 - a.act_keep) * s)


def _scale_grad(a: Attack, s: float) -> Attack:
    return dataclasses.replace(a, grad_scale=1.0 + (a.grad_scale - 1.0) * s)


def _scale_noise(a: Attack, s: float) -> Attack:
    return dataclasses.replace(a, noise_std=a.noise_std * s)


def _scale_param(a: Attack, s: float) -> Attack:
    return dataclasses.replace(a, param_scale=a.param_scale * s)


# ---------------------------------------------------------------------------
# the families
# ---------------------------------------------------------------------------

register(AttackFamily(name=specs.NONE, doc="honest client"))

register(AttackFamily(
    name=specs.LABEL_FLIP, code=CODE_LABEL_FLIP,
    doc="y -> (y + shift) mod n_classes on the transmitted labels",
    static_labels=lambda a, y, n: (y + a.label_shift) % n,
    vec_labels=lambda av, y, n: (y + lane(av.shift, y)) % n,
    lanes=lambda a: dict(shift=a.label_shift),
))


def _act_family(name: str, doc: str) -> AttackFamily:
    return AttackFamily(
        name=name, code=CODE_ACTIVATION, doc=doc,
        static_acts=lambda a, acts, noise: _noise_blend(acts, noise, a.act_keep),
        vec_acts=_noise_blend_vec,
        lanes=lambda a: dict(act_keep=a.act_keep),
        scale=_scale_keep,
    )


register(_act_family(
    specs.ACTIVATION,
    "norm-matched Gaussian blend of the cut-activation message (paper V-A)"))
register(_act_family(
    specs.STEALTH,
    "activation blend with keep near 1 — hovers at the validation-selection "
    "threshold instead of announcing itself"))


def _grad_family(name: str, doc: str) -> AttackFamily:
    return AttackFamily(
        name=name, code=CODE_GRAD_SCALE, doc=doc,
        static_grads=lambda a, g, noise: (float(np.float32(a.grad_scale))
                                          * g.to(torch.float32)).to(g.dtype),
        vec_grads=lambda av, g, noise: (lane(av.grad_scale, g)
                                        * g.to(torch.float32)).to(g.dtype),
        lanes=lambda a: dict(grad_scale=a.grad_scale),
        scale=_scale_grad,
    )


register(_grad_family(
    specs.GRADIENT, "grad_c -> grad_scale * grad_c (paper: -1, sign flip)"))
register(_grad_family(
    specs.GRAD_SCALE, "Byzantine gradient scaling (arbitrary multiplier)"))

register(AttackFamily(
    name=specs.GRAD_NOISE, code=CODE_GRAD_NOISE,
    doc="grad_c += noise_std * N(0, I) on the received cut gradient",
    static_grads=lambda a, g, noise: _grad_noise(g, noise, a.noise_std),
    vec_grads=_grad_noise_vec,
    grads_need_key=True,
    lanes=lambda a: dict(noise_std=a.noise_std),
    scale=_scale_noise,
))

register(AttackFamily(
    name=specs.BACKDOOR, code=CODE_BACKDOOR,
    doc="stamp a trigger patch on the inputs and relabel them to the target",
    static_poison=lambda a, x: _stamp_trigger(x, a.trigger_frac, a.trigger_value),
    static_labels=lambda a, y, n: torch.full_like(y, a.target % n),
    vec_poison=_stamp_trigger_vec,
    vec_labels=lambda av, y, n: lane(av.target % n, y).expand(y.shape).to(y.dtype),
    lanes=lambda a: dict(target=a.target, trig_frac=a.trigger_frac,
                         trig_value=a.trigger_value),
))

register(AttackFamily(
    name=specs.REPLAY, code=CODE_REPLAY,
    doc="replay one captured cut-activation message for the whole batch",
    static_acts=lambda a, acts, noise: _replay_acts(acts),
    vec_acts=lambda av, acts, noise: _replay_acts_vec(acts),
))

register(AttackFamily(
    name=specs.PARAM_TAMPER, trains_honestly=True,
    doc="train honestly, hand off gamma += param_scale * N(0, I) (III-C)",
    static_params=_tamper_params,
    scale=_scale_param,
))
