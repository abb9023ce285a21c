"""Built-in attack families (static hooks).

Importing this module populates ``repro_torch.adversary.registry.REGISTRY``.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Sequence, Union

import numpy as np
import torch

from . import specs
from .registry import AttackFamily, register
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

def _noise_blend(acts: torch.Tensor, noise: Noise, keep: float) -> torch.Tensor:
    """Keep a ``keep`` fraction of the true cut activation and replace the
    rest with Gaussian noise norm-matched per sample (leading axis = batch).
    ``keep`` and ``1 - keep`` are rounded to f32 first, as the reference
    computes them."""
    keep32 = np.float32(keep)
    rest32 = np.float32(1.0) - keep32
    n = _normal(noise, acts)
    a = acts.to(torch.float32)
    dims = tuple(range(1, acts.dim()))
    g_norm = torch.sqrt(torch.sum(torch.square(a), dim=dims, keepdim=True))
    n_norm = torch.sqrt(torch.sum(torch.square(n), dim=dims, keepdim=True))
    n_scaled = n * (g_norm / torch.clamp_min(n_norm, 1e-12))
    out = float(keep32) * a + float(rest32) * n_scaled
    return out.to(acts.dtype)


def _replay_acts(acts: torch.Tensor) -> torch.Tensor:
    """Stale/replay: re-transmit the first sample's captured cut-activation
    message for every sample of the batch."""
    return acts[:1].expand(acts.shape).contiguous()


def _stamp_trigger(x: torch.Tensor, frac: float, value: float) -> torch.Tensor:
    """Backdoor trigger: overwrite the first ``round(frac * d)`` features of
    each flattened sample with ``value``."""
    flat = x.reshape(x.shape[0], -1).clone()
    d = flat.shape[1]
    k = max(1, int(np.round(np.float32(frac) * np.float32(d))))
    flat[:, :k] = float(np.float32(value))
    return flat.reshape(x.shape)


def _grad_noise(g: torch.Tensor, noise: Noise, std: float) -> torch.Tensor:
    return (g.to(torch.float32)
            + float(np.float32(std)) * _normal(noise, g)).to(g.dtype)


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
    name=specs.LABEL_FLIP,
    doc="y -> (y + shift) mod n_classes on the transmitted labels",
    static_labels=lambda a, y, n: (y + a.label_shift) % n,
))


def _act_family(name: str, doc: str) -> AttackFamily:
    return AttackFamily(
        name=name, doc=doc,
        static_acts=lambda a, acts, noise: _noise_blend(acts, noise, a.act_keep),
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
        name=name, doc=doc,
        static_grads=lambda a, g, noise: (float(np.float32(a.grad_scale))
                                          * g.to(torch.float32)).to(g.dtype),
        scale=_scale_grad,
    )


register(_grad_family(
    specs.GRADIENT, "grad_c -> grad_scale * grad_c (paper: -1, sign flip)"))
register(_grad_family(
    specs.GRAD_SCALE, "Byzantine gradient scaling (arbitrary multiplier)"))

register(AttackFamily(
    name=specs.GRAD_NOISE,
    doc="grad_c += noise_std * N(0, I) on the received cut gradient",
    static_grads=lambda a, g, noise: _grad_noise(g, noise, a.noise_std),
    scale=_scale_noise,
))

register(AttackFamily(
    name=specs.BACKDOOR,
    doc="stamp a trigger patch on the inputs and relabel them to the target",
    static_poison=lambda a, x: _stamp_trigger(x, a.trigger_frac, a.trigger_value),
    static_labels=lambda a, y, n: torch.full_like(y, a.target % n),
))

register(AttackFamily(
    name=specs.REPLAY,
    doc="replay one captured cut-activation message for the whole batch",
    static_acts=lambda a, acts, noise: _replay_acts(acts),
))

register(AttackFamily(
    name=specs.PARAM_TAMPER, trains_honestly=True,
    doc="train honestly, hand off gamma += param_scale * N(0, I) (III-C)",
    static_params=_tamper_params,
    scale=_scale_param,
))
