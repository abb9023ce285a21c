"""The attack-family registry and the static (per-``Attack``) hooks.

Each registered :class:`AttackFamily` declares one hook per tampering point
of the SL message exchange (``repro_torch.core.split._sl_exchange``):

  * ``poison``  — the client's own training inputs, before the forward pass
  * ``labels``  — the label message sent to the AP
  * ``acts``    — the cut-activation message sent to the AP
  * ``grads``   — the cut-gradient message received from the AP

plus the host-side ``params`` hook for handoff tampering (Section III-C).

Stochastic hooks take ``noise``: a ``torch.Generator`` on the message's
device to draw from, or the already-drawn standard-normal noise (a tensor of
the message's shape; for ``params``, one tensor per parameter), so a test can
hand the reference's draw to both implementations.  The vectorised
``AttackVec`` form the batched round needs is not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from .specs import Attack, HONEST


@dataclasses.dataclass(frozen=True)
class AttackFamily:
    """One attack family's static hooks.  ``scale`` interpolates the spec
    toward honest for fractional schedule strengths (continuous families
    only); ``trains_honestly`` marks host-side families (param_tamper) whose
    training-phase behaviour is honest."""
    name: str
    doc: str = ""
    static_poison: Optional[Callable] = None   # (attack, x) -> x
    static_labels: Optional[Callable] = None   # (attack, y, n_classes) -> y
    static_acts: Optional[Callable] = None     # (attack, acts, noise) -> acts
    static_grads: Optional[Callable] = None    # (attack, g, noise) -> g
    static_params: Optional[Callable] = None   # (attack, module, noise) -> module
    scale: Callable[[Attack, float], Attack] = lambda a, s: a
    trains_honestly: bool = False


REGISTRY: Dict[str, AttackFamily] = {}


def register(family: AttackFamily) -> AttackFamily:
    if family.name in REGISTRY:
        raise ValueError(f"duplicate attack family {family.name}")
    REGISTRY[family.name] = family
    return family


def get(kind: str) -> AttackFamily:
    try:
        return REGISTRY[kind]
    except KeyError:
        raise KeyError(f"unknown attack family {kind!r}; registered: "
                       f"{sorted(REGISTRY)}") from None


def families() -> Dict[str, AttackFamily]:
    return dict(REGISTRY)


def scale_attack(attack: Attack, s: float) -> Attack:
    """Schedule-strength interpolation toward honest.  s >= 1 returns the
    spec unchanged; s <= 0 is fully honest; fractional s delegates to the
    family's ``scale`` rule."""
    if s >= 1.0:
        return attack
    if s <= 0.0:
        return HONEST
    return get(attack.kind).scale(attack, s)


def poison_inputs(attack: Attack, x: torch.Tensor) -> torch.Tensor:
    hook = get(attack.kind).static_poison
    return hook(attack, x) if hook else x


def flip_labels(attack: Attack, y: torch.Tensor, n_classes: int) -> torch.Tensor:
    hook = get(attack.kind).static_labels
    return hook(attack, y, n_classes) if hook else y


def tamper_activation(attack: Attack, acts: torch.Tensor, noise=None) -> torch.Tensor:
    hook = get(attack.kind).static_acts
    return hook(attack, acts, noise) if hook else acts


def tamper_gradient(attack: Attack, g: torch.Tensor, noise=None) -> torch.Tensor:
    hook = get(attack.kind).static_grads
    return hook(attack, g, noise) if hook else g


def tamper_params(attack: Attack, params: torch.nn.Module, noise) -> torch.nn.Module:
    """Section III-C: the malicious *last* client of the selected cluster
    hands off manipulated client-side parameters to the next round.  Returns
    a new module; ``params`` is left as it was."""
    hook = get(attack.kind).static_params
    return hook(attack, params, noise) if hook else params


__all__ = ["AttackFamily", "REGISTRY", "families", "flip_labels", "get",
           "poison_inputs", "register", "scale_attack", "tamper_activation",
           "tamper_gradient", "tamper_params"]
