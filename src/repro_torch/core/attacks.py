"""The reference's ``core/attacks.py`` import surface over
:mod:`repro_torch.adversary`, where the attack families, schedules, threat
models and ``AttackVec`` lanes live; also the legacy
``attack_vec_for_clusters(attack, clusters, malicious)`` helper."""
from __future__ import annotations

from typing import Sequence, Set

from ..adversary import (ACTIVATION, BACKDOOR, GRAD_NOISE, GRAD_SCALE, GRADIENT, HONEST,
                         KINDS, LABEL_FLIP, NONE, PARAM_TAMPER, REPLAY, STEALTH, Attack,
                         AttackVec, attack_vec, attack_vec_grid, flip_labels,
                         flip_labels_vec, poison_inputs, poison_inputs_vec, stealth,
                         tamper_activation, tamper_activation_vec, tamper_gradient,
                         tamper_gradient_vec, tamper_params)
from ..adversary.threat_model import ThreatModel

__all__ = [
    "NONE", "LABEL_FLIP", "ACTIVATION", "GRADIENT", "PARAM_TAMPER",
    "BACKDOOR", "GRAD_SCALE", "GRAD_NOISE", "REPLAY", "STEALTH", "KINDS",
    "Attack", "HONEST", "stealth", "AttackVec", "attack_vec",
    "attack_vec_grid", "attack_vec_for_clusters",
    "poison_inputs", "flip_labels", "tamper_activation", "tamper_gradient",
    "tamper_params", "poison_inputs_vec", "flip_labels_vec",
    "tamper_activation_vec", "tamper_gradient_vec",
]


def attack_vec_for_clusters(attack: Attack, clusters: Sequence[Sequence[int]],
                            malicious: Set[int]) -> AttackVec:
    """The (R, M_bar)-laned AttackVec of one round's partition for a
    homogeneous population (the always-on schedule)."""
    return ThreatModel.from_legacy(set(malicious), attack) \
        .attack_vec_for_clusters(clusters, 0)
