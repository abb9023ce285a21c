"""Pluggable adversary subsystem: registry-based attack families
(``families``), round-indexed schedules (``schedule``) and per-client threat
models (``threat_model``), in their static (per-``Attack``) form and
compiled into ``AttackVec`` lanes for the batched round."""
from . import families as _families  # noqa: F401  (populates the registry)
from .registry import (AttackFamily, AttackVec, attack_vec, attack_vec_grid,
                       families, flip_labels, flip_labels_vec, get,
                       poison_inputs, poison_inputs_vec, register,
                       scale_attack, tamper_activation, tamper_activation_vec,
                       tamper_gradient, tamper_gradient_vec, tamper_params)
from .schedule import (ALWAYS, SCHEDULE_KINDS, Schedule, after_warmup,
                       every_k, ramp)
from .specs import (ACTIVATION, BACKDOOR, GRAD_NOISE, GRAD_SCALE, GRADIENT,
                    HONEST, KINDS, LABEL_FLIP, NONE, PARAM_TAMPER, REPLAY,
                    STEALTH, Attack, stealth)
from .threat_model import ClientThreat, ThreatModel, resolve_threat_model

__all__ = [
    "Attack", "HONEST", "stealth", "KINDS",
    "NONE", "LABEL_FLIP", "ACTIVATION", "GRADIENT", "PARAM_TAMPER",
    "BACKDOOR", "GRAD_SCALE", "GRAD_NOISE", "REPLAY", "STEALTH",
    "Schedule", "SCHEDULE_KINDS", "ALWAYS", "every_k", "after_warmup", "ramp",
    "ClientThreat", "ThreatModel", "resolve_threat_model",
    "AttackFamily", "register", "get", "families", "scale_attack",
    "poison_inputs", "flip_labels", "tamper_activation", "tamper_gradient",
    "tamper_params", "AttackVec", "attack_vec", "attack_vec_grid",
    "poison_inputs_vec", "flip_labels_vec", "tamper_activation_vec",
    "tamper_gradient_vec",
]
