"""Pluggable adversary subsystem: registry-based attack families
(``families``), round-indexed schedules (``schedule``) and per-client threat
models (``threat_model``), in their static (per-``Attack``) form."""
from . import families as _families  # noqa: F401  (populates the registry)
from .registry import (AttackFamily, families, flip_labels, get,
                       poison_inputs, register, scale_attack,
                       tamper_activation, tamper_gradient, tamper_params)
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
    "tamper_params",
]
