"""Threat models: who attacks, with what, and when.

A :class:`ThreatModel` maps each malicious client id to a
:class:`ClientThreat` — an (attack, schedule) pair.  It is the single object
the protocol drivers consume; the legacy ``(malicious, attack)`` API is
bridged through :meth:`ThreatModel.from_legacy` (every listed client gets the
same always-on attack), so existing call sites keep working unchanged.

The sequential round asks :meth:`attack_for` per (client, round) and applies
the returned frozen spec through the static hooks of :mod:`.registry`; the
batched round compiles the same specs into an ``AttackVec``
(:meth:`ThreatModel.attack_vec_for_clusters`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, Mapping, Optional, Sequence, Set, Union

from .registry import AttackVec, attack_vec_grid, get, scale_attack
from .schedule import ALWAYS, Schedule
from .specs import HONEST, NONE, Attack


@dataclasses.dataclass(frozen=True)
class ClientThreat:
    attack: Attack
    schedule: Schedule = ALWAYS


def _as_threat(spec: Union["ClientThreat", Attack]) -> ClientThreat:
    if isinstance(spec, ClientThreat):
        return spec
    if isinstance(spec, Attack):
        return ClientThreat(spec)
    raise TypeError(f"expected Attack or ClientThreat, got {type(spec).__name__}")


@dataclasses.dataclass(frozen=True)
class ThreatModel:
    """Immutable client -> (attack, schedule) assignment.

    Construct from a mapping (clients not listed are honest)::

        tm = ThreatModel.build({
            0: Attack(LABEL_FLIP),                            # always on
            2: ClientThreat(Attack(GRAD_SCALE, grad_scale=8.0),
                            every_k(2)),                      # intermittent
        })

    or bridge from the legacy API::

        tm = ThreatModel.from_legacy(malicious={0, 2}, attack=Attack(LABEL_FLIP))
    """
    clients: Mapping[int, ClientThreat] = dataclasses.field(default_factory=dict)
    # Clients counted malicious for honesty accounting even though they mount
    # no message-level attack — the legacy API allowed marking clients
    # malicious while attack=HONEST, and History's selected_honest /
    # honest_cluster_exists bookkeeping must keep honouring that.
    marked_malicious: FrozenSet[int] = frozenset()

    @classmethod
    def build(cls, assignments: Mapping[int, Union[ClientThreat, Attack]],
              schedule: Schedule = ALWAYS) -> "ThreatModel":
        """Normalise a {client: Attack | ClientThreat} mapping; bare Attack
        values get ``schedule`` (default always-on).  HONEST entries drop."""
        out: Dict[int, ClientThreat] = {}
        for client, spec in assignments.items():
            threat = _as_threat(spec)
            if threat.attack.kind == NONE:
                continue
            if threat.schedule is ALWAYS and schedule is not ALWAYS:
                threat = ClientThreat(threat.attack, schedule)
            out[int(client)] = threat
        return cls(out)

    @classmethod
    def from_legacy(cls, malicious: Optional[Set[int]], attack: Attack = HONEST,
                    schedule: Schedule = ALWAYS) -> "ThreatModel":
        """The pre-subsystem API: one shared attack for every malicious id.
        With attack=HONEST the listed clients mount nothing but stay in the
        ``malicious`` accounting set, exactly as the legacy drivers did."""
        if not malicious:
            return cls({})
        if attack.kind == NONE:
            return cls({}, marked_malicious=frozenset(int(c) for c in malicious))
        return cls({int(c): ClientThreat(attack, schedule) for c in malicious})

    # -- bookkeeping --------------------------------------------------------

    @property
    def malicious(self) -> FrozenSet[int]:
        """All clients with an assigned attack (regardless of schedule phase)
        plus any marked-malicious ids — the paper's (static) malicious set,
        used for honesty accounting."""
        return frozenset(self.clients) | self.marked_malicious

    @property
    def has_param_tamper(self) -> bool:
        return any(get(t.attack.kind).trains_honestly
                   for t in self.clients.values())

    def describe(self) -> Dict[str, Dict[str, object]]:
        """JSON-friendly manifest (benchmark provenance)."""
        return {str(c): dict(attack=dataclasses.asdict(t.attack),
                             schedule=dataclasses.asdict(t.schedule))
                for c, t in sorted(self.clients.items())}

    # -- per-round attack state --------------------------------------------

    def attack_for(self, client: int, t: int) -> Attack:
        """The *training-phase* spec for one (client, round): HONEST for
        honest clients, schedule-inactive rounds and host-side families
        (param tamperers train honestly, Section III-C); otherwise the
        schedule-strength-scaled spec."""
        threat = self.clients.get(client)
        if threat is None or get(threat.attack.kind).trains_honestly:
            return HONEST
        return scale_attack(threat.attack, threat.schedule.strength(t))

    def param_attack_for(self, client: int, t: int) -> Optional[Attack]:
        """The handoff-tampering spec for one (client, round), or None —
        consumed host-side by the selection loop, never compiled."""
        threat = self.clients.get(client)
        if threat is None or not get(threat.attack.kind).trains_honestly:
            return None
        a = scale_attack(threat.attack, threat.schedule.strength(t))
        return None if a.kind == NONE else a

    def attack_vec_for_clusters(self, clusters: Sequence[Sequence[int]],
                                t: int) -> AttackVec:
        """(R, M_bar)-laned AttackVec for round t's cluster partition,
        compiled from exactly the specs ``attack_for`` hands the sequential
        engine."""
        return attack_vec_grid([[self.attack_for(c, t) for c in cluster]
                                for cluster in clusters])


def resolve_threat_model(malicious: Optional[Set[int]], attack: Attack,
                         threat_model: Optional[ThreatModel]) -> ThreatModel:
    """Protocol-driver argument resolution: either the legacy
    ``(malicious, attack)`` pair or an explicit ``threat_model``, not both."""
    if threat_model is not None:
        if malicious or attack.kind != NONE:
            raise ValueError("pass either threat_model or the legacy "
                             "(malicious, attack) pair, not both")
        return threat_model
    return ThreatModel.from_legacy(malicious, attack)
