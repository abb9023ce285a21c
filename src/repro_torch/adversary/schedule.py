"""Round-indexed attack schedules.

A :class:`Schedule` maps the global round index t to an activation *strength*
in [0, 1] — 0 means the client behaves honestly this round, 1 means the full
attack, and fractional values interpolate the attack's continuous parameters
toward honest (see each family's ``scale`` rule in
``repro.adversary.families``).  Schedules are frozen data: the protocol
evaluates them on the host each round and folds the result into the
:class:`~repro.adversary.registry.AttackVec` parameter lanes, so the batched
engine's compiled round program never changes shape — one compile serves
every schedule.

Four kinds (the intermittent/adaptive adversaries of arXiv:2505.05872 and
arXiv:2212.01716 that a static always-on harness never exercises):

  * ``always``   active every round (the legacy behaviour)
  * ``every_k``  active on rounds t with (t - offset) % k == 0 and t >= offset
  * ``warmup``   off until round ``start``, then always on (on/off flips with
                 ``stop`` to model an attacker that goes quiet again)
  * ``ramp``     strength grows linearly from 0 over ``ramp_rounds`` rounds
                 starting at ``start``
"""
from __future__ import annotations

import dataclasses

ALWAYS_KIND = "always"
EVERY_K_KIND = "every_k"
WARMUP_KIND = "warmup"
RAMP_KIND = "ramp"

SCHEDULE_KINDS = (ALWAYS_KIND, EVERY_K_KIND, WARMUP_KIND, RAMP_KIND)


@dataclasses.dataclass(frozen=True)
class Schedule:
    kind: str = ALWAYS_KIND
    k: int = 2                # every_k: period
    offset: int = 0           # every_k: phase (first active round)
    start: int = 0            # warmup/ramp: first (partially) active round
    stop: int = -1            # warmup: first round the attack goes quiet again (-1 = never)
    ramp_rounds: int = 5      # ramp: rounds to reach full strength

    def __post_init__(self):
        assert self.kind in SCHEDULE_KINDS, self.kind
        assert self.k >= 1 and self.ramp_rounds >= 1

    def strength(self, t: int) -> float:
        """Attack strength in [0, 1] at global round t (host-side, exact)."""
        if self.kind == ALWAYS_KIND:
            return 1.0
        if self.kind == EVERY_K_KIND:
            return 1.0 if t >= self.offset and (t - self.offset) % self.k == 0 else 0.0
        if self.kind == WARMUP_KIND:
            on = t >= self.start and (self.stop < 0 or t < self.stop)
            return 1.0 if on else 0.0
        # ramp
        if t < self.start:
            return 0.0
        return min(1.0, (t - self.start + 1) / self.ramp_rounds)

    def active(self, t: int) -> bool:
        return self.strength(t) > 0.0


ALWAYS = Schedule()


def every_k(k: int, offset: int = 0) -> Schedule:
    """Intermittent attacker: strikes every k-th round (phase ``offset``)."""
    return Schedule(EVERY_K_KIND, k=k, offset=offset)


def after_warmup(start: int, stop: int = -1) -> Schedule:
    """Sleeper attacker: honest during warmup, on from round ``start``
    (optionally quiet again from ``stop``)."""
    return Schedule(WARMUP_KIND, start=start, stop=stop)


def ramp(ramp_rounds: int, start: int = 0) -> Schedule:
    """Escalating attacker: strength climbs linearly to 1 over
    ``ramp_rounds`` rounds."""
    return Schedule(RAMP_KIND, ramp_rounds=ramp_rounds, start=start)
