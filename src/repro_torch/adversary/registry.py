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
hand the reference's draw to both implementations.

The batched round compiles a round's per-slot specs into an
:class:`AttackVec`: a kind code and parameter lanes per (cluster, client)
slot.  The ``*_vec`` dispatchers take one client position's lanes, ``(R,)``
tensors, and a cluster-stacked message ``(R, B, ...)``; each registered
family's arithmetic applies where the slot's code selects it
(``torch.where``), so honest slots pass the message through bit for bit.
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Callable, Dict, Optional, Sequence, Union

import numpy as np
import torch

from .specs import Attack, HONEST

# -- vec kind codes (0 = honest / no message-level effect) ------------------
CODE_NONE = 0
CODE_LABEL_FLIP = 1
CODE_ACTIVATION = 2
CODE_GRAD_SCALE = 3
CODE_GRAD_NOISE = 4
CODE_BACKDOOR = 5
CODE_REPLAY = 6

LANES = ("code", "shift", "act_keep", "grad_scale", "noise_std", "target",
         "trig_frac", "trig_value")
_LANE_DEFAULTS = dict(code=0, shift=0, act_keep=1.0, grad_scale=1.0,
                      noise_std=0.0, target=0, trig_frac=0.0, trig_value=0.0)
_LANE_DTYPES = dict(code=np.int32, shift=np.int32, act_keep=np.float32,
                    grad_scale=np.float32, noise_std=np.float32,
                    target=np.int32, trig_frac=np.float32,
                    trig_value=np.float32)


@dataclasses.dataclass(frozen=True)
class AttackVec:
    """Per-slot attack state: every lane carries the same leading axes —
    ``(R, M_bar)`` for a round, ``(R,)`` for one client position.
    ``host_code`` is the host's copy of ``code``: it decides which family
    kernels run and which slots draw noise, so the device lanes are never
    read back."""
    code: torch.Tensor        # int32  — vec kind code (CODE_*)
    shift: torch.Tensor       # int32  — label-flip shift
    act_keep: torch.Tensor    # float32 — activation/stealth keep fraction
    grad_scale: torch.Tensor  # float32 — cut-gradient multiplier
    noise_std: torch.Tensor   # float32 — cut-gradient Gaussian std
    target: torch.Tensor      # int32  — backdoor target label
    trig_frac: torch.Tensor   # float32 — backdoor trigger size (input fraction)
    trig_value: torch.Tensor  # float32 — backdoor trigger stamp value
    host_code: np.ndarray

    def _map(self, fn, host_fn) -> "AttackVec":
        return AttackVec(**{name: fn(getattr(self, name)) for name in LANES},
                         host_code=host_fn(self.host_code))

    def to(self, device, non_blocking: bool = False) -> "AttackVec":
        return self._map(lambda a: a.to(device, non_blocking=non_blocking), lambda h: h)

    def client(self, j: int) -> "AttackVec":
        """The ``(R,)`` lanes of client position ``j`` of every cluster."""
        return self._map(lambda a: a[:, j], lambda h: h[:, j])

    def rows(self, index: slice) -> "AttackVec":
        """The lanes of rows ``index`` of the leading axis (views): a
        rank's clusters of a round."""
        return self._map(lambda a: a[index], lambda h: h[index])

    def block(self, n_lanes: int, lanes: slice, clusters: slice) -> "AttackVec":
        """The lanes of replicas ``lanes`` x clusters ``clusters`` of an
        ``(L * R, ...)`` replica grid (``L = n_lanes``, replica-major), in
        the same order: a rank's block of the sweep's or the pool's grid,
        cut on the lanes' device (no index crosses from the host)."""
        def cut(a):
            grid = a.reshape((n_lanes, -1) + tuple(a.shape[1:]))[lanes, clusters]
            return grid.reshape((-1,) + tuple(a.shape[1:]))
        return self._map(cut, cut)

    def flat(self) -> "AttackVec":
        """The ``(R * M_bar,)`` lanes of a round's grid, cluster-major: one
        lane a client (SplitFed trains every client at once)."""
        return self._map(lambda a: a.reshape(-1), lambda h: h.reshape(-1))

    @staticmethod
    def cat(avecs: Sequence["AttackVec"]) -> "AttackVec":
        """L round grids, each ``(R, M_bar)``, as one ``(L * R, M_bar)``
        grid, replica-major: the lanes of the replica form (the sweep's
        seeds, the pool's jobs) in one stacked round."""
        return AttackVec(**{name: torch.cat([getattr(a, name) for a in avecs])
                            for name in LANES},
                         host_code=np.concatenate([a.host_code for a in avecs]))


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
    code: int = CODE_NONE
    vec_poison: Optional[Callable] = None      # (av, x) -> x
    vec_labels: Optional[Callable] = None      # (av, y, n_classes) -> y
    vec_acts: Optional[Callable] = None        # (av, acts, noise) -> acts
    vec_grads: Optional[Callable] = None       # (av, g, noise) -> g
    grads_need_key: bool = False               # vec_grads draws noise
    lanes: Callable[[Attack], Dict[str, float]] = lambda a: {}
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


# ---------------------------------------------------------------------------
# vectorised dispatchers: torch.where chains over the registered kind codes
# ---------------------------------------------------------------------------

#: the noise of a vec stage: one generator per slot (None where the slot
#: draws nothing), or the standard-normal draws themselves, ``(R, ...)``
VecNoise = Union[Sequence[Optional[torch.Generator]], torch.Tensor, None]


def _vec_stage(stage: str, av: AttackVec, skip_keyed: bool = False):
    """Unique (code, kernel) pairs for one tampering point, in code order,
    restricted to the codes some slot of ``av`` carries.  Families sharing a
    code (stealth compiles onto the activation kernel) contribute it once."""
    present = set(np.unique(av.host_code).tolist())
    seen: Dict[int, Callable] = {}
    for fam in REGISTRY.values():
        fn = getattr(fam, stage)
        if skip_keyed and fam.grads_need_key:
            continue
        if fam.code and fn is not None and fam.code in present \
                and fam.code not in seen:
            seen[fam.code] = fn
    return sorted(seen.items())


def lane(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """An ``(R,)`` lane shaped to broadcast over an ``(R, ...)`` message."""
    return x.reshape((-1,) + (1,) * (like.dim() - 1))


def _where(av: AttackVec, code: int, new: torch.Tensor, old: torch.Tensor):
    return torch.where(lane(av.code == code, old), new, old)


def slot_noise(av: AttackVec, code: int, noise: VecNoise,
               like: torch.Tensor) -> torch.Tensor:
    """Standard-normal noise of ``like``'s shape for the slots whose code is
    ``code``, each from its own generator (zeros elsewhere: those slots keep
    their message, and their generators draw nothing)."""
    if isinstance(noise, torch.Tensor):
        if tuple(noise.shape) != tuple(like.shape):
            raise ValueError(f"noise of shape {tuple(noise.shape)} for a "
                             f"message of shape {tuple(like.shape)}")
        return noise.to(device=like.device, dtype=torch.float32)
    if noise is None:
        raise ValueError("this attack family draws noise: pass one generator "
                         "per slot or the noise tensor")
    rows = []
    for r, c in enumerate(av.host_code.tolist()):
        if c == code:
            rows.append(torch.randn(like.shape[1:], generator=noise[r],
                                    dtype=torch.float32, device=like.device))
        else:
            rows.append(torch.zeros(like.shape[1:], dtype=torch.float32,
                                    device=like.device))
    return torch.stack(rows)


def poison_inputs_vec(av: AttackVec, x: torch.Tensor) -> torch.Tensor:
    out = x
    for code, fn in _vec_stage("vec_poison", av):
        out = _where(av, code, fn(av, x), out)
    return out


def flip_labels_vec(av: AttackVec, y: torch.Tensor, n_classes: int) -> torch.Tensor:
    out = y
    for code, fn in _vec_stage("vec_labels", av):
        out = _where(av, code, fn(av, y, n_classes), out)
    return out


def tamper_activation_vec(av: AttackVec, acts: torch.Tensor,
                          noise: VecNoise = None) -> torch.Tensor:
    out = acts
    for code, fn in _vec_stage("vec_acts", av):
        out = _where(av, code, fn(av, acts, noise), out)
    return out


def tamper_gradient_vec(av: AttackVec, g: torch.Tensor,
                        noise: VecNoise = None) -> torch.Tensor:
    """Without ``noise`` the stochastic gradient kernels are skipped, as the
    reference skips them without a key; the engines always pass it."""
    out = g
    for code, fn in _vec_stage("vec_grads", av, skip_keyed=noise is None):
        out = _where(av, code, fn(av, g, noise), out)
    return out


# ---------------------------------------------------------------------------
# AttackVec compilation
# ---------------------------------------------------------------------------

def _slot_lanes(attack: Attack) -> Dict[str, float]:
    lanes = dict(_LANE_DEFAULTS)
    fam = get(attack.kind)
    if fam.code and not fam.trains_honestly:
        lanes["code"] = fam.code
        lanes.update(fam.lanes(attack))
    return lanes


def _compile(slots) -> AttackVec:
    arrays = {name: np.array([[s[name] for s in row] for row in slots],
                             dtype=_LANE_DTYPES[name]) for name in LANES}
    return AttackVec(**{name: torch.from_numpy(a) for name, a in arrays.items()},
                     host_code=arrays["code"])


@lru_cache(maxsize=512)
def _attack_vec_grid_cached(grid: tuple) -> AttackVec:
    return _compile([[_slot_lanes(a) for a in row] for row in grid])


def attack_vec_grid(grid: Sequence[Sequence[Attack]]) -> AttackVec:
    """Compile an (R, M_bar) grid of per-slot specs (already
    schedule-scaled; HONEST for honest slots) into one CPU AttackVec,
    memoised on the grid: a static population derives the same grid every
    round.  The caller moves it to the device with the round's batches."""
    return _attack_vec_grid_cached(tuple(tuple(row) for row in grid))


def attack_vec(attack: Attack, active) -> AttackVec:
    """Per-slot attack state for a single spec.  ``active`` is a bool or a
    bool array (one leading axis per slot axis); param-tampering clients
    train honestly (Section III-C), so host-side families raise no code."""
    on = np.atleast_1d(np.asarray(active, bool))
    a_lanes, h_lanes = _slot_lanes(attack), _slot_lanes(HONEST)
    arrays = {name: np.where(on, a_lanes[name], h_lanes[name])
              .astype(_LANE_DTYPES[name]) for name in LANES}
    return AttackVec(**{name: torch.from_numpy(a) for name, a in arrays.items()},
                     host_code=arrays["code"])


__all__ = ["AttackFamily", "AttackVec", "CODE_ACTIVATION", "CODE_BACKDOOR",
           "CODE_GRAD_NOISE", "CODE_GRAD_SCALE", "CODE_LABEL_FLIP",
           "CODE_NONE", "CODE_REPLAY", "LANES", "REGISTRY", "attack_vec",
           "attack_vec_grid", "families", "flip_labels", "flip_labels_vec",
           "get", "lane", "poison_inputs", "poison_inputs_vec", "register",
           "scale_attack", "slot_noise", "tamper_activation",
           "tamper_activation_vec", "tamper_gradient", "tamper_gradient_vec",
           "tamper_params"]
