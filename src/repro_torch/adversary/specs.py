"""Attack specifications: the frozen, hashable description of what a
malicious client does.

An :class:`Attack` names a *family* (see ``repro.adversary.families``) plus
the family's parameters.  It is deliberately a single flat frozen dataclass —
hashable, so the sequential oracle can use it as a static jit argument (one
compiled program per distinct spec), and trivially serialisable for benchmark
manifests.  Parameters a family does not use are simply ignored by its
registry entry.

Families
--------
The paper's three message-level attacks (Section II / V-A) plus Section
III-C's parameter tampering:

  * ``label_flip``    y -> (y + label_shift) mod n_classes
  * ``activation``    g -> act_keep * g + (1 - act_keep) * n~   (norm-matched noise)
  * ``gradient``      grad_c -> grad_scale * grad_c             (paper: -1, sign flip)
  * ``param_tamper``  handed-off gamma += param_scale * N(0, I) (trains honestly)

and the extended threat catalogue (arXiv:2505.05872 taxonomy):

  * ``backdoor``      stamp a trigger patch on the inputs, relabel to ``target``
  * ``grad_scale``    Byzantine gradient scaling (same kernel as ``gradient``;
                      a separate name so sweeps can distinguish sign-flip from
                      amplification)
  * ``grad_noise``    grad_c += noise_std * N(0, I)
  * ``replay``        re-transmit one captured cut-activation message for the
                      whole batch (stale/replayed activations)
  * ``stealth``       the activation blend with act_keep near 1, tuned to
                      hover near the validation-selection threshold (use the
                      :func:`stealth` constructor)
"""
from __future__ import annotations

import dataclasses

# -- family names -----------------------------------------------------------
NONE = "none"
LABEL_FLIP = "label_flip"
ACTIVATION = "activation"
GRADIENT = "gradient"
PARAM_TAMPER = "param_tamper"       # Section III-C: tampering the handed-off params
BACKDOOR = "backdoor"
GRAD_SCALE = "grad_scale"
GRAD_NOISE = "grad_noise"
REPLAY = "replay"
STEALTH = "stealth"

KINDS = (NONE, LABEL_FLIP, ACTIVATION, GRADIENT, PARAM_TAMPER,
         BACKDOOR, GRAD_SCALE, GRAD_NOISE, REPLAY, STEALTH)


@dataclasses.dataclass(frozen=True)
class Attack:
    kind: str = NONE
    label_shift: int = 3             # label_flip: shift amount
    act_keep: float = 0.1            # activation/stealth: fraction of the true activation kept
    param_scale: float = 5.0         # param_tamper: noise multiplier on handoff
    grad_scale: float = -1.0         # gradient/grad_scale: cut-gradient multiplier
    noise_std: float = 1.0           # grad_noise: Gaussian std added to the cut gradient
    target: int = 0                  # backdoor: the targeted label
    trigger_frac: float = 0.05       # backdoor: fraction of input features the trigger stamps
    trigger_value: float = 2.0       # backdoor: the stamped value

    def __post_init__(self):
        assert self.kind in KINDS, self.kind


HONEST = Attack(NONE)


def stealth(keep: float = 0.97) -> Attack:
    """The strength-parameterised stealth variant: an activation blend that
    keeps ``keep`` of the true message, perturbing the cluster's validation
    loss just enough to sometimes slip past argmin selection (``keep`` near 1
    hovers near the selection threshold; the plain ``activation`` family's
    default 0.1 is the loud version)."""
    return Attack(STEALTH, act_keep=keep)
