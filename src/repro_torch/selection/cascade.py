"""The masked on-device acceptance cascade (rank -> verify -> commit).

Section III-C's selection loop — order the clusters by score, walk the
candidates in that order, discard any whose handoff fails the tamper check,
commit the first survivor or roll back to theta^t — as tensor arithmetic on
the device: ranks are data (a stable ``argsort``), rejection is a mask, and
the only host interaction is the round's single fetch of
``(val_losses, train_summary, selected, detections, accepted)``.  Nothing
here branches in Python on a device value, so the cascade costs no host
sync.

The decisions match the host selector (``repro_torch.selection.selector``):

  * candidates are visited in ascending masked-score order (ineligible
    clusters sort last via +inf and are never visited);
  * ``detections`` counts the visited candidates that failed verification
    before the accepted one — R_eligible when nothing survives;
  * ``accepted`` is False only when every eligible candidate fails; then
    ``selected`` still reports the rank-0 candidate for History's honesty
    bookkeeping while the commit keeps theta^t.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

# fetch layout: [vlosses (R,), train_summary (R,), selected, detections,
# accepted] — one f32 vector, one host sync per round.
N_FETCH_TAIL = 3


def masked_first_accept(scores: torch.Tensor, eligible: torch.Tensor,
                        passed: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(selected int64, detections int64, accepted bool), all 0-d device
    tensors, of the rank/verify/commit walk.

    ``scores``: (R,) f32, lower = better.  ``eligible``: (R,) bool policy
    mask (all-False falls back to all-True).  ``passed``: (R,) bool
    per-candidate verification verdicts (all-True when verification is
    off)."""
    eligible = torch.where(eligible.any(), eligible, torch.ones_like(eligible))
    masked = torch.where(eligible, scores.to(torch.float32), float("inf"))
    ranks = torch.argsort(masked, stable=True)        # stable: ties keep index order
    ok = torch.gather((passed & eligible).to(torch.int32), 0, ranks)
    first = torch.argmax(ok)                          # the first 1; 0 when none
    accepted = ok.any()
    selected = torch.gather(ranks, 0, torch.where(accepted, first, 0).reshape(1))[0]
    detections = torch.where(accepted, first, eligible.sum())
    return selected, detections, accepted


def pack_fetch(vlosses: torch.Tensor, train_summary: torch.Tensor,
               selected: torch.Tensor, detections: torch.Tensor,
               accepted: torch.Tensor) -> torch.Tensor:
    """Stack the round's host-visible outcome into one (2R + 3,) f32 vector
    so the drivers pay exactly one device->host copy per round."""
    tail = torch.stack([selected.to(torch.float32), detections.to(torch.float32),
                        accepted.to(torch.float32)])
    return torch.cat([vlosses.to(torch.float32), train_summary.to(torch.float32),
                      tail])


def unpack_fetch(fetched: np.ndarray, r: int):
    """Host-side view of :func:`pack_fetch` (``fetched`` a numpy array):
    (vlosses, train_summary, selected, detections, accepted)."""
    if fetched.shape[-1] != 2 * r + N_FETCH_TAIL:
        raise ValueError(f"fetch of length {fetched.shape[-1]} for R={r}")
    return (fetched[:r], fetched[r:2 * r], int(fetched[2 * r]),
            int(fetched[2 * r + 1]), bool(fetched[2 * r + 2]))


__all__ = ["N_FETCH_TAIL", "masked_first_accept", "pack_fetch", "unpack_fetch"]
