"""Host-side selector: the Section III-C acceptance loop.

Rank the R candidate clusters by the policy's score, visit them in order,
tamper-check each handoff (the visited candidate's last client may tamper
the parameters it hands off), and commit the first survivor; when every
candidate fails, keep theta^t.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .policies import ScoreContext, SelectionPolicy


@dataclasses.dataclass
class SelectionOutcome:
    """One round's acceptance verdict."""
    selected: int
    accepted: bool
    detections: int
    theta: Tuple[nn.Module, nn.Module]
    scores: np.ndarray


def host_score_context(policy: SelectionPolicy,
                       results: List[Dict[str, Any]]) -> ScoreContext:
    """The policy's features from the round's results: ``vloss`` always,
    ``msg_stats`` when the round was trained with message statistics."""
    vlosses = torch.from_numpy(np.asarray([res["vloss"] for res in results],
                                          dtype=np.float32))
    message_stats = None
    if policy.needs_message_stats:
        message_stats = torch.from_numpy(np.stack(
            [np.asarray(res["msg_stats"], dtype=np.float32) for res in results]))
    return ScoreContext(vlosses=vlosses, message_stats=message_stats)


def score_and_rank(policy: SelectionPolicy, ctx: ScoreContext
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(scores, eligibility, visit order).  The scores are cast to float64
    and ranked with ``np.argsort``, as the reference does, so ties resolve
    the same way."""
    scores = np.asarray(policy.score(ctx).cpu().numpy(), dtype=np.float64)
    elig = np.asarray(policy.eligible(
        ctx, torch.from_numpy(scores.astype(np.float32))).cpu().numpy())
    if not elig.any():
        elig = np.ones_like(elig)
    order = np.argsort(scores)
    return scores, elig, order


def select_host(policy: SelectionPolicy, module, results: List[Dict[str, Any]],
                theta: Tuple[nn.Module, nn.Module], tm, t: int,
                gen: Optional[torch.Generator], pcfg, meter, x0: torch.Tensor,
                d_c: int) -> SelectionOutcome:
    """The reference cascade.  ``gen`` draws the handoff-tampering noise of
    a visited candidate whose last client tampers.  Mutates ``meter`` with
    the per-visit re-transmission accounting (Table I's 2R*D_o validation
    term)."""
    from ..adversary import tamper_params
    from ..core.protocol import account_handoff_recheck
    from ..core.validation import check_handoff, handoff_activations
    ctx = host_score_context(policy, results)
    scores, elig, order = score_and_rank(policy, ctx)
    d_o = int(x0.shape[0])

    detections = 0
    selected: Optional[int] = None
    new_theta = theta
    for cand in order:
        if not elig[cand]:
            continue                  # trimmed outlier: never visited
        res = results[cand]
        g_sel, p_sel = res["gamma"], res["phi"]
        handed = g_sel
        pt = tm.param_attack_for(res["cluster"][-1], t)
        if pt is not None:
            handed = tamper_params(pt, g_sel, gen)
        if pcfg.tamper_check:
            # next-round first clients re-transmit g(x0, gamma_received);
            # >=1 of the R recipients is honest, so a tampered handoff is
            # always visible against the validation-time activations.
            recv = handoff_activations(module, handed, x0)
            account_handoff_recheck(meter, pcfg, d_o, d_c, visited=1)
            ok, _ = check_handoff(res["vacts"], [recv], pcfg.tamper_tol)
            if not ok:
                detections += 1
                continue              # discard tampered cluster, reselect
        selected = int(cand)
        new_theta = (handed, p_sel)
        break

    accepted = selected is not None
    if not accepted:                  # every candidate tampered: keep theta^t
        selected = int(next(c for c in order if elig[c]))
        new_theta = theta
    return SelectionOutcome(selected=selected, accepted=accepted,
                            detections=detections, theta=new_theta,
                            scores=scores.astype(np.float32))


__all__ = ["SelectionOutcome", "host_score_context", "score_and_rank",
           "select_host"]
