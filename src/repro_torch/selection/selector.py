"""Host-side selector: the Section III-C acceptance loop.

Rank the R candidate clusters by the policy's score, visit them in order,
tamper-check each handoff (the visited candidate's last client may tamper
the parameters it hands off), and commit the first survivor; when every
candidate fails, keep theta^t.  The sequential engine always runs it, and the
batched engine runs it for param-tamper threat models, whose handoff noise
is drawn per visited candidate; the batched engine's other rounds run the
fused cascade (``selection.cascade`` via ``core.runner.RoundRunner.accept``).
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


def effective_shards(k: int, d_o: int) -> int:
    """Largest divisor of D_o at most ``k`` — the shard count the host and
    fused median-of-means paths both use."""
    from ..kernels.ops import largest_divisor
    return largest_divisor(d_o, k)


@torch.no_grad()
def host_score_context(policy: SelectionPolicy, module,
                       results: List[Dict[str, Any]], y0: torch.Tensor
                       ) -> ScoreContext:
    """The policy's features from the round's results: ``vloss`` always,
    ``msg_stats`` when the round was trained with message statistics, and
    the per-shard losses of each cluster's validation activations
    (``res_vacts``) when the policy shards D_o."""
    from ..core.protocol import res_params, res_vacts
    from ..core.runner import sharded_validation_losses
    vlosses = torch.from_numpy(np.asarray([res["vloss"] for res in results],
                                          dtype=np.float32))
    shard_losses = None
    if policy.shard_count > 0:
        shard_losses = torch.stack([
            sharded_validation_losses(module.ap_loss, res_params(res)[1],
                                      res_vacts(res), y0, policy.shard_count)
            for res in results]).cpu()
    message_stats = None
    if policy.needs_message_stats:
        message_stats = torch.from_numpy(np.stack(
            [np.asarray(res["msg_stats"], dtype=np.float32) for res in results]))
    return ScoreContext(vlosses=vlosses, shard_losses=shard_losses,
                        message_stats=message_stats)


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
                y0: torch.Tensor, d_c: int) -> SelectionOutcome:
    """The reference cascade.  ``gen`` draws the handoff-tampering noise of
    a visited candidate whose last client tampers.  Mutates ``meter`` with
    the per-visit re-transmission accounting (Table I's 2R*D_o validation
    term).  Results of the batched engine hold views into its stacked
    candidates; only the visited ones are taken out (``res_params``)."""
    from ..adversary import tamper_params
    from ..core.protocol import account_handoff_recheck, res_params, res_vacts
    from ..core.validation import check_handoff, handoff_activations
    ctx = host_score_context(policy, module, results, y0)
    scores, elig, order = score_and_rank(policy, ctx)
    d_o = int(x0.shape[0])

    detections = 0
    selected: Optional[int] = None
    new_theta = theta
    for cand in order:
        if not elig[cand]:
            continue                  # trimmed outlier: never visited
        res = results[cand]
        g_sel, p_sel = res_params(res)
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
            ok, _ = check_handoff(res_vacts(res), [recv], pcfg.tamper_tol)
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


__all__ = ["SelectionOutcome", "effective_shards", "host_score_context",
           "score_and_rank", "select_host"]
