"""Cluster-acceptance policies and the host-side selector."""
from .policies import (ARGMIN, LOSS_PLUS_DISTANCE, TRIMMED,
                       LossPlusDistancePolicy, ScoreContext, SelectionPolicy,
                       TrimmedPolicy, register_policy, resolve_policy,
                       robust_z, selection_policies)
from .selector import (SelectionOutcome, host_score_context, score_and_rank,
                       select_host)

__all__ = ["ARGMIN", "LOSS_PLUS_DISTANCE", "TRIMMED", "LossPlusDistancePolicy",
           "ScoreContext", "SelectionOutcome", "SelectionPolicy",
           "TrimmedPolicy", "host_score_context", "register_policy",
           "resolve_policy", "robust_z", "score_and_rank", "select_host",
           "selection_policies"]
