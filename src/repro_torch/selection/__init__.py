"""Cluster-acceptance policies, the host-side selector and the fused
on-device cascade."""
from .cascade import (N_FETCH_TAIL, masked_first_accept, pack_fetch,
                      unpack_fetch)
from .policies import (ARGMIN, LOSS_PLUS_DISTANCE, MEDIAN_OF_MEANS, TRIMMED,
                       LossPlusDistancePolicy, MedianOfMeansPolicy,
                       ScoreContext, SelectionPolicy, TrimmedPolicy,
                       register_policy, resolve_policy, robust_z,
                       selection_policies)
from .selector import (SelectionOutcome, effective_shards, host_score_context,
                       score_and_rank, select_host)

__all__ = ["ARGMIN", "LOSS_PLUS_DISTANCE", "MEDIAN_OF_MEANS", "N_FETCH_TAIL",
           "TRIMMED", "LossPlusDistancePolicy", "MedianOfMeansPolicy",
           "ScoreContext", "SelectionOutcome", "SelectionPolicy",
           "TrimmedPolicy", "effective_shards", "host_score_context",
           "masked_first_accept", "pack_fetch", "register_policy",
           "resolve_policy", "robust_z", "score_and_rank", "select_host",
           "selection_policies", "unpack_fetch"]
