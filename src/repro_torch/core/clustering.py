"""Cluster formation (Section III-B, eq. (1)) and the pigeonhole guarantee."""
from __future__ import annotations

from typing import List, Sequence, Set

import numpy as np


def make_clusters(rng: np.random.Generator, m: int, r: int) -> List[List[int]]:
    """Randomly partition [0, m) into r disjoint clusters of equal size.

    Satisfies (1): pairwise disjoint and covering.  Requires r | m, as in the
    paper (M/R must be a positive integer)."""
    if m % r != 0:
        raise ValueError(f"R={r} must divide M={m} (paper: M_bar = M/R in Z+)")
    perm = rng.permutation(m)
    size = m // r
    return [sorted(perm[i * size : (i + 1) * size].tolist()) for i in range(r)]


def has_honest_cluster(clusters: Sequence[Sequence[int]], malicious: Set[int]) -> bool:
    """The pigeonhole invariant: with |malicious| <= N and R = N + 1 clusters,
    at least one cluster contains no malicious client."""
    return any(all(c not in malicious for c in cluster) for cluster in clusters)


def cluster_is_honest(cluster: Sequence[int], malicious: Set[int]) -> bool:
    return all(c not in malicious for c in cluster)
