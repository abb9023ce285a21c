"""Selection policies: pluggable cluster-acceptance scoring (Section III-C
and beyond).

A :class:`SelectionPolicy` owns the *score* and *eligibility* stages of the
round-acceptance cascade (score -> rank -> verify -> commit) as plain tensor
functions of a :class:`ScoreContext`.  They run on the host's tensors in the
host selector (:mod:`.selector`) and on the device inside the batched
round's fused cascade (``core/runner.py``), so they are device-agnostic and
never branch in Python on a tensor's value (no host sync).

Registered policies (``selection=`` on the protocol drivers):

  * ``argmin``             — the paper's rule: argmin shared-set validation loss.
  * ``median_of_means``    — score each cluster by the median of its
                             per-shard mean losses over ``shards`` equal D_o
                             slices.
  * ``loss_plus_distance`` — validation-loss z-score composited with the
                             cluster's worst activation-message anomaly, both
                             robust-z-scored across the round's clients.
  * ``trimmed``            — drop clusters whose validation loss is a robust
                             z-score outlier before argmin.

Scores follow the loss convention: lower is better.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Union

import torch

# indices into the message-stats lane of ScoreContext (see
# repro_torch.core.split.MESSAGE_STAT_NAMES)
_STAT_DISPERSION = 0
_STAT_SUPPORT = 1


def _median(x: torch.Tensor, dim: Optional[int] = None,
            keepdim: bool = False) -> torch.Tensor:
    """Sort-based median: ``0.5 * (lo + hi)`` of the two middle order
    statistics, as the reference computes it (``torch.median`` returns the
    lower middle value instead)."""
    if dim is None:
        s = torch.sort(x.reshape(-1)).values
        n = s.shape[0]
        m = 0.5 * (s[(n - 1) // 2] + s[n // 2])
        return m.reshape((1,) * x.dim()) if keepdim else m
    s = torch.sort(x, dim=dim).values
    n = s.shape[dim]
    m = 0.5 * (s.narrow(dim, (n - 1) // 2, 1) + s.narrow(dim, n // 2, 1))
    return m if keepdim else m.squeeze(dim)


@dataclasses.dataclass(frozen=True)
class ScoreContext:
    """Per-round features a policy may score.  ``shard_losses`` and
    ``message_stats`` are present only when the policy declares it needs
    them (``shard_count`` / ``needs_message_stats``)."""
    vlosses: torch.Tensor                          # (R,) shared-set val losses
    shard_losses: Optional[torch.Tensor] = None    # (R, K) per-shard losses
    message_stats: Optional[torch.Tensor] = None   # (R, M_bar, S) train-message stats


def robust_z(x: torch.Tensor, dim: Optional[int] = None,
             eps: float = 1e-6) -> torch.Tensor:
    """Median/MAD z-score (1.4826 * MAD estimates sigma under normality).
    ``eps`` keeps degenerate all-equal features at z = 0 instead of NaN."""
    x = x.to(torch.float32)
    med = _median(x, dim=dim, keepdim=dim is not None)
    mad = _median(torch.abs(x - med), dim=dim, keepdim=dim is not None)
    return (x - med) / (1.4826 * mad + eps)


@dataclasses.dataclass(frozen=True)
class SelectionPolicy:
    """Base policy: argmin validation loss (the paper's Section III-C rule).
    Subclasses override :meth:`score` (lower = better) and/or
    :meth:`eligible`, plus ``needs_message_stats``."""
    name: str = "argmin"

    @property
    def shard_count(self) -> int:
        """> 0: the round validates in this many D_o shards."""
        return 0

    @property
    def needs_message_stats(self) -> bool:
        """True: the round surfaces per-client transmitted-message
        statistics from the training phase."""
        return False

    def score(self, ctx: ScoreContext) -> torch.Tensor:
        """(R,) f32 scores, lower = better."""
        return ctx.vlosses.to(torch.float32)

    def eligible(self, ctx: ScoreContext, scores: torch.Tensor) -> torch.Tensor:
        """(R,) bool mask of clusters the cascade may visit/select."""
        return torch.ones_like(scores, dtype=torch.bool)


@dataclasses.dataclass(frozen=True)
class MedianOfMeansPolicy(SelectionPolicy):
    """Median over ``shards`` equal D_o slices of the per-shard mean loss."""
    name: str = "median_of_means"
    shards: int = 4

    @property
    def shard_count(self) -> int:
        return self.shards

    def score(self, ctx: ScoreContext) -> torch.Tensor:
        if ctx.shard_losses is None:
            raise ValueError(f"{self.name} needs per-shard validation losses")
        return _median(ctx.shard_losses.to(torch.float32), dim=1)


@dataclasses.dataclass(frozen=True)
class LossPlusDistancePolicy(SelectionPolicy):
    """Bounded validation-loss z-score + ``weight`` x the cluster's worst
    activation-message anomaly.

    Anomaly per client = max(z(support residual), -z(dispersion), 0), robust
    z-scores taken across all R x M_bar clients of the round; the cluster
    inherits its worst client's anomaly, hinged at ``margin``.  The loss term
    is squashed through tanh(z / loss_scale), bounding its pull to (-1, 1)
    while keeping the argmin order among unflagged clusters."""
    name: str = "loss_plus_distance"
    weight: float = 4.0
    margin: float = 1.5
    loss_scale: float = 3.0
    z_clip: float = 1e4

    @property
    def needs_message_stats(self) -> bool:
        return True

    def score(self, ctx: ScoreContext) -> torch.Tensor:
        if ctx.message_stats is None:
            raise ValueError(f"{self.name} needs transmitted-message statistics")
        stats = ctx.message_stats.to(torch.float32)    # (R, M_bar, S)
        r, m_bar = stats.shape[0], stats.shape[1]
        flat = stats.reshape(r * m_bar, -1)
        z_disp = robust_z(flat[:, _STAT_DISPERSION])
        z_sup = robust_z(flat[:, _STAT_SUPPORT])
        anomaly = torch.clamp_min(torch.maximum(z_sup, -z_disp), 0.0)
        anomaly = torch.clamp(anomaly, 0.0, self.z_clip).reshape(r, m_bar)
        cluster_dist = torch.clamp_min(torch.amax(anomaly, dim=1) - self.margin, 0.0)
        loss_term = torch.tanh(robust_z(ctx.vlosses) / self.loss_scale)
        return loss_term + self.weight * cluster_dist


@dataclasses.dataclass(frozen=True)
class TrimmedPolicy(SelectionPolicy):
    """Argmin after dropping robust-z validation-loss outliers."""
    name: str = "trimmed"
    z_tol: float = 3.0

    def eligible(self, ctx: ScoreContext, scores: torch.Tensor) -> torch.Tensor:
        return torch.abs(robust_z(ctx.vlosses)) <= self.z_tol


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

SELECTION_REGISTRY: Dict[str, SelectionPolicy] = {}


def register_policy(policy: SelectionPolicy) -> SelectionPolicy:
    if policy.name in SELECTION_REGISTRY:
        raise ValueError(f"duplicate selection policy {policy.name!r}")
    SELECTION_REGISTRY[policy.name] = policy
    return policy


ARGMIN = register_policy(SelectionPolicy())
MEDIAN_OF_MEANS = register_policy(MedianOfMeansPolicy())
LOSS_PLUS_DISTANCE = register_policy(LossPlusDistancePolicy())
TRIMMED = register_policy(TrimmedPolicy())


def selection_policies() -> Dict[str, SelectionPolicy]:
    return dict(SELECTION_REGISTRY)


def resolve_policy(selection: Union[str, SelectionPolicy, None]) -> SelectionPolicy:
    """A registered name, a policy instance, or None (the default argmin)."""
    if selection is None:
        return ARGMIN
    if isinstance(selection, SelectionPolicy):
        return selection
    try:
        return SELECTION_REGISTRY[selection]
    except KeyError:
        raise ValueError(
            f"unknown selection policy {selection!r}; registered: "
            f"{sorted(SELECTION_REGISTRY)}") from None


__all__ = ["ARGMIN", "LOSS_PLUS_DISTANCE", "MEDIAN_OF_MEANS", "TRIMMED",
           "LossPlusDistancePolicy", "MedianOfMeansPolicy", "ScoreContext",
           "SelectionPolicy", "TrimmedPolicy",
           "register_policy", "resolve_policy", "robust_z",
           "selection_policies"]
