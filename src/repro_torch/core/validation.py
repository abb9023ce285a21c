"""Shared-dataset validation (Section III-C).

At the end of a round the *last* client of each cluster pushes the cut-layer
activations of the shared dataset D_o and the AP finishes the forward pass
to obtain the cluster validation loss.  ``check_handoff`` is the
tamper-resilience check: the first clients of the next round each transmit
g(x_0, gamma_received), and the AP compares them with the activations the
selected cluster reported at validation time.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from .split import SplitModule


@torch.no_grad()
def validation_loss(module: SplitModule, gamma: nn.Module, phi: nn.Module,
                    x0: torch.Tensor, y0: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (loss, cut-activations).  The activations are what the last
    client actually transmits — kept so the AP can cross-check handoffs."""
    acts = module.client_forward(gamma, x0)
    return module.ap_loss(phi, acts, y0), acts


@torch.no_grad()
def handoff_activations(module: SplitModule, gamma: nn.Module,
                        x0: torch.Tensor) -> torch.Tensor:
    """g(x_0, gamma_received) transmitted by a first client before training."""
    return module.client_forward(gamma, x0)


@torch.no_grad()
def check_handoff(reference_acts: torch.Tensor, received: Sequence[torch.Tensor],
                  tol: float = 1e-4) -> Tuple[bool, float]:
    """AP-side comparison: max_k ||recv_k - ref|| / ||ref|| against ``tol``.
    Honest handoff => all equal.  Returns (ok, max_distance)."""
    received = list(received)
    if not received:
        return True, 0.0
    ref = reference_acts.to(torch.float32)
    denom = torch.clamp_min(torch.linalg.vector_norm(ref.reshape(-1)), 1e-12)
    diffs = (torch.stack(received).to(torch.float32) - ref[None]).reshape(len(received), -1)
    max_d = float(torch.max(torch.linalg.vector_norm(diffs, dim=1)) / denom)
    return max_d <= tol, max_d


__all__ = ["check_handoff", "handoff_activations", "validation_loss"]
