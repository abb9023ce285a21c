"""Synthetic tasks for the split-learning protocol and the LM (numpy)."""
from .pipeline import build_image_task, build_lm_task, dirichlet_relabel, minibatches
from .synthetic import lm_batch, make_markov_tokens

__all__ = ["build_image_task", "build_lm_task", "dirichlet_relabel", "lm_batch",
           "make_markov_tokens", "minibatches"]
