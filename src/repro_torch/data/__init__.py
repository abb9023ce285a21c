"""Synthetic tasks for the split-learning protocol and the LM (numpy)."""
from .pipeline import build_image_task, build_lm_task
from .synthetic import lm_batch, make_markov_tokens

__all__ = ["build_image_task", "build_lm_task", "lm_batch", "make_markov_tokens"]
