"""Synthetic tasks for the split-learning protocol and the LM (numpy), and
the host pipeline of the batched engine (round blocks, the round feeder,
pinned staging)."""
from .pipeline import (DeviceStager, RoundFeeder, build_image_task, build_lm_task,
                       dirichlet_relabel, lane_block_len, minibatches, plan_blocks)
from .synthetic import (lm_batch, make_classification_data, make_markov_tokens,
                        make_templates, sample_images)

__all__ = ["DeviceStager", "RoundFeeder", "build_image_task", "build_lm_task",
           "dirichlet_relabel", "lane_block_len", "lm_batch", "make_classification_data",
           "make_markov_tokens", "make_templates", "minibatches", "plan_blocks",
           "sample_images"]
