"""The optimizer library (the reference's ``repro.optim``): schedules, the
global-norm clip, SGD with and without momentum and AdamW, over trees of
tensors.  ``launch/steps.py::make_train_step`` stays plain SGD, as the
reference's does."""
from .optim import (Optimizer, adamw, apply_updates, clip_by_global_norm, constant_schedule,
                    cosine_schedule, sgd, tree_leaves, tree_map, warmup_cosine)

__all__ = ["Optimizer", "sgd", "adamw", "constant_schedule", "cosine_schedule",
           "warmup_cosine", "clip_by_global_norm", "apply_updates", "tree_map",
           "tree_leaves"]
