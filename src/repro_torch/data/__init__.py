"""Synthetic tasks for the split-learning protocol (numpy)."""
from .pipeline import build_image_task

__all__ = ["build_image_task"]
