"""Public entry points of the port's kernels.

A CPU tensor takes the plain PyTorch version; a CUDA tensor takes the CUDA
kernel, or the launcher raises (there is no fallback from the kernel to the
plain version).
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import quant_exchange as _qx


def quant_roundtrip(x: torch.Tensor, fmt: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric quantize->dequantize of an (N, D) f32 message.
    Returns (dequantized (N, D) f32, per-row scales (N,) f32) — the message a
    receiver reconstructs from ``1 byte/element + 4 bytes/row``."""
    if x.device.type == "cpu":
        return _qx.quant_dequant_plain(x, fmt)
    return _qx.quant_dequant(x, fmt)


def quant_roundtrip_stats(x: torch.Tensor, fmt: str
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`quant_roundtrip` fused with the message statistics of the
    *dequantized* message (``core.split.message_stats``).  Returns
    (deq, scales, stats (2,))."""
    if x.device.type == "cpu":
        return _qx.quant_dequant_stats_plain(x, fmt)
    return _qx.quant_dequant_stats(x, fmt)


__all__ = ["quant_roundtrip", "quant_roundtrip_stats"]
