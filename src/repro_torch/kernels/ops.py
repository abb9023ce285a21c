"""Public entry points of the port's kernels.

A CPU tensor takes the plain PyTorch version; a CUDA tensor takes the CUDA
kernel, or the launcher raises (there is no fallback from the kernel to the
plain version).
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import decode_attention as _da
from . import flash_attention as _fa
from . import quant_exchange as _qx
from . import tamper_check as _tc


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


def largest_divisor(n: int, cap: int) -> int:
    """Largest divisor of n at most ``cap`` (the median-of-means shard count
    clamp, ``selection.selector.effective_shards``)."""
    cap = max(1, min(cap, n))
    while n % cap:
        cap -= 1
    return cap


def tamper_distance(ref: torch.Tensor, recv: torch.Tensor) -> torch.Tensor:
    """Relative L2 distance ``||ref - recv|| / ||ref||`` per candidate:
    ref/recv (R, N, D) -> (R,) in one kernel call over all candidates (the
    fused cascade's verify stage), or (N, D) -> a scalar."""
    if ref.device.type == "cpu":
        sums = _tc.tamper_check_sums_plain(ref, recv)
    else:
        sums = _tc.tamper_check_sums(ref, recv)
    return torch.sqrt(sums[..., 0]) / torch.clamp_min(torch.sqrt(sums[..., 1]), 1e-12)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: int = 0) -> torch.Tensor:
    """Causal multi-head attention over a sequence.  q (B, Sq, H, D); k, v
    (B, Sk, Hkv, D), GQA when Hkv < H; ``window > 0`` a sliding window.
    Returns (B, Sq, H, D)."""
    if q.device.type == "cpu":
        return _fa.flash_attention_plain(q, k, v, window=window)
    return _fa.flash_attention(q, k, v, window=window)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, index: int, *,
                     window: int = 0) -> torch.Tensor:
    """Single-token decode attention.  q (B, 1, H, D); the cache's k, v (B,
    S, Hkv, D); ``index`` the new token's position (host int).  Returns (B,
    1, H, D)."""
    if q.device.type == "cpu":
        return _da.decode_attention_plain(q, k, v, index, window=window)
    return _da.decode_attention(q, k, v, index, window=window)


__all__ = ["decode_attention", "flash_attention", "largest_divisor", "quant_roundtrip",
           "quant_roundtrip_stats", "tamper_distance"]
