"""Public entry points of the port's kernels.

A CPU tensor takes the plain PyTorch version; a CUDA tensor takes the CUDA
kernel, or the launcher raises (there is no fallback from the kernel to the
plain version).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch

from . import decode_attention as _da
from . import flash_attention as _fa
from . import fused_xent as _fx
from . import quant_exchange as _qx
from . import slstm_scan as _ss
from . import tamper_check as _tc


def _needs_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


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
    """Relative L2 distance ``||ref - recv|| / max(||ref||, 1e-12)`` per
    candidate: ref/recv (R, N, D) -> (R,), or (N, D) -> a scalar: the
    distances of :func:`tamper_verdict`."""
    return tamper_verdict(ref, recv, math.inf)[1]


def tamper_verdict(ref: torch.Tensor, recv: torch.Tensor, tol: float
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fused cascade's verify stage: (passed ``distance <= tol`` (R,)
    bool, distances (R,)) for ref/recv (R, N, D); on CUDA tensors both come
    out of one launch of B1."""
    if ref.device.type == "cpu":
        dists = _tc.tamper_distance_plain(ref, recv)
        return dists <= tol, dists
    _, dists, passed = _tc.tamper_check(ref, recv, tol)
    return passed, dists


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: int = 0) -> torch.Tensor:
    """Causal multi-head attention over a sequence.  q (B, Sq, H, D); k, v
    (B, Sk, Hkv, D), GQA when Hkv < H; ``window > 0`` a sliding window.
    Returns (B, Sq, H, D), differentiable: on CUDA tensors that need a
    gradient through the B5 forward and backward kernels."""
    if q.device.type == "cpu":
        return _fa.flash_attention_plain(q, k, v, window=window)
    if _needs_grad(q, k, v):
        return _fa.FlashAttention.apply(q, k, v, window)
    return _fa.flash_attention(q, k, v, window=window)[0]


def fused_cross_entropy(hidden: torch.Tensor, weights: torch.Tensor, labels: torch.Tensor,
                        mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean softmax cross-entropy of ``hidden (..., D) @ weights (D, V)``
    against ``labels (...)`` without the logits in device memory (B4), in
    f32: ``mean(loss)``, or with a ``mask`` of the labels' shape
    ``sum(loss * mask) / max(sum(mask), 1)`` (``blocks.cross_entropy``).
    Differentiable: on CUDA tensors that need a gradient through the B4
    forward and backward kernels."""
    h2 = hidden.reshape(-1, hidden.shape[-1])
    l2 = labels.reshape(-1)
    if hidden.device.type == "cpu":
        per_tok = _fx.fused_xent_plain(h2, weights, l2)
    else:
        l2 = l2.to(torch.int32).contiguous()
        if _needs_grad(hidden, weights):
            per_tok = _fx.FusedXent.apply(h2.contiguous(), weights, l2)
        else:
            per_tok = _fx.fused_xent(h2.contiguous(), weights, l2)[0]
    if mask is None:
        return torch.mean(per_tok)
    m = mask.reshape(-1).to(torch.float32)
    return torch.sum(per_tok * m) / torch.clamp_min(torch.sum(m), 1.0)


class _QuantCutExchange(torch.autograd.Function):
    """The straight-through wire: the forward quantizes the uplink
    activation message, the backward the downlink cut gradient, each per
    sample (a row a sample over the ``lead`` leading axes) through
    :func:`quant_roundtrip`."""

    @staticmethod
    def _qdq(x: torch.Tensor, fmt: str, lead: int) -> torch.Tensor:
        flat = x.reshape(math.prod(x.shape[:lead]), -1).to(torch.float32).contiguous()
        deq, _ = quant_roundtrip(flat, fmt)
        return deq.reshape(x.shape).to(x.dtype)

    @staticmethod
    def forward(ctx, x, fmt, lead):
        ctx.fmt, ctx.lead = fmt, lead
        return _QuantCutExchange._qdq(x, fmt, lead)

    @staticmethod
    def backward(ctx, g):
        return _QuantCutExchange._qdq(g, ctx.fmt, ctx.lead), None, None


def quant_cut_exchange(x: torch.Tensor, fmt: Optional[str], lead: int = 1) -> torch.Tensor:
    """Apply the quantized cut-layer wire to an activation tensor (``lead``
    leading sample axes: 1 for a batch, 2 for n slots' batches (n, B, ...);
    any trailing shape): one differentiable call sees exactly the two
    messages a client/AP pair exchange, a row a sample.  ``fmt=None`` is
    the identity."""
    if fmt is None:
        return x
    _qx.check_format(fmt)
    return _QuantCutExchange.apply(x, fmt, lead)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     index: Union[int, torch.Tensor], *, window: int = 0) -> torch.Tensor:
    """Single-token decode attention.  q (B, 1, H, D); the cache's k, v (B,
    S, Hkv, D); ``index`` the new token's position: a host int, or a 0-d
    int32 tensor on q's device, as the reference takes it (read on the
    device by the kernels).  Returns (B, 1, H, D)."""
    if q.device.type == "cpu":
        return _da.decode_attention_plain(q, k, v, index, window=window)
    return _da.decode_attention(q, k, v, index, window=window)


def slstm_scan(pre: torch.Tensor, r: torch.Tensor, n_heads: int) -> torch.Tensor:
    """The sLSTM time scan (B7): pre (T, B, 4d) input pre-activations, r
    (H, dh, 4dh) recurrent weights -> hidden states (T, B, d) in pre's
    dtype, f32 state.  A CPU tensor takes the plain version, which autograd
    differentiates; a CUDA tensor the kernels (by
    ``slstm_scan.slstm_route``), and one that needs a gradient goes through
    ``SlstmScan``: the forward kernel saves its state, the backward runs the
    reverse-scan kernel (by ``slstm_scan.slstm_bwd_route``:
    ``csrc/slstm_scan_bwd_persistent.cu`` or the step route
    ``csrc/slstm_scan_bwd.cu``) and the dR product."""
    if pre.device.type == "cpu":
        return _ss.slstm_scan_plain(pre, r, n_heads)
    pre, r = pre.contiguous(), r.contiguous()
    if _needs_grad(pre, r):
        return _ss.SlstmScan.apply(pre, r, n_heads, _ss.slstm_scan_saving, _ss.slstm_scan_bwd)
    return _ss.slstm_scan(pre, r, n_heads)


__all__ = ["decode_attention", "flash_attention", "fused_cross_entropy", "largest_divisor",
           "quant_cut_exchange", "quant_roundtrip", "quant_roundtrip_stats", "slstm_scan",
           "tamper_distance", "tamper_verdict"]
