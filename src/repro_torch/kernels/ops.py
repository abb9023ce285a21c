"""Public entry points of the port's kernels.

A CPU tensor takes the plain PyTorch version; a CUDA tensor takes the CUDA
kernel, or the launcher raises (there is no fallback from the kernel to the
plain version).  A tensor on the ``meta`` device takes the meta rule: empty
tensors of the kernel's output shapes and dtypes, forward and backward (the
``autograd.Function``s carry the same branch), with no launch and no plain
arithmetic, so that ``launch/dryrun.py`` traces a step at full size.

Every entry runs inside ``observe.entry``: an op counter
(``launch/op_analysis.py``) counts it as one operation of the kernel's work
(``launch/roofline.py``), whatever implements it.
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
from .observe import entry, is_meta


def _needs_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _empty(shape, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def quant_roundtrip(x: torch.Tensor, fmt: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric quantize->dequantize of an (N, D) f32 message.
    Returns (dequantized (N, D) f32, per-row scales (N,) f32) — the message a
    receiver reconstructs from ``1 byte/element + 4 bytes/row``."""
    with entry("quant_roundtrip", x, fmt=fmt):
        if x.device.type == "cpu":
            return _qx.quant_dequant_plain(x, fmt)
        if is_meta(x):
            _qx.check_format(fmt)
            return torch.empty_like(x), _empty(x.shape[:-1], torch.float32)
        return _qx.quant_dequant(x, fmt)


def quant_roundtrip_stats(x: torch.Tensor, fmt: str
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`quant_roundtrip` fused with the message statistics of the
    *dequantized* message (``core.split.message_stats``).  Returns
    (deq, scales, stats (2,))."""
    with entry("quant_roundtrip_stats", x, fmt=fmt):
        if x.device.type == "cpu":
            return _qx.quant_dequant_stats_plain(x, fmt)
        if is_meta(x):
            _qx.check_format(fmt)
            return (torch.empty_like(x), _empty(x.shape[:-1], torch.float32),
                    _empty(x.shape[:-2] + (2,), torch.float32))
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
    with entry("tamper_verdict", ref, recv):
        if ref.device.type == "cpu":
            dists = _tc.tamper_distance_plain(ref, recv)
            return dists <= tol, dists
        if is_meta(ref, recv):
            lead = ref.shape[:-2]
            return _empty(lead, torch.bool), _empty(lead, torch.float32)
        _, dists, passed = _tc.tamper_check(ref, recv, tol)
        return passed, dists


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Multi-head attention over a sequence, causal unless ``causal=False``
    (then only the window masks, and Sq may exceed Sk).  q (B, Sq, H, D); k,
    v (B, Sk, Hkv, D), GQA when Hkv < H; ``window > 0`` a sliding window.
    Returns (B, Sq, H, D), differentiable: on CUDA tensors that need a
    gradient through the B5 forward and backward kernels, causal or not (a
    non-causal call with a row that sees no key raises
    ``flash_attention.DEAD_ROW_BACKWARD``; the CPU path differentiates
    every call)."""
    with entry("flash_attention", q, k, v, window=window, causal=causal):
        if q.device.type == "cpu":
            return _fa.flash_attention_plain(q, k, v, causal=causal, window=window)
        if _needs_grad(q, k, v):
            return _fa.FlashAttention.apply(q, k, v, window, causal)
        if is_meta(q, k, v):
            return _fa.flash_attention_meta(q, k, v)[0]
        return _fa.flash_attention(q, k, v, causal=causal, window=window)[0]


def fused_cross_entropy(hidden: torch.Tensor, weights: torch.Tensor, labels: torch.Tensor,
                        mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean softmax cross-entropy of ``hidden (..., D) @ weights (D, V)``
    against ``labels (...)`` without the logits in device memory (B4), in
    f32: ``mean(loss)``, or with a ``mask`` of the labels' shape
    ``sum(loss * mask) / max(sum(mask), 1)`` (``blocks.cross_entropy``).
    Differentiable: on CUDA tensors that need a gradient through the B4
    forward and backward kernels."""
    per_tok = _xent_per_token(hidden, weights, labels)
    if mask is None:
        return torch.mean(per_tok)
    m = mask.reshape(-1).to(torch.float32)
    return torch.sum(per_tok * m) / torch.clamp_min(torch.sum(m), 1.0)


def _xent_per_token(hidden: torch.Tensor, weights: torch.Tensor, labels: torch.Tensor,
                    par=None) -> torch.Tensor:
    """B4's per-token loss (T,) f32; with ``par`` of model axis > 1 over
    the vocab-parallel panel ``weights`` (:class:`fused_xent.VocabParallelXent`)."""
    h2 = hidden.reshape(-1, hidden.shape[-1])
    l2 = labels.reshape(-1)
    with entry("fused_xent", h2, weights):
        if par is not None and par.model_size > 1:
            v0 = par.model_rank * weights.shape[1]
            return _fx.VocabParallelXent.apply(h2.contiguous(), weights, l2, v0, par)
        if hidden.device.type == "cpu":
            return _fx.fused_xent_plain(h2, weights, l2)
        l2 = l2.to(torch.int32).contiguous()
        if _needs_grad(hidden, weights):
            return _fx.FusedXent.apply(h2.contiguous(), weights, l2)
        if is_meta(hidden, weights):
            return _fx.fused_xent_meta(h2, weights, l2)[0]
        return _fx.fused_xent(h2.contiguous(), weights, l2)[0]


def parallel_cross_entropy(hidden: torch.Tensor, weights: torch.Tensor, labels: torch.Tensor,
                           mask: Optional[torch.Tensor], par) -> torch.Tensor:
    """:func:`fused_cross_entropy` of a tensor-parallel model on one rank:
    ``weights`` this rank's vocab panel (D, V/m) of the head, ``hidden``
    and ``labels`` this data rank's rows.  B4 runs on the panel
    (``VocabParallelXent``, the whole vocab's loss on every model rank);
    the mean is the whole batch's: the sum (with a ``mask``, the masked sum
    and the mask's count, each on its own) all-reduced over ``data``, never
    a mean of means.  A trivial ``par`` is :func:`fused_cross_entropy`."""
    if par is None or par.trivial:
        return fused_cross_entropy(hidden, weights, labels, mask)
    from ..models.parallel import reduce_from
    per_tok = _xent_per_token(hidden, weights, labels, par)
    if mask is None:
        total = reduce_from(torch.sum(per_tok), par.data_group, par.data_size)
        return total / (per_tok.numel() * par.data_size)
    m = mask.reshape(-1).to(torch.float32)
    num = reduce_from(torch.sum(per_tok * m), par.data_group, par.data_size)
    den = reduce_from(torch.sum(m), par.data_group, par.data_size)
    return num / torch.clamp_min(den, 1.0)


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
    with entry("decode_attention", q, k, v, index=index, window=window):
        if q.device.type == "cpu":
            return _da.decode_attention_plain(q, k, v, index, window=window)
        if is_meta(q, k, v):
            _da.check_shapes(q, k, v)
            return torch.empty_like(q)
        return _da.decode_attention(q, k, v, index, window=window)


def decode_attention_partial(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             index: Union[int, torch.Tensor], *, base: int, window: int = 0
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """B6's partial mode over one panel of a sequence-sharded cache: k, v
    (B, S_local, Hkv, D) hold the absolute positions [base, base +
    S_local); ``index`` is absolute (before, inside or past the panel).
    Returns (out f32 (B, 1, H, D) normalised by the panel's own softmax
    sum, lse f32 (B, 1, H)); a panel with no live key gives out 0 and lse
    -inf.  ``decode_attention.combine_partials`` merges G panels'."""
    with entry("decode_attention_partial", q, k, v, index=index, base=base, window=window):
        if q.device.type == "cpu":
            return _da.decode_attention_partial_plain(q, k, v, index, base=base, window=window)
        if is_meta(q, k, v):
            _da.check_shapes(q, k, v)
            b, _, h, d = q.shape
            return _empty((b, 1, h, d), torch.float32), _empty((b, 1, h), torch.float32)
        return _da.decode_attention_partial(q, k, v, index, base=base, window=window)


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
    with entry("slstm_scan", pre, r, n_heads=n_heads):
        if pre.device.type == "cpu":
            return _ss.slstm_scan_plain(pre, r, n_heads)
        pre, r = pre.contiguous(), r.contiguous()
        if _needs_grad(pre, r):
            return _ss.SlstmScan.apply(pre, r, n_heads, _ss.slstm_scan_saving,
                                       _ss.slstm_scan_bwd)
        if is_meta(pre, r):
            return _ss.slstm_scan_meta(pre, r, n_heads)
        return _ss.slstm_scan(pre, r, n_heads)


__all__ = ["decode_attention", "decode_attention_partial", "flash_attention", "fused_cross_entropy", "largest_divisor",
           "parallel_cross_entropy",
           "quant_cut_exchange", "quant_roundtrip", "quant_roundtrip_stats", "slstm_scan",
           "tamper_distance", "tamper_verdict"]
