"""Fused softmax cross-entropy (B4): the CUDA kernels
(``csrc/fused_xent.cu``), their plain PyTorch versions, and the autograd
function that trains through them.

Layout, as the reference's ``repro/kernels/fused_xent.py``: hidden (T, D)
f32 or bf16, weights (D, V) of the same dtype, labels (T,) int; the
per-token loss ``logsumexp(h @ W) - (h @ W)[label]`` comes out as (T,) f32.
A label outside [0, V) picks 0 (the loss is then the bare logsumexp), as
the reference's kernel, whose vocab panels never hit it.

  * :func:`fused_xent` — launches a forward kernel on CUDA tensors: the
    product h @ W computed panel by panel inside the kernel, a running
    (max, sum of exp) per row, no (T, V) logits in device memory.  Returns
    (loss, lse), lse being what the backward needs.  :func:`xent_route`
    picks the kernel: ``tensor_cores`` (``csrc/fused_xent_tc.cu``: wgmma
    with TMA loads; bf16, D and V multiples of 8, 16-byte aligned) or
    ``f32_fma`` (``csrc/fused_xent.cu``: f32 FMA; everything else).
  * :func:`fused_xent_bwd` — the backward on CUDA tensors, in chunks of T
    rows, by the route :func:`xent_bwd_route` picks.  ``tensor_cores``
    (:func:`xent_backward_tc`): the ``xent_dlogits_tc`` kernel
    (``csrc/fused_xent_bwd_tc.cu``) recomputes the chunk's logits on wgmma
    and writes ``dlogits_c = bf16((softmax - onehot(label)) * g)``; a chunk
    holds :data:`CHUNK_BYTES` of bf16 dlogits.  ``f32_fma``
    (:func:`xent_backward`): ``logits_c = h_c @ W`` (cuBLAS, f32), the
    ``xent_grad`` kernel turns them into dlogits in place; a chunk holds
    :data:`CHUNK_BYTES` of f32 logits.  Both then run ``dh_c = dlogits_c @
    W.T`` and ``dW += h_c.T @ dlogits_c`` (cuBLAS, in the inputs' dtype).
    The reference's kernel is forward only: its training path
    differentiates the plain cross-entropy through XLA, which leaves these
    two products to the matrix unit too.
  * :class:`FusedXent` — the ``autograd.Function`` over the two.
  * :func:`fused_xent_plain` — what ``repro/kernels/ref.py::xent_reference``
    computes (the logits materialised in f32), with the out-of-range rule
    above; the CPU path and the comparisons on the card use it, and its
    autograd is the plain backward.

``kernels/ops.py::fused_cross_entropy`` picks between them by the tensor's
device.  The launchers count their launches by route, in
``build.LAUNCHES``: the forward as ``fused_xent`` (f32 FMA) or
``fused_xent_tc`` (tensor cores), the backward as ``fused_xent_bwd`` or
``fused_xent_bwd_tc`` (one a call, whatever its chunks).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .flash_attention import DTYPE_CODES, F32_FMA, TENSOR_CORES, tma_ok

#: logits a backward chunk holds: f32 on the f32-FMA route, bf16 dlogits on
#: the tensor cores' (chunk rows = CHUNK_BYTES // (4 V), or // (2 V))
CHUNK_BYTES = 512 * 2 ** 20
#: rows of h and vocab columns a forward block owns: csrc/fused_xent.cu
#: (two blocks an SM) and, PANEL_V_TC, csrc/fused_xent_tc.cu (one)
BLOCK_T, PANEL_V, PANEL_V_TC = 128, 128, 256


def _picked(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """logits[t, label[t]], 0 where the label is outside [0, V)."""
    v = logits.shape[-1]
    inside = (labels >= 0) & (labels < v)
    idx = torch.where(inside, labels, torch.zeros_like(labels)).long()
    got = torch.gather(logits, -1, idx[:, None])[:, 0]
    return torch.where(inside, got, torch.zeros_like(got))


def fused_xent_plain(hidden: torch.Tensor, weights: torch.Tensor,
                     labels: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`fused_xent`'s loss (``ref.xent_reference``):
    (T,) f32."""
    check_shapes(hidden, weights, labels)
    logits = hidden.to(torch.float32) @ weights.to(torch.float32)
    return torch.logsumexp(logits, dim=-1) - _picked(logits, labels)


def check_shapes(hidden: torch.Tensor, weights: torch.Tensor, labels: torch.Tensor) -> None:
    if hidden.dim() != 2 or weights.dim() != 2 or labels.dim() != 1:
        raise ValueError(f"fused_xent takes hidden (T, D), weights (D, V) and labels (T,); "
                         f"got {tuple(hidden.shape)}, {tuple(weights.shape)}, "
                         f"{tuple(labels.shape)}")
    if hidden.shape[1] != weights.shape[0] or hidden.shape[0] != labels.shape[0]:
        raise ValueError(f"hidden {tuple(hidden.shape)}, weights {tuple(weights.shape)} and "
                         f"labels {tuple(labels.shape)} disagree")


def xent_route(hidden: torch.Tensor, weights: torch.Tensor) -> str:
    """The forward's route: :data:`TENSOR_CORES` for bf16 where TMA can read
    both operands (D and V multiples of 8, so each row stride is a multiple
    of 16 bytes, and 16-byte aligned bases), else :data:`F32_FMA`."""
    if hidden.dtype == torch.bfloat16 and tma_ok(hidden) and tma_ok(weights):
        return TENSOR_CORES
    return F32_FMA


def xent_bwd_route(hidden: torch.Tensor, weights: torch.Tensor) -> str:
    """The backward's route: :data:`TENSOR_CORES` (the logits recomputed on
    wgmma, bf16 dlogits, bf16 products) where the forward's holds, by the
    same rule (bf16, D and V multiples of 8, 16-byte aligned bases), else
    :data:`F32_FMA` (cuBLAS f32 logits and ``xent_grad``)."""
    return xent_route(hidden, weights)


def xent_splits(t: int, v: int, sms: int, panel: int = PANEL_V,
                blocks_per_sm: int = 2) -> Tuple[int, int]:
    """(panels a block, blocks along V) of the forward grid: enough blocks
    for four waves of ``blocks_per_sm`` blocks an SM, every block at least
    one ``panel``-wide vocab panel."""
    n_panels = -(-v // panel)
    row_blocks = -(-t // BLOCK_T)
    want = max(1, min(n_panels, -(-4 * blocks_per_sm * sms // row_blocks)))
    per_block = -(-n_panels // want)
    return per_block, -(-n_panels // per_block)


def chunk_rows(v: int, elt: int = 4) -> int:
    """Rows of a backward chunk: :data:`CHUNK_BYTES` of logits of ``elt``
    bytes (4: the f32-FMA route's f32 logits; 2: the tensor cores' bf16
    dlogits)."""
    return max(1, min(65535, CHUNK_BYTES // (elt * v)))


def _check_cuda(hidden: torch.Tensor, weights: torch.Tensor, labels: torch.Tensor) -> None:
    check_shapes(hidden, weights, labels)
    for x in (hidden, weights, labels):
        if x.device.type != "cuda":
            raise ValueError(f"the fused_xent kernels take CUDA tensors, got {x.device}")
        if x.device.index != torch.cuda.current_device():
            raise ValueError(f"tensor on {x.device} but the current device is "
                             f"cuda:{torch.cuda.current_device()}")
        if not x.is_contiguous():
            raise ValueError("the fused_xent kernels take contiguous tensors")
    if hidden.dtype not in DTYPE_CODES or weights.dtype != hidden.dtype:
        raise TypeError(f"the fused_xent kernels take float32 or bfloat16 hidden and weights "
                        f"of one dtype, got {hidden.dtype}, {weights.dtype}")
    if labels.dtype != torch.int32:
        raise TypeError(f"the fused_xent kernels take int32 labels, got {labels.dtype}")
    if hidden.numel() == 0 or weights.numel() == 0:
        raise ValueError(f"fused_xent: empty hidden {tuple(hidden.shape)} or weights "
                         f"{tuple(weights.shape)}")


def fused_xent(hidden: torch.Tensor, weights: torch.Tensor, labels: torch.Tensor, *,
               route: Optional[str] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch a forward kernel, by :func:`xent_route` (``route=F32_FMA``
    forces the f32-FMA kernel, to time it beside the other): hidden (T, D),
    weights (D, V), int32 labels (T,) -> (loss (T,) f32, lse (T,) f32).
    Records no graph (see :class:`FusedXent`)."""
    from .build import load, record_launch
    if torch.is_grad_enabled() and (hidden.requires_grad or weights.requires_grad):
        raise RuntimeError("the fused_xent launcher has no backward: train through "
                           "kernels.ops.fused_cross_entropy (FusedXent)")
    _check_cuda(hidden, weights, labels)
    t, d = hidden.shape
    v = weights.shape[1]
    sms = torch.cuda.get_device_properties(hidden.device).multi_processor_count
    chosen = xent_route(hidden, weights)
    if route not in (None, chosen, F32_FMA):
        raise ValueError(f"route {route!r}: these tensors take {chosen!r} or {F32_FMA!r}")
    tc = (route or chosen) == TENSOR_CORES
    per_block, nsplit = (xent_splits(t, v, sms, PANEL_V_TC, 1) if tc
                         else xent_splits(t, v, sms))
    f32 = dict(dtype=torch.float32, device=hidden.device)
    part = torch.empty((t, nsplit, 2), **f32)
    picked = torch.zeros((t,), **f32)
    loss = torch.empty((t,), **f32)
    lse = torch.empty((t,), **f32)
    stream = torch.cuda.current_stream(hidden.device).cuda_stream
    args = (hidden.data_ptr(), weights.data_ptr(), labels.data_ptr(), part.data_ptr(),
            picked.data_ptr(), loss.data_ptr(), lse.data_ptr(), t, d, v, per_block, nsplit)
    if tc:
        err = load("fused_xent_tc").repro_fused_xent_tc(*args, stream)
        record_launch(err, "fused_xent_tc")
    else:
        err = load("fused_xent").repro_fused_xent(*args, DTYPE_CODES[hidden.dtype], stream)
        record_launch(err, "fused_xent")
    return loss, lse


def _xent_grad(logits: torch.Tensor, lse: torch.Tensor, labels: torch.Tensor,
               g: torch.Tensor) -> int:
    """Launch ``xent_grad`` on one chunk, in place on its (C, V) f32 logits:
    ``(exp(logits - lse) - onehot(label)) * g``; returns its cudaError_t."""
    from .build import load
    stream = torch.cuda.current_stream(logits.device).cuda_stream
    return load("fused_xent").repro_xent_grad(
        logits.data_ptr(), lse.data_ptr(), labels.data_ptr(), g.data_ptr(),
        logits.shape[0], logits.shape[1], stream)


def xent_backward(hidden: torch.Tensor, weights: torch.Tensor, labels: torch.Tensor,
                  lse: torch.Tensor, g: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """The f32-FMA route's chunked backward of CUDA tensors: (dh (T, D), dW
    (D, V), the first cudaError_t of the ``xent_grad`` launches)."""
    t = hidden.shape[0]
    rows = chunk_rows(weights.shape[1])
    w32 = weights.to(torch.float32)
    dh = torch.empty_like(hidden)
    dw = torch.empty_like(weights)
    err = 0
    for c0 in range(0, t, rows):
        c1 = min(t, c0 + rows)
        hc = hidden[c0:c1]
        logits = hc.to(torch.float32) @ w32
        err = err or _xent_grad(logits, lse[c0:c1], labels[c0:c1], g[c0:c1])
        dl = logits.to(weights.dtype)
        torch.mm(dl, weights.t(), out=dh[c0:c1])
        if c0 == 0:
            torch.mm(hc.t(), dl, out=dw)
        else:
            dw.addmm_(hc.t(), dl)
    return dh, dw, err


def _xent_dlogits_tc(hc: torch.Tensor, weights: torch.Tensor, labels: torch.Tensor,
                     lse: torch.Tensor, g: torch.Tensor, dl: torch.Tensor) -> int:
    """Launch ``xent_dlogits_tc`` on one chunk of C rows: ``dl`` (C, V) bf16
    = ``bf16((exp(hc @ W - lse) - onehot(label)) * g)``; returns its
    cudaError_t."""
    from .build import load
    c, d = hc.shape
    v = weights.shape[1]
    sms = torch.cuda.get_device_properties(hc.device).multi_processor_count
    per_block, nsplit = xent_splits(c, v, sms, PANEL_V_TC, 1)
    stream = torch.cuda.current_stream(hc.device).cuda_stream
    return load("fused_xent_bwd_tc").repro_xent_dlogits_tc(
        hc.data_ptr(), weights.data_ptr(), labels.data_ptr(), lse.data_ptr(), g.data_ptr(),
        dl.data_ptr(), c, d, v, per_block, nsplit, stream)


def xent_backward_tc(hidden: torch.Tensor, weights: torch.Tensor, labels: torch.Tensor,
                     lse: torch.Tensor, g: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """The tensor cores' chunked backward of bf16 CUDA tensors: per chunk
    the ``xent_dlogits_tc`` kernel, then ``dh_c = dl @ W.T`` and ``dW +=
    h_c.T @ dl`` on cuBLAS in bf16.  Returns (dh (T, D), dW (D, V), the
    first cudaError_t of the kernel's launches)."""
    t = hidden.shape[0]
    v = weights.shape[1]
    rows = chunk_rows(v, 2)
    dh = torch.empty_like(hidden)
    dw = torch.empty_like(weights)
    dl_buf = torch.empty((min(t, rows), v), dtype=weights.dtype, device=weights.device)
    err = 0
    for c0 in range(0, t, rows):
        c1 = min(t, c0 + rows)
        hc = hidden[c0:c1]
        dl = dl_buf[:c1 - c0]
        err = err or _xent_dlogits_tc(hc, weights, labels[c0:c1], lse[c0:c1], g[c0:c1], dl)
        torch.mm(dl, weights.t(), out=dh[c0:c1])
        if c0 == 0:
            torch.mm(hc.t(), dl, out=dw)
        else:
            dw.addmm_(hc.t(), dl)
    return dh, dw, err


def fused_xent_bwd(hidden: torch.Tensor, weights: torch.Tensor, labels: torch.Tensor,
                   lse: torch.Tensor, g: torch.Tensor, *, route: Optional[str] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward on CUDA tensors, by :func:`xent_bwd_route`
    (``route=F32_FMA`` forces the f32-FMA route, to time it beside the
    other): g (T,) f32, the upstream gradient of the per-token loss -> (dh,
    dW) in the inputs' dtype."""
    from .build import record_launch
    _check_cuda(hidden, weights, labels)
    for x in (lse, g):
        if x.device != hidden.device or x.dtype != torch.float32 or x.shape != labels.shape \
                or not x.is_contiguous():
            raise ValueError("fused_xent_bwd takes lse and g as contiguous (T,) f32 on "
                             "hidden's device")
    chosen = xent_bwd_route(hidden, weights)
    if route not in (None, chosen, F32_FMA):
        raise ValueError(f"route {route!r}: these tensors take {chosen!r} or {F32_FMA!r}")
    if (route or chosen) == TENSOR_CORES:
        dh, dw, err = xent_backward_tc(hidden, weights, labels, lse, g)
        record_launch(err, "fused_xent_bwd_tc")
    else:
        dh, dw, err = xent_backward(hidden, weights, labels, lse, g)
        record_launch(err, "fused_xent_bwd")
    return dh, dw


class FusedXent(torch.autograd.Function):
    """Per-token loss of CUDA tensors through the B4 kernels, with its
    backward: ``FusedXent.apply(hidden, weights, labels)`` -> (T,) f32."""

    @staticmethod
    def forward(ctx, hidden, weights, labels):
        loss, lse = fused_xent(hidden, weights, labels)
        ctx.save_for_backward(hidden, weights, labels, lse)
        return loss

    @staticmethod
    def backward(ctx, g):
        hidden, weights, labels, lse = ctx.saved_tensors
        dh, dw = fused_xent_bwd(hidden, weights, labels, lse,
                                g.to(torch.float32).contiguous())
        return dh, dw, None


__all__ = ["CHUNK_BYTES", "FusedXent", "check_shapes", "chunk_rows",
           "fused_xent", "fused_xent_bwd", "fused_xent_plain", "xent_backward",
           "xent_backward_tc", "xent_bwd_route", "xent_route", "xent_splits"]
