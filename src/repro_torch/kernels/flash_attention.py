"""Causal GQA attention over a whole sequence (the prefill's attention): the
CUDA kernel (``csrc/flash_attention.cu``) and its plain PyTorch version.

Layout, as the model holds it: q (B, Sq, H, D); k, v (B, Sk, Hkv, D) with
H % Hkv == 0; out (B, Sq, H, D) in q's dtype.  Query head h reads KV head
``h // (H // Hkv)``.  Query i attends to key j where ``j <= i`` (causal) and,
with ``window > 0``, ``i - j < window``; scores are scaled by 1/sqrt(D).

  * :func:`flash_attention` — launches a forward kernel on CUDA tensors
    (f32 or bf16, head_dim in :data:`HEAD_DIMS`, contiguous, 1 <= Sq <= Sk)
    by the route :func:`attention_route` picks: ``tensor_cores``
    (``csrc/flash_attention_tc.cu``: wgmma with TMA loads; bf16, head_dim in
    :data:`TC_HEAD_DIMS`, 16-byte aligned) or ``f32_fma``
    (``csrc/flash_attention.cu``: every product in f32 FMA, no tensor cores;
    everything else).  Returns the output and the rows' log-sum-exp (B, H,
    Sq) f32, which the backward reads.
  * :func:`flash_attention_bwd` — launches the backward kernels, (dq, dk,
    dv) from the forward's inputs, output and lse and the output's
    gradient, by the route :func:`attention_bwd_route` picks:
    ``tensor_cores`` (``csrc/flash_attention_bwd_tc.cu``: wgmma with TMA
    loads; bf16, head_dim in :data:`TC_BWD_HEAD_DIMS`, 16-byte aligned) or
    ``f32_fma`` (``csrc/flash_attention_bwd.cu``; everything else).
  * :class:`FlashAttention` — the ``autograd.Function`` over the two, the
    path of a CUDA call that needs a gradient.
  * :func:`flash_attention_plain` — what ``repro/kernels/ref.py::
    mha_reference`` computes: the scores materialised in f32, GQA by
    repeating the KV heads, masked with -1e30, softmax in f32.  The CPU
    path and the comparisons on the card use it; its autograd is the
    plain backward.

``kernels/ops.py`` picks between them by the tensor's device and by
whether a gradient is needed.  The launchers count their launches by route
in ``build.LAUNCHES`` (``flash_attention`` and ``flash_attention_bwd`` the
f32-FMA kernels, ``flash_attention_tc`` and ``flash_attention_bwd_tc`` the
tensor-core ones); the launchers themselves record no graph.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

NEG_INF = -1e30
#: head dims the kernels are built for
HEAD_DIMS = (32, 64, 80, 128, 256)
#: head dims of the tensor-core route: whole 64-column (128-byte) TMA boxes
TC_HEAD_DIMS = (64, 128, 256)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: head dims of the backward's tensor-core route: at 256 the dK and dV
#: accumulators of a warpgroup's 64 keys (256 f32 a thread) overflow the
#: registers, so D 256 stays on the f32-FMA route
TC_BWD_HEAD_DIMS = (64, 128)
#: the routes (see :func:`attention_route`, :func:`attention_bwd_route`)
TENSOR_CORES, F32_FMA = "tensor_cores", "f32_fma"
#: tiles of the backward's tensor-core kernels: the dK/dV kernel's keys a
#: block and queries a step, the dQ kernel's query rows a block and keys a
#: step; a warpgroup owns 64 keys or rows (csrc/flash_attention_bwd_tc.cu)
BWD_KEYS, BWD_QUERIES, DQ_ROWS, DQ_KEYS, WG_ROWS = 128, 64, 128, 64, 64


def tma_ok(t: torch.Tensor) -> bool:
    """Whether TMA can describe ``t``: a 16-byte aligned base address, unit
    stride in the last dim and every other stride a multiple of 16 bytes."""
    return (t.data_ptr() % 16 == 0 and t.stride(-1) == 1
            and all(st * t.element_size() % 16 == 0 for st in t.stride()[:-1]))


def attention_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The forward's route for these tensors: :data:`TENSOR_CORES` for bf16
    at a head_dim of :data:`TC_HEAD_DIMS` that TMA can read, else
    :data:`F32_FMA` (f32 keeps exact f32 products; head dims 32 and 80 do
    not fill a 128-byte box; a misaligned view is not a TMA tensor)."""
    if (q.dtype == torch.bfloat16 and q.shape[-1] in TC_HEAD_DIMS
            and all(tma_ok(t) for t in (q, k, v))):
        return TENSOR_CORES
    return F32_FMA


def attention_bwd_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, dout: torch.Tensor) -> str:
    """The backward's route: :data:`TENSOR_CORES` for bf16 at a head_dim of
    :data:`TC_BWD_HEAD_DIMS` where TMA can read q, k, v, out and dout, else
    :data:`F32_FMA` (f32 keeps exact f32 products; head dims 32 and 80 do
    not fill a 128-byte box, and 256 does not fit the registers; a
    misaligned view is not a TMA tensor)."""
    if (q.dtype == torch.bfloat16 and q.shape[-1] in TC_BWD_HEAD_DIMS
            and all(tma_ok(t) for t in (q, k, v, out, dout))):
        return TENSOR_CORES
    return F32_FMA


def _tile_live(q0: int, q1: int, k0: int, k1: int, sq: int, sk: int, window: int) -> bool:
    """Whether queries [q0, q1] and keys [k0, k1] hold a live pair (the
    kernels' skip rule: their largest query sees their first key, and the
    window reaches from their first query to their last key)."""
    q1, k1 = min(q1, sq - 1), min(k1, sk - 1)
    return q0 < sq and k0 < sk and k0 <= q1 and (window <= 0 or q0 - k1 < window)


def bwd_tc_walks(sq: int, sk: int, window: int = 0):
    """The tile walks of the backward's tensor-core kernels, per head, as
    they compute them: ``(dkdv, dq)``, each {(block, warpgroup): [(first
    query, first key) of each tile the warpgroup computes]}.  dK/dV: block
    ``k0`` (:data:`BWD_KEYS` keys, a warpgroup's 64 from ``k0 + 64 wg``)
    walks the :data:`BWD_QUERIES`-query tiles from ``k0`` to Sq (to ``k0 +
    BWD_KEYS - 1 + window`` with a window).  dQ: block ``q0``
    (:data:`DQ_ROWS` rows, 64 a warpgroup) walks :data:`DQ_KEYS`-key tiles
    from ``max(0, q0 - window + 1)`` (0 without a window) to ``min(Sk, q0 +
    DQ_ROWS)``.  A warpgroup skips a tile with no live pair."""
    dkdv, dq = {}, {}
    for k0 in range(0, sk, BWD_KEYS):
        q_end = min(sq, k0 + BWD_KEYS - 1 + window) if window > 0 else sq
        for wg in range(BWD_KEYS // WG_ROWS):
            kw0 = k0 + WG_ROWS * wg
            dkdv[k0, wg] = [(qt, kw0) for qt in range(k0, q_end, BWD_QUERIES)
                            if _tile_live(qt, qt + BWD_QUERIES - 1, kw0, kw0 + WG_ROWS - 1,
                                          sq, sk, window)]
    for q0 in range(0, sq, DQ_ROWS):
        k_begin = max(0, q0 - window + 1) if window > 0 else 0
        k_end = min(sk, q0 + DQ_ROWS)
        for wg in range(DQ_ROWS // WG_ROWS):
            qw0 = q0 + WG_ROWS * wg
            dq[q0, wg] = [(qw0, kt) for kt in range(k_begin, k_end, DQ_KEYS)
                          if _tile_live(qw0, qw0 + WG_ROWS - 1, kt, kt + DQ_KEYS - 1,
                                        sq, sk, window)]
    return dkdv, dq


def causal_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, window: int = 0) -> torch.Tensor:
    """(q, k) boolean mask, True = attend (the reference's ``causal_mask``)."""
    diff = q_pos[:, None] - k_pos[None, :]
    mask = diff >= 0
    if window > 0:
        mask = mask & (diff < window)
    return mask


def attend_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """Softmax attention with materialised f32 scores.  q (B, Sq, H, D); k, v
    (B, Sk, Hkv, D); mask (Sq, Sk).  Returns (B, Sq, H, D) in q's dtype."""
    groups = q.shape[2] // k.shape[2]
    kf = k.to(torch.float32).repeat_interleave(groups, dim=2)
    vf = v.to(torch.float32).repeat_interleave(groups, dim=2)
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32), kf) * scale
    s = torch.where(mask, s, torch.full((), NEG_INF, device=s.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vf).to(q.dtype)


def check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"attention takes q (B, Sq, H, D) and k, v (B, Sk, Hkv, D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.shape[0] != k.shape[0] or q.shape[3] != k.shape[3] or q.shape[2] % k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree on batch or "
                         f"head_dim, or H is not a multiple of Hkv")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          window: int = 0) -> torch.Tensor:
    """Plain version of :func:`flash_attention` (``ref.mha_reference``)."""
    check_shapes(q, k, v)
    mask = causal_mask(torch.arange(q.shape[1], device=q.device),
                       torch.arange(k.shape[1], device=q.device), window)
    return attend_plain(q, k, v, mask)


def check_cuda_inputs(name: str, *tensors: torch.Tensor) -> None:
    """What both attention launchers require of their tensors."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"the {name} launcher has no backward of its own: call it "
                           f"under torch.no_grad() (kernels.ops.flash_attention is the "
                           f"differentiable attention)")
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"the {name} kernel takes CUDA tensors, got {t.device}")
        if t.device.index != torch.cuda.current_device():
            raise ValueError(f"tensor on {t.device} but the current device is "
                             f"cuda:{torch.cuda.current_device()}")
        if t.dtype not in DTYPE_CODES or t.dtype != tensors[0].dtype:
            raise TypeError(f"the {name} kernel takes float32 or bfloat16 tensors of "
                            f"one dtype, got {[x.dtype for x in tensors]}")
        if not t.is_contiguous():
            raise ValueError(f"the {name} kernel takes contiguous tensors")
    if tensors[0].shape[-1] not in HEAD_DIMS:
        raise ValueError(f"the {name} kernel is built for head_dim in {HEAD_DIMS}, got "
                         f"{tensors[0].shape[-1]}")


def _check_launch(q: torch.Tensor, k: torch.Tensor, window: int) -> None:
    sq, sk = q.shape[1], k.shape[1]
    if not 1 <= sq <= sk or window < 0:
        raise ValueError(f"the flash_attention kernels take 1 <= Sq <= Sk and window >= 0 "
                         f"(a query past the last key has no key); got Sq {sq}, Sk {sk}, "
                         f"window {window}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: int = 0, route: Optional[str] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch a flash-attention forward kernel, by :func:`attention_route`
    (``route=F32_FMA`` forces the f32-FMA kernel, to time it beside the
    other): q (B, Sq, H, D), k, v (B, Sk, Hkv, D) -> (out (B, Sq, H, D), lse
    (B, H, Sq) f32)."""
    from .build import load, record_launch
    check_cuda_inputs("flash_attention", q, k, v)
    check_shapes(q, k, v)
    _check_launch(q, k, window)
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(), b, sq,
            sk, h, hkv, d, window, 1.0 / math.sqrt(d))
    chosen = attention_route(q, k, v)
    if route not in (None, chosen, F32_FMA):
        raise ValueError(f"route {route!r}: these tensors take {chosen!r} or {F32_FMA!r}")
    if (route or chosen) == TENSOR_CORES:
        err = load("flash_attention_tc").repro_flash_attention_tc(*args, stream)
        record_launch(err, "flash_attention_tc")
    else:
        err = load("flash_attention").repro_flash_attention(*args, DTYPE_CODES[q.dtype],
                                                            stream)
        record_launch(err, "flash_attention")
    return out, lse


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, dout: torch.Tensor, lse: torch.Tensor, *,
                        window: int = 0, route: Optional[str] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the backward kernels, by :func:`attention_bwd_route`
    (``route=F32_FMA`` forces the f32-FMA kernels, to time them beside the
    others): the forward's q, k, v, out and lse and the output's gradient
    ``dout`` -> (dq, dk, dv) in q's dtype."""
    from .build import load, record_launch
    check_cuda_inputs("flash_attention_bwd", q, k, v, out, dout)
    check_shapes(q, k, v)
    _check_launch(q, k, window)
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"out {tuple(out.shape)} and dout {tuple(dout.shape)} must be q's "
                         f"shape {tuple(q.shape)}")
    if (lse.shape != (b, h, sq) or lse.dtype != torch.float32 or lse.device != q.device
            or not lse.is_contiguous()):
        raise ValueError(f"lse must be a contiguous ({b}, {h}, {sq}) f32 tensor on "
                         f"{q.device}")
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b,
            sq, sk, h, hkv, d, window, 1.0 / math.sqrt(d))
    chosen = attention_bwd_route(q, k, v, out, dout)
    if route not in (None, chosen, F32_FMA):
        raise ValueError(f"route {route!r}: these tensors take {chosen!r} or {F32_FMA!r}")
    if (route or chosen) == TENSOR_CORES:
        err = load("flash_attention_bwd_tc").repro_flash_attention_bwd_tc(*args, stream)
        record_launch(err, "flash_attention_bwd_tc")
    else:
        err = load("flash_attention_bwd").repro_flash_attention_bwd(
            *args, DTYPE_CODES[q.dtype], stream)
        record_launch(err, "flash_attention_bwd")
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Attention of CUDA tensors through the B5 kernels, with its backward:
    ``FlashAttention.apply(q, k, v, window)`` -> (B, Sq, H, D)."""

    @staticmethod
    def forward(ctx, q, k, v, window):
        out, lse = flash_attention(q, k, v, window=window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.window = window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout.contiguous(), lse,
                                         window=ctx.window)
        return dq, dk, dv, None


__all__ = ["F32_FMA", "FlashAttention", "HEAD_DIMS", "NEG_INF", "TC_BWD_HEAD_DIMS",
           "TC_HEAD_DIMS", "TENSOR_CORES", "attend_plain", "attention_bwd_route",
           "attention_route", "bwd_tc_walks", "causal_mask", "flash_attention",
           "flash_attention_bwd", "flash_attention_plain", "tma_ok"]
