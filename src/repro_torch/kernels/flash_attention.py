"""GQA attention over a whole sequence (the prefill's attention), causal or
not: the CUDA kernels (``csrc/flash_attention.cu``,
``csrc/flash_attention_tc.cu``) and their plain PyTorch version.

Layout, as the model holds it: q (B, Sq, H, D); k, v (B, Sk, Hkv, D) with
H % Hkv == 0; out (B, Sq, H, D) in q's dtype.  Query head h reads KV head
``h // (H // Hkv)``.  Query i attends to key j where ``j <= i`` (causal) and,
with ``window > 0``, ``i - j < window``; scores are scaled by 1/sqrt(D).
With ``causal=False`` (the reference's ``causal`` flag) only the window
masks, keys ahead of the query stay live, and Sq may exceed Sk.  A query
row with no live key (``causal=False``, a window, a query at or past ``Sk
+ window - 1``) takes the reference kernel's value for it, not the
oracle's (:func:`dead_row_begin`).

  * :func:`flash_attention` — launches a forward kernel on CUDA tensors
    (f32 or bf16, head_dim in :data:`HEAD_DIMS`, contiguous, 1 <= Sq <= Sk
    when causal)
    by the route :func:`attention_route` picks: ``tensor_cores``
    (``csrc/flash_attention_tc.cu``: wgmma with TMA loads; bf16, head_dim in
    :data:`TC_HEAD_DIMS`, 80 held at a depth of 128 (:data:`TC_DEPTH`),
    16-byte aligned) or ``f32_fma`` (``csrc/flash_attention.cu``: every
    product in f32 FMA, no tensor cores; f32, head dim 32, a misaligned
    view).  Returns the output and the rows' log-sum-exp (B, H,
    Sq) f32, which the backward reads.
  * :func:`flash_attention_bwd` — launches the backward kernels, (dq, dk,
    dv) from the forward's inputs, output and lse and the output's
    gradient, by the route :func:`attention_bwd_route` picks:
    ``tensor_cores`` (``csrc/flash_attention_bwd_tc.cu``: wgmma with TMA
    loads; bf16, head_dim in :data:`TC_BWD_HEAD_DIMS`, 16-byte aligned; the
    tiles of :func:`bwd_tc_tiles`) or ``f32_fma``
    (``csrc/flash_attention_bwd.cu``; f32, head dim 32, a misaligned
    view).
  * :class:`FlashAttention` — the ``autograd.Function`` over the two, the
    path of a CUDA call that needs a gradient, causal or not (a non-causal
    call with a row that sees no key is refused: :data:`DEAD_ROW_BACKWARD`).
  * :func:`flash_attention_plain` — what ``repro/kernels/ref.py::
    mha_reference`` computes: the scores materialised in f32, GQA by
    repeating the KV heads, masked with -1e30, softmax in f32.  The CPU
    path and the comparisons on the card use it; its autograd is the
    plain backward.  Its rows with no live key follow the reference
    kernel (:func:`dead_row_begin`).

``kernels/ops.py`` picks between them by the tensor's device and by
whether a gradient is needed.  The launchers count their launches by route
and mode in ``build.LAUNCHES`` (``flash_attention`` and
``flash_attention_bwd`` the f32-FMA kernels, ``flash_attention_tc`` and
``flash_attention_bwd_tc`` the tensor-core ones, each with ``_noncausal``
for a call with ``causal=False``); the launchers themselves record no
graph.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from .observe import entry, is_meta

NEG_INF = -1e30
#: head dims the kernels are built for
HEAD_DIMS = (32, 64, 80, 128, 256)
#: head dims of the tensor-core route (a head in whole 64-column, 128-byte
#: TMA boxes; 32 would fill half of one)
TC_HEAD_DIMS = (64, 80, 128, 256)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: head dims of the backward's tensor-core route: the forward's (at 256 the
#: two warpgroups split D, :func:`bwd_tc_tiles`)
TC_BWD_HEAD_DIMS = TC_HEAD_DIMS
#: the depth the tensor-core kernels hold a head at in shared memory, whole
#: 64-column boxes (``sm90::box_depth``): 80 is padded to two, whose columns
#: past 80 TMA fills with zeros (the tensor maps keep the real D; every
#: store uses it)
TC_DEPTH = {d: -(-d // 64) * 64 for d in TC_HEAD_DIMS}
#: the routes (see :func:`attention_route`, :func:`attention_bwd_route`)
TENSOR_CORES, F32_FMA = "tensor_cores", "f32_fma"
#: a warpgroup's rows (keys or queries) in the backward's tensor-core kernels
WG_ROWS = 64


def tma_ok(t: torch.Tensor) -> bool:
    """Whether TMA can describe ``t``: a 16-byte aligned base address, unit
    stride in the last dim and every other stride a multiple of 16 bytes."""
    return (t.data_ptr() % 16 == 0 and t.stride(-1) == 1
            and all(st * t.element_size() % 16 == 0 for st in t.stride()[:-1]))


def attention_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The forward's route for these tensors: :data:`TENSOR_CORES` for bf16
    at a head_dim of :data:`TC_HEAD_DIMS` that TMA can read, else
    :data:`F32_FMA` (f32 keeps exact f32 products; head dim 32 fills half a
    128-byte box; a misaligned view is not a TMA tensor)."""
    if (q.dtype == torch.bfloat16 and q.shape[-1] in TC_HEAD_DIMS
            and all(tma_ok(t) for t in (q, k, v))):
        return TENSOR_CORES
    return F32_FMA


def attention_bwd_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, dout: torch.Tensor) -> str:
    """The backward's route: :data:`TENSOR_CORES` for bf16 at a head_dim of
    :data:`TC_BWD_HEAD_DIMS` where TMA can read q, k, v, out and dout, else
    :data:`F32_FMA` (f32 keeps exact f32 products; head dim 32 fills half a
    128-byte box; a misaligned view is not a TMA tensor)."""
    if (q.dtype == torch.bfloat16 and q.shape[-1] in TC_BWD_HEAD_DIMS
            and all(tma_ok(t) for t in (q, k, v, out, dout))):
        return TENSOR_CORES
    return F32_FMA


def _tile_live(q0: int, q1: int, k0: int, k1: int, sq: int, sk: int, window: int,
               causal: bool = True) -> bool:
    """Whether queries [q0, q1] and keys [k0, k1] hold a live pair (the
    kernels' skip rule: causal, their largest query sees their first key;
    and the window reaches from their first query to their last key)."""
    q1, k1 = min(q1, sq - 1), min(k1, sk - 1)
    return (q0 < sq and k0 < sk and (not causal or k0 <= q1)
            and (window <= 0 or q0 - k1 < window))


class BwdTiles(NamedTuple):
    """The tiles of the backward's tensor-core kernels at one head dim
    (``BwdTile<D>`` in csrc/flash_attention_bwd_tc.cu): the depth held in
    shared memory, the dK/dV kernel's keys a block and queries a step, the
    dQ kernel's query rows a block and keys a step, and whether the two
    warpgroups split D (each owning ``depth // 2`` columns of the same 64
    keys or rows) rather than the rows (64 each, the same columns)."""
    depth: int
    keys: int
    queries: int
    rows: int
    key_step: int
    split: bool

    def cols(self, wg: int) -> slice:
        """The columns of dK, dV (or dQ) at the padded depth that warpgroup
        ``wg`` sums."""
        half = self.depth // 2
        return slice(wg * half, (wg + 1) * half) if self.split else slice(0, self.depth)

    def row0(self, wg: int) -> int:
        """Warpgroup ``wg``'s first key (dK/dV) or row (dQ) in its block."""
        return 0 if self.split else WG_ROWS * wg


def bwd_tc_tiles(d: int) -> BwdTiles:
    """The backward's tensor-core tiles at head dim ``d``: 128 keys (rows) a
    block, 64 a warpgroup, up to a depth of 128; at 256 (whose dK and dV of
    64 keys x 256 columns fit neither a thread's registers nor, at 128 keys,
    shared memory) 64 keys (rows) a block, the warpgroups splitting D."""
    depth = TC_DEPTH[d]
    split = depth == 256
    block = 64 if split else 128
    return BwdTiles(depth, block, 64, block, 64, split)


def bwd_tc_constants() -> dict:
    """What ``repro_flash_attention_bwd_tc_constants`` writes, from
    :func:`bwd_tc_tiles` (``build.check_constants`` holds the two equal on
    the card's first launch)."""
    out = {}
    for d in TC_BWD_HEAD_DIMS:
        t = bwd_tc_tiles(d)
        out.update({f"DP{d}": t.depth, f"BKV{d}": t.keys, f"BQR{d}": t.rows,
                    f"kSplit{d}": int(t.split)})
    t = bwd_tc_tiles(64)
    return {**out, "BQ": t.queries, "BK": t.key_step}


def bwd_tc_walks(sq: int, sk: int, window: int = 0, causal: bool = True, d: int = 128):
    """The tile walks of the backward's tensor-core kernels at head dim
    ``d``, per head, as they compute them: ``(dkdv, dq)``, each {(block,
    warpgroup): [(first query, first key) of each tile the warpgroup
    computes]}, with ``t = bwd_tc_tiles(d)``.  dK/dV: block ``k0`` (``t.keys``
    keys; a warpgroup's 64 from ``k0 + t.row0(wg)``) walks the
    ``t.queries``-query tiles from ``k0`` (causal) or 0 to Sq (to ``k0 +
    t.keys - 1 + window`` with a window).  dQ: block ``q0`` (``t.rows``
    rows, 64 a warpgroup) walks ``t.key_step``-key tiles from ``max(0, q0 -
    window + 1)`` (0 without a window) to ``min(Sk, q0 + t.rows)`` (causal)
    or Sk.  A warpgroup skips a tile with no live pair.  Where the
    warpgroups split D, both walk the same tiles, each over its own
    columns (``t.cols``)."""
    t = bwd_tc_tiles(d)
    dkdv, dq = {}, {}
    for k0 in range(0, sk, t.keys):
        q_end = min(sq, k0 + t.keys - 1 + window) if window > 0 else sq
        for wg in range(2):
            kw0 = k0 + t.row0(wg)
            dkdv[k0, wg] = [(qt, kw0) for qt in range(k0 if causal else 0, q_end, t.queries)
                            if _tile_live(qt, qt + t.queries - 1, kw0, kw0 + WG_ROWS - 1,
                                          sq, sk, window, causal)]
    for q0 in range(0, sq, t.rows):
        k_begin = max(0, q0 - window + 1) if window > 0 else 0
        k_end = min(sk, q0 + t.rows) if causal else sk
        for wg in range(2):
            qw0 = q0 + t.row0(wg)
            dq[q0, wg] = [(qw0, kt) for kt in range(k_begin, k_end, t.key_step)
                          if _tile_live(qw0, qw0 + WG_ROWS - 1, kt, kt + t.key_step - 1,
                                        sq, sk, window, causal)]
    return dkdv, dq


def causal_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, window: int = 0,
                causal: bool = True) -> torch.Tensor:
    """(q, k) boolean mask, True = attend (the reference's ``causal_mask``;
    with ``causal=False`` only the window masks, as its kernel does)."""
    diff = q_pos[:, None] - k_pos[None, :]
    mask = diff >= 0 if causal else torch.ones_like(diff, dtype=torch.bool)
    if window > 0:
        mask = mask & (diff < window)
    return mask


#: the reference op's tiles (``repro/kernels/ops.py::flash_attention``'s
#: block_q and block_k), which decide a dead row's value
REF_BLOCK = 128


def dead_row_begin(q: int, sq: int, sk: int, window: int) -> int:
    """The first key of the keys whose mean of v a query row with no live
    key gets (``causal=False``, a window, ``q >= Sk + window - 1``): the
    reference kernel masks such a row to -1e30 in every key tile its query
    tile finds live, its running max stays -1e30 and each of those keys
    weighs exp(0) = 1.  The live tiles of a query tile (:data:`REF_BLOCK`
    rows and keys, fewer where Sq or Sk is shorter) are a suffix of the
    keys; the row's value is the mean of v over [this, Sk), or 0 where
    that is empty (``ref.mha_reference`` instead gives the mean over all
    Sk keys).  ``csrc/attention_rows.cuh`` is the same rule."""
    bq, bk = min(REF_BLOCK, sq), min(REF_BLOCK, sk)
    x = (q // bq) * bq - window - bk + 1
    return 0 if x < 0 else (x // bk + 1) * bk


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
                          causal: bool = True, window: int = 0) -> torch.Tensor:
    """Plain version of :func:`flash_attention` (``ref.mha_reference``, but
    for the rows with no live key: those follow the reference kernel,
    :func:`dead_row_begin`)."""
    check_shapes(q, k, v)
    sq, sk = q.shape[1], k.shape[1]
    mask = causal_mask(torch.arange(sq, device=q.device), torch.arange(sk, device=q.device),
                       window, causal)
    out = attend_plain(q, k, v, mask)
    dead = [i for i in range(max(0, sk + window - 1), sq)] if not causal and window > 0 else []
    if dead:
        groups = q.shape[2] // k.shape[2]
        vf = v.to(torch.float32).repeat_interleave(groups, dim=2)
        rows = []
        for i in dead:
            kb = dead_row_begin(i, sq, sk, window)
            rows.append(vf[:, kb:].mean(dim=1) if kb < sk else torch.zeros_like(vf[:, 0]))
        out = out.clone()
        out[:, dead] = torch.stack(rows, dim=1).to(out.dtype)
    return out


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


def _check_launch(q: torch.Tensor, k: torch.Tensor, window: int, causal: bool = True) -> None:
    sq, sk = q.shape[1], k.shape[1]
    if sq < 1 or sk < 1 or (causal and sq > sk) or window < 0:
        raise ValueError(f"the flash_attention kernels take Sq, Sk >= 1, Sq <= Sk when causal "
                         f"(a query past the last key has no key) and window >= 0; got Sq "
                         f"{sq}, Sk {sk}, window {window}, causal {causal}")


#: why a non-causal call with a row that sees no key has no gradient here
DEAD_ROW_BACKWARD = (
    "B5's backward takes no query row that sees no key: with causal=False and a window, the "
    "rows at or past Sk + window - 1 (Sq >= Sk + window) take the reference kernel's suffix "
    "mean of v (dead_row_begin), which the backward kernels do not differentiate; no path of "
    "the repository makes such a call.  Call it under torch.no_grad(), or on the CPU")


def has_dead_rows(sq: int, sk: int, window: int, causal: bool) -> bool:
    """Whether some query row sees no key: not causal, a window, and Sq >=
    Sk + window (causal, every row sees its own key)."""
    return not causal and window > 0 and sq >= sk + window


def check_differentiable(q: torch.Tensor, k: torch.Tensor, window: int, causal: bool) -> None:
    """Raise :data:`DEAD_ROW_BACKWARD` where a call has a row with no live
    key: the kernels' backward covers every other call."""
    if has_dead_rows(q.shape[1], k.shape[1], window, causal):
        raise NotImplementedError(f"{DEAD_ROW_BACKWARD} (Sq {q.shape[1]}, Sk {k.shape[1]}, "
                                  f"window {window})")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, route: Optional[str] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch a flash-attention forward kernel, by :func:`attention_route`
    (``route=F32_FMA`` forces the f32-FMA kernel, to time it beside the
    other): q (B, Sq, H, D), k, v (B, Sk, Hkv, D) -> (out (B, Sq, H, D), lse
    (B, H, Sq) f32).  ``causal`` is a runtime argument of both kernels."""
    from .build import load, record_launch
    check_cuda_inputs("flash_attention", q, k, v)
    check_shapes(q, k, v)
    _check_launch(q, k, window, causal)
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(), b, sq,
            sk, h, hkv, d, window, int(causal), 1.0 / math.sqrt(d))
    chosen = attention_route(q, k, v)
    if route not in (None, chosen, F32_FMA):
        raise ValueError(f"route {route!r}: these tensors take {chosen!r} or {F32_FMA!r}")
    mode = "" if causal else "_noncausal"
    if (route or chosen) == TENSOR_CORES:
        err = load("flash_attention_tc").repro_flash_attention_tc(*args, stream)
        record_launch(err, "flash_attention_tc" + mode)
    else:
        err = load("flash_attention").repro_flash_attention(*args, DTYPE_CODES[q.dtype],
                                                            stream)
        record_launch(err, "flash_attention" + mode)
    return out, lse


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, dout: torch.Tensor, lse: torch.Tensor, *,
                        causal: bool = True, window: int = 0, route: Optional[str] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the backward kernels, by :func:`attention_bwd_route`
    (``route=F32_FMA`` forces the f32-FMA kernels, to time them beside the
    others): the forward's q, k, v, out and lse and the output's gradient
    ``dout`` -> (dq, dk, dv) in q's dtype.  ``causal`` is the forward's (a
    runtime argument of both kernels); a non-causal call with a row that
    sees no key raises :data:`DEAD_ROW_BACKWARD`."""
    from .build import check_constants, load, record_launch
    check_cuda_inputs("flash_attention_bwd", q, k, v, out, dout)
    check_shapes(q, k, v)
    _check_launch(q, k, window, causal)
    check_differentiable(q, k, window, causal)
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
            sq, sk, h, hkv, d, window, int(causal), 1.0 / math.sqrt(d))
    chosen = attention_bwd_route(q, k, v, out, dout)
    if route not in (None, chosen, F32_FMA):
        raise ValueError(f"route {route!r}: these tensors take {chosen!r} or {F32_FMA!r}")
    mode = "" if causal else "_noncausal"
    if (route or chosen) == TENSOR_CORES:
        check_constants("flash_attention_bwd_tc", bwd_tc_constants())
        err = load("flash_attention_bwd_tc").repro_flash_attention_bwd_tc(*args, stream)
        record_launch(err, "flash_attention_bwd_tc" + mode)
    else:
        err = load("flash_attention_bwd").repro_flash_attention_bwd(
            *args, DTYPE_CODES[q.dtype], stream)
        record_launch(err, "flash_attention_bwd" + mode)
    return dq, dk, dv


def flash_attention_meta(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The meta rule of the forward: (out, lse) of the kernel's shapes and
    dtypes on the ``meta`` device, empty; nothing launches and nothing is
    computed (``launch/dryrun.py`` traces a step at full size so)."""
    check_shapes(q, k, v)
    b, sq, h, _ = q.shape
    return torch.empty_like(q), torch.empty((b, h, sq), dtype=torch.float32, device=q.device)


def flash_attention_bwd_meta(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The meta rule of the backward: empty (dq, dk, dv)."""
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


class FlashAttention(torch.autograd.Function):
    """Attention of CUDA tensors through the B5 kernels, with its backward:
    ``FlashAttention.apply(q, k, v, window, causal)`` -> (B, Sq, H, D).  A
    non-causal call with a row that sees no key raises
    :data:`DEAD_ROW_BACKWARD`.  Meta tensors take the meta rule both
    ways."""

    @staticmethod
    def forward(ctx, q, k, v, window, causal=True):
        check_differentiable(q, k, window, causal)
        if is_meta(q, k, v):
            out, lse = flash_attention_meta(q, k, v)
        else:
            out, lse = flash_attention(q, k, v, causal=causal, window=window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.window, ctx.causal = window, causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        with entry("flash_attention_bwd", q, k, v, window=ctx.window, causal=ctx.causal):
            if is_meta(q, k, v):
                dq, dk, dv = flash_attention_bwd_meta(q, k, v)
            else:
                dq, dk, dv = flash_attention_bwd(q, k, v, out, dout.contiguous(), lse,
                                                 causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None


__all__ = ["BwdTiles", "DEAD_ROW_BACKWARD", "F32_FMA", "FlashAttention", "HEAD_DIMS", "NEG_INF",
           "REF_BLOCK", "TC_BWD_HEAD_DIMS", "TC_DEPTH", "TC_HEAD_DIMS", "TENSOR_CORES",
           "WG_ROWS", "attend_plain", "attention_bwd_route", "attention_route", "bwd_tc_constants",
           "bwd_tc_tiles", "bwd_tc_walks", "causal_mask",
           "check_differentiable", "dead_row_begin", "flash_attention", "flash_attention_bwd",
           "flash_attention_bwd_meta", "flash_attention_meta", "flash_attention_plain", "has_dead_rows", "tma_ok"]
