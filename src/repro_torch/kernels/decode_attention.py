"""One new token against the KV cache (each decode step's attention): the
CUDA kernels (``csrc/decode_attention_tc.cu``, ``csrc/decode_attention.cu``)
and their plain PyTorch version.

Layout, as the model holds it: q (B, 1, H, D); the cache's k, v (B, S, Hkv,
D); out (B, 1, H, D) in q's dtype.  The token at position ``index`` attends
to the positions ``k_pos <= index`` and, with ``window > 0``, ``index - k_pos
< window``; later positions are never read.  ``index`` is a host int (0 <=
index < S) or, as the reference takes it, a 0-d int32 tensor on q's device,
which the kernels read on the device (a decode step that a CUDA graph
replays advances it without the host).

  * :func:`decode_attention` — launches a kernel on CUDA tensors by the
    route :func:`decode_route` picks: ``tensor_cores``
    (``csrc/decode_attention_tc.cu``: mma.sync with cp.async loads, one
    launch, the split-K combine inside a thread-block cluster; bf16,
    head_dim in :data:`TC_HEAD_DIMS`, 16-byte aligned) or ``f32_fma``
    (``csrc/decode_attention.cu``: f32 FMAs and a second combine launch;
    f32, head dim 32, misaligned views).
  * :func:`decode_attention_plain` — what ``repro/kernels/ref.py::
    decode_attention_reference`` computes (f32 scores over the whole cache,
    masked with -1e30, softmax in f32).

The partial mode is the reference docstring's flash-decoding schedule over
a sequence-sharded cache (``models/parallel.py::Panels``): each rank holds
one panel k, v (B, S_local, Hkv, D) of the absolute positions [base, base +
S_local), and :func:`decode_attention_partial` (both kernels, a mode of
each) or :func:`decode_attention_partial_plain` give the panel's (out f32
(B, 1, H, D) normalised by its own softmax sum, lse f32 (B, 1, H) = m + log
l); ``index`` stays absolute and may lie before, inside or past the panel.
A panel with no live key gives out = 0 and lse = -inf, with no NaN.
:func:`combine_partials` merges G panels' partials into the one-call
result (the ranks all-gather them first, ``parallel.combine_panels``).

``kernels/ops.py`` picks between them by the tensor's device.  The launcher
counts its launches by route in ``build.LAUNCHES`` (``decode_attention`` the
f32-FMA kernel, ``decode_attention_tc`` the tensor-core one).
"""
from __future__ import annotations

import functools
import math
from typing import Callable, Optional, Tuple, Union

import torch

from .flash_attention import (DTYPE_CODES, F32_FMA, TENSOR_CORES, attend_plain, causal_mask,
                              check_cuda_inputs, check_shapes, tma_ok)

#: blocks the f32-FMA split aims for: four a streaming multiprocessor
BLOCKS_PER_SM = 4
#: fewest keys an f32-FMA split takes (two of the kernel's 32-key tiles)
MIN_CHUNK = 64
#: query heads a block of the f32-FMA kernel takes (kMaxHeads in the source)
HEADS_PER_BLOCK = 8
#: head dims of the tensor-core route: whole pairs of 8-column mma blocks.
#: 64, 128 and 256 keep a stage's rows swizzled (8, 16, 32 16-byte chunks,
#: the XOR by row % 8 inside the row); 80's 10 chunks would be carried
#: into the next row by that XOR, so its rows lie :data:`TC_PITCH80`
#: elements apart, unswizzled.  At 256 q's fragments come from shared
#: memory at each step (its 16 rows, swizzled as a stage's), so that the
#: accumulator's 128 registers a thread fit without a spill
TC_HEAD_DIMS = (64, 80, 128, 256)
#: the tensor-core kernel's stage (keys), query heads a block (the mma's M)
#: and blocks a cluster: kTileKeys, kRows and kMaxSplits of
#: csrc/decode_attention_tc.cu, which the launcher checks against the
#: library's own on first use (:func:`build.check_constants`)
TC_TILE_KEYS, TC_HEADS, TC_MAX_SPLITS = 64, 16, 8
#: its ring's stages at each head dim and D 80's row pitch in elements
#: (kStages64 ..., kPitch80)
TC_STAGES = {64: 4, 80: 4, 128: 3, 256: 3}
TC_PITCH80 = 88
_TC_CONSTANTS = {"kTileKeys": TC_TILE_KEYS, "kRows": TC_HEADS, "kMaxSplits": TC_MAX_SPLITS,
                 **{f"kStages{d}": n for d, n in TC_STAGES.items()}, "kPitch80": TC_PITCH80}

Index = Union[int, torch.Tensor]


def _index_positions(index: Index, device) -> torch.Tensor:
    if isinstance(index, torch.Tensor):
        return index.to(device=device).reshape(1)
    return torch.full((1,), index, device=device)


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, index: Index,
                           *, window: int = 0) -> torch.Tensor:
    """Plain version of :func:`decode_attention`
    (``ref.decode_attention_reference``); ``index`` a host int or a 0-d
    tensor."""
    check_shapes(q, k, v)
    mask = causal_mask(_index_positions(index, q.device),
                       torch.arange(k.shape[1], device=q.device), window)
    return attend_plain(q, k, v, mask)


def decode_attention_partial_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                   index: Index, *, base: int, window: int = 0
                                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`decode_attention_partial`: (out f32 (B, 1,
    H, D) normalised by the panel's own sum, lse f32 (B, 1, H)), f32 scores
    over the panel; out = 0 and lse = -inf where no key is live."""
    check_shapes(q, k, v)
    groups = q.shape[2] // k.shape[2]
    kf = k.to(torch.float32).repeat_interleave(groups, dim=2)
    vf = v.to(torch.float32).repeat_interleave(groups, dim=2)
    sc = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32), kf) * (1.0 / math.sqrt(q.shape[-1]))
    pos = base + torch.arange(k.shape[1], device=q.device)
    idx = _index_positions(index, q.device)
    live = (pos <= idx) & ((idx - pos < window) if window > 0 else True)
    sc = torch.where(live, sc, torch.full((), -math.inf, device=sc.device))
    m = sc.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros((), device=m.device))
    p = torch.exp(sc - m)                                   # exactly 0 where masked
    l = p.sum(dim=-1)                                       # (B, H, 1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, vf) / torch.clamp_min(l, 1e-30).permute(0, 2, 1)[
        ..., None]
    lse = (m[..., 0] + torch.log(l)).permute(0, 2, 1)       # -inf with no live key
    return out, lse


def combine_partials(outs: torch.Tensor, lses: torch.Tensor,
                     dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """G panels' partials -> the attention over all of them: outs (G, B, 1,
    H, D) f32, lses (G, B, 1, H) f32 -> (B, 1, H, D) in ``dtype`` (f32 by
    default).  Each panel weighs exp(lse_g - M), M the largest lse; an empty
    panel (lse -inf) weighs 0, so with one live panel the result is its out
    exactly.  Sums over G in panel order, the same on every rank."""
    big = lses.amax(dim=0)
    big = torch.where(torch.isfinite(big), big, torch.zeros((), device=big.device))
    w = torch.exp(lses - big)                               # (G, B, 1, H)
    num = (w[..., None] * outs).sum(dim=0)
    out = num / torch.clamp_min(w.sum(dim=0), 1e-30)[..., None]
    return out if dtype is None else out.to(dtype)


@functools.lru_cache(maxsize=None)
def _tc_clusters(device_index: int, d: int, splits: int) -> int:
    """How many clusters of ``splits`` tensor-core blocks at head_dim ``d``
    the card holds at once (``cudaOccupancyMaxActiveClusters``)."""
    import ctypes

    from .build import load
    out = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = load("decode_attention_tc").repro_decode_attention_tc_clusters(
            d, splits, ctypes.addressof(out))
    if err != 0 or out.value < 1:
        raise RuntimeError(f"decode_attention_tc: no cluster of {splits} blocks fits the "
                           f"card at head_dim {d} (cudaError_t {err}, {out.value} clusters)")
    return out.value


def live_range(index: int, window: int) -> Tuple[int, int]:
    """The cache positions [begin, end) that the token at ``index`` sees."""
    return (max(0, index - window + 1) if window > 0 else 0), index + 1


def span(s: int, window: int) -> int:
    """The most live keys a token can see in a cache of ``s`` positions:
    what a split covers when ``index`` lies on the device."""
    return min(s, window) if window > 0 else s


def decode_splits(n_keys: int, blocks_per_split: int, sms: int) -> Tuple[int, int]:
    """(chunk, splits) of the f32-FMA kernel: the live keys cut into
    ``splits`` chunks of ``chunk`` keys (a multiple of 32, at least
    :data:`MIN_CHUNK`), so that about ``BLOCKS_PER_SM * sms`` blocks cover
    the card.  Depends on the shape alone, so the sums' order repeats from
    run to run."""
    want = max(1, -(-BLOCKS_PER_SM * sms // blocks_per_split))
    chunk = max(MIN_CHUNK, -(-n_keys // want))
    chunk = -(-chunk // 32) * 32
    return chunk, -(-n_keys // chunk)


def decode_tc_splits(n_keys: int, clusters: int, sms: int,
                     resident: Callable[[int], int]) -> Tuple[int, int]:
    """(chunk, splits) of the tensor-core kernel: a cluster of ``splits``
    (1 to :data:`TC_MAX_SPLITS`) blocks takes ``n_keys`` keys in chunks of
    ``chunk`` (a multiple of :data:`TC_TILE_KEYS`).  The most splits the
    keys fill that give each of the ``sms`` SMs at most one block
    (``clusters * splits <= sms``) and whose clusters all fit at once
    (``resident(splits)``: how many clusters of that size the card holds);
    else one.  On an H100 one streaming block an SM beat two, and a
    cluster that waits for a second wave doubles the time (a sweep of every
    cluster size, PERF.md §6).  Depends on the shape and the card alone."""
    splits = min(TC_MAX_SPLITS, -(-n_keys // TC_TILE_KEYS))
    while splits > 1 and (clusters * splits > sms or clusters > resident(splits)):
        splits -= 1
    chunk = -(-(-(-n_keys // splits)) // TC_TILE_KEYS) * TC_TILE_KEYS
    return chunk, -(-n_keys // chunk)


def decode_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The route for these tensors: :data:`TENSOR_CORES` for bf16 at a
    head_dim of :data:`TC_HEAD_DIMS` whose rows are 16-byte aligned (what
    the 16-byte cp.async copies read), else :data:`F32_FMA` (f32 keeps
    exact f32 products; head dim 32, whose 4-chunk rows the swizzle would
    leave, on no path; a misaligned view)."""
    if (q.dtype == torch.bfloat16 and q.shape[-1] in TC_HEAD_DIMS
            and all(tma_ok(t) for t in (q, k, v))):
        return TENSOR_CORES
    return F32_FMA


def _check_index(index: Index, s: Optional[int], q: torch.Tensor) -> Tuple[Optional[int], int]:
    """(device pointer or None, host index) of a valid ``index`` (``s``
    None: a panel's, any position)."""
    if isinstance(index, torch.Tensor):
        if index.dim() != 0 or index.dtype != torch.int32 or index.device != q.device:
            raise ValueError(f"a tensor index must be a 0-d int32 tensor on {q.device}, "
                             f"got {tuple(index.shape)} {index.dtype} on {index.device}")
        return index.data_ptr(), 0
    index = int(index)
    if s is not None and not 0 <= index < s:
        raise ValueError(f"the decode_attention kernels take 0 <= index < S; got index "
                         f"{index}, S {s}")
    return None, index


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, index: Index, *,
                     window: int = 0, route: Optional[str] = None) -> torch.Tensor:
    """Launch a decode-attention kernel, by :func:`decode_route`
    (``route=F32_FMA`` forces the f32-FMA kernel, to time it beside the
    other): q (B, 1, H, D), the cache's k, v (B, S, Hkv, D), ``index`` a host
    int or a 0-d int32 tensor on the card -> (B, 1, H, D).  With a tensor
    the split covers the whole cache (or window), and blocks past the live
    range contribute nothing."""
    from .build import check_constants, device_limits, load, record_launch
    check_cuda_inputs("decode_attention", q, k, v)
    check_shapes(q, k, v)
    b, one, h, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    if one != 1 or window < 0:
        raise ValueError(f"the decode_attention kernels take one query and window >= 0; "
                         f"got q {tuple(q.shape)}, window {window}")
    index_ptr, index_host = _check_index(index, s, q)
    if index_ptr is None:
        begin, end = live_range(index_host, window)
        n_keys = end - begin
    else:
        n_keys = span(s, window)
    chosen = decode_route(q, k, v)
    if route not in (None, chosen, F32_FMA):
        raise ValueError(f"route {route!r}: these tensors take {chosen!r} or {F32_FMA!r}")
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    scale = 1.0 / math.sqrt(d)
    if (route or chosen) == TENSOR_CORES:
        lib = load("decode_attention_tc")
        check_constants("decode_attention_tc", _TC_CONSTANTS)
        clusters = b * hkv * -(-(h // hkv) // TC_HEADS)
        chunk, splits = decode_tc_splits(n_keys, clusters, device_limits(q.device.index)[0],
                                         functools.partial(_tc_clusters, q.device.index, d))
        err = lib.repro_decode_attention_tc(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), index_ptr, index_host,
            b, s, h, hkv, d, window, chunk, splits, scale, stream)
        record_launch(err, "decode_attention_tc")
        return out
    head_chunks = -(-(h // hkv) // HEADS_PER_BLOCK)
    chunk, splits = decode_splits(n_keys, b * hkv * head_chunks,
                                  device_limits(q.device.index)[0])
    ws = torch.empty((b, h, splits, d + 2), dtype=torch.float32, device=q.device)
    err = load("decode_attention").repro_decode_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), ws.data_ptr(), index_ptr,
        index_host, b, s, h, hkv, d, window, chunk, splits, scale, DTYPE_CODES[q.dtype],
        stream)
    record_launch(err, "decode_attention")
    return out


def panel_keys(index: int, base: int, s: int, window: int) -> int:
    """How many rows of the panel [base, base + s) the token at the
    absolute ``index`` sees (0 for a panel before its window or past it)."""
    begin, end = live_range(index, window)
    return max(0, min(end, base + s) - max(begin, base))


def decode_attention_partial(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, index: Index,
                             *, base: int, window: int = 0, route: Optional[str] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch a decode-attention kernel in its partial mode over one panel
    (k, v (B, S_local, Hkv, D) holding the positions [base, base +
    S_local)), by :func:`decode_route` as :func:`decode_attention`:
    (out f32 (B, 1, H, D), lse f32 (B, 1, H)).  ``index`` is absolute, a
    host int (any position: the split covers the panel's live keys) or a
    0-d int32 tensor on the card (the split covers min(S_local, window)
    keys).  A panel with no live key still launches, and the kernel writes
    its out = 0 and lse = -inf."""
    from .build import check_constants, device_limits, load, record_launch
    check_cuda_inputs("decode_attention_partial", q, k, v)
    check_shapes(q, k, v)
    b, one, h, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    if one != 1 or window < 0 or base < 0:
        raise ValueError(f"the decode_attention kernels take one query, window >= 0 and a "
                         f"panel base >= 0; got q {tuple(q.shape)}, window {window}, base {base}")
    index_ptr, index_host = _check_index(index, None, q)
    n_keys = span(s, window) if index_ptr is not None else panel_keys(index_host, base, s, window)
    n_keys = max(n_keys, 1)
    chosen = decode_route(q, k, v)
    if route not in (None, chosen, F32_FMA):
        raise ValueError(f"route {route!r}: these tensors take {chosen!r} or {F32_FMA!r}")
    out = torch.empty((b, 1, h, d), dtype=torch.float32, device=q.device)
    lse = torch.empty((b, 1, h), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    scale = 1.0 / math.sqrt(d)
    if (route or chosen) == TENSOR_CORES:
        lib = load("decode_attention_tc")
        check_constants("decode_attention_tc", _TC_CONSTANTS)
        clusters = b * hkv * -(-(h // hkv) // TC_HEADS)
        chunk, splits = decode_tc_splits(n_keys, clusters, device_limits(q.device.index)[0],
                                         functools.partial(_tc_clusters, q.device.index, d))
        err = lib.repro_decode_attention_tc_partial(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(), index_ptr,
            index_host, base, b, s, h, hkv, d, window, chunk, splits, scale, stream)
        record_launch(err, "decode_attention_partial_tc")
        return out, lse
    head_chunks = -(-(h // hkv) // HEADS_PER_BLOCK)
    chunk, splits = decode_splits(n_keys, b * hkv * head_chunks,
                                  device_limits(q.device.index)[0])
    ws = torch.empty((b, h, splits, d + 2), dtype=torch.float32, device=q.device)
    err = load("decode_attention").repro_decode_attention_partial(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(), ws.data_ptr(),
        index_ptr, index_host, base, b, s, h, hkv, d, window, chunk, splits, scale,
        DTYPE_CODES[q.dtype], stream)
    record_launch(err, "decode_attention_partial")
    return out, lse


__all__ = ["TC_HEAD_DIMS", "combine_partials", "decode_attention", "decode_attention_partial",
           "decode_attention_partial_plain", "decode_attention_plain", "decode_route",
           "decode_splits", "decode_tc_splits", "live_range", "panel_keys", "span"]
