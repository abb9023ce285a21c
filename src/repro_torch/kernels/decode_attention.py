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
    f32, head dims 32/80/256, what the other cannot read).
  * :func:`decode_attention_plain` — what ``repro/kernels/ref.py::
    decode_attention_reference`` computes (f32 scores over the whole cache,
    masked with -1e30, softmax in f32).

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
#: head dims of the tensor-core route (whole 8-column mma blocks, rows of
#: 8 or more 16-byte chunks for the swizzle); at 256 the accumulator and q
#: fragments (192 registers a thread) leave too little room, so 256 stays
#: on the f32-FMA route
TC_HEAD_DIMS = (64, 128)
#: the tensor-core kernel's stage (keys), query heads a block (the mma's M)
#: and blocks a cluster: kTileKeys, kRows and kMaxSplits of
#: csrc/decode_attention_tc.cu, which the launcher checks against the
#: library's own on first use (:func:`build.check_constants`)
TC_TILE_KEYS, TC_HEADS, TC_MAX_SPLITS = 64, 16, 8
_TC_CONSTANTS = {"kTileKeys": TC_TILE_KEYS, "kRows": TC_HEADS, "kMaxSplits": TC_MAX_SPLITS}

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


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


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
    exact f32 products; head dims 32 and 80 are not whole swizzled rows,
    256 does not fit the registers; a misaligned view)."""
    if (q.dtype == torch.bfloat16 and q.shape[-1] in TC_HEAD_DIMS
            and all(tma_ok(t) for t in (q, k, v))):
        return TENSOR_CORES
    return F32_FMA


def _check_index(index: Index, s: int, q: torch.Tensor) -> Tuple[Optional[int], int]:
    """(device pointer or None, host index) of a valid ``index``."""
    if isinstance(index, torch.Tensor):
        if index.dim() != 0 or index.dtype != torch.int32 or index.device != q.device:
            raise ValueError(f"a tensor index must be a 0-d int32 tensor on {q.device}, "
                             f"got {tuple(index.shape)} {index.dtype} on {index.device}")
        return index.data_ptr(), 0
    index = int(index)
    if not 0 <= index < s:
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
    from .build import check_constants, load, record_launch
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
        chunk, splits = decode_tc_splits(n_keys, clusters, _sm_count(q.device.index),
                                         functools.partial(_tc_clusters, q.device.index, d))
        err = lib.repro_decode_attention_tc(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), index_ptr, index_host,
            b, s, h, hkv, d, window, chunk, splits, scale, stream)
        record_launch(err, "decode_attention_tc")
        return out
    head_chunks = -(-(h // hkv) // HEADS_PER_BLOCK)
    chunk, splits = decode_splits(n_keys, b * hkv * head_chunks, _sm_count(q.device.index))
    ws = torch.empty((b, h, splits, d + 2), dtype=torch.float32, device=q.device)
    err = load("decode_attention").repro_decode_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), ws.data_ptr(), index_ptr,
        index_host, b, s, h, hkv, d, window, chunk, splits, scale, DTYPE_CODES[q.dtype],
        stream)
    record_launch(err, "decode_attention")
    return out


__all__ = ["TC_HEAD_DIMS", "decode_attention", "decode_attention_plain", "decode_route",
           "decode_splits", "decode_tc_splits", "live_range", "span"]
