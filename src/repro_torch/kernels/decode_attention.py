"""One new token against the KV cache (each decode step's attention): the
CUDA kernel (``csrc/decode_attention.cu``) and its plain PyTorch version.

Layout, as the model holds it: q (B, 1, H, D); the cache's k, v (B, S, Hkv,
D); out (B, 1, H, D) in q's dtype.  The token at position ``index`` (a host
int, 0 <= index < S) attends to the positions ``k_pos <= index`` and, with
``window > 0``, ``index - k_pos < window``; later positions are never read.

  * :func:`decode_attention` — launches the split-K kernel on CUDA tensors
    (f32 or bf16, head_dim in ``HEAD_DIMS``, contiguous).
  * :func:`decode_attention_plain` — what ``repro/kernels/ref.py::
    decode_attention_reference`` computes (f32 scores over the whole cache,
    masked with -1e30, softmax in f32).

``kernels/ops.py`` picks between them by the tensor's device.  The launcher
counts its launches in ``build.LAUNCHES``.
"""
from __future__ import annotations

import functools
import math
from typing import Tuple

import torch

from .flash_attention import (DTYPE_CODES, attend_plain, causal_mask, check_cuda_inputs,
                              check_shapes)

#: blocks the split aims for: four a streaming multiprocessor
BLOCKS_PER_SM = 4
#: fewest keys a split takes (two of the kernel's 32-key tiles)
MIN_CHUNK = 64
#: query heads a block of the kernel takes (kMaxHeads in the source)
HEADS_PER_BLOCK = 8


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, index: int, *,
                           window: int = 0) -> torch.Tensor:
    """Plain version of :func:`decode_attention`
    (``ref.decode_attention_reference``)."""
    check_shapes(q, k, v)
    mask = causal_mask(torch.full((1,), index, device=q.device),
                       torch.arange(k.shape[1], device=q.device), window)
    return attend_plain(q, k, v, mask)


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def live_range(index: int, window: int) -> Tuple[int, int]:
    """The cache positions [begin, end) that the token at ``index`` sees."""
    return (max(0, index - window + 1) if window > 0 else 0), index + 1


def decode_splits(n_keys: int, blocks_per_split: int, sms: int) -> Tuple[int, int]:
    """(chunk, splits): the live keys cut into ``splits`` chunks of ``chunk``
    keys (a multiple of 32, at least :data:`MIN_CHUNK`), so that about
    ``BLOCKS_PER_SM * sms`` blocks cover the card.  Depends on the shape
    alone, so the sums' order repeats from run to run."""
    want = max(1, -(-BLOCKS_PER_SM * sms // blocks_per_split))
    chunk = max(MIN_CHUNK, -(-n_keys // want))
    chunk = -(-chunk // 32) * 32
    return chunk, -(-n_keys // chunk)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, index: int, *,
                     window: int = 0) -> torch.Tensor:
    """Launch the decode-attention kernel: q (B, 1, H, D), the cache's k, v
    (B, S, Hkv, D) -> (B, 1, H, D)."""
    from .build import load, record_launch
    check_cuda_inputs("decode_attention", q, k, v)
    check_shapes(q, k, v)
    b, one, h, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    index = int(index)
    if one != 1 or not 0 <= index < s or window < 0:
        raise ValueError(f"the decode_attention kernel takes one query and 0 <= index < S, "
                         f"window >= 0; got q {tuple(q.shape)}, index {index}, S {s}, "
                         f"window {window}")
    begin, end = live_range(index, window)
    head_chunks = -(-(h // hkv) // HEADS_PER_BLOCK)
    chunk, splits = decode_splits(end - begin, b * hkv * head_chunks,
                                  _sm_count(q.device.index))
    ws = torch.empty((b, h, splits, d + 2), dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = load("decode_attention").repro_decode_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), ws.data_ptr(), b, s, h,
        hkv, d, begin, end, chunk, splits, 1.0 / math.sqrt(d), DTYPE_CODES[q.dtype], stream)
    record_launch(err, "decode_attention")
    return out


__all__ = ["decode_attention", "decode_attention_plain", "decode_splits", "live_range"]
