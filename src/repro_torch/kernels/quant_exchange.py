"""Quantize -> dequantize of the cut-layer wire: the CUDA kernels
(``csrc/quant_exchange.cu``) and their plain PyTorch versions.

Per-row (per-sample) symmetric quantization to int8 or fp8-e4m3 with one f32
scale per row, immediately dequantized, so the receiver consumes exactly the
message it would reconstruct from ``1 byte/element + 4 bytes/row``.

  * :func:`quant_dequant` — (N, D) f32 -> (deq (N, D), scales (N,)) in one
    launch: rows up to :data:`MAX_STATS_D` wide by a warp or a few (laid
    out by :func:`row_layout`), wider ones by one cooperative grid over
    tiles of :data:`TILE_COLS` columns (laid out by :func:`wide_layout`).
  * :func:`quant_dequant_stats` — the same plus the
    :func:`message_stats` ``[dispersion, support_residual]`` of the
    dequantized message, in one C call.  It also takes M messages at once,
    ``(M, N, D)`` -> stats ``(M, 2)`` (the batched round's R clusters, one
    thread-block cluster per message, laid out by :func:`stats_layout`).  A
    message wider than :data:`MAX_STATS_D` (an LM's cut activations), or
    with more than :data:`MAX_STATS_ROWS` rows, takes the wide path: three
    launches over (message, column chunk) blocks behind the same call.

These two launch the kernels and accept only CUDA tensors; the plain
versions (:func:`quant_dequant_plain`, :func:`quant_dequant_stats_plain`)
repeat the arithmetic in PyTorch for the CPU and for comparison on the card.
``kernels/ops.py`` picks between them by the tensor's device.  Each launcher
counts its launches in ``build.LAUNCHES``.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

INT8 = "int8"
FP8_E4M3 = "fp8_e4m3"
QUANT_FORMATS = (INT8, FP8_E4M3)

#: symmetric clip range per format (int8: +-127; fp8-e4m3: +-448)
QMAX = {INT8: 127.0, FP8_E4M3: 448.0}

#: 1/qmax rounded to f32.  The scale is ``max(amax, eps) * QINV``: under jit
#: XLA rewrites the reference's ``max(amax, eps) / qmax`` into this multiply,
#: and a division here would differ from it in the last bit in most rows.
QINV = {fmt: float(np.float32(1.0) / np.float32(q)) for fmt, q in QMAX.items()}

_EPS = 1e-12
_FMT_CODE = {INT8: 0, FP8_E4M3: 1}

#: where the kernels switch paths: a stats message up to this wide (and up
#: to MAX_STATS_ROWS rows) runs in one cluster of at most STATS_MAX_BLOCKS
#: blocks, and a row of B2 in at most 8 warps; wider ones take the wide
#: paths (any width): B3's grid of WIDE_COLS-column chunks, B2's tiles
MAX_STATS_D = 8192
WIDE_COLS = 2048
#: the stats kernel's shared memory holds two floats a row
MAX_STATS_ROWS = 8192
#: the stats kernel's layout: a block owns 1, 2 or 4 segments of
#: STATS_SEG_COLS columns (8 a lane) and a chunk of about
#: STATS_ROWS_PER_BLOCK rows, a cluster at most STATS_MAX_BLOCKS blocks, and
#: a block's STATS_WARPS warps take its rows warp, warp + 16, ...  With
#: MAX_STATS_ROWS they are kSegCols, kMaxStatsBlocks, kStatsWarps and
#: kMaxStatsRows of csrc/quant_exchange.cu, which the launcher checks against
#: the library's own on first use (:func:`build.check_constants`)
STATS_SEG_COLS = 256
STATS_MAX_BLOCKS = 8
STATS_WARPS = 16
STATS_ROWS_PER_BLOCK = 8
#: B2's row layout: a block of ROW_THREADS threads takes 8 / warps rows, a
#: lane at most ROW_VALS values of its row (kRowThreads, kRowVals).  Past
#: MAX_STATS_D, tiles of TILE_COLS columns of one row, TILE_WARPS warps a
#: block, of which a block keeps KEPT_TILES in shared memory between its
#: two passes (kTileCols, kTileWarps, kKeptTiles)
ROW_THREADS, ROW_VALS = 256, 32
TILE_COLS, TILE_WARPS, KEPT_TILES = 8192, 32, 7
#: the Python copies of csrc/quant_exchange.cu's layout constants, in the
#: order its repro_quant_exchange_constants writes them
_CONSTANTS = {"kSegCols": STATS_SEG_COLS, "kMaxStatsBlocks": STATS_MAX_BLOCKS,
              "kStatsWarps": STATS_WARPS, "kMaxStatsRows": MAX_STATS_ROWS,
              "kRowThreads": ROW_THREADS, "kRowVals": ROW_VALS, "kTileCols": TILE_COLS,
              "kTileWarps": TILE_WARPS, "kKeptTiles": KEPT_TILES}


def fp8_supported() -> bool:
    """fp8-e4m3 needs a torch build exposing ``torch.float8_e4m3fn``."""
    return hasattr(torch, "float8_e4m3fn")


def check_format(fmt: str) -> None:
    if fmt not in QUANT_FORMATS:
        raise ValueError(f"quant format {fmt!r} must be one of {QUANT_FORMATS}")
    if fmt == FP8_E4M3 and not fp8_supported():
        raise NotImplementedError(
            "fp8_e4m3 quantization needs a torch build with "
            "torch.float8_e4m3fn; use quant='int8'")


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def quant_dequant_plain(x: torch.Tensor, fmt: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch per-row quantize->dequantize of an (N, D) f32 block.
    Returns (dequantized block, per-row scales); the round trip through the
    narrow dtype is explicit."""
    check_format(fmt)
    qmax = QMAX[fmt]
    amax = x.abs().amax(dim=1)
    scale = torch.clamp_min(amax, _EPS) * QINV[fmt]
    s = scale[:, None]
    if fmt == INT8:
        q = torch.clamp(torch.round(x / s), -qmax, qmax).to(torch.int8)
    else:
        q = torch.clamp(x / s, -qmax, qmax).to(torch.float8_e4m3fn)
    return q.to(torch.float32) * s, scale


def message_stats(acts_sent: torch.Tensor) -> torch.Tensor:
    """Per-batch anomaly statistics of a transmitted cut-activation message
    (leading axis = batch), from exactly what the AP observes:

      * ``dispersion`` — mean distance of the samples from the batch mean,
        relative to the mean's norm (a replayed message has dispersion 0);
      * ``support_residual`` — norm fraction of the message below zero (the
        CNN cut layers are ReLU, so honest messages are non-negative).

    Returns a (2,) f32 tensor."""
    flat = acts_sent.reshape(acts_sent.shape[0], -1).to(torch.float32)
    mu = flat.mean(dim=0, keepdim=True)
    mu_norm = torch.clamp_min(torch.linalg.vector_norm(mu), _EPS)
    disp = torch.linalg.vector_norm(flat - mu, dim=1).mean() / mu_norm
    total = torch.clamp_min(torch.linalg.vector_norm(flat), _EPS)
    support = torch.linalg.vector_norm(torch.clamp_max(flat, 0.0)) / total
    return torch.stack([disp, support])


def quant_dequant_stats_plain(x: torch.Tensor, fmt: str
                              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of :func:`quant_dequant_stats`: an (N, D) message, or
    (M, N, D) messages, each taken exactly as a message of its own."""
    if x.dim() == 3:
        outs = [quant_dequant_stats_plain(m, fmt) for m in x]
        return tuple(torch.stack(parts) for parts in zip(*outs))
    deq, scale = quant_dequant_plain(x, fmt)
    return deq, scale, message_stats(deq)


# ---------------------------------------------------------------------------
# kernel launchers
# ---------------------------------------------------------------------------

def _check_input(x: torch.Tensor, fmt: str, dims=(2,)) -> None:
    check_format(fmt)
    if x.device.type != "cuda":
        raise ValueError(f"the quant kernels take CUDA tensors, got {x.device}")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"message on {x.device} but the current device is "
                         f"cuda:{torch.cuda.current_device()}")
    if x.dtype != torch.float32:
        raise TypeError(f"the quant kernels take float32, got {x.dtype}")
    if x.dim() not in dims or x.numel() == 0:
        raise ValueError(f"the quant kernels take a non-empty (N, D) message "
                         f"(or (M, N, D) messages for the stats kernel), got "
                         f"shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("the quant kernels take a contiguous message")
    if x.numel() >= 2 ** 31:
        raise ValueError(f"message of {x.numel()} elements exceeds the "
                         f"kernels' int32 indexing")


def stats_layout(n: int, d: int) -> Tuple[int, int, int, int]:
    """(row_blocks, col_blocks, segs, rows) of the stats kernel's cluster for
    an (n, d) message: the fewest segments a block (1, 2 or 4) that let at
    most :data:`STATS_MAX_BLOCKS` column chunks cover the columns, then as
    many row chunks of ``rows`` rows (about :data:`STATS_ROWS_PER_BLOCK`) as
    the rest of the cluster takes.  Block ``rrank * col_blocks + crank``
    owns rows ``[rrank * rows, + rows)`` and the ``segs * 256`` columns from
    ``crank * segs * 256``."""
    if not 0 < d <= MAX_STATS_D or not 0 < n <= MAX_STATS_ROWS:
        raise ValueError(f"the stats kernel takes 1 to {MAX_STATS_D} columns and 1 to "
                         f"{MAX_STATS_ROWS} rows, got ({n}, {d})")
    segs = -(-d // (STATS_SEG_COLS * STATS_MAX_BLOCKS))
    segs = 4 if segs == 3 else segs
    col_blocks = -(-d // (segs * STATS_SEG_COLS))
    row_blocks = max(1, min(STATS_MAX_BLOCKS // col_blocks, -(-n // STATS_ROWS_PER_BLOCK)))
    rows = -(-n // row_blocks)
    return -(-n // rows), col_blocks, segs, rows


def row_layout(d: int, aligned: bool) -> Tuple[int, int, bool]:
    """(warps, vals, vec) of B2's row kernel for rows ``d`` wide (up to
    :data:`MAX_STATS_D`): the fewer values a lane holds, the shorter its
    chain of IEEE divisions, so a row up to :data:`ROW_THREADS` wide takes
    one column a lane over as few warps as hold it (1 to 8, a power of two),
    and a wider row the block's 8 warps at :data:`ROW_VALS` values a lane,
    those past ``d`` masked (the kernel's two template counts), read as
    16-byte chunks (``vec``) where D % 4 == 0 and ``aligned``.  Lane ``l``
    of the row's warp ``w`` holds value ``i`` at column ``((i // 4 * warps +
    w) * 32 + l) * 4 + i % 4`` with ``vec``, else ``(i * warps + w) * 32 +
    l``."""
    if not 0 < d <= MAX_STATS_D:
        raise ValueError(f"B2's row kernel takes 1 to {MAX_STATS_D} columns, got {d}")
    if d > ROW_THREADS:
        return ROW_THREADS // 32, ROW_VALS, aligned and d % 4 == 0
    warps = 1
    while warps * 32 < d:
        warps *= 2
    return warps, 1, False


def wide_layout(n: int, d: int, sms: int) -> Tuple[int, int, int, int]:
    """(tiles a row, tiles, tiles a block, blocks) of B2's wide kernel on a
    card of ``sms`` SMs: rows cut into tiles of :data:`TILE_COLS` columns,
    tile ``j`` = (row ``j // tpr``, columns from ``(j % tpr) * TILE_COLS``),
    block ``b`` walks tiles ``[b * per, + per)`` and keeps the first
    :data:`KEPT_TILES` in shared memory; one block an SM at most, so the
    cooperative grid is co-resident."""
    tpr = -(-d // TILE_COLS)
    tiles = n * tpr
    per = -(-tiles // sms)
    return tpr, tiles, per, -(-tiles // per)


def quant_dequant(x: torch.Tensor, fmt: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the quant->dequant kernel on an (N, D) f32 CUDA message.
    Returns (deq (N, D) f32, scales (N,) f32)."""
    from .build import check_constants, device_limits, load, record_launch
    _check_input(x, fmt)
    n, d = x.shape
    deq = torch.empty_like(x)
    scales = torch.empty((n,), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    lib = load("quant_exchange")
    check_constants("quant_exchange", _CONSTANTS)
    aligned = x.data_ptr() % 16 == 0
    if d <= MAX_STATS_D:
        warps, vals, vec = row_layout(d, aligned)
        err = lib.repro_quant_dequant(
            x.data_ptr(), deq.data_ptr(), scales.data_ptr(), n, d, _FMT_CODE[fmt],
            QINV[fmt], warps, vals, int(vec), stream)
    else:
        _, tiles, per, _ = wide_layout(n, d, device_limits(x.device.index)[0])
        # each tile's warps' |x| maxima, then the grid barrier's counter
        scratch = torch.empty((tiles * TILE_WARPS + 4,), dtype=torch.float32, device=x.device)
        err = lib.repro_quant_dequant_wide(
            x.data_ptr(), deq.data_ptr(), scales.data_ptr(), scratch.data_ptr(), n, d,
            _FMT_CODE[fmt], QINV[fmt], per, int(aligned and d % 4 == 0), stream)
    record_launch(err, "quant_dequant")
    return deq, scales


def quant_dequant_stats(x: torch.Tensor, fmt: str
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the fused quant->dequant + message-stats kernel on an (N, D)
    f32 CUDA message, or on M messages (M, N, D) in one launch.  Returns
    (deq, scales (N,) or (M, N), stats (2,) or (M, 2) f32), where each
    message's stats == :func:`message_stats` of its deq."""
    from .build import check_constants, load, record_launch
    _check_input(x, fmt, dims=(2, 3))
    m, n, d = (1,) * (3 - x.dim()) + tuple(x.shape)
    deq = torch.empty_like(x)
    scales = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
    stats = torch.empty(x.shape[:-2] + (2,), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    lib = load("quant_exchange")
    if d <= MAX_STATS_D and n <= MAX_STATS_ROWS:
        check_constants("quant_exchange", _CONSTANTS)
        row_blocks, col_blocks, segs, rows = stats_layout(n, d)
        if m * row_blocks * col_blocks >= 2 ** 31:
            raise ValueError(f"quant_dequant_stats takes fewer than 2**31 blocks a call, "
                             f"got {m} messages of {row_blocks * col_blocks}")
        vec = d % 4 == 0 and x.data_ptr() % 16 == 0
        err = lib.repro_quant_dequant_stats(
            x.data_ptr(), deq.data_ptr(), scales.data_ptr(), stats.data_ptr(), m, n,
            d, _FMT_CODE[fmt], QINV[fmt], row_blocks, col_blocks, segs, rows, int(vec),
            stream)
    else:
        if m > 65535:
            raise ValueError(f"quant_dequant_stats takes at most 65,535 messages wider "
                             f"than {MAX_STATS_D} a call, got {m}")
        chunks = -(-d // WIDE_COLS)
        # per (row, chunk): partial max, partial sum (v - mu)^2; per (message,
        # chunk): partial sums of mu^2, min(v, 0)^2, v^2
        scratch = torch.empty(((2 * m * n + 3 * m) * chunks,), dtype=torch.float32,
                              device=x.device)
        err = lib.repro_quant_dequant_stats_wide(
            x.data_ptr(), deq.data_ptr(), scales.data_ptr(), stats.data_ptr(),
            scratch.data_ptr(), m, n, d, _FMT_CODE[fmt], QINV[fmt], stream)
    record_launch(err, "quant_dequant_stats")
    return deq, scales, stats


__all__ = ["INT8", "FP8_E4M3", "QUANT_FORMATS", "QMAX", "QINV", "KEPT_TILES", "MAX_STATS_D",
           "MAX_STATS_ROWS", "ROW_THREADS", "ROW_VALS", "STATS_MAX_BLOCKS",
           "STATS_ROWS_PER_BLOCK", "STATS_SEG_COLS", "STATS_WARPS", "TILE_COLS", "TILE_WARPS",
           "WIDE_COLS", "row_layout", "stats_layout", "wide_layout",
           "check_format", "fp8_supported", "message_stats", "quant_dequant",
           "quant_dequant_plain", "quant_dequant_stats",
           "quant_dequant_stats_plain"]
