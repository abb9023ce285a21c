"""Roofline model of one NVIDIA H100 80GB HBM3 (SXM, 700.00 W power limit
as ``nvidia-smi`` reports it): the three terms of a step, and the work of
each hand-written kernel (the reference's ``repro/launch/roofline.py``,
with the card's constants in place of the TPU's).

  compute term    = FLOPs / 989e12 (dense bf16 tensor cores)
  memory term     = bytes / 3.35e12 (HBM3)
  collective term = a rank's collective bytes / the link's rate a
                    direction: NVLink 4 (450e9) where the mesh fits one
                    node of 8 cards, else the network between nodes (50e9:
                    one 400 Gb/s NDR InfiniBand port a card, as a DGX
                    H100 has); 0 on one card

``model_flops_for`` is the analytic 6 N D (train) / 2 N D (prefill and
decode) with N the active parameters, so ``useful_ratio`` catches remat and
redundant work, and ``mfu`` is the share of the card's bf16 peak a
measured step reaches.

The kernel-work functions give the least work each kernel does: every input
read once, every output written once (bytes), and the operations the
function needs on this call's shapes, live pairs and data (ops), with the
rate those operations run at (bf16 tensor cores, or the f32 units with TF32
off).  :func:`bound_us` turns one into the bound of ``chip_smoke.py``'s
kernels line and PERF.md's table; ``launch/op_analysis.py`` counts a kernel
entry's FLOPs and bytes from the same functions.  A card may be capped below
700 W and then runs slower under load: the power limit stands beside every
measured time.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

#: NVIDIA H100 80GB HBM3 (SXM) data-sheet rates, at its 700.00 W limit
BF16_OPS_PER_S = 989e12         # dense bf16 tensor-core FLOP/s
F32_OPS_PER_S = 67e12           # f32 FLOP/s outside the tensor cores (TF32 off)
HBM_BYTES_PER_S = 3.35e12       # HBM3 bytes/s
RATES = {"bf16": BF16_OPS_PER_S, "f32": F32_OPS_PER_S}
#: NVLink 4 on the H100 SXM: 900 GB/s a card, both directions together
#: (NVIDIA H100 data sheet), so 450 GB/s a direction, card to card in a node
NVLINK_BYTES_PER_S = 450e9
#: cards a node joins all to all by NVLink (an HGX H100 8-GPU board)
CARDS_PER_NODE = 8
#: between nodes: one 400 Gb/s NDR InfiniBand port a card (the DGX H100's
#: layout), 50 GB/s a direction
NETWORK_BYTES_PER_S = 50e9


def link_rate(chips: int) -> float:
    """Bytes/s a direction a rank's collectives move at: NVLink within one
    node, the network where the mesh spans nodes (more than
    :data:`CARDS_PER_NODE` cards: the production meshes' 256 and 512)."""
    return NVLINK_BYTES_PER_S if chips <= CARDS_PER_NODE else NETWORK_BYTES_PER_S


@dataclasses.dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float
    hlo_flops_global: float
    useful_ratio: float

    def as_dict(self) -> Dict:
        return dataclasses.asdict(self)


def model_flops_for(kind: str, active_params: int, tokens: int) -> float:
    """Analytic model FLOPs of the step."""
    if kind == "train":
        return 6.0 * active_params * tokens
    # prefill and decode are forward-only
    return 2.0 * active_params * tokens


def mfu(model_flops: float, seconds: float) -> float:
    """The share of the card's dense bf16 peak a step of ``model_flops``
    reaches in ``seconds``."""
    return model_flops / (seconds * BF16_OPS_PER_S)


def roofline_terms(per_device_flops: float, per_device_bytes: float,
                   per_device_coll_bytes: float, chips: int,
                   kind: str, active_params: int, tokens: int) -> Roofline:
    """The three terms of one step on one of ``chips`` cards (a rank's
    FLOPs, bytes and collective bytes; :func:`link_rate` for the last).
    ``hlo_flops_global`` keeps the reference's key: here it is the counted
    FLOPs of the step on one rank."""
    compute_s = per_device_flops / BF16_OPS_PER_S
    memory_s = per_device_bytes / HBM_BYTES_PER_S
    coll_s = per_device_coll_bytes / link_rate(chips) if chips > 1 else 0.0
    dominant = max((("compute", compute_s), ("memory", memory_s), ("collective", coll_s)),
                   key=lambda kv: kv[1])[0]
    mf = model_flops_for(kind, active_params, tokens)
    return Roofline(compute_s=compute_s, memory_s=memory_s, collective_s=coll_s,
                    dominant=dominant, model_flops=mf, hlo_flops_global=per_device_flops,
                    useful_ratio=(mf / per_device_flops) if per_device_flops else 0.0)


# ---------------------------------------------------------------------------
# the kernels' work
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Work:
    """The least work of one kernel call: ``bytes`` moved (each input read
    once, each output written once), ``ops`` operations, run at ``rate``
    ("bf16" tensor cores or "f32" units)."""
    bytes: int
    ops: int
    rate: str = "f32"


def bound_us(work: Work) -> Tuple[float, str]:
    """(the least time in µs, what sets it: "bytes" or "operations")."""
    bytes_us = work.bytes / HBM_BYTES_PER_S * 1e6
    ops_us = work.ops / RATES[work.rate] * 1e6
    return max(bytes_us, ops_us), ("bytes" if bytes_us >= ops_us else "operations")


def _elt(dtype: str) -> int:
    return 4 if dtype == "float32" else 2


def _rate(dtype: str) -> str:
    return "f32" if dtype == "float32" else "bf16"


def live_pairs(sq: int, sk: int, window: int = 0, causal: bool = True) -> int:
    """The (query, key) pairs attention computes: query i sees key j where
    j <= i (causal) and i - j < window (a window), as
    ``kernels/flash_attention.py::causal_mask`` masks them."""
    i = np.arange(sq, dtype=np.int64)
    hi = np.minimum(i, sk - 1) if causal else np.full_like(i, sk - 1)
    lo = np.maximum(0, i - window + 1) if window > 0 else np.zeros_like(i)
    return int(np.maximum(0, hi - lo + 1).sum())


def tamper_check_work(r: int, n: int, d: int, aliased: bool, elt: int = 4) -> Work:
    """B1: the activations read once (once in all where ``ref is recv``),
    the sums, distances and verdicts written (13 bytes a candidate); 5 f32
    operations an element."""
    n_in = 1 if aliased else 2
    return Work(n_in * r * n * d * elt + r * 13, 5 * r * n * d, "f32")


def quant_dequant_work(rows: int, d: int) -> Work:
    """B2: the message read once, the dequantized message and the row scales
    written once; divide, round, clamp, multiply an element."""
    return Work(4 * rows * d + 4 * rows * d + 4 * rows, rows * d * 4, "f32")


def quant_dequant_stats_work(rows: int, d: int, msgs: int) -> Work:
    """B3: B2's work, two stats a message written and 5 more operations an
    element."""
    return Work(4 * rows * d + 4 * rows * d + 4 * rows + 8 * msgs, rows * d * 9, "f32")


def fused_xent_work(t: int, d: int, v: int, elt: int = 2) -> Work:
    """B4 forward: hidden and the head read once, loss, lse and the labels
    (4 bytes a token each); the h @ W product, 2 T D V on the tensor
    cores."""
    return Work(elt * (t * d + d * v) + 4 * t * 3, 2 * t * d * v, "bf16")


def fused_xent_bwd_work(t: int, d: int, v: int, elt: int = 2) -> Work:
    """B4 backward: hidden and the head read, dh and dW written; the logits
    recomputed and the two gradient products, 3 x 2 T D V."""
    return Work(2 * elt * (t * d + d * v) + 4 * t * 3, 3 * 2 * t * d * v, "bf16")


def flash_attention_work(b: int, sq: int, sk: int, h: int, hkv: int, d: int,
                         window: int = 0, causal: bool = True,
                         dtype: str = "bfloat16") -> Work:
    """B5 forward: q and the output (B, Sq, H, D), k and v (B, Sk, Hkv, D)
    once; 4 D operations a live pair and head (scores and values)."""
    pairs = live_pairs(sq, sk, window, causal)
    return Work(_elt(dtype) * (2 * b * sq * h * d + 2 * b * sk * hkv * d),
                4 * d * pairs * b * h, _rate(dtype))


def flash_attention_bwd_work(b: int, sq: int, sk: int, h: int, hkv: int, d: int,
                             window: int = 0, causal: bool = True,
                             dtype: str = "bfloat16") -> Work:
    """B5 backward: q, out, dout, dq (B, Sq, H, D) and k, v, dk, dv (B, Sk,
    Hkv, D) once, lse (B, H, Sq) f32; 10 D operations a live pair and head
    (S and P recomputed, dP, dS and the three gradient products)."""
    pairs = live_pairs(sq, sk, window, causal)
    return Work(_elt(dtype) * (4 * b * sq * h * d + 4 * b * sk * hkv * d) + 4 * b * h * sq,
                10 * d * pairs * b * h, _rate(dtype))


def decode_attention_work(b: int, s: int, h: int, hkv: int, d: int, window: int = 0,
                          index: Optional[int] = None, dtype: str = "bfloat16") -> Work:
    """B6: q and the output (B, H, D) once, the live keys' k and v once; 4 D
    operations a live key and head.  ``index`` None (a position on the
    device) counts the whole span a split covers."""
    if index is None:
        pairs = min(s, window) if window > 0 else s
    else:
        pairs = index + 1 - (max(0, index - window + 1) if window > 0 else 0)
    return Work(_elt(dtype) * (2 * b * h * d + 2 * b * pairs * hkv * d),
                4 * d * pairs * b * h, _rate(dtype))


def decode_attention_partial_work(b: int, s: int, h: int, hkv: int, d: int, base: int,
                                  window: int = 0, index: Optional[int] = None,
                                  dtype: str = "bfloat16") -> Work:
    """B6's partial mode over the panel [base, base + s): q read once, out
    (B, H, D) and lse (B, H) written once in f32, the panel's live keys' k
    and v once; 4 D operations a live key and head.  ``index`` None (a
    position on the device) counts the span a split covers."""
    if index is None:
        pairs = min(s, window) if window > 0 else s
    else:
        begin = max(0, index - window + 1) if window > 0 else 0
        pairs = max(0, min(index + 1, base + s) - max(begin, base))
    return Work(_elt(dtype) * (b * h * d + 2 * b * pairs * hkv * d) + 4 * (b * h * d + b * h),
                4 * d * pairs * b * h, _rate(dtype))


def slstm_scan_work(t: int, b: int, d: int, h: int, dtype: str = "bfloat16") -> Work:
    """B7 forward: pre (T, B, 4d) read once, the output (T, B, d) written
    once, R read once; 2 dh operations a (step, row, gate column) on the f32
    units (the state is f32)."""
    dh = d // h
    return Work(_elt(dtype) * (t * b * 4 * d + t * b * d + h * dh * 4 * dh),
                2 * t * b * 4 * d * dh, "f32")


def slstm_scan_bwd_work(t: int, b: int, d: int, h: int) -> Work:
    """B7 backward: dout (bf16), z and the state (f32) read once, dz (f32)
    written once, R read once; the per-step product with R^T, 2 dh
    operations a (step, row, gate column), on the f32 units."""
    dh = d // h
    return Work(2 * t * b * d + 4 * t * b * 4 * d + 4 * 4 * t * b * d + 4 * t * b * 4 * d
                + 2 * h * dh * 4 * dh, 2 * t * b * 4 * d * dh, "f32")


__all__ = ["BF16_OPS_PER_S", "CARDS_PER_NODE", "F32_OPS_PER_S", "HBM_BYTES_PER_S",
           "NETWORK_BYTES_PER_S", "NVLINK_BYTES_PER_S", "RATES", "Roofline", "Work", "bound_us",
           "decode_attention_partial_work", "decode_attention_work", "link_rate",
           "flash_attention_bwd_work", "flash_attention_work", "fused_xent_bwd_work",
           "fused_xent_work", "live_pairs", "mfu", "model_flops_for", "quant_dequant_stats_work",
           "quant_dequant_work", "roofline_terms", "slstm_scan_bwd_work", "slstm_scan_work",
           "tamper_check_work"]
