"""Cut-layer transport configuration and byte arithmetic.

The paper's Table I counts cut-layer *floats*; this module owns the wire
representation those floats travel in.  A :class:`CommConfig` on
``ProtocolConfig`` selects the quantization format of the two per-batch
cut-layer messages (activations up, cut gradients down):

  * ``quant=None``       — f32 wire, 4 bytes/element (the paper's baseline);
  * ``quant="int8"``     — per-row symmetric int8, 1 byte/element + one f32
                           scale per row;
  * ``quant="fp8_e4m3"`` — per-row-scaled fp8-e4m3 (alias ``"fp8"``), same
                           byte layout, gated on backend float8 support.

Defense-critical messages stay exact regardless of ``quant``: the shared-set
validation push (Section III-C — quantizing the message the tamper check and
selection scores read would let an attacker hide inside quantization noise)
and the intra-cluster parameter handoffs travel f32.  ``CommMeter``'s float
counts are therefore format-independent (Table I stays valid as a float
count); the ``*_bytes`` fields measure the actual wire, and the int8 win on
the exchange bytes is ``4 / (1 + 4/d_c)`` — >= 3.9x for any cut width
d_c >= 156.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from ..kernels.quant_exchange import QUANT_FORMATS, check_format, fp8_supported

FLOAT_BYTES = 4       # the f32 wire element
SCALE_BYTES = 4       # one f32 scale per quantized row
QUANT_ITEMSIZE = {"int8": 1, "fp8_e4m3": 1}

_ALIASES = {"fp8": "fp8_e4m3", "e4m3": "fp8_e4m3", "float8": "fp8_e4m3"}


def resolve_quant(quant: Optional[str]) -> Optional[str]:
    """Normalize a user-facing format name (``None`` passes through;
    ``"fp8"``-style aliases map to ``"fp8_e4m3"``; unknown names raise)."""
    if quant is None:
        return None
    quant = _ALIASES.get(quant, quant)
    if quant not in QUANT_FORMATS:
        raise ValueError(f"quant={quant!r} must be None or one of "
                         f"{QUANT_FORMATS} (aliases: {sorted(_ALIASES)})")
    return quant


@dataclasses.dataclass(frozen=True)
class CommConfig:
    """Cut-layer transport knobs (hashable — rides on the frozen
    ``ProtocolConfig`` and into the lru-cached runner factories)."""
    quant: Optional[str] = None

    def __post_init__(self):
        object.__setattr__(self, "quant", resolve_quant(self.quant))

    @property
    def itemsize(self) -> int:
        return FLOAT_BYTES if self.quant is None else QUANT_ITEMSIZE[self.quant]


def message_bytes(quant: Optional[str], n_rows: int, row_elems: int) -> int:
    """Wire bytes of one (n_rows, row_elems) cut-layer message under
    ``quant`` — the single byte formula CommMeter accounting charges."""
    if quant is None:
        return n_rows * row_elems * FLOAT_BYTES
    return n_rows * row_elems * QUANT_ITEMSIZE[quant] + n_rows * SCALE_BYTES


__all__ = ["CommConfig", "FLOAT_BYTES", "SCALE_BYTES", "QUANT_ITEMSIZE",
           "QUANT_FORMATS", "check_format", "fp8_supported", "message_bytes",
           "resolve_quant"]
