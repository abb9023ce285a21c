"""The four assigned input shapes and per-(arch, shape) applicability.

``long_500k`` requires sub-quadratic attention: it runs for the SSM/hybrid
architectures (zamba2, xlstm) and for the dense architectures with a
sliding-window variant (gemma3 5:1 local:global, h2o-danube SWA); it is
skipped for pure full-attention architectures (qwen2.5-14b, qwen3-8b,
qwen3-moe, deepseek-v2-lite, internvl2, seamless).

A copy of the reference's ``repro/launch/shapes.py`` (pure data).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                  # "train" | "prefill" | "decode"


SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}

# architectures allowed to run long_500k (sub-quadratic or SWA)
SUBQUADRATIC = {"zamba2-1.2b", "xlstm-1.3b", "gemma3-12b", "h2o-danube-1.8b"}


def applicable(arch: str, shape: str) -> Tuple[bool, str]:
    """Returns (runs?, reason-if-skipped)."""
    if shape == "long_500k" and arch not in SUBQUADRATIC:
        return False, "pure full-attention arch: long_500k requires sub-quadratic attention"
    return True, ""


def shape_settings(shape: InputShape) -> Dict[str, object]:
    """Execution knobs applied to the ModelConfig per input shape."""
    if shape.kind == "train":
        return dict(q_chunk=512, loss_chunk=512, remat=True,
                    ssm_chunk=512, dtype="bfloat16")
    if shape.kind == "prefill":
        return dict(q_chunk=2048, loss_chunk=0, remat=False,
                    ssm_chunk=2048, dtype="bfloat16")
    return dict(q_chunk=0, loss_chunk=0, remat=False, dtype="bfloat16")
