"""Phase 19 of ``chip_smoke.py`` alone: the data and model axes on every
visible card.

It builds the kernels, draws Qwen3-30B-A3B at full width and depth (phase
13's weights) for the ``moe_shard`` prefill, frees it and runs
``chip_smoke.phase_tensor_parallel``: on one card the group of one, the
planted faults and two gloo ranks over (1, 2), a batch-1 decode over (2,
1) (the cache's sequence over the data ranks), InternVL2-26B over (1,
2) (its vocab whole) and the last layer kinds over (1, 2) (DeepSeek-V2-Lite's
MLA and MoE, Zamba2's Mamba2 and shared block, xLSTM's mLSTM and sLSTM,
SeamlessM4T's encoder and decoder, each at full width and cut depth); on n
cards the NCCL meshes (1, n) and (2, n / 2), the batch-1 decodes over (n,
1) and (2, n / 2), InternVL2-26B and the last layer kinds over (1, n), the
MoE's experts over n cards and the round over (2, 1, n / 2).  A failed check is printed and the run goes on, so every
reading prints; the exit code is 1 if any check failed.

Run from the repository root on a machine with CUDA cards:

    python3 scripts/chip_phase19.py
"""
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs  # noqa: E402

FAILS = []


def _check(cond, msg):
    if not cond:
        FAILS.append(msg)
        cs.log("CHECK FAILED: " + msg[:600])


# at the top level, so that the ranks the phase spawns take it too
cs.check = _check


def main() -> int:
    import torch
    from repro_torch import resolve_device
    from repro_torch.kernels.build import build_all
    from repro_torch.launch.serve import serve_config
    cs.log(cs.card_line())
    resolve_device("cuda")
    t0 = time.perf_counter()
    build_all()
    cs.log(f"built in {time.perf_counter() - t0:.1f} s")
    model = cs._draw_model("p19 qmoe", serve_config("qwen3-moe-30b-a3b", full=True), 0,
                           cs.QMOE_PARAMS)
    moe_shard = cs._moe_shard_prefill(model)
    del model
    torch.cuda.empty_cache()
    out = cs.phase_tensor_parallel(moe_shard)
    cs.log("P19 " + json.dumps({k: v for k, v in out.items()
                                if k in ("panel", "faults", "runs", "group_of_one")
                                or "rank" in k}, default=str))
    cs.log(f"phase 19 took {out['seconds']:.1f} s")
    cs.log(f"FAILS {len(FAILS)}")
    for msg in FAILS:
        cs.log(" - " + msg[:600])
    return 1 if FAILS else 0


if __name__ == "__main__":
    sys.exit(main())
