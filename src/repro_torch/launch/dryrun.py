"""Dry run: trace every (architecture x input shape) step at full size on the
``meta`` device and record what it would need of one NVIDIA H100 80GB HBM3
(the reference's ``repro/launch/dryrun.py``, which AOT-compiles on a TPU
mesh).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--out PATH] [--pigeon-clusters R]

Each step comes from ``launch/steps.py::input_specs`` (the model and its
arguments on the meta device: shapes and dtypes, nothing allocated) and runs
once under ``launch/op_analysis.py``'s counter.  The kernels take their meta
rule (``kernels/ops.py``), so nothing launches and no plain arithmetic runs;
a kernel's FLOPs and bytes are its roofline work (``launch/roofline.py``).
A record holds the reference's keys:

  * ``memory`` — the argument bytes (parameters, batch, a decode's cache),
    the output bytes, and the temp bytes: the peak of the bytes the step's
    new tensors hold at once, as the counter sees them;
  * ``ops`` — FLOPs and bytes (the products outside the kernels plus the
    kernels' work), the aten operations, the host transfers, the kernel
    entries;
  * ``roofline`` — the three terms, ``dominant``, ``model_flops`` and
    ``useful_ratio`` on the card's constants.

A decode step takes a host index (the port's serve loop does): the dry run
decodes the last position, S - 1, where every key of the cache is live.
The production mesh (``--mesh multi``: the pod axis with its data and
model axes), ``--opt pigeon_shardmap`` over it, ``--opt moe_shard`` and the
HLO dump (``--save-hlo``) raise: the data and model axes come with the next
multi-card slice (the pod axis alone runs, on the ranks of a process group:
``launch/steps.py::make_pigeon_round_step_shardmap``), and PyTorch compiles
no HLO.
"""
from __future__ import annotations

import argparse
import json
import os
import traceback
from typing import Any, Dict, Optional, Sequence


from ..configs import get_config, list_archs
from ..core.protocol import MULTI_CARD_SLICE
from ..telemetry import Stopwatch
from .op_analysis import OpCounter, _tensors
from .roofline import roofline_terms
from .shapes import SHAPES, applicable
from .steps import input_specs

#: why an option raises
NOT_PORTED = {
    "mesh": f"--mesh multi: the production mesh's data and model axes come with "
            f"{MULTI_CARD_SLICE}",
    "pigeon_shardmap": f"--opt pigeon_shardmap: the round over the production mesh's data "
                       f"and model axes comes with {MULTI_CARD_SLICE}",
    "moe_shard": f"--opt moe_shard comes with {MULTI_CARD_SLICE}",
    "save_hlo": ("--save-hlo: PyTorch runs eagerly and compiles no HLO; the op counter "
                 "(launch/op_analysis.py) measures what the HLO analysis read"),
}
MULTI_CARD_OPTS = ("pigeon_shardmap", "moe_shard")


def _bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def argument_bytes(spec) -> int:
    """The bytes the step's arguments hold on the card: the model's
    parameters and buffers, and its tensor arguments (batch, cache)."""
    state = list(spec.model.parameters()) + list(spec.model.buffers())
    return _bytes(state) + _bytes(_tensors(spec.args))


def _decode_args(shape, args):
    """A decode step's arguments with the meta index replaced by the host
    index S - 1."""
    cache, tokens, _index, *memory = args
    return (cache, tokens, shape.seq_len - 1, *memory)


def step_tokens(shape) -> int:
    """The positions a step processes: the reference's tokens of the model
    FLOPs (a decode step's one token a sequence)."""
    return shape.seq_len * shape.global_batch if shape.kind != "decode" else shape.global_batch


def analyze(spec, args, kind: str, tokens: int, active_params: int) -> Dict[str, Any]:
    """One call of ``spec.fn(*args)`` under the op counter: the record's
    ``memory``, ``ops`` and ``roofline``."""
    with OpCounter() as counter:
        out = spec.fn(*args)
    a = counter.result
    return {
        "memory": {"argument_bytes": argument_bytes(spec),
                   "output_bytes": _bytes(_tensors(out)),
                   "temp_bytes": a.peak_live_bytes},
        "ops": {"flops": a.flops, "bytes": a.total_bytes,
                "product_flops": a.product_flops, "kernel_flops": a.kernel_flops,
                "aten_ops": a.ops, "host_transfers": dict(a.host_transfers),
                "kernels": dict(a.kernels), "dtypes": sorted(a.dtypes),
                "products": {k: v for k, v in sorted(a.products.items())}},
        "roofline": roofline_terms(a.flops, a.total_bytes, 0, 1, kind, active_params,
                                   tokens).as_dict(),
    }


def run_one(arch: str, shape_name: str, pigeon_clusters: int = 0,
            optimizations: Sequence[str] = ()) -> Dict[str, Any]:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    for opt in optimizations:
        if opt in MULTI_CARD_OPTS:
            raise NotImplementedError(NOT_PORTED[opt])
    pigeon = pigeon_clusters if shape.kind == "train" else 0
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": "1 card", "chips": 1,
        "program": ("pigeon_round_step" if pigeon else
                    {"train": "train_step", "prefill": "prefill_step",
                     "decode": "serve_step"}[shape.kind])
                   + "".join(f"+{o}" for o in optimizations),
    }
    try:
        with Stopwatch() as sw:
            spec = input_specs(cfg, shape_name, pigeon_clusters=pigeon,
                               optimizations=tuple(optimizations))
            args = _decode_args(shape, spec.args) if shape.kind == "decode" else spec.args
            rec.update(analyze(spec, args, shape.kind, step_tokens(shape),
                               cfg.active_param_count()))
        rec["trace_s"] = round(sw.elapsed, 2)
        rec["ok"] = True
    except Exception as e:  # noqa: BLE001 — failures are bugs; record them
        rec["ok"] = False
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    return rec


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None, choices=list_archs())
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--pigeon-clusters", type=int, default=0,
                    help="train shapes: the Pigeon-SL round over R cluster slots")
    ap.add_argument("--out", default=None, help="merge the records into this JSON file")
    ap.add_argument("--save-hlo", default=None, metavar="DIR", help="no counterpart")
    ap.add_argument("--opt", action="append", default=[],
                    help="named optimization(s), e.g. pigeon_batch_split, pigeon_plus, "
                         "mlstm_bf16_state (pigeon_shardmap and moe_shard raise)")
    args = ap.parse_args(argv)
    if args.mesh != "single":
        raise NotImplementedError(NOT_PORTED["mesh"])
    if args.save_hlo is not None:
        raise NotImplementedError(NOT_PORTED["save_hlo"])
    for opt in args.opt:
        if opt in MULTI_CARD_OPTS:
            raise NotImplementedError(NOT_PORTED[opt])

    archs = list_archs() if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    results = []
    for arch in archs:
        for shape_name in shapes:
            ok, reason = applicable(arch, shape_name)
            if not ok:
                results.append({"arch": arch, "shape": shape_name, "skipped": True,
                                "reason": reason})
                print(f"SKIP  {arch:24s} {shape_name:12s} {reason}")
                continue
            rec = run_one(arch, shape_name, args.pigeon_clusters, tuple(args.opt))
            results.append(rec)
            if rec["ok"]:
                r = rec["roofline"]
                extra = (f"dom={r['dominant']:10s} c={r['compute_s']:.2e}s "
                         f"m={r['memory_s']:.2e}s args={rec['memory']['argument_bytes']:.3e}B "
                         f"temp={rec['memory']['temp_bytes']:.3e}B")
            else:
                extra = rec.get("error", "")[:120]
            print(f"{'OK ' if rec['ok'] else 'FAIL'}  {arch:24s} {shape_name:12s} {extra}",
                  flush=True)
    if args.out:
        existing = []
        if os.path.exists(args.out):
            with open(args.out) as f:
                existing = json.load(f)

        def key(r):
            return (r.get("arch"), r.get("shape"), r.get("mesh"), r.get("program"))
        merged = {key(r): r for r in existing}
        for r in results:
            merged[key(r)] = r
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(list(merged.values()), f, indent=1)
        print(f"wrote {args.out}")
    if not all(r.get("ok", True) for r in results):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
