"""Dry run: trace every (architecture x input shape) step at full size on the
``meta`` device and record what it would need of one NVIDIA H100 80GB HBM3
(the reference's ``repro/launch/dryrun.py``, which AOT-compiles on a TPU
mesh).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--out PATH] [--pigeon-clusters R]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both [--seq-shard-cache]

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
Its cache is a rank's part of the reference's layout (``Model.init_cache``):
where several ranks hold the same KV heads (8 KV heads at model 16, or a
whole attention block) they split its sequence, and under
``--seq-shard-cache`` or a global batch of 1 (``long_500k``) the data axes
split it too; the record's name then ends in ``+seq_shard_cache``.

``--mesh single|multi|both`` runs each step over the reference's
production meshes (``launch/mesh.py::make_production_mesh``: 16 x 16
``data``, ``model``, or 2 x 16 x 16 with ``pod``) as rank 0 of a fake
process group of 256 or 512 ranks (``mesh.fake_group``): the model is rank
0's part of the parallel model (``models/parallel.py``), its collectives
counted by kind and not run (the meta device moves nothing), the memory
and ops a rank's, and the roofline's collective term over the link the
mesh spans (``roofline.link_rate``).  ``--opt pigeon_shardmap`` runs the
round over the multi-pod mesh, ``--opt moe_shard`` the MoE's shard-local
dispatch.  The default, ``--mesh card``, is one card.  The HLO dump
(``--save-hlo``) raises: PyTorch compiles no HLO.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import traceback
from typing import Any, Dict, Optional, Sequence


from ..configs import get_config, list_archs
from ..models import parallel
from ..telemetry import Stopwatch
from .op_analysis import OpCounter, _tensors
from .roofline import roofline_terms
from .shapes import SHAPES, applicable
from .steps import input_specs

#: why an option raises
NOT_PORTED = {
    "save_hlo": ("--save-hlo: PyTorch runs eagerly and compiles no HLO; the op counter "
                 "(launch/op_analysis.py) measures what the HLO analysis read"),
}
#: --mesh -> the meshes run: None one card, False/True the reference's
#: one-pod (16 x 16) and two-pod (2 x 16 x 16) production meshes
MESHES = {"card": [None], "single": [False], "multi": [True], "both": [False, True]}
MESH_NAMES = {None: "1 card", False: "16x16(data,model)", True: "2x16x16(pod,data,model)"}


def _bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def argument_bytes(spec, mesh=None) -> int:
    """The bytes the step's arguments hold on one card: the model's
    parameters and buffers (a rank's shards), and its tensor arguments
    (batch, cache) as ``launch/shardings.py`` lays them over ``mesh``
    (a rank's rows; the cache is already a rank's)."""
    state = list(spec.model.parameters()) + list(spec.model.buffers())
    if mesh is None:
        return _bytes(state) + _bytes(_tensors(spec.args))
    from .shardings import batch_shardings, local_bytes
    total = _bytes(state)
    cluster = "pod" if getattr(spec.model, "n", 0) and "pod" in mesh.axis_names else None
    for i, arg in enumerate(spec.args):
        if isinstance(arg, dict):
            lead = cluster if (i == 0 and cluster) else None
            specs = batch_shardings(arg, mesh, cluster_axis=lead)
            total += sum(local_bytes(t.shape, t.element_size(), specs[k], mesh)
                         for k, t in arg.items())
        else:
            total += _bytes(_tensors(arg))
    return total


def param_bytes_record(model, mesh) -> Dict[str, Any]:
    """The parameters' bytes a rank holds against ``local_bytes`` of the
    reference's ``param_shardings`` spec (``launch/shardings.py::
    param_bytes``): the totals and, by reference path, the leaves where the
    port departs from the spec."""
    from .shardings import param_bytes
    cluster = "pod" if getattr(model, "n", 0) and "pod" in mesh.axis_names else None
    rows = param_bytes(model, mesh, cluster)
    return {"held": sum(h for h, _ in rows.values()),
            "spec": sum(s for _, s in rows.values()),
            "departures": {path: [h, s] for path, (h, s) in rows.items() if h != s}}


def _decode_args(shape, args):
    """A decode step's arguments with the meta index replaced by the host
    index S - 1."""
    cache, tokens, _index, *memory = args
    return (cache, tokens, shape.seq_len - 1, *memory)


def step_tokens(shape) -> int:
    """The positions a step processes: the reference's tokens of the model
    FLOPs (a decode step's one token a sequence)."""
    return shape.seq_len * shape.global_batch if shape.kind != "decode" else shape.global_batch


def analyze(spec, args, kind: str, tokens: int, active_params: int, mesh=None,
            chips: int = 1) -> Dict[str, Any]:
    """One call of ``spec.fn(*args)`` under the op counter: the record's
    ``memory``, ``ops`` (with a rank's collective bytes and counts by kind,
    ``models/parallel.py``'s counter, under the reference's keys) and
    ``roofline``."""
    parallel.reset_collectives()
    with OpCounter() as counter:
        out = spec.fn(*args)
    coll = parallel.collective_totals()
    a = counter.result
    memory = {"argument_bytes": argument_bytes(spec, mesh),
              "output_bytes": _bytes(_tensors(out)),
              "temp_bytes": a.peak_live_bytes}
    if mesh is not None:
        memory["param_bytes"] = param_bytes_record(spec.model, mesh)
    return {
        "memory": memory,
        "ops": {"flops": a.flops, "bytes": a.total_bytes,
                "product_flops": a.product_flops, "kernel_flops": a.kernel_flops,
                "aten_ops": a.ops, "host_transfers": dict(a.host_transfers),
                "kernels": dict(a.kernels), "dtypes": sorted(a.dtypes),
                "products": {k: v for k, v in sorted(a.products.items())},
                "collective_bytes_per_device": coll["bytes"],
                "collectives_by_kind": coll["by_kind"],
                "collective_counts": coll["counts"]},
        "roofline": roofline_terms(a.flops, a.total_bytes, coll["bytes"], chips, kind,
                                   active_params, tokens).as_dict(),
    }


def run_one(arch: str, shape_name: str, pigeon_clusters: int = 0,
            optimizations: Sequence[str] = (), multi_pod: Optional[bool] = None,
            seq_shard_cache: bool = False) -> Dict[str, Any]:
    """One record: on one card (``multi_pod`` None) or, as rank 0 of a fake
    process group of 256 (``False``: the reference's 16 x 16 ``data``,
    ``model`` mesh) or 512 ranks (``True``: 2 x 16 x 16 with ``pod``), on
    the production mesh, where the multi-pod train program is the Pigeon
    round (R = 2, a cluster a pod) as the reference's.  ``pigeon_shardmap``
    and ``moe_shard`` name the mesh programs (on one card ``moe_shard``
    runs its 16-group dispatch alone); ``seq_shard_cache`` the reference's
    flash-decoding cache layout (decode shapes)."""
    from .mesh import PRODUCTION, fake_group, make_production_mesh
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    if "pigeon_shardmap" in optimizations and not multi_pod:
        raise ValueError("--opt pigeon_shardmap runs over the multi-pod mesh (--mesh multi)")
    pigeon = pigeon_clusters if shape.kind == "train" else 0
    if multi_pod and shape.kind == "train" and not pigeon:
        pigeon = 2
    chips = 1 if multi_pod is None else math.prod(PRODUCTION[multi_pod][0])
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": MESH_NAMES[multi_pod], "chips": chips,
        "program": ("pigeon_round_step" if pigeon else
                    {"train": "train_step", "prefill": "prefill_step",
                     "decode": "serve_step"}[shape.kind])
                   + "".join(f"+{o}" for o in optimizations)
                   + ("+seq_shard_cache" if seq_shard_cache else ""),
    }
    group = (contextlib.nullcontext() if multi_pod is None else fake_group(chips))
    try:
        with Stopwatch() as sw, group:
            mesh = None if multi_pod is None else make_production_mesh(multi_pod=multi_pod)
            spec = input_specs(cfg, shape_name, mesh, pigeon_clusters=pigeon,
                               seq_shard_cache=seq_shard_cache,
                               optimizations=tuple(optimizations))
            args = _decode_args(shape, spec.args) if shape.kind == "decode" else spec.args
            rec.update(analyze(spec, args, shape.kind, step_tokens(shape),
                               cfg.active_param_count(), mesh, chips))
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
    ap.add_argument("--mesh", default="card", choices=list(MESHES),
                    help="card: one H100; single/multi/both: the reference's 16x16 and "
                         "2x16x16 production meshes, as rank 0 of a fake process group")
    ap.add_argument("--pigeon-clusters", type=int, default=0,
                    help="train shapes: the Pigeon-SL round over R cluster slots")
    ap.add_argument("--seq-shard-cache", action="store_true",
                    help="decode shapes: the cache's sequence over the data axes too (the "
                         "reference's flash-decoding layout; a batch of 1 takes it anyway)")
    ap.add_argument("--out", default=None, help="merge the records into this JSON file")
    ap.add_argument("--save-hlo", default=None, metavar="DIR", help="no counterpart")
    ap.add_argument("--opt", action="append", default=[],
                    help="named optimization(s), e.g. pigeon_batch_split, pigeon_plus, "
                         "mlstm_bf16_state, moe_shard, pigeon_shardmap (over --mesh multi)")
    args = ap.parse_args(argv)
    if args.save_hlo is not None:
        raise NotImplementedError(NOT_PORTED["save_hlo"])

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
            for mp in MESHES[args.mesh]:
                rec = run_one(arch, shape_name, args.pigeon_clusters, tuple(args.opt), mp,
                              args.seq_shard_cache)
                results.append(rec)
                if rec["ok"]:
                    r = rec["roofline"]
                    extra = (f"dom={r['dominant']:10s} c={r['compute_s']:.2e}s "
                             f"m={r['memory_s']:.2e}s x={r['collective_s']:.2e}s "
                             f"args={rec['memory']['argument_bytes']:.3e}B "
                             f"temp={rec['memory']['temp_bytes']:.3e}B "
                             f"coll={rec['ops']['collective_bytes_per_device']:.3e}B")
                else:
                    extra = rec.get("error", "")[:120]
                print(f"{'OK ' if rec['ok'] else 'FAIL'}  {arch:24s} {shape_name:12s} "
                      f"{rec['mesh']:24s} {extra}", flush=True)
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
