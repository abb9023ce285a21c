"""Training launcher: the Pigeon-SL protocol over an LM or the paper's CNNs.

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --arch qwen3-8b --smoke --protocol pigeon --attack label_flip \\
        --malicious 1 --rounds 3
    PYTHONPATH=src python -m repro_torch.launch.train --task mnist \\
        --protocol pigeon+ --attack label_flip --malicious 2 --rounds 10

The reference's ``repro/launch/train.py``, with the same flags, on the CUDA
card by default (``--device cpu`` asks for the CPU).  An ``--arch`` runs its
reduced config (``reduce_config``), as the reference does, on the
sequential engine.  Not ported, each raising: ``--protocol vanilla|sfl``
(the baselines), ``--trace`` and ``--profile-dir`` (telemetry), ``--block >
1`` (multi-round execution) and ``--compile-cache`` (JAX's persistent
compilation cache, which has no counterpart: PyTorch runs eagerly and the
kernels are built once into ``build/``).
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Optional, Sequence

import torch

from .. import resolve_device
from ..configs import get_smoke_config, list_archs
from ..core import HONEST, Attack, ProtocolConfig, from_cnn, from_lm, run_pigeon
from ..data import build_image_task, build_lm_task
from ..models import build_model

#: why each unported option raises
NOT_PORTED = {
    "vanilla": "--protocol vanilla: run_vanilla_sl is ROADMAP.md Queue A item 5",
    "sfl": "--protocol sfl: run_splitfed is ROADMAP.md Queue A item 5",
    "trace": "--trace: telemetry is ROADMAP.md Queue A item 8",
    "profile_dir": "--profile-dir: telemetry is ROADMAP.md Queue A item 8",
    "block": "--block > 1: multi-round execution is ROADMAP.md Queue A item 8",
    "compile_cache": ("--compile-cache: JAX's persistent compilation cache has no "
                      "counterpart (PyTorch runs eagerly; the kernels build once into "
                      "build/)"),
}


def _refuse(args) -> None:
    if args.protocol in ("vanilla", "sfl"):
        raise NotImplementedError(NOT_PORTED[args.protocol])
    for flag in ("trace", "profile_dir", "compile_cache"):
        if getattr(args, flag) is not None:
            raise NotImplementedError(NOT_PORTED[flag])
    if args.block > 1:
        raise NotImplementedError(NOT_PORTED["block"])


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--task", default=None, choices=["mnist", "cifar10"])
    ap.add_argument("--arch", default=None, choices=list_archs())
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (an --arch always runs it, as in the "
                         "reference)")
    ap.add_argument("--protocol", default="pigeon+",
                    choices=["pigeon", "pigeon+", "vanilla", "sfl"])
    ap.add_argument("--attack", default="none",
                    choices=["none", "label_flip", "activation", "gradient",
                             "param_tamper"])
    ap.add_argument("--malicious", type=int, default=0,
                    help="number of malicious clients (first k ids)")
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--tolerance", type=int, default=1,
                    help="N, the malicious-client budget (R = N+1)")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--local-steps", type=int, default=5, help="E")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="a JSONL telemetry trace (not ported)")
    ap.add_argument("--profile-dir", default=None, metavar="DIR",
                    help="a profiler trace of round 1 (not ported)")
    ap.add_argument("--engine", default=None, choices=["sequential", "batched"],
                    help="round engine (default: sequential; an LM runs on the "
                         "sequential engine only)")
    ap.add_argument("--block", type=int, default=1,
                    help="round-block size (only 1 is ported)")
    ap.add_argument("--compile-cache", default=None, metavar="DIR",
                    help="JAX's persistent compilation cache (no counterpart)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    _refuse(args)
    device = resolve_device(args.device)
    engine = args.engine or "sequential"

    if args.task:
        data, cnn_cfg = build_image_task(args.task, m_clients=args.clients,
                                         d_m=300, d_o=150, n_test=1000,
                                         seed=args.seed)
        module = from_cnn(cnn_cfg)
        lr = args.lr or (0.05 if args.task == "mnist" else 0.02)
    else:
        cfg = get_smoke_config(args.arch or "qwen3-8b")
        module = from_lm(build_model(cfg, device))
        data = build_lm_task(vocab=cfg.vocab, seq_len=32,
                             m_clients=args.clients, d_m=64, d_o=32,
                             n_test=32, seed=args.seed)
        lr = args.lr or 5e-2

    pcfg = ProtocolConfig(M=args.clients, N=args.tolerance, T=args.rounds,
                          E=args.local_steps, B=args.batch, lr=lr,
                          seed=args.seed)
    attack = HONEST if args.attack == "none" else Attack(args.attack)
    malicious = set(range(args.malicious))

    t0 = time.perf_counter()
    hist = run_pigeon(module, data, pcfg, malicious, attack,
                      plus=args.protocol == "pigeon+", engine=engine, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for r in hist.rounds:
        print(f"round {r['round']}: selected={r['selected']} accepted={r['accepted']} "
              f"selected_honest={r['selected_honest']} detections={r['detections']} "
              f"val_losses={[round(v, 4) for v in r['val_losses']]} "
              f"test_acc={r.get('test_acc')}")
    final = hist.rounds[-1].get("test_acc")
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "CPU"
    print(f"done: {args.protocol} rounds={args.rounds} "
          f"final_test_acc={final} wall={wall:.1f}s ({where})")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(hist.rounds, f, indent=1, default=str)


if __name__ == "__main__":
    main()
