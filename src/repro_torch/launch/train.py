"""Training launcher: the Pigeon-SL protocol over an LM or the paper's CNNs.

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --arch qwen3-8b --smoke --protocol pigeon --attack label_flip \\
        --malicious 1 --rounds 3
    PYTHONPATH=src python -m repro_torch.launch.train --task mnist \\
        --protocol pigeon+ --attack label_flip --malicious 2 --rounds 10
    PYTHONPATH=src python -m repro_torch.launch.train --task cifar10 \\
        --protocol sfl --engine batched --attack label_flip --malicious 1

    PYTHONPATH=src python -m repro_torch.launch.train --task cifar10 --smoke \
        --protocol pigeon --engine batched --block 2 --trace run.jsonl \
        --profile-dir prof

The reference's ``repro/launch/train.py``, with the same flags, on the CUDA
card by default (``--device cpu`` asks for the CPU).  An ``--arch`` runs its
reduced config (``reduce_config``), as the reference does, on either
engine (``--engine batched``: the cluster-stacked LM, dense, vlm, MoE,
xLSTM or Zamba2; an xLSTM trains through B7 and its backward on the card; a
vlm's round takes tokens only, as the reference's ``from_lm`` does; a MoE
such as ``deepseek-v2-lite-16b`` (MLA) or ``qwen3-moe-30b-a3b`` routes each
slot as its plain model does).  An encoder-decoder
(``seamless-m4t-medium``) raises ``core.split.ENCDEC_ROUND``: no Pigeon-SL
round over one exists in the reference.
``--protocol vanilla`` runs vanilla SL, ``sfl`` clustered SplitFed (either
engine).  ``--trace`` writes a JSONL
telemetry trace (spans, per-round records, a provenance stamp with the
card's name and power limit), ``--profile-dir`` a ``torch.profiler`` trace
of round 1, and ``--block K`` runs K rounds a fetch (the batched engine by
default then; ``pigeon+`` and ``param_tamper`` force 1).  ``--compile-cache
DIR`` (or ``REPRO_COMPILE_CACHE``) puts the kernel libraries in DIR, the
persistent cache of ``core/compile_cache.py``: a library built there by one
run is loaded by the next.
"""
from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

import torch

from .. import resolve_device
from ..configs import get_smoke_config, list_archs
from ..core import (HONEST, Attack, ProtocolConfig, enable_compile_cache, from_cnn,
                    from_lm, run_pigeon, run_splitfed, run_vanilla_sl)
from ..data import build_image_task, build_lm_task
from ..models import build_model
from ..telemetry import Stopwatch, Telemetry


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
                    help="write a JSONL telemetry trace (spans, per-round records, "
                         "provenance) to PATH")
    ap.add_argument("--profile-dir", default=None, metavar="DIR",
                    help="write a torch.profiler trace of round 1 into DIR")
    ap.add_argument("--engine", default=None, choices=["sequential", "batched"],
                    help="round engine (default: batched when --block > 1, else "
                         "sequential; both run the CNNs and a dense LM, the batched one "
                         "over its cluster-stacked form)")
    ap.add_argument("--block", type=int, default=1,
                    help="round-block size: this many rounds a host fetch "
                         "(pigeon/sfl on the batched engine; pigeon+ and "
                         "param_tamper force 1)")
    ap.add_argument("--compile-cache", default=None, metavar="DIR",
                    help="directory of the persistent kernel-library cache "
                         "(default: REPRO_COMPILE_CACHE, else build/repro_torch_kernels)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    enable_compile_cache(args.compile_cache)   # no-op when DIR and the env are unset
    device = resolve_device(args.device)
    engine = args.engine or ("batched" if args.block > 1 else "sequential")

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
    telemetry = None
    if args.trace or args.profile_dir:
        telemetry = Telemetry(jsonl=args.trace, profile_dir=args.profile_dir)

    with Stopwatch() as sw:
        if args.protocol == "vanilla":
            hist = run_vanilla_sl(module, data, pcfg, malicious, attack,
                                  telemetry=telemetry, device=device)
        elif args.protocol == "sfl":
            hist = run_splitfed(module, data, pcfg, malicious, attack, engine=engine,
                                block=args.block, telemetry=telemetry, device=device)
        else:
            hist = run_pigeon(module, data, pcfg, malicious, attack,
                              plus=args.protocol == "pigeon+", engine=engine,
                              block=args.block, telemetry=telemetry, device=device)
        if device.type == "cuda":
            torch.cuda.synchronize()
    wall = sw.elapsed
    for r in hist.rounds:
        fields = " ".join(f"{k}={r[k]}" for k in ("selected", "accepted", "selected_honest",
                                                  "detections", "train_loss") if k in r)
        losses = (f" val_losses={[round(v, 4) for v in r['val_losses']]}"
                  if "val_losses" in r else "")
        print(f"round {r['round']}: {fields}{losses} test_acc={r.get('test_acc')}")
    final = hist.rounds[-1].get("test_acc")
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "CPU"
    print(f"done: {args.protocol} rounds={args.rounds} "
          f"final_test_acc={final} wall={wall:.1f}s ({where})")
    if args.trace:
        print(f"telemetry trace: {args.trace}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(hist.rounds, f, indent=1, default=str)


if __name__ == "__main__":
    main()
