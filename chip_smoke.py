#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

from the repository root.  Phases, in order; any failure exits non-zero:

  0. set-up: require CUDA (no CPU fallback), print the card's name and power
     limit, the torch/CUDA/TF32 settings, and build every kernel (timed);
  1. every kernel against its plain PyTorch version on the card, at the
     shapes the main paths give it and a few edge shapes: the wire kernels'
     deq/scales bit-equal, stats within rtol 1e-5, two runs bit-identical
     (B2 also over the batched path's R*B rows, the stats kernel also with
     R messages in one launch); the tamper
     check's sums within rtol 1e-5 of the plain version and of a float64
     sum, bit-identical from run to run, exactly 0 on identical inputs and
     above the tolerance only for a tampered candidate; each kernel's time
     (eager, graph-replayed with the L2 warm, one call with it cold) beside
     its plain version's and its bound;
  2. the sequential main path at full width: the CIFAR-10 split CNN (convs
     32/64/128, d_c = 256, FC 128/64/10) at the paper's Table II sizes
     through ``run_pigeon(engine="sequential", quant="int8",
     selection="loss_plus_distance")`` with label flip on 4 of 20 clients;
     the launch counts show the path went through both wire kernels;
  2b. the batched main path, the same configuration through
     ``engine="batched"``: the R = 5 clusters as one stacked program, the
     fused cascade (``RoundRunner.accept``) under
     ``torch.cuda.set_sync_debug_mode("error")`` so that a hidden host sync
     fails the run; launches of all three kernels, exchange bytes equal to
     the sequential run's, selections and losses beside it;
  3. the MNIST split CNN at Table II sizes, fp8-e4m3 wire, argmin, gradient
     attack;
  4. the same tiny runs on the CPU and on the card, from the same init, on
     both engines: equal discrete outcomes, validation losses within rtol
     1e-3;
  5. where the time goes (torch.profiler): one CIFAR client turn of the
     sequential engine and one batched CIFAR round step — device busy
     share, launches, the top kernels and the host ops.

The last lines are one JSON object per kernel set (``{"kernels": [...]}``),
the card's ``nvidia-smi`` name and power limit, and
``{"ok": true, "device": {...}}``.  Imports nothing of JAX or of the JAX
package.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
DEVICE = "cuda"                 # where phase 1 makes its inputs

HBM_BYTES_PER_S = 3.35e12       # H100 SXM memory rate (NVIDIA data sheet)
F32_OPS_PER_S = 67e12           # H100 SXM f32 rate outside the tensor cores
# the batched round's messages: R = 5 clusters of (B, d_c) = (64, 256)
BATCHED_MESSAGES = (5, 64, 256)
TIMED_SHAPE = (64, 256)         # (B, d_c) of the CIFAR cut layer at B = 64
# the wire kernels' checks: the batched path's R*B rows (one B2 launch a
# step), the sequential path's one message, then edge shapes
KERNEL_SHAPES = ((BATCHED_MESSAGES[0] * BATCHED_MESSAGES[1], BATCHED_MESSAGES[2]),
                 TIMED_SHAPE, (64, 32), (37, 200), (1, 256), (1024, 4096))
# the tamper check's (R, D_o, d_c): CIFAR, MNIST, ragged, tiny, large
TAMPER_SHAPES = ((5, 3000, 256), (4, 3000, 32), (3, 37, 200), (1, 1, 256),
                 (2, 4096, 4096))
STATS_RTOL = 1e-5
TAMPER_RTOL = 1e-5
TAMPER_TOL = 1e-4               # ProtocolConfig.tamper_tol


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 1: kernels against their plain versions
# ---------------------------------------------------------------------------

def _time_us(fn, *args, reps: int = 200, samples: int = 15) -> float:
    """Median over ``samples`` of the mean time of ``reps`` back-to-back
    calls, by CUDA events (after a warm-up)."""
    import torch
    for _ in range(10):
        fn(*args)
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn(*args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) * 1e3 / reps)
    times.sort()
    return times[len(times) // 2]


def _graph_time_us(fn, *args, reps: int = 100, samples: int = 15) -> float:
    """Device time per call: ``reps`` calls captured in one CUDA graph and
    replayed, so the host's per-call cost drops out."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn(*args)
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) * 1e3 / reps)
    times.sort()
    return times[len(times) // 2]


def _cold_time_us(fn, *args, reps: int = 50) -> float:
    """Median device time of one call that finds the L2 cache cold: a
    128 MB buffer (over the 50 MB L2) is rewritten before each call, outside
    the timed events.  A spin kernel ahead of them keeps the card busy while
    the host enqueues the events and the call, so the events time the
    call's device work and not the host's wrapper latency."""
    import torch
    flush = torch.empty(32 * 2 ** 20, dtype=torch.float32, device=DEVICE)
    fn(*args)
    times = []
    for _ in range(reps):
        torch.cuda._sleep(2_000_000)            # ~1 ms of spinning
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) * 1e3)
    times.sort()
    return times[len(times) // 2]


def _message(shape, seed: int):
    """A cut-layer-like message (N, D), or messages (M, N, D): ReLU
    activations of varied row scale, one all-zero row per message (the
    scale's eps path) where there is room."""
    import torch
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    d = shape[-1]
    x = torch.randn(shape, generator=g, device=DEVICE)
    x = torch.relu(x - 0.3) * torch.rand(tuple(shape[:-1]) + (1,), generator=g,
                                         device=DEVICE) * 10.0
    x[..., : max(1, d // 8)] -= 0.5        # a little mass below zero
    if shape[-2] > 2:
        x[..., 1, :] = 0.0
    return x.contiguous()


def phase_kernels():
    import torch
    from repro_torch.kernels import quant_exchange as qx

    results = {}
    for name, kernel, plain in (
            ("quant_dequant", qx.quant_dequant, qx.quant_dequant_plain),
            ("quant_dequant_stats", qx.quant_dequant_stats,
             qx.quant_dequant_stats_plain)):
        max_err = 0.0
        for fmt in qx.QUANT_FORMATS:
            for i, shape in enumerate(KERNEL_SHAPES):
                x = _message(shape, seed=i)
                out1 = kernel(x, fmt)
                out2 = kernel(x, fmt)
                ref = plain(x, fmt)
                torch.cuda.synchronize()
                for a, b in zip(out1, out2):
                    check(torch.equal(a, b), f"{name} {fmt} {shape}: two runs differ")
                check(torch.equal(out1[0], ref[0]),
                      f"{name} {fmt} {shape}: deq differs from the plain version "
                      f"(max {float((out1[0] - ref[0]).abs().max()):.3e})")
                check(torch.equal(out1[1], ref[1]),
                      f"{name} {fmt} {shape}: scales differ from the plain version")
                for a, b in zip(out1, ref):
                    max_err = max(max_err, float((a - b).abs().max()))
                if len(out1) == 3:
                    check(bool(torch.isfinite(out1[2]).all()), f"{name}: stats not finite")
                    check(torch.allclose(out1[2], ref[2], rtol=STATS_RTOL, atol=1e-7),
                          f"{name} {fmt} {shape}: stats {out1[2].tolist()} vs plain "
                          f"{ref[2].tolist()}")
        stats = name.endswith("stats")
        if stats:
            max_err = max(max_err, _check_batched_stats())
        # the batched main path's shape (R*B rows, or R messages), then the
        # sequential path's (one message)
        m, n, d = BATCHED_MESSAGES
        main_shape = (m, n, d) if stats else (m * n, d)
        for shape in (main_shape, TIMED_SHAPE):
            x = _message(shape, seed=99)
            rows = x.numel() // d
            kernel_us = _time_us(kernel, x, "int8")
            plain_us = _time_us(plain, x, "int8")
            kernel_dev_us = _graph_time_us(kernel, x, "int8")
            plain_dev_us = _graph_time_us(plain, x, "int8")
            kernel_cold_us = _cold_time_us(kernel, x, "int8")
            msgs = rows // n if stats else 1
            # each input read once, each output written once
            n_bytes = 4 * rows * d + 4 * rows * d + 4 * rows + (8 * msgs if stats else 0)
            # per element: divide, round, clamp, multiply (+ 5 for the stats)
            n_ops = rows * d * (4 + (5 if stats else 0))
            bytes_us = n_bytes / HBM_BYTES_PER_S * 1e6
            ops_us = n_ops / F32_OPS_PER_S * 1e6
            timing = dict(kernel_us=kernel_us, plain_us=plain_us,
                          kernel_dev_us=kernel_dev_us, plain_dev_us=plain_dev_us,
                          kernel_cold_us=kernel_cold_us, bound_us=max(bytes_us, ops_us),
                          bound_by="bytes" if bytes_us >= ops_us else "operations")
            if shape == main_shape:
                results[name] = dict(max_abs_err=max_err, shape=list(shape), **timing)
            log(f"phase1 {name} at {shape} int8: kernel_us={kernel_us:.3f} "
                f"plain_us={plain_us:.3f} bound_us={timing['bound_us']:.4f} "
                f"({timing['bound_by']}); graph-replayed device time (L2 warm): "
                f"kernel_us={kernel_dev_us:.3f} plain_us={plain_dev_us:.3f}; one "
                f"call with the L2 cold: kernel_us={kernel_cold_us:.3f}")
        log(f"phase1 {name}: bit-equal to plain at {list(KERNEL_SHAPES)} "
            f"(int8, fp8_e4m3){' and R messages at ' + str(BATCHED_MESSAGES) if stats else ''}; "
            f"max_abs_err={max_err:.3e}")
    results["tamper_check_sums"] = _phase_tamper()
    return results


def _check_batched_stats() -> float:
    """R messages through one stats launch: each slot bit-equal to the plain
    version's (deq, scales, and stats as one message's)."""
    import torch
    from repro_torch.kernels import quant_exchange as qx
    max_err = 0.0
    for fmt in qx.QUANT_FORMATS:
        x = _message(BATCHED_MESSAGES, seed=7)
        out1 = qx.quant_dequant_stats(x, fmt)
        out2 = qx.quant_dequant_stats(x, fmt)
        ref = qx.quant_dequant_stats_plain(x, fmt)
        torch.cuda.synchronize()
        for a, b in zip(out1, out2):
            check(torch.equal(a, b), f"batched stats {fmt}: two runs differ")
        check(torch.equal(out1[0], ref[0]) and torch.equal(out1[1], ref[1]),
              f"batched stats {fmt}: deq/scales differ from the plain version")
        check(torch.allclose(out1[2], ref[2], rtol=STATS_RTOL, atol=1e-7),
              f"batched stats {fmt}: {out1[2].tolist()} vs plain {ref[2].tolist()}")
        for a, b in zip(out1, ref):
            max_err = max(max_err, float((a - b).abs().max()))
    return max_err


def _activations(shape, seed: int):
    """(ref, recv) cut-activation sets of shape (R, N, D): ReLU-like values,
    recv a perturbed copy (so the sums are not trivial)."""
    import torch
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    ref = torch.relu(torch.randn(shape, generator=g, device=DEVICE))
    recv = ref + 0.01 * torch.randn(shape, generator=g, device=DEVICE)
    return ref.contiguous(), recv.contiguous()


def _phase_tamper():
    """B1 against its plain version and a float64 sum, its determinism, its
    exact zero and its verdict on a tampered candidate; timed at the main
    path's (R, D_o, d_c)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import tamper_check as tc

    max_err = 0.0
    for i, shape in enumerate(TAMPER_SHAPES):
        ref, recv = _activations(shape, seed=i)
        s1 = tc.tamper_check_sums(ref, recv)
        s2 = tc.tamper_check_sums(ref, recv)
        plain = tc.tamper_check_sums_plain(ref, recv)
        a, b = ref.double().reshape(shape[0], -1), recv.double().reshape(shape[0], -1)
        exact = torch.stack([((a - b) ** 2).sum(1), (a * a).sum(1)], dim=1)
        same = tc.tamper_check_sums(ref, ref)
        torch.cuda.synchronize()
        check(torch.equal(s1, s2), f"tamper {shape}: two runs differ")
        check(torch.allclose(s1, plain, rtol=TAMPER_RTOL, atol=0),
              f"tamper {shape}: {s1.tolist()} vs plain {plain.tolist()}")
        check(torch.allclose(s1.double(), exact, rtol=TAMPER_RTOL, atol=0),
              f"tamper {shape}: {s1.tolist()} vs float64 {exact.tolist()}")
        check(bool((same[:, 0] == 0.0).all()),
              f"tamper {shape}: identical inputs give {same[:, 0].tolist()}, not 0")
        check(torch.equal(same[:, 1], s1[:, 1]), f"tamper {shape}: den depends on recv")
        d_k = ops.tamper_distance(ref, recv)
        d_p = torch.sqrt(plain[:, 0]) / torch.clamp_min(torch.sqrt(plain[:, 1]), 1e-12)
        max_err = max(max_err, float((d_k - d_p).abs().max()))
    # one tampered candidate among identical ones
    ref, _ = _activations(TAMPER_SHAPES[0], seed=50)
    recv = ref.clone()
    recv[2] += 1e-3 * torch.randn_like(recv[2])
    dist = ops.tamper_distance(ref, recv).tolist()
    check(dist[2] > TAMPER_TOL and all(d == 0.0 for j, d in enumerate(dist) if j != 2),
          f"tamper: tampered candidate 2 gives distances {dist}")
    log(f"phase1 tamper_check_sums: within rtol {TAMPER_RTOL} of plain and float64 "
        f"at {list(TAMPER_SHAPES)}, bit-identical run to run, exactly 0 on "
        f"identical inputs; tampered candidate 2: distances {dist}; "
        f"distance max_abs_err={max_err:.3e}")

    r, n, d = TAMPER_SHAPES[0]
    ref, recv = _activations(TAMPER_SHAPES[0], seed=99)
    timing = dict(kernel_us=_time_us(tc.tamper_check_sums, ref, recv),
                  plain_us=_time_us(tc.tamper_check_sums_plain, ref, recv),
                  kernel_dev_us=_graph_time_us(tc.tamper_check_sums, ref, recv),
                  plain_dev_us=_graph_time_us(tc.tamper_check_sums_plain, ref, recv),
                  kernel_cold_us=_cold_time_us(tc.tamper_check_sums, ref, recv))
    # both inputs read once, (R, 2) written; 5 flops an element
    bytes_us = (2 * r * n * d * 4 + r * 2 * 4) / HBM_BYTES_PER_S * 1e6
    ops_us = 5 * r * n * d / F32_OPS_PER_S * 1e6
    timing.update(bound_us=max(bytes_us, ops_us),
                  bound_by="bytes" if bytes_us >= ops_us else "operations")
    log(f"phase1 tamper_check_sums at {TAMPER_SHAPES[0]}: kernel_us="
        f"{timing['kernel_us']:.3f} plain_us={timing['plain_us']:.3f} "
        f"bound_us={timing['bound_us']:.4f} ({timing['bound_by']}); graph-replayed "
        f"device time: kernel_us={timing['kernel_dev_us']:.3f} "
        f"plain_us={timing['plain_dev_us']:.3f} (inputs in the 50 MB L2 between "
        f"replays); one call with the L2 cold: kernel_us={timing['kernel_cold_us']:.3f}")
    return dict(max_abs_err=max_err, shape=list(TAMPER_SHAPES[0]), **timing)


# ---------------------------------------------------------------------------
# phases 2-4: the protocol
# ---------------------------------------------------------------------------

def _run(name, module, data, pcfg, **kw):
    import torch
    from repro_torch.core import run_pigeon
    from repro_torch.kernels import build

    torch.cuda.synchronize()
    build.reset_launches()
    t0 = time.perf_counter()
    hist = run_pigeon(module, data, pcfg, **kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    for r in hist.rounds:
        check(all(v == v and abs(v) < 1e6 for v in r["val_losses"]),
              f"{name}: non-finite validation loss {r['val_losses']}")
        check(0.0 <= r["test_acc"] <= 1.0, f"{name}: test_acc {r['test_acc']}")
        log(f"{name} round {r['round']}: selected={r['selected']} "
            f"selected_honest={r['selected_honest']} accepted={r['accepted']} "
            f"detections={r['detections']} "
            f"val_losses={[round(v, 6) for v in r['val_losses']]} "
            f"test_acc={r['test_acc']:.4f} "
            f"exchange_bytes={r['comm']['activation_bytes'] + r['comm']['gradient_bytes']}")
    log(f"{name}: {pcfg.T} rounds in {seconds:.2f} s "
        f"({seconds / pcfg.T:.2f} s/round, first-call set-up included); "
        f"launches={launches}")
    return hist, launches, seconds


def _check_exchange_bytes(name, hist, pcfg, d_c, quant):
    from repro_torch.core import message_bytes
    want = pcfg.M * pcfg.E * message_bytes(quant, pcfg.B, d_c)
    for r in hist.rounds:
        check(r["comm"]["activation_bytes"] == want == r["comm"]["gradient_bytes"],
              f"{name}: exchange bytes {r['comm']} != {want} per direction")


def _cifar_main_path():
    """The full-width CIFAR configuration both main paths run: the task,
    the split model, the ProtocolConfig and run_pigeon's arguments."""
    from repro_torch.core import LABEL_FLIP, Attack, ProtocolConfig, from_cnn
    from repro_torch.data import build_image_task

    t0 = time.perf_counter()
    data, cfg = build_image_task("cifar10", m_clients=20, d_m=2500, d_o=3000,
                                 n_test=7000, seed=0)
    log(f"phase2 data: CIFAR-10 task M=20 d_m=2500 d_o=3000 n_test=7000 "
        f"({(data.x.nbytes + data.x0.nbytes + data.x_test.nbytes) / 1e6:.0f} MB) "
        f"in {time.perf_counter() - t0:.1f} s")
    pcfg = ProtocolConfig(M=20, N=4, T=2, E=40, B=64, lr=2e-4, seed=0)
    kw = dict(malicious={0, 5, 10, 15}, attack=Attack(LABEL_FLIP), quant="int8",
              selection="loss_plus_distance", device="cuda")
    return data, cfg, from_cnn(cfg), pcfg, kw


def phase_cifar(main):
    data, cfg, module, pcfg, kw = main
    hist, launches, seconds = _run("phase2 cifar", module, data, pcfg, **kw)
    want = pcfg.T * pcfg.M * pcfg.E
    check(launches == {"quant_dequant": want, "quant_dequant_stats": want,
                       "tamper_check_sums": 0},
          f"phase2: launches {launches}, want {want} of each wire kernel")
    _check_exchange_bytes("phase2", hist, pcfg, cfg.d_cut, "int8")
    return hist, launches, seconds / pcfg.T


def phase_cifar_batched(main, seq_hist, seq_s_per_round):
    """The batched main path, its fused step under sync-debug "error": any
    host sync inside RoundRunner.accept raises.  The round's one fetch
    happens after accept returns, outside that mode."""
    import torch
    from repro_torch.core.runner import RoundRunner

    data, cfg, module, pcfg, kw = main
    accept = RoundRunner.accept
    steps = []

    def strict_accept(self, params, inputs, val):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = accept(self, params, inputs, val)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        steps.append(time.perf_counter() - t0)
        return out

    RoundRunner.accept = strict_accept
    try:
        hist, launches, seconds = _run("phase2b cifar batched", module, data, pcfg,
                                       engine="batched", **kw)
    finally:
        RoundRunner.accept = accept
    m_bar = pcfg.M // pcfg.R
    want = pcfg.T * m_bar * pcfg.E
    check(len(steps) == pcfg.T, f"phase2b: {len(steps)} fused steps, want {pcfg.T}")
    check(launches == {"quant_dequant": want, "quant_dequant_stats": want,
                       "tamper_check_sums": pcfg.T},
          f"phase2b: launches {launches}, want {want} of each wire kernel and "
          f"{pcfg.T} tamper checks")
    _check_exchange_bytes("phase2b", hist, pcfg, cfg.d_cut, "int8")
    for rs, rb in zip(seq_hist.rounds, hist.rounds):
        for k in ("activation_bytes", "gradient_bytes"):
            check(rs["comm"][k] == rb["comm"][k],
                  f"phase2b round {rb['round']}: {k} {rb['comm'][k]} != sequential "
                  f"{rs['comm'][k]}")
        log(f"phase2b round {rb['round']}: batched selected={rb['selected']} "
            f"accepted={rb['accepted']} detections={rb['detections']} "
            f"val_losses={rb['val_losses']} | sequential selected={rs['selected']} "
            f"accepted={rs['accepted']} detections={rs['detections']} "
            f"val_losses={rs['val_losses']} | comm equal: {rs['comm'] == rb['comm']}")
    log(f"phase2b fused step (RoundRunner.accept, sync-debug error) seconds: "
        f"{[round(x, 3) for x in steps]}")
    log(f"phase2b seconds_per_round={seconds / pcfg.T:.3f} (batched) vs "
        f"{seq_s_per_round:.3f} (sequential, phase2); Python-issued client steps "
        f"a round: {m_bar * pcfg.E} vs {pcfg.M * pcfg.E}")
    return launches, seconds / pcfg.T


def phase_mnist():
    from repro_torch.core import GRADIENT, Attack, ProtocolConfig, from_cnn
    from repro_torch.data import build_image_task

    data, cfg = build_image_task("mnist", m_clients=12, d_m=5000, d_o=3000,
                                 n_test=7000, seed=0)
    log("phase3 data: MNIST task at Table II sizes M=12 d_m=5000 d_o=3000 "
        "n_test=7000 (nothing cut)")
    pcfg = ProtocolConfig(M=12, N=3, T=1, E=79, B=64, lr=1e-3, seed=0)
    hist, launches, _ = _run(
        "phase3 mnist", from_cnn(cfg), data, pcfg, malicious={0, 4, 8},
        attack=Attack(GRADIENT), quant="fp8_e4m3", device="cuda")
    want = 2 * pcfg.M * pcfg.E * pcfg.T
    check(launches == {"quant_dequant": want, "quant_dequant_stats": 0,
                       "tamper_check_sums": 0},
          f"phase3: launches {launches}, want {want} quant_dequant")
    _check_exchange_bytes("phase3", hist, pcfg, cfg.d_cut, "fp8_e4m3")


def phase_cpu_vs_card():
    import numpy as np
    from repro_torch.core import (LABEL_FLIP, Attack, ProtocolConfig, from_cnn,
                                  run_pigeon)
    from repro_torch.data import build_image_task

    data, cfg = build_image_task("mnist", m_clients=4, d_m=120, d_o=60,
                                 n_test=200, seed=0)
    pcfg = ProtocolConfig(M=4, N=1, T=2, E=2, B=16, lr=0.05, seed=0)
    kw = dict(malicious={1}, attack=Attack(LABEL_FLIP), quant="int8")
    module = from_cnn(cfg)
    runs = {(engine, dev): run_pigeon(module, data, pcfg, device=dev,
                                      engine=engine, **kw)
            for engine in ("sequential", "batched") for dev in ("cpu", "cuda")}
    pairs = [(("sequential", "cpu"), ("sequential", "cuda"), True),
             (("batched", "cpu"), ("batched", "cuda"), True),
             (("sequential", "cuda"), ("batched", "cuda"), False)]
    for a, b, losses_too in pairs:
        for ra, rb in zip(runs[a].rounds, runs[b].rounds):
            for k in ("clusters", "selected", "accepted", "detections", "comm"):
                check(ra[k] == rb[k], f"phase4 round {ra['round']}: {k} {a}={ra[k]} "
                                      f"{b}={rb[k]}")
            if losses_too:
                check(np.allclose(ra["val_losses"], rb["val_losses"], rtol=1e-3, atol=0),
                      f"phase4: val_losses {a}={ra['val_losses']} {b}={rb['val_losses']}")
        log(f"phase4: {a} and {b} agree over {pcfg.T} rounds; val_losses "
            f"{runs[a].rounds[-1]['val_losses']} vs {runs[b].rounds[-1]['val_losses']}")


def _profile_report(name: str, fn, wall_us: float, steps: int) -> None:
    """Run ``fn`` once under torch.profiler and log the device busy share
    against the unprofiled wall time, the launches, the top device kernels
    and the top host ops."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()

    def dev_us(ev) -> float:
        return float(getattr(ev, "self_device_time_total", 0.0)
                     or getattr(ev, "self_cuda_time_total", 0.0))

    kernels = [ev for ev in events if str(ev.device_type).endswith("CUDA")]
    busy_us = sum(dev_us(ev) for ev in kernels)
    launches = sum(ev.count for ev in kernels)
    log(f"{name}: wall {wall_us / 1e3:.2f} ms ({wall_us / steps:.0f} us/step over "
        f"{steps} steps); launches under the profiler {launches} "
        f"({launches / steps:.0f} a step)")
    if busy_us == 0.0:
        log(f"{name}: the profiler recorded no device time: busy share not measured")
    else:
        log(f"{name} device busy {busy_us / 1e3:.2f} ms of the {wall_us / 1e3:.2f} ms "
            f"unprofiled wall: idle share {1.0 - busy_us / wall_us:.3f}")
    for ev in sorted(kernels, key=dev_us, reverse=True)[:8]:
        log(f"  kernel {dev_us(ev) / 1e3:8.3f} ms x{ev.count:5d}  {ev.key[:90]}")
    host = [ev for ev in events if not str(ev.device_type).endswith("CUDA")]
    for ev in sorted(host, key=lambda ev: ev.self_cpu_time_total, reverse=True)[:8]:
        log(f"  host   {ev.self_cpu_time_total / 1e3:8.3f} ms x{ev.count:5d}  {ev.key[:90]}")


def phase_profile_batched(main):
    """One warm batched CIFAR round step as phase 2b runs it: the fused
    RoundRunner.accept over R = 5 clusters x M_bar = 4 clients x E = 40
    stacked steps, validation, scores, the tamper check and the commit."""
    import copy
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.adversary import resolve_threat_model
    from repro_torch.core import CommConfig, make_clusters
    from repro_torch.core.engine import assemble_round
    from repro_torch.core.runner import protocol_accept_runner
    from repro_torch.selection import resolve_policy

    data, cfg, module, pcfg, kw = main
    pcfg = dataclasses.replace(pcfg, comm=CommConfig(quant=kw["quant"]))
    tm = resolve_threat_model(kw["malicious"], kw["attack"], None)
    dev = torch.device(kw["device"])
    theta = tuple(m.to(dev) for m in module.init(torch.Generator().manual_seed(0)))
    rng = np.random.default_rng(0)
    seed_gen = torch.Generator().manual_seed(0)
    x0 = torch.from_numpy(data.x0).to(dev)
    y0 = torch.from_numpy(data.y0).to(dev)
    runner = protocol_accept_runner(module, pcfg.lr,
                                    resolve_policy(kw["selection"]), True,
                                    pcfg.tamper_tol, quant=pcfg.comm.quant)
    t0 = time.perf_counter()
    payload = assemble_round(rng, seed_gen, data, make_clusters(rng, pcfg.M, pcfg.R),
                             pcfg, tm, 0, dev)
    torch.cuda.synchronize()
    assemble_ms = (time.perf_counter() - t0) * 1e3

    def step():
        fresh = tuple(copy.deepcopy(m) for m in theta)
        return runner.accept(fresh, payload, (x0, y0))[1]

    step()
    torch.cuda.synchronize()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    steps = (pcfg.M // pcfg.R) * pcfg.E
    log(f"phase5 batched round assembly (numpy gather + one host->device copy of "
        f"{payload[0].numel() * 4 / 1e6:.0f} MB): {assemble_ms:.1f} ms; peak device "
        f"memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    _profile_report(f"phase5 batched cifar round step (R={pcfg.R}, M_bar="
                    f"{pcfg.M // pcfg.R}, E={pcfg.E}, B={pcfg.B}, int8+stats, fused "
                    f"cascade)", step, sorted(walls)[1] * 1e6, steps)


def phase_profile():
    """One CIFAR client turn as phase 2 runs it (E = 40 steps at B = 64, int8
    wire with stats), warm: wall time, the device's busy share under
    torch.profiler, the top device kernels and host ops, and the cost of
    gathering and moving the turn's batches."""
    import numpy as np
    import torch
    from repro_torch.core import HONEST, client_update_stats, from_cnn
    from repro_torch.core.protocol import _sample_batches
    from repro_torch.models import CIFAR_CNN

    e, b = 40, 64
    module = from_cnn(CIFAR_CNN)
    gamma, phi = (m.to("cuda") for m in module.init(torch.Generator().manual_seed(0)))
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2500, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, size=2500).astype(np.int32)
    xs, ys = _sample_batches(rng, x, y, e, b, torch.device("cuda"))

    def turn():
        out = client_update_stats(module, HONEST, gamma, phi, (xs, ys), 2e-4,
                                  None, quant="int8")
        return float(out[2])

    turn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        turn()
        walls.append(time.perf_counter() - t0)
    wall_us = sorted(walls)[1] * 1e6
    gathers = []
    for _ in range(3):
        t0 = time.perf_counter()
        _sample_batches(rng, x, y, e, b, torch.device("cuda"))
        torch.cuda.synchronize()
        gathers.append(time.perf_counter() - t0)
    log(f"phase5 cifar client turn batch gather+copy {sorted(gathers)[1] * 1e3:.2f} ms")
    _profile_report(f"phase5 cifar client turn (E={e}, B={b}, int8+stats)", turn,
                    wall_us, e)


# ---------------------------------------------------------------------------

def main() -> None:
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"no src/repro_torch next to {Path(__file__).name}: run it from a "
             f"checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: the port's smoke run needs a "
             "CUDA device")

    from repro_torch import resolve_device
    from repro_torch.kernels.build import build_all

    card = card_line()
    log(card)
    resolve_device("cuda")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    t0 = time.perf_counter()
    logs = build_all()
    log(f"phase0: built {sorted(logs)} in {time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "Compiling entry" in line:
                log(f"  ptxas {name}: {line.strip()}")

    kernels = phase_kernels()
    main_path = _cifar_main_path()
    seq_hist, seq_launches, s_per_round = phase_cifar(main_path)
    launches, b_per_round = phase_cifar_batched(main_path, seq_hist, s_per_round)
    phase_mnist()
    phase_cpu_vs_card()
    phase_profile()
    phase_profile_batched(main_path)

    sources = {"quant_dequant": ("src/repro/kernels/quant_exchange.py:85",
                                 "src/repro_torch/kernels/csrc/quant_exchange.cu"),
               "quant_dequant_stats": ("src/repro/kernels/quant_exchange.py:144",
                                       "src/repro_torch/kernels/csrc/quant_exchange.cu"),
               "tamper_check_sums": ("src/repro/kernels/tamper_check.py:42",
                                     "src/repro_torch/kernels/csrc/tamper_check.cu")}
    # launches: the batched main path's run (this slice's path, the only one
    # that reaches all three kernels); both paths' counts ride beside them.
    # Device times: graph replays back to back, which find inputs of up to
    # the 50 MB L2 still there (l2_warm), and one call after an L2 flush
    # (l2_cold), the figure to hold against bound_ms (HBM traffic).
    entries = [dict(name=name, route="cuda", source=sources[name][1],
                    replaces=sources[name][0], launches=launches[name],
                    launches_by_path={"sequential": seq_launches[name],
                                      "batched": launches[name]},
                    shape=k["shape"], max_abs_err=k["max_abs_err"],
                    ms=k["kernel_us"] / 1e3,
                    device_ms_l2_warm=k["kernel_dev_us"] / 1e3,
                    device_ms_l2_cold=k["kernel_cold_us"] / 1e3,
                    plain_ms=k["plain_us"] / 1e3, bound_ms=k["bound_us"] / 1e3,
                    bound_by=k["bound_by"], library_ms=None)
               for name, k in kernels.items()]
    log(f"phase2 seconds_per_round={s_per_round:.3f}; phase2b (batched) "
        f"seconds_per_round={b_per_round:.3f}")
    log(json.dumps({"kernels": entries}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
