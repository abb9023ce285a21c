#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

from the repository root.  Phases, in order; any failure exits non-zero:

  0. set-up: require CUDA (no CPU fallback), print the card's name and power
     limit, the torch/CUDA/TF32 settings, and build every kernel (timed);
  1. every kernel against its plain PyTorch version on the card, at the
     shapes the main path gives it and a few edge shapes: deq/scales
     bit-equal, stats within rtol 1e-5, two runs bit-identical; each
     kernel's time beside its plain version's and its bound;
  2. the main path at full width: the CIFAR-10 split CNN (convs 32/64/128,
     d_c = 256, FC 128/64/10) at the paper's Table II sizes through
     ``run_pigeon(engine="sequential", quant="int8",
     selection="loss_plus_distance")`` with label flip on 4 of 20 clients;
     the launch counts show the path went through both kernels;
  3. the MNIST split CNN at Table II sizes, fp8-e4m3 wire, argmin, gradient
     attack;
  4. the same tiny run on the CPU and on the card, from the same init: equal
     discrete outcomes, validation losses within rtol 1e-3;
  5. where one CIFAR client turn's time goes (torch.profiler): device busy
     share, the top kernels, the host ops, and the batch gather.

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

HBM_BYTES_PER_S = 3.35e12       # H100 SXM memory rate (NVIDIA data sheet)
F32_OPS_PER_S = 67e12           # H100 SXM f32 rate outside the tensor cores
KERNEL_SHAPES = ((64, 256), (64, 32), (37, 200), (1, 256), (1024, 4096))
TIMED_SHAPE = (64, 256)         # (B, d_c) of the CIFAR cut layer at B = 64
STATS_RTOL = 1e-5


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

def _time_us(fn, x, fmt, reps: int = 200, samples: int = 15) -> float:
    """Median over ``samples`` of the mean time of ``reps`` back-to-back
    calls, by CUDA events (after a warm-up)."""
    import torch
    for _ in range(10):
        fn(x, fmt)
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn(x, fmt)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) * 1e3 / reps)
    times.sort()
    return times[len(times) // 2]


def _graph_time_us(fn, x, fmt, reps: int = 100, samples: int = 15) -> float:
    """Device time per call: ``reps`` calls captured in one CUDA graph and
    replayed, so the host's per-call cost drops out."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn(x, fmt)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn(x, fmt)
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


def _message(shape, seed: int):
    """A cut-layer-like message: ReLU activations of varied row scale, one
    all-zero row (the scale's eps path) where there is room."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    n, d = shape
    x = torch.randn(shape, generator=g, device="cuda")
    x = torch.relu(x - 0.3) * torch.rand((n, 1), generator=g, device="cuda") * 10.0
    x[:, : max(1, d // 8)] -= 0.5          # a little mass below zero
    if n > 2:
        x[1] = 0.0
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
        n, d = TIMED_SHAPE
        x = _message(TIMED_SHAPE, seed=99)
        kernel_us = _time_us(kernel, x, "int8")
        plain_us = _time_us(plain, x, "int8")
        kernel_dev_us = _graph_time_us(kernel, x, "int8")
        plain_dev_us = _graph_time_us(plain, x, "int8")
        # each input read once, each output written once
        n_bytes = 4 * n * d + 4 * n * d + 4 * n + (8 if name.endswith("stats") else 0)
        # per element: divide, round, clamp, multiply (+ 5 for the stats)
        n_ops = n * d * (4 + (5 if name.endswith("stats") else 0))
        bytes_us = n_bytes / HBM_BYTES_PER_S * 1e6
        ops_us = n_ops / F32_OPS_PER_S * 1e6
        results[name] = dict(max_abs_err=max_err, kernel_us=kernel_us,
                             plain_us=plain_us, bound_us=max(bytes_us, ops_us),
                             bound_by="bytes" if bytes_us >= ops_us else "operations")
        log(f"phase1 {name}: bit-equal to plain at {list(KERNEL_SHAPES)} "
            f"(int8, fp8_e4m3); max_abs_err={max_err:.3e}; at {TIMED_SHAPE} int8: "
            f"kernel_us={kernel_us:.3f} plain_us={plain_us:.3f} "
            f"bound_us={results[name]['bound_us']:.4f} ({results[name]['bound_by']}); "
            f"graph-replayed device time: kernel_us={kernel_dev_us:.3f} "
            f"plain_us={plain_dev_us:.3f}")
    return results


# ---------------------------------------------------------------------------
# phases 2-4: the protocol
# ---------------------------------------------------------------------------

def _run(name, module, data, pcfg, **kw):
    import torch
    from repro_torch.core import run_pigeon
    from repro_torch.kernels import quant_exchange as qx

    qx.reset_launches()
    t0 = time.perf_counter()
    hist = run_pigeon(module, data, pcfg, **kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(qx.LAUNCHES)
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


def phase_cifar():
    from repro_torch.core import LABEL_FLIP, Attack, ProtocolConfig, from_cnn
    from repro_torch.data import build_image_task

    t0 = time.perf_counter()
    data, cfg = build_image_task("cifar10", m_clients=20, d_m=2500, d_o=3000,
                                 n_test=7000, seed=0)
    log(f"phase2 data: CIFAR-10 task M=20 d_m=2500 d_o=3000 n_test=7000 "
        f"({(data.x.nbytes + data.x0.nbytes + data.x_test.nbytes) / 1e6:.0f} MB) "
        f"in {time.perf_counter() - t0:.1f} s")
    pcfg = ProtocolConfig(M=20, N=4, T=2, E=40, B=64, lr=2e-4, seed=0)
    hist, launches, seconds = _run(
        "phase2 cifar", from_cnn(cfg), data, pcfg, malicious={0, 5, 10, 15},
        attack=Attack(LABEL_FLIP), quant="int8", selection="loss_plus_distance",
        device="cuda")
    want = pcfg.T * pcfg.M * pcfg.E
    check(launches == {"quant_dequant": want, "quant_dequant_stats": want},
          f"phase2: launches {launches}, want {want} of each kernel")
    _check_exchange_bytes("phase2", hist, pcfg, cfg.d_cut, "int8")
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
    check(launches == {"quant_dequant": want, "quant_dequant_stats": 0},
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
    h_cpu = run_pigeon(module, data, pcfg, device="cpu", **kw)
    h_gpu = run_pigeon(module, data, pcfg, device="cuda", **kw)
    for rc, rg in zip(h_cpu.rounds, h_gpu.rounds):
        for k in ("clusters", "selected", "accepted", "detections", "comm"):
            check(rc[k] == rg[k], f"phase4 round {rc['round']}: {k} cpu={rc[k]} "
                                  f"card={rg[k]}")
        check(np.allclose(rc["val_losses"], rg["val_losses"], rtol=1e-3, atol=0),
              f"phase4: val_losses cpu={rc['val_losses']} card={rg['val_losses']}")
    log(f"phase4: CPU and card agree over {pcfg.T} rounds; val_losses "
        f"cpu={h_cpu.rounds[-1]['val_losses']} card={h_gpu.rounds[-1]['val_losses']}")


def phase_profile():
    """One CIFAR client turn as phase 2 runs it (E = 40 steps at B = 64, int8
    wire with stats), warm: wall time, the device's busy share under
    torch.profiler, the top device kernels and host ops, and the cost of
    gathering and moving the turn's batches."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
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
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        turn()
        torch.cuda.synchronize()
    events = prof.key_averages()

    def dev_us(ev) -> float:
        return float(getattr(ev, "self_device_time_total", 0.0)
                     or getattr(ev, "self_cuda_time_total", 0.0))

    kernels = [ev for ev in events if str(ev.device_type).endswith("CUDA")]
    busy_us = sum(dev_us(ev) for ev in kernels)
    log(f"phase5 cifar client turn (E={e}, B={b}, int8+stats): wall "
        f"{wall_us / 1e3:.2f} ms ({wall_us / e:.0f} us/step); batch gather+copy "
        f"{sorted(gathers)[1] * 1e3:.2f} ms; launches under the profiler "
        f"{sum(ev.count for ev in kernels)}")
    if busy_us == 0.0:
        log("phase5: the profiler recorded no device time: busy share not measured")
    else:
        log(f"phase5 device busy {busy_us / 1e3:.2f} ms of the {wall_us / 1e3:.2f} ms "
            f"unprofiled wall: idle share {1.0 - busy_us / wall_us:.3f}")
    for ev in sorted(kernels, key=dev_us, reverse=True)[:8]:
        log(f"  kernel {dev_us(ev) / 1e3:8.3f} ms x{ev.count:5d}  {ev.key[:90]}")
    host = [ev for ev in events if not str(ev.device_type).endswith("CUDA")]
    for ev in sorted(host, key=lambda ev: ev.self_cpu_time_total, reverse=True)[:8]:
        log(f"  host   {ev.self_cpu_time_total / 1e3:8.3f} ms x{ev.count:5d}  {ev.key[:90]}")


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
    launches, s_per_round = phase_cifar()
    phase_mnist()
    phase_cpu_vs_card()
    phase_profile()

    sources = {"quant_dequant": "src/repro/kernels/quant_exchange.py:85",
               "quant_dequant_stats": "src/repro/kernels/quant_exchange.py:144"}
    entries = [dict(name=name, route="cuda",
                    source="src/repro_torch/kernels/csrc/quant_exchange.cu",
                    replaces=sources[name], launches=launches[name],
                    max_abs_err=k["max_abs_err"], ms=k["kernel_us"] / 1e3,
                    plain_ms=k["plain_us"] / 1e3, bound_ms=k["bound_us"] / 1e3,
                    bound_by=k["bound_by"], library_ms=None)
               for name, k in kernels.items()]
    log(f"phase2 seconds_per_round={s_per_round:.3f}")
    log(json.dumps({"kernels": entries}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
