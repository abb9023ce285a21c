#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

from the repository root.  Phases, in order; any failure exits non-zero:

  0. set-up: require CUDA (no CPU fallback), print the card's name and power
     limit, the torch/CUDA/TF32 settings, and build every kernel (timed; one
     ``nvcc`` per source, all started together);
  1. every kernel against its plain PyTorch version on the card, at the
     shapes the main paths give it and a few edge shapes: the wire kernels'
     deq/scales bit-equal, stats within rtol 1e-5, two runs bit-identical
     (B2 also over the batched path's R*B rows, the stats kernel (one
     thread-block cluster a message up to 8,192 wide) also with R messages
     in one launch, at the sequential (1, 64, 256) and batched (5, 64, 256)
     layouts and at n 1 and 3, D 1,000 and 8,192; both at an LM's cut
     message (4, 2,097,152),
     which B3 runs on its wide path, and B3 also on (2, 4, 12,288), timed
     beside their bytes bound); the tamper
     check's sums within rtol 1e-5 of the plain version and of a float64
     sum, bit-identical from run to run, exactly 0 on identical inputs and
     above the tolerance only for a tampered candidate; the attention
     kernels (B5 flash attention, B6 decode attention) within atol 2e-5
     (f32) and 2e-2 (bf16) of their plain versions at the serve path's
     shapes and edge shapes (MQA, groups 1, windows, head dims 64/80/256,
     ragged S, index 0; B6 also with windows on its tensor-core route and
     at its 32k shape, where the bf16 bound is 2e-2 of the largest |plain|
     value), bit-identical from run
     to run, on both routes wherever a shape takes the tensor cores (B5's
     forward: wgmma with TMA loads; B6: mma.sync with cp.async loads and a
     cluster combine; and the f32-FMA kernel beside each), B6 also with
     ``index`` as a device scalar, each route's choice printed; each
     kernel's time (eager, graph-replayed with the L2 warm, one call with
     it cold) beside its plain version's, its bound and, for B5/B6, the
     time of PyTorch's ``scaled_dot_product_attention`` on the same inputs,
     eager and replayed (a yardstick the port never calls), also at two
     long-context shapes, the f32-FMA route timed beside the tensor-core
     route; B4 (fused cross-entropy) forward
     within atol 1e-5 (f32) and 3e-2 (bf16) of its plain version, loss and
     lse, on both routes wherever it takes the tensor cores (both timed),
     and its backward (dh, dW) and B5's
     backward (dq, dk, dv) within rel 1e-4 (f32) and 3e-2 (bf16) of
     autograd of the plain versions, each on both routes wherever it takes
     the tensor cores (timed side by side at the train shape, where the
     tensor cores must be the faster), at the train shapes (T 2,048 through
     Qwen3-8B's 4,096 x 151,936 head; B 4, S 512, 32/8 heads of 128) and
     edges (T and V tails, labels on panel edges and out of range; GQA
     groups 1/2/4/8, MQA, windows, head dims 64/80/256, S = 1), all
     bit-identical run to run, timed beside their plain versions, bounds
     and yardsticks (``F.cross_entropy(h @ W)``, two calls; autograd of
     SDPA); B7 (the sLSTM time scan) within atol 1e-4 (f32) and 8e-3 (bf16)
     of its plain version at the xLSTM prefill shape (T 512, B 4, d 2,048,
     H 4) and edges (H 1 and 2, dh 40, ragged units, B 1/3/5, T 1),
     bit-identical run to run, timed (no PyTorch call computes the scan),
     also at T 4,096; the wgmma routes' libraries hold HGMMA and UTMALDG
     instructions in their SASS (cuobjdump), B6's tensor-core library HMMA
     and LDGSTS (mma.sync, cp.async), the f32-FMA ones none of the four;
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
     1e-3; tiny LMs (``reduce_config`` of Qwen3-8B, and of xLSTM-1.3B, one
     B7 launch) served on both from one init: equal greedy tokens, logits
     within atol 1e-4; and the Qwen3-8B one through a Pigeon-SL run over ``from_lm`` (sequential, label
     flip) on both from one init: equal discrete outcomes, validation
     losses within rtol 1e-3;
  5. where the time goes (torch.profiler): one CIFAR client turn of the
     sequential engine and one batched CIFAR round step — device busy
     share, launches, the top kernels and the host ops;
  6. the serve path: Qwen3-8B at full width and depth (36 layers, bf16,
     8.19 B parameters drawn on the card from a seed) prefills 4 prompts of
     480 tokens through ``make_prefill_step`` (36 B5 launches, all on the
     tensor-core route), then runs the
     reference serve loop through ``make_serve_step`` (the prompt stepped,
     then 32 greedy tokens: 512 steps, 18,432 B6 launches, all on the
     tensor-core route); prefill and
     decode logits at the prompt's last position agree (bf16 bound, and at
     f32 with 4 layers a tight one); prefill seconds, ms per decode step,
     tokens/s, peak memory and the profile of one warm decode step;
  7. the train step: Qwen3-8B at full width and depth (36 layers, bf16,
     remat: the reference's train_4k settings with the sequence cut to
     512), three ``make_train_step`` calls on one (4, 512) batch of
     ``build_lm_task`` tokens: the loss finite and falling, per step 72 B5
     forwards (remat recomputes each) and one B4 forward, 36 B5 backwards
     and one B4 backward, all on the tensor-core routes; seconds and
     tokens per step, peak memory, one step's profile with B4's and B5's
     shares; at 4 layers in f32 the kernel path (the f32-FMA routes) holds
     its loss and every gradient within rel 1e-4 of the plain path's;
  8. the Pigeon-SL round over ``from_lm`` at Qwen3-8B's width, depth cut
     to 12 layers (9 client + 3 AP): ``run_pigeon`` (argmin, label flip on
     client 0, Pigeon-SL+, T = 2) without the wire and with int8 through
     B2, then with int8 and ``selection="loss_plus_distance"`` (B3 on its
     wide path for every client step's uplink); finite losses, the
     selection the policy's scores give, the launches the round's
     structure predicts, exchange bytes, seconds per round and peak memory;
  9. the xLSTM serve path: xLSTM-1.3B at full width and depth (48 blocks,
     (mLSTM 7, sLSTM 1) x 6, bf16, 3,529,644,368 parameters drawn on the
     card) prefills 4 prompts of 512 tokens through ``make_prefill_step``
     (6 B7 launches, 3,072 step kernels), then runs the reference serve
     loop through ``make_serve_step`` (544 steps, no kernel of the port);
     the same weights widened to f32 and served again: prefill and decode
     logits agree within 1e-3 in f32, and the bf16 ones within 0.6 of each
     other and of the f32 logits (bf16 rounding compounds over 48 blocks
     at random init); prefill seconds, ms per decode step, tokens/s, peak
     memory, one warm decode step's profile; a longer prefill at
     prefill_32k's settings (B 4 x 2,048 tokens), profiled, with B7's
     step kernels counted and its share beside the mLSTM products'.

The last lines are one JSON object per kernel set (``{"kernels": [...]}``),
the card's ``nvidia-smi`` name and power limit, and
``{"ok": true, "device": {...}}``.  Imports nothing of JAX or of the JAX
package.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
DEVICE = "cuda"                 # where phases 1, 4 (LM) and 6 run the card's side

HBM_BYTES_PER_S = 3.35e12       # H100 SXM memory rate (NVIDIA data sheet)
F32_OPS_PER_S = 67e12           # H100 SXM f32 rate outside the tensor cores
# the batched round's messages: R = 5 clusters of (B, d_c) = (64, 256)
BATCHED_MESSAGES = (5, 64, 256)
TIMED_SHAPE = (64, 256)         # (B, d_c) of the CIFAR cut layer at B = 64
# an LM's cut message: B 4 x (S 512 * d_model 4,096) (phase 8), which B3
# takes on its wide path (wider than quant_exchange.MAX_STATS_D); and R = 2
# wide messages in one stats call
LM_MESSAGE = (4, 2_097_152)
WIDE_BATCHED = (2, 4, 12_288)
# the wire kernels' checks: the batched path's R*B rows (one B2 launch a
# step), the sequential path's one message, then edge shapes and the LM's
KERNEL_SHAPES = ((BATCHED_MESSAGES[0] * BATCHED_MESSAGES[1], BATCHED_MESSAGES[2]),
                 TIMED_SHAPE, (64, 32), (37, 200), (1, 256), (1, 1000), (3, 1000),
                 (1, 8192), (3, 8192), (1024, 4096), LM_MESSAGE)
# R messages in one stats call: the batched round's, the sequential path's
# one message in the batched layout, and wide ones (B3's wide path)
STATS_BATCHED = (BATCHED_MESSAGES, (1,) + TIMED_SHAPE, WIDE_BATCHED)
# the tamper check's (R, D_o, d_c): CIFAR, MNIST, ragged, tiny, large
TAMPER_SHAPES = ((5, 3000, 256), (4, 3000, 32), (3, 37, 200), (1, 1, 256),
                 (2, 4096, 4096))
STATS_RTOL = 1e-5
TAMPER_RTOL = 1e-5
TAMPER_TOL = 1e-4               # ProtocolConfig.tamper_tol

BF16_OPS_PER_S = 989e12         # H100 SXM dense bf16 tensor-core rate
# attention: (B, S, H, Hkv, D, window) for B5, (..., index) for B6; the serve
# path's shapes first (Qwen3-8B: 32 query and 8 KV heads of 128; a 480-token
# prompt, a 512-position cache), then MQA, groups 1, windows, head dims
# 64/80/256 and ragged S; B6's last three take windows on the tensor-core
# route (bf16 at head dims 128 and 64, a window wider than the live range)
FLASH_SHAPES = ((4, 480, 32, 8, 128, 0), (2, 128, 8, 1, 64, 0), (2, 96, 4, 4, 64, 0),
                (1, 480, 8, 2, 128, 64), (2, 37, 4, 2, 80, 0), (1, 300, 16, 8, 256, 128),
                (1, 1, 4, 2, 64, 0))
DECODE_SHAPES = ((4, 512, 32, 8, 128, 0, 479), (4, 512, 32, 8, 128, 0, 511),
                 (2, 300, 8, 1, 64, 0, 0), (2, 256, 4, 4, 64, 0, 255),
                 (1, 1000, 4, 2, 80, 100, 999), (2, 257, 16, 8, 256, 1024, 200),
                 (1, 37, 8, 2, 128, 0, 36), (1, 100, 32, 1, 128, 0, 50),
                 (1, 1000, 8, 2, 128, 100, 999), (2, 256, 8, 2, 64, 16, 200),
                 (1, 300, 16, 4, 128, 256, 100))
# long context at Qwen3-8B widths: one 8k prompt; one layer of decode_32k at
# 8 of its 128 sequences
FLASH_LONG = (1, 8192, 32, 8, 128, 0)
DECODE_LONG = (8, 32768, 32, 8, 128, 0, 32767)
ATTN_ATOL = {"float32": 2e-5, "bfloat16": 2e-2}
# at DECODE_LONG a typical |out| is about sqrt(e / 32,768) = 0.009 (N(0, 1)
# inputs over 32k live keys), under the bf16 atol itself: there the bf16
# bound is this share of the call's largest |plain| value (~5 bf16 ulps of it)
LONG_BF16_REL = 2e-2
# phase 6: Qwen3-8B served at B = 4, 480 prompt tokens, 32 new ones
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 4, 480, 32
# prefill vs decode logits at the prompt's last position, the largest
# difference relative to the largest |logit|.  bf16: each path rounds every
# activation to 8 significant bits (2^-9 = 2e-3 relative) at different
# points of 36 residual layers, and the two add up like a random walk
# (sqrt(2 * 36) * 2e-3 = 1.7e-2); the bound leaves 3x above that.  f32 at
# 4 layers: only the summation order differs (~1e-6 relative).
SERVE_BF16_REL = 5e-2
SERVE_F32_REL = 1e-3
# B4: (T, D, V), the train shape first (T = B * S = 4 * 512 tokens through
# Qwen3-8B's 4,096 x 151,936 head), then T and V tails at full vocab and
# small edges; tolerances of the reference's kernel test (atol) and of
# the gradients (relative to the call's largest plain-version value)
XENT_SHAPES = ((2048, 4096, 151936), (333, 1024, 151936), (129, 256, 151937),
               (37, 80, 1000), (1, 64, 7))
XENT_ATOL = {"float32": 1e-5, "bfloat16": 3e-2}
GRAD_REL = {"float32": 1e-4, "bfloat16": 3e-2}
# phases 7 and 8: Qwen3-8B trained at B 4 x S 512 (the train_4k settings,
# the sequence cut from 4,096), tokens of build_lm_task's vocabulary 2,048
# (the head stays 151,936 wide); SGD lr 0.1 moves bf16 weights (a smaller
# step rounds away in bf16); the round's depth cut to 12 layers
TRAIN_BATCH, TRAIN_SEQ, TRAIN_VOCAB, TRAIN_LR = 4, 512, 2048, 0.1
TRAIN_F32_REL = 1e-4
ROUND_LAYERS = 12
# B7 (the sLSTM scan): (T, B, d, H), the prefill shape first (xLSTM-1.3B: a
# 512-token prompt at B 4, d 2,048, 4 heads of 512), then H 1 and 2, dh 40
# with a ragged unit block and 3 rows, B 5 (two row blocks), B 1, T 1; the
# long shape (a 4,096-token sequence) is timed only
SLSTM_SHAPES = ((512, 4, 2048, 4), (64, 4, 2048, 1), (64, 4, 2048, 2), (33, 3, 80, 2),
                (20, 5, 96, 2), (40, 1, 2048, 4), (1, 4, 2048, 4))
SLSTM_LONG = (4096, 4, 2048, 4)
# h is bounded by 1 and the state never goes through bf16, so the error does
# not compound: in bf16 the outputs differ by their last roundings, two bf16
# ulps at |h| <= 1 (2 * 2^-8); f32 by the dot products' summation order
SLSTM_ATOL = {"float32": 1e-4, "bfloat16": 8e-3}
# phase 9: xLSTM-1.3B served at B 4, 512-token prompts (two mLSTM chunks of
# 256), 32 new tokens; the reference's layer counts 3,529,644,368 parameters.
# Prefill vs decode logits at the prompt's last position.  The tight check
# runs the same weights widened to f32 at full depth (6 B7 launches): the
# chunked and the recurrent form of the same f32 math, 1e-3.  In bf16 the
# rounding does not stay a random walk as in Qwen3-8B (SERVE_BF16_REL): at
# this random init the 48 blocks compound it, stack after stack, so each
# bf16 path lands some 0.3 of max |logit| from the f32 logits (a first
# run read 0.277 between the two bf16 paths).  The reference does the same:
# at d_model 64 and full depth on the CPU its own bf16 logits lie 0.54 of
# max |logit| from its f32 logits, and the port's as far from theirs
# (tests/test_torch_xlstm.py's full-depth bf16 tests).  The bf16 paths are held
# within 0.6 of each other and of the f32 logits: the sum of two such
# errors; a path that computed another function (another gate layout, a
# lost chunk carry) moves the logits by their own scale.  The longer
# prefill takes prefill_32k's settings (ssm_chunk 2,048), its 32 x 32,768
# tokens cut to 4 x 2,048.
XLSTM_BATCH, XLSTM_PROMPT, XLSTM_NEW = 4, 512, 32
XLSTM_PARAMS = 3_529_644_368
XLSTM_BF16_REL = 0.6
XLSTM_F32_REL = 1e-3
XLSTM_LONG_PROMPT = 2048
# the xLSTM prefills' device time, by kernel name
PREFILL_SHARES = {"B7 (slstm_step)": ["slstm_step"],
                  "f32 products (the mLSTM einsums)": ["sgemm", "f32f32", "f32_f32"],
                  "bf16 products (projections, head)": ["bf16", "nvjet"]}
# B5's backward: the train shape (B 4, S 512, Qwen3-8B's heads), then GQA
# group 8, the forward's edge shapes (MQA, group 1, windows, head dims
# 64/80/256, ragged S, S = 1)
ATTN_BWD_SHAPES = ((4, 512, 32, 8, 128, 0), (2, 64, 16, 2, 128, 0)) + FLASH_SHAPES[1:]


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def want_launches(**counts) -> dict:
    """``build.LAUNCHES`` as a path should leave it: ``counts``, else 0."""
    from repro_torch.kernels import build
    return {**dict.fromkeys(build.LAUNCHES, 0), **counts}


#: the libraries of each route of B5's and B4's forwards and backwards and
#: of B6 (fused_xent.cu holds the f32 route's forward and its xent_grad):
#: the wgmma ones, B6's mma.sync one, the f32-FMA ones
TC_LIBRARIES = ("flash_attention_tc", "fused_xent_tc", "flash_attention_bwd_tc",
                "fused_xent_bwd_tc")
MMA_LIBRARIES = ("decode_attention_tc",)
FMA_LIBRARIES = ("flash_attention", "fused_xent", "flash_attention_bwd", "decode_attention")
#: SASS opcodes counted: wgmma, TMA loads, mma.sync, cp.async
SASS_OPS = ("HGMMA", "UTMALDG", "HMMA", "LDGSTS")


def phase_sass() -> dict:
    """Count the Hopper instructions in each built library's SASS
    (``cuobjdump --dump-sass``): the wgmma routes must hold wgmma (HGMMA) and
    TMA loads (UTMALDG), B6's tensor-core route tensor-core products (HMMA or
    HGMMA) and asynchronous copies (LDGSTS or UTMALDG), the f32-FMA routes
    none of the four."""
    import shutil

    from repro_torch.kernels import build
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    counts = {}
    for name in build.SOURCES:
        sass = subprocess.run([tool, "--dump-sass", str(build.library_path(name))],
                              capture_output=True, text=True, timeout=300, check=True).stdout
        counts[name] = {op: len(re.findall(rf"\b{op}\b", sass)) for op in SASS_OPS}
    for name in TC_LIBRARIES:
        check(counts[name]["HGMMA"] and counts[name]["UTMALDG"],
              f"phase0: {name}'s SASS lacks wgmma or TMA: {counts[name]}")
    for name in MMA_LIBRARIES:
        c = counts[name]
        check((c["HMMA"] or c["HGMMA"]) and (c["LDGSTS"] or c["UTMALDG"]),
              f"phase0: {name}'s SASS lacks tensor-core products or asynchronous copies: {c}")
    for name in FMA_LIBRARIES:
        check(not any(counts[name].values()), f"phase0: the f32-FMA route {name} holds "
                                              f"Hopper tensor-core instructions {counts[name]}")
    log(f"phase0 SASS instruction counts (HGMMA: wgmma, UTMALDG: TMA loads, HMMA: mma.sync, "
        f"LDGSTS: cp.async): {counts}")
    return counts


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 1: kernels against their plain versions
# ---------------------------------------------------------------------------

def _time_us(fn, *args, reps: int = 200, samples: int = 15, warmup: int = 10) -> float:
    """Median over ``samples`` of the mean time of ``reps`` back-to-back
    calls, by CUDA events (after ``warmup`` calls)."""
    import torch
    for _ in range(warmup):
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


def _graph_times_us(fns, reps: int = 100, samples: int = 15):
    """Device time per call of each of ``fns``: ``reps`` calls of each
    captured in a CUDA graph of its own, so the host's per-call cost drops
    out, and the graphs replayed in turn ``samples`` times, so a change in
    the card's speed during the run falls on all of them alike.  The sorted
    per-call times of each."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in fns:
            for _ in range(3):
                fn()
    torch.cuda.current_stream().wait_stream(side)
    graphs = []
    for fn in fns:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
        graph.replay()
        graphs.append(graph)
    torch.cuda.synchronize()
    times = [[] for _ in graphs]
    for _ in range(samples):
        for graph, got in zip(graphs, times):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            got.append(start.elapsed_time(end) * 1e3 / reps)
    return [sorted(got) for got in times]


def _median(times) -> float:
    return times[len(times) // 2]


def _graph_time_us(fn, *args, reps: int = 100, samples: int = 15) -> float:
    """Device time per call (the median of :func:`_graph_times_us`)."""
    return _median(_graph_times_us([lambda: fn(*args)], reps=reps, samples=samples)[0])


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
        # sequential path's (one message), then the LM round's
        m, n, d = BATCHED_MESSAGES
        main_shape = (m, n, d) if stats else (m * n, d)
        for shape in (main_shape, TIMED_SHAPE, LM_MESSAGE):
            x = _message(shape, seed=99)
            n, d = shape[-2:]
            rows = x.numel() // d
            few = dict(reps=20, samples=5) if shape == LM_MESSAGE else {}
            kernel_us = _time_us(kernel, x, "int8", **few)
            plain_us = _time_us(plain, x, "int8", **few)
            kernel_dev_us = _graph_time_us(kernel, x, "int8", **few)
            plain_dev_us = _graph_time_us(plain, x, "int8", **few)
            kernel_cold_us = _cold_time_us(kernel, x, "int8", reps=10 if few else 50)
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
            if shape == LM_MESSAGE:
                results[name]["lm_message"] = dict(shape=list(shape), **timing)
            log(f"phase1 {name} at {shape} int8: kernel_us={kernel_us:.3f} "
                f"plain_us={plain_us:.3f} bound_us={timing['bound_us']:.4f} "
                f"({timing['bound_by']}); graph-replayed device time (L2 warm): "
                f"kernel_us={kernel_dev_us:.3f} plain_us={plain_dev_us:.3f}; one "
                f"call with the L2 cold: kernel_us={kernel_cold_us:.3f}")
        batched = f" and R messages at {list(STATS_BATCHED)}"
        log(f"phase1 {name}: bit-equal to plain at {list(KERNEL_SHAPES)} "
            f"(int8, fp8_e4m3){batched if stats else ''}; "
            f"max_abs_err={max_err:.3e}")
    results["tamper_check_sums"] = _phase_tamper()
    results.update(_phase_xent())
    results.update(_phase_attention())
    results.update(_phase_attention_bwd())
    results["slstm_scan"] = _phase_slstm()
    return results


def _check_batched_stats() -> float:
    """R messages through one stats call, narrow and wide: each slot
    bit-equal to the plain version's (deq, scales, and stats as one
    message's)."""
    import torch
    from repro_torch.kernels import quant_exchange as qx
    max_err = 0.0
    for fmt, shape in ((f, sh) for f in qx.QUANT_FORMATS for sh in STATS_BATCHED):
        x = _message(shape, seed=7)
        out1 = qx.quant_dequant_stats(x, fmt)
        out2 = qx.quant_dequant_stats(x, fmt)
        ref = qx.quant_dequant_stats_plain(x, fmt)
        torch.cuda.synchronize()
        for a, b in zip(out1, out2):
            check(torch.equal(a, b), f"batched stats {fmt} {shape}: two runs differ")
        check(torch.equal(out1[0], ref[0]) and torch.equal(out1[1], ref[1]),
              f"batched stats {fmt} {shape}: deq/scales differ from the plain version")
        check(torch.allclose(out1[2], ref[2], rtol=STATS_RTOL, atol=1e-7),
              f"batched stats {fmt} {shape}: {out1[2].tolist()} vs plain "
              f"{ref[2].tolist()}")
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


def _attention_args(name: str, shape, dtype: str, seed: int):
    """(args, kwargs) of one B5 or B6 call: q, k, v (and the index) drawn on
    the card in ``dtype``, the window as a keyword."""
    import torch
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    b, s, h, hkv, d, window = shape[:6]
    sq = 1 if name == "decode_attention" else s
    dt = getattr(torch, dtype)
    q = torch.randn((b, sq, h, d), generator=g, device=DEVICE).to(dt)
    k = torch.randn((b, s, hkv, d), generator=g, device=DEVICE).to(dt)
    v = torch.randn((b, s, hkv, d), generator=g, device=DEVICE).to(dt)
    args = (q, k, v) if name == "flash_attention" else (q, k, v, shape[6])
    return args, {"window": window}


def _attention_library(name: str, args, window: int):
    """The one PyTorch call that computes the same function (no window):
    ``scaled_dot_product_attention`` over (B, H, S, D) views, for B6 over
    the live cache ``k[:, :index + 1]``.  Timed for the record only."""
    if window:
        return None
    import torch.nn.functional as F
    q, k, v = args[:3]
    if name == "decode_attention":
        k, v = k[:, :args[3] + 1], v[:, :args[3] + 1]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    causal = name == "flash_attention"
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                                  enable_gqa=True)


def _attention_bound_us(name: str, shape, dtype: str):
    """(bound in us, what sets it): each input read once, the output written
    once, over 3.35 TB/s; 4 * D flops per live (query, key) pair and head
    (scores and values), over the dtype's peak (bf16 tensor cores; f32 FMA
    units, TF32 off)."""
    from repro_torch.kernels.decode_attention import live_range
    b, s, h, hkv, d, window = shape[:6]
    elt = 4 if dtype == "float32" else 2
    if name == "flash_attention":
        pairs = sum(min(i + 1, window) if window else i + 1 for i in range(s))
        n_bytes = elt * (2 * b * s * h * d + 2 * b * s * hkv * d)
    else:
        begin, end = live_range(shape[6], window)
        pairs = end - begin
        n_bytes = elt * (2 * b * h * d + 2 * b * pairs * hkv * d)
    n_ops = 4 * d * pairs * b * h
    bytes_us = n_bytes / HBM_BYTES_PER_S * 1e6
    ops_us = n_ops / (F32_OPS_PER_S if dtype == "float32" else BF16_OPS_PER_S) * 1e6
    return max(bytes_us, ops_us), ("bytes" if bytes_us >= ops_us else "operations")


def _attention_timing(name: str, kernel, plain, shape, long: bool, old=None):
    """Times of one B5/B6 call at ``shape`` in bf16: the kernel eager,
    graph-replayed (L2 warm) and L2-cold; with ``old``, the same of the
    f32-FMA route beside it; the plain version eager (and replayed, at the
    serve shapes); SDPA eager and replayed (the kernels' replayed times are
    held against the replayed SDPA, like for like: the kernel's, SDPA's and
    the f32-FMA route's graphs are replayed in turn); the bound."""
    import torch
    args, kw = _attention_args(name, shape, "bfloat16", seed=99)
    lib = _attention_library(name, args, kw["window"])
    if lib is not None:
        with torch.inference_mode():
            want = plain(*args, **kw).float()
            got = lib().transpose(1, 2).float()
        check(float((got - want).abs().max()) <= ATTN_ATOL["bfloat16"],
              f"{name} {shape}: SDPA disagrees with the plain version")
    few = dict(reps=5, samples=5) if long else {}
    call = lambda: kernel(*args, **kw)               # noqa: E731
    plain_call = lambda: plain(*args, **kw)          # noqa: E731
    old_call = None if old is None else (lambda: old(*args, **kw))   # noqa: E731
    # the kernel, SDPA and the f32-FMA route replayed in turn, each from its
    # own graph: their replayed times are taken alike and at the same time
    replayed = [fn for fn in (call, lib, old_call) if fn is not None]
    with torch.inference_mode():
        dev = dict(zip(replayed, _graph_times_us(
            replayed, **(dict(reps=5, samples=9) if long else {}))))
        timing = dict(kernel_us=_time_us(call, **few),
                      kernel_dev_us=_median(dev[call]),
                      kernel_cold_us=_cold_time_us(call, reps=5 if long else 50),
                      plain_us=_time_us(plain_call,
                                        **(dict(reps=2, samples=3) if long else {})),
                      plain_dev_us=None if long else _graph_time_us(plain_call),
                      library_us=None if lib is None else _time_us(lib, **few),
                      library_dev_us=None if lib is None else _median(dev[lib]))
        timing["bound_us"], timing["bound_by"] = _attention_bound_us(name, shape, "bfloat16")
        if old is not None:
            timing["f32_fma_route"] = dict(
                kernel_us=_time_us(old_call, **few), kernel_dev_us=_median(dev[old_call]),
                kernel_cold_us=_cold_time_us(old_call, reps=3 if long else 10))
    spread = ", ".join(f"{what} {dev[fn][0]:.3f}-{dev[fn][-1]:.3f}" for what, fn in
                       (("kernel", call), ("sdpa", lib), ("f32-FMA route", old_call))
                       if fn is not None)
    log(f"phase1 {name} at {shape} bf16, graph replays taken in turn: per-call us from "
        f"the fastest to the slowest replay: {spread}")
    if old is not None:
        log(f"phase1 {name} at {shape} bf16, the f32-FMA route: kernel_us="
            f"{timing['f32_fma_route']['kernel_us']:.3f}; graph-replayed device time: "
            f"kernel_us={timing['f32_fma_route']['kernel_dev_us']:.3f}; L2 cold: "
            f"kernel_us={timing['f32_fma_route']['kernel_cold_us']:.3f}")
    plain_dev = ("not timed" if timing["plain_dev_us"] is None
                 else f"{timing['plain_dev_us']:.3f}")
    lib_us = ("none" if lib is None else
              f"{timing['library_us']:.3f} eager, {timing['library_dev_us']:.3f} replayed")
    log(f"phase1 {name} at {shape} bf16: kernel_us={timing['kernel_us']:.3f} "
        f"plain_us={timing['plain_us']:.3f} sdpa_us={lib_us} "
        f"bound_us={timing['bound_us']:.4f} ({timing['bound_by']}); graph-replayed "
        f"device time (L2 warm): kernel_us={timing['kernel_dev_us']:.3f} "
        f"plain_us={plain_dev}; one call with the L2 cold: "
        f"kernel_us={timing['kernel_cold_us']:.3f}")
    return dict(shape=list(shape), dtype="bfloat16", **timing)


def _phase_attention():
    """B5 and B6 against their plain versions at the serve path's shapes and
    the edge shapes (B6 also at its long-context shape), in f32 and bf16,
    on every route a shape takes (the tensor-core route and the f32-FMA one
    beside it), B6 also with ``index`` as a device scalar; bit-identical run
    to run; timed at the serve shapes and at the long-context shapes, both
    routes side by side."""
    import torch
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa

    def flash(route=None):
        return lambda *a, **kw: fa.flash_attention(*a, **kw, route=route)[0]

    def decode(route=None, device_index=False):
        def call(q, k, v, index, **kw):
            if device_index:
                index = torch.tensor(index, dtype=torch.int32, device=q.device)
            return da.decode_attention(q, k, v, index, **kw, route=route)
        return call

    results = {}
    for name, kernel, old, plain, shapes, long_shape, route_of in (
            ("flash_attention", flash(), flash(fa.F32_FMA), fa.flash_attention_plain,
             FLASH_SHAPES, FLASH_LONG, fa.attention_route),
            ("decode_attention", decode(), decode(fa.F32_FMA), da.decode_attention_plain,
             DECODE_SHAPES + (DECODE_LONG,), DECODE_LONG, da.decode_route)):
        max_err, routes = {}, {}
        for dtype in ("float32", "bfloat16"):
            for i, shape in enumerate(shapes):
                args, kw = _attention_args(name, shape, dtype, seed=i)
                route = route_of(*args[:3])
                routes.setdefault(route, []).append((dtype, shape))
                # each kernel on its own route and, where that is the tensor
                # cores', on the f32-FMA route beside it; B6 also with the
                # index on the device
                calls = [(route, kernel)]
                if route == fa.TENSOR_CORES:
                    calls.append((fa.F32_FMA, old))
                if name == "decode_attention":
                    calls += [(f"{how} device index", decode(how, device_index=True))
                              for how, _ in list(calls)]
                with torch.inference_mode():
                    ref = plain(*args, **kw)
                bound = ATTN_ATOL[dtype]
                long_bf16 = shape == long_shape and dtype == "bfloat16"
                if long_bf16:
                    bound = LONG_BF16_REL * float(ref.float().abs().max())
                    long_errs = {"bound": bound}
                for how, call in calls:
                    with torch.inference_mode():
                        out1 = call(*args, **kw)
                        out2 = call(*args, **kw)
                    torch.cuda.synchronize()
                    what = f"{name} ({how}) {dtype} {shape}"
                    check(torch.equal(out1, out2), f"{what}: two runs differ")
                    check(out1.shape == ref.shape and out1.dtype == ref.dtype,
                          f"{what}: {out1.shape} {out1.dtype} vs plain {ref.shape} "
                          f"{ref.dtype}")
                    check(bool(torch.isfinite(out1).all()), f"{what}: not finite")
                    err = float((out1.float() - ref.float()).abs().max())
                    check(err <= bound, f"{what}: max |kernel - plain| {err:.3e} > {bound:.3e}")
                    key = f"{how} {dtype}"
                    max_err[key] = max(max_err.get(key, 0.0), err)
                    if i == 0 and dtype == "bfloat16" and how == route:
                        main_err = err
                    if long_bf16:
                        long_errs[how] = err
                del args, ref
        for route, cases in routes.items():
            log(f"phase1 {name}: {route} route takes {cases}")
        log(f"phase1 {name}: within atol {ATTN_ATOL} of plain at {list(shapes)} in f32 "
            f"and bf16 on every route{' and index form' if name == 'decode_attention' else ''}, "
            f"bit-identical run to run; max_abs_err {max_err}")
        if long_shape in shapes:
            log(f"phase1 {name} at {long_shape} bf16: max |kernel - plain| by route "
                f"{long_errs}, the bound {LONG_BF16_REL} x max |plain|")
        main = _attention_timing(name, kernel, plain, shapes[0], long=False, old=old)
        long_context = _attention_timing(name, kernel, plain, long_shape, long=True, old=old)
        if name == "decode_attention":
            # B6's tensor-core route must beat the f32-FMA one in the same call
            for timing in (main, long_context):
                fma = timing["f32_fma_route"]["kernel_dev_us"]
                check(timing["kernel_dev_us"] < fma,
                      f"{name} {timing['shape']}: the tensor-core route "
                      f"({timing['kernel_dev_us']:.2f} us replayed) is not faster than the "
                      f"f32-FMA route ({fma:.2f} us)")
        results[name] = dict(max_abs_err=main_err, max_abs_err_by_route=max_err, **main,
                             long_context=long_context)
    return results


def _rel_err(got, want, zero_scale: float = 0.0) -> float:
    """max |got - want| over max |want|, each tensor on its own scale.  A
    reference that is identically 0 (dq with a single key) is held against
    ``zero_scale``, the largest |value| among the call's other outputs."""
    scale = float(want.abs().max()) if want.numel() else 0.0
    if scale == 0.0:
        scale = zero_scale
    return float((got.float() - want.float()).abs().max()) / max(scale, 1e-30)


def _xent_grad_err(dh, dw, ref_dh, ref_dw, labels) -> float:
    """The B4 backward's error, as the worst of four parts each on its own
    scale: dh's rows with an in-range label and the rest, dW's columns some
    in-range label hits and the rest.  The one-hot term dominates the hit
    rows and columns by four orders of magnitude at the train shape, so only
    the other parts, which are the softmax term alone, can see that term."""
    import torch
    v = ref_dw.shape[1]
    inside = (labels >= 0) & (labels < v)
    hit = torch.zeros(v, dtype=torch.bool, device=labels.device)
    hit[labels[inside].long()] = True
    parts = ((dh[inside], ref_dh[inside]), (dh[~inside], ref_dh[~inside]),
             (dw[:, hit], ref_dw[:, hit]), (dw[:, ~hit], ref_dw[:, ~hit]))
    return max(_rel_err(a, r) for a, r in parts if r.numel())


def _xent_grad_mutants(h, w, labels, gup, dh, dw):
    """Wrong backwards the check must refuse: dh of zeros, and dh and dW with
    the softmax term dropped (the one-hot term alone)."""
    import torch
    inside = (labels >= 0) & (labels < w.shape[1])
    rows, lab = torch.nonzero(inside)[:, 0], labels[inside].long()
    onehot_dh = torch.zeros_like(dh, dtype=torch.float32)
    onehot_dh[rows] = -(gup[rows, None] * w[:, lab].t().float())
    onehot_dw = torch.zeros_like(dw, dtype=torch.float32)
    onehot_dw.index_add_(1, lab, -(h[rows].float() * gup[rows, None]).t())
    return (("a zero dh", torch.zeros_like(dh), dw),
            ("dh without the softmax term", onehot_dh, dw),
            ("dW without the softmax term", dh, onehot_dw))


def _xent_args(shape, dtype: str, seed: int):
    """hidden (T, D) ~ N(0, 1) (a final norm's output), weights (D, V) at
    the LM head's init scale 0.02, int32 labels with panel edges (0, 127,
    128, V - 1) and out-of-range labels (-1, V, -100) in front, and an
    upstream gradient (T,) f32."""
    import torch
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    t, d, v = shape
    dt = getattr(torch, dtype)
    h = torch.randn((t, d), generator=g, device=DEVICE).to(dt)
    w = (torch.randn((d, v), generator=g, device=DEVICE) * 0.02).to(dt)
    labels = torch.randint(0, v, (t,), generator=g, device=DEVICE, dtype=torch.int32)
    edges = torch.tensor([0, 127, 128, v - 1, -1, v, -100], dtype=torch.int32,
                         device=DEVICE)[:t]
    labels[:edges.numel()] = edges
    gup = torch.randn((t,), generator=g, device=DEVICE)
    return h, w, labels, gup


def _phase_xent():
    """B4 forward (loss and lse) and backward (dh, dW) against the plain
    version and its autograd at the train shape and the edges, f32 and
    bf16, bit-identical run to run; timed at the train shape in bf16."""
    import torch
    from repro_torch.kernels import fused_xent as fx

    fwd_err, bwd_err, mutant_err, routes, bwd_routes = {}, {}, {}, {}, {}
    for dtype in ("float32", "bfloat16"):
        for i, shape in enumerate(XENT_SHAPES):
            h, w, labels, gup = _xent_args(shape, dtype, seed=i)
            route = fx.xent_route(h, w)
            routes.setdefault(route, []).append((dtype, shape))
            hh, ww = h.clone().requires_grad_(), w.clone().requires_grad_()
            ref = fx.fused_xent_plain(hh, ww, labels)
            ref_dh, ref_dw = torch.autograd.grad((ref * gup).sum(), (hh, ww))
            with torch.no_grad():
                ref_lse = torch.logsumexp(h.float() @ w.float(), dim=-1)
            # the forward on its own route and, where that is the tensor
            # cores', on the f32-FMA route it replaced
            for how in [route] + ([fx.F32_FMA] if route == fx.TENSOR_CORES else []):
                loss1, lse1 = fx.fused_xent(h, w, labels, route=how)
                loss2, lse2 = fx.fused_xent(h, w, labels, route=how)
                torch.cuda.synchronize()
                what = f"fused_xent ({how}) {dtype} {shape}"
                check(torch.equal(loss1, loss2) and torch.equal(lse1, lse2),
                      f"{what}: two runs differ")
                err = max(float((loss1 - ref.detach()).abs().max()),
                          float((lse1 - ref_lse).abs().max()))
                check(bool(torch.isfinite(loss1).all()), f"{what}: not finite")
                check(err <= XENT_ATOL[dtype], f"{what}: max |kernel - plain| {err:.3e} > "
                                               f"{XENT_ATOL[dtype]}")
                fwd_err[f"{how} {dtype}"] = max(fwd_err.get(f"{how} {dtype}", 0.0), err)
                if how == route:
                    route_err, route_lse = err, lse1
            err, lse1 = route_err, route_lse
            # the backward on its own route and, where that is the tensor
            # cores', on the f32-FMA route it replaced; the mutants are held
            # against the first
            bwd_route = fx.xent_bwd_route(h, w)
            bwd_routes.setdefault(bwd_route, []).append((dtype, shape))
            for how in [bwd_route] + ([fx.F32_FMA] if bwd_route == fx.TENSOR_CORES else []):
                dh1, dw1 = fx.fused_xent_bwd(h, w, labels, lse1, gup, route=how)
                dh2, dw2 = fx.fused_xent_bwd(h, w, labels, lse1, gup, route=how)
                torch.cuda.synchronize()
                what = f"fused_xent_bwd ({how}) {dtype} {shape}"
                check(torch.equal(dh1, dh2) and torch.equal(dw1, dw2), f"{what}: two runs differ")
                gerr = _xent_grad_err(dh1, dw1, ref_dh, ref_dw, labels)
                check(dh1.dtype == h.dtype and dw1.dtype == w.dtype and gerr <= GRAD_REL[dtype],
                      f"{what}: rel err {gerr:.3e} > {GRAD_REL[dtype]}")
                if i == 0 and how == bwd_route:
                    for bad_what, bad_dh, bad_dw in _xent_grad_mutants(h, w, labels, gup, dh1,
                                                                       dw1):
                        bad = _xent_grad_err(bad_dh, bad_dw, ref_dh, ref_dw, labels)
                        check(bad > GRAD_REL[dtype], f"{what}: the check passes {bad_what} "
                                                     f"(rel err {bad:.3e})")
                        mutant_err.setdefault(dtype, {})[bad_what] = bad
                key = f"{how} {dtype}"
                bwd_err[key] = max(bwd_err.get(key, 0.0), gerr)
                if i == 0 and dtype == "bfloat16" and how == bwd_route:
                    main_err, main_gerr = err, gerr
                    main_gabs = max(float((dh1.float() - ref_dh.float()).abs().max()),
                                    float((dw1.float() - ref_dw.float()).abs().max()))
                del dh1, dw1, dh2, dw2
            del h, w, hh, ww, ref, ref_dh, ref_dw
            torch.cuda.empty_cache()
    log(f"phase1 fused_xent: loss and lse within atol {XENT_ATOL} of plain at "
        f"{list(XENT_SHAPES)} (labels on panel edges and out of range), bit-identical run "
        f"to run; routes {routes}; max_abs_err {fwd_err}")
    log(f"phase1 fused_xent_bwd: dh, dW within rel {GRAD_REL} of autograd of the plain "
        f"version at the same shapes (dh's rows with and without an in-range label, dW's "
        f"columns hit and not hit by one, each on its own scale), bit-identical run to run, "
        f"on every route a shape takes; routes {bwd_routes}; max rel err {bwd_err}; at "
        f"{XENT_SHAPES[0]} the check refuses {mutant_err}")

    # timings at the train shape in bf16
    import torch.nn.functional as F
    t, d, v = XENT_SHAPES[0]
    h, w, labels, gup = _xent_args(XENT_SHAPES[0], "bfloat16", seed=99)
    labels = labels.abs() % v                   # in range: F.cross_entropy takes no other
    loss, lse = fx.fused_xent(h, w, labels)
    # the yardstick rounds its logits to bf16 (as the reference's bf16 loss
    # does): held to 3e-2 of the largest loss
    lib_want = F.cross_entropy((h @ w).float(), labels.long(), reduction="none")
    check(float((lib_want - loss).abs().max()) <= 3e-2 * float(loss.abs().max()),
          "fused_xent: F.cross_entropy disagrees with the kernel")
    few = dict(reps=2, samples=3)
    hh, ww = h.clone().requires_grad_(), w.clone().requires_grad_()
    plain_loss = (fx.fused_xent_plain(hh, ww, labels) * gup).sum()
    lib_loss = (F.cross_entropy(hh @ ww, labels.long(), reduction="none") * gup).sum()
    elt = 2
    results = {}
    old_route = {"fused_xent": lambda: fx.fused_xent(h, w, labels, route=fx.F32_FMA),
                 "fused_xent_bwd": lambda: fx.fused_xent_bwd(h, w, labels, lse, gup,
                                                             route=fx.F32_FMA)}
    for name, call, plain, lib, n_bytes, n_ops in (
            ("fused_xent", lambda: fx.fused_xent(h, w, labels),
             lambda: fx.fused_xent_plain(h, w, labels),
             lambda: F.cross_entropy(h @ w, labels.long(), reduction="none"),
             elt * (t * d + d * v) + 4 * t * 3, 2 * t * d * v),
            ("fused_xent_bwd", lambda: fx.fused_xent_bwd(h, w, labels, lse, gup),
             lambda: torch.autograd.grad(plain_loss, (hh, ww), retain_graph=True),
             lambda: torch.autograd.grad(lib_loss, (hh, ww), retain_graph=True),
             2 * elt * (t * d + d * v) + 4 * t * 3, 3 * 2 * t * d * v)):
        bytes_us = n_bytes / HBM_BYTES_PER_S * 1e6
        ops_us = n_ops / BF16_OPS_PER_S * 1e6
        timing = dict(kernel_us=_time_us(call, **few),
                      kernel_dev_us=_graph_time_us(call, **few),
                      kernel_cold_us=_cold_time_us(call, reps=3),
                      plain_us=_time_us(plain, **few), plain_dev_us=None,
                      library_us=_time_us(lib, **few),
                      bound_us=max(bytes_us, ops_us),
                      bound_by="bytes" if bytes_us >= ops_us else "operations")
        # the f32-FMA route it replaced, in the same call; the tensor cores
        # must beat it (by over 5x predicted: a kernel that silently lost
        # its tensor cores fails here)
        old = old_route[name]
        timing["f32_fma_route"] = dict(kernel_us=_time_us(old, **few),
                                       kernel_dev_us=_graph_time_us(old, **few),
                                       kernel_cold_us=_cold_time_us(old, reps=3))
        log(f"phase1 {name} at {XENT_SHAPES[0]} bf16, the f32-FMA route (redesigned): "
            f"kernel_us={timing['f32_fma_route']['kernel_us']:.1f}; graph-replayed device "
            f"time: kernel_us={timing['f32_fma_route']['kernel_dev_us']:.1f}; L2 cold: "
            f"kernel_us={timing['f32_fma_route']['kernel_cold_us']:.1f}")
        check(timing["kernel_dev_us"] < timing["f32_fma_route"]["kernel_dev_us"],
              f"{name}: the tensor-core route ({timing['kernel_dev_us']:.1f} us) is not faster "
              f"than the f32-FMA route ({timing['f32_fma_route']['kernel_dev_us']:.1f} us)")
        log(f"phase1 {name} at (T, D, V) = {XENT_SHAPES[0]} bf16: kernel_us="
            f"{timing['kernel_us']:.1f} plain_us={timing['plain_us']:.1f} library_us="
            f"{timing['library_us']:.1f} (F.cross_entropy(h @ W): two calls{'' if name == 'fused_xent' else ', through autograd'}) "
            f"bound_us={timing['bound_us']:.1f} ({timing['bound_by']}; {n_ops / 1e12:.3f} "
            f"TFLOP, {n_bytes / 1e9:.3f} GB); graph-replayed device time: kernel_us="
            f"{timing['kernel_dev_us']:.1f}; one call with the L2 cold: kernel_us="
            f"{timing['kernel_cold_us']:.1f}; achieved "
            f"{n_ops / timing['kernel_dev_us'] / 1e6:.2f} TFLOP/s")
        errs = (dict(max_abs_err=main_err) if name == "fused_xent"
                else dict(max_abs_err=main_gabs, max_rel_err=main_gerr))
        results[name] = dict(shape=list(XENT_SHAPES[0]), dtype="bfloat16", **errs, **timing)
    del h, w, hh, ww, plain_loss, lib_loss
    torch.cuda.empty_cache()
    return results


def _phase_attention_bwd():
    """The B5 backward (dq, dk, dv) against autograd of the plain version at
    the train shape and the edges (GQA groups 1/2/4/8, MQA, windows, head
    dims 64/80/128/256, ragged S), f32 and bf16, bit-identical run to run;
    timed at the train shape in bf16 beside the plain backward and SDPA's."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa

    def grads_of(shape, dtype, seed):
        args, kw = _attention_args("flash_attention", shape, dtype, seed)
        g = torch.Generator(device=DEVICE).manual_seed(seed + 1000)
        dout = torch.randn(args[0].shape, generator=g, device=DEVICE).to(args[0].dtype)
        return args, kw["window"], dout

    errs, routes = {}, {}
    for dtype in ("float32", "bfloat16"):
        for i, shape in enumerate(ATTN_BWD_SHAPES):
            (q, k, v), window, dout = grads_of(shape, dtype, i)
            out, lse = fa.flash_attention(q, k, v, window=window)
            qq, kk, vv = (x.clone().requires_grad_() for x in (q, k, v))
            ref = torch.autograd.grad(fa.flash_attention_plain(qq, kk, vv, window=window),
                                      (qq, kk, vv), grad_outputs=dout)
            scale = max(float(r.abs().max()) for r in ref)
            # on its own route and, where that is the tensor cores', on the
            # f32-FMA route it replaced
            route = fa.attention_bwd_route(q, k, v, out, dout)
            routes.setdefault(route, []).append((dtype, shape))
            for how in [route] + ([fa.F32_FMA] if route == fa.TENSOR_CORES else []):
                d1 = fa.flash_attention_bwd(q, k, v, out, dout, lse, window=window, route=how)
                d2 = fa.flash_attention_bwd(q, k, v, out, dout, lse, window=window, route=how)
                torch.cuda.synchronize()
                what = f"flash_attention_bwd ({how}) {dtype} {shape}"
                check(all(torch.equal(a, b) for a, b in zip(d1, d2)), f"{what}: two runs differ")
                err = max(_rel_err(a, r, scale) for a, r in zip(d1, ref))
                check(all(a.dtype == q.dtype and a.shape == r.shape for a, r in zip(d1, ref))
                      and err <= GRAD_REL[dtype],
                      f"{what}: rel err {err:.3e} > {GRAD_REL[dtype]}")
                key = f"{how} {dtype}"
                errs[key] = max(errs.get(key, 0.0), err)
                if i == 0 and dtype == "bfloat16" and how == route:
                    main_err = err
                    main_abs = max(float((a.float() - r.float()).abs().max())
                                   for a, r in zip(d1, ref))
    log(f"phase1 flash_attention_bwd: dq, dk, dv within rel {GRAD_REL} of autograd of the "
        f"plain version at {list(ATTN_BWD_SHAPES)}, bit-identical run to run, on every route "
        f"a shape takes; routes {routes}; max rel err {errs}")

    shape = ATTN_BWD_SHAPES[0]
    (q, k, v), window, dout = grads_of(shape, "bfloat16", 99)
    out, lse = fa.flash_attention(q, k, v, window=window)
    qq, kk, vv = (x.clone().requires_grad_() for x in (q, k, v))
    plain_out = fa.flash_attention_plain(qq, kk, vv, window=window)
    qt, kt, vt = (x.transpose(1, 2) for x in (qq, kk, vv))
    lib_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
    lib_ref = torch.autograd.grad(lib_out, (qq, kk, vv), grad_outputs=dout.transpose(1, 2),
                                  retain_graph=True)
    mine = fa.flash_attention_bwd(q, k, v, out, dout, lse, window=window)
    scale = max(float(r.abs().max()) for r in lib_ref)
    check(max(_rel_err(a, r, scale) for a, r in zip(mine, lib_ref)) <= GRAD_REL["bfloat16"],
          "flash_attention_bwd: SDPA's backward disagrees with the kernel")
    call = lambda: fa.flash_attention_bwd(q, k, v, out, dout, lse, window=window)  # noqa: E731
    plain = lambda: torch.autograd.grad(plain_out, (qq, kk, vv), grad_outputs=dout,  # noqa: E731
                                        retain_graph=True)
    lib = lambda: torch.autograd.grad(lib_out, (qq, kk, vv),  # noqa: E731
                                      grad_outputs=dout.transpose(1, 2), retain_graph=True)
    b, s, h, hkv, d, _ = shape
    pairs = s * (s + 1) // 2
    n_ops = 10 * d * pairs * b * h
    # q, out, dout, dq (B, S, H, D); k, v, dk, dv (B, S, Hkv, D); lse
    n_bytes = 2 * (4 * b * s * h * d + 4 * b * s * hkv * d) + 4 * b * h * s
    bytes_us = n_bytes / HBM_BYTES_PER_S * 1e6
    ops_us = n_ops / BF16_OPS_PER_S * 1e6
    old = lambda: fa.flash_attention_bwd(q, k, v, out, dout, lse, window=window,  # noqa: E731
                                         route=fa.F32_FMA)
    timing = dict(kernel_us=_time_us(call, reps=20, samples=5),
                  kernel_dev_us=_graph_time_us(call, reps=20, samples=5),
                  kernel_cold_us=_cold_time_us(call, reps=10),
                  plain_us=_time_us(plain, reps=5, samples=3), plain_dev_us=None,
                  library_us=_time_us(lib, reps=20, samples=5),
                  bound_us=max(bytes_us, ops_us),
                  bound_by="bytes" if bytes_us >= ops_us else "operations",
                  f32_fma_route=dict(kernel_us=_time_us(old, reps=5, samples=3),
                                     kernel_dev_us=_graph_time_us(old, reps=5, samples=3),
                                     kernel_cold_us=_cold_time_us(old, reps=5)))
    # this design's own bound: S and dP recomputed in the dQ pass (14 D
    # flops a live pair and head)
    own_us = 14 * d * pairs * b * h / BF16_OPS_PER_S * 1e6
    old_t = timing["f32_fma_route"]
    log(f"phase1 flash_attention_bwd at {shape} bf16, the f32-FMA route (redesigned): "
        f"kernel_us={old_t['kernel_us']:.1f}; graph-replayed device time: kernel_us="
        f"{old_t['kernel_dev_us']:.1f}; L2 cold: kernel_us={old_t['kernel_cold_us']:.1f}")
    check(timing["kernel_dev_us"] < old_t["kernel_dev_us"],
          f"flash_attention_bwd: the tensor-core route ({timing['kernel_dev_us']:.1f} us) is "
          f"not faster than the f32-FMA route ({old_t['kernel_dev_us']:.1f} us)")
    log(f"phase1 flash_attention_bwd at {shape} bf16: the design's own bound (14 D flops a "
        f"pair) {own_us:.2f} us")
    log(f"phase1 flash_attention_bwd at {shape} bf16: kernel_us={timing['kernel_us']:.1f} "
        f"plain_us={timing['plain_us']:.1f} sdpa_backward_us={timing['library_us']:.1f} "
        f"bound_us={timing['bound_us']:.2f} ({timing['bound_by']}; {n_ops / 1e9:.2f} GFLOP, "
        f"{n_bytes / 1e6:.1f} MB); graph-replayed device time: kernel_us="
        f"{timing['kernel_dev_us']:.1f}; one call with the L2 cold: kernel_us="
        f"{timing['kernel_cold_us']:.1f}; achieved "
        f"{n_ops / timing['kernel_dev_us'] / 1e6:.2f} TFLOP/s")
    return {"flash_attention_bwd": dict(shape=list(shape), dtype="bfloat16",
                                        max_abs_err=main_abs, max_rel_err=main_err,
                                        **timing)}


def _slstm_args(shape, dtype: str, seed: int):
    """(pre (T, B, 4d), r (H, dh, 4dh), H) of one B7 call, drawn on the card
    in ``dtype``: pre ~ N(0, 1) (the pre-activations of a normed input), r
    ~ N(0, 1) / sqrt(dh) (the model's init)."""
    import math

    import torch
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    t, b, d, h = shape
    dh = d // h
    dt = getattr(torch, dtype)
    pre = torch.randn((t, b, 4 * d), generator=g, device=DEVICE).to(dt)
    r = (torch.randn((h, dh, 4 * dh), generator=g, device=DEVICE) / math.sqrt(dh)).to(dt)
    return pre, r, h


def _slstm_bound_us(shape, dtype: str):
    """(bound in us, what sets it): pre read once, out written once and r
    read once, over 3.35 TB/s; 2 * dh flops per (step, row, gate column),
    over the f32 FMA rate (h is an f32 state)."""
    t, b, d, h = shape
    dh = d // h
    elt = 4 if dtype == "float32" else 2
    n_bytes = elt * (t * b * 4 * d + t * b * d + h * dh * 4 * dh)
    n_ops = 2 * t * b * 4 * d * dh
    bytes_us = n_bytes / HBM_BYTES_PER_S * 1e6
    ops_us = n_ops / F32_OPS_PER_S * 1e6
    return max(bytes_us, ops_us), ("bytes" if bytes_us >= ops_us else "operations")


def _slstm_timing(shape, long: bool):
    """Times of one B7 call at ``shape`` in bf16: the kernel eager,
    graph-replayed (L2 warm) and L2-cold, the plain version eager, the
    bound, and the time a step (the scan's dependency chain)."""
    import torch
    from repro_torch.kernels import slstm_scan as ss
    pre, r, h = _slstm_args(shape, "bfloat16", seed=99)
    call = lambda: ss.slstm_scan(pre, r, h)             # noqa: E731
    plain = lambda: ss.slstm_scan_plain(pre, r, h)      # noqa: E731
    with torch.inference_mode():
        timing = dict(kernel_us=_time_us(call, reps=2 if long else 10, samples=5, warmup=2),
                      kernel_dev_us=_graph_time_us(call, reps=1 if long else 5, samples=5),
                      kernel_cold_us=_cold_time_us(call, reps=5),
                      plain_us=_time_us(plain, reps=1, samples=3, warmup=1),
                      plain_dev_us=None, library_us=None)
    timing["bound_us"], timing["bound_by"] = _slstm_bound_us(shape, "bfloat16")
    timing["step_us"] = timing["kernel_dev_us"] / shape[0]
    log(f"phase1 slstm_scan at {shape} bf16: kernel_us={timing['kernel_us']:.3f} "
        f"plain_us={timing['plain_us']:.3f} library none "
        f"bound_us={timing['bound_us']:.4f} ({timing['bound_by']}); graph-replayed "
        f"device time (L2 warm): kernel_us={timing['kernel_dev_us']:.3f} "
        f"({timing['step_us']:.3f} us a step over T = {shape[0]}); one call with the L2 "
        f"cold: kernel_us={timing['kernel_cold_us']:.3f}")
    return dict(shape=list(shape), dtype="bfloat16", **timing)


def _phase_slstm():
    """B7 against its plain version at the prefill shape and the edge shapes,
    in f32 and bf16, bit-identical run to run; timed at the prefill shape
    and at the long shape."""
    import torch
    from repro_torch.kernels import slstm_scan as ss

    max_err = {}
    for dtype in ("float32", "bfloat16"):
        for i, shape in enumerate(SLSTM_SHAPES):
            pre, r, h = _slstm_args(shape, dtype, seed=i)
            with torch.inference_mode():
                out1 = ss.slstm_scan(pre, r, h)
                out2 = ss.slstm_scan(pre, r, h)
                ref = ss.slstm_scan_plain(pre, r, h)
            torch.cuda.synchronize()
            check(torch.equal(out1, out2), f"slstm_scan {dtype} {shape}: two runs differ")
            check(out1.shape == ref.shape and out1.dtype == ref.dtype,
                  f"slstm_scan {dtype} {shape}: {out1.shape} {out1.dtype} vs plain "
                  f"{ref.shape} {ref.dtype}")
            check(bool(torch.isfinite(out1).all()), f"slstm_scan {dtype} {shape}: not finite")
            err = float((out1.float() - ref.float()).abs().max())
            check(err <= SLSTM_ATOL[dtype], f"slstm_scan {dtype} {shape}: max |kernel - "
                                            f"plain| {err:.3e} > {SLSTM_ATOL[dtype]}")
            max_err[dtype] = max(max_err.get(dtype, 0.0), err)
            if i == 0 and dtype == "bfloat16":
                main_err = err
    log(f"phase1 slstm_scan: within atol {SLSTM_ATOL} of plain at {list(SLSTM_SHAPES)} in "
        f"f32 and bf16, bit-identical run to run; max_abs_err {max_err}")
    main = _slstm_timing(SLSTM_SHAPES[0], long=False)
    return dict(max_abs_err=main_err, max_abs_err_by_dtype=max_err, **main,
                long_context=_slstm_timing(SLSTM_LONG, long=True))


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
    check(launches == want_launches(quant_dequant=want, quant_dequant_stats=want),
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
    check(launches == want_launches(quant_dequant=want, quant_dequant_stats=want,
                                    tamper_check_sums=pcfg.T),
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
    check(launches == want_launches(quant_dequant=want),
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


def _serve(model, prompts, new_tokens: int):
    """The serve path on ``model``: the prefill step's last-position logits,
    then the reference serve loop.  Returns (prefill logits, greedy tokens,
    the loop's logits at the prompt's last position, prefill s, loop s)."""
    import torch
    from repro_torch.launch.serve import greedy_decode
    from repro_torch.launch.steps import make_prefill_step, make_serve_step

    b, p = prompts.shape
    cache = model.init_cache(b, p + new_tokens)
    sync = torch.cuda.synchronize if prompts.is_cuda else (lambda: None)
    sync()
    t0 = time.perf_counter()
    prefill = make_prefill_step(model)({"tokens": prompts})
    sync()
    t1 = time.perf_counter()
    gen, last = greedy_decode(make_serve_step(model), cache, prompts, new_tokens)
    sync()
    return prefill, gen, last, t1 - t0, time.perf_counter() - t1


def phase_lm_cpu_vs_card():
    """Tiny LMs (reduce_config of Qwen3-8B and of xLSTM-1.3B, f32) served on
    the CPU and on the card from one init: equal greedy tokens, logits
    within atol 1e-4."""
    import copy

    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import build
    from repro_torch.launch.serve import make_prompts
    from repro_torch.models import build_model

    prompt_len, new = 16, 16
    steps = prompt_len + new
    for arch in ("qwen3-8b", "xlstm-1.3b"):
        cfg = get_smoke_config(arch)
        cpu = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
        want = (want_launches(flash_attention=cfg.n_layers,
                              decode_attention=cfg.n_layers * steps)
                if cfg.arch_type == "dense" else
                want_launches(slstm_scan=sum(s.kind == "slstm" for s in cpu.stacks)))
        card = copy.deepcopy(cpu).to(DEVICE)
        prompts = torch.from_numpy(make_prompts(0, cfg.vocab, 4, prompt_len))
        runs = {}
        for where, model in (("cpu", cpu), ("card", card)):
            torch.cuda.synchronize()
            build.reset_launches()
            pre, gen, last, _, _ = _serve(model, prompts.to(model.device), new)
            runs[where] = (pre.cpu(), gen.cpu(), last.cpu(), dict(build.LAUNCHES))
        (pre_c, gen_c, last_c, l_c), (pre_g, gen_g, last_g, l_g) = runs["cpu"], runs["card"]
        check(l_c == want_launches(), f"phase4 lm {arch}: the CPU run launched {l_c}")
        check(l_g == want, f"phase4 lm {arch}: card launches {l_g}, want {want}")
        check(torch.equal(gen_c, gen_g),
              f"phase4 lm {arch}: greedy tokens differ:\n{gen_c}\n{gen_g}")
        err = max(float((pre_c - pre_g).abs().max()), float((last_c - last_g).abs().max()))
        check(err <= 1e-4, f"phase4 lm {arch}: logits differ by {err:.3e} between CPU and card")
        log(f"phase4 lm {cfg.name} (f32, {cfg.n_layers} layers, d {cfg.d_model}): CPU and "
            f"card agree on {gen_g.numel()} greedy tokens; logits max |diff| {err:.3e}; card "
            f"launches {l_g}")


def phase_lm_round_cpu_vs_card():
    """A tiny LM (reduce_config of Qwen3-8B, f32) through one Pigeon-SL run
    (sequential engine, label flip on one client) on the CPU and on the card
    from one init: equal discrete outcomes, validation losses within rtol
    1e-3; the card run went through B4 and B5, forward and backward."""
    import numpy as np
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import LABEL_FLIP, Attack, ProtocolConfig, from_lm, run_pigeon
    from repro_torch.data import build_lm_task
    from repro_torch.kernels import build
    from repro_torch.models import build_model

    cfg = get_smoke_config("qwen3-8b")
    module = from_lm(build_model(cfg, "cpu"))       # the CPU template: one init for both
    data = build_lm_task(vocab=cfg.vocab, seq_len=32, m_clients=4, d_m=16, d_o=8, n_test=8)
    pcfg = ProtocolConfig(M=4, N=1, T=2, E=2, B=4, lr=5e-2, seed=0)
    runs, launches = {}, {}
    for dev in ("cpu", DEVICE):
        torch.cuda.synchronize()
        build.reset_launches()
        runs[dev] = run_pigeon(module, data, pcfg, malicious={1}, attack=Attack(LABEL_FLIP),
                               device=dev)
        torch.cuda.synchronize()
        launches[dev] = dict(build.LAUNCHES)
    check(launches["cpu"] == want_launches(), f"phase4 lm round: the CPU run launched "
                                              f"{launches['cpu']}")
    check(all(launches[DEVICE][k] > 0 for k in ("fused_xent", "fused_xent_bwd",
                                                 "flash_attention", "flash_attention_bwd")),
          f"phase4 lm round: card launches {launches[DEVICE]}")
    for ra, rb in zip(runs["cpu"].rounds, runs[DEVICE].rounds):
        for k in ("clusters", "selected", "accepted", "detections", "comm"):
            check(ra[k] == rb[k], f"phase4 lm round {ra['round']}: {k} cpu={ra[k]} "
                                  f"card={rb[k]}")
        check(np.allclose(ra["val_losses"], rb["val_losses"], rtol=1e-3, atol=0),
              f"phase4 lm round: val_losses cpu={ra['val_losses']} card={rb['val_losses']}")
    log(f"phase4 lm round {cfg.name} (f32, sequential, label flip): CPU and card agree over "
        f"{pcfg.T} rounds; val_losses {runs['cpu'].rounds[-1]['val_losses']} vs "
        f"{runs[DEVICE].rounds[-1]['val_losses']}; card launches {launches[DEVICE]}")


def _train_batch(b: int, s: int, seed: int = 0):
    """(B, S) tokens and next-token labels on the card from
    ``build_lm_task`` (vocab TRAIN_VOCAB: its Markov chain holds a dense
    (vocab, vocab) matrix)."""
    import torch
    from repro_torch.data import build_lm_task
    data = build_lm_task(vocab=TRAIN_VOCAB, seq_len=s, m_clients=1, d_m=b, d_o=0,
                         n_test=0, seed=seed)
    return {"tokens": torch.from_numpy(data.x[0]).to(DEVICE),
            "labels": torch.from_numpy(data.y[0]).to(DEVICE)}


class _PlainPath:
    """Within the block, the attention and the loss of CUDA tensors that
    need a gradient take the plain versions through autograd instead of
    the B4/B5 functions (what phase 7 holds the kernel path against)."""

    def __enter__(self):
        from repro_torch.kernels import flash_attention as fa
        from repro_torch.kernels import fused_xent as fx
        self.saved = (fa.FlashAttention.apply, fx.FusedXent.apply)
        fa.FlashAttention.apply = staticmethod(
            lambda q, k, v, window: fa.flash_attention_plain(q, k, v, window=window))
        fx.FusedXent.apply = staticmethod(fx.fused_xent_plain)
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import flash_attention as fa
        from repro_torch.kernels import fused_xent as fx
        fa.FlashAttention.apply, fx.FusedXent.apply = self.saved


def phase_train():
    """Qwen3-8B at full width and depth, the reference's train_4k settings
    (bf16, remat) with the sequence cut to 512: three make_train_step calls
    on one (4, 512) batch, the loss finite and falling, B5 and B4 launches
    per step, seconds and tokens per step, peak memory, one step's profile;
    then at 4 layers in f32 the kernel path's loss and every gradient
    against the plain path's on the card."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.launch.shapes import SHAPES, shape_settings
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_config("qwen3-8b"), **shape_settings(SHAPES["train_4k"]))
    b, s = TRAIN_BATCH, TRAIN_SEQ
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, DEVICE).init(torch.Generator(device=DEVICE).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in model.parameters())
    log(f"phase7 {cfg.name}: {cfg.n_layers} layers, {cfg.dtype}, remat={cfg.remat}, "
        f"{n_params:,} parameters drawn on the card in {time.perf_counter() - t0:.2f} s; "
        f"batch ({b}, {s}), lr {TRAIN_LR}")
    batch = _train_batch(b, s)
    step = make_train_step(model, TRAIN_LR)
    per_step = want_launches(flash_attention_tc=cfg.n_layers * (2 if cfg.remat else 1),
                             flash_attention_bwd_tc=cfg.n_layers, fused_xent_tc=1,
                             fused_xent_bwd_tc=1)
    losses, secs = [], []
    for i in range(3):
        torch.cuda.synchronize()
        build.reset_launches()
        t0 = time.perf_counter()
        losses.append(float(step(batch)))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        launches = dict(build.LAUNCHES)
        check(launches == per_step, f"phase7 step {i}: launches {launches}, want {per_step} "
                                    f"(remat recomputes each layer's forward; bf16 takes the "
                                    f"tensor-core routes, backwards too)")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(all(x == x and abs(x) < 1e4 for x in losses), f"phase7: losses {losses}")
    check(losses[1] < losses[0] and losses[2] < losses[1], f"phase7: loss not falling {losses}")
    warm = min(secs[1:])
    log(f"phase7 losses {losses}; seconds per step {[round(x, 4) for x in secs]} (the first "
        f"with set-up); warm {warm:.4f} s, {b * s / warm:.1f} tokens/s; peak device memory "
        f"{peak_gb:.2f} GB; launches a step {launches}")
    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    _profile_report(f"phase7 {cfg.name} train step (B {b}, S {s}, bf16, remat)",
                    lambda: step(batch), min(walls) * 1e6, 1,
                    shares={"B4 forward": ("xent_fwd_tc_kernel", "xent_combine_kernel"),
                            # B4's two bf16 products share cuBLAS's kernels
                            # with the layers'
                            "B4 backward: the logit gradient (xent_dlogits_tc)":
                                ("xent_bwd_tc_kernel",),
                            "B5 forward": ("flash_fwd_tc_kernel",),
                            "B5 backward": ("flash_bwd_dkdv_tc_kernel", "flash_bwd_dq_tc_kernel",
                                            "flash_bwd_delta_kernel"),
                            # none is left in a bf16 step: B4's f32 route
                            # made the only ones
                            "f32 products (SIMT SGEMM)": ("sgemm",)})
    train = dict(launches=launches, losses=losses, seconds=secs, warm_s=warm,
                 tokens_per_s=b * s / warm, peak_gb=peak_gb)
    del model, step
    torch.cuda.empty_cache()

    # the kernel path against the plain path at full width, 4 layers, f32
    cfg4 = dataclasses.replace(cfg, n_layers=4, dtype="float32")
    model = build_model(cfg4, DEVICE).init(torch.Generator(device=DEVICE).manual_seed(1))
    params = list(model.parameters())
    results = {}
    for name in ("kernel", "plain"):
        build.reset_launches()
        if name == "plain":
            with _PlainPath():
                loss, _ = model.loss(batch)
                grads = torch.autograd.grad(loss, params)
            check(build.LAUNCHES["fused_xent"] == build.LAUNCHES["flash_attention"] == 0,
                  f"phase7 f32: the plain path launched {build.LAUNCHES}")
        else:
            loss, _ = model.loss(batch)
            grads = torch.autograd.grad(loss, params)
            # f32 keeps exact f32 products: the f32-FMA routes, forward and
            # backward, no tensor cores
            check(build.LAUNCHES == want_launches(
                flash_attention=cfg4.n_layers * (2 if cfg4.remat else 1),
                flash_attention_bwd=cfg4.n_layers, fused_xent=1, fused_xent_bwd=1),
                  f"phase7 f32: the kernel path launched {build.LAUNCHES}")
            f32_launches = dict(build.LAUNCHES)
        results[name] = (loss.detach(), grads)
    (lk, gk), (lp, gp) = results["kernel"], results["plain"]
    loss_rel = abs(float(lk) - float(lp)) / abs(float(lp))
    worst = max((_rel_err(a, r), n)
                for (n, _), a, r in zip(model.named_parameters(), gk, gp))
    check(loss_rel <= TRAIN_F32_REL and worst[0] <= TRAIN_F32_REL,
          f"phase7 f32: loss rel {loss_rel:.3e}, worst gradient {worst}")
    log(f"phase7 {cfg4.name} f32, 4 layers, full width: loss {float(lk):.6f} (kernel) vs "
        f"{float(lp):.6f} (plain), rel {loss_rel:.3e}; every gradient within rel "
        f"{TRAIN_F32_REL}, the worst {worst[0]:.3e} ({worst[1]}); the kernel path's "
        f"launches {f32_launches} (the f32-FMA routes)")
    train.update(f32_loss_rel=loss_rel, f32_grad_rel=worst[0], f32_launches=f32_launches)
    del model, params, results, gk, gp
    torch.cuda.empty_cache()
    return train


def _round_launches(cfg, pcfg, hist, quant, n_test, stats=False):
    """The kernel launches a sequential run_pigeon over from_lm makes, from
    the round structure: each client step runs the client's and the AP's
    layers forward (twice with remat: the backward recomputes them) and
    backward, and B4 forward and backward; each validation, handoff check
    and evaluation runs layers forward (and B4 for a validation); the cut
    width is read once.  The int8 wire quantizes each step's two messages;
    under a policy that scores message statistics the uplink of each step
    of the round's R clusters goes through B3 (the Pigeon-SL+ sub-rounds'
    steps collect none).  bf16 forwards and backwards of B4 and B5 count on
    the tensor-core routes."""
    import math
    n = cfg.n_layers
    cut = min(cfg.cut_layer, n)
    fwd = 2 if cfg.remat else 1
    m_bar = pcfg.M // pcfg.R
    steps = vals = handoffs = evals = main = 0
    for r in hist.rounds:
        main += pcfg.R * m_bar * pcfg.E
        steps += pcfg.R * m_bar * pcfg.E + (pcfg.R - 1) * m_bar * pcfg.E * r["accepted"]
        vals += pcfg.R
        handoffs += r["detections"] + int(r["accepted"])
        evals += math.ceil(n_test / pcfg.eval_batch) if "test_acc" in r else 0
    tc = "_tc" if cfg.dtype == "bfloat16" else ""
    stats_launches = main if quant and stats else 0
    return want_launches(**{
        "fused_xent" + tc: steps + vals, "fused_xent_bwd" + tc: steps,
        "flash_attention" + tc: steps * fwd * n + vals * n + handoffs * cut + evals * n + cut,
        "flash_attention_bwd" + tc: steps * n,
        "quant_dequant": 2 * steps - stats_launches if quant else 0,
        "quant_dequant_stats": stats_launches})


def phase_round():
    """The Pigeon-SL round over from_lm at Qwen3-8B's full width, depth cut
    to 12 layers (9 client + 3 AP), the train_4k settings (bf16, remat):
    run_pigeon(argmin, label flip on client 0, Pigeon-SL+) without the wire
    and with int8 through B2, then with int8 under loss_plus_distance (B3 on
    its wide path).  Finite losses, the selection the policy's scores give
    (argmin(val_losses) under argmin), launches as the round's structure
    predicts, exchange bytes, seconds per round and peak memory."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import (LABEL_FLIP, Attack, ProtocolConfig, from_lm,
                                  message_bytes)
    from repro_torch.data import build_lm_task
    from repro_torch.launch.shapes import SHAPES, shape_settings
    from repro_torch.models import build_model
    from repro_torch.selection import selector

    cfg = dataclasses.replace(get_config("qwen3-8b"), n_layers=ROUND_LAYERS,
                              **shape_settings(SHAPES["train_4k"]))
    t0 = time.perf_counter()
    data = build_lm_task(vocab=TRAIN_VOCAB, seq_len=TRAIN_SEQ, m_clients=4, d_m=16, d_o=8,
                         n_test=8)
    log(f"phase8 data: build_lm_task(vocab={TRAIN_VOCAB}, seq_len={TRAIN_SEQ}, m_clients=4, "
        f"d_m=16, d_o=8, n_test=8) in {time.perf_counter() - t0:.1f} s")
    model = build_model(cfg, DEVICE)        # the template: from_lm draws the init on the card
    n_params = sum(x.numel() for x in model.parameters())
    log(f"phase8 {cfg.name}: {cfg.n_layers} layers (cut {cfg.cut_layer}), {cfg.dtype}, "
        f"remat={cfg.remat}: {n_params:,} parameters "
        f"({n_params * model.embedding.element_size() / 1e9:.2f} GB a copy)")
    pcfg = ProtocolConfig(M=4, N=1, T=2, E=2, B=4, lr=1e-3)
    out = {}
    for quant, selection in ((None, "argmin"), ("int8", "argmin"),
                             ("int8", "loss_plus_distance")):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        name = f"phase8 round quant={quant} selection={selection}"
        ranked = []                             # the host selector's (scores, elig, order)

        def recorded(policy, ctx, _rank=selector.score_and_rank):
            ranked.append(_rank(policy, ctx))
            return ranked[-1]

        selector.score_and_rank = recorded
        try:
            hist, launches, seconds = _run(name, from_lm(model), data, pcfg, malicious={0},
                                           attack=Attack(LABEL_FLIP), plus=True,
                                           selection=selection, quant=quant, device=DEVICE)
        finally:
            selector.score_and_rank = recorded.__defaults__[0]
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        stats = selection != "argmin"
        want = _round_launches(cfg, pcfg, hist, quant, data.x_test.shape[0], stats=stats)
        check(launches == want, f"{name}: launches {launches}, want {want}")
        d_c = TRAIN_SEQ * cfg.d_model
        m_bar = pcfg.M // pcfg.R
        check(len(ranked) == len(hist.rounds), f"{name}: {len(ranked)} selections scored")
        for r, (scores, elig, order) in zip(hist.rounds, ranked):
            # the cascade visits the eligible candidates in score order; each
            # detection passes one over
            visit = [int(c) for c in order if elig[c]]
            check(all(x == x for x in scores) and (not r["accepted"] or
                                                   r["selected"] == visit[r["detections"]]),
                  f"{name} round {r['round']}: selected {r['selected']}, the policy's scores "
                  f"{scores.tolist()} (eligible {elig.tolist()}), detections "
                  f"{r['detections']}")
            if not stats:
                check(r["selected"] == int(np.argmin(r["val_losses"])),
                      f"{name} round {r['round']}: selected {r['selected']} is not the argmin "
                      f"of {r['val_losses']}")
            log(f"{name} round {r['round']}: the policy's scores {scores.tolist()} -> "
                f"selected {r['selected']}")
            steps = pcfg.R * m_bar * pcfg.E + (pcfg.R - 1) * m_bar * pcfg.E * r["accepted"]
            wire = steps * message_bytes(quant, pcfg.B, d_c)
            check(r["comm"]["activation_bytes"] == wire == r["comm"]["gradient_bytes"],
                  f"{name} round {r['round']}: exchange bytes {r['comm']} != {wire}")
        log(f"{name}: {seconds / pcfg.T:.2f} s/round (init and first-call set-up "
            f"included); peak device memory {peak_gb:.2f} GB; d_c {d_c:,}")
        out[f"{quant}_{selection}"] = dict(launches=launches, s_per_round=seconds / pcfg.T,
                                           peak_gb=peak_gb)
    del model
    torch.cuda.empty_cache()
    return out


def _profile_report(name: str, fn, wall_us: float, steps: int, shares=None) -> None:
    """Run ``fn`` once under torch.profiler and log the device busy share
    against the unprofiled wall time, the launches, the top device kernels
    and the top host ops; ``shares`` {label: name fragments} adds the share
    of the busy time taken by the kernels whose names hold a fragment.
    Returns the device kernels' profiler events."""
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
    for label, frags in (shares or {}).items():
        part = sum(dev_us(ev) for ev in kernels if any(f in ev.key for f in frags))
        log(f"  share {label}: {part / 1e3:.3f} ms, "
            f"{part / busy_us if busy_us else float('nan'):.3f} of the busy time")
    host = [ev for ev in events if not str(ev.device_type).endswith("CUDA")]
    for ev in sorted(host, key=lambda ev: ev.self_cpu_time_total, reverse=True)[:8]:
        log(f"  host   {ev.self_cpu_time_total / 1e3:8.3f} ms x{ev.count:5d}  {ev.key[:90]}")
    return kernels


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


def phase_serve():
    """Qwen3-8B at full width and depth, bf16, weights drawn on the card:
    prefill and the serve loop, with B5/B6 launch counts, the prefill/decode
    agreement, timings, peak memory and one warm decode step's profile;
    then the agreement at f32 with 4 layers."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.launch.serve import make_prompts, serve_config
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import build_model
    from repro_torch.models.transformer import run_stack

    def agreement(pre, last):
        rel = float((pre - last).abs().max()) / float(pre.abs().max())
        argmax = float((pre.argmax(-1) == last.argmax(-1)).float().mean())
        return rel, argmax

    cfg = serve_config("qwen3-8b", full=True)
    b, p, new = SERVE_BATCH, SERVE_PROMPT, SERVE_NEW
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, DEVICE).init(torch.Generator(device=DEVICE).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in model.parameters())
    log(f"phase6 {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, heads "
        f"{cfg.n_heads}/{cfg.n_kv_heads} x {cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab}, {cfg.dtype}: {n_params:,} parameters "
        f"({n_params * model.embedding.element_size() / 1e9:.2f} GB), drawn on the card "
        f"in {time.perf_counter() - t0:.2f} s")
    prompts = torch.from_numpy(make_prompts(0, cfg.vocab, b, p)).to(DEVICE)
    make_prefill_step(model)({"tokens": prompts})          # warm-up, not counted
    torch.cuda.synchronize()
    build.reset_launches()
    pre, gen, last, prefill_s, loop_s = _serve(model, prompts, new)
    launches = dict(build.LAUNCHES)
    steps = p + new
    check(launches == want_launches(flash_attention_tc=cfg.n_layers,
                                    decode_attention_tc=cfg.n_layers * steps),
          f"phase6: launches {launches}, want {cfg.n_layers} flash_attention_tc and "
          f"{cfg.n_layers * steps} decode_attention_tc (every bf16 prefill and decode "
          f"attention on the tensor cores)")
    check(pre.shape == (b, 1, cfg.vocab) and last.shape == pre.shape,
          f"phase6: logits {tuple(pre.shape)} / {tuple(last.shape)}")
    check(bool(torch.isfinite(pre).all()) and bool(torch.isfinite(last).all()),
          "phase6: non-finite logits")
    check(gen.shape == (b, new) and int(gen.min()) >= 0 and int(gen.max()) < cfg.vocab,
          f"phase6: generated tokens {tuple(gen.shape)}")
    rel, argmax = agreement(pre, last)
    check(rel <= SERVE_BF16_REL, f"phase6: prefill vs decode logits differ by {rel:.3e} "
                                 f"of max |logit| > {SERVE_BF16_REL}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ms_step = loop_s / steps * 1e3
    log(f"phase6 launches {launches}")
    log(f"phase6 prefill (B {b} x {p} tokens, warm): {prefill_s:.4f} s; serve loop "
        f"{steps} steps in {loop_s:.3f} s: {ms_step:.3f} ms/step, "
        f"{b * steps / loop_s:.1f} tokens/s; peak device memory {peak_gb:.2f} GB")
    log(f"phase6 prefill vs decode logits at position {p - 1}: max |diff| / max |logit| = "
        f"{rel:.4e} (bound {SERVE_BF16_REL}, bf16); argmax agreement {argmax:.3f}; "
        f"max |logit| {float(pre.abs().max()):.4f}")
    log(f"phase6 greedy tokens[0]: {gen[0].tolist()}")
    # the warm prefill, profiled: its device time and B5's share of it
    prefill_step = make_prefill_step(model)
    _profile_report(f"phase6 {cfg.name} prefill (B {b} x {p}, bf16)",
                    lambda: prefill_step({"tokens": prompts}), prefill_s * 1e6, 1,
                    shares={"B5 forward": ("flash_fwd_tc_kernel",)})
    del prefill_step

    # one warm decode step, profiled, at the loop's last position
    serve_step = make_serve_step(model)
    cache = model.init_cache(b, steps)
    tok = gen[:, -1:].contiguous()

    def step():
        return serve_step(cache, tok, steps - 1)[0]

    step()
    torch.cuda.synchronize()
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    _profile_report(f"phase6 {cfg.name} decode step (B {b}, index {steps - 1}, bf16)", step,
                    sorted(walls)[2] * 1e6, 1)
    serve = dict(launches=launches, prefill_s=prefill_s, ms_per_step=ms_step,
                 tokens_per_s=b * steps / loop_s, peak_gb=peak_gb, rel=rel, argmax=argmax)
    del model, cache, serve_step
    torch.cuda.empty_cache()

    # the same agreement at full width in f32, 4 layers
    cfg4 = dataclasses.replace(get_config("qwen3-8b"), n_layers=4)
    model = build_model(cfg4, DEVICE).init(torch.Generator(device=DEVICE).manual_seed(1))
    pre, _, last, _, _ = _serve(model, prompts, 1)
    rel4, argmax4 = agreement(pre, last)
    check(rel4 <= SERVE_F32_REL, f"phase6 f32: prefill vs decode logits differ by "
                                 f"{rel4:.3e} of max |logit| > {SERVE_F32_REL}")
    log(f"phase6 {cfg4.name} f32, 4 layers, full width: prefill vs decode logits at "
        f"position {p - 1}: max |diff| / max |logit| = {rel4:.4e} (bound {SERVE_F32_REL}); "
        f"argmax agreement {argmax4:.3f}")
    del model
    torch.cuda.empty_cache()
    serve.update(rel_f32=rel4, argmax_f32=argmax4)
    return serve


def phase_xlstm():
    """xLSTM-1.3B at full width and depth, bf16, weights drawn on the card:
    the prefill (6 B7 launches) and the serve loop (none), timings, peak
    memory and one warm decode step's profile; the same weights widened to
    f32, served again: prefill and decode logits agree tightly in f32, and
    the bf16 paths within XLSTM_BF16_REL of each other and of f32, with
    the bf16 error read stack by stack; both prefills (the serve one and a
    longer one at prefill_32k's settings) profiled, with the B7 step
    kernels counted."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.launch.serve import greedy_decode, make_prompts, serve_config
    from repro_torch.launch.shapes import SHAPES, shape_settings
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import build_model
    from repro_torch.models.transformer import run_stack

    def agreement(pre, last):
        rel = float((pre - last).abs().max()) / float(pre.abs().max())
        argmax = float((pre.argmax(-1) == last.argmax(-1)).float().mean())
        return rel, argmax

    def stack_states(model, tokens):
        """The prefill path's embedding and each stack's output."""
        with torch.inference_mode():
            x, positions = model.embed({"tokens": tokens})
            states = [x]
            for stack in model.stacks:
                x = run_stack(stack, x, positions)[0]
                states.append(x)
        return states

    def timed(fn):
        """(fn(), seconds, the launches it made), the counts reset just
        before it."""
        torch.cuda.synchronize()
        build.reset_launches()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, dict(build.LAUNCHES)

    t_phase = time.perf_counter()
    cfg = serve_config("xlstm-1.3b", full=True)
    b, p, new = XLSTM_BATCH, XLSTM_PROMPT, XLSTM_NEW
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, DEVICE).init(torch.Generator(device=DEVICE).manual_seed(0))
    torch.cuda.synchronize()
    n_slstm = sum(1 for s in model.stacks if s.kind == "slstm")
    n_params = sum(x.numel() for x in model.parameters())
    check(n_params == XLSTM_PARAMS, f"phase9: {n_params:,} parameters, want {XLSTM_PARAMS:,}")
    log(f"phase9 {cfg.name}: {cfg.n_layers} blocks in {len(model.stacks)} stacks "
        f"{[(s.kind, s.n) for s in model.stacks[:2]]} x {len(model.stacks) // 2}, d "
        f"{cfg.d_model}, {cfg.n_heads} heads, vocab {cfg.vocab}, ssm_chunk {cfg.ssm_chunk}, "
        f"{cfg.dtype}: {n_params:,} parameters "
        f"({n_params * model.embedding.element_size() / 1e9:.2f} GB), drawn on the card "
        f"in {time.perf_counter() - t0:.2f} s")
    prompts = torch.from_numpy(make_prompts(0, cfg.vocab, b, p)).to(DEVICE)
    prefill_step, serve_step = make_prefill_step(model), make_serve_step(model)
    prefill_step({"tokens": prompts})                      # warm-up, not counted
    pre, prefill_s, prefill_launches = timed(lambda: prefill_step({"tokens": prompts}))
    check(prefill_launches == want_launches(slstm_scan=n_slstm),
          f"phase9: prefill launches {prefill_launches}, want {n_slstm} slstm_scan")
    cache = model.init_cache(b, p + new)
    (gen, last), loop_s, loop_launches = timed(
        lambda: greedy_decode(serve_step, cache, prompts, new))
    check(loop_launches == want_launches(), f"phase9: the serve loop launched {loop_launches}")
    steps = p + new
    check(pre.shape == (b, 1, cfg.vocab) and last.shape == pre.shape,
          f"phase9: logits {tuple(pre.shape)} / {tuple(last.shape)}")
    check(bool(torch.isfinite(pre).all()) and bool(torch.isfinite(last).all()),
          "phase9: non-finite logits")
    check(gen.shape == (b, new) and int(gen.min()) >= 0 and int(gen.max()) < cfg.vocab,
          f"phase9: generated tokens {tuple(gen.shape)}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    state_gb = sum(t.numel() * t.element_size() for c in cache for t in c.values()) / 1e9
    ms_step = loop_s / steps * 1e3
    prefill_kernels = _profile_report(
        f"phase9 prefill (B {b} x {p})", lambda: prefill_step({"tokens": prompts}),
        prefill_s * 1e6, 1, shares=PREFILL_SHARES)
    step_kernels = sum(ev.count for ev in prefill_kernels if "slstm_step" in ev.key)
    check(step_kernels == n_slstm * p, f"phase9 prefill: the profiler saw {step_kernels} B7 "
                                       f"step kernels, want {n_slstm * p}")
    log(f"phase9 prefill launches {prefill_launches}: {n_slstm} B7 scans of T = {p}, "
        f"{step_kernels} step kernels under the profiler; serve loop launches "
        f"{loop_launches}")
    log(f"phase9 prefill (B {b} x {p} tokens, warm): {prefill_s:.4f} s; serve loop "
        f"{steps} steps in {loop_s:.3f} s: {ms_step:.3f} ms/step, "
        f"{b * steps / loop_s:.1f} tokens/s; peak device memory {peak_gb:.2f} GB (decode "
        f"state {state_gb:.2f} GB)")
    log(f"phase9 greedy tokens[0]: {gen[0].tolist()}")

    # one warm decode step, profiled (the state's size does not depend on
    # the position)
    tok = gen[:, -1:].contiguous()

    def step():
        return serve_step(cache, tok, steps - 1)[0]

    step()
    torch.cuda.synchronize()
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    _profile_report(f"phase9 {cfg.name} decode step (B {b}, bf16)", step,
                    sorted(walls)[2] * 1e6, 1)
    states16 = stack_states(model, prompts)
    out = dict(prefill_launches=prefill_launches, loop_launches=loop_launches,
               step_kernels=step_kernels, prefill_s=prefill_s, ms_per_step=ms_step,
               tokens_per_s=b * steps / loop_s, peak_gb=peak_gb)
    del cache, prefill_step, serve_step
    torch.cuda.empty_cache()

    # the same weights widened to f32, at full depth: prefill and decode
    # held tightly, and each bf16 path against them
    model.float()
    build.reset_launches()
    pre32, _, last32, _, _ = _serve(model, prompts, 1)
    launches32 = dict(build.LAUNCHES)
    check(launches32 == want_launches(slstm_scan=n_slstm), f"phase9 f32: launches {launches32}")
    rel32, argmax32 = agreement(pre32, last32)
    check(rel32 <= XLSTM_F32_REL, f"phase9 f32: prefill vs decode logits differ by "
                                  f"{rel32:.3e} of max |logit| > {XLSTM_F32_REL}")
    rel, argmax = agreement(pre, last)
    pre_err, dec_err = agreement(pre, pre32)[0], agreement(last, last32)[0]
    for what, value in (("prefill vs decode", rel), ("prefill vs f32", pre_err),
                        ("decode vs f32", dec_err)):
        check(value <= XLSTM_BF16_REL, f"phase9 bf16: {what} logits differ by {value:.3e} of "
                                       f"max |logit| > {XLSTM_BF16_REL}")
    log(f"phase9 f32 (the bf16 weights widened), {cfg.n_layers} blocks: prefill vs decode "
        f"logits at position {p - 1}: max |diff| / max |logit| = {rel32:.4e} (bound "
        f"{XLSTM_F32_REL}); argmax agreement {argmax32:.3f}; launches {launches32}")
    log(f"phase9 bf16 logits at position {p - 1}, max |diff| / max |logit| (bound "
        f"{XLSTM_BF16_REL}): prefill vs decode {rel:.4e} (argmax agreement {argmax:.3f}), "
        f"prefill vs f32 {pre_err:.4e}, decode vs f32 {dec_err:.4e}; max |logit| "
        f"{float(pre.abs().max()):.4f}")
    # where the bf16 error grows: each stack's bf16 output on the prefill
    # path against the f32 run (free) and against the f32 stack fed the same
    # bf16 input (that stack's own error), over max |x| of the f32 run
    states32 = stack_states(model, prompts)
    positions = torch.arange(p, device=DEVICE)
    log("phase9 bf16 vs f32 on the prefill path, by stack: kind, max |x| (f32), the "
        "stack's own error (fed the bf16 input), the free run's error")
    for k, stack in enumerate(model.stacks):
        with torch.inference_mode():
            own = run_stack(stack, states16[k].float(), positions)[0]
        scale = float(states32[k + 1].abs().max())
        log(f"  stack {k:2d} {stack.kind} {scale:8.3f} "
            f"{float((own - states16[k + 1].float()).abs().max()) / scale:.3e} "
            f"{float((states32[k + 1] - states16[k + 1].float()).abs().max()) / scale:.3e}")
    del model, states16, states32, own
    torch.cuda.empty_cache()
    out.update(rel=rel, argmax=argmax, rel_prefill_f32=pre_err, rel_decode_f32=dec_err,
               rel_f32=rel32, argmax_f32=argmax32)

    # a longer prefill at prefill_32k's settings (ssm_chunk 2,048)
    cfg_long = dataclasses.replace(get_config("xlstm-1.3b"),
                                   **shape_settings(SHAPES["prefill_32k"]))
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg_long, DEVICE).init(torch.Generator(device=DEVICE).manual_seed(0))
    tokens = torch.from_numpy(make_prompts(1, cfg.vocab, b, XLSTM_LONG_PROMPT)).to(DEVICE)
    prefill_step = make_prefill_step(model)

    def long_prefill():
        return prefill_step({"tokens": tokens})

    long_prefill()                                         # warm-up, not counted
    logits, long_s, long_launches = timed(long_prefill)
    check(long_launches == want_launches(slstm_scan=n_slstm),
          f"phase9 long prefill: launches {long_launches}")
    check(bool(torch.isfinite(logits).all()), "phase9 long prefill: non-finite logits")
    long_peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"phase9 long prefill ({cfg_long.dtype}, ssm_chunk {cfg_long.ssm_chunk}, B {b} x "
        f"{XLSTM_LONG_PROMPT} tokens, warm): {long_s:.4f} s, "
        f"{b * XLSTM_LONG_PROMPT / long_s:.0f} tokens/s; peak device memory "
        f"{long_peak:.2f} GB")
    kernels = _profile_report(
        f"phase9 long prefill (B {b} x {XLSTM_LONG_PROMPT})", long_prefill, long_s * 1e6, 1,
        shares=PREFILL_SHARES)
    step_kernels = sum(ev.count for ev in kernels if "slstm_step" in ev.key)
    check(step_kernels == n_slstm * XLSTM_LONG_PROMPT,
          f"phase9 long prefill: the profiler saw {step_kernels} B7 step kernels, want "
          f"{n_slstm * XLSTM_LONG_PROMPT}")
    del model, prefill_step, logits
    torch.cuda.empty_cache()
    out.update(long_prefill_s=long_s, long_peak_gb=long_peak, long_step_kernels=step_kernels,
               seconds=time.perf_counter() - t_phase)
    log(f"phase9 took {out['seconds']:.1f} s")
    return out


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
        regs = [int(n) for n in re.findall(r"Used (\d+) registers", text)]
        spills = sum(int(n) for n in re.findall(r"(\d+) bytes spill stores", text))
        log(f"  ptxas {name}: {len(regs)} kernels, {min(regs)}-{max(regs)} registers a "
            f"thread, {spills} bytes of spill stores")
        for line in text.splitlines():
            if "C7517" in line or "C7508" in line:
                log(f"  ptxas {name}: {line.strip()[:160]}")
    sass = phase_sass()

    kernels = phase_kernels()
    torch.cuda.reset_peak_memory_stats()    # phase 5's peak: the protocol phases only
    main_path = _cifar_main_path()
    seq_hist, seq_launches, s_per_round = phase_cifar(main_path)
    launches, b_per_round = phase_cifar_batched(main_path, seq_hist, s_per_round)
    phase_mnist()
    phase_cpu_vs_card()
    phase_lm_cpu_vs_card()
    phase_lm_round_cpu_vs_card()
    phase_profile()
    phase_profile_batched(main_path)
    del main_path
    serve = phase_serve()
    train = phase_train()
    rounds = phase_round()
    xlstm = phase_xlstm()

    sources = {"quant_dequant": ("src/repro/kernels/quant_exchange.py:85",
                                 "src/repro_torch/kernels/csrc/quant_exchange.cu"),
               "quant_dequant_stats": ("src/repro/kernels/quant_exchange.py:144",
                                       "src/repro_torch/kernels/csrc/quant_exchange.cu"),
               "tamper_check_sums": ("src/repro/kernels/tamper_check.py:42",
                                     "src/repro_torch/kernels/csrc/tamper_check.cu"),
               "fused_xent": ("src/repro/kernels/fused_xent.py:62",
                              "src/repro_torch/kernels/csrc/fused_xent_tc.cu"),
               # no TPU kernel: the reference's training path leaves both
               # backwards to XLA's autodiff, of its plain cross-entropy
               # (chunked: models/model.py:258) and of attend
               "fused_xent_bwd": ("none; XLA autodiff of src/repro/models/model.py:258",
                                  "src/repro_torch/kernels/csrc/fused_xent_bwd_tc.cu"),
               "flash_attention": ("src/repro/kernels/flash_attention.py:82",
                                   "src/repro_torch/kernels/csrc/flash_attention_tc.cu"),
               "flash_attention_bwd": ("none; XLA autodiff of src/repro/models/attention.py:82",
                                       "src/repro_torch/kernels/csrc/flash_attention_bwd_tc.cu"),
               "decode_attention": ("src/repro/kernels/decode_attention.py:66",
                                    "src/repro_torch/kernels/csrc/decode_attention_tc.cu"),
               "slstm_scan": ("src/repro/kernels/slstm_scan.py:67",
                              "src/repro_torch/kernels/csrc/slstm_scan.cu")}
    # launches: each kernel's own path, driven with the counts reset just
    # before it: the batched round for B1-B3 (the only path that reaches all
    # three), the Qwen3-8B serve run for B5/B6, the last Qwen3-8B train step
    # for B4 and B5's backward, the xLSTM-1.3B prefill for B7; every path's
    # counts ride beside them.  Device times: graph replays back to back,
    # which find inputs of up to the 50 MB L2 still there (l2_warm), and one
    # call after an L2 flush (l2_cold), the figure to hold against bound_ms.
    by_path = {"sequential": seq_launches, "batched": launches, "serve": serve["launches"],
               "train": train["launches"],
               **{f"round_{q}": r["launches"] for q, r in rounds.items()},
               "xlstm_prefill": xlstm["prefill_launches"],
               "xlstm_decode": xlstm["loop_launches"]}
    # B5's and B4's forwards and backwards and B6: the entry is the
    # tensor-core route, which the bf16 paths take; the f32-FMA route it
    # replaced (its library and counter) rides beside it
    route_key = {"flash_attention": "flash_attention_tc", "fused_xent": "fused_xent_tc",
                 "flash_attention_bwd": "flash_attention_bwd_tc",
                 "fused_xent_bwd": "fused_xent_bwd_tc",
                 "decode_attention": "decode_attention_tc"}
    fma_library = {"flash_attention": "flash_attention", "fused_xent": "fused_xent",
                   "flash_attention_bwd": "flash_attention_bwd", "fused_xent_bwd": "fused_xent",
                   "decode_attention": "decode_attention"}
    own = {name: ("serve" if name in ("flash_attention", "decode_attention") else
                  "train" if name in ("fused_xent", "fused_xent_bwd", "flash_attention_bwd")
                  else "xlstm_prefill" if name == "slstm_scan" else "batched")
           for name in kernels}

    def ms(us):
        return None if us is None else us / 1e3

    entries = []
    for name, k in kernels.items():
        key = route_key.get(name, name)
        entry = dict(name=name, route="cuda", source=sources[name][1],
                     replaces=sources[name][0], launches=by_path[own[name]][key],
                     launches_by_path={path: counts[key] for path, counts in by_path.items()},
                     shape=k["shape"], max_abs_err=k["max_abs_err"],
                     **({"max_rel_err": k["max_rel_err"]} if "max_rel_err" in k else {}),
                     ms=ms(k["kernel_us"]), device_ms_l2_warm=ms(k["kernel_dev_us"]),
                     device_ms_l2_cold=ms(k["kernel_cold_us"]), plain_ms=ms(k["plain_us"]),
                     bound_ms=ms(k["bound_us"]), bound_by=k["bound_by"],
                     library_ms=ms(k.get("library_us")),
                     library_device_ms=ms(k.get("library_dev_us")))
        if "step_us" in k:
            # B7 launches T step kernels a call (the scan's dependency chain),
            # counted by the profiler over one prefill of the path
            entry.update(step_kernels=xlstm["step_kernels"], device_ms_a_step=ms(k["step_us"]))
        if name in route_key:
            entry["kernel_route"] = "tensor_cores"
            entry["sass"] = sass[key]
            old = k["f32_fma_route"]
            entry["f32_fma_route"] = dict(
                source=f"src/repro_torch/kernels/csrc/{fma_library[name]}.cu",
                sass=sass[fma_library[name]],
                launches_by_path={path: counts[name] for path, counts in by_path.items()},
                ms=ms(old["kernel_us"]), device_ms_l2_warm=ms(old["kernel_dev_us"]),
                device_ms_l2_cold=ms(old["kernel_cold_us"]))
        if "lm_message" in k:
            # the LM round's cut message (B3's wide path)
            lm = k["lm_message"]
            entry["lm_message"] = dict(
                shape=lm["shape"], ms=ms(lm["kernel_us"]),
                device_ms_l2_warm=ms(lm["kernel_dev_us"]),
                device_ms_l2_cold=ms(lm["kernel_cold_us"]), plain_ms=ms(lm["plain_us"]),
                plain_device_ms=ms(lm["plain_dev_us"]), bound_ms=ms(lm["bound_us"]),
                bound_by=lm["bound_by"])
        if "long_context" in k:
            lc = k["long_context"]
            entry["long_context"] = dict(
                shape=lc["shape"], ms=ms(lc["kernel_us"]),
                device_ms_l2_warm=ms(lc["kernel_dev_us"]),
                device_ms_l2_cold=ms(lc["kernel_cold_us"]), plain_ms=ms(lc["plain_us"]),
                bound_ms=ms(lc["bound_us"]), bound_by=lc["bound_by"],
                library_ms=ms(lc["library_us"]), library_device_ms=ms(lc.get("library_dev_us")))
            if "f32_fma_route" in lc:
                entry["long_context"]["f32_fma_route"] = dict(
                    ms=ms(lc["f32_fma_route"]["kernel_us"]),
                    device_ms_l2_warm=ms(lc["f32_fma_route"]["kernel_dev_us"]),
                    device_ms_l2_cold=ms(lc["f32_fma_route"]["kernel_cold_us"]))
        entries.append(entry)
    log(f"phase2 seconds_per_round={s_per_round:.3f}; phase2b (batched) "
        f"seconds_per_round={b_per_round:.3f}; phase6 serve {serve}; phase7 train {train}; "
        f"phase8 rounds {rounds}; phase9 xlstm {xlstm}")
    log(json.dumps({"kernels": entries}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
