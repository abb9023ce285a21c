#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

from the repository root.  Phases, in order; any failure exits non-zero:

  0. set-up: require CUDA (no CPU fallback), print the card's name and power
     limit, the torch/CUDA/TF32 settings, and build every kernel (timed; one
     ``nvcc`` per source, all started together);
  1. every kernel against its plain PyTorch version on the card, at the
     shapes the main paths give it and a few edge shapes: the wire kernels'
     deq/scales bit-equal (also where D % 4 != 0, narrow and wide), stats
     within rtol 1e-5, two runs bit-identical
     (B2 also over the batched path's R*B rows, the stats kernel (one
     thread-block cluster a message up to 8,192 wide) also with R messages
     in one launch, at the sequential (1, 64, 256) and batched (5, 64, 256)
     layouts and at n 1 and 3, D 1,000 and 8,192; both at an LM's cut
     message (4, 2,097,152), which both run on their wide paths (B2 in one
     cooperative launch), and B3 also on (2, 4, 12,288), timed
     beside their bytes bound; B2 also at SplitFed's (1,280, 256) rows and
     B3 at its (20, 64, 256) messages); the tamper check (B1, one launch a
     call) at every shape on distinct inputs and on the aliased call the
     fused round makes (ref is recv): sums within rtol 1e-5 of the plain
     version and of a float64 sum, bit-identical from run to run, distances
     bit-equal to the plain formula on the kernel's sums, verdicts, exactly
     0 on identical finite inputs, NaN where an input holds an inf or a NaN,
     and above the tolerance only for a tampered candidate; timed distinct
     and aliased beside a calibration read of the same bytes
     (``torch.sum``), L2-cold after a 128 MB buffer is read; B1's bf16 route
     (an LM's activations read as they lie, summed in f32) the same way at
     the batched LM round's (2, 4,096, 4,096) and an edge whose element
     count is not a multiple of 8, timed there; B2, B3, and B5's forward
     and backward also at the batched LM round's shapes ((8, 2,097,152),
     (2, 4, 2,097,152), (8, 512, 32, 128)), timed beside their bounds; the
     attention kernels (B5 flash attention, B6 decode attention) within atol 2e-5
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
     SDPA); B7 (the sLSTM time scan) on the route ``slstm_route`` picks
     (held against ``SLSTM_ROUTES``: the persistent kernel wherever R fits
     the co-resident grid, else the step kernel) and on the step route,
     within atol 1e-4 (f32) and 8e-3 (bf16) of its plain version at the
     xLSTM prefill shape (T 512, B 4, d 2,048, H 4) and edges (H 1 and 2,
     dh 40 and 30, a ragged unit block, B 1/3/5/9, T 1), bit-identical run
     to run, both routes timed (no PyTorch call computes the scan; eager,
     replayed in turn, L2-cold) also at T 4,096; B7's backward (the reverse-time scan) on the
     route ``slstm_bwd_route`` picks (held against ``SLSTM_BWD_ROUTES``:
     ``csrc/slstm_scan_bwd_persistent.cu``, one cooperative launch, wherever
     R's rows and dz's slice fit the co-resident grid) and on the step route
     (``csrc/slstm_scan_bwd.cu``), from the saves of both forward routes,
     against autograd of the plain version at every B7 shape, f32 and bf16
     (dpre and dR within rel 1e-4 and 3e-2 of each tensor's largest value;
     the two routes' dz as close to each other), the saving forward's h
     bit-equal to the plain launch's, bit-identical run to run, the
     autograd path once (one forward and one persistent backward launch),
     both routes timed at the prefill shape and at T 4,096 (eager,
     replayed in turn, L2-cold), beside the plain autograd's backward, the
     dR product and the saving forward; SDPA's forward and
     backward timed at B5's batched-LM shapes; the wgmma routes' libraries hold HGMMA and UTMALDG
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
     the sequential run's, selections and losses beside it; one more round
     step with its verify stage profiled alone: one device operation, B1's
     kernel;
  2c. the paper's baselines: tiny vanilla SL and SplitFed (both engines)
     on the CPU and on the card from one init (equal comm and selections,
     losses within rtol 1e-3), then the Table II CIFAR configuration (T = 2)
     through ``run_vanilla_sl`` and ``run_splitfed`` sequential and batched
     (argmin) and batched under ``loss_plus_distance``: the B2 and B3
     launches each path's structure gives (SplitFed's batched round sends
     all 20 clients' messages in one call), exchange bytes, SplitFed's comm
     equal across its runs and its selections on both engines, seconds a
     round;
  2d. multi-round execution on the batched main path (2b's configuration,
     T = 5, eval_every 5): block 1 and 4, each with prefetch 0 and 1, and a
     repeat, under the main path's cuDNN (the same decisions; the losses'
     spread and test_acc printed), then the four under deterministic cuDNN
     (decisions and test_acc equal, losses within rtol 1e-6); 800 B2, 800
     B3 and 5 B1 launches in each, ``RoundRunner.accept_block`` under
     sync-debug "error", one ``block.fetch`` span a block; seconds a round,
     span totals, peak memory; resume (T = 2 in blocks of 2, resumed to 4,
     equal to the uninterrupted run); ``launch.train --trace --profile-dir``
     on the card (its provenance names the card and its power limit);
  2e. the multi-seed sweep and the job pool on the batched main path (2b's
     configuration): ``run_pigeon_sweep`` over seeds 0-2 (T = 3, block 1
     and 2) and ``run_job_pool`` over 4 jobs (T = 2, 2, 3, 3; two threat
     models) on 2 lanes with block 2 and prefetch 1, each replica and job
     held against its solo batched run (decisions exactly, losses within
     rtol 1e-4, test_acc within 5/7,000), a job's pool checkpoint resumed
     under ``run_pigeon``; ``sweep_block`` and ``pool_accept_block`` under
     sync-debug "error"; 160 B2 and B3 a round, one B1 a pool round, one
     fetch span a block; seconds a round and peak memory beside the solo
     runs'; then again under deterministic cuDNN (the bit-equal float fields
     reported); phase 1 holds B1 at (10, 3000, 256) aliased, B2 at (960,
     256) and (640, 256) and B3 at (15, 64, 256) and (10, 64, 256);
  3. the MNIST split CNN at Table II sizes, fp8-e4m3 wire, argmin, gradient
     attack;
  4. the same tiny runs on the CPU and on the card, from the same init, on
     both engines: equal discrete outcomes, validation losses within rtol
     1e-3; tiny LMs (``reduce_config`` of Qwen3-8B, and of xLSTM-1.3B, one
     B7 launch) served on both from one init: equal greedy tokens, logits
     within atol 1e-4; and the Qwen3-8B one through a Pigeon-SL run over ``from_lm`` (sequential, label
     flip) on both from one init, the xLSTM one on both engines: equal
     discrete outcomes, validation losses within rtol 1e-3;
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
  8b. the batched engine over from_lm at phase 8's configuration (12
     layers): ``run_pigeon(engine="batched")`` over the cluster-stacked LM
     with no wire, int8, and int8 under ``loss_plus_distance``, each from
     phase 8's init: decisions equal to phase 8's sequential runs (the
     largest float gap reported), the launches the round's structure
     predicts (B5 over both slots in one launch a layer, B4 a slot, one B1
     a round on the bf16 route), seconds a round and peak memory; the
     launch layer's ``make_pigeon_round_step`` on a 2-slot stacked model at
     12 layers (block 1, block 2, Pigeon-SL+, int8: sel the argmin, every
     slot bit-equal to the winner, launches as predicted, seconds a round);
     batched SplitFed over the LM at 4 layers (cut 3: its 4 lanes at 12
     layers would not fit), decisions equal to the sequential run;
  9. the xLSTM serve path: xLSTM-1.3B at full width and depth (48 blocks,
     (mLSTM 7, sLSTM 1) x 6, bf16, 3,529,644,368 parameters drawn on the
     card) prefills 4 prompts of 512 tokens through ``make_prefill_step``
     (6 B7 launches on the persistent route: 6 persistent kernels and no
     step kernel in the profile), then runs the reference serve
     loop through ``make_serve_step`` (544 steps, no kernel of the port);
     the same weights widened to f32 and served again: prefill and decode
     logits agree within 1e-3 in f32, and the bf16 ones within 0.6 of each
     other and of the f32 logits (bf16 rounding compounds over 48 blocks
     at random init); prefill seconds, ms per decode step, tokens/s, peak
     memory, one warm decode step's profile; a longer prefill at
     prefill_32k's settings (B 4 x 2,048 tokens), profiled, with B7's
     persistent and step kernels counted and its share beside the mLSTM
     products';
 10. the xLSTM train step: xLSTM-1.3B at full width and depth (train_4k's
     settings: bf16, remat, ssm_chunk 512; the sequence cut to 512), three
     ``make_train_step`` calls on one (4, 512) batch: the loss finite and
     falling, per step 12 B7 forwards (remat recomputes each sLSTM block),
     6 B7 backwards, one B4 forward and backward; seconds and tokens a
     step, peak memory, one step's profile; at one (mLSTM 7, sLSTM 1) unit
     in f32 the kernel path's loss and every gradient within rel 1e-4 of
     the plain path's (B4 and B7 through autograd of their plain versions);
 11. the Pigeon-SL round over ``from_lm`` at xLSTM-1.3B's full width and
     depth (cut 12: one sLSTM block on the client's side, five on the
     AP's), phase 8's protocol, no wire and int8 under
     ``loss_plus_distance``, each on the sequential and the batched engine
     (the cluster-stacked xLSTM, B7 once a slot) from one init: decisions
     equal, the largest float gap reported, B7's launches as the round's
     cluster counts predict, seconds a round and peak memory.

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
# the batched LM round's (phase 8b) wire and attention: R * B = 8 cut
# messages of 2,097,152 (B2's rows; B3's R = 2 messages of B = 4 rows) and
# R * B = 8 sequences folded into B5's batch (Qwen3-8B's heads, S 512)
LM_BATCHED_ROWS = (8, 2_097_152)
LM_BATCHED_MESSAGES = (2, 4, 2_097_152)
LM_BATCHED_ATTN = (8, 512, 32, 8, 128, 0)
# SplitFed's batched round sends every client's message at once: M = 20
# messages of (B, d_c), one a client (B3), or their M * B rows (B2)
SPLITFED_MESSAGES = (20, 64, 256)
# the wire kernels' checks: the batched path's R*B rows (one B2 launch a
# step), the sequential path's one message, SplitFed's batched M*B rows,
# then edge shapes (D % 4 != 0: no 16-byte loads, narrow and wide) and the
# LM's
KERNEL_SHAPES = ((BATCHED_MESSAGES[0] * BATCHED_MESSAGES[1], BATCHED_MESSAGES[2]),
                 TIMED_SHAPE, (SPLITFED_MESSAGES[0] * SPLITFED_MESSAGES[1],
                               SPLITFED_MESSAGES[2]), (64, 32), (37, 200), (1, 256), (1, 1000), (3, 1000),
                 (5, 1001), (1, 8192), (3, 8192), (1024, 4096), (3, 20001), LM_MESSAGE)
# R messages in one stats call: the batched round's, the sequential path's
# one message in the batched layout, SplitFed's batched round's, and wide
# ones (B3's wide path)
STATS_BATCHED = (BATCHED_MESSAGES, (1,) + TIMED_SHAPE, SPLITFED_MESSAGES, WIDE_BATCHED)
# the tamper check's (R, D_o, d_c): CIFAR, MNIST, ragged, tiny, large
TAMPER_SHAPES = ((5, 3000, 256), (4, 3000, 32), (3, 37, 200), (1, 1, 256),
                 (2, 4096, 4096))
# phase 2e's replica form: S * R = 15 slots (the sweep's three seeds), J * R
# = 10 (the pool's two lanes): B1 over the pool's candidates, B2 over the
# S*R*B and J*R*B rows, B3 over the S*R and J*R messages
REPLICA_TAMPER = (10, 3000, 256)
# B1's bf16 route: the batched LM round's validation activations (phase 8b:
# R 2 x D_o 8 x S 512 x d_model 4,096, 67.1 MB, over the 50 MB L2), then an
# edge whose element count is not a multiple of 8 (a bf16 16-byte load)
TAMPER_BF16_SHAPES = ((2, 4096, 4096), (3, 37, 201))
REPLICA_ROWS = ((15 * 64, 256), (10 * 64, 256))
REPLICA_MESSAGES = ((15, 64, 256), (10, 64, 256))
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
# phases 8 and 8b: (quant, selection) of the three runs, and the task
ROUND_RUNS = ((None, "argmin"), ("int8", "argmin"), ("int8", "loss_plus_distance"))
ROUND_TASK = dict(vocab=TRAIN_VOCAB, seq_len=TRAIN_SEQ, m_clients=4, d_m=16, d_o=8, n_test=8)
ROUND_DECISIONS = ("clusters", "selected", "accepted", "detections", "selected_honest",
                   "honest_cluster_exists", "comm")
# phase 8b's batched SplitFed trains R * M_bar = 4 lanes of the LM at once:
# at 12 layers theta, 4 lanes, their gradients and 2 FedAvg slots are 78 GB
# before activations; at 6 layers it peaked at 72.45 GB on an H100 80GB HBM3
# (700 W), so it runs at 4 layers (3 client + 1 AP), 2,016,449,536 parameters
SPLITFED_LAYERS, SPLITFED_CUT = 4, 3
# B7 (the sLSTM scan): (T, B, d, H), the prefill shape first (xLSTM-1.3B: a
# 512-token prompt at B 4, d 2,048, 4 heads of 512), then H 1 and 2, dh 40
# with 3 rows, B 5 (8 rows on the persistent route, two row blocks on the
# step route), B 1, T 1, a ragged last unit block (612 units in blocks of 8),
# B 9 and dh 30; the long shape (a 4,096-token sequence) is timed only
SLSTM_SHAPES = ((512, 4, 2048, 4), (64, 4, 2048, 1), (64, 4, 2048, 2), (33, 3, 80, 2),
                (20, 5, 96, 2), (40, 1, 2048, 4), (1, 4, 2048, 4), (24, 2, 612, 3),
                (17, 9, 256, 4), (13, 2, 90, 3))
SLSTM_LONG = (4096, 4, 2048, 4)
# the route slstm_route picks for each shape in (f32, bf16) on an H100 SXM
# (132 SMs, 227 KB a block): the persistent kernel wherever R's slice and h
# fit a block of the co-resident grid; the step kernel for R of 256 KB or
# more a block (dh 2,048; dh 1,024 in f32), B 9 and dh 30 (% 4 != 0)
SLSTM_ROUTES = dict(zip(SLSTM_SHAPES, (
    ("persistent", "persistent"), ("step", "step"), ("step", "persistent"),
    ("persistent", "persistent"), ("persistent", "persistent"), ("persistent", "persistent"),
    ("persistent", "persistent"), ("persistent", "persistent"), ("step", "step"),
    ("step", "step"))))
# the route slstm_bwd_route picks for each shape in (f32, bf16) on an H100
# SXM: the persistent backward wherever R's rows and dz's slice of the heads
# spanned fit a block of the co-resident grid (at the forward's shapes, the
# same table: R's rows are the bytes of the forward's slice; (24, 2, 612, 3)
# has blocks of 8 units straddling two heads of 204); the step route
# elsewhere
SLSTM_BWD_ROUTES = dict(SLSTM_ROUTES)
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
PREFILL_SHARES = {"B7 (slstm_scan_persistent)": ["slstm_scan_persistent"],
                  "f32 products (the mLSTM einsums)": ["sgemm", "f32f32", "f32_f32"],
                  "bf16 products (projections, head)": ["bf16", "nvjet"]}
# phase 11: the Pigeon-SL round over xLSTM-1.3B at full depth (theta 7.06 GB
# in bf16, as phase 8's 12-layer Qwen3-8B), no wire and int8 under
# loss_plus_distance, each on both engines
XLSTM_ROUND_LAYERS = 48
XLSTM_ROUND_RUNS = ((None, "argmin"), ("int8", "loss_plus_distance"))
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
    128 MB buffer (over the 50 MB L2), written once, is read before each
    call, outside the timed events, so the L2 holds only clean lines and
    the call pays no write-back.  A spin kernel ahead of them keeps the card
    busy while the host enqueues the events and the call, so the events
    time the call's device work and not the host's wrapper latency."""
    import torch
    buf = torch.ones(32 * 2 ** 20, dtype=torch.float32, device=DEVICE)
    sink = torch.empty((), dtype=torch.float32, device=DEVICE)
    fn(*args)
    times = []
    for _ in range(reps):
        torch.cuda._sleep(2_000_000)            # ~1 ms of spinning
        torch.sum(buf, dim=0, out=sink)
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
    results["tamper_check_sums"]["bf16"] = _phase_tamper_bf16()
    for name, shapes in _phase_replica_kernels().items():
        results[name]["replica_shapes"] = shapes
    results.update(_phase_xent())
    results.update(_phase_attention())
    results.update(_phase_attention_bwd())
    for name, t in _phase_lm_batched_shapes().items():
        results[name]["lm_batched"] = t
    results["slstm_scan"] = _phase_slstm()
    results["slstm_scan_bwd"] = _phase_slstm_bwd()
    return results


def _wire_bound(rows: int, d: int, msgs: int, stats: bool):
    """(bound µs, what bounds it) of one B2 (or, with ``stats``, B3) call:
    the message read once, the dequantized message and the row scales
    written once (and two stats a message); 4 operations an element (divide,
    round, clamp, multiply), 5 more for the stats."""
    n_bytes = 4 * rows * d + 4 * rows * d + 4 * rows + (8 * msgs if stats else 0)
    bytes_us = n_bytes / HBM_BYTES_PER_S * 1e6
    ops_us = rows * d * (4 + (5 if stats else 0)) / F32_OPS_PER_S * 1e6
    return max(bytes_us, ops_us), "bytes" if bytes_us >= ops_us else "operations"


def _phase_lm_batched_shapes() -> dict:
    """Phase 8b's new shapes in phase 1: B2 on the batched LM round's R * B
    = 8 wide rows and B3 on its R = 2 messages (int8, bit-equal to the plain
    version), B5's forward and backward on its R * B = 8 folded sequences
    in bf16 (within ATTN_ATOL and GRAD_REL of the plain version); each
    timed eager, replayed (L2-warm) and one call L2-cold, beside its bound
    and the plain version's eager time."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import quant_exchange as qx

    few = dict(reps=10, samples=5)
    out = {}
    for name, kernel, plain, shape in (
            ("quant_dequant", qx.quant_dequant, qx.quant_dequant_plain, LM_BATCHED_ROWS),
            ("quant_dequant_stats", qx.quant_dequant_stats, qx.quant_dequant_stats_plain,
             LM_BATCHED_MESSAGES)):
        x = _message(shape, seed=120)
        got, want = kernel(x, "int8"), plain(x, "int8")
        torch.cuda.synchronize()
        check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
              f"{name} at {shape}: differs from the plain version")
        if len(got) == 3:
            check(torch.allclose(got[2], want[2], rtol=STATS_RTOL, atol=1e-7),
                  f"{name} at {shape}: stats {got[2].tolist()} vs {want[2].tolist()}")
        d = shape[-1]
        rows = x.numel() // d
        bound, by = _wire_bound(rows, d, rows // shape[-2] if len(shape) == 3 else 1,
                                len(got) == 3)
        out[name] = dict(shape=list(shape), kernel_us=_time_us(kernel, x, "int8", **few),
                         kernel_dev_us=_graph_time_us(kernel, x, "int8", **few),
                         kernel_cold_us=_cold_time_us(kernel, x, "int8", reps=10),
                         plain_us=_time_us(plain, x, "int8", reps=3, samples=3),
                         bound_us=bound, bound_by=by)
    b, s, h, hkv, d, window = LM_BATCHED_ATTN
    (q, k, v), kw = _attention_args("flash_attention", LM_BATCHED_ATTN, "bfloat16", seed=121)
    with torch.inference_mode():
        got, _ = fa.flash_attention(q, k, v, **kw)
        want = fa.flash_attention_plain(q, k, v, **kw)
    err = float((got.float() - want.float()).abs().max())
    check(err <= ATTN_ATOL["bfloat16"], f"flash_attention at {LM_BATCHED_ATTN}: {err:.3e}")
    call = lambda: fa.flash_attention(q, k, v, **kw)          # noqa: E731
    lib = _attention_library("flash_attention", (q, k, v), window)
    bound, by = _attention_bound_us("flash_attention", LM_BATCHED_ATTN, "bfloat16")
    with torch.inference_mode():
        check(float((lib().transpose(1, 2).float() - want.float()).abs().max())
              <= ATTN_ATOL["bfloat16"], f"SDPA at {LM_BATCHED_ATTN} disagrees with the plain "
                                        f"version")
        dev = _graph_times_us([call, lib], **few)
        out["flash_attention"] = dict(
            shape=list(LM_BATCHED_ATTN), max_abs_err=err, kernel_us=_time_us(call, **few),
            kernel_dev_us=_median(dev[0]),
            kernel_cold_us=_cold_time_us(call, reps=10),
            plain_us=_time_us(lambda: fa.flash_attention_plain(q, k, v, **kw), reps=3,
                              samples=3),
            library_us=_time_us(lib, **few), library_dev_us=_median(dev[1]),
            bound_us=bound, bound_by=by)
    g = torch.Generator(device=DEVICE).manual_seed(122)
    dout = torch.randn(q.shape, generator=g, device=DEVICE).to(q.dtype)
    o, lse = fa.flash_attention(q, k, v, **kw)
    qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
    plain_out = fa.flash_attention_plain(qq, kk, vv, **kw)
    ref = torch.autograd.grad(plain_out, (qq, kk, vv), grad_outputs=dout, retain_graph=True)
    mine = fa.flash_attention_bwd(q, k, v, o, dout, lse, **kw)
    scale = max(float(r.abs().max()) for r in ref)
    err = max(_rel_err(a, r, scale) for a, r in zip(mine, ref))
    check(err <= GRAD_REL["bfloat16"], f"flash_attention_bwd at {LM_BATCHED_ATTN}: {err:.3e}")
    call = lambda: fa.flash_attention_bwd(q, k, v, o, dout, lse, **kw)   # noqa: E731
    lib_out = F.scaled_dot_product_attention(*(x.transpose(1, 2) for x in (qq, kk, vv)),
                                             is_causal=True, enable_gqa=True)
    lib_bwd = lambda: torch.autograd.grad(lib_out, (qq, kk, vv),  # noqa: E731
                                          grad_outputs=dout.transpose(1, 2), retain_graph=True)
    check(max(_rel_err(a, r, scale) for a, r in zip(lib_bwd(), ref)) <= GRAD_REL["bfloat16"],
          f"SDPA's backward at {LM_BATCHED_ATTN} disagrees with the plain autograd")
    pairs = s * (s + 1) // 2
    n_bytes = 2 * (4 * b * s * h * d + 4 * b * s * hkv * d) + 4 * b * h * s
    bytes_us = n_bytes / HBM_BYTES_PER_S * 1e6
    ops_us = 10 * d * pairs * b * h / BF16_OPS_PER_S * 1e6
    out["flash_attention_bwd"] = dict(
        shape=list(LM_BATCHED_ATTN), max_rel_err=err, kernel_us=_time_us(call, **few),
        kernel_dev_us=_graph_time_us(call, **few), kernel_cold_us=_cold_time_us(call, reps=10),
        plain_us=_time_us(lambda: torch.autograd.grad(plain_out, (qq, kk, vv),
                                                      grad_outputs=dout, retain_graph=True),
                          reps=3, samples=3),
        library_us=_time_us(lib_bwd, reps=5, samples=5),
        bound_us=max(bytes_us, ops_us), bound_by="bytes" if bytes_us >= ops_us else "operations")
    for name, t in out.items():
        lib_us = ("none" if "library_us" not in t else f"{t['library_us']:.3f} eager" + (
            f", {t['library_dev_us']:.3f} replayed" if "library_dev_us" in t else ""))
        log(f"phase1 {name} at {t['shape']} (the batched LM round): kernel_us="
            f"{t['kernel_us']:.3f} plain_us={t['plain_us']:.3f} bound_us={t['bound_us']:.4f} "
            f"({t['bound_by']}); replayed kernel_us={t['kernel_dev_us']:.3f}; L2-cold "
            f"kernel_us={t['kernel_cold_us']:.3f}; SDPA{' backward' if 'bwd' in name else ''} "
            f"{lib_us}")
    return out


def _phase_replica_kernels() -> dict:
    """Phase 2e's new shapes in phase 1: B1 aliased at the pool's J * R
    candidates (one launch a call, bit-identical runs, the sums within rtol
    of the plain version and of float64, numerators exactly 0), B2 on the
    sweep's and the pool's rows and B3 on their messages (deq and scales
    bit-equal to the plain version, stats within STATS_RTOL, both formats),
    each timed eager, replayed (L2-warm) and L2-cold beside its plain
    version and its bound.  {kernel: [one dict a shape]}."""
    import torch
    from repro_torch.kernels import quant_exchange as qx
    from repro_torch.kernels import tamper_check as tc

    out = {"tamper_check_sums": [], "quant_dequant": [], "quant_dequant_stats": []}
    ref, _ = _activations(REPLICA_TAMPER, seed=11)
    a = ref.double().reshape(REPLICA_TAMPER[0], -1)
    err = _tamper_checks(ref, ref, torch.stack([torch.zeros_like(a[:, 0]), (a * a).sum(1)],
                                               dim=1), f"{REPLICA_TAMPER} aliased")
    check(bool((tc.tamper_check_sums(ref, ref)[:, 0] == 0.0).all()),
          f"tamper {REPLICA_TAMPER}: identical inputs give a nonzero numerator")
    r, n, d = REPLICA_TAMPER
    t = _tamper_timing(tc.tamper_check_sums, ref, ref, plain=tc.tamper_check_sums_plain)
    bytes_us = (r * n * d * 4 + r * 13) / HBM_BYTES_PER_S * 1e6
    ops_us = 5 * r * n * d / F32_OPS_PER_S * 1e6
    t.update(shape=list(REPLICA_TAMPER), call="aliased (ref, ref)", max_abs_err=err,
             bound_us=max(bytes_us, ops_us),
             bound_by="bytes" if bytes_us >= ops_us else "operations")
    out["tamper_check_sums"].append(t)
    for name, kernel, plain, shapes in (
            ("quant_dequant", qx.quant_dequant, qx.quant_dequant_plain, REPLICA_ROWS),
            ("quant_dequant_stats", qx.quant_dequant_stats, qx.quant_dequant_stats_plain,
             REPLICA_MESSAGES)):
        for i, shape in enumerate(shapes):
            x = _message(shape, seed=30 + i)
            max_err = 0.0
            for fmt in qx.QUANT_FORMATS:
                out1, out2, ref_out = kernel(x, fmt), kernel(x, fmt), plain(x, fmt)
                torch.cuda.synchronize()
                check(all(torch.equal(p, q) for p, q in zip(out1, out2)),
                      f"{name} {fmt} {shape}: two runs differ")
                check(torch.equal(out1[0], ref_out[0]) and torch.equal(out1[1], ref_out[1]),
                      f"{name} {fmt} {shape}: deq/scales differ from the plain version")
                if len(out1) == 3:
                    check(torch.allclose(out1[2], ref_out[2], rtol=STATS_RTOL, atol=1e-7),
                          f"{name} {fmt} {shape}: stats differ from the plain version")
                max_err = max([max_err] + [float((p - q).abs().max())
                                           for p, q in zip(out1, ref_out)])
            rows = x.numel() // shape[-1]
            bound_us, bound_by = _wire_bound(rows, shape[-1], shape[0] if len(shape) == 3
                                             else 1, len(shape) == 3)
            t = dict(shape=list(shape), max_abs_err=max_err,
                     kernel_us=_time_us(kernel, x, "int8"), plain_us=_time_us(plain, x, "int8"),
                     kernel_dev_us=_graph_time_us(kernel, x, "int8"),
                     plain_dev_us=_graph_time_us(plain, x, "int8"),
                     kernel_cold_us=_cold_time_us(kernel, x, "int8"),
                     bound_us=bound_us, bound_by=bound_by)
            out[name].append(t)
    for name, shapes in out.items():
        for t in shapes:
            log(f"phase1 {name} at {tuple(t['shape'])} (phase 2e's replica form): equal to "
                f"plain (max_abs_err={t['max_abs_err']:.3e}); kernel_us={t['kernel_us']:.3f} "
                f"plain_us={t['plain_us']:.3f} bound_us={t['bound_us']:.4f} "
                f"({t['bound_by']}); replayed (L2 warm): kernel_us={t['kernel_dev_us']:.3f} "
                f"plain_us={t['plain_dev_us']:.3f}; one call L2-cold: "
                f"kernel_us={t['kernel_cold_us']:.3f}")
    return out


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


def _same_bits(a, b) -> bool:
    """Equal values, NaN where the other is NaN."""
    import torch
    return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def _tamper_checks(ref, other, exact, label: str, key: str = "tamper_check_sums") -> float:
    """One B1 case: one launch a call (counted under ``key``, the route's),
    two runs bit-identical, the sums within rtol of the plain version and
    of ``exact`` (float64), the distances bit-equal to the plain formula on
    the kernel's sums and the verdicts ``distance <= tol``.  Returns max
    |distance - plain distance|."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels import tamper_check as tc
    build.reset_launches()
    s1, d1, p1 = tc.tamper_check(ref, other, TAMPER_TOL)
    check(build.LAUNCHES == want_launches(**{key: 1}),
          f"tamper {label}: a call launched {build.LAUNCHES}")
    s2, d2, p2 = tc.tamper_check(ref, other, TAMPER_TOL)
    plain = tc.tamper_check_sums_plain(ref, other)
    torch.cuda.synchronize()
    check(_same_bits(s1, s2) and _same_bits(d1, d2) and torch.equal(p1, p2),
          f"tamper {label}: two runs differ")
    check(torch.allclose(s1, plain, rtol=TAMPER_RTOL, atol=0, equal_nan=True),
          f"tamper {label}: {s1.tolist()} vs plain {plain.tolist()}")
    check(torch.allclose(s1.double(), exact, rtol=TAMPER_RTOL, atol=0, equal_nan=True),
          f"tamper {label}: {s1.tolist()} vs float64 {exact.tolist()}")
    check(_same_bits(d1, tc.distance_from_sums(s1)),
          f"tamper {label}: distances {d1.tolist()} are not the plain formula's on the "
          f"kernel's sums {tc.distance_from_sums(s1).tolist()}")
    check(torch.equal(p1, d1 <= TAMPER_TOL), f"tamper {label}: verdicts {p1.tolist()} "
                                             f"for distances {d1.tolist()}")
    diff = (d1 - tc.tamper_distance_plain(ref, other)).abs()
    return float(torch.nan_to_num(diff, nan=0.0).max())


def _tamper_timing(fn, *args, plain=None) -> dict:
    """Eager, replayed and L2-cold times of one call."""
    timing = dict(kernel_us=_time_us(fn, *args), kernel_dev_us=_graph_time_us(fn, *args),
                  kernel_cold_us=_cold_time_us(fn, *args))
    if plain is not None:
        timing.update(plain_us=_time_us(plain, *args), plain_dev_us=_graph_time_us(plain, *args))
    return timing


def _phase_tamper():
    """B1 at every TAMPER_SHAPES entry, on distinct inputs and on the
    aliased call the fused round makes (ref, ref): one launch a call, the
    sums against the plain version and a float64 sum, bit-identical runs,
    the distances bit-equal to the plain formula on the kernel's sums, the
    numerator exactly 0 on identical finite inputs and NaN where an input
    holds an inf or a NaN, the verdict on a tampered candidate; timed at
    the main path's (R, D_o, d_c), distinct and aliased, beside a
    calibration read of the same bytes (``torch.sum``)."""
    import torch
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import tamper_check as tc

    max_err = 0.0
    for i, shape in enumerate(TAMPER_SHAPES):
        ref, recv = _activations(shape, seed=i)
        a, b = ref.double().reshape(shape[0], -1), recv.double().reshape(shape[0], -1)
        den = (a * a).sum(1)
        max_err = max(max_err, _tamper_checks(
            ref, recv, torch.stack([((a - b) ** 2).sum(1), den], dim=1), f"{shape}"))
        max_err = max(max_err, _tamper_checks(
            ref, ref, torch.stack([torch.zeros_like(den), den], dim=1), f"{shape} aliased"))
        aliased, distinct = tc.tamper_check_sums(ref, ref), tc.tamper_check_sums(ref, recv)
        check(bool((aliased[:, 0] == 0.0).all()),
              f"tamper {shape}: identical inputs give {aliased[:, 0].tolist()}, not 0")
        check(torch.equal(aliased[:, 1], distinct[:, 1]),
              f"tamper {shape}: den depends on recv or on the route")
    # an inf and a NaN: NaN numerators (inf - inf, NaN - NaN) on both
    # routes, an inf one where only recv holds an inf; those candidates fail
    ref, _ = _activations(TAMPER_SHAPES[0], seed=60)
    ref[1, 7, 3], ref[3, 100, 5] = float("inf"), float("nan")
    recv = ref.clone()
    recv[4, 9, 9] = float("inf")
    for other, label in ((ref, "aliased, inf and NaN"), (recv, "inf and NaN")):
        a, b = ref.double().reshape(ref.shape[0], -1), other.double().reshape(ref.shape[0], -1)
        _tamper_checks(ref, other, torch.stack([((a - b) ** 2).sum(1), (a * a).sum(1)], dim=1),
                       label)
    sums, dists, passed = tc.tamper_check(ref, ref, TAMPER_TOL)
    want_nan = [False, True, False, True, False]
    check(sums[:, 0].isnan().tolist() == want_nan and (sums[[0, 2, 4], 0] == 0).all(),
          f"tamper: aliased numerators with an inf and a NaN {sums[:, 0].tolist()}")
    check(passed.tolist() == [not w for w in want_nan],
          f"tamper: aliased verdicts with an inf and a NaN {passed.tolist()}")
    check(tc.tamper_check(ref, recv, TAMPER_TOL)[2].tolist() == [True, False, True, False,
                                                                 False],
          "tamper: the candidate whose recv holds an inf passed")
    # one tampered candidate among identical ones
    ref, _ = _activations(TAMPER_SHAPES[0], seed=50)
    recv = ref.clone()
    recv[2] += 1e-3 * torch.randn_like(recv[2])
    build.reset_launches()
    dist = ops.tamper_distance(ref, recv).tolist()
    check(build.LAUNCHES == want_launches(tamper_check_sums=1),
          f"tamper: ops.tamper_distance launched {build.LAUNCHES}")
    check(dist[2] > TAMPER_TOL and all(d == 0.0 for j, d in enumerate(dist) if j != 2),
          f"tamper: tampered candidate 2 gives distances {dist}")
    check(ops.tamper_verdict(ref, recv, TAMPER_TOL)[0].tolist() == [True, True, False,
                                                                     True, True],
          "tamper: the verdict on tampered candidate 2")
    log(f"phase1 tamper_check_sums: one launch a call; within rtol {TAMPER_RTOL} of plain "
        f"and float64 at {list(TAMPER_SHAPES)}, distinct and aliased, bit-identical run "
        f"to run, distances bit-equal to the plain formula on the kernel's sums, exactly "
        f"0 on identical inputs, NaN numerators where an input holds an inf or a NaN; "
        f"tampered candidate 2: distances {dist}; distance max_abs_err={max_err:.3e}")

    r, n, d = TAMPER_SHAPES[0]
    ref, recv = _activations(TAMPER_SHAPES[0], seed=99)
    sink = torch.empty((), dtype=torch.float32, device=DEVICE)

    def calibration(x):
        return torch.sum(x, dim=0, out=sink)

    timing = _tamper_timing(tc.tamper_check_sums, ref, ref, plain=tc.tamper_check_sums_plain)
    distinct = _tamper_timing(tc.tamper_check_sums, ref, recv,
                              plain=tc.tamper_check_sums_plain)
    results = {}
    for label, t, n_in in (("aliased", timing, 1), ("distinct", distinct, 2)):
        # the inputs read once, the sums, distances and verdicts written; 5
        # flops an element
        bytes_us = (n_in * r * n * d * 4 + r * 13) / HBM_BYTES_PER_S * 1e6
        ops_us = 5 * r * n * d / F32_OPS_PER_S * 1e6
        t.update(bound_us=max(bytes_us, ops_us),
                 bound_by="bytes" if bytes_us >= ops_us else "operations")
        # a read of the same bytes (a yardstick of the timers, not B1)
        t["calibration"] = _tamper_timing(calibration, torch.ones(n_in * r * n * d,
                                                                  device=DEVICE))
        results[label] = t
        log(f"phase1 tamper_check_sums at {TAMPER_SHAPES[0]} {label}: kernel_us="
            f"{t['kernel_us']:.3f} plain_us={t['plain_us']:.3f} bound_us="
            f"{t['bound_us']:.4f} ({t['bound_by']}); graph-replayed device time: "
            f"kernel_us={t['kernel_dev_us']:.3f} plain_us={t['plain_dev_us']:.3f} (inputs "
            f"in the 50 MB L2 between replays); one call with the L2 cold: kernel_us="
            f"{t['kernel_cold_us']:.3f}; calibration read of "
            f"{n_in * r * n * d * 4 / 1e6:.2f} MB (torch.sum): eager "
            f"{t['calibration']['kernel_us']:.3f}, replayed "
            f"{t['calibration']['kernel_dev_us']:.3f}, cold "
            f"{t['calibration']['kernel_cold_us']:.3f}")
    timing["distinct"] = dict(shape=list(TAMPER_SHAPES[0]), **distinct)
    return dict(max_abs_err=max_err, shape=list(TAMPER_SHAPES[0]), call="aliased (ref, ref)",
                **timing)


def _phase_tamper_bf16():
    """B1's bf16 route at every TAMPER_BF16_SHAPES entry, distinct and
    aliased: one launch a call (``tamper_check_sums_bf16``), the sums within
    rtol of the plain version (which widens to f32) and of a float64 sum of
    the same bf16 values, bit-identical runs, the distances bit-equal to the
    plain formula on the kernel's sums, 0 on identical inputs, NaN where an
    input holds an inf or a NaN; timed at the LM round's shape, aliased (the
    path's call) and distinct, eager, replayed (L2-warm) and one call
    L2-cold, beside the plain version and a calibration read of the same
    bytes."""
    import torch
    from repro_torch.kernels import tamper_check as tc

    key = "tamper_check_sums_bf16"
    max_err = 0.0
    for i, shape in enumerate(TAMPER_BF16_SHAPES):
        ref, recv = (x.to(torch.bfloat16) for x in _activations(shape, seed=70 + i))
        a, b = ref.double().reshape(shape[0], -1), recv.double().reshape(shape[0], -1)
        den = (a * a).sum(1)
        max_err = max(max_err, _tamper_checks(
            ref, recv, torch.stack([((a - b) ** 2).sum(1), den], dim=1), f"bf16 {shape}",
            key))
        max_err = max(max_err, _tamper_checks(
            ref, ref, torch.stack([torch.zeros_like(den), den], dim=1),
            f"bf16 {shape} aliased", key))
        aliased, distinct = tc.tamper_check_sums(ref, ref), tc.tamper_check_sums(ref, recv)
        check(bool((aliased[:, 0] == 0.0).all()) and torch.equal(aliased[:, 1], distinct[:, 1]),
              f"tamper bf16 {shape}: aliased sums {aliased.tolist()}, distinct "
              f"{distinct.tolist()}")
    ref, _ = _activations(TAMPER_BF16_SHAPES[1], seed=80)
    ref = ref.to(torch.bfloat16)
    ref[1, 7, 3], ref[2, 30, 200] = float("inf"), float("nan")
    sums = tc.tamper_check_sums(ref, ref)
    check(sums[:, 0].isnan().tolist() == [False, True, True] and float(sums[0, 0]) == 0.0,
          f"tamper bf16: aliased numerators with an inf and a NaN {sums[:, 0].tolist()}")
    log(f"phase1 tamper_check_sums bf16: one launch a call; within rtol {TAMPER_RTOL} of "
        f"plain and float64 at {list(TAMPER_BF16_SHAPES)}, distinct and aliased, "
        f"bit-identical run to run, NaN numerators where an input holds an inf or a NaN; "
        f"distance max_abs_err={max_err:.3e}")

    shape = TAMPER_BF16_SHAPES[0]
    numel = shape[0] * shape[1] * shape[2]
    ref, recv = (x.to(torch.bfloat16) for x in _activations(shape, seed=99))
    sink = torch.empty((), dtype=torch.bfloat16, device=DEVICE)

    def calibration(x):
        return torch.sum(x, dim=0, out=sink)

    out = dict(max_abs_err=max_err, shape=list(shape), dtype="bfloat16",
               call="aliased (ref, ref)")
    for label, other, n_in in (("aliased", ref, 1), ("distinct", recv, 2)):
        t = _tamper_timing(tc.tamper_check_sums, ref, other, plain=tc.tamper_check_sums_plain)
        bytes_us = (n_in * numel * 2 + shape[0] * 13) / HBM_BYTES_PER_S * 1e6
        ops_us = 5 * numel / F32_OPS_PER_S * 1e6
        t.update(bound_us=max(bytes_us, ops_us),
                 bound_by="bytes" if bytes_us >= ops_us else "operations",
                 calibration=_tamper_timing(calibration, torch.ones(
                     n_in * numel, dtype=torch.bfloat16, device=DEVICE)))
        log(f"phase1 tamper_check_sums bf16 at {shape} {label}: kernel_us="
            f"{t['kernel_us']:.3f} plain_us={t['plain_us']:.3f} bound_us="
            f"{t['bound_us']:.4f} ({t['bound_by']}); replayed: kernel_us="
            f"{t['kernel_dev_us']:.3f} plain_us={t['plain_dev_us']:.3f}; L2-cold: "
            f"kernel_us={t['kernel_cold_us']:.3f}; calibration read of "
            f"{n_in * numel * 2 / 1e6:.2f} MB (torch.sum): eager "
            f"{t['calibration']['kernel_us']:.3f}, replayed "
            f"{t['calibration']['kernel_dev_us']:.3f}, cold "
            f"{t['calibration']['kernel_cold_us']:.3f}")
        out[label] = t
    return out


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
    """Times of one B7 call at ``shape`` in bf16 on both routes (the
    persistent kernel and the step kernel): eager, graph-replayed in turn
    (L2 warm) and L2-cold; the plain version eager, the bound, and the time
    a step (the scan's dependency chain)."""
    import torch
    from repro_torch.kernels import slstm_scan as ss
    pre, r, h = _slstm_args(shape, "bfloat16", seed=99)
    check(ss.slstm_route(pre, r) == ss.PERSISTENT, f"slstm_scan {shape}: the timed shape "
                                                   f"takes {ss.slstm_route(pre, r)!r}")
    call = lambda: ss.slstm_scan(pre, r, h)                        # noqa: E731
    step = lambda: ss.slstm_scan(pre, r, h, route=ss.STEP)         # noqa: E731
    plain = lambda: ss.slstm_scan_plain(pre, r, h)                 # noqa: E731
    eager = dict(reps=2 if long else 10, samples=5, warmup=2)
    with torch.inference_mode():
        replays = _graph_times_us([call, step], reps=1 if long else 5, samples=5)
        timing = dict(kernel_us=_time_us(call, **eager), kernel_dev_us=_median(replays[0]),
                      kernel_cold_us=_cold_time_us(call, reps=5),
                      plain_us=_time_us(plain, reps=1, samples=3, warmup=1),
                      plain_dev_us=None, library_us=None)
        old = dict(kernel_us=_time_us(step, **eager), kernel_dev_us=_median(replays[1]),
                   kernel_cold_us=_cold_time_us(step, reps=5))
    timing["bound_us"], timing["bound_by"] = _slstm_bound_us(shape, "bfloat16")
    t = shape[0]
    timing["step_us"] = timing["kernel_dev_us"] / t
    old["step_us"] = old["kernel_dev_us"] / t
    log(f"phase1 slstm_scan at {shape} bf16: bound_us={timing['bound_us']:.4f} "
        f"({timing['bound_by']}); plain_us={timing['plain_us']:.3f}; library none")
    for name, tm, times in (("persistent", timing, replays[0]), ("step", old, replays[1])):
        log(f"  {name} route: kernel_us={tm['kernel_us']:.3f} eager; graph-replayed device "
            f"time (L2 warm, in turn) kernel_us={tm['kernel_dev_us']:.3f} (replays "
            f"{times[0]:.3f}-{times[-1]:.3f}; {tm['step_us']:.3f} us a step over T = {t}); "
            f"one call with the L2 cold: kernel_us={tm['kernel_cold_us']:.3f}")
    return dict(shape=list(shape), dtype="bfloat16", step_route=old, **timing)


def _phase_slstm():
    """B7 against its plain version at every shape, in f32 and bf16, on the
    route ``slstm_route`` picks (checked against SLSTM_ROUTES) and, where
    that is the persistent kernel, on the step kernel too; bit-identical run
    to run; both routes timed at the prefill shape and at the long shape."""
    import torch
    from repro_torch.kernels import slstm_scan as ss

    max_err = {}
    for dtype in ("float32", "bfloat16"):
        for i, shape in enumerate(SLSTM_SHAPES):
            pre, r, h = _slstm_args(shape, dtype, seed=i)
            chosen = ss.slstm_route(pre, r)
            want = SLSTM_ROUTES[shape][dtype == "bfloat16"]
            check(chosen == want,
                  f"slstm_scan {dtype} {shape}: route {chosen!r}, want {want!r}")
            with torch.inference_mode():
                ref = ss.slstm_scan_plain(pre, r, h)
            for route in dict.fromkeys((chosen, ss.STEP)):
                what = f"slstm_scan {dtype} {shape} on the {route} route"
                with torch.inference_mode():
                    out1 = ss.slstm_scan(pre, r, h, route=route)
                    out2 = ss.slstm_scan(pre, r, h, route=route)
                torch.cuda.synchronize()
                check(torch.equal(out1, out2), f"{what}: two runs differ")
                check(out1.shape == ref.shape and out1.dtype == ref.dtype,
                      f"{what}: {out1.shape} {out1.dtype} vs plain {ref.shape} {ref.dtype}")
                check(bool(torch.isfinite(out1).all()), f"{what}: not finite")
                err = float((out1.float() - ref.float()).abs().max())
                check(err <= SLSTM_ATOL[dtype], f"{what}: max |kernel - plain| {err:.3e} > "
                                                f"{SLSTM_ATOL[dtype]}")
                key = (dtype, route)
                max_err[key] = max(max_err.get(key, 0.0), err)
                if i == 0 and dtype == "bfloat16" and route == chosen:
                    main_err = err
        log(f"phase1 slstm_scan {dtype} routes: "
            f"{[(shape, SLSTM_ROUTES[shape][dtype == 'bfloat16']) for shape in SLSTM_SHAPES]}")
    log(f"phase1 slstm_scan: within atol {SLSTM_ATOL} of plain at {list(SLSTM_SHAPES)} in "
        f"f32 and bf16 on the route each takes and on the step route, bit-identical run to "
        f"run; max_abs_err by (dtype, route) {max_err}")
    main = _slstm_timing(SLSTM_SHAPES[0], long=False)
    return dict(max_abs_err=main_err,
                max_abs_err_by_route={f"{d}/{r}": e for (d, r), e in max_err.items()},
                **main, long_context=_slstm_timing(SLSTM_LONG, long=True))


def _slstm_bwd_bound_us(shape):
    """(bound in us, what sets it) of B7's backward: dout (bf16), z and the
    state (f32) read once, dz (f32) written once, r read once, over 3.35
    TB/s; the per-step product with R^T, 2 * dh flops per (step, row, gate
    column), over the f32 FMA rate."""
    t, b, d, h = shape
    dh = d // h
    n_bytes = 2 * t * b * d + 4 * t * b * 4 * d + 4 * 4 * t * b * d + 4 * t * b * 4 * d \
        + 2 * h * dh * 4 * dh
    bytes_us = n_bytes / HBM_BYTES_PER_S * 1e6
    ops_us = 2 * t * b * 4 * d * dh / F32_OPS_PER_S * 1e6
    return max(bytes_us, ops_us), ("bytes" if bytes_us >= ops_us else "operations")


def _slstm_bwd_timing(shape, long: bool):
    """Times of one B7 backward call at ``shape`` in bf16, from the
    persistent forward's saves, on both routes (the persistent kernel and
    the step kernel): eager, graph-replayed in turn (L2 warm) and L2-cold;
    the bound and the time a reverse step.  At the prefill shape also the
    plain autograd's backward, the dR product and the forward with and
    without saves."""
    import torch
    from repro_torch.kernels import slstm_scan as ss
    pre, r, h = _slstm_args(shape, "bfloat16", seed=99)
    g = torch.Generator(device=DEVICE).manual_seed(98)
    dout = torch.randn(shape[:3], generator=g, device=DEVICE).to(pre.dtype)
    check(ss.slstm_bwd_route(dout, r) == ss.PERSISTENT,
          f"slstm_scan_bwd {shape}: the timed shape takes {ss.slstm_bwd_route(dout, r)!r}")
    with torch.no_grad():
        _, z, state = ss.slstm_scan(pre, r, h, save=True)
        dz = ss.slstm_scan_bwd(dout, r, z, state, h)
    call = lambda: ss.slstm_scan_bwd(dout, r, z, state, h)                        # noqa: E731
    step = lambda: ss.slstm_scan_bwd(dout, r, z, state, h, route=ss.STEP)         # noqa: E731
    extra = [] if long else [lambda: ss.recurrent_weight_grad(state[0], dz, h),
                             lambda: ss.slstm_scan(pre, r, h),
                             lambda: ss.slstm_scan(pre, r, h, save=True)]
    eager = dict(reps=2 if long else 5, samples=5, warmup=2)
    with torch.no_grad():
        replays = _graph_times_us([call, step, *extra], reps=1 if long else 2, samples=5)
        timing = dict(kernel_us=_time_us(call, **eager), kernel_dev_us=_median(replays[0]),
                      kernel_cold_us=_cold_time_us(call, reps=5), plain_us=None,
                      plain_dev_us=None, library_us=None)
        old = dict(kernel_us=_time_us(step, **eager), kernel_dev_us=_median(replays[1]),
                   kernel_cold_us=_cold_time_us(step, reps=5))
        if not long:
            timing.update(dr_us=_time_us(extra[0], **eager), dr_dev_us=_median(replays[2]),
                          fwd_dev_us=_median(replays[3]), fwd_save_dev_us=_median(replays[4]))
    if not long:
        pp, rr = pre.clone().requires_grad_(), r.clone().requires_grad_()
        plain_out = ss.slstm_scan_plain(pp, rr, h)
        plain = lambda: torch.autograd.grad(plain_out, (pp, rr),                  # noqa: E731
                                            grad_outputs=dout, retain_graph=True)
        timing["plain_us"] = _time_us(plain, reps=1, samples=3, warmup=1)
    timing["bound_us"], timing["bound_by"] = _slstm_bwd_bound_us(shape)
    t = shape[0]
    timing["step_us"] = timing["kernel_dev_us"] / t
    old["step_us"] = old["kernel_dev_us"] / t
    plain_txt = "not timed" if long else f"plain autograd backward {timing['plain_us']:.3f}"
    log(f"phase1 slstm_scan_bwd at {shape} bf16: bound_us={timing['bound_us']:.4f} "
        f"({timing['bound_by']}); {plain_txt}; library none")
    for name, tm, times in (("persistent", timing, replays[0]), ("step", old, replays[1])):
        log(f"  {name} route: kernel_us={tm['kernel_us']:.3f} eager; graph-replayed device "
            f"time (L2 warm, in turn) kernel_us={tm['kernel_dev_us']:.3f} (replays "
            f"{times[0]:.3f}-{times[-1]:.3f}; {tm['step_us']:.3f} us a reverse step over T = "
            f"{t}); one call with the L2 cold: kernel_us={tm['kernel_cold_us']:.3f}")
    if not long:
        log(f"  the dR product (f32 einsum) {timing['dr_us']:.3f} eager, "
            f"{timing['dr_dev_us']:.3f} replayed; the forward replayed without saves "
            f"{timing['fwd_dev_us']:.3f}, with saves {timing['fwd_save_dev_us']:.3f}")
    return dict(shape=list(shape), dtype="bfloat16", step_route=old, **timing)


def _phase_slstm_bwd():
    """B7's backward (the reverse-time scan) on the route ``slstm_bwd_route``
    picks (checked against SLSTM_BWD_ROUTES) and on the step route
    (``csrc/slstm_scan_bwd.cu``), against autograd of the plain version at
    every SLSTM_SHAPES entry, f32 and bf16, from the saves of both forward
    routes (the route ``slstm_route`` picks and the step route): dpre (dz in
    pre's dtype) and dR (``recurrent_weight_grad``) within GRAD_REL of each
    tensor's largest value, the two backward routes' dz within GRAD_REL of
    each other, the saving forward's h bit-equal to the plain launch's, each
    reverse scan bit-identical run to run.  In bf16 the reference is the
    plain version's autograd on the same values widened to f32 (its bf16
    autograd sums dR over T steps in bf16, each add rounded).  Then the
    autograd path (``ops.slstm_scan``) once at the prefill shape: one saving
    forward and one persistent backward launch, the gradients of the direct
    calls bit for bit.  Both routes timed at the prefill shape and at
    SLSTM_LONG in bf16: eager, replayed, L2-cold."""
    import torch
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import slstm_scan as ss

    def grads(pre, r, h, dout, fwd_route, bwd_route=None):
        with torch.no_grad():
            out, z, state = ss.slstm_scan(pre, r, h, route=fwd_route, save=True)
            dz = ss.slstm_scan_bwd(dout, r, z, state, h, route=bwd_route)
            return (out, dz, dz.to(pre.dtype),
                    ss.recurrent_weight_grad(state[0], dz, h).to(r.dtype))

    errs, gaps, main_err = {}, {}, None
    for dtype in ("float32", "bfloat16"):
        for i, shape in enumerate(SLSTM_SHAPES):
            pre, r, h = _slstm_args(shape, dtype, seed=200 + i)
            g = torch.Generator(device=DEVICE).manual_seed(300 + i)
            dout = torch.randn(shape[:3], generator=g, device=DEVICE).to(pre.dtype)
            chosen = ss.slstm_bwd_route(dout, r)
            want = SLSTM_BWD_ROUTES[shape][dtype == "bfloat16"]
            check(chosen == want,
                  f"slstm_scan_bwd {dtype} {shape}: route {chosen!r}, want {want!r}")
            pp, rr = (x.float().requires_grad_() for x in (pre, r))
            ref = torch.autograd.grad(ss.slstm_scan_plain(pp, rr, h), (pp, rr),
                                      grad_outputs=dout.float())
            for route in dict.fromkeys((ss.slstm_route(pre, r), ss.STEP)):
                with torch.no_grad():
                    plain_launch = ss.slstm_scan(pre, r, h, route=route)
                dzs = {}
                for bwd in dict.fromkeys((chosen, ss.STEP)):
                    what = (f"slstm_scan_bwd {dtype} {shape} on the {bwd} route from the "
                            f"{route} route's saves")
                    out, dz, dpre, dr = grads(pre, r, h, dout, route, bwd)
                    again = grads(pre, r, h, dout, route, bwd)[1]
                    torch.cuda.synchronize()
                    check(torch.equal(out, plain_launch), f"{what}: the saving forward's h "
                                                          f"differs from the plain launch's")
                    check(torch.equal(dz, again), f"{what}: two runs differ")
                    check(dpre.shape == pre.shape and dr.shape == r.shape and
                          dpre.dtype == dr.dtype == pre.dtype,
                          f"{what}: {dpre.shape} {dr.shape}")
                    check(bool(torch.isfinite(dz).all()), f"{what}: dz not finite")
                    err = max(_rel_err(dpre, ref[0]), _rel_err(dr, ref[1]))
                    check(err <= GRAD_REL[dtype],
                          f"{what}: rel err {err:.3e} > {GRAD_REL[dtype]}")
                    key = f"{dtype}/{route} saves/{bwd}"
                    errs[key] = max(errs.get(key, 0.0), err)
                    dzs[bwd] = dz
                    if i == 0 and dtype == "bfloat16" and main_err is None:
                        main_err = err
                        main_abs = max(float((dpre.float() - ref[0]).abs().max()),
                                       float((dr.float() - ref[1]).abs().max()))
                if len(dzs) == 2:
                    gap = _rel_err(dzs[ss.PERSISTENT], dzs[ss.STEP])
                    check(gap <= GRAD_REL[dtype], f"slstm_scan_bwd {dtype} {shape}: the two "
                                                  f"routes' dz differ by rel {gap:.3e}")
                    gaps[dtype] = max(gaps.get(dtype, 0.0), gap)
        log(f"phase1 slstm_scan_bwd {dtype} routes: "
            f"{[(shape, SLSTM_BWD_ROUTES[shape][dtype == 'bfloat16']) for shape in SLSTM_SHAPES]}")
    log(f"phase1 slstm_scan_bwd: dpre and dR within rel {GRAD_REL} of autograd of the plain "
        f"version at {list(SLSTM_SHAPES)} in f32 and bf16, on the route each takes and on "
        f"the step route, from the saves of both forward routes, the saving forward's h "
        f"bit-equal to the plain launch's, bit-identical run to run; max rel err by (dtype, "
        f"forward route, backward route) {errs}; the two backward routes' dz apart by rel "
        f"{gaps}")

    # the autograd path: ops.slstm_scan on tensors that need a gradient
    shape = SLSTM_SHAPES[0]
    pre, r, h = _slstm_args(shape, "bfloat16", seed=99)
    g = torch.Generator(device=DEVICE).manual_seed(98)
    dout = torch.randn(shape[:3], generator=g, device=DEVICE).to(pre.dtype)
    pp, rr = pre.clone().requires_grad_(), r.clone().requires_grad_()
    torch.cuda.synchronize()
    build.reset_launches()
    got = torch.autograd.grad(ops.slstm_scan(pp, rr, h), (pp, rr), grad_outputs=dout)
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    check(launches == want_launches(slstm_scan_persistent=1, slstm_scan_bwd_persistent=1),
          f"slstm_scan_bwd: ops.slstm_scan with a gradient launched {launches}")
    _, dz, dpre, dr = grads(pre, r, h, dout, ss.PERSISTENT)
    check(torch.equal(got[0], dpre) and torch.equal(got[1], dr),
          "slstm_scan_bwd: the autograd path's gradients differ from the direct calls'")
    log(f"phase1 slstm_scan_bwd: launches through ops.slstm_scan {launches}")

    main = _slstm_bwd_timing(shape, long=False)
    return dict(max_abs_err=main_abs, max_rel_err=main_err, max_rel_err_by_route=errs,
                routes_rel_gap=gaps, **main,
                long_context=_slstm_bwd_timing(SLSTM_LONG, long=True))


# ---------------------------------------------------------------------------
# phases 2-4: the protocol
# ---------------------------------------------------------------------------

def _run(name, module, data, pcfg, driver=None, **kw):
    """``driver`` (``run_pigeon`` by default) on the card with the launch
    counts reset just before it: (history, launches, seconds)."""
    import torch
    from repro_torch.core import run_pigeon
    from repro_torch.kernels import build

    torch.cuda.synchronize()
    build.reset_launches()
    t0 = time.perf_counter()
    hist = (driver or run_pigeon)(module, data, pcfg, **kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    for r in hist.rounds:
        losses = r.get("val_losses", [r.get("train_loss")])
        check(all(v == v and abs(v) < 1e6 for v in losses),
              f"{name}: non-finite loss {losses}")
        check(0.0 <= r["test_acc"] <= 1.0, f"{name}: test_acc {r['test_acc']}")
        fields = " ".join(f"{k}={r[k]}" for k in ("selected", "selected_honest", "accepted",
                                                  "detections") if k in r)
        log(f"{name} round {r['round']}: {fields} "
            f"{'val_losses' if 'val_losses' in r else 'train_loss'}="
            f"{[round(v, 6) for v in losses]} "
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
    ops = _verify_stage_ops(main)
    check(sum(ev.count for ev in ops) == 1 and "tamper_check_kernel" in ops[0].key,
          f"phase2b: the verify stage ran {[(ev.key[:60], ev.count) for ev in ops]}, want "
          f"one tamper_check_kernel a round")
    log(f"phase2b verify stage, one round profiled alone: {sum(ev.count for ev in ops)} "
        f"device operation a round ({ops[0].key[:80]})")
    log(f"phase2b seconds_per_round={seconds / pcfg.T:.3f} (batched) vs "
        f"{seq_s_per_round:.3f} (sequential, phase2); Python-issued client steps "
        f"a round: {m_bar * pcfg.E} vs {pcfg.M * pcfg.E}")
    return launches, seconds / pcfg.T


def phase_baselines(main):
    """The paper's baselines.  (a) Tiny vanilla SL and SplitFed (both
    engines) on the CPU and on the card from one init (int8, label flip):
    equal comm and selections, losses within rtol 1e-3, and SplitFed's two
    engines equal on the card.  (b) The Table II CIFAR configuration (phase
    2's, T = 2) through run_vanilla_sl, run_splitfed sequential and batched
    (argmin), and batched under loss_plus_distance: the wire launches each
    path's structure gives, exchange bytes, comm equal across SplitFed's
    runs, the same selections on its two engines, seconds a round."""
    import numpy as np
    from repro_torch.core import (LABEL_FLIP, Attack, ProtocolConfig, from_cnn, run_splitfed,
                                  run_vanilla_sl)
    from repro_torch.data import build_image_task

    data, cfg = build_image_task("mnist", m_clients=4, d_m=120, d_o=60, n_test=200, seed=0)
    pcfg = ProtocolConfig(M=4, N=1, T=2, E=2, B=16, lr=0.05, seed=0)
    kw = dict(malicious={1}, attack=Attack(LABEL_FLIP), quant="int8")
    module = from_cnn(cfg)
    runs = {}
    for dev in ("cpu", DEVICE):
        runs["vanilla", dev] = run_vanilla_sl(module, data, pcfg, device=dev, **kw)
        for engine in ("sequential", "batched"):
            runs[engine, dev] = run_splitfed(module, data, pcfg, engine=engine, device=dev,
                                             **kw)
    for ra, rb in zip(runs["vanilla", "cpu"].rounds, runs["vanilla", DEVICE].rounds):
        check(ra["comm"] == rb["comm"] and np.allclose(ra["train_loss"], rb["train_loss"],
                                                       rtol=1e-3, atol=0),
              f"phase2c vanilla round {ra['round']}: cpu {ra} card {rb}")
    for a, b, losses_too in ((("sequential", "cpu"), ("sequential", DEVICE), True),
                             (("batched", "cpu"), ("batched", DEVICE), True),
                             (("sequential", DEVICE), ("batched", DEVICE), False)):
        for ra, rb in zip(runs[a].rounds, runs[b].rounds):
            for k in ("selected", "selected_honest", "comm"):
                check(ra[k] == rb[k], f"phase2c splitfed round {ra['round']}: {k} {a}={ra[k]} "
                                      f"{b}={rb[k]}")
            if losses_too:
                check(np.allclose(ra["val_losses"], rb["val_losses"], rtol=1e-3, atol=0),
                      f"phase2c splitfed: val_losses {a}={ra['val_losses']} "
                      f"{b}={rb['val_losses']}")
    log(f"phase2c: tiny vanilla SL (train losses "
        f"{[r['train_loss'] for r in runs['vanilla', DEVICE].rounds]}) and SplitFed on both "
        f"engines agree between the CPU and the card over {pcfg.T} rounds; SplitFed's "
        f"engines select {[r['selected'] for r in runs['batched', DEVICE].rounds]} on both")

    data, cfg, module, pcfg, kw = main
    base = dict(malicious=kw["malicious"], attack=kw["attack"], quant="int8",
                device=kw["device"])
    steps = pcfg.T * pcfg.E
    paths = {"vanilla": (run_vanilla_sl, {}, dict(quant_dequant=2 * pcfg.M * steps)),
             "splitfed_sequential": (run_splitfed, dict(engine="sequential"),
                                     dict(quant_dequant=2 * pcfg.M * steps)),
             "splitfed_batched": (run_splitfed, dict(engine="batched"),
                                  dict(quant_dequant=2 * steps)),
             "splitfed_batched_lpd": (run_splitfed, dict(engine="batched",
                                                         selection="loss_plus_distance"),
                                      dict(quant_dequant=steps, quant_dequant_stats=steps))}
    out, hists = {}, {}
    for name, (driver, extra, want) in paths.items():
        hist, launches, seconds = _run(f"phase2c cifar {name}", module, data, pcfg,
                                       driver=driver, **base, **extra)
        check(launches == want_launches(**want),
              f"phase2c {name}: launches {launches}, want {want}")
        _check_exchange_bytes(f"phase2c {name}", hist, pcfg, cfg.d_cut, "int8")
        hists[name] = hist
        out[name] = dict(launches=launches, seconds_per_round=seconds / pcfg.T)
    sfl = [hists[n] for n in paths if n.startswith("splitfed")]
    for rounds in zip(*(h.rounds for h in sfl)):
        check(all(r["comm"] == rounds[0]["comm"] for r in rounds),
              f"phase2c round {rounds[0]['round']}: SplitFed's comm differs between runs")
    for rs, rb in zip(hists["splitfed_sequential"].rounds, hists["splitfed_batched"].rounds):
        check(rs["selected"] == rb["selected"],
              f"phase2c round {rs['round']}: SplitFed selects {rs['selected']} sequential, "
              f"{rb['selected']} batched (val_losses {rs['val_losses']} vs "
              f"{rb['val_losses']})")
    log(f"phase2c cifar seconds_per_round: "
        f"{ {n: round(v['seconds_per_round'], 3) for n, v in out.items()} }; SplitFed's comm "
        f"equal across its runs, its selections equal on both engines")
    return out


#: phase 2d's four runs of the batched engine: (block, prefetch)
MULTIROUND_RUNS = ((1, 0), (1, 1), (4, 0), (4, 1))
MULTIROUND_T = 5                 # eval_every 5: rounds 0 and 4 are sync rounds
MULTIROUND_RTOL = 1e-6           # floats across the runs under deterministic cuDNN


def _span_totals(sink) -> dict:
    """{span name: [count, seconds]} over a MemorySink's spans."""
    out = {}
    for e in sink.of("span"):
        n, s = out.get(e["name"], (0, 0.0))
        out[e["name"]] = (n + 1, s + e["dur_s"])
    return {k: [n, round(v, 4)] for k, (n, v) in sorted(out.items())}


#: the History fields phase 2d holds exactly: the protocol's decisions
MULTIROUND_DECISIONS = ("round", "clusters", "selected", "detections", "accepted",
                        "selected_honest", "comm")


def _multiround_compare(ref, hist, exact=MULTIROUND_DECISIONS):
    """Phase 2d's comparison of two Histories: (the fields of ``exact`` that
    differ, as messages; the losses' largest relative difference, 0.0 when
    bit-equal; the number of rounds whose test_acc differs)."""
    import numpy as np
    if len(ref.rounds) != len(hist.rounds):
        return [f"{len(hist.rounds)} rounds, want {len(ref.rounds)}"], float("inf"), 0
    diffs, worst, acc = [], 0.0, 0
    for ra, rb in zip(ref.rounds, hist.rounds):
        diffs += [f"round {ra['round']}: {k} {rb.get(k)} != {ra.get(k)}"
                  for k in exact if ra.get(k) != rb.get(k)]
        acc += ra.get("test_acc") != rb.get("test_acc")
        for k in ("val_losses", "train_losses"):
            a, b = np.asarray(ra[k], np.float64), np.asarray(rb[k], np.float64)
            worst = max(worst, float(np.max(np.abs(a - b) / np.abs(a))))
    return diffs, worst, acc


class _deterministic_cudnn:
    """cuDNN restricted to deterministic algorithms inside the block."""

    def __enter__(self):
        import torch
        self.saved = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True

    def __exit__(self, *exc):
        import torch
        torch.backends.cudnn.deterministic = self.saved


def phase_multiround(main):
    """Phase 2d: multi-round execution on the batched main path (phase 2b's
    configuration, T = 5, eval_every = 5).  Four runs — block 1 and 4, each
    with prefetch 0 and 1 — and a repeat of the first, under the main path's
    cuDNN settings: each makes T*M_bar*E B2 and B3 launches and T B1
    launches, every RoundRunner.accept_block runs under sync-debug "error",
    a block run makes one block.fetch span a block, and all make the same
    decisions (clusters, selections, detections, acceptance, comm); their
    losses' spread and test_acc are printed (cuDNN's default algorithms need
    not repeat bit for bit).  The four again under deterministic cuDNN: the
    decisions and test_acc exactly, the losses within MULTIROUND_RTOL
    (bit-equality reported).  Prints each
    timed run's seconds a round, span totals and peak device memory.  Then
    resume at Table II (deterministic cuDNN; T = 2 with block 2 and
    checkpoint_every 2, resumed to T = 4: the tail equals an uninterrupted
    T = 4 run), and a --trace/--profile-dir run of launch/train.py on the
    card (provenance names the card and its power limit, the JSONL reads
    back, the profile directory holds a trace)."""
    import dataclasses
    import os
    import tempfile

    import torch
    from repro_torch.core import run_pigeon
    from repro_torch.core.runner import RoundRunner
    from repro_torch.data import plan_blocks
    from repro_torch.kernels import build
    from repro_torch.telemetry import MemorySink, Telemetry, read_jsonl

    data, cfg, module, pcfg, kw = main
    pcfg = dataclasses.replace(pcfg, T=MULTIROUND_T, eval_every=MULTIROUND_T)
    m_bar = pcfg.M // pcfg.R
    want = want_launches(quant_dequant=pcfg.T * m_bar * pcfg.E,
                         quant_dequant_stats=pcfg.T * m_bar * pcfg.E,
                         tamper_check_sums=pcfg.T)
    accept_block = RoundRunner.accept_block
    blocks = []

    def strict_accept_block(self, params, block_inputs, val):
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = accept_block(self, params, block_inputs, val)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        blocks.append(len(block_inputs))
        return out

    def run(name, block, prefetch):
        sink = MemorySink()
        blocks.clear()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        build.reset_launches()
        t0 = time.perf_counter()
        hist = run_pigeon(module, data, pcfg, engine="batched", block=block,
                          prefetch=prefetch, telemetry=Telemetry(sinks=(sink,)), **kw)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dict(build.LAUNCHES)
        check(launches == want, f"phase2d {name}: launches {launches}, want {want}")
        spans = _span_totals(sink)
        segments = plan_blocks(0, pcfg.T, block,
                               lambda t: t % pcfg.eval_every == 0 or t == pcfg.T - 1)
        if block > 1:
            check(blocks == [k for _, k in segments],
                  f"phase2d {name}: accept_block ran blocks {blocks}, want "
                  f"{[k for _, k in segments]}")
            check(spans["block.fetch"][0] == len(segments),
                  f"phase2d {name}: {spans['block.fetch'][0]} block.fetch spans, want one "
                  f"a block ({len(segments)})")
        else:
            check(not blocks, f"phase2d {name}: accept_block ran at block 1")
        rec = dict(seconds_per_round=seconds / pcfg.T, seconds=seconds,
                   peak_gb=torch.cuda.max_memory_allocated() / 1e9, spans=spans)
        log(f"phase2d {name}: {pcfg.T} rounds in {seconds:.3f} s "
            f"({seconds / pcfg.T:.3f} s/round, warm); peak {rec['peak_gb']:.2f} GB; "
            f"B2/B3/B1 launches {launches['quant_dequant']}/"
            f"{launches['quant_dequant_stats']}/{launches['tamper_check_sums']}; spans "
            f"[count, seconds] {spans}")
        return hist, rec

    run_pigeon(module, data, dataclasses.replace(pcfg, T=1), engine="batched", **kw)
    torch.cuda.synchronize()                   # warm: the runs below start alike
    out, hists, det = {}, {}, {}
    RoundRunner.accept_block = strict_accept_block
    try:
        for block, prefetch in MULTIROUND_RUNS + ((1, 0),):
            name = f"block{block}_prefetch{prefetch}"
            name += "_repeat" if name in out else ""
            hists[name], out[name] = run(name, block, prefetch)
        with _deterministic_cudnn():
            for block, prefetch in MULTIROUND_RUNS:
                name = f"block{block}_prefetch{prefetch}"
                det[name], out[name]["deterministic"] = run(f"{name} deterministic",
                                                            block, prefetch)
    finally:
        RoundRunner.accept_block = accept_block
    # the main path's cuDNN: the decisions exactly; the losses' spread and
    # test_acc reported (cuDNN's default algorithms need not repeat bit for
    # bit: the repeat shows the spread of one mode run twice).  Deterministic
    # cuDNN: everything exactly, test_acc included, losses within rtol.
    found = {}
    for label, runs, exact in (("", hists, MULTIROUND_DECISIONS),
                               (" deterministic", det, MULTIROUND_DECISIONS + ("test_acc",))):
        ref = runs["block1_prefetch0"]
        for name, hist in runs.items():
            diffs, worst, acc = _multiround_compare(ref, hist, exact)
            found[name + label] = (diffs, worst)
            rec = out[name]["deterministic"] if label else out[name]
            rec.update(max_rel_diff=worst, test_acc_rounds_differing=acc)
            log(f"phase2d {name}{label} vs block1_prefetch0{label}: losses' largest "
                f"relative difference {worst!r} (0.0: bit-equal), test_acc differs in "
                f"{acc} of its evaluated rounds, decisions differ: {diffs}")
    for r in hists["block1_prefetch0"].rounds:
        log(f"phase2d round {r['round']}: selected={r['selected']} "
            f"accepted={r['accepted']} detections={r['detections']} "
            f"test_acc={r.get('test_acc')}")
    for name, (diffs, worst) in found.items():
        check(not diffs, f"phase2d {name}: {diffs}")
        check(not name.endswith("deterministic") or worst <= MULTIROUND_RTOL,
              f"phase2d {name}: losses differ by {worst} > rtol {MULTIROUND_RTOL}")
    log(f"phase2d: the runs agree in every decision (and, under deterministic cuDNN, "
        f"in test_acc and the losses within rtol {MULTIROUND_RTOL}); seconds_per_round "
        f"{ {n: round(v['seconds_per_round'], 3) for n, v in out.items()} }, "
        f"deterministic { {n: round(v['deterministic']['seconds_per_round'], 3) for n, v in out.items() if 'deterministic' in v} }")

    # resume at Table II: T = 2 in blocks of 2 with a checkpoint, resumed to T = 4
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp, _deterministic_cudnn():
        path = os.path.join(tmp, "ck")
        full_cfg = dataclasses.replace(pcfg, T=4)
        full = run_pigeon(module, data, full_cfg, engine="batched", **kw)
        run_pigeon(module, data, dataclasses.replace(pcfg, T=2), engine="batched", block=2,
                   checkpoint_path=path, checkpoint_every=2, **kw)
        t0 = time.perf_counter()
        resumed = run_pigeon(module, data, full_cfg, engine="batched", block=2,
                             checkpoint_path=path, checkpoint_every=2, resume=True, **kw)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        diffs, worst, _ = _multiround_compare(type(full)(rounds=full.rounds[2:]), resumed,
                                              MULTIROUND_DECISIONS + ("test_acc",))
        out["resume"] = dict(max_rel_diff=worst, seconds=seconds)
    check(not diffs and worst <= MULTIROUND_RTOL,
          f"phase2d resume: the tail differs from the uninterrupted run: {diffs}, losses "
          f"by {worst}")
    log(f"phase2d resume: T=2 (block 2, checkpoint_every 2) resumed to T=4 equals the "
        f"uninterrupted run's rounds 2-3 (deterministic cuDNN; losses' largest relative "
        f"difference {worst!r})")

    # the launch script's trace and profile on the card
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        trace, prof = os.path.join(tmp, "run.jsonl"), os.path.join(tmp, "prof")
        cmd = [sys.executable, "-m", "repro_torch.launch.train", "--task", "cifar10",
               "--smoke", "--protocol", "pigeon", "--engine", "batched", "--block", "2",
               "--trace", trace, "--profile-dir", prof]
        env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600, env=env,
                              cwd=ROOT)
        check(proc.returncode == 0, f"phase2d train --trace exited {proc.returncode}: "
                                    f"{proc.stderr[-2000:]}")
        events = read_jsonl(trace)
        stamp = events[0].get("provenance", {})
        card = card_line()
        gpus = stamp.get("gpus") or []
        check(events[0]["event"] == "run_start" and gpus
              and f"{gpus[0]['name']}, {gpus[0]['power_limit']}" == card
              and stamp.get("device_kind") == torch.cuda.get_device_name(0),
              f"phase2d trace: run_start provenance {stamp} does not name the card "
              f"({card})")
        rounds = [e for e in events if e["event"] == "round"]
        check([e["t"] for e in rounds] == list(range(5)),
              f"phase2d trace: round events {[e['t'] for e in rounds]}")
        files = os.listdir(prof) if os.path.isdir(prof) else []
        check(len(files) == 1 and files[0].endswith(".json"),
              f"phase2d profile dir holds {files}")
        out["train_trace"] = dict(events=len(events), profile_files=files,
                                  seconds=time.perf_counter() - t0)
    log(f"phase2d train --trace --profile-dir: {len(events)} events read back, "
        f"provenance names {gpus}, profile {files}")
    return out


#: phase 2e: the sweep's seeds and horizon (rounds 0 and T - 1 always
#: evaluate, so T = 3 is the least at which a block of 2 fuses two rounds),
#: the pool's jobs' horizons and lanes, and the tolerances against the solo
#: runs (a replica's slots take other reduction layouts on the card)
SWEEP_SEEDS = (0, 1, 2)
SWEEP_T = 3
POOL_T = (2, 2, 3, 3)
POOL_LANES = 2
REPLICA_RTOL = 1e-4
REPLICA_ACC_TOL = 5 / 7000
REPLICA_FLOATS = ("val_losses", "train_losses", "test_acc")


def _replica_compare(solo, hist):
    """A sweep replica's or pooled job's History against its solo run's:
    (the decisions that differ, as messages — a field the replica does not
    record, the sweep's ``accepted`` and ``detections``, is skipped; the
    losses' largest relative gap; test_acc's largest gap; the float fields
    bit-equal in every round)."""
    import numpy as np
    if len(solo.rounds) != len(hist.rounds):
        return [f"{len(hist.rounds)} rounds, want {len(solo.rounds)}"], float("inf"), 1.0, []
    diffs, worst, acc = [], 0.0, 0.0
    for rs, rh in zip(solo.rounds, hist.rounds):
        diffs += [f"round {rs['round']}: {k} {rh[k]} != {rs[k]}"
                  for k in MULTIROUND_DECISIONS + ("honest_cluster_exists",)
                  if k in rh and rh[k] != rs[k]]
        for k in ("val_losses", "train_losses"):
            a, b = np.asarray(rs[k], np.float64), np.asarray(rh[k], np.float64)
            worst = max(worst, float(np.max(np.abs(a - b) / np.abs(a))))
        if ("test_acc" in rs) != ("test_acc" in rh):
            diffs.append(f"round {rs['round']}: test_acc recorded in one run only")
        elif "test_acc" in rs:
            acc = max(acc, abs(rs["test_acc"] - rh["test_acc"]))
    equal = [k for k in REPLICA_FLOATS
             if all(rs.get(k) == rh.get(k) for rs, rh in zip(solo.rounds, hist.rounds))]
    return diffs, worst, acc, equal


def _sweep_pool_pass(main, label: str, sweep_blocks, tmp: str) -> dict:
    """One pass of phase 2e (see :func:`phase_sweep_pool`); ``label`` names
    the cuDNN mode in the log."""
    import dataclasses
    import os

    import torch
    from repro_torch.core import LABEL_FLIP, Attack, run_pigeon, run_pigeon_sweep
    from repro_torch.core.jobs import JobSpec, run_job_pool
    from repro_torch.data import plan_blocks
    from repro_torch.kernels import build
    from repro_torch.telemetry import MemorySink, Telemetry

    data, cfg, module, pcfg, kw = main
    m_bar = pcfg.M // pcfg.R
    out, found = {}, []

    def timed(name, fn, want):
        sink = MemorySink()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        build.reset_launches()
        t0 = time.perf_counter()
        result = fn(Telemetry(sinks=(sink,)))
        torch.cuda.synchronize()
        rec = dict(seconds=time.perf_counter() - t0, launches=dict(build.LAUNCHES),
                   peak_gb=torch.cuda.max_memory_allocated() / 1e9, spans=_span_totals(sink))
        if want is not None:
            check(rec["launches"] == want_launches(**want),
                  f"phase2e{label} {name}: launches {rec['launches']}, want {want}")
        return result, rec, sink

    def held(name, solo, hist):
        diffs, worst, acc, equal = _replica_compare(solo, hist)
        found.append((name, diffs, worst, acc))
        log(f"phase2e{label} {name} vs its solo run: decisions differ {diffs}; losses' "
            f"largest relative gap {worst!r}; test_acc's largest gap {acc!r}; bit-equal "
            f"float fields {equal}")
        return dict(max_rel_diff=worst, test_acc_gap=acc, bit_equal=equal)

    def wire(rounds):
        return dict(quant_dequant=rounds * m_bar * pcfg.E,
                    quant_dequant_stats=rounds * m_bar * pcfg.E)

    # the sweep against three solo runs
    sweep_cfg = dataclasses.replace(pcfg, T=SWEEP_T, eval_every=SWEEP_T)
    solos, solo_s = {}, 0.0
    for seed in SWEEP_SEEDS:
        solos[seed], rec, _ = timed(
            f"solo seed {seed}", lambda tel, seed=seed: run_pigeon(
                module, data, dataclasses.replace(sweep_cfg, seed=seed), engine="batched",
                telemetry=tel, **kw), dict(**wire(SWEEP_T), tamper_check_sums=SWEEP_T))
        solo_s += rec["seconds"]
    out["solo_seconds_per_round"] = solo_s / (SWEEP_T * len(SWEEP_SEEDS))
    for block in sweep_blocks:
        name = f"sweep block {block}"
        STRICT.clear()
        hists, rec, sink = timed(name, lambda tel, block=block: run_pigeon_sweep(
            module, data, sweep_cfg, seeds=SWEEP_SEEDS, block=block, telemetry=tel, **kw),
            wire(SWEEP_T))
        segments = plan_blocks(0, SWEEP_T, block, lambda t: t % SWEEP_T == 0
                               or t == SWEEP_T - 1)
        kind = "block" if block > 1 else "round"
        check(STRICT.get("sweep_block") == len(segments),
              f"phase2e{label} {name}: {STRICT} sync-debug sweep_block calls, want "
              f"{len(segments)}")
        check(rec["spans"][f"{kind}.fetch"][0] == len(segments),
              f"phase2e{label} {name}: {rec['spans'][f'{kind}.fetch'][0]} {kind}.fetch "
              f"spans, want one a block ({len(segments)})")
        rec.update(seconds_per_round=rec["seconds"] / SWEEP_T,
                   replicas={seed: held(f"{name} seed {seed}", solos[seed], h)
                             for seed, h in zip(SWEEP_SEEDS, hists)})
        log(f"phase2e{label} {name}: {SWEEP_T} rounds of {len(SWEEP_SEEDS)} seeds in "
            f"{rec['seconds']:.3f} s ({rec['seconds_per_round']:.3f} s a round; three solo "
            f"runs {3 * out['solo_seconds_per_round']:.3f} s a round); peak "
            f"{rec['peak_gb']:.2f} GB; launches {rec['launches']}; spans {rec['spans']}")
        out[f"sweep_block{block}"] = rec

    # the pool against each job's solo run; job1 checkpoints
    def spec(i):
        bad = {0, 1, 2, 3} if i % 2 == 0 else {4, 5, 6, 7}
        return JobSpec(name=f"job{i}", module=module, data=data,
                       pcfg=dataclasses.replace(pcfg, seed=i, T=POOL_T[i], eval_every=POOL_T[i]),
                       malicious=bad, attack=Attack(LABEL_FLIP), quant=kw["quant"],
                       selection=kw["selection"],
                       **(dict(checkpoint_path=os.path.join(tmp, f"job{i}{label.strip()}"),
                               checkpoint_every=2) if i == 1 else {}))

    specs = [spec(i) for i in range(len(POOL_T))]
    STRICT.clear()
    pooled, rec, sink = timed("pool", lambda tel: run_job_pool(
        specs, block=2, lanes=POOL_LANES, prefetch=1, telemetry=tel, device=kw["device"]),
        None)
    steps = [e for e in sink.of("span") if e["name"] == "pool.step"]
    pool_rounds = sum(e["k"] for e in steps)
    blocks = sink.of("pool_block")
    want = dict(**wire(pool_rounds), tamper_check_sums=pool_rounds)
    check(rec["launches"] == want_launches(**want),
          f"phase2e{label} pool: launches {rec['launches']} over {pool_rounds} pool rounds, "
          f"want {want} (one B1 a pool round)")
    check(STRICT.get("pool_accept_block") == len(blocks) == len(steps)
          and rec["spans"]["pool.fetch"][0] == len(blocks),
          f"phase2e{label} pool: {STRICT} sync-debug calls, {len(steps)} pool.step and "
          f"{rec['spans'].get('pool.fetch')} pool.fetch spans for {len(blocks)} blocks")
    job_rounds = sum(POOL_T)
    solo_s = 0.0
    rec["jobs"] = {}
    for sp in specs:
        solo, srec, _ = timed(f"solo {sp.name}", lambda tel, sp=sp: run_pigeon(
            module, data, sp.pcfg, engine="batched", block=2, prefetch=1, telemetry=tel,
            **{**kw, "malicious": sp.malicious}), dict(**wire(sp.pcfg.T),
                                                       tamper_check_sums=sp.pcfg.T))
        solo_s += srec["seconds"]
        rec["jobs"][sp.name] = held(f"pool {sp.name}", solo, pooled[sp.name])
    rec.update(pool_rounds=pool_rounds, blocks=len(blocks),
               seconds_per_job_round=rec["seconds"] / job_rounds,
               solo_seconds_per_round=solo_s / job_rounds)
    log(f"phase2e{label} pool: {len(specs)} jobs ({job_rounds} job-rounds) on "
        f"{POOL_LANES} lanes in {len(blocks)} blocks, {pool_rounds} pool rounds, "
        f"{rec['seconds']:.3f} s ({rec['seconds_per_job_round']:.3f} s a job-round; solo "
        f"block 2/prefetch 1 {rec['solo_seconds_per_round']:.3f} s a round); peak "
        f"{rec['peak_gb']:.2f} GB; launches {rec['launches']}; spans {rec['spans']}")
    out["pool"] = rec

    # job1's checkpoint (round 1) resumed under run_pigeon to T = 3
    cont = dataclasses.replace(specs[1].pcfg, T=3, eval_every=3)
    solo_kw = {**kw, "malicious": specs[1].malicious}
    full = run_pigeon(module, data, cont, engine="batched", **solo_kw)
    resumed = run_pigeon(module, data, cont, engine="batched", block=2,
                         checkpoint_path=specs[1].checkpoint_path, checkpoint_every=2,
                         resume=True, **solo_kw)
    check([r["round"] for r in resumed.rounds] == [2],
          f"phase2e{label} resume: rounds {[r['round'] for r in resumed.rounds]}, want [2]")
    out["resume"] = held("pool checkpoint resumed solo", type(full)(rounds=full.rounds[2:]),
                         resumed)
    for name, diffs, worst, acc in found:
        check(not diffs, f"phase2e{label} {name}: decisions differ from the solo run: {diffs}")
        check(worst <= REPLICA_RTOL, f"phase2e{label} {name}: losses {worst} apart > rtol "
                                     f"{REPLICA_RTOL}")
        check(acc <= REPLICA_ACC_TOL, f"phase2e{label} {name}: test_acc {acc} apart > "
                                      f"{REPLICA_ACC_TOL}")
    out["largest_gap"] = dict(losses=max(w for _, _, w, _ in found),
                              test_acc=max(a for _, _, _, a in found))
    return out


#: RoundRunner entries phase 2e ran under sync-debug "error", by name
STRICT: dict = {}


def phase_sweep_pool(main):
    """Phase 2e: the multi-seed sweep and the job pool on the batched main
    path (phase 2b's configuration).  The sweep: seeds 0-2, T = 3 (eval at
    rounds 0 and 2), block 1 and 2, each replica held against a solo
    ``run_pigeon(engine="batched")`` of its seed.  The pool: 4 jobs (T = 2,
    2, 3, 3; label flip on clients 0-3 or 4-7) on 2 lanes (a lane refilled),
    block 2, prefetch 1, each job held against its solo run; job1 checkpoints
    in the pool and resumes under ``run_pigeon`` (the tail against the
    uninterrupted run).  Decisions exactly, losses within REPLICA_RTOL,
    test_acc within REPLICA_ACC_TOL; every ``sweep_block`` and
    ``pool_accept_block`` under sync-debug "error"; B2 and B3 160 a round
    (M_bar * E) whatever the slots, B1 one a pool round and none in the sweep;
    one ``block.fetch`` (``round.fetch`` at block 1) a sweep block and one
    ``pool.fetch`` a pool block; seconds a round and peak memory beside the
    solo runs'.  Then the sweep at block 2 and the pool again under
    deterministic cuDNN, the same checks, with the float fields bit-equal to
    the solo runs' reported."""
    import tempfile

    import torch
    from repro_torch.core.runner import RoundRunner

    originals = {name: getattr(RoundRunner, name) for name in ("sweep_block",
                                                              "pool_accept_block")}

    def strict(name):
        def entry(self, *args):
            torch.cuda.set_sync_debug_mode("error")
            try:
                result = originals[name](self, *args)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            STRICT[name] = STRICT.get(name, 0) + 1
            return result
        return entry

    for name in originals:
        setattr(RoundRunner, name, strict(name))
    try:
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
            out = _sweep_pool_pass(main, "", (1, 2), tmp)
            with _deterministic_cudnn():
                out["deterministic"] = _sweep_pool_pass(main, " deterministic", (2,), tmp)
    finally:
        for name, fn in originals.items():
            setattr(RoundRunner, name, fn)
    log(f"phase2e: decisions equal to the solo runs; largest gaps {out['largest_gap']} "
        f"(deterministic cuDNN {out['deterministic']['largest_gap']}); sweep s a round "
        f"{out['sweep_block1']['seconds_per_round']:.3f} (block 1), "
        f"{out['sweep_block2']['seconds_per_round']:.3f} (block 2) vs three solo runs "
        f"{3 * out['solo_seconds_per_round']:.3f}; pool s a job-round "
        f"{out['pool']['seconds_per_job_round']:.3f} vs solo "
        f"{out['pool']['solo_seconds_per_round']:.3f}")
    return out


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
                want_launches(slstm_scan_persistent=sum(s.kind == "slstm"
                                                        for s in cpu.stacks)))
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
    """Tiny LMs (reduce_config of Qwen3-8B, and of xLSTM-1.3B, f32) through
    one Pigeon-SL run (label flip on one client) on the CPU and on the card
    from one init, Qwen3-8B on the sequential engine, the xLSTM on both:
    equal discrete outcomes, validation losses within rtol 1e-3; the card
    runs went through B4 and B5 (B7 for the xLSTM), forward and
    backward."""
    import numpy as np
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import LABEL_FLIP, Attack, ProtocolConfig, from_lm, run_pigeon
    from repro_torch.data import build_lm_task
    from repro_torch.kernels import build
    from repro_torch.models import build_model

    kernels = {"qwen3-8b": ("fused_xent", "fused_xent_bwd", "flash_attention",
                            "flash_attention_bwd"),
               "xlstm-1.3b": ("fused_xent", "fused_xent_bwd", "slstm_scan_persistent",
                              "slstm_scan_bwd_persistent")}
    for arch, engines in (("qwen3-8b", ("sequential",)),
                          ("xlstm-1.3b", ("sequential", "batched"))):
        cfg = get_smoke_config(arch)
        module = from_lm(build_model(cfg, "cpu"))   # the CPU template: one init for both
        data = build_lm_task(vocab=cfg.vocab, seq_len=32, m_clients=4, d_m=16, d_o=8,
                             n_test=8)
        pcfg = ProtocolConfig(M=4, N=1, T=2, E=2, B=4, lr=5e-2, seed=0)
        for engine in engines:
            what = f"phase4 lm round {arch} {engine}"
            runs, launches = {}, {}
            for dev in ("cpu", DEVICE):
                torch.cuda.synchronize()
                build.reset_launches()
                runs[dev] = run_pigeon(module, data, pcfg, malicious={1},
                                       attack=Attack(LABEL_FLIP), engine=engine, device=dev)
                torch.cuda.synchronize()
                launches[dev] = dict(build.LAUNCHES)
            check(launches["cpu"] == want_launches(), f"{what}: the CPU run launched "
                                                      f"{launches['cpu']}")
            check(all(launches[DEVICE][k] > 0 for k in kernels[arch]),
                  f"{what}: card launches {launches[DEVICE]}")
            for ra, rb in zip(runs["cpu"].rounds, runs[DEVICE].rounds):
                for k in ("clusters", "selected", "accepted", "detections", "comm"):
                    check(ra[k] == rb[k], f"{what} round {ra['round']}: {k} cpu={ra[k]} "
                                          f"card={rb[k]}")
                check(np.allclose(ra["val_losses"], rb["val_losses"], rtol=1e-3, atol=0),
                      f"{what}: val_losses cpu={ra['val_losses']} card={rb['val_losses']}")
            log(f"{what} ({cfg.name}, f32, label flip): CPU and card agree over {pcfg.T} "
                f"rounds; val_losses {runs['cpu'].rounds[-1]['val_losses']} vs "
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
    """Within the block, the attention, the loss and the sLSTM scan of CUDA
    tensors that need a gradient take the plain versions through autograd
    instead of the B4/B5/B7 functions (what phases 7 and 10 hold the kernel
    path against)."""

    def __enter__(self):
        from repro_torch.kernels import flash_attention as fa
        from repro_torch.kernels import fused_xent as fx
        from repro_torch.kernels import slstm_scan as ss
        self.saved = (fa.FlashAttention.apply, fx.FusedXent.apply, ss.SlstmScan.apply)
        fa.FlashAttention.apply = staticmethod(
            lambda q, k, v, window: fa.flash_attention_plain(q, k, v, window=window))
        fx.FusedXent.apply = staticmethod(fx.fused_xent_plain)
        ss.SlstmScan.apply = staticmethod(
            lambda pre, r, n_heads, *_: ss.slstm_scan_plain(pre, r, n_heads))
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import flash_attention as fa
        from repro_torch.kernels import fused_xent as fx
        from repro_torch.kernels import slstm_scan as ss
        fa.FlashAttention.apply, fx.FusedXent.apply, ss.SlstmScan.apply = self.saved


def _three_steps(label: str, step, batch, per_step: dict):
    """Three calls of a train ``step`` on ``batch``, each with the launches
    ``per_step``; the loss finite and falling; then two more timed for the
    profile's wall.  Returns (figures, the faster of the two walls in us)."""
    import torch
    from repro_torch.kernels import build
    losses, secs = [], []
    for i in range(3):
        torch.cuda.synchronize()
        build.reset_launches()
        t0 = time.perf_counter()
        losses.append(float(step(batch)))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        launches = dict(build.LAUNCHES)
        check(launches == per_step, f"{label} step {i}: launches {launches}, want {per_step} "
                                    f"(remat recomputes each layer's forward; bf16 takes the "
                                    f"tensor-core routes, backwards too)")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(all(x == x and abs(x) < 1e4 for x in losses), f"{label}: losses {losses}")
    check(losses[1] < losses[0] and losses[2] < losses[1], f"{label}: loss not falling {losses}")
    warm = min(secs[1:])
    tokens = batch["tokens"].numel()
    log(f"{label} losses {losses}; seconds per step {[round(x, 4) for x in secs]} (the first "
        f"with set-up); warm {warm:.4f} s, {tokens / warm:.1f} tokens/s; peak device memory "
        f"{peak_gb:.2f} GB; launches a step {launches}")
    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return dict(launches=launches, losses=losses, seconds=secs, warm_s=warm,
                tokens_per_s=tokens / warm, peak_gb=peak_gb), min(walls) * 1e6


def _kernel_vs_plain(label: str, model, batch, want: dict) -> dict:
    """``model``'s loss and every gradient on the card through the kernels
    (launches ``want``) against the plain path's (``_PlainPath``, which
    launches none): the relative gaps, each gradient on its own scale,
    within TRAIN_F32_REL."""
    import torch
    from repro_torch.kernels import build
    params = list(model.parameters())
    results = {}
    for name in ("kernel", "plain"):
        build.reset_launches()
        if name == "plain":
            with _PlainPath():
                loss, _ = model.loss(batch)
                grads = torch.autograd.grad(loss, params)
            check(build.LAUNCHES == want_launches(),
                  f"{label}: the plain path launched {build.LAUNCHES}")
        else:
            loss, _ = model.loss(batch)
            grads = torch.autograd.grad(loss, params)
            launches = dict(build.LAUNCHES)
            check(launches == want, f"{label}: the kernel path launched {launches}, want {want}")
        results[name] = (loss.detach(), grads)
    (lk, gk), (lp, gp) = results["kernel"], results["plain"]
    loss_rel = abs(float(lk) - float(lp)) / abs(float(lp))
    rels = {n: _rel_err(a, r) for (n, _), a, r in zip(model.named_parameters(), gk, gp)}
    worst = max((v, n) for n, v in rels.items())
    check(loss_rel <= TRAIN_F32_REL and worst[0] <= TRAIN_F32_REL,
          f"{label}: loss rel {loss_rel:.3e}, worst gradient {worst}")
    log(f"{label}: loss {float(lk):.6f} (kernel) vs {float(lp):.6f} (plain), rel "
        f"{loss_rel:.3e}; every gradient within rel {TRAIN_F32_REL}, the worst "
        f"{worst[0]:.3e} ({worst[1]}); the kernel path's launches {launches}")
    return dict(f32_loss_rel=loss_rel, f32_grad_rel=worst[0], f32_launches=launches,
                f32_grad_rels=rels)


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
    train, wall_us = _three_steps("phase7", step, batch, per_step)
    _profile_report(f"phase7 {cfg.name} train step (B {b}, S {s}, bf16, remat)",
                    lambda: step(batch), wall_us, 1,
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
    del model, step
    torch.cuda.empty_cache()

    # the kernel path against the plain path at full width, 4 layers, f32:
    # exact f32 products take the f32-FMA routes, forward and backward
    cfg4 = dataclasses.replace(cfg, n_layers=4, dtype="float32")
    model = build_model(cfg4, DEVICE).init(torch.Generator(device=DEVICE).manual_seed(1))
    f32 = _kernel_vs_plain(
        f"phase7 {cfg4.name} f32, 4 layers, full width", model, batch,
        want_launches(flash_attention=cfg4.n_layers * (2 if cfg4.remat else 1),
                      flash_attention_bwd=cfg4.n_layers, fused_xent=1, fused_xent_bwd=1))
    train.update({k: v for k, v in f32.items() if k != "f32_grad_rels"})
    del model
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
    predicts, exchange bytes, seconds per round and peak memory.  Returns
    (the figures, the runs' histories, which phase 8b holds its batched runs
    against)."""
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
    data = build_lm_task(**ROUND_TASK)
    log(f"phase8 data: build_lm_task({ROUND_TASK}) in {time.perf_counter() - t0:.1f} s")
    model = build_model(cfg, DEVICE)        # the template: from_lm draws the init on the card
    n_params = sum(x.numel() for x in model.parameters())
    log(f"phase8 {cfg.name}: {cfg.n_layers} layers (cut {cfg.cut_layer}), {cfg.dtype}, "
        f"remat={cfg.remat}: {n_params:,} parameters "
        f"({n_params * model.embedding.element_size() / 1e9:.2f} GB a copy)")
    pcfg = ProtocolConfig(M=4, N=1, T=2, E=2, B=4, lr=1e-3)
    out, hists = {}, {}
    for quant, selection in ROUND_RUNS:
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
        hists[f"{quant}_{selection}"] = hist
    del model
    torch.cuda.empty_cache()
    return out, hists


def _batched_round_launches(cfg, pcfg, hist, quant, n_test, stats=False):
    """The kernel launches a batched run_pigeon over from_lm makes, from the
    round structure: each of the M_bar * E stacked client steps runs every
    layer of all R slots forward (twice with remat) and backward, one B5
    launch a layer over the R * B folded batch, and B4 forward and backward
    once a slot; the validation runs the layers forward once and B4 once a
    slot; the verify stage one B1 on the bf16 route (the validation
    activations against themselves); each accepted round's R - 1 Pigeon-SL+
    sub-rounds train a stack of one (and validate it on one sample); each
    evaluation runs the layers forward; the cut width is read once.  The
    int8 wire quantizes each step's two messages over all slots' rows in
    one call each; under a policy that scores message statistics the main
    steps' uplinks go through B3."""
    import math
    n = cfg.n_layers
    cut = min(cfg.cut_layer, n)
    fwd = 2 if cfg.remat else 1
    steps = (pcfg.M // pcfg.R) * pcfg.E
    b5f, b5b, b4f, b4b, b1, b2, b3 = cut, 0, 0, 0, 0, 0, 0
    for r in hist.rounds:
        sub = (pcfg.R - 1) * int(r["accepted"])
        evals = math.ceil(n_test / pcfg.eval_batch) if "test_acc" in r else 0
        b5f += (1 + sub) * (steps * fwd * n + n) + evals * n
        b5b += (1 + sub) * steps * n
        b4f += pcfg.R * (steps + 1) + sub * (steps + 1)
        b4b += pcfg.R * steps + sub * steps
        b1 += 1
        if quant:
            b2 += (1 if stats else 2) * steps + 2 * sub * steps
            b3 += steps if stats else 0
    tc = "_tc" if cfg.dtype == "bfloat16" else ""
    return want_launches(**{
        "fused_xent" + tc: b4f, "fused_xent_bwd" + tc: b4b,
        "flash_attention" + tc: b5f, "flash_attention_bwd" + tc: b5b,
        "tamper_check_sums" + ("_bf16" if cfg.dtype == "bfloat16" else ""): b1,
        "quant_dequant": b2, "quant_dequant_stats": b3})


def _round_float_gap(got, want) -> float:
    """The largest relative gap of the loss fields (and absolute of
    test_acc) between two histories."""
    import numpy as np
    gap = 0.0
    for rg, rw in zip(got.rounds, want.rounds):
        for k in ("val_losses", "train_losses"):
            if k not in rg or k not in rw:
                continue
            a, b = np.asarray(rg[k], float), np.asarray(rw[k], float)
            gap = max(gap, float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30))))
        gap = max(gap, abs(rg["test_acc"] - rw["test_acc"]))
    return gap


def phase_round_batched(seq_hists):
    """Phase 8b: the batched engine over from_lm at phase 8's configuration
    (Qwen3-8B's width, 12 layers: 9 client + 3 AP, train_4k settings; M 4,
    N 1, T 2, E 2, B 4, label flip on client 0, Pigeon-SL+): run_pigeon(
    engine="batched") with no wire, int8, and int8 under loss_plus_distance,
    each from phase 8's init.  Its decisions equal phase 8's sequential
    runs', the largest float gap reported; launches as the round's
    structure predicts (B5 over the R slots in one launch a layer, B4 a
    slot, one B1 a round on the bf16 route); seconds a round and peak
    memory.  Then the launch layer's round steps on a 2-slot stacked model
    at the same depth (:func:`_phase_round_steps`) and batched SplitFed over
    the LM at SPLITFED_LAYERS (:func:`_phase_splitfed_lm`)."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import LABEL_FLIP, Attack, ProtocolConfig, from_lm
    from repro_torch.data import build_lm_task
    from repro_torch.launch.shapes import SHAPES, shape_settings
    from repro_torch.models import build_model

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config("qwen3-8b"), n_layers=ROUND_LAYERS,
                              **shape_settings(SHAPES["train_4k"]))
    data = build_lm_task(**ROUND_TASK)
    model = build_model(cfg, DEVICE)
    pcfg = ProtocolConfig(M=4, N=1, T=2, E=2, B=4, lr=1e-3)
    out = {}
    for quant, selection in ROUND_RUNS:
        key = f"{quant}_{selection}"
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        name = f"phase8b batched round quant={quant} selection={selection}"
        hist, launches, seconds = _run(name, from_lm(model), data, pcfg, malicious={0},
                                       attack=Attack(LABEL_FLIP), plus=True,
                                       selection=selection, quant=quant, engine="batched",
                                       device=DEVICE)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        stats = selection != "argmin"
        want = _batched_round_launches(cfg, pcfg, hist, quant, data.x_test.shape[0], stats)
        check(launches == want, f"{name}: launches {launches}, want {want}")
        seq = seq_hists[key]
        for rb, rs in zip(hist.rounds, seq.rounds):
            for k in ROUND_DECISIONS:
                check(rb[k] == rs[k], f"{name} round {rb['round']}: {k} batched={rb[k]} "
                                      f"sequential={rs[k]}")
            if not stats and rb["accepted"]:
                check(rb["selected"] == int(np.argmin(rb["val_losses"])),
                      f"{name} round {rb['round']}: selected {rb['selected']} is not the "
                      f"argmin of {rb['val_losses']}")
        gap = _round_float_gap(hist, seq)
        log(f"{name}: decisions equal to phase 8's sequential run; largest float gap "
            f"{gap:.3e} (losses relative, test_acc absolute); {seconds / pcfg.T:.2f} "
            f"s/round (init and first-call set-up included); peak device memory "
            f"{peak_gb:.2f} GB")
        out[key] = dict(launches=launches, s_per_round=seconds / pcfg.T, peak_gb=peak_gb,
                        float_gap=gap)
    del model
    torch.cuda.empty_cache()
    out["round_steps"] = _phase_round_steps(cfg)
    out["splitfed"] = _phase_splitfed_lm(cfg, data)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase8b took {out['seconds']:.1f} s")
    return out


def _step_launches(cfg, r: int, rounds: int, quant=None, plus: bool = False):
    """The launches of ``rounds`` calls of a round step over an r-slot
    stacked model: each round one train step over all slots (every layer
    forward twice under remat and backward, one B5 launch a layer; B4 once
    a slot each way; with int8 one B2 call each way over the slots' rows)
    and one validation (the layers forward once, B4 once a slot); a
    Pigeon-SL+ round one train step more."""
    n = cfg.n_layers
    fwd = 2 if cfg.remat else 1
    trains = rounds + int(plus)
    return want_launches(
        flash_attention_tc=trains * fwd * n + rounds * n, flash_attention_bwd_tc=trains * n,
        fused_xent_tc=r * (trains + rounds), fused_xent_bwd_tc=r * trains,
        quant_dequant=2 * trains if quant else 0)


def _phase_round_steps(cfg):
    """make_pigeon_round_step on a 2-slot StackedModel of ``cfg`` (two inits
    drawn on the card), batches (2, 4, 512) of build_lm_task tokens and a (8,
    512) validation set: block 1, block 2, Pigeon-SL+ and int8 once each.
    Each: finite losses, sel the argmin of the round's vlosses, every slot
    bit-equal to the winner, the launches the structure predicts; seconds a
    step (the first call's set-up included) and peak memory."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.launch.steps import make_pigeon_plus_round_step, make_pigeon_round_step
    from repro_torch.models import build_model, build_stacked_model

    r, b, s = 2, TRAIN_BATCH, TRAIN_SEQ
    stacked = build_stacked_model(cfg, r, device=DEVICE)
    plain = build_model(cfg, DEVICE)
    for slot in range(r):
        stacked.load_slot(slot, plain.init(torch.Generator(device=DEVICE).manual_seed(slot)))
    del plain
    torch.cuda.empty_cache()

    def batches(k: int, seed: int):
        parts = [_train_batch(b, s, seed=seed + i) for i in range(k * r)]
        return {name: torch.stack([p[name] for p in parts]).view(k, r, b, s)
                for name in ("tokens", "labels")}

    val = _train_batch(8, s, seed=90)
    out = {}
    for label, kw, k, plus in (("block1", {}, 1, False), ("block2", dict(block=2), 2, False),
                               ("plus", {}, 1, True), ("int8", dict(quant="int8"), 1, False)):
        inputs = batches(k, seed=10 * len(out))
        if k == 1:
            inputs = {name: v[0] for name, v in inputs.items()}
        step = (make_pigeon_plus_round_step(stacked, TRAIN_LR) if plus
                else make_pigeon_round_step(stacked, TRAIN_LR, **kw))
        args = (inputs, val)
        if plus:
            args += ({name: v[0] for name, v in batches(1, seed=80).items()},)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        build.reset_launches()
        t0 = time.perf_counter()
        vlosses, sel = step(*args)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dict(build.LAUNCHES)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        name = f"phase8b round step {label}"
        vl = vlosses.reshape(k, r)
        check(bool(torch.isfinite(vl).all()), f"{name}: vlosses {vl.tolist()}")
        check(sel.reshape(k).tolist() == torch.argmin(vl, dim=1).tolist(),
              f"{name}: sel {sel.tolist()} for vlosses {vl.tolist()}")
        check(all(torch.equal(p[0], p[i]) for p in stacked.parameters() for i in range(1, r)),
              f"{name}: the slots differ after the winner's broadcast")
        want = _step_launches(cfg, r, k, kw.get("quant"), plus)
        check(launches == want, f"{name}: launches {launches}, want {want}")
        log(f"{name}: vlosses {vl.tolist()} sel {sel.reshape(k).tolist()}; every slot "
            f"bit-equal to the winner; {seconds / k:.3f} s a round ({k} in {seconds:.3f} s, "
            f"first call included); peak {peak_gb:.2f} GB; launches {launches}")
        out[label] = dict(s_per_round=seconds / k, peak_gb=peak_gb, launches=launches)
    del stacked
    torch.cuda.empty_cache()
    return out


def _phase_splitfed_lm(cfg, data):
    """Batched SplitFed over from_lm at SPLITFED_LAYERS (cut SPLITFED_CUT):
    its R * M_bar = 4 lanes trained as one stacked model, FedAvg a cluster,
    argmin; held against the sequential SplitFed run from the same init
    (equal decisions), the launches the structure predicts (each of E steps
    runs every layer of all lanes forward, twice under remat, and backward,
    B4 once a lane; the validation once, B4 once a cluster; no verify
    stage); seconds a round and peak memory."""
    import dataclasses
    import math

    import torch
    from repro_torch.core import LABEL_FLIP, Attack, ProtocolConfig, from_lm, run_splitfed
    from repro_torch.models import build_model

    cfg = dataclasses.replace(cfg, n_layers=SPLITFED_LAYERS, cut_layer=SPLITFED_CUT)
    model = build_model(cfg, DEVICE)
    n_params = sum(x.numel() for x in model.parameters())
    pcfg = ProtocolConfig(M=4, N=1, T=2, E=2, B=4, lr=1e-3)
    runs = {}
    for engine in ("batched", "sequential"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        name = f"phase8b splitfed {engine} ({cfg.n_layers} layers, cut {cfg.cut_layer})"
        hist, launches, seconds = _run(name, from_lm(model), data, pcfg, driver=run_splitfed,
                                       malicious={0}, attack=Attack(LABEL_FLIP),
                                       engine=engine, device=DEVICE)
        runs[engine] = (hist, launches, seconds, torch.cuda.max_memory_allocated() / 1e9)
    hist, launches, seconds, peak_gb = runs["batched"]
    n, fwd, lanes = cfg.n_layers, 2 if cfg.remat else 1, pcfg.M
    evals = sum(math.ceil(data.x_test.shape[0] / pcfg.eval_batch)
                for r in hist.rounds if "test_acc" in r)
    want = want_launches(
        flash_attention_tc=min(cfg.cut_layer, n) + pcfg.T * (pcfg.E * fwd * n + n) + evals * n,
        flash_attention_bwd_tc=pcfg.T * pcfg.E * n,
        fused_xent_tc=pcfg.T * (lanes * pcfg.E + pcfg.R),
        fused_xent_bwd_tc=pcfg.T * lanes * pcfg.E)
    check(launches == want, f"phase8b splitfed batched: launches {launches}, want {want}")
    for rb, rs in zip(hist.rounds, runs["sequential"][0].rounds):
        for k in (k for k in ROUND_DECISIONS if k in rs):
            check(rb[k] == rs[k], f"phase8b splitfed round {rb['round']}: {k} "
                                  f"batched={rb[k]} sequential={rs[k]}")
    gap = _round_float_gap(hist, runs["sequential"][0])
    log(f"phase8b splitfed over {cfg.name} at {cfg.n_layers} layers ({n_params:,} "
        f"parameters): decisions equal to the sequential run, largest float gap "
        f"{gap:.3e}; batched "
        f"{seconds / pcfg.T:.2f} s/round, peak {peak_gb:.2f} GB; sequential "
        f"{runs['sequential'][2] / pcfg.T:.2f} s/round, peak {runs['sequential'][3]:.2f} GB")
    del model
    torch.cuda.empty_cache()
    return dict(layers=cfg.n_layers, cut=cfg.cut_layer, launches=launches,
                s_per_round=seconds / pcfg.T, peak_gb=peak_gb, float_gap=gap,
                sequential_s_per_round=runs["sequential"][2] / pcfg.T,
                sequential_peak_gb=runs["sequential"][3])


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


def _batched_round_step(main):
    """One fused batched CIFAR round step as phase 2b runs it, on a round
    assembled once: (step, payload, assembly ms).  ``step()`` runs
    RoundRunner.accept from a fresh copy of theta and returns its fetch."""
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

    return step, payload, assemble_ms


def _verify_stage_ops(main):
    """The device operations of one round's verify stage: one fused batched
    step with ``RoundRunner._verify_passed`` alone under torch.profiler, the
    card synchronised on both sides of it, so the window holds that stage's
    work and nothing else.  Returns the profiler's device events."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.runner import RoundRunner

    verify = RoundRunner._verify_passed
    found = []

    def profiled(self, new_p, vaux, val):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            out = verify(self, new_p, vaux, val)
            torch.cuda.synchronize()
        found.extend(ev for ev in prof.key_averages() if str(ev.device_type).endswith("CUDA"))
        return out

    step = _batched_round_step(main)[0]
    RoundRunner._verify_passed = profiled
    try:
        step()
    finally:
        RoundRunner._verify_passed = verify
    torch.cuda.synchronize()
    return found


def phase_profile_batched(main):
    """One warm batched CIFAR round step as phase 2b runs it: the fused
    RoundRunner.accept over R = 5 clusters x M_bar = 4 clients x E = 40
    stacked steps, validation, scores, the tamper check and the commit."""
    import torch

    data, cfg, module, pcfg, kw = main
    step, payload, assemble_ms = _batched_round_step(main)
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


def _b7_kernels(kernels, backward: bool = False):
    """(persistent scans, step kernels) of B7's forward, or of its backward,
    among a profile's device kernels."""
    count = lambda frag: sum(ev.count for ev in kernels if frag in ev.key)   # noqa: E731
    if backward:
        return count("slstm_bwd_persistent"), count("slstm_bwd_step")
    return count("slstm_scan_persistent"), count("slstm_step")


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
    check(prefill_launches == want_launches(slstm_scan_persistent=n_slstm),
          f"phase9: prefill launches {prefill_launches}, want {n_slstm} "
          f"slstm_scan_persistent")
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
    scans, step_kernels = _b7_kernels(prefill_kernels)
    check((scans, step_kernels) == (n_slstm, 0),
          f"phase9 prefill: the profiler saw {scans} persistent B7 kernels and "
          f"{step_kernels} step kernels, want {n_slstm} and 0")
    log(f"phase9 prefill launches {prefill_launches}: {n_slstm} B7 scans of T = {p}, "
        f"{scans} persistent kernels and {step_kernels} step kernels under the profiler; "
        f"serve loop launches {loop_launches}")
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
               persistent_kernels=scans, step_kernels=step_kernels, prefill_s=prefill_s,
               ms_per_step=ms_step, tokens_per_s=b * steps / loop_s, peak_gb=peak_gb)
    del cache, prefill_step, serve_step
    torch.cuda.empty_cache()

    # the same weights widened to f32, at full depth: prefill and decode
    # held tightly, and each bf16 path against them
    model.float()
    build.reset_launches()
    pre32, _, last32, _, _ = _serve(model, prompts, 1)
    launches32 = dict(build.LAUNCHES)
    check(launches32 == want_launches(slstm_scan_persistent=n_slstm),
          f"phase9 f32: launches {launches32}")
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
    check(long_launches == want_launches(slstm_scan_persistent=n_slstm),
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
    scans, step_kernels = _b7_kernels(kernels)
    check((scans, step_kernels) == (n_slstm, 0),
          f"phase9 long prefill: the profiler saw {scans} persistent B7 kernels and "
          f"{step_kernels} step kernels, want {n_slstm} and 0")
    del model, prefill_step, logits
    torch.cuda.empty_cache()
    out.update(long_prefill_s=long_s, long_peak_gb=long_peak, long_persistent_kernels=scans,
               long_step_kernels=step_kernels,
               seconds=time.perf_counter() - t_phase)
    log(f"phase9 took {out['seconds']:.1f} s")
    return out


def _slstm_counts(cfg):
    """(sLSTM blocks of the model, sLSTM blocks on the client's side of the
    cut) of an xLSTM config."""
    from repro_torch.models.model import build_plan
    kinds = [sp.kind for sp in build_plan(cfg) for _ in range(sp.n)]
    return kinds.count("slstm"), kinds[:cfg.cut_layer].count("slstm")


def phase_xlstm_train():
    """Phase 10: xLSTM-1.3B at full width and depth, the reference's train_4k
    settings (bf16, remat, ssm_chunk 512) with the sequence cut to 512:
    three make_train_step calls on one (4, 512) batch, the loss finite and
    falling, launches a step (B7's forward twice an sLSTM block under remat,
    its backward once, B4 forward and backward once), seconds and tokens a
    step, peak memory, one step's profile; then one (mLSTM 7, sLSTM 1) unit
    at full width in f32: the kernel path's loss and every gradient against
    the plain path's on the card (TRAIN_F32_REL)."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.shapes import SHAPES, shape_settings
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build_model

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config("xlstm-1.3b"), **shape_settings(SHAPES["train_4k"]))
    n_s, _ = _slstm_counts(cfg)
    b, s = TRAIN_BATCH, TRAIN_SEQ
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, DEVICE).init(torch.Generator(device=DEVICE).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in model.parameters())
    check(n_params == XLSTM_PARAMS, f"phase10: {n_params:,} parameters, want {XLSTM_PARAMS:,}")
    log(f"phase10 {cfg.name}: {cfg.n_layers} blocks ({n_s} sLSTM), {cfg.dtype}, remat="
        f"{cfg.remat}, ssm_chunk {cfg.ssm_chunk}, {n_params:,} parameters drawn on the card "
        f"in {time.perf_counter() - t0:.2f} s; batch ({b}, {s}), lr {TRAIN_LR}")
    batch = _train_batch(b, s)
    step = make_train_step(model, TRAIN_LR)
    per_step = want_launches(slstm_scan_persistent=n_s * (2 if cfg.remat else 1),
                             slstm_scan_bwd_persistent=n_s, fused_xent_tc=1,
                             fused_xent_bwd_tc=1)
    train, wall_us = _three_steps("phase10", step, batch, per_step)
    kernels = _profile_report(
        f"phase10 {cfg.name} train step (B {b}, S {s}, bf16, remat)", lambda: step(batch),
        wall_us, 1, shares={"B7 forward (slstm_scan_persistent)": ("slstm_scan_persistent",),
                            "B7 backward (slstm_bwd_persistent)": ("slstm_bwd_persistent",),
                            "B4 forward": ("xent_fwd_tc_kernel", "xent_combine_kernel"),
                            "B4 backward: the logit gradient": ("xent_bwd_tc_kernel",),
                            **{k: v for k, v in PREFILL_SHARES.items() if "B7" not in k}})
    scans, step_kernels = _b7_kernels(kernels, backward=True)
    check((scans, step_kernels) == (n_s, 0),
          f"phase10: the profiled train step ran {scans} persistent B7 backward kernels and "
          f"{step_kernels} step kernels, want {n_s} and 0")
    log(f"phase10 B7 backward under the profiler: {scans} persistent kernels, "
        f"{step_kernels} step kernels a train step")
    train.update(persistent_bwd_kernels=scans, step_bwd_kernels=step_kernels)
    del model, step
    torch.cuda.empty_cache()

    # the kernel path against the plain path at full width, one unit, f32
    cfg8 = dataclasses.replace(cfg, n_layers=cfg.slstm_every, dtype="float32")
    n_s8, _ = _slstm_counts(cfg8)
    model = build_model(cfg8, DEVICE).init(torch.Generator(device=DEVICE).manual_seed(1))
    f32 = _kernel_vs_plain(
        f"phase10 {cfg8.name} f32, one unit ({cfg8.n_layers} blocks), full width", model,
        batch, want_launches(slstm_scan_persistent=n_s8 * (2 if cfg8.remat else 1),
                             slstm_scan_bwd_persistent=n_s8, fused_xent=1, fused_xent_bwd=1))
    rels = f32.pop("f32_grad_rels")
    f32["f32_r_rel"] = max(v for n, v in rels.items() if n.endswith("mixer.r"))
    log(f"phase10 f32: the sLSTM's r within rel {f32['f32_r_rel']:.3e} of the plain path's")
    train.update(f32, seconds_phase=time.perf_counter() - t_phase)
    del model
    torch.cuda.empty_cache()
    log(f"phase10 took {train['seconds_phase']:.1f} s")
    return train


def _xlstm_round_launches(cfg, pcfg, hist, quant, n_test, batched: bool, stats=False):
    """B7's (and the wire's, B4's and B1's) launches of a run_pigeon over
    from_lm(xLSTM), from the round structure, as ``_round_launches`` and
    ``_batched_round_launches`` count B5, with B7 once an sLSTM block where
    B5 runs once a layer, and once a slot in the batched engine's stacked
    steps and validation (each slot has its own R): every client step runs
    the sLSTM blocks forward (twice under remat) and backward; each
    validation, handoff check and evaluation forward; the cut width is read
    once through the client's sLSTM blocks."""
    import math
    n_s, cut_s = _slstm_counts(cfg)
    fwd = 2 if cfg.remat else 1
    m_bar = pcfg.M // pcfg.R
    steps = m_bar * pcfg.E
    b7f, b7b, b4f, b4b, b1, b2, b3 = cut_s, 0, 0, 0, 0, 0, 0
    for r in hist.rounds:
        sub = (pcfg.R - 1) * int(r["accepted"])
        evals = math.ceil(n_test / pcfg.eval_batch) if "test_acc" in r else 0
        if batched:
            b7f += pcfg.R * (steps * fwd * n_s + n_s) + sub * (steps * fwd * n_s + n_s)
            b7b += (pcfg.R + sub) * steps * n_s
            b1 += 1
            if quant:
                b2 += (1 if stats else 2) * steps + 2 * sub * steps
                b3 += steps if stats else 0
        else:
            handoffs = r["detections"] + int(r["accepted"])
            b7f += (pcfg.R + sub) * steps * fwd * n_s + pcfg.R * n_s + handoffs * cut_s
            b7b += (pcfg.R + sub) * steps * n_s
            if quant:
                main = pcfg.R * steps
                b2 += 2 * (pcfg.R + sub) * steps - (main if stats else 0)
                b3 += main if stats else 0
        b7f += evals * n_s
        b4f += (pcfg.R + sub) * (steps + 1) if batched else (pcfg.R + sub) * steps + pcfg.R
        b4b += (pcfg.R + sub) * steps
    tc = "_tc" if cfg.dtype == "bfloat16" else ""
    return want_launches(**{
        "slstm_scan_persistent": b7f, "slstm_scan_bwd_persistent": b7b,
        "fused_xent" + tc: b4f, "fused_xent_bwd" + tc: b4b,
        "tamper_check_sums" + ("_bf16" if cfg.dtype == "bfloat16" else ""): b1,
        "quant_dequant": b2, "quant_dequant_stats": b3})


def phase_xlstm_round():
    """Phase 11: the Pigeon-SL round over from_lm(xLSTM-1.3B) at full width
    and XLSTM_ROUND_LAYERS blocks (cut 12), the train_4k settings, phase 8's
    protocol (M 4, N 1, T 2, E 2, B 4, label flip on client 0, Pigeon-SL+):
    no wire, then int8 under loss_plus_distance, each on the sequential and
    the batched engine (the cluster-stacked xLSTM) from one init.  Finite
    losses, decisions equal across the engines (the largest float gap
    reported), B7's launches from the round's cluster counts, seconds a
    round and peak memory."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import LABEL_FLIP, Attack, ProtocolConfig, from_lm
    from repro_torch.data import build_lm_task
    from repro_torch.launch.shapes import SHAPES, shape_settings
    from repro_torch.models import build_model

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config("xlstm-1.3b"), n_layers=XLSTM_ROUND_LAYERS,
                              **shape_settings(SHAPES["train_4k"]))
    data = build_lm_task(**ROUND_TASK)
    model = build_model(cfg, DEVICE)        # the template: from_lm draws the init on the card
    n_params = sum(x.numel() for x in model.parameters())
    log(f"phase11 {cfg.name}: {cfg.n_layers} blocks (cut {cfg.cut_layer}; sLSTM blocks, "
        f"client's: {_slstm_counts(cfg)}), {cfg.dtype}, remat={cfg.remat}: {n_params:,} "
        f"parameters ({n_params * model.embedding.element_size() / 1e9:.2f} GB a copy)")
    pcfg = ProtocolConfig(M=4, N=1, T=2, E=2, B=4, lr=1e-3)
    out = {}
    for quant, selection in XLSTM_ROUND_RUNS:
        key = f"{quant}_{selection}"
        stats = selection != "argmin"
        hists = {}
        for engine in ("sequential", "batched"):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            name = f"phase11 xlstm round {engine} quant={quant} selection={selection}"
            hist, launches, seconds = _run(name, from_lm(model), data, pcfg, malicious={0},
                                           attack=Attack(LABEL_FLIP), plus=True,
                                           selection=selection, quant=quant, engine=engine,
                                           device=DEVICE)
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            want = _xlstm_round_launches(cfg, pcfg, hist, quant, data.x_test.shape[0],
                                         engine == "batched", stats)
            check(launches == want, f"{name}: launches {launches}, want {want}")
            hists[engine] = hist
            out[f"{engine}_{key}"] = dict(launches=launches, s_per_round=seconds / pcfg.T,
                                          peak_gb=peak_gb)
            log(f"{name}: {seconds / pcfg.T:.2f} s/round (init and first-call set-up "
                f"included); peak device memory {peak_gb:.2f} GB; launches {launches}")
        for rb, rs in zip(hists["batched"].rounds, hists["sequential"].rounds):
            for k in ROUND_DECISIONS:
                check(rb[k] == rs[k], f"phase11 {key} round {rb['round']}: {k} "
                                      f"batched={rb[k]} sequential={rs[k]}")
        gap = _round_float_gap(hists["batched"], hists["sequential"])
        out[f"batched_{key}"]["float_gap"] = gap
        log(f"phase11 {key}: the batched engine's decisions equal the sequential one's over "
            f"{pcfg.T} rounds; largest float gap {gap:.3e} (losses relative, test_acc "
            f"absolute)")
    del model
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase11 took {out['seconds']:.1f} s")
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
    baselines = phase_baselines(main_path)
    multiround = phase_multiround(main_path)
    sweep_pool = phase_sweep_pool(main_path)
    phase_mnist()
    phase_cpu_vs_card()
    phase_lm_cpu_vs_card()
    phase_lm_round_cpu_vs_card()
    phase_profile()
    phase_profile_batched(main_path)
    del main_path
    serve = phase_serve()
    train = phase_train()
    rounds, round_hists = phase_round()
    batched_lm = phase_round_batched(round_hists)
    del round_hists
    xlstm = phase_xlstm()
    xlstm_train = phase_xlstm_train()
    xlstm_rounds = phase_xlstm_round()

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
                              "src/repro_torch/kernels/csrc/slstm_scan_persistent.cu"),
               # no TPU kernel: the reference trains the sLSTM by XLA autodiff
               # of its scan (_slstm_step under lax.scan)
               "slstm_scan_bwd": ("none; XLA autodiff of src/repro/models/xlstm.py:214",
                                  "src/repro_torch/kernels/csrc/slstm_scan_bwd_persistent.cu")}
    # the kernels of each wire entry (one library): B2's row kernel and its
    # wide cooperative kernel; B3's cluster kernel and its three-launch wide
    # path
    wire_kernels = {"quant_dequant": ["qdq_rows_kernel", "qdq_wide_kernel"],
                    "quant_dequant_stats": ["qdq_stats_kernel", "wide_rowmax_kernel",
                                            "wide_qdq_kernel", "wide_finish_kernel"]}
    # launches: each kernel's own path, driven with the counts reset just
    # before it: the batched round for B1-B3 (the only path that reaches all
    # three), the Qwen3-8B serve run for B5/B6, the last Qwen3-8B train step
    # for B4 and B5's backward, the xLSTM-1.3B prefill for B7; every path's
    # counts ride beside them.  Device times: graph replays back to back,
    # which find inputs of up to the 50 MB L2 still there (l2_warm), and one
    # call after an L2 flush (l2_cold), the figure to hold against bound_ms.
    by_path = {"sequential": seq_launches, "batched": launches,
               **{name: b["launches"] for name, b in baselines.items()},
               "sweep": sweep_pool["sweep_block2"]["launches"],
               "pool": sweep_pool["pool"]["launches"],
               "serve": serve["launches"],
               "train": train["launches"],
               **{f"round_{q}": r["launches"] for q, r in rounds.items()},
               **{f"round_batched_{q}": batched_lm[q]["launches"]
                  for q in rounds},
               **{f"round_step_{q}": r["launches"]
                  for q, r in batched_lm["round_steps"].items()},
               "splitfed_lm_batched": batched_lm["splitfed"]["launches"],
               "xlstm_prefill": xlstm["prefill_launches"],
               "xlstm_decode": xlstm["loop_launches"],
               "xlstm_train": xlstm_train["launches"],
               **{f"xlstm_round_{q}": r["launches"] for q, r in xlstm_rounds.items()
                  if isinstance(r, dict)}}
    # B5's and B4's forwards and backwards and B6: the entry is the
    # tensor-core route, which the bf16 paths take; the f32-FMA route it
    # replaced (its library and counter) rides beside it
    route_key = {"flash_attention": "flash_attention_tc", "fused_xent": "fused_xent_tc",
                 "flash_attention_bwd": "flash_attention_bwd_tc",
                 "fused_xent_bwd": "fused_xent_bwd_tc",
                 "decode_attention": "decode_attention_tc",
                 "slstm_scan": "slstm_scan_persistent",
                 "slstm_scan_bwd": "slstm_scan_bwd_persistent"}
    fma_library = {"flash_attention": "flash_attention", "fused_xent": "fused_xent",
                   "flash_attention_bwd": "flash_attention_bwd", "fused_xent_bwd": "fused_xent",
                   "decode_attention": "decode_attention"}
    own = {name: ("serve" if name in ("flash_attention", "decode_attention") else
                  "train" if name in ("fused_xent", "fused_xent_bwd", "flash_attention_bwd")
                  else "xlstm_prefill" if name == "slstm_scan"
                  else "xlstm_train" if name == "slstm_scan_bwd" else "batched")
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
        if name in wire_kernels:
            entry["kernels"] = wire_kernels[name]
        if "replica_shapes" in k:
            # phase 2e's shapes: the sweep's S * R and the pool's J * R slots
            entry["replica_shapes"] = [dict(
                shape=t["shape"], max_abs_err=t["max_abs_err"], ms=ms(t["kernel_us"]),
                device_ms_l2_warm=ms(t["kernel_dev_us"]),
                device_ms_l2_cold=ms(t["kernel_cold_us"]), plain_ms=ms(t["plain_us"]),
                plain_device_ms=ms(t["plain_dev_us"]), bound_ms=ms(t["bound_us"]),
                bound_by=t["bound_by"]) for t in k["replica_shapes"]]
        if name == "tamper_check_sums":
            # the path's aliased call above; distinct inputs and the
            # calibration reads (torch.sum of the same bytes) beside it
            def dev_times(t):
                return dict(device_ms_l2_warm=ms(t["kernel_dev_us"]),
                            device_ms_l2_cold=ms(t["kernel_cold_us"]))
            dist = k["distinct"]
            # the bf16 route, on the batched LM round's validation activations
            bf = k["bf16"]
            entry["bf16"] = dict(
                shape=bf["shape"], dtype=bf["dtype"], call=bf["call"],
                launches=by_path["round_batched_None_argmin"]["tamper_check_sums_bf16"],
                launches_by_path={path: counts["tamper_check_sums_bf16"]
                                  for path, counts in by_path.items()},
                max_abs_err=bf["max_abs_err"], ms=ms(bf["aliased"]["kernel_us"]),
                **dev_times(bf["aliased"]), plain_ms=ms(bf["aliased"]["plain_us"]),
                bound_ms=ms(bf["aliased"]["bound_us"]), bound_by=bf["aliased"]["bound_by"],
                library_ms=None,
                distinct=dict(ms=ms(bf["distinct"]["kernel_us"]), **dev_times(bf["distinct"]),
                              plain_ms=ms(bf["distinct"]["plain_us"]),
                              bound_ms=ms(bf["distinct"]["bound_us"]),
                              bound_by=bf["distinct"]["bound_by"]))
            entry.update(call=k["call"], kernels=["tamper_check_kernel"],
                         calibration=dict(ms=ms(k["calibration"]["kernel_us"]),
                                          **dev_times(k["calibration"])),
                         distinct=dict(shape=dist["shape"], ms=ms(dist["kernel_us"]),
                                       plain_ms=ms(dist["plain_us"]),
                                       bound_ms=ms(dist["bound_us"]),
                                       bound_by=dist["bound_by"], **dev_times(dist),
                                       calibration=dict(ms=ms(dist["calibration"]["kernel_us"]),
                                                        **dev_times(dist["calibration"]))))
        if name == "slstm_scan_bwd":
            # B7's backward: one persistent launch a reverse scan (the
            # profiler's count over one train step beside it); the step
            # route (T launches a call, its own counter) rides beside it,
            # the dR product (cuBLAS, f32) and the saving forward too
            old = k["step_route"]
            entry.update(
                kernel_route="persistent",
                persistent_kernels=xlstm_train["persistent_bwd_kernels"],
                step_kernels=xlstm_train["step_bwd_kernels"], device_ms_a_step=ms(k["step_us"]),
                step_route=dict(
                    source="src/repro_torch/kernels/csrc/slstm_scan_bwd.cu",
                    launches_by_path={path: counts[name] for path, counts in by_path.items()},
                    ms=ms(old["kernel_us"]), device_ms_l2_warm=ms(old["kernel_dev_us"]),
                    device_ms_l2_cold=ms(old["kernel_cold_us"]),
                    device_ms_a_step=ms(old["step_us"])),
                dr_product=dict(ms=ms(k["dr_us"]), device_ms_l2_warm=ms(k["dr_dev_us"])),
                forward_device_ms=dict(without_saves=ms(k["fwd_dev_us"]),
                                       with_saves=ms(k["fwd_save_dev_us"])))
        elif "step_us" in k:
            # B7: one persistent launch a scan (the profiler's count over one
            # prefill of the path beside it); the step kernel it replaced on
            # the path (T launches a scan, its own counter) rides beside it
            old = k["step_route"]
            entry.update(
                kernel_route="persistent",
                persistent_kernels=xlstm["persistent_kernels"],
                step_kernels=xlstm["step_kernels"], device_ms_a_step=ms(k["step_us"]),
                step_route=dict(
                    source="src/repro_torch/kernels/csrc/slstm_scan.cu",
                    launches_by_path={path: counts[name] for path, counts in by_path.items()},
                    ms=ms(old["kernel_us"]), device_ms_l2_warm=ms(old["kernel_dev_us"]),
                    device_ms_l2_cold=ms(old["kernel_cold_us"]),
                    device_ms_a_step=ms(old["step_us"])))
        elif name in route_key:
            entry["kernel_route"] = "tensor_cores"
            entry["sass"] = sass[key]
            old = k["f32_fma_route"]
            entry["f32_fma_route"] = dict(
                source=f"src/repro_torch/kernels/csrc/{fma_library[name]}.cu",
                sass=sass[fma_library[name]],
                launches_by_path={path: counts[name] for path, counts in by_path.items()},
                ms=ms(old["kernel_us"]), device_ms_l2_warm=ms(old["kernel_dev_us"]),
                device_ms_l2_cold=ms(old["kernel_cold_us"]))
        if "lm_batched" in k:
            # the batched LM round's shape (phase 8b), its launches there
            lb = k["lm_batched"]
            path = ("round_batched_int8_loss_plus_distance" if name == "quant_dequant_stats"
                    else "round_batched_int8_argmin")
            entry["lm_batched"] = dict(
                shape=lb["shape"], path=path, launches=by_path[path][key],
                ms=ms(lb["kernel_us"]), device_ms_l2_warm=ms(lb["kernel_dev_us"]),
                device_ms_l2_cold=ms(lb["kernel_cold_us"]), plain_ms=ms(lb["plain_us"]),
                bound_ms=ms(lb["bound_us"]), bound_by=lb["bound_by"],
                library_ms=ms(lb.get("library_us")),
                library_device_ms=ms(lb.get("library_dev_us")))
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
            for other in ("f32_fma_route", "step_route"):
                if other in lc:
                    entry["long_context"][other] = dict(
                        ms=ms(lc[other]["kernel_us"]),
                        device_ms_l2_warm=ms(lc[other]["kernel_dev_us"]),
                        device_ms_l2_cold=ms(lc[other]["kernel_cold_us"]))
        entries.append(entry)
    log(f"phase2 seconds_per_round={s_per_round:.3f}; phase2b (batched) "
        f"seconds_per_round={b_per_round:.3f}; phase2c baselines {baselines}; "
        f"phase2d multiround {multiround}; phase2e sweep and pool {sweep_pool}; "
        f"phase6 serve {serve}; phase7 train {train}; "
        f"phase8 rounds {rounds}; phase8b batched LM {batched_lm}; phase9 xlstm {xlstm}; "
        f"phase10 xlstm train {xlstm_train}; phase11 xlstm rounds {xlstm_rounds}")
    log(json.dumps({"kernels": entries}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
