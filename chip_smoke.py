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
     route; B5's non-causal mode (``causal=False``: only the window masks,
     Sq may exceed Sk, a row with no live key takes the reference kernel's
     value) on both forward routes, f32 and bf16, at ``NONCAUSAL_SHAPES``
     (self, Sq < Sk, Sq > Sk, windows, dead rows), timed at (4, 512, 32/8,
     128) beside SDPA's ``is_causal=False``; its backward on both routes,
     f32 and bf16, at ``NONCAUSAL_BWD_SHAPES`` (SeamlessM4T's encoder and
     cross-attention (4, 256, 16/16, 64), Sq < Sk, Sq > Sk, a window with
     every row live, head dim 80) against autograd of the plain version
     within the causal backward's bounds, bit-identical run to run, once
     through ``ops.flash_attention``, a call with a row that sees no key
     refused, timed at the encoder's shape beside SDPA's backward with
     ``is_causal=False``; B4 (fused cross-entropy) forward
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
     backward timed at B5's batched-LM shapes; B4, B5 (both modes, forward
     and backward) and B6 in bf16 at the shapes phases 12-17 hand them
     (``SLICE_ATTN``, ``SLICE_NONCAUSAL``, ``SLICE_DECODE``,
     ``SLICE_XENT``), each within the bounds above and tagged with its
     path, phase 20's B5 rows both ways also replayed beside the f32-FMA
     route (the tensor cores checked faster at each), and every bf16 call
     of phases 15-17 and 20 logged and held against that list
     (``_ShapeLog``); the wgmma routes' libraries hold HGMMA and UTMALDG
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
     T = 4, eval_every 4): block 1 and 4, each with prefetch 0 and 1, under
     the main path's cuDNN (the same decisions; the losses' spread and
     test_acc printed), then the four under deterministic cuDNN
     (decisions and test_acc equal, losses within rtol 1e-6); 640 B2, 640
     B3 and 4 B1 launches in each, ``RoundRunner.accept_block`` under
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
     runs' (the bit-equal float fields reported); phase 1 holds B1 at (10, 3000, 256) aliased, B2 at (960,
     256) and (640, 256) and B3 at (15, 64, 256) and (10, 64, 256);
  2f. the sharded placement (the cluster axis over an NCCL group of every
     visible card: in this process as a group of one where one card is
     visible, one spawned rank a card where more are): 2b's run through
     ``placement="sharded"`` (the sharded ``RoundRunner.accept`` under
     sync-debug "error") against 2b's History (decisions and comm exactly,
     val_losses within rtol 1e-5), SplitFed against 2c's batched run the
     same way, a 2-seed sweep (block 2) and a 2-job pool (block 2, prefetch
     1) against 2e's (losses within rtol 1e-4); every rank's History rank
     0's; B1, B2 and B3 launched as 2b's structure gives them; the NCCL
     version, the world size and s/round beside 2b's;
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
  6. the serve path: Qwen3-8B at full width, depth cut to SERVE_LAYERS (6
     of 36 layers, bf16, weights drawn on the card from a seed) prefills 4
     prompts of 480 tokens through ``make_prefill_step`` (6 B5 launches,
     all on the tensor-core route), then runs the
     reference serve loop through ``make_serve_step`` (the prompt stepped,
     then 32 greedy tokens: 512 steps, 3,072 B6 launches, all on the
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
     to 6 layers (3 client + 3 AP): ``run_pigeon`` (argmin, label flip on
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
     6 layers (block 1, block 2, Pigeon-SL+, int8: sel the argmin, every
     slot bit-equal to the winner, launches as predicted, seconds a round);
     batched SplitFed over the LM at 4 layers (cut 3: its 4 lanes at 12
     layers would not fit), decisions equal to the sequential run;
  8c. the launch layer's round over the sharded placement: 8b's 2-slot
     step at 6 layers through ``make_pigeon_round_step_shardmap`` on an
     NCCL group of every visible card (both slots on one card, one a rank
     on more), int8 and a block of 2, from 8b's inits: sel equal to
     ``make_pigeon_round_step``'s on the same inits and batches, vlosses
     within rtol 1e-5, every slot the winner, launches as the step's
     structure gives a rank's slots; seconds and peak memory beside the
     one-card step's;
  9. the xLSTM serve path: xLSTM-1.3B at full width, depth cut to
     XLSTM_SERVE_LAYERS (8 of 48 blocks: (mLSTM 7, sLSTM 1), bf16, drawn on
     the card) prefills 4 prompts of 512 tokens through
     ``make_prefill_step`` (1 B7 launch on the persistent route: 1
     persistent kernel and no step kernel in the profile), then runs the
     reference serve
     loop through ``make_serve_step`` (544 steps, no kernel of the port);
     the same weights widened to f32 and served again: prefill and decode
     logits agree within 1e-3 in f32, and the bf16 ones within 0.6 of each
     other and of the f32 logits (bf16 rounding compounds over the blocks
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
 11. the Pigeon-SL round over ``from_lm`` at xLSTM-1.3B's full width, depth
     cut to XLSTM_ROUND_LAYERS (16 blocks, cut 12: one sLSTM block on each
     side), phase 8's protocol, no wire and int8 under
     ``loss_plus_distance``, each on the sequential and the batched engine
     (the cluster-stacked xLSTM, B7 once a slot) from one init: decisions
     equal, the largest float gap reported, B7's launches as the round's
     cluster counts predict, seconds a round and peak memory;
 12. the vlm patch prefix: InternVL2-26B at full width and depth (48
     layers, bf16, 19,860,664,320 parameters drawn on the card) prefills 4
     x (256 patch embeddings drawn from a seed + 224 text tokens), 48 B5
     launches, profiled; the serve loop on text (a 32-token prompt stepped,
     32 greedy tokens; 48 B6 launches a step) against a text prefill; the
     train step at 24 of its 48 layers (theta and its gradient alone are 79
     GB at 48) on 4 x (256 patches + 256 tokens), remat, three SGD steps
     (48 B5 forwards, 24 backwards, one B4 each way a step), profiled; at 2
     layers in f32 the card's loss and prefill logits with patches against
     the CPU's;
 13. MLA and MoE: DeepSeek-V2-Lite (27 layers, 15,706,357,760 parameters;
     MLA, no attention kernel) and Qwen3-30B-A3B (48 layers,
     30,531,911,680; GQA through B5 and B6) served at full width and depth
     (a 4 x 480 prefill, profiled; the serve loop as phase 12's, on the MLA
     latent cache for DeepSeek); DeepSeek trained at full depth (4 x 512,
     remat, three SGD steps, B4 each way a step), the (token, k) pairs
     dropped past capacity at each MoE layer reported; at 3 and 2 layers
     in f32 each one's loss, prefill logits and routing ids on the card
     against the CPU's, and its prefill against its decode loop;
 14. the Pigeon-SL round over ``from_lm`` at DeepSeek-V2-Lite's width,
     depth cut to 6 layers (1 dense + 5 MoE, cut 3), phase 8's task and
     protocol, no wire and int8 under ``loss_plus_distance``, each on the
     sequential and the batched engine (the cluster-stacked MoE, a slot
     routed as its plain model) from one init: decisions equal, launches as
     the rounds' structure predicts, seconds a round and peak memory;
 15. Mamba2 and the hybrid: Zamba2-1.2B (38 Mamba2 layers and 6 shared
     attention blocks, 1,204,036,480 parameters) served at full width and
     depth (a 4 x 512 prefill, 6 B5 launches, profiled with the SSD chunk
     scan's share of the busy time; the serve loop, 6 B6 launches a step,
     against a text prefill within ZAMBA2_BF16_REL), trained at full depth
     (4 x 512, train_4k's ssm_chunk 512 and remat, three SGD steps: 12 B5
     forwards, 6 backwards, B4 on its tensor-core route each way a step),
     and at 4 Mamba2 layers in f32 its loss, every gradient and prefill
     logits on the card against the CPU's;
 16. the Pigeon-SL round over ``from_lm`` at Zamba2-1.2B's width, 13 Mamba2
     layers with the published cut at 10 (a shared block on each side),
     phase 8's task and runs (no wire, int8, int8 under
     ``loss_plus_distance``) on both engines from one init: decisions
     equal, launches as the rounds' structure predicts;
 17. the encoder-decoder: SeamlessM4T-medium (12 encoder and 12 decoder
     layers, 977,758,208 parameters) served at full width and depth (4 x
     256 frame embeddings drawn from a seed, a 4 x 256 prefill, the serve
     loop on their memory: 12 B6 and 12 non-causal B5 launches with Sq = 1
     a step), trained on 4 x (256 frames + 256 tokens) with remat (48
     non-causal and 24 causal B5 forwards, 24 and 12 backwards, B4 on its
     f32-FMA route at vocab 256,206, a step), and at 2 + 2 layers in f32
     against the CPU;
 18. the analysis layer on the card: (a) every ``repro_torch.analysis``
     program cell on CUDA tensors under ``set_sync_debug_mode("error")``,
     zero findings, each cell's and each driver cell's launches by kernel
     against the pinned ``@cuda`` rows of ``analysis/torch/budgets/``;
     (b) ``clip_by_global_norm`` and ``adamw(warmup_cosine(...),
     weight_decay > 0)`` three steps on SeamlessM4T-medium's gradients at
     full width, against the CPU on a sample of leaves with the largest
     (the updates within one bf16 ulp, m, v and the global norm within
     rtol 1e-5), its device time and the memory m and v add; (c) the dry
     run of that train step on the meta device: argument bytes equal to the
     card's parameters and batch, its temp-bytes estimate beside the card's
     peak, and the step's mfu.  Every train phase's warm step prints its
     mfu (``roofline.model_flops_for`` over the step's seconds at 989e12
     bf16 FLOP/s; nothing gates on it).  The kernels' bounds come from
     ``repro_torch.launch.roofline``;
 19. the data and model axes (``models/parallel.py``, ``launch/mesh.py``):
     Qwen3-8B at full width and 6 layers through the parallel model on an
     NCCL group of every visible card (prefill, the serve loop over the
     KV-sharded cache, a train step): on one card the group of one bit-equal
     to the plain model (logits, tokens, loss, every updated parameter), on
     n cards meshes (1, n) and (2, n / 2) within phase 6's bf16 bound of the
     one-card run; Qwen3-30B-A3B at full depth with ``moe_shard`` (phase
     13's weights on one card: a 4 x 512 prefill through the 16-group
     local dispatch, pairs dropped a group; experts over every card on n);
     8c's 2-slot int8 round step over (pod, data, model); B4 on a
     vocab-parallel panel (2,048 x 4,096 x 37,984) against its plain
     versions, on the tensor cores; on one card two gloo ranks on it tried;
 20. the three dense configurations no earlier phase ran (DENSE_FAMILIES):
     Gemma3-12B (head dim 256, the 5:1 local:global windows of 1,024,
     vocab 262,144), H2O-Danube-1.8B (head dim 80, a 4,096 window) and
     Qwen2.5-14B (40 query heads over 8, QKV bias), each at full width and
     depth in bf16 with weights drawn on the card (parameter counts and
     bytes beside the card's name and power limit): a prefill whose prompt
     outruns the window (2 x 2,048, 1 x 6,144, 4 x 480), the decode cache
     given the prefill's keys and values, the serve loop from the prompt's
     last position through 16 greedy tokens, its logits there against the
     prefill's; launches per counter and route as ``_dense_want`` plans
     them from the config (B5 both ways and B6 on the tensor cores at
     every head dim, 80 and 256 too); prefill and decode profiled with
     each route's share where an f32-FMA route runs, and Danube's prefill,
     both train steps and both decode steps always (``ALWAYS_PROFILED``:
     B5's and B6's shares by route); a train step at train_4k cut
     to 4 x 512 (full depth), its mfu, peak and profile; a few layers in f32 (Gemma3's a local and a global one) the
     kernel path against the plain path; the Pigeon-SL round over Danube
     at full depth (cut 6) on both engines, decisions equal.  Every bf16
     B4, B5 and B6 call of the phase at a shape phase 1 checked
     (``_ShapeLog``);
 and then ``examples_torch/quickstart.py`` and ``serve_decode.py`` on the
 card, each a subprocess, together: a non-zero exit fails the run.  Phase 0
 also prints the kernel-library cache's figures (``compile_cache_stats``).

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

# attention: (B, S, H, Hkv, D, window) for B5, (..., index) for B6; the serve
# path's shapes first (Qwen3-8B: 32 query and 8 KV heads of 128; a 480-token
# prompt, a 512-position cache), then MQA, groups 1, windows, head dims
# 64/80/256 and ragged S, S = 1; then head dim 80 (the padded depth) with a
# window over a ragged S and GQA group 4, and head dim 256 (the backward's
# 64-key blocks) with group 2 over a ragged S (ATTN_BWD_SHAPES takes them
# too); B6's last three take windows on the tensor-core route (bf16 at head
# dims 128 and 64, a window wider than the live range)
FLASH_SHAPES = ((4, 480, 32, 8, 128, 0), (2, 128, 8, 1, 64, 0), (2, 96, 4, 4, 64, 0),
                (1, 480, 8, 2, 128, 64), (2, 37, 4, 2, 80, 0), (1, 300, 16, 8, 256, 128),
                (1, 1, 4, 2, 64, 0), (1, 299, 8, 2, 80, 96), (2, 130, 8, 4, 256, 0))
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
# B6's partial mode (a rank's panel of a sequence-sharded cache): each
# shape's cache split into each G of PARTIAL_SPLITS panels (the last padded
# with zeros, as Model.init_cache pads it): phase 19's batch-1 decode
# (Qwen3-8B's heads, TP_PROMPT + TP_NEW positions, the main path's shape),
# phase 6's serve shape, the 32k shape, Gemma3-12B's head dim 256 with its
# 1,024-token window and H2O-Danube's head dim 80 with its 4,096 (both on
# the tensor cores, the f32-FMA route beside them); 16 panels leave some
# with no live key at every shape
PARTIAL_SHAPES = ((1, 40, 32, 8, 128, 0, 39), (4, 512, 32, 8, 128, 0, 479), DECODE_LONG,
                  (2, 4096, 16, 8, 256, 1024, 4000), (2, 4096, 32, 8, 80, 4096, 3000))
PARTIAL_SPLITS = (2, 16)
ATTN_ATOL = {"float32": 2e-5, "bfloat16": 2e-2}
# B5's non-causal mode: (B, Sq, Sk, H, Hkv, D, window): self-attention at
# the serve shape's heads (timed), a cross shape with Sq < Sk and one with
# Sq > Sk, windows (keys ahead of the query live) with rows that see no key
# (Sq > Sk + window - 1), head dims 64/80/256, ragged S, and SeamlessM4T's
# decode step (one query against 256 frames of memory, 16/16 heads of 64);
# last, head dim 80 with Sq < Sk, GQA group 4, ragged
NONCAUSAL_SHAPES = ((4, 512, 512, 32, 8, 128, 0), (2, 384, 640, 16, 4, 128, 0),
                    (2, 640, 256, 16, 4, 64, 0), (2, 512, 256, 8, 2, 128, 64),
                    (1, 200, 130, 4, 1, 256, 16), (1, 37, 5, 4, 2, 80, 0),
                    (1, 300, 300, 8, 8, 64, 32), (4, 1, 256, 16, 16, 64, 0),
                    (2, 70, 133, 8, 2, 80, 0))
NONCAUSAL_TIMED = 4             # the first four are timed
# B5's non-causal backward: (B, Sq, Sk, H, Hkv, D, window): SeamlessM4T's
# encoder self-attention (16 heads of 64, 256 frames; timed) and its
# decoder's cross-attention (256 tokens against 256 frames) share a shape;
# then an Sq < Sk and an Sq > Sk edge (GQA, head dim 128), a window with
# every row live (Sq < Sk + window), head dim 80 (the padded depth) with
# ragged S, head dim 256 (64-key blocks) with Sq > Sk and a window
NONCAUSAL_BWD_SHAPES = ((4, 256, 256, 16, 16, 64, 0), (2, 100, 300, 8, 2, 128, 0),
                        (2, 300, 130, 8, 4, 128, 0), (1, 200, 160, 8, 4, 64, 48),
                        (1, 37, 50, 4, 2, 80, 0), (1, 150, 100, 4, 2, 256, 64))
# at DECODE_LONG a typical |out| is about sqrt(e / 32,768) = 0.009 (N(0, 1)
# inputs over 32k live keys), under the bf16 atol itself: there the bf16
# bound is this share of the call's largest |plain| value (~5 bf16 ulps of it)
LONG_BF16_REL = 2e-2
# phase 6: Qwen3-8B served at B = 4, 480 prompt tokens, 32 new ones, at 6
# of its 36 layers (the serve loop steps every prompt token, so its time
# grows with depth and the whole script must stay within its time limit)
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 4, 480, 32
SERVE_LAYERS = 6
# prefill vs decode logits at the prompt's last position, the largest
# difference relative to the largest |logit|.  bf16: each path rounds every
# activation to 8 significant bits (2^-9 = 2e-3 relative) at different
# points of 36 residual layers, and the two add up like a random walk
# (sqrt(2 * 36) * 2e-3 = 1.7e-2 at Qwen3-8B's full depth); the bound
# leaves 3x above that.  f32 at
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
# step rounds away in bf16); the round's depth cut to 6 layers for the time
# limit, its cut at 3 (3 client + 3 AP; the published cut, 9, needs more)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_VOCAB, TRAIN_LR = 4, 512, 2048, 0.1
TRAIN_F32_REL = 1e-4
ROUND_LAYERS, ROUND_CUT = 6, 3
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
# 256), 32 new tokens, at 8 of its 48 blocks (one (mLSTM 7, sLSTM 1) unit;
# the serve loop steps every prompt token, so its time grows with depth and
# the whole script must stay within its time limit); phase 10
# holds the full model's 3,529,644,368 parameters (the reference's layer
# count).  Prefill vs decode logits at the prompt's last position.  The
# tight check runs the same weights widened to f32 (1 B7 launch): the
# chunked and the recurrent form of the same f32 math, 1e-3.  In bf16 the
# rounding does not stay a random walk as in Qwen3-8B (SERVE_BF16_REL): at
# this random init the blocks compound it, stack after stack, so at 48
# blocks each bf16 path lands some 0.3 of max |logit| from the f32 logits
# (a first run read 0.277 between the two bf16 paths).  The reference does the same:
# at d_model 64 and full depth on the CPU its own bf16 logits lie 0.54 of
# max |logit| from its f32 logits, and the port's as far from theirs
# (tests/test_torch_xlstm.py's full-depth bf16 tests).  The bf16 paths are held
# within 0.6 of each other and of the f32 logits: the sum of two such
# errors; a path that computed another function (another gate layout, a
# lost chunk carry) moves the logits by their own scale.  The longer
# prefill takes prefill_32k's settings (ssm_chunk 2,048) at full depth (one
# call: 6 B7 launches), its 32 x 32,768 tokens cut to 4 x 2,048.
XLSTM_BATCH, XLSTM_PROMPT, XLSTM_NEW = 4, 512, 32
XLSTM_SERVE_LAYERS = 8
XLSTM_PARAMS = 3_529_644_368
XLSTM_BF16_REL = 0.6
XLSTM_F32_REL = 1e-3
XLSTM_LONG_PROMPT = 2048
# the xLSTM prefills' device time, by kernel name
PREFILL_SHARES = {"B7 (slstm_scan_persistent)": ["slstm_scan_persistent"],
                  "f32 products (the mLSTM einsums)": ["sgemm", "f32f32", "f32_f32"],
                  "bf16 products (projections, head)": ["bf16", "nvjet"]}
# phase 11: the Pigeon-SL round over xLSTM-1.3B at 16 of its 48 blocks (cut
# 12: an sLSTM block on each side; the time limit, as phase 9), no wire and
# int8 under loss_plus_distance, each on both engines
XLSTM_ROUND_LAYERS = 16
XLSTM_ROUND_RUNS = ((None, "argmin"), ("int8", "loss_plus_distance"))
# phases 12-14.  InternVL2-26B (configs/internvl2_26b.py, arXiv:2404.16821):
# served at full width and depth, its prefill 4 x (256 patch embeddings +
# 224 text tokens) = 480 positions; trained at 24 of its 48 layers (theta
# and its gradient alone are 79 GB at 48), 4 x (256 patches + 256 tokens);
# its f32 check at 2 layers on 1 x (64 patches + 32 tokens).  DeepSeek-V2-Lite
# (arXiv:2405.04434) and Qwen3-30B-A3B (hf:Qwen/Qwen3-30B-A3B) served at
# full width and depth (4 x 480 prefills); DeepSeek trained at full depth
# (theta and its gradient 63 GB); their f32 checks at 3 and 2 layers on 1 x
# 128 tokens.  The serve loops step a SLICE_PROMPT-token text prompt and
# decode SLICE_NEW greedy tokens.  The round over DeepSeek at 6 layers
# (1 dense + 5 MoE; cut 3): 3,424,649,216 parameters besides the norms,
# a 12-layer Qwen3-8B's size.
VLM_ARCH, VLM_PARAMS, VLM_TEXT = "internvl2-26b", 19_860_664_320, 224
VLM_TRAIN_LAYERS = 24
VLM_F32_LAYERS, VLM_F32_PATCHES, VLM_F32_TEXT = 2, 64, 32
DSV2_PARAMS, QMOE_PARAMS = 15_706_357_760, 30_531_911_680
DSV2_TRAIN_LAYERS = 27
DSV2_F32_LAYERS, QMOE_F32_LAYERS, MOE_F32_TOKENS = 3, 2, 128
SLICE_PROMPT, SLICE_NEW = 32, 32
MOE_ROUND_LAYERS, MOE_ROUND_CUT = 6, 3
MOE_ROUND_RUNS = ((None, "argmin"), ("int8", "loss_plus_distance"))
# phases 15-17.  Zamba2-1.2B (configs/zamba2_1_2b.py, arXiv:2411.15242; 38
# Mamba2 layers, a shared attention block after every 6 of them: 32 heads of
# 64, all KV heads; 1,204,036,480 parameters by the reference's layers, each
# of the 6 blocks with its own): served at full width and depth, its prefill
# 4 x 512 (the decode settings keep ssm_chunk 256, which must divide the
# sequence), the serve loop as phase 12's; trained at full depth on 4 x 512
# under train_4k's settings (ssm_chunk 512, remat); its f32 check at 4 Mamba2
# layers with attn_every 2 (Mamba2 2, a block, Mamba2 2) on 1 x 128 tokens.
# The round over it at ZAMBA2_ROUND_LAYERS Mamba2 layers (Mamba2 6, a block,
# 6, a block, 1) with the published cut at 10: the client holds Mamba2 6, a
# block and Mamba2 3, the AP Mamba2 3, a block and Mamba2 1.
# SeamlessM4T-medium (configs/seamless_m4t_medium.py, arXiv:2308.11596; 12
# encoder and 12 decoder layers, 16 heads of 64, vocab 256,206; 977,758,208
# parameters): served at full width and depth, 4 x 256 frame embeddings
# drawn from a seed, a 4 x 256 prefill, the serve loop on their memory (Sk
# 256); trained on 4 x (256 frames + 256 tokens), remat; its f32 check at 2 +
# 2 layers on 1 x (64 frames + 128 tokens)
ZAMBA2_ARCH, ZAMBA2_PARAMS, ZAMBA2_PROMPT = "zamba2-1.2b", 1_204_036_480, 512
ZAMBA2_F32 = dict(n_layers=4, attn_every=2)
ZAMBA2_ROUND_LAYERS, ZAMBA2_ROUND_CUT = 13, 10
SEAMLESS_ARCH, SEAMLESS_PARAMS = "seamless-m4t-medium", 977_758_208
SEAMLESS_FRAMES, SEAMLESS_TOKENS = 256, 256
SEAMLESS_F32 = dict(n_layers=2, n_enc_layers=2)
SEAMLESS_F32_FRAMES = 64
SLICE_F32_TOKENS = 128
# the range chip_smoke opens around each SSD chunk (models/ssm.py::_ssd_chunk)
# while it profiles a Zamba2 path: the kernels launched within it are the
# SSD's share of the busy time
SSD_RANGE = "mamba2.ssd_chunk"
# Zamba2's bf16 prefill vs decode logits: the two paths round Mamba2 at
# different points (the prefill's causal convolution four bf16 products and
# sums a position, the decode's one product over the window; the projections
# of a sequence and of one token), and at random init that compounds over
# 38 layers more than the dense layers' rounding does (SERVE_BF16_REL): on
# the CPU at 38 layers, d 256 and 512, each bf16 path lay 0.040-0.062 of
# max |logit| from the same weights' f32 logits and the two 0.042-0.059
# from each other (the f32 paths 2e-6 apart).  The bound holds two such
# errors with a margin; phase 15's f32 check holds the two paths within
# SERVE_F32_REL
ZAMBA2_BF16_REL = 0.2
# bf16 prefill vs decode logits of a MoE differ by more than rounding: a
# token whose k-th and (k+1)-th router probabilities lie within the two
# paths' roundings of each other takes another expert on the other path,
# and the prefill drops (token, k) pairs past its experts' capacity where
# a decode step (B <= 8 tokens, capacity 8) drops none.  So the prefill is
# rerun with each MoE layer's ids pinned to the decode loop's and every
# pair kept (_Routing): the two paths then compute one function, held at
# the dense bound (SERVE_BF16_REL); the flips and drops of the unpinned
# prefill are counted and reported beside its gap.  f32 at full width and
# a cut depth, card against CPU: the summation order only, and every
# routing id and kept pair equal
SLICE_F32_REL = 1e-3
# f32 gradients, card against CPU (phases 15 and 17), each leaf on its own
# scale within TRAIN_F32_REL, but for Mamba2's A_log: its gradient sums
# dt * A * (...) over every position, head dim and state entry of its head,
# terms that mostly cancel, so the sum keeps the rounding of the large ones.
# A float64 copy of the model on the CPU (_F64) is the third witness: on the
# CPU at d 256, 4 Mamba2 layers and 128 tokens, f32 against it read
# 4.5e-5-6.8e-5 at A_log, 1.2e-5 at dt_bias and under 2.6e-6 elsewhere; at
# full width on an H100 80GB HBM3 (700 W) the card against the CPU read
# 1.31e-4 at one A_log and under 1e-5 elsewhere.  So A_log alone is held at
# A_LOG_GRAD_REL, card against CPU and card against float64
A_LOG_GRAD_REL = 1e-3
# phase 20: the three dense configurations no earlier phase ran on the card,
# each served at full width and depth in bf16 with weights drawn on the card:
# Gemma3-12B (configs/gemma3_12b.py; hf:google/gemma-3-1b-pt's family card,
# 12B: 48 layers, d 3,840, 16 query and 8 KV heads of 256, qk-norm, a
# 1,024-token window on 5 layers of every 6, vocab 262,144), H2O-Danube-1.8B
# (arXiv:2401.16818: 24 layers, d 2,560, 32/8 heads of 80, a 4,096 window,
# vocab 32,000) and Qwen2.5-14B (hf:Qwen/Qwen2.5-0.5B's family card, 14B: 48
# layers, d 5,120, 40/8 heads of 128, a GQA group of 5, QKV bias, vocab
# 152,064).  The prompts (batch, length) outrun the windows, so the windows
# cut keys in the prefill and in decode: Gemma3 2 x 2,048, Danube 1 x 6,144,
# Qwen2.5 phase 6's 4 x 480.  The reference's serve loop steps every prompt
# position (2,064 and 6,160 decode steps of 48 and 24 layers: past the
# script's time limit), so the decode cache takes the prefill's keys and
# values of the prompt's first positions (_KVCapture) and the loop steps
# the last prompt position, then DENSE_NEW greedy tokens.  Trained at
# train_4k cut to TRAIN_BATCH x TRAIN_SEQ at train_layers (full depth:
# Qwen2.5-14B's theta and gradient are 59 GB); the f32 kernel path against
# the plain path at f32_layers (Gemma3's 6: five local layers and the first
# global one) on 1 x f32_tokens (past the window: Gemma3 1,280, Danube
# 4,352).  The round over Danube at full depth with its published cut at 6
DENSE_FAMILIES = {
    "gemma3-12b": dict(label="gemma3", params=12_771_655_680, serve=(2, 2048),
                       train_layers=48, f32_layers=6, f32_tokens=1280),
    "h2o-danube-1.8b": dict(label="danube", params=1_831_075_840, serve=(1, 6144),
                            train_layers=24, f32_layers=2, f32_tokens=4352),
    "qwen2.5-14b": dict(label="qwen25", params=14_769_192_960, serve=(4, 480),
                        train_layers=48, f32_layers=2, f32_tokens=128)}
DENSE_NEW = 16
DANUBE_ARCH = "h2o-danube-1.8b"
# phase 1 at the slice's own shapes (_phase_slice_shapes), bf16: B5 forward
# and backward at InternVL2-26B's heads (48 query, 8 KV of 128) at its
# prefill's 480 and its train step's 512 positions, and at Qwen3-30B-A3B's
# (32 and 4) at its 480; at Zamba2-1.2B's shared blocks (32/32 of 64) at its
# prefill's and train step's 4 x 512, the serve loop's text prefill (4 x
# SLICE_PROMPT) and the round's 1, 4, 8 (the batched engine's R * B folded
# sequences, a backward too) and 16 sequences of 512; at SeamlessM4T-
# medium's decoder (16/16 of 64), causal, at 4 x 256 and 4 x SLICE_PROMPT;
# B5 non-causal at SeamlessM4T's encoder and cross-attention (4 x 256 against
# 256 frames, forward and backward), the loop's text prefill against them
# (Sq SLICE_PROMPT) and its decode steps' cross-attention (Sq 1); B6 at the
# four head layouts over the serve loops' 64-slot caches (B 4, SLICE_PROMPT
# + SLICE_NEW) at the first, middle and last index; B4 forward and backward
# at InternVL2-26B's train head (4 x 256 text tokens: the loss drops the 256
# patch positions; d 6,144, vocab 92,553 on the f32-FMA route), the same at
# 2,048 rows, DeepSeek-V2-Lite's (4 x 512 tokens, d 2,048, vocab 102,400,
# tensor cores), Zamba2's train head (4 x 512, d 2,048, vocab 32,000,
# tensor cores) and its round's evaluation heads (4,096 and 512 rows, the
# forward only on the path), and SeamlessM4T's (4 x 256 text tokens, d
# 1,024, vocab 256,206 on the f32-FMA route).  Each names the path whose
# launches it stands for (None: on no path), forward and backward apart
SLICE_ATTN = (((4, 480, 48, 8, 128, 0), "vlm_prefill", None),
              ((4, 512, 48, 8, 128, 0), "vlm_train", "vlm_train"),
              ((4, 480, 32, 4, 128, 0), "qmoe_prefill", None),
              ((4, ZAMBA2_PROMPT, 32, 32, 64, 0), "zamba2_prefill", "zamba2_train"),
              ((4, SLICE_PROMPT, 32, 32, 64, 0), "zamba2_serve_loop", None),
              ((1, 512, 32, 32, 64, 0), "zamba2_round_sequential_None_argmin", None),
              ((8, 512, 32, 32, 64, 0), "zamba2_round_batched_None_argmin",
               "zamba2_round_batched_None_argmin"),
              ((16, 512, 32, 32, 64, 0), "zamba2_round_batched_None_argmin", None),
              ((4, SEAMLESS_TOKENS, 16, 16, 64, 0), "seamless_prefill", "seamless_train"),
              ((4, SLICE_PROMPT, 16, 16, 64, 0), "seamless_serve_loop", None))
SLICE_NONCAUSAL = (((4, SEAMLESS_TOKENS, SEAMLESS_FRAMES, 16, 16, 64, 0), "seamless_prefill",
                    "seamless_train"),
                   ((4, SLICE_PROMPT, SEAMLESS_FRAMES, 16, 16, 64, 0), "seamless_serve_loop",
                    None),
                   ((4, 1, SEAMLESS_FRAMES, 16, 16, 64, 0), "seamless_serve_loop", None))
SLICE_DECODE = tuple(((4, SLICE_PROMPT + SLICE_NEW, h, hkv, d, 0, i), path)
                     for h, hkv, d, path in ((48, 8, 128, "vlm_serve_loop"),
                                             (32, 4, 128, "qmoe_loop"),
                                             (32, 32, 64, "zamba2_serve_loop"),
                                             (16, 16, 64, "seamless_serve_loop"))
                     for i in (0, (SLICE_PROMPT + SLICE_NEW) // 2 - 1,
                               SLICE_PROMPT + SLICE_NEW - 1))
SLICE_XENT = (((1024, 6144, 92553), "vlm_train", "vlm_train"),
              ((2048, 6144, 92553), None, None),
              ((2048, 2048, 102400), "dsv2_train", "dsv2_train"),
              ((2048, 2048, 32000), "zamba2_train", "zamba2_train"),
              ((4096, 2048, 32000), "zamba2_round_sequential_None_argmin", None),
              ((512, 2048, 32000), "zamba2_round_batched_None_argmin", None),
              ((4 * SEAMLESS_TOKENS, 1024, 256206), "seamless_train", "seamless_train"))
# phase 20's own shapes (DENSE_FAMILIES), bf16: B5 forward at each prefill
# (Gemma3's 2 x 2,048 under its 1,024 window and its global layers' none,
# Danube's 1 x 6,144 under its 4,096, Qwen2.5's 4 x 480 at its 40/8 heads)
# and, with its backward, at each train step's TRAIN_BATCH x TRAIN_SEQ; the
# Danube round's 1, 8 (the batched engine's R * B folded sequences, a
# backward too) and 16 sequences of TRAIN_SEQ; B6 over each serve loop's
# cache (prompt + DENSE_NEW positions) at the loop's first and last index;
# B4 forward and backward at each train head (TRAIN_BATCH x TRAIN_SEQ rows:
# d 3,840 x vocab 262,144, d 2,560 x 32,000, d 5,120 x 152,064) and the
# Danube round's evaluation heads (4,096 and 512 rows, the forward only)
SLICE_ATTN += (((2, 2048, 16, 8, 256, 1024), "gemma3_prefill", None),
               ((2, 2048, 16, 8, 256, 0), "gemma3_prefill", None),
               ((TRAIN_BATCH, TRAIN_SEQ, 16, 8, 256, 1024), "gemma3_train", "gemma3_train"),
               ((TRAIN_BATCH, TRAIN_SEQ, 16, 8, 256, 0), "gemma3_train", "gemma3_train"),
               ((1, 6144, 32, 8, 80, 4096), "danube_prefill", None),
               ((TRAIN_BATCH, TRAIN_SEQ, 32, 8, 80, 4096), "danube_train", "danube_train"),
               ((1, TRAIN_SEQ, 32, 8, 80, 4096), "danube_round_sequential", None),
               ((8, TRAIN_SEQ, 32, 8, 80, 4096), "danube_round_batched", "danube_round_batched"),
               ((16, TRAIN_SEQ, 32, 8, 80, 4096), "danube_round_batched", None),
               ((4, 480, 40, 8, 128, 0), "qwen25_prefill", None),
               ((TRAIN_BATCH, TRAIN_SEQ, 40, 8, 128, 0), "qwen25_train", "qwen25_train"))
SLICE_DECODE += tuple(((b, p + DENSE_NEW, h, hkv, d, w, i), path)
                      for b, p, h, hkv, d, w, path in (
                          (2, 2048, 16, 8, 256, 1024, "gemma3_loop"),
                          (2, 2048, 16, 8, 256, 0, "gemma3_loop"),
                          (1, 6144, 32, 8, 80, 4096, "danube_loop"),
                          (4, 480, 40, 8, 128, 0, "qwen25_loop"))
                      for i in (p - 1, p + DENSE_NEW - 1))
SLICE_XENT += (((TRAIN_BATCH * TRAIN_SEQ, 3840, 262144), "gemma3_train", "gemma3_train"),
               ((TRAIN_BATCH * TRAIN_SEQ, 2560, 32000), "danube_train", "danube_train"),
               ((4096, 2560, 32000), "danube_round_sequential", None),
               ((512, 2560, 32000), "danube_round_batched", None),
               ((TRAIN_BATCH * TRAIN_SEQ, 5120, 152064), "qwen25_train", "qwen25_train"))
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
    import os
    import shutil
    import tempfile

    from repro_torch.kernels import build
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    # one cuobjdump a library, all started together, each writing a file
    # (a pipe would stall a dump until its turn to be read)
    counts, procs = {}, {}
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        try:
            for name in build.SOURCES:
                with open(os.path.join(tmp, name + ".sass"), "w") as out:
                    procs[name] = subprocess.Popen(
                        [tool, "--dump-sass", str(build.library_path(name))], stdout=out,
                        stderr=subprocess.STDOUT)
            for name, proc in procs.items():
                code = proc.wait(timeout=300)
                with open(os.path.join(tmp, name + ".sass")) as f:
                    sass = f.read()
                check(code == 0, f"phase0: cuobjdump {name} exited {code}: {sass[-500:]}")
                counts[name] = {op: len(re.findall(rf"\b{op}\b", sass)) for op in SASS_OPS}
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
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

#: the longest a timing sample runs (µs): a slower function takes fewer reps
SAMPLE_US = 20_000.0


def _one_call_us(fn, stream=None) -> float:
    """One call of ``fn`` by CUDA events on ``stream`` (the current one)."""
    import torch
    stream = stream or torch.cuda.current_stream()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with torch.cuda.stream(stream):
        start.record(stream)
        fn()
        end.record(stream)
    end.synchronize()
    return start.elapsed_time(end) * 1e3


def _fit_reps(reps: int, call_us: float) -> int:
    """``reps``, cut so that ``reps`` calls of ``call_us`` take at most
    SAMPLE_US (at least one call)."""
    return max(1, min(reps, int(SAMPLE_US / max(call_us, 1e-3))))


def _time_us(fn, *args, reps: int = 200, samples: int = 15, warmup: int = 10) -> float:
    """Median over ``samples`` of the mean time of ``reps`` back-to-back
    calls, by CUDA events (after ``warmup`` calls, at most ``reps``; a
    function slower than SAMPLE_US / ``reps`` takes fewer reps)."""
    import torch
    for _ in range(min(warmup, reps)):
        fn(*args)
    torch.cuda.synchronize()
    reps = _fit_reps(reps, _one_call_us(lambda: fn(*args)))
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


def _graph_times_us(fns, reps: int = 100, samples: int = 15, stream=None):
    """Device time per call of each of ``fns``: ``reps`` calls of each
    captured in a CUDA graph of its own, so the host's per-call cost drops
    out (fewer where the slowest call of ``fns`` is over SAMPLE_US /
    ``reps``), and the graphs replayed in turn ``samples`` times, so a change
    in the card's speed during the run falls on all of them alike.  The sorted
    per-call times of each.  ``stream``: the stream to warm up and capture
    on (an autograd backward runs on its forward's stream, so a backward
    is captured on the stream its forward ran on)."""
    import torch
    side = stream or torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in fns:
            for _ in range(3):
                fn()
    reps = _fit_reps(reps, max(_one_call_us(fn, side) for fn in fns))
    torch.cuda.current_stream().wait_stream(side)
    graphs = []
    for fn in fns:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
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
    from repro_torch.launch import roofline as rl

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
            bound_us, bound_by = rl.bound_us(
                rl.quant_dequant_stats_work(rows, d, rows // n) if stats
                else rl.quant_dequant_work(rows, d))
            timing = dict(kernel_us=kernel_us, plain_us=plain_us,
                          kernel_dev_us=kernel_dev_us, plain_dev_us=plain_dev_us,
                          kernel_cold_us=kernel_cold_us, bound_us=bound_us, bound_by=bound_by)
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
    results["decode_attention"]["partial"] = _phase_decode_partial()
    results["flash_attention"]["non_causal"] = _phase_attention_non_causal()
    results.update(_phase_attention_bwd())
    results["flash_attention_bwd"]["non_causal"] = _phase_attention_bwd_non_causal()
    for name, t in _phase_lm_batched_shapes().items():
        results[name]["lm_batched"] = t
    for name, cases in _phase_slice_shapes().items():
        results[name]["slice_shapes"] = cases
    results["slstm_scan"] = _phase_slstm()
    results["slstm_scan_bwd"] = _phase_slstm_bwd()
    return results


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
    from repro_torch.launch import roofline as rl

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
        bound, by = rl.bound_us(rl.quant_dequant_stats_work(rows, d, rows // shape[-2])
                                if len(got) == 3 else rl.quant_dequant_work(rows, d))
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
    bound, by = rl.bound_us(rl.flash_attention_work(b, s, s, h, hkv, d, window))
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
    bound, by = rl.bound_us(rl.flash_attention_bwd_work(b, s, s, h, hkv, d, window))
    out["flash_attention_bwd"] = dict(
        shape=list(LM_BATCHED_ATTN), max_rel_err=err, kernel_us=_time_us(call, **few),
        kernel_dev_us=_graph_time_us(call, **few), kernel_cold_us=_cold_time_us(call, reps=10),
        plain_us=_time_us(lambda: torch.autograd.grad(plain_out, (qq, kk, vv),
                                                      grad_outputs=dout, retain_graph=True),
                          reps=3, samples=3),
        library_us=_time_us(lib_bwd, reps=5, samples=5), bound_us=bound, bound_by=by)
    for name, t in out.items():
        lib_us = ("none" if "library_us" not in t else f"{t['library_us']:.3f} eager" + (
            f", {t['library_dev_us']:.3f} replayed" if "library_dev_us" in t else ""))
        log(f"phase1 {name} at {t['shape']} (the batched LM round): kernel_us="
            f"{t['kernel_us']:.3f} plain_us={t['plain_us']:.3f} bound_us={t['bound_us']:.4f} "
            f"({t['bound_by']}); replayed kernel_us={t['kernel_dev_us']:.3f}; L2-cold "
            f"kernel_us={t['kernel_cold_us']:.3f}; SDPA{' backward' if 'bwd' in name else ''} "
            f"{lib_us}")
    return out


def _sdpa(q, k, v, window: int, index=None):
    """The one PyTorch call that computes B5's (``index`` None) or B6's
    function on these tensors, for the record: ``scaled_dot_product_attention``
    over (B, H, S, D) views with GQA, causal where no window applies, else
    with an explicit boolean mask (query i sees key j where j <= i and i - j
    < window); for B6 the query at ``index`` over the cache's keys up to
    it."""
    import torch
    import torch.nn.functional as F
    if index is not None:
        k, v = k[:, :index + 1], v[:, :index + 1]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    if not window:
        return lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=index is None,
                                                      enable_gqa=True)
    rows = (torch.arange(q.shape[1], device=q.device) if index is None
            else torch.full((1,), index, device=q.device))
    cols = torch.arange(k.shape[1], device=q.device)
    mask = (cols[None, :] <= rows[:, None]) & (rows[:, None] - cols[None, :] < window)
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                  enable_gqa=True)


#: B4's rows on the f32-FMA route (a vocab not a multiple of 8) that phase 1
#: times beside the yardsticks of phase 20's rows: InternVL2-26B's and
#: SeamlessM4T's train heads
XENT_TIMED = {"vlm_train", "seamless_train"}


def _dense_path(path) -> bool:
    """Whether ``path`` is one of phase 20's (DENSE_FAMILIES' labels)."""
    return path is not None and path.split("_")[0] in {
        fam["label"] for fam in DENSE_FAMILIES.values()}


def _phase_slice_shapes() -> dict:
    """Phases 12-17's and 20's own shapes in phase 1, bf16, each on the
    route its path takes: B5's forward within ATTN_ATOL of the plain
    version and its backward within GRAD_REL of autograd of it, causal
    (SLICE_ATTN) and not (SLICE_NONCAUSAL); B6 within ATTN_ATOL
    (SLICE_DECODE); B4's loss and lse within XENT_ATOL and its backward
    within GRAD_REL, on _xent_grad_err's four scales (SLICE_XENT).  Each
    with its route, the counter its path's launches fall under, its error,
    one eager time and its ``_ShapeLog`` key; phase 20's rows also with
    the plain version's eager time (a backward's: autograd's backward of
    it), the bound (``launch/roofline.py``) and the library call's
    (``_sdpa``, its backward through autograd; B4's
    ``F.cross_entropy(h @ W)``, and through autograd) and the kernel's
    replayed device time (B4's also at XENT_TIMED's heads); phase 20's B5
    rows, both ways, and B6 rows also with the f32-FMA route's eager and
    replayed times beside it (``beside_fma``), the tensor cores checked
    faster; every B6 row bit-identical run to run, phase 20's also timed
    with the L2 cold."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_xent as fx
    from repro_torch.launch import roofline as rl

    few = dict(reps=3, samples=3)
    out = {name: [] for name in ("flash_attention", "flash_attention_bwd", "decode_attention",
                                 "fused_xent", "fused_xent_bwd")}

    def note(name, shape, path, route, err, us, key, rel=False, causal=True, extra=None):
        counter = (name + ("_tc" if route == "tensor_cores" else "")
                   + ("" if causal else "_noncausal"))
        out[name].append(dict(shape=list(shape), path=path, route=route, counter=counter,
                              kernel_us=us, key=key, causal=causal,
                              **{"max_rel_err" if rel else "max_abs_err": err},
                              **(extra or {})))

    once = dict(reps=1, samples=3, warmup=1)

    def yardsticks(work, plain, lib, call=None):
        """Phase 20's figures beside a row's kernel time: the plain
        version's and the library call's eager times (the median of three
        single calls), the bound and, given the kernel's ``call``, its
        replayed device time."""
        bound_us, bound_by = rl.bound_us(work)
        out = dict(plain_us=_time_us(plain, **once), bound_us=bound_us, bound_by=bound_by,
                   library_us=None if lib is None else _time_us(lib, **once))
        if call is not None:
            out["kernel_dev_us"] = _median(_graph_times_us([call], reps=3, samples=3)[0])
        return out

    def beside_fma(call, old, what, reps=3, samples=3):
        """The kernel's replayed device time and the f32-FMA route's eager
        and replayed ones (the two graphs of ``reps`` calls replayed in turn
        ``samples`` times); fails unless the tensor cores' is the shorter."""
        dev, fma_dev = map(_median, _graph_times_us([call, old], reps=reps, samples=samples))
        check(dev < fma_dev, f"{what}: the tensor-core route ({dev:.1f} us replayed) is not "
                             f"faster than the f32-FMA route ({fma_dev:.1f} us)")
        return dict(kernel_dev_us=dev,
                    f32_fma_route=dict(kernel_us=_time_us(old, **once), kernel_dev_us=fma_dev))

    def draw(shape, seed):
        b, sq, sk, h, hkv, d, _ = shape
        g = torch.Generator(device=DEVICE).manual_seed(seed)
        return tuple(torch.randn(dims, generator=g, device=DEVICE).to(torch.bfloat16)
                     for dims in ((b, sq, h, d), (b, sk, hkv, d), (b, sk, hkv, d)))

    cases = ([(shape, True, path, bwd_path, 300 + i)
              for i, (shape, path, bwd_path) in enumerate(SLICE_ATTN)]
             + [(shape, False, path, bwd_path, 340 + i)
                for i, (shape, path, bwd_path) in enumerate(SLICE_NONCAUSAL)])
    for shape, causal, path, bwd_path, seed in cases:
        if causal:
            (q, k, v), kw = _attention_args("flash_attention", shape, "bfloat16", seed=seed)
            b, s, h, hkv, d, window = shape
            key = (b, s, s, h, hkv, d, window, True)
        else:
            q, k, v = draw(shape, seed)
            kw = dict(window=shape[6], causal=False)
            key = (*shape, False)
        what = f"{'' if causal else 'non-causal '}bf16 {shape}"
        with torch.inference_mode():
            got, lse = fa.flash_attention(q, k, v, **kw)
            want = fa.flash_attention_plain(q, k, v, **kw)
        err = float((got.float() - want.float()).abs().max())
        check(err <= ATTN_ATOL["bfloat16"], f"flash_attention {what}: max |kernel - "
                                            f"plain| {err:.3e} > {ATTN_ATOL['bfloat16']}")
        extra = None
        if _dense_path(path):
            with torch.inference_mode():
                extra = yardsticks(rl.flash_attention_work(b, s, s, h, hkv, d, window),
                                   lambda: fa.flash_attention_plain(q, k, v, **kw),
                                   _sdpa(q, k, v, window))
                extra.update(beside_fma(lambda: fa.flash_attention(q, k, v, **kw),
                                        lambda: fa.flash_attention(q, k, v, **kw,
                                                                   route=fa.F32_FMA),
                                        f"flash_attention {what}"))
        note("flash_attention", shape, path, fa.attention_route(q, k, v), err,
             _time_us(lambda: fa.flash_attention(q, k, v, **kw), **few), key, causal=causal,
             extra=extra)
        g = torch.Generator(device=DEVICE).manual_seed(seed + 10)
        dout = torch.randn(q.shape, generator=g, device=DEVICE).to(q.dtype)
        qq, kk, vv = (x.clone().requires_grad_() for x in (q, k, v))
        timed = _dense_path(bwd_path)
        plain_out = fa.flash_attention_plain(qq, kk, vv, **kw)
        ref = torch.autograd.grad(plain_out, (qq, kk, vv), grad_outputs=dout,
                                  retain_graph=timed)
        mine = fa.flash_attention_bwd(q, k, v, got, dout, lse, **kw)
        scale = max(float(r.abs().max()) for r in ref)
        err = max(_rel_err(a, r, scale) for a, r in zip(mine, ref))
        check(err <= GRAD_REL["bfloat16"], f"flash_attention_bwd {what}: rel err "
                                           f"{err:.3e} > {GRAD_REL['bfloat16']}")
        extra = None
        if timed:
            lib_out = _sdpa(qq, kk, vv, window)()
            extra = yardsticks(
                rl.flash_attention_bwd_work(b, s, s, h, hkv, d, window),
                lambda: torch.autograd.grad(plain_out, (qq, kk, vv), grad_outputs=dout,
                                            retain_graph=True),
                lambda: torch.autograd.grad(lib_out, (qq, kk, vv),
                                            grad_outputs=dout.transpose(1, 2),
                                            retain_graph=True))
            del lib_out
            extra.update(beside_fma(
                lambda: fa.flash_attention_bwd(q, k, v, got, dout, lse, **kw),
                lambda: fa.flash_attention_bwd(q, k, v, got, dout, lse, **kw, route=fa.F32_FMA),
                f"flash_attention_bwd {what}"))
        note("flash_attention_bwd", shape, bwd_path, fa.attention_bwd_route(q, k, v, got, dout),
             err,
             _time_us(lambda: fa.flash_attention_bwd(q, k, v, got, dout, lse, **kw), **few),
             key, rel=True, causal=causal, extra=extra)
        del q, k, v, qq, kk, vv, ref, mine, plain_out
        torch.cuda.empty_cache()
    for i, (shape, path) in enumerate(SLICE_DECODE):
        args, kw = _attention_args("decode_attention", shape, "bfloat16", seed=320 + i)
        with torch.inference_mode():
            got = da.decode_attention(*args, **kw)
            again = da.decode_attention(*args, **kw)
            want = da.decode_attention_plain(*args, **kw)
        check(torch.equal(got, again), f"decode_attention bf16 {shape}: two runs differ")
        err = float((got.float() - want.float()).abs().max())
        check(err <= ATTN_ATOL["bfloat16"], f"decode_attention bf16 {shape}: max |kernel - "
                                            f"plain| {err:.3e} > {ATTN_ATOL['bfloat16']}")
        extra = None
        if _dense_path(path):
            b, s, h, hkv, d, window, index = shape
            call = lambda: da.decode_attention(*args, **kw)   # noqa: E731
            with torch.inference_mode():
                extra = yardsticks(rl.decode_attention_work(b, s, h, hkv, d, window, index),
                                   lambda: da.decode_attention_plain(*args, **kw),
                                   _sdpa(*args[:3], window, index=index))
                # 50 calls a graph: a graph's own launch cost would weigh on
                # a few calls of a 10 us kernel
                extra.update(beside_fma(call,
                                        lambda: da.decode_attention(*args, **kw, route=da.F32_FMA),
                                        f"decode_attention bf16 {shape}", reps=50, samples=9))
                extra["kernel_cold_us"] = _cold_time_us(call, reps=20)
        note("decode_attention", shape, path, da.decode_route(*args[:3]), err,
             _time_us(lambda: da.decode_attention(*args, **kw), **few), tuple(shape[:6]),
             extra=extra)
    for i, (shape, path, bwd_path) in enumerate(SLICE_XENT):
        h, w, labels, gup = _xent_args(shape, "bfloat16", seed=330 + i)
        hh, ww = h.clone().requires_grad_(), w.clone().requires_grad_()
        timed = _dense_path(bwd_path) or bwd_path in XENT_TIMED
        ref = fx.fused_xent_plain(hh, ww, labels)
        plain_loss = (ref * gup).sum()
        ref_dh, ref_dw = torch.autograd.grad(plain_loss, (hh, ww), retain_graph=timed)
        with torch.no_grad():
            ref_lse = torch.logsumexp(h.float() @ w.float(), dim=-1)
        loss, lse = fx.fused_xent(h, w, labels)
        err = max(float((loss - ref.detach()).abs().max()), float((lse - ref_lse).abs().max()))
        check(bool(torch.isfinite(loss).all()) and err <= XENT_ATOL["bfloat16"],
              f"fused_xent bf16 {shape}: max |kernel - plain| {err:.3e} > "
              f"{XENT_ATOL['bfloat16']}")
        # the yardstick takes in-range labels only
        in_range = labels.long().abs() % shape[2]
        extra = None
        if _dense_path(path) or path in XENT_TIMED:
            with torch.no_grad():
                extra = yardsticks(rl.fused_xent_work(*shape),
                                   lambda: fx.fused_xent_plain(h, w, labels),
                                   lambda: F.cross_entropy(h @ w, in_range, reduction="none"),
                                   lambda: fx.fused_xent(h, w, labels))
        note("fused_xent", shape, path, fx.xent_route(h, w), err,
             _time_us(lambda: fx.fused_xent(h, w, labels), **few), tuple(shape), extra=extra)
        dh, dw = fx.fused_xent_bwd(h, w, labels, lse, gup)
        err = _xent_grad_err(dh, dw, ref_dh, ref_dw, labels)
        check(dh.dtype == h.dtype and dw.dtype == w.dtype and err <= GRAD_REL["bfloat16"],
              f"fused_xent_bwd bf16 {shape}: rel err {err:.3e} > {GRAD_REL['bfloat16']}")
        extra = None
        if timed:
            lib_loss = (F.cross_entropy(hh @ ww, in_range, reduction="none") * gup).sum()
            extra = yardsticks(
                rl.fused_xent_bwd_work(*shape),
                lambda: torch.autograd.grad(plain_loss, (hh, ww), retain_graph=True),
                lambda: torch.autograd.grad(lib_loss, (hh, ww), retain_graph=True),
                lambda: fx.fused_xent_bwd(h, w, labels, lse, gup))
            del lib_loss
        note("fused_xent_bwd", shape, bwd_path, fx.xent_bwd_route(h, w), err,
             _time_us(lambda: fx.fused_xent_bwd(h, w, labels, lse, gup), **few), tuple(shape),
             rel=True, extra=extra)
        del h, w, hh, ww, ref, plain_loss, ref_dh, ref_dw, dh, dw
        torch.cuda.empty_cache()
    for name, cases in out.items():
        log(f"phase1 {name} at the slice's shapes (bf16): " + "; ".join(
            f"{t['shape']}{'' if t['causal'] else ' non-causal'} ({t['path'] or 'on no path'}) "
            f"{t['route']} route, {'rel' if 'max_rel_err' in t else 'abs'} err "
            f"{t.get('max_rel_err', t.get('max_abs_err')):.3e}, kernel_us {t['kernel_us']:.1f}"
            + ("" if "bound_us" not in t else
               f", plain_us {t['plain_us']:.1f}, bound_us {t['bound_us']:.2f} "
               f"({t['bound_by']}), library_us "
               + ("none" if t["library_us"] is None else f"{t['library_us']:.1f}"))
            + ("" if "kernel_dev_us" not in t else
               f", kernel replayed {t['kernel_dev_us']:.1f} us")
            + ("" if "kernel_cold_us" not in t else f", L2 cold {t['kernel_cold_us']:.1f} us")
            + ("" if "f32_fma_route" not in t else
               f", the f32-FMA route {t['f32_fma_route']['kernel_us']:.1f} eager / "
               f"{t['f32_fma_route']['kernel_dev_us']:.1f} replayed")
            for t in cases))
    return out


class _ShapeLog:
    """Within the block, the key of every bf16 call on the card to B4's, B5's
    and B6's launchers, by launcher: (B, Sq, Sk, H, Hkv, D, window, causal)
    for B5 both ways, (B, S, H, Hkv, D, window) for B6 (any index), (T, D,
    V) for B4 both ways; what ``_phase_slice_shapes`` checked is held
    against it (``_check_shape_log``)."""

    def __enter__(self):
        import torch
        from repro_torch.kernels import decode_attention as da
        from repro_torch.kernels import flash_attention as fa
        from repro_torch.kernels import fused_xent as fx

        def attention(q, k, *_, causal=True, window=0, **__):
            return (*q.shape[:2], k.shape[1], q.shape[2], k.shape[2], q.shape[3], window,
                    causal)

        def decode(q, k, *_, window=0, **__):
            return (q.shape[0], k.shape[1], q.shape[2], k.shape[2], q.shape[3], window)

        def xent(h, w, *_, **__):
            return (h.shape[0], *w.shape)

        launchers = ((fa, "flash_attention", attention), (fa, "flash_attention_bwd", attention),
                     (da, "decode_attention", decode), (fx, "fused_xent", xent),
                     (fx, "fused_xent_bwd", xent))
        self.seen = {name: set() for _, name, _ in launchers}
        device = torch.device(DEVICE).type
        self.saved = [(module, name, getattr(module, name)) for module, name, _ in launchers]
        for (module, name, key), (_, _, fn) in zip(launchers, self.saved):
            def logged(*args, _fn=fn, _key=key, _seen=self.seen[name], **kw):
                if args[0].device.type == device and args[0].dtype == torch.bfloat16:
                    _seen.add(_key(*args, **kw))
                return _fn(*args, **kw)
            setattr(module, name, logged)
        return self

    def __exit__(self, *exc):
        for module, name, fn in self.saved:
            setattr(module, name, fn)


def _check_shape_log(label: str, log_: _ShapeLog, slice_shapes: dict) -> None:
    """Fail unless every key in ``log_`` was checked in phase 1 at the
    slice's shapes (``_phase_slice_shapes``)."""
    missing = {name: sorted(keys - {tuple(t["key"]) for t in slice_shapes[name]})
               for name, keys in log_.seen.items()}
    check(not any(missing.values()),
          f"{label}: bf16 calls at shapes phase 1 did not hold against the plain versions: "
          f"{ {n: m for n, m in missing.items() if m} }")
    log(f"{label}: every bf16 call to B4, B5 and B6 at a shape phase 1 checked: "
        f"{ {n: len(k) for n, k in log_.seen.items()} } distinct shapes")


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
    from repro_torch.launch import roofline as rl

    out = {"tamper_check_sums": [], "quant_dequant": [], "quant_dequant_stats": []}
    ref, _ = _activations(REPLICA_TAMPER, seed=11)
    a = ref.double().reshape(REPLICA_TAMPER[0], -1)
    err = _tamper_checks(ref, ref, torch.stack([torch.zeros_like(a[:, 0]), (a * a).sum(1)],
                                               dim=1), f"{REPLICA_TAMPER} aliased")
    check(bool((tc.tamper_check_sums(ref, ref)[:, 0] == 0.0).all()),
          f"tamper {REPLICA_TAMPER}: identical inputs give a nonzero numerator")
    r, n, d = REPLICA_TAMPER
    t = _tamper_timing(tc.tamper_check_sums, ref, ref, plain=tc.tamper_check_sums_plain)
    bound_us, bound_by = rl.bound_us(rl.tamper_check_work(r, n, d, aliased=True))
    t.update(shape=list(REPLICA_TAMPER), call="aliased (ref, ref)", max_abs_err=err,
             bound_us=bound_us, bound_by=bound_by)
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
            bound_us, bound_by = rl.bound_us(
                rl.quant_dequant_stats_work(rows, shape[-1], shape[0]) if len(shape) == 3
                else rl.quant_dequant_work(rows, shape[-1]))
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
    from repro_torch.launch import roofline as rl

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
        t["bound_us"], t["bound_by"] = rl.bound_us(rl.tamper_check_work(r, n, d, n_in == 1))
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
    from repro_torch.launch import roofline as rl

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
        bound_us, bound_by = rl.bound_us(rl.tamper_check_work(*shape, n_in == 1, elt=2))
        t.update(bound_us=bound_us, bound_by=bound_by,
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


def _attention_timing(name: str, kernel, plain, shape, long: bool, old=None):
    """Times of one B5/B6 call at ``shape`` in bf16: the kernel eager,
    graph-replayed (L2 warm) and L2-cold; with ``old``, the same of the
    f32-FMA route beside it; the plain version eager (and replayed, at the
    serve shapes); SDPA eager and replayed (the kernels' replayed times are
    held against the replayed SDPA, like for like: the kernel's, SDPA's and
    the f32-FMA route's graphs are replayed in turn); the bound."""
    import torch
    from repro_torch.launch import roofline as rl
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
        b, s, h, hkv, d, window = shape[:6]
        timing["bound_us"], timing["bound_by"] = rl.bound_us(
            rl.flash_attention_work(b, s, s, h, hkv, d, window) if name == "flash_attention"
            else rl.decode_attention_work(b, s, h, hkv, d, window, shape[6]))
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
        if name == "decode_attention":
            dev = torch.cuda.current_device()
            resident = {d: [da._tc_clusters(dev, d, n) for n in range(1, 9)]
                        for d in da.TC_HEAD_DIMS}
            log(f"phase1 {name}: clusters the card holds at once "
                f"(cudaOccupancyMaxActiveClusters) at splits 1-8, by head dim: {resident}")
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


def _panels(t, g: int):
    """(G, ...) panels of a (B, S, Hkv, D) cache: S cut into G panels of
    ceil(S / G) positions, the last padded with zeros."""
    import torch
    length = -(-t.shape[1] // g)
    pad = g * length - t.shape[1]
    if pad:
        t = torch.cat([t, t.new_zeros((t.shape[0], pad) + tuple(t.shape[2:]))], dim=1)
    return [t[:, i * length:(i + 1) * length] for i in range(g)], length


def _partial_timing(shape, g: int) -> dict:
    """B6's partial mode on the panel of ``shape``'s G-panel split that holds
    its index, bf16: eager, replayed (the f32-FMA route's graph replayed in
    turn where the tensor cores take it) and L2-cold; the plain partial
    eager (and replayed but at the 32k shape); the bound of the panel's
    live bytes."""
    import torch
    from repro_torch.kernels import decode_attention as da
    from repro_torch.launch import roofline as rl
    (q, k, v, index), kw = _attention_args("decode_attention", shape, "bfloat16", seed=98)
    ks, length = _panels(k, g)
    vs, _ = _panels(v, g)
    p = index // length
    kp, vp = ks[p].contiguous(), vs[p].contiguous()
    base, window = p * length, kw["window"]
    route = da.decode_route(q, kp, vp)
    call = lambda: da.decode_attention_partial(q, kp, vp, index, base=base,   # noqa: E731
                                               window=window)
    old = (None if route != da.TENSOR_CORES else lambda: da.decode_attention_partial(  # noqa: E731
        q, kp, vp, index, base=base, window=window, route=da.F32_FMA))
    plain = lambda: da.decode_attention_partial_plain(q, kp, vp, index, base=base,  # noqa: E731
                                                      window=window)
    long = shape == DECODE_LONG
    with torch.inference_mode():
        fns = [fn for fn in (call, old) if fn is not None]
        dev = dict(zip(fns, _graph_times_us(fns, **(dict(reps=5, samples=9) if long else {}))))
        b, _, h, d = q.shape
        bound_us, bound_by = rl.bound_us(rl.decode_attention_partial_work(
            b, length, h, kp.shape[2], d, base, window, index))
        out = dict(shape=list(shape), panels=g, panel=p, route=route,
                   kernel_us=_time_us(call, **(dict(reps=5, samples=5) if long else {})),
                   kernel_dev_us=_median(dev[call]),
                   kernel_cold_us=_cold_time_us(call, reps=5 if long else 50),
                   plain_us=_time_us(plain, **(dict(reps=2, samples=3) if long else {})),
                   plain_dev_us=None if long else _graph_time_us(plain),
                   bound_us=bound_us, bound_by=bound_by, library_us=None,
                   live_keys=da.panel_keys(index, base, length, window))
        if old is not None:
            out["f32_fma_route"] = dict(kernel_dev_us=_median(dev[old]))
    log(f"phase1 decode_attention (partial) at {shape}, panel {p} of {g} ({out['live_keys']} "
        f"live keys), bf16, {route}: kernel_us={out['kernel_us']:.3f}, replayed "
        f"{out['kernel_dev_us']:.3f}, L2 cold {out['kernel_cold_us']:.3f}"
        + (f", the f32-FMA route replayed {out['f32_fma_route']['kernel_dev_us']:.3f}"
           if old is not None else "")
        + f"; plain_us={out['plain_us']:.3f}; bound_us={bound_us:.4f} ({bound_by}); library: "
          f"none (no PyTorch call returns the lse); {card_line()}")
    return out


def _phase_decode_partial() -> dict:
    """B6's partial mode (``decode_attention_partial``, both kernels) against
    its plain version over every panel of PARTIAL_SHAPES split into each G
    of PARTIAL_SPLITS, f32 and bf16, on every route a panel takes (the
    tensor cores and, beside them, the f32-FMA route) and both index forms:
    out within ATTN_ATOL, lse within ATTN_ATOL where finite and -inf where
    the plain version's is; a panel with no live key exactly out 0, lse
    -inf, no NaN; bit-identical run to run; the panels combined
    (``combine_partials``) equal to the one-call B6 on the same route
    within ATTN_ATOL (LONG_BF16_REL of the largest |plain| at the 32k
    shape in bf16).  Timed at the main path's panel, the serve shape's
    (2 panels), the 32k shape's (16), head dim 256's and 80's (2)."""
    import torch
    from repro_torch.kernels import decode_attention as da
    max_err, empties, routes = {}, 0, {}
    for i, shape in enumerate(PARTIAL_SHAPES):
        for dtype in ("float32", "bfloat16"):
            (q, k, v, index), kw = _attention_args("decode_attention", shape, dtype, seed=i)
            window = kw["window"]
            with torch.inference_mode():
                whole_plain = da.decode_attention_plain(q, k, v, index, window=window)
            bound = ATTN_ATOL[dtype]
            if shape == DECODE_LONG and dtype == "bfloat16":
                bound = LONG_BF16_REL * float(whole_plain.float().abs().max())
            for g in PARTIAL_SPLITS:
                ks, length = _panels(k, g)
                vs, _ = _panels(v, g)
                ks = [t.contiguous() for t in ks]
                vs = [t.contiguous() for t in vs]
                chosen = da.decode_route(q, ks[0], vs[0])
                routes.setdefault(chosen, set()).add((dtype, tuple(shape), g))
                calls = [chosen] + ([da.F32_FMA] if chosen == da.TENSOR_CORES else [])
                with torch.inference_mode():
                    plains = [da.decode_attention_partial_plain(
                        q, kp, vp, index, base=j * length, window=window)
                        for j, (kp, vp) in enumerate(zip(ks, vs))]
                for route in calls:
                    with torch.inference_mode():
                        one = da.decode_attention(q, k, v, index, window=window, route=route)
                    for dev_index in (False, True):
                        idx = (torch.tensor(index, dtype=torch.int32, device=q.device)
                               if dev_index else index)
                        what = (f"decode_attention (partial, {route}"
                                f"{', device index' if dev_index else ''}) {dtype} {shape} "
                                f"G {g}")
                        outs, lses = [], []
                        for j, (kp, vp) in enumerate(zip(ks, vs)):
                            with torch.inference_mode():
                                o1, l1 = da.decode_attention_partial(
                                    q, kp, vp, idx, base=j * length, window=window, route=route)
                                o2, l2 = da.decode_attention_partial(
                                    q, kp, vp, idx, base=j * length, window=window, route=route)
                            torch.cuda.synchronize()
                            po, pl = plains[j]
                            check(torch.equal(o1, o2) and torch.equal(l1, l2),
                                  f"{what} panel {j}: two runs differ")
                            check(o1.shape == po.shape and l1.shape == pl.shape and
                                  o1.dtype == torch.float32 and l1.dtype == torch.float32,
                                  f"{what} panel {j}: shapes {o1.shape} {l1.shape}")
                            check(bool(torch.isfinite(o1).all()) and not bool(l1.isnan().any()),
                                  f"{what} panel {j}: out not finite or lse NaN")
                            empty = bool(torch.isneginf(pl).all())
                            if empty:
                                empties += 1
                                check(bool((o1 == 0).all()) and bool(torch.isneginf(l1).all()),
                                      f"{what} panel {j}: a panel with no live key gives out "
                                      f"{float(o1.abs().max()):.3e}, lse {l1.flatten()[:4]}")
                            check(torch.equal(torch.isneginf(l1), torch.isneginf(pl)),
                                  f"{what} panel {j}: lse -inf where the plain one is not")
                            fin = torch.isfinite(pl)
                            err = max(float((o1 - po).abs().max()),
                                      float((l1[fin] - pl[fin]).abs().max()) if fin.any()
                                      else 0.0)
                            check(err <= ATTN_ATOL[dtype], f"{what} panel {j}: max |kernel - "
                                                           f"plain| {err:.3e}")
                            key = f"{route} {dtype}"
                            max_err[key] = max(max_err.get(key, 0.0), err)
                            outs.append(o1)
                            lses.append(l1)
                        got = da.combine_partials(torch.stack(outs), torch.stack(lses), q.dtype)
                        cerr = float((got.float() - one.float()).abs().max())
                        check(got.shape == one.shape and cerr <= bound,
                              f"{what}: the combined panels differ from the one-call B6 by "
                              f"{cerr:.3e} > {bound:.3e}")
                        key = f"combined {route} {dtype}"
                        max_err[key] = max(max_err.get(key, 0.0), cerr)
                del outs, lses, plains, ks, vs
            del q, k, v, whole_plain
        torch.cuda.empty_cache()
    for route, cases in routes.items():
        log(f"phase1 decode_attention (partial): {route} route takes {sorted(cases)}")
    check(empties > 0, "phase1 decode_attention (partial): no panel without a live key ran")
    log(f"phase1 decode_attention (partial): every panel of {list(PARTIAL_SHAPES)} split into "
        f"{list(PARTIAL_SPLITS)} within atol {ATTN_ATOL} of the plain partial on every route "
        f"and index form, {empties} panels with no live key exactly (0, -inf), the combined "
        f"panels within the same of the one-call B6; max_abs_err {max_err}")
    timed = [_partial_timing(shape, g) for shape, g in
             ((PARTIAL_SHAPES[0], 2), (PARTIAL_SHAPES[1], 2), (DECODE_LONG, 16),
              (PARTIAL_SHAPES[3], 2), (PARTIAL_SHAPES[4], 2))]
    main = timed[0]
    return dict(max_abs_err=max(v for key, v in max_err.items()
                                if key.startswith(main["route"])),
                max_abs_err_by_route=max_err, empty_panels=empties, **main, timed=timed[1:])


def _phase_attention_non_causal():
    """B5's non-causal mode (``causal=False``: only the window masks; Sq may
    exceed Sk; a row with no live key takes the reference kernel's value)
    on both forward routes against the plain version at
    :data:`NONCAUSAL_SHAPES`, f32 and bf16, bit-identical run to run; timed
    at the self shape beside SDPA with ``is_causal=False`` (eager, replayed
    in turn with the f32-FMA route, L2-cold).  Its backward:
    :func:`_phase_attention_bwd_non_causal`."""
    import torch
    from repro_torch.kernels import flash_attention as fa

    def draw(shape, dtype, seed):
        b, sq, sk, h, hkv, d, _ = shape
        g = torch.Generator(device=DEVICE).manual_seed(seed)
        dt = getattr(torch, dtype)
        return tuple(torch.randn(dims, generator=g, device=DEVICE).to(dt)
                     for dims in ((b, sq, h, d), (b, sk, hkv, d), (b, sk, hkv, d)))

    max_err, routes = {}, {}
    for dtype in ("float32", "bfloat16"):
        for i, shape in enumerate(NONCAUSAL_SHAPES):
            q, k, v = draw(shape, dtype, 200 + i)
            window = shape[6]
            with torch.inference_mode():
                ref = fa.flash_attention_plain(q, k, v, causal=False, window=window)
            route = fa.attention_route(q, k, v)
            routes.setdefault(route, []).append((dtype, shape))
            for how in ([route, fa.F32_FMA] if route == fa.TENSOR_CORES else [route]):
                with torch.inference_mode():
                    out1 = fa.flash_attention(q, k, v, causal=False, window=window,
                                              route=how)[0]
                    out2 = fa.flash_attention(q, k, v, causal=False, window=window,
                                              route=how)[0]
                torch.cuda.synchronize()
                what = f"flash_attention non-causal ({how}) {dtype} {shape}"
                check(torch.equal(out1, out2), f"{what}: two runs differ")
                check(out1.shape == ref.shape and bool(torch.isfinite(out1).all()),
                      f"{what}: {tuple(out1.shape)} or not finite")
                err = float((out1.float() - ref.float()).abs().max())
                check(err <= ATTN_ATOL[dtype],
                      f"{what}: max |kernel - plain| {err:.3e} > {ATTN_ATOL[dtype]}")
                key = f"{how} {dtype}"
                max_err[key] = max(max_err.get(key, 0.0), err)
    for route, cases in routes.items():
        log(f"phase1 flash_attention non-causal: {route} route takes {cases}")
    log(f"phase1 flash_attention non-causal: within atol {ATTN_ATOL} of plain at "
        f"{list(NONCAUSAL_SHAPES)} (Sq = Sk, Sq < Sk, Sq > Sk, windows, rows with no live "
        f"key) on every route, bit-identical run to run; max_abs_err {max_err}")

    timings = [_non_causal_timing(shape, draw(shape, "bfloat16", 250 + i))
               for i, shape in enumerate(NONCAUSAL_SHAPES[:NONCAUSAL_TIMED])]
    return dict(max_abs_err=max_err[f"{fa.TENSOR_CORES} bfloat16"],
                max_abs_err_by_route=max_err, **timings[0], others=timings[1:])


def _non_causal_timing(shape, qkv) -> dict:
    """Times of one non-causal B5 call at ``shape`` in bf16: the kernel
    eager, replayed (in turn with SDPA's ``is_causal=False`` and the
    f32-FMA route) and L2-cold, the plain version eager, SDPA eager where
    it computes the same function (no window), the bound: max of the bytes
    over 3.35 TB/s and 4 D flops a live (query, key) pair and head over the
    bf16 peak."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import roofline as rl

    b, sq, sk, h, hkv, d, window = shape
    q, k, v = qkv
    call = lambda: fa.flash_attention(q, k, v, causal=False, window=window)[0]  # noqa: E731
    old = lambda: fa.flash_attention(q, k, v, causal=False, window=window,      # noqa: E731
                                     route=fa.F32_FMA)[0]
    lib = None
    if not window:
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        lib = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=False,  # noqa: E731
                                                     enable_gqa=True)
    replayed = [fn for fn in (call, lib, old) if fn is not None]
    with torch.inference_mode():
        if lib is not None:
            want = fa.flash_attention_plain(q, k, v, causal=False).float()
            check(float((lib().transpose(1, 2).float() - want).abs().max())
                  <= ATTN_ATOL["bfloat16"],
                  f"{shape}: SDPA (is_causal=False) disagrees with the plain version")
        dev = dict(zip(replayed, _graph_times_us(replayed)))
        timing = dict(
            shape=list(shape), dtype="bfloat16", kernel_us=_time_us(call),
            kernel_dev_us=_median(dev[call]), kernel_cold_us=_cold_time_us(call),
            plain_us=_time_us(lambda: fa.flash_attention_plain(q, k, v, causal=False,
                                                               window=window),
                              reps=3, samples=5),
            library_us=None if lib is None else _time_us(lib),
            library_dev_us=None if lib is None else _median(dev[lib]),
            f32_fma_route=dict(kernel_us=_time_us(old), kernel_dev_us=_median(dev[old]),
                               kernel_cold_us=_cold_time_us(old, reps=10)))
    timing["bound_us"], timing["bound_by"] = rl.bound_us(
        rl.flash_attention_work(b, sq, sk, h, hkv, d, window, causal=False))
    sdpa = ("none (a window)" if lib is None else
            f"{timing['library_us']:.3f} eager, {timing['library_dev_us']:.3f} replayed "
            f"({dev[lib][0]:.3f}-{dev[lib][-1]:.3f})")
    log(f"phase1 flash_attention non-causal at {shape} bf16: kernel_us="
        f"{timing['kernel_us']:.3f} plain_us={timing['plain_us']:.3f} sdpa_us={sdpa}; "
        f"bound_us={timing['bound_us']:.4f} ({timing['bound_by']}); graph-replayed "
        f"(L2 warm): kernel_us={timing['kernel_dev_us']:.3f} ({dev[call][0]:.3f}-"
        f"{dev[call][-1]:.3f}), the f32-FMA route {timing['f32_fma_route']['kernel_dev_us']:.3f}; "
        f"one call L2-cold: kernel_us={timing['kernel_cold_us']:.3f} (f32-FMA "
        f"{timing['f32_fma_route']['kernel_cold_us']:.3f})")
    return timing


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
    from repro_torch.launch import roofline as rl

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
    for name, call, plain, lib, work in (
            ("fused_xent", lambda: fx.fused_xent(h, w, labels),
             lambda: fx.fused_xent_plain(h, w, labels),
             lambda: F.cross_entropy(h @ w, labels.long(), reduction="none"),
             rl.fused_xent_work(t, d, v, elt)),
            ("fused_xent_bwd", lambda: fx.fused_xent_bwd(h, w, labels, lse, gup),
             lambda: torch.autograd.grad(plain_loss, (hh, ww), retain_graph=True),
             lambda: torch.autograd.grad(lib_loss, (hh, ww), retain_graph=True),
             rl.fused_xent_bwd_work(t, d, v, elt))):
        n_bytes, n_ops = work.bytes, work.ops
        bound_us, bound_by = rl.bound_us(work)
        timing = dict(kernel_us=_time_us(call, **few),
                      kernel_dev_us=_graph_time_us(call, **few),
                      kernel_cold_us=_cold_time_us(call, reps=3),
                      plain_us=_time_us(plain, **few), plain_dev_us=None,
                      library_us=_time_us(lib, **few), bound_us=bound_us, bound_by=bound_by)
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
    from repro_torch.launch import roofline as rl

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
    # q, out, dout, dq (B, S, H, D); k, v, dk, dv (B, S, Hkv, D); lse
    work = rl.flash_attention_bwd_work(b, s, s, h, hkv, d, window)
    n_ops, n_bytes = work.ops, work.bytes
    bound_us, bound_by = rl.bound_us(work)
    old = lambda: fa.flash_attention_bwd(q, k, v, out, dout, lse, window=window,  # noqa: E731
                                         route=fa.F32_FMA)
    timing = dict(kernel_us=_time_us(call, reps=20, samples=5),
                  kernel_dev_us=_graph_time_us(call, reps=20, samples=5),
                  kernel_cold_us=_cold_time_us(call, reps=10),
                  plain_us=_time_us(plain, reps=5, samples=3), plain_dev_us=None,
                  library_us=_time_us(lib, reps=20, samples=5),
                  bound_us=bound_us, bound_by=bound_by,
                  f32_fma_route=dict(kernel_us=_time_us(old, reps=5, samples=3),
                                     kernel_dev_us=_graph_time_us(old, reps=5, samples=3),
                                     kernel_cold_us=_cold_time_us(old, reps=5)))
    # this design's own bound: S and dP recomputed in the dQ pass (14 D
    # flops a live pair and head, against the 10 of the least work)
    own_us = 14 / 10 * n_ops / rl.BF16_OPS_PER_S * 1e6
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


def _phase_attention_bwd_non_causal():
    """B5's backward in non-causal mode (dq, dk, dv) against autograd of the
    plain version (``causal=False``) at :data:`NONCAUSAL_BWD_SHAPES`, f32
    and bf16, on both routes wherever a shape takes the tensor cores,
    within GRAD_REL, bit-identical run to run; once through
    ``ops.flash_attention`` (``FlashAttention``: one non-causal forward and
    one backward launch); a call with a row that sees no key refused (by
    ``ops.flash_attention`` and by the launcher); timed at SeamlessM4T's
    encoder shape in bf16, eager, replayed and L2-cold, beside the plain
    autograd's backward, SDPA's backward with ``is_causal=False`` (eager,
    and replayed in turn with the kernel; a yardstick the port never calls)
    and the bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch import roofline as rl

    def draw(shape, dtype, seed):
        b, sq, sk, h, hkv, d, _ = shape
        g = torch.Generator(device=DEVICE).manual_seed(seed)
        dt = getattr(torch, dtype)
        return tuple(torch.randn(dims, generator=g, device=DEVICE).to(dt)
                     for dims in ((b, sq, h, d), (b, sk, hkv, d), (b, sk, hkv, d),
                                  (b, sq, h, d)))

    errs, routes = {}, {}
    for dtype in ("float32", "bfloat16"):
        for i, shape in enumerate(NONCAUSAL_BWD_SHAPES):
            q, k, v, dout = draw(shape, dtype, 400 + i)
            window = shape[6]
            check(not fa.has_dead_rows(shape[1], shape[2], window, False),
                  f"{shape}: a row with no key")
            out, lse = fa.flash_attention(q, k, v, causal=False, window=window)
            qq, kk, vv = (x.clone().requires_grad_() for x in (q, k, v))
            ref = torch.autograd.grad(
                fa.flash_attention_plain(qq, kk, vv, causal=False, window=window),
                (qq, kk, vv), grad_outputs=dout)
            scale = max(float(r.abs().max()) for r in ref)
            route = fa.attention_bwd_route(q, k, v, out, dout)
            routes.setdefault(route, []).append((dtype, shape))
            for how in [route] + ([fa.F32_FMA] if route == fa.TENSOR_CORES else []):
                d1 = fa.flash_attention_bwd(q, k, v, out, dout, lse, causal=False,
                                            window=window, route=how)
                d2 = fa.flash_attention_bwd(q, k, v, out, dout, lse, causal=False,
                                            window=window, route=how)
                torch.cuda.synchronize()
                what = f"flash_attention_bwd non-causal ({how}) {dtype} {shape}"
                check(all(torch.equal(a, b) for a, b in zip(d1, d2)), f"{what}: two runs differ")
                err = max(_rel_err(a, r, scale) for a, r in zip(d1, ref))
                check(all(a.dtype == q.dtype and a.shape == r.shape for a, r in zip(d1, ref))
                      and all(bool(torch.isfinite(a).all()) for a in d1)
                      and err <= GRAD_REL[dtype],
                      f"{what}: rel err {err:.3e} > {GRAD_REL[dtype]}")
                key = f"{how} {dtype}"
                errs[key] = max(errs.get(key, 0.0), err)
                if i == 0 and dtype == "bfloat16" and how == route:
                    main_err = err
                    main_abs = max(float((a.float() - r.float()).abs().max())
                                   for a, r in zip(d1, ref))
            del q, k, v, dout, out, lse, qq, kk, vv, ref
    log(f"phase1 flash_attention_bwd non-causal: dq, dk, dv within rel {GRAD_REL} of "
        f"autograd of the plain version at {list(NONCAUSAL_BWD_SHAPES)} (Seamless's encoder "
        f"and cross-attention, Sq < Sk, Sq > Sk, a window with every row live, head dim 80), "
        f"bit-identical run to run; routes {routes}; max rel err {errs}")

    # through the autograd.Function: one non-causal launch each way
    q, k, v, dout = draw(NONCAUSAL_BWD_SHAPES[0], "bfloat16", 450)
    qq, kk, vv = (x.clone().requires_grad_() for x in (q, k, v))
    build.reset_launches()
    got = torch.autograd.grad(ops.flash_attention(qq, kk, vv, causal=False), (qq, kk, vv),
                              grad_outputs=dout)
    torch.cuda.synchronize()
    want = want_launches(flash_attention_tc_noncausal=1, flash_attention_bwd_tc_noncausal=1)
    check(dict(build.LAUNCHES) == want,
          f"ops.flash_attention non-causal with a gradient launched {build.LAUNCHES}")
    out, lse = fa.flash_attention(q, k, v, causal=False)
    direct = fa.flash_attention_bwd(q, k, v, out, dout, lse, causal=False)
    check(all(torch.equal(a, b) for a, b in zip(got, direct)),
          "ops.flash_attention's non-causal gradient differs from the launcher's")

    # a row with no live key: refused by both entry points
    dead = (1, 200, 100, 4, 2, 64, 64)
    dq_, dk_, dv_, dd = draw(dead, "bfloat16", 460)
    for call in (lambda: ops.flash_attention(dq_.clone().requires_grad_(), dk_, dv_,
                                             causal=False, window=64),
                 lambda: fa.flash_attention_bwd(dq_, dk_, dv_, dq_, dd, torch.zeros(
                     (1, 4, 200), device=DEVICE), causal=False, window=64)):
        try:
            call()
            fail(f"flash_attention_bwd non-causal at {dead} (rows 163-199 see no key) did "
                 f"not raise")
        except NotImplementedError as e:
            check("sees no key" in str(e), f"the dead-row refusal says: {e}")
    log(f"phase1 flash_attention_bwd non-causal: a call with a gradient at {dead} (Sq >= Sk "
        f"+ window) refused by ops.flash_attention and the launcher")

    shape = NONCAUSAL_BWD_SHAPES[0]
    b, sq, sk, h, hkv, d, window = shape
    plain_out = fa.flash_attention_plain(qq, kk, vv, causal=False)
    # SDPA's leaves, forward and grad_outputs on a stream of their own, where
    # its backward then runs and is captured for the replayed time (a node
    # of its graph on the legacy stream would make the capture wait on it)
    lib_stream = torch.cuda.Stream()
    lib_stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(lib_stream):
        ql, kl, vl = (x.clone().requires_grad_() for x in (q, k, v))
        dl = dout.transpose(1, 2).contiguous()
        qt, kt, vt = (x.transpose(1, 2) for x in (ql, kl, vl))
        lib_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=False, enable_gqa=True)
        lib_ref = torch.autograd.grad(lib_out, (ql, kl, vl), grad_outputs=dl, retain_graph=True)
    torch.cuda.current_stream().wait_stream(lib_stream)
    scale = max(float(r.abs().max()) for r in lib_ref)
    check(max(_rel_err(a, r, scale) for a, r in zip(direct, lib_ref)) <= GRAD_REL["bfloat16"],
          "flash_attention_bwd non-causal: SDPA's backward disagrees with the kernel")
    call = lambda: fa.flash_attention_bwd(q, k, v, out, dout, lse, causal=False)  # noqa: E731
    old = lambda: fa.flash_attention_bwd(q, k, v, out, dout, lse, causal=False,  # noqa: E731
                                         route=fa.F32_FMA)
    plain = lambda: torch.autograd.grad(plain_out, (qq, kk, vv), grad_outputs=dout,  # noqa: E731
                                        retain_graph=True)
    lib = lambda: torch.autograd.grad(lib_out, (ql, kl, vl), grad_outputs=dl,  # noqa: E731
                                      retain_graph=True)
    dev, lib_dev = _graph_times_us([call, lib], reps=20, samples=9, stream=lib_stream)
    work = rl.flash_attention_bwd_work(b, sq, sk, h, hkv, d, causal=False)
    n_ops, n_bytes = work.ops, work.bytes
    bound_us, bound_by = rl.bound_us(work)
    timing = dict(kernel_us=_time_us(call, reps=20, samples=5), kernel_dev_us=_median(dev),
                  kernel_cold_us=_cold_time_us(call, reps=10),
                  plain_us=_time_us(plain, reps=5, samples=3),
                  library_us=_time_us(lib, reps=20, samples=5),
                  library_dev_us=_median(lib_dev), bound_us=bound_us, bound_by=bound_by,
                  f32_fma_route=dict(kernel_us=_time_us(old, reps=5, samples=3),
                                     kernel_dev_us=_graph_time_us(old, reps=5, samples=3),
                                     kernel_cold_us=_cold_time_us(old, reps=5)))
    log(f"phase1 flash_attention_bwd non-causal at {shape} bf16: kernel_us="
        f"{timing['kernel_us']:.2f} plain_us={timing['plain_us']:.1f} sdpa_backward_us="
        f"{timing['library_us']:.2f} (eager); bound_us={timing['bound_us']:.3f} "
        f"({timing['bound_by']}; {n_ops / 1e9:.3f} GFLOP, {n_bytes / 1e6:.2f} MB); replayed "
        f"in turn (L2 warm): kernel_us={timing['kernel_dev_us']:.2f} ({dev[0]:.2f}-"
        f"{dev[-1]:.2f}), SDPA's backward {timing['library_dev_us']:.2f} ({lib_dev[0]:.2f}-"
        f"{lib_dev[-1]:.2f}); L2 cold: {timing['kernel_cold_us']:.2f}; the f32-FMA route "
        f"{timing['f32_fma_route']['kernel_us']:.1f} eager, "
        f"{timing['f32_fma_route']['kernel_dev_us']:.1f} replayed")
    return dict(shape=list(shape), dtype="bfloat16", max_abs_err=main_abs,
                max_rel_err=main_err, max_rel_err_by_route=errs, **timing)


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


def _slstm_timing(shape, long: bool):
    """Times of one B7 call at ``shape`` in bf16 on both routes (the
    persistent kernel and the step kernel): eager, graph-replayed in turn
    (L2 warm) and L2-cold; the plain version eager, the bound, and the time
    a step (the scan's dependency chain)."""
    import torch
    from repro_torch.kernels import slstm_scan as ss
    from repro_torch.launch import roofline as rl
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
    timing["bound_us"], timing["bound_by"] = rl.bound_us(rl.slstm_scan_work(*shape))
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


def _slstm_bwd_timing(shape, long: bool):
    """Times of one B7 backward call at ``shape`` in bf16, from the
    persistent forward's saves, on both routes (the persistent kernel and
    the step kernel): eager, graph-replayed in turn (L2 warm) and L2-cold;
    the bound and the time a reverse step.  At the prefill shape also the
    plain autograd's backward, the dR product and the forward with and
    without saves."""
    import torch
    from repro_torch.kernels import slstm_scan as ss
    from repro_torch.launch import roofline as rl
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
    timing["bound_us"], timing["bound_by"] = rl.bound_us(rl.slstm_scan_bwd_work(*shape))
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
    return launches, seconds / pcfg.T, hist


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
    return out, hists["splitfed_batched"]


#: phase 2d's four runs of the batched engine: (block, prefetch)
MULTIROUND_RUNS = ((1, 0), (1, 1), (4, 0), (4, 1))
MULTIROUND_T = 4                 # eval_every 4: rounds 0 and 3 are sync rounds
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
    configuration, T = 4, eval_every = 4).  Four runs — block 1 and 4, each
    with prefetch 0 and 1 — under the main path's cuDNN settings: each makes T*M_bar*E B2 and B3 launches and T B1
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
        for block, prefetch in MULTIROUND_RUNS:
            name = f"block{block}_prefetch{prefetch}"
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
    # bit).  Deterministic cuDNN: everything exactly, test_acc included,
    # losses within rtol.
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


def _sweep_pool_pass(main, label: str, sweep_blocks, tmp: str):
    """One pass of phase 2e (see :func:`phase_sweep_pool`); ``label`` names
    the cuDNN mode in the log.  Returns (the figures, the sweep's and the
    pool's Histories, which phase 2f holds its sharded runs against)."""
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
    out, found, kept = {}, [], {}

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
        kept[f"sweep_block{block}"] = dict(zip(SWEEP_SEEDS, hists))

    # the pool against each job's solo run; job1 checkpoints
    def spec(i):
        return _pool_spec(main, i, **(dict(checkpoint_path=os.path.join(
            tmp, f"job{i}{label.strip()}"), checkpoint_every=2) if i == 1 else {}))

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
    kept["pool"] = pooled

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
    return out, kept


#: RoundRunner entries phase 2e ran under sync-debug "error", by name
STRICT: dict = {}


def _pool_spec(main, i: int, **extra):
    """Job i of phase 2e's pool (and of 2f's): seed i, T = POOL_T[i], label
    flip on clients 0-3 or 4-7, the main path's wire and policy."""
    import dataclasses

    from repro_torch.core import LABEL_FLIP, Attack
    from repro_torch.core.jobs import JobSpec
    data, _, module, pcfg, kw = main
    bad = {0, 1, 2, 3} if i % 2 == 0 else {4, 5, 6, 7}
    return JobSpec(name=f"job{i}", module=module, data=data,
                   pcfg=dataclasses.replace(pcfg, seed=i, T=POOL_T[i], eval_every=POOL_T[i]),
                   malicious=bad, attack=Attack(LABEL_FLIP), quant=kw["quant"],
                   selection=kw["selection"], **extra)


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
    solo runs', with the float fields bit-equal to the solo runs'
    reported."""
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
            out, kept = _sweep_pool_pass(main, "", (1, 2), tmp)
    finally:
        for name, fn in originals.items():
            setattr(RoundRunner, name, fn)
    log(f"phase2e: decisions equal to the solo runs; largest gaps {out['largest_gap']}; "
        f"sweep s a round "
        f"{out['sweep_block1']['seconds_per_round']:.3f} (block 1), "
        f"{out['sweep_block2']['seconds_per_round']:.3f} (block 2) vs three solo runs "
        f"{3 * out['solo_seconds_per_round']:.3f}; pool s a job-round "
        f"{out['pool']['seconds_per_job_round']:.3f} vs solo "
        f"{out['pool']['solo_seconds_per_round']:.3f}")
    return out, kept


#: phase 2f: the sharded placement's tolerance against the vmap runs of
#: phases 2b and 2c (the same slots on one card; a rank's slice elsewhere),
#: the sweep's seeds and the pool's jobs
SHARDED_RTOL = 1e-5
SHARDED_SWEEP_SEEDS = (0, 1)
SHARDED_POOL_JOBS = 2
SHARDED_DEADLINE_S = 900.0


def _on_every_card(target, *args):
    """``target(*args)`` on every visible card as one NCCL group: in this
    process as a group of one where one card is visible, else one spawned
    rank a card (``launch/mesh.py::spawn``; each rank builds its own
    inputs).  Returns the ranks' results in rank order."""
    import torch
    from repro_torch.launch.mesh import group_of_one, spawn
    n = torch.cuda.device_count()
    if n == 1:
        with group_of_one("nccl"):
            return [target(*args)]
    torch.cuda.empty_cache()
    return spawn(target, n, "nccl", SHARDED_DEADLINE_S)


def _timed_run(fn):
    """``fn()`` with the launch counts reset just before it: (result,
    launches, seconds)."""
    import torch
    from repro_torch.kernels import build
    torch.cuda.synchronize()
    build.reset_launches()
    t0 = time.perf_counter()
    result = fn()
    torch.cuda.synchronize()
    return result, dict(build.LAUNCHES), time.perf_counter() - t0


def _sharded_cifar_rank(main=None) -> dict:
    """Phase 2f's runs on this rank of the group (see :func:`phase_sharded`):
    the Histories' rounds, the launches and the seconds of each."""
    import dataclasses

    import torch
    import torch.distributed as dist
    from repro_torch.core import run_pigeon_sweep, run_splitfed
    from repro_torch.core.jobs import run_job_pool
    from repro_torch.core.runner import RoundRunner

    main = main or _cifar_main_path()
    data, cfg, module, pcfg, kw = main
    out = dict(rank=dist.get_rank(), world=dist.get_world_size(),
               nccl=".".join(map(str, torch.cuda.nccl.version())))
    accept, steps = RoundRunner.accept, []
    # rank 0 trains in every mesh; a rank outside one waits on rank 0's
    # results (host reads of their shapes), so it runs without the mode
    strict = "error" if out["rank"] == 0 else 0

    def strict_accept(self, params, inputs, val):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode(strict)
        try:
            result = accept(self, params, inputs, val)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        steps.append(time.perf_counter() - t0)
        return result

    RoundRunner.accept = strict_accept
    try:
        hist, launches, seconds = _run("phase2f cifar sharded", module, data, pcfg,
                                       engine="batched", placement="sharded", **kw)
    finally:
        RoundRunner.accept = accept
    out["pigeon"] = dict(rounds=hist.rounds, launches=launches, s_per_round=seconds / pcfg.T,
                         step_seconds=steps)
    base = dict(malicious=kw["malicious"], attack=kw["attack"], quant="int8",
                device=kw["device"])
    hist, launches, seconds = _run("phase2f cifar splitfed sharded", module, data, pcfg,
                                   driver=run_splitfed, engine="batched",
                                   placement="sharded", **base)
    out["splitfed"] = dict(rounds=hist.rounds, launches=launches,
                           s_per_round=seconds / pcfg.T)
    sweep_cfg = dataclasses.replace(pcfg, T=SWEEP_T, eval_every=SWEEP_T)
    hists, launches, seconds = _timed_run(lambda: run_pigeon_sweep(
        module, data, sweep_cfg, seeds=SHARDED_SWEEP_SEEDS, block=2, placement="sharded",
        **kw))
    out["sweep"] = dict(rounds={s: h.rounds for s, h in zip(SHARDED_SWEEP_SEEDS, hists)},
                        launches=launches, s_per_round=seconds / SWEEP_T)
    specs = [_pool_spec(main, i) for i in range(SHARDED_POOL_JOBS)]
    pooled, launches, seconds = _timed_run(lambda: run_job_pool(
        specs, block=2, prefetch=1, placement="sharded", device=kw["device"]))
    job_rounds = sum(sp.pcfg.T for sp in specs)
    out["pool"] = dict(rounds={k: h.rounds for k, h in pooled.items()}, launches=launches,
                       s_per_job_round=seconds / job_rounds)
    return out


def phase_sharded(main, b_per_round, hists):
    """Phase 2f: the sharded placement (the cluster axis over an NCCL group
    of every visible card: in this process as a group of one on one card,
    one spawned rank a card elsewhere) on the main path: phase 2b's CIFAR
    Table II run (``RoundRunner.accept`` under sync-debug "error" on rank
    0, a rank of every mesh) held against 2b's History (decisions and comm exactly, val_losses within
    SHARDED_RTOL), SplitFed against 2c's batched run the same way, a 2-seed
    sweep (block 2) and a 2-job pool (block 2, prefetch 1) against 2e's
    replicas and jobs (decisions exactly, losses within REPLICA_RTOL);
    every rank's History equal to rank 0's; each run's B1, B2 and B3
    launches as the round's structure gives them on a rank that trains
    (rank 0); seconds a round beside 2b's.  ``hists``: 2b's, 2c's batched
    SplitFed's and 2e's Histories."""
    import numpy as np

    data, cfg, module, pcfg, kw = main
    ranks = _on_every_card(_sharded_cifar_rank, *(() if _cards() > 1 else (main,)))
    got = ranks[0]
    for r in ranks[1:]:
        for run in ("pigeon", "splitfed", "sweep", "pool"):
            check(r[run]["rounds"] == got[run]["rounds"],
                  f"phase2f {run}: rank {r['rank']}'s History differs from rank 0's")
    m_bar = pcfg.M // pcfg.R
    wire = pcfg.T * m_bar * pcfg.E
    check(got["pigeon"]["launches"] == want_launches(quant_dequant=wire,
                                                     quant_dequant_stats=wire,
                                                     tamper_check_sums=pcfg.T),
          f"phase2f pigeon: launches {got['pigeon']['launches']}, want {wire} of each wire "
          f"kernel and {pcfg.T} tamper checks")
    check(len(got["pigeon"]["step_seconds"]) == pcfg.T,
          f"phase2f: {len(got['pigeon']['step_seconds'])} sharded accepts, want {pcfg.T}")
    check(got["splitfed"]["launches"] == want_launches(quant_dequant=2 * pcfg.T * pcfg.E),
          f"phase2f splitfed: launches {got['splitfed']['launches']}")
    sweep_wire = SWEEP_T * m_bar * pcfg.E
    check(got["sweep"]["launches"] == want_launches(quant_dequant=sweep_wire,
                                                    quant_dequant_stats=sweep_wire),
          f"phase2f sweep: launches {got['sweep']['launches']}")
    pool_rounds = max(POOL_T[:SHARDED_POOL_JOBS])
    check(got["pool"]["launches"] == want_launches(
        quant_dequant=pool_rounds * m_bar * pcfg.E,
        quant_dequant_stats=pool_rounds * m_bar * pcfg.E, tamper_check_sums=pool_rounds),
          f"phase2f pool: launches {got['pool']['launches']}")

    def held(name, want_rounds, got_rounds, keys, rtol):
        worst = 0.0
        check(len(want_rounds) == len(got_rounds), f"phase2f {name}: round counts differ")
        for rw, rg in zip(want_rounds, got_rounds):
            for k in keys:
                if k in rw:
                    check(rg[k] == rw[k], f"phase2f {name} round {rw['round']}: {k} "
                                          f"{rg[k]} != {rw[k]}")
            a, b = np.asarray(rw["val_losses"], float), np.asarray(rg["val_losses"], float)
            worst = max(worst, float(np.max(np.abs(a - b) / np.abs(a))))
        check(worst <= rtol, f"phase2f {name}: val_losses {worst!r} apart > rtol {rtol}")
        log(f"phase2f {name}: decisions equal; val_losses' largest relative gap {worst!r} "
            f"(bound {rtol}); bit-equal: {want_rounds == got_rounds}")
        return worst

    gaps = dict(
        pigeon=held("run_pigeon vs 2b", hists["b"].rounds, got["pigeon"]["rounds"],
                    MULTIROUND_DECISIONS + ("clusters", "comm"), SHARDED_RTOL),
        splitfed=held("run_splitfed vs 2c", hists["splitfed"].rounds,
                      got["splitfed"]["rounds"], ("selected", "selected_honest", "comm"),
                      SHARDED_RTOL))
    for seed in SHARDED_SWEEP_SEEDS:
        gaps[f"sweep seed {seed}"] = held(
            f"sweep seed {seed} vs 2e", hists["sweep_block2"][seed].rounds,
            got["sweep"]["rounds"][seed], MULTIROUND_DECISIONS + ("clusters", "comm"),
            REPLICA_RTOL)
    for job, rounds in got["pool"]["rounds"].items():
        gaps[f"pool {job}"] = held(f"pool {job} vs 2e", hists["pool"][job].rounds, rounds,
                                   MULTIROUND_DECISIONS + ("clusters", "comm"), REPLICA_RTOL)
    out = dict(world=got["world"], nccl=got["nccl"], gaps=gaps,
               s_per_round=got["pigeon"]["s_per_round"], s_per_round_2b=b_per_round,
               accept_seconds=got["pigeon"]["step_seconds"],
               splitfed_s_per_round=got["splitfed"]["s_per_round"],
               sweep_s_per_round=got["sweep"]["s_per_round"],
               pool_s_per_job_round=got["pool"]["s_per_job_round"],
               launches=got["pigeon"]["launches"])
    log(f"phase2f: NCCL {got['nccl']}, world {got['world']}; run_pigeon sharded "
        f"{out['s_per_round']:.3f} s/round vs 2b's {b_per_round:.3f} (vmap); sharded accept "
        f"seconds {[round(x, 3) for x in out['accept_seconds']]}; SplitFed "
        f"{out['splitfed_s_per_round']:.3f} s/round; sweep {out['sweep_s_per_round']:.3f} s a "
        f"round; pool {out['pool_s_per_job_round']:.3f} s a job-round; launches on the path "
        f"(B1 tamper_check_sums, B2 quant_dequant, B3 quant_dequant_stats) "
        f"{got['pigeon']['launches']}; {card_line()}")
    return out


def _cards() -> int:
    import torch
    return torch.cuda.device_count()


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


def _serve(model, prompts, new_tokens: int, frames=None):
    """The serve path on ``model``: the prefill step's last-position logits,
    then the reference serve loop (an encoder-decoder's prefill takes
    ``frames``, its loop their encoding, computed once before it).  Returns
    (prefill logits, greedy tokens, the loop's logits at the prompt's last
    position, prefill s, loop s)."""
    import torch
    from repro_torch.launch.serve import greedy_decode
    from repro_torch.launch.steps import make_prefill_step, make_serve_step

    b, p = prompts.shape
    cache = model.init_cache(b, p + new_tokens)
    sync = torch.cuda.synchronize if prompts.is_cuda else (lambda: None)
    batch = {"tokens": prompts} if frames is None else {"tokens": prompts, "frames": frames}
    sync()
    t0 = time.perf_counter()
    prefill = make_prefill_step(model)(batch)
    sync()
    t1 = time.perf_counter()
    memory = None
    if frames is not None:
        with torch.inference_mode():
            memory = model.encode(batch)
    gen, last = greedy_decode(make_serve_step(model), cache, prompts, new_tokens, memory)
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


class _F64:
    """Within the block every cast the port spells ``torch.float32`` (the f32
    compute of Mamba2's SSD and state, the norms, rope, the plain attention
    and loss) casts to float64 instead, so that a float64 copy of a model
    on the CPU computes its loss and gradients in float64 throughout: the
    third witness beside the card's and the CPU's f32."""

    def __enter__(self):
        import torch
        self.saved = torch.float32
        torch.float32 = torch.float64
        return self

    def __exit__(self, *exc):
        import torch
        torch.float32 = self.saved


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
            lambda q, k, v, window, causal=True: fa.flash_attention_plain(
                q, k, v, causal=causal, window=window))
        fx.FusedXent.apply = staticmethod(fx.fused_xent_plain)
        ss.SlstmScan.apply = staticmethod(
            lambda pre, r, n_heads, *_: ss.slstm_scan_plain(pre, r, n_heads))
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import flash_attention as fa
        from repro_torch.kernels import fused_xent as fx
        from repro_torch.kernels import slstm_scan as ss
        fa.FlashAttention.apply, fx.FusedXent.apply, ss.SlstmScan.apply = self.saved


class _Routing:
    """Within the block, every MoE layer's routing, in call order: ``own``
    the ids (T, k) its router picks, ``ids`` the ids it takes and ``kept``
    the (T * k,) pairs it keeps within capacity.  With ``pin`` (ids a call,
    in call order) a layer takes the pinned ids, weighted by its own router
    probabilities renormalised over them (as ``moe.route`` weights its
    top-k); with ``keep_all`` an expert's capacity is the call's token
    count, so no pair is dropped.  ``groups`` the dispatch groups of each
    call (16 under ``moe_shard``'s local dispatch, else 1)."""

    def __init__(self, pin=None, keep_all: bool = False):
        self.pin, self.keep_all = pin, keep_all
        self.own, self.ids, self.kept, self.groups = [], [], [], []

    def __enter__(self):
        import torch
        from repro_torch.models import moe
        self.saved = route, dispatch, _ = moe.route, moe.dispatch_groups, moe.capacity

        def routed(router, cfg, x_flat, par=None):
            weights, ids, aux = route(router, cfg, x_flat, par)
            self.own.append(ids)
            if self.pin is not None:
                ids = self.pin[len(self.ids)].to(ids.device)
                probs = torch.softmax((x_flat @ router).to(torch.float32), dim=-1)
                w = torch.gather(probs, 1, ids)
                weights = (w / torch.clamp_min(w.sum(-1, keepdim=True), 1e-9)).to(x_flat.dtype)
            self.ids.append(ids)
            return weights, ids, aux

        def dispatched(ids, cfg, groups, cap, offset=None):
            slot, keep = dispatch(ids, cfg, groups, cap, offset)
            self.kept.append(keep.reshape(-1))
            self.groups.append(groups)
            return slot, keep

        moe.route, moe.dispatch_groups = routed, dispatched
        if self.keep_all:
            moe.capacity = lambda n_tokens, cfg: n_tokens
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe.route, moe.dispatch_groups, moe.capacity = self.saved


def _flips(a, b) -> int:
    """Tokens whose set of k experts differs between two ids (T, k)."""
    import torch
    return int((torch.sort(a.cpu(), -1)[0] != torch.sort(b.cpu(), -1)[0]).any(-1).sum())


def _step_positions(batch) -> int:
    """The positions a train step processes: tokens, and a vlm's patches or
    an encoder-decoder's frames (the dry run's tokens of a step)."""
    return batch["tokens"].numel() + sum(
        batch[k].shape[0] * batch[k].shape[1] for k in ("patches", "frames") if k in batch)


def _active_params(model) -> int:
    """The model's parameters a token runs through as the model is built:
    all of them, or a MoE's active count of its config (top-k and the
    shared experts)."""
    if model.cfg.arch_type == "moe":
        return model.cfg.active_param_count()
    return sum(p.numel() for p in model.parameters())


def _three_steps(label: str, step, batch, per_step: dict, model):
    """Three calls of a train ``step`` on ``batch``, each with the launches
    ``per_step``; the loss finite and falling; then two more timed for the
    profile's wall.  The warm step's ``mfu`` (printed, nothing gates on it):
    ``roofline.model_flops_for("train", active params of ``model``,
    positions)`` over the warm step's seconds at the card's 989e12 bf16
    FLOP/s.  Returns (figures, the faster of the two walls in us)."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.launch import roofline as rl
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
    active, positions = _active_params(model), _step_positions(batch)
    model_flops = rl.model_flops_for("train", active, positions)
    mfu = rl.mfu(model_flops, warm)
    log(f"{label} losses {losses}; seconds per step {[round(x, 4) for x in secs]} (the first "
        f"with set-up); warm {warm:.4f} s, {tokens / warm:.1f} tokens/s; peak device memory "
        f"{peak_gb:.2f} GB; launches a step {launches}")
    log(f"{label} mfu {mfu:.4f}: 6 x {active:,} active parameters x {positions:,} positions "
        f"= {model_flops:.4e} FLOP in the warm step's {warm:.4f} s at 989e12 bf16 FLOP/s")
    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return dict(launches=launches, losses=losses, seconds=secs, warm_s=warm,
                tokens_per_s=tokens / warm, peak_gb=peak_gb, mfu=mfu,
                model_flops=model_flops), min(walls) * 1e6


def _kernel_vs_plain(label: str, model, batch, want: dict) -> dict:
    """``model``'s loss and every gradient on the card through the kernels
    (launches ``want``) against the plain path's (``_PlainPath``, which
    launches none): the relative gaps, each gradient on its own scale,
    within TRAIN_F32_REL.  A MoE's plain path takes the kernel path's
    routing (``_Routing``), so that a near tie that the two summation
    orders break apart cannot move a gradient by an expert's share; the
    tokens whose own experts differ are counted."""
    import torch
    from repro_torch.kernels import build
    params = list(model.parameters())
    results = {}
    for name in ("kernel", "plain"):
        build.reset_launches()
        if name == "plain":
            with _PlainPath(), _Routing(pin=routing.ids) as pinned:
                loss, _ = model.loss(batch)
                grads = torch.autograd.grad(loss, params)
            check(build.LAUNCHES == want_launches(),
                  f"{label}: the plain path launched {build.LAUNCHES}")
        else:
            with _Routing() as routing:
                loss, _ = model.loss(batch)
                grads = torch.autograd.grad(loss, params)
            launches = dict(build.LAUNCHES)
            check(launches == want, f"{label}: the kernel path launched {launches}, want {want}")
        results[name] = (loss.detach(), grads)
    check(len(pinned.ids) == len(routing.ids), f"{label}: {len(routing.ids)} MoE calls on the "
                                               f"kernel path, {len(pinned.ids)} on the plain")
    flips = sum(_flips(a, b) for a, b in zip(pinned.own, routing.ids))
    (lk, gk), (lp, gp) = results["kernel"], results["plain"]
    loss_rel = abs(float(lk) - float(lp)) / abs(float(lp))
    rels = {n: _rel_err(a, r) for (n, _), a, r in zip(model.named_parameters(), gk, gp)}
    worst = max((v, n) for n, v in rels.items())
    check(loss_rel <= TRAIN_F32_REL and worst[0] <= TRAIN_F32_REL,
          f"{label}: loss rel {loss_rel:.3e}, worst gradient {worst}")
    moe = (f"; {len(routing.ids)} MoE calls, the plain path's own experts differ from the "
           f"kernel path's at {flips} tokens" if routing.ids else "")
    log(f"{label}: loss {float(lk):.6f} (kernel) vs {float(lp):.6f} (plain), rel "
        f"{loss_rel:.3e}; every gradient within rel {TRAIN_F32_REL}, the worst "
        f"{worst[0]:.3e} ({worst[1]}); the kernel path's launches {launches}{moe}")
    return dict(f32_loss_rel=loss_rel, f32_grad_rel=worst[0], f32_launches=launches,
                f32_grad_rels=rels, f32_route_flips=flips)


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
    train, wall_us = _three_steps("phase7", step, batch, per_step, model)
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


def _attn_layers(cfg):
    """(the attention layers of ``cfg``'s plan, those on the client's side of
    the cut): every layer of the dense and MoE kinds, a hybrid's
    ``shared_attn`` blocks (each one layer toward the cut)."""
    from repro_torch.models import build_plan
    from repro_torch.models.model import split_plans
    kinds = ("attn_mlp", "dense_mlp", "moe", "shared_attn")
    plan = build_plan(cfg)
    client = split_plans(cfg, plan)[0]
    return (sum(sp.n for sp in plan if sp.kind in kinds),
            sum(sp.n for sp in client if sp.kind in kinds))


def _round_launches(cfg, pcfg, hist, quant, n_test, stats=False):
    """The kernel launches a sequential run_pigeon over from_lm makes, from
    the round structure: each client step runs the client's and the AP's
    layers forward (twice with remat: the backward recomputes them) and
    backward, and B4 forward and backward; each validation, handoff check
    and evaluation runs layers forward (and B4 for a validation); the cut
    width is read once.  The int8 wire quantizes each step's two messages;
    under a policy that scores message statistics the uplink of each step
    of the round's R clusters goes through B3 (the Pigeon-SL+ sub-rounds'
    steps collect none).  B4's and B5's forwards and backwards count under
    the routes ``cfg``'s tensors take (``_kernel_counters``)."""
    import math
    n, cut = _attn_layers(cfg)
    fwd = 2 if cfg.remat else 1
    m_bar = pcfg.M // pcfg.R
    steps = vals = handoffs = evals = main = 0
    for r in hist.rounds:
        main += pcfg.R * m_bar * pcfg.E
        steps += pcfg.R * m_bar * pcfg.E + (pcfg.R - 1) * m_bar * pcfg.E * r["accepted"]
        vals += pcfg.R
        handoffs += r["detections"] + int(r["accepted"])
        evals += math.ceil(n_test / pcfg.eval_batch) if "test_acc" in r else 0
    names = _kernel_counters(cfg)
    stats_launches = main if quant and stats else 0
    return want_launches(**{
        names["fused_xent"]: steps + vals, names["fused_xent_bwd"]: steps,
        names["flash_attention"]: steps * fwd * n + vals * n + handoffs * cut + evals * n + cut,
        names["flash_attention_bwd"]: steps * n,
        "quant_dequant": 2 * steps - stats_launches if quant else 0,
        "quant_dequant_stats": stats_launches})


def phase_round():
    """The Pigeon-SL round over from_lm at Qwen3-8B's full width, depth cut
    to ROUND_LAYERS (3 client + 3 AP), the train_4k settings (bf16, remat):
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
                              cut_layer=ROUND_CUT, **shape_settings(SHAPES["train_4k"]))
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
    n, cut = _attn_layers(cfg)
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
    names = _kernel_counters(cfg)
    return want_launches(**{
        names["fused_xent"]: b4f, names["fused_xent_bwd"]: b4b,
        names["flash_attention"]: b5f, names["flash_attention_bwd"]: b5b,
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
    (Qwen3-8B's width, ROUND_LAYERS: 3 client + 3 AP, train_4k settings; M 4,
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
                              cut_layer=ROUND_CUT, **shape_settings(SHAPES["train_4k"]))
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


#: phase 8c: the round step's runs (label, make_pigeon_round_step kwargs,
#: rounds) and its tolerance against the one-card step
SHARDMAP_RUNS = (("int8", dict(quant="int8"), 1), ("block2", dict(block=2), 2))
SHARDMAP_RTOL = 1e-5


def _lm_step_inputs(k: int, seed: int):
    """``k`` rounds of (R, B, S) batches of build_lm_task tokens for phase
    8b's and 8c's 2-slot steps."""
    import torch
    r, b, s = 2, TRAIN_BATCH, TRAIN_SEQ
    parts = [_train_batch(b, s, seed=seed + i) for i in range(k * r)]
    out = {name: torch.stack([p[name] for p in parts]).view(k, r, b, s)
           for name in ("tokens", "labels")}
    return out if k > 1 else {name: v[0] for name, v in out.items()}


def _load_slots(stacked, cfg, slots) -> None:
    """Slot i of ``stacked`` holds the init of seed ``slots[i]``, drawn on
    the card (phase 8b's inits)."""
    import torch
    from repro_torch.models import build_model
    plain = build_model(cfg, DEVICE)
    for i, seed in enumerate(slots):
        stacked.load_slot(i, plain.init(torch.Generator(device=DEVICE).manual_seed(seed)))
    del plain
    torch.cuda.empty_cache()


def _round_cfg():
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.shapes import SHAPES, shape_settings
    return dataclasses.replace(get_config("qwen3-8b"), n_layers=ROUND_LAYERS,
                               cut_layer=ROUND_CUT, **shape_settings(SHAPES["train_4k"]))


def _shardmap_rank(reference=None) -> dict:
    """Phase 8c on this rank (see :func:`phase_round_sharded`): each run's
    step on this rank's slots of the 2-slot model, from phase 8b's inits:
    vlosses, sel, seconds, peak memory, launches; with ``reference`` (one
    card) each run's one-card step first, on the same inits and batches."""
    import torch
    import torch.distributed as dist
    from repro_torch.core.runner import cluster_mesh
    from repro_torch.launch.steps import make_pigeon_round_step, make_pigeon_round_step_shardmap
    from repro_torch.models import build_stacked_model

    cfg, r = _round_cfg(), 2
    mesh = cluster_mesh(r)
    n = r // mesh.size
    lo = mesh.coord("pod") * n
    stacked = build_stacked_model(cfg, n, device=DEVICE)
    val = _train_batch(8, TRAIN_SEQ, seed=90)
    out = dict(rank=dist.get_rank(), world=dist.get_world_size(), slots=n,
               member=mesh.member)
    for i, (label, kw, k) in enumerate(SHARDMAP_RUNS):
        inputs = _lm_step_inputs(k, seed=100 + 10 * i)
        for which in (("vmap", "sharded") if reference else ("sharded",)):
            _load_slots(stacked, cfg, range(lo, lo + n))
            step = (make_pigeon_round_step(stacked, TRAIN_LR, **kw) if which == "vmap"
                    else make_pigeon_round_step_shardmap(stacked, mesh, TRAIN_LR, **kw))
            torch.cuda.reset_peak_memory_stats()
            (vlosses, sel), launches, seconds = _timed_run(lambda: step(inputs, val))
            out[f"{label} {which}"] = dict(
                vlosses=vlosses.reshape(k, r).tolist(), sel=sel.reshape(k).tolist(),
                launches=launches, seconds=seconds,
                peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                slots_equal=all(torch.equal(p[0], p[i]) for p in stacked.parameters()
                                for i in range(1, n)))
            # a second call on the same inputs, timed alone: the group's
            # communicators and the kernels are set up by then
            out[f"{label} {which}"]["warm_seconds"] = _timed_run(lambda: step(inputs, val))[2]
    del stacked
    torch.cuda.empty_cache()
    return out


def phase_round_sharded(batched_lm):
    """Phase 8c: phase 8b's launch-layer round (Qwen3-8B's width at 12
    layers, R = 2 slots from 8b's inits, train_4k's settings) through
    ``make_pigeon_round_step_shardmap`` over an NCCL group of every visible
    card (a group of one on one card: both slots on this rank; one slot a
    rank on two or more), int8 (block 1) and argmin in a block of 2: sel
    equal to ``make_pigeon_round_step``'s on the same inits and batches,
    vlosses within SHARDMAP_RTOL, every slot of every rank the winner, the
    launches the step's structure gives a rank's slots; seconds and peak
    memory beside 8b's steps'."""
    import numpy as np

    cfg = _round_cfg()
    if _cards() == 1:
        ranks = _on_every_card(_shardmap_rank, True)
        ref = ranks[0]
    else:
        from repro_torch.launch.mesh import group_of_one
        ranks = _on_every_card(_shardmap_rank)
        with group_of_one("nccl"):        # the one-card step, after the ranks are done
            ref = _shardmap_rank(True)
    out = dict(world=ranks[0]["world"], runs={},
               launches=ranks[0][f"{SHARDMAP_RUNS[0][0]} sharded"]["launches"])
    for label, kw, k in SHARDMAP_RUNS:
        want = ref[f"{label} vmap"]
        for res in ranks:
            got = res[f"{label} sharded"]
            name = f"phase8c {label} rank {res['rank']}"
            check(got["sel"] == want["sel"], f"{name}: sel {got['sel']} != {want['sel']}")
            gap = float(np.max(np.abs(np.asarray(got["vlosses"]) - np.asarray(want["vlosses"]))
                               / np.abs(np.asarray(want["vlosses"]))))
            check(gap <= SHARDMAP_RTOL, f"{name}: vlosses {got['vlosses']} vs "
                                        f"{want['vlosses']} ({gap!r} > {SHARDMAP_RTOL})")
            check(got["slots_equal"], f"{name}: the slots differ after the winner's "
                                      f"all-reduce")
            want_l = (_step_launches(cfg, res["slots"], k, kw.get("quant")) if res["member"]
                      else want_launches())
            check(got["launches"] == want_l, f"{name}: launches {got['launches']}, want {want_l}")
            log(f"{name}: sel {got['sel']} (one-card step {want['sel']}); vlosses "
                f"{got['vlosses']} (largest relative gap {gap!r}); {got['seconds'] / k:.3f} s "
                f"a round (first call included; one-card step {want['seconds'] / k:.3f}); "
                f"warm second call {got['warm_seconds'] / k:.3f} s a round (one-card step "
                f"{want['warm_seconds'] / k:.3f}); "
                f"peak {got['peak_gb']:.2f} GB (one-card step {want['peak_gb']:.2f}; 8b's "
                f"steps {batched_lm['round_steps']['int8']['peak_gb']:.2f}); launches "
                f"{got['launches']}; {card_line()}")
            out["runs"][f"{label} rank {res['rank']}"] = dict(
                gap=gap, s_per_round=got["seconds"] / k, peak_gb=got["peak_gb"],
                warm_s_per_round=got["warm_seconds"] / k,
                vmap_s_per_round=want["seconds"] / k,
                vmap_warm_s_per_round=want["warm_seconds"] / k, vmap_peak_gb=want["peak_gb"])
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


def _profile_report(name: str, fn, wall_us: float, steps: int, shares=None, ranges=None,
                    record=None) -> None:
    """Run ``fn`` once under torch.profiler and log the device busy share
    against the unprofiled wall time, the launches, the top device kernels
    and the top host ops; ``shares`` {label: name fragments} adds the share
    of the busy time taken by the kernels whose names hold a fragment,
    ``ranges`` {label: a ``record_function`` name} the share of the device
    time of the kernels launched within those ranges; ``record`` (a dict)
    gets each share and the idle share.  Returns the device kernels'
    profiler events."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()

    def dev_us(ev) -> float:
        return float(getattr(ev, "self_device_time_total", 0.0)
                     or getattr(ev, "self_cuda_time_total", 0.0))

    # a record_function range also appears as a device-side annotation
    # spanning its kernels: it is no kernel of its own
    annotations = set((ranges or {}).values())
    kernels = [ev for ev in events if str(ev.device_type).endswith("CUDA")
               and ev.key not in annotations]
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
    if record is not None:
        record.update(busy_ms=busy_us / 1e3,
                      idle_share=1.0 - busy_us / wall_us if busy_us else None)
    for ev in sorted(kernels, key=dev_us, reverse=True)[:8]:
        log(f"  kernel {dev_us(ev) / 1e3:8.3f} ms x{ev.count:5d}  {ev.key[:90]}")
    for label, frags in (shares or {}).items():
        part = sum(dev_us(ev) for ev in kernels if any(f in ev.key for f in frags))
        log(f"  share {label}: {part / 1e3:.3f} ms, "
            f"{part / busy_us if busy_us else float('nan'):.3f} of the busy time")
        if record is not None:
            record[label] = part / busy_us if busy_us else None
    for label, range_name in (ranges or {}).items():
        # the kernels the host ops within each range launched (a range's
        # device-side annotation also spans the gaps between them)
        part = sum(float(getattr(ev, "device_time_total", 0.0)
                         or getattr(ev, "cuda_time_total", 0.0))
                   for ev in prof.events()
                   if ev.name == range_name and not str(ev.device_type).endswith("CUDA"))
        log(f"  share {label} (the kernels launched within the {range_name!r} ranges): "
            f"{part / 1e3:.3f} ms, {part / busy_us if busy_us else float('nan'):.3f} of the "
            f"busy time")
        if record is not None:
            record[label] = part / busy_us if busy_us else None
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
    """Qwen3-8B at full width and SERVE_LAYERS layers, bf16, weights drawn
    on the card: prefill and the serve loop, with B5/B6 launch counts, the
    prefill/decode agreement, timings, peak memory and one warm decode
    step's profile; then the agreement at f32 with 4 layers."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.launch.serve import make_prompts, serve_config
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import build_model
    from repro_torch.models.transformer import run_stack

    cfg = dataclasses.replace(serve_config("qwen3-8b", full=True), n_layers=SERVE_LAYERS)
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
    rel, argmax = _agreement(pre, last)
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
    rel4, argmax4 = _agreement(pre, last)
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
    """xLSTM-1.3B at full width and XLSTM_SERVE_LAYERS blocks, bf16, weights
    drawn on the card: the prefill (a B7 launch an sLSTM block) and the
    serve loop (none), timings, peak
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
    cfg = dataclasses.replace(serve_config("xlstm-1.3b", full=True),
                              n_layers=XLSTM_SERVE_LAYERS)
    b, p, new = XLSTM_BATCH, XLSTM_PROMPT, XLSTM_NEW
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, DEVICE).init(torch.Generator(device=DEVICE).manual_seed(0))
    torch.cuda.synchronize()
    n_slstm = sum(1 for s in model.stacks if s.kind == "slstm")
    n_params = sum(x.numel() for x in model.parameters())
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

    # the same weights widened to f32: prefill and decode
    # held tightly, and each bf16 path against them
    model.float()
    build.reset_launches()
    pre32, _, last32, _, _ = _serve(model, prompts, 1)
    launches32 = dict(build.LAUNCHES)
    check(launches32 == want_launches(slstm_scan_persistent=n_slstm),
          f"phase9 f32: launches {launches32}")
    rel32, argmax32 = _agreement(pre32, last32)
    check(rel32 <= XLSTM_F32_REL, f"phase9 f32: prefill vs decode logits differ by "
                                  f"{rel32:.3e} of max |logit| > {XLSTM_F32_REL}")
    rel, argmax = _agreement(pre, last)
    pre_err, dec_err = _agreement(pre, pre32)[0], _agreement(last, last32)[0]
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
    n_slstm = sum(1 for s in model.stacks if s.kind == "slstm")
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
    train, wall_us = _three_steps("phase10", step, batch, per_step, model)
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

# ---------------------------------------------------------------------------
# phases 12-14: the vlm patch prefix and MLA/MoE (InternVL2-26B,
# DeepSeek-V2-Lite, Qwen3-30B-A3B)
# ---------------------------------------------------------------------------

def _agreement(pre, last):
    """(max |diff| / max |logit|, argmax agreement) of two logit tensors."""
    rel = float((pre.float() - last.float()).abs().max()) / float(pre.float().abs().max())
    argmax = float((pre.argmax(-1) == last.argmax(-1)).float().mean())
    return rel, argmax


def _attn_launches(cfg, prefills: int = 0, decode_steps: int = 0) -> dict:
    """The launches of ``prefills`` bf16 prefills and ``decode_steps`` decode
    steps of ``cfg``: B5 an attention layer a prefill and B6 one a step
    where the attention is GQA (a hybrid's shared blocks; an
    encoder-decoder's decoder layers, whose cross-attention is B5
    non-causal, Sq = 1 in decode, as is each encoder layer's prefill); none
    for MLA (plain PyTorch, 192/128-wide heads)."""
    if cfg.kv_lora_rank:
        return want_launches()
    if cfg.arch_type in ("audio", "encdec"):
        n_enc = cfg.n_enc_layers or cfg.n_layers
        return want_launches(
            flash_attention_tc=cfg.n_layers * prefills,
            flash_attention_tc_noncausal=(n_enc + cfg.n_layers) * prefills
            + cfg.n_layers * decode_steps,
            decode_attention_tc=cfg.n_layers * decode_steps)
    n = _attn_layers(cfg)[0]
    return want_launches(flash_attention_tc=n * prefills, decode_attention_tc=n * decode_steps)


def _train_attn_launches(cfg, tc: bool = True) -> dict:
    """B5's launches in one loss and gradient of ``cfg`` on its bf16 (``tc``)
    or f32 routes: a forward an attention layer (two under remat, which
    recomputes it) and a backward; an encoder-decoder's encoder layers and
    decoder cross-attention non-causal, its decoder self-attention causal;
    none for MLA."""
    if cfg.kv_lora_rank:
        return {}
    fwd = 2 if cfg.remat else 1
    fa = "flash_attention" + ("_tc" if tc else "")
    bwd = "flash_attention_bwd" + ("_tc" if tc else "")
    if cfg.arch_type in ("audio", "encdec"):
        nc = (cfg.n_enc_layers or cfg.n_layers) + cfg.n_layers
        return {fa: cfg.n_layers * fwd, bwd: cfg.n_layers, f"{fa}_noncausal": nc * fwd,
                f"{bwd}_noncausal": nc}
    n = _attn_layers(cfg)[0]
    return {fa: n * fwd, bwd: n}


def _kernel_counters(cfg) -> dict:
    """The counters that B5's forward and backward, B6 and B4's forward and
    backward add to on ``cfg``'s tensors: each route function's choice on
    meta tensors of the config's dtype, heads, head dim, width and vocab (a
    model's tensors are contiguous and aligned, so these decide)."""
    import torch
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_xent as fx
    dtype = getattr(torch, cfg.dtype)

    def meta(*shape):
        return torch.empty(shape, dtype=dtype, device="meta")

    d = cfg.resolved_head_dim
    q, kv = meta(1, 1, cfg.n_heads, d), meta(1, 1, cfg.n_kv_heads, d)
    h, w = meta(8, cfg.d_model), meta(cfg.d_model, cfg.vocab)
    tc = {fa.TENSOR_CORES: "_tc", fa.F32_FMA: ""}
    return dict(
        flash_attention="flash_attention" + tc[fa.attention_route(q, kv, kv)],
        flash_attention_bwd="flash_attention_bwd" + tc[fa.attention_bwd_route(q, kv, kv, q, q)],
        decode_attention="decode_attention" + tc[da.decode_route(q, kv, kv)],
        fused_xent="fused_xent" + tc[fx.xent_route(h, w)],
        fused_xent_bwd="fused_xent_bwd" + tc[fx.xent_bwd_route(h, w)])


def _xent_route(model) -> str:
    """The route B4 takes over ``model``'s head for a (T, d_model) hidden in
    the model's dtype (``fused_xent.xent_route``)."""
    import torch
    from repro_torch.kernels import fused_xent as fx
    hidden = torch.empty((8, model.cfg.d_model), dtype=model.dtype, device=DEVICE)
    return fx.xent_route(hidden, model.head.w)


def _draw_model(label: str, cfg, seed: int = 0, want_params=None):
    """``cfg``'s model drawn on the card from ``seed``; its parameter count
    held against ``want_params``: the analytic count (``param_count``), which
    leaves out the norms' scales and Qwen2.5's QKV biases."""
    import torch
    from repro_torch.models import build_model
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, DEVICE).init(torch.Generator(device=DEVICE).manual_seed(seed))
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in model.parameters())
    norms = sum(x.numel() for n, x in model.named_parameters()
                if n.endswith("scale") or n.endswith(("wq.b", "wk.b", "wv.b")))
    if want_params is not None:
        check(n_params - norms == want_params == cfg.param_count(),
              f"{label}: {n_params - norms:,} parameters besides the norms and QKV biases, "
              f"want {want_params:,} (param_count {cfg.param_count():,})")
    log(f"{label} {cfg.name}: {cfg.n_layers} layers {[(sp.kind, sp.n) for sp in model.plan]}, "
        f"d {cfg.d_model}, {cfg.dtype}: {n_params:,} parameters "
        f"({n_params * model.embedding.element_size() / 1e9:.2f} GB), drawn on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    return model


def _slice_serve(label: str, model, prefill_batch: dict, shares: dict, ranges=None,
                 rel_bound: float = SERVE_BF16_REL) -> dict:
    """The serve path of one of the slice's models: the bf16 prefill step on
    ``prefill_batch`` (warm, timed, launches counted, profiled), then the
    reference serve loop over a text prompt of SLICE_PROMPT tokens and
    SLICE_NEW greedy tokens (launches counted), its prompt logits held
    against a text prefill's within ``rel_bound``.  For a MoE
    that prefill is rerun with its routing pinned to the loop's (_Routing;
    see SLICE_F32_REL's note), and the unpinned prefill's routing flips and
    dropped pairs are reported beside its gap.  An encoder-decoder's batch
    holds its frames: the text prefill takes them, the loop their encoding
    (one more encoder pass); ``ranges`` goes to the prefill's profile."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.launch.serve import make_prompts
    from repro_torch.launch.steps import make_prefill_step

    cfg = model.cfg
    b = prefill_batch["tokens"].shape[0]
    prefill = make_prefill_step(model)
    prefill(prefill_batch)                                  # warm-up, not counted
    torch.cuda.synchronize()
    build.reset_launches()
    t0 = time.perf_counter()
    logits = prefill(prefill_batch)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    prefill_launches = dict(build.LAUNCHES)
    check(prefill_launches == _attn_launches(cfg, prefills=1),
          f"{label} prefill: launches {prefill_launches}, want {_attn_launches(cfg, 1)}")
    check(logits.shape == (b, 1, cfg.vocab) and bool(torch.isfinite(logits).all()),
          f"{label} prefill: logits {tuple(logits.shape)} not finite or misshapen")
    positions = prefill_batch["tokens"].shape[1] + (
        prefill_batch["patches"].shape[1] if "patches" in prefill_batch else 0)
    frames = prefill_batch.get("frames")
    record = {}
    _profile_report(f"{label} {cfg.name} prefill (B {b} x {positions} positions"
                    f"{'' if frames is None else f' + {frames.shape[1]} frames'}, bf16)",
                    lambda: prefill(prefill_batch), prefill_s * 1e6, 1, shares=shares,
                    ranges=ranges, record=record)
    prompts = torch.from_numpy(make_prompts(1, cfg.vocab, b, SLICE_PROMPT)).to(DEVICE)
    build.reset_launches()
    with _Routing() as routing:
        pre, gen, last, _, loop_s = _serve(model, prompts, SLICE_NEW, frames)
    loop_launches = dict(build.LAUNCHES)
    steps = SLICE_PROMPT + SLICE_NEW
    want = _attn_launches(cfg, prefills=1, decode_steps=steps)
    if frames is not None:              # the loop's memory: one more encoder pass
        want["flash_attention_tc_noncausal"] += cfg.n_enc_layers or cfg.n_layers
    check(loop_launches == want, f"{label} serve loop: launches {loop_launches}, want {want}")
    check(gen.shape == (b, SLICE_NEW) and int(gen.min()) >= 0 and int(gen.max()) < cfg.vocab,
          f"{label}: generated tokens {tuple(gen.shape)}")
    rel, argmax = _agreement(pre, last)
    out = dict(rel=rel, argmax=argmax)
    moe = ""
    if routing.ids:
        # the prefill's MoE calls, then each decode step's, layer by layer
        n = len(routing.ids) // (1 + steps)
        check(len(routing.ids) == n * (1 + steps) and n == sum(
                  sp.n for sp in model.plan if sp.kind == "moe"),
              f"{label}: {len(routing.ids)} MoE calls in the serve run, {n} layers")
        check(all(bool(k.all()) for k in routing.kept[n:]),
              f"{label}: a decode step dropped a (token, k) pair")
        loop_ids = [torch.stack([routing.ids[n * (1 + t) + layer] for t in range(SLICE_PROMPT)],
                                dim=1).reshape(b * SLICE_PROMPT, -1) for layer in range(n)]
        flips = [_flips(a, c) for a, c in zip(routing.ids[:n], loop_ids)]
        drops = [int((~k).sum()) for k in routing.kept[:n]]
        with torch.no_grad(), _Routing(pin=loop_ids, keep_all=True) as pinned:
            pinned_pre = prefill({"tokens": prompts})
        check(len(pinned.ids) == n, f"{label}: {len(pinned.ids)} MoE calls in the pinned "
                                    f"prefill, want {n}")
        out.update(unpinned_rel=rel, unpinned_argmax=argmax, flips_by_layer=flips,
                   drops_by_layer=drops)
        moe = (f"; unpinned {rel:.4e} (argmax agreement {argmax:.3f}) with the prefill's "
               f"routing against the loop's: tokens of {b * SLICE_PROMPT} whose experts "
               f"differ by MoE layer {flips}, (token, k) pairs the prefill dropped past "
               f"capacity {drops}; pinned to the loop's routing, every pair kept")
        rel, argmax = _agreement(pinned_pre, last)
        out.update(rel=rel, argmax=argmax)
    check(rel <= rel_bound, f"{label}: text prefill vs decode logits differ by {rel:.3e} "
                            f"of max |logit| > {rel_bound}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ms_step = loop_s / steps * 1e3
    log(f"{label} prefill (B {b} x {positions} positions, warm): {prefill_s:.4f} s, "
        f"launches {prefill_launches}; serve loop {steps} steps ({SLICE_PROMPT} prompt + "
        f"{SLICE_NEW} greedy) in {loop_s:.3f} s: {ms_step:.3f} ms/step, "
        f"{b * steps / loop_s:.1f} tokens/s; text prefill vs decode logits max |diff| / "
        f"max |logit| {rel:.4e} (bound {rel_bound}), argmax agreement {argmax:.3f}"
        f"{moe}; peak device memory {peak_gb:.2f} GB; greedy tokens[0] {gen[0].tolist()}")
    return dict(prefill_launches=prefill_launches, loop_launches=loop_launches,
                prefill_s=prefill_s, ms_per_step=ms_step, tokens_per_s=b * steps / loop_s,
                peak_gb=peak_gb, prefill_profile=record, **out)


def _f32_against_cpu(label: str, cfg, batch: dict, seed: int, grads: bool = False) -> dict:
    """At full width and a cut depth in f32: the model drawn on the card,
    its loss, prefill logits, (for a MoE) every layer's routing ids and
    kept pairs and (``grads``) every gradient on the card against the same
    weights and batch on the CPU (plain versions; ids and pairs equal,
    gradients within TRAIN_F32_REL but Mamba2's A_log, within
    A_LOG_GRAD_REL of the CPU's and of a float64 copy's on the CPU, beside
    which a Mamba2 model's every leaf is reported); the card's text prefill against its
    decode loop (an encoder-decoder's with the batch's frames); then the
    kernel path's loss and every gradient against the plain path's on the
    card (``_kernel_vs_plain``)."""
    import copy

    import torch
    from repro_torch.launch.steps import make_prefill_step

    model = _draw_model(label, cfg, seed)

    def run(m, dev):
        bt = {k: v.to(dev) for k, v in batch.items()}
        with torch.set_grad_enabled(grads), _Routing() as routing:
            loss = m.loss(bt)[0]
            g = [x.cpu() for x in torch.autograd.grad(loss, list(m.parameters()))] \
                if grads else []
            with torch.no_grad():
                logits = make_prefill_step(m)(bt).cpu()
        return (float(loss), logits, [x.cpu() for x in routing.ids],
                [x.cpu() for x in routing.kept], g)

    loss_c, logits_c, ids_c, kept_c, grads_c = run(model, DEVICE)
    cpu = model.to("cpu")
    loss_h, logits_h, ids_h, kept_h, grads_h = run(cpu, "cpu")
    loose = {n for n, _ in cpu.named_parameters() if grads and n.rsplit(".", 1)[-1] == "A_log"}
    if loose:
        wide = copy.deepcopy(cpu).to(torch.float64)
        with _F64():
            grads_w = torch.autograd.grad(
                wide.loss({k: v.to("cpu") for k, v in batch.items()})[0],
                list(wide.parameters()))
        del wide
    model = cpu.to(DEVICE)
    del cpu
    names = [n for n, _ in model.named_parameters()]
    grad_rels = {n: _rel_err(a, r) for n, a, r in zip(names, grads_c, grads_h)}
    tight = max(((v, n) for n, v in grad_rels.items() if n not in loose), default=(0.0, "none"))
    worst_loose = max(((grad_rels[n], n) for n in loose), default=(0.0, "none"))
    three = sorted(grad_rels.items(), key=lambda x: -x[1])[:3]
    check(tight[0] <= TRAIN_F32_REL,
          f"{label}: card vs CPU gradient {tight} > {TRAIN_F32_REL}, the three worst {three}")
    witness, f64 = "", {}
    if loose:
        card_w = {n: _rel_err(a, r) for n, a, r in zip(names, grads_c, grads_w)}
        cpu_w = {n: _rel_err(a, r) for n, a, r in zip(names, grads_h, grads_w)}
        for n in loose:
            check(grad_rels[n] <= A_LOG_GRAD_REL and card_w[n] <= A_LOG_GRAD_REL,
                  f"{label}: {n} card vs CPU {grad_rels[n]:.3e}, card vs float64 "
                  f"{card_w[n]:.3e} > {A_LOG_GRAD_REL}")
        rest = [n for n in names if n not in loose]
        f64 = dict(f32_grad_rel_card_vs_f64=max(card_w[n] for n in rest),
                   f32_grad_rel_cpu_vs_f64=max(cpu_w[n] for n in rest),
                   a_log_rels={n: [grad_rels[n], card_w[n], cpu_w[n]] for n in sorted(loose)})
        witness = (
            f"; against a float64 copy on the CPU, outside A_log: the card "
            f"{f64['f32_grad_rel_card_vs_f64']:.3e}, the CPU "
            f"{f64['f32_grad_rel_cpu_vs_f64']:.3e} at worst"
            + "; A_log by layer (card vs CPU / card vs float64 / CPU vs float64): "
            + ", ".join(f"{n.split('.mixer')[0]} {a:.3e} / {b:.3e} / {c:.3e}"
                        for n, (a, b, c) in f64["a_log_rels"].items()))
    loss_rel = abs(loss_c - loss_h) / abs(loss_h)
    logit_rel = float((logits_c - logits_h).abs().max()) / float(logits_h.abs().max())
    same = [float((a == b).float().mean()) for a, b in zip(ids_c, ids_h)]
    drops = [int((~k).sum()) for k in kept_h]
    check(loss_rel <= SLICE_F32_REL and logit_rel <= SLICE_F32_REL,
          f"{label}: card vs CPU loss rel {loss_rel:.3e}, prefill logits rel {logit_rel:.3e} "
          f"> {SLICE_F32_REL}")
    check(len(ids_c) == len(ids_h) and all(torch.equal(a, b) for a, b in zip(ids_c, ids_h))
          and all(torch.equal(a, b) for a, b in zip(kept_c, kept_h)),
          f"{label}: card vs CPU routing ids equal by MoE call {same}; dropped pairs card "
          f"{[int((~k).sum()) for k in kept_c]}, CPU {drops}")
    text = batch["tokens"][:, :8].to(DEVICE)
    frames = batch["frames"].to(DEVICE) if "frames" in batch else None
    pre, _, last, _, _ = _serve(model, text, 1, frames)
    rel, argmax = _agreement(pre, last)
    check(rel <= SERVE_F32_REL, f"{label}: f32 prefill vs decode logits differ by {rel:.3e}")
    log(f"{label} {cfg.name} f32, {cfg.n_layers} layers, full width: card vs CPU loss "
        f"{loss_c:.6f} vs {loss_h:.6f} (rel {loss_rel:.3e}), prefill logits rel "
        f"{logit_rel:.3e} (bound {SLICE_F32_REL}); routing ids and kept pairs equal at each "
        f"of {len(ids_c)} MoE calls (the loss's, then the prefill's), (token, k) pairs "
        f"dropped past capacity {drops}; text prefill vs decode on the card rel {rel:.3e} "
        f"(bound {SERVE_F32_REL}), argmax agreement {argmax:.3f}"
        + (f"; every gradient card vs CPU within rel {TRAIN_F32_REL}"
           + (f" but A_log's (within {A_LOG_GRAD_REL}: {worst_loose[0]:.3e})" if loose else "")
           + f", the worst {tight[0]:.3e} ({tight[1]}){witness}" if grads else ""))
    kernel = _kernel_vs_plain(
        f"{label} {cfg.name} f32, {cfg.n_layers} layers, full width, gradients", model,
        {k: v.to(DEVICE) for k, v in batch.items()},
        want_launches(**_train_attn_launches(cfg, tc=False), fused_xent=1, fused_xent_bwd=1))
    del model
    torch.cuda.empty_cache()
    return dict(f32_loss_rel=loss_rel, f32_logit_rel=logit_rel, f32_drops=drops,
                f32_decode_rel=rel, f32_kernel_vs_plain_loss_rel=kernel["f32_loss_rel"],
                f32_grad_rel=kernel["f32_grad_rel"], f32_launches=kernel["f32_launches"],
                f32_route_flips=kernel["f32_route_flips"],
                **({"f32_grad_rel_card_vs_cpu": tight[0],
                    "f32_a_log_rel_card_vs_cpu": worst_loose[0], **f64} if grads else {}))


def phase_vlm():
    """Phase 12: InternVL2-26B (the vlm patch prefix on the dense stack).
    Served at full width and depth (48 layers, bf16): a prefill of 4 x (256
    patch embeddings drawn from a seed + 224 text tokens), 48 B5 launches;
    the serve loop on text (48 B6 launches a step).  Trained at
    VLM_TRAIN_LAYERS (48 layers: theta and its gradient alone are 79 GB) on
    4 x (256 patches + 256 tokens), remat, three SGD steps.  At 2 layers in
    f32, the card's loss and prefill logits with patches against the CPU's."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import make_prompts, serve_config
    from repro_torch.launch.shapes import SHAPES, shape_settings
    from repro_torch.launch.steps import make_train_step

    t_phase = time.perf_counter()
    cfg = serve_config(VLM_ARCH, full=True)
    model = _draw_model("phase12", cfg, 0, VLM_PARAMS)
    b, npx = SERVE_BATCH, cfg.n_prefix_tokens
    g = torch.Generator(device=DEVICE).manual_seed(3)
    patches = torch.randn((b, npx, cfg.d_model), generator=g, device=DEVICE).to(model.dtype)
    text = torch.from_numpy(make_prompts(0, cfg.vocab, b, VLM_TEXT)).to(DEVICE)
    serve = _slice_serve("phase12", model, {"tokens": text, "patches": patches},
                         shares={"B5 forward": ("flash_fwd_tc_kernel",)})
    del model
    torch.cuda.empty_cache()

    tcfg = dataclasses.replace(get_config(VLM_ARCH), n_layers=VLM_TRAIN_LAYERS,
                               **shape_settings(SHAPES["train_4k"]))
    model = _draw_model("phase12 train", tcfg, 1)
    batch = _train_batch(TRAIN_BATCH, TRAIN_SEQ - npx)
    batch["patches"] = torch.randn((TRAIN_BATCH, npx, tcfg.d_model), generator=g,
                                   device=DEVICE).to(model.dtype)
    step = make_train_step(model, TRAIN_LR)
    # B4's route by its rule: InternVL2's vocab of 92,553 is no multiple of
    # 8, so TMA cannot read the head and B4 takes its f32-FMA route
    xent = "fused_xent" + ("_tc" if _xent_route(model) == "tensor_cores" else "")
    per_step = want_launches(flash_attention_tc=tcfg.n_layers * 2,
                             flash_attention_bwd_tc=tcfg.n_layers,
                             **{xent: 1, xent.replace("xent", "xent_bwd"): 1})
    train, wall_us = _three_steps("phase12 train", step, batch, per_step, model)
    _profile_report(f"phase12 {tcfg.name} train step ({tcfg.n_layers} layers, B "
                    f"{TRAIN_BATCH} x ({npx} patches + {TRAIN_SEQ - npx} tokens), bf16, remat)",
                    lambda: step(batch), wall_us, 1,
                    shares={"B5 forward": ("flash_fwd_tc_kernel",),
                            "B5 backward": ("flash_bwd_dkdv_tc_kernel", "flash_bwd_dq_tc_kernel",
                                            "flash_bwd_delta_kernel"),
                            "B4 (f32-FMA route)": ("xent_fwd_kernel", "xent_combine_kernel",
                                                   "xent_grad"),
                            "f32 products (SIMT SGEMM)": ("sgemm",)})
    del model, step, batch
    torch.cuda.empty_cache()

    fcfg = dataclasses.replace(get_config(VLM_ARCH), n_layers=VLM_F32_LAYERS)
    rng = torch.Generator().manual_seed(4)
    small = {"tokens": torch.randint(0, TRAIN_VOCAB, (1, VLM_F32_TEXT), generator=rng),
             "labels": torch.randint(0, TRAIN_VOCAB, (1, VLM_F32_TEXT), generator=rng),
             "patches": torch.randn((1, VLM_F32_PATCHES, fcfg.d_model), generator=rng)}
    f32 = _f32_against_cpu("phase12 f32", fcfg, small, 5)
    out = dict(serve=serve, train=train, **f32, seconds=time.perf_counter() - t_phase)
    log(f"phase12 took {out['seconds']:.1f} s")
    return out


def phase_moe():
    """Phase 13: MLA and MoE.  DeepSeek-V2-Lite and Qwen3-30B-A3B served at
    full width and depth (bf16): a 4 x 480 prefill and the serve loop
    (DeepSeek's on the MLA latent cache, no attention kernel; Qwen3's
    through B5 and B6).  DeepSeek-V2-Lite trained at full depth (4 x 512,
    remat, three SGD steps), with the (token, k) pairs dropped past capacity
    at each MoE layer of the train batch; at a cut depth in f32, each model's
    loss, prefill logits and routing on the card against the CPU's."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import make_prompts, serve_config
    from repro_torch.launch.shapes import SHAPES, shape_settings
    from repro_torch.launch.steps import make_train_step

    t_phase = time.perf_counter()
    out = {}
    for arch, want_params, label in (("deepseek-v2-lite-16b", DSV2_PARAMS, "dsv2"),
                                     ("qwen3-moe-30b-a3b", QMOE_PARAMS, "qmoe")):
        cfg = serve_config(arch, full=True)
        model = _draw_model(f"phase13 {label}", cfg, 0, want_params)
        prompts = torch.from_numpy(make_prompts(0, cfg.vocab, SERVE_BATCH, SERVE_PROMPT))
        shares = {"bf16 products (cuBLAS)": ("nvjet", "gemm", "bf16")}
        if not cfg.kv_lora_rank:
            shares["B5 forward"] = ("flash_fwd_tc_kernel",)
        out[label] = _slice_serve(f"phase13 {label}", model, {"tokens": prompts.to(DEVICE)},
                                  shares)
        if label == "qmoe":
            out["qmoe_moe_shard"] = _moe_shard_prefill(model)
        del model
        torch.cuda.empty_cache()

    tcfg = dataclasses.replace(get_config("deepseek-v2-lite-16b"), n_layers=DSV2_TRAIN_LAYERS,
                               **shape_settings(SHAPES["train_4k"]))
    model = _draw_model("phase13 dsv2 train", tcfg, 1)
    batch = _train_batch(TRAIN_BATCH, TRAIN_SEQ)
    step = make_train_step(model, TRAIN_LR)
    with _Routing() as routing:
        train, wall_us = _three_steps("phase13 dsv2 train", step, batch,
                                      want_launches(fused_xent_tc=1, fused_xent_bwd_tc=1),
                                      model)
    # the first step's forward: its MoE calls come first, layer by layer
    n_moe = sum(sp.n for sp in model.plan if sp.kind == "moe")
    drops = [int((~k).sum()) for k in routing.kept[:n_moe]]
    _profile_report(f"phase13 {tcfg.name} train step ({tcfg.n_layers} layers, B {TRAIN_BATCH} "
                    f"x {TRAIN_SEQ}, bf16, remat)", lambda: step(batch), wall_us, 1,
                    shares={"B4": ("xent_fwd_tc_kernel", "xent_combine_kernel",
                                   "xent_bwd_tc_kernel")})
    log(f"phase13 dsv2 train batch: (token, k) pairs dropped past capacity by MoE layer "
        f"{drops} of {TRAIN_BATCH * TRAIN_SEQ * tcfg.top_k} a layer (capacity "
        f"{_capacity(tcfg, TRAIN_BATCH * TRAIN_SEQ)} an expert)")
    train["drops_by_layer"] = drops
    out["dsv2_train"] = train
    del model, step, batch
    torch.cuda.empty_cache()

    for arch, layers, label in (("deepseek-v2-lite-16b", DSV2_F32_LAYERS, "dsv2"),
                                ("qwen3-moe-30b-a3b", QMOE_F32_LAYERS, "qmoe")):
        fcfg = dataclasses.replace(get_config(arch), n_layers=layers)
        rng = torch.Generator().manual_seed(6)
        small = {name: torch.randint(0, TRAIN_VOCAB, (1, MOE_F32_TOKENS), generator=rng)
                 for name in ("tokens", "labels")}
        out[label].update(_f32_against_cpu(f"phase13 {label} f32", fcfg, small, 7))
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase13 took {out['seconds']:.1f} s")
    return out


def _capacity(cfg, tokens: int) -> int:
    from repro_torch.models.moe import capacity
    from repro_torch.models.transformer import moe_cfg
    return capacity(tokens, moe_cfg(cfg))


def phase_moe_round():
    """Phase 14: the Pigeon-SL round over from_lm at DeepSeek-V2-Lite's full
    width, depth cut to MOE_ROUND_LAYERS (theta about a 12-layer
    Qwen3-8B; R = 2 candidates and gradients), phase 8's task and protocol
    (M 4, N 1, T 2, E 2, B 4, label flip on client 0, Pigeon-SL+): no wire,
    and int8 under loss_plus_distance, each on the sequential and the
    batched engine (the cluster-stacked MoE, each slot routed as its plain
    model) from one init.  Decisions equal; launches as the rounds'
    structure predicts (no attention kernel: MLA); seconds a round and peak
    memory."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import LABEL_FLIP, Attack, ProtocolConfig, from_lm
    from repro_torch.data import build_lm_task
    from repro_torch.launch.shapes import SHAPES, shape_settings
    from repro_torch.models import build_model

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config("deepseek-v2-lite-16b"), n_layers=MOE_ROUND_LAYERS,
                              cut_layer=MOE_ROUND_CUT, **shape_settings(SHAPES["train_4k"]))
    data = build_lm_task(**ROUND_TASK)
    model = build_model(cfg, DEVICE)
    n_params = sum(x.numel() for x in model.parameters())
    log(f"phase14 {cfg.name}: {cfg.n_layers} layers (cut {cfg.cut_layer}) "
        f"{[(sp.kind, sp.n) for sp in model.plan]}, {cfg.dtype}, remat={cfg.remat}: "
        f"{n_params:,} parameters ({n_params * 2 / 1e9:.2f} GB a copy)")
    pcfg = ProtocolConfig(M=4, N=1, T=2, E=2, B=4, lr=1e-3)
    no_attn = dict.fromkeys(("flash_attention_tc", "flash_attention_bwd_tc"), 0)
    out = {}
    for quant, selection in MOE_ROUND_RUNS:
        hists = {}
        for engine in ("sequential", "batched"):
            key = f"{engine}_{quant}_{selection}"
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            name = f"phase14 round {engine} quant={quant} selection={selection}"
            hist, launches, seconds = _run(name, from_lm(model), data, pcfg, malicious={0},
                                           attack=Attack(LABEL_FLIP), plus=True,
                                           selection=selection, quant=quant, engine=engine,
                                           device=DEVICE)
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            stats = selection != "argmin"
            count = _batched_round_launches if engine == "batched" else _round_launches
            want = {**count(cfg, pcfg, hist, quant, data.x_test.shape[0], stats=stats),
                    **no_attn}
            check(launches == want, f"{name}: launches {launches}, want {want}")
            log(f"{name}: {seconds / pcfg.T:.2f} s/round (init and first-call set-up "
                f"included); peak device memory {peak_gb:.2f} GB")
            hists[engine] = hist
            out[key] = dict(launches=launches, s_per_round=seconds / pcfg.T, peak_gb=peak_gb)
        for rb, rs in zip(hists["batched"].rounds, hists["sequential"].rounds):
            for k in ROUND_DECISIONS:
                check(rb[k] == rs[k], f"phase14 quant={quant} round {rb['round']}: {k} "
                                      f"batched={rb[k]} sequential={rs[k]}")
        gap = _round_float_gap(hists["batched"], hists["sequential"])
        out[f"batched_{quant}_{selection}"]["float_gap"] = gap
        log(f"phase14 quant={quant} selection={selection}: decisions equal on both engines; "
            f"largest float gap {gap:.3e}")
    del model
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase14 took {out['seconds']:.1f} s")
    return out


class _SSDRange:
    """Within the block, every Mamba2 SSD chunk (``models/ssm.py::
    _ssd_chunk``) runs inside a ``record_function`` range named
    :data:`SSD_RANGE`, which ``_profile_report``'s ``ranges`` reads."""

    def __enter__(self):
        from torch.profiler import record_function
        from repro_torch.models import ssm
        self.saved = chunk = ssm._ssd_chunk

        def ranged(*args):
            with record_function(SSD_RANGE):
                return chunk(*args)

        ssm._ssd_chunk = ranged
        return self

    def __exit__(self, *exc):
        from repro_torch.models import ssm
        ssm._ssd_chunk = self.saved


def _count_params(label: str, model, want: int) -> int:
    """All of ``model``'s parameters, held against ``want`` (the reference's
    count of the same layers)."""
    n = sum(p.numel() for p in model.parameters())
    check(n == want, f"{label}: {n:,} parameters, want {want:,}")
    return n


def phase_zamba2():
    """Phase 15: Zamba2-1.2B (Mamba2 and shared attention blocks).  Served
    at full width and depth (38 Mamba2 layers and 6 blocks, bf16): a 4 x 512
    prefill, 6 B5 launches, profiled with the SSD's share of the busy time;
    the serve loop (6 B6 launches a step) against a text prefill.  Trained
    at full depth under train_4k's settings (ssm_chunk 512, remat) on 4 x
    512, three SGD steps (12 B5 forwards, 6 backwards, B4 on its
    tensor-core route each way a step), profiled.  At 4 Mamba2 layers in
    f32, the card's loss, gradients and prefill logits against the CPU's."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import make_prompts, serve_config
    from repro_torch.launch.shapes import SHAPES, shape_settings
    from repro_torch.launch.steps import make_train_step

    t_phase = time.perf_counter()
    cfg = serve_config(ZAMBA2_ARCH, full=True)
    model = _draw_model("phase15", cfg, 0)
    _count_params("phase15", model, ZAMBA2_PARAMS)
    check(sum(sp.kind == "shared_attn" for sp in model.plan) == 6
          and sum(sp.n for sp in model.plan if sp.kind == "mamba") == 38,
          f"phase15: plan {[(sp.kind, sp.n) for sp in model.plan]}")
    prompts = torch.from_numpy(make_prompts(0, cfg.vocab, SERVE_BATCH, ZAMBA2_PROMPT))
    with _SSDRange():
        serve = _slice_serve("phase15", model, {"tokens": prompts.to(DEVICE)},
                             shares={"B5 forward": ("flash_fwd_tc_kernel",),
                                     "bf16 products (cuBLAS)": ("nvjet", "gemm", "bf16")},
                             ranges={"the SSD chunk scan (plain PyTorch)": SSD_RANGE},
                             rel_bound=ZAMBA2_BF16_REL)
    del model
    torch.cuda.empty_cache()

    tcfg = dataclasses.replace(get_config(ZAMBA2_ARCH), **shape_settings(SHAPES["train_4k"]))
    model = _draw_model("phase15 train", tcfg, 1)
    batch = _train_batch(TRAIN_BATCH, TRAIN_SEQ)
    step = make_train_step(model, TRAIN_LR)
    check(_xent_route(model) == "tensor_cores", "phase15: B4 should take the tensor cores at "
                                                "vocab 32,000")
    per_step = want_launches(**_train_attn_launches(tcfg), fused_xent_tc=1, fused_xent_bwd_tc=1)
    train, wall_us = _three_steps("phase15 train", step, batch, per_step, model)
    record = {}
    with _SSDRange():
        _profile_report(f"phase15 {tcfg.name} train step ({tcfg.n_layers} Mamba2 layers, B "
                        f"{TRAIN_BATCH} x {TRAIN_SEQ}, bf16, remat, ssm_chunk {tcfg.ssm_chunk})",
                        lambda: step(batch), wall_us, 1,
                        shares={"B5 forward": ("flash_fwd_tc_kernel",),
                                "B5 backward": ("flash_bwd_dkdv_tc_kernel",
                                                "flash_bwd_dq_tc_kernel",
                                                "flash_bwd_delta_kernel"),
                                "B4": ("xent_fwd_tc_kernel", "xent_combine_kernel",
                                       "xent_bwd_tc_kernel")},
                        ranges={"the SSD chunk scan (plain PyTorch)": SSD_RANGE},
                        record=record)
    train["profile"] = record
    del model, step, batch
    torch.cuda.empty_cache()

    fcfg = dataclasses.replace(get_config(ZAMBA2_ARCH), **ZAMBA2_F32)
    rng = torch.Generator().manual_seed(9)
    small = {name: torch.randint(0, TRAIN_VOCAB, (1, SLICE_F32_TOKENS), generator=rng)
             for name in ("tokens", "labels")}
    f32 = _f32_against_cpu("phase15 f32", fcfg, small, 10, grads=True)
    out = dict(serve=serve, train=train, **f32, seconds=time.perf_counter() - t_phase)
    log(f"phase15 took {out['seconds']:.1f} s")
    return out


def phase_zamba2_round():
    """Phase 16: the Pigeon-SL round over from_lm at Zamba2-1.2B's full
    width, depth cut to ZAMBA2_ROUND_LAYERS Mamba2 layers with the published
    cut at 10 (each half holds a shared block), phase 8's task, protocol
    and runs (no wire, int8, int8 under loss_plus_distance), each on the
    sequential and the batched engine (the cluster-stacked Zamba2: Mamba2 a
    call a slot, the shared blocks through B5 over the folded slots) from
    one init: decisions equal, launches as the rounds' structure predicts
    (B1 once a batched round, on the bf16 route), seconds a round and peak
    memory."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import LABEL_FLIP, Attack, ProtocolConfig, from_lm
    from repro_torch.data import build_lm_task
    from repro_torch.launch.shapes import SHAPES, shape_settings
    from repro_torch.models import build_model

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config(ZAMBA2_ARCH), n_layers=ZAMBA2_ROUND_LAYERS,
                              cut_layer=ZAMBA2_ROUND_CUT, **shape_settings(SHAPES["train_4k"]))
    data = build_lm_task(**ROUND_TASK)
    model = build_model(cfg, DEVICE)
    client, ap, _ = model.split_plans()
    check([(p.kind, p.n) for p in client] == [("mamba", 6), ("shared_attn", 1), ("mamba", 3)]
          and [(p.kind, p.n) for p in ap] == [("mamba", 3), ("shared_attn", 1), ("mamba", 1)],
          f"phase16: the cut gives {client} | {ap}")
    n_params = sum(x.numel() for x in model.parameters())
    log(f"phase16 {cfg.name}: {cfg.n_layers} Mamba2 layers (cut {cfg.cut_layer}) "
        f"{[(sp.kind, sp.n) for sp in model.plan]}, client {[(p.kind, p.n) for p in client]}, "
        f"AP {[(p.kind, p.n) for p in ap]}, {cfg.dtype}, remat={cfg.remat}: {n_params:,} "
        f"parameters ({n_params * 2 / 1e9:.2f} GB a copy)")
    pcfg = ProtocolConfig(M=4, N=1, T=2, E=2, B=4, lr=1e-3)
    out = {}
    for quant, selection in ROUND_RUNS:
        hists = {}
        for engine in ("sequential", "batched"):
            key = f"{engine}_{quant}_{selection}"
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            name = f"phase16 round {engine} quant={quant} selection={selection}"
            hist, launches, seconds = _run(name, from_lm(model), data, pcfg, malicious={0},
                                           attack=Attack(LABEL_FLIP), plus=True,
                                           selection=selection, quant=quant, engine=engine,
                                           device=DEVICE)
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            count = _batched_round_launches if engine == "batched" else _round_launches
            want = count(cfg, pcfg, hist, quant, data.x_test.shape[0],
                         stats=selection != "argmin")
            check(launches == want, f"{name}: launches {launches}, want {want}")
            log(f"{name}: {seconds / pcfg.T:.2f} s/round (init and first-call set-up "
                f"included); peak device memory {peak_gb:.2f} GB")
            hists[engine] = hist
            out[key] = dict(launches=launches, s_per_round=seconds / pcfg.T, peak_gb=peak_gb)
        for rb, rs in zip(hists["batched"].rounds, hists["sequential"].rounds):
            for k in ROUND_DECISIONS:
                check(rb[k] == rs[k], f"phase16 quant={quant} round {rb['round']}: {k} "
                                      f"batched={rb[k]} sequential={rs[k]}")
        gap = _round_float_gap(hists["batched"], hists["sequential"])
        out[f"batched_{quant}_{selection}"]["float_gap"] = gap
        log(f"phase16 quant={quant} selection={selection}: decisions equal on both engines; "
            f"largest float gap {gap:.3e}")
    del model
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase16 took {out['seconds']:.1f} s")
    return out


def phase_seamless():
    """Phase 17: SeamlessM4T-medium (the encoder-decoder).  Served at full
    width and depth (12 + 12 layers, bf16): 4 x 256 frame embeddings drawn
    from a seed, a 4 x 256 prefill with them (the encoder's 12 layers and
    the decoder's cross-attention through B5 non-causal, its
    self-attention causal), profiled; the serve loop on their memory (Sk
    256: per step 12 B6 and 12 non-causal B5 launches with Sq = 1) against a
    text prefill.  Trained on 4 x (256 frames + 256 tokens), remat, three
    SGD steps: per step 48 non-causal and 24 causal B5 forwards, 24 and 12
    backwards, B4 on its f32-FMA route (vocab 256,206 is no multiple of 8)
    each way.  At 2 + 2 layers in f32, the card's loss, gradients and
    prefill logits against the CPU's."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import make_prompts, serve_config
    from repro_torch.launch.shapes import SHAPES, shape_settings
    from repro_torch.launch.steps import make_train_step

    t_phase = time.perf_counter()
    cfg = serve_config(SEAMLESS_ARCH, full=True)
    model = _draw_model("phase17", cfg, 0)
    _count_params("phase17", model, SEAMLESS_PARAMS)
    g = torch.Generator(device=DEVICE).manual_seed(11)
    frames = torch.randn((SERVE_BATCH, SEAMLESS_FRAMES, cfg.d_model), generator=g,
                         device=DEVICE).to(model.dtype)
    tokens = torch.from_numpy(make_prompts(0, cfg.vocab, SERVE_BATCH, SEAMLESS_TOKENS))
    b5 = ("flash_fwd_tc_kernel",)
    serve = _slice_serve("phase17", model, {"tokens": tokens.to(DEVICE), "frames": frames},
                         shares={"B5 forward (both modes)": b5,
                                 "bf16 products (cuBLAS)": ("nvjet", "gemm", "bf16")})
    del model, frames
    torch.cuda.empty_cache()

    tcfg = dataclasses.replace(get_config(SEAMLESS_ARCH), **shape_settings(SHAPES["train_4k"]))
    model = _draw_model("phase17 train", tcfg, 1)
    batch = _train_batch(TRAIN_BATCH, SEAMLESS_TOKENS)
    batch["frames"] = torch.randn((TRAIN_BATCH, SEAMLESS_FRAMES, tcfg.d_model), generator=g,
                                  device=DEVICE).to(model.dtype)
    step = make_train_step(model, TRAIN_LR)
    check(_xent_route(model) == "f32_fma", "phase17: B4 should take its f32-FMA route at "
                                           "vocab 256,206")
    per_step = want_launches(**_train_attn_launches(tcfg), fused_xent=1, fused_xent_bwd=1)
    train, wall_us = _three_steps("phase17 train", step, batch, per_step, model)
    record = {}
    _profile_report(f"phase17 {tcfg.name} train step (12 + 12 layers, B {TRAIN_BATCH} x "
                    f"({SEAMLESS_FRAMES} frames + {SEAMLESS_TOKENS} tokens), bf16, remat)",
                    lambda: step(batch), wall_us, 1,
                    shares={"B5 forward (both modes)": b5,
                            "B5 backward (both modes)": ("flash_bwd_dkdv_tc_kernel",
                                                         "flash_bwd_dq_tc_kernel",
                                                         "flash_bwd_delta_kernel"),
                            "B4 (f32-FMA route)": ("xent_fwd_kernel", "xent_combine_kernel",
                                                   "xent_grad"),
                            "f32 products (SIMT SGEMM)": ("sgemm",)},
                    record=record)
    train["profile"] = record
    del model, step, batch
    torch.cuda.empty_cache()

    fcfg = dataclasses.replace(get_config(SEAMLESS_ARCH), **SEAMLESS_F32)
    rng = torch.Generator().manual_seed(12)
    small = {name: torch.randint(0, TRAIN_VOCAB, (1, SLICE_F32_TOKENS), generator=rng)
             for name in ("tokens", "labels")}
    small["frames"] = torch.randn((1, SEAMLESS_F32_FRAMES, fcfg.d_model), generator=rng)
    f32 = _f32_against_cpu("phase17 f32", fcfg, small, 13, grads=True)
    out = dict(serve=serve, train=train, **f32, seconds=time.perf_counter() - t_phase)
    log(f"phase17 took {out['seconds']:.1f} s")
    return out


#: phase 18b: AdamW under a warmup-cosine schedule with weight decay, after
#: the global-norm clip, three steps on one train step's gradients
OPT_LR, OPT_WARMUP, OPT_TOTAL, OPT_WD, OPT_CLIP, OPT_STEPS = 3e-4, 2, 100, 0.1, 1.0, 3
#: the leaves held against the CPU: the largest and a few small ones, each
#: on its first rows along dim 0, up to OPT_CPU_ELEMS elements (AdamW acts
#: element by element, so rows of a leaf check it as the whole leaf does;
#: with whole leaves, the largest 262,354,944 elements, the CPU's part took
#: 42.4-55.8 s a run on the H100 hosts)
OPT_SAMPLE = 6
OPT_CPU_ELEMS = 1 << 22
#: the card's optimizer against the CPU's: each bf16 update within one bf16
#: ulp of the larger (2**-7 of |u|, the f32 updates rounded apart), m, v and
#: the global norm within rtol 1e-5 (the sums' order differs)
OPT_UPDATE_REL, OPT_STATE_RTOL = 2.0 ** -7, 1e-5


def _phase_audit() -> dict:
    """Phase 18a: every ``analysis.programs`` cell on CUDA tensors, each
    entry under ``set_sync_debug_mode("error")`` (``program_audit``): no
    float64, no host read, the carry in place, the pinned fetch; zero
    findings.  Each cell's launches by kernel (``build.LAUNCHES`` deltas)
    against the ``@cuda`` rows of ``analysis/torch/budgets/programs.json``,
    the driver cells' against ``compile_counts.json``'s; a repeat driver
    cell builds no library again."""
    from repro_torch.analysis import budgets
    from repro_torch.analysis.programs import build_context, select_cells

    ctx = build_context(DEVICE)
    compiles, findings = budgets.measure_compile_counts(ctx)
    # each sharded cell runs in a group of one rank, closed after it
    programs, audit_findings = budgets.measure_program_budgets(ctx, select_cells())
    findings += audit_findings
    check(not findings, "phase18a: " + "; ".join(f.located() for f in findings))
    out = {}
    for filename, rows, fields in (
            (budgets.PROGRAMS_FILE, programs, ("launches", "host_transfers", "fetch_leaves",
                                              "carried_in_place", "kernel_entries")),
            (budgets.COMPILES_FILE, compiles, ("launches",))):
        pinned = budgets.load_budget(budgets.budget_path(str(ROOT), filename))["cells"]
        for key, row in rows.items():
            want = pinned.get(key)
            check(want is not None, f"phase18a: no pinned row {key} in {filename}")
            for field in fields:
                check(row[field] == want[field], f"phase18a {key}: {field} {row[field]}, "
                                                 f"pinned {want[field]}")
            extra = (f"; aten ops {row['aten_ops']} (pinned {want['aten_ops']})"
                     if "aten_ops" in row else f"; library builds {row['library_builds']}")
            log(f"phase18a {key}: launches {row['launches']}{extra}")
            out[key] = row
    return out


def _phase_optimizer_and_dryrun() -> dict:
    """Phases 18b and 18c on SeamlessM4T-medium at phase 17's train shape
    (full width and depth, bf16, remat; 4 x (256 frames + 256 tokens)).

    18c: the dry run (``launch/dryrun.py::analyze``) of the train step on
    the meta device at this shape: its argument bytes equal the card's
    bytes of the parameters and the batch; its temp-bytes estimate beside
    the peak the card allocates over one train step; its FLOPs and the
    step's mfu.

    18b: one train step's gradients (B4 and B5 forward and backward),
    then ``clip_by_global_norm`` and ``adamw(warmup_cosine(...),
    weight_decay > 0)`` for three steps on the card under
    ``set_sync_debug_mode("error")``, against the same optimizer on the CPU
    for a sample of leaves that includes the largest: the updates, m, v and
    the global norm (OPT_UPDATE_REL, OPT_STATE_RTOL).  The optimizer step's
    device time (CUDA events) and the memory m and v add."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch import roofline as rl
    from repro_torch.launch.shapes import SHAPES, InputShape, shape_settings
    from repro_torch.launch.steps import LoweringSpec, batch_struct, make_train_step
    from repro_torch.models.model import Model, build_plan
    from repro_torch.optim import adamw, apply_updates, clip_by_global_norm, warmup_cosine

    tcfg = dataclasses.replace(get_config(SEAMLESS_ARCH), **shape_settings(SHAPES["train_4k"]))
    shape = InputShape("phase17_train", SEAMLESS_FRAMES + SEAMLESS_TOKENS, TRAIN_BATCH, "train")
    meta_model = Model(tcfg, build_plan(tcfg), torch.device("meta"))
    meta_batch = batch_struct(tcfg, shape)
    spec = LoweringSpec(make_train_step(meta_model, TRAIN_LR), (meta_batch,), meta_model)
    positions = _step_positions(meta_batch)
    dry = dryrun.analyze(spec, spec.args, "train", positions, tcfg.active_param_count())

    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    model = _draw_model("phase18", tcfg, 1)
    g = torch.Generator(device=DEVICE).manual_seed(18)
    batch = {k: (torch.randn(v.shape, generator=g, device=DEVICE).to(v.dtype)
                 if v.is_floating_point() else
                 torch.randint(0, TRAIN_VOCAB, v.shape, generator=g, device=DEVICE,
                               dtype=v.dtype)) for k, v in meta_batch.items()}
    torch.cuda.synchronize()
    allocated = torch.cuda.memory_allocated() - before
    state = list(model.parameters()) + list(model.buffers()) + list(batch.values())
    card_bytes = sum(t.untyped_storage().nbytes() for t in state)
    arg_bytes = dry["memory"]["argument_bytes"]
    check(arg_bytes == card_bytes, f"phase18c: the dry run's argument bytes {arg_bytes:,} "
                                   f"!= the card's {card_bytes:,} (parameters and batch)")
    step = make_train_step(model, TRAIN_LR)
    step(batch)                                 # warm: the first call's set-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    step(batch)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    temp = dry["memory"]["temp_bytes"]
    mfu = rl.mfu(dry["roofline"]["model_flops"], step_s)
    log(f"phase18c {tcfg.name} train step at {TRAIN_BATCH} x ({SEAMLESS_FRAMES} frames + "
        f"{SEAMLESS_TOKENS} tokens): argument bytes {arg_bytes:,} (dry run) = {card_bytes:,} "
        f"(the card's parameters and batch; allocator {allocated:,}); temp bytes "
        f"{temp:,} (dry run) beside the card's peak over one step {peak:,} "
        f"({temp / peak:.3f}x); dry-run FLOPs {dry['ops']['flops']:.4e} (products "
        f"{dry['ops']['product_flops']:.4e}, kernels {dry['ops']['kernel_flops']:.4e}), "
        f"bytes {dry['ops']['bytes']:.4e}, roofline compute {dry['roofline']['compute_s']:.4e} "
        f"s, memory {dry['roofline']['memory_s']:.4e} s ({dry['roofline']['dominant']}); "
        f"model FLOPs {dry['roofline']['model_flops']:.4e}; measured step {step_s:.4f} s, "
        f"mfu {mfu:.4f}")

    # 18b
    params = dict(model.named_parameters())
    loss = model.loss(batch)[0]
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    del loss
    names = sorted(params, key=lambda n: -params[n].numel())
    # the largest leaf first, then leaves spread over the sizes down to the
    # smallest
    sample = list(dict.fromkeys(names[(len(names) - 1) * i // (OPT_SAMPLE - 1)]
                                for i in range(OPT_SAMPLE)))
    opt = adamw(warmup_cosine(OPT_LR, OPT_WARMUP, OPT_TOTAL), weight_decay=OPT_WD)
    torch.cuda.synchronize()
    before_state = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    opt_state = opt.init(params)
    torch.cuda.synchronize()
    mv_bytes = torch.cuda.memory_allocated() - before_state
    def rows(t):
        """``t``'s first rows, up to OPT_CPU_ELEMS elements."""
        return t[:max(1, OPT_CPU_ELEMS // (t.numel() // t.shape[0]))] if t.dim() else t

    cpu_params = {n: rows(params[n].detach()).to("cpu", copy=True) for n in sample}
    cpu_grads = {n: t.cpu() for n, t in grads.items()}
    card, times = [], []
    events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    for _ in range(OPT_STEPS):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        events[0].record()
        clipped, gnorm = clip_by_global_norm(grads, OPT_CLIP)
        updates, opt_state = opt.update(clipped, opt_state, params)
        apply_updates(params, updates)
        events[1].record()
        torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        times.append(events[0].elapsed_time(events[1]))
        card.append(dict(gnorm=gnorm.cpu(), **{f"{k}/{n}": rows(t[n].detach()).cpu()
                                                for n in sample
                                                for k, t in (("u", updates), ("m", opt_state["m"]),
                                                             ("v", opt_state["v"]))}))
        del clipped, updates
    peak_opt = torch.cuda.max_memory_allocated() - before_state

    # the CPU: the clip over every gradient, the optimizer on the sample
    t_cpu = time.perf_counter()
    cpu_opt = adamw(warmup_cosine(OPT_LR, OPT_WARMUP, OPT_TOTAL), weight_decay=OPT_WD)
    cpu_state = cpu_opt.init(cpu_params)
    errs = dict(u=0.0, m=0.0, v=0.0, gnorm=0.0)
    clipped, gnorm = clip_by_global_norm(cpu_grads, OPT_CLIP)     # the same every step
    sub = {n: rows(clipped[n]) for n in sample}
    del clipped, cpu_grads
    for i in range(OPT_STEPS):
        updates, cpu_state = cpu_opt.update(sub, cpu_state, cpu_params)
        apply_updates(cpu_params, updates)
        errs["gnorm"] = max(errs["gnorm"], float(abs(card[i]["gnorm"] - gnorm) / gnorm))
        check(errs["gnorm"] <= OPT_STATE_RTOL, f"phase18b step {i}: gnorm {card[i]['gnorm']} "
                                               f"vs the CPU's {gnorm}")
        for n in sample:
            for k, want in (("m", cpu_state["m"][n]), ("v", cpu_state["v"][n])):
                got = card[i][f"{k}/{n}"]
                rel = float(((got - want).abs() / want.abs().clamp_min(1e-30)).max())
                errs[k] = max(errs[k], rel)
                check(torch.allclose(got, want, rtol=OPT_STATE_RTOL, atol=0),
                      f"phase18b step {i} {k} of {n}: rel err {rel:.3e}")
            got, want = card[i][f"u/{n}"].float(), updates[n].float()
            gap = (got - want).abs()
            bound = OPT_UPDATE_REL * torch.maximum(got.abs(), want.abs())
            errs["u"] = max(errs["u"], float((gap / want.abs().clamp_min(1e-30)).max()))
            check(bool((gap <= bound).all()), f"phase18b step {i} update of {n}: "
                                              f"{int((gap > bound).sum())} beyond one bf16 ulp")
    cpu_s = time.perf_counter() - t_cpu
    log(f"phase18b adamw (warmup_cosine({OPT_LR}, {OPT_WARMUP}, {OPT_TOTAL}), weight_decay "
        f"{OPT_WD}) after clip_by_global_norm({OPT_CLIP}), {OPT_STEPS} steps on "
        f"{len(params)} leaves ({sum(p.numel() for p in params.values()):,} parameters) under "
        f"sync-debug 'error': against the CPU on {sample}, each on its first rows up to "
        f"{OPT_CPU_ELEMS:,} elements ({params[names[0]].numel():,} the largest leaf): max "
        f"rel err update {errs['u']:.3e} (bound one bf16 ulp), m {errs['m']:.3e}, v {errs['v']:.3e}, gnorm {errs['gnorm']:.3e} (rtol "
        f"{OPT_STATE_RTOL}); optimizer step device ms {[round(t, 3) for t in times]}; "
        f"m and v add {mv_bytes:,} bytes, the step's peak over them {peak_opt:,}")
    del model, params, grads, opt_state, step, batch
    torch.cuda.empty_cache()
    return dict(dryrun=dict(argument_bytes=arg_bytes, card_bytes=card_bytes,
                            allocator_bytes=allocated, temp_bytes=temp, card_peak_bytes=peak,
                            flops=dry["ops"]["flops"], model_flops=dry["roofline"]["model_flops"],
                            step_s=step_s, mfu=mfu),
                optimizer=dict(errors=errs, device_ms=times, mv_bytes=mv_bytes,
                               peak_bytes=peak_opt, sample=sample, cpu_s=cpu_s))


def phase_analysis() -> dict:
    """Phase 18: the auditor on the card (18a), the optimizer at full width
    (18b) and the dry run against the card (18c)."""
    t0 = time.perf_counter()
    out = dict(audit=_phase_audit())
    t1 = time.perf_counter()
    out.update(_phase_optimizer_and_dryrun())
    out["seconds"] = time.perf_counter() - t0
    log(f"phase18 took {out['seconds']:.1f} s (18a {t1 - t0:.1f} s, 18b and 18c "
        f"{out['seconds'] - (t1 - t0):.1f} s, of them the CPU's optimizer "
        f"{out['optimizer']['cpu_s']:.1f} s)")
    return out


# ---------------------------------------------------------------------------
# phase 19: the data and model axes (tensor and expert parallelism)
# ---------------------------------------------------------------------------

TP_LAYERS = 6                   # phase 19's Qwen3-8B depth (phase 6's SERVE_LAYERS)
TP_PROMPT, TP_NEW = 32, 8       # its serve loop: prompt steps, then greedy tokens
TP_MOE_BATCH = (4, 512)         # 2,048 tokens: the least that takes moe_shard's local
                                # dispatch at E = 128 (16 x 128)
TP_DEADLINE_S = 600.0
TP_PANEL_CHECK_M = (2, 4, 16)   # B4's panels whose route is checked: 151,936 / m columns
TP_SAMPLE = 16384               # elements of each whole parameter a train step's update is
                                # compared on (seeded positions, the same in every run)
# a parallel train step against the one-card step: each leaf's update
# (W' - W) against the one-card run's, |dW_n - dW_1| / |dW_1| over the
# leaf's sample, the largest over leaves (bf16: the SGD step moves a
# weight by about one rounding step, so a gradient rounded differently
# moves some weights by one step more or less); the per-token losses, the
# largest difference over the spread of the one-card run's per-token
# losses around their mean.  Both bounds sit between the largest sound
# reading and the planted faults' readings, which the phase takes again
# and checks on every run (on an H100 80GB HBM3 at 700 W: updates 0.217-
# 0.241 over gloo (1, 2) and NCCL (1, 4), (2, 2), a skipped data
# reduction 0.929; per-token losses 0.0125-0.0137, rows one token out of
# place 1.42).
TP_UPDATE_REL = 0.5
TP_TOKEN_REL = 0.1
# InternVL2-26B at full width (vocab 92,553, which no model axis of 2 or
# more divides: the embedding and the head whole on every rank) and this
# depth, over (1, 2) on one card and (1, n) on n
TP_VLM_LAYERS = 4
# the last layer kinds at full width (train_4k's bf16 and remat) and cut
# depth, over (1, 2) on one card and (1, n) on n: DeepSeek-V2-Lite's one
# dense and one MoE layer (MLA: its latent cache split on its sequence over
# the model ranks), Zamba2's two Mamba2 layers with the shared block between
# them, xLSTM's mLSTM and sLSTM blocks, SeamlessM4T's two encoder and two
# decoder layers; a TP_FAM_BATCH x TP_FAM_SEQ train batch (and the prefill
# on its tokens; an encoder-decoder's TP_FAM_FRAMES frames a row), the serve
# loop of TP_PROMPT + TP_NEW steps over SERVE_BATCH rows
TP_FAMILIES = {"deepseek-v2-lite-16b": dict(n_layers=2),
               "zamba2-1.2b": dict(n_layers=2, attn_every=1),
               "xlstm-1.3b": dict(n_layers=2, slstm_every=2),
               "seamless-m4t-medium": dict(n_layers=2, n_enc_layers=2)}
TP_FAM_BATCH, TP_FAM_SEQ, TP_FAM_FRAMES = 2, 256, 64
def _nccl_version() -> str:
    import torch
    v = torch.cuda.nccl.version()
    return ".".join(map(str, v)) if isinstance(v, tuple) else str(v)


def _moe_shard_prefill(model) -> dict:
    """Phase 13's Qwen3-30B-A3B (the same weights) with its MoE layers on
    ``moe_shard``'s local dispatch (16 groups): a TP_MOE_BATCH prefill, its
    logits finite, B5's launches, 16 groups a layer, the pairs dropped a
    group and layer, each layer's routing ids and kept pairs; the layers
    back on the global dispatch after."""
    import torch
    from repro_torch.launch.serve import make_prompts
    from repro_torch.launch.steps import make_prefill_step
    cfg = model.cfg
    layers = [layer for stack in model.stacks for layer in stack.layers
              if getattr(layer, "routed", False)]
    saved = [layer.moe.cfg for layer in layers]
    b, s = TP_MOE_BATCH
    tokens = torch.from_numpy(make_prompts(1, cfg.vocab, b, s)).to(DEVICE)
    try:
        for layer in layers:
            layer.moe.cfg = layer.moe.cfg._replace(shard=True, shard_groups=16)
        torch.cuda.reset_peak_memory_stats()
        with _Routing() as routing:
            logits, launches, seconds = _timed_run(
                lambda: make_prefill_step(model)({"tokens": tokens}))
    finally:
        for layer, c in zip(layers, saved):
            layer.moe.cfg = c
    check(routing.groups == [16] * len(layers), f"phase13 qmoe moe_shard: dispatch groups "
                                                 f"{set(routing.groups)}, want 16 a layer")
    check(bool(torch.isfinite(logits).all()) and logits.shape == (b, 1, cfg.vocab),
          f"phase13 qmoe moe_shard: logits {tuple(logits.shape)} not finite or misshapen")
    check(launches == _attn_launches(cfg, prefills=1),
          f"phase13 qmoe moe_shard: launches {launches}")
    drops = [[int(g) for g in (~k.view(16, -1)).sum(dim=1)] for k in routing.kept]
    per_layer = [sum(d) for d in drops]
    log(f"phase13 qmoe moe_shard prefill (B {b} x {s}, 16 groups of {b * s // 16} tokens, "
        f"capacity {_capacity(cfg, b * s // 16)} an expert a group): {seconds:.3f} s, peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB, launches {launches}; (token, k) "
        f"pairs dropped by layer {per_layer} of {b * s * cfg.top_k}; by group in layer 0 "
        f"{drops[0]}; {card_line()}")
    return dict(logits=logits.float().cpu().numpy(), groups=routing.groups, drops=drops,
                drops_by_layer=per_layer, seconds=seconds, launches=launches,
                ids=[i.cpu().numpy() for i in routing.ids],
                kept=[k.cpu().numpy() for k in routing.kept])


def _tp_cfg():
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.shapes import SHAPES, shape_settings
    return dataclasses.replace(get_config("qwen3-8b"), n_layers=TP_LAYERS,
                               **shape_settings(SHAPES["train_4k"]))


def _tp_vlm_cfg():
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.shapes import SHAPES, shape_settings
    return dataclasses.replace(get_config(VLM_ARCH), n_layers=TP_VLM_LAYERS,
                               **shape_settings(SHAPES["train_4k"]))


def _tp_decode1_meshes(n: int):
    """Phase 19's batch-1 decodes over n cards: (n, 1) and (2, n / 2), the
    cache's sequence over the data ranks (and the model ranks beside)."""
    return [(n, 1)] + ([(2, n // 2)] if n >= 4 and n % 2 == 0 else [])


def _tp_meshes(n: int):
    """Phase 19's (data, model) meshes over n cards: (1, n) and (2, n / 2)."""
    return [(1, n)] + ([(2, n // 2)] if n >= 4 and n % 2 == 0 else [])


def _leaf_samples(model) -> dict:
    """{name: f32 numpy array}: TP_SAMPLE elements of each whole parameter
    at seeded positions (the same for every model of these shapes), the
    whole leaf where it is smaller; a parallel model's leaves gathered over
    ``model`` one at a time."""
    import torch
    from repro_torch.launch.shardings import gather_param
    out = {}
    for name, p in model.named_parameters():
        whole = gather_param(p, model.par).reshape(-1)
        n = whole.numel()
        if n > TP_SAMPLE:
            idx = torch.randint(n, (TP_SAMPLE,), generator=torch.Generator().manual_seed(n))
            whole = whole[idx.to(whole.device)]
        out[name] = whole.float().cpu().numpy()
    return out


class _TokenLosses:
    """Within the block, the per-token losses (T,) f32 each call of the
    loss path's B4 entry (``ops._xent_per_token``) returns, in call order."""

    def __enter__(self):
        from repro_torch.kernels import ops
        self.saved, self.seen = ops._xent_per_token, []

        def recorded(*args, **kw):
            out = self.saved(*args, **kw)
            self.seen.append(out.detach())
            return out

        ops._xent_per_token = recorded
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops
        ops._xent_per_token = self.saved


def _train_update(model, batch, lr) -> tuple:
    """One train step of ``model`` on ``batch``: (loss, launches, seconds,
    the collectives it made, its per-token losses (numpy), each leaf's
    sampled update (after - before, :func:`_leaf_samples`))."""
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.parallel import collective_totals, reset_collectives
    before = _leaf_samples(model)
    step = make_train_step(model, lr)
    reset_collectives()
    with _TokenLosses() as tl:
        loss, launches, seconds = _timed_run(lambda: step(batch))
    coll = collective_totals()
    check(len(tl.seen) == 1, f"phase19: the train step's loss path ran {len(tl.seen)} times")
    after = _leaf_samples(model)
    update = {name: after[name] - before[name] for name in before}
    return loss, launches, seconds, coll, tl.seen[0].float().cpu().numpy(), update


def _tp_dense_run(model, shape=(TRAIN_BATCH, TRAIN_SEQ), frames: int = 0) -> dict:
    """Phase 19's run of a model on this rank: the prefill step on the
    train batch's tokens, the serve loop (TP_PROMPT prompt steps, TP_NEW
    greedy tokens) over the KV-sharded cache, one train step on a ``shape``
    batch; launches, seconds, the collectives of each, peak memory, the
    step's per-token losses (this data rank's rows) and each leaf's sampled
    update.  An encoder-decoder's batches carry ``frames`` frames a row
    drawn from a seed (the serve loop their memory)."""
    import torch
    from repro_torch.launch.serve import greedy_decode, make_prompts
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models.parallel import collective_totals, reset_collectives
    cfg, par = model.cfg, model.par
    batch = _train_batch(*shape)
    prompts = torch.from_numpy(make_prompts(0, cfg.vocab, SERVE_BATCH, TP_PROMPT)).to(DEVICE)
    memory = None
    if frames:
        g = torch.Generator(device=DEVICE).manual_seed(11)
        batch["frames"], serve_frames = (
            torch.randn((b, frames, cfg.d_model), generator=g, device=DEVICE).to(model.dtype)
            for b in (shape[0], SERVE_BATCH))
        with torch.inference_mode():
            memory = model.encode({"frames": serve_frames})
    torch.cuda.reset_peak_memory_stats()
    reset_collectives()
    prefill, prefill_l, prefill_s = _timed_run(
        lambda: make_prefill_step(model)({k: v for k, v in batch.items() if k != "labels"}))
    coll = dict(prefill=collective_totals())
    reset_collectives()
    (gen, last), serve_l, serve_s = _timed_run(lambda: greedy_decode(
        make_serve_step(model), model.init_cache(SERVE_BATCH, TP_PROMPT + TP_NEW), prompts,
        TP_NEW, memory))
    coll["serve"] = collective_totals()
    loss, train_l, train_s, coll["train"], tokens, update = _train_update(model, batch,
                                                                         TRAIN_LR)
    return dict(prefill=prefill.float().cpu().numpy(), last=last.float().cpu().numpy(),
                gen=gen.cpu().numpy(), loss=float(loss), tokens=tokens, update=update,
                rows=(par.data_rank, par.data_size),
                launches=dict(prefill=prefill_l, serve=serve_l, train=train_l),
                seconds=dict(prefill=prefill_s, serve=serve_s, train=train_s),
                collectives=coll, peak_gb=torch.cuda.max_memory_allocated() / 1e9)


def _tp_decode1_run(model) -> dict:
    """The batch-1 serve loop (TP_PROMPT prompt steps, TP_NEW greedy
    tokens): on a parallel model over data ranks the cache's panels span
    them (every rank holds the row; B6's partial mode a layer and step, the
    partials all-gathered and combined).  Its logits, tokens, launches,
    seconds, collectives, panels and cache bytes."""
    import torch
    from repro_torch.launch.serve import greedy_decode, make_prompts
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models.parallel import collective_totals, reset_collectives
    prompts = torch.from_numpy(make_prompts(2, model.cfg.vocab, 1, TP_PROMPT)).to(DEVICE)
    cache = model.init_cache(1, TP_PROMPT + TP_NEW)
    reset_collectives()
    (gen, last), launches, seconds = _timed_run(
        lambda: greedy_decode(make_serve_step(model), cache, prompts, TP_NEW))
    return dict(last=last.float().cpu().numpy(), gen=gen.cpu().numpy(), launches=launches,
                seconds=seconds, collectives=collective_totals(),
                panels=(cache.panels.count, cache.panels.length, cache.panels.rows_whole),
                cache_bytes=sum(t.numel() * t.element_size() for c in cache
                                for t in c.values()))


def _tp_decode1_compare(label: str, got: dict, want: dict, layers: int) -> dict:
    """A batch-1 decode over data ranks against the one-card loop: the
    prompt's last logits within SERVE_BF16_REL of the largest, the tokens
    of the same shape (their agreement reported), B6's partial mode on every
    layer and step and the one-call B6 on none."""
    import numpy as np
    gap = float(np.abs(got["last"] - want["last"]).max() / np.abs(want["last"]).max())
    steps = TP_PROMPT + TP_NEW
    check(gap <= SERVE_BF16_REL, f"{label}: logits differ from the one-card loop by "
                                 f"{gap:.3e} > {SERVE_BF16_REL}")
    check(got["gen"].shape == want["gen"].shape, f"{label}: tokens misshapen")
    check(got["panels"][2] and got["panels"][0] > 1, f"{label}: panels {got['panels']}")
    check(got["launches"] == want_launches(decode_attention_partial_tc=layers * steps),
          f"{label}: launches {got['launches']}, want B6's partial mode "
          f"{layers * steps} times")
    # the greedy tokens follow the first one, the argmax of these logits:
    # where its top two sit closer than the gap, a flip is bf16 rounding
    top = np.sort(want["last"].reshape(-1))
    return dict(gap=gap, tokens_equal=int((got["gen"] == want["gen"]).sum()),
                tokens=int(want["gen"].size),
                top2_margin=float((top[-1] - top[-2]) / np.abs(want["last"]).max()))


def _tp_moe_run(cfg, pin) -> dict:
    """Qwen3-30B-A3B at full width and depth with ``moe_shard`` on this
    rank's part of the parallel model: a TP_MOE_BATCH prefill with each
    layer's routing pinned to ``pin`` (the one-card run's ids), its logits,
    the dispatch groups, the kept pairs and the pairs dropped a group and
    layer."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve import make_prompts
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import build_model
    mesh = make_mesh((1, dist.get_world_size()), ("data", "model"))
    model = build_model(cfg, DEVICE, mesh).init(torch.Generator(device=DEVICE).manual_seed(0))
    b, s = TP_MOE_BATCH
    tokens = torch.from_numpy(make_prompts(1, cfg.vocab, b, s)).to(DEVICE)
    torch.cuda.reset_peak_memory_stats()
    with _Routing(pin=[torch.from_numpy(ids) for ids in pin]) as routing:
        logits, launches, seconds = _timed_run(lambda: make_prefill_step(model)({"tokens": tokens}))
    drops = [[int(g) for g in (~k.view(16, -1)).sum(dim=1)] for k in routing.kept]
    out = dict(logits=logits.float().cpu().numpy(), launches=launches, seconds=seconds,
               groups=routing.groups, drops=drops, kept=[k.cpu().numpy() for k in routing.kept],
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    del model
    torch.cuda.empty_cache()
    return out


def _tp_round_rank(dims) -> dict:
    """8c's 2-slot int8 round step over (pod, data, model) = ``dims`` on this
    rank: the slots over ``pod``, each pod's model parallel over its
    ``data`` and ``model`` ranks (phase 8b's inits, 8c's batches)."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import make_pigeon_round_step_shardmap
    from repro_torch.models import build_model, build_stacked_model
    cfg = _round_cfg()
    mesh = make_mesh(dims, ("pod", "data", "model"))
    n = 2 // dims[0]
    lo = mesh.coord("pod") * n
    stacked = build_stacked_model(cfg, n, device=DEVICE, mesh=mesh)
    plain = build_model(cfg, DEVICE, mesh)
    for i, seed in enumerate(range(lo, lo + n)):
        stacked.load_slot(i, plain.init(torch.Generator(device=DEVICE).manual_seed(seed)))
    del plain
    torch.cuda.empty_cache()
    inputs, val = _lm_step_inputs(1, seed=100), _train_batch(8, TRAIN_SEQ, seed=90)
    step = make_pigeon_round_step_shardmap(stacked, mesh, TRAIN_LR, quant="int8")
    torch.cuda.reset_peak_memory_stats()
    (vlosses, sel), launches, seconds = _timed_run(lambda: step(inputs, val))
    out = dict(vlosses=vlosses.tolist(), sel=int(sel), launches=launches, seconds=seconds,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9, rank=dist.get_rank())
    del stacked
    torch.cuda.empty_cache()
    return out


def _tp_family_cfg(arch: str):
    """``arch`` at full width, train_4k's settings and TP_FAMILIES' depth."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.shapes import SHAPES, shape_settings
    return dataclasses.replace(get_config(arch), **TP_FAMILIES[arch],
                               **shape_settings(SHAPES["train_4k"]))


def _tp_family_run(arch: str, mesh=None) -> dict:
    """:func:`_tp_dense_run` of ``arch``'s TP_FAMILIES model on this rank's
    part of ``mesh`` (None: one card), drawn from seed 0."""
    import torch
    from repro_torch.models import build_model
    cfg = _tp_family_cfg(arch)
    model = build_model(cfg, DEVICE, mesh).init(torch.Generator(device=DEVICE).manual_seed(0))
    out = _tp_dense_run(model, (TP_FAM_BATCH, TP_FAM_SEQ),
                        TP_FAM_FRAMES if cfg.arch_type in ("audio", "encdec") else 0)
    out["cache_panels"] = model.kv_share()
    del model
    torch.cuda.empty_cache()
    return out


def _tp_families_rank(dims) -> dict:
    """Every TP_FAMILIES model's run over (data, model) = ``dims``."""
    from repro_torch.launch.mesh import make_mesh
    return {arch: _tp_family_run(arch, make_mesh(dims, ("data", "model")))
            for arch in TP_FAMILIES}


def _tp_rank(dims_list, moe_cfg=None, pin=None, round_dims=None, decode1_dims=(),
             vlm_dims=None, fam_dims=None) -> dict:
    """Phase 19 on one rank of an NCCL group of every card: the dense runs
    over each (data, model) mesh of ``dims_list``, the batch-1 decodes
    over each of ``decode1_dims``, InternVL2-26B's run over ``vlm_dims``,
    the last layer kinds' runs over ``fam_dims``, the MoE prefill with
    experts over every rank (routing pinned to ``pin``), the round step
    over ``round_dims``."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    out = dict(rank=dist.get_rank(), world=dist.get_world_size(),
               nccl=_nccl_version(), runs={})
    for dims in dims_list:
        mesh = make_mesh(dims, ("data", "model"))
        model = build_model(_tp_cfg(), DEVICE, mesh).init(
            torch.Generator(device=DEVICE).manual_seed(0))
        out["runs"][tuple(dims)] = _tp_dense_run(model)
        del model
        torch.cuda.empty_cache()
    out["decode1"] = {}
    for dims in decode1_dims:
        mesh = make_mesh(dims, ("data", "model"))
        model = build_model(_tp_cfg(), DEVICE, mesh).init(
            torch.Generator(device=DEVICE).manual_seed(0))
        out["decode1"][tuple(dims)] = _tp_decode1_run(model)
        del model
        torch.cuda.empty_cache()
    if vlm_dims is not None:
        out["vlm"] = _tp_vlm_rank(vlm_dims)
    if fam_dims is not None:
        out["families"] = _tp_families_rank(fam_dims)
    if moe_cfg is not None:
        out["moe"] = _tp_moe_run(moe_cfg, pin)
    if round_dims is not None:
        out["round"] = _tp_round_rank(round_dims)
    return out


def _tp_vlm_rank(dims) -> dict:
    """InternVL2-26B (TP_VLM_LAYERS layers, full width) on this rank of a
    (data, model) = ``dims`` mesh: its vocab whole on every rank (plain B4
    over the whole head, no gather of logits), the rest tensor-parallel;
    :func:`_tp_dense_run`'s prefill, serve loop and train step."""
    import torch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    model = build_model(_tp_vlm_cfg(), DEVICE, make_mesh(dims, ("data", "model"))).init(
        torch.Generator(device=DEVICE).manual_seed(0))
    check(model.vocab_par.model_size == 1 and model.embedding.shape[0] == model.cfg.vocab,
          f"phase19 vlm {dims}: the vocab of {model.cfg.vocab} is not held whole")
    out = _tp_dense_run(model)
    del model
    torch.cuda.empty_cache()
    return out


def _tp_gloo_rank() -> dict:
    """Two gloo ranks on one card: the dense run over (1, 2), the batch-1
    decode over (2, 1) (the cache's sequence over the two data ranks),
    InternVL2-26B over (1, 2) (its vocab whole) and the last layer kinds
    over (1, 2)."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    torch.cuda.set_device(0)
    mesh = make_mesh((1, 2), ("data", "model"))
    model = build_model(_tp_cfg(), DEVICE, mesh).init(
        torch.Generator(device=DEVICE).manual_seed(0))
    out = dict(_tp_dense_run(model), rank=dist.get_rank())
    del model
    torch.cuda.empty_cache()
    model = build_model(_tp_cfg(), DEVICE, make_mesh((2, 1), ("data", "model"))).init(
        torch.Generator(device=DEVICE).manual_seed(0))
    out["decode1"] = {(2, 1): _tp_decode1_run(model)}
    del model
    torch.cuda.empty_cache()
    out["vlm"] = _tp_vlm_rank((1, 2))
    out["families"] = _tp_families_rank((1, 2))
    return out


def _update_gap(got: dict, want: dict) -> tuple:
    """(gap, leaf): the largest over leaves of |dW_got - dW_want| /
    |dW_want| over each leaf's sample (inf where the one-card update is
    zero and the other is not)."""
    import numpy as np
    gaps = {}
    for name, w in want.items():
        num, den = float(np.linalg.norm(got[name] - w)), float(np.linalg.norm(w))
        gaps[name] = num / den if den > 0 else (0.0 if num == 0 else float("inf"))
    leaf = max(gaps, key=gaps.get)
    return gaps[leaf], leaf


def _token_gap(got, rows, want) -> float:
    """The largest difference of a data rank's per-token losses ``got``
    (its ``rows`` = (data rank, data size) of the batch) from the one-card
    run's ``want``, over the spread of ``want`` around its mean."""
    import numpy as np
    d, size = rows
    t = want.size // size
    spread = float(np.abs(want - want.mean()).max())
    return float(np.abs(got - want[d * t:(d + 1) * t]).max()) / spread


def _tp_compare(label: str, got: dict, want: dict) -> dict:
    """A parallel run against the one-card run: prefill and decode logits
    within SERVE_BF16_REL of the largest logit, the per-token losses within
    TP_TOKEN_REL, each leaf's update within TP_UPDATE_REL, the greedy
    tokens of the same shape."""
    import numpy as np
    gaps = {key: float(np.abs(got[key] - want[key]).max() / np.abs(want[key]).max())
            for key in ("prefill", "last")}
    gaps["tokens"] = _token_gap(got["tokens"], got["rows"], want["tokens"])
    gaps["update"], gaps["update_leaf"] = _update_gap(got["update"], want["update"])
    bounds = dict(prefill=SERVE_BF16_REL, last=SERVE_BF16_REL, tokens=TP_TOKEN_REL,
                  update=TP_UPDATE_REL)
    for key, bound in bounds.items():
        check(gaps[key] <= bound, f"{label}: {key} differs from the one-card run by "
                                  f"{gaps[key]:.3e} > {bound} ({gaps['update_leaf']})")
    check(got["gen"].shape == want["gen"].shape, f"{label}: tokens misshapen")
    return gaps


def _tp_faults(cfg, one: dict) -> dict:
    """The readings of planted faults against the one-card run, which the
    bounds of :func:`_tp_compare` must catch: the update a rank of a data
    axis of 2 makes when the gradients' all-reduce is skipped (the plain
    model's step on half the batch at half the rate: its loss is half its
    rows' mean), and the per-token losses of rows one token out of place.
    (No update at all reads 1 by definition.)"""
    import numpy as np
    import torch
    from repro_torch.models import build_model
    plain = build_model(cfg, DEVICE).init(torch.Generator(device=DEVICE).manual_seed(0))
    batch = _train_batch(TRAIN_BATCH, TRAIN_SEQ)
    half = {k: v[:TRAIN_BATCH // 2] for k, v in batch.items()}
    *_, update = _train_update(plain, half, TRAIN_LR / 2)
    del plain
    torch.cuda.empty_cache()
    skipped, leaf = _update_gap(update, one["update"])
    shifted = _token_gap(np.roll(one["tokens"], 1), (0, 1), one["tokens"])
    check(skipped > TP_UPDATE_REL and shifted > TP_TOKEN_REL,
          f"phase19: the bounds do not catch the planted faults: a skipped data reduction "
          f"reads {skipped:.3e} ({leaf}) against {TP_UPDATE_REL}, rows one token out of "
          f"place {shifted:.3e} against {TP_TOKEN_REL}")
    return dict(skipped_data_reduction=skipped, skipped_leaf=leaf, rows_shifted=shifted)


def _xent_panel(m: int) -> dict:
    """B4 on a rank's vocab-parallel panel at the train shape, bf16: the
    panel (D, 151,936 / m) of rank 1 with the labels shifted by its offset
    (most fall outside it and pick 0), forward (loss, lse) and backward
    (with the whole vocab's lse) against the plain versions, the
    tensor-core route checked there and at every m of TP_PANEL_CHECK_M,
    timed beside the plain panel and its bound."""
    import torch
    from repro_torch.kernels import fused_xent as fx
    from repro_torch.launch import roofline as rl
    t, d, v = XENT_SHAPES[0]
    v_l = v // m
    h, w, labels, gup = _xent_args(XENT_SHAPES[0], "bfloat16", seed=77)
    labels = labels.abs() % v
    panel = w[:, v_l:2 * v_l].contiguous()
    local = (labels - v_l).to(torch.int32)
    routes = {}
    for mm in sorted(set(TP_PANEL_CHECK_M) | {m}):
        p = panel if mm == m else torch.empty((d, v // mm), dtype=w.dtype, device=w.device)
        routes[mm] = (fx.xent_route(h, p), fx.xent_bwd_route(h, p))
    check(all(r == (fx.TENSOR_CORES, fx.TENSOR_CORES) for r in routes.values()),
          f"phase19 B4 panels: routes {routes} by m, want the tensor cores")
    loss, lse_r = fx.fused_xent(h, panel, local)
    picked_p, lse_p = fx._panel_plain(h, panel, local)
    err = max(float((loss - (lse_p - picked_p)).abs().max()), float((lse_r - lse_p).abs().max()))
    check(err <= XENT_ATOL["bfloat16"], f"phase19 B4 panel: max |kernel - plain| {err:.3e}")
    lse = torch.logsumexp(h.float() @ w.float(), dim=-1)
    dh, dw = fx.fused_xent_bwd(h, panel, local, lse, gup)
    ref_dh, ref_dw = fx._panel_bwd_plain(h, panel, local, lse, gup)
    gerr = max(float((dh.float() - ref_dh.float()).abs().max() / ref_dh.float().abs().max()),
               float((dw.float() - ref_dw.float()).abs().max() / ref_dw.float().abs().max()))
    check(gerr <= GRAD_REL["bfloat16"], f"phase19 B4 panel backward: rel err {gerr:.3e}")
    kernel_us = _time_us(lambda: fx.fused_xent(h, panel, local))
    plain_us = _time_us(lambda: fx._panel_plain(h, panel, local))
    bwd_us = _time_us(lambda: fx.fused_xent_bwd(h, panel, local, lse, gup))
    bound_us, bound_by = rl.bound_us(rl.fused_xent_work(t, d, v_l))
    bwd_bound_us, _ = rl.bound_us(rl.fused_xent_bwd_work(t, d, v_l))
    log(f"phase19 B4 vocab-parallel panel ({t}, {d}, {v_l}) bf16, rank 1 of {m}: forward "
        f"{kernel_us:.1f} us (plain {plain_us:.1f}, bound {bound_us:.1f} by {bound_by}), max "
        f"|err| {err:.3e}; backward {bwd_us:.1f} us (bound {bwd_bound_us:.1f}), rel err "
        f"{gerr:.3e}; routes by m {routes}; {card_line()}")
    del h, w, panel, dh, dw, ref_dh, ref_dw
    torch.cuda.empty_cache()
    return dict(shape=(t, d, v_l), max_abs_err=err, max_rel_err_bwd=gerr, kernel_us=kernel_us,
                plain_us=plain_us, bound_us=bound_us, bound_by=bound_by, bwd_us=bwd_us,
                bwd_bound_us=bwd_bound_us)


def _tp_family_want(arch: str) -> dict:
    """The launches of :func:`_tp_family_run`'s three paths, from the plan
    of ``arch``'s TP_FAMILIES model: causal B5 once a self-attention layer
    (the shared block's, the decoder's) in the prefill, once more under
    remat in the train step and its backward once; non-causal B5 the same
    an encoder layer and a cross-attention, and once a cross-attention and
    position in the serve loop; B6 once a self-attention layer and
    position; B7 as causal B5, an sLSTM layer (its decode step is plain);
    B4 forward and backward once, on the route the head's width takes.
    MLA's attention and Mamba2's SSD are plain PyTorch, as in the
    reference: they launch none."""
    import torch
    from repro_torch.kernels import fused_xent as fx
    from repro_torch.models.model import build_plan
    cfg = _tp_family_cfg(arch)
    plan = build_plan(cfg)

    def layers(*kinds):
        return sum(sp.n for sp in plan if sp.kind in kinds)

    fwd = 2 if cfg.remat else 1
    attn, cross, slstm = layers("shared_attn", "dec_cross"), layers("dec_cross"), layers("slstm")
    noncausal = cross + (cfg.n_enc_layers if cfg.arch_type in ("audio", "encdec") else 0)
    positions = TP_PROMPT + TP_NEW
    h = torch.empty((8, cfg.d_model), dtype=torch.bfloat16, device=DEVICE)
    w = torch.empty((cfg.d_model, cfg.vocab), dtype=torch.bfloat16, device=DEVICE)
    names = {fx.TENSOR_CORES: "_tc", fx.F32_FMA: ""}
    xent = {"fused_xent" + names[fx.xent_route(h, w)]: 1,
            "fused_xent_bwd" + names[fx.xent_bwd_route(h, w)]: 1}
    return dict(
        prefill=want_launches(flash_attention_tc=attn, flash_attention_tc_noncausal=noncausal,
                              slstm_scan_persistent=slstm),
        serve=want_launches(decode_attention_tc=attn * positions,
                            flash_attention_tc_noncausal=cross * positions),
        train=want_launches(flash_attention_tc=fwd * attn, flash_attention_bwd_tc=attn,
                            flash_attention_tc_noncausal=fwd * noncausal,
                            flash_attention_bwd_tc_noncausal=noncausal,
                            slstm_scan_persistent=fwd * slstm, slstm_scan_bwd_persistent=slstm,
                            **xent))


def _tp_family_compare(label: str, arch: str, got: dict, want: dict) -> dict:
    """A family's parallel run against its one-card run: :func:`_tp_compare`'s
    bounds, the same launches on every path (every kernel on the rank's
    shard of the work)."""
    gaps = _tp_compare(label, got, want)
    launched = _launched(got["launches"])
    check(got["launches"] == want["launches"], f"{label}: launches {launched}, the one-card "
                                               f"run's {_launched(want['launches'])}")
    log(f"{label}: {arch} at {_tp_family_cfg(arch).n_layers} layers, full width: gaps to the "
        f"one-card run {gaps}; launches {launched}; seconds {got['seconds']} (one card "
        f"{want['seconds']}); peak {got['peak_gb']:.2f} GB (one card {want['peak_gb']:.2f}); "
        f"cache panels {got['cache_panels']}; collectives {got['collectives']}; {card_line()}")
    return dict(gaps=gaps, launches=launched, seconds=got["seconds"],
                peak_gb=got["peak_gb"], panels=got["cache_panels"],
                collectives=got["collectives"])


def _launched(launches: dict) -> dict:
    """A run's launch counts by path, the kernels it launched only."""
    return {path: {k: v for k, v in counts.items() if v} for path, counts in launches.items()}


def _tp_want_launches(cfg, xent: str = "fused_xent_tc",
                      xent_bwd: str = "fused_xent_bwd_tc") -> dict:
    """The launches of :func:`_tp_dense_run`'s three paths on every rank:
    B5 a layer on the local heads, B6 a layer and position, B4 forward and
    backward once on the rank's panel (or, a vocab held whole, on the whole
    head, on the route its width takes: ``xent``, ``xent_bwd``)."""
    return dict(prefill=want_launches(flash_attention_tc=cfg.n_layers),
                serve=want_launches(decode_attention_tc=cfg.n_layers * (TP_PROMPT + TP_NEW)),
                train=want_launches(flash_attention_tc=2 * cfg.n_layers,
                                    flash_attention_bwd_tc=cfg.n_layers, **{xent: 1},
                                    **{xent_bwd: 1}))


def _tp_vlm_want(vcfg) -> dict:
    """:func:`_tp_want_launches` of InternVL2's run: B4 over the whole
    92,553-column head takes the f32-FMA routes (V not a multiple of 8)."""
    import torch
    from repro_torch.kernels import fused_xent as fx
    h = torch.empty((8, vcfg.d_model), dtype=torch.bfloat16, device=DEVICE)
    w = torch.empty((vcfg.d_model, vcfg.vocab), dtype=torch.bfloat16, device=DEVICE)
    names = {fx.TENSOR_CORES: "_tc", fx.F32_FMA: ""}
    return _tp_want_launches(vcfg, "fused_xent" + names[fx.xent_route(h, w)],
                             "fused_xent_bwd" + names[fx.xent_bwd_route(h, w)])


def phase_tensor_parallel(moe_shard: dict) -> dict:
    """Phase 19: the data and model axes.  On an NCCL group of every
    visible card: Qwen3-8B at full width and TP_LAYERS layers (train_4k's
    bf16 and remat) through the parallel model (``models/parallel.py``):
    the prefill step, the serve loop over the KV-sharded cache and a train
    step.  On one card the group of one's run is bit-equal to the plain
    ``Model``'s from the same weights (prefill and decode logits, tokens,
    the loss and every updated parameter), and two gloo ranks on the card
    run over (1, 2); on n cards meshes (1, n) and (2, n / 2).  Each of
    these is held against the one-card run by :func:`_tp_compare`, whose
    bounds are shown to catch planted faults (:func:`_tp_faults`).
    Qwen3-30B-A3B with ``moe_shard`` at full depth (the TP_MOE_BATCH
    prefill, the local dispatch's 16 groups, pairs dropped a group): phase
    13's run on one card; experts over every card on n, routing pinned to
    the one-card ids, kept pairs equal and logits within SERVE_BF16_REL.
    8c's 2-slot int8 round step over (pod, data, model): bit-equal to the
    vmap step on one card, (2, 1, n / 2) against it on n.  B4's
    vocab-parallel panel of the run that launched it (m = 2 on one card,
    n on n) against its plain versions.  The sequence-sharded decode cache
    and the whole vocab: a batch-1 serve loop of the same Qwen3-8B over (2,
    1) on one card (two gloo ranks; (n, 1) and (2, n / 2) on n), its
    cache's sequence over the data ranks, against the one-card loop;
    InternVL2-26B at full width and TP_VLM_LAYERS layers over (1, 2) ((1,
    n) on n), its vocab of 92,553 whole, by :func:`_tp_compare` against
    its one-card run.  Qwen2.5-14B's whole attention (40 heads) and a KV
    head's sequence split over the model ranks that share it need a model
    axis of 16 (40 and 8 divide by 4): the CPU tests and phase 1's panels
    hold them."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.launch.mesh import group_of_one, make_mesh, spawn
    from repro_torch.launch.serve import serve_config
    from repro_torch.launch.steps import make_pigeon_round_step
    from repro_torch.models import build_model, build_stacked_model

    t_phase = time.perf_counter()
    n = _cards()
    cfg = _tp_cfg()
    want = _tp_want_launches(cfg)
    out = dict(cards=n, panel=_xent_panel(2 if n == 1 else n))
    # the one-card runs: the plain model, then the group of one's parallel model
    plain = build_model(cfg, DEVICE).init(torch.Generator(device=DEVICE).manual_seed(0))
    one_b1 = _tp_decode1_run(plain)           # before the dense run's train step
    one = _tp_dense_run(plain)
    check(one_b1["launches"] == want_launches(
        decode_attention_tc=cfg.n_layers * (TP_PROMPT + TP_NEW)),
        f"phase19 one-card batch-1 loop: launches {one_b1['launches']}")
    with group_of_one("nccl"):
        mesh = make_mesh((1, 1), ("data", "model"))
        par = build_model(cfg, DEVICE, mesh).init(torch.Generator(device=DEVICE).manual_seed(0))
        got = _tp_dense_run(par)
        same = {key: bool(np.array_equal(got[key], one[key]))
                for key in ("prefill", "last", "gen", "tokens")}
        same["loss"] = got["loss"] == one["loss"]
        same["params"] = all(torch.equal(a, b) for a, b in zip(par.parameters(),
                                                               plain.parameters()))
        check(all(same.values()), f"phase19: the group of one's parallel model is not "
                                  f"bit-equal to the plain model: {same}")
        check(got["launches"] == one["launches"], f"phase19: the group of one's launches "
                                                  f"{got['launches']} != {one['launches']}")
        del par
    del plain
    torch.cuda.empty_cache()
    # InternVL2-26B on one card: what its parallel runs (vocab whole) are held to
    vcfg = _tp_vlm_cfg()
    plain_vlm = build_model(vcfg, DEVICE).init(torch.Generator(device=DEVICE).manual_seed(0))
    one_vlm = _tp_dense_run(plain_vlm)
    vlm_want = _tp_vlm_want(vcfg)
    check(one_vlm["launches"] == vlm_want, f"phase19 one-card vlm: launches "
                                           f"{one_vlm['launches']}, want {vlm_want}")
    del plain_vlm
    torch.cuda.empty_cache()
    # the last layer kinds on one card: what their parallel runs are held to
    one_fam = {arch: _tp_family_run(arch) for arch in TP_FAMILIES}
    for arch, fam in one_fam.items():
        fam_want = _tp_family_want(arch)
        check(fam["launches"] == fam_want, f"phase19 one-card {arch}: launches "
                                           f"{_launched(fam['launches'])}, want "
                                           f"{_launched(fam_want)}")
        log(f"phase19 one-card {arch} ({_tp_family_cfg(arch).n_layers} layers): launches "
            f"{_launched(fam['launches'])}; seconds {fam['seconds']}; peak "
            f"{fam['peak_gb']:.2f} GB")
    launches = got["launches"]
    check(launches == want, f"phase19: launches {launches}, want {want}")
    log(f"phase19 group of one (NCCL {_nccl_version()}): "
        f"Qwen3-8B {cfg.n_layers} layers bf16 through the parallel model, bit-equal to the "
        f"plain model {same}; launches {launches}; seconds {got['seconds']} (plain "
        f"{one['seconds']}); peak {got['peak_gb']:.2f} GB (plain {one['peak_gb']:.2f}); "
        f"loss {got['loss']:.6f}; {card_line()}")
    out.update(group_of_one=dict(bit_equal=same, launches=launches, seconds=got["seconds"],
                                 plain_seconds=one["seconds"], peak_gb=got["peak_gb"],
                                 plain_peak_gb=one["peak_gb"]))
    out["faults"] = _tp_faults(cfg, one)
    log(f"phase19 planted faults against the one-card run: {out['faults']} (bounds: update "
        f"{TP_UPDATE_REL}, per-token losses {TP_TOKEN_REL})")

    # the 2-slot int8 round over (pod, data, model), against the vmap step
    rcfg = _round_cfg()
    stacked = build_stacked_model(rcfg, 2, device=DEVICE)
    _load_slots(stacked, rcfg, range(2))
    inputs, val = _lm_step_inputs(1, seed=100), _train_batch(8, TRAIN_SEQ, seed=90)
    ref_vl, ref_sel = make_pigeon_round_step(stacked, TRAIN_LR, quant="int8")(inputs, val)
    ref_round = dict(vlosses=ref_vl.tolist(), sel=int(ref_sel))
    del stacked
    torch.cuda.empty_cache()

    moe_cfg = dataclasses.replace(serve_config("qwen3-moe-30b-a3b", full=True),
                                  optimizations=("moe_shard",))
    if n == 1:
        with group_of_one("nccl"):
            rnd = _tp_round_rank((1, 1, 1))
        check(rnd["sel"] == ref_round["sel"] and rnd["vlosses"] == ref_round["vlosses"],
              f"phase19 round over (pod, data, model) (1, 1, 1): {rnd['vlosses']} sel "
              f"{rnd['sel']}, the vmap step {ref_round}")
        out["round"] = dict(dims=(1, 1, 1), sel=rnd["sel"], vlosses=rnd["vlosses"],
                            seconds=rnd["seconds"], peak_gb=rnd["peak_gb"],
                            launches=rnd["launches"])
        out["moe"] = dict(cards=1, **{k: v for k, v in moe_shard.items()
                                      if k not in ("logits", "ids", "kept")})
        # two gloo ranks on the one card (NCCL takes one rank a card): the
        # only run here of the model axis above 1, B4's panel among it
        ranks = spawn(_tp_gloo_rank, 2, "gloo", TP_DEADLINE_S)
        runs = {(1, 2): ranks}
        vlm_dims = (1, 2)
        backend = "gloo"
    else:
        torch.cuda.empty_cache()
        vlm_dims = (1, n)
        ranks = spawn(_tp_rank, n, "nccl", TP_DEADLINE_S,
                      args=(_tp_meshes(n), moe_cfg, moe_shard["ids"], (2, 1, n // 2),
                            _tp_decode1_meshes(n), vlm_dims, vlm_dims))
        out.update(world=ranks[0]["world"], nccl=ranks[0]["nccl"])
        runs = {dims: [dict(res["runs"][dims], rank=res["rank"]) for res in ranks]
                for dims in _tp_meshes(n)}
        backend = "nccl"
    # the batch-1 decodes (the sequence-sharded cache over the data ranks)
    # and InternVL2's whole vocab, against their one-card runs
    for res in ranks:
        for dims, d1 in res["decode1"].items():
            label = f"phase19 {backend} batch-1 decode {dims} rank {res['rank']}"
            gaps = _tp_decode1_compare(label, d1, one_b1, cfg.n_layers)
            log(f"{label}: {gaps}; panels (count, positions, rows whole) {d1['panels']}, "
                f"cache {d1['cache_bytes'] / 1e9:.4f} GB (one card "
                f"{TP_PROMPT + TP_NEW} positions); launches {d1['launches']}; "
                f"{d1['seconds']:.3f} s (one card {one_b1['seconds']:.3f}); collectives "
                f"{d1['collectives']}; {card_line()}")
            out[f"decode1 {backend} {dims} rank {res['rank']}"] = dict(
                gaps, panels=d1["panels"], seconds=d1["seconds"], launches=d1["launches"],
                collectives=d1["collectives"])
        label = f"phase19 {backend} vlm {vlm_dims} rank {res['rank']}"
        vlm = res["vlm"]
        gaps = _tp_compare(label, vlm, one_vlm)
        check(vlm["launches"] == vlm_want, f"{label}: launches {vlm['launches']}, want "
                                           f"{vlm_want}")
        log(f"{label}: InternVL2-26B at {vcfg.n_layers} layers, vocab {vcfg.vocab} whole: gaps "
            f"to the one-card run {gaps}; launches {vlm['launches']}; seconds "
            f"{vlm['seconds']} (one card {one_vlm['seconds']}); peak {vlm['peak_gb']:.2f} GB "
            f"(one card {one_vlm['peak_gb']:.2f}); collectives {vlm['collectives']}; "
            f"{card_line()}")
        out[f"vlm {backend} {vlm_dims} rank {res['rank']}"] = dict(
            gaps=gaps, launches=vlm["launches"], seconds=vlm["seconds"],
            peak_gb=vlm["peak_gb"], collectives=vlm["collectives"])
        # the last layer kinds over (1, 2) ((1, n) on n cards), vlm_dims'
        for arch, fam in res["families"].items():
            label = f"phase19 {backend} {arch} {vlm_dims} rank {res['rank']}"
            out[f"family {arch} {backend} {vlm_dims} rank {res['rank']}"] = \
                _tp_family_compare(label, arch, fam, one_fam[arch])
    # B6's partial mode on the main path: the first batch-1 decode, rank 0
    first = next(iter(ranks[0]["decode1"]))
    out["partial_launches"] = ranks[0]["decode1"][first]["launches"]
    out["partial_path"] = f"{backend} batch-1 decode {first}"
    out["runs"] = {}
    for dims, ranks_of in runs.items():
        for run in ranks_of:
            label = f"phase19 {backend} {dims} rank {run['rank']}"
            gaps = _tp_compare(label, run, one)
            check(run["launches"] == want, f"{label}: launches {run['launches']}, want {want}")
            log(f"{label}: gaps to the one-card run {gaps}; launches {run['launches']}; "
                f"seconds {run['seconds']} (one card {one['seconds']}); peak "
                f"{run['peak_gb']:.2f} GB (one card {one['peak_gb']:.2f}); collectives "
                f"{run['collectives']}; {card_line()}")
            out["runs"][f"{backend} {dims} rank {run['rank']}"] = dict(
                gaps=gaps, launches=run["launches"], seconds=run["seconds"],
                peak_gb=run["peak_gb"], collectives=run["collectives"])
    # B4's panel entry: its launches on the first mesh's train step, rank 1
    # (the panel _xent_panel timed), whose vocab panel is 151,936 / m wide
    out["panel"]["launches"] = runs[next(iter(runs))][1]["launches"]["train"]["fused_xent_tc"]
    if n > 1:
        for res in ranks:
            moe = res["moe"]
            label = f"phase19 moe rank {res['rank']}"
            gap = float(np.abs(moe["logits"] - moe_shard["logits"]).max()
                        / np.abs(moe_shard["logits"]).max())
            kept = all(np.array_equal(a, b) for a, b in zip(moe["kept"], moe_shard["kept"]))
            check(bool(np.isfinite(moe["logits"]).all()) and
                  all(g == 16 for g in moe["groups"]) and kept and gap <= SERVE_BF16_REL,
                  f"{label}: logits gap {gap:.3e} to one card (bound {SERVE_BF16_REL}), groups "
                  f"{set(moe['groups'])}, kept pairs equal {kept}")
            rnd = res["round"]
            rgap = max(abs(a - b) / abs(b) for a, b in zip(rnd["vlosses"], ref_round["vlosses"]))
            check(rnd["sel"] == ref_round["sel"] and rgap <= SERVE_BF16_REL,
                  f"phase19 round rank {res['rank']}: sel {rnd['sel']} (vmap {ref_round['sel']}),"
                  f" vlosses gap {rgap:.3e}")
            log(f"{label}: moe_shard prefill, routing pinned to one card's, gap {gap:.3e}, "
                f"{moe['seconds']:.3f} s, peak {moe['peak_gb']:.2f} GB, launches "
                f"{moe['launches']}, drops by layer and group {moe['drops'][:2]}...; round "
                f"(2, 1, {n // 2}) sel {rnd['sel']} gap {rgap:.3e}, {rnd['seconds']:.3f} s, peak "
                f"{rnd['peak_gb']:.2f} GB")
            out[f"moe rank {res['rank']}"] = dict(gap=gap, seconds=moe["seconds"],
                                                 peak_gb=moe["peak_gb"], drops=moe["drops"])
            out[f"round rank {res['rank']}"] = dict(sel=rnd["sel"], gap=rgap,
                                                   seconds=rnd["seconds"],
                                                   peak_gb=rnd["peak_gb"])
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase19 took {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 20: Gemma3-12B, H2O-Danube-1.8B and Qwen2.5-14B
# ---------------------------------------------------------------------------

#: the kernels each counter's route launches (profiler name fragments)
ROUTE_KERNELS = {"flash_attention": ("flash_fwd_kernel",),
                 "flash_attention_tc": ("flash_fwd_tc_kernel",),
                 "flash_attention_bwd": ("delta_kernel", "dkdv_kernel", "dq_kernel"),
                 "flash_attention_bwd_tc": ("flash_bwd_dkdv_tc_kernel", "flash_bwd_dq_tc_kernel",
                                            "flash_bwd_delta_kernel"),
                 "decode_attention": ("decode_partial_kernel", "decode_combine_kernel"),
                 "decode_attention_tc": ("decode_tc_kernel",),
                 "fused_xent": ("xent_fwd_kernel", "xent_combine_kernel", "xent_grad"),
                 "fused_xent_tc": ("xent_fwd_tc_kernel", "xent_combine_kernel"),
                 "fused_xent_bwd": ("xent_grad",),
                 "fused_xent_bwd_tc": ("xent_bwd_tc_kernel",)}


def _route_shares(launches: dict) -> dict:
    """``_profile_report``'s shares of the kernels a path launched, by
    counter (the route in its name)."""
    return {f"{name} ({'tensor cores' if '_tc' in name else 'f32-FMA route'})":
            ROUTE_KERNELS[name] for name, n in launches.items() if n}


#: phase 20's paths profiled whatever routes they take (label, path): where
#: B5 and B6 at head dims 80 and 256 moved from the f32-FMA routes to the
#: tensor cores, each kernel's share of the busy time by route
ALWAYS_PROFILED = {("danube", "prefill"), ("gemma3", "train"), ("danube", "train"),
                   ("gemma3", "decode"), ("danube", "decode")}


def _fma_profile(name: str, fn, wall_us: float, launches: dict, always: bool = False) -> dict:
    """``_profile_report`` of one call of a phase 20 path that launched an
    f32-FMA route, or of any with ``always`` (each route's share of the busy
    time, the idle share); an empty record, and no profile, for another path
    on the tensor cores only (the script's time limit)."""
    record = {}
    if always or any(n and "_tc" not in counter for counter, n in launches.items()):
        _profile_report(name, fn, wall_us, 1, shares=_route_shares(launches), record=record)
    return record


class _KVCapture:
    """Within the block, the keys and values of every ``ops.flash_attention``
    call in call order (a prefill's, layer by layer): what the reference's
    serve loop writes into the decode cache as it steps the prompt.
    ``fill(cache, n)`` writes their first ``n`` positions into the cache's
    layers, in order."""

    def __enter__(self):
        from repro_torch.kernels import ops
        self.saved, self.kv = ops.flash_attention, []

        def captured(q, k, v, **kw):
            self.kv.append((k, v))
            return self.saved(q, k, v, **kw)

        ops.flash_attention = captured
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops
        ops.flash_attention = self.saved

    def fill(self, cache, n: int) -> None:
        layers = sum(c["k"].shape[0] for c in cache)
        check(len(self.kv) == layers, f"_KVCapture: {len(self.kv)} attention calls for "
                                      f"{layers} cached layers")
        kv = iter(self.kv)
        for c in cache:
            for i in range(c["k"].shape[0]):
                k, v = next(kv)
                c["k"][i, :, :n] = k[:, :n]
                c["v"][i, :, :n] = v[:, :n]


def _dense_want(cfg, decode_steps: int = 0) -> dict:
    """The launches of phase 20's paths over a dense ``cfg``, per counter and
    route (``_kernel_counters``): the prefill B5's forward once a layer;
    ``decode_steps`` of the serve loop B6 once a layer and step; a train
    step (a loss and its gradient) B5's forward once a layer (twice under
    remat, which recomputes it) and its backward once, B4's forward and
    backward once."""
    names = _kernel_counters(cfg)
    n, fwd = cfg.n_layers, 2 if cfg.remat else 1
    return dict(prefill=want_launches(**{names["flash_attention"]: n}),
                serve=want_launches(**{names["decode_attention"]: n * decode_steps}),
                train=want_launches(**{names["flash_attention"]: fwd * n,
                                       names["flash_attention_bwd"]: n,
                                       names["fused_xent"]: 1, names["fused_xent_bwd"]: 1}))


def _dense_serve(arch: str, fam: dict) -> dict:
    """Phase 20's serve path of ``arch`` at full width and depth, bf16: the
    weights drawn on the card (the parameter count held against the
    config's), a (batch, prompt) prefill (``fam["serve"]``; warm, timed,
    launches as ``_dense_want`` plans, ``_fma_profile``), the decode cache given
    the prefill's keys and values of the prompt's first positions
    (``_KVCapture``), then the serve loop from the prompt's last position
    through DENSE_NEW greedy tokens (launches as planned): its logits at
    the prompt's last position against the prefill's within
    SERVE_BF16_REL; one warm decode step profiled (``_fma_profile``); the
    peak memory."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.launch.serve import greedy_decode, make_prompts, serve_config
    from repro_torch.launch.steps import make_prefill_step, make_serve_step

    label = f"phase20 {fam['label']}"
    cfg = serve_config(arch, full=True)
    model = _draw_model(label, cfg, 0, fam["params"])
    n_params = sum(x.numel() for x in model.parameters())
    log(f"{label} {cfg.name}: {n_params:,} parameters, {n_params * 2 / 1e9:.2f} GB of bf16 "
        f"weights; {card_line()}")
    b, p = fam["serve"]
    steps = 1 + DENSE_NEW
    plan = _dense_want(cfg, steps)
    prompts = torch.from_numpy(make_prompts(0, cfg.vocab, b, p)).to(DEVICE)
    prefill = make_prefill_step(model)
    with _KVCapture() as kv:                    # the warm-up: not counted
        prefill({"tokens": prompts})
    torch.cuda.synchronize()
    build.reset_launches()
    t0 = time.perf_counter()
    logits = prefill({"tokens": prompts})
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    prefill_launches = dict(build.LAUNCHES)
    check(prefill_launches == plan["prefill"],
          f"{label} prefill: launches {_launched({0: prefill_launches})[0]}, want "
          f"{_launched({0: plan['prefill']})[0]}")
    check(logits.shape == (b, 1, cfg.vocab) and bool(torch.isfinite(logits).all()),
          f"{label} prefill: logits {tuple(logits.shape)} not finite or misshapen")
    prefill_profile = _fma_profile(f"{label} {cfg.name} prefill (B {b} x {p}, bf16)",
                                   lambda: prefill({"tokens": prompts}), prefill_s * 1e6,
                                   prefill_launches,
                                   always=(fam["label"], "prefill") in ALWAYS_PROFILED)

    cache = model.init_cache(b, p + DENSE_NEW)
    kv.fill(cache, p - 1)
    del kv
    serve_step = make_serve_step(model)

    def from_last(c, tok, i):
        return serve_step(c, tok, p - 1 + i)

    torch.cuda.synchronize()
    build.reset_launches()
    t0 = time.perf_counter()
    gen, last = greedy_decode(from_last, cache, prompts[:, -1:], DENSE_NEW)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    loop_launches = dict(build.LAUNCHES)
    check(loop_launches == plan["serve"],
          f"{label} serve loop: launches {_launched({0: loop_launches})[0]}, want "
          f"{_launched({0: plan['serve']})[0]}")
    check(gen.shape == (b, DENSE_NEW) and int(gen.min()) >= 0 and int(gen.max()) < cfg.vocab,
          f"{label}: generated tokens {tuple(gen.shape)}")
    rel, argmax = _agreement(logits, last)
    check(rel <= SERVE_BF16_REL, f"{label}: prefill vs decode logits at position {p - 1} "
                                 f"differ by {rel:.3e} of max |logit| > {SERVE_BF16_REL}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ms_step = loop_s / steps * 1e3
    windows = sorted({w for sp in model.plan for w in sp.meta.get("window", ())})
    log(f"{label} prefill (B {b} x {p} tokens, windows {windows}, warm): {prefill_s:.4f} s, "
        f"launches {_launched({0: prefill_launches})[0]}; serve loop from position {p - 1}: "
        f"{steps} steps (1 prompt + {DENSE_NEW} greedy) in {loop_s:.3f} s: {ms_step:.3f} "
        f"ms/step, {b * steps / loop_s:.1f} tokens/s, launches "
        f"{_launched({0: loop_launches})[0]}; prefill vs decode logits max |diff| / max "
        f"|logit| {rel:.4e} (bound {SERVE_BF16_REL}), argmax agreement {argmax:.3f}; peak "
        f"device memory {peak_gb:.2f} GB; greedy tokens[0] {gen[0].tolist()}; {card_line()}")
    tok = gen[:, -1:].contiguous()
    decode_profile = _fma_profile(
        f"{label} {cfg.name} decode step (B {b}, index {p + DENSE_NEW - 1}, bf16)",
        lambda: serve_step(cache, tok, p + DENSE_NEW - 1)[0], ms_step * 1e3, loop_launches,
        always=(fam["label"], "decode") in ALWAYS_PROFILED)
    del model, cache, serve_step, prefill
    torch.cuda.empty_cache()
    return dict(params=n_params, prefill_launches=prefill_launches,
                loop_launches=loop_launches, prefill_s=prefill_s, ms_per_step=ms_step,
                tokens_per_s=b * steps / loop_s, peak_gb=peak_gb, rel=rel, argmax=argmax,
                prefill_profile=prefill_profile, decode_profile=decode_profile)


def _dense_train(arch: str, fam: dict) -> dict:
    """Phase 20's train path of ``arch`` at full width, ``fam["train_layers"]``
    layers, train_4k's settings (bf16, remat) on TRAIN_BATCH x TRAIN_SEQ:
    ``_three_steps`` with the launches ``_dense_want`` plans, its mfu and
    peak, one step profiled (``_fma_profile``); then at
    ``fam["f32_layers"]`` in f32 on 1 x ``fam["f32_tokens"]`` tokens the
    kernel path's loss and every gradient against the plain path's
    (``_kernel_vs_plain``, the f32-FMA routes)."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.shapes import SHAPES, shape_settings
    from repro_torch.launch.steps import make_train_step

    label = f"phase20 {fam['label']}"
    tcfg = dataclasses.replace(get_config(arch), n_layers=fam["train_layers"],
                               **shape_settings(SHAPES["train_4k"]))
    model = _draw_model(f"{label} train", tcfg, 1)
    batch = _train_batch(TRAIN_BATCH, TRAIN_SEQ)
    step = make_train_step(model, TRAIN_LR)
    plan = _dense_want(tcfg)["train"]
    train, wall_us = _three_steps(f"{label} train", step, batch, plan, model)
    profile = _fma_profile(f"{label} {tcfg.name} train step ({tcfg.n_layers} layers, B "
                           f"{TRAIN_BATCH} x {TRAIN_SEQ}, bf16, remat)", lambda: step(batch),
                           wall_us, plan, always=(fam["label"], "train") in ALWAYS_PROFILED)
    log(f"{label} train: {tcfg.n_layers} of {get_config(arch).n_layers} layers; peak "
        f"{train['peak_gb']:.2f} GB; mfu {train['mfu']:.4f}; {card_line()}")
    train.update(layers=tcfg.n_layers, profile=profile)
    del model, step, batch
    torch.cuda.empty_cache()

    fcfg = dataclasses.replace(get_config(arch), n_layers=fam["f32_layers"])
    model = _draw_model(f"{label} f32", fcfg, 5)
    rng = torch.Generator().manual_seed(6)
    small = {name: torch.randint(0, TRAIN_VOCAB, (1, fam["f32_tokens"]),
                                 generator=rng).to(DEVICE) for name in ("tokens", "labels")}
    windows = sorted(set(model.plan[0].meta["window"]))
    f32 = _kernel_vs_plain(f"{label} {fcfg.name} f32, {fcfg.n_layers} layers (windows "
                           f"{windows}), full width, 1 x {fam['f32_tokens']} tokens", model,
                           small, _dense_want(fcfg)["train"])
    train.update({k: v for k, v in f32.items() if k != "f32_grad_rels"})
    del model
    torch.cuda.empty_cache()
    return train


def _danube_round() -> dict:
    """The Pigeon-SL round over from_lm at H2O-Danube-1.8B's full width and
    depth (24 layers, its published cut at 6; train_4k's bf16 and remat),
    phase 8's task and protocol (M 4, N 1, T 2, E 2, B 4, label flip on
    client 0, Pigeon-SL+, no wire), on the sequential and the batched
    engine from one init: decisions equal, launches as the rounds'
    structure predicts on the routes Danube's tensors take (B4 and, at
    head dim 80, B5 both ways on the tensor cores; B1 once a batched
    round), seconds a round and peak memory."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import LABEL_FLIP, Attack, ProtocolConfig, from_lm
    from repro_torch.data import build_lm_task
    from repro_torch.launch.shapes import SHAPES, shape_settings
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_config(DANUBE_ARCH), **shape_settings(SHAPES["train_4k"]))
    data = build_lm_task(**ROUND_TASK)
    model = build_model(cfg, DEVICE)
    n_params = sum(x.numel() for x in model.parameters())
    log(f"phase20 danube round {cfg.name}: {cfg.n_layers} layers (cut {cfg.cut_layer}), "
        f"{cfg.dtype}, remat={cfg.remat}: {n_params:,} parameters ({n_params * 2 / 1e9:.2f} "
        f"GB a copy); routes {_kernel_counters(cfg)}")
    pcfg = ProtocolConfig(M=4, N=1, T=2, E=2, B=4, lr=1e-3)
    out, hists = {}, {}
    for engine in ("sequential", "batched"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        name = f"phase20 danube round {engine}"
        hist, launches, seconds = _run(name, from_lm(model), data, pcfg, malicious={0},
                                       attack=Attack(LABEL_FLIP), plus=True, engine=engine,
                                       device=DEVICE)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        count = _batched_round_launches if engine == "batched" else _round_launches
        want = count(cfg, pcfg, hist, None, data.x_test.shape[0])
        check(launches == want, f"{name}: launches {_launched({0: launches})[0]}, want "
                                f"{_launched({0: want})[0]}")
        log(f"{name}: {seconds / pcfg.T:.2f} s/round (init and first-call set-up "
            f"included); peak device memory {peak_gb:.2f} GB; launches "
            f"{_launched({0: launches})[0]}")
        hists[engine] = hist
        out[engine] = dict(launches=launches, s_per_round=seconds / pcfg.T, peak_gb=peak_gb)
    for rb, rs in zip(hists["batched"].rounds, hists["sequential"].rounds):
        for k in ROUND_DECISIONS:
            check(rb[k] == rs[k], f"phase20 danube round {rb['round']}: {k} "
                                  f"batched={rb[k]} sequential={rs[k]}")
    out["batched"]["float_gap"] = gap = _round_float_gap(hists["batched"], hists["sequential"])
    log(f"phase20 danube round: decisions equal on both engines "
        f"({[r['selected'] for r in hists['batched'].rounds]} selected); largest float gap "
        f"{gap:.3e}; {card_line()}")
    del model
    torch.cuda.empty_cache()
    return out


def phase_dense_families() -> dict:
    """Phase 20: Gemma3-12B, H2O-Danube-1.8B and Qwen2.5-14B (DENSE_FAMILIES)
    at full width: each served at full depth (``_dense_serve``), trained at
    its train_layers and held in f32 against the plain path
    (``_dense_train``); the Pigeon-SL round over Danube at full depth on
    both engines (``_danube_round``).  ``main`` runs it inside a
    ``_ShapeLog``: every bf16 B4, B5 and B6 call at a shape phase 1
    checked."""
    t_phase = time.perf_counter()
    out = {}
    for arch, fam in DENSE_FAMILIES.items():
        out[fam["label"]] = dict(serve=_dense_serve(arch, fam), train=_dense_train(arch, fam))
    out["danube_round"] = _danube_round()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase20 took {out['seconds']:.1f} s")
    return out


EXAMPLES = ("quickstart", "serve_decode")
EXAMPLES_DEADLINE_S = 300.0


def phase_examples() -> dict:
    """The port's examples ``EXAMPLES`` (``examples_torch/``) on the card, each
    a subprocess of its own, started together; a non-zero exit (or one past
    EXAMPLES_DEADLINE_S) fails the run.  Their last lines and seconds."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    args = [] if DEVICE == "cuda" else ["--device", DEVICE]
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen([sys.executable, str(ROOT / "examples_torch" / f"{name}.py"),
                                     *args], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
             for name in EXAMPLES}
    out = {}
    try:
        for name, proc in procs.items():
            text, _ = proc.communicate(timeout=max(1.0, EXAMPLES_DEADLINE_S
                                                   - (time.perf_counter() - t0)))
            lines = text.strip().splitlines()
            check(proc.returncode == 0, f"examples_torch/{name}.py exited {proc.returncode}: "
                                        + "\n".join(lines[-20:]))
            out[name] = dict(seconds=time.perf_counter() - t0, tail=lines[-4:])
            log(f"examples_torch/{name}.py: exit 0 within {out[name]['seconds']:.1f} s; "
                + " | ".join(lines[-4:]))
    except subprocess.TimeoutExpired:
        fail(f"the examples ran past {EXAMPLES_DEADLINE_S} s")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out


def _ptxas_by_head_dim(text: str) -> dict:
    """{head dim: (registers, bytes of spill stores)} of each
    ``decode_tc_kernel<D>`` in a ptxas -v log."""
    out, d = {}, None
    for line in text.splitlines():
        entry = re.search(r"Compiling entry function '[^']*decode_tc_kernelILi(\d+)E", line)
        if "Compiling entry function" in line:
            d = int(entry.group(1)) if entry else None
        spill = re.search(r"(\d+) bytes spill stores", line)
        regs = re.search(r"Used (\d+) registers", line)
        if d is not None and spill:
            out[d] = (out.get(d, (0, 0))[0], int(spill.group(1)))
        if d is not None and regs:
            out[d] = (int(regs.group(1)), out.get(d, (0, 0))[1])
    return out


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
    from repro_torch.core import compile_cache_stats
    log(f"phase0: kernel-library cache {compile_cache_stats()}")
    for name, text in logs.items():
        regs = [int(n) for n in re.findall(r"Used (\d+) registers", text)]
        spills = sum(int(n) for n in re.findall(r"(\d+) bytes spill stores", text))
        log(f"  ptxas {name}: {len(regs)} kernels, {min(regs)}-{max(regs)} registers a "
            f"thread, {spills} bytes of spill stores")
        for line in text.splitlines():
            if "C7517" in line or "C7508" in line:
                log(f"  ptxas {name}: {line.strip()[:160]}")
        if name == "decode_attention_tc":
            log(f"  ptxas {name} by head dim (registers, bytes of spill stores): "
                f"{_ptxas_by_head_dim(text)}")
    sass = phase_sass()

    seconds = {"build": round(time.perf_counter() - t0, 1)}

    def phase(name, fn, *args):
        """fn(*args), its wall seconds kept under ``name``."""
        t1 = time.perf_counter()
        result = fn(*args)
        seconds[name] = round(time.perf_counter() - t1, 1)
        return result

    kernels = phase("1", phase_kernels)
    torch.cuda.reset_peak_memory_stats()    # phase 5's peak: the protocol phases only
    main_path = phase("2 data", _cifar_main_path)
    seq_hist, seq_launches, s_per_round = phase("2", phase_cifar, main_path)
    launches, b_per_round, b_hist = phase("2b", phase_cifar_batched, main_path, seq_hist,
                                          s_per_round)
    baselines, sfl_hist = phase("2c", phase_baselines, main_path)
    multiround = phase("2d", phase_multiround, main_path)
    sweep_pool, replica_hists = phase("2e", phase_sweep_pool, main_path)
    sharded = phase("2f", phase_sharded, main_path, b_per_round,
                    dict(b=b_hist, splitfed=sfl_hist, **replica_hists))
    del b_hist, sfl_hist, replica_hists
    phase("3", phase_mnist)
    phase("4", phase_cpu_vs_card)
    phase("4 lm", phase_lm_cpu_vs_card)
    phase("4 lm round", phase_lm_round_cpu_vs_card)
    phase("5", phase_profile)
    phase("5 batched", phase_profile_batched, main_path)
    del main_path
    serve = phase("6", phase_serve)
    train = phase("7", phase_train)
    rounds, round_hists = phase("8", phase_round)
    batched_lm = phase("8b", phase_round_batched, round_hists)
    shardmap = phase("8c", phase_round_sharded, batched_lm)
    del round_hists
    xlstm = phase("9", phase_xlstm)
    xlstm_train = phase("10", phase_xlstm_train)
    xlstm_rounds = phase("11", phase_xlstm_round)
    vlm = phase("12", phase_vlm)
    moe = phase("13", phase_moe)
    moe_rounds = phase("14", phase_moe_round)
    with _ShapeLog() as shapes:
        zamba2 = phase("15", phase_zamba2)
        zamba2_rounds = phase("16", phase_zamba2_round)
        seamless = phase("17", phase_seamless)
    _check_shape_log("phases 15-17", shapes,
                     {name: kernels[name]["slice_shapes"] for name in shapes.seen})
    analysis = phase("18", phase_analysis)
    tp = phase("19", phase_tensor_parallel, moe.pop("qmoe_moe_shard"))
    with _ShapeLog() as shapes:
        dense = phase("20", phase_dense_families)
    _check_shape_log("phase 20", shapes,
                     {name: kernels[name]["slice_shapes"] for name in shapes.seen})
    examples = phase("examples", phase_examples)

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
               "sharded": sharded["launches"],
               "serve": serve["launches"],
               "train": train["launches"],
               **{f"round_{q}": r["launches"] for q, r in rounds.items()},
               **{f"round_batched_{q}": batched_lm[q]["launches"]
                  for q in rounds},
               **{f"round_step_{q}": r["launches"]
                  for q, r in batched_lm["round_steps"].items()},
               "splitfed_lm_batched": batched_lm["splitfed"]["launches"],
               "round_step_sharded_int8": shardmap["launches"],
               "xlstm_prefill": xlstm["prefill_launches"],
               "xlstm_decode": xlstm["loop_launches"],
               "xlstm_train": xlstm_train["launches"],
               **{f"xlstm_round_{q}": r["launches"] for q, r in xlstm_rounds.items()
                  if isinstance(r, dict)},
               "vlm_prefill": vlm["serve"]["prefill_launches"],
               "vlm_serve_loop": vlm["serve"]["loop_launches"],
               "vlm_train": vlm["train"]["launches"],
               **{f"{m}_{what}": moe[m][f"{what}_launches"] for m in ("dsv2", "qmoe")
                  for what in ("prefill", "loop")},
               "dsv2_train": moe["dsv2_train"]["launches"],
               **{f"moe_round_{q}": r["launches"] for q, r in moe_rounds.items()
                  if isinstance(r, dict)},
               "zamba2_prefill": zamba2["serve"]["prefill_launches"],
               "zamba2_serve_loop": zamba2["serve"]["loop_launches"],
               "zamba2_train": zamba2["train"]["launches"],
               **{f"zamba2_round_{q}": r["launches"] for q, r in zamba2_rounds.items()
                  if isinstance(r, dict)},
               "seamless_prefill": seamless["serve"]["prefill_launches"],
               "seamless_serve_loop": seamless["serve"]["loop_launches"],
               "seamless_train": seamless["train"]["launches"],
               **{f"{fam['label']}_{what}": dense[fam["label"]]["serve"][f"{what}_launches"]
                  for fam in DENSE_FAMILIES.values() for what in ("prefill", "loop")},
               **{f"{fam['label']}_train": dense[fam["label"]]["train"]["launches"]
                  for fam in DENSE_FAMILIES.values()},
               **{f"danube_round_{engine}": dense["danube_round"][engine]["launches"]
                  for engine in ("sequential", "batched")}}
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
        if "slice_shapes" in k:
            # phases 12-17's and 20's own shapes (phase 1), with the launches
            # of the path each comes from; phase 20's with their yardsticks
            entry["slice_shapes"] = [dict(
                shape=t["shape"], path=t["path"], route=t["route"],
                **({} if t["causal"] else {"causal": False}),
                launches=None if t["path"] is None else by_path[t["path"]][t["counter"]],
                **{e: t[e] for e in ("max_abs_err", "max_rel_err") if e in t},
                ms=ms(t["kernel_us"]),
                **({} if "bound_us" not in t else dict(
                    plain_ms=ms(t["plain_us"]), bound_ms=ms(t["bound_us"]),
                    bound_by=t["bound_by"], library_ms=ms(t["library_us"]))))
                for t in k["slice_shapes"]]
        if "lm_message" in k:
            # the LM round's cut message (B3's wide path)
            lm = k["lm_message"]
            entry["lm_message"] = dict(
                shape=lm["shape"], ms=ms(lm["kernel_us"]),
                device_ms_l2_warm=ms(lm["kernel_dev_us"]),
                device_ms_l2_cold=ms(lm["kernel_cold_us"]), plain_ms=ms(lm["plain_us"]),
                plain_device_ms=ms(lm["plain_dev_us"]), bound_ms=ms(lm["bound_us"]),
                bound_by=lm["bound_by"])
        if "non_causal" in k and name == "flash_attention_bwd":
            # B5's backward in non-causal mode (phase 1's checks), its
            # launches on SeamlessM4T's train step (the encoder and the
            # cross-attention)
            nc = k["non_causal"]
            nkey = f"{key}_noncausal"
            entry["non_causal"] = dict(
                name=f"{name} (non-causal)", shape=nc["shape"], route="cuda",
                source=sources[name][1], replaces=sources[name][0],
                launches=by_path["seamless_train"][nkey],
                launches_by_path={path: counts[nkey] for path, counts in by_path.items()},
                max_abs_err=nc["max_abs_err"], max_rel_err=nc["max_rel_err"],
                max_rel_err_by_route=nc["max_rel_err_by_route"], ms=ms(nc["kernel_us"]),
                device_ms_l2_warm=ms(nc["kernel_dev_us"]),
                device_ms_l2_cold=ms(nc["kernel_cold_us"]), plain_ms=ms(nc["plain_us"]),
                bound_ms=ms(nc["bound_us"]), bound_by=nc["bound_by"],
                library_ms=ms(nc["library_us"]), library_device_ms=ms(nc["library_dev_us"]),
                f32_fma_route=dict(ms=ms(nc["f32_fma_route"]["kernel_us"]),
                                   device_ms_l2_warm=ms(nc["f32_fma_route"]["kernel_dev_us"]),
                                   device_ms_l2_cold=ms(nc["f32_fma_route"]["kernel_cold_us"])))
        elif "non_causal" in k:
            # B5's non-causal mode (phase 1's checks), its launches on
            # SeamlessM4T's prefill (the encoder and the cross-attention)
            nc = k["non_causal"]
            nkey = f"{key}_noncausal"
            entry["non_causal"] = dict(
                name=f"{name} (non-causal)", shape=nc["shape"], route="cuda",
                source=sources[name][1], replaces=sources[name][0],
                launches=by_path["seamless_prefill"][nkey],
                launches_by_path={path: counts[nkey] for path, counts in by_path.items()},
                max_abs_err=nc["max_abs_err"],
                max_abs_err_by_route=nc["max_abs_err_by_route"], ms=ms(nc["kernel_us"]),
                device_ms_l2_warm=ms(nc["kernel_dev_us"]),
                device_ms_l2_cold=ms(nc["kernel_cold_us"]), plain_ms=ms(nc["plain_us"]),
                bound_ms=ms(nc["bound_us"]), bound_by=nc["bound_by"],
                library_ms=ms(nc["library_us"]), library_device_ms=ms(nc["library_dev_us"]),
                f32_fma_route=dict(ms=ms(nc["f32_fma_route"]["kernel_us"]),
                                   device_ms_l2_warm=ms(nc["f32_fma_route"]["kernel_dev_us"]),
                                   device_ms_l2_cold=ms(nc["f32_fma_route"]["kernel_cold_us"])),
                others=[dict(shape=t["shape"], ms=ms(t["kernel_us"]),
                             device_ms_l2_warm=ms(t["kernel_dev_us"]),
                             device_ms_l2_cold=ms(t["kernel_cold_us"]), plain_ms=ms(t["plain_us"]),
                             bound_ms=ms(t["bound_us"]), bound_by=t["bound_by"],
                             library_ms=ms(t["library_us"]),
                             library_device_ms=ms(t["library_dev_us"]),
                             f32_fma_route_device_ms=ms(t["f32_fma_route"]["kernel_dev_us"]))
                        for t in nc["others"]])
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
    # B4 on a vocab-parallel panel (phase 19): its launches on the train
    # step of the run whose panel it is (one card: two gloo ranks over (1,
    # 2); n cards: the (1, n) mesh)
    panel = tp["panel"]
    entries.append(dict(
        name="fused_xent (vocab-parallel panel)", route="cuda",
        source="src/repro_torch/kernels/csrc/fused_xent_tc.cu",
        replaces=sources["fused_xent"][0], launches=panel["launches"],
        shape=panel["shape"], max_abs_err=panel["max_abs_err"],
        max_rel_err_bwd=panel["max_rel_err_bwd"], ms=ms(panel["kernel_us"]),
        plain_ms=ms(panel["plain_us"]), bound_ms=ms(panel["bound_us"]),
        bound_by=panel["bound_by"], library_ms=None, backward_ms=ms(panel["bwd_us"]),
        backward_bound_ms=ms(panel["bwd_bound_us"])))
    # B6's partial mode (phase 1's panels; the main path's shape is phase
    # 19's batch-1 decode, a panel of 20 positions), its launches on that
    # decode's run (one card: two gloo ranks over (2, 1); n cards: (n, 1))
    part = kernels["decode_attention"]["partial"]

    def panel_times(t):
        return dict(ms=ms(t["kernel_us"]), device_ms_l2_warm=ms(t["kernel_dev_us"]),
                    device_ms_l2_cold=ms(t["kernel_cold_us"]), plain_ms=ms(t["plain_us"]),
                    plain_device_ms=ms(t["plain_dev_us"]), bound_ms=ms(t["bound_us"]),
                    bound_by=t["bound_by"], library_ms=None)
    entries.append(dict(
        name="decode_attention (partial)", route="cuda",
        source="src/repro_torch/kernels/csrc/decode_attention_tc.cu",
        replaces=sources["decode_attention"][0],
        launches=tp["partial_launches"]["decode_attention_partial_tc"],
        launches_path=tp["partial_path"], shape=part["shape"], panels=part["panels"],
        live_keys=part["live_keys"], max_abs_err=part["max_abs_err"],
        max_abs_err_by_route=part["max_abs_err_by_route"], empty_panels=part["empty_panels"],
        **panel_times(part),
        f32_fma_route=dict(source="src/repro_torch/kernels/csrc/decode_attention.cu",
                           device_ms_l2_warm=ms(part["f32_fma_route"]["kernel_dev_us"])),
        timed=[dict(shape=t["shape"], panels=t["panels"], panel=t["panel"], route=t["route"],
                    live_keys=t["live_keys"], **panel_times(t)) for t in part["timed"]]))
    log(f"phase2 seconds_per_round={s_per_round:.3f}; phase2b (batched) "
        f"seconds_per_round={b_per_round:.3f}; phase2c baselines {baselines}; "
        f"phase2d multiround {multiround}; phase2e sweep and pool {sweep_pool}; "
        f"phase2f sharded {sharded}; "
        f"phase6 serve {serve}; phase7 train {train}; "
        f"phase8 rounds {rounds}; phase8b batched LM {batched_lm}; phase8c sharded LM "
        f"step {shardmap}; phase9 xlstm {xlstm}; "
        f"phase10 xlstm train {xlstm_train}; phase11 xlstm rounds {xlstm_rounds}; "
        f"phase12 vlm {vlm}; phase13 moe {moe}; phase14 moe rounds {moe_rounds}; "
        f"phase15 zamba2 {zamba2}; phase16 zamba2 rounds {zamba2_rounds}; "
        f"phase17 seamless {seamless}; phase18 analysis {analysis}; phase19 tensor "
        f"parallel {tp}; phase20 dense families {dense}; examples {examples}")
    log(f"phase seconds {seconds}; {time.perf_counter() - t0:.1f} s since the build began")
    log(json.dumps({"kernels": entries}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
