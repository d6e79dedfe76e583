#!/usr/bin/env python3
"""Drive the PyTorch port (`src/repro_torch`) on one CUDA card.

    python3 chip_smoke.py

Phases, one line each (or more); any failure raises and exits non-zero:
  1. device   the card's name and power limit (nvidia-smi);
  2. build    every kernel under src/repro_torch/kernels/csrc, one nvcc each,
              all started together;
  3. kernels  each kernel against its plain PyTorch version run in fp32 on
              the same inputs, on the card (phase 14's shapes too: d 64 with
              G 1 and 2, non-causal, Sq != Skv): the test sweeps, the profiling
              catalog's shapes and full width (decode: mistral-nemo-12b at
              B8/Skv4096, h2o-danube-1.8b's d 80, G 4 at B8/Skv4096 and at
              short caches, h2o-danube-3-4b's d 120, G 4 and gemma-7b's
              d 256, G 1 at B8/Skv4096; flash: mistral-nemo-12b prefill at
              S4096, h2o-danube-1.8b's window at S8192, h2o-danube-3-4b's
              d 120 window at S5120 and gemma-7b's d 256 at S2048; ssm:
              jamba-1.5-large's Mamba layer, di 16384, N 16, S4096); and
              phase 7's own decode calls (B1 and B2, caches of 1039, 2079
              and 4096 rows) and prefills (mistral-nemo-12b B2 S2048,
              gemma-7b S1024); then both attention kernels on MLA's route
              (deepseek-v2-lite-16b: q.k at 192, v at 128 zero-padded to
              it and the output cut back; decode at B8/Skv4096 ragged and
              full and at phase 14's generate calls, prefill at B2 S2048;
              both at the SMOKE widths 24 and 16) and at d 192 unpadded;
              jamba-1.5-large-398b's attention at G 8, the decode kernel's
              widest group (decode B8/Skv4096 H64 Hk8, ragged and full, and
              phase 14's generate calls; flash B1 S4096 H64 causal); and
              the scan from a random initial state h0 with its final state
              h_last compared too, at every L, for the sweep and jamba's
              width at S 4096 and 4093, then a scan over S 4096 against two
              over 2048, the second from the first's h_last; then both
              attention kernels with the logit cap (cap*tanh(s/cap)) at
              caps 50 and 5, in bf16 and fp32, against their plain versions
              with the same cap, at gemma-7b's d 256, h2o-danube-1.8b's d
              80 and the table's d 128 (and phase 15's gemma-7b decode
              calls), q and k spreading the scores to about 30, each cap
              required to move the output;
  4. parity   SMOKE configs in fp32, the model on the card (through the
              kernels) against the same weights on the CPU (plain path):
              mistral-nemo-12b's decode logits and the serving engine's
              greedy tokens; then h2o-danube-1.8b's ring cache (window 16):
              40 decode steps at one position and 40 at ragged per-row
              positions, both past the window, and the engine's tokens;
              xlstm-350m's decode logits and the engine's tokens under slot
              reuse; then prefill logits and `greedy_generate` tokens for
              all five ported architectures (prompts past the window);
  5. serve    mistral-nemo-12b FULL in bf16: `launch.serve.run` at batch 8,
              kv_cap 4096 (100 requests), then a ServingEngine with 8 slots answering ragged
              requests; the kernel's launch count must be 40 per decode step;
  6. share    h2o-danube-1.8b FULL in bf16: `launch.serve.run` at batch 8,
              kv_cap 4096 (the ring, 100 requests), alone and then with `share=True`
              (AdamW train steps of a second copy packed in by the
              multiplexer); 24 launches per decode step, at least one offline
              step, and the train step counter at offline steps + 2;
  7. generate `greedy_generate` in bf16 FULL, one model at a time:
              mistral-nemo-12b (batch 2, a 2048-token prompt; 10 of its
              40 layers, since phase 14's pixtral-12b runs that backbone
              at full depth),
              h2o-danube-3-4b (batch 1, 5120 tokens: past its 4096 window,
              so decode runs on the ring the prefill aligned), gemma-7b
              (batch 1, 1024 tokens) and xlstm-350m (batch 2, 512 tokens);
              flash_attention once a layer in each dense prefill,
              decode_attention once a layer a decode step, no kernel in the
              mLSTM; prefill ms, decode ms a step, tokens/s and peak memory;
              then `launch.serve.run("xlstm-350m", smoke=False)` alone and
              with `share=True` (`repro`'s default workload at full width);
  8. profile  MuxFlow's measurement loop on the card: the smoke suite's speed
              matrix (as `python -m repro_torch profile` builds it), schema
              clean and equal to the CPU-built matrix but for checksums,
              which agree within a stated tolerance; all three kernels must
              launch; then the measured speed predictor trained on the card;
  9. train    three momentum-SGD steps of xlstm-350m FULL in bf16 (batch 2,
              seq 512); five AdamW steps of h2o-danube-1.8b FULL in bf16
              through `launch.train.run` (batch 8, seq 64): finite losses,
              step time, peak memory; then a checkpoint of h2o-danube-1.8b
              SMOKE's weights and AdamW state saved and restored to the card,
              bit-equal;
 10. timing   each kernel, its plain version and the library call that
              computes the same function (where one exists), at full width;
              decode attention, whose call is about as short on the card
              as the host's per-call Python, as device time in a CUDA graph
              of 20 calls (its library call too); the scan with events and
              in a CUDA graph, the SM clock read after its timed loop, the
              lanes a channel `lane_plan` chose, ptxas's registers and
              spills for each template, and one line for each L it takes;
              then the attention kernels and SDPA at phase 7's new shapes
              (d 120 and d 256) and phase 14's (d 64 decode at G 1 and 2;
              flash for seamless-m4t-medium's encoder, cross and self
              attention, granite-moe-1b-a400m and pixtral-12b), in CUDA
              graphs, each beside its bound; and both at deepseek-v2-lite-
              16b's MLA shapes (decode B8/Skv4096, prefill B2 S2048, v
              padded to 192) beside the bound of the model's own work (q.k
              192, v 128) and SDPA at those widths, with the kernels SDPA
              ran; the scan at jamba's width without state, with h_last out
              (jamba's prefill) and with h0 in and h_last out, in turns in
              CUDA graphs; decode and flash at jamba's shapes (G 8, H64);
              both attention kernels at the table's shapes with the cap of
              50 and without, in CUDA graphs in turns, beside
              `flex_attention` with a tanh score_mod under torch.compile,
              the one PyTorch call that computes the capped function;
 11. fleet    MuxFlow's scheduling step at the paper's 20,000 GPUs: phase 8's
              card matrix and card-trained predictor drive
              `run_policy(MeasuredMuxFlowPolicy(matrix=card_matrix), ...)`
              (trace B, 30 s ticks, a round every 900 s, seed 0, 2 h of
              SimConfig's 12 h) once on the numpy tick engine and once on
              the torch engine on the card; the two SimResults must be
              equal byte for byte as canonical JSON; `online-only` at the same fleet gives
              the dedicated baseline; the card's predictions over one
              round's weight grid against the same MLP on the CPU (1e-5);
              one block of the torch engine under torch.profiler (the card's
              busy time and launches); then 200 devices under heavy faults,
              the torch engine in lockstep with numpy tick by tick and
              byte-equal SimResults; then tests/test_sim_parity.py's
              configuration (50 devices, 4 h of 30 s ticks, trace B, seed
              12345, `muxflow`, a predictor trained on the card as that
              test trains its own): the torch engine on the card against
              the per-device `LegacyClusterSim` under the test's rule
              (counts equal, floats rel 1e-9 / abs 1e-12, p99 rel 0.02 /
              abs 0.2, timelines rel 1e-9), each engine's seconds;
 12. control  MuxFlow's control plane (`repro_torch.cluster`, the tick loop
              with agents, fault campaign, autoscaler and job manager over
              the engine): `repro`'s flagship `diurnal-mixed` at the paper's
              20,000 GPUs over 6 h of the scenario's 12 h, on the numpy
              engine and on the torch engine on the card, under one
              predictor trained
              once on the card by the policy's own `build_predictor`; the
              reports must be equal byte for byte and schema clean; ms a
              tick by engine, where the time goes, and the card's idle share
              over the torch run's last ticks under torch.profiler; then the
              front door in-process: `sim --scenario calibrated` (its matrix
              built on the card through all three kernels, each of which must
              launch), `serve --scenario serving-slo` (p50/p99/SLO attainment
              by service) and `sim --scenario chaos-storm` (every injected
              fault paired with its recovery);
 13. durable  the observability and durability planes over the card's tick
              engine: `sim --scenario diurnal-mixed --devices 20000
              --hours 3 --engine torch` (3 h of its 12 h) with every obs
              flag (metrics, trace, Prometheus and alerts every 600 s,
              `--profile-phases`) and `--durable` (jsonl WAL, a snapshot
              every 1800 s): the report schema clean with every event in
              the WAL, the Prometheus text lint-clean, the manifest
              verified; the time by layer (WAL appends, snapshots, metrics,
              trace, alerts) and the engine's phase table; the same run
              killed by a tick callback at tick 260 (between two
              snapshots, after the pruning began) and resumed
              by `python -m repro_torch sim --resume` in a fresh process
              (which trains its predictor again on the card): the report
              and the four obs files byte-equal to the uninterrupted run's,
              `diff` identical; `inspect` at tick 330; `serve --scenario
              serving-slo --hours 6` durable with every obs flag on the
              numpy and
              the torch engine, every artifact and WAL segment byte-equal;
              `chaos --scenario chaos-storm --engine torch`, every invariant
              passing.
 14. zoo      the rest of the model zoo: pixtral-12b (1024 patch
              embeddings before the tokens), seamless-m4t-medium (a 12-layer
              encoder over 1024 source frames, cross attention, ReLU) and
              granite-moe-1b-a400m (32 experts, top 8, grouped dispatch).
              Parity at SMOKE in fp32, the card against the CPU: prefill
              logits, 20 decode steps' logits and `greedy_generate`'s
              tokens for each, and granite's decode at ragged positions and
              engine tokens under ragged slots.  Then in bf16 at FULL:
              `greedy_generate` (pixtral-12b B1 x (1024 patches + 1024
              tokens), seamless-m4t-medium B2 x 512 tokens over 1024
              frames, granite-moe-1b-a400m B2 x 2048 at 6 of its 24
              layers, 31 steps each) with the launches required exactly
              (flash once a layer, the encoder's and the cross attention's
              too; decode once a layer a step, twice with cross attention);
              granite served by `serve.run` alone and with `share=True` and
              by the engine with ragged requests (6 layers); granite
              trained through
              `launch.train.run` (B2 x 512) and one train step's moe_aux,
              three AdamW steps of seamless-m4t-medium on batches with
              source frames, and pixtral-12b's eval step.  Then
              deepseek-v2-lite-16b (MLA over a latent cache, 64 experts top
              6 + 2 shared): SMOKE parity as above (prefill, decode and
              greedy tokens; decode at ragged positions and the engine's
              tokens), then at FULL on one set of weights `greedy_generate`
              B2 x 2048, 31 steps (flash 27, decode 837 launches), the
              engine with ragged requests, and the eval step B2 x 512 with
              its moe_aux (its AdamW state, 194.5 GB, does not fit).  Then
              jamba-1.5-large-398b (Mamba and attention in an 8-layer
              super-block, 16 experts top 2): SMOKE parity as above, then
              at FULL width over the super-block's first five layers in
              their own order (four Mamba layers, two with the MoE, then
              attention; 24.0e9 parameters, 44.8 GiB) on one set of
              weights: `greedy_generate` B1 x 4096, 31 steps (ssm_scan 4,
              one a Mamba layer in the prefill, flash 1, decode 31
              launches), the engine with ragged requests at capacity 256,
              and the eval step B1 x 512 with its moe_aux.
 15. knobs    `repro`'s ModelConfig knobs at published widths:
              h2o-danube-1.8b FULL (24 layers) trained two AdamW steps at
              B1 x 8192 through `launch.train.run` (remat on, attention
              streamed over KV chunks, past 4096**2 scores a head); the
              same model's gradient at B1 x 2048 with remat on and off (the
              loss equal, the gradients within 2e-5 by relative norm), and
              at B1 x 8192 with the KV chunks hidden from a whole query
              chunk skipped and with every chunk computed (the same, and
              both times);
              gemma-7b FULL with Gemma 2's cap of 50: `greedy_generate`
              B1 x 2048, 31 steps (flash 28, decode 868 launches), its
              first decode step against the same step through the plain
              versions on the card (2e-2 by relative norm; each layer's
              gap, the largest score and how far the cap moves the logits
              printed beside), the eval step
              at B1 x 8192 with and without the fused loss (1e-3); and
              gemma-7b's first two layers at full width, a train step at
              B1 x 8192 fused against unfused (loss 1e-3, gradients 2e-2
              by relative norm), then one AdamW step.
 16. examples the example ports: `examples/torch_serve_multiplex.py` at
              full width in a child process (the SIGINT its timer sends at
              half the horizon is the child's own; the child loads the
              kernels phase 2 built): h2o-danube-1.8b FULL decoding B8 on
              a standing cache of capacity 128 through decode_attention,
              granite-moe-1b-a400m FULL's AdamW steps (B8 x 64) packed in by
              the multiplexer, 35 Poisson requests (the original's 150 cut
              for time); the signal must land (SIGINT caught, offline
              launches frozen, one checkpoint, one release, no offline step
              begun after it, the online side serving on or the eviction
              stated) and decode_attention launch exactly 24 times a decode
              call; the child's set-up is printed split into its parts;
              then `torch_quickstart` (the predictor trained on the
              card, Algorithm 1's plan) and `torch_train_lm --steps 40`
              (evicted at 20, resumed from the checkpoint at 20, the loss
              falls).  `torch_cluster_sim`'s paths are phases 11 and 12's.
Then one line of each phase's seconds and the card's name and power limit
again (phase 1's line).  The line before the last is
{"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.  Without CUDA, or outside a checkout of the
repository, it exits non-zero before printing any result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# H100 SXM, NVIDIA's data sheet (dense, at the full 700 W power limit)
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
# exponentials on the SFU: 16 results a clock a SM (CUDA programming guide,
# arithmetic throughput, compute capability 9.0) x 132 SMs x 1.98 GHz, the
# boost clock behind the 67 TFLOP/s fp32 peak (132 x 128 FMA x 2 x 1.98 GHz)
PEAK_EXP_S = 16 * 132 * 1.98e9

MAIN = dict(B=8, Skv=4096, H=32, Hk=8, d=128)     # mistral-nemo-12b decode
RAGGED = [1, 17, 512, 1000, 2048, 3000, 4095, 4096]
# (B, Skv, H, Hk, d, kv_len): h2o-danube-1.8b's decode (d 80, G 4) on its
# 4096-row ring, then at short caches (its SMOKE window's 16 rows, 128)
DANUBE_SHAPES = [
    (8, 4096, 32, 8, 80, [1, 16, 80, 1000, 2048, 3333, 4095, 4096]),
    (8, 4096, 32, 8, 80, 4096),
    (3, 16, 8, 2, 80, [1, 9, 16]),
    (4, 128, 32, 8, 80, [1, 17, 100, 128]),
]
# (B, Skv, H, Hk, d, kv_len): h2o-danube-3-4b's decode (d 120, G 4: 240-byte
# bf16 rows, the d <= 128 template with d below it) and gemma-7b's (d 256,
# MHA), both at B8 on a 4096-row cache, ragged and full
ZOO_DECODE = [(8, 4096, 32, 8, 120, RAGGED), (8, 4096, 32, 8, 120, 4096),
              (8, 4096, 16, 16, 256, RAGGED), (8, 4096, 16, 16, 256, 4096)]
# (B, Skv, H, Hk, d, kv_len): the decode calls of phase 7's generate runs, at
# their own batch and cache (split_plan gives B1 and B2 many short splits and
# a wide combine): h2o-danube-3-4b on its 4096-row ring, gemma-7b's 1024 +
# 15 rows and mistral-nemo-12b's 2048 + 31, each at its first and last step
GEN_DECODE = [(1, 4096, 32, 8, 120, 4096), (1, 4096, 32, 8, 120, 1001),
              (1, 1039, 16, 16, 256, 1025), (1, 1039, 16, 16, 256, 1039),
              (2, 2079, 32, 8, 128, [2049, 2049]),
              (2, 2079, 32, 8, 128, [2079, 2064])]
# (B, Skv, H, Hk, d, kv_len): phase 14's new decode shapes, all d 64:
# seamless-m4t-medium's cross attention (MHA) over its 1024 source rows and
# granite-moe-1b-a400m's self attention (G 2) at B8 on a 4096-row cache,
# ragged and full; then the decode calls of phase 14's generate runs, each
# at its first and last step: pixtral-12b's 1024 patches + 1024 tokens + 31
# rows (d 128, G 4), seamless-m4t-medium's 512 + 31 decoder rows and
# granite-moe-1b-a400m's 2048 + 31
ZOO2_DECODE = [(2, 1024, 16, 16, 64, 1024), (8, 4096, 16, 8, 64, RAGGED),
               (8, 4096, 16, 8, 64, 4096)]
ZOO2_GEN_DECODE = [(1, 2079, 32, 8, 128, 2049), (1, 2079, 32, 8, 128, 2079),
                   (2, 543, 16, 16, 64, [513, 513]),
                   (2, 543, 16, 16, 64, [543, 543]),
                   (2, 2079, 16, 8, 64, [2049, 2049]),
                   (2, 2079, 16, 8, 64, [2079, 2079])]
# deepseek-v2-lite-16b's MLA (phase 14): q.k at 192 (128 + the 64-wide
# rotary part) and v at 128, zero-padded to 192 on the way into the kernels
# and cut back after (`layers.pad_v`), MHA.  (B, Skv, H, dq, dv, kv_len) of
# its decode: B8 on a 4096-row cache, ragged and full; phase 14's generate
# calls at their first and last step (2048 + 31 rows); the SMOKE widths 24
# and 16; then the kernel at d 192 with a v of that width (nothing padded).
# (B, S, H, dq, dv) of its causal prefill: phase 14's B2 x 2048, the SMOKE
# widths, and the kernel at d 192 unpadded
MLA_DECODE = [(8, 4096, 16, 192, 128, RAGGED), (8, 4096, 16, 192, 128, 4096),
              (2, 2079, 16, 192, 128, [2049, 2049]),
              (2, 2079, 16, 192, 128, [2079, 2079]),
              (4, 64, 4, 24, 16, [1, 9, 40, 64]),
              (8, 4096, 16, 192, 192, RAGGED)]
MLA_FLASH = [(2, 2048, 16, 192, 128), (2, 21, 4, 24, 16),
             (2, 2048, 16, 192, 192)]
# jamba-1.5-large-398b's attention (phase 14), H64 Hk8 d128, so G 8, the
# decode kernel's widest group: (B, Skv, H, Hk, d, kv_len) of its decode at
# B8 on a 4096-row cache, ragged and full, then phase 14's generate calls
# at their first and last step (4096 + 31 rows); and its causal prefill
JAMBA_DECODE = [(8, 4096, 64, 8, 128, RAGGED), (8, 4096, 64, 8, 128, 4096),
                (1, 4127, 64, 8, 128, 4097), (1, 4127, 64, 8, 128, 4127)]
FLASH_JAMBA = (1, 4096, 4096, 64, 8, 128, True, None)
# (B, Sq, Skv, H, Hk, d, causal, window): tests/test_kernels.py:20-26, the
# catalog's flash-prefill, ragged tiles at d 80, a window without causal, d 256
FLASH_SHAPES = [
    (1, 128, 128, 1, 1, 128, True, None),
    (2, 256, 256, 4, 2, 128, True, None),
    (2, 128, 256, 4, 4, 128, False, None),
    (1, 256, 256, 8, 2, 128, True, 128),
    (2, 384, 384, 2, 1, 128, True, 256),
    (1, 128, 128, 4, 2, 64, True, None),
    (1, 200, 300, 4, 2, 80, True, None),
    (2, 100, 100, 6, 2, 24, False, 50),
    (1, 64, 64, 2, 1, 256, True, None),
    # the tensor-core kernel's edges: Sq 1, 63, 65, 200; Sq != Skv; a window
    # without causal at d 24; d 256 with a window
    (1, 1, 1, 2, 1, 128, True, None),
    (1, 1, 77, 4, 2, 64, False, None),
    (2, 63, 63, 4, 2, 128, True, None),
    (1, 65, 130, 4, 1, 80, True, None),
    (1, 200, 200, 2, 2, 256, True, 64),
    (1, 96, 160, 4, 2, 24, False, 40),
]
FLASH_MAIN = (1, 4096, 4096, 32, 8, 128, True, None)   # mistral-nemo-12b
FLASH_DANUBE = (1, 8192, 8192, 32, 8, 80, True, 4096)  # h2o-danube-1.8b
FLASH_DANUBE3 = (1, 5120, 5120, 32, 8, 120, True, 4096)  # h2o-danube-3-4b
FLASH_GEMMA = (1, 2048, 2048, 16, 16, 256, True, None)   # gemma-7b
CAP_FLASH = [FLASH_GEMMA, FLASH_DANUBE, FLASH_MAIN]
# phase 7's prefills at their own shapes (h2o-danube-3-4b's is FLASH_DANUBE3)
GEN_FLASH = [(2, 2048, 2048, 32, 8, 128, True, None),    # mistral-nemo-12b
             (1, 1024, 1024, 16, 16, 256, True, None)]   # gemma-7b
# phase 14's prefills at their own shapes: seamless-m4t-medium's encoder
# (non-causal, MHA, d 64, 1024 frames), its cross attention (non-causal,
# 512 queries on 1024 keys) and its decoder's self attention;
# granite-moe-1b-a400m (causal, d 64, G 2); pixtral-12b (causal, d 128,
# G 4, 1024 patches + 1024 tokens)
ZOO2_FLASH = {"seamless_encoder": (2, 1024, 1024, 16, 16, 64, False, None),
              "seamless_cross": (2, 512, 1024, 16, 16, 64, False, None),
              "seamless_self": (2, 512, 512, 16, 16, 64, True, None),
              "granite": (2, 2048, 2048, 16, 8, 64, True, None),
              "pixtral": (1, 2048, 2048, 32, 8, 128, True, None)}
# (B, S, di, N): tests/test_kernels.py:58-62, the catalog's ssm-scan, ragged
SSM_SHAPES = [(1, 64, 128, 16), (2, 128, 256, 16), (2, 96, 128, 8),
              (2, 64, 128, 8), (1, 100, 70, 4)]
SSM_MAIN = (1, 4096, 16384, 16)                        # jamba-1.5-large Mamba
# the scan from a given state: the sweep, jamba's width, and jamba's width
# at an S that is not a multiple of the kernel's 16 steps a tile
SSM_STATE = SSM_SHAPES + [SSM_MAIN, (1, 4093, 16384, 16)]
SSM_TOL = 1e-4                                         # tests/test_kernels.py:73
# ssm_scan's events ms at SSM_MAIN on an H100 80GB HBM3 at 700 W before it
# took a state (PERF.md's kernel table): what phase 10 prints its state
# variants beside
STATELESS_SSM_MS = 0.38832640647888184

# (B, Skv, H, Hk, d, kv_len): tests/test_kernels.py's decode sweep, the
# catalog's decode-serve, then the other template paths of the kernel
# (d > 128 with G = 8; d = 24 with G = 3) and the SMOKE head width; then
# kv_len 1 and the capacity, one split and many, G 1, 3 and 8
EXTRA_SHAPES = [
    (2, 256, 4, 2, 128, 200),
    (1, 512, 8, 1, 128, 512),
    (3, 256, 4, 4, 128, 17),
    (4, 256, 4, 2, 64, 224),
    (2, 300, 16, 2, 256, [7, 300]),
    (2, 100, 6, 2, 24, [1, 99]),
    (4, 64, 4, 2, 16, [1, 5, 33, 64]),
    (2, 64, 3, 1, 128, [1, 64]),
    (2, 4096, 8, 1, 64, [1, 4096]),
    (1, 1000, 1, 1, 256, 999),
    (3, 2048, 24, 8, 128, [1, 1500, 2048]),
    (4, 1024, 64, 8, 128, [1, 129, 1000, 1024]),
]
# the logit cap (phases 3, 10 and 15): Gemma 2's published
# attn_logit_softcapping, and a cap far below the scores; q and k are drawn
# N(0, CAP_SPREAD**2), so that the scores s = q.k/sqrt(d) spread to about 30
SOFTCAPS = (50.0, 5.0)
CAP_SPREAD = 2.5
# the fp32 flash kernel (scalar) at cap 50 draws scores to about 17 at the
# widths where, at 30, its uncapped result misses the fp32 rule against
# the plain version in fp32 (d 80 and 128: the two fp32 score sums differ
# by that much), as a cap of 50 leaves such scores near 27; the uncapped
# kernel is held at both spreads, so each run shows that miss.  At cap 5
# the capped scores stay below 5, and the full spread is kept
CAP_SPREAD_FLASH_FP32 = 1.8
CAP_FLASH_FP32_LOWERED = (80, 128)
# (B, Skv, H, Hk, d, kv_len): decode with a cap at gemma-7b's d 256 (MHA),
# h2o-danube-1.8b's d 80 (G 4) and the table's d 128 (G 4), ragged, then
# phase 15's gemma-7b generate calls at their first and last step; flash
# with a cap at the same three widths (gemma-7b S2048, h2o-danube-1.8b's
# window at S8192, mistral-nemo-12b's S4096)
CAP_DECODE = [(8, 4096, 16, 16, 256, RAGGED), (8, 4096, 32, 8, 80, RAGGED),
              (8, 4096, 32, 8, 128, RAGGED), (1, 2079, 16, 16, 256, 2049),
              (1, 2079, 16, 16, 256, 2079)]
SERVE_KV_LEN = 128          # a serving-path cache: capacity 4096, 128 rows
# phases 5 and 6's `serve.run` requests (the run's default 200 cut to make
# room for phase 7 within the script's time)
SERVE_REQUESTS = 100


class PhaseFailed(RuntimeError):
    pass


def phase(name: str, **fields) -> None:
    print(f"[{name}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseFailed(msg)


def excess(torch, out, want, atol: float, rtol: float) -> tuple:
    """(max abs error, values past |out - want| <= atol + rtol*|want|, the
    largest error over that bound) of one comparison, without failing."""
    out, want = out.float(), want.float()
    err = (out - want).abs()
    over = err - (atol + rtol * want.abs())
    return (float(err.max()), int((over > 0).sum()), float(over.max()),
            bool(torch.isfinite(out).all()))


def compare(torch, out, want, atol: float, rtol: float) -> float:
    """Max abs error; fails unless |out - want| <= atol + rtol*|want|
    everywhere (numpy's assert_allclose rule)."""
    err, n_bad, _, finite = excess(torch, out, want, atol, rtol)
    require(finite, "non-finite output")
    require(not n_bad, f"{n_bad} values off by more than {atol} + "
            f"{rtol}*|want| (max abs err {err:.3e})")
    return err


def bound(nbytes: float, ops: dict) -> tuple[float, str]:
    """(least ms for the work, what sets it): bytes over the memory rate,
    or the slowest of the operation counts over their peak rates."""
    t_bytes = nbytes / PEAK_BYTES_S
    t_ops = max(n / rate for n, rate in ops.values())
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes"
    return t_ops * 1e3, "operations"


def time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(torch, fn, calls: int = 20, replays: int = 10) -> float:
    """Device ms per call of `fn`: `calls` calls captured in one CUDA graph
    and replayed, so that the host's cost per call drops out (for a call
    that is shorter on the card than on the host)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (replays * calls)


def phase_device(torch) -> tuple[str, str]:
    """(the card's kind, nvidia-smi's name and power limit line)."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    phase("1/16 device", kind=repr(kind), count=torch.cuda.device_count(),
          capability=torch.cuda.get_device_capability(0),
          torch=torch.__version__, cuda=torch.version.cuda)
    return kind, card


def phase_build() -> None:
    from repro_torch.kernels import _build
    t = time.perf_counter()
    paths = _build.build(*_build.sources())
    for name in paths:
        _build.load(name)
    phase("2/16 build", kernels=",".join(paths),
          seconds=f"{time.perf_counter() - t:.1f}")


def phase_kernels(torch) -> dict:
    """Each kernel against its plain version; returns each kernel's max abs
    error at its full-width, timed shape."""
    errs = {"decode_attention": check_decode(torch),
            "flash_attention": check_flash(torch),
            "ssm_scan": check_ssm(torch)}
    check_ssm_state(torch)
    check_mla(torch)
    check_capped(torch)
    return errs


def check_decode(torch) -> float:
    """Returns the max abs error at the main path's shape in bf16.

    The kernel computes in fp32 whatever its input type, so it is held
    against the plain version run in fp32 on the same inputs: within 2e-5
    (atol and rtol), and for a bf16 output also its one rounding to bf16,
    at most half an ulp (2**-8 of the value)."""
    from repro_torch.kernels import decode_attention as da
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rtol = {torch.float32: 2e-5, torch.bfloat16: 2e-5 + 2**-8}
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    main_err = 0.0
    cases = [((MAIN["B"], MAIN["Skv"], MAIN["H"], MAIN["Hk"], MAIN["d"]), kv)
             for kv in (RAGGED, 3000)]
    cases += [(s[:5], s[5]) for s in EXTRA_SHAPES + DANUBE_SHAPES
              + ZOO_DECODE + GEN_DECODE + ZOO2_DECODE + ZOO2_GEN_DECODE
              + JAMBA_DECODE]
    catalog = {}                  # the profile path's decode-serve shape
    danube = {torch.float32: 0.0, torch.bfloat16: 0.0}
    zoo = {(d, dtype): 0.0 for d in (120, 256)
           for dtype in (torch.float32, torch.bfloat16)}
    generate = {torch.float32: 0.0, torch.bfloat16: 0.0}
    zoo2 = {(name, dtype): 0.0 for name in ("cross", "granite", "generate",
                                             "jamba")
            for dtype in (torch.float32, torch.bfloat16)}
    n = 0
    for dtype in (torch.bfloat16, torch.float32):
        for i, ((B, Skv, H, Hk, d), kv_len) in enumerate(cases):
            q = torch.randn(B, 1, H, d, generator=gen, device=dev).to(dtype)
            # a cache with room for 2*Hk heads, read as its first Hk: the
            # kernel must follow the strides of a non-contiguous view
            big = torch.randn(2, B, Skv, 2 * Hk, d, generator=gen,
                              device=dev).to(dtype)
            k, v = big[0][:, :, :Hk], big[1][:, :, :Hk]
            lens = (torch.tensor(kv_len, dtype=torch.int32, device=dev)
                    if isinstance(kv_len, list) else kv_len)
            out = da.decode_attention_cuda(q, k, v, lens)
            torch.cuda.synchronize()
            want = da.decode_attention_plain(q.float(), k.float(), v.float(),
                                             lens)
            err = compare(torch, out, want, 2e-5, rtol[dtype])
            worst[dtype] = max(worst[dtype], err)
            if i < 2 and dtype == torch.bfloat16:
                main_err = max(main_err, err)
            if (B, Skv, H, Hk, d, kv_len) == (4, 256, 4, 2, 64, 224):
                catalog[str(dtype).split(".")[1]] = err
            if d == 80:
                danube[dtype] = max(danube[dtype], err)
            if (B, Skv, H, Hk, d, kv_len) in ZOO_DECODE:
                zoo[(d, dtype)] = max(zoo[(d, dtype)], err)
            if (B, Skv, H, Hk, d, kv_len) in GEN_DECODE:
                generate[dtype] = max(generate[dtype], err)
            shape = (B, Skv, H, Hk, d, kv_len)
            name = ("cross" if shape == ZOO2_DECODE[0] else
                    "granite" if shape in ZOO2_DECODE else
                    "generate" if shape in ZOO2_GEN_DECODE else
                    "jamba" if shape in JAMBA_DECODE else None)
            if name:
                zoo2[(name, dtype)] = max(zoo2[(name, dtype)], err)
            n += 1
    require(len(catalog) == 2, "the catalog's decode shape was not checked")
    phase("3/16 kernels", kernel="decode_attention", cases=n,
          max_abs_err_bf16=f"{worst[torch.bfloat16]:.3e}",
          max_abs_err_fp32=f"{worst[torch.float32]:.3e}",
          max_abs_err_catalog_B4_Skv256_d64_fp32=f"{catalog['float32']:.3e}",
          max_abs_err_catalog_B4_Skv256_d64_bf16=f"{catalog['bfloat16']:.3e}",
          max_abs_err_danube_d80_G4_bf16=f"{danube[torch.bfloat16]:.3e}",
          max_abs_err_danube_d80_G4_fp32=f"{danube[torch.float32]:.3e}",
          **{f"max_abs_err_{name}_B8_Skv4096_{dt}": f"{zoo[(d, dtype)]:.3e}"
             for name, d in (("danube3_d120_G4", 120), ("gemma_d256_G1", 256))
             for dt, dtype in (("bf16", torch.bfloat16),
                               ("fp32", torch.float32))},
          max_abs_err_generate_B1_B2_d120_d256_d128_bf16=
          f"{generate[torch.bfloat16]:.3e}",
          max_abs_err_generate_B1_B2_d120_d256_d128_fp32=
          f"{generate[torch.float32]:.3e}",
          **{f"max_abs_err_{label}_{dt}": f"{zoo2[(name, dtype)]:.3e}"
             for name, label in (
                 ("cross", "seamless_cross_B2_Skv1024_d64_G1"),
                 ("granite", "granite_B8_Skv4096_d64_G2"),
                 ("generate", "zoo_generate_pixtral_seamless_granite"),
                 ("jamba", "jamba_B8_Skv4096_H64_G8_and_generate"))
             for dt, dtype in (("bf16", torch.bfloat16),
                               ("fp32", torch.float32))},
          tol="atol:2e-5,rtol:fp32=2e-5,bf16=2e-5+2**-8",
          against="plain_in_fp32")
    return main_err


def check_flash(torch) -> float:
    """The flash kernel against the plain version run in fp32 on the same
    inputs, under decode's rule; K and V are strided views.  The plain
    version runs one KV head's query heads at a time (the heads are
    independent): over all 32 heads at S 8192 it would hold 8.6 GB of fp32
    scores several times over.  Returns the error at FLASH_MAIN in bf16."""
    from repro_torch.kernels import flash_attention as fa
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    rtol = {torch.float32: 2e-5, torch.bfloat16: 2e-5 + 2**-8}
    cases = [(s, dt) for s in FLASH_SHAPES
             for dt in (torch.float32, torch.bfloat16)]
    cases += [(FLASH_MAIN, torch.bfloat16), (FLASH_MAIN, torch.float32),
              (FLASH_DANUBE, torch.bfloat16), (FLASH_DANUBE3, torch.bfloat16),
              (FLASH_GEMMA, torch.bfloat16)]
    cases += [(s, torch.bfloat16) for s in GEN_FLASH]
    cases += [(s, torch.bfloat16) for s in ZOO2_FLASH.values()]
    cases += [(FLASH_JAMBA, torch.bfloat16)]
    errs = {}
    for shape, dtype in cases:
        B, Sq, Skv, H, Hk, d, causal, window = shape
        q = torch.randn(B, Sq, H, d, generator=gen, device=dev).to(dtype)
        big = torch.randn(2, B, Skv, 2 * Hk, d, generator=gen,
                          device=dev).to(dtype)
        k, v = big[0][:, :, :Hk], big[1][:, :, :Hk]
        out = fa.flash_attention_cuda(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        G, err = H // Hk, 0.0
        for g in range(Hk):
            hs = slice(g * G, (g + 1) * G)
            want = fa.flash_attention_plain(
                q[:, :, hs].float(), k[:, :, g:g + 1].float(),
                v[:, :, g:g + 1].float(), causal=causal, window=window)
            err = max(err, compare(torch, out[:, :, hs], want, 2e-5,
                                   rtol[dtype]))
        errs[(shape, str(dtype).split(".")[1])] = err
        del q, big, k, v, out
    torch.cuda.empty_cache()
    small = [e for (s, _), e in errs.items() if s in FLASH_SHAPES]
    phase("3/16 kernels", kernel="flash_attention", cases=len(errs),
          max_abs_err_sweep=f"{max(small):.3e}",
          max_abs_err_mistral_S4096_bf16=f"{errs[(FLASH_MAIN, 'bfloat16')]:.3e}",
          max_abs_err_mistral_S4096_fp32=f"{errs[(FLASH_MAIN, 'float32')]:.3e}",
          max_abs_err_danube_S8192_w4096_bf16=
          f"{errs[(FLASH_DANUBE, 'bfloat16')]:.3e}",
          max_abs_err_danube3_S5120_d120_w4096_bf16=
          f"{errs[(FLASH_DANUBE3, 'bfloat16')]:.3e}",
          max_abs_err_gemma_S2048_d256_bf16=
          f"{errs[(FLASH_GEMMA, 'bfloat16')]:.3e}",
          max_abs_err_generate_mistral_B2_S2048_gemma_S1024_bf16=
          f"{max(errs[(s, 'bfloat16')] for s in GEN_FLASH):.3e}",
          **{f"max_abs_err_{name}_bf16": f"{errs[(s, 'bfloat16')]:.3e}"
             for name, s in ZOO2_FLASH.items()},
          max_abs_err_jamba_S4096_H64_G8_bf16=
          f"{errs[(FLASH_JAMBA, 'bfloat16')]:.3e}",
          tol="atol:2e-5,rtol:fp32=2e-5,bf16=2e-5+2**-8",
          against="plain_in_fp32")
    return errs[(FLASH_MAIN, "bfloat16")]


def check_mla(torch) -> None:
    """Both attention kernels on MLA's route, v zero-padded to the q.k width
    and the output cut back (`layers.pad_v`), against the plain versions on
    the same route in fp32, under decode's rule; K is a strided view, as
    the decode kernel reads a cache.  Decode at MLA_DECODE in bf16 and
    fp32, prefill at MLA_FLASH in bf16 (and fp32 at the SMOKE widths)."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import layers as L
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    rtol = {torch.float32: 2e-5, torch.bfloat16: 2e-5 + 2**-8}
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        for B, Skv, H, dq, dv, kv_len in MLA_DECODE:
            q = torch.randn(B, 1, H, dq, generator=gen, device=dev).to(dtype)
            k = torch.randn(B, Skv, 2 * H, dq, generator=gen,
                            device=dev).to(dtype)[:, :, :H]
            v = torch.randn(B, Skv, H, dv, generator=gen, device=dev).to(dtype)
            lens = (torch.tensor(kv_len, dtype=torch.int32, device=dev)
                    if isinstance(kv_len, list) else kv_len)
            out = L.pad_v(da.decode_attention_cuda)(q, k, v, lens)
            torch.cuda.synchronize()
            require(tuple(out.shape) == (B, 1, H, dv), "MLA decode shape")
            want = L.pad_v(da.decode_attention_plain)(q.float(), k.float(),
                                                      v.float(), lens)
            key = ("decode", dq, dv, str(dtype).split(".")[1])
            errs[key] = max(errs.get(key, 0.0),
                            compare(torch, out, want, 2e-5, rtol[dtype]))
        for B, S, H, dq, dv in MLA_FLASH:
            if dtype == torch.float32 and dq > 24:
                continue
            q, k = (torch.randn(B, S, H, dq, generator=gen, device=dev)
                    .to(dtype) for _ in range(2))
            v = torch.randn(B, S, H, dv, generator=gen, device=dev).to(dtype)
            out = L.pad_v(fa.flash_attention_cuda)(q, k, v, causal=True)
            torch.cuda.synchronize()
            require(tuple(out.shape) == (B, S, H, dv), "MLA prefill shape")
            want = L.pad_v(fa.flash_attention_plain)(
                q.float(), k.float(), v.float(), causal=True)
            errs[("flash", dq, dv, str(dtype).split(".")[1])] = compare(
                torch, out, want, 2e-5, rtol[dtype])
            del q, k, v, out, want
    torch.cuda.empty_cache()
    phase("3/16 kernels", kernel="decode_attention+flash_attention",
          route="mla_v_zero_padded", cases=len(MLA_DECODE) * 2
          + len(MLA_FLASH) + 1,
          **{f"max_abs_err_{kind}_qk{dq}_v{dv}_{dt}": f"{e:.3e}"
             for (kind, dq, dv, dt), e in sorted(errs.items())},
          tol="atol:2e-5,rtol:fp32=2e-5,bf16=2e-5+2**-8",
          against="plain_in_fp32_same_route")


def check_capped(torch) -> None:
    """Both attention kernels with the logit cap (cap*tanh(s/cap)) against
    their plain versions with the same cap run in fp32 on the same inputs,
    under decode's rule, at caps 50 and 5, in bf16 and fp32: decode at
    CAP_DECODE, flash at CAP_FLASH (the plain version one KV head's query
    heads at a time).  q and k spread the scores to about 30 (17 for the
    fp32 flash kernel at cap 50, CAP_SPREAD_FLASH_FP32), so that the cap
    bites: each capped plain output must differ from the uncapped one by
    more than 1e-2 somewhere.  The uncapped kernel's error on the same
    inputs is printed beside (cap0: what the scores' spread alone costs;
    for fp32 flash at both spreads, `_s17` the lower)."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(8)
    rtol = {torch.float32: 2e-5, torch.bfloat16: 2e-5 + 2**-8}
    errs, bite, spread = {}, {}, 0.0

    def note(key, out, want, dtype):
        e = excess(torch, out, want, 2e-5, rtol[dtype])
        old = errs.get(key, (0.0, 0, -math.inf, True))
        errs[key] = (max(old[0], e[0]), old[1] + e[1], max(old[2], e[2]),
                     old[3] and e[3])

    for dtype in (torch.bfloat16, torch.float32):
        dt = str(dtype).split(".")[1]
        for B, Skv, H, Hk, d, kv_len in CAP_DECODE:
            q = (torch.randn(B, 1, H, d, generator=gen, device=dev)
                 * CAP_SPREAD).to(dtype)
            k = (torch.randn(B, Skv, Hk, d, generator=gen, device=dev)
                 * CAP_SPREAD).to(dtype)
            v = torch.randn(B, Skv, Hk, d, generator=gen, device=dev).to(dtype)
            lens = (torch.tensor(kv_len, dtype=torch.int32, device=dev)
                    if isinstance(kv_len, list) else kv_len)
            qf, kf, vf = q.float(), k.float(), v.float()
            free = da.decode_attention_plain(qf, kf, vf, lens)
            note(("decode", d, 0, dt), da.decode_attention_cuda(q, k, v, lens),
                 free, dtype)
            s = torch.einsum("bqhd,bkhd->bhqk", qf.reshape(B, 1, Hk, -1)[
                ..., :d], kf) / math.sqrt(d)
            spread = max(spread, float(s.abs().max()))
            for cap in SOFTCAPS:
                out = da.decode_attention_cuda(q, k, v, lens, cap)
                torch.cuda.synchronize()
                want = da.decode_attention_plain(qf, kf, vf, lens, cap)
                key = ("decode", d, cap, dt)
                note(key, out, want, dtype)
                bite[key] = max(bite.get(key, 0.0),
                                float((want - free).abs().max()))
            del q, k, v, qf, kf, vf, free, s
        for B, Sq, Skv, H, Hk, d, causal, window in CAP_FLASH:
            lowered = (dtype == torch.float32
                       and d in CAP_FLASH_FP32_LOWERED)
            spreads = ([(CAP_SPREAD, (0, SOFTCAPS[1])),
                        (CAP_SPREAD_FLASH_FP32, (0, SOFTCAPS[0]))]
                       if lowered else [(CAP_SPREAD, (0,) + SOFTCAPS)])
            for sp, caps in spreads:
                q = (torch.randn(B, Sq, H, d, generator=gen, device=dev)
                     * sp).to(dtype)
                k = (torch.randn(B, Skv, Hk, d, generator=gen, device=dev)
                     * sp).to(dtype)
                v = torch.randn(B, Skv, Hk, d, generator=gen,
                                device=dev).to(dtype)
                G = H // Hk
                for cap in caps:
                    out = fa.flash_attention_cuda(q, k, v, causal=causal,
                                                  window=window,
                                                  softcap=cap or None)
                    torch.cuda.synchronize()
                    key = ("flash", d, cap, dt if sp == CAP_SPREAD
                           else f"{dt}_s17")
                    for g in range(Hk):
                        hs = slice(g * G, (g + 1) * G)
                        args = (q[:, :, hs].float(),
                                k[:, :, g:g + 1].float(),
                                v[:, :, g:g + 1].float())
                        want = fa.flash_attention_plain(
                            *args, causal=causal, window=window,
                            softcap=cap or None)
                        note(key, out[:, :, hs], want, dtype)
                        if g == 0 and cap:
                            free = fa.flash_attention_plain(
                                *args, causal=causal, window=window)
                            bite[key] = float((want - free).abs().max())
                            del free
                        del want, args
                    del out
                del q, k, v
                torch.cuda.empty_cache()
    phase("3/16 kernels", kernel="decode_attention+flash_attention",
          softcap=",".join(str(c) for c in SOFTCAPS), cases=len(errs),
          max_abs_score=f"{spread:.1f}",
          **{f"max_abs_err_{kind}_d{d}_cap{cap:g}_{dt}":
             f"{e[0]:.3e}" + (f"({'FAIL' if cap else 'uncapped'}:{e[1]}"
                              f"_over_by_{e[2]:.1e})"
                              if e[1] or not e[3] else "")
             for (kind, d, cap, dt), e in sorted(errs.items())},
          min_bite_capped_vs_uncapped=f"{min(bite.values()):.3e}",
          tol="atol:2e-5,rtol:fp32=2e-5,bf16=2e-5+2**-8",
          against="plain_in_fp32_same_cap", cap0="the_uncapped_kernel")
    bad = sorted(k for k, e in errs.items() if k[2] and (e[1] or not e[3]))
    require(not bad, f"capped kernels off their plain versions: {bad}")
    small = {k: b for k, b in bite.items() if b <= 1e-2}
    require(not small, f"the cap did not bite: {small}")


def ssm_args(torch, gen, B: int, S: int, di: int, N: int,
             a_log: str = "shared") -> tuple:
    """The catalog's input recipe: dt = softplus(normal), x, B, C normal,
    A = -(1..N) for every channel.  With a_log="per_channel", A_log =
    log(uniform(0.5, 16)) for each (channel, state), as a trained Mamba
    layer's A differs per channel."""
    import torch.nn.functional as F
    dev = gen.device
    dt = F.softplus(torch.randn(B, S, di, generator=gen, device=dev))
    x = torch.randn(B, S, di, generator=gen, device=dev)
    Bc = torch.randn(B, S, N, generator=gen, device=dev)
    Cc = torch.randn(B, S, N, generator=gen, device=dev)
    if a_log == "per_channel":
        A_log = torch.empty(di, N, device=dev).uniform_(
            0.5, 16.0, generator=gen).log_()
    else:
        A_log = torch.log(torch.arange(1, N + 1, dtype=torch.float32,
                                       device=dev).expand(di, N).contiguous())
    return dt, x, Bc, Cc, A_log


def check_ssm(torch) -> float:
    """The scan kernel against the plain version (both fp32) within the
    reference's 1e-4 (atol and rtol), with the catalog's A shared by every
    channel and with an A_log drawn per channel; at each shape with every
    L (lanes a channel) the kernel takes, `lane_plan`'s among them.
    Returns the error at SSM_MAIN with the shared A (the worst over L)."""
    from repro_torch.kernels import ssm_scan as ss
    gen = torch.Generator(device="cuda").manual_seed(3)
    errs, runs = {}, 0
    for a_log in ("shared", "per_channel"):
        for shape in SSM_SHAPES + [SSM_MAIN]:
            args = ssm_args(torch, gen, *shape, a_log=a_log)
            want = ss.ssm_scan_plain(*args)
            err = 0.0
            for lanes in sorted(L for L in ss.LANES if L <= shape[3]):
                out = ss.ssm_scan_cuda(*args, lanes=lanes)
                torch.cuda.synchronize()
                err = max(err, compare(torch, out, want, SSM_TOL, SSM_TOL))
                runs += 1
                del out
            errs[(shape, a_log)] = err
            del args, want
    torch.cuda.empty_cache()
    sweep = {a: max(e for (s, k), e in errs.items()
                    if k == a and s != SSM_MAIN)
             for a in ("shared", "per_channel")}
    phase("3/16 kernels", kernel="ssm_scan", cases=len(errs), runs=runs,
          lanes="1,2,4",
          max_abs_err_sweep=f"{sweep['shared']:.3e}",
          max_abs_err_sweep_per_channel_A=f"{sweep['per_channel']:.3e}",
          max_abs_err_jamba_S4096_di16384_N16=
          f"{errs[(SSM_MAIN, 'shared')]:.3e}",
          max_abs_err_jamba_per_channel_A=
          f"{errs[(SSM_MAIN, 'per_channel')]:.3e}",
          tol="atol:1e-4,rtol:1e-4", against="plain_fp32")
    return errs[(SSM_MAIN, "shared")]


def check_ssm_state(torch) -> None:
    """The scan from a random h0 with its final state returned, against the
    plain version (both fp32) within 1e-4, y and h_last, at every L the
    kernel takes and each SSM_STATE shape; then the split: at jamba's width
    a scan over S against two over S / 2, the second from the first's
    h_last, within 1e-4 of the whole scan's y and h_last."""
    from repro_torch.kernels import ssm_scan as ss
    gen = torch.Generator(device="cuda").manual_seed(7)
    errs, runs = {}, 0
    for shape in SSM_STATE:
        args = ssm_args(torch, gen, *shape, a_log="per_channel")
        B, _, di, N = shape
        h0 = torch.randn(B, di, N, generator=gen, device="cuda")
        want_y, want_h = ss.ssm_scan_plain(*args, h0=h0, return_state=True)
        err = 0.0
        for lanes in sorted(L for L in ss.LANES if L <= N):
            y, h = ss.ssm_scan_cuda(*args, h0=h0, return_state=True,
                                    lanes=lanes)
            torch.cuda.synchronize()
            err = max(err, compare(torch, y, want_y, SSM_TOL, SSM_TOL),
                      compare(torch, h, want_h, SSM_TOL, SSM_TOL))
            runs += 1
            del y, h
        errs[shape] = err
        if shape == SSM_MAIN:
            m = shape[1] // 2
            first = [a[:, :m] for a in args[:4]]
            second = [a[:, m:] for a in args[:4]]
            y1, h1 = ss.ssm_scan_cuda(*first, args[4], h0=h0,
                                      return_state=True)
            y2, h2 = ss.ssm_scan_cuda(*second, args[4], h0=h1,
                                      return_state=True)
            torch.cuda.synchronize()
            split = max(compare(torch, torch.cat([y1, y2], dim=1), want_y,
                                SSM_TOL, SSM_TOL),
                        compare(torch, h2, want_h, SSM_TOL, SSM_TOL))
            del y1, h1, y2, h2
        del args, want_y, want_h
    torch.cuda.empty_cache()
    sweep = max(e for shape, e in errs.items() if shape in SSM_SHAPES)
    phase("3/16 kernels", kernel="ssm_scan", state="h0_and_h_last",
          cases=len(errs), runs=runs, lanes="1,2,4",
          max_abs_err_sweep=f"{sweep:.3e}",
          max_abs_err_jamba_S4096=f"{errs[SSM_MAIN]:.3e}",
          max_abs_err_jamba_S4093=f"{errs[SSM_STATE[-1]]:.3e}",
          max_abs_err_split_S4096_in_2x2048=f"{split:.3e}",
          tol="atol:1e-4,rtol:1e-4", against="plain_fp32_same_h0")


def phase_parity(torch) -> None:
    import numpy as np
    mistral = parity(torch, "mistral-nemo-12b", [np.array([0, 3, 10, 40])],
                     steps=6, prompt=(2, 9), new=(2, 6))
    phase("4/16 parity", config="mistral-nemo-12b/SMOKE/fp32",
          logits_max_abs_err=f"{mistral:.3e}", tol="1e-4",
          engine_tokens="equal")
    # one position for every row, then ragged per-row positions: 40 steps
    # each run every ring slot past the window of 16; the engine's requests
    # (prompt + new tokens 18-32) run past it too
    danube = parity(torch, "h2o-danube-1.8b",
                    [np.zeros(4, np.int64), np.array([0, 5, 11, 30])],
                    steps=40, prompt=(10, 21), new=(8, 14))
    phase("4/16 parity", config="h2o-danube-1.8b/SMOKE/fp32", window=16,
          cache_rows=16, steps="40_scalar_pos+40_ragged_pos",
          logits_max_abs_err=f"{danube:.3e}", tol="1e-4",
          engine_tokens="equal")
    # the mLSTM state in place of a KV cache (positions are ignored); the
    # engine's six requests through three slots reuse slots (F5)
    xlstm = parity(torch, "xlstm-350m", [np.zeros(4, np.int64)], steps=20,
                   prompt=(2, 9), new=(2, 6))
    phase("4/16 parity", config="xlstm-350m/SMOKE/fp32", steps=20,
          logits_max_abs_err=f"{xlstm:.3e}", tol="1e-4",
          engine_tokens="equal_under_slot_reuse")
    for arch in GENERATE_PARITY:
        err = generate_parity(torch, arch)
        phase("4/16 parity.generate", config=f"{arch}/SMOKE/fp32",
              batch=2, prompt=21, steps=12,
              prefill_logits_max_abs_err=f"{err:.3e}", tol="1e-4",
              greedy_tokens="equal")


# every ported architecture; a 21-token prompt is past the SMOKE window of
# 16 of both h2o-danube models
GENERATE_PARITY = ["mistral-nemo-12b", "h2o-danube-1.8b", "h2o-danube-3-4b",
                   "gemma-7b", "xlstm-350m"]


def generate_parity(torch, arch: str) -> float:
    """`arch` SMOKE in fp32, one set of weights on the card and on the CPU:
    the prefill's last-token logits (limit 1e-4) and `greedy_generate`'s
    tokens over 12 steps, which must be equal.  Returns the logits' max abs
    error."""
    import copy

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import greedy_generate, init_params, make_prefill
    cfg = get_config(arch, smoke=True, dtype=torch.float32)
    cpu = init_params(torch.Generator().manual_seed(0), cfg)
    gpu = copy.deepcopy(cpu).to("cuda")
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 21)))
    want, _ = make_prefill(cfg)(cpu, {"tokens": toks})
    got, _ = make_prefill(cfg)(gpu, {"tokens": toks.cuda()})
    err = compare(torch, got.cpu(), want, 1e-4, 1e-4)
    card = greedy_generate(cfg, gpu, {"tokens": toks.cuda()}, 12).cpu()
    host = greedy_generate(cfg, cpu, {"tokens": toks}, 12)
    require(torch.equal(card, host),
            f"{arch}: greedy tokens differ: card {card.tolist()} vs CPU "
            f"{host.tolist()}")
    return err


def parity(torch, arch: str, starts: list, steps: int, prompt: tuple,
           new: tuple) -> float:
    """`arch` SMOKE in fp32, one set of weights on the card and on the CPU:
    decode logits over `steps` steps from each row-position vector in
    `starts` (fresh caches of capacity 64 each time; an all-equal vector is
    passed as one int), then the serving engine's greedy tokens, which must
    be equal.  Returns the logits' max abs error (limit 1e-4)."""
    import copy

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import init_cache, init_params, make_decode_step
    from repro_torch.serving.engine import (EngineConfig, ServeRequest,
                                            ServingEngine)
    cfg = get_config(arch, smoke=True, dtype=torch.float32)
    cpu = init_params(torch.Generator().manual_seed(0), cfg)
    gpu = copy.deepcopy(cpu).to("cuda")
    decode = make_decode_step(cfg)
    B, cap = 4, 64
    rng = np.random.default_rng(0)
    worst = 0.0
    for start in starts:
        caches = {"cpu": init_cache(cfg, B, cap, device="cpu"),
                  "cuda": init_cache(cfg, B, cap, device="cuda")}
        for step in range(steps):
            toks = rng.integers(0, cfg.vocab_size, (B, 1))
            pos = (int(start[0]) + step if (start == start[0]).all()
                   else torch.from_numpy(start + step))
            want, _ = decode(cpu, caches["cpu"], torch.from_numpy(toks), pos)
            got, _ = decode(gpu, caches["cuda"],
                            torch.from_numpy(toks).cuda(), pos)
            worst = max(worst, compare(torch, got.cpu(), want, 1e-4, 1e-4))

    def serve(params):
        r = np.random.default_rng(1)
        reqs = [ServeRequest(i, r.integers(0, cfg.vocab_size,
                                           int(r.integers(*prompt))),
                             max_new_tokens=int(r.integers(*new)))
                for i in range(6)]
        eng = ServingEngine(cfg, params, EngineConfig(num_slots=3,
                                                      kv_capacity=64))
        for req in reqs:
            eng.submit(req)
        eng.drain()
        return [req.output for req in reqs]

    require(serve(gpu) == serve(cpu), f"{arch}: engine tokens differ: card "
            "vs CPU")
    return worst


def phase_serve(torch) -> dict:
    """The main path.  Returns the kernels' launch counts of this run."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as da
    from repro_torch.launch.serve import run
    from repro_torch.models import init_params, make_decode_step
    from repro_torch.serving.engine import (EngineConfig, ServeRequest,
                                            ServingEngine)
    cfg = get_config("mistral-nemo-12b", smoke=False)
    require(cfg.num_layers == 40 and cfg.d_model == 5120, "not FULL")

    da.launches = 0
    t = time.perf_counter()
    res = run("mistral-nemo-12b", smoke=False, batch=8, kv_cap=4096,
              requests=SERVE_REQUESTS, device="cuda")
    wall = time.perf_counter() - t
    run_launches = da.launches
    require(run_launches == cfg.num_layers * res["decode_steps"],
            f"run: {run_launches} launches for {res['decode_steps']} steps")
    phase("5/16 serve.run", base_ms=res["base_ms"], p50_ms=res["p50_ms"],
          p99_ms=res["p99_ms"], served=res["served"],
          decode_steps=res["decode_steps"], launches=run_launches,
          wall_s=f"{wall:.1f}")
    gc.collect()
    torch.cuda.empty_cache()

    params = init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    eng = ServingEngine(cfg, params, EngineConfig(num_slots=8,
                                                  kv_capacity=4096))
    rng = np.random.default_rng(0)
    reqs = [ServeRequest(i, rng.integers(0, cfg.vocab_size,
                                         int(rng.integers(8, 65))),
                         max_new_tokens=16) for i in range(8)]
    for req in reqs:
        eng.submit(req)
    da.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    eng.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    eng_launches = da.launches
    require(eng_launches == cfg.num_layers * eng.steps,
            f"engine: {eng_launches} launches for {eng.steps} steps")
    new = sum(len(r.output) for r in reqs)
    require(new == 16 * len(reqs) and all(
        0 <= tok < cfg.vocab_size for r in reqs for tok in r.output),
        "engine output has the wrong length or ids out of the vocabulary")
    # the logits of one more step at full width: right shape, finite
    logits, _ = make_decode_step(cfg)(
        params, eng.cache, torch.zeros((8, 1), dtype=torch.long,
                                       device="cuda"), 100)
    require(tuple(logits.shape) == (8, cfg.padded_vocab)
            and bool(torch.isfinite(logits).all()), "bad full-width logits")
    phase("5/16 serve.engine", requests=len(reqs), decode_steps=eng.steps,
          new_tokens=new, tokens_per_s=f"{new / wall:.1f}",
          wall_s=f"{wall:.2f}", launches=eng_launches,
          peak_mem_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.1f}")
    del params, eng
    gc.collect()
    torch.cuda.empty_cache()
    return {"decode_attention": run_launches + eng_launches}


def phase_share(torch) -> int:
    """MuxFlow's on-device unit at h2o-danube-1.8b FULL: the decode step
    alone, then with AdamW train steps of a second copy packed in by the
    multiplexer.  Returns the decode kernel's launches of both runs."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as da
    from repro_torch.launch.serve import run
    cfg = get_config("h2o-danube-1.8b", smoke=False)
    require(cfg.num_layers == 24 and cfg.d_model == 2560
            and cfg.window == 4096, "not h2o-danube-1.8b FULL")
    requests, total = SERVE_REQUESTS, 0
    for share in (False, True):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        da.launches = 0
        t = time.perf_counter()
        res = run("h2o-danube-1.8b", smoke=False, batch=8, kv_cap=4096,
                  requests=requests, share=share, device="cuda")
        wall = time.perf_counter() - t
        n = da.launches
        require(n == cfg.num_layers * res["decode_steps"],
                f"share={share}: {n} launches for {res['decode_steps']} "
                "decode steps")
        require(res["served"] >= 1, f"share={share}: nothing served")
        if share:
            require(res["offline_steps"] >= 1, "no offline step ran")
            require(res["train_steps_done"] == res["offline_steps"] + 2,
                    f"train steps {res['train_steps_done']} for "
                    f"{res['offline_steps']} offline steps")
        total += n
        # the offline step `run` timed: oversold = offline_steps /
        # (horizon / off_step), the horizon the last arrival + 1 s
        rng = np.random.default_rng(0)
        horizon = float(np.cumsum(rng.exponential(1 / 40.0, requests))[-1]) + 1
        off_ms = (res["oversold"] * horizon / res["offline_steps"] * 1e3
                  if share else None)
        # the SLO guard's eviction ends the run early: fewer served
        phase("6/16 share", config="h2o-danube-1.8b/FULL/bf16", share=share,
              batch=8, kv_cap=4096, requests=requests,
              base_ms=res["base_ms"], p50_ms=res["p50_ms"],
              p99_ms=res["p99_ms"], served=res["served"],
              evicted=res["served"] < requests,
              offline_steps=res["offline_steps"], offline_step_ms=off_ms,
              offline_duty=res["offline_duty"], oversold=res["oversold"],
              train_steps_done=res["train_steps_done"],
              decode_steps=res["decode_steps"], launches=n,
              peak_mem_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}",
              wall_s=f"{wall:.1f}")
    gc.collect()
    torch.cuda.empty_cache()
    return total


# (arch, batch, prompt tokens, decode steps, layers): each run gives
# steps + 1 new tokens, the first from the prefill's logits; layers None is
# the config's depth.  mistral-nemo-12b runs 10 of its 40 layers at full
# width since phase 14 came in (the script near 240 s): pixtral-12b's run
# there covers that backbone's width at full depth
GENERATE = [("mistral-nemo-12b", 2, 2048, 31, 10),
            ("h2o-danube-3-4b", 1, 5120, 31, None),
            ("gemma-7b", 1, 1024, 15, None), ("xlstm-350m", 2, 512, 31, None)]


def phase_generate(torch) -> dict:
    """This slice's main path: prefill and greedy generation at full width,
    then `repro`'s default serve workload (xlstm-350m FULL), alone and
    shared.  Returns the kernels' launch counts of these runs."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssm_scan as ss
    from repro_torch.launch.serve import run
    from repro_torch.models import greedy_generate, init_params, make_prefill
    total = {"decode_attention": 0, "flash_attention": 0}
    for arch, B, S0, steps, layers in GENERATE:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cfg = get_config(arch, smoke=False,
                         **({"num_layers": layers} if layers else {}))
        dense = cfg.pattern == (("attn", "dense"),)
        params = init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
        batch = {"tokens": torch.randint(
            0, cfg.vocab_size, (B, S0), device="cuda",
            generator=torch.Generator(device="cuda").manual_seed(1))}
        # the prefill alone, a warm-up and then timed; its launches are
        # not the main path's (the counts are set to 0 below)
        prefill = make_prefill(cfg)
        prefill(params, batch)
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits, cache = prefill(params, batch)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t) * 1e3
        require(tuple(logits.shape) == (B, cfg.padded_vocab)
                and bool(torch.isfinite(logits).all()),
                f"{arch}: bad prefill logits")
        rows = {k: tuple(v.shape) for k, v in cache[0].items()}
        del logits, cache
        da.launches = fa.launches = ss.launches = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = greedy_generate(cfg, params, batch, steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        n = {"flash_attention": fa.launches, "decode_attention": da.launches}
        want = ({"flash_attention": cfg.num_layers,
                 "decode_attention": cfg.num_layers * steps} if dense else
                {"flash_attention": 0, "decode_attention": 0})
        require(n == want and ss.launches == 0,
                f"{arch}: launches {n}, ssm_scan {ss.launches}; want {want}")
        require(tuple(out.shape) == (B, steps + 1) and bool(
            ((out >= 0) & (out < cfg.vocab_size)).all()),
            f"{arch}: generated ids of the wrong shape or outside the "
            "vocabulary")
        for k in total:
            total[k] += n[k]
        phase("7/16 generate", config=f"{arch}/FULL/bf16",
              layers=cfg.num_layers, batch=B, prompt=S0, decode_steps=steps, new_tokens=B * (steps + 1),
              prefill_ms=f"{prefill_ms:.2f}",
              decode_ms_per_step=f"{(wall * 1e3 - prefill_ms) / steps:.2f}",
              tokens_per_s=f"{B * (steps + 1) / wall:.1f}",
              wall_s=f"{wall:.2f}", launches=n, prefill_cache=rows,
              peak_mem_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}")
        del params, batch, out
    gc.collect()
    torch.cuda.empty_cache()

    cfg = get_config("xlstm-350m", smoke=False)
    for share in (False, True):
        torch.cuda.reset_peak_memory_stats()
        da.launches = fa.launches = ss.launches = 0
        t = time.perf_counter()
        res = run("xlstm-350m", smoke=False, share=share)
        wall = time.perf_counter() - t
        require(da.launches == fa.launches == ss.launches == 0,
                "a kernel launched on the mLSTM serve path")
        require(res["served"] >= 1 and res["decode_steps"] >= 6,
                f"share={share}: nothing served")
        if share:
            require(res["offline_steps"] >= 1, "no offline step ran")
            require(res["train_steps_done"] == res["offline_steps"] + 2,
                    f"train steps {res['train_steps_done']} for "
                    f"{res['offline_steps']} offline steps")
        phase("7/16 generate.serve", config="xlstm-350m/FULL/bf16",
              share=share, batch=4, requests=200, base_ms=res["base_ms"],
              p50_ms=res["p50_ms"], p99_ms=res["p99_ms"],
              served=res["served"], evicted=res["served"] < 200,
              offline_steps=res["offline_steps"],
              offline_duty=res["offline_duty"], oversold=res["oversold"],
              train_steps_done=res["train_steps_done"],
              decode_steps=res["decode_steps"], launches=0,
              params=cfg.param_count(),
              peak_mem_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}",
              wall_s=f"{wall:.1f}")
        gc.collect()
        torch.cuda.empty_cache()
    return total


# card vs CPU checksum limits: the kernel workloads sum fp32 outputs (each
# within 2e-5 or 1e-4 of the plain version), the train step sums bf16 losses
CHECKSUM_TOL = {"flash-prefill": (1e-3, 1e-4), "decode-serve": (1e-3, 1e-4),
                "ssm-scan": (1e-3, 1e-4), "lm-train-step": (0.0, 2e-2)}


def phase_profile(torch) -> tuple[dict, object, object]:
    """MuxFlow's measurement loop on the card.  Returns the kernels' launch
    counts of this path, the card's speed matrix and the measured predictor
    trained on the card."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssm_scan as ss
    from repro_torch.profiling import calibrate
    from repro_torch.profiling.harness import build_speed_matrix
    from repro_torch.profiling.matrix import check_schema
    t = time.perf_counter()
    cpu = build_speed_matrix("smoke", seed=0, device="cpu")
    cpu_s = time.perf_counter() - t

    da.launches = fa.launches = ss.launches = 0
    t = time.perf_counter()
    card = build_speed_matrix("smoke", seed=0)     # the card by default
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = {"decode_attention": da.launches, "flash_attention": fa.launches,
              "ssm_scan": ss.launches}
    require(all(n > 0 for n in counts.values()),
            f"a kernel never launched on the profile path: {counts}")
    problems = check_schema(card.data)
    require(not problems, f"card matrix schema: {problems}")
    got, want = json.loads(card.to_json()), json.loads(cpu.to_json())
    for name, rec in card.records.items():
        g = got["workloads"][name].pop("checksum")
        w = want["workloads"][name].pop("checksum")
        atol, rtol = CHECKSUM_TOL[name]
        require(abs(g - w) <= atol + rtol * abs(w),
                f"{name}: checksum {g} on the card, {w} on the CPU")
        phase("8/16 profile.exec", workload=name, device="cuda",
              steps=rec.steps_executed,
              wall_ms_per_step=rec.wall_ms_per_step, checksum_card=g,
              checksum_cpu=w, tol=f"atol:{atol},rtol:{rtol}")
    require(got == want, "the card's matrix differs from the CPU-built one "
            "in a field other than the checksums")
    phase("8/16 profile", suite="smoke", seed=0, pairs=len(card.pairs),
          cells=sum(len(p["shares"]) for p in card.pairs), schema="clean",
          matrix="equal_to_cpu_but_checksums", launches=counts,
          wall_s=f"{wall:.2f}", cpu_matrix_s=f"{cpu_s:.2f}")

    t = time.perf_counter()
    pred = calibrate.build_measured_predictor(card)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    hist = pred.histories
    maes = {gpu: h["val_mae"][-1] for gpu, h in hist.items()}
    require(all(math.isfinite(m) and 0.0 <= m < 1.0 for m in maes.values()),
            f"bad validation MAE {maes}")
    require(all(p[0]["w"].device.type == "cuda"
                for p in pred.params_by_type.values()), "predictor not on card")
    phase("8/16 profile.predictor", device="cuda",
          epochs=len(hist["T4"]["val_mae"]),
          **{f"final_val_mae_{gpu}": m for gpu, m in maes.items()},
          seconds=f"{secs:.2f}")
    return counts, card, pred


def phase_train(torch) -> None:
    """xlstm-350m FULL, bf16, through the port's train step (autograd,
    momentum SGD; no kernel of this repository)."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.models import init_params, make_train_step
    from repro_torch.optim import MomentumSGD, MomentumSGDConfig
    cfg = get_config("xlstm-350m", smoke=False)
    require(cfg.num_layers == 24 and cfg.d_model == 1024
            and cfg.dtype == torch.bfloat16, "not xlstm-350m FULL in bf16")
    torch.cuda.reset_peak_memory_stats()
    params = init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    opt = MomentumSGD(MomentumSGDConfig(lr=1e-3, momentum=0.9))
    state = opt.init(list(params.parameters()))
    step = make_train_step(cfg, opt)
    pipe = TokenPipeline(DataConfig(cfg.vocab_size, 512, 2, seed=0))
    losses, ms = [], []
    for i in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        params, state, metrics = step(params, state, pipe.batch_at(i))
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
    require(all(math.isfinite(v) for v in losses), f"losses {losses}")
    phase("9/16 train", config="xlstm-350m/FULL/bf16", batch=2, seq=512,
          params=cfg.param_count(), losses=losses, step_ms=ms,
          peak_mem_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}")
    del params, state
    gc.collect()
    torch.cuda.empty_cache()
    train_danube(torch)
    offline_step_breakdown(torch)
    checkpoint_roundtrip(torch)


def train_danube(torch) -> None:
    """Five AdamW steps of h2o-danube-1.8b FULL in bf16 through the train
    launcher (no checkpoints); it prints each step's loss and its running
    ms a step."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    cfg = get_config("h2o-danube-1.8b", smoke=False)
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    out = train.run("h2o-danube-1.8b", smoke=False, steps=5, batch=8, seq=64,
                    log_every=1, device="cuda")
    wall = time.perf_counter() - t
    losses = out["losses"]
    require(out["steps_done"] == 5 and not out["interrupted"]
            and all(math.isfinite(v) for v in losses), f"train.run {out}")
    phase("9/16 train", config="h2o-danube-1.8b/FULL/bf16", optimizer="AdamW",
          batch=8, seq=64, params=cfg.param_count(), losses=losses,
          wall_s=f"{wall:.2f}",
          peak_mem_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}")
    gc.collect()
    torch.cuda.empty_cache()


def offline_step_breakdown(torch) -> None:
    """`serve --share`'s offline step (h2o-danube-1.8b FULL, bf16, batch
    4 x 32 tokens) in its two parts: the AdamW update, timed from a
    synchronise to a synchronise around the optimizer's call, and the rest
    of the step (the gradient: forward and backward under autograd); three
    steps after a warm-up.  The update's bound counts what AdamW must move:
    each parameter and gradient read and the parameter written (bf16), m and
    v read and written (fp32), 22 bytes a parameter."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.models import init_params, make_train_step
    from repro_torch.optim import AdamW, AdamWConfig
    cfg = get_config("h2o-danube-1.8b", smoke=False)
    params = init_params(torch.Generator(device="cuda").manual_seed(1), cfg)
    opt = AdamW(AdamWConfig(lr=1e-3, total_steps=10_000))
    update_s = []

    class TimedAdamW:
        def update(self, *args):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = opt.update(*args)
            torch.cuda.synchronize()
            update_s.append(time.perf_counter() - t)
            return out

    state = opt.init(params.parameters())
    step = make_train_step(cfg, TimedAdamW())
    pipe = TokenPipeline(DataConfig(cfg.vocab_size, 32, 4))
    step_s = []
    for i in range(4):
        torch.cuda.synchronize()
        t = time.perf_counter()
        params, state, _ = step(params, state, pipe.batch_at(i))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
    n = cfg.param_count()
    phase("9/16 train.offline_step", config="h2o-danube-1.8b/FULL/bf16",
          batch=4, seq=32, step_ms=[t * 1e3 for t in step_s[1:]],
          grad_ms=[(t - u) * 1e3 for t, u in zip(step_s[1:], update_s[1:])],
          adamw_ms=[u * 1e3 for u in update_s[1:]],
          adamw_tensors=len(state["m"]),
          adamw_bound_ms=22 * n / PEAK_BYTES_S * 1e3, adamw_bound_by="bytes")
    del params, state
    gc.collect()
    torch.cuda.empty_cache()


def checkpoint_roundtrip(torch) -> None:
    """h2o-danube-1.8b SMOKE in bf16 after two AdamW steps on the card
    (master weights kept, so every kind of state is there): weights and
    optimizer state saved, restored to the card, and compared bit for bit."""
    import tempfile

    from repro_torch.checkpoint import latest_step, restore, save
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.models import init_params, make_train_step
    from repro_torch.optim import AdamW, AdamWConfig
    cfg = get_config("h2o-danube-1.8b", smoke=True)
    params = init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    opt = AdamW(AdamWConfig(lr=1e-3, master_weights=True))
    state = opt.init(params.parameters())
    step = make_train_step(cfg, opt)
    pipe = TokenPipeline(DataConfig(cfg.vocab_size, 32, 4))
    for i in range(2):
        params, state, _ = step(params, state, pipe.batch_at(i))
    tree = (list(params.parameters()), state)
    with tempfile.TemporaryDirectory() as d:
        save(d, 2, tree)
        require(latest_step(d) == 2, "checkpoint not published")
        back, at = restore(d, tree, device="cuda")

    def leaves(t):
        weights, st = t
        return [*weights, *st["m"], *st["v"], *st["master"], st["step"]]

    pairs = list(zip(leaves(tree), leaves(back)))
    require(at == 2 and len(pairs) == 4 * len(tree[0]) + 1 and all(
        y.device.type == "cuda" and x.dtype == y.dtype and torch.equal(x, y)
        for x, y in pairs), "restored checkpoint differs")
    phase("9/16 train.checkpoint", config="h2o-danube-1.8b/SMOKE/bf16",
          leaves=len(pairs), step=at, restored_to="cuda", equal="bitwise")


def phase_timing(torch, launches: dict, max_err: dict) -> list:
    kernels = [time_decode(torch, launches, max_err["decode_attention"]),
               time_flash(torch, launches, max_err["flash_attention"]),
               time_ssm(torch, launches, max_err["ssm_scan"])]
    time_mla(torch)
    time_capped(torch)
    return kernels


def sdpa_backend(torch, fn) -> str:
    """The CUDA kernels one call of `fn` (an SDPA call) ran, by name under
    torch.profiler: which of SDPA's backends it took."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    names = sorted({e.key for e in prof.key_averages()
                    if getattr(e, "device_time_total", 0) > 0})
    return "|".join(n[:60] for n in names)


def time_mla(torch) -> None:
    """Both kernels at deepseek-v2-lite-16b's MLA shapes (MLA_DECODE[1],
    MLA_FLASH[0]), in CUDA graphs, on v already zero-padded to 192 (the
    kernel's call; the pad is the model's, timed by launch/profile.py).
    The bound is that of the model's own work, q.k at 192 and v at 128, so
    the padding's waste shows; the padded read's bytes bound is printed
    beside.  SDPA runs at the model's widths (v 128, no padding), and the
    kernels it ran are named."""
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(6)
    saved = da.launches, fa.launches
    B, Skv, H, dq, dv, _ = MLA_DECODE[1]
    q = torch.randn(B, 1, H, dq, generator=gen, device=dev).to(bf16)
    k = torch.randn(B, Skv, H, dq, generator=gen, device=dev).to(bf16)
    v = torch.randn(B, Skv, H, dv, generator=gen, device=dev).to(bf16)
    vp = F.pad(v, (0, dq - dv))
    lens = torch.full((B,), Skv, dtype=torch.int32, device=dev)
    mask = torch.ones(B, 1, 1, Skv, dtype=torch.bool, device=dev)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, attn_mask=mask)
    nbytes = (B * Skv * H * (dq + dv) + B * H * (dq + dv)) * 2 + 4 * B
    bound_ms, by = bound(nbytes, {"bf16": (2 * B * H * Skv * (dq + dv),
                                           PEAK_FLOPS["bfloat16"])})
    padded_ms = (2 * B * Skv * H * dq * 2) / PEAK_BYTES_S * 1e3
    phase("10/16 timing", kernel="decode_attention", model="deepseek_mla",
          shape=f"B{B}_Skv{Skv}_H{H}_Hk{H}_qk{dq}_v{dv}_padded_to_{dq}_bf16_"
          f"kvlen{Skv}",
          graph_ms=graph_ms(torch, lambda: da.decode_attention_cuda(
              q, k, vp, lens)),
          library_graph_ms=graph_ms(torch, sdpa),
          library_backend=sdpa_backend(torch, sdpa), bound_ms=bound_ms,
          bound_by=by, bytes=nbytes, padded_read_bound_ms=padded_ms)
    del q, k, v, vp
    B, S, H, dq, dv = MLA_FLASH[0]
    q, k = (torch.randn(B, S, H, dq, generator=gen, device=dev).to(bf16)
            for _ in range(2))
    v = torch.randn(B, S, H, dv, generator=gen, device=dev).to(bf16)
    vp = F.pad(v, (0, dq - dv))
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, is_causal=True)
    visible = S * (S + 1) // 2
    flops = 2 * B * H * visible * (dq + dv)
    nbytes = (2 * B * S * H * dq + 2 * B * S * H * dv) * 2
    bound_ms, by = bound(nbytes, {"bf16": (flops, PEAK_FLOPS["bfloat16"])})
    phase("10/16 timing", kernel="flash_attention", model="deepseek_mla",
          shape=f"B{B}_S{S}_H{H}_Hk{H}_qk{dq}_v{dv}_padded_to_{dq}_bf16_"
          "causal", bf16_tile=fa.tile_plan(dq),
          graph_ms=graph_ms(torch, lambda: fa.flash_attention_cuda(
              q, k, vp, causal=True)),
          library_graph_ms=graph_ms(torch, sdpa),
          library_backend=sdpa_backend(torch, sdpa), bound_ms=bound_ms,
          bound_by=by, flops=flops, bytes=nbytes,
          padded_bound_ms=2 * B * H * visible * 2 * dq
          / PEAK_FLOPS["bfloat16"] * 1e3)
    del q, k, v, vp
    da.launches, fa.launches = saved     # launches to time do not count
    torch.cuda.empty_cache()


def in_turns(torch, calls: dict) -> dict:
    """ms of each named call, measured in turns (the names in order, then
    in reverse), each turn a CUDA graph of 20 calls (`graph_ms`); each
    name's two readings, in order."""
    out = {name: [] for name in calls}
    for name in list(calls) + list(reversed(calls)):
        out[name].append(graph_ms(torch, calls[name]))
    return out


def flex_capped(torch, q, k, v, cap: float, causal: bool):
    """PyTorch's one call that computes the capped attention:
    `flex_attention` under `torch.compile` with a tanh `score_mod` (GQA by
    `enable_gqa`, causal by a block mask), on (B, S, H, d) inputs.  A
    yardstick only; the port never calls it.  Returns the call."""
    import torch._inductor.config as inductor_config
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)
    inductor_config.compile_threads = 1       # no worker processes
    flex = torch.compile(flex_attention, dynamic=False)

    def score_mod(score, b, h, q_idx, kv_idx):
        return cap * torch.tanh(score / cap)

    Sq, Skv = q.shape[1], k.shape[1]
    mask = (create_block_mask(lambda b, h, q_idx, kv_idx: kv_idx <= q_idx,
                              None, None, Sq, Skv, device=q.device)
            if causal else None)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    return lambda: flex(qt, kt, vt, score_mod=score_mod, block_mask=mask,
                        enable_gqa=True)


def time_capped(torch) -> None:
    """Both attention kernels with the cap (50, Gemma 2's) and without, at
    the table's shapes (decode B8 Skv4096 H32 Hk8 d128, every row full;
    flash B1 S4096 H32 Hk8 d128 causal), in CUDA graphs in turns (without,
    with, with, without), beside the bound (the cap adds no byte, and its
    tanh is not counted) and the library call that computes the capped
    function, `flex_attention` with a tanh score_mod under torch.compile
    (its difference from the plain version printed; where it does not run,
    why)."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    cap = SOFTCAPS[0]
    gen = torch.Generator(device="cuda").manual_seed(9)
    saved = da.launches, fa.launches
    B, Skv, H, Hk, d = (MAIN[k] for k in ("B", "Skv", "H", "Hk", "d"))
    q, k, v, lens, _, bound_ms, by = decode_inputs(torch, gen, B, Skv, H, Hk,
                                                   d)
    q, k = q * CAP_SPREAD, k * CAP_SPREAD
    ms = in_turns(torch, {
        "free": lambda: da.decode_attention_cuda(q, k, v, lens),
        "capped": lambda: da.decode_attention_cuda(q, k, v, lens, cap)})
    want = da.decode_attention_plain(q, k, v, lens, cap)
    plain_ms = time_ms(torch, lambda: da.decode_attention_plain(
        q, k, v, lens, cap))
    lib = library_line(torch, lambda: flex_capped(torch, q, k, v, cap, False),
                       want)
    phase("10/16 timing", kernel="decode_attention", softcap=cap,
          shape=f"B{B}_Skv{Skv}_H{H}_Hk{Hk}_d{d}_bf16_kvlen{Skv}",
          graph_ms_free=ms["free"], graph_ms_capped=ms["capped"],
          capped_over_free=f"{sum(ms['capped']) / sum(ms['free']):.4f}",
          plain_ms_capped=plain_ms, bound_ms=bound_ms, bound_by=by, **lib)
    del q, k, v, want
    shape = FLASH_MAIN
    q, k, v, _, bound_ms, by, flops, nbytes = flash_inputs(torch, gen, shape)
    q, k = q * CAP_SPREAD, k * CAP_SPREAD
    causal = shape[6]
    ms = in_turns(torch, {
        "free": lambda: fa.flash_attention_cuda(q, k, v, causal=causal),
        "capped": lambda: fa.flash_attention_cuda(q, k, v, causal=causal,
                                                  softcap=cap)})
    want = torch.cat([fa.flash_attention_plain(
        q[:, :, g * (H // Hk):(g + 1) * (H // Hk)], k[:, :, g:g + 1],
        v[:, :, g:g + 1], causal=causal, softcap=cap)
        for g in range(shape[4])], dim=2)
    plain_ms = time_ms(torch, lambda: fa.flash_attention_plain(
        q, k, v, causal=causal, softcap=cap), iters=3, warmup=1)
    lib = library_line(torch, lambda: flex_capped(torch, q, k, v, cap,
                                                  causal), want)
    B, Sq, Skv, H, Hk, d = shape[:6]
    phase("10/16 timing", kernel="flash_attention", softcap=cap,
          shape=f"B{B}_S{Sq}_H{H}_Hk{Hk}_d{d}_bf16_causal",
          graph_ms_free=ms["free"], graph_ms_capped=ms["capped"],
          capped_over_free=f"{sum(ms['capped']) / sum(ms['free']):.4f}",
          visible_scores=flops // (4 * d), plain_ms_capped=plain_ms,
          bound_ms=bound_ms, bound_by=by, **lib)
    del q, k, v, want
    da.launches, fa.launches = saved     # launches to time do not count
    torch.cuda.empty_cache()


def library_line(torch, make, want) -> dict:
    """The library call's fields for a timing line: its ms (a CUDA graph
    of 20 calls, or events where the graph cannot be captured), its max
    abs difference from `want`, and its build seconds; or why it did not
    run.  A yardstick, so a failure is printed, not raised."""
    t = time.perf_counter()
    try:
        fn = make()
        got = fn()
        torch.cuda.synchronize()
        built = time.perf_counter() - t
        diff = float((got.transpose(1, 2).float() - want.float()).abs().max())
        try:
            ms, how = graph_ms(torch, fn), "graph"
        except Exception:                                  # noqa: BLE001
            ms, how = time_ms(torch, fn), "events"
        return {"library": "flex_attention_compiled_tanh_score_mod",
                "library_ms": ms, "library_timing": how,
                "library_max_abs_diff": f"{diff:.3e}",
                "library_build_s": f"{built:.1f}"}
    except Exception as e:                                 # noqa: BLE001
        return {"library": "flex_attention_compiled_tanh_score_mod",
                "library_ms": None,
                "library_not_run": repr(e)[:300].replace(" ", "_")}


def decode_inputs(torch, gen, B: int, Skv: int, H: int, Hk: int, d: int):
    """bf16 q and caches on the card, every row's cache full; SDPA on the
    same inputs (a yardstick only, never called by the port: GQA by
    `enable_gqa`, the lengths as a boolean mask); the bound.  Returns
    (q, k, v, lens, sdpa, bound_ms, bound_by)."""
    import torch.nn.functional as F
    dev, dtype = gen.device, torch.bfloat16
    q = torch.randn(B, 1, H, d, generator=gen, device=dev).to(dtype)
    k = torch.randn(B, Skv, Hk, d, generator=gen, device=dev).to(dtype)
    v = torch.randn(B, Skv, Hk, d, generator=gen, device=dev).to(dtype)
    lens = torch.full((B,), Skv, dtype=torch.int32, device=dev)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    mask = (torch.arange(Skv, device=dev)[None] < lens[:, None])[:, None, None]
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, attn_mask=mask, enable_gqa=True)
    nbytes = (2 * B * Skv * Hk * d + 2 * B * H * d) * q.element_size() + 4 * B
    bound_ms, by = bound(nbytes, {"bf16": (4 * B * H * Skv * d,
                                           PEAK_FLOPS["bfloat16"])})
    return q, k, v, lens, sdpa, bound_ms, by


def time_decode(torch, launches: dict, max_err: float) -> dict:
    from repro_torch.kernels import decode_attention as da
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    B, Skv, H, Hk, d = (MAIN[k] for k in ("B", "Skv", "H", "Hk", "d"))
    q, k, v, lens, sdpa, bound_ms, by = decode_inputs(torch, gen, B, Skv, H,
                                                      Hk, d)
    saved = da.launches
    # a serving-path cache first: capacity Skv, SERVE_KV_LEN rows live
    short = torch.full((B,), SERVE_KV_LEN, dtype=torch.int32, device=dev)
    ns, split_len = da.split_plan(B, Hk, Skv, *da._card_plan(
        da._library(), dev, q.dtype, H, Hk, d))
    call = lambda: da.decode_attention_cuda(q, k, v, short)  # noqa: E731
    phase("10/16 timing", kernel="decode_attention",
          shape=f"B{B}_Skv{Skv}_H{H}_Hk{Hk}_d{d}_bf16_kvlen{SERVE_KV_LEN}",
          ms=time_ms(torch, call), graph_ms=graph_ms(torch, call),
          splits=ns, split_len=split_len)
    # the full cache.  A call is about as short on the card as the host's
    # Python per call, so the kernel and the library call are timed in CUDA
    # graphs (device time); events around calls one after another are
    # printed beside
    call = lambda: da.decode_attention_cuda(q, k, v, lens)  # noqa: E731
    ms, events_ms = graph_ms(torch, call), time_ms(torch, call)
    plain_ms = time_ms(torch, lambda: da.decode_attention_plain(q, k, v, lens))
    library_err = float((sdpa().transpose(1, 2).float() - da.decode_attention_plain(
        q, k, v, lens).float()).abs().max())
    library_ms, library_events_ms = graph_ms(torch, sdpa), time_ms(torch, sdpa)
    phase("10/16 timing", kernel="decode_attention",
          shape=f"B{B}_Skv{Skv}_H{H}_Hk{Hk}_d{d}_bf16_kvlen{Skv}",
          ms=ms, events_ms=events_ms, plain_ms=plain_ms,
          library_ms=library_ms, library_events_ms=library_events_ms,
          library_max_abs_err=f"{library_err:.3e}", bound_ms=bound_ms,
          bound_by=by)
    # the head widths and groups phases 7 and 14 added, in CUDA graphs
    for name, (b, skv, h, hk, dh, _) in (("danube3", ZOO_DECODE[1]),
                                         ("gemma", ZOO_DECODE[3]),
                                         ("seamless_cross", ZOO2_DECODE[0]),
                                         ("granite", ZOO2_DECODE[2]),
                                         ("jamba", JAMBA_DECODE[1])):
        q2, k2, v2, lens2, sdpa2, bound2, by2 = decode_inputs(
            torch, gen, b, skv, h, hk, dh)
        phase("10/16 timing", kernel="decode_attention", model=name,
              shape=f"B{b}_Skv{skv}_H{h}_Hk{hk}_d{dh}_bf16_kvlen{skv}",
              graph_ms=graph_ms(torch, lambda: da.decode_attention_cuda(
                  q2, k2, v2, lens2)),
              library_graph_ms=graph_ms(torch, sdpa2), bound_ms=bound2,
              bound_by=by2)
        del q2, k2, v2
    da.launches = saved                  # launches to time do not count
    return {"name": "decode_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
            "replaces": "src/repro/kernels/decode_attention.py:63",
            "launches": launches["decode_attention"], "max_abs_err": max_err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": by, "library_ms": library_ms}


def flash_inputs(torch, gen, shape: tuple):
    """bf16 q, k, v on the card for a FLASH_* shape (causal, or non-causal
    with no window); SDPA on the same inputs (a yardstick only: GQA by
    `enable_gqa`, a window as a boolean mask); the bound over the
    (query, key) pairs the masks leave.
    Returns (q, k, v, sdpa, bound_ms, bound_by, flops, nbytes)."""
    import torch.nn.functional as F
    B, Sq, Skv, H, Hk, d, causal, window = shape
    dev, dtype = gen.device, torch.bfloat16
    q = torch.randn(B, Sq, H, d, generator=gen, device=dev).to(dtype)
    k = torch.randn(B, Skv, Hk, d, generator=gen, device=dev).to(dtype)
    v = torch.randn(B, Skv, Hk, d, generator=gen, device=dev).to(dtype)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if window is None:
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, is_causal=causal, enable_gqa=True)
    else:
        i = torch.arange(Sq, device=dev)[:, None]
        j = torch.arange(Skv, device=dev)[None]
        mask = (j <= i) & (j > i - window)
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, attn_mask=mask, enable_gqa=True)
    # query row i sees keys max(0, i - window + 1)..i (causal), or all
    visible = (sum(min(i + 1, window or Skv) for i in range(Sq)) if causal
               else Sq * Skv)
    flops = 4 * B * H * visible * d
    nbytes = (2 * B * Sq * H * d + 2 * B * Skv * Hk * d) * q.element_size()
    bound_ms, by = bound(nbytes, {"bf16": (flops, PEAK_FLOPS["bfloat16"])})
    return q, k, v, sdpa, bound_ms, by, flops, nbytes


def time_flash(torch, launches: dict, max_err: float) -> dict:
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    B, Sq, Skv, H, Hk, d, causal, window = FLASH_MAIN
    # which design ran, and what ptxas reported for each bf16 template
    ptxas = {}
    for r in _build.ptxas_report("flash_attention"):
        if "wgmma_forward" in r["kernel"]:
            dp_bk = "x".join(re.findall(r"ILi(\d+)ELi(\d+)E", r["kernel"])[0])
            ptxas[f"wgmma_forward_{dp_bk}"] = (
                f"regs:{r.get('registers')},spill_bytes:"
                f"{r.get('spill_stores', 0) + r.get('spill_loads', 0)}")
    phase("10/16 timing", kernel="flash_attention", design="wgmma",
          bf16_tile=fa.tile_plan(d), **ptxas)
    gen = torch.Generator(device="cuda").manual_seed(4)
    q, k, v, sdpa, bound_ms, by, flops, nbytes = flash_inputs(torch, gen,
                                                              FLASH_MAIN)
    saved = fa.launches
    ms = time_ms(torch, lambda: fa.flash_attention_cuda(q, k, v,
                                                        causal=causal))
    plain_ms = time_ms(torch, lambda: fa.flash_attention_plain(
        q, k, v, causal=causal), iters=3, warmup=1)
    library_err = float((sdpa().transpose(1, 2).float() - fa.flash_attention_cuda(
        q, k, v, causal=causal).float()).abs().max())
    library_ms = time_ms(torch, sdpa)
    phase("10/16 timing", kernel="flash_attention",
          shape=f"B{B}_S{Sq}_H{H}_Hk{Hk}_d{d}_bf16_causal", ms=ms,
          plain_ms=plain_ms, library_ms=library_ms,
          library_vs_kernel_max_abs_diff=f"{library_err:.3e}",
          bound_ms=bound_ms, bound_by=by, flops=flops, bytes=nbytes)
    del q, k, v
    # the generate phases' new prefill shapes, in CUDA graphs
    for name, shape in (("danube3", FLASH_DANUBE3), ("gemma", FLASH_GEMMA),
                        *ZOO2_FLASH.items(), ("jamba", FLASH_JAMBA)):
        q2, k2, v2, sdpa2, bound2, by2, flops2, nbytes2 = flash_inputs(
            torch, gen, shape)
        B2, Sq2, Skv2, H2, Hk2, d2, causal2, window2 = shape
        phase("10/16 timing", kernel="flash_attention", model=name,
              shape=f"B{B2}_Sq{Sq2}_Skv{Skv2}_H{H2}_Hk{Hk2}_d{d2}_bf16_"
              + ("causal" if causal2 else "full")
              + (f"_w{window2}" if window2 else ""),
              bf16_tile=fa.tile_plan(d2), graph_ms=graph_ms(
                  torch, lambda: fa.flash_attention_cuda(
                      q2, k2, v2, causal=causal2, window=window2)),
              library_graph_ms=graph_ms(torch, sdpa2), bound_ms=bound2,
              bound_by=by2, flops=flops2, bytes=nbytes2)
        del q2, k2, v2
    fa.launches = saved                  # launches to time do not count
    torch.cuda.empty_cache()
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:71",
            "launches": launches["flash_attention"], "max_abs_err": max_err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": by, "library_ms": library_ms}


def sm_clock() -> str:
    """The SM clock and its maximum, as nvidia-smi reads them now."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader", "-i", "0"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().replace(", ", "/")


def time_ssm(torch, launches: dict, max_err: float) -> dict:
    from repro_torch.kernels import _build
    from repro_torch.kernels import ssm_scan as ss
    B, S, di, N = SSM_MAIN
    # what ptxas reported for each (N, L) template
    ptxas = {}
    for r in _build.ptxas_report("ssm_scan"):
        n, lanes = re.findall(r"ILi(\d+)ELi(\d+)E", r["kernel"])[0]
        ptxas[f"N{n}_L{lanes}"] = (
            f"regs:{r.get('registers')},spill_bytes:"
            f"{r.get('spill_stores', 0) + r.get('spill_loads', 0)}")
    phase("10/16 timing", kernel="ssm_scan", ptxas=json.dumps(ptxas))
    args = ssm_args(torch, torch.Generator(device="cuda").manual_seed(5),
                    B, S, di, N)
    shape = f"B{B}_S{S}_di{di}_N{N}_fp32"
    saved = ss.launches
    # the sweep over the lanes a channel, each timed with events (then the
    # SM clock) and as device time in a CUDA graph
    for lanes in sorted(L for L in ss.LANES if L <= N):
        call = lambda: ss.ssm_scan_cuda(*args, lanes=lanes)  # noqa: E731
        events_ms = time_ms(torch, call)
        clock = sm_clock()
        phase("10/16 timing", kernel="ssm_scan", shape=shape, lanes=lanes,
              ms=events_ms, sm_clock_mhz=clock,
              graph_ms=graph_ms(torch, call))
    plan = ss.lane_plan(B, di, N,
                        torch.cuda.get_device_properties(0)
                        .multi_processor_count)
    call = lambda: ss.ssm_scan_cuda(*args)  # noqa: E731
    ms = time_ms(torch, call)
    clock = sm_clock()
    device_ms = graph_ms(torch, call)
    plain_ms = time_ms(torch, lambda: ss.ssm_scan_plain(*args), iters=2,
                       warmup=1)
    ss.launches = saved
    # dt, x read and y written once; B, C, A_log read once
    nbytes = (3 * B * S * di + 2 * B * S * N + di * N) * 4
    exps = B * S * di * N + di * N
    flops = 6 * B * S * di * N     # dt*A, dA*h + bx*B, h*C, the sum over N
    bound_ms, by = bound(nbytes, {"exp": (exps, PEAK_EXP_S),
                                  "fp32": (flops, PEAK_FLOPS["float32"])})
    phase("10/16 timing", kernel="ssm_scan", shape=shape, lanes=plan.lanes,
          channels_per_block=plan.channels, blocks=plan.blocks,
          busiest_sm_channels=plan.busiest,
          mean_sm_channels=f"{plan.mean:.2f}", ms=ms, graph_ms=device_ms,
          sm_clock_mhz=clock, plain_ms=plain_ms, library_ms=None,
          bound_ms=bound_ms, bound_by=by,
          bytes_ms=nbytes / PEAK_BYTES_S * 1e3,
          exp_ms=exps / PEAK_EXP_S * 1e3,
          fp32_ms=flops / PEAK_FLOPS["float32"] * 1e3)
    time_ssm_state(torch, args, bound_ms, by, nbytes)
    return {"name": "ssm_scan", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ssm_scan.cu",
            "replaces": "src/repro/kernels/ssm_scan.py:56",
            "launches": launches["ssm_scan"], "max_abs_err": max_err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": by, "library_ms": None}


def time_ssm_state(torch, args: tuple, bound_ms: float, by: str,
                   nbytes: int) -> None:
    """The scan at SSM_MAIN as jamba's prefill calls it (h_last out), from a
    given state too (h0 in, h_last out), and without state (neither),
    in CUDA graphs, in turns (none, h_last, h0 and h_last, h0 and h_last,
    h_last, none), beside the bound; the state adds 2 * B * di * N * 4
    bytes to what the kernel moves."""
    from repro_torch.kernels import ssm_scan as ss
    B, S, di, N = SSM_MAIN
    h0 = torch.randn(B, di, N, device="cuda",
                     generator=torch.Generator(device="cuda").manual_seed(8))
    calls = {"none": lambda: ss.ssm_scan_cuda(*args),
             "h_last": lambda: ss.ssm_scan_cuda(*args, return_state=True),
             "h0_h_last": lambda: ss.ssm_scan_cuda(*args, h0=h0,
                                                   return_state=True)}
    saved = ss.launches
    times = {k: [] for k in calls}
    for k in ("none", "h_last", "h0_h_last", "h0_h_last", "h_last", "none"):
        times[k].append(graph_ms(torch, calls[k]))
    ss.launches = saved                  # launches to time do not count
    state_bytes = 2 * B * di * N * 4
    pct = 100 * (min(times["h0_h_last"]) / min(times["none"]) - 1)
    phase("10/16 timing", kernel="ssm_scan", shape=f"B{B}_S{S}_di{di}_N{N}"
          "_fp32", state="none|h_last|h0_h_last", turns=json.dumps(times),
          graph_ms_none=min(times["none"]),
          graph_ms_h_last=min(times["h_last"]),
          graph_ms_h0_h_last=min(times["h0_h_last"]),
          h0_h_last_vs_none_pct=f"{pct:.2f}",
          stateless_kernel_events_ms=STATELESS_SSM_MS, bound_ms=bound_ms,
          bound_by=by,
          state_bytes=state_bytes,
          state_bytes_ms=state_bytes / PEAK_BYTES_S * 1e3,
          bytes_with_state_ms=(nbytes + state_bytes) / PEAK_BYTES_S * 1e3)


# phase 11: the paper's deployment ("more than 20,000 GPUs") over 2 h of
# SimConfig's 12 h (240 ticks, 8 scheduling rounds), cut so that the
# script stays near its time line
FLEET = dict(n_devices=20000, horizon_s=2 * 3600.0, trace="B", tick_s=30.0,
             schedule_interval_s=900.0, seed=0)
# every branch of the tick core fires (tests/test_engine_xla.py:53's faults)
FLEET_FAULTS = dict(n_devices=200, horizon_s=2 * 3600.0, trace="D", seed=11,
                    device_mtbf_h=2.0, device_repair_s=300.0,
                    error_rate_per_job_hour=1.0, graceful_exit=False)
PREDICTOR_TOL = 1e-5                       # repro's predictor tolerance


class Phases:
    """Wall seconds by phase name, for `ClusterSim.attach_phases`."""

    def __init__(self):
        self.s: dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str, exclude=()):
        t = time.perf_counter()
        try:
            yield
        finally:
            self.s[name] = self.s.get(name, 0.0) + time.perf_counter() - t


class TimedPredictor:
    """The card predictor, timed: rows and ms of each call (the answer is
    copied back to the host, so each call ends in a sync), and the rows of
    every call, kept for the card-vs-CPU check."""

    def __init__(self, inner):
        self.inner = inner
        self.params_by_type = inner.params_by_type
        self.calls: list[tuple[str, object, float]] = []

    def predict(self, gpu_type, feats):
        t = time.perf_counter()
        out = self.inner.predict(gpu_type, feats)
        self.calls.append((gpu_type, feats, (time.perf_counter() - t) * 1e3))
        return out


def fleet_hooks(timed: TimedPredictor):
    """A SimHooks that marks where each scheduling round's predictor calls
    end and counts the tick core's events (hooks never change results)."""
    from repro_torch.core.simulator import SimHooks

    class Hooks(SimHooks):
        def __init__(self):
            self.round_ends: list[int] = []
            self.events: dict[str, int] = {}

        def _count(self, key):
            self.events[key] = self.events.get(key, 0) + 1

        def on_schedule(self, sim, t, n_free, n_before, n_assigned, wall):
            self.round_ends.append(len(timed.calls))

        def on_device_fail(self, sim, t, device, until):
            self._count("device_fail")

        def on_error(self, sim, t, device, handled):
            self._count("error_propagated" if handled.propagated
                        else "error_contained")

        def on_job_finish(self, sim, t, device, spec, jct, wall, progress):
            self._count("finish")

        def on_job_evict(self, sim, t, device, spec, reason, progress,
                         checkpoint, requeued):
            self._count(f"evict_{reason}")

    return Hooks()


def fleet_run(torch, policy, predictor, engine: str, **kw) -> dict:
    """One `ClusterSim.run()` with its wall time, phase split and the
    predictor's rows and card ms per scheduling round."""

    from repro_torch.core.simulator import ClusterSim, SimConfig
    timed = TimedPredictor(predictor) if predictor is not None else None
    hooks = fleet_hooks(timed) if timed is not None else None
    sim = ClusterSim(SimConfig(policy=policy, engine=engine, **kw), timed,
                     hooks=hooks)
    phases = Phases()
    sim.attach_phases(phases)
    t = time.perf_counter()
    res = sim.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    n_ticks = int(kw["horizon_s"] / kw.get("tick_s", 30.0))
    round_calls = []
    if timed is not None:
        start = 0
        for end in hooks.round_ends:
            round_calls.append(timed.calls[start:end])
            start = end
    lat = sim.schedule_latencies
    return {"res": res, "json": json.dumps(dataclasses.asdict(res),
                                           sort_keys=True),
            "wall_s": wall, "ticks_per_s": n_ticks / wall,
            "core_ms_per_tick": phases.s.get("dense_core", 0.0) * 1e3
            / n_ticks, "phases_s": phases.s, "round_calls": round_calls,
            "sched_s": lat, "sim": sim}


def fleet_line(name: str, engine: str, run: dict, **extra) -> None:
    r = run["res"]
    lat = run["sched_s"]
    rows = [sum(len(f) for _, f, _ in c) for c in run["round_calls"]]
    ms = [sum(m for _, _, m in c) for c in run["round_calls"]]
    fields = dict(
        gpu_util=r.gpu_util, sm_activity=r.sm_activity, mem_used=r.mem_used,
        oversold_gpu=r.oversold_gpu, avg_slowdown=r.avg_slowdown,
        p99_latency_ms=r.p99_latency_ms, n_jobs=r.n_jobs,
        n_finished=r.n_finished, evictions=r.evictions,
        errors_propagated=r.errors_propagated,
        wall_s=f"{run['wall_s']:.2f}",
        ticks_per_s=f"{run['ticks_per_s']:.2f}",
        core_ms_per_tick=f"{run['core_ms_per_tick']:.3f}")
    if lat:
        fields.update(rounds=len(lat),
                      round_s_mean=f"{sum(lat) / len(lat):.3f}",
                      round_s_max=f"{max(lat):.3f}")
    if rows:
        fields.update(predictor_rows_mean=f"{sum(rows) / len(rows):.1f}",
                      predictor_rows_max=max(rows),
                      predictor_ms_mean=f"{sum(ms) / len(ms):.3f}",
                      predictor_ms_max=f"{max(ms):.3f}")
    fields["phases_s"] = json.dumps({k: round(v, 3) for k, v in
                                     sorted(run["phases_s"].items())})
    phase(f"11/16 fleet.{name}", engine=engine, **fields, **extra)


def engine_profile(torch, sim, ticks: int = 30) -> None:
    """One block of the torch engine at the fleet's size, after its run's
    results were taken, under torch.profiler: the block's wall time, the
    card's busy time (kernels and copies) and its launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    eng = sim._torch_engine()
    t0 = sim.cfg.horizon_s
    warm = [sim._tick_inputs(t0 + k * sim.cfg.tick_s) for k in range(ticks)]
    eng.tick_block(warm)
    t0 += ticks * sim.cfg.tick_s
    inps = [sim._tick_inputs(t0 + k * sim.cfg.tick_s) for k in range(ticks)]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        eng.tick_block(inps)
        wall_ms = (time.perf_counter() - t) * 1e3
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    copies = [e for e in dev if "memcpy" in e.name.lower()]
    busy = sum(e.time_range.elapsed_us() for e in dev) / 1e3
    copy_ms = sum(e.time_range.elapsed_us() for e in copies) / 1e3
    fields = dict(ticks=ticks, wall_ms=f"{wall_ms:.2f}",
                  wall_ms_per_tick=f"{wall_ms / ticks:.3f}")
    if dev:
        fields.update(device_busy_ms=f"{busy:.3f}",
                      copy_ms=f"{copy_ms:.3f}",
                      kernels=len(dev) - len(copies),
                      kernels_per_tick=f"{(len(dev) - len(copies)) / ticks:.1f}",
                      idle_share=f"{1.0 - busy / wall_ms:.3f}")
    else:
        fields.update(device_busy_ms="not measured (no device events)")
    phase("11/16 fleet.engine", device="cuda", n_devices=sim.cfg.n_devices,
          **fields)


def phase_fleet(torch, card_matrix, predictor) -> None:
    """MuxFlow's scheduling step at 20,000 GPUs on the card's matrix and
    predictor: numpy against torch engine byte for byte, the dedicated
    baseline, the predictor on the card against the CPU, and a small fleet
    under heavy faults in lockstep."""
    import numpy as np

    from repro_torch.core.predictor import SpeedPredictor
    from repro_torch.core.simulator import ClusterSim, SimConfig
    from repro_torch.profiling.calibrate import MeasuredMuxFlowPolicy
    require(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on")
    policy = MeasuredMuxFlowPolicy(matrix=card_matrix)
    require(all(p[0]["w"].device.type == "cuda"
                for p in predictor.params_by_type.values()),
            "the predictor is not on the card")
    runs = {engine: fleet_run(torch, policy, predictor, engine, **FLEET)
            for engine in ("numpy", "torch")}
    for engine, run in runs.items():
        fleet_line("muxflow-measured", engine, run,
                   device=("cuda" if engine == "torch" else "host"),
                   n_devices=FLEET["n_devices"],
                   horizon_h=FLEET["horizon_s"] / 3600.0,
                   cut="2 h of SimConfig's 12 h")
    require(runs["numpy"]["json"] == runs["torch"]["json"],
            "SimResults differ between the numpy and torch engines")
    engine_profile(torch, runs["torch"]["sim"])
    res = runs["numpy"]["res"]
    require(res.n_finished > 0 and 0.0 < res.gpu_util <= 1.0
            and math.isfinite(res.p99_latency_ms),
            f"implausible fleet results {res}")
    base = fleet_run(torch, "online-only", None, "numpy", **FLEET)
    fleet_line("online-only", "numpy", base)
    require(base["res"].oversold_gpu == 0.0
            and base["res"].gpu_util < res.gpu_util,
            "sharing did not raise utilization over the dedicated baseline")

    # the card's predictions over one round's grid against the CPU's
    calls = next(c for c in runs["torch"]["round_calls"] if c)
    cpu = SpeedPredictor({t: [{k: v.cpu() for k, v in layer.items()}
                              for layer in params]
                          for t, params in predictor.params_by_type.items()})
    err = max(float(np.abs(predictor.predict(t, f) - cpu.predict(t, f)).max())
              for t, f, _ in calls)
    require(err <= PREDICTOR_TOL,
            f"card predictions off the CPU's by {err} > {PREDICTOR_TOL}")
    phase("11/16 fleet.predictor", rows=sum(len(f) for _, f, _ in calls),
          gpu_types=sorted({str(t) for t, _, _ in calls}), max_abs_err=err,
          tol=PREDICTOR_TOL, matmul_precision=repr(
              torch.get_float32_matmul_precision()),
          allow_tf32=torch.backends.cuda.matmul.allow_tf32)

    # heavy faults: block mode byte-equal, then tick by tick in lockstep
    faults = {engine: fleet_run(torch, policy, predictor, engine,
                                **FLEET_FAULTS)
              for engine in ("numpy", "torch")}
    require(faults["numpy"]["json"] == faults["torch"]["json"],
            "SimResults differ between engines under heavy faults")
    sims = [ClusterSim(SimConfig(policy=policy, engine=engine,
                                 **FLEET_FAULTS), predictor)
            for engine in ("numpy", "torch")]
    n_ticks = int(FLEET_FAULTS["horizon_s"] / 30.0)
    ts = [0.0, 0.0]
    for k in range(n_ticks):
        ts = [sim.step(t) for sim, t in zip(sims, ts)]
        a, b = sims
        for f in ("has_job", "model_idx", "sm_share", "progress",
                  "checkpoint", "wall", "duration", "failed_until",
                  "outage_until"):
            require(np.array_equal(getattr(a.state, f), getattr(b.state, f)),
                    f"tick {k}: {f} differs between engines")
        require(np.array_equal(a.monitor.state, b.monitor.state)
                and np.array_equal(a.monitor._readmit_at,
                                   b.monitor._readmit_at, equal_nan=True)
                and np.array_equal(a.monitor._ol_times, b.monitor._ol_times),
                f"tick {k}: the monitor differs between engines")
    events = faults["torch"]["sim"].hooks.events
    readmits = int((faults["torch"]["sim"].monitor._ol_ptr > 0).sum())
    for key in ("device_fail", "error_propagated", "finish",
                "evict_device_failure", "evict_error"):
        require(events.get(key, 0) > 0, f"no {key} under heavy faults")
    fleet_line("faults", "numpy==torch", faults["torch"], events=events,
               overlimit_devices=readmits, lockstep_ticks=n_ticks)
    fleet_legacy(torch)


# tests/test_sim_parity.py's configuration: the per-device reference engine
# against the vectorized one, under its rule
LEGACY = dict(n_devices=50, horizon_s=4 * 3600.0, tick_s=30.0, trace="B",
              seed=12345)


def approx(got: float, want: float, rel: float, abs_: float = 0.0) -> bool:
    """pytest.approx's rule: |got - want| <= max(rel * |want|, abs_)."""
    return abs(got - want) <= max(rel * abs(want), abs_)


def legacy_problems(vec, ref) -> list:
    """The fields of SimResults where `vec` breaks tests/test_sim_parity.py's
    rule against `ref`, taken from the dataclass so that no field escapes
    it: ints (the counts) and strings equal, floats rel 1e-9 / abs 1e-12
    but p99 rel 0.02 / abs 0.2 (binned against interpolated), and the
    timeline's series: the same keys, "t" equal, the others rel 1e-9."""
    bad = []
    for field in dataclasses.fields(ref):
        kind = field.type if isinstance(field.type, str) \
            else field.type.__name__
        got, want = getattr(vec, field.name), getattr(ref, field.name)
        if field.name == "p99_latency_ms":
            ok = approx(got, want, 0.02, 0.2)
        elif kind == "float":
            ok = approx(got, want, 1e-9, 1e-12)
        elif kind == "dict":
            ok = sorted(got) == sorted(want) and got["t"] == want["t"]
            if ok:
                bad += [f"{field.name}.{k}" for k in sorted(want)
                        if len(got[k]) != len(want[k]) or not all(
                            approx(x, y, 1e-9)
                            for x, y in zip(got[k], want[k]))]
        else:
            ok = got == want
        if not ok:
            bad.append(field.name)
    return bad


def fleet_legacy(torch) -> None:
    """`muxflow` on the torch tick engine on the card against the port's
    per-device `LegacyClusterSim`, under one predictor trained on the card
    as tests/test_sim_parity.py trains its own."""
    from repro_torch.core.predictor import build_speed_predictor
    from repro_torch.core.simulator import ClusterSim, SimConfig
    from repro_torch.core.simulator_legacy import LegacyClusterSim
    pred = build_speed_predictor(gpu_types=("T4", "A10"), n=500, epochs=25)
    t = time.perf_counter()
    ref = LegacyClusterSim(SimConfig(policy="muxflow", **LEGACY), pred).run()
    legacy_s = time.perf_counter() - t
    t = time.perf_counter()
    vec = ClusterSim(SimConfig(policy="muxflow", engine="torch", **LEGACY),
                     pred).run()
    torch.cuda.synchronize()
    torch_s = time.perf_counter() - t
    bad = legacy_problems(vec, ref)
    require(not bad, f"the torch engine breaks the parity rule against the "
            f"legacy engine in {bad}")
    require(ref.n_finished > 0 and ref.n_jobs > 0, "no job finished")
    phase("11/16 fleet.legacy", policy="muxflow", engines="torch~legacy",
          n_devices=LEGACY["n_devices"], horizon_h=LEGACY["horizon_s"] / 3600,
          trace=LEGACY["trace"], seed=LEGACY["seed"],
          n_finished=ref.n_finished, evictions=ref.evictions,
          oversold_gpu=ref.oversold_gpu, gpu_util=ref.gpu_util,
          p99_ms=f"{vec.p99_latency_ms}~{ref.p99_latency_ms}",
          rule="counts==,floats rel1e-9 abs1e-12,p99 rel0.02 abs0.2,"
               "timelines rel1e-9",
          legacy_s=f"{legacy_s:.2f}", torch_s=f"{torch_s:.2f}")


# phase 12: `repro`'s flagship campaign at the paper's fleet, 30 s ticks,
# over 6 h of the scenario's 12 h, cut so that the script stays near its
# time line
CONTROL = dict(scenario="diurnal-mixed", n_devices=20000, hours=6)
CONTROL_PROFILED_TICKS = 30


def timer(phases: Phases, label: str):
    """A wrapper that times every call of a function into `phases`."""
    def wrap(inner):
        def call(*args, **kw):
            with phases.phase(label):
                return inner(*args, **kw)
        return call
    return wrap


def timed_method(obj, name: str, phases: Phases, label: str) -> None:
    """Time every call of `obj.name` into `phases` under `label`."""
    setattr(obj, name, timer(phases, label)(getattr(obj, name)))


def control_run(torch, sc, predictor, engine: str) -> dict:
    """One `ControlPlane` campaign; its last ticks on their own (the torch
    engine's under torch.profiler), so that ms a tick reads the rest.  The
    split: the engine's phases (`schedule` holds `match` and `predict`),
    the control plane's parts between ticks, and the rest (`other`: the
    loop, the engine's step outside its phases, the bus's hooks)."""
    from repro_torch.cluster.control import ControlPlane
    cp = ControlPlane(sc.with_overrides(engine=engine), predictor=predictor)
    phases = Phases()
    cp.sim.attach_phases(phases)
    timed_method(cp, "_submit_due", phases, "submit")
    timed_method(cp, "_autoscale", phases, "autoscale")
    timed_method(cp.campaign, "inject", phases, "faults")
    timed_method(cp.agents, "observe", phases, "agents")
    n = int(sc.horizon_seconds() / sc.tick_s)
    head = n - CONTROL_PROFILED_TICKS
    t = time.perf_counter()
    cp.run(stop_tick=head)
    torch.cuda.synchronize()
    head_s = time.perf_counter() - t
    split = dict(phases.s, schedule=sum(cp.sim.schedule_latencies))
    split["other"] = head_s - sum(v for k, v in split.items()
                                  if k not in ("match", "predict"))
    tail = contextlib.nullcontext()
    if engine == "torch":
        from torch.profiler import ProfilerActivity, profile
        tail = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
    t = time.perf_counter()
    with tail as prof:
        cp.run(start_tick=head, start_t=cp._t_end)
        torch.cuda.synchronize()
    tail_s = time.perf_counter() - t
    out = {"report": cp.report(), "head_s": head_s, "tail_s": tail_s,
           "ms_per_tick": head_s * 1e3 / head, "split_s": split}
    if engine == "torch":
        from torch.autograd import DeviceType
        dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        busy = sum(e.time_range.elapsed_us() for e in dev) / 1e3
        out["profiled"] = (
            dict(device_busy_ms=f"{busy:.3f}", launches=len(dev),
                 idle_share=f"{1.0 - busy / (tail_s * 1e3):.3f}")
            if dev else dict(device_busy_ms="not measured (no device "
                                            "events)"))
    return out


def run_cli_plain(torch, argv: list) -> tuple[int, float, str]:
    """`python -m repro_torch <argv>` in-process with its stderr captured;
    returns the exit code, the wall seconds and the stderr text."""
    import io

    from repro_torch import cli
    err = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    return rc, time.perf_counter() - t, err.getvalue()


def run_cli(torch, argv: list) -> tuple[dict, float]:
    """`python -m repro_torch <argv>` in-process, its report written to a
    temporary file; returns the report and the wall seconds."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "report.json")
        rc, wall, err = run_cli_plain(torch, [*argv, "--out", path])
        sys.stderr.write(err)
        require(rc == 0, f"{argv}: exit code {rc}")
        with open(path) as f:
            return json.load(f), wall


def phase_control(torch) -> dict:
    """MuxFlow's control plane at 20,000 GPUs on both engines, byte for
    byte, then the front door's `sim` and `serve` on three scenarios.
    Returns the kernels' launch counts of this path (the calibrated run's
    matrix) and the torch run's ms a tick."""
    from repro_torch.cluster.control import check_schema
    from repro_torch.cluster.fleet import FleetSpec
    from repro_torch.cluster.scenario import scenario_by_name
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssm_scan as ss
    from repro_torch.policies import resolve
    sc = scenario_by_name(CONTROL["scenario"]).with_overrides(
        n_devices=CONTROL["n_devices"], hours=CONTROL["hours"])
    t = time.perf_counter()
    predictor = resolve(sc.policy).build_predictor(
        FleetSpec(sc.n_devices, sc.pools).gpu_types,
        samples=sc.predictor_samples, epochs=sc.predictor_epochs, seed=0)
    torch.cuda.synchronize()
    require(all(p[0]["w"].device.type == "cuda"
                for p in predictor.params_by_type.values()),
            "the predictor is not on the card")
    phase("12/16 control.predictor", device="cuda", policy=sc.policy,
          samples=sc.predictor_samples, epochs=sc.predictor_epochs,
          seconds=f"{time.perf_counter() - t:.2f}")
    runs = {engine: control_run(torch, sc, predictor, engine)
            for engine in ("numpy", "torch")}
    canon = {e: json.dumps(r["report"], indent=2, sort_keys=True)
             for e, r in runs.items()}
    require(canon["numpy"] == canon["torch"],
            "the control plane's reports differ between the engines")
    rep = runs["numpy"]["report"]
    problems = check_schema(rep)
    require(not problems, f"report schema: {problems}")
    s, f = rep["sim"], rep["faults"]
    require(s["n_finished"] > 0 and 0.0 < s["gpu_util"] <= 1.0
            and math.isfinite(f["propagation_rate"]),
            f"implausible campaign report {s}")
    for engine, run in runs.items():
        phase("12/16 control.diurnal-mixed", engine=engine,
              device=("cuda" if engine == "torch" else "host"),
              n_devices=sc.n_devices, hours=sc.hours, tick_s=sc.tick_s,
              wall_s=f"{run['head_s'] + run['tail_s']:.2f}",
              ms_per_tick=f"{run['ms_per_tick']:.3f}",
              split_s=json.dumps({k: round(v, 3) for k, v in
                                  sorted(run["split_s"].items())}),
              **run.get("profiled", {}))
    phase("12/16 control.report", scenario=sc.name, engines="numpy==torch",
          bytes=len(canon["numpy"]), schema="clean",
          gpu_util=s["gpu_util"], sm_activity=s["sm_activity"],
          oversold_gpu=s["oversold_gpu"], avg_slowdown=s["avg_slowdown"],
          n_jobs=s["n_jobs"], n_finished=s["n_finished"],
          faults_injected=f["injected"], faults_propagated=f["propagated"],
          propagation_rate=f["propagation_rate"],
          autoscale_decisions=rep["autoscaler"]["n_decisions"],
          stale_device_ticks=rep["agents"]["stale_device_ticks"],
          events=rep["events"]["n_events"])

    # the front door: the measured matrix built on the card
    da.launches = fa.launches = ss.launches = 0
    rep, wall = run_cli(torch, ["sim", "--scenario", "calibrated"])
    counts = {"decode_attention": da.launches, "flash_attention": fa.launches,
              "ssm_scan": ss.launches}
    require(all(n > 0 for n in counts.values()),
            f"the calibrated run's matrix did not launch every kernel "
            f"(phase 8's matrix is not reused): {counts}")
    require(not check_schema(rep) and rep["sim"]["n_finished"] > 0,
            "calibrated: bad report")
    phase("12/16 control.calibrated", n_devices=rep["scenario"]["n_devices"],
          matrix="built on the card", launches=counts,
          gpu_util=rep["sim"]["gpu_util"],
          avg_slowdown=rep["sim"]["avg_slowdown"],
          n_finished=rep["sim"]["n_finished"], wall_s=f"{wall:.2f}")

    rep, wall = run_cli(torch, ["serve", "--scenario", "serving-slo"])
    serving = rep["serving"]
    require(not check_schema(rep) and serving["total"]["served"] > 0,
            "serving-slo: bad report")
    for svc, row in sorted(serving["services"].items()) + [
            ("total", serving["total"])]:
        phase("12/16 control.serving-slo", service=svc, p50_ms=row["p50_ms"],
              p99_ms=row["p99_ms"], slo_attainment=row["slo_attainment"],
              shed=row["shed"], arrived=row["arrived"])
    phase("12/16 control.serving-slo", n_devices=rep["scenario"]["n_devices"],
          hours=rep["scenario"]["hours"], wall_s=f"{wall:.2f}")

    rep, wall = run_cli(torch, ["sim", "--scenario", "chaos-storm"])
    res = rep["resilience"]
    require(not check_schema(rep) and res["injected"] > 0
            and res["unmatched"] == 0,
            f"chaos-storm: unpaired faults {res['unmatched_by_kind']}")
    phase("12/16 control.chaos-storm", n_devices=rep["scenario"]["n_devices"],
          injected=res["injected"], recovered=res["recovered"],
          unmatched=res["unmatched"],
          injected_by_kind=json.dumps(res["injected_by_kind"]),
          wall_s=f"{wall:.2f}")
    return {"launches": counts,
            "torch_ms_per_tick": runs["torch"]["ms_per_tick"]}


# ------------------------------------------------------------------ phase 13
# phase 13: diurnal-mixed at 20,000 devices over 3 h of its 12 h (360
# ticks), cut so that the script stays near its time line; the kill falls
# between the snapshots at ticks 240 and 300, after the pruning of old ones
# began (three are kept), and `inspect` restores the kept snapshot at 300
# and replays 30 ticks
DURABLE = dict(scenario="diurnal-mixed", n_devices=20000, hours=3,
               metrics_every=600, snapshot_every=1800, kill_tick=260,
               inspect_tick=330, serve_hours=6)
OBS_FILES = ("report.json", "metrics.jsonl", "trace.jsonl", "metrics.prom",
             "incidents.jsonl")


def durable_argv(d: str, snapshot_every: float) -> list:
    """Every obs flag and --durable, all outputs under `d`."""
    def at(name):
        return os.path.join(d, name)
    return ["--metrics-out", at("metrics.jsonl"),
            "--trace-out", at("trace.jsonl"),
            "--prom-out", at("metrics.prom"),
            "--alerts-out", at("incidents.jsonl"),
            "--durable", at("run"), "--snapshot-every", str(snapshot_every),
            "--out", at("report.json")]


def dir_bytes(d: str, names=None) -> dict:
    names = sorted(os.listdir(d)) if names is None else names
    out = {}
    for name in names:
        path = os.path.join(d, name)
        if os.path.isfile(path):
            with open(path, "rb") as f:
                out[name] = f.read()
    return out


@contextlib.contextmanager
def wrapped(cls, name: str, wrap):
    """Replace `cls.name` by `wrap(original)` for the block."""
    inner = getattr(cls, name)
    setattr(cls, name, wrap(inner))
    try:
        yield
    finally:
        setattr(cls, name, inner)


def phase_durable(torch, control: dict) -> None:
    """The observability and durability planes over the card's tick engine:
    `diurnal-mixed` at 20,000 devices through `sim` with every obs flag and
    --durable; the same run killed at a tick between two snapshots and
    resumed in a fresh process, byte-equal; `inspect`; `serve` durable on
    both engines, byte-equal; `chaos` on the card."""
    import tempfile

    from repro_torch.chaos.harness import _SimulatedKill
    from repro_torch.cluster.control import check_schema
    from repro_torch.durability.runner import DurableRun
    from repro_torch.durability.store import JsonlEventStore
    from repro_torch.obs.alerts import AlertEngine
    from repro_torch.obs.export import lint_prometheus
    from repro_torch.obs.metrics import FleetMetricsRecorder
    from repro_torch.obs.trace import EventBusTracer
    D = DURABLE
    sim = ["sim", "--scenario", D["scenario"], "--devices",
           str(D["n_devices"]), "--hours", str(D["hours"]), "--engine",
           "torch",
           "--metrics-every", str(D["metrics_every"]), "--profile-phases"]
    with tempfile.TemporaryDirectory() as work:
        a, c = os.path.join(work, "A"), os.path.join(work, "C")
        os.makedirs(a)
        os.makedirs(c)

        # 1. the uninterrupted run, its layers timed
        parts = Phases()
        tick_at: dict[int, float] = {}

        def record_ticks(inner):
            def make(self):
                cb = inner(self)

                def each(ticks_done, t):
                    cb(ticks_done, t)
                    tick_at[ticks_done] = time.perf_counter()
                return each
            return make

        with contextlib.ExitStack() as stack:
            for cls, name, label in (
                    (JsonlEventStore, "append", "wal_append"),
                    (DurableRun, "_snapshot", "snapshot"),
                    (FleetMetricsRecorder, "on_tick", "metrics"),
                    (EventBusTracer, "_on_event", "trace"),
                    (AlertEngine, "on_window", "alerts")):
                stack.enter_context(wrapped(cls, name, timer(parts, label)))
            stack.enter_context(wrapped(DurableRun, "_tick_callback",
                                        record_ticks))
            rc, wall, err = run_cli_plain(
                torch, sim + durable_argv(a, D["snapshot_every"]))
        require(rc == 0, f"durable sim: exit code {rc}\n{err}")
        with open(os.path.join(a, "report.json")) as f:
            rep = json.load(f)
        require(not check_schema(rep), f"report schema: {check_schema(rep)}")
        # the bus delivered every event to the WAL, its sink
        ev = rep["events"]
        require(ev["sink_events"] == ev["n_events"] and not ev["sink_dropped"],
                f"WAL sink events {ev}")
        with open(os.path.join(a, "metrics.prom")) as f:
            lint = lint_prometheus(f.read())
        require(not lint, f"Prometheus lint: {lint}")
        rc, _, verr = run_cli_plain(torch, [
            "sim", "--verify-manifest", os.path.join(a, "run",
                                                     "manifest.json")])
        require(rc == 0 and "manifest OK" in verr, f"manifest: {verr}")
        n = int(round(rep["scenario"]["hours"] * 3600.0
                      / rep["scenario"]["tick_s"]))
        every = int(round(D["snapshot_every"] / rep["scenario"]["tick_s"]))
        events = rep["events"]["n_events"]
        snaps = sorted(os.listdir(os.path.join(a, "run", "snapshots")))
        snap_bytes = [os.path.getsize(os.path.join(a, "run", "snapshots",
                                                   s)) for s in snaps]
        for line in err.splitlines():
            if line.startswith("[phases]") and "phase" not in line[9:15]:
                name, *vals = line[9:].split()
                phase("13/16 durable.phases", phase=name, wall_s=vals[0],
                      **({"share": vals[1], "calls": vals[2]}
                         if len(vals) == 3 else {}))
        obs = rep["obs"]
        phase("13/16 durable.run", scenario=D["scenario"],
              n_devices=D["n_devices"], hours=rep["scenario"]["hours"],
              engine="torch", device="cuda", ticks=n,
              wall_s=f"{wall:.2f}", ms_per_tick=f"{wall * 1e3 / n:.3f}",
              phase12_torch_ms_per_tick=(
                  f"{control['torch_ms_per_tick']:.3f}"),
              ratio_to_phase12=(
                  f"{wall * 1e3 / n / control['torch_ms_per_tick']:.3f}"),
              parts_s=json.dumps({k: round(v, 3)
                                  for k, v in sorted(parts.s.items())}),
              schema="clean", prom_lint="clean", manifest="OK")
        phase("13/16 durable.wal", backend="jsonl", events=events,
              events_per_s=f"{events / wall:.1f}",
              append_us=f"{parts.s['wal_append'] * 1e6 / events:.2f}",
              metrics_rows=obs["metrics"]["rows"],
              metrics_windows=obs["metrics"]["windows"],
              trace_rows=obs["trace"]["rows"],
              incidents=rep["incidents"]["total"])
        n_snap = n // every - (1 if n % every == 0 else 0)
        phase("13/16 durable.snapshots", taken=n_snap, kept=len(snaps),
              every_ticks=every,
              bytes_each=json.dumps(dict(zip(snaps, snap_bytes))),
              ms_each=f"{parts.s['snapshot'] * 1e3 / n_snap:.1f}")

        # 2. the same run killed at a tick between two snapshots, resumed
        # in a fresh process (which retrains the predictor on the card)
        kill = D["kill_tick"]
        require(kill % every and kill > 4 * every,
                "the kill tick must lie between two snapshots, after the "
                "pruning of old ones has begun")
        dead = []

        def kill_at(inner):
            def make(self):
                cb = inner(self)

                def each(ticks_done, t):
                    cb(ticks_done, t)
                    if ticks_done >= kill:
                        dead.append(self)
                        raise _SimulatedKill()
                return each
            return make

        t = time.perf_counter()
        try:
            with wrapped(DurableRun, "_tick_callback", kill_at):
                run_cli_plain(torch, sim + durable_argv(
                    c, D["snapshot_every"]))
            require(False, "the durable run was not killed")
        except _SimulatedKill:
            pass
        killed_s = time.perf_counter() - t
        dead.pop().store.abandon()
        gc.collect()       # no handle of the dead run outlives it
        require(not os.path.exists(os.path.join(c, "report.json")),
                "the killed run wrote a report")
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [SRC] + [p for p in [env.get("PYTHONPATH")] if p])
        t = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch", "sim", "--resume",
             os.path.join(c, "run")], env=env, cwd=ROOT,
            capture_output=True, text=True, timeout=600)
        resume_s = time.perf_counter() - t
        require(proc.returncode == 0,
                f"resume: exit code {proc.returncode}\n{proc.stderr}")
        origin = (kill // every) * every
        require(f"from tick {origin}:" in proc.stderr,
                f"resume did not start at tick {origin}: {proc.stderr}")
        cli_wall = re.search(r"\(([0-9.]+)s wall", proc.stderr)
        got, want = dir_bytes(c, OBS_FILES), dir_bytes(a, OBS_FILES)
        require(sorted(got) == sorted(OBS_FILES),
                f"the resumed run wrote {sorted(got)}")
        differ = [k for k in OBS_FILES if got[k] != want[k]]
        rc, _, derr = run_cli_plain(torch, [
            "diff", os.path.join(a, "run"), os.path.join(c, "run"),
            "--out", os.path.join(work, "diff.json")])
        require(not differ and rc == 0,
                f"the resumed run differs from the uninterrupted one in "
                f"{differ}; diff exit {rc}: {derr}")
        rc, _, verr = run_cli_plain(torch, [
            "sim", "--verify-manifest", os.path.join(c, "run",
                                                     "manifest.json")])
        require(rc == 0, f"resumed manifest: {verr}")
        live_s = tick_at[n] - tick_at[origin]
        phase("13/16 durable.resume", killed_at_tick=kill,
              resumed_from_tick=origin, ticks_replayed=n - origin,
              killed_run_s=f"{killed_s:.2f}",
              resume_process_s=f"{resume_s:.2f}",
              resume_cli_wall_s=(cli_wall.group(1) if cli_wall
                                 else "not printed"),
              live_s_same_ticks=f"{live_s:.2f}",
              bytes_equal=",".join(OBS_FILES), diff="identical",
              manifest="OK")

        # 3. time travel to a tick of the uninterrupted run
        rc, wall, err = run_cli_plain(torch, [
            "inspect", os.path.join(a, "run"), "--tick",
            str(D["inspect_tick"]), "--out",
            os.path.join(work, "inspect.json")])
        require(rc == 0, f"inspect: exit code {rc}\n{err}")
        with open(os.path.join(work, "inspect.json")) as f:
            doc = json.load(f)
        require(doc["tick"] == D["inspect_tick"]
                and doc["devices"]["total"] == D["n_devices"],
                f"inspect: {doc['tick']}, {doc['devices']}")
        for line in err.strip().splitlines():
            phase("13/16 durable.inspect", line=repr(line))
        phase("13/16 durable.inspect", tick=D["inspect_tick"],
              wall_s=f"{wall:.2f}")

        # 4. serve durable on both engines: every artifact byte-equal
        out = {}
        for engine in ("numpy", "torch"):
            d = os.path.join(work, f"serve-{engine}")
            os.makedirs(d)
            rc, wall, err = run_cli_plain(torch, [
                "serve", "--scenario", "serving-slo", "--engine", engine,
                "--hours", str(D["serve_hours"]),
                "--metrics-every", str(D["metrics_every"])]
                + durable_argv(d, D["snapshot_every"]))
            require(rc == 0, f"serve {engine}: exit code {rc}\n{err}")
            out[engine] = (dir_bytes(d), dir_bytes(
                os.path.join(d, "run", "events")), wall)
        require(out["numpy"][:2] == out["torch"][:2],
                "serving-slo's artifacts differ between the engines")
        with open(os.path.join(work, "serve-torch", "report.json")) as f:
            rep = json.load(f)
        phase("13/16 durable.serve", scenario="serving-slo",
              n_devices=rep["scenario"]["n_devices"],
              hours=rep["scenario"]["hours"], engines="numpy==torch",
              files=",".join(sorted(out["torch"][0])),
              wal_segments=",".join(sorted(out["torch"][1])),
              events=rep["events"]["n_events"],
              slo_attainment=rep["serving"]["total"]["slo_attainment"],
              wall_s=json.dumps({e: round(v[2], 2)
                                 for e, v in out.items()}))

        # 5. the chaos harness on the card
        path = os.path.join(work, "verdict.json")
        rc, wall, err = run_cli_plain(torch, [
            "chaos", "--scenario", "chaos-storm", "--engine", "torch",
            "--workdir", os.path.join(work, "chaos"), "--out", path])
        with open(path) as f:
            verdict = json.load(f)
        names = {i["name"]: i["ok"] for i in verdict["invariants"]}
        require(rc == 0 and verdict["ok"]
                and names.get("store-retry-ladder")
                and names.get("recovery-byte-identity"),
                f"chaos: exit code {rc}, invariants {names}")
        for inv in verdict["invariants"]:
            phase("13/16 durable.chaos", invariant=inv["name"],
                  result="PASS" if inv["ok"] else "FAIL",
                  detail=repr(inv["detail"]))
        res = verdict["resilience"]
        phase("13/16 durable.chaos", scenario="chaos-storm", engine="torch",
              device="cuda", injected=res["injected"],
              recovered=res["recovered"],
              store_faults=res["ladder"]["store_faults"],
              store_retries=res["ladder"]["store_retries"],
              wall_s=f"{wall:.2f}")


# ------------------------------------------------------------------ phase 14
# phase 14: the rest of the zoo.  (arch, batch, prompt tokens, decode steps,
# layers) of its generate runs at full width, layers None being the
# config's depth; pixtral-12b's prompt also holds its 1024 patch embeddings
# before the tokens, seamless-m4t-medium's batch ZOO2_FRAMES source frame
# embeddings.  granite-moe-1b-a400m's generate and engine run GRANITE_CUT of
# its 24 layers since deepseek-v2-lite-16b came in (the script past 240 s):
# deepseek's runs cover the grouped MoE through the same paths at full depth
GRANITE_CUT = 6
ZOO2_GENERATE = [("pixtral-12b", 1, 1024, 31, None),
                 ("seamless-m4t-medium", 2, 512, 31, None),
                 ("granite-moe-1b-a400m", 2, 2048, 31,
                  {"num_layers": GRANITE_CUT})]
ZOO2_FRAMES = 1024
ZOO2_TRAIN_SEQ = 512          # tokens a row of the train batches (B2)


def zoo_batch(torch, cfg, B: int, S: int, gen, frames: int) -> dict:
    """Tokens, with the stub frontends' embeddings a config takes: the
    patch frontend's num_patches embeddings, an encoder's `frames` source
    frames; drawn from `gen` on its device."""
    dev = gen.device
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), device=dev,
                                     generator=gen)}
    if cfg.frontend == "patch":
        batch["patch_embeds"] = torch.randn(B, cfg.num_patches, cfg.d_model,
                                            generator=gen, device=dev)
    if cfg.enc_layers:
        batch["src_embeds"] = torch.randn(B, frames, cfg.d_model,
                                          generator=gen, device=dev)
    return batch


def attn_layers(cfg) -> int:
    """The decoder's attention layers (all but the Mamba ones)."""
    return cfg.num_layers - cfg.repeats * sum(
        mixer == "mamba" for mixer, _ in cfg.pattern)


def zoo_want(cfg, steps: int) -> dict:
    """A generate run's exact launches: flash once an attention layer in
    the prefill (an encoder's layers too, and once more for a decoder
    layer's cross attention), decode once an attention layer a step (twice
    with cross attention), the scan once a Mamba layer in the prefill and
    never in decode."""
    cross = 2 if cfg.enc_layers else 1
    attn = attn_layers(cfg)
    return {"flash_attention": cross * attn + cfg.enc_layers,
            "decode_attention": cross * attn * steps,
            "ssm_scan": cfg.num_layers - attn}


def zoo_parity(torch, arch: str) -> float:
    """`arch` SMOKE in fp32, one set of weights on the card and on the CPU,
    on one batch (its patches or source frames too): the prefill's
    last-token logits, 20 decode steps' logits after it (limit 1e-4 each)
    and `greedy_generate`'s tokens over 12 steps, which must be equal.
    Returns the logits' max abs error."""
    import copy

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import (greedy_generate, init_cache,
                                    init_params, make_decode_step,
                                    make_prefill)
    from repro_torch.models.steps import _copy_prefix_cache
    cfg = get_config(arch, smoke=True, dtype=torch.float32)
    cpu = init_params(torch.Generator().manual_seed(0), cfg)
    gpu = copy.deepcopy(cpu).to("cuda")
    B, S, steps, frames = 2, 21, 20, 12
    batch = zoo_batch(torch, cfg, B, S, torch.Generator().manual_seed(2),
                      frames)
    card = {k: v.cuda() for k, v in batch.items()}
    S0 = S + (cfg.num_patches if cfg.frontend == "patch" else 0)
    src = frames if cfg.enc_layers else 0
    want, pre = make_prefill(cfg)(cpu, batch)
    got, pre_card = make_prefill(cfg)(gpu, card)
    err = compare(torch, got.cpu(), want, 1e-4, 1e-4)
    caches = {"cpu": _copy_prefix_cache(pre, init_cache(
                  cfg, B, S0 + steps, src_len=src, device="cpu")),
              "cuda": _copy_prefix_cache(pre_card, init_cache(
                  cfg, B, S0 + steps, src_len=src, device="cuda"))}
    decode = make_decode_step(cfg)
    rng = np.random.default_rng(3)
    for i in range(steps):
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, 1)))
        want, _ = decode(cpu, caches["cpu"], toks, S0 + i)
        got, _ = decode(gpu, caches["cuda"], toks.cuda(), S0 + i)
        err = max(err, compare(torch, got.cpu(), want, 1e-4, 1e-4))
    host = greedy_generate(cfg, cpu, batch, 12)
    on_card = greedy_generate(cfg, gpu, card, 12).cpu()
    require(torch.equal(on_card, host),
            f"{arch}: greedy tokens differ: card {on_card.tolist()} vs CPU "
            f"{host.tolist()}")
    return err


def zoo_generate(torch, arch: str, B: int, S: int, steps: int,
                 overrides: dict | None = None, params=None,
                 label: str = "14/16 zoo.generate") -> dict:
    """`greedy_generate` at full width in bf16 (the FULL config with
    `overrides`, a cut of its depth or a knob, if any; on `params`, or
    weights drawn from seed 0) with its prefill timed alone first; the
    launches of the generate run, required exactly.  Returns them."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssm_scan as ss
    from repro_torch.models import greedy_generate, init_params, make_prefill
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(arch, smoke=False, **(overrides or {}))
    if params is None:
        params = init_params(torch.Generator(device="cuda").manual_seed(0),
                             cfg)
    batch = zoo_batch(torch, cfg, B, S,
                      torch.Generator(device="cuda").manual_seed(1),
                      ZOO2_FRAMES)
    prefill = make_prefill(cfg)
    prefill(params, batch)                           # warm-up
    torch.cuda.synchronize()
    t = time.perf_counter()
    logits, cache = prefill(params, batch)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t) * 1e3
    require(tuple(logits.shape) == (B, cfg.padded_vocab)
            and bool(torch.isfinite(logits).all()),
            f"{arch}: bad prefill logits")
    rows = {k: tuple(v.shape) for k, v in cache[0].items()}
    del logits, cache
    da.launches = fa.launches = ss.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = greedy_generate(cfg, params, batch, steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    n = {"flash_attention": fa.launches, "decode_attention": da.launches,
         "ssm_scan": ss.launches}
    want = zoo_want(cfg, steps)
    require(n == want, f"{arch}: launches {n}; want {want}")
    require(tuple(out.shape) == (B, steps + 1) and bool(
        ((out >= 0) & (out < cfg.vocab_size)).all()),
        f"{arch}: generated ids of the wrong shape or outside the "
        "vocabulary")
    phase(label, config=f"{arch}/FULL/bf16",
          layers=cfg.num_layers, batch=B, prompt_tokens=S,
          patches=cfg.num_patches if cfg.frontend == "patch" else 0,
          source_frames=ZOO2_FRAMES if cfg.enc_layers else 0,
          decode_steps=steps, new_tokens=B * (steps + 1),
          prefill_ms=f"{prefill_ms:.2f}",
          decode_ms_per_step=f"{(wall * 1e3 - prefill_ms) / steps:.2f}",
          tokens_per_s=f"{B * (steps + 1) / wall:.1f}",
          wall_s=f"{wall:.2f}", launches=n, prefill_cache=rows,
          params=cfg.param_count(), active_params=cfg.active_param_count(),
          peak_mem_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}")
    del params, batch, out
    return n


def zoo_serve(torch) -> int:
    """granite-moe-1b-a400m FULL: `serve.run` alone and with `share=True`
    (AdamW steps of a second copy, the loss with the MoE aux), then the
    serving engine with ragged requests.  Returns the decode kernel's
    launches of the three."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.serve import run
    from repro_torch.models import init_params
    arch = "granite-moe-1b-a400m"
    cfg = get_config(arch, smoke=False)
    total = 0
    for share in (False, True):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        da.launches = fa.launches = 0
        t = time.perf_counter()
        res = run(arch, smoke=False, batch=8, kv_cap=4096,
                  requests=SERVE_REQUESTS, share=share, device="cuda")
        wall = time.perf_counter() - t
        n = da.launches
        require(n == cfg.num_layers * res["decode_steps"] and fa.launches == 0,
                f"share={share}: {n} decode launches for "
                f"{res['decode_steps']} steps, flash {fa.launches}")
        require(res["served"] >= 1, f"share={share}: nothing served")
        if share:
            require(res["offline_steps"] >= 1, "no offline step ran")
            require(res["train_steps_done"] == res["offline_steps"] + 2,
                    f"train steps {res['train_steps_done']} for "
                    f"{res['offline_steps']} offline steps")
        total += n
        phase("14/16 zoo.serve", config=f"{arch}/FULL/bf16", share=share,
              batch=8, kv_cap=4096, requests=SERVE_REQUESTS,
              base_ms=res["base_ms"], p50_ms=res["p50_ms"],
              p99_ms=res["p99_ms"], served=res["served"],
              evicted=res["served"] < SERVE_REQUESTS,
              offline_steps=res["offline_steps"],
              offline_duty=res["offline_duty"], oversold=res["oversold"],
              train_steps_done=res["train_steps_done"],
              decode_steps=res["decode_steps"], launches=n,
              peak_mem_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}",
              wall_s=f"{wall:.1f}")
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(arch, smoke=False, num_layers=GRANITE_CUT)
    params = init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    total += zoo_engine(torch, cfg, params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return total


def zoo_engine(torch, cfg, params, kv_capacity: int = 4096) -> int:
    """The serving engine over `params` at full width (8 slots, capacity
    `kv_capacity`) with 12 ragged requests; the decode kernel's launches
    required exactly, once an attention layer a step.  Returns them."""
    import numpy as np

    from repro_torch.kernels import decode_attention as da
    from repro_torch.serving.engine import (EngineConfig, ServeRequest,
                                            ServingEngine)
    eng = ServingEngine(cfg, params, EngineConfig(num_slots=8,
                                                  kv_capacity=kv_capacity))
    rng = np.random.default_rng(0)
    reqs = [ServeRequest(i, rng.integers(0, cfg.vocab_size,
                                         int(rng.integers(8, 65))),
                         max_new_tokens=int(rng.integers(4, 17)))
            for i in range(12)]
    for req in reqs:
        eng.submit(req)
    da.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    eng.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    n = da.launches
    require(n == attn_layers(cfg) * eng.steps,
            f"engine: {n} launches for {eng.steps} steps")
    new = sum(len(r.output) for r in reqs)
    require(all(len(r.output) == r.max_new_tokens for r in reqs) and all(
        0 <= tok < cfg.vocab_size for r in reqs for tok in r.output),
        "engine output has the wrong length or ids out of the vocabulary")
    phase("14/16 zoo.engine", config=f"{cfg.name}/FULL/bf16",
          layers=cfg.num_layers, slots=8, kv_capacity=kv_capacity,
          requests=len(reqs), decode_steps=eng.steps, new_tokens=new,
          tokens_per_s=f"{new / wall:.1f}", wall_s=f"{wall:.2f}",
          launches=n)
    return n


# deepseek-v2-lite-16b (MLA, 64 experts top 6 + 2 shared) at full width and
# depth: (batch, prompt tokens, decode steps) of its generate run, and
# (batch, tokens) of its eval step
DEEPSEEK = "deepseek-v2-lite-16b"
DEEPSEEK_GENERATE = (2, 2048, 31)
DEEPSEEK_EVAL = (2, 512)


def zoo_deepseek(torch) -> dict:
    """deepseek-v2-lite-16b FULL in bf16 on one set of weights:
    `greedy_generate` (flash once a layer, decode once a layer a step, on
    MLA's padded-v route), the serving engine with ragged requests, and the
    eval step with its moe_aux (its AdamW state does not fit one card).
    Returns the kernels' launches."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(DEEPSEEK, smoke=False)
    t = time.perf_counter()
    params = init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    n = zoo_generate(torch, DEEPSEEK, *DEEPSEEK_GENERATE, params=params)
    n["decode_attention"] += zoo_engine(torch, cfg, params)
    zoo_eval(torch, cfg, params, *DEEPSEEK_EVAL, init_params_s=init_s)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return n


def zoo_eval(torch, cfg, params, B: int, S: int, **fields) -> None:
    """The eval step at full width with its moe_aux, for a model whose
    AdamW state does not fit one card: timed after a warm-up, and its loss
    and ce equal to `loss_fn`'s, which gives the aux.  `fields` (floats)
    are printed beside."""
    from repro_torch.models import loss_fn, make_eval_step
    torch.cuda.reset_peak_memory_stats()
    batch = zoo_batch(torch, cfg, B, S,
                      torch.Generator(device="cuda").manual_seed(3), 0)
    eval_step = make_eval_step(cfg)
    eval_step(params, batch)                         # warm-up
    torch.cuda.synchronize()
    t = time.perf_counter()
    got = eval_step(params, batch)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3
    with torch.no_grad():
        loss, (ce, aux) = loss_fn(params, cfg, batch)
    loss, ce, aux = float(loss), float(ce), float(aux)
    require(all(math.isfinite(x) for x in (loss, ce, aux)) and aux > 0,
            f"{cfg.name}: eval {got}, loss {loss}, ce {ce}, moe_aux {aux}")
    require(loss == float(got["loss"]) and ce == float(got["ce"]),
            f"{cfg.name}: loss_fn {loss}, {ce} against eval step {got}")
    p = cfg.param_count()
    # bf16 weights and gradients, fp32 m and v (the port's AdamW)
    phase("14/16 zoo.train", config=f"{cfg.name}/FULL/bf16",
          layers=cfg.num_layers, via="make_eval_step", batch=B, seq=S,
          loss=loss, ce=ce, moe_aux=aux, step_ms=f"{ms:.2f}",
          **{k: f"{v:.2f}" for k, v in fields.items()},
          params=p, active_params=cfg.active_param_count(),
          adamw_state_gb=f"{12 * p / 1e9:.1f}",
          train_step="not_run:adamw_state_past_80GB",
          peak_mem_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}")


# jamba-1.5-large-398b at full width over the first JAMBA_CUT layers of its
# super-block, in its own order: (mamba, dense), (mamba, moe), (mamba,
# dense), (mamba, moe), (attn, dense); 24.0e9 parameters, 44.8 GiB in bf16.
# (batch, prompt tokens, decode steps) of its generate run, the engine's
# capacity, and (batch, tokens) of its eval step
JAMBA = "jamba-1.5-large-398b"
JAMBA_CUT = 5
JAMBA_GENERATE = (1, 4096, 31)
JAMBA_ENGINE_CAP = 256
JAMBA_EVAL = (1, 512)


def zoo_jamba(torch) -> dict:
    """jamba-1.5-large-398b's five-layer cut at FULL width in bf16 on one
    set of weights: `greedy_generate` (the scan once a Mamba layer in the
    prefill, flash once, decode once a step), the serving engine with
    ragged requests, and the eval step with its moe_aux.  Returns the
    kernels' launches."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    pattern = get_config(JAMBA).pattern
    cut = {"num_layers": JAMBA_CUT, "pattern": pattern[:JAMBA_CUT]}
    cfg = get_config(JAMBA, **cut)
    t = time.perf_counter()
    params = init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    init_peak = torch.cuda.max_memory_allocated() / 2**30
    n = zoo_generate(torch, JAMBA, *JAMBA_GENERATE, overrides=cut,
                     params=params)
    n["decode_attention"] += zoo_engine(torch, cfg, params,
                                        kv_capacity=JAMBA_ENGINE_CAP)
    zoo_eval(torch, cfg, params, *JAMBA_EVAL, init_params_s=init_s,
             init_peak_mem_gib=init_peak)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return n


def zoo_train(torch) -> None:
    """granite-moe-1b-a400m FULL through the train launcher (AdamW, B2 x
    512) and one train step's metrics (loss, ce, moe_aux); three AdamW
    steps of seamless-m4t-medium FULL on batches with source frames; the
    eval step of pixtral-12b FULL (its AdamW state does not fit one card)."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.launch import train
    from repro_torch.models import init_params, make_eval_step, make_train_step
    from repro_torch.optim import AdamW, AdamWConfig
    B, S = 2, ZOO2_TRAIN_SEQ
    arch = "granite-moe-1b-a400m"
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    out = train.run(arch, smoke=False, steps=3, batch=B, seq=S, log_every=1,
                    device="cuda")
    wall = time.perf_counter() - t
    require(out["steps_done"] == 3 and all(
        math.isfinite(v) for v in out["losses"]), f"train.run {out}")
    phase("14/16 zoo.train", config=f"{arch}/FULL/bf16", via="launch.train",
          optimizer="AdamW", batch=B, seq=S, losses=out["losses"],
          wall_s=f"{wall:.2f}",
          peak_mem_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}")
    gc.collect()
    torch.cuda.empty_cache()
    for arch, steps in ((arch, 1), ("seamless-m4t-medium", 3)):
        torch.cuda.reset_peak_memory_stats()
        cfg = get_config(arch, smoke=False)
        params = init_params(torch.Generator(device="cuda").manual_seed(1),
                             cfg)
        opt = AdamW(AdamWConfig(lr=1e-4, total_steps=100))
        state = opt.init(params.parameters())
        step = make_train_step(cfg, opt)
        pipe = TokenPipeline(DataConfig(cfg.vocab_size, S, B))
        gen = torch.Generator(device="cuda").manual_seed(2)
        metrics, ms = [], []
        for i in range(steps):
            batch = pipe.batch_at(i)
            if cfg.enc_layers:
                batch["src_embeds"] = torch.randn(
                    B, ZOO2_FRAMES, cfg.d_model, generator=gen,
                    device="cuda")
            torch.cuda.synchronize()
            t = time.perf_counter()
            params, state, m = step(params, state, batch)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
            metrics.append({k: float(m[k]) for k in ("loss", "ce",
                                                     "moe_aux")})
        require(all(math.isfinite(v) for m in metrics for v in m.values()),
                f"{arch}: train metrics {metrics}")
        if cfg.num_experts:
            require(all(m["moe_aux"] > 0 for m in metrics),
                    f"{arch}: no MoE aux loss {metrics}")
        phase("14/16 zoo.train", config=f"{arch}/FULL/bf16",
              via="make_train_step", optimizer="AdamW", batch=B, seq=S,
              source_frames=ZOO2_FRAMES if cfg.enc_layers else 0,
              metrics=metrics, step_ms=ms,
              peak_mem_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}")
        del params, state
        gc.collect()
        torch.cuda.empty_cache()
    arch = "pixtral-12b"
    cfg = get_config(arch, smoke=False)
    torch.cuda.reset_peak_memory_stats()
    params = init_params(torch.Generator(device="cuda").manual_seed(1), cfg)
    batch = zoo_batch(torch, cfg, 1, 1024,
                      torch.Generator(device="cuda").manual_seed(3), 0)
    torch.cuda.synchronize()
    t = time.perf_counter()
    got = make_eval_step(cfg)(params, batch)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3
    require(all(math.isfinite(float(v)) for v in got.values()),
            f"{arch}: eval {got}")
    n = cfg.param_count()
    # bf16 weights and gradients, fp32 m and v (the port's AdamW)
    phase("14/16 zoo.train", config=f"{arch}/FULL/bf16", via="make_eval_step",
          batch=1, patches=cfg.num_patches, seq=1024,
          loss=float(got["loss"]), ce=float(got["ce"]), step_ms=ms,
          adamw_state_gb=f"{12 * n / 1e9:.1f}",
          train_step="not_run:adamw_state_past_80GB",
          peak_mem_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}")
    del params, batch
    gc.collect()
    torch.cuda.empty_cache()


def phase_zoo(torch) -> dict:
    """The zoo past phase 7: pixtral-12b, seamless-m4t-medium,
    granite-moe-1b-a400m, deepseek-v2-lite-16b and jamba-1.5-large-398b:
    parity of the card with the CPU at SMOKE, then generation, serving and
    training or eval at full width; then one line of the seconds each
    model's part took.  Returns the kernels' launches of the generate runs,
    granite's serving and the engines."""
    import numpy as np
    seconds = {}

    def timed(arch, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        seconds[arch] = seconds.get(arch, 0.0) + time.perf_counter() - t
        return out

    for arch in [g[0] for g in ZOO2_GENERATE] + [DEEPSEEK, JAMBA]:
        err = timed(arch, zoo_parity, torch, arch)
        phase("14/16 zoo.parity", config=f"{arch}/SMOKE/fp32", batch=2,
              prompt=21, decode_steps=20, greedy_steps=12,
              logits_max_abs_err=f"{err:.3e}", tol="1e-4",
              greedy_tokens="equal")
    # the engine under ragged slots, and decode at ragged positions
    for arch in ("granite-moe-1b-a400m", DEEPSEEK, JAMBA):
        err = timed(arch, parity, torch, arch, [np.array([0, 3, 10, 40])], 6,
                    (2, 9), (2, 6))
        phase("14/16 zoo.parity", config=f"{arch}/SMOKE/fp32",
              decode="ragged_pos", logits_max_abs_err=f"{err:.3e}",
              tol="1e-4", engine_tokens="equal")
    total = {"decode_attention": 0, "flash_attention": 0, "ssm_scan": 0}
    for arch, B, S, steps, cut in ZOO2_GENERATE:
        for k, n in timed(arch, zoo_generate, torch, arch, B, S, steps,
                          cut).items():
            total[k] += n
    gc.collect()
    torch.cuda.empty_cache()
    granite = "granite-moe-1b-a400m"
    total["decode_attention"] += timed(granite, zoo_serve, torch)
    timed("zoo_train", zoo_train, torch)
    for arch, fn in ((DEEPSEEK, zoo_deepseek), (JAMBA, zoo_jamba)):
        for k, n in timed(arch, fn, torch).items():
            total[k] += n
    phase("14/16 zoo.seconds", **{a: f"{t:.1f}" for a, t in seconds.items()})
    return total


# phase 15: `repro`'s ModelConfig knobs at published widths.  (batch,
# tokens, AdamW steps) of h2o-danube-1.8b's train through the launcher;
# (batch, tokens) of its remat on/off comparison; gemma-7b with Gemma 2's
# cap: (batch, prompt, steps) of its generate, (batch, tokens) of its eval
# step with and without the fused loss, and the layers of the cut whose
# train step (B1 x 8192) is compared fused and unfused
KNOBS_TRAIN = (1, 8192, 2)
KNOBS_REMAT = (1, 2048)
KNOBS_GENERATE = (1, 2048, 31)
KNOBS_EVAL = (1, 8192)
KNOBS_CUT = 2
GEMMA_CAP = 50.0


def grads_of(torch, cfg, params, batch) -> tuple:
    """(loss, every weight's gradient) of `loss_fn` under autograd."""
    from repro_torch.models import loss_fn
    weights = list(params.parameters())
    with torch.enable_grad():
        for w in weights:
            w.requires_grad_(True)
        try:
            loss, _ = loss_fn(params, cfg, batch)
            grads = torch.autograd.grad(loss, weights)
        finally:
            for w in weights:
                w.requires_grad_(False)
    return loss.detach(), grads


def rel_norm(torch, got, want) -> float:
    """||got - want|| / ||want|| over every tensor of the two lists, fp32."""
    num = den = 0.0
    for g, w in zip(got, want):
        num += float(((g.float() - w.float()) ** 2).sum())
        den += float((w.float() ** 2).sum())
    return math.sqrt(num / den)


def timed_run(torch, fn, *args):
    """(fn(*args), ms, peak GiB) on the card, from a fresh peak."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    return (out, (time.perf_counter() - t) * 1e3,
            torch.cuda.max_memory_allocated() / 2**30)


@contextlib.contextmanager
def plain_kernels():
    """The attention kernels' entry points replaced by their plain versions
    for the block (on CUDA tensors too): the model's path with no kernel."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    saved = da.decode_attention_cuda, fa.flash_attention_cuda
    da.decode_attention_cuda = da.decode_attention_plain
    fa.flash_attention_cuda = fa.flash_attention_plain
    try:
        yield
    finally:
        da.decode_attention_cuda, fa.flash_attention_cuda = saved


def knobs_train(torch) -> None:
    """h2o-danube-1.8b FULL, all 24 layers, two AdamW steps at B1 x 8192
    through `launch.train.run`: remat on (the default) and the attention
    streamed over KV chunks (8192**2 scores a head pass 4096**2); finite
    losses, the launcher's ms a step, the peak."""
    import io

    from repro_torch.launch import train
    from repro_torch.models import layers as L
    B, S, steps = KNOBS_TRAIN
    require(L.chunked(S, S), f"S {S} is not past the materialise limit")
    calls = []

    def count(inner):
        def run(*args, **kw):
            calls.append(1)
            return inner(*args, **kw)
        return run

    buf = io.StringIO()
    with wrapped(L, "attention_chunked", count), \
            contextlib.redirect_stdout(buf):
        out, ms, peak = timed_run(torch, lambda: train.run(
            "h2o-danube-1.8b", smoke=False, steps=steps, batch=B, seq=S,
            log_every=1, device="cuda"))
    log = buf.getvalue()
    print(log, end="", flush=True)
    require(out["steps_done"] == steps and all(
        math.isfinite(x) for x in out["losses"]), f"train.run {out}")
    require(calls, "the attention was not streamed over KV chunks")
    phase("15/16 knobs.train", config="h2o-danube-1.8b/FULL/bf16",
          via="launch.train", optimizer="AdamW", batch=B, seq=S,
          steps=steps, remat=True, attention="chunked",
          attention_chunked_calls=len(calls), losses=out["losses"],
          ms_per_step_launcher=re.findall(r"\((\d+) ms/step\)", log),
          wall_s=f"{ms / 1e3:.2f}", peak_mem_gib=f"{peak:.2f}")


def knobs_remat(torch) -> None:
    """h2o-danube-1.8b FULL on one set of weights.  At B1 x 2048, where both
    fit: one gradient with remat on and off; the loss equal, the gradients
    within the fp32 limit by relative norm (the embedding's backward
    accumulates in an order of its own); both peaks and times.  At B1 x
    8192 (the attention streamed over KV chunks): one gradient with the
    chunks that the causal mask and the window hide from a whole query
    chunk skipped, as the model runs, and with every chunk computed, as
    `repro` does; the loss equal, the gradients within the same limit;
    both times."""

    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.models import layers as L
    cfg = get_config("h2o-danube-1.8b")
    params = init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    B, S = KNOBS_REMAT
    batch = zoo_batch(torch, cfg, B, S,
                      torch.Generator(device="cuda").manual_seed(4), 0)
    runs = {}
    for remat in (True, False):
        c = dataclasses.replace(cfg, remat=remat)
        grads_of(torch, c, params, batch)                 # warm-up
        runs[remat] = timed_run(torch, grads_of, torch, c, params, batch)
    (lon, gon), ms_on, peak_on = runs[True]
    (loff, goff), ms_off, peak_off = runs[False]
    rel = rel_norm(torch, gon, goff)
    require(float(lon) == float(loff), f"remat loss {float(lon)} against "
            f"{float(loff)} without")
    require(rel <= 2e-5, f"remat gradients {rel:.3e} off by relative norm")
    phase("15/16 knobs.remat", config="h2o-danube-1.8b/FULL/bf16", batch=B,
          seq=S, loss=float(lon), loss_equal=True,
          grads_rel_norm=f"{rel:.3e}", tol="2e-5",
          ms_remat_on=f"{ms_on:.1f}", ms_remat_off=f"{ms_off:.1f}",
          peak_mem_gib_remat_on=f"{peak_on:.2f}",
          peak_mem_gib_remat_off=f"{peak_off:.2f}")
    del gon, goff, runs
    B, S = KNOBS_TRAIN[:2]
    batch = zoo_batch(torch, cfg, B, S,
                      torch.Generator(device="cuda").manual_seed(6), 0)
    calls, runs = {}, {}

    def count(skip):
        def wrap(inner):
            def run(*args, **kw):
                calls[skip] = calls.get(skip, 0) + 1
                return inner(*args, **kw)
            return run
        return wrap

    # skipped first: what the first run pays for shapes new to the process
    # falls on the skip
    for skip in (True, False):
        with wrapped(L, "_kv_chunk", count(skip)), (
                contextlib.nullcontext() if skip else
                wrapped(L, "_visible_chunks", lambda inner: lambda *a: None)):
            runs[skip] = timed_run(torch, grads_of, torch, cfg, params, batch)
    (ls, gs), ms_skip, _ = runs[True]
    (la, ga), ms_all, _ = runs[False]
    rel = rel_norm(torch, gs, ga)
    require(float(ls) == float(la), f"skipping chunks: loss {float(ls)} "
            f"against {float(la)} over every chunk")
    require(rel <= 2e-5, f"skipping chunks: gradients {rel:.3e} off")
    phase("15/16 knobs.skip", config="h2o-danube-1.8b/FULL/bf16", batch=B,
          seq=S, remat=True, loss=float(ls), loss_equal=True,
          grads_rel_norm=f"{rel:.3e}", tol="2e-5",
          kv_chunk_calls_skipping=calls[True],
          kv_chunk_calls_every=calls[False],
          ms_skipping=f"{ms_skip:.1f}", ms_every_chunk=f"{ms_all:.1f}")
    del params, gs, ga, runs


def knobs_gemma(torch) -> dict:
    """gemma-7b FULL (28 layers) with Gemma 2's cap of 50: `greedy_generate`
    B1 x 2048, 31 steps, launches exact (flash 28, decode 868: the cap
    reaches every self-attention layer, MHA on a plain cache); the first
    decode step's logits against the same step with both kernels replaced
    by their plain versions on the card (2e-2 by relative norm); the eval
    step at B1 x 8192 (attention streamed over KV chunks) with and without
    the fused loss (1e-3 relative), both peaks.  Beside the first decode
    step's gap: each layer's output against the plain path's (where the
    gap comes from), the same without the cap, the largest score the
    decode attention meets and how far the cap moves the logits.  Returns
    the generate run's launches."""

    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models import (init_cache, init_params,
                                    make_decode_step, make_eval_step,
                                    make_prefill, model)
    from repro_torch.models import layers as L
    from repro_torch.models.steps import _copy_prefix_cache
    arch = "gemma-7b"
    cfg = get_config(arch, softcap=GEMMA_CAP)
    params = init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    B, S, steps = KNOBS_GENERATE
    n = zoo_generate(torch, arch, B, S, steps,
                     overrides={"softcap": GEMMA_CAP}, params=params,
                     label="15/16 knobs.generate")
    require(n == {"flash_attention": 28, "decode_attention": 868,
                  "ssm_scan": 0}, f"gemma-7b capped launches {n}")
    batch = zoo_batch(torch, cfg, B, S,
                      torch.Generator(device="cuda").manual_seed(1), 0)
    tok = torch.randint(
        0, cfg.vocab_size, (B, 1), device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(2))

    saved = da.launches, fa.launches
    rels, layers, logits, score = {}, {}, {}, [0.0]

    def record(out: list):
        """`_ffn` that keeps each layer's output (the residual stream)."""
        def wrap(inner):
            def run(*args, **kw):
                x, aux = inner(*args, **kw)
                out.append(x.float())
                return x, aux
            return run
        return wrap

    def scores(inner):
        """`ops.decode_attention` that keeps the largest |q.k/sqrt(d)|."""
        def run(q, k, v, *args, **kw):
            G = q.shape[2] // k.shape[2]
            s = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                             L.repeat_kv(k, G).float()) / math.sqrt(
                                 q.shape[-1])
            score[0] = max(score[0], float(s.abs().max()))
            return inner(q, k, v, *args, **kw)
        return run

    def first_step(c, hid: list):
        """The first decode step's logits; each layer's output in `hid`."""
        _, cache = make_prefill(c)(params, batch)
        cache = _copy_prefix_cache(cache, init_cache(c, B, S + 1,
                                                     device="cuda"))
        with wrapped(model, "_ffn", record(hid)), \
                wrapped(ops, "decode_attention", scores):
            return make_decode_step(c)(params, cache, tok, S)[0].float()

    for c in (cfg, dataclasses.replace(cfg, softcap=None)):
        runs = []
        for plain in (False, True):
            hid = []
            with plain_kernels() if plain else contextlib.nullcontext():
                runs.append((first_step(c, hid), hid))
        (got, hg), (want, hw) = runs
        require(bool(torch.isfinite(got).all()), "non-finite logits")
        rels[c.softcap] = float((got - want).norm() / want.norm())
        layers[c.softcap] = [float((a - b).norm() / b.norm())
                             for a, b in zip(hg, hw)]
        logits[c.softcap] = got
        del want, hg, hw, runs
    da.launches, fa.launches = saved     # launches to compare do not count
    rel = rels[GEMMA_CAP]
    cap_moves = float((logits[GEMMA_CAP] - logits[None]).norm()
                      / logits[None].norm())
    del logits
    require(len(layers[GEMMA_CAP]) == cfg.num_layers,
            f"{len(layers[GEMMA_CAP])} layers recorded")
    require(rel <= 2e-2,
            f"capped decode step {rel:.3e} from its plain version")
    # this check holds the path through the kernels, not the cap: with
    # random weights the scores stay far below 50, and the cap moves the
    # logits about as far as the layers' rounding does, within the limit
    # (capped_vs_uncapped); phase 3 holds the cap, at scores past it
    phase("15/16 knobs.generate", config=f"{arch}/FULL/bf16",
          softcap=GEMMA_CAP, step="first_decode", against="plain_versions",
          logits_rel_norm=f"{rel:.3e}", tol="2e-2",
          uncapped_logits_rel_norm=f"{rels[None]:.3e}",
          layer_rel_norm="|".join(f"{x:.1e}" for x in layers[GEMMA_CAP]),
          uncapped_layer_rel_norm="|".join(f"{x:.1e}"
                                           for x in layers[None]),
          max_abs_score=f"{score[0]:.2f}",
          capped_vs_uncapped_logits_rel_norm=f"{cap_moves:.3e}")
    B, S = KNOBS_EVAL
    batch = zoo_batch(torch, cfg, B, S,
                      torch.Generator(device="cuda").manual_seed(3), 0)
    evals = {}
    for fused in (True, False):
        c = dataclasses.replace(cfg, fused_loss=fused)
        got, ms, peak = timed_run(torch, make_eval_step(c), params, batch)
        evals[fused] = (float(got["loss"]), ms, peak)
    (lf, msf, pf), (lu, msu, pu) = evals[True], evals[False]
    require(math.isfinite(lf) and abs(lf - lu) <= 1e-3 * abs(lu),
            f"fused eval loss {lf} against {lu}")
    phase("15/16 knobs.eval", config=f"{arch}/FULL/bf16", softcap=GEMMA_CAP,
          batch=B, seq=S, attention="chunked", loss_fused=lf,
          loss_unfused=lu, rel_diff=f"{abs(lf - lu) / abs(lu):.3e}",
          tol="1e-3", ms_fused=f"{msf:.1f}", ms_unfused=f"{msu:.1f}",
          peak_mem_gib_fused=f"{pf:.2f}", peak_mem_gib_unfused=f"{pu:.2f}")
    del params, batch
    gc.collect()
    torch.cuda.empty_cache()
    return n


def knobs_gemma_cut(torch) -> None:
    """gemma-7b at full width cut to its first KNOBS_CUT layers (2.1e9
    parameters; FULL's AdamW state does not fit): a train step's loss and
    gradients at B1 x 8192 with the cap, the fused loss and remat against
    the same step unfused (1e-3 relative, 2e-2 by relative norm), then one
    AdamW step fused."""

    from repro_torch.configs import get_config
    from repro_torch.models import init_params, make_train_step
    from repro_torch.optim import AdamW, AdamWConfig
    arch = "gemma-7b"
    cfg = get_config(arch, num_layers=KNOBS_CUT, softcap=GEMMA_CAP,
                     fused_loss=True)
    params = init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    B, S = KNOBS_EVAL
    batch = zoo_batch(torch, cfg, B, S,
                      torch.Generator(device="cuda").manual_seed(5), 0)
    (lf, gf), msf, pf = timed_run(torch, grads_of, torch, cfg, params, batch)
    (lu, gu), msu, pu = timed_run(torch, grads_of, torch, dataclasses.replace(
        cfg, fused_loss=False), params, batch)
    lf, lu = float(lf), float(lu)
    rel = rel_norm(torch, gf, gu)
    del gf, gu
    require(abs(lf - lu) <= 1e-3 * abs(lu), f"fused loss {lf} against {lu}")
    require(rel <= 2e-2, f"fused gradients {rel:.3e} off by relative norm")
    opt = AdamW(AdamWConfig(lr=1e-4, total_steps=10))
    state = opt.init(list(params.parameters()))
    (_, _, m), ms, peak = timed_run(torch, make_train_step(cfg, opt), params,
                                    state, batch)
    require(math.isfinite(float(m["loss"])), f"train step {m}")
    phase("15/16 knobs.train", config=f"{arch}/FULL/bf16",
          layers=KNOBS_CUT, params=cfg.param_count(), softcap=GEMMA_CAP,
          remat=True, batch=B, seq=S, loss_fused=lf, loss_unfused=lu,
          loss_rel_diff=f"{abs(lf - lu) / abs(lu):.3e}", loss_tol="1e-3",
          grads_rel_norm=f"{rel:.3e}", grads_tol="2e-2",
          grad_ms_fused=f"{msf:.1f}", grad_ms_unfused=f"{msu:.1f}",
          peak_mem_gib_fused=f"{pf:.2f}", peak_mem_gib_unfused=f"{pu:.2f}",
          adamw_step_loss=float(m["loss"]), adamw_step_ms=f"{ms:.1f}",
          adamw_peak_mem_gib=f"{peak:.2f}")
    del params, state, batch
    gc.collect()
    torch.cuda.empty_cache()


def phase_knobs(torch) -> dict:
    """`repro`'s ModelConfig knobs at published widths, each part's seconds
    printed after.  Returns the kernels' launches of gemma-7b's capped
    generate run (a main path)."""
    seconds = {}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        seconds[name] = round(time.perf_counter() - t, 1)
        return out

    timed("train_danube_8192", knobs_train, torch)
    timed("danube_remat_2048_skip_8192", knobs_remat, torch)
    n = timed("gemma_capped", knobs_gemma, torch)
    timed("gemma_cut_train", knobs_gemma_cut, torch)
    phase("15/16 knobs.seconds", **seconds)
    return n


# phase 16: the example ports.  `torch_serve_multiplex` at full width in a
# child process, with its requests cut from the original's 150 so that its
# multiplexed run takes 10-15 s (the horizon grows by 1.2 offline steps,
# 0.47-0.67 s on the card, a request, and the signal lands at half of it);
# `torch_train_lm` at 40 steps
EXAMPLES = os.path.join(ROOT, "examples")
EXAMPLE_REQUESTS = 35
EXAMPLE_TRAIN_STEPS = 40
def serve_child(n_req: int) -> None:
    """The child of `examples_serve`: `torch_serve_multiplex` FULL on the
    card, with its set-up split into parts (each between two synchronizes:
    the imports, the CUDA context, each model's weight init, the AdamW
    moments, the first decode and the first train step), then its result,
    the split and the decode kernel's launches as one JSON line."""
    t = time.perf_counter()
    sys.path[:0] = [SRC, EXAMPLES]
    import torch
    split = {"import_torch": time.perf_counter() - t}
    t = time.perf_counter()
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as da
    if not _build.library_path("decode_attention").exists():
        sys.exit("decode_attention is not built")
    import torch_serve_multiplex as example
    split["import_example"] = time.perf_counter() - t
    t = time.perf_counter()
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    split["cuda_context"] = time.perf_counter() - t

    def timed(name, fn):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            split[name] = split.get(name, 0.0) + time.perf_counter() - t
            return out
        return call

    def first_call_timed(name, make):
        def made(*args, **kwargs):
            step = make(*args, **kwargs)
            calls = [timed(name, step)]
            return lambda *a, **k: (calls.pop() if calls else step)(*a, **k)
        return made

    init_params = example.init_params
    example.init_params = lambda gen, cfg: timed(
        f"init_params {cfg.name}", init_params)(gen, cfg)
    example.AdamW.init = timed("adamw_init", example.AdamW.init)
    example.make_decode_step = first_call_timed(
        "first_decode", example.make_decode_step)
    example.make_train_step = first_call_timed(
        "first_train_step", example.make_train_step)
    da.launches = 0
    t = time.perf_counter()
    out = example.main(smoke=False, n_req=n_req, device="cuda")
    out["main_s"] = time.perf_counter() - t
    out["split_s"] = split
    out["launches"] = da.launches
    out["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    print(json.dumps(out), flush=True)


def load_example(name: str):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", os.path.join(EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def examples_serve() -> int:
    """`torch_serve_multiplex` at full width in a child process: the SIGINT
    its timer sends is its own.  Returns the decode kernel's launches."""
    from repro_torch.kernels import _build
    lib = _build.library_path("decode_attention")
    built_at = lib.stat().st_mtime_ns
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [SRC] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    t = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", f"import chip_smoke; "
         f"chip_smoke.serve_child({EXAMPLE_REQUESTS})"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    wall = time.perf_counter() - t
    for line in proc.stdout.splitlines()[:-1]:
        print(f"    | {line}", flush=True)
    require(proc.returncode == 0, f"serve_multiplex exited "
            f"{proc.returncode}: {proc.stderr[-2000:]}")
    require(lib.stat().st_mtime_ns == built_at,
            "the child rebuilt the decode kernel")
    out = json.loads(proc.stdout.splitlines()[-1])
    require(out["smoke"] is False and out["n_req"] == EXAMPLE_REQUESTS,
            "not the full-width run")
    require(out["triggered"] == "sigint", "the SIGINT did not land: "
            f"run {out['run_wall_s']:.2f} s of wall against a timer at half "
            f"the {out['horizon_s']:.2f} s horizon")
    require(out["frozen"] is True, "offline launches not frozen")
    require(out["checkpoint_step"] is not None and out["releases"] == 1,
            f"checkpoint step {out['checkpoint_step']}, "
            f"{out['releases']} releases")
    require(out["offline_steps_after_signal"] == 0,
            f"{out['offline_steps_after_signal']} offline steps after the "
            "signal")
    require(out["online_steps_after_signal"] >= 1 or out["evicted"],
            "the online side served nothing after the signal")
    require(out["launches"] == 24 * out["decode_calls"],
            f"{out['launches']} decode launches for {out['decode_calls']} "
            "decode calls of 24 layers")
    phase("16/16 examples.serve_multiplex",
          config="h2o-danube-1.8b/FULL/bf16+granite-moe-1b-a400m/FULL/bf16",
          batch=8, capacity=128, n_req=out["n_req"],
          cut=f"n_req 150->{EXAMPLE_REQUESTS}", base_ms=out["base_ms"],
          offline_step_ms=out["offline_step_ms"], p50_ms=out["p50_ms"],
          p99_ms=out["p99_ms"], served=out["served"],
          offline_steps=out["offline_steps"], duty=out["offline_duty"],
          oversold=out["oversold"], evicted=out["evicted"],
          slo_violations=out["slo_violations"],
          signal=out["triggered"], frozen=out["frozen"],
          signal_step=out["checkpoint_step"],
          signal_wall_s=f"{out['signal_wall_s']:.2f}",
          online_steps_after_signal=out["online_steps_after_signal"],
          offline_steps_after_signal=out["offline_steps_after_signal"],
          releases=out["releases"], horizon_s=f"{out['horizon_s']:.2f}",
          run_wall_s=f"{out['run_wall_s']:.2f}",
          setup_s=f"{out['main_s'] - out['run_wall_s']:.2f}",
          split_s=json.dumps({k: round(v, 3)
                              for k, v in out["split_s"].items()}),
          decode_calls=out["decode_calls"], launches=out["launches"],
          peak_mem_gib=f"{out['peak_mem_gib']:.2f}",
          child_wall_s=f"{wall:.1f}")
    return out["launches"]


def examples_quickstart(torch) -> None:
    """`torch_quickstart` on the card: the predictor trained there, then
    Algorithm 1's plan."""
    t = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        out = load_example("torch_quickstart").main()
    torch.cuda.synchronize()
    plan = out["plan"]
    require(len(plan) == 4 and len({a[0] for a in plan}) == 4
            and sorted(a[1] for a in plan) == [0, 1, 2, 3],
            f"not a matching of the four jobs: {plan}")
    require(all(0.0 < a[3] <= 1.0 and 0.0 < a[2] <= 1.0 for a in plan)
            and math.isclose(out["total"], sum(a[3] for a in plan)),
            f"implausible plan {plan}")
    phase("16/16 examples.quickstart", device="cuda",
          plan=json.dumps([[a[0], a[1], round(a[2], 3), round(a[3], 4)]
                           for a in plan]),
          total=f"{out['total']:.4f}",
          wall_s=f"{time.perf_counter() - t:.1f}")


def examples_train_lm(torch) -> None:
    """`torch_train_lm` on the card: train, evict at half the steps, resume
    from the checkpoint, and the loss falls."""
    t = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        out = load_example("torch_train_lm").main(
            ["--steps", str(EXAMPLE_TRAIN_STEPS)])
    half = EXAMPLE_TRAIN_STEPS // 2
    first, last = out["phase1"], out["phase2"]
    require(out["resumed_from"] == half
            and first["steps_done"] == half
            and last["steps_done"] == EXAMPLE_TRAIN_STEPS - half,
            f"resumed from {out['resumed_from']} after "
            f"{first['steps_done']} steps, then {last['steps_done']}")
    require(last["final_loss"] < first["losses"][0], "the loss did not fall")
    phase("16/16 examples.train_lm", config="xlstm-350m/SMOKE",
          steps=EXAMPLE_TRAIN_STEPS, resumed_from=out["resumed_from"],
          loss_first=first["losses"][0], loss_at_evict=first["final_loss"],
          loss_final=last["final_loss"],
          wall_s=f"{time.perf_counter() - t:.1f}")


def phase_examples(torch) -> dict:
    """The four example ports' card paths (torch_cluster_sim's are phases
    11 and 12's).  Returns the kernels' launches of serve_multiplex's run
    (a main path)."""
    gc.collect()
    torch.cuda.empty_cache()
    n = examples_serve()
    examples_quickstart(torch)
    examples_train_lm(torch)
    return {"decode_attention": n}


def main() -> int:
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print("chip_smoke.py: src/repro_torch not found next to this script; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 2
    if shutil.which("nvidia-smi"):
        # the card's machine sets PYTHONDONTWRITEBYTECODE and its packages
        # ship no bytecode, so each process compiled torch's sources anew:
        # keep the bytecode in build/pycache, where the child processes of
        # phases 13 and 16 load what this process compiled
        sys.pycache_prefix = os.path.join(ROOT, "build", "pycache")
        sys.dont_write_bytecode = False
        os.environ["PYTHONPYCACHEPREFIX"] = sys.pycache_prefix
        os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    seconds = {}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        seconds[name] = round(time.perf_counter() - t, 1)
        return out

    kind, card = timed("device", phase_device, torch)
    timed("build", phase_build)
    max_err = timed("kernels", phase_kernels, torch)
    timed("parity", phase_parity, torch)
    serve = timed("serve", phase_serve, torch)
    shared = timed("share", phase_share, torch)
    generated = timed("generate", phase_generate, torch)
    launches, card_matrix, predictor = timed("profile", phase_profile, torch)
    launches["decode_attention"] += serve["decode_attention"] + shared
    for name, n in generated.items():
        launches[name] += n
    missing = [name for name, n in launches.items() if n == 0]
    require(not missing, f"kernels never launched on the main path: {missing}")
    timed("train", phase_train, torch)
    kernels = timed("timing", phase_timing, torch, launches, max_err)
    timed("fleet", phase_fleet, torch, card_matrix, predictor)
    control = timed("control", phase_control, torch)
    for kernel, n in control["launches"].items():
        next(k for k in kernels if k["name"] == kernel)["launches"] += n
    timed("durable", phase_durable, torch, control)
    zoo = timed("zoo", phase_zoo, torch)
    knobs = timed("knobs", phase_knobs, torch)
    examples = timed("examples", phase_examples, torch)
    for part in (zoo, knobs, examples):
        for kernel, n in part.items():
            next(k for k in kernels if k["name"] == kernel)["launches"] += n
    phase("seconds", **seconds, total=f"{sum(seconds.values()):.1f}")
    print(card, flush=True)        # again, where a cut tail of the log keeps it
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
