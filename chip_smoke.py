#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (``src/repro_torch``).

    python3 chip_smoke.py [--json PATH]

On one NVIDIA H100 (compute capability 9.0, ``nvcc`` on PATH or in
/usr/local/cuda) it:

1. build     — compiles the four kernels (``ibn_pointwise``, ``flash_attention``,
               ``ssd_scan``, ``gmm``) from the repository's sources (one ``nvcc``
               each, started together) and prints ptxas's report;
2. kernel    — at every distinct 1×1 shape of full-width MobileNetV2,
               EfficientNet-B0 (SE, swish) and the manual EdgeTPU model at
               224 px, batch 8, and of the search's MobileNetV2 space at the
               proxy's 32 px, batch 64, holds the kernel's forward and backward
               (dx, dw, db) against the plain PyTorch version on the card, its
               edges (K 960 and dw's K 16384 split over a cluster, ragged M and
               N, transposed views, bf16) with two controls that the limit
               must fail (the plain version without a cluster rank's K range,
               and without the last K step), and
               times kernel, plain version and ``torch.addmm`` + act as the host
               issues them (CUDA events around 20 calls), then on the device
               alone (CUDA graphs of 20 calls, in turns) the forward, dx and dw
               products against ``torch.addmm`` / ``torch.mm``, and the
               wrapper's host µs per call;
3. model     — the same three models at full width, 1000 classes, 224 px: the
               card's logits against the port's CPU forward on the same params,
               then 5 SGD steps of ``proxy.train_step`` at batch 16;
4. search    — the main path: ``SearchSession.joint`` over the full-width
               MobileNetV2 space with ``TrainedAccuracy`` and the PPO
               controller on the card;
5. runtime   — the sweep of the joint search over the constraint-modes
               preset (4 scenarios x 16 samples, PPO on the card,
               ``TrainedAccuracy(steps=20, batch=64)`` on the card: every 1×1
               convolution on ``ibn_pointwise``) through the durable runtime
               (``SearchRuntime.at``: a ``DurableRecordStore`` and a
               ``Checkpointer``): serially in this process, then with
               ``run_concurrent`` on 2 spawned worker processes, one of them
               hard-killed in the middle of a job (``REPRO_FAULTS``), each
               worker training its candidates on the card; the process
               sweep's histories and winners must be the serial sweep's
               bitwise, its recovery counters must show the respawn, the two
               stores must hold the same records by decision vector, and each
               worker that trained must have launched the kernel (an
               accuracy wrapper, ``RecordingAccuracy``, logs every process's
               pid, card and launch count); a budgeted run is interrupted and
               an unbudgeted resume completes it to the serial result, and a
               run over the finished store evaluates nothing; walls, each
               worker's ready time, the recovery counters, the store's hit
               rate and the launches in the parent and per worker;
6. serve_tier — the serve tier over the runtime phase's serial store (a
               copy, taken before that phase's directory goes): compacts it
               with ``snapshot_store`` twice (bitwise equal bytes), loads the
               snapshot verified and not, its records equal to
               ``load_store_frontier``'s, with a control that must fail (one
               payload byte flipped fails ``verify``); answers every
               registered scenario, the constraint-modes preset and 300
               seeded ad-hoc envelopes over the frontier's own ranges, tiled
               20 times and shuffled, each answer equal to
               ``brute_force_best``, with 0 evaluations and 0 kernel launches;
               then admits two envelopes below the frontier's least latency at
               once (``AdmissionController``, ``max_concurrent=2``, budget 16,
               batch 8, REINFORCE on the card, the durable store given) whose
               searches train their candidates with
               ``TrainedAccuracy(steps=40, batch=64)`` on the card (K1), folds
               them in, re-asks (no more admissions; answers equal brute
               force over the folded frontier), and holds each admitted
               search's history and store records bitwise against the same
               search run alone into a store of its own; snapshot build and
               load ms, cold JSONL reload ms, warm p50 / p99 µs, queries/s,
               cache hit rate, and per admission its status, wall s,
               candidates trained and its lone run's K1 launches;
7. profile   — one training step of a search candidate under torch.profiler:
               wall time, device time, and the kernel's share of it;
8. costmodel — labels 50,000 points of the oneshot search's joint space
               (full-width MobileNetV2's kernel / expansion / op choices at 32 px
               x the accelerator space) with the simulator, trains the MLP cost
               model (``CostModelConfig()``: 20,000 Adam steps, energy head) on
               the card, reports its validation MAPEs, and holds its forward and
               3 steps (dropout 0) card against CPU;
9. oneshot   — the oneshot (weight-sharing) search over full-width MobileNetV2
               (17 blocks, 10 classes, 32 px, batch 64, 200 supernet steps,
               warmup 50) with the REINFORCE controller on the card and the
               cost model in the loop, with exactly 105 ``ibn_pointwise``
               launches per supernet step and 35 per validation forward; the
               supernet's logits and one SGD step card against CPU for four
               draws; and 3 supernet steps under torch.profiler;
10. attention — holds ``flash_attention`` against its plain version on the
               card at tests/test_kernels.py's shapes (fp32 and bf16), causal
               with sq != skv, head_dims 80, 112 and 256 with G 1, 2 and 8 at
               S 1000 and 1025, and the served model's prefill shape (B 8,
               H 16, KV 8, hd 128, bf16, causal, S 1024 and a ragged 1025),
               each on (B, S, H, hd) views as the model passes them and
               contiguous, bf16 also per row against a control; times the
               kernel, the plain version and
               ``scaled_dot_product_attention`` there (on the model's views,
               and once contiguous), at S 4096, and at zamba2-7b's,
               hubert-xlarge's and gemma-2b's heads; holds the backward
               kernels against the plain backward (fp32 and bf16, every
               head_dim, causal sq != skv both ways, ragged lengths, the
               served shape), each twice bitwise the same;
11. ssd      — holds ``ssd_scan`` against its plain version (fp32 and bf16) at
               tests/test_kernels.py's shapes, mamba2-370m's prefill shape and a
               ragged S 1000, zamba2-7b's H 112 N 64, and the cluster's edges
               (S 4096 and 8192, S 2300, a cluster of 8, one chunk, G 4 with
               a ragged tail) in mamba2's dt and A ranges, with two controls
               that the fp32 limit must fail (the plain version run apart on
               the two sides of the first chunk boundary, and of the first
               group boundary), and the plain version against the sequential
               recurrence; times kernel and plain version (no single PyTorch
               call computes the scan) as the host issues them and on the
               device alone (CUDA graphs), at mamba2's and zamba2's shapes,
               and the wrapper's host µs per call; holds the backward kernels
               against the plain backward (fp32 and bf16) at the same shapes,
               with and without the final state's cotangent, each twice
               bitwise the same;
12. gmm      — holds ``gmm`` against its plain version (fp32 and bf16) at
               tests/test_kernels.py's shapes, ragged edges, strided views, the
               bf16 body's edges (C 1 to 8192, D off the K steps, F under one
               tile, 60 experts of 8 rows) and qwen2-moe-a2.7b's four expert
               products, with two controls that the bf16 limit must fail;
               times kernel, plain version and ``torch.bmm`` at the four
               products;
13. serve    — qwen3-1.7B at full width with ``attn_impl="flash_pallas"``,
               random weights from a seed on the card, 8 prompts of 1024 tokens
               through ``make_prefill_step`` (exactly 28 kernel launches) and the
               ``return_cache`` forward, the k/v written into a preallocated
               2048-position bf16 cache, 32 greedy steps of ``make_decode_step``,
               the first step held against a forward over the prompt plus its
               token, 4 steps over int8 caches; ms per prefill and per decode
               step, tokens/s, and where the device time goes (torch.profiler);
14. serve_ssm — mamba2-370m at full width: prefill 8 x 1024 (exactly 48
               ``ssd_scan`` launches), 64 decode steps over the prompt from a zero
               cache then 32 greedy steps at batch 8, decode vs forward held in
               fp32 and for the timed bf16 decode; times and the profiler's
               breakdown;
15. serve_moe — qwen2-moe-a2.7b at full width with ``flash_pallas``: prefill
               8 x 1024 (exactly 72 ``gmm`` and 24 ``flash_attention``
               launches), a 2048-position bf16 cache filled by one multi-token
               decode step, 32 greedy steps, decode vs forward at 8 x 256 tokens
               (no capacity drops); times and the profiler's breakdown;
16. llm      — full width cut in depth (qwen3-1.7B at 4 layers, mamba2-370m
               whole, qwen2-moe-a2.7b at 2 layers, zamba2-7b at 2 groups with
               its shared block on ``flash_attention`` at head_dim 112), fp32
               and bf16: the card's logits (kernels) against the port's CPU
               forward (plain versions), with each kernel's launch count;
17. train    — the LLM families' training step at full width, 8 x 1024
               tokens of the LM stream a step, AdamW as ``launch/train.py``
               sets it: qwen3-1.7B (28 layers, ``flash_pallas``,
               remat="full": exactly 112 ``flash_attention`` launches a step,
               56 forward and 56 of its backward kernels, its loss falling by
               0.3 over 30 steps; one step each at remat="dots" and
               microbatches=2), mamba2-370m (48 layers: exactly 288
               ``ssd_scan`` launches, 48 forward and 240 backward) and
               qwen2-moe-a2.7b cut to 2 layers (exactly 18 ``gmm`` and 6
               ``flash_attention`` launches); ms per step, tokens/s, peak
               memory, model TFLOP/s and the device time by kernel and in the
               backwards' and the optimizer's profiler ranges; each backward
               alone at the step's shape against the plain VJP (and, for
               attention, ``scaled_dot_product_attention``'s); the step card
               against CPU at the llm cuts in fp32 (loss, every gradient
               leaf, one AdamW update) with two planted faults the
               gradient limit must fail; the loop resumed after an injected
               failure from a bitwise checkpoint;
18. mesh     — the pod mesh search (``core.meshsearch.search_mesh``) for
               qwen3-1.7B, mamba2-370m and qwen2-moe-a2.7b at train_4k on
               256 chips, 400 samples, seed 0, with its PPO updates on the
               card, then the same search on the CPU: the sampled configs
               (in order), every record (bitwise) and the best config must be
               the same and the final PPO logits within 1e-5; wall s per
               search, ms per sample, the PPO update's mean ms on the card
               (CUDA events over its 25 updates), the engine's cache hit rate
               and the best config; then the full LLM scenario grid
               (``core.scenarios.grid``: 324 scenarios, distinct feature
               vectors, every target in [0.2, 2.0] ms) and its wall s. The
               serve phases hold ``launch.roofline.count_params`` (a
               shape-only init) against the full-width weights' element
               count, and the train phase counts its model FLOPs with
               ``launch.roofline.model_flops``;
19. parallel — one world of 8 spawned ranks (on one card every rank
               computes on cuda:0 and the collectives go over gloo with
               every CUDA tensor staged through host memory,
               ``parallel.staging``; NCCL with a card a rank) over (2, 4)
               and (1, 8) (data, model), (8,) stage and (4, 2): qwen3-1.7B
               cut to 4 layers at full width, fp32, 8 x 512 tokens, AdamW,
               TP 4 and FSDP on (2, 4): its sharded gradients against the
               unsharded ones computed first in this process, its sharded
               AdamW update against the unsharded optimizer's on the same
               clipped gradients, a train step timed, K2 launched on every
               rank alike, and a planted fault (layer 0's attention output
               without its model-axis sum) the gradient limit must fail;
               qwen2-moe-a2.7b cut to 2 layers, fp32 forward: EP on (2, 4)
               against the unsharded forward of each data shard's rows, TPE
               on (1, 8) against the whole batch's, K4 on every rank, and a
               planted fault (each EP rank running another rank's experts)
               that must fail; ``pipeline_apply`` over 8 stages against the
               sequential product; ``compressed_psum`` on the card bitwise
               against the same ranks on the CPU; the qwen3 smoke config's
               sharded checkpoint restored onto (4, 2) and one device,
               bitwise. It prints the backend, the collectives and bytes
               staged, the walls and per-rank peak memory (not a scaling
               figure: the ranks time-share one card);
20. dryrun   — in a process of its own, the dry run (``launch.dryrun``):
               its CLI on the 16 x 16 fake world at ``DRYRUN_CELLS`` (full
               width, fake CUDA tensors, the kernels' custom ops; each
               status the reference's, each ok cell's roofline terms and
               useful-FLOPs ratio printed); its trace of the serve phases'
               three prefills (8 x 1024, bf16 weights; K2, K3, K4 and K2) at world 1
               against the same prefills run on the card under the same
               counter and ``FlopCounterMode`` (FLOPs and bytes equal, the
               predicted peak within 20% of ``max_memory_allocated``), with
               a planted control (K4's FLOP formula zeroed) that must fail;
               and its trace of the parallel phase's qwen3 gradient pass on
               a fake 8-rank CUDA world against rank 0's readings of the
               real pass (collectives per kind, FLOPs and bytes equal, the
               peak within 20%);
21. prints one ``kernels`` JSON line, then ``{"ok": true, "device": ...}``.

Each main path (search, runtime, serve_tier and oneshot for ibn_pointwise; serve, serve_ssm,
serve_moe, train and parallel for flash_attention, ssd_scan and gmm; mesh, which
must launch none of them, as the dryrun phase's traces must not) runs with every
kernel's launch count set to 0 just before it and read just after. Any failure raises and exits
non-zero; nothing falls back to the CPU. TF32 is off for matmuls and cuDNN
convolutions.
``--json PATH`` also writes every per-shape measurement to PATH.
"""
from __future__ import annotations

import argparse
import bisect
import contextlib
import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import configs  # noqa: E402
from repro_torch.common import (tree_leaves, tree_map, tree_paths, tree_size,  # noqa: E402
                                tree_unflatten_paths)
from repro_torch.config import SHAPES as LLM_SHAPES  # noqa: E402
from repro_torch.config import MeshConfig, RunConfig, ShapeConfig, TrainConfig  # noqa: E402
from repro_torch.core import (costmodel, has, meshsearch, nas, oneshot, scenarios,  # noqa: E402
                              simulator, sweep)
from repro_torch.core.engine import split_key  # noqa: E402
from repro_torch.core.proxy import TrainedAccuracy, train_step  # noqa: E402
from repro_torch.core.search import SearchConfig, SearchInterrupted  # noqa: E402
from repro_torch.core.session import SearchSession  # noqa: E402
from repro_torch.kernels import build as kbuild  # noqa: E402
from repro_torch.data.synthetic import LMStream  # noqa: E402
from repro_torch.kernels import flash_attention, gmm, ibn_conv, ssd_scan  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402
from repro_torch.kernels.ref import (flash_attention_bwd, flash_attention_ref,  # noqa: E402
                                     gmm_ref, ibn_pointwise_ref, ssd_chunked, ssd_chunked_bwd,
                                     ssd_scan_ref)
from repro_torch.launch import dryrun, roofline  # noqa: E402
from repro_torch.models import api, moe, transformer  # noqa: E402
from repro_torch.models import convnets as C  # noqa: E402
from repro_torch.parallel import sharding, staging  # noqa: E402
from repro_torch.runtime import FAULTS_ENV, Budget, DurableRecordStore, SearchRuntime  # noqa: E402
from repro_torch.serve import (AdmissionConfig, AdmissionController,  # noqa: E402
                               FrontierServer, brute_force_best, load_snapshot,
                               load_store_frontier, snapshot_store)
from repro_torch.serve import admission as serve_admission  # noqa: E402
from repro_torch.serving import kvcache  # noqa: E402
from repro_torch.train import checkpoint, steps  # noqa: E402
from repro_torch.train.loop import LoopConfig, run_training  # noqa: E402
from repro_torch.train.optim import make_optimizer  # noqa: E402

# H100 SXM, NVIDIA's data sheet: HBM3 rate, and the peak rate of each input
# type (fp32 outside the tensor cores, bf16 dense on them)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOP_PER_S = {torch.float32: 67e12, torch.bfloat16: 989e12}
# forward and backward tolerances, relative to the largest |plain value|:
# fp32 sums in another order (K up to 200k pixels for dw); bf16 rounds the
# output to 8 bits of mantissa
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
LOGIT_TOL = 1e-3  # card vs CPU logits, absolute (cuDNN vs CPU conv sum order)
MAIN_PATH_SCENARIO = "lat-0.5ms"
# costmodel: labelled points and the card-vs-CPU limits (forward / max |output|;
# 3 Adam steps per leaf / max(1, max |leaf|))
COST_POINTS = 50_000
COST_CONFIG = costmodel.CostModelConfig()
COST_FWD_TOL = 1e-5
COST_STEP_TOL = 1e-4
# oneshot: supernet steps of the search, the card-vs-CPU batch, and the limits
# (logits / max |logit|; one SGD step per leaf / max(1, max |leaf|); its
# gradient per leaf / that leaf's max |gradient|)
ONESHOT_STEPS = 200
ONESHOT_CHECK_BATCH = 8
ONESHOT_TOL = 1e-4
# flash_attention against its plain version, absolute, inputs N(0, 1):
# tests/test_kernels.py's tolerances (fp32 sums in another order; bf16 rounds
# p and the output to 8 bits of mantissa)
ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# bf16 is also held per row: a row's largest |error| over the row's largest
# |plain value|. Over n keys |o| is about n^-1/2, so at S 4096 the absolute
# 2e-2 is half a typical value and passes a kernel that drops a row's last
# kv tile; per row, the kernel's and the plain version's o round to bf16 one
# step (2^-7 of the row's largest value) apart, and the dropped tile moves
# a row by about 0.2. Two steps:
ATTN_ROW_TOL = 2.0 ** -6
DEV = "cuda"  # every tensor of the attention, serve and llm phases
# the served model's prefill attention: B, H, KV, S, hd (qwen3-1.7B, 8 x 1024)
SERVE_ATTN = (8, 16, 8, 1024, 128)
# the other head_dims of the configs, at their own heads, 8 x 1024: H, KV,
# hd, causal (zamba2-7b's shared block, hubert-xlarge's bidirectional
# encoder, gemma-2b)
OTHER_ATTN = {"zamba2-7b": (32, 32, 112, True), "hubert-xlarge": (16, 16, 80, False),
              "gemma-2b": (8, 1, 256, True)}
SERVE_ARCH = "qwen3_1_7b"
SERVE_BATCH, PROMPT, CACHE_LEN, DECODE_STEPS, INT8_STEPS = 8, 1024, 2048, 32, 4
# LLM logits relative to max |logit|. fp32: the card and the CPU sum in
# another order. bf16: every product and norm rounds to 8 bits of mantissa at
# other places (the card's against the CPU's products, decode's chunked
# attention against the prefill's kernel, one-row against many-row products),
# through up to 28 layers; a wrong mask or position moves logits by O(1). The
# llm phase's bf16 cuts hold 5e-2, except mamba2-370m's whole 48 layers: its
# card vs CPU bf16 logits measure 5.14e-2 while the CPU's own bf16 logits sit
# 7.8e-2 from its fp32 ones on the same params and tokens, so that cut holds
# 6.5e-2, between the two
LLM_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
LLM_BF16_TOL = {"mamba2_370m": 6.5e-2}
# int8 cache against the bf16 cache: every cached k/v moves by up to 1/254 of
# its row's largest value, in all 28 layers
INT8_TOL = 0.1
# ssd_scan against its plain version, relative to max |plain value|. fp32:
# the chunk's cumsum is a scan in another order and the products sum in
# another order, which moves exp(cs_i - cs_j) by ~1e-5 where |cs| reaches
# hundreds; bf16 rounds y to 8 bits of mantissa. The state is fp32 in both.
SSD_TOL = {torch.float32: 1e-3, torch.bfloat16: 2e-2}
# the backward kernels against the plain backwards, each gradient over
# max(1, its largest |plain value|) (absolute below 1: a single query row's
# dq and dk are 0 up to rounding): fp32 sums in another order; bf16 rounds
# the products' operands (P and dS, the scores and the state terms) to bf16
# where the plain backward keeps fp32, and the gradients to 8 bits
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _grad_rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp_min(1.0)).item()
# the plain chunked version against the sequential recurrence, absolute, inputs
# as tests/test_kernels.py draws them (its tolerance)
SEQ_TOL = 2e-3
# gmm against its plain version, relative to max |plain value|: fp32 sums in
# another order; bf16 rounds the output to 8 bits of mantissa
GMM_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# gmm's edge shapes (E, C, D, F), checked in fp32 and bf16 (gmm_phase)
GMM_EDGES = [(3, 1, 256, 1408), (3, 33, 72, 256), (2, 64, 1000, 1408), (2, 65, 2048, 72),
             (2, 129, 8, 1408), (2, 8192, 2048, 1408), (60, 8, 2048, 1408)]
# K4's backward (E, C, D, F, view) beside the training shapes: C ragged (dw's
# K runs past C, which TMA zero-fills), C at most 64 (dx on the 64-row body),
# D and F multiples of 8 but not of 64, x and w expert-strided views, and a w
# whose row stride (F + 4) no TMA map takes, whose wᵀ is still copied
GMM_BWD_EDGES = [(4, 100, 256, 384, "contiguous"), (4, 40, 128, 192, "contiguous"),
                 (3, 200, 200, 136, "contiguous"), (4, 120, 192, 320, "expert-strided"),
                 (3, 96, 128, 200, "unaligned w")]
# tests/test_kernels.py's ssd_scan shapes (b, s, h, p, g, n, chunk), then a
# ragged tail with G > 1 and a chunk longer than S
SSD_SMALL = [(2, 64, 4, 16, 1, 32, 16), (1, 128, 4, 8, 2, 16, 32), (2, 96, 2, 32, 1, 64, 32),
             (1, 48, 8, 16, 4, 8, 48), (1, 37, 4, 16, 2, 16, 16), (2, 20, 2, 8, 1, 8, 64)]
SSM_ARCH, MOE_ARCH, HYBRID_ARCH = "mamba2_370m", "qwen2_moe_a2_7b", "zamba2_7b"
# mamba2-370m's prefill scan (8 x 1024 tokens; chunk = ssm_chunk), the same
# at a ragged S, and zamba2-7b's widths (H 112, N 64)
SERVE_SSD = (SERVE_BATCH, PROMPT, 32, 64, 1, 128, 256)
ZAMBA_SSD = (2, 512, 112, 64, 1, 64, 256)
# the cluster's edges, drawn in mamba2's dt and A ranges so that the state
# passed between chunks shows in y: S 4096 and 8192 (16 and 32 chunks,
# clusters of 2 walking 8 and 16 groups), S 2300 (9 chunks, not a multiple
# of the cluster), B 1 H 8 S 4096 (few heads: a cluster of 8 walking 2
# groups), one chunk (S <= Q), and G 4 with a ragged tail
SSD_EDGES = [(2, 4096, 32, 64, 1, 128, 256), (2, 8192, 32, 64, 1, 128, 256),
             (2, 2300, 32, 64, 1, 128, 256), (1, 4096, 8, 64, 1, 128, 256),
             (2, 200, 32, 64, 1, 128, 256), (2, 1100, 32, 64, 4, 128, 256)]
# K3's fp32 backward at a chunk of 4096, held against the plain backward in
# float64 (scripts/backward_kernels.py's shape)
SSD_BWD_EXACT = (1, 4096, 2, 64, 1, 128, 4096)
# the backward's own edges (its chunk launch sums each group's heads over
# slices of them, walks a chunk's 64-position tiles in pairs, and reads x,
# B, C and dy through TMA maps in bf16): a group's heads over several
# slices (G 1 H 32; G 2 H 8 at a ragged S; zamba2's H 112 N 64), chunks of
# 64 (one tile) and 4096 (64 tiles), S < 64, a chunk of 200 (its last tile
# 8 positions), and P 60, whose x and dy no map reads (padded copies);
# (b, s, h, p, g, n, chunk). fp32 is held against the plain backward in
# float64: the fp32 plain backward is itself off by 1.8e-4 at (1, 512, 32,
# ...) in these draws, and by up to 2e-3 at chunk 4096
SSD_BWD_EDGES = [(1, 512, 32, 64, 1, 128, 256), (1, 900, 8, 64, 2, 128, 256), ZAMBA_SSD,
                 (2, 300, 4, 64, 1, 128, 64), (1, 4096, 2, 64, 1, 128, 4096),
                 (2, 40, 4, 32, 1, 64, 256), (2, 700, 4, 64, 1, 128, 200),
                 (1, 300, 4, 60, 1, 128, 128)]
# serve_ssm: decode steps over the prompt's first tokens from a zero cache,
# held against a forward over those tokens: in fp32 compute (the recurrence
# against the chunked scan, fp32 through 48 layers) at 1e-3, and the timed
# bf16 decode against the bf16 forward at 0.1. The two bf16 paths round at
# other places through 48 layers: they measure 7.97e-2 apart, each about
# 8e-2 from fp32, while a wrong state or position moves logits by O(1)
SSM_TEACHER = 64
SSM_DECODE_TOL = {"float32": 1e-3, "bfloat16": 0.1}
# serve_moe: decode vs forward at 8 x 256 tokens, where capacity_for never
# drops (8 x 256 x 4 assignments <= 8192)
MOE_CHECK_LEN = 256
# the device symbol of K1's launches (ibn_pw<...>)
K1_SYMBOL = "ibn_pw"
KERNELS = {"ibn_pointwise": ibn_conv, "flash_attention": flash_attention,
           "ssd_scan": ssd_scan, "gmm": gmm}
# the backward kernels, counted apart too (their launches are also in their
# module's LAUNCHES)
BACKWARDS = {"flash_attention_bwd": flash_attention, "ssd_scan_bwd": ssd_scan}
# the mesh phase: one dense, the ssm and one moe config, as the reference's
# mesh search prices them
# the runtime phase: the constraint-modes preset's 4 scenarios, the search
# phase's search and proxy training; a worker hard-killed in the middle of
# lat-0.5ms's first attempt (after its first batch); a budget under the
# sweep's 4 x 16 samples
RUNTIME_PRESET = "constraint-modes"
RUNTIME_SEARCH = SearchConfig(samples=16, batch=8, seed=0)
# half the search phase's 40 steps a candidate: the script's budget holds
# the parallel phase too (the sweeps hold their bitwise checks at any depth)
RUNTIME_TRAIN = {"steps": 20, "batch": 64}
RUNTIME_WORKERS = 2
RUNTIME_FAULT = "crash:sweep.lat-0.5ms:0:1"
RUNTIME_BUDGET = 24
# the serve_tier phase: the runtime phase's serial store; every registered
# scenario, the runtime preset and seeded ad-hoc envelopes over the
# frontier's own ranges, tiled for re-asks (benchmarks/serve_bench.py's
# workload); two admitted searches at once, trained as the search phase
# trains, their latency targets these fractions of the frontier's least
SERVE_TIER_ADHOC = 300
SERVE_TIER_REPEATS = 20
SERVE_TIER_COLD_REPS = 5
SERVE_TIER_ADMISSION = AdmissionConfig(budget_samples=16, batch=8, max_concurrent=2)
SERVE_TIER_TRAIN = {"steps": 40, "batch": 64}
SERVE_TIER_TARGETS = (0.9, 0.8)
MESH_ARCHS = ("qwen3_1_7b", "mamba2_370m", "qwen2_moe_a2_7b")
MESH_SHAPE, MESH_CHIPS, MESH_SAMPLES = "train_4k", 256, 400
MESH_LOGIT_TOL = 1e-5
GRID_SIZE = 324


def reset_counts() -> None:
    """Every kernel's launch count to 0, just before a main path."""
    for mod in KERNELS.values():
        mod.LAUNCHES = 0
    for mod in BACKWARDS.values():
        mod.BACKWARD_LAUNCHES = 0


def launch_counts() -> dict:
    return {**{name: mod.LAUNCHES for name, mod in KERNELS.items()},
            **{name: mod.BACKWARD_LAUNCHES for name, mod in BACKWARDS.items()}}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls (CUDA
    events; L2 stays warm between calls)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fns, calls: int = 20, rounds: int = 3) -> list[float]:
    """Device time per call of each of ``fns``, with the host out of the
    reading: each is captured ``calls`` times into a CUDA graph, and the
    graphs are replayed in turns (0, 1, .., 1, 0, ...) ``rounds`` times each,
    timed by CUDA events around each replay; mean ms per call. L2 stays warm
    between calls, as in ``time_ms``."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in fns:
            for _ in range(3):
                fn()
    torch.cuda.current_stream().wait_stream(side)
    graphs = []
    for fn in fns:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(calls):
                fn()
        graphs.append(g)
    torch.cuda.synchronize()
    total = [0.0] * len(fns)
    for r in range(rounds):
        order = range(len(fns)) if r % 2 == 0 else reversed(range(len(fns)))
        for i in order:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graphs[i].replay()
            end.record()
            end.synchronize()
            total[i] += start.elapsed_time(end)
    del graphs
    return [t / (rounds * calls) for t in total]


def host_us(fn, calls: int = 200) -> float:
    """Host µs per call of ``fn``: the time to issue ``calls`` calls back to
    back (the device finishes each small call faster than the host issues
    the next, so the queue never fills)."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e6 / calls


def bound_parts_ms(n: int, cin: int, cout: int, dtype=torch.float32) -> tuple[float, float]:
    """The two lower bounds of act(x @ w + b) in ms: bytes (each input read
    once, y written once) over the memory rate, and 2·N·Cin·Cout operations
    over the peak rate for the input type. The bound is the larger."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    nbytes = itemsize * (n * cin + cin * cout + cout + n * cout)
    return (nbytes / HBM_BYTES_PER_S * 1e3,
            2.0 * n * cin * cout / PEAK_FLOP_PER_S[dtype] * 1e3)


def pointwise_shapes(spec: C.ConvNetSpec, batch: int) -> list[tuple[int, int, int]]:
    """(N, Cin, Cout) of every 1×1 conv of ``spec``, in order, repeats kept."""
    return [(batch * op.h * op.w, op.cin, op.cout) for op in C.layer_ops(spec)
            if op.op == "conv" and op.kernel == 1]


def search_space_shapes(batch: int, image_size: int) -> list[tuple[int, int, int]]:
    """Every 1×1 shape the search's MobileNetV2 space can give at the
    proxy's size: block shapes depend only on the block's expansion."""
    base = C.mobilenet_v2(10, image_size)
    shapes = []
    for e in (3, 6):
        blocks = tuple(dataclasses.replace(b, expansion=1 if i == 0 else e)
                       for i, b in enumerate(base.blocks))
        shapes += pointwise_shapes(dataclasses.replace(base, blocks=blocks), batch)
    return sorted(set(shapes))


def supernet_shapes(batch: int, image_size: int) -> list[tuple[int, int, int]]:
    """The 1×1 shapes of one oneshot supernet forward, in order, repeats kept:
    its weights are at the largest expansion in every block, block 0
    included, whatever the draw masks."""
    base = C.mobilenet_v2(10, image_size)
    blocks = tuple(dataclasses.replace(b, expansion=oneshot._MAX_EXP) for b in base.blocks)
    return pointwise_shapes(dataclasses.replace(base, blocks=blocks), batch)


def rel_err(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(max |got - want|, that over max(1, max |want|))."""
    err = (got.float() - want.float()).abs().max().item()
    return err, err / max(1.0, want.float().abs().max().item())


def check_shape(n, cin, cout, act, dtype, gen, timed: bool) -> dict:
    """Forward and backward of the kernel against the plain version."""
    dev = "cuda"
    x = torch.randn((n, cin), generator=gen, device=dev).to(dtype)
    w = (torch.randn((cin, cout), generator=gen, device=dev) / math.sqrt(cin)).to(dtype)
    b = (torch.randn((cout,), generator=gen, device=dev) * 0.1).to(dtype)
    dy = torch.randn((n, cout), generator=gen, device=dev).to(dtype)
    tol = TOL[dtype]

    y = ibn_conv.launch(x, w, b, act)
    y_ref = ibn_pointwise_ref(x, w, b, act)
    torch.cuda.synchronize()
    fwd_abs, fwd_rel = rel_err(y, y_ref)

    near_zero = torch.zeros((), dtype=torch.bool)
    if act == "relu":
        # relu's gradient steps at 0, where two sums in another order may
        # fall on either side: the cotangent is 0 wherever the plain
        # pre-activation lies within the forward's limit of 0 (by the plain
        # version alone), and each version's backward takes its own mask
        z_ref = ibn_pointwise_ref(x, w, b, "none").float()
        near_zero = z_ref.abs() <= tol * max(1.0, z_ref.abs().max().item())
        dy = dy.masked_fill(near_zero, 0)
    leaves = [t.clone().requires_grad_(True) for t in (x, w, b)]
    y_k = ibn_conv.ibn_pointwise(*leaves, act=act)
    y_k.backward(dy)
    plain = [t.clone().requires_grad_(True) for t in (x, w, b)]
    y_p = ibn_pointwise_ref(*plain, act)
    y_p.backward(dy)
    torch.cuda.synchronize()
    # the two relu masks may differ only at pre-activations within the limit of 0
    flips = (y_k.detach() > 0) != (y_p.detach() > 0)
    if act == "relu" and (flips & ~near_zero).any():
        raise AssertionError(f"ibn_pointwise's relu mask differs away from 0 at "
                             f"{(n, cin, cout)}")
    bwd = [rel_err(a.grad, p.grad)[1] for a, p in zip(leaves, plain)]
    rec = {"n": n, "cin": cin, "cout": cout, "act": act, "dtype": str(dtype)[6:],
           "fwd_max_abs_err": fwd_abs, "fwd_rel_err": fwd_rel,
           "dx_rel_err": bwd[0], "dw_rel_err": bwd[1], "db_rel_err": bwd[2],
           "relu_mask_flips": int(flips.sum().item()) if act == "relu" else 0,
           "cotangent_zeroed": int(near_zero.sum().item()), "tol": tol}
    if max(fwd_rel, *bwd) > tol:
        raise AssertionError(f"ibn_pointwise disagrees with its plain version: {rec}")
    if timed:
        lib_act = {"none": lambda t: t, "relu": torch.relu, "silu": torch.nn.functional.silu}[act]
        rec["ms"] = time_ms(lambda: ibn_conv.launch(x, w, b, act))
        rec["plain_ms"] = time_ms(lambda: ibn_pointwise_ref(x, w, b, act))
        rec["library_ms"] = time_ms(lambda: lib_act(torch.addmm(b, x, w)))
        rec["bound_bytes_ms"], rec["bound_ops_ms"] = bound_parts_ms(n, cin, cout, dtype)
        rec["bound_ms"] = max(rec["bound_bytes_ms"], rec["bound_ops_ms"])
        rec["bound_by"] = ("bytes" if rec["bound_bytes_ms"] >= rec["bound_ops_ms"]
                           else "operations")
    return rec


def product_times(n: int, cin: int, cout: int, gen) -> dict:
    """Device-only ms of the three products of one 1x1 conv, fp32, for the
    kernel and for one PyTorch call, in turns (``graph_ms``): the forward
    ``x @ w + b`` (``torch.addmm``), and the backward's ``dx = dz @ wᵀ`` and
    ``dw = xᵀ @ dz`` (``torch.mm``), on the transposed views the backward
    passes; with each product's bound (M, K, N)."""
    dev = "cuda"
    x = torch.randn((n, cin), generator=gen, device=dev)
    w = torch.randn((cin, cout), generator=gen, device=dev) / math.sqrt(cin)
    b = torch.randn((cout,), generator=gen, device=dev) * 0.1
    dz = torch.randn((n, cout), generator=gen, device=dev)
    products = {
        "fwd": ((n, cin, cout), lambda: ibn_conv.launch(x, w, b, "none"),
                lambda: torch.addmm(b, x, w)),
        "dx": ((n, cout, cin), lambda: ibn_conv.launch(dz, w.t(), None, "none"),
               lambda: torch.mm(dz, w.t())),
        "dw": ((cin, n, cout), lambda: ibn_conv.launch(x.t(), dz, None, "none"),
               lambda: torch.mm(x.t(), dz)),
    }
    out = {}
    for name, ((m, k, nn), kern, lib) in products.items():
        if name == "fwd":
            kern_ms, lib_ms, plain_ms = graph_ms(
                [kern, lib, lambda: ibn_pointwise_ref(x, w, b, "none")])
        else:
            (kern_ms, lib_ms), plain_ms = graph_ms([kern, lib]), None
        nbytes = 4 * (m * k + k * nn + m * nn + (nn if name == "fwd" else 0))
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = 2.0 * m * k * nn / PEAK_FLOP_PER_S[torch.float32] * 1e3
        out[name] = {"mkn": (m, k, nn), "ms": kern_ms, "library_ms": lib_ms, "plain_ms": plain_ms,
                     "bound_ms": max(bytes_ms, ops_ms), "bound_bytes_ms": bytes_ms,
                     "bound_ops_ms": ops_ms}
    return out


# K1's edges, (M, K, N, how a and b lie): K 960 split across a cluster, the
# backward's dw at K 16384 (xᵀ @ dz) and its dx (dz @ wᵀ), ragged M and N,
# one row, and every layout of the two operands
K1_EDGES = [(64, 960, 160, "x", "w"), (64, 960, 320, "x", "w"), (16, 16384, 48, "xT", "w"),
            (48, 16384, 96, "xT", "w"), (16384, 48, 16, "x", "wT"), (77, 130, 33, "x", "w"),
            (1000, 70, 50, "xT", "wT"), (1, 96, 1280, "x", "w"), (131, 4096, 45, "x", "wT")]


def k1_edges(card: str) -> dict:
    """K1 against its plain version at ``K1_EDGES`` in fp32 and bf16, with
    the operands as they lie (``xT``/``wT``: transposed views of contiguous
    tensors, as the backward passes them), and two controls that the limit
    must fail on the split-K products, the plain version without the last
    cluster rank's K range and without the last rank's last K step: the
    faults of a partial left out of the sum and of a K step never loaded."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    out = []
    for m, k, n, la, lb in K1_EDGES:
        for dtype in (torch.float32, torch.bfloat16):
            a = torch.randn((k, m) if la == "xT" else (m, k), generator=gen, device="cuda")
            b = torch.randn((n, k) if lb == "wT" else (k, n), generator=gen, device="cuda")
            a = (a.t() if la == "xT" else a).to(dtype)
            b = (b.t() if lb == "wT" else b).to(dtype) / math.sqrt(k)
            bias = (torch.randn((n,), generator=gen, device="cuda") * 0.1).to(dtype)
            want = ibn_pointwise_ref(a, b, bias, "relu")
            got = ibn_conv.launch(a, b, bias, "relu")
            torch.cuda.synchronize()
            err = rel_err(got, want)[1]
            (_, _, step), splits, k_chunk = ibn_conv.plan(
                m, n, k, dtype, kbuild.device_info(0)[1], ibn_conv._max_cluster(0))
            rec = {"mkn": (m, k, n), "layout": (la, lb), "dtype": str(dtype)[6:],
                   "splits": splits, "k_chunk": k_chunk, "rel_err": err, "tol": TOL[dtype]}
            if err > TOL[dtype]:
                raise AssertionError(f"ibn_pointwise disagrees with its plain version: {rec}")
            if splits > 1:
                last = (k - 1) // k_chunk
                last_step = last * k_chunk + (k - 1 - last * k_chunk) // step * step
                rec["controls"] = {}
                for name, lo in (("rank_dropped", last * k_chunk),
                                 ("last_k_step_unloaded", last_step)):
                    cut = a.clone()
                    cut[:, lo:] = 0
                    rec["controls"][name] = rel_err(ibn_pointwise_ref(cut, b, bias, "relu"),
                                                    want)[1]
                if not min(rec["controls"].values()) > TOL[dtype]:
                    raise AssertionError(f"the limit passes a control: {rec}")
            out.append(rec)
    split = [r for r in out if "controls" in r]
    print(f"kernel: {len(out)} edge checks (K 960 and dw K 16384 split over clusters of "
          f"{sorted({r['splits'] for r in split})}, ragged M and N, xT and wT views, fp32 and "
          f"bf16): worst {max(r['rel_err'] / r['tol'] for r in out):.3g} of the limit; "
          f"controls fail it by at least "
          f"{min(min(r['controls'].values()) / r['tol'] for r in split):.3g}x  [{card}]")
    return {"records": out}


def device_phase(card: str, full, search, supernet, per_model) -> dict:
    """K1 and one PyTorch call on the device alone (CUDA graphs of 20
    calls, in turns), per product, summed over the search's 36 shapes, over
    one supernet forward's 35 products and over the full-width models'
    shapes; and the wrapper's host µs per call."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    per_shape = {shape: product_times(*shape, gen)
                 for shape in sorted(set(full) | set(search) | set(supernet))}
    sums = {}
    for label, shapes in (("search", search), ("supernet", supernet), *per_model.items()):
        sums[label] = {p: {k: sum(per_shape[s][p][k] for s in shapes)
                           for k in ("ms", "library_ms", "bound_ms", "bound_bytes_ms",
                                     "bound_ops_ms")}
                       for p in ("fwd", "dx", "dw")}
        sums[label]["fwd"]["plain_ms"] = sum(per_shape[s]["fwd"]["plain_ms"] for s in shapes)
        t = sums[label]
        print(f"kernel: device only (CUDA graphs of 20 calls, kernel and library in turns), "
              f"{label} {len(shapes)} shapes, fp32, ms summed: "
              + "; ".join(f"{p} kernel {t[p]['ms']:.4f} vs {'addmm' if p == 'fwd' else 'mm'} "
                          f"{t[p]['library_ms']:.4f} (bound {t[p]['bound_ms']:.4f})"
                          for p in ("fwd", "dx", "dw")) + f"  [{card}]")
    for shape in search:
        r = per_shape[shape]
        print(f"kernel:   search {shape} device ms: "
              + ", ".join(f"{p} {r[p]['ms']:.4f} / {r[p]['library_ms']:.4f} "
                          f"(bound {r[p]['bound_ms']:.4f})" for p in ("fwd", "dx", "dw")))
    x = torch.randn((search[0][0], search[0][1]), device="cuda")
    w = torch.randn((search[0][1], search[0][2]), device="cuda")
    host = {"kernel_us": host_us(lambda: ibn_conv.launch(x, w, None, "none")),
            "mm_us": host_us(lambda: torch.mm(x, w))}
    print(f"kernel: host µs per call at {search[0]}: the wrapper (ibn_conv.launch) "
          f"{host['kernel_us']:.2f}, torch.mm {host['mm_us']:.2f}  [{card}]")
    return {"per_shape": {str(k): v for k, v in per_shape.items()}, "sums": sums,
            "host_us": host}


def kernel_phase(card: str) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    models = {"mobilenet_v2": C.mobilenet_v2(), "efficientnet_b0": C.efficientnet_b0(),
              "manual_edgetpu_s": C.manual_edgetpu(size="s")}
    per_model = {name: pointwise_shapes(spec, 8) for name, spec in models.items()}
    full = sorted({s for shapes in per_model.values() for s in shapes})
    search = search_space_shapes(64, 32)
    supernet = supernet_shapes(64, 32)
    records = {}
    for shape in sorted(set(full) | set(search) | set(supernet)):
        for act in ("none", "relu"):
            records[(shape, act, "fp32")] = check_shape(
                *shape, act, torch.float32, gen, timed=(act == "none"))
    # a few shapes in bf16 and with silu: first expand, a project, the head
    for shape in (per_model["mobilenet_v2"][0], per_model["efficientnet_b0"][1],
                  per_model["mobilenet_v2"][-1], search[0]):
        records[(shape, "silu", "fp32")] = check_shape(*shape, "silu", torch.float32,
                                                       gen, timed=False)
        for act in ("none", "silu"):
            records[(shape, act, "bf16")] = check_shape(*shape, act, torch.bfloat16,
                                                        gen, timed=(act == "none"))
    worst = max(max(r["fwd_rel_err"], r["dx_rel_err"], r["dw_rel_err"], r["db_rel_err"])
                / r["tol"] for r in records.values())
    flips = sum(r["relu_mask_flips"] for r in records.values())
    zeroed = sum(r["cotangent_zeroed"] for r in records.values())
    print(f"kernel: {len(records)} checks at {len(full)} full-width shapes (224 px, "
          f"batch 8), {len(search)} search shapes and {len(set(supernet))} supernet shapes "
          f"({len(set(supernet) - set(search))} not among the search's; 32 px, batch 64), "
          f"forward and "
          f"backward; worst error {worst:.3g} of its tolerance; {flips} relu outputs on the "
          f"other side of 0 from the plain version's, each within the limit of 0 (relu's "
          f"cotangent is 0 at the {zeroed} plain pre-activations there)  [{card}]")

    def totals(shapes):
        rs = [records[(s, "none", "fp32")] for s in shapes]
        t = {k: sum(r[k] for r in rs) for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                                 "bound_bytes_ms", "bound_ops_ms")}
        t["bound_by"] = ("bytes" if t["bound_bytes_ms"] >= t["bound_ops_ms"]
                         else "operations")
        return t

    summary = {}
    for name, shapes in per_model.items():
        t = totals(shapes)
        summary[name] = t
        print(f"kernel: {name} 224 px batch 8, {len(shapes)} 1x1 convs per forward: "
              f"kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, addmm "
              f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms  [{card}]")
    largest = sorted(full, key=lambda s: -s[0] * s[1] * s[2])[:6]
    for shape in largest + [s for s in per_model["mobilenet_v2"][:1] if s not in largest]:
        r = records[(shape, "none", "fp32")]
        print(f"kernel: (N, Cin, Cout) = {shape} fp32: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, addmm {r['library_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']})  [{card}]")
    t = totals(search)
    summary["search_shapes"] = t
    print(f"kernel: the {len(search)} search shapes, one forward each, host-issued (CUDA "
          f"events around 20 calls): kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
          f"addmm {t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms  [{card}]")
    fp32_main = [records[(s, a, "fp32")] for s in sorted(set(search) | set(supernet))
                 for a in ("none", "relu")]
    edges = k1_edges(card)
    device = device_phase(card, full, search, supernet, per_model)
    return {"records": list(records.values()), "summary": summary,
            "search_totals": t, "device": device, "edges": edges,
            "max_abs_err": max(r["fwd_max_abs_err"] for r in fp32_main),
            "max_rel_err_fwd": max(r["fwd_rel_err"] for r in records.values()),
            "max_rel_err_bwd": max(max(r["dx_rel_err"], r["dw_rel_err"], r["db_rel_err"])
                                   for r in records.values())}


def model_phase(card: str) -> dict:
    out = {}
    rng = np.random.default_rng(0)
    for name, spec in (("mobilenet_v2", C.mobilenet_v2()),
                       ("efficientnet_b0", C.efficientnet_b0()),
                       ("manual_edgetpu_s", C.manual_edgetpu(size="s"))):
        params = C.init(0, spec, device="cuda")
        cpu_params = tree_map(lambda t: t.cpu(), params)
        images = torch.from_numpy(rng.normal(size=(2, 224, 224, 3)).astype(np.float32))
        before = ibn_conv.LAUNCHES
        with torch.no_grad():
            logits = C.forward(params, images.cuda(), spec)
            torch.cuda.synchronize()
            fwd_launches = ibn_conv.LAUNCHES - before
            want = C.forward(cpu_params, images, spec)
        err = (logits.cpu() - want).abs().max().item()
        if not (torch.isfinite(logits).all() and logits.shape == (2, 1000)):
            raise AssertionError(f"{name}: bad logits {tuple(logits.shape)}")
        if err > LOGIT_TOL or fwd_launches == 0:
            raise AssertionError(f"{name}: card vs CPU logits differ by {err} "
                                 f"(tolerance {LOGIT_TOL}), {fwd_launches} launches")
        batch = torch.from_numpy(rng.normal(size=(16, 224, 224, 3)).astype(np.float32)).cuda()
        labels = torch.from_numpy(rng.integers(0, 1000, size=16)).cuda()
        losses, step_ms = [], []
        for i in range(5):
            before = ibn_conv.LAUNCHES
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, loss = train_step(params, batch, labels, spec, 0.05)
            losses.append(float(loss))
            step_ms.append((time.perf_counter() - t0) * 1e3)
            step_launches = ibn_conv.LAUNCHES - before
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"{name}: non-finite losses {losses}")
        print(f"model: {name} 224 px: card vs CPU logits max |diff| {err:.3g} (tolerance "
              f"{LOGIT_TOL}, max |logit| {want.abs().max().item():.3g}), {fwd_launches} "
              f"kernel launches per forward; train_step batch 16: losses "
              f"{[round(v, 4) for v in losses]}, {step_launches} launches per step, "
              f"{min(step_ms[1:]):.1f} ms per step  [{card}]")
        out[name] = {"logit_err": err, "fwd_launches": fwd_launches, "losses": losses,
                     "step_launches": step_launches, "step_ms": step_ms}
    return out


def search_phase(card: str) -> dict:
    session = SearchSession(
        nas.s1_mobilenetv2(),
        TrainedAccuracy(steps=40, batch=64, device="cuda"),
        cfg=SearchConfig(samples=16, batch=8, seed=0),
    )
    rcfg = scenarios.get(MAIN_PATH_SCENARIO).reward_config()
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    res = session.joint(rcfg=rcfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ibn_conv.LAUNCHES
    trained = [h for h in res.history if h["valid"]]
    if not trained or res.best_record is None:
        raise AssertionError("the search produced no record with an accuracy")
    if launches == 0:
        raise AssertionError("the search never launched the ibn_pointwise kernel")
    evaluated = res.engine_stats["evaluated"]
    best = res.best_record
    print(f"search: s1_mbv2 x has, PPO on cuda, TrainedAccuracy(steps=40, batch=64) on "
          f"cuda, {len(res.history)} samples, {evaluated} evaluated, {len(trained)} "
          f"trained: wall {wall:.2f} s, {wall / max(evaluated, 1):.3f} s per candidate, "
          f"{launches} kernel launches  [{card}]")
    print(f"search: best record acc={best['accuracy']:.4f} lat={best['latency_ms']:.4f} ms "
          f"energy={best['energy_mj']:.4f} mJ area={best['area_mm2']:.2f} mm^2 "
          f"reward={best['reward']:.4f} meets={best.get('meets_constraints')}  [{card}]")
    return {"wall_s": wall, "evaluated": evaluated, "trained": len(trained),
            "launches": launches, "best": best}


# the process's age when its first candidate's training began (filled by
# RecordingAccuracy's first call)
_FIRST_CALL: dict = {}


def _process_age_s() -> float:
    """Seconds since this process started (/proc: its start, in clock ticks
    after boot, against the machine's uptime)."""
    start_ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
    uptime = float(Path("/proc/uptime").read_text().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


@dataclasses.dataclass
class RecordingAccuracy(TrainedAccuracy):
    """``TrainedAccuracy`` that, after each candidate, appends this process's
    pid, its card, the kernel's launch count so far and the process's age at
    its first candidate to ``log_dir/acc-<pid>.jsonl``: how the runtime phase sees
    that every worker trained on the card with the kernel. Its fields are
    plain scalars, so its store namespace is the same in every process (and
    in both runs that share ``log_dir``). Spawned workers import this module
    as their main module, so it lives here, at module level."""

    log_dir: str = ""

    def __call__(self, spec: C.ConvNetSpec) -> float:
        _FIRST_CALL.setdefault("age_at_first_candidate_s", _process_age_s())
        acc = super().__call__(spec)
        line = {"pid": os.getpid(), "device": torch.cuda.current_device(),
                "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                "launches": ibn_conv.LAUNCHES, **_FIRST_CALL}
        with open(Path(self.log_dir) / f"acc-{os.getpid()}.jsonl", "a") as f:
            f.write(json.dumps(line) + "\n")
        return acc


def _acc_logs(log_dir: Path) -> dict[int, list[dict]]:
    return {int(p.stem.split("-")[1]): [json.loads(ln) for ln in p.read_text().splitlines()]
            for p in sorted(log_dir.glob("acc-*.jsonl"))}


def _sweep_records(path: Path) -> dict:
    store = DurableRecordStore(path, read_only=True)  # the base log and every segment
    return {split_key(k)[1]: raw for k, raw, _ in store.entries()}


def _same_sweep(label: str, got, want) -> None:
    for g, w in zip(got.outcomes, want.outcomes, strict=True):
        if g.scenario.name != w.scenario.name or g.result.history != w.result.history:
            raise AssertionError(f"runtime: {label}: {g.scenario.name}'s history is not "
                                 f"the serial sweep's")
        if g.best != w.best or g.result.best_record != w.result.best_record:
            raise AssertionError(f"runtime: {label}: {g.scenario.name}'s winner is not "
                                 f"the serial sweep's")


def runtime_phase(card: str, keep_store: Path | None = None) -> dict:
    """The runtime phase in a temporary directory; ``keep_store`` receives a
    copy of its serial sweep's store (the serve_tier phase's input) before
    the directory goes."""
    root = Path(tempfile.mkdtemp(prefix="chip-smoke-runtime-"))
    try:
        out = _runtime_phase(card, root)
        if keep_store is not None:
            shutil.copyfile(root / "serial" / "store.jsonl", keep_store)
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _runtime_phase(card: str, root: Path) -> dict:
    logs = root / "acc"
    logs.mkdir()
    acc = RecordingAccuracy(**RUNTIME_TRAIN, device=DEV, log_dir=str(logs))
    space = nas.s1_mobilenetv2()
    search_cfg = dataclasses.replace(RUNTIME_SEARCH, device=DEV)
    cfg = sweep.SweepConfig(search=search_cfg)

    def runner(config=cfg, signal=None):
        return sweep.SweepRunner(RUNTIME_PRESET, space,
                                 dataclasses.replace(acc) if signal is None else signal,
                                 config)

    # serial, in this process
    serial_runner = runner()
    serial_rt = SearchRuntime.at(root / "serial", root / "serial" / "store.jsonl")
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    serial = serial_runner.run(runtime=serial_rt)
    torch.cuda.synchronize()
    serial_wall = time.perf_counter() - t0
    parent_launches = ibn_conv.LAUNCHES
    serial_rt.store.close()
    if parent_launches == 0:
        raise AssertionError("runtime: the serial sweep never launched ibn_pointwise")
    n_scen = len(serial.outcomes)
    print(f"runtime: serial sweep, {RUNTIME_PRESET} ({n_scen} scenarios x "
          f"{search_cfg.samples} samples), PPO and TrainedAccuracy({RUNTIME_TRAIN}) "
          f"on {DEV}: wall {serial_wall:.2f} s, {serial.store_stats['puts']} evaluations for "
          f"{serial.store_stats['gets']} lookups (hit rate "
          f"{serial.store_stats['hit_rate']:.4f}), {parent_launches} ibn_pointwise launches "
          f"in the parent  [{card}]")

    # processes, one worker hard-killed mid-job
    parent = os.getpid()
    saved = os.environ.get(FAULTS_ENV)
    os.environ[FAULTS_ENV] = RUNTIME_FAULT
    try:
        reset_counts()
        t0 = time.perf_counter()
        proc = runner(dataclasses.replace(cfg, workers=RUNTIME_WORKERS, processes=True)).run(
            runtime=SearchRuntime.at(root / "proc", root / "proc" / "store.jsonl"))
        proc_wall = time.perf_counter() - t0
    finally:
        if saved is None:
            os.environ.pop(FAULTS_ENV, None)
        else:
            os.environ[FAULTS_ENV] = saved
    if ibn_conv.LAUNCHES != 0:
        raise AssertionError("runtime: the parent trained during the process sweep")
    rec = proc.recovery
    if rec["crashes"] < 1 or rec["respawns"] < 1 or rec["retries"] < 1:
        raise AssertionError(f"runtime: the injected crash was not healed: {rec}")
    _same_sweep("process sweep", proc, serial)
    serial_records = _sweep_records(root / "serial" / "store.jsonl")
    proc_records = _sweep_records(root / "proc" / "store.jsonl")
    if proc_records != serial_records:
        raise AssertionError(f"runtime: the stores differ by decision vector "
                             f"({len(proc_records)} against {len(serial_records)} records)")
    workers = {pid: lines for pid, lines in _acc_logs(logs).items() if pid != parent}
    if len(workers) < RUNTIME_WORKERS:
        raise AssertionError(f"runtime: {len(workers)} worker processes trained, "
                             f"{RUNTIME_WORKERS} workers and {rec['respawns']} respawns ran")
    for pid, lines in workers.items():
        if lines[-1]["launches"] == 0:
            raise AssertionError(f"runtime: worker {pid} trained {len(lines)} candidates "
                                 f"without launching ibn_pointwise")
    worker_launches = {pid: lines[-1]["launches"] for pid, lines in workers.items()}
    stats = proc.store_stats
    print(f"runtime: process sweep, {RUNTIME_WORKERS} spawned workers, fault "
          f"{RUNTIME_FAULT!r}: wall {proc_wall:.2f} s; histories, winners and store records "
          f"(by decision vector) bitwise the serial sweep's; recovery {rec}; "
          f"{stats['puts']} evaluations for {stats['gets']} lookups across "
          f"{stats['workers']} worker incarnations (hit rate {stats['hit_rate']:.4f})  [{card}]")
    for pid, lines in workers.items():
        first = lines[0]
        print(f"runtime: worker pid {pid}: card {first['device']} (CUDA_VISIBLE_DEVICES="
              f"{first['visible']}), {len(lines)} candidates trained, "
              f"{worker_launches[pid]} ibn_pointwise launches; its first candidate's "
              f"training began {first['age_at_first_candidate_s']:.2f} s after the process "
              f"started (its PPO controller's first CUDA call made the context before "
              f"it)  [{card}]")
    print(f"runtime: workers' seconds from spawn to ready (process start, torch and "
          f"module imports, store load), per incarnation: {proc.ready_s}  [{card}]")

    # a budgeted run is interrupted; an unbudgeted resume completes it. The
    # serial run's memoised accuracies stand in for the training: this part
    # holds the checkpoints, not the proxy
    budget_dir = root / "budget"
    budget = Budget(max_samples=RUNTIME_BUDGET)
    try:
        runner(signal=serial_runner.acc_fn).run(runtime=SearchRuntime.at(
            budget_dir, budget_dir / "store.jsonl", budget=budget))
    except SearchInterrupted as e:
        interrupted = f"{e.tag} at {e.samples_done}/{e.samples}"
    else:
        raise AssertionError("runtime: the budgeted sweep was not interrupted")
    resumed_rt = SearchRuntime.at(budget_dir, budget_dir / "store.jsonl")
    resumed = runner(signal=serial_runner.acc_fn).run(runtime=resumed_rt)
    resumed_rt.store.close()
    _same_sweep("resumed sweep", resumed, serial)

    # a second run over the finished store, fresh checkpoints and a fresh
    # accuracy signal: every lookup hits the durable store
    reset_counts()
    rerun_rt = SearchRuntime.at(root / "rerun", root / "serial" / "store.jsonl")
    rerun = runner().run(runtime=rerun_rt)
    rerun_rt.store.close()
    _same_sweep("rerun", rerun, serial)
    if rerun_rt.store.appended != 0 or rerun.store_stats["puts"] != 0 or ibn_conv.LAUNCHES:
        raise AssertionError(f"runtime: the rerun evaluated {rerun.store_stats['puts']} "
                             f"candidates over the finished store")
    print(f"runtime: budget {RUNTIME_BUDGET} of {n_scen * search_cfg.samples} samples "
          f"interrupted {interrupted}; the resume completed it to the serial result; a "
          f"rerun over the finished store: 0 new records, hit rate "
          f"{rerun.store_stats['hit_rate']:.4f}, 0 launches  [{card}]")
    return {"serial_wall_s": serial_wall, "process_wall_s": proc_wall,
            "parent_launches": parent_launches, "worker_launches": worker_launches,
            "launches": parent_launches + sum(worker_launches.values()),
            "recovery": rec, "ready_s": proc.ready_s,
            "age_at_first_candidate_s": {pid: lines[0]["age_at_first_candidate_s"]
                                         for pid, lines in workers.items()},
            "serial_store": serial.store_stats, "process_store": stats,
            "records": len(serial_records), "interrupted": interrupted,
            "rerun_hit_rate": rerun.store_stats["hit_rate"]}


def _dumps(rec) -> str:
    return json.dumps(rec, default=str)


def _serve_workload(records: list) -> tuple[list, list]:
    """Every registered scenario, the runtime preset's and seeded ad-hoc
    envelopes spread over the frontier's own latency, energy and area
    ranges (hard and soft), then the pool tiled ``SERVE_TIER_REPEATS`` times
    and shuffled so the answer cache sees re-asks: (pool, queries)."""
    rng = np.random.default_rng(0)
    lat = [r["latency_ms"] for r in records]
    energy = [r["energy_mj"] for r in records if r.get("energy_mj") is not None]
    area = [r["area_mm2"] for r in records]
    pool = [scenarios.get(n) for n in scenarios.names()]
    pool += scenarios.expand([RUNTIME_PRESET])
    for i in range(SERVE_TIER_ADHOC):
        kw = {"name": f"adhoc-{i}", "mode": "hard" if rng.random() < 0.7 else "soft",
              "area_target_mm2": float(rng.uniform(0.5 * min(area), 1.5 * max(area)))}
        if rng.random() < 0.6:
            kw["latency_target_ms"] = float(rng.uniform(0.5 * min(lat), 1.5 * max(lat)))
        else:
            kw["energy_target_mj"] = float(rng.uniform(0.5 * min(energy), 1.5 * max(energy)))
        pool.append(scenarios.Scenario(**kw))
    queries = pool * SERVE_TIER_REPEATS
    rng.shuffle(queries)
    return pool, queries


@contextlib.contextmanager
def _recorded_admissions():
    """The admission module's ``SearchExecutor`` swapped for a subclass that
    keeps, per admitted search, its job, status, wall s, the candidates its
    accuracy memo trained (misses) and its history."""
    runs = []

    class Executor(serve_admission.SearchExecutor):
        def run(self, jobs):
            t0 = time.perf_counter()
            report = super().run(jobs)
            wall = time.perf_counter() - t0
            for job in jobs:
                o = report.outcomes[job.name]
                runs.append({"job": job.name, "status": o.status, "wall_s": wall,
                             "trained": job.kwargs["acc_fn"].misses,
                             "history": None if o.result is None else o.result.history})
            return report

    saved = serve_admission.SearchExecutor
    serve_admission.SearchExecutor = Executor
    try:
        yield runs
    finally:
        serve_admission.SearchExecutor = saved


def _store_by_key(path: Path) -> dict:
    return {k: raw for k, raw, _ in DurableRecordStore(path, read_only=True).entries()}


def serve_tier_phase(card: str, root: Path) -> dict:
    """The serve tier over the runtime phase's store (``root/store.jsonl``):
    compact and reload, serve a tiled workload against brute force, then
    admit two searches at once that train on the card."""
    store_path = root / "store.jsonl"
    out: dict = {}

    # 1. compact and reload
    t0 = time.perf_counter()
    header, info = snapshot_store(store_path, root / "a.snap")
    out["build_ms"] = (time.perf_counter() - t0) * 1e3
    snapshot_store(store_path, root / "b.snap")
    if (root / "a.snap").read_bytes() != (root / "b.snap").read_bytes():
        raise AssertionError("serve_tier: two snapshots of one store differ")
    load_ms = {}
    for verify in (True, False):
        t0 = time.perf_counter()
        snap = load_snapshot(root / "a.snap", verify=verify)
        frontier = snap.frontier()
        load_ms[verify] = (time.perf_counter() - t0) * 1e3
    want, _ = load_store_frontier(store_path)
    if [_dumps(r) for r in frontier.records()] != [_dumps(r) for r in want.records()]:
        raise AssertionError("serve_tier: the snapshot's records are not the store's")
    bad = bytearray((root / "a.snap").read_bytes())
    bad[-3] ^= 0xFF  # the control: one payload byte flipped
    (root / "bad.snap").write_bytes(bytes(bad))
    try:
        load_snapshot(root / "bad.snap", verify=True)
    except ValueError as e:
        control = str(e)
    else:
        raise AssertionError("serve_tier: a flipped payload byte passed verify")
    cold = []
    for _ in range(SERVE_TIER_COLD_REPS):
        t0 = time.perf_counter()
        f, _ = load_store_frontier(store_path)
        f.best(scenarios.get(MAIN_PATH_SCENARIO))
        cold.append((time.perf_counter() - t0) * 1e3)
    out.update(records=info["records"], frontier=header["count"],
               load_verified_ms=load_ms[True], load_unverified_ms=load_ms[False],
               cold_reload_ms=float(np.median(cold)), control=control)
    print(f"serve_tier: {info['records']} records of the runtime phase's serial store, "
          f"frontier {header['count']}: snapshot built in {out['build_ms']:.3f} ms (two "
          f"builds bitwise equal), loaded in {load_ms[True]:.3f} ms verified / "
          f"{load_ms[False]:.3f} ms unverified, records equal to the store's; cold JSONL "
          f"reload + one query {out['cold_reload_ms']:.3f} ms (median of "
          f"{SERVE_TIER_COLD_REPS}); a flipped payload byte fails verify  [{card}]")

    # 2. serve: every answer against brute force, no evaluation, no launch
    server = FrontierServer(frontier)
    records = server.records()
    pool, queries = _serve_workload(records)
    want_best = {id(sc): _dumps(brute_force_best(records, sc)) for sc in pool}
    torch.cuda.synchronize()
    reset_counts()
    got = [None] * len(queries)
    lat_ns = np.empty(len(queries))
    t_all = time.perf_counter()
    for i, sc in enumerate(queries):
        t0 = time.perf_counter_ns()
        got[i] = server.best(sc)
        lat_ns[i] = time.perf_counter_ns() - t0
    wall = time.perf_counter() - t_all
    launched = sum(launch_counts().values())
    wrong = sum(_dumps(g) != want_best[id(sc)] for g, sc in zip(got, queries))
    if wrong or server.stats.evaluations != 0 or launched != 0:
        raise AssertionError(f"serve_tier: {wrong} answers differ from brute force, "
                             f"{server.stats.evaluations} evaluations, {launched} launches")
    out.update(queries=len(queries), distinct=len(pool), qps=len(queries) / wall,
               p50_us=float(np.percentile(lat_ns, 50) / 1e3),
               p99_us=float(np.percentile(lat_ns, 99) / 1e3),
               cache_hit_rate=server.stats.cache_hit_rate, stats=server.stats.as_dict())
    print(f"serve_tier: {len(queries)} queries ({len(pool)} distinct: "
          f"{len(scenarios.names())} registered, the {RUNTIME_PRESET} preset, "
          f"{SERVE_TIER_ADHOC} ad-hoc; x{SERVE_TIER_REPEATS}, shuffled) all equal to "
          f"brute_force_best; evaluations 0, 0 kernel launches; warm p50 "
          f"{out['p50_us']:.3f} us, p99 {out['p99_us']:.3f} us, {out['qps']:.1f} queries/s, "
          f"cache hit rate {out['cache_hit_rate']:.4f}  [{card}]")

    # 3. admit two uncovered envelopes at once; their searches train on the card
    least = min(r["latency_ms"] for r in records)
    envelopes = [scenarios.Scenario(name=f"admit-{f}x", latency_target_ms=f * least)
                 for f in SERVE_TIER_TARGETS]
    acc = TrainedAccuracy(**SERVE_TIER_TRAIN, device=DEV)
    acc.prepare()  # K1 is built here, never in an admission thread
    cfg = dataclasses.replace(SERVE_TIER_ADMISSION, device=DEV)
    space = nas.s1_mobilenetv2()
    with _recorded_admissions() as runs:
        adm_server = FrontierServer(snap.frontier())
        store = DurableRecordStore(store_path)
        ctl = AdmissionController(adm_server, space, acc, cfg, store=store)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        first = [ctl.query(sc) for sc in envelopes]
        for a in first:
            if a.status != "searching":
                raise AssertionError(f"serve_tier: {a.scenario.name} was {a.status}, "
                                     f"not admitted")
            a.future.result()
        torch.cuda.synchronize()
        adm_wall = time.perf_counter() - t0
        launches = ibn_conv.LAUNCHES
        again = [ctl.query(sc) for sc in envelopes]
        ctl.close()
        store.close()
        if ctl.admitted != 2 or ctl.failed != 0:
            raise AssertionError(f"serve_tier: {ctl.admitted} admissions, {ctl.failed} "
                                 f"failed, after re-asking")
        if launches == 0 or adm_server.stats.folds < 1:
            raise AssertionError(f"serve_tier: {launches} launches, "
                                 f"{adm_server.stats.folds} folds")
        folded = adm_server.records()
        for a in again:
            if a.status not in ("served", "exhausted"):
                raise AssertionError(f"serve_tier: re-asking {a.scenario.name}: {a.status}")
            if _dumps(a.answer["best"]) != _dumps(brute_force_best(folded, a.scenario)):
                raise AssertionError(f"serve_tier: {a.scenario.name}'s answer after the "
                                     f"fold is not brute force's")
        together = {r["job"]: r for r in runs}
        shared = _store_by_key(store_path)

        # each search alone, into a store of its own, so that it trains
        lone = {}
        for sc in envelopes:
            lone_store = DurableRecordStore(root / f"lone-{sc.name}.jsonl")
            lone_ctl = AdmissionController(FrontierServer(snap.frontier()), space,
                                           dataclasses.replace(acc), cfg, store=lone_store)
            reset_counts()
            lone_ctl.query(sc, wait=True)
            torch.cuda.synchronize()
            lone_ctl.close()
            lone_store.close()
            run = runs[-1]
            if run["job"] != f"sweep.{sc.name}" or run["status"] != "done" or lone_ctl.failed:
                raise AssertionError(f"serve_tier: the lone run of {sc.name} failed")
            if together[run["job"]]["history"] != run["history"]:
                raise AssertionError(f"serve_tier: {sc.name}'s admitted search is not "
                                     f"bitwise its lone run")
            mine = _store_by_key(root / f"lone-{sc.name}.jsonl")
            if any(shared.get(k) != raw for k, raw in mine.items()):
                raise AssertionError(f"serve_tier: the shared store's records of "
                                     f"{sc.name}'s candidates are not its lone run's")
            lone[sc.name] = {"launches": ibn_conv.LAUNCHES, "trained": run["trained"],
                             "wall_s": run["wall_s"], "records": len(mine)}
    admissions = []
    for sc, a in zip(envelopes, again):
        r = together[f"sweep.{sc.name}"]
        admissions.append({"scenario": sc.name, "target_ms": sc.latency_target_ms,
                           "status": a.status, "wall_s": r["wall_s"],
                           "trained": r["trained"], "feasible": a.answer["feasible"],
                           "lone": lone[sc.name]})
        print(f"serve_tier: admitted {sc.name} (lat <= {sc.latency_target_ms:.6f} ms, the "
              f"frontier's least {least:.6f}): {a.status} after the fold, search wall "
              f"{r['wall_s']:.2f} s, {r['trained']} candidates trained (alone: "
              f"{lone[sc.name]['trained']} in {lone[sc.name]['wall_s']:.2f} s, "
              f"{lone[sc.name]['launches']} K1 launches), history and store records "
              f"bitwise its lone run's; answer feasible={a.answer['feasible']}  [{card}]")
    out.update(admissions=admissions, launches=launches, admission_wall_s=adm_wall,
               folds=adm_server.stats.folds, folded_frontier=len(folded))
    print(f"serve_tier: 2 searches admitted at once (budget {cfg.budget_samples} samples, "
          f"batch {cfg.batch}, {cfg.controller} on {DEV}, TrainedAccuracy"
          f"({SERVE_TIER_TRAIN}) on {DEV}): wall {adm_wall:.2f} s, {launches} ibn_pointwise "
          f"launches, {adm_server.stats.folds} folds, frontier {header['count']} -> "
          f"{len(folded)}; re-asking admits nothing  [{card}]")
    return out


def profile_phase(card: str) -> dict:
    """Where one search candidate's training step spends its time: the S1
    space's seed architecture (MobileNetV2) at the proxy's 32 px, batch 64.
    Wall time per step without the profiler, device time per step by kernel
    from ``torch.profiler`` over 3 steps."""
    from torch.profiler import ProfilerActivity, profile

    spec = C.mobilenet_v2(10, 32)
    params = C.init(0, spec, device="cuda")
    rng = np.random.default_rng(1)
    images = torch.from_numpy(rng.normal(size=(64, 32, 32, 3)).astype(np.float32)).cuda()
    labels = torch.from_numpy(rng.integers(0, 10, size=64)).cuda()
    steps = 3

    def run():
        nonlocal params
        for _ in range(steps):
            params, _ = train_step(params, images, labels, spec, 0.05)
        torch.cuda.synchronize()

    run()  # warm-up
    before = ibn_conv.LAUNCHES
    t0 = time.perf_counter()
    run()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    launches = (ibn_conv.LAUNCHES - before) / steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
    per_kernel = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            per_kernel[e.key] = us / 1e3 / steps
    device_ms = sum(per_kernel.values())
    ibn_ms = sum(v for k, v in per_kernel.items() if K1_SYMBOL in k)
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:6]
    if device_ms == 0.0:
        print(f"profile: train_step {wall_ms:.2f} ms; device time not measured (the "
              f"profiler saw no CUDA activity)  [{card}]")
    else:
        print(f"profile: train_step (mobilenet_v2, 32 px, batch 64) {wall_ms:.2f} ms wall, "
              f"{device_ms:.3f} ms on the device ({device_ms / wall_ms:.1%} busy), "
              f"ibn_pointwise {ibn_ms:.3f} ms ({ibn_ms / device_ms:.1%} of device time, "
              f"{launches:.0f} launches per step), {len(per_kernel)} kernel names  [{card}]")
        for name, ms in top:
            print(f"profile:   {ms:.4f} ms/step  {name[:90]}")
    return {"wall_ms": wall_ms, "device_ms": device_ms, "ibn_ms": ibn_ms,
            "launches_per_step": launches, "per_kernel_ms": per_kernel}


def _oneshot_base() -> C.ConvNetSpec:
    """Full-width MobileNetV2 as the oneshot search sizes it: 10 classes, 32 px."""
    return C.mobilenet_v2(10, 32)


def _leaf_errs(got, want) -> list[float]:
    """Per leaf, max |got - want| over max(1, max |want|), both on the CPU."""
    return [((g.cpu().float() - w.float()).abs().max()
             / max(1.0, w.float().abs().max().item())).item()
            for g, w in zip(tree_leaves(got), tree_leaves(want))]


def _grad_errs(got, want) -> list[float]:
    """Per leaf, max |got - want| over max |want|: 0 where both are all 0,
    inf where only ``want`` is. A step's update (lr times the gradient) lies
    far below the parameters' rounding, so the step's gradient is held leaf
    by leaf on its own scale. Taken on ``got``'s device (the same IEEE
    arithmetic as on the CPU, without the CPU's minutes at full width)."""
    errs = []
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        w = w.to(g.device)
        diff, scale = (g - w).abs().max().item(), w.abs().max().item()
        errs.append(diff / scale if scale else (0.0 if diff == 0 else math.inf))
    return errs


PLANTED_FAULTS = ("block0_expand_dw_dropped", "unselected_branch_cotangent")


@contextlib.contextmanager
def _planted(fault: str):
    """A fault the supernet's gradient check must see, for the length of a
    ``with``: block 0's expand conv with no weight gradient (K1's dw left
    out; the same weight values), or the unselected branch of every block
    taking the cotangent too (the forward unchanged)."""
    pointwise, where, calls = C._pointwise, torch.where, []

    def faulty(x, w, act="none"):
        calls.append(w)
        return pointwise(x, w.detach() + 0 * w if len(calls) == 1 else w, act)

    def leaky(cond, a, b):
        return where(cond, a.detach(), b.detach()) + (a - a.detach()) + (b - b.detach())

    if fault == "block0_expand_dw_dropped":
        C._pointwise = faulty
    else:
        torch.where = leaky
    try:
        yield
    finally:
        C._pointwise, torch.where = pointwise, where


def costmodel_phase(card: str) -> dict:
    """Sec. 3.5.2's cost model as the oneshot search uses it: labelled on the
    search's own joint space (its features are what the loop queries),
    trained on the card, then held card against CPU."""
    nas_space = oneshot.oneshot_space(_oneshot_base())
    has_space = has.has_space()
    t0 = time.perf_counter()
    feats, lat, area, energy = costmodel.generate_dataset(
        nas_space, has_space, COST_POINTS, seed=0, include_energy=True)
    label_s = time.perf_counter() - t0
    cfg = COST_CONFIG
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model, metrics = costmodel.train(feats, lat, area, cfg, energy_mj=energy, device=DEV)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    if not all(math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"costmodel: non-finite metrics {metrics}")
    print(f"costmodel: labelled {COST_POINTS} points of oneshot(mobilenet_v2, 32 px) x has "
          f"({feats.shape[1]} features) in {label_s:.2f} s of host time; trained "
          f"{cfg.steps} steps (3 x {cfg.hidden}, dropout {cfg.dropout}, batch {cfg.batch}, "
          f"energy head) on {DEV} in {train_s:.2f} s, {train_s / cfg.steps * 1e3:.4f} ms per "
          f"step; validation MAPE latency {metrics['val_latency_mape']:.4f} area "
          f"{metrics['val_area_mape']:.4f} energy {metrics['val_energy_mape']:.4f}, latency "
          f"R2 {metrics['val_latency_r2']:.4f}  [{card}]")

    # card against CPU: the trained model's forward, then 3 steps from one init
    x = torch.from_numpy(feats[:8192].astype(np.float32))
    cpu_params = tree_map(lambda t: t.cpu(), model.params)
    with torch.no_grad():
        got = costmodel.mlp_forward_all(model.params, x.to(DEV))
        want = costmodel.mlp_forward_all(cpu_params, x)
    fwd_err = max(((g.cpu() - w).abs().max() / w.abs().max()).item()
                  for g, w in zip(got, want))
    few = dataclasses.replace(cfg, steps=3, dropout=0.0)
    on_card, _ = costmodel.train(feats, lat, area, few, energy_mj=energy, device=DEV)
    on_cpu, _ = costmodel.train(feats, lat, area, few, energy_mj=energy, device="cpu")
    step_err = max(_leaf_errs(on_card.params, on_cpu.params))
    print(f"costmodel: card vs CPU forward {fwd_err:.3g} of max |output| (limit "
          f"{COST_FWD_TOL}); 3 steps, dropout 0, from one init: params {step_err:.3g} per "
          f"leaf (limit {COST_STEP_TOL})  [{card}]")
    if fwd_err > COST_FWD_TOL or step_err > COST_STEP_TOL:
        raise AssertionError(f"costmodel: card vs CPU {fwd_err}, {step_err}")
    return {"model": model, "metrics": metrics, "label_s": label_s, "train_s": train_s,
            "ms_per_step": train_s / cfg.steps * 1e3, "n_features": int(feats.shape[1]),
            "fwd_err": fwd_err, "step_err": step_err}


def _oneshot_draws(n: int) -> dict:
    """(ks, exps, ops) for all-IBN, all-fused and two mixed draws."""
    i = np.arange(n)
    return {"all_ibn": (np.full(n, 7), np.full(n, 6), np.zeros(n, int)),
            "all_fused": (np.full(n, 3), np.full(n, 3), np.ones(n, int)),
            "mixed_a": (3 + 2 * (i % 3), np.where(i % 2, 3, 6), i % 2),
            "mixed_b": (7 - 2 * (i % 3), np.where(i % 2, 6, 3), 1 - i % 2)}


def _conv_ms(prof, steps_run: int) -> float:
    """Device ms per step of the fused 7×7 convolutions (not the depthwise
    ones), forward and backward, from the ops' input shapes."""
    total = 0.0
    for e in prof.key_averages(group_by_input_shape=True):
        if e.key not in ("aten::convolution", "aten::convolution_backward"):
            continue
        shapes = e.input_shapes or []
        weight = shapes[1] if e.key == "aten::convolution" else shapes[2]
        if len(weight) == 4 and weight[2:] == [7, 7] and weight[1] > 1:
            us = getattr(e, "device_time_total", None)
            total += (e.cuda_time_total if us is None else us) / 1e3
    return total / steps_run


def oneshot_phase(card: str, cost_model) -> dict:
    from torch.profiler import ProfilerActivity, profile

    base = _oneshot_base()
    n = len(base.blocks)
    per_forward = 2 * n + 1  # expand and project per block, and the head
    rcfg = scenarios.get(MAIN_PATH_SCENARIO).reward_config()
    cfg = oneshot.OneshotConfig(steps=ONESHOT_STEPS, batch=64, image_size=32, seed=0,
                                device=DEV)
    warmup = int(cfg.steps * cfg.warmup_frac)
    expected = 3 * per_forward * cfg.steps + per_forward * len(
        range(warmup, cfg.steps, cfg.controller_every))
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    res = oneshot.oneshot_search(base, rcfg, cfg, cost_model=cost_model)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    if launches["ibn_pointwise"] != expected:
        raise AssertionError(f"oneshot: {launches} kernel launches, expected {expected} of "
                             f"ibn_pointwise")
    hist = res["history"]
    valid = [h for h in hist if h["valid"]]
    if not hist or not all(math.isfinite(h["loss"]) for h in hist):
        raise AssertionError("oneshot: no history or a non-finite loss")
    arch, hw = res["best_arch"], res["best_hw"]
    sim = simulator.simulate_safe(arch, hw)
    blocks = [(b.kernel, b.expansion, b.op) for b in arch.blocks]
    print(f"oneshot: mobilenet_v2 supernet ({n} blocks, 32 px, batch 64), {cfg.steps} steps "
          f"(warmup {warmup}), REINFORCE on {DEV}, cost model in the loop, scenario "
          f"{MAIN_PATH_SCENARIO}: wall {wall:.2f} s, {wall / cfg.steps * 1e3:.2f} ms per "
          f"supernet step with its controller step; {launches['ibn_pointwise']} ibn_pointwise "
          f"launches ({3 * per_forward} per train step, {per_forward} per validation "
          f"forward); valid share {len(valid) / len(hist):.3f}; last losses "
          f"{[round(h['loss'], 4) for h in hist[-3:]]}  [{card}]")
    print(f"oneshot: best arch (k, exp, op) per block {blocks}; best hw {hw}; simulated "
          + ("invalid" if sim is None else
             f"latency {sim['latency_ms']:.4f} ms area {sim['area_mm2']:.2f} mm^2 energy "
             f"{sim['energy_mj']:.4f} mJ") + f"  [{card}]")

    # card against CPU at full width: logits and one SGD step per draw
    rng = np.random.default_rng(4)
    images = torch.from_numpy(rng.normal(size=(ONESHOT_CHECK_BATCH, 32, 32, 3))
                              .astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 10, size=ONESHOT_CHECK_BATCH))
    params = oneshot.init_supernet(0, base, device=DEV)
    cpu_params = tree_map(lambda t: t.cpu(), params)
    checks = {}
    for name, (ks, exps, ops) in _oneshot_draws(n).items():
        with torch.no_grad():
            got = oneshot.supernet_forward(params, images.to(DEV), base, ks, exps, ops)
            want = oneshot.supernet_forward(cpu_params, images, base, ks, exps, ops)
        logit_err = ((got.cpu() - want).abs().max() / want.abs().max()).item()
        new, loss = oneshot.train_step(params, images.to(DEV), labels.to(DEV), base, ks, exps,
                                       ops, cfg.lr)
        new_cpu, loss_cpu = oneshot.train_step(cpu_params, images, labels, base, ks, exps,
                                               ops, cfg.lr)
        step_err = max(_leaf_errs(new, new_cpu))
        _, grads_cpu = oneshot.loss_and_grads(cpu_params, images, labels, base, ks, exps, ops)
        _, grads = oneshot.loss_and_grads(params, images.to(DEV), labels.to(DEV), base, ks,
                                          exps, ops)
        grad_err = max(_grad_errs(grads, grads_cpu))
        checks[name] = {"logit_err": logit_err, "step_err": step_err, "grad_err": grad_err,
                        "loss_err": abs(float(loss) - float(loss_cpu))}
        if not (torch.isfinite(got).all() and got.shape == (ONESHOT_CHECK_BATCH, 10)):
            raise AssertionError(f"oneshot {name}: bad logits {tuple(got.shape)}")
        if max(logit_err, step_err, grad_err) > ONESHOT_TOL:
            raise AssertionError(f"oneshot {name}: card vs CPU {checks[name]}")
        if name == "mixed_a":  # each planted fault must fail the gradient check
            controls = {}
            for fault in PLANTED_FAULTS:
                with _planted(fault):
                    _, bad = oneshot.loss_and_grads(params, images.to(DEV), labels.to(DEV),
                                                    base, ks, exps, ops)
                bad_cpu = tree_map(lambda t: t.cpu(), bad)
                controls[fault] = {"grad_err": max(_grad_errs(bad, grads_cpu)),
                                   "step_err": max(_leaf_errs(
                                       tree_map(lambda p, g: p - cfg.lr * g, cpu_params,
                                                bad_cpu), new_cpu))}
            checks[name]["controls"] = controls
            if not min(c["grad_err"] for c in controls.values()) > ONESHOT_TOL:
                raise AssertionError(f"oneshot: the gradient limit passes a control: "
                                     f"{controls}")
    print(f"oneshot: card vs CPU at full width, batch {ONESHOT_CHECK_BATCH}, fp32: "
          + "; ".join(f"{k} logits {v['logit_err']:.3g} of max |logit|, one SGD step "
                      f"{v['step_err']:.3g} per leaf, its gradient {v['grad_err']:.3g} of "
                      f"the leaf's max" for k, v in checks.items())
          + f" (limit {ONESHOT_TOL}); planted faults on the card fail the gradient check: "
          + ", ".join(f"{f} {c['grad_err']:.3g} (the step's parameters "
                      f"{c['step_err']:.3g})" for f, c in controls.items()) + f"  [{card}]")

    # 3 supernet steps of a mixed draw: wall without the profiler, device with it
    ks, exps, ops = _oneshot_draws(n)["mixed_a"]
    b = rng.normal(size=(64, 32, 32, 3)).astype(np.float32)
    x = torch.from_numpy(b).to(DEV)
    y = torch.from_numpy(rng.integers(0, 10, size=64)).to(DEV)
    steps = 3

    def run():
        nonlocal params
        for _ in range(steps):
            params, _ = oneshot.train_step(params, x, y, base, ks, exps, ops, cfg.lr)
        torch.cuda.synchronize()

    run()  # warm-up
    before = ibn_conv.LAUNCHES
    t0 = time.perf_counter()
    run()
    step_ms = (time.perf_counter() - t0) * 1e3 / steps
    per_step = (ibn_conv.LAUNCHES - before) / steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        run()
    per_kernel = _device_times(prof, steps)
    device_ms = sum(per_kernel.values())
    fused_ms = _conv_ms(prof, steps)
    shares = _print_breakdown(f"supernet step (mobilenet_v2, 32 px, batch 64, {per_step:.0f} "
                              f"ibn_pointwise launches; fused 7x7 convs {fused_ms:.3f} ms)",
                              step_ms, per_kernel, card, phase="oneshot",
                              kernels=(("ibn_pointwise", K1_SYMBOL),))
    if per_step != 3 * per_forward:
        raise AssertionError(f"oneshot: {per_step} launches per supernet step, expected "
                             f"{3 * per_forward}")
    return {"wall_s": wall, "steps": cfg.steps, "warmup": warmup,
            "launches": launches["ibn_pointwise"], "expected_launches": expected,
            "valid_share": len(valid) / len(hist), "best_blocks": blocks, "best_hw": str(hw),
            "best_sim": sim, "checks": checks, "step_ms": step_ms, "device_ms": device_ms,
            "ibn_ms": shares["ibn_pointwise"], "fused_conv_ms": fused_ms,
            "launches_per_step": per_step,
            "top": sorted(per_kernel.items(), key=lambda kv: -kv[1])[:6]}


def attention_bound_parts_ms(b, h, kv, sq, skv, hd, causal, dtype) -> tuple[float, float]:
    """The two lower bounds of one attention call in ms: bytes (q, k, v read
    once, o written once) over the memory rate, and 4·hd operations per
    unmasked (q, k) pair over the peak rate for the input type."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    nbytes = itemsize * (2 * b * h * sq * hd + 2 * b * kv * skv * hd)
    pairs = sum(min(i + 1, skv) for i in range(sq)) if causal else sq * skv
    return (nbytes / HBM_BYTES_PER_S * 1e3,
            4.0 * hd * pairs * b * h / PEAK_FLOP_PER_S[dtype] * 1e3)


def attention_inputs(b, h, kv, sq, skv, hd, dtype, gen, layout: str):
    """q (B, H, Sq, hd), k and v (B, KV, Skv, hd) from N(0, 1): transposed
    views of (B, S, H, hd) tensors ("bshd"), as ``ops.flash_attention``
    passes the model's, or contiguous ("bhsd")."""
    def draw(heads, rows):
        if layout == "bshd":
            t = torch.randn((b, rows, heads, hd), generator=gen, device=DEV)
            return t.to(dtype).transpose(1, 2)
        return torch.randn((b, heads, rows, hd), generator=gen, device=DEV).to(dtype)

    return draw(h, sq), draw(kv, skv), draw(kv, skv)


def row_rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest |got - want| of each row over the row's largest |want|,
    the worst row."""
    err = (got.float() - want.float()).abs().amax(dim=-1)
    return (err / want.float().abs().amax(dim=-1).clamp_min(1e-30)).max().item()


def check_attention(b, h, kv, sq, skv, hd, causal, dtype, gen, timed: bool,
                    layout: str = "bshd") -> dict:
    """flash_attention against its plain version on the card."""
    q, k, v = attention_inputs(b, h, kv, sq, skv, hd, dtype, gen, layout)
    out = flash_attention.launch(q, k, v, causal=causal)[0]
    want = flash_attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    err = (out.float() - want.float()).abs().max().item()
    rec = {"shape": (b, h, kv, sq, skv, hd), "causal": causal, "dtype": str(dtype)[6:],
           "layout": layout, "max_abs_err": err, "tol": ATTN_TOL[dtype]}
    ok = err <= ATTN_TOL[dtype]
    if dtype == torch.bfloat16:
        rec["row_rel_err"] = row_rel_err(out, want)
        ok = ok and rec["row_rel_err"] <= ATTN_ROW_TOL
    if not ok:
        raise AssertionError(f"flash_attention disagrees with its plain version: {rec}")
    if timed:
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lib = sdpa(q, k, v, is_causal=causal, enable_gqa=True)
        rec["library_err"] = (lib.float() - want.float()).abs().max().item()
        rec["ms"] = time_ms(lambda: flash_attention.launch(q, k, v, causal=causal)[0])
        rec["plain_ms"] = time_ms(lambda: flash_attention_ref(q, k, v, causal=causal))
        rec["library_ms"] = time_ms(lambda: sdpa(q, k, v, is_causal=causal, enable_gqa=True))
        rec["bound_bytes_ms"], rec["bound_ops_ms"] = attention_bound_parts_ms(
            b, h, kv, sq, skv, hd, causal, dtype)
        rec["bound_ms"] = max(rec["bound_bytes_ms"], rec["bound_ops_ms"])
        rec["bound_by"] = ("bytes" if rec["bound_bytes_ms"] >= rec["bound_ops_ms"]
                           else "operations")
        if dtype == torch.bfloat16:
            # controls of the bf16 checks on these inputs: the plain version
            # with p and o kept in fp32, a rounding the checks must pass, and
            # with the last kv tile (64 keys) dropped, a fault they must catch
            fp32 = flash_attention_ref(q.float(), k.float(), v.float(), causal=causal)
            drop = flash_attention_ref(q, k[:, :, :-64], v[:, :, :-64], causal=causal)
            rec["controls"] = {
                name: {"max_abs_err": (c.float() - want.float()).abs().max().item(),
                       "row_rel_err": row_rel_err(c, want)}
                for name, c in (("fp32_p", fp32), ("dropped_tile", drop))}
            if not (rec["controls"]["fp32_p"]["row_rel_err"] <= ATTN_ROW_TOL
                    < rec["controls"]["dropped_tile"]["row_rel_err"]):
                raise AssertionError(f"the per-row bf16 check does not tell the controls "
                                     f"apart: {rec['controls']}")
    return rec


def attention_bwd_bound_parts_ms(b, h, kv, sq, skv, hd, causal,
                                 dtype) -> tuple[float, float]:
    """The two lower bounds of one attention backward in ms: bytes (q, k, v,
    o, do and the fp32 log-sum-exp read once, dq, dk, dv written once) over
    the memory rate, and its five products' 10·hd operations per unmasked
    (q, k) pair over the peak rate for the input type."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    nbytes = itemsize * (4 * b * h * sq * hd + 4 * b * kv * skv * hd) + 4 * b * h * sq
    pairs = sum(min(i + 1, skv) for i in range(sq)) if causal else sq * skv
    return (nbytes / HBM_BYTES_PER_S * 1e3,
            10.0 * hd * pairs * b * h / PEAK_FLOP_PER_S[dtype] * 1e3)


# the backward's shapes: every head_dim at a ragged length with G 2, causal
# with sq != skv both ways, G 2 at hd 112 and 80 over long ragged lengths,
# cross-attention, MQA at hd 256, one row, and the served shape
ATTN_BWD_SHAPES = ([(1, 4, 2, 130, 130, hd, True) for hd in flash_attention.HEAD_DIMS]
                   + [(1, 4, 2, 96, 160, 32, True), (2, 4, 1, 160, 96, 16, True),
                      (1, 8, 4, 1000, 1025, 112, True), (2, 4, 2, 300, 1025, 80, False),
                      (1, 8, 1, 1025, 1000, 256, True), (2, 4, 2, 1, 1, 128, True),
                      SERVE_ATTN[:4] + SERVE_ATTN[3:] + (True,)])


def check_attention_backward(b, h, kv, sq, skv, hd, causal, dtype, gen) -> dict:
    """The backward kernels (``launch_bwd`` on the forward kernel's output
    and log-sum-exp) against the plain backward on the same inputs, on the
    model's (B, S, H, hd) views; a second call must give bitwise the same
    gradients."""
    q, k, v = attention_inputs(b, h, kv, sq, skv, hd, dtype, gen, "bshd")
    do = torch.randn((b, sq, h, hd), generator=gen, device=DEV).to(dtype).transpose(1, 2)
    o, lse = flash_attention.launch(q, k, v, causal=causal, with_lse=True)
    got = flash_attention.launch_bwd(q, k, v, o, lse, do, causal=causal)
    again = flash_attention.launch_bwd(q, k, v, o, lse, do, causal=causal)
    want = flash_attention_bwd(q, k, v, o, do, causal=causal)
    torch.cuda.synchronize()
    rec = {"shape": (b, h, kv, sq, skv, hd), "causal": causal, "dtype": str(dtype)[6:],
           "rel_err": {n: _grad_rel(g, w) for n, g, w in zip(("dq", "dk", "dv"), got, want)},
           "max_abs_err": max((g.float() - w.float()).abs().max().item()
                              for g, w in zip(got, want)),
           "bitwise": all(torch.equal(a, c) for a, c in zip(got, again)),
           "tol": BWD_TOL[dtype]}
    finite = all(torch.isfinite(g.float()).all() for g in got)
    if not (finite and rec["bitwise"] and max(rec["rel_err"].values()) <= BWD_TOL[dtype]):
        raise AssertionError(f"the flash_attention backward disagrees with the plain "
                             f"backward: {rec}")
    return rec


def attention_phase(card: str) -> dict:
    gen = torch.Generator(device=DEV).manual_seed(1)
    records = []
    # tests/test_kernels.py's shapes, causal with sq != skv, the other
    # head_dims of the configs (80, 112, 256) with G 1, 2 and 8 at lengths
    # that are not multiples of the kv tile, one row, and rows shorter than
    # a tile; each in the model's layout and contiguous, which the kernel
    # reads through differently ordered TMA maps
    for shape in ((1, 4, 4, 64, 64, 32, True), (2, 4, 2, 64, 64, 32, True),
                  (1, 8, 1, 128, 128, 64, True), (2, 4, 1, 96, 160, 32, False),
                  (1, 2, 2, 200, 200, 16, True), (1, 4, 2, 96, 160, 32, True),
                  (2, 4, 1, 160, 96, 16, True), (2, 8, 8, 1000, 1000, 80, True),
                  (1, 8, 4, 1000, 1025, 112, True), (1, 8, 1, 1025, 1000, 256, True),
                  (2, 4, 2, 300, 1025, 80, False), (1, 16, 2, 1000, 1000, 112, False),
                  (1, 2, 2, 130, 70, 256, False), (2, 4, 2, 1, 1, 128, True),
                  (1, 4, 4, 40, 77, 64, False)):
        for dtype in (torch.float32, torch.bfloat16):
            for layout in ("bshd", "bhsd"):
                records.append(check_attention(*shape, dtype, gen, timed=False, layout=layout))
    b, h, kv, s, hd = SERVE_ATTN
    ragged = [check_attention(b, h, kv, s + 1, s + 1, hd, True, torch.bfloat16, gen,
                              timed=False, layout=layout) for layout in ("bshd", "bhsd")]
    # timed in the model's layout, which the served prefill gives the kernel,
    # and once contiguous
    main = check_attention(b, h, kv, s, s, hd, True, torch.bfloat16, gen, timed=True)
    contiguous = check_attention(b, h, kv, s, s, hd, True, torch.bfloat16, gen, timed=True,
                                 layout="bhsd")
    # 4 times longer sequences at a quarter of the batch: each item walks 4 times
    # as many kv tiles, so its start and end weigh less
    long = check_attention(b // 4, h, kv, 4 * s, 4 * s, hd, True, torch.bfloat16, gen,
                           timed=True)
    others = {name: check_attention(b, oh, okv, s, s, ohd, oc, torch.bfloat16, gen, timed=True)
              for name, (oh, okv, ohd, oc) in OTHER_ATTN.items()}
    timed_recs = [main, contiguous, long, *others.values()]
    records += ragged + timed_recs
    worst = max(r["max_abs_err"] / r["tol"] for r in records)
    worst_row = max(r["row_rel_err"] for r in records if "row_rel_err" in r)
    print(f"attention: {len(records)} checks against the plain version (fp32 and bf16, "
          f"hd {sorted({r['shape'][5] for r in records})}, causal sq != skv, S {s} and "
          f"{s + 1}, (B, S, H, hd) views and contiguous); worst error {worst:.3g} of its "
          f"tolerance; bf16 per row {worst_row:.3g} (limit {ATTN_ROW_TOL:.3g})  [{card}]")
    print(f"attention: B {b} H {h} KV {kv} S {s} hd {hd} bf16 causal, (B, S, H, hd) views: "
          f"kernel {main['ms']:.4f} ms, plain {main['plain_ms']:.4f} ms, sdpa "
          f"{main['library_ms']:.4f} ms, bound {main['bound_ms']:.4f} ms ({main['bound_by']}; "
          f"bytes {main['bound_bytes_ms']:.4f}, operations {main['bound_ops_ms']:.4f}); "
          f"max |err| {main['max_abs_err']:.3g} (ragged S {s + 1}: "
          f"{max(r['max_abs_err'] for r in ragged):.3g}), sdpa vs plain "
          f"{main['library_err']:.3g}; contiguous: kernel {contiguous['ms']:.4f} ms, sdpa "
          f"{contiguous['library_ms']:.4f} ms  [{card}]")
    for name, rec in [("qwen3-1.7B", main), ("qwen3-1.7B contiguous", contiguous),
                      ("qwen3-1.7B at S 4096", long), *others.items()]:
        flop = rec["bound_ops_ms"] * 1e-3 * PEAK_FLOP_PER_S[torch.bfloat16]
        ctl = rec["controls"]
        print(f"attention: {name} (B, H, KV, Sq, Skv, hd) {rec['shape']} bf16"
              f"{' causal' if rec['causal'] else ''}: kernel {rec['ms']:.4f} ms "
              f"({flop / rec['ms'] / 1e9:.1f} TFLOP/s), sdpa {rec['library_ms']:.4f} ms "
              f"({flop / rec['library_ms'] / 1e9:.1f}), plain {rec['plain_ms']:.4f} ms, bound "
              f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}); max |err| "
              f"{rec['max_abs_err']:.3g}, per row {rec['row_rel_err']:.3g}; controls: fp32 p "
              f"{ctl['fp32_p']['max_abs_err']:.3g} / {ctl['fp32_p']['row_rel_err']:.3g} per "
              f"row, last kv tile dropped {ctl['dropped_tile']['max_abs_err']:.3g} / "
              f"{ctl['dropped_tile']['row_rel_err']:.3g} per row  [{card}]")
    backward = [check_attention_backward(*shape, dtype, gen)
                for shape in ATTN_BWD_SHAPES for dtype in (torch.float32, torch.bfloat16)]
    worst_bwd = max(max(r["rel_err"].values()) / r["tol"] for r in backward)
    bwd_main = backward[-1]
    print(f"attention: backward kernels, {len(backward)} checks against the plain backward "
          f"(fp32 and bf16, hd {sorted({r['shape'][5] for r in backward})}, causal sq != skv, "
          f"ragged, one row, the served shape), each gradient over max(1, its max |plain "
          f"value|): "
          f"worst {worst_bwd:.3g} of its tolerance ({BWD_TOL[torch.float32]} fp32, "
          f"{BWD_TOL[torch.bfloat16]} bf16); every one twice bitwise the same; served shape "
          f"bf16 dq / dk / dv " + " / ".join(f"{v:.3g}" for v in bwd_main["rel_err"].values())
          + f"  [{card}]")
    return {"records": records, "main": main, "contiguous": contiguous, "long": long,
            "others": others, "backward": backward, "backward_main": bwd_main}


def _device_times(prof, steps_run: int) -> dict:
    """Device ms per run by kernel name from a finished torch.profiler."""
    out = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            out[e.key] = us / 1e3 / steps_run
    return out


def _print_breakdown(label: str, wall_ms: float, per_kernel: dict, card: str,
                     phase: str = "serve", kernels=(("flash_attention", "attn_fwd"),)) -> dict:
    """Prints device time, busy share and each named kernel's share (by a
    substring of its symbol); returns {kernel: device ms}."""
    device_ms = sum(per_kernel.values())
    shares = {name: sum(v for k, v in per_kernel.items() if key in k) for name, key in kernels}
    if device_ms == 0.0:
        print(f"{phase}: {label} device time not measured (the profiler saw no CUDA "
              f"activity)  [{card}]")
        return shares
    parts = ", ".join(f"{name} {ms:.3f} ms ({ms / device_ms:.1%} of device time)"
                      for name, ms in shares.items())
    print(f"{phase}: {label} {wall_ms:.2f} ms wall, {device_ms:.3f} ms on the device "
          f"({device_ms / wall_ms:.1%} busy), {parts}, {len(per_kernel)} kernel names  "
          f"[{card}]")
    for name, ms in sorted(per_kernel.items(), key=lambda kv: -kv[1])[:6]:
        print(f"{phase}:   {ms:.4f} ms  {name[:90]}")
    return shares


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


def _prefill_timings(prefill, params, prompt) -> tuple[float, list]:
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill(params, {"tokens": prompt})
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return min(times), times


def _profiled(fn) -> dict:
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return _device_times(prof, 1)


def held_param_count(label: str, cfg, params, card: str) -> int:
    """The materialised tree's element count, held against
    ``launch.roofline.count_params`` (a shape-only init on the meta
    device); for the moe family also its expert stacks' count."""
    n = tree_size(params)
    counts = roofline.count_params(cfg)
    if counts["total"] != n:
        raise AssertionError(f"{label}: count_params total {counts['total']}, weights {n}")
    note = ""
    if cfg.family == "moe":
        expert = sum(params["layers"]["moe"][k].numel() for k in ("wg", "wu", "wo"))
        if counts["expert"] != expert:
            raise AssertionError(f"{label}: count_params expert {counts['expert']}, "
                                 f"wg/wu/wo {expert}")
        note = f", experts {expert} = the wg/wu/wo stacks'"
    print(f"{label}: count_params({cfg.name}) total {counts['total']} = the full-width weights' "
          f"element count{note}  [{card}]")
    return n


def serve_phase(card: str) -> dict:
    run = configs.make_run(SERVE_ARCH, "decode_32k", model_attn_impl="flash_pallas")
    cfg = run.model
    prefill, _, _ = steps.make_prefill_step(run)
    decode, _, _, _ = steps.make_decode_step(run)
    t0 = time.perf_counter()
    params = api.init(0, cfg, device=DEV)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = held_param_count("serve", cfg, params, card)
    rng = np.random.default_rng(2)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(SERVE_BATCH, PROMPT))).to(DEV)
    prefill(params, {"tokens": prompt})  # warm-up: cuBLAS plans, the kernel's first launch
    torch.cuda.synchronize()

    # --- the main path: counts at 0 just before, read just after
    reset_counts()
    t0 = time.perf_counter()
    logits = prefill(params, {"tokens": prompt})
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    prefill_launches = flash_attention.LAUNCHES
    if prefill_launches != cfg.num_layers:
        raise AssertionError(f"prefill launched flash_attention {prefill_launches} times, "
                             f"not once per layer ({cfg.num_layers})")
    if logits.shape != (SERVE_BATCH, PROMPT, cfg.vocab_size) or not torch.isfinite(logits).all():
        raise AssertionError(f"bad prefill logits {tuple(logits.shape)}")
    first = logits[:, -1:].argmax(dim=-1).to(torch.int32)
    del logits
    with torch.no_grad():
        _, pre = transformer.forward(params, {"tokens": prompt}, cfg, return_cache=True)
    cache = kvcache.cache_update(api.init_cache(cfg, SERVE_BATCH, CACHE_LEN, "bfloat16", DEV),
                                 pre["k"].transpose(-3, -2), pre["v"].transpose(-3, -2), 0)
    tok, tokens, step_ms = first, [first], []
    for i in range(DECODE_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tok, lg, cache = decode(params, cache, tok, PROMPT + i)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            first_step = lg[:, 0].float()
        if not torch.isfinite(lg).all():
            raise AssertionError(f"decode step {i}: non-finite logits")
        tokens.append(tok)
    path = launch_counts()
    if path["flash_attention"] != 2 * cfg.num_layers:
        raise AssertionError(f"the serve path launched flash_attention "
                             f"{path['flash_attention']} times, not {2 * cfg.num_layers}")
    tokens = torch.cat(tokens, dim=1)
    if tokens.min() < 0 or tokens.max() >= cfg.vocab_size:
        raise AssertionError("decode produced token ids outside the vocabulary")

    # --- decode against a forward over the prompt plus the first token (S 1025)
    with torch.no_grad():
        full = transformer.forward(params, {"tokens": torch.cat([prompt, first], dim=1)}, cfg)
    want = full[:, PROMPT].float()
    del full
    decode_err = _rel(first_step, want)
    agree = (first_step.argmax(-1) == want.argmax(-1)).float().mean().item()
    if not decode_err <= LLM_TOL["bfloat16"]:
        raise AssertionError(f"first decode step vs forward: {decode_err} relative to max "
                             f"|logit| (tolerance {LLM_TOL['bfloat16']})")

    # --- a few steps over int8 caches (eager and lazy dequantization)
    int8 = {}
    for lazy in (False, True):
        qrun = run.replace(model=cfg.scaled(lazy_kv_dequant=lazy))
        qdecode, _, _, _ = steps.make_decode_step(qrun)
        qcache = kvcache.cache_update(api.init_cache(cfg, SERVE_BATCH, CACHE_LEN, "int8", DEV),
                                      pre["k"].transpose(-3, -2), pre["v"].transpose(-3, -2), 0)
        qtoks = []
        for i in range(INT8_STEPS):
            qtok, qlg, qcache = qdecode(params, qcache, tokens[:, i:i + 1], PROMPT + i)
            if i == 0:
                qerr = _rel(qlg[:, 0], first_step)
            if not torch.isfinite(qlg).all():
                raise AssertionError(f"int8 decode step {i}: non-finite logits")
            qtoks.append(qtok)
        qagree = (torch.cat(qtoks, 1) == tokens[:, 1:INT8_STEPS + 1]).float().mean().item()
        if not qerr <= INT8_TOL:
            raise AssertionError(f"int8 (lazy={lazy}) first step vs bf16 cache: {qerr} "
                                 f"(tolerance {INT8_TOL})")
        int8["lazy" if lazy else "eager"] = {"first_step_rel_err": qerr, "token_agreement": qagree}
        del qcache
    del pre

    # --- steady-state timing and where the device time goes
    prefill_ms_steady, times = _prefill_timings(prefill, params, prompt)
    decode_ms = float(np.median(step_ms[1:]))
    prefill_kernels = _profiled(lambda: prefill(params, {"tokens": prompt}))
    decode_kernels = _profiled(lambda: decode(params, cache, tokens[:, -1:],
                                              PROMPT + DECODE_STEPS))

    print(f"serve: {SERVE_ARCH} full width ({n_params / 1e9:.3f} B params, fp32 weights, bf16 "
          f"compute, attn_impl=flash_pallas), init on the card {init_s:.1f} s  [{card}]")
    print(f"serve: prefill {SERVE_BATCH} x {PROMPT} tokens: {prefill_ms:.2f} ms on the main "
          f"path, {prefill_ms_steady:.2f} ms steady ({SERVE_BATCH * PROMPT / prefill_ms_steady * 1e3:.0f} "
          f"tokens/s), {prefill_launches} flash_attention launches  [{card}]")
    print(f"serve: decode {DECODE_STEPS} greedy steps over a {CACHE_LEN}-position bf16 cache: "
          f"{decode_ms:.2f} ms per step (median; first {step_ms[0]:.2f} ms), "
          f"{SERVE_BATCH / decode_ms * 1e3:.1f} tokens/s; main path launches {path}  [{card}]")
    print(f"serve: first decode step vs forward over prompt + token at position {PROMPT}: "
          f"{decode_err:.3g} of max |logit| (tolerance {LLM_TOL['bfloat16']}), argmax agreement "
          f"{agree:.3f}  [{card}]")
    for name, r in int8.items():
        print(f"serve: int8 cache ({name} dequantization), {INT8_STEPS} steps: first step "
              f"{r['first_step_rel_err']:.3g} of max |logit| from the bf16 cache's (tolerance "
              f"{INT8_TOL}), greedy tokens agree {r['token_agreement']:.3f}  [{card}]")
    attn_ms = _print_breakdown(f"prefill ({SERVE_BATCH} x {PROMPT})", prefill_ms_steady,
                               prefill_kernels, card)["flash_attention"]
    _print_breakdown("decode step", decode_ms, decode_kernels, card)
    return {"n_params": n_params, "init_s": init_s, "prefill_ms": prefill_ms,
            "prefill_ms_steady": prefill_ms_steady, "prefill_times_ms": times,
            "prefill_launches": prefill_launches, "path_launches": path,
            "decode_step_ms": step_ms, "decode_ms": decode_ms,
            "decode_vs_forward_rel_err": decode_err, "decode_vs_forward_argmax_agreement": agree,
            "int8": int8, "prefill_attention_device_ms": attn_ms,
            "prefill_device_ms": sum(prefill_kernels.values()),
            "decode_device_ms": sum(decode_kernels.values()),
            "prefill_kernels_ms": prefill_kernels, "decode_kernels_ms": decode_kernels}


def ssd_bound_parts_ms(b, s, h, p, g, n, chunk, dtype) -> tuple[float, float]:
    """The two lower bounds of one chunk scan in ms: bytes (x, dt, A, B, C
    read once, y and the fp32 final state written once) over the memory
    rate; and the operations the chunked algorithm needs over the peak rate
    for the input type: per chunk of L positions, C·Bᵀ and its product with
    x·dt over the L(L+1)/2 pairs at or below the diagonal (2(N + P)
    operations each), C·stateᵀ and the state update (4PN per position)."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    nbytes = (itemsize * (2 * b * s * h * p + 2 * b * s * g * n)
              + 4 * (b * s * h + h + b * h * p * n))
    q = min(chunk, s)
    ops = sum(2 * (n + p) * (ln * (ln + 1) // 2) + 4 * p * n * ln
              for ln in (min(q, s - r0) for r0 in range(0, s, q)))
    return (nbytes / HBM_BYTES_PER_S * 1e3,
            float(b * h * ops) / PEAK_FLOP_PER_S[dtype] * 1e3)


def ssd_inputs(b, s, h, p, g, n, dtype, gen, ranges: str = "normal"):
    """x, and B, C as views into one (B, S, 2GN) tensor, as the model passes
    them; dt and A as tests/test_kernels.py draws them (``ranges`` "normal":
    dt = softplus(normal), A = -exp(normal), which decay the state by about
    e^-1 a position) or in mamba2's ranges ("model": dt = softplus(d + 0.5
    normal) with softplus(d) log-uniform in [1e-3, 1e-1] per head, A
    uniform in [-16, -1], as ``models.ssm`` initialises dt_bias and A_log),
    under which the state carries across chunks."""
    x = torch.randn((b, s, h, p), generator=gen, device=DEV).to(dtype)
    if ranges == "model":
        d0 = torch.exp(torch.empty((h,), device=DEV).uniform_(math.log(1e-3), math.log(1e-1),
                                                              generator=gen))
        dt = torch.nn.functional.softplus(
            torch.log(torch.expm1(d0)) + 0.5 * torch.randn((b, s, h), generator=gen, device=DEV))
        A = -torch.empty((h,), device=DEV).uniform_(1.0, 16.0, generator=gen)
    else:
        dt = torch.nn.functional.softplus(torch.randn((b, s, h), generator=gen, device=DEV))
        A = -torch.exp(torch.randn((h,), generator=gen, device=DEV))
    bc = torch.randn((b, s, 2 * g * n), generator=gen, device=DEV).to(dtype)
    return x, dt, A, bc[..., :g * n].reshape(b, s, g, n), bc[..., g * n:].reshape(b, s, g, n)


def ssd_rel(y, st, want_y, want_st) -> tuple[float, float]:
    """(y's max error over max |plain y|, the state's over max |plain state|)."""
    return ((y.float() - want_y.float()).abs().max().item() / want_y.float().abs().max().item(),
            (st - want_st).abs().max().item() / want_st.abs().max().item())


def ssd_split(x, dt, A, Bm, Cm, chunk: int, at: int):
    """The plain version run apart on positions [0, at) and [at, S), y
    concatenated and the second run's state: the scan with the state passed
    across ``at`` (a chunk boundary) dropped."""
    y1, _ = ssd_chunked(x[:, :at], dt[:, :at], A, Bm[:, :at], Cm[:, :at], chunk)
    y2, st2 = ssd_chunked(x[:, at:], dt[:, at:], A, Bm[:, at:], Cm[:, at:], chunk)
    return torch.cat([y1, y2], dim=1), st2


def check_ssd(shape, dtype, gen, timed: bool, ranges: str = "normal") -> dict:
    """ssd_scan against its plain version (ref.ssd_chunked) on the card; in
    fp32, in mamba2's ranges, where a (batch, head) has more than one chunk,
    the two split controls (``ssd_split`` at the first chunk boundary, and
    at the first group boundary where there are two groups), which the limit
    must fail. (Under the "normal" draws the state decays by about e^-256
    over a chunk of 256, so no control could fail there.)"""
    b, s, h, p, g, n, chunk = shape
    x, dt, A, Bm, Cm = ssd_inputs(b, s, h, p, g, n, dtype, gen, ranges)
    y, st = ssd_scan.launch(x, dt, A, Bm, Cm, chunk=chunk)
    want_y, want_st = ssd_chunked(x, dt, A, Bm, Cm, chunk)
    torch.cuda.synchronize()
    err = rel_err(y, want_y)[0]
    rel, st_rel = ssd_rel(y, st, want_y, want_st)
    pl = ssd_scan.plan(b, s, h, p, n, chunk, dtype, kbuild.device_info(0)[1])
    rec = {"shape": shape, "dtype": str(dtype)[6:], "ranges": ranges, "max_abs_err": err,
           "rel_err": rel, "state_rel_err": st_rel, "tol": SSD_TOL[dtype],
           "plan": dataclasses.asdict(pl)}
    finite = bool(torch.isfinite(y.float()).all() and torch.isfinite(st).all())
    if not (finite and rel <= SSD_TOL[dtype] and st_rel <= SSD_TOL[torch.float32]):
        raise AssertionError(f"ssd_scan disagrees with its plain version: {rec}")
    if dtype == torch.float32 and ranges == "model" and pl.chunks > 1:
        q = pl.chunk
        cuts = {"rank_state_dropped": q}
        if pl.groups > 1:
            cuts["group_carry_dropped"] = pl.cluster * q
        rec["controls"] = {}
        for name, at in cuts.items():
            cy, cst = ssd_split(x, dt, A, Bm, Cm, chunk, at)
            rec["controls"][name] = max(ssd_rel(cy, cst, want_y, want_st)) / SSD_TOL[dtype]
        if not min(rec["controls"].values()) > 1.0:
            raise AssertionError(f"the fp32 limit passes a split control: {rec}")
    if timed:
        rec["ms"] = time_ms(lambda: ssd_scan.launch(x, dt, A, Bm, Cm, chunk=chunk))
        rec["plain_ms"] = time_ms(lambda: ssd_chunked(x, dt, A, Bm, Cm, chunk), iters=5)
        rec["device_ms"], rec["device_plain_ms"] = graph_ms(
            [lambda: ssd_scan.launch(x, dt, A, Bm, Cm, chunk=chunk),
             lambda: ssd_chunked(x, dt, A, Bm, Cm, chunk)], calls=10, rounds=2)
        rec["host_us"] = host_us(lambda: ssd_scan.launch(x, dt, A, Bm, Cm, chunk=chunk),
                                 calls=100)
        rec["library_ms"] = None  # no single PyTorch call computes the chunk scan
        rec["bound_bytes_ms"], rec["bound_ops_ms"] = ssd_bound_parts_ms(*shape, dtype)
        rec["bound_ms"] = max(rec["bound_bytes_ms"], rec["bound_ops_ms"])
        rec["bound_by"] = ("bytes" if rec["bound_bytes_ms"] >= rec["bound_ops_ms"]
                           else "operations")
    return rec


def ssd_bwd_bound_parts_ms(b, s, h, p, g, n, chunk, dtype) -> tuple[float, float]:
    """The two lower bounds of one chunk scan's backward in ms: bytes (x, dy,
    B, C, dt, A read once; dx, dB, dC, dt's and A's gradients written once)
    over the memory rate; and the operations the plain backward's products
    need under the causal mask over the peak rate for the input type: per
    chunk of L positions, its five Q·Q products over the L(L+1)/2 pairs at
    or below the diagonal (2(3N + 2P) operations each) and six state
    products (12PN per position)."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    nbytes = itemsize * (3 * b * s * h * p + 4 * b * s * g * n) + 4 * (2 * b * s * h + 2 * h)
    q = min(chunk, s)
    ops = sum(2 * (3 * n + 2 * p) * (ln * (ln + 1) // 2) + 12 * p * n * ln
              for ln in (min(q, s - r0) for r0 in range(0, s, q)))
    return (nbytes / HBM_BYTES_PER_S * 1e3,
            float(b * h * ops) / PEAK_FLOP_PER_S[dtype] * 1e3)


def check_ssd_backward(shape, dtype, gen, ranges: str = "normal",
                       with_state: bool = False, exact: bool = False) -> dict:
    """The backward kernels (``launch_bwd``) against the plain backward
    (``ref.ssd_chunked_bwd``) on the same inputs, y's cotangent and, with
    ``with_state``, the final state's; a second call must give bitwise the
    same gradients. ``exact`` (fp32): against the plain backward evaluated
    in float64 instead, beside the fp32 plain backward's own error there
    (at chunk 4096 the fp32 plain backward sits up to 2.8e-4 from it)."""
    b, s, h, p, g, n, chunk = shape
    x, dt, A, Bm, Cm = ssd_inputs(b, s, h, p, g, n, dtype, gen, ranges)
    dy = torch.randn(x.shape, generator=gen, device=DEV).to(dtype)
    dst = torch.randn((b, h, p, n), generator=gen, device=DEV) if with_state else None
    copies, launches = ssd_scan.OPERAND_COPIES, ssd_scan.BACKWARD_LAUNCHES
    got = ssd_scan.launch_bwd(x, dt, A, Bm, Cm, dy, dst, chunk=chunk)
    copies = ssd_scan.OPERAND_COPIES - copies
    launches = ssd_scan.BACKWARD_LAUNCHES - launches
    again = ssd_scan.launch_bwd(x, dt, A, Bm, Cm, dy, dst, chunk=chunk)
    want = ssd_chunked_bwd(x, dt, A, Bm, Cm, dy, dst, chunk)
    names = ("dx", "ddt", "dA", "dB", "dC")
    plain_rel = None
    if exact:
        plain = want
        want = ssd_chunked_bwd(*(None if t is None else t.double()
                                 for t in (x, dt, A, Bm, Cm, dy, dst)), chunk, acc=torch.float64)
        plain_rel = {nm: _grad_rel(pl, w) for nm, pl, w in zip(names, plain, want)}
    torch.cuda.synchronize()
    rec = {"shape": shape, "dtype": str(dtype)[6:], "ranges": ranges, "with_state": with_state,
           "against": "float64" if exact else "plain", "plain_rel_err": plain_rel,
           "rel_err": {nm: _grad_rel(gr, w) for nm, gr, w in zip(names, got, want)},
           "max_abs_err": max((gr.float() - w.float()).abs().max().item()
                              for gr, w in zip(got, want)),
           "bitwise": all(torch.equal(a, c) for a, c in zip(got, again)),
           "tol": BWD_TOL[dtype], "launches": launches, "operand_copies": copies,
           "plan": dataclasses.asdict(ssd_scan.bwd_plan(b, s, h, p, g, n, chunk,
                                                       kbuild.device_info(0)[1]))}
    finite = all(torch.isfinite(gr.float()).all() for gr in got)
    if not (finite and rec["bitwise"] and max(rec["rel_err"].values()) <= BWD_TOL[dtype]
            and launches == ssd_scan.BWD_LAUNCHES):
        raise AssertionError(f"the ssd_scan backward disagrees with the plain backward: {rec}")
    return rec


def ssd_phase(card: str) -> dict:
    gen = torch.Generator(device=DEV).manual_seed(4)
    records, seq_err = [], 0.0
    for shape in SSD_SMALL:
        for dtype in (torch.float32, torch.bfloat16):
            records.append(check_ssd(shape, dtype, gen, timed=False))
        x, dt, A, Bm, Cm = ssd_inputs(*shape[:6], torch.float32, gen)
        y, st = ssd_chunked(x, dt, A, Bm, Cm, shape[6])
        ry, rst = ssd_scan_ref(x, dt, A, Bm, Cm, shape[6])
        seq_err = max(seq_err, (y - ry).abs().max().item(), (st - rst).abs().max().item())
    if not seq_err <= SEQ_TOL:
        raise AssertionError(f"the plain chunked scan against the sequential recurrence: "
                             f"{seq_err} (tolerance {SEQ_TOL})")
    b, s, h, p, g, n, chunk = SERVE_SSD
    for shape in ((b, 1000, h, p, g, n, chunk), ZAMBA_SSD):
        for dtype in (torch.float32, torch.bfloat16):
            records.append(check_ssd(shape, dtype, gen, timed=False))
    edges = []
    for shape in SSD_EDGES:
        for dtype in (torch.float32, torch.bfloat16):
            edges.append(check_ssd(shape, dtype, gen, timed=False, ranges="model"))
    records += edges
    records.append(check_ssd(SERVE_SSD, torch.float32, gen, timed=False))
    main = check_ssd(SERVE_SSD, torch.bfloat16, gen, timed=True)
    records.append(main)
    zamba = check_ssd(ZAMBA_SSD, torch.bfloat16, gen, timed=True)
    records.append(zamba)
    bwd = [check_ssd_backward(shape, dtype, gen, with_state=i % 2 == 1)
           for i, shape in enumerate(SSD_SMALL + [(b, 1000, h, p, g, n, chunk), ZAMBA_SSD])
           for dtype in (torch.float32, torch.bfloat16)]
    bwd += [check_ssd_backward(shape, dtype, gen, ranges="model", with_state=i % 2 == 0)
            for i, shape in enumerate(SSD_EDGES) for dtype in (torch.float32, torch.bfloat16)]
    # a chunk of 4096 (cs in the thousands) in fp32, against float64
    bwd.append(check_ssd_backward(SSD_BWD_EXACT, torch.float32, gen, exact=True))
    bwd_main = check_ssd_backward(SERVE_SSD, torch.bfloat16, gen, ranges="model")
    bwd.append(bwd_main)
    # the edges after them, which keeps the draws of the checks above as they were
    bwd_edges = [check_ssd_backward(shape, dtype, gen, with_state=i % 2 == 1,
                                    exact=dtype == torch.float32)
                 for i, shape in enumerate(SSD_BWD_EDGES)
                 for dtype in (torch.float32, torch.bfloat16)]
    for r in bwd_edges:  # the padded copies are bf16's alone (fp32 reads through strides)
        want = 2 if r["shape"][3] % 8 and r["dtype"] == "bfloat16" else 0
        if r["operand_copies"] != want:
            raise AssertionError(f"the ssd_scan backward copied {r['operand_copies']} "
                                 f"operands, not {want}: {r}")
    worst = max(r["rel_err"] / r["tol"] for r in records)
    worst_state = max(r["state_rel_err"] for r in records) / SSD_TOL[torch.float32]
    controls = [(r["shape"], name, v) for r in records
                for name, v in r.get("controls", {}).items()]
    print(f"ssd: {len(records)} checks against the plain version (fp32 and bf16; "
          f"tests/test_kernels.py's shapes, ragged S 1000, zamba2's H 112 N 64, the cluster's "
          f"edges in mamba2's dt and A ranges); worst y error {worst:.3g} of its tolerance, "
          f"worst state error {worst_state:.3g} of 1e-3; plain vs sequential recurrence "
          f"{seq_err:.3g} (tolerance {SEQ_TOL})  [{card}]")
    for r in edges:
        pl = r["plan"]
        print(f"ssd:   edge {r['shape']} {r['dtype']}: cluster {pl['cluster']} x {pl['groups']} "
              f"groups, y {r['rel_err']:.3g} of max |y|, state {r['state_rel_err']:.3g}")
    print("ssd: split controls, each as a multiple of the fp32 limit (must exceed 1): "
          + "; ".join(f"{shape} {name} {v:.3g}x" for shape, name, v in controls) + f"  [{card}]")
    for label, r in (("mamba2-370m prefill", main), ("zamba2-7b", zamba)):
        bb, ss, hh, pp, gg, nn, qq = r["shape"]
        print(f"ssd: {label} B {bb} S {ss} H {hh} P {pp} G {gg} N {nn} chunk {qq} bf16 "
              f"(cluster {r['plan']['cluster']}, {r['plan']['ctas']} CTAs): kernel "
              f"{r['ms']:.4f} ms host-issued, {r['device_ms']:.4f} ms on the device alone; plain "
              f"{r['plain_ms']:.4f} / {r['device_plain_ms']:.4f} ms; no library call; bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}; bytes {r['bound_bytes_ms']:.4f}, "
              f"operations {r['bound_ops_ms']:.4f}); wrapper {r['host_us']:.2f} µs of host time "
              f"a call; y {r['rel_err']:.3g} of max |y|, state {r['state_rel_err']:.3g}  [{card}]")
    worst_edge = max(max(r["rel_err"].values()) / r["tol"] for r in bwd_edges)
    print(f"ssd: backward edges, {len(bwd_edges)} checks (fp32 and bf16; slices "
          + ", ".join(f"{r['shape']} {r['plan']['slices']}" for r in bwd_edges[::2])
          + f"): worst {worst_edge:.3g} of its tolerance, each twice bitwise, "
          f"{ssd_scan.BWD_LAUNCHES} launches a call; operand copies only at P 60 in bf16 "
          f"(x and dy)  [{card}]")
    worst_bwd = max(max(r["rel_err"].values()) / r["tol"] for r in bwd)
    print(f"ssd: backward kernels, {len(bwd)} checks against the plain backward (fp32 and "
          f"bf16; the same shapes, the edges in mamba2's ranges, with and without the final "
          f"state's cotangent), each gradient over max(1, its max |plain value|): worst "
          f"{worst_bwd:.3g} of its tolerance ({BWD_TOL[torch.float32]} fp32, "
          f"{BWD_TOL[torch.bfloat16]} bf16); every one twice bitwise the same; mamba2-370m's "
          f"training shape bf16 " + ", ".join(f"{k} {v:.3g}" for k, v in
                                             bwd_main["rel_err"].items()) + f"  [{card}]")
    exact = next(r for r in bwd if r["against"] == "float64")
    print(f"ssd: backward fp32 at {exact['shape']} (chunk 4096) against the plain backward in "
          f"float64: kernel " + ", ".join(f"{k} {v:.3g}" for k, v in exact["rel_err"].items())
          + " (limit 1e-4); the fp32 plain backward " + ", ".join(
              f"{k} {v:.3g}" for k, v in exact["plain_rel_err"].items()) + f"  [{card}]")
    return {"records": records, "main": main, "zamba": zamba, "seq_err": seq_err,
            "controls": controls, "backward": bwd, "backward_main": bwd_main,
            "backward_edges": bwd_edges}


def gmm_bound_parts_ms(e, c, d, f, dtype) -> tuple[float, float]:
    """The two lower bounds of one grouped product in ms: bytes (x and w
    read once, y written once) over the memory rate, and 2·E·C·D·F
    operations over the peak rate for the input type."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    nbytes = itemsize * (e * c * d + e * d * f + e * c * f)
    return (nbytes / HBM_BYTES_PER_S * 1e3,
            2.0 * e * c * d * f / PEAK_FLOP_PER_S[dtype] * 1e3)


def check_gmm(e, c, d, f, dtype, gen, timed: bool, layout: str = "contiguous") -> dict:
    """gmm against its plain version (ref.gmm_ref) on the card. ``layout``
    "strided" passes x with every other row and w as a transposed view (the
    bf16 body copies that w), "x_rows" x with every other row and w
    contiguous, both of which the bf16 body reads through its TMA maps."""
    strided = layout != "contiguous"
    x = torch.randn((e, 2 * c if strided else c, d), generator=gen, device=DEV).to(dtype)
    w = (torch.randn((e, f, d) if layout == "strided" else (e, d, f), generator=gen, device=DEV)
         / math.sqrt(d)).to(dtype)
    if strided:
        x = x[:, ::2]
    if layout == "strided":
        w = w.transpose(1, 2)
    if layout == "x_rows" and not gmm._fits_bf16_body(x):
        raise AssertionError(f"x[:, ::2] of {tuple(x.shape)} is not one the TMA maps describe")
    y = gmm.launch(x, w)
    want = gmm_ref(x, w)
    torch.cuda.synchronize()
    err = rel_err(y, want)[0]
    rel = err / want.float().abs().max().item()
    rec = {"shape": (e, c, d, f), "dtype": str(dtype)[6:], "layout": layout,
           "max_abs_err": err, "rel_err": rel, "tol": GMM_TOL[dtype]}
    if not (torch.isfinite(y.float()).all() and rel <= GMM_TOL[dtype]):
        raise AssertionError(f"gmm disagrees with its plain version: {rec}")
    if timed:
        lib = torch.bmm(x, w)
        rec["library_rel_err"] = (lib.float() - want.float()).abs().max().item() / \
            want.float().abs().max().item()
        rec["ms"] = time_ms(lambda: gmm.launch(x, w))
        rec["plain_ms"] = time_ms(lambda: gmm_ref(x, w), iters=5)
        rec["library_ms"] = time_ms(lambda: torch.bmm(x, w))
        rec["bound_bytes_ms"], rec["bound_ops_ms"] = gmm_bound_parts_ms(e, c, d, f, dtype)
        rec["bound_ms"] = max(rec["bound_bytes_ms"], rec["bound_ops_ms"])
        rec["bound_by"] = ("bytes" if rec["bound_bytes_ms"] >= rec["bound_ops_ms"]
                           else "operations")
        if dtype == torch.bfloat16:
            # controls of the bf16 limit on these inputs, faults it must
            # catch: the plain version with the last 64-wide K panel dropped,
            # and with the last 128-row tile of every expert zeroed
            dropped = gmm_ref(x[..., :d - 64], w[:, :d - 64])
            zeroed = want.clone()
            zeroed[:, (c - 1) // 128 * 128:] = 0
            rec["controls"] = {name: (ctl.float() - want.float()).abs().max().item()
                               / want.float().abs().max().item()
                               for name, ctl in (("dropped_k_panel", dropped),
                                                 ("zeroed_row_tile", zeroed))}
            if not min(rec["controls"].values()) > GMM_TOL[dtype]:
                raise AssertionError(f"the bf16 limit passes a control: {rec['controls']}")
    return rec


def check_gmm_backward(e, c, d, f, dtype, gen, view: str = "contiguous",
                       timed: bool = False) -> dict:
    """gmm's backward on the card (``gmm.Gmm``: dx = dy·wᵀ and dw = xᵀ·dy,
    two launches on the transposed views it passes, each read through a TMA
    map of its own layout) against autograd of the plain version
    (ref.gmm_ref) on the same inputs, each relative to its plain max
    |value|; a second backward must be bitwise the same. ``view``
    "expert-strided" passes x and w as every other expert of larger
    tensors, "unaligned w" a w whose row stride (F + 4) no TMA map takes:
    the backward copies its wᵀ (bf16) and no operand of any other view.
    Controls of the limit on these inputs, faults it must catch, for each
    product: the plain version with the last 64 of its K (F for dx, C for
    dw) dropped, and with the last 128-row tile of its output zeroed.
    ``timed``: the backward and each launch against ``torch.bmm``."""
    def draw(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=DEV) * scale).to(dtype)

    if view == "expert-strided":
        x, w = draw(2 * e, c, d)[::2], draw(2 * e, d, f, scale=d ** -0.5)[1::2]
    elif view == "unaligned w":
        x, w = draw(e, c, d), draw(e, d, f + 4, scale=d ** -0.5)[..., :f]
    else:
        x, w = draw(e, c, d), draw(e, d, f, scale=d ** -0.5)
    x.requires_grad_(True)
    w.requires_grad_(True)
    dy = draw(e, c, f)
    y = gmm.gmm(x, w)
    before, copies, padded = gmm.LAUNCHES, [], gmm._padded
    gmm._padded = lambda *a: copies.append(a[0].shape) or padded(*a)
    try:
        got = torch.autograd.grad(y, (x, w), dy, retain_graph=True)
        torch.cuda.synchronize()
    finally:
        gmm._padded = padded
    launches = gmm.LAUNCHES - before
    again = torch.autograd.grad(y, (x, w), dy, retain_graph=True)
    plain = gmm_ref(x, w)
    want = torch.autograd.grad(plain, (x, w), dy, retain_graph=True)
    xd, wd, dyd = x.detach(), w.detach(), dy
    controls = {
        "dx": {"dropped_k_panel": gmm_ref(dyd[..., :f - 64], wd[..., :f - 64].transpose(1, 2)),
               "zeroed_row_tile": want[0].clone().index_fill_(
                   1, torch.arange((c - 1) // 128 * 128, c, device=DEV), 0)},
        "dw": {"dropped_k_panel": gmm_ref(xd[:, :c - 64].transpose(1, 2), dyd[:, :c - 64]),
               "zeroed_row_tile": want[1].clone().index_fill_(
                   1, torch.arange((d - 1) // 128 * 128, d, device=DEV), 0)}}
    rec = {"shape": (e, c, d, f), "dtype": str(dtype)[6:], "view": view, "launches": launches,
           "operand_copies": len(copies), "tol": GMM_TOL[dtype], "controls": {},
           "bitwise": all(torch.equal(a, b) for a, b in zip(got, again))}
    for name, g, p in (("dx", got[0], want[0]), ("dw", got[1], want[1])):
        scale = p.float().abs().max().item()
        rec[f"{name}_max_abs_err"] = (g.float() - p.float()).abs().max().item()
        rec[f"{name}_rel_err"] = rec[f"{name}_max_abs_err"] / scale
        if not (g.dtype == dtype and torch.isfinite(g.float()).all()):
            raise AssertionError(f"gmm's {name} is not finite {dtype}: {rec}")
        for ctl, t in controls[name].items():
            rec["controls"][f"{name} {ctl}"] = (t.float() - p.float()).abs().max().item() / scale
    rec["max_abs_err"] = max(rec["dx_max_abs_err"], rec["dw_max_abs_err"])
    if (launches != 2 or not rec["bitwise"]
            or max(rec["dx_rel_err"], rec["dw_rel_err"]) > GMM_TOL[dtype]):
        raise AssertionError(f"gmm's backward disagrees with its plain version: {rec}")
    want_copies = 1 if view == "unaligned w" and dtype == torch.bfloat16 else 0
    if len(copies) != want_copies:
        raise AssertionError(f"gmm's backward copied {copies}, expected {want_copies} copies: "
                             f"{rec}")
    if not min(rec["controls"].values()) > GMM_TOL[dtype]:
        raise AssertionError(f"the gmm backward's limit passes a control: {rec['controls']}")
    if timed:
        wt, xt = wd.transpose(1, 2), xd.transpose(1, 2)
        rec["ms"] = time_ms(lambda: torch.autograd.grad(y, (x, w), dy, retain_graph=True))
        rec["dx_ms"] = time_ms(lambda: gmm.launch(dyd, wt))
        rec["dw_ms"] = time_ms(lambda: gmm.launch(xt, dyd))
        rec["plain_ms"] = time_ms(
            lambda: torch.autograd.grad(plain, (x, w), dy, retain_graph=True), iters=5)
        rec["library_ms"] = time_ms(lambda: (torch.bmm(dyd, wt), torch.bmm(xt, dyd)))
        rec["dx_library_ms"] = time_ms(lambda: torch.bmm(dyd, wt))
        rec["dw_library_ms"] = time_ms(lambda: torch.bmm(xt, dyd))
        # each launch's own bound: dx is (E, C, F)·(E, F, D), dw (E, D, C)·(E, C, F)
        parts = (gmm_bound_parts_ms(e, c, f, d, dtype), gmm_bound_parts_ms(e, d, c, f, dtype))
        rec["dx_bound_ms"], rec["dw_bound_ms"] = max(parts[0]), max(parts[1])
        rec["bound_ms"] = rec["dx_bound_ms"] + rec["dw_bound_ms"]
        rec["bound_by"] = ("bytes" if sum(p[0] for p in parts) >= sum(p[1] for p in parts)
                           else "operations")
    return rec


def moe_gmm_shapes() -> dict:
    """qwen2-moe-a2.7b's expert products (E, C, D, F): the prefill of
    8 x 1024 tokens (capacity 688) and a decode step at batch 8 (C 32)."""
    cfg = configs.get(MOE_ARCH)
    e, d, f = cfg.num_experts, cfg.d_model, cfg.moe_d_ff
    cap = moe.capacity_for(SERVE_BATCH * PROMPT, cfg)
    dec = moe.capacity_for(SERVE_BATCH, cfg)
    return {"gate/up": (e, cap, d, f), "down": (e, cap, f, d), "decode gate/up": (e, dec, d, f),
            "decode down": (e, dec, f, d)}


def gmm_phase(card: str) -> dict:
    gen = torch.Generator(device=DEV).manual_seed(5)
    records = []
    # tests/test_kernels.py's shapes, then ragged edges and strided views
    for shape in ((4, 64, 32, 48), (2, 100, 70, 30), (8, 128, 256, 128), (1, 8, 8, 8),
                  (3, 129, 33, 257)):
        for dtype in (torch.float32, torch.bfloat16):
            records.append(check_gmm(*shape, dtype, gen, timed=False))
            records.append(check_gmm(*shape, dtype, gen, timed=False, layout="strided"))
    # the bf16 body's edges: C on both sides of the 64-row body and of one
    # and two 128-row tiles, and the multi-token cache fill's 8192; D off the
    # 64-wide K steps; F under one tile and off the 256-wide tiles; 60
    # experts of 8 rows, so each CTA walks many tiles and the ring's parity
    # wraps many times; x[:, ::2] read through the TMA map
    for shape in GMM_EDGES:
        for dtype in (torch.float32, torch.bfloat16):
            records.append(check_gmm(*shape, dtype, gen, timed=False))
    records.append(check_gmm(3, 100, 1000, 1408, torch.bfloat16, gen, timed=False,
                             layout="x_rows"))
    main = {}
    for name, shape in moe_gmm_shapes().items():
        records.append(check_gmm(*shape, torch.float32, gen, timed=False))
        main[name] = check_gmm(*shape, torch.bfloat16, gen, timed=True)
        records.append(main[name])
    # the backward at the training step's shapes (8 x 1024 tokens give the
    # prefill's capacity) and at the transposed layouts' edges, fp32 and bf16
    backward = {}
    for name in ("gate/up", "down"):
        shape = moe_gmm_shapes()[name]
        for dtype in (torch.float32, torch.bfloat16):
            backward[f"{name} {str(dtype)[6:]}"] = check_gmm_backward(
                *shape, dtype, gen, timed=dtype == torch.bfloat16)
    for *shape, view in GMM_BWD_EDGES:
        for dtype in (torch.float32, torch.bfloat16):
            backward[f"{tuple(shape)} {view} {str(dtype)[6:]}"] = check_gmm_backward(
                *shape, dtype, gen, view=view)
    worst = max(r["rel_err"] / r["tol"] for r in records)
    print(f"gmm: {len(records)} checks against the plain version (fp32 and bf16, "
          f"tests/test_kernels.py's shapes, ragged edges, strided views, C "
          f"{sorted({r['shape'][1] for r in records})}, qwen2-moe's four products); worst "
          f"error {worst:.3g} of its tolerance; bf16 worst "
          f"{max(r['rel_err'] for r in records if r['dtype'] == 'bfloat16'):.3g}, fp32 worst "
          f"{max(r['rel_err'] for r in records if r['dtype'] == 'float32'):.3g} of max |y|  "
          f"[{card}]")
    for name, r in main.items():
        flop = r["bound_ops_ms"] * 1e-3 * PEAK_FLOP_PER_S[torch.bfloat16]
        ctl = r["controls"]
        print(f"gmm: {name} (E, C, D, F) = {r['shape']} bf16: kernel {r['ms']:.4f} ms "
              f"({flop / r['ms'] / 1e9:.0f} TFLOP/s), plain {r['plain_ms']:.4f} ms, bmm "
              f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}; bytes "
              f"{r['bound_bytes_ms']:.4f}, operations {r['bound_ops_ms']:.4f}); "
              f"{r['rel_err']:.3g} of max |y| (bmm {r['library_rel_err']:.3g}); controls: last "
              f"K panel dropped {ctl['dropped_k_panel']:.3g}, last row tile zeroed "
              f"{ctl['zeroed_row_tile']:.3g} (limit {GMM_TOL[torch.bfloat16]})  [{card}]")
    edges = [r for r in backward.values() if "ms" not in r]
    print(f"gmm backward: {len(edges)} checks at the transposed layouts' edges (C ragged and "
          f"<= 64, D and F off 64, expert-strided views, a w no TMA map takes), fp32 and bf16: "
          f"worst {max(max(r['dx_rel_err'], r['dw_rel_err']) for r in edges):.3g} of max "
          f"|plain| (limit {GMM_TOL[torch.float32]} fp32, {GMM_TOL[torch.bfloat16]} bf16), "
          f"each 2 launches, twice bitwise, operand copies "
          f"{sorted({r['operand_copies'] for r in edges})} (only the unaligned w's, bf16); "
          f"controls {min(min(r['controls'].values()) for r in edges):.3g} at least  [{card}]")
    for name, r in backward.items():
        if "ms" not in r:
            continue
        print(f"gmm backward: {name} (E, C, D, F) = {r['shape']}: dx {r['dx_rel_err']:.3g}, dw "
              f"{r['dw_rel_err']:.3g} of max |plain| (limit {r['tol']}), 2 launches, "
              f"{r['operand_copies']} operand copies; kernel {r['ms']:.4f} ms (dx "
              f"{r['dx_ms']:.4f}, dw {r['dw_ms']:.4f}), plain {r['plain_ms']:.4f} ms, bmm "
              f"{r['library_ms']:.4f} ms (dx {r['dx_library_ms']:.4f}, dw "
              f"{r['dw_library_ms']:.4f}), bound {r['bound_ms']:.4f} ms ({r['bound_by']}); "
              f"controls {min(r['controls'].values()):.3g} at least  [{card}]")
    return {"records": records, "main": main, "backward": backward}


def serve_ssm_phase(card: str) -> dict:
    """mamba2-370m at full width: prefill 8 x 1024 on ssd_scan (one launch
    per layer), decode from a zero cache (the recurrence in torch, as in the
    reference), greedy steps; decode vs forward held in fp32 and, for the
    timed bf16 decode, in bf16."""
    run = configs.make_run(SSM_ARCH, "decode_32k")
    cfg = run.model
    prefill, _, _ = steps.make_prefill_step(run)
    decode, _, _, _ = steps.make_decode_step(run)
    t0 = time.perf_counter()
    params = api.init(0, cfg, device=DEV)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = held_param_count("serve_ssm", cfg, params, card)
    rng = np.random.default_rng(6)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(SERVE_BATCH, PROMPT))).to(DEV)
    prefill(params, {"tokens": prompt})  # warm-up
    torch.cuda.synchronize()

    # --- the main path: counts at 0 just before, read just after
    reset_counts()
    t0 = time.perf_counter()
    logits = prefill(params, {"tokens": prompt})
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    prefill_launches = ssd_scan.LAUNCHES
    if prefill_launches != cfg.num_layers:
        raise AssertionError(f"prefill launched ssd_scan {prefill_launches} times, not once "
                             f"per layer ({cfg.num_layers})")
    if logits.shape != (SERVE_BATCH, PROMPT, cfg.vocab_size) or not torch.isfinite(logits).all():
        raise AssertionError(f"bad prefill logits {tuple(logits.shape)}")
    del logits
    cache = api.init_cache(cfg, SERVE_BATCH, 0, device=DEV)
    step_ms, tokens = [], []
    for i in range(SSM_TEACHER + DECODE_STEPS):
        tok_in = prompt[:, i:i + 1] if i < SSM_TEACHER else tok
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tok, lg, cache = decode(params, cache, tok_in, i)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if not torch.isfinite(lg).all():
            raise AssertionError(f"decode step {i}: non-finite logits")
        if i == SSM_TEACHER - 1:
            bf16_last = lg[:, 0].float()
        if i >= SSM_TEACHER - 1:
            tokens.append(tok)
    path = launch_counts()
    tokens = torch.cat(tokens, dim=1)
    if tokens.min() < 0 or tokens.max() >= cfg.vocab_size:
        raise AssertionError("decode produced token ids outside the vocabulary")

    # --- decode vs forward over the same SSM_TEACHER tokens: the timed bf16
    # decode's step SSM_TEACHER - 1, and an fp32 decode of those tokens
    with torch.no_grad():
        want, _ = api.forward(params, {"tokens": prompt[:, :SSM_TEACHER]}, cfg)
        bf16_err = _rel(bf16_last, want[:, -1])
        cfg32 = cfg.scaled(compute_dtype="float32")
        cache32 = api.init_cache(cfg32, SERVE_BATCH, 0, device=DEV)
        for i in range(SSM_TEACHER):
            lg32, cache32 = api.decode_step(params, cache32, prompt[:, i:i + 1], i, cfg32)
        want32, _ = api.forward(params, {"tokens": prompt[:, :SSM_TEACHER]}, cfg32)
    fp32_err = _rel(lg32[:, 0], want32[:, -1])
    bf16_floor = _rel(want[:, -1].float(), want32[:, -1])  # reported, not a limit
    for name, err in (("float32", fp32_err), ("bfloat16", bf16_err)):
        if not err <= SSM_DECODE_TOL[name]:
            raise AssertionError(f"{name} decode vs forward: {err} of max |logit| (tolerance "
                                 f"{SSM_DECODE_TOL[name]})")
    del cache32, want, want32

    prefill_ms_steady, times = _prefill_timings(prefill, params, prompt)
    decode_ms = float(np.median(step_ms[SSM_TEACHER:]))
    prefill_kernels = _profiled(lambda: prefill(params, {"tokens": prompt}))
    decode_kernels = _profiled(lambda: decode(params, cache, tokens[:, -1:],
                                              SSM_TEACHER + DECODE_STEPS))
    print(f"serve_ssm: {SSM_ARCH} full width ({n_params / 1e9:.3f} B params, fp32 weights, "
          f"bf16 compute, chunk {cfg.ssm_chunk}), init on the card {init_s:.1f} s  [{card}]")
    print(f"serve_ssm: prefill {SERVE_BATCH} x {PROMPT} tokens: {prefill_ms:.2f} ms on the main "
          f"path, {prefill_ms_steady:.2f} ms steady ({SERVE_BATCH * PROMPT / prefill_ms_steady * 1e3:.0f} "
          f"tokens/s), {prefill_launches} ssd_scan launches  [{card}]")
    print(f"serve_ssm: decode at batch {SERVE_BATCH}, {SSM_TEACHER} steps over the prompt from a "
          f"zero cache then {DECODE_STEPS} greedy: {decode_ms:.2f} ms per step (median of the "
          f"greedy steps; first {step_ms[0]:.2f} ms), {SERVE_BATCH / decode_ms * 1e3:.1f} "
          f"tokens/s; main path launches {path}  [{card}]")
    print(f"serve_ssm: decode step {SSM_TEACHER} vs forward over those {SSM_TEACHER} tokens: "
          f"fp32 {fp32_err:.3g} of max |logit| (tolerance {SSM_DECODE_TOL['float32']}); the "
          f"timed bf16 decode {bf16_err:.3g} (tolerance {SSM_DECODE_TOL['bfloat16']}; the bf16 "
          f"forward's own distance from fp32 {bf16_floor:.3g})  [{card}]")
    kern = (("ssd_scan", "ssd_chunk_scan"),)
    ssd_ms = _print_breakdown(f"prefill ({SERVE_BATCH} x {PROMPT})", prefill_ms_steady,
                              prefill_kernels, card, "serve_ssm", kern)["ssd_scan"]
    _print_breakdown("decode step", decode_ms, decode_kernels, card, "serve_ssm", kern)
    return {"n_params": n_params, "init_s": init_s, "prefill_ms": prefill_ms,
            "prefill_ms_steady": prefill_ms_steady, "prefill_times_ms": times,
            "prefill_launches": prefill_launches, "path_launches": path,
            "decode_step_ms": step_ms, "decode_ms": decode_ms,
            "decode_vs_forward_fp32": fp32_err, "decode_vs_forward_bf16": bf16_err,
            "forward_bf16_vs_fp32": bf16_floor,
            "prefill_ssd_device_ms": ssd_ms,
            "prefill_device_ms": sum(prefill_kernels.values()),
            "decode_device_ms": sum(decode_kernels.values()),
            "prefill_kernels_ms": prefill_kernels, "decode_kernels_ms": decode_kernels}


class RouteRecorder:
    """While active, records each ``moe.route`` call's chosen experts
    (top_e), in call order: one call per MoE layer per forward or decode
    step."""

    def __enter__(self):
        self.top_e, self._route = [], moe.route

        def route(x2d, wr, cfg):
            out = self._route(x2d, wr, cfg)
            self.top_e.append(out[1])
            return out

        moe.route = route
        return self

    def __exit__(self, *exc):
        moe.route = self._route


class RouteReplay:
    """While active, makes each ``moe.route`` call choose the experts given
    for it (in call order), with the weights renormalized from this run's
    own router probabilities, and counts how many tokens' own top-k would
    have chosen the same experts. The top-k is a discrete choice between
    near-tied router values: two runs that round at other places (bf16,
    card against CPU, decode against forward) can swap one, which moves that
    token's output by O(1). Replaying one run's choices in the other holds
    the rest of the computation against it."""

    def __init__(self, top_e):
        self.replay, self.same, self.total = list(top_e), 0, 0

    def __enter__(self):
        self._route = moe.route
        calls = iter(self.replay)

        def route(x2d, wr, cfg):
            _, own, aux = self._route(x2d, wr, cfg)
            top_e = next(calls).to(own.device)
            probs = torch.softmax(x2d.float() @ wr.float(), dim=-1)
            top_w = probs.gather(-1, top_e)
            top_w = top_w / top_w.sum(dim=-1, keepdim=True).clamp_min(1e-9)
            self.same += int((own.sort(-1).values == top_e.sort(-1).values).all(-1).sum())
            self.total += own.shape[0]
            return top_w, top_e, aux

        moe.route = route
        return self

    def __exit__(self, *exc):
        moe.route = self._route

    @property
    def agreement(self) -> float:
        return self.same / max(self.total, 1)


def serve_moe_phase(card: str) -> dict:
    """qwen2-moe-a2.7b at full width with attn_impl=flash_pallas: prefill
    8 x 1024 (three gmm and one flash_attention launch per layer), a
    2048-position bf16 cache filled by one multi-token decode step, greedy
    steps, and decode vs forward at 8 x 256 tokens."""
    run = configs.make_run(MOE_ARCH, "decode_32k", model_attn_impl="flash_pallas")
    cfg = run.model
    prefill, _, _ = steps.make_prefill_step(run)
    decode, _, _, _ = steps.make_decode_step(run)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = api.init(0, cfg, device=DEV)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = held_param_count("serve_moe", cfg, params, card)
    rng = np.random.default_rng(7)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(SERVE_BATCH, PROMPT))).to(DEV)
    prefill(params, {"tokens": prompt})  # warm-up
    torch.cuda.synchronize()

    # --- the main path: counts at 0 just before, read just after
    reset_counts()
    t0 = time.perf_counter()
    logits = prefill(params, {"tokens": prompt})
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    prefill_launches = launch_counts()
    if (prefill_launches["gmm"] != 3 * cfg.num_layers
            or prefill_launches["flash_attention"] != cfg.num_layers):
        raise AssertionError(f"prefill launched {prefill_launches}, not 3 gmm and 1 "
                             f"flash_attention per layer ({cfg.num_layers} layers)")
    if logits.shape != (SERVE_BATCH, PROMPT, cfg.vocab_size) or not torch.isfinite(logits).all():
        raise AssertionError(f"bad prefill logits {tuple(logits.shape)}")
    first = logits[:, -1:].argmax(dim=-1).to(torch.int32)
    del logits
    cache = api.init_cache(cfg, SERVE_BATCH, CACHE_LEN, "bfloat16", DEV)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, lg, cache = decode(params, cache, prompt, 0)  # fill the cache from the prompt
    torch.cuda.synchronize()
    fill_ms = (time.perf_counter() - t0) * 1e3
    del lg
    tok, tokens, step_ms = first, [first], []
    for i in range(DECODE_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tok, lg, cache = decode(params, cache, tok, PROMPT + i)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if not torch.isfinite(lg).all():
            raise AssertionError(f"decode step {i}: non-finite logits")
        tokens.append(tok)
    path = launch_counts()
    tokens = torch.cat(tokens, dim=1)
    if tokens.min() < 0 or tokens.max() >= cfg.vocab_size:
        raise AssertionError("decode produced token ids outside the vocabulary")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # --- decode vs forward at 8 x 256 tokens (no capacity drops): the cache
    # filled from the first 255, then one step of the 256th, against a forward
    # over all 256, with the forward's expert choices replayed in the timed
    # decode
    n = MOE_CHECK_LEN
    with torch.no_grad():
        with RouteRecorder() as fwd:
            want, _ = api.forward(params, {"tokens": prompt[:, :n]}, cfg)
        routes = [t.reshape(SERVE_BATCH, n, -1) for t in fwd.top_e]
        replay = ([r[:, :n - 1].reshape(-1, r.shape[-1]) for r in routes]
                  + [r[:, n - 1] for r in routes])
        short = api.init_cache(cfg, SERVE_BATCH, n, "bfloat16", DEV)
        with RouteReplay(replay) as rep:
            decode(params, short, prompt[:, :n - 1], 0)
            _, got, _ = decode(params, short, prompt[:, n - 1:n], n - 1)
    del short
    got, want = got[:, 0].float(), want[:, -1].float()
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    decode_err = _rel(got, want)
    if not decode_err <= LLM_TOL["bfloat16"]:
        raise AssertionError(f"decode vs forward at position {n - 1}: {decode_err} of max "
                             f"|logit| (tolerance {LLM_TOL['bfloat16']})")
    route_agree = rep.agreement

    prefill_ms_steady, times = _prefill_timings(prefill, params, prompt)
    decode_ms = float(np.median(step_ms[1:]))
    prefill_kernels = _profiled(lambda: prefill(params, {"tokens": prompt}))
    decode_kernels = _profiled(lambda: decode(params, cache, tokens[:, -1:],
                                              PROMPT + DECODE_STEPS))
    print(f"serve_moe: {MOE_ARCH} full width ({n_params / 1e9:.3f} B params, fp32 weights, "
          f"bf16 compute, attn_impl=flash_pallas), init on the card {init_s:.1f} s, peak "
          f"{peak_gb:.1f} GB  [{card}]")
    print(f"serve_moe: prefill {SERVE_BATCH} x {PROMPT} tokens: {prefill_ms:.2f} ms on the main "
          f"path, {prefill_ms_steady:.2f} ms steady ({SERVE_BATCH * PROMPT / prefill_ms_steady * 1e3:.0f} "
          f"tokens/s), launches {prefill_launches}  [{card}]")
    print(f"serve_moe: cache fill ({PROMPT} tokens, one decode step) {fill_ms:.2f} ms; decode "
          f"{DECODE_STEPS} greedy steps over a {CACHE_LEN}-position bf16 cache: {decode_ms:.2f} "
          f"ms per step (median; first {step_ms[0]:.2f} ms), {SERVE_BATCH / decode_ms * 1e3:.1f} "
          f"tokens/s; main path launches {path}  [{card}]")
    print(f"serve_moe: decode vs forward at position {n - 1} ({SERVE_BATCH} x {n} tokens, the "
          f"forward's expert choices replayed): {decode_err:.3g} of max |logit| (tolerance "
          f"{LLM_TOL['bfloat16']}), argmax agreement {agree:.3f}; decode's own top-k chose "
          f"the same experts for {route_agree:.3f} of (token, layer) pairs  [{card}]")
    kern = (("gmm", "gmm_"), ("flash_attention", "attn_fwd"))
    shares = _print_breakdown(f"prefill ({SERVE_BATCH} x {PROMPT})", prefill_ms_steady,
                              prefill_kernels, card, "serve_moe", kern)
    _print_breakdown("decode step", decode_ms, decode_kernels, card, "serve_moe", kern)
    return {"n_params": n_params, "init_s": init_s, "peak_gb": peak_gb,
            "prefill_ms": prefill_ms, "prefill_ms_steady": prefill_ms_steady,
            "prefill_times_ms": times, "prefill_launches": prefill_launches,
            "path_launches": path, "fill_ms": fill_ms, "decode_step_ms": step_ms,
            "decode_ms": decode_ms, "decode_vs_forward_rel_err": decode_err,
            "route_agreement": route_agree, "argmax_agreement": agree,
            "prefill_shares_ms": shares, "prefill_device_ms": sum(prefill_kernels.values()),
            "decode_device_ms": sum(decode_kernels.values()),
            "prefill_kernels_ms": prefill_kernels, "decode_kernels_ms": decode_kernels}


def _cut_config(arch: str, compute: str):
    """The llm phase's cut of ``arch``: qwen3-1.7B at 4 layers, mamba2-370m
    whole, qwen2-moe-a2.7b at 2 layers, zamba2-7b at 2 groups (all but
    mamba2 with flash_pallas; zamba2's shared block at head_dim 112); full
    width."""
    base = configs.get(arch).scaled(compute_dtype=compute)
    if arch == SERVE_ARCH:
        return base.scaled(num_layers=4, attn_impl="flash_pallas")
    if arch == MOE_ARCH:
        return base.scaled(num_layers=2, attn_impl="flash_pallas")
    if arch == HYBRID_ARCH:
        return base.scaled(num_layers=2 * base.hybrid_attn_every, attn_impl="flash_pallas")
    return base


def _expected_launches(cfg) -> dict:
    if cfg.family == "moe":
        return {"gmm": 3 * cfg.num_layers, "flash_attention": cfg.num_layers}
    if cfg.family == "hybrid":  # one attention launch per shared-block application
        return {"ssd_scan": cfg.num_layers,
                "flash_attention": cfg.num_layers // cfg.hybrid_attn_every}
    if cfg.family == "ssm":
        return {"ssd_scan": cfg.num_layers}
    return {"flash_attention": cfg.num_layers}


def llm_phase(card: str) -> dict:
    """Full width, cut in depth (``_cut_config``): the card's logits (the
    kernels) against the port's CPU forward (the plain versions) on the same
    params. For the MoE cut the CPU run replays the card's expert choices
    (``RouteReplay``) and reports how many it would have made the same. bf16
    holds ``LLM_TOL`` or the cut's own ``LLM_BF16_TOL``; for the dense, ssm
    and hybrid cuts it also reports the CPU's own bf16 distance from its fp32
    logits."""
    out = {}
    for arch in (SERVE_ARCH, SSM_ARCH, MOE_ARCH, HYBRID_ARCH):
        batch, length = 1, 64
        for compute in ("float32", "bfloat16"):  # fp32 first: bf16 is reported against it
            cfg = _cut_config(arch, compute)
            tokens = torch.from_numpy(np.random.default_rng(3).integers(
                0, cfg.vocab_size, size=(batch, length)))
            params = api.init(1, cfg, device=DEV)
            before = launch_counts()
            with torch.no_grad(), RouteRecorder() as card_routes:
                got, _ = api.forward(params, {"tokens": tokens.to(DEV)}, cfg)
                torch.cuda.synchronize()
            launches = {k: v - before[k] for k, v in launch_counts().items() if v != before[k]}
            cpu_params = tree_map(lambda t: t.cpu(), params)
            del params
            with torch.no_grad(), RouteReplay(t.cpu() for t in card_routes.top_e) as rep:
                want, _ = api.forward(cpu_params, {"tokens": tokens}, cfg)
            del cpu_params
            got = got.cpu()
            if not (torch.isfinite(got).all() and got.shape == (batch, length, cfg.vocab_size)):
                raise AssertionError(f"llm {arch}: bad logits {tuple(got.shape)}")
            err = _rel(got, want)
            floor = None
            if compute == "float32":
                want32 = want
            elif not rep.total:  # an MoE's fp32 and bf16 runs choose other experts
                floor = _rel(want, want32)
            tol = LLM_TOL[compute] if compute == "float32" else LLM_BF16_TOL.get(
                arch, LLM_TOL[compute])
            if not err <= tol or launches != _expected_launches(cfg):
                raise AssertionError(f"llm {arch} {compute}: card vs CPU logits {err} of max "
                                     f"|logit| (tolerance {tol}), launches {launches}, "
                                     f"expected {_expected_launches(cfg)}")
            routed = (f", the card's expert choices replayed on the CPU (its own top-k agrees "
                      f"on {rep.agreement:.3f})" if rep.total else "")
            floor_txt = "" if floor is None else f"; the CPU's own bf16 vs fp32 {floor:.3g}"
            print(f"llm: {arch} full width, {cfg.num_layers} layers, {batch} x {length} tokens, "
                  f"{compute} compute: card vs CPU logits {err:.3g} of max |logit| (tolerance "
                  f"{tol:.3g}{floor_txt}){routed}, launches {launches}  [{card}]")
            out[f"{arch}/{compute}"] = {"rel_err": err, "tol": tol, "bf16_floor": floor,
                                        "launches": launches,
                                        "route_agreement": rep.agreement if rep.total else None}
            del got
            torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# train: the LLM families' training step on the card
# ---------------------------------------------------------------------------

TRAIN_BATCH, TRAIN_SEQ = 8, 1024
# each model's run (LMStream at seed 0): warm-up steps, timed steps
# (synchronised wall clock; every launch count at 0 just before), profiled
# steps (16 in all); qwen3's goes on to TRAIN_STEPS, over which its loss
# must fall by TRAIN_LOSS_DROP (the mean of the last 5 against the first 5,
# as tests/test_train.py's test_loss_decreases asks)
TRAIN_WARMUP, TRAIN_TIMED, TRAIN_PROFILED, TRAIN_STEPS = 3, 10, 3, 30
TRAIN_LOSS_DROP = 0.3
TRAIN_MOE_LAYERS = 2  # qwen2-moe-a2.7b at full width: 1.76 B parameters, 28 GB of state
# card against CPU at the llm phase's cuts, fp32, 2 x 256 tokens: the loss
# relative; each leaf's gradient over that leaf's max |gradient|; one AdamW
# update (new - old) from the card's gradients, on the card and on the CPU,
# per leaf over that leaf's max |update|, beyond one rounding step of the
# new parameter. (The update is taken from one set of gradients: AdamW's
# first update is lr x g / (|g| + eps), the sign of g, which flips wherever
# a gradient smaller than the two devices' rounding difference crosses 0,
# thousands of elements at these sizes. And the new parameter is an fp32
# number: at lr 2e-4 one step of it at |p| 0.25 is 1.5e-4 of the update, so
# two correct devices that round p - lr·u to neighbouring values differ
# by that much.)
TRAIN_CHECK_BATCH, TRAIN_CHECK_SEQ, TRAIN_TOL = 2, 256, 1e-4
# faults the gradient limit must see: one product's dw dropped in gmm's
# backward (K4), and the B gradient of every ssd_scan backward zeroed (K3)
TRAIN_PLANTED = {"gmm_dw_dropped": MOE_ARCH, "ssd_scan_dB_zeroed": SSM_ARCH}
# the loop: mamba2-370m cut to 4 layers (129 M parameters), checkpoints
# every 5 steps, a failure injected after step 7, then the same call resumes
TRAIN_LOOP_LAYERS, TRAIN_LOOP_STEPS, TRAIN_LOOP_EVERY, TRAIN_LOOP_FAIL = 4, 12, 5, 7
# device kernels by symbol: the port's kernels, then cuBLAS's
TRAIN_KERNEL_KEYS = {"flash_attention": ("attn_fwd",), "ssd_scan": ("ssd_chunk_scan",),
                     "flash_attention_bwd": ("attn_bwd_",), "ssd_scan_bwd": ("ssd_bwd_",),
                     "gmm": ("gmm_bf16", "gmm_f32"),
                     "cublas": ("gemm", "nvjet", "cutlass", "xmma", "Kernel2")}
TRAIN_RANGES = ("flash_attention.backward", "ssd_scan.backward", "optimizer.step")


def _train_run(cfg, batch: int, seq: int, **train) -> RunConfig:
    """launch/train.py's TrainConfig (warmup 5, lr 1e-3, AdamW) over the
    phase's steps."""
    return RunConfig(model=cfg, shape=ShapeConfig("train", seq, batch, "train"),
                     train=TrainConfig(total_steps=TRAIN_STEPS, warmup_steps=5,
                                       learning_rate=1e-3, **train))


class _RawProfile(torch.autograd.profiler.profile):
    """torch's profiler (CPU and CUDA activity) that keeps kineto's raw
    events and skips building its Python event tree, which takes minutes
    for a profile of ~10^5 ops."""

    def __init__(self):
        # a private name of torch's (torch calls it where it builds the tree,
        # lazily or at exit): fail here, not by a silent minute of parsing,
        # if a torch release renames it. ``_train_breakdown`` fails if
        # ``kineto_results`` is gone.
        if not hasattr(torch.autograd.profiler.profile, "_parse_kineto_results"):
            raise AssertionError("torch's profiler has no _parse_kineto_results to override")
        super().__init__(use_device="cuda", use_kineto=True)

    def _parse_kineto_results(self, result, *args, **kwargs):
        return []


def _train_breakdown(prof: _RawProfile, steps_run: int) -> dict:
    """Device ms per step from a finished ``_RawProfile``: all of it, by
    kernel symbol (TRAIN_KERNEL_KEYS, the rest "elementwise and other"),
    and in each of TRAIN_RANGES (the K2 and K3 backwards and the optimizer:
    the device work whose launch, a runtime call, ran inside the range on its
    thread; the backward kernels launch straight from their libraries, with
    no op of torch's inside the range to link them to)."""
    if getattr(prof, "kineto_results", None) is None:
        raise AssertionError("torch's profiler kept no kineto_results: its names have changed")
    per_kernel, by_corr, launches, ranges = {}, {}, {}, []
    for e in prof.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if e.is_user_annotation():  # the device side of a range, not a kernel
                continue
            ms = e.duration_ns() / 1e6 / steps_run
            per_kernel[e.name()] = per_kernel.get(e.name(), 0.0) + ms
            by_corr[e.correlation_id()] = by_corr.get(e.correlation_id(), 0.0) + ms
        elif e.linked_correlation_id() != 0:  # a runtime call (a launch), linked to its op
            launches.setdefault(e.start_thread_id(), []).append((e.start_ns(),
                                                                 e.correlation_id()))
        elif e.name() in TRAIN_RANGES:
            ranges.append((e.name(), e.start_thread_id(), e.start_ns(), e.end_ns()))
    for calls in launches.values():
        calls.sort()
    in_range = {name: 0.0 for name in TRAIN_RANGES}
    for name, thread, start, end in ranges:
        calls = launches.get(thread, [])
        lo = bisect.bisect_left(calls, (start, -1))
        hi = bisect.bisect_right(calls, (end, math.inf))
        in_range[name] += sum(by_corr.get(corr, 0.0) for _, corr in calls[lo:hi])
    by = {name: sum(v for k, v in per_kernel.items() if any(key in k for key in keys))
          for name, keys in TRAIN_KERNEL_KEYS.items()}
    by["elementwise and other"] = sum(per_kernel.values()) - sum(by.values())
    # each backward kernel's device ms a step, by symbol (its prefix and the
    # word after it)
    bwd_launch = {}
    for k, v in per_kernel.items():
        found = re.search(r"(ssd_bwd_|attn_bwd_)\w+", k)
        if found:
            bwd_launch[found.group(0)] = bwd_launch.get(found.group(0), 0.0) + v
    return {"device_ms": sum(per_kernel.values()), "by_kernel": by, "ranges": in_range,
            "top": dict(sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]),
            "backward_launch_ms": bwd_launch}


def _backward_call(kind: str) -> dict:
    """One backward alone at the training shape (CUDA events), K2's at
    qwen3-1.7B's attention (B 8, H 16, KV 8, S 1024, hd 128, bf16, causal),
    K3's at mamba2-370m's scan (B 8, S 1024, H 32, P 64, N 128, chunk 256,
    bf16): the backward kernels (``launch_bwd``), the plain VJP (``ref.vjp``
    of the plain forward, what the port ran before the kernels), and for K2
    ``scaled_dot_product_attention``'s backward (autograd; timed here, used
    nowhere in the port); the bound from the shapes."""
    gen = torch.Generator(DEV).manual_seed(21)
    if kind == "flash_attention":
        b, h, kv, s, hd = SERVE_ATTN
        q, k, v = attention_inputs(b, h, kv, s, s, hd, torch.bfloat16, gen, "bshd")
        do = torch.randn((b, s, h, hd), generator=gen, device=DEV).bfloat16().transpose(1, 2)
        o, lse = flash_attention.launch(q, k, v, causal=True, with_lse=True)
        kernel = lambda: flash_attention.launch_bwd(q, k, v, o, lse, do, causal=True)  # noqa: E731
        plain = lambda: kref.vjp(  # noqa: E731
            lambda *t: flash_attention_ref(*t, causal=True), (q, k, v), (True,) * 3, (do,))
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = torch.nn.functional.scaled_dot_product_attention(*leaves, is_causal=True,
                                                               enable_gqa=True)
        library = lambda: torch.autograd.grad(out, leaves, do, retain_graph=True)  # noqa: E731
        parts = attention_bwd_bound_parts_ms(b, h, kv, s, s, hd, True, torch.bfloat16)
    else:
        b, s, h, p, g, n, chunk = SERVE_SSD
        x, dt, A, Bm, Cm = ssd_inputs(b, s, h, p, g, n, torch.bfloat16, gen, "model")
        dy = torch.randn(x.shape, generator=gen, device=DEV).bfloat16()
        kernel = lambda: ssd_scan.launch_bwd(x, dt, A, Bm, Cm, dy, None, chunk=chunk)  # noqa: E731
        plain = lambda: kref.vjp(  # noqa: E731
            lambda *t: ssd_chunked(*t, chunk), (x, dt, A, Bm, Cm), (True,) * 5, (dy, None))
        library = None  # no single PyTorch call computes the chunk scan or its gradient
        parts = ssd_bwd_bound_parts_ms(b, s, h, p, g, n, chunk, torch.bfloat16)
    out = {"ms": time_ms(kernel), "plain_ms": time_ms(plain, iters=5, warmup=1),
           "library_ms": None if library is None else time_ms(library),
           "bound_bytes_ms": parts[0], "bound_ops_ms": parts[1], "bound_ms": max(parts),
           "bound_by": "bytes" if parts[0] >= parts[1] else "operations"}
    if kind == "ssd_scan":
        pl = ssd_scan.bwd_plan(b, s, h, p, g, n, chunk, kbuild.device_info(0)[1])
        out.update(launches_per_call=ssd_scan.BWD_LAUNCHES, workspace_bytes=pl.workspace,
                   plan=dataclasses.asdict(pl))
    return out


def _train_model(card: str, label: str, cfg, remat: str, expect: dict,
                 n_steps: int = TRAIN_WARMUP + TRAIN_TIMED + TRAIN_PROFILED,
                 variants: bool = False) -> dict:
    """One model's training run at 8 x 1024 tokens (see TRAIN_*): ms per step
    (wall and device), tokens/s, peak memory, model TFLOP/s, the device
    breakdown, the launches of each kernel per step (exactly ``expect``) and
    the losses; with ``variants``, one more step at remat="dots" and one at
    microbatches=2."""
    run = _train_run(cfg, TRAIN_BATCH, TRAIN_SEQ, remat=remat)
    step = steps.make_train_step(run)[0]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = api.init(0, cfg, device=DEV)
    state = {"params": params, "opt": make_optimizer(run.train).init(params)}
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_leaves(params))
    flops = roofline.model_flops(cfg, ShapeConfig("train", TRAIN_SEQ, TRAIN_BATCH, "train"))
    del params
    stream = LMStream(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0)
    batches = [{k: torch.from_numpy(v).to(DEV) for k, v in stream.batch_at(i).items()}
               for i in range(n_steps + 4)]  # set-up: the data, made and uploaded once
    losses = []

    def steps_of(n, fn=step):
        nonlocal state
        for _ in range(n):
            state, m = fn(state, batches[len(losses)])
            losses.append(m["loss"])

    steps_of(TRAIN_WARMUP)
    torch.cuda.synchronize()
    # --- the main path: counts at 0 just before, read just after
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    steps_of(TRAIN_TIMED)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / TRAIN_TIMED
    launches = {k: v / TRAIN_TIMED for k, v in launch_counts().items() if v}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if launches != expect:
        raise AssertionError(f"train {label}: launches per step {launches}, expected {expect}")
    t0 = time.perf_counter()
    with _RawProfile() as prof:
        steps_of(TRAIN_PROFILED)
        torch.cuda.synchronize()
    bd = _train_breakdown(prof, TRAIN_PROFILED)
    profile_s = time.perf_counter() - t0
    steps_of(n_steps - len(losses))
    out = {"n_params": n_params, "init_s": init_s, "remat": remat, "ms": ms,
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / ms * 1e3, "peak_gb": peak_gb,
           "model_flops": flops, "tflops": flops / ms / 1e9,
           "launches_per_step": launches, **bd}
    out["mfu"] = out["tflops"] * 1e12 / PEAK_FLOP_PER_S[torch.bfloat16]
    if variants:
        for name, kw in (("remat=dots", dict(remat="dots")),
                         ("microbatches=2", dict(remat=remat, microbatches=2))):
            vstep = steps.make_train_step(_train_run(cfg, TRAIN_BATCH, TRAIN_SEQ, **kw))[0]
            steps_of(1, vstep)  # its first step: cuBLAS plans, checkpoint contexts
            torch.cuda.synchronize()
            reset_counts()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            steps_of(1, vstep)
            torch.cuda.synchronize()
            out[name] = {"ms": (time.perf_counter() - t0) * 1e3,
                         "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                         "launches": {k: v for k, v in launch_counts().items() if v}}
    losses = torch.stack(losses).float().cpu()
    if not torch.isfinite(losses).all():
        raise AssertionError(f"train {label}: non-finite loss {losses.tolist()}")
    out["losses"] = losses.tolist()
    out["loss_drop"] = (losses[:5].mean() - losses[n_steps - 5:n_steps].mean()).item()
    out["profile_s"] = profile_s
    del state, batches
    torch.cuda.empty_cache()

    dev_ms = bd["device_ms"] or math.nan  # nan: the profiler saw no CUDA activity
    print(f"train: {label} ({n_params / 1e9:.3f} B params, fp32 master weights, bf16 compute, "
          f"remat={remat}, AdamW), {TRAIN_BATCH} x {TRAIN_SEQ} tokens a step: {ms:.2f} ms per "
          f"step wall ({TRAIN_TIMED} steps), {dev_ms:.2f} ms on the device "
          f"({dev_ms / ms:.1%} busy), {out['tokens_per_s']:.0f} tokens/s, peak "
          f"{peak_gb:.2f} GB allocated; {flops / 1e12:.2f} model TFLOP a step, "
          f"{out['tflops']:.1f} TFLOP/s = {out['mfu']:.1%} of the H100 SXM dense bf16 peak "
          f"(989 TFLOP/s); launches per step {launches}  [{card}]")
    print("train:   device ms per step by kernel: " + ", ".join(
        f"{k} {v:.3f} ({v / dev_ms:.1%})" for k, v in bd["by_kernel"].items()))
    print("train:   in the profiler ranges: " + ", ".join(
        f"{k} {v:.3f} ({v / dev_ms:.1%})" for k, v in bd["ranges"].items() if v))
    for name, v in bd["top"].items():
        print(f"train:     {v:.3f} ms  {name[:90]}")
    print(f"train:   loss over {n_steps} steps {losses[0]:.3f} -> {losses[n_steps - 1]:.3f} "
          f"(first 5 against last 5: {out['loss_drop']:.3f} lower); {TRAIN_PROFILED} profiled "
          f"steps and their reading {profile_s:.1f} s  [{card}]")
    for name in ("remat=dots", "microbatches=2"):
        if name in out:
            v = out[name]
            print(f"train:   one step at {name}: {v['ms']:.2f} ms wall, peak {v['peak_gb']:.2f} "
                  f"GB, launches {v['launches']}  [{card}]")
    return out


def _stepped(params, grads, run) -> dict:
    """A copy of ``params`` after one AdamW step from ``grads``, which the
    step clips in place."""
    new = tree_map(torch.clone, params)
    opt = make_optimizer(run.train)
    opt.step(new, grads, opt.init(new))
    return new


def _update_errs(got, want, old) -> list[float]:
    """Per leaf, how far the update ``got - old`` is from ``want - old``
    beyond one rounding step of the new parameter (the spacing of its type
    at ``want``), over the leaf's max |want - old|; 0 where both updates
    are all 0, inf where only ``want``'s is. Taken in float64 on ``got``'s
    device, leaf by leaf (the same IEEE arithmetic as on the CPU)."""
    errs = []
    for g, w, o in zip(tree_leaves(got), tree_leaves(want), tree_leaves(old)):
        w, o = w.to(g.device), o.to(g.device)
        step = (torch.nextafter(w, torch.full_like(w, math.inf)) - w).double()
        excess = ((g.double() - w.double()).abs() - step).clamp_min(0).max().item()
        scale = (w.double() - o.double()).abs().max().item()
        errs.append(excess / scale if scale else (0.0 if excess == 0 else math.inf))
    return errs


@contextlib.contextmanager
def _train_fault(fault: str):
    """A fault the training gradient check must see, for the length of a
    ``with``: gmm's first backward product with no dw (K4's dw launch left
    out), or every ssd_scan backward's dB zeroed (K3's backward kernels)."""
    gmm_bwd, ssd_bwd, calls = gmm.Gmm.backward, ssd_scan.SsdScan.backward, []

    def no_dw(ctx, dy):
        dx, dw = gmm_bwd(ctx, dy)
        calls.append(dw)
        return dx, (torch.zeros_like(dw) if len(calls) == 1 else dw)

    def no_db(ctx, dy, dstate):
        out = list(ssd_bwd(ctx, dy, dstate))
        out[3] = torch.zeros_like(out[3])
        return tuple(out)

    if fault == "gmm_dw_dropped":
        gmm.Gmm.backward = staticmethod(no_dw)
    else:
        ssd_scan.SsdScan.backward = staticmethod(no_db)
    try:
        yield
    finally:
        gmm.Gmm.backward, ssd_scan.SsdScan.backward = staticmethod(gmm_bwd), staticmethod(ssd_bwd)


def _train_check(card: str) -> dict:
    """The training step card against CPU, fp32, at the llm phase's cuts
    (``_cut_config``), 2 x 256 tokens, on the same parameters: loss,
    gradients and one AdamW update at TRAIN_TOL; MoE routing replayed from
    the card on the CPU (``RouteReplay``); the planted faults must fail the
    gradient limit."""
    out = {}
    for arch in (SERVE_ARCH, SSM_ARCH, MOE_ARCH):
        cfg = _cut_config(arch, "float32")
        run = _train_run(cfg, TRAIN_CHECK_BATCH, TRAIN_CHECK_SEQ)
        host = LMStream(cfg.vocab_size, TRAIN_CHECK_SEQ, TRAIN_CHECK_BATCH,
                        seed=0).batch_at(0)
        batch = {k: torch.from_numpy(v) for k, v in host.items()}
        card_batch = {k: v.to(DEV) for k, v in batch.items()}
        params = api.init(1, cfg, device=DEV)
        cpu_params = tree_map(lambda t: t.cpu(), params)
        before = launch_counts()
        with RouteRecorder() as routes:
            loss, _, grads = steps.value_and_grad(params, card_batch, run)
            torch.cuda.synchronize()
        launches = {k: v - before[k] for k, v in launch_counts().items() if v != before[k]}
        with RouteReplay(t.cpu() for t in routes.top_e) as rep:
            want_loss, _, want = steps.value_and_grad(cpu_params, batch, run)
        loss_err = abs(loss.item() - want_loss.item()) / abs(want_loss.item())
        grad_err = max(_grad_errs(grads, want))
        faults = {}
        for fault, where in TRAIN_PLANTED.items():
            if where == arch:
                with _train_fault(fault), RouteReplay(routes.top_e):
                    faulty = steps.value_and_grad(params, card_batch, run)[2]
                faults[fault] = max(_grad_errs(faulty, want))
                del faulty
        del want
        cpu_grads = tree_map(lambda t: t.cpu(), grads)  # before the card's step clips grads
        upd_err = max(_update_errs(_stepped(params, grads, run),
                                   _stepped(cpu_params, cpu_grads, run), cpu_params))
        del grads, cpu_grads, params, cpu_params
        torch.cuda.empty_cache()
        bad = {f: e for f, e in faults.items() if not e > TRAIN_TOL}
        if not (loss_err <= TRAIN_TOL and grad_err <= TRAIN_TOL and upd_err <= TRAIN_TOL) or bad:
            raise AssertionError(f"train check {arch}: loss {loss_err}, gradients {grad_err}, "
                                 f"update {upd_err} (tolerance {TRAIN_TOL}); planted faults "
                                 f"that passed the limit: {bad}")
        routed = (f", the card's expert choices replayed on the CPU (its own top-k agrees "
                  f"on {rep.agreement:.3f})" if rep.total else "")
        planted = "".join(f"; planted {f}: {e:.3g} (must fail)" for f, e in faults.items())
        print(f"train: check {arch} {cfg.num_layers} layers, fp32, {TRAIN_CHECK_BATCH} x "
              f"{TRAIN_CHECK_SEQ} tokens, card vs CPU: loss {loss_err:.3g}, gradients {grad_err:.3g} "
              f"of each leaf's max, one AdamW update {upd_err:.3g} of each leaf's max beyond a "
              f"rounding step of the parameter (tolerance {TRAIN_TOL}){routed}{planted}; "
              f"launches {launches}  [{card}]")
        out[arch] = {"loss_rel_err": loss_err, "grad_rel_err": grad_err,
                     "update_rel_err": upd_err, "planted": faults, "launches": launches,
                     "route_agreement": rep.agreement if rep.total else None}
    return out


def _train_loop(card: str) -> dict:
    """``run_training`` on mamba2-370m cut to TRAIN_LOOP_LAYERS layers into a
    temporary directory (removed after): a failure injected after step
    TRAIN_LOOP_FAIL with checkpoints every TRAIN_LOOP_EVERY steps, then the
    same call resumes; the state it resumes from must be, bitwise, the state
    saved at the last checkpoint. Also the seconds an async save of that
    state takes (to return: the host snapshot; to finish: the write)."""
    cfg = configs.get(SSM_ARCH).scaled(num_layers=TRAIN_LOOP_LAYERS)
    run = _train_run(cfg, TRAIN_BATCH, TRAIN_SEQ)
    step = steps.make_train_step(run)[0]
    stream = LMStream(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0)

    def batch_at(i):
        return {k: torch.from_numpy(v).to(DEV) for k, v in stream.batch_at(i).items()}

    def fresh():
        params = api.init(0, cfg, device=DEV)
        return {"params": params, "opt": make_optimizer(run.train).init(params)}

    saved, seen = {}, {}

    def snapshotting(state, batch):
        state, m = step(state, batch)
        saved[int(state["opt"]["step"])] = tree_map(torch.clone, state)
        return state, m

    def recording(state, batch):  # its first call gets the restored state
        seen.setdefault("first", tree_map(torch.clone, state))
        return step(state, batch)

    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        cfg_fail = LoopConfig(total_steps=TRAIN_LOOP_STEPS, ckpt_every=TRAIN_LOOP_EVERY,
                              ckpt_dir=tmp, fail_at_step=TRAIN_LOOP_FAIL, log_every=100,
                              async_ckpt=False)
        try:
            run_training(snapshotting, fresh(), batch_at, cfg_fail, log_fn=lambda s: None)
            raise AssertionError("train loop: the injected failure did not happen")
        except RuntimeError as e:
            if "injected failure" not in str(e):
                raise
        t0 = time.perf_counter()
        res = run_training(recording, fresh(), batch_at,
                           dataclasses.replace(cfg_fail, fail_at_step=None, async_ckpt=True),
                           log_fn=lambda s: None)
        resume_s = time.perf_counter() - t0
        want = saved[TRAIN_LOOP_EVERY]
        same = all(torch.equal(a, b) for a, b in zip(tree_leaves(seen["first"]),
                                                      tree_leaves(want)))
        if not (res.resumed_from == TRAIN_LOOP_EVERY and res.final_step == TRAIN_LOOP_STEPS
                and same and checkpoint.latest_step(tmp) == TRAIN_LOOP_STEPS):
            raise AssertionError(f"train loop: resumed from {res.resumed_from}, final step "
                                 f"{res.final_step}, restored state bitwise {same}")
        state_gb = sum(t.numel() * t.element_size() for t in tree_leaves(want)) / 1e9
        t0 = time.perf_counter()
        pending = checkpoint.save(tmp, 99, want, blocking=False)
        return_s = time.perf_counter() - t0
        pending.join()
        write_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"train: loop on {SSM_ARCH} cut to {TRAIN_LOOP_LAYERS} layers ({state_gb:.2f} GB of "
          f"state): failure injected after step {TRAIN_LOOP_FAIL}, resumed from step "
          f"{res.resumed_from} (the state bitwise the one saved there), final step "
          f"{res.final_step}, resumed run {resume_s:.2f} s; an async save returns in "
          f"{return_s:.3f} s (the host snapshot) and is written in {write_s:.3f} s  [{card}]")
    return {"resumed_from": res.resumed_from, "final_step": res.final_step,
            "state_gb": state_gb, "resume_s": resume_s, "async_save_return_s": return_s,
            "async_save_write_s": write_s}


def _train_keys(res: dict, kernel: str, step: str) -> dict:
    """A kernel's keys of the ``kernels`` line from its training run: its
    launches and device ms per step, and its backward range's device ms per
    step where it has one."""
    out = {"launches_per_train_step": res["launches_per_step"][kernel],
           "device_ms_per_train_step": res["by_kernel"][kernel], "train_step": step}
    bwd = res["ranges"].get(f"{kernel.removesuffix('_bwd')}.backward")
    if bwd is not None:
        out["backward_range_device_ms_per_train_step"] = bwd
    return out


def train_phase(card: str) -> dict:
    """The LLM families' training step on the card at full width: qwen3-1.7B
    (28 layers, flash_pallas, remat="full": 112 K2 launches a step, 28
    forward, 28 in the recompute and 2 a layer of the backward's),
    mamba2-370m (48 layers, remat="none": 288 K3 launches, 48 forward and 5
    a layer of the backward's) and qwen2-moe-a2.7b cut to TRAIN_MOE_LAYERS
    layers (flash_pallas, remat="none": 9 K4 launches a layer, 3 forward and
    6 backward, and 3 K2); each backward timed alone against its plain VJP;
    then the card against the CPU (``_train_check``) and the loop
    (``_train_loop``)."""
    part_s, t0 = {}, time.perf_counter()

    def done(name):
        nonlocal t0
        part_s[name] = time.perf_counter() - t0
        t0 = time.perf_counter()

    qwen3 = configs.get(SERVE_ARCH).scaled(attn_impl="flash_pallas")
    qwen3_out = _train_model(card, f"{SERVE_ARCH} full width, {qwen3.num_layers} layers", qwen3,
                             "full", {"flash_attention": 4 * qwen3.num_layers,
                                      "flash_attention_bwd": 2 * qwen3.num_layers},
                             n_steps=TRAIN_STEPS, variants=True)
    if not qwen3_out["loss_drop"] >= TRAIN_LOSS_DROP:
        raise AssertionError(f"train {SERVE_ARCH}: the loss fell {qwen3_out['loss_drop']} over "
                             f"{TRAIN_STEPS} steps, not {TRAIN_LOSS_DROP}")
    done("qwen3")
    mamba = configs.get(SSM_ARCH)
    mamba_out = _train_model(card, f"{SSM_ARCH} full width, {mamba.num_layers} layers", mamba,
                             "none", {"ssd_scan": (1 + ssd_scan.BWD_LAUNCHES) * mamba.num_layers,
                                      "ssd_scan_bwd": ssd_scan.BWD_LAUNCHES * mamba.num_layers})
    done("mamba2")
    moe_cfg = configs.get(MOE_ARCH).scaled(num_layers=TRAIN_MOE_LAYERS, attn_impl="flash_pallas")
    moe_out = _train_model(card, f"{MOE_ARCH} full width, cut to {TRAIN_MOE_LAYERS} layers",
                           moe_cfg, "none", {"gmm": 9 * TRAIN_MOE_LAYERS,
                                             "flash_attention": 3 * TRAIN_MOE_LAYERS,
                                             "flash_attention_bwd": 2 * TRAIN_MOE_LAYERS})
    done("moe")
    bwd = {kind: _backward_call(kind) for kind in ("flash_attention", "ssd_scan")}
    # K3's launches a call in the profiled mamba2 steps: a step's device ms
    # over its calls (one a layer)
    bwd["ssd_scan"]["launch_ms"] = {k: v / mamba.num_layers
                                    for k, v in mamba_out["backward_launch_ms"].items()
                                    if k.startswith("ssd_bwd_")}
    if not bwd["ssd_scan"]["launch_ms"]:
        raise AssertionError("the profiled mamba2 steps show no ssd_bwd_* kernel")
    for kind, per_step, res in (("flash_attention", qwen3.num_layers, qwen3_out),
                                ("ssd_scan", mamba.num_layers, mamba_out)):
        r = bwd[kind]
        lib = "" if r["library_ms"] is None else f", sdpa's backward {r['library_ms']:.4f} ms"
        print(f"train: {kind}'s backward alone at the step's shape (CUDA events): kernels "
              f"{r['ms']:.4f} ms a call (x {per_step} = {r['ms'] * per_step:.2f} ms a step; "
              f"the step's {kind}.backward range {res['ranges'][f'{kind}.backward']:.2f} ms), "
              f"plain VJP {r['plain_ms']:.4f} ms{lib}, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}; bytes {r['bound_bytes_ms']:.4f}, operations "
              f"{r['bound_ops_ms']:.4f})  [{card}]")
    r = bwd["ssd_scan"]
    print(f"train: ssd_scan's backward, {r['launches_per_call']} launches a call, device ms "
          f"each a call in the profiled mamba2 steps: "
          + ", ".join(f"{k} {v:.4f}" for k, v in r["launch_ms"].items())
          + f"; workspace {r['workspace_bytes'] / 1e6:.1f} MB, {r['plan']['slices']} slice(s) "
          f"of {r['plan']['heads']} heads, {r['plan']['items']} chunk items  [{card}]")
    done("backward")
    check = _train_check(card)
    done("check")
    loop = _train_loop(card)
    done("loop")
    print("train: seconds by part: " + ", ".join(f"{k} {v:.1f}" for k, v in part_s.items()))
    return {"qwen3": qwen3_out, "mamba2": mamba_out, "moe": moe_out, "backward_call": bwd,
            "check": check, "loop": loop, "part_s": part_s}


@contextlib.contextmanager
def _recorded_mesh_search():
    """``meshsearch``'s controller and engine swapped for subclasses that
    keep their instances; the controller's updates on the card are timed
    with CUDA events around each call."""
    made = {"ctrl": [], "engine": []}

    class Ctrl(meshsearch.PPOController):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.update_events = []
            made["ctrl"].append(self)

        def update(self, vecs, rewards):
            if self.device.type != "cuda":
                return super().update(vecs, rewards)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            super().update(vecs, rewards)
            end.record()
            self.update_events.append((start, end))

    class Engine(meshsearch.CallableEngine):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made["engine"].append(self)

    saved = meshsearch.PPOController, meshsearch.CallableEngine
    meshsearch.PPOController, meshsearch.CallableEngine = Ctrl, Engine
    try:
        yield made
    finally:
        meshsearch.PPOController, meshsearch.CallableEngine = saved


def _mesh_search(cfg, device: str) -> dict:
    with _recorded_mesh_search() as made:
        t0 = time.perf_counter()
        res = meshsearch.search_mesh(cfg, LLM_SHAPES[MESH_SHAPE], samples=MESH_SAMPLES,
                                     chips=MESH_CHIPS, seed=0, device=device)
        if device == "cuda":
            torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    (ctrl,), (engine,) = made["ctrl"], made["engine"]
    if ctrl.device.type != device:
        raise AssertionError(f"mesh: the controller ran on {ctrl.device}, not {device}")
    update_ms = [a.elapsed_time(b) for a, b in ctrl.update_events]
    return {"result": res, "wall_s": wall_s, "logits": ctrl.logits.detach().cpu(),
            "update_ms": update_ms, "stats": engine.stats}


def mesh_phase(card: str) -> dict:
    """The pod mesh search with its PPO updates on the card against the same
    search on the CPU (MESH_*), then the full LLM scenario grid."""
    out = {}
    # the mesh path: counts at 0 just before, read just after (it launches
    # none of the port's kernels: its only device work is the PPO update)
    reset_counts()
    for arch in MESH_ARCHS:
        cfg = configs.get(arch)
        card_run = _mesh_search(cfg, "cuda")
        cpu_run = _mesh_search(cfg, "cpu")
        got, want = card_run["result"], cpu_run["result"]
        cfgs_card = [h["config"] for h in got.history]
        cfgs_cpu = [h["config"] for h in want.history]
        mismatched = sum(a != b for a, b in zip(cfgs_card, cfgs_cpu))
        if len(got.history) != MESH_SAMPLES or cfgs_card != cfgs_cpu:
            raise AssertionError(f"mesh {arch}: {mismatched} of {MESH_SAMPLES} sampled configs "
                                 f"differ between the card's search and the CPU's")
        if repr(got.history) != repr(want.history):
            raise AssertionError(f"mesh {arch}: the records differ between card and CPU")
        if got.best_cfg != want.best_cfg or repr(got.best) != repr(want.best):
            raise AssertionError(f"mesh {arch}: best {got.best_cfg} on the card, "
                                 f"{want.best_cfg} on the CPU")
        logit_err = (card_run["logits"] - cpu_run["logits"]).abs().max().item()
        if not logit_err <= MESH_LOGIT_TOL:
            raise AssertionError(f"mesh {arch}: final PPO logits card vs CPU {logit_err}")
        n_updates = -(-MESH_SAMPLES // 16)
        if len(card_run["update_ms"]) != n_updates:
            raise AssertionError(f"mesh {arch}: {len(card_run['update_ms'])} PPO updates timed, "
                                 f"not {n_updates}")
        st = card_run["stats"]
        hit_rate = st.cache_hits / st.requested
        update_ms = float(np.mean(card_run["update_ms"]))
        out[arch] = {"card_wall_s": card_run["wall_s"], "cpu_wall_s": cpu_run["wall_s"],
                     "ms_per_sample": card_run["wall_s"] * 1e3 / MESH_SAMPLES,
                     "cpu_ms_per_sample": cpu_run["wall_s"] * 1e3 / MESH_SAMPLES,
                     "ppo_update_ms": card_run["update_ms"], "ppo_update_mean_ms": update_ms,
                     "cache_hit_rate": hit_rate, "evaluated": st.evaluated,
                     "best_cfg": got.best_cfg, "best_step_s": got.best["step_s"],
                     "logit_err": logit_err, "mismatched_configs": mismatched}
        print(f"mesh: {arch} {MESH_SHAPE} on {MESH_CHIPS} chips, {MESH_SAMPLES} samples: card "
              f"{card_run['wall_s']:.3f} s ({out[arch]['ms_per_sample']:.3f} ms per sample), CPU "
              f"{cpu_run['wall_s']:.3f} s; PPO update on the card {update_ms:.3f} ms mean over "
              f"{n_updates} (CUDA events); engine cache hit rate {hit_rate:.1%} "
              f"({st.evaluated} evaluated); configs and records card = CPU, "
              f"logits {logit_err:.2e} apart (limit {MESH_LOGIT_TOL})  [{card}]")
        print(f"mesh:   best {got.best_cfg} step_s {got.best['step_s']!r}")
    launches = {k: v for k, v in launch_counts().items() if v}
    if launches:
        raise AssertionError(f"mesh: the mesh search launched {launches}")

    t0 = time.perf_counter()
    grid = scenarios.grid()
    grid_s = time.perf_counter() - t0
    feats = np.stack([scenarios.features(sc) for sc in grid])
    lo, hi = scenarios.GRID_LATENCY_CLIP_MS
    if len(grid) != GRID_SIZE or len({row.tobytes() for row in feats}) != GRID_SIZE:
        raise AssertionError(f"mesh: grid of {len(grid)} scenarios, "
                             f"{len({row.tobytes() for row in feats})} distinct feature vectors")
    bad = [sc.name for sc in grid if not lo <= sc.latency_target_ms <= hi]
    if bad:
        raise AssertionError(f"mesh: grid targets outside [{lo}, {hi}] ms: {bad[:5]}")
    print(f"mesh: scenarios.grid() {len(grid)} scenarios in {grid_s:.3f} s (host), "
          f"{GRID_SIZE} distinct feature vectors, targets in [{lo}, {hi}] ms  [{card}]")
    out["grid"] = {"count": len(grid), "wall_s": grid_s}
    return out


# the parallel phase: one world of 8 ranks (on one card, over gloo with CUDA
# tensors staged through host memory), qwen3-1.7B cut to 4 layers and
# qwen2-moe-a2.7b to 2 at full width, 8 x 512 tokens, fp32: the limits of the
# train phase's card-vs-CPU check (loss relative, each gradient leaf over its
# own max, an update beyond one fp32 step) and of tests/test_sharded.py's
# pipeline
PARALLEL_RANKS = 8
PARALLEL_BATCH, PARALLEL_SEQ = 8, 512
PARALLEL_LAYERS = {SERVE_ARCH: 4, MOE_ARCH: 2}
PARALLEL_LOSS_TOL, PARALLEL_GRAD_TOL, PARALLEL_MOE_TOL = 1e-5, 1e-4, 1e-4
# pipeline: stages (the mesh), microbatches, rows each, width; absolute limit
PARALLEL_PIPE = (8, 16, 64, 2048)
PARALLEL_PIPE_TOL = 1e-5
PARALLEL_PSUM = (8, (1024, 1024))  # steps with error feedback, each rank's gradient
PARALLEL_DEADLINE_S = 900


def _parallel_cut(arch: str):
    """The parallel phase's full-width cut of ``arch`` in fp32, attention on
    the kernel."""
    return configs.get(arch).scaled(num_layers=PARALLEL_LAYERS[arch], attn_impl="flash_pallas",
                                    compute_dtype="float32")


def _parallel_run(cfg) -> RunConfig:
    return _train_run(cfg, PARALLEL_BATCH, PARALLEL_SEQ).replace(mesh=MeshConfig())


def _parallel_batch(cfg, device) -> dict:
    host = LMStream(cfg.vocab_size, PARALLEL_SEQ, PARALLEL_BATCH, seed=0).batch_at(0)
    return {k: torch.from_numpy(v).to(device) for k, v in host.items()}


def _pipe_inputs(device) -> tuple[torch.Tensor, torch.Tensor]:
    s, m, rows, width = PARALLEL_PIPE
    gen = torch.Generator(device=device).manual_seed(7)
    ws = torch.randn((s, width, width), generator=gen, device=device) / math.sqrt(width)
    xs = torch.randn((m, rows, width), generator=gen, device=device)
    return ws, xs


def _psum_grads(rank: int) -> torch.Tensor:
    _, shape = PARALLEL_PSUM
    gen = torch.Generator().manual_seed(100 + rank)
    return torch.randn(shape, generator=gen)


def _local_piece(d, whole: torch.Tensor) -> torch.Tensor:
    """The slice of ``whole`` that the DTensor ``d`` holds on this rank."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    shape, off = compute_local_shape_and_global_offset(whole.shape, d.device_mesh, d.placements)
    return whole[tuple(slice(o, o + n) for o, n in zip(off, shape))]


def _local_errs(got, want: dict, scales: dict) -> dict:
    """Per leaf of the DTensor tree ``got``: max |local shard - the same
    slice of the whole leaf ``want[path]``| over that whole leaf's max
    |value| (``scales[path]``)."""
    out = {}
    for path, g in tree_paths(got):
        local = g.to_local()
        piece = _local_piece(g, want[path]).to(local.device)
        diff = (local.float() - piece.float()).abs().max().item() if piece.numel() else 0.0
        scale = scales[path]
        out[path] = diff / scale if scale else (0.0 if diff == 0 else math.inf)
    return out


def _drop_model_sum(h):
    """The planted fault: a row-parallel product's output, pending its sum
    over the model axis, taken as if already summed (each rank keeps only
    its own heads' share)."""
    from torch.distributed.tensor import DTensor, Replicate

    if not any(p.is_partial() for p in h.placements):
        raise AssertionError(f"the attention output is not a pending sum: {h.placements}")
    pl = [Replicate() if p.is_partial() else p for p in h.placements]
    return DTensor.from_local(h.to_local(), h.device_mesh, pl, run_check=False)


@contextlib.contextmanager
def _parallel_fault(fault: str):
    """``model_sum_dropped``: layer 0's attention output (``wo``, a
    row-parallel product) loses its model-axis sum; ``e_start_shifted``:
    every EP rank runs the next rank's experts under its own ids."""
    from repro_torch.models import layers

    if fault == "model_sum_dropped":
        orig, calls = layers.attention_block, []

        def faulty(*args, **kwargs):
            out, cache = orig(*args, **kwargs)
            calls.append(1)
            return (_drop_model_sum(out) if len(calls) == 1 else out), cache

        layers.attention_block = faulty
        try:
            yield
        finally:
            layers.attention_block = orig
    else:
        orig = moe._moe_ffn_local

        def shifted(x3d, wr, wg, wu, wo, cfg, e_start, e_count):
            return orig(x3d, wr, wg, wu, wo, cfg, (e_start + e_count) % cfg.num_experts, e_count)

        moe._moe_ffn_local = shifted
        try:
            yield
        finally:
            moe._moe_ffn_local = orig


def _sync_ms(fn) -> tuple:
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t)


def _parallel_dense(pc, shared: dict) -> dict:
    """qwen3's sharded gradients against the parent's unsharded ones, the
    sharded AdamW update against the unsharded optimizer's on the same
    gradients (as the train phase holds the card's update against the
    CPU's), one timed train step, and the planted fault."""
    from torch.distributed.tensor.debug import CommDebugMode

    cfg = _parallel_cut(SERVE_ARCH)
    run = _parallel_run(cfg)
    step, sspecs, bspecs = steps.make_train_step(run, pc)
    opt = make_optimizer(run.train)
    batch = sharding.distribute_tree(shared["batch"], bspecs, pc.mesh)
    want = torch.load(Path(shared["refs"]) / "grads.pt", mmap=True)
    flat = torch.load(Path(shared["refs"]) / "params.pt", mmap=True)
    abstract = steps.abstract_params(cfg)
    whole = tree_unflatten_paths(abstract, [flat[p] for p, _ in tree_paths(abstract)])
    params = sharding.distribute_tree(whole, sspecs["params"], pc.mesh)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    # the dry run's counter reads the rank's own local ops (the dryrun phase
    # holds its trace of this pass against them)
    comm, counter = CommDebugMode(), dryrun.StepCounter()
    counter.arguments((params, batch))
    with comm, counter:
        (loss, _, grads), grad_ms = _sync_ms(
            lambda: steps.value_and_grad(params, batch, run, pc))
    counter.outputs((loss, grads))
    res = {"loss": loss.full_tensor().item(), "grad_ms": grad_ms,
           "grad_errs": _local_errs(grads, want, shared["grad_scales"]),
           "collectives": {str(k).split(".")[-1]: v for k, v in
                           comm.get_comm_counts().items()},
           "counts": counter.result(), "memory": counter.memory_analysis(),
           "grad_peak": torch.cuda.max_memory_allocated()}
    # the sharded update; the optimizer clips ``grads`` in place, so each
    # leaf's reference below steps from the same clipped gradient
    new, _, _ = opt.step(tree_map(torch.clone, params), grads, opt.init(params))
    res["update_err"] = _sharded_update_err(new, grads, whole, run)
    del new, grads
    state = {"params": params, "opt": opt.init(params)}
    (state, metrics), res["step_ms"] = _sync_ms(lambda: step(state, batch))
    res["step_loss"] = float(metrics["loss"])
    res["launches"] = launch_counts()["flash_attention"]
    res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del state
    with _parallel_fault("model_sum_dropped"):
        _, _, bad = steps.value_and_grad(
            sharding.distribute_tree(whole, sspecs["params"], pc.mesh), batch, run, pc)
    res["fault_grad_err"] = max(_local_errs(bad, want, shared["grad_scales"]).values())
    return res


def _sharded_update_err(new, clipped, old, run) -> float:
    """The sharded AdamW result ``new`` against the unsharded optimizer's
    step of the same slices of the whole leaves ``old`` from the same
    clipped gradients (AdamW is elementwise once the gradients are
    clipped), beyond one fp32 step (``_update_errs``): each rank checks its
    own shards. The reference clips nothing more (an infinite clip)."""
    noclip = run.replace(train=dataclasses.replace(run.train, grad_clip=math.inf))
    worst = 0.0
    for (_, n), (_, g), (_, o) in zip(tree_paths(new), tree_paths(clipped), tree_paths(old)):
        piece = _local_piece(n, o).to(n.to_local().device)
        want = _stepped({"p": piece}, {"p": g.to_local().clone()}, noclip)["p"]
        # on the CPU: the rank's peak memory, read after this, stays the step's
        worst = max(worst, _update_errs([n.to_local().cpu()], [want.cpu()], [piece.cpu()])[0])
    return worst


def _parallel_moe(pc_ep, pc_tpe, shared: dict) -> dict:
    """qwen2-moe's EP forward per data shard and TPE forward on the whole
    batch against the parent's unsharded forwards."""
    cfg = _parallel_cut(MOE_ARCH)
    res = {}
    for scheme, pc in (("ep", pc_ep), ("tpe", pc_tpe)):
        assert moe.ep_scheme(cfg, pc) == scheme
        specs = sharding.param_specs(shared["moe_params"], cfg, pc, MeshConfig())
        params = sharding.distribute_tree(shared["moe_params"], specs, pc.mesh)
        reset_counts()
        with torch.no_grad():
            (logits, aux), ms = _sync_ms(
                lambda: api.forward(params, {"tokens": shared["moe_tokens"]}, cfg, pc))
        res[f"{scheme}_launches"] = launch_counts()["gmm"]
        res[f"{scheme}_attention_launches"] = launch_counts()["flash_attention"]
        res[f"{scheme}_ms"] = ms
        want = torch.load(Path(shared["refs"]) / f"{scheme}_logits.pt", mmap=True)
        scale = shared["logit_scales"][scheme]
        res[f"{scheme}_err"] = _logit_err(logits, want, scale)
        res[f"{scheme}_aux"] = aux.full_tensor().item()
        if scheme == "ep":
            with _parallel_fault("e_start_shifted"), torch.no_grad():
                bad, _ = api.forward(params, {"tokens": shared["moe_tokens"]}, cfg, pc)
            res["fault_err"] = _logit_err(bad, want, scale)
        del params, logits
    return res


def _logit_err(logits, want, scale: float) -> float:
    """max |local logits - the same slice of want| over max |want|
    (``scale``; want stacked per data shard for EP: (shards, B/shards, S,
    V))."""
    local = logits.to_local()
    piece = _local_piece(logits, want.reshape(logits.shape)).to(local.device)
    return (local - piece).abs().max().item() / scale


def _parallel_pipeline(mesh8, shared: dict) -> dict:
    from repro_torch.parallel import pipeline

    sid = mesh8.get_local_rank("stage")
    ws, xs = shared["pipe_ws"], shared["pipe_xs"]
    mine = {"w": ws[sid:sid + 1]}  # this stage's weights only
    out, ms = _sync_ms(lambda: pipeline.pipeline_apply(
        lambda p, x: torch.tanh(x @ p["w"]), mine, xs, mesh8))
    return {"err": (out - shared["pipe_want"]).abs().max().item(), "ms": ms}


def _parallel_psum(mesh8, cpu8) -> dict:
    from repro_torch.parallel.compression import compressed_psum

    rank = mesh8.get_local_rank("stage")
    g = _psum_grads(rank)
    steps_, _ = PARALLEL_PSUM
    same, err_card, err_cpu = True, None, None
    for t in range(steps_):
        card, err_card = compressed_psum({"g": (g * (t + 1)).to(DEV)},
                                         mesh8.get_group("stage"), err_card)
        host, err_cpu = compressed_psum({"g": g * (t + 1)}, cpu8.get_group("stage"), err_cpu)
        same &= torch.equal(card["g"].cpu(), host["g"])
        same &= torch.equal(err_card["g"].cpu(), err_cpu["g"])
    return {"bitwise": bool(same)}


def _parallel_checkpoint(pc, mesh42, root: str) -> dict:
    """The qwen3 smoke config after one sharded step, saved and restored
    onto (4, 2) and onto one device: the largest difference from the state
    (0 when bitwise)."""
    cfg = configs.smoke(SERVE_ARCH).scaled(compute_dtype="float32")
    run = _train_run(cfg, 8, 64).replace(mesh=MeshConfig(fsdp_min_size=1))
    step, sspecs, bspecs = steps.make_train_step(run, pc)
    params = api.init(0, cfg, device=DEV)
    state = sharding.distribute_tree({"params": params, "opt": make_optimizer(run.train).init(
        params)}, sspecs, pc.mesh)
    host = LMStream(cfg.vocab_size, 64, 8, seed=1).batch_at(0)
    state, _ = step(state, sharding.distribute_tree(
        {k: torch.from_numpy(v).to(DEV) for k, v in host.items()}, bspecs, pc.mesh))
    checkpoint.save(root, 1, state)
    want = {p: t.full_tensor() for p, t in tree_paths(state)}
    moved, _ = checkpoint.restore(root, state,
                                  shardings=sharding.shardings(state, sspecs, mesh42))
    alone, _ = checkpoint.restore(root, tree_map(torch.zeros_like, tree_map(
        lambda t: t.full_tensor(), state)))
    diff = 0.0
    for (p, a), (_, b) in zip(tree_paths(moved), tree_paths(alone)):
        assert a.device_mesh is mesh42 and a.dtype == b.dtype == want[p].dtype
        diff = max(diff, (a.full_tensor() - want[p]).abs().max().item(),
                   (b - want[p]).abs().max().item())
    return {"max_diff": diff}


def _parallel_rank(rank: int, shared: dict, root: str) -> dict:
    """One rank of the parallel phase's world (see ``parallel_phase``)."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.ctx import from_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh24 = make_mesh((2, 4), ("data", "model"), device=DEV)
    mesh18 = make_mesh((1, 8), ("data", "model"), device=DEV)
    mesh8 = make_mesh((8,), ("stage",), device=DEV)
    mesh42 = make_mesh((4, 2), ("data", "model"), device=DEV)
    cpu8 = init_device_mesh("cpu", (8,), mesh_dim_names=("stage",))
    pc = from_mesh(mesh24)
    t = time.perf_counter()
    parts = {"dense": lambda: _parallel_dense(pc, shared),
             "moe": lambda: _parallel_moe(pc, from_mesh(mesh18), shared),
             "pipeline": lambda: _parallel_pipeline(mesh8, shared),
             "psum": lambda: _parallel_psum(mesh8, cpu8),
             "checkpoint": lambda: _parallel_checkpoint(pc, mesh42, root)}
    res = {}
    for name, part in parts.items():
        res[name] = part()
        torch.cuda.empty_cache()
        if rank == 0:
            print(f"parallel rank 0: {name} done at {time.perf_counter() - t:.1f} s, peak "
                  f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
    res["rank_s"] = time.perf_counter() - t
    res["staged_bytes"] = dict(staging.STAGED_BYTES)
    res["staged_calls"] = dict(staging.CALLS)
    return res


def parallel_phase(card: str) -> dict:
    """One world of PARALLEL_RANKS ranks over three meshes, as the
    reference's tests/test_sharded.py builds them over 8 host devices:
    (2, 4) and (1, 8) (data, model) and (8,) stage. Every reference result
    is computed here first, unsharded on the card, and handed to the ranks
    by CUDA IPC with the parameters they slice (nothing is copied whole per
    rank). Each rank holds its own shards against the same slices of it:

    * qwen3-1.7B at full width cut to 4 layers, fp32, 8 x 512 tokens,
      AdamW, on (2, 4) (TP 4, FSDP on data): the first gradients per leaf
      over that leaf's max, the loss, one train step's update beyond one
      fp32 step, K2 launched on every rank (local heads) the same number of
      times; a planted fault (layer 0's attention output losing its
      model-axis sum) must fail the gradient limit;
    * qwen2-moe-a2.7b at full width cut to 2 layers, fp32 forward over the
      same tokens: EP on (2, 4) (15 experts a rank) against the unsharded
      forward of each data shard's rows, TPE on (1, 8) (60 experts, F 176)
      against the whole batch's, K4 on every rank; a planted fault (each
      EP rank running another rank's experts) must fail;
    * ``pipeline_apply`` over 8 stages: 16 microbatches of tanh(x @ w) at
      width 2048 against the sequential product;
    * ``compressed_psum`` over 8 ranks, 8 steps with error feedback, the
      card's run bitwise the CPU's (a CPU mesh over the same world);
    * the qwen3 smoke config after one sharded step saved and restored
      onto (4, 2) and onto one device, bitwise.

    With fewer cards than ranks every rank computes on cuda:0 and the
    collectives go over gloo (NCCL takes no two ranks on one device): the
    walls time-share one card and cross host memory, so they are no scaling
    figure."""
    from repro_torch.launch.mesh import backend_for, run_world

    t0 = time.perf_counter()
    backend = backend_for(PARALLEL_RANKS, DEV)
    print(f"parallel: {PARALLEL_RANKS} ranks over {backend} on "
          f"{min(PARALLEL_RANKS, torch.cuda.device_count())} card(s)  [{card}]")
    cfg = _parallel_cut(SERVE_ARCH)
    run = _parallel_run(cfg)
    params = api.init(0, cfg, device=DEV)
    batch = _parallel_batch(cfg, DEV)
    reset_counts()
    loss, _, grads = steps.value_and_grad(params, batch, run)
    mcfg = _parallel_cut(MOE_ARCH)
    moe_params = api.init(0, mcfg, device=DEV)
    half = PARALLEL_BATCH // 2
    with torch.no_grad():
        halves = [api.forward(moe_params, {"tokens": batch["tokens"][i:i + half]}, mcfg)
                  for i in (0, half)]
        ep_want = torch.stack([logits for logits, _ in halves])
        ep_auxes = [aux.item() for _, aux in halves]
        del halves
        tpe_want, tpe_aux = api.forward(moe_params, {"tokens": batch["tokens"]}, mcfg)
    ws, xs = _pipe_inputs(DEV)
    pipe_want = xs
    for w in ws:
        pipe_want = torch.tanh(pipe_want @ w)
    root = Path(tempfile.mkdtemp(prefix="chip-smoke-parallel-"))
    # what the ranks compare against goes to files they map and slice
    # (each rank copies only its own slices to the card); what they build
    # from goes by CUDA IPC
    refs = {"grads": {p: g.cpu() for p, g in tree_paths(grads)},
            "params": {p: t.cpu() for p, t in tree_paths(params)},
            "ep_logits": ep_want.cpu(), "tpe_logits": tpe_want.cpu()}
    for name, ref in refs.items():
        torch.save(ref, root / f"{name}.pt")
    shared = {"batch": batch, "refs": str(root),
              "grad_scales": {p: g.abs().max().item() for p, g in tree_paths(grads)},
              "logit_scales": {"ep": ep_want.abs().max().item(),
                               "tpe": tpe_want.abs().max().item()},
              "moe_params": moe_params, "moe_tokens": batch["tokens"],
              "pipe_ws": ws, "pipe_xs": xs, "pipe_want": pipe_want}
    del refs, grads, params, ep_want, tpe_want
    torch.cuda.empty_cache()  # the ranks share the card: hand back what the references cached
    ref_s = time.perf_counter() - t0
    print(f"parallel: references {ref_s:.1f} s; the parent holds "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB for the ranks  [{card}]", flush=True)
    try:
        ranks = run_world(_parallel_rank, PARALLEL_RANKS, DEV, shared, str(root / "ckpt"),
                          timeout_s=PARALLEL_DEADLINE_S, threads=None)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    del shared, moe_params
    torch.cuda.empty_cache()

    dense = [r["dense"] for r in ranks]
    moes = [r["moe"] for r in ranks]
    grad_err = max(max(d["grad_errs"].values()) for d in dense)
    update_err = max(d["update_err"] for d in dense)
    loss_err = max(abs(d["loss"] - loss.item()) / abs(loss.item()) for d in dense)
    fault_err = min(d["fault_grad_err"] for d in dense)
    k2 = [d["launches"] for d in dense]
    out = {
        "backend": backend, "ranks": PARALLEL_RANKS, "ref_s": ref_s,
        "loss": loss.item(), "loss_rel_err": loss_err, "grad_err": grad_err,
        "update_err": update_err, "fault_grad_err": fault_err, "k2_launches": k2,
        "grad_ms": [d["grad_ms"] for d in dense], "step_ms": [d["step_ms"] for d in dense],
        "peak_gb": [d["peak_gb"] for d in dense], "collectives": dense[0]["collectives"],
        "grad_peak": [d["grad_peak"] for d in dense], "grad_counts": dense[0]["counts"],
        "grad_memory": dense[0]["memory"],
        "ep_err": max(m["ep_err"] for m in moes), "tpe_err": max(m["tpe_err"] for m in moes),
        "ep_fault_err": min(m["fault_err"] for m in moes),
        "ep_aux": moes[0]["ep_aux"], "ep_aux_want": float(np.mean(ep_auxes)),
        "tpe_aux": moes[0]["tpe_aux"], "tpe_aux_want": tpe_aux.item(),
        "k4_launches": {"ep": [m["ep_launches"] for m in moes],
                        "tpe": [m["tpe_launches"] for m in moes]},
        "moe_k2_launches": {"ep": [m["ep_attention_launches"] for m in moes],
                            "tpe": [m["tpe_attention_launches"] for m in moes]},
        "moe_ms": {"ep": [m["ep_ms"] for m in moes], "tpe": [m["tpe_ms"] for m in moes]},
        "pipe_err": max(r["pipeline"]["err"] for r in ranks),
        "pipe_ms": [r["pipeline"]["ms"] for r in ranks],
        "staged_bytes": [r["staged_bytes"] for r in ranks],
        "staged_calls": ranks[0]["staged_calls"],
        "psum_bitwise": all(r["psum"]["bitwise"] for r in ranks),
        "ckpt_max_diff": max(r["checkpoint"]["max_diff"] for r in ranks),
        "rank_s": [r["rank_s"] for r in ranks],
    }
    staged = out["staged_bytes"][0]
    print(f"parallel: backend {backend}; DTensor collectives on CUDA tensors in one qwen3 "
          f"gradient pass (rank 0): {out['collectives']}; collectives on CUDA tensors staged "
          f"through host memory over the phase (rank 0): calls {out['staged_calls']}, bytes "
          f"{staged} ({sum(staged.values()) / 1e9:.3f} GB; ranks "
          f"{[round(sum(b.values()) / 1e9, 3) for b in out['staged_bytes']]} GB)  [{card}]")
    print(f"parallel qwen3-1.7B x{PARALLEL_LAYERS[SERVE_ARCH]} on (2, 4), fp32, "
          f"{PARALLEL_BATCH} x {PARALLEL_SEQ}: loss rel err {loss_err:.3g}, grad err "
          f"{grad_err:.3g}, update err {update_err:.3g} (limits {PARALLEL_LOSS_TOL}, "
          f"{PARALLEL_GRAD_TOL}), planted fault {fault_err:.3g}; K2 launches per rank {k2}; "
          f"gradient pass ms {[round(v) for v in out['grad_ms']]}, train step ms "
          f"{[round(v) for v in out['step_ms']]}, peak GB per rank "
          f"{[round(v, 2) for v in out['peak_gb']]}  [{card}; {PARALLEL_RANKS} ranks "
          f"time-share one card over {backend}: not a scaling figure]")
    print(f"parallel qwen2-moe-a2.7b x{PARALLEL_LAYERS[MOE_ARCH]}: EP (2, 4) err "
          f"{out['ep_err']:.3g}, TPE (1, 8) err {out['tpe_err']:.3g} (limit "
          f"{PARALLEL_MOE_TOL}), planted e_start fault {out['ep_fault_err']:.3g}; aux EP "
          f"{out['ep_aux']:.6g} vs {out['ep_aux_want']:.6g}, TPE {out['tpe_aux']:.6g} vs "
          f"{out['tpe_aux_want']:.6g}; K4 launches EP {out['k4_launches']['ep']}, TPE "
          f"{out['k4_launches']['tpe']}; forward ms EP {[round(v) for v in out['moe_ms']['ep']]}"
          f", TPE {[round(v) for v in out['moe_ms']['tpe']]}  [{card}]")
    print(f"parallel pipeline {PARALLEL_PIPE}: err {out['pipe_err']:.3g} (limit "
          f"{PARALLEL_PIPE_TOL}), ms {[round(v) for v in out['pipe_ms']]}; compressed_psum "
          f"bitwise card vs CPU: {out['psum_bitwise']}; checkpoint (2, 4) -> (4, 2) and one "
          f"device max diff {out['ckpt_max_diff']}  [{card}]")
    assert loss_err <= PARALLEL_LOSS_TOL, loss_err
    assert grad_err <= PARALLEL_GRAD_TOL, grad_err
    assert update_err <= PARALLEL_GRAD_TOL, update_err
    assert fault_err > PARALLEL_GRAD_TOL, f"the planted fault passed: {fault_err}"
    assert len(set(k2)) == 1 and k2[0] > 0, k2
    assert out["ep_err"] <= PARALLEL_MOE_TOL and out["tpe_err"] <= PARALLEL_MOE_TOL, out
    assert out["ep_fault_err"] > PARALLEL_MOE_TOL, out["ep_fault_err"]
    assert abs(out["ep_aux"] - out["ep_aux_want"]) <= 1e-5 * abs(out["ep_aux_want"])
    assert abs(out["tpe_aux"] - out["tpe_aux_want"]) <= 1e-5 * abs(out["tpe_aux_want"])
    assert all(n > 0 for n in out["k4_launches"]["ep"] + out["k4_launches"]["tpe"]), out
    assert out["pipe_err"] <= PARALLEL_PIPE_TOL, out["pipe_err"]
    assert out["psum_bitwise"], "compressed_psum on the card differs from the CPU's"
    assert out["ckpt_max_diff"] == 0.0, out["ckpt_max_diff"]
    out["phase_s"] = time.perf_counter() - t0
    print(f"parallel: {out['phase_s']:.1f} s (references {ref_s:.1f} s, ranks "
          f"{max(out['rank_s']):.1f} s)  [{card}]")
    return out


# the dry run's CLI on the production mesh (16 x 16 fake ranks, fake CUDA
# tensors) at these cells: full width, one of each family's paths that fits
# the phase (the cells' traces take the host tens of seconds each at
# train_4k; PERF.md has every cell's run), and a skipped cell's status
DRYRUN_CELLS = (("qwen3_1_7b", "decode_32k"), ("mamba2_370m", "prefill_32k"),
                ("qwen2_moe_a2_7b", "decode_32k"), ("qwen3_1_7b", "long_500k"))
# the real single-rank prefills the trace is held against: the serve
# phases' (8 x 1024, bf16 weights and compute), attention on K2 where the
# serve phase runs it
DRYRUN_PREFILLS = ((SERVE_ARCH, "flash_pallas"), (SSM_ARCH, None), (MOE_ARCH, "flash_pallas"))
DRYRUN_PEAK_TOL = 0.2  # predicted peak against max_memory_allocated, relative
DRYRUN_DEADLINE_S = 600


def _dryrun_cells(card: str) -> dict:
    """(a) ``python -m repro_torch.launch.dryrun`` (its ``main``) at each of
    ``DRYRUN_CELLS``: the status, and an ok cell's roofline terms."""
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip-smoke-dryrun-") as d:
        for arch, shape in DRYRUN_CELLS:
            t = time.perf_counter()
            dryrun.main(["--arch", arch, "--shape", shape, "--device", DEV, "--out", d])
            rec = json.loads((Path(d) / f"{arch}_{shape}_single.json").read_text())
            want = configs.applicable_shapes(configs.get(arch))[shape]
            assert rec["status"] == want, (arch, shape, rec["status"], want)
            row = {"status": rec["status"], "s": time.perf_counter() - t}
            if want == "ok":
                rl = rec["roofline"]
                row.update({k: rl[k] for k in ("compute_s", "memory_s", "collective_s",
                                               "dominant", "useful_flops_ratio",
                                               "roofline_fraction")},
                           lower_s=rec["lower_s"], memory=rec["memory_analysis"],
                           flops=rec["cost_analysis"]["flops"],
                           reconstructed_flops=rec["reconstruction"]["flops"],
                           collectives=rec["collectives"]["counts"])
                assert 0 < rl["useful_flops_ratio"] <= 1.05, rl
                print(f"dryrun {arch} {shape} 16x16: compute {1e3 * rl['compute_s']:.3f} ms, "
                      f"memory {1e3 * rl['memory_s']:.3f} ms, collective "
                      f"{1e3 * rl['collective_s']:.3f} ms ({rl['dominant']}), useful-FLOPs "
                      f"ratio {rl['useful_flops_ratio']:.4f}; trace {rec['lower_s']:.1f} s, cell "
                      f"{row['s']:.1f} s  [the pod roofline's V5E terms; traced on {card}]",
                      flush=True)
            else:
                print(f"dryrun {arch} {shape}: {rec['status']}", flush=True)
            out[f"{arch} {shape}"] = row
    return out


def _prefill_run(arch: str, impl) -> RunConfig:
    """The serve phase's prefill of ``arch`` with bf16 weights (qwen2-moe's
    fp32 ones, 57 GB, leave too little of the card beside this process's
    parent)."""
    extra = {} if impl is None else {"model_attn_impl": impl}
    run = configs.make_run(arch, "decode_32k", model_param_dtype="bfloat16", **extra)
    return run.replace(shape=ShapeConfig("prefill", PROMPT, SERVE_BATCH, "prefill"))


def _dryrun_prefill(card: str, arch: str, impl) -> dict:
    """(b) The trace of one prefill at world 1 against the same prefill run
    on the card under the same counter (and torch's own FlopCounterMode):
    FLOPs and bytes equal, the peak within DRYRUN_PEAK_TOL; the trace
    launches nothing, the real run each kernel of its path."""
    from torch.utils.flop_counter import FlopCounterMode

    run = _prefill_run(arch, impl)
    cfg = run.model
    reset_counts()
    t = time.perf_counter()
    pred = dryrun._measure(run, None, want_mem=True, device=DEV)
    trace_s = time.perf_counter() - t
    assert not any(launch_counts().values()), launch_counts()
    params = api.init(0, cfg, device=DEV)
    gen = torch.Generator(device=DEV).manual_seed(3)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (SERVE_BATCH, PROMPT), generator=gen,
                                     device=DEV, dtype=torch.int32)}
    step = steps.make_prefill_step(run)[0]
    step(params, batch)  # the first call loads the libraries and their workspaces
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    counter, flop = dryrun.StepCounter(), FlopCounterMode(display=False)
    counter.arguments((params, batch))
    with flop, counter:
        logits = step(params, batch)
    counter.outputs(logits)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    launches = {k: v for k, v in launch_counts().items() if v}
    del logits, params
    torch.cuda.empty_cache()
    mem = pred["memory_analysis"]
    want_peak = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
    res = {"flops": pred["flops"], "real_flops": counter.flops,
           "torch_flops": flop.get_total_flops(), "bytes": pred["bytes"],
           "real_bytes": counter.bytes, "peak": want_peak, "real_peak": peak,
           "peak_err": abs(want_peak - peak) / peak, "launches": launches,
           "trace_s": trace_s, "memory": mem, "real_memory": counter.memory_analysis()}
    print(f"dryrun prefill {arch} ({cfg.attn_impl}) {SERVE_BATCH} x {PROMPT}, world 1: FLOPs "
          f"{res['flops']:.6e} traced / {res['real_flops']:.6e} run (FlopCounterMode "
          f"{res['torch_flops']:.6e}); bytes {res['bytes']:.6e} / {res['real_bytes']:.6e}; peak "
          f"{want_peak / 1e9:.3f} GB predicted / {peak / 1e9:.3f} GB max_memory_allocated "
          f"(err {res['peak_err']:.3f}); launches {launches}; trace {trace_s:.1f} s  [{card}]",
          flush=True)
    assert res["flops"] == res["real_flops"] == res["torch_flops"] > 0, res
    assert res["bytes"] == res["real_bytes"], res
    assert res["peak_err"] <= DRYRUN_PEAK_TOL, res
    assert launches, f"the real prefill of {arch} launched no kernel"
    return res


def _dryrun_control(card: str, real_flops: float) -> float:
    """The planted control: qwen2-moe's prefill traced with K4's FLOP
    formula replaced by zero must fail check (b). Returns the FLOPs it
    traced."""
    from torch.utils.flop_counter import flop_registry

    packet = torch.ops.repro_torch.gmm
    orig = flop_registry[packet]
    flop_registry[packet] = lambda *args, **kwargs: 0
    try:
        bad = dryrun._measure(_prefill_run(MOE_ARCH, "flash_pallas"), None, device=DEV)["flops"]
    finally:
        flop_registry[packet] = orig
    print(f"dryrun control: qwen2-moe's prefill traced with K4's FLOP formula zeroed reads "
          f"{bad:.6e} FLOPs against {real_flops:.6e} run (must differ)  [{card}]", flush=True)
    assert bad != real_flops, "the zero-FLOP K4 control passed check (b)"
    return bad


def _dryrun_parallel(card: str, par: dict) -> dict:
    """(c) The trace of the parallel phase's qwen3 gradient pass as rank 0
    of a fake world of PARALLEL_RANKS on (2, 4), against rank 0's readings
    of the real pass: collectives per kind (CommDebugMode and the counter),
    FLOPs and bytes equal; the peak within DRYRUN_PEAK_TOL of the pass's
    max_memory_allocated."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.ctx import from_mesh

    cfg = _parallel_cut(SERVE_ARCH)
    run = _parallel_run(cfg)
    t = time.perf_counter()
    with dryrun.fake_world(PARALLEL_RANKS):
        mesh = make_mesh((2, 4), ("data", "model"), device=DEV)
        pc = from_mesh(mesh)
        _, sspecs, bspecs = steps.make_train_step(run, pc)
        leaves = (dryrun.placed(steps.abstract_params(cfg), sspecs["params"], mesh),
                  dryrun.placed(steps.input_specs(cfg, run.shape), bspecs, mesh))
        pred = dryrun.trace(lambda p, b: steps.value_and_grad(p, b, run, pc), leaves, mesh,
                            DEV, want_mem=True)
    trace_s = time.perf_counter() - t
    real = par["grad_counts"]
    comm = {dryrun.COLLECTIVES[k]: v for k, v in par["collectives"].items()}
    mem = pred["memory_analysis"]
    want_peak = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
    peak = par["grad_peak"][0]
    res = {"coll_counts": pred["coll_counts"], "real_coll_counts": real["coll_counts"],
           "comm_debug_counts": comm, "flops": pred["flops"], "real_flops": real["flops"],
           "bytes": pred["bytes"], "real_bytes": real["bytes"], "peak": want_peak,
           "real_peak": peak, "real_peaks": par["grad_peak"],
           "peak_err": abs(want_peak - peak) / peak, "trace_s": trace_s, "memory": mem,
           "real_memory": par["grad_memory"]}
    print(f"dryrun parallel qwen3-1.7B x{PARALLEL_LAYERS[SERVE_ARCH]} gradient pass on (2, 4), "
          f"rank 0 of {PARALLEL_RANKS}: collectives {pred['coll_counts']} traced / "
          f"{real['coll_counts']} run (CommDebugMode {comm}); FLOPs {pred['flops']:.6e} / "
          f"{real['flops']:.6e}; bytes {pred['bytes']:.6e} / {real['bytes']:.6e}; peak "
          f"{want_peak / 1e9:.3f} GB predicted / {peak / 1e9:.3f} GB max_memory_allocated "
          f"(err {res['peak_err']:.3f}); trace {trace_s:.1f} s  [{card}]", flush=True)
    assert pred["coll_counts"] == real["coll_counts"] == comm, res
    assert pred["flops"] == real["flops"] > 0 and pred["bytes"] == real["bytes"], res
    assert res["peak_err"] <= DRYRUN_PEAK_TOL, res
    return res


def _dryrun_child(card: str, par: dict) -> dict:
    t0 = time.perf_counter()
    out = {"cells": _dryrun_cells(card), "prefills": {}}
    for arch, impl in DRYRUN_PREFILLS:
        out["prefills"][arch] = _dryrun_prefill(card, arch, impl)
    out["control_flops"] = _dryrun_control(card, out["prefills"][MOE_ARCH]["real_flops"])
    out["parallel"] = _dryrun_parallel(card, par)
    out["child_s"] = time.perf_counter() - t0
    return out


def dryrun_phase(card: str, par: dict) -> dict:
    """The dry run (``launch.dryrun``) on the card's path, in a process of
    its own (it starts fake process groups and fake tensors): (a) its CLI on
    the production mesh at ``DRYRUN_CELLS``; (b) its trace of the serve
    phases' three prefills at world 1 against the same prefills run on the
    card, with a planted control (K4's FLOP formula zeroed) that must fail;
    (c) its trace of the parallel phase's qwen3 gradient pass on a fake
    8-rank world against rank 0's readings of the real pass (``par``)."""
    t0 = time.perf_counter()
    # the child takes qwen2-moe's 57 GB of fp32 weights: hand back what this
    # process caches, and what the parallel phase's ranks mapped from it
    torch.cuda.ipc_collect()
    torch.cuda.empty_cache()
    print(f"dryrun: this process holds {torch.cuda.memory_reserved() / 1e9:.2f} GB of the "
          f"card  [{card}]", flush=True)
    with tempfile.TemporaryDirectory(prefix="chip-smoke-dryrun-") as d:
        keep = {k: par[k] for k in ("collectives", "grad_counts", "grad_memory", "grad_peak")}
        (Path(d) / "in.json").write_text(json.dumps(keep))
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--dryrun-child",
                               d], timeout=DRYRUN_DEADLINE_S)
        if proc.returncode != 0:
            raise RuntimeError(f"the dryrun phase's process failed ({proc.returncode})")
        out = json.loads((Path(d) / "out.json").read_text())
    out["phase_s"] = time.perf_counter() - t0
    print(f"dryrun: {out['phase_s']:.1f} s (its process {out['child_s']:.1f} s)  [{card}]",
          flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", help="also write every measurement to this file")
    ap.add_argument("--dryrun-child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need an NVIDIA GPU",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    if args.dryrun_child:  # the dryrun phase's own process
        d = Path(args.dryrun_child)
        out = _dryrun_child(card, json.loads((d / "in.json").read_text()))
        (d / "out.json").write_text(json.dumps(out, default=str))
        return 0
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    t0 = time.perf_counter()
    libs = kbuild.build(*(src for mod in KERNELS.values()
                          for src in getattr(mod, "SOURCES", (mod.SOURCE,))))
    print(f"build: {', '.join(lib.name for lib in libs)} in {time.perf_counter() - t0:.1f} s  "
          f"[{card}]")
    for log in kbuild.LOGS.values():
        print(log.strip())

    phase_s = {}

    def timed(name, fn):
        t = time.perf_counter()
        result = fn(card)
        phase_s[name] = time.perf_counter() - t
        return result

    kern = timed("kernel", kernel_phase)
    model = timed("model", model_phase)
    search = timed("search", search_phase)
    tier_root = Path(tempfile.mkdtemp(prefix="chip-smoke-serve-tier-"))
    try:
        runtime = timed("runtime", lambda c: runtime_phase(c, tier_root / "store.jsonl"))
        serve_tier = timed("serve_tier", lambda c: serve_tier_phase(c, tier_root))
    finally:
        shutil.rmtree(tier_root, ignore_errors=True)
    prof = timed("profile", profile_phase)
    cost = timed("costmodel", costmodel_phase)
    one = timed("oneshot", lambda c: oneshot_phase(c, cost["model"]))
    attn = timed("attention", attention_phase)
    ssd = timed("ssd", ssd_phase)
    gmm_res = timed("gmm", gmm_phase)
    serve = timed("serve", serve_phase)
    torch.cuda.empty_cache()
    serve_ssm = timed("serve_ssm", serve_ssm_phase)
    torch.cuda.empty_cache()
    serve_moe = timed("serve_moe", serve_moe_phase)
    torch.cuda.empty_cache()
    llm = timed("llm", llm_phase)
    torch.cuda.empty_cache()
    train = timed("train", train_phase)
    mesh = timed("mesh", mesh_phase)
    torch.cuda.empty_cache()
    par = timed("parallel", parallel_phase)
    dry = timed("dryrun", lambda c: dryrun_phase(c, par))
    print("phases (s): " + ", ".join(f"{k} {v:.1f}" for k, v in phase_s.items()))

    t = kern["search_totals"]
    dev = kern["device"]["sums"]["search"]
    kernels = {"kernels": [{
        "name": "ibn_pointwise",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ibn_pointwise.cu",
        "replaces": "src/repro/kernels/ibn_conv.py:49",
        "launches": search["launches"] + runtime["launches"] + serve_tier["launches"],
        "search_launches": search["launches"],
        "runtime_launches": {"parent": runtime["parent_launches"],
                             "workers": runtime["worker_launches"]},
        "serve_tier_launches": serve_tier["launches"],
        "max_abs_err": kern["max_abs_err"],
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "library_ms": t["library_ms"],
        "timing": "ms, plain_ms, library_ms: the 36 search shapes' forward as the host "
                  "issues them (CUDA events around 20 calls); device_*: the same on the "
                  "device alone (CUDA graphs of 20 calls); library torch.addmm",
        "device_ms": dev["fwd"]["ms"],
        "device_plain_ms": dev["fwd"]["plain_ms"],
        "device_library_ms": dev["fwd"]["library_ms"],
        "device_backward_ms": {p: dev[p]["ms"] for p in ("dx", "dw")},
        "device_backward_library_ms": {p: dev[p]["library_ms"] for p in ("dx", "dw")},
        "device_backward_bound_ms": {p: dev[p]["bound_ms"] for p in ("dx", "dw")},
        "launches_per_train_step": prof["launches_per_step"],
        "device_ms_per_train_step": prof["ibn_ms"],
        "launches_per_oneshot_step": one["launches_per_step"],
        "oneshot_launches": one["launches"],
        "device_ms_per_oneshot_step": one["ibn_ms"],
        "max_rel_err_fwd": kern["max_rel_err_fwd"],
        "max_rel_err_bwd": kern["max_rel_err_bwd"],
    }, {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:88",
        "launches": serve["path_launches"]["flash_attention"] + sum(par["k2_launches"])
                    + sum(par["moe_k2_launches"]["ep"] + par["moe_k2_launches"]["tpe"]),
        "serve_launches": serve["path_launches"]["flash_attention"],
        "parallel_launches": {"qwen3 train per rank": par["k2_launches"],
                              "moe EP per rank": par["moe_k2_launches"]["ep"],
                              "moe TPE per rank": par["moe_k2_launches"]["tpe"]},
        "max_abs_err": attn["main"]["max_abs_err"],
        "ms": attn["main"]["ms"],
        "plain_ms": attn["main"]["plain_ms"],
        "bound_ms": attn["main"]["bound_ms"],
        "bound_by": attn["main"]["bound_by"],
        "library_ms": attn["main"]["library_ms"],
        "launches_per_prefill": serve["prefill_launches"],
        **_train_keys(train["qwen3"], "flash_attention",
                      "qwen3-1.7B at full width, 28 layers, remat=full, 8 x 1024 tokens"),
    }, {
        "name": "ssd_scan",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:88",
        "launches": serve_ssm["path_launches"]["ssd_scan"],
        "max_abs_err": ssd["main"]["max_abs_err"],
        "ms": ssd["main"]["ms"],
        "plain_ms": ssd["main"]["plain_ms"],
        "bound_ms": ssd["main"]["bound_ms"],
        "bound_by": ssd["main"]["bound_by"],
        "library_ms": None,
        "library_note": "no single PyTorch call computes the SSD chunk scan",
        "launches_per_prefill": serve_ssm["prefill_launches"],
        "timing": "ms, plain_ms: mamba2-370m's prefill scan (B 8, S 1024, H 32, P 64, N 128, "
                  "chunk 256, bf16) as the host issues it (CUDA events around 20 calls); "
                  "device_*: the same on the device alone (CUDA graphs of 10 calls)",
        "device_ms": ssd["main"]["device_ms"],
        "device_plain_ms": ssd["main"]["device_plain_ms"],
        "host_us": ssd["main"]["host_us"],
        "plan": ssd["main"]["plan"],
        "zamba2": {k: ssd["zamba"][k] for k in ("shape", "ms", "device_ms", "plain_ms",
                                                 "device_plain_ms", "bound_ms")},
        "controls": {f"{shape} {name}": v for shape, name, v in ssd["controls"]},
        **_train_keys(train["mamba2"], "ssd_scan",
                      "mamba2-370m at full width, 48 layers, remat=none, 8 x 1024 tokens"),
    }, {
        "name": "flash_attention_bwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/kernels/flash_attention.py:88",
        "replaces_note": "the TPU kernel has no VJP; the reference differentiates its jnp "
                         "attention, the plain VJP the port ran before these kernels",
        "launches": train["qwen3"]["launches_per_step"]["flash_attention_bwd"] * TRAIN_TIMED,
        "max_abs_err": attn["backward_main"]["max_abs_err"],
        "ms": train["backward_call"]["flash_attention"]["ms"],
        "plain_ms": train["backward_call"]["flash_attention"]["plain_ms"],
        "bound_ms": train["backward_call"]["flash_attention"]["bound_ms"],
        "bound_by": train["backward_call"]["flash_attention"]["bound_by"],
        "library_ms": train["backward_call"]["flash_attention"]["library_ms"],
        "timing": "one backward at qwen3-1.7B's training shape (B 8, H 16, KV 8, S 1024, hd "
                  "128, bf16, causal) alone, CUDA events; plain: ref.vjp of the plain "
                  "forward; library: scaled_dot_product_attention's backward",
        "launches_note": f"over the train phase's {TRAIN_TIMED} timed qwen3 steps",
        "checks": len(attn["backward"]),
        **_train_keys(train["qwen3"], "flash_attention_bwd",
                      "qwen3-1.7B at full width, 28 layers, remat=full, 8 x 1024 tokens"),
    }, {
        "name": "ssd_scan_bwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan_bwd.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:88",
        "replaces_note": "the TPU kernel has no VJP; the reference differentiates its jnp "
                         "chunked scan, the plain VJP the port ran before these kernels",
        "launches": train["mamba2"]["launches_per_step"]["ssd_scan_bwd"] * TRAIN_TIMED,
        "max_abs_err": ssd["backward_main"]["max_abs_err"],
        "ms": train["backward_call"]["ssd_scan"]["ms"],
        "plain_ms": train["backward_call"]["ssd_scan"]["plain_ms"],
        "bound_ms": train["backward_call"]["ssd_scan"]["bound_ms"],
        "bound_by": train["backward_call"]["ssd_scan"]["bound_by"],
        "library_ms": None,
        "library_note": "no single PyTorch call computes the chunk scan's gradient",
        "timing": "one backward at mamba2-370m's training shape (B 8, S 1024, H 32, P 64, N "
                  "128, chunk 256, bf16) alone, CUDA events; plain: ref.vjp of the plain "
                  "forward",
        "launches_note": f"over the train phase's {TRAIN_TIMED} timed mamba2 steps",
        "launches_per_call": train["backward_call"]["ssd_scan"]["launches_per_call"],
        "workspace_bytes": train["backward_call"]["ssd_scan"]["workspace_bytes"],
        "device_ms_by_launch": train["backward_call"]["ssd_scan"]["launch_ms"],
        "checks": len(ssd["backward"]),
        "edge_checks": len(ssd["backward_edges"]),
        **_train_keys(train["mamba2"], "ssd_scan_bwd",
                      "mamba2-370m at full width, 48 layers, remat=none, 8 x 1024 tokens"),
    }, {
        "name": "gmm",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gmm.cu",
        "replaces": "src/repro/kernels/gmm.py:44",
        "launches": serve_moe["path_launches"]["gmm"] + sum(par["k4_launches"]["ep"]
                                                            + par["k4_launches"]["tpe"]),
        "serve_launches": serve_moe["path_launches"]["gmm"],
        "parallel_launches": {"EP per rank (15 experts)": par["k4_launches"]["ep"],
                              "TPE per rank (60 experts, F 176)": par["k4_launches"]["tpe"]},
        "max_abs_err": gmm_res["main"]["gate/up"]["max_abs_err"],
        "ms": gmm_res["main"]["gate/up"]["ms"],
        "plain_ms": gmm_res["main"]["gate/up"]["plain_ms"],
        "bound_ms": gmm_res["main"]["gate/up"]["bound_ms"],
        "bound_by": gmm_res["main"]["gate/up"]["bound_by"],
        "library_ms": gmm_res["main"]["gate/up"]["library_ms"],
        "shape": "gate/up prefill product (E, C, D, F) = "
                 f"{gmm_res['main']['gate/up']['shape']}, bf16",
        "launches_per_prefill": serve_moe["prefill_launches"]["gmm"],
        "products": {name: {k: r[k] for k in ("shape", "ms", "plain_ms", "library_ms",
                                                "bound_ms", "bound_by", "controls")}
                     for name, r in gmm_res["main"].items()},
        "backward_products": {name: {k: r[k] for k in (
            "shape", "dx_rel_err", "dw_rel_err", "tol", "controls", "operand_copies", "ms",
            "dx_ms", "dw_ms", "plain_ms", "library_ms", "dx_library_ms", "dw_library_ms",
            "bound_ms", "dx_bound_ms", "dw_bound_ms", "bound_by")}
                              for name, r in gmm_res["backward"].items() if "ms" in r},
        "backward_timing": "each training shape's dx + dw (autograd.grad through gmm.Gmm, two "
                           "launches on the transposed views, no operand copy) and each launch "
                           "alone, CUDA events; library: the same two torch.bmm calls",
        "backward_edge_checks": sum("ms" not in r for r in gmm_res["backward"].values()),
        **_train_keys(train["moe"], "gmm", f"qwen2-moe-a2.7b at full width cut to "
                      f"{TRAIN_MOE_LAYERS} layers, remat=none, 8 x 1024 tokens"),
    }]}
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(
            {"card": card, "kernel": kern, "model": model, "search": search,
             "runtime": runtime, "serve_tier": serve_tier,
             "profile": prof, "costmodel": {k: v for k, v in cost.items() if k != "model"},
             "oneshot": one, "attention": attn, "ssd": ssd, "gmm": gmm_res, "serve": serve,
             "serve_ssm": serve_ssm, "serve_moe": serve_moe, "llm": llm, "train": train,
             "mesh": mesh, "parallel": par, "dryrun": dry, "phase_s": phase_s,
             "kernels": kernels},
            indent=1, default=str))
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
