#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --sdpa-backends   # only SDPA's backward backends

Phases, each printing one JSON line:

1. device  — the card's name and power limit (``nvidia-smi``); without
             CUDA the script exits 2;
2. build   — the CUDA kernels from the sources in this checkout (``nvcc``,
             one process per source, all at once);
3. kernel  — the flash attention kernels against their plain PyTorch
             version on the card: the cases of ``tests/test_kernels.py``, a
             GQA shape, the head dims of llama-3b (100), vit-g (104,
             non-causal, ragged S 257) and gemma-2b (256, MQA) and a ragged
             Sq = Sk = 1000 at the serving widths, in fp32 (the FMA kernel;
             TF32 off, |err| <= 2e-5) and bf16 (the tensor-core kernel;
             |err| <= 1e-3 + 1e-2 |plain|, about one bf16 rounding step);
             the serving shape (contiguous and as the transposed views the
             model passes); the count of HMMA/HGMMA instructions in each
             kernel's SASS (``cuobjdump``); times of kernel, plain version
             and SDPA at the serving shape, beside the least time the card
             could take; the same, in bf16, at the MoE models' prefill
             shapes (qwen3: 32 query heads over 4 KV heads; mixtral: over
             8, window 4096; D 128), at gemma2-9b's local and global
             prefill shapes (2 x 8192, GQA 16/8, D 256, softcap 50, the
             local one's window 4096 masking; the library time there is
             ``flex_attention``'s, compiled, with the softcap as its
             score_mod and the window as its block mask, held against the
             plain version; SDPA without the cap, the window as a boolean
             mask, stands beside it, labelled), at zamba2-7b's shared
             block's (8 x 2048, MHA 32/32, D 112) and at the frontend
             models' (musicgen-large: 8 x 1500, MHA 32/32, D 64, 1500 no
             multiple of the tiles; pixtral-12b: 4 x 4096, GQA 32/8, D
             128);
4. serve   — ``launch.serve.serve`` on llama-7b at full width (bf16, random
             weights from a seed): batch 8, prompt 512, 32 generated tokens;
             the prefill must launch the bf16 kernel once per layer;
5. ssd_kernel — the SSD scan kernels against their plain version on the
             card, y and final state: the cases of ``tests/test_kernels.py``
             and a ragged L with slow decay, from zero and from a given
             initial state, in fp32 (the FMA kernel; |err| <= 1e-4
             max|plain|) and bf16 (the tensor-core kernel; y: |err| <= 1e-4
             max|plain| + 1e-2 |plain|), the serving shape and a ragged
             L 1025 in bf16 as the strided views the model passes, and views
             whose pointers or strides allow only 8, 4 or 2 B copies; the
             HMMA count of the bf16 kernel's SASS (it fails at 0) and both
             kernels' registers and spills; times of kernel and plain
             version at the serving shape and at zamba2-7b's (112 heads, N
             64) beside the least time the card could take;
6. serve_mamba2 — ``launch.serve.serve`` on mamba2-370m at full width
             (bf16, random weights from a seed): batch 8, prompt 2048, 32
             generated tokens; the prefill must launch the bf16 SSD kernel
             once per layer and the flash kernel never (and no serve a
             backward kernel);
6b. serve_qwen3_moe, serve_mixtral — ``launch.serve.serve`` on the MoE
             models at the serving phase's batch, prompt and tokens (bf16,
             random weights from a seed, the drop-free expert dispatch):
             qwen3-moe-30b-a3b at full width and depth (48 layers, 128
             experts, top-8), mixtral-8x7b at full width cut to 24 of its
             32 layers (the card does not hold 32); the prefill must launch
             the flash kernel once per layer, no serve a backward kernel;
             each phase starts with the earlier phases' memory freed;
6c. serve_gemma2, serve_zamba2, serve_yi34b — ``launch.serve.serve`` at
             full width and depth (bf16, random weights from a seed), but
             zamba2's depth: gemma2-9b at batch 2, prompt 8192 (its
             context, twice its local window: the local layers' windows
             mask and their 4096 ring slots wrap), 32 tokens, 42 flash
             launches a prefill; zamba2-7b on 42 of 81 layers at batch 8,
             prompt 2048, 32 tokens, 42 SSD-scan and 7 flash launches a
             prefill; yi-34b at batch 8, prompt 512, 32
             tokens, 60 flash launches;
6d. serve_musicgen, serve_pixtral — ``launch.serve.serve`` at full width
             and depth (bf16, random weights from a seed) with the prompt's
             precomputed frontend embeddings (fp32, from a seeded
             generator): musicgen-large at 8 x 1500 (30 s of EnCodec
             frames at 50 Hz), ``frontend_embed`` (8, 1500, 1536), 32
             tokens, 48 flash launches a prefill; pixtral-12b at 4 x 4096
             (one 1024 x 1024 image in 16-pixel patches), (4, 4096, 1024),
             32 tokens, 40 flash launches;
7. consistency — fp32, TF32 off, full width, for llama-7b, mamba2-370m,
             qwen3-moe-30b-a3b (4 layers: 48 in fp32 need 122 GB),
             gemma2-9b (4 layers, S 4200: the decode step reads a wrapped
             local ring), zamba2-7b (6 layers, one group, S 1024),
             musicgen-large (full depth, S 1500) and pixtral-12b (4
             layers, S 4096), the last two with frontend embeddings in
             both prefills, zero at position S (a decode step takes none):
             the last logits of a prefill of S+1 tokens against a prefill
             of S tokens and one decode step (the kernel path against the
             plain decode path), within 2e-3 of max|logits|; and each model
             reduced, on the card against the same parameters on the CPU
             (plain versions), within 1e-4;
8. flash_bwd — the flash attention backward kernels (through the
             autograd function of ``ops.flash_attention``) against the plain
             version's autograd on the card, dq, dk, dv for a seeded dO: the
             cases of ``tests/test_kernels.py``, head dims 64, 100 and 128, a
             ragged length, rows with no live key, and the model's
             transposed views, in fp32 (the FMA kernels; |err| <= 2e-5
             max|plain|) and bf16 (the tensor-core kernels; |err| <= 1e-3
             max|plain| + 1e-2 |plain|), and in bf16 also gemma-2b's D 256
             (MQA), vit-e's D 112 (non-causal, ragged S 257) and qwen3's
             training shape (GQA 32/4, D 128: dK, dV sum 8 query heads), a
             gemma2-9b local layer (GQA 16/8, D 256, softcap 50, S 4608,
             its window of 4096 masking) and zamba2-7b's shared block's
             training shape (MHA 32/32, D 112) as views;
             each case must launch its dtype's variant once per kernel; the
             HMMA count of both bf16 kernels' SASS (it fails at 0); times of
             the forward with its log-sum-exp, of each backward kernel, of
             the plain backward and of SDPA's at the gpt-1.3b training
             shape, beside the least time the card could take, and of the
             backward kernels and the library's backward at qwen3's,
             gemma2's and zamba2's shapes (SDPA; at gemma2's, with its
             softcap and window, ``flex_attention``, and SDPA without the
             cap beside it); ``--sdpa-backends`` runs instead only SDPA's
             backward at qwen3's shape under each of its backends (flash,
             efficient, cuDNN, math) and the kernels the default one ran;
9. ssd_bwd — the SSD scan's backward kernels (through the autograd
             function of ``ops.ssd_scan``: fp32 on scalar FMAs, bf16 on
             tensor cores) against the plain version's
             autograd on the card, dx, ddt, da, db, dc and dh0 for seeded
             cotangents on y and the final state: the forward's cases and
             its ragged slow-decay one, each from zero and from a given
             state, in fp32 (|err| <= 1e-4 max|plain|) and bf16 (|err| <=
             1e-3 max|plain| + 1e-2 |plain|), and mamba2-370m's heads as
             the model's views (L 2048, and a ragged L 1025 from a given
             state); each case must launch its dtype's backward once; two
             runs at the training shape must agree bit for bit; the HMMA
             count of the bf16 kernel's SASS (it fails at 0); both kernels'
             ptxas registers and spills, shared memory a block and blocks
             an SM; the bf16 kernel's time at the training shape of the
             largest rank call of the mamba2 plan below (B 10, L 2048,
             bf16 views) beside the least time the card could take and the
             plain backward's time (at B 2: it keeps a state per position),
             and the wrapper's whole call (its dB, dC partial sums);
10. train_grads — fp32, TF32 off: the loss and every param grad of
             reduced gpt-1.3b, bert-large, mixtral-8x7b (through the flash
             kernels; mixtral's capacity dispatch on tokens of 8 ids, so
             that it drops, the same assignments on both devices),
             mamba2-370m (P 32, N 16, through the SSD kernels), gemma2-9b
             (a local/global pair) and zamba2-7b (an SSM group checkpointed
             inside its element's checkpoint, and the shared block) on the
             card against the same on the CPU (plain versions), within
             1e-4 of each leaf's max|grad|;
11. train  — ``build_train_step(..., substrate="loopback",
             schedule="layered")`` on gpt-1.3b at full width and depth
             (seq 512, two ranks of one plan on the one card, fp32 state,
             bf16 compute), state from a seeded generator on the card,
             tokens from ``SyntheticStream``: 1 warm-up step and 3 timed
             ones; finite losses, every rank's shard of every unit changed
             by each step, and the flash launches the plan, the schedule
             and the per-layer checkpointing predict, every backward launch
             on the bf16 tensor-core kernels;
11b. train_moe — the same on qwen3-moe-30b-a3b at full width cut to 2
             layers (1.87 B parameters: the vocabulary of 151,936 is most
             of them), the capacity dispatch (each rank call its own);
11c. train_gemma2, train_zamba2 — the same on gemma2-9b at full width on 4
             layers (2 pairs) and zamba2-7b on 6 (one group and the shared
             block): the flash and SSD launches the nested checkpointing
             predicts (an SSM block's forward three times a rank call);
             for gemma2, then, 4 steps on one batch from the seeded state
             at Adam's lr and at a tenth of it (printed, not a gate);
11d. train_multiproc — gpt-1.3b at full width and depth on train's
             two-rank plan (seq 512, ``layered``) through the process fleet
             (``build_train_step(..., substrate="multiproc")``): two worker
             processes share the card, each holding its rank's shard and
             running the kernels, once with the hub topology and once with
             the ring, on the pipe data plane (MP_TRANSPORT); 1 warm-up step
             and 2 timed ones.  First the loopback engine takes the same
             steps from the same generator seed; the fleet's losses and its
             state after the last step (p, m, v) must equal the loopback's
             bit for bit (or within the difference of two loopback runs,
             should they differ), and each step's flash launches, counted
             inside the workers, must be what the plan and the
             checkpointing predict, all bf16; step ms, samples/s, the ring's
             comm seconds, the coordinator's data-plane bytes, each
             channel's plane, /dev/shm's size, each rank's state and pid,
             and the card's and the host's most used memory;
12. profile — the profiler (``core/profiler.py``) on the card: one
             gpt-1.3b layer at seq 512 in bf16, forward and backward, timed
             by CUDA events at m = 1, 2, 3, 4, 6, 8, 12; the piecewise fit
             on m <= 6 and its error at m = 8 and 12 (the paper's App. A.3
             check; printed, not a gate); then ``profiled_cluster_model``
             for the paper's Cluster A, solved by ``auto_solve`` at batch
             128: fails on an infeasible plan, a sample that is not finite
             and positive, or a flash launch off the bf16 tensor-core
             kernels; then zamba2-7b's element (6 SSM blocks and the shared
             block) profiled at m = 1, 2, 4 (printed, not a gate);
13. plan_train — the training launcher's own functions
             (``launch.train.solve_plan``, ``_train_loop``) on gpt-1.3b at
             full width and depth: the plan the port's planner solves for
             Cluster A at batch 128 (eight ranks of uneven m and ell on the
             one card), 1 warm-up step and 2 timed ones; finite losses,
             every rank's shard of every unit changed by each step, and the
             flash launches the plan predicts, all bf16; the plan's
             predicted iteration (for Cluster A's GPUs) beside the measured
             step; then reduced gpt-1.3b on the card: a checkpoint of the
             exported state saved after 2 steps, loaded, imported into a
             fresh engine, and its third step's loss equal to the loss of
             3 steps straight;
14. plan_train_mamba2 — the launcher's functions on mamba2-370m at full
             width and depth (48 layers, d 1024, 419,825,152 parameters):
             the plan for Cluster A at seq 2048, batch 32 (m 7, 7, 10, 2,
             2, 2, 1, 1: eight rank calls a step), 1 warm-up step and 2
             timed ones; finite losses, every rank's shard changed by each
             step, and per step 2 x 48 x 8 SSD forward launches (all
             ``bf16-mma``) and 48 x 8 backward launches (all ``bf16-mma``:
             the tensor-core backward), no flash launch;
15. plan_train_elastic — the launcher's elastic path (``solve_plan``,
             ``elastic_knobs``, ``build_engine``, ``_train_loop``, the
             argv of ``--elastic --straggler 2:3.0@2``) on gpt-1.3b at
             full width and depth, Cluster A's plan at batch 128, 6 steps:
             the cost-model oracle makes rank 2 three times slower from
             step 2; no event before it, and an adopted replan after the
             third step that gives rank 2 fewer samples; then rank 7
             leaves (``on_cluster_change`` onto the survivors' refit
             models) and one more step.  Each migration's state (p, m, v,
             step) equal bit for bit across it, its seconds and its card
             peak; every step's flash launches those of the plan in force,
             all bf16; finite losses; the step ms under each plan and the
             replan's seconds by stage;
16. train_elastic_multiproc — the elastic runtime on the process fleet
             with wall-clock telemetry: gpt-1.3b at full width on 4 of its
             24 layers (a replan holds two fleets), two worker processes
             on a ring (pipe plane, comm sanitizer armed), the plan
             ``solve_plan`` solves from wall-clock models for two H100s
             on NVLink (``--cluster h100``), batch 16, the
             ``WallClockOracle``; rank 0's worker three times slower from
             step 2, until two steps after the first adopted replan (at
             most 10).  An adopted replan must shed batch off rank
             0, the refit model rank 0 at least 2x slower than rank 1,
             each migration bitwise, each step's launches inside the
             workers the plan in force's, all bf16; a loopback engine that
             takes the same blocks and migrates at the same steps must end
             with the fleet's losses and state bit for bit; step ms
             before and after, respawn and migrate seconds, the events,
             the card's and the host's most used memory;
17. train_spmd — the SPMD runtime through the launcher's ``--runtime
             spmd`` (``launch.train.run_spmd``) on gpt-1.3b at full width
             and depth (seq 512, bf16 compute, fp32 state): the world sized
             from the card count, one rank on the one card over NCCL,
             ``--batch 16 --ell 4`` (4 microbatches of 4), layered, 1
             warm-up step and 3 timed ones; each step's flash launches,
             counted in the rank process, and its collectives what the
             schedule predicts, all ``bf16-mma``; then the loopback engine
             on the same plan, blocks and seed, each loss within 2e-3
             relative (a few bf16 rounding steps: the SPMD rank sums the
             microbatches one by one); step ms, samples/s, the rank's peak
             device memory, its collectives;
17b. train_spmd_shared — two uneven ranks of the SPMD runtime (the
             parity matrix's m, ell, ratio: 2, 2, 0.6 and 1, 1, 0.4) on
             the one card, gloo over pinned host copies, gpt-1.3b at full
             width on 4 of 24 layers, fp32 with TF32 off, seq 512: layered
             and per_microbatch, 1 step each from a seeded generator,
             against the loopback engine on the card: each loss within
             1e-4, p within 2e-4 where Adam was well conditioned (the
             reference's shard_map gate), Adam's m within 1e-4 relative
             (it carries the gradients' scale); each step's collectives as the
             schedule predicts, the launches all ``fp32-fma``; then the
             state migrates to the loopback engine and to a second world
             with the ratios swapped, bit for bit; step ms, the host copy
             bytes a step, the card's and the host's most used memory;
18. verify_protocol — the offline protocol checker's entry point
             (``repro_torch.core.engine.verify``): the 132-cell grid on both
             data planes, the determinism lint on the port's data plane,
             the 5 seeded mutants; it must exit 0.

Then the script's wall time, the card's name and power limit, a line
``{"kernels": [...]}`` with each kernel's launches on its main-path run
(serving for the forwards, phase ``train`` for the flash backward, the
timed steps of ``plan_train_mamba2`` for the SSD backward; a planned
step's launches and the MoE, pair, hybrid, frontend, fleet, elastic and
SPMD phases' beside them), its error and its times, and last
``{"ok": true, "device": {...}}``.  Any failed check raises, so the script
exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

from repro_torch.checkpoint import checkpointing  # noqa: E402
from repro_torch.configs.base import InputShape, get_arch  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import fsdp  # noqa: E402
from repro_torch.core import device_specs  # noqa: E402
from repro_torch.core import profiler  # noqa: E402
from repro_torch.core.cost_model import fit_piecewise  # noqa: E402
from repro_torch.core.engine import build_train_step  # noqa: E402
from repro_torch.core.engine import elastic  # noqa: E402
from repro_torch.core.engine import verify  # noqa: E402
from repro_torch.core.engine import world as spmd_world  # noqa: E402
from repro_torch.core.engine.verify import cli as verify_cli  # noqa: E402
from repro_torch.core.engine.schedules import get_schedule  # noqa: E402
from repro_torch.core.engine.units import (  # noqa: E402
    UnitPlanner, normalized_ratios)
from repro_torch.core.layered_ga import CephaloProgram  # noqa: E402
from repro_torch.core.partition import Plan, RankPlan  # noqa: E402
from repro_torch.core.planner import auto_solve  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticStream  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import \
    attention_reference  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import (  # noqa: E402
    ssd_scan_backward_reference, ssd_scan_reference)
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import serving  # noqa: E402
from repro_torch.launch import train as train_launch  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.layers import moe  # noqa: E402
from repro_torch.optim.adam import AdamConfig  # noqa: E402
from repro_torch.roofline import analysis as roofline  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet, dense): bytes/s of HBM3 and
# FLOP/s of the tensor cores (bf16) and of the fp32 pipe
HBM_BYTES_S = 3.35e12
PEAK_FLOP_S = {torch.bfloat16: 989e12, torch.float32: 67e12}

# b, h, kvh, sq, sk, d, causal, window, softcap (tests/test_kernels.py:21-31)
FLASH_CASES = [
    (2, 4, 4, 128, 128, 64, True, 0, 0.0),
    (2, 4, 2, 128, 128, 64, True, 0, 0.0),
    (1, 8, 1, 96, 96, 64, True, 0, 0.0),
    (2, 4, 4, 128, 128, 64, True, 48, 0.0),
    (2, 4, 4, 128, 128, 64, True, 0, 30.0),
    (2, 4, 4, 64, 64, 64, False, 0, 0.0),
    (1, 2, 2, 64, 192, 32, True, 0, 0.0),
    (2, 4, 4, 128, 128, 128, True, 32, 50.0),
]
SERVE_SHAPE = (8, 32, 32, 512, 512, 128, True, 0, 0.0)     # llama-7b prefill
GQA_SHAPE = (2, 32, 4, 512, 512, 64, True, 0, 0.0)         # tiny-llama heads
# the other head dims of the configs, and a ragged length at the serving
# widths
HEAD_DIM_CASES = {
    "llama-3b-d100": (2, 32, 32, 512, 512, 100, True, 0, 0.0),
    "vit-g-d104": (2, 16, 16, 257, 257, 104, False, 0, 0.0),
    "gemma-2b-d256": (2, 8, 1, 512, 512, 256, True, 0, 0.0),
    "ragged-1000": (2, 32, 32, 1000, 1000, 128, True, 0, 0.0),
}
# the flash kernel at the MoE models' GQA shapes: their prefills (32 query
# heads over 4 and over 8 KV heads, D 128; mixtral's window 4096), and
# qwen3's training shape (rank 0's 4 rows of TRAIN_RANKS), where the dK dV
# kernel sums 8 query heads into each KV head
MOE_PREFILL_SHAPES = {
    "qwen3-prefill": (8, 32, 4, 512, 512, 128, True, 0, 0.0),
    "mixtral-prefill": (8, 32, 8, 512, 512, 128, True, 4096, 0.0)}
MOE_TRAIN_SHAPE = (4, 32, 4, 512, 512, 128, True, 0, 0.0)
# the flash kernel at a rank's heads of phase serve_seqshard's
# tensor-parallel prefills on mesh (1, 2): stablelm-1.6b 2 x 8192 at
# 16/16 heads, D 64; qwen3-moe 8 x 512 at 16/2, D 128
TP_PREFILL_SHAPES = {
    "stablelm-rank": (2, 16, 16, 8192, 8192, 64, True, 0, 0.0),
    "qwen3-rank": (8, 16, 2, 512, 512, 128, True, 0, 0.0)}
# the backward at a gemma2-9b local layer with its window masking (S 4608;
# GQA 16/8, D 256, softcap 50), and at zamba2-7b's shared block at the
# two-rank plan's rank 0 (4 rows; MHA 32/32, D 112)
GEMMA2_BWD_SHAPE = (1, 16, 8, 4608, 4608, 256, True, 4096, 50.0)
ZAMBA2_TRAIN_SHAPE = (4, 32, 32, 512, 512, 112, True, 0, 0.0)
# |kernel - plain| <= atol + rtol * |plain|, elementwise.  Both compute in
# fp32 and round once to the output dtype, so in bf16 they differ by at most
# one rounding step (<= 2**-7 of the value) plus fp32 noise near zero.
TOL = {torch.float32: (2e-5, 0.0), torch.bfloat16: (1e-3, 1e-2)}
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 8, 512, 32

# b, h, l, p, n (tests/test_kernels.py:60-66; their chunk is not an argument
# here: the kernel tiles at 64 positions)
SSD_CASES = [
    (2, 4, 128, 32, 16),
    (1, 2, 96, 64, 32),      # ragged L
    (2, 4, 256, 32, 64),
    (1, 8, 64, 64, 128),     # mamba2-370m-like head geometry
]
SSD_RAGGED = (2, 4, 1000, 64, 128)   # slow decay: the state crosses chunks
SSD_Q = 64                           # the kernel's tile length
# copy widths (elements) of the bf16 kernel below 16 B: views of a
# (B, L, H P + 2 N + off) tensor shifted by off elements
SSD_VEC_VIEWS = {4: (2, 4, 200, 64, 128), 2: (2, 4, 200, 32, 64),
                 1: (1, 4, 130, 64, 32)}
KERNEL_OPS = {"flash_attention": flash_ops, "ssd_scan": ssd_ops}
PTXAS: dict = {}    # kernel instance -> registers and spills (phase build)
FLEX: list = []     # flex_attention compiled, the library yardstick (_flex)
MAMBA = "mamba2-370m"
MAMBA_BATCH, MAMBA_PROMPT, MAMBA_GEN = 8, 2048, 32

# the backward's cases: the forward's, views of the model's layout, rows
# that see no key (causal, window 16, Sq > Sk + 15), and the gpt-1.3b
# training shape (rank 0's 8 rows of the layered plan below)
TRAIN_SHAPE = (8, 32, 32, 512, 512, 64, True, 0, 0.0)
BWD_CASES = dict(
    [(f"case{i}", (c, False)) for i, c in enumerate(FLASH_CASES)] + [
        ("views-case7", (FLASH_CASES[7], True)),
        ("gqa-d64", (GQA_SHAPE, False)),
        ("d100-views", (HEAD_DIM_CASES["llama-3b-d100"], True)),
        ("d128-ragged-1000", (HEAD_DIM_CASES["ragged-1000"], False)),
        ("masked-rows", ((1, 2, 2, 96, 32, 64, True, 16, 0.0), False)),
        ("gpt-1.3b-views", (TRAIN_SHAPE, True))])
# bf16 only: the largest head dim, vit-e's (paper_models.py: 16 heads
# of 112, non-causal), at vit-g-d104's ragged length, and qwen3's training
# shape
BWD_BF16_CASES = {
    "gemma-2b-d256-views": (HEAD_DIM_CASES["gemma-2b-d256"], True),
    "vit-e-d112-views": ((2, 16, 16, 257, 257, 112, False, 0, 0.0), True),
    "qwen3-train-views": (MOE_TRAIN_SHAPE, True),
    "gemma2-local-views": (GEMMA2_BWD_SHAPE, True),
    "zamba2-d112-views": (ZAMBA2_TRAIN_SHAPE, True),
}
# gpt-1.3b training: two ranks on the one card, global batch 10, seq 512
TRAIN_ARCH, TRAIN_SEQ = "gpt-1.3b", 512
TRAIN_RANKS = [("rank0", 4, 2, 0.6), ("rank1", 2, 1, 0.4)]   # m, ell, r
TRAIN_STEPS = 3
# the profiler's App. A.3 check: fit on these microbatch sizes, hold out
# the rest (benchmarks/model_accuracy.py's split)
PROFILE_FIT_MS, PROFILE_HELD_MS = (1, 2, 3, 4, 6), (8, 12)
# planned training: the launcher's plan for the paper's Cluster A at
# Table 4's global batch, 1 warm-up step and 2 timed ones
PLAN_ARGS = ["--arch", TRAIN_ARCH, "--seq", str(TRAIN_SEQ), "--batch", "128",
             "--runtime", "mpmd", "--cluster", "cluster-a"]
PLAN_STEPS = 2
# the checkpoint resume: reduced gpt-1.3b on the same cluster's plan
RESUME_ARGS = ["--arch", TRAIN_ARCH, "--reduced", "--seq", "64", "--batch",
               "16", "--cluster", "cluster-a"]
# the SSD backward's cases beyond the forward's: mamba2-370m's heads as the
# model's views at B 2 (L 2048, and a ragged L from a given state); its
# training shape, the largest rank call of the Cluster A plan below (rank
# 2: m 10), where the plain backward, which keeps a state per position, is
# timed at B 2
SSD_BWD_VIEWS = {"views-2048": ((2, 32, 2048, 64, 128), False),
                 "views-ragged-1025-h0": ((2, 32, 1025, 64, 128), True)}
SSD_TRAIN_SHAPE = (10, 32, 2048, 64, 128)
SSD_PLAIN_BATCH = 2
SSD_GRADS = ("dx", "ddt", "da", "db", "dc", "dh0")
# mamba2-370m training: the launcher's plan for Cluster A at seq 2048 (the
# Mamba2 paper's training context), batch 32: m 7, 7, 10, 2, 2, 2, 1, 1
MAMBA_PLAN_ARGS = ["--arch", MAMBA, "--seq", "2048", "--batch", "32",
                   "--runtime", "mpmd", "--cluster", "cluster-a"]
# the MoE models: served at the serving phase's batch 8, prompt 512, 32
# tokens; qwen3 at full width and depth (56.9 GiB of bf16 weights),
# mixtral at full width cut to 24 of its 32 layers (87.0 GiB in full,
# more than the card holds; 65.4 GiB at 24); the qwen3 consistency check
# in fp32 at 4 layers (48 would need 122 GB); qwen3 trained at full width
# on 2 layers on the fixed two-rank plan (TRAIN_RANKS), seq 512
QWEN3, MIXTRAL = "qwen3-moe-30b-a3b", "mixtral-8x7b"
MIXTRAL_SERVE_LAYERS = 24
QWEN3_CONSISTENCY_LAYERS = 4
MOE_TRAIN_LAYERS = 2
# gemma2-9b (local/global pairs), zamba2-7b (Mamba2 groups and a shared
# attention block) and yi-34b, served at full width and depth: gemma2 at
# its context of 8192, twice its local window, batch 2; zamba2 at
# mamba2's 8 x 2048; yi at 8 x 512 (64.06 GiB of bf16 weights).  The
# consistency checks in fp32 at 4 layers (gemma2, S 4200: past the
# window, so the decode step reads a wrapped ring) and 6 (zamba2, one
# group); training at full width on 4 layers (gemma2: 2 pairs) and 6
# (zamba2: one group and the shared block) on the two-rank plan
GEMMA2, ZAMBA2, YI = "gemma2-9b", "zamba2-7b", "yi-34b"
GEMMA2_BATCH, GEMMA2_PROMPT = 2, 8192
# serve_zamba2 at full width on 42 of its 81 layers (7 applications of
# the shared block): the costliest of the earlier serve phases, cut in
# depth to win back time for serve_seqshard
ZAMBA2_SERVE_LAYERS = 42
PAIR_CONSISTENCY = {GEMMA2: (4, 4200), ZAMBA2: (6, 1024)}
PAIR_TRAIN_LAYERS = {GEMMA2: 4, ZAMBA2: 6}
# train_gemma2's losses on one batch repeated, at Adam's default lr and a
# tenth of it (printed, not a gate)
TREND_LRS = {GEMMA2: (AdamConfig().lr, AdamConfig().lr / 10)}
TREND_STEPS = 4
# the flash kernel at their prefill shapes: gemma2's local and global
# layers (GQA 16/8, D 256, softcap 50), zamba2's shared block (MHA, D 112)
PAIR_PREFILL_SHAPES = {
    "gemma2-local-prefill": (2, 16, 8, 8192, 8192, 256, True, 4096, 50.0),
    "gemma2-global-prefill": (2, 16, 8, 8192, 8192, 256, True, 0, 50.0),
    "zamba2-prefill": (8, 32, 32, 2048, 2048, 112, True, 0, 0.0)}
ZAMBA2_SSD_SHAPE = (8, 112, 2048, 64, 64)     # b, h, l, p, n at its prefill
# mamba2-370m's tensor-parallel prefill: a rank's 16 of 32 heads
MAMBA2_RANK_SSD_SHAPE = (8, 16, 2048, 64, 128)
# the zamba2 element's profile (printed, not a gate)
ZAMBA2_PROFILE_MS = (1, 2, 4)
# the frontend models, served at full width and depth with precomputed
# frontend embeddings from a seeded generator: musicgen-large at 8 x 1500
# (30 s of EnCodec frames at 50 Hz; 1500 is no multiple of the flash
# kernel's tiles), pixtral-12b at 4 x 4096 (one 1024 x 1024 image in
# 16-pixel patches); the consistency checks in fp32, musicgen at full
# depth, pixtral on 4 layers, the frontend embedding of the decoded
# position zero (a decode step takes none)
MUSICGEN, PIXTRAL = "musicgen-large", "pixtral-12b"
FRONTEND_SERVE = {MUSICGEN: (8, 1500), PIXTRAL: (4, 4096)}
FRONTEND_CONSISTENCY = {MUSICGEN: (0, 1500), PIXTRAL: (4, 4096)}
FRONTEND_PREFILL_SHAPES = {
    "musicgen-prefill": (8, 32, 32, 1500, 1500, 64, True, 0, 0.0),
    "pixtral-prefill": (4, 32, 8, 4096, 4096, 128, True, 0, 0.0)}
# the process fleet: gpt-1.3b at full width and depth on the fixed
# two-rank plan, one worker process a rank on the one card, hub and ring;
# 1 warm-up step and MP_STEPS timed ones, against the loopback engine's
MP_STEPS = 2
MP_TOPOLOGIES = ("hub", "ring")
# the fleet's data plane: the pipe.  Shared-memory arenas live in the
# host's memory (the chip machine's 96 GiB counts /dev/shm): at full
# width the hub's four arenas hold a full fp32 flat each (22.6 GB) beside
# the payloads' copies, and the first run on the card with them ran the
# machine out of memory
MP_TRANSPORT = "pipe"
# the machine's memory in use, where its cgroup says (v2, then v1)
CGROUP_MEM = ("/sys/fs/cgroup/memory.current",
              "/sys/fs/cgroup/memory/memory.usage_in_bytes")
# the elastic runtime on the launcher's path at full width and depth:
# plan_train's plan (Cluster A, batch 128), rank 2 (the A6000, the
# largest batch) three times slower from step 2, 6 steps; then rank 7
# leaves (the survivors keep their refit models) and one more step
ELASTIC_ARGS = PLAN_ARGS + ["--elastic", "--straggler", "2:3.0@2",
                            "--steps", "6"]
ELASTIC_LEAVER = 7
# ... and on the process fleet: gpt-1.3b at full width on 4 layers (a
# replan holds two fleets at once: two at full depth do not fit the
# card), two worker processes on a ring, the pipe plane, the comm
# sanitizer armed, the plan from wall-clock models as the launcher
# solves it for two H100s on NVLink (the card the workers run on: on
# Cluster A's modelled 50 Gbps link a layer's AllGather and ReduceScatter
# take longer than either rank's compute, so the plan is one of many that
# tie and a straggler changes the predicted step only now and then),
# rank 0 three times slower (its worker sleeps) from step 2; it runs
# until two steps after the first adopted replan, at most --steps
ELASTIC_MP_LAYERS = 4
ELASTIC_MP_AFTER = 2
ELASTIC_MP_ARGS = ["--arch", TRAIN_ARCH, "--seq", str(TRAIN_SEQ),
                   "--batch", "16", "--cluster", "h100",
                   "--substrate", "multiproc", "--nprocs", "2",
                   "--topology", "ring", "--elastic", "--straggler",
                   "0:3.0@2", "--steps", "10"]
# phase train_spmd: the launcher's --runtime spmd at full width and depth
# (one rank on the one card), 1 warm-up step and SPMD_STEPS timed ones,
# held against the loopback engine within SPMD_REL_TOL of each loss:
# a few bf16 rounding steps (the SPMD rank sums 4 microbatches one by
# one, the loopback engine takes the 16 rows at once)
SPMD_STEPS = 3
SPMD_ARGS = ["--arch", TRAIN_ARCH, "--seq", str(TRAIN_SEQ), "--batch", "16",
             "--ell", "4", "--runtime", "spmd", "--ga-mode", "layered",
             "--steps", str(SPMD_STEPS + 1)]
SPMD_REL_TOL = 2e-3
# phase train_spmd_shared: two uneven ranks (the parity matrix's m, ell,
# ratio) on the one card at full width on SHARED_LAYERS layers, fp32
SHARED_LAYERS = 4
SHARED_RANKS = [("rank0", 2, 2, 0.6), ("rank1", 1, 1, 0.4)]
SHARED_STEPS = 1     # the phase's time is its host plane's: ~10 s a step
SHARED_SCHEDULES = ("layered", "per_microbatch")
SHARED_LOSS_TOL, SHARED_P_TOL = 1e-4, 2e-4   # tests/test_parity_matrix.py
# Adam's first moment after the step, (1 - b1) g, against the loopback's,
# relative in the 2-norm of each leaf: fp32 grads summed in another order
SHARED_M_TOL = 1e-4
# phase serve_seqshard: tensor-parallel serving (launch.serving, the
# reference's build_prefill / build_decode) of each of SEQSHARD_MODELS
# (arch, layers or 0 for all, batch, prompt, generated tokens: the first
# from the prefill) in one world of the two ranks of mesh (1, 2), which
# share the card (gloo over pinned host copies): each rank holds its
# shard of every weight and of every cache leaf (the KV cache's sequence,
# the SSM state's heads), at the dry-run's bytes exactly.  The prefill is
# held block by block against rank 0's unsharded blocks, each fed the
# split prefill's input to it (bf16 rounding would compound over
# mamba2's 48 layers to ~10% of a state's max on the H100, and flip
# qwen3's expert choices): the embedding's output, every block's output,
# the last-position logits and every cache leaf gathered from the ranks'
# shards (layer by layer) within SEQSHARD_BF16_TOL of max|value|; each
# decode step's logits against the unsharded decode
# within SEQSHARD_TOL (fp32); the timed bf16 decode's logits against the
# unsharded fp32 ones within SEQSHARD_BF16_TOL, on each row whose fed
# tokens and whose experts at every MoE layer agree at every step so far
# (qwen3-moe's routing flips under bf16 rounding).  The phase
# measures how far the first step's logits move with every rank's
# partial sums skipped (the other shards dropped), and fails unless that
# exceeds SEQSHARD_BF16_TOL
SEQSHARD_MODELS = [("stablelm-1.6b", 0, 2, 8192, 16),
                   ("mamba2-370m", 0, 8, 2048, 16),
                   ("qwen3-moe-30b-a3b", 4, 8, 512, 16)]
SEQSHARD_MESH = spmd_world.Mesh((1, 2), ("data", "model"))
SEQSHARD_TOL = 2e-3
SEQSHARD_BF16_TOL = 6e-2


CARD: list = []     # the card's name and power limit (phase device)
PHASE_T0: list = []  # the host clock at the start of each running phase


def _phase(fn):
    """A phase function: the lines it emits carry its seconds so far."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        PHASE_T0.append(time.perf_counter())
        try:
            return fn(*args, **kwargs)
        finally:
            PHASE_T0.pop()
    return run


def emit(obj) -> None:
    """One JSON line; a phase's line carries the card's name and power
    limit as ``nvidia-smi`` reads them, and the seconds since its phase
    began (where the line sets none of its own)."""
    if "phase" in obj and CARD:
        obj = {**obj, "card": CARD[0]}
    if "phase" in obj and PHASE_T0 and "seconds" not in obj:
        obj = {**obj, "seconds": time.perf_counter() - PHASE_T0[-1]}
    print(json.dumps(obj), flush=True)


def _roofline(cfg, kind: str, seq: int, batch: int,
              measured_s: float, chips: int = 1) -> dict:
    """The H100's roofline terms (``repro_torch.roofline``) of a ``kind``
    step of ``batch`` sequences of ``seq`` tokens (the cache's length for
    a decode token) on ``chips`` cards, tensor-parallel over all of them
    (one card: no collectives on the wire), beside the measured seconds;
    printed, not a gate."""
    t = roofline.terms_for(cfg, InputShape(kind, seq, batch, kind), chips,
                           model_par=chips)
    return {"compute_s": t.compute_s, "memory_s": t.memory_s,
            "collective_s": t.collective_s, "coll_bytes": t.coll_bytes,
            "dominant": t.dominant,
            "bound_s": t.bound_s, "measured_s": measured_s,
            "measured_over_bound": measured_s / t.bound_s}


@_phase
def phase_device() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    dev = {"name": torch.cuda.get_device_name(0),
           "count": torch.cuda.device_count(), "nvidia_smi": smi,
           "torch": torch.__version__, "cuda": torch.version.cuda}
    CARD[:] = [smi]
    emit({"phase": "device", **dev})
    return dev


@_phase
def phase_build() -> None:
    t0 = time.perf_counter()
    logs = build.build_all()
    secs = time.perf_counter() - t0
    for name in build.sources():
        build.load(name)
    PTXAS.update(_ptxas_usage(logs))
    emit({"phase": "build", "seconds": secs, "built": sorted(logs),
          "ptxas": PTXAS})


def _ptxas_usage(logs: dict) -> dict:
    """Kernel instance → its registers and spills, from ``-Xptxas -v``."""
    usage: dict = {}
    func = None
    for log in logs.values():
        for line in log.splitlines():
            hit = re.search(r"Compiling entry function '(\S+)'", line)
            if hit:
                m = re.search(r"(flash_fwd_kernel_\w+?|"
                              r"flash_bwd_\w+?_kernel(?:_mma)?|"
                              r"ssd_scan_bwd_kernel(?:_mma)?|"
                              r"ssd_scan_kernel\w*?)I(\w+?)EEv", hit[1])
                func = f"{m[1]}<{m[2]}>" if m else hit[1]
                usage[func] = ""
            elif func is not None and ("registers" in line or
                                       "spill" in line):
                usage[func] = (usage[func] + " " + line.split(":")[-1]
                               .strip()).strip()
    return usage


def _qkv(case, dtype, seed=0):
    b, h, kvh, sq, sk, d = case[:6]
    g = torch.Generator(device="cuda").manual_seed(seed)

    def mk(*shape):
        return torch.randn(*shape, generator=g, device="cuda").to(dtype)
    return mk(b, h, sq, d), mk(b, kvh, sk, d), mk(b, kvh, sk, d)


def _compare(case, dtype, views=False) -> float:
    q, k, v = _qkv(case, dtype)
    kw = dict(causal=case[6], window=case[7], softcap=case[8])
    if views:   # (B, S, H, D) storage seen as (B, H, S, D), as the model does
        q, k, v = (t.transpose(1, 2).contiguous().transpose(1, 2)
                   for t in (q, k, v))
    got = flash_ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    ref = attention_reference(q, k, v, **kw)
    diff = (got.float() - ref.float()).abs()
    atol, rtol = TOL[dtype]
    over = (diff / (atol + rtol * ref.float().abs())).max().item()
    err = diff.max().item()
    if not (np.isfinite(err) and over <= 1.0):
        raise AssertionError(f"flash attention {case} {dtype} views={views}:"
                             f" max err {err}, {over} x the tolerance "
                             f"{atol} + {rtol} |plain|")
    return err


def _sdpa(q, k, v, causal, mask=None):
    """PyTorch's own attention on the same (B, H, S, D) inputs, GQA by
    its ``enable_gqa``, with ``mask`` (boolean, True = keep) in place of
    ``causal`` where given; the yardstick only, never called by the port."""
    return F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, is_causal=causal and mask is None,
        enable_gqa=q.shape[1] != k.shape[1])


def _sdpa_mask(case):
    """The boolean (Sq, Sk) mask of ``case``'s causal mask and window, for
    SDPA, where the window masks a key (SDPA has no window); else None."""
    sq, sk, causal, window = case[3], case[4], case[6], case[7]
    if not 0 < window < sk:
        return None
    qp = torch.arange(sq, device="cuda")[:, None]
    kp = torch.arange(sk, device="cuda")[None, :]
    keep = qp - kp < window
    return keep & (kp <= qp) if causal else keep


def _flex(case):
    """PyTorch's ``flex_attention`` for ``case`` as ``fn(q, k, v)``,
    compiled (Inductor's Triton templates; once a shape): the tanh softcap
    as its ``score_mod``, the causal mask and the window as its block mask
    (fully masked tiles skipped), GQA by ``enable_gqa``.  The one PyTorch
    call that computes softcapped attention; a yardstick only, never called
    by the port."""
    import torch._functorch.config as functorch_config
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)
    # the backward is timed over one graph (retain_graph), which a donated
    # buffer forbids
    functorch_config.donated_buffer = False
    if not FLEX:
        FLEX.append(torch.compile(flex_attention, dynamic=False))
    _, h, kvh, sq, sk, _, causal, window, cap = case

    def keep(b, hd, qi, ki):
        ok = ki <= qi if causal else ki >= 0
        return ok & (qi - ki < window) if window > 0 else ok

    def capped(score, b, hd, qi, ki):
        return cap * torch.tanh(score / cap)
    mask = (create_block_mask(keep, None, None, sq, sk, device="cuda")
            if causal or window > 0 else None)
    return lambda q, k, v: FLEX[0](q, k, v, score_mod=capped if cap else None,
                                   block_mask=mask, enable_gqa=h != kvh)


def _library(case, q, k, v, fn_ms) -> dict:
    """The library columns for ``case`` on (q, k, v): where SDPA computes
    the function (no softcap; no window that masks a key), its time;
    else ``flex_attention``'s (:func:`_flex`), its output held against the
    plain version within 2% of max|plain| (it rounds the probabilities to
    bf16 as the kernel does; a wrong mask or cap is off by tens of per
    cent), and SDPA's beside it, labelled: without the softcap, the window
    as a boolean mask.  ``fn_ms(call)`` returns the library time of
    ``call(q, k, v)``: the forward's or the backward's."""
    mask = _sdpa_mask(case)
    sdpa_ms = fn_ms(lambda q, k, v: _sdpa(q, k, v, case[6], mask))
    if not case[8] and mask is None:
        return {"library_ms": sdpa_ms, "library_call": "SDPA"}
    flex = _flex(case)
    with torch.no_grad():
        got = flex(q, k, v).float()
        ref = attention_reference(q, k, v, causal=case[6], window=case[7],
                                  softcap=case[8]).float()
    err = (got - ref).abs().max().item()
    if not err <= 0.02 * ref.abs().max().item():
        raise AssertionError(f"flex_attention {case}: max err {err} against "
                             f"the plain version (max {ref.abs().max()})")
    del got, ref
    return {"library_ms": fn_ms(flex), "library_call":
            "flex_attention, compiled: softcap score_mod, causal and window "
            "block mask", "library_max_abs_err": err, "sdpa_ms": sdpa_ms,
            "sdpa_note": ", ".join(
                ["without the softcap"] * bool(case[8]) +
                ["window as a boolean mask"] * (mask is not None))}


def _time_ms(fn, iters: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _least_ms(nbytes, flops, dtype):
    """(least ms, what bounds it, bytes, FLOPs): the larger of ``nbytes``
    at the HBM rate and ``flops`` at the peak for ``dtype``."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOP_S[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), nbytes, flops


def _bound(case, dtype):
    """Least time (ms) for the function at ``case``: each input read once
    and the output written once at the HBM rate, against the two matmuls'
    FLOPs over the (q, k) pairs the masks keep at the peak for ``dtype``."""
    b, h, kvh, sq, sk, d, causal, window, _ = case
    esize = torch.tensor([], dtype=dtype).element_size()
    nbytes = esize * d * (2 * b * h * sq + 2 * b * kvh * sk)
    qp = np.arange(sq)[:, None]
    kp = np.arange(sk)[None, :]
    keep = np.ones((sq, sk), bool)
    if causal:
        keep &= kp <= qp
    if window > 0:
        keep &= qp - kp < window
    flops = 4.0 * b * h * d * int(keep.sum())
    return _least_ms(nbytes, flops, dtype)


def _sass_counts(name: str) -> dict:
    """Tensor-core instructions (HMMA, HGMMA) in the SASS of each kernel
    function of library ``name``, summed by function name prefix; None
    where the toolkit has no ``cuobjdump``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    lib = build._lib_path(build.sources()[name])
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts: dict = {}
    func = None
    for line in sass.splitlines():
        hit = re.search(r"Function : (\S+)", line)
        if hit:
            m = re.search(r"(flash_fwd_kernel_\w+?|"
                          r"flash_bwd_\w+?_kernel(?:_mma)?|"
                          r"ssd_scan_bwd_kernel(?:_mma)?|"
                          r"ssd_scan_kernel\w*?)I", hit[1])
            func = m[1] if m else hit[1][:40]
            counts.setdefault(func, {"HMMA": 0, "HGMMA": 0})
        elif func is not None:
            for op in ("HGMMA", "HMMA"):
                if re.search(rf"\b{op}\.", line):
                    counts[func][op] += 1
                    break
    return counts


@_phase
def phase_kernel() -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sass = _sass_counts("flash_attention")
    if sass is not None:
        tc = sass.get("flash_fwd_kernel_mma", {})
        if tc.get("HMMA", 0) + tc.get("HGMMA", 0) == 0:
            raise AssertionError(f"bf16 flash kernel: no tensor-core "
                                 f"instructions in its SASS: {sass}")
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype)[6:]
        for i, case in enumerate(FLASH_CASES):
            errs[f"case{i}-{tag}"] = _compare(case, dtype)
        errs[f"gqa-{tag}"] = _compare(GQA_SHAPE, dtype)
        errs[f"views-{tag}"] = _compare(FLASH_CASES[7], dtype, views=True)
        for name, case in HEAD_DIM_CASES.items():
            errs[f"{name}-{tag}"] = _compare(case, dtype)
        errs[f"views-d100-{tag}"] = _compare(HEAD_DIM_CASES["llama-3b-d100"],
                                             dtype, views=True)
    dtype = torch.bfloat16
    serve_err = max(_compare(SERVE_SHAPE, dtype),
                    _compare(SERVE_SHAPE, dtype, views=True))
    errs["serve-bfloat16"] = serve_err

    q, k, v = _qkv(SERVE_SHAPE, dtype)
    kw = dict(causal=True, window=0, softcap=0.0)
    kernel_ms = _time_ms(lambda: flash_ops.flash_attention(q, k, v, **kw),
                         20)
    plain_ms = _time_ms(lambda: attention_reference(q, k, v, **kw), 10)
    library_ms = _time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True), 20)
    kernel_ms_2 = _time_ms(lambda: flash_ops.flash_attention(q, k, v, **kw),
                           20)
    bound_ms, bound_by, nbytes, flops = _bound(SERVE_SHAPE, dtype)
    gqa = {name: _gqa_timing(name, case, errs)
           for name, case in MOE_PREFILL_SHAPES.items()}
    pair = {name: _gqa_timing(name, case, errs)
            for name, case in PAIR_PREFILL_SHAPES.items()}
    frontend = {name: _gqa_timing(name, case, errs)
                for name, case in FRONTEND_PREFILL_SHAPES.items()}
    tp = {name: _gqa_timing(name, case, errs)
          for name, case in TP_PREFILL_SHAPES.items()}
    res = {"phase": "kernel", "max_abs_err": errs, "sass": sass,
           "shape": SERVE_SHAPE, "dtype": "bfloat16",
           "variant": flash_ops.VARIANTS[dtype], "kernel_ms": kernel_ms,
           "kernel_ms_repeat": kernel_ms_2, "plain_ms": plain_ms,
           "library_ms": library_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "bytes": nbytes, "flops": flops,
           "kernel_tflops": flops / kernel_ms / 1e9, "moe_shapes": gqa,
           "pair_hybrid_shapes": pair, "frontend_shapes": frontend,
           "tp_rank_shapes": tp}
    emit(res)
    return {"variant": flash_ops.VARIANTS[dtype], "max_abs_err": serve_err,
            "ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "moe_shapes": gqa,
            "pair_hybrid_shapes": pair, "frontend_shapes": frontend,
            "tp_rank_shapes": tp}


def _gqa_timing(name, case, errs) -> dict:
    """The bf16 kernel at a model's prefill shape: held against its plain
    version (contiguous and as the model's views, at ``TOL``), then
    kernel, plain version and SDPA timed beside the bound.  A window
    that masks goes to SDPA as a boolean mask; a softcap has no library
    call (:func:`_library`).  The plain version, which holds the whole
    (B, H, Sq, Sk) fp32 score tensor, is timed over fewer calls past
    16 M scores a head."""
    dtype = torch.bfloat16
    err = max(_compare(case, dtype), _compare(case, dtype, views=True))
    errs[f"{name}-bfloat16"] = err
    q, k, v = _qkv(case, dtype)
    kw = dict(causal=case[6], window=case[7], softcap=case[8])
    big = case[3] * case[4] > 2**24
    kernel_ms = _time_ms(lambda: flash_ops.flash_attention(q, k, v, **kw),
                         20)
    plain_ms = _time_ms(lambda: attention_reference(q, k, v, **kw),
                        3 if big else 10, warmup=1 if big else 3)
    library = _library(case, q, k, v,
                       lambda call: _time_ms(lambda: call(q, k, v), 20))
    bound_ms, bound_by, nbytes, flops = _bound(case, dtype)
    return {"shape": case, "max_abs_err": err, "ms": kernel_ms,
            "ms_repeat": _time_ms(lambda: flash_ops.flash_attention(
                q, k, v, **kw), 20),
            "plain_ms": plain_ms, **library,
            "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
            "flops": flops, "kernel_tflops": flops / kernel_ms / 1e9}


def _ssd_inputs(shape, dtype, seed=0, slow=False):
    """x (B, H, L, P), dt (B, H, L) fp32, a (H,), b, c (B, L, N) on the card,
    drawn as ``tests/test_kernels.py`` draws them; ``slow`` makes the decay
    slow (small dt, |a| <= 1), so the state carries across many chunks."""
    b, h, l, p, n = shape
    g = torch.Generator(device="cuda").manual_seed(seed)

    def mk(*s):
        return torch.randn(*s, generator=g, device="cuda")
    x = mk(b, h, l, p).to(dtype)
    if slow:
        dt = F.softplus(mk(b, h, l) - 4.0)
        a = -torch.exp(torch.linspace(-3.0, 0.0, h, device="cuda"))
    else:
        dt = F.softplus(mk(b, h, l))
        a = -torch.exp(torch.linspace(0.0, 1.5, h, device="cuda"))
    return x, dt, a, mk(b, l, n).to(dtype), mk(b, l, n).to(dtype)


def _ssd_model_views(shape, seed=0, off=0):
    """The serving shape as ``ssd_apply`` passes it: x, b, c column slices
    of one (B, L, d_inner + 2N) bf16 conv output, dt a transposed
    (B, L, H) fp32 tensor, mamba2's own a and dt bias.  ``off`` > 0
    widens the conv output by ``off`` columns and starts the slices
    there, so pointers and strides are multiples of ``off`` elements."""
    b, h, l, p, n = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    di = h * p
    xbc = torch.randn(b, l, di + 2 * n + off, generator=g,
                      device="cuda").to(torch.bfloat16)[..., off:]
    dt_bias = torch.empty(h, device="cuda").uniform_(-4.0, -1.0,
                                                     generator=g)
    dt = F.softplus(torch.randn(b, l, h, generator=g, device="cuda")
                    + dt_bias)
    a = -torch.linspace(1.0, 16.0, h, device="cuda")
    x = xbc[..., :di].unflatten(-1, (h, p)).transpose(1, 2)
    return (x, dt.transpose(1, 2), a, xbc[..., di: di + n],
            xbc[..., di + n:])


def _ssd_compare(name, inputs) -> tuple:
    """Kernel against plain on ``inputs``: y elementwise (fp32: 1e-4 of
    max|plain|; bf16: that plus 1e-2 |plain|, one rounding step of bf16,
    since both round one fp32 result), the final state at 1e-4 of its
    max.  Returns y's largest absolute error and the largest error of y
    or the state relative to its max|plain|."""
    y, hT = ssd_ops.ssd_scan(*inputs)
    torch.cuda.synchronize()
    y_ref, h_ref = ssd_scan_reference(*inputs)
    rtol = 1e-2 if inputs[0].dtype == torch.bfloat16 else 0.0
    errs = []
    for what, got, ref, rt in (("y", y, y_ref, rtol), ("h", hT, h_ref, 0.0)):
        got, ref = got.float(), ref.float()
        scale = ref.abs().max().item()
        diff = (got - ref).abs()
        over = (diff / (1e-4 * scale + rt * ref.abs())).max().item()
        if not (np.isfinite(over) and over <= 1.0 and scale > 0):
            raise AssertionError(f"ssd scan {name} {what}: max err "
                                 f"{diff.max().item()}, {over} x the "
                                 f"tolerance (max|plain| {scale})")
        errs.append((diff.max().item(), diff.max().item() / scale))
    return errs[0][0], max(rel for _, rel in errs)


def _ssd_bound(shape, dtype):
    """Least time (ms) for the scan at ``shape``: x, dt, b, c read once and
    y and the final state written once at the HBM rate, against the FLOPs
    of the chunked form at the kernel's tile over causal pairs (C B^T and
    its product with x dt within each chunk, C h^T and the state update) at
    the peak for ``dtype``."""
    b, h, l, p, n = shape
    esize = torch.tensor([], dtype=dtype).element_size()
    nbytes = (esize * (2 * b * h * l * p + 2 * b * l * n)
              + 4 * (b * h * l + h + b * h * p * n))
    flops = 0
    for l0 in range(0, l, SSD_Q):
        q = min(SSD_Q, l - l0)
        pairs = q * (q + 1) // 2
        flops += 2 * pairs * (n + p) + 4 * q * p * n
    flops *= b * h
    return _least_ms(nbytes, flops, dtype)


@_phase
def phase_ssd_kernel() -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sass = _sass_counts("ssd_scan")
    if sass is not None and \
            sass.get("ssd_scan_kernel_mma", {}).get("HMMA", 0) == 0:
        raise AssertionError(f"bf16 SSD kernel: no HMMA instructions in its "
                             f"SASS: {sass}")
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype)[6:]
        for i, case in enumerate(SSD_CASES):
            errs[f"case{i}-{tag}"] = _ssd_compare(
                f"{case} {tag}", _ssd_inputs(case, dtype))[1]
        errs[f"ragged-{tag}"] = _ssd_compare(
            f"{SSD_RAGGED} {tag}",
            _ssd_inputs(SSD_RAGGED, dtype, slow=True))[1]
        b, h, _, p, n = SSD_RAGGED
        h0 = torch.randn(b, h, p, n, device="cuda",
                         generator=torch.Generator("cuda").manual_seed(3))
        errs[f"ragged-h0-{tag}"] = _ssd_compare(
            f"{SSD_RAGGED} h0 {tag}",
            _ssd_inputs(SSD_RAGGED, dtype, seed=2, slow=True) + (h0,))[1]
    cfg = get_arch(MAMBA)
    shape = (MAMBA_BATCH, cfg.ssm_heads, MAMBA_PROMPT, cfg.ssm_head_dim,
             cfg.ssm_state)
    inputs = _ssd_model_views(shape)
    serve_err, errs["serve-views-bfloat16"] = _ssd_compare(
        f"{shape} views", inputs)
    ragged = (shape[0], shape[1], 1025) + shape[3:]
    errs["serve-ragged-views-bfloat16"] = _ssd_compare(
        f"{ragged} views", _ssd_model_views(ragged, seed=1))[1]
    for vec, case in SSD_VEC_VIEWS.items():
        x, dt, a, b, c = _ssd_model_views(case, seed=4, off=vec)
        got = ssd_ops._copy_width(x, b, c)
        if got != vec:
            raise AssertionError(f"views shifted by {vec}: copy width {got}")
        errs[f"views-vec{vec}-bfloat16"] = _ssd_compare(
            f"{case} views, {vec}-element copies", (x, dt, a, b, c))[1]

    kernel_ms = _time_ms(lambda: ssd_ops.ssd_scan(*inputs), 20)
    plain_ms = _time_ms(lambda: ssd_scan_reference(*inputs), 3, warmup=1)
    kernel_ms_2 = _time_ms(lambda: ssd_ops.ssd_scan(*inputs), 20)
    bound_ms, bound_by, nbytes, flops = _ssd_bound(shape, torch.bfloat16)
    variant = ssd_ops.VARIANTS[torch.bfloat16]
    del inputs
    zamba2 = _ssd_timing(ZAMBA2_SSD_SHAPE, errs)
    mamba2_rank = _ssd_timing(MAMBA2_RANK_SSD_SHAPE, errs)
    emit({"phase": "ssd_kernel", "max_rel_err": errs,
          "serve_max_abs_err": serve_err, "shape": shape,
          "dtype": "bfloat16", "variant": variant, "sass": sass,
          "ptxas": {k: v for k, v in PTXAS.items()
                    if k.startswith("ssd_scan")},
          "kernel_ms": kernel_ms,
          "kernel_ms_repeat": kernel_ms_2, "plain_ms": plain_ms,
          "library_ms": None,
          "library_note": "no single PyTorch call computes the SSD scan",
          "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
          "flops": flops, "kernel_tflops": flops / kernel_ms / 1e9,
          "zamba2_shape": zamba2, "mamba2_rank_shape": mamba2_rank})
    return {"variant": variant, "max_abs_err": serve_err, "ms": kernel_ms,
            "plain_ms": plain_ms, "library_ms": None, "bound_ms": bound_ms,
            "bound_by": bound_by, "zamba2_shape": zamba2,
            "mamba2_rank_shape": mamba2_rank}


def _ssd_timing(shape, errs) -> dict:
    """The bf16 SSD kernel at a model's prefill shape, as the model's
    views: held against its plain version, then kernel and plain version
    timed beside the bound."""
    inputs = _ssd_model_views(shape, seed=8)
    err, errs[f"{shape}-views-bfloat16"] = _ssd_compare(f"{shape} views",
                                                        inputs)
    kernel_ms = _time_ms(lambda: ssd_ops.ssd_scan(*inputs), 20)
    plain_ms = _time_ms(lambda: ssd_scan_reference(*inputs), 2, warmup=1)
    bound_ms, bound_by, nbytes, flops = _ssd_bound(shape, torch.bfloat16)
    return {"shape": shape, "max_abs_err": err, "ms": kernel_ms,
            "ms_repeat": _time_ms(lambda: ssd_ops.ssd_scan(*inputs), 20),
            "plain_ms": plain_ms, "library_ms": None, "bound_ms": bound_ms,
            "bound_by": bound_by, "bytes": nbytes, "flops": flops,
            "kernel_tflops": flops / kernel_ms / 1e9}


def _frontend(cfg, batch: int, seq: int, device, seed: int):
    """Precomputed frontend embeddings (batch, seq, frontend_dim), fp32
    from a seeded generator, for a model with a frontend stub; else
    None."""
    if not cfg.frontend_dim:
        return None
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn((batch, seq, cfg.frontend_dim), generator=gen,
                       device=device)


@_phase
def phase_serve(arch: str, batch: int, prompt: int, gen: int,
                phase: str, expect: dict, layers: int = 0) -> dict:
    """Serve ``arch`` at full width (its first ``layers`` layers when
    given); ``expect`` maps each kernel's name to the launches the served
    run must show.  A model with a frontend stub gets the prompt's
    frontend embeddings (:func:`_frontend`)."""
    cfg = get_arch(arch)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    held = torch.cuda.memory_allocated()     # cuBLAS workspaces and such
    if held > 2**30:
        raise AssertionError(f"{phase}: {held} B still held by earlier "
                             f"phases")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen_ = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    model = M.DecoderLM.init(cfg, gen_, "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (batch, prompt))
    fe = _frontend(cfg, batch, prompt, "cuda", 0)
    serve(cfg, model, prompts, 2, "cuda", fe)   # warm-up at the same shapes
    torch.cuda.reset_peak_memory_stats()
    for ops in KERNEL_OPS.values():
        ops.LAUNCHES = 0
        ops.VARIANT_LAUNCHES.update(dict.fromkeys(ops.VARIANT_LAUNCHES, 0))
    bwd_before = (ssd_ops.BWD_LAUNCHES, dict(flash_ops.BWD_LAUNCHES))
    res = serve(cfg, model, prompts, gen, "cuda", fe)
    if (ssd_ops.BWD_LAUNCHES, dict(flash_ops.BWD_LAUNCHES)) != bwd_before:
        raise AssertionError(f"{arch}: a serve launched a backward kernel")
    launches = {name: ops.LAUNCHES for name, ops in KERNEL_OPS.items()}
    variants = {name: {k: n for k, n in ops.VARIANT_LAUNCHES.items() if n}
                for name, ops in KERNEL_OPS.items()}
    peak = torch.cuda.max_memory_allocated()
    toks = res["tokens"]
    if launches != expect:
        raise AssertionError(f"{arch}: kernel launches {launches}, "
                             f"expected {expect}")
    for name, ops in KERNEL_OPS.items():
        want = {ops.VARIANTS[torch.bfloat16]: expect[name]} \
            if expect[name] else {}
        if variants[name] != want:
            raise AssertionError(f"{arch}: {name} launches by variant "
                                 f"{variants[name]}, expected {want}")
    if tuple(toks.shape) != (batch, gen) or \
            int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab_size:
        raise AssertionError(f"bad tokens {tuple(toks.shape)}")
    if not bool(torch.isfinite(res["last_logits"]).all()):
        raise AssertionError("non-finite logits")
    emit({"phase": phase, "arch": cfg.name, "layers": cfg.n_layers,
          "of_layers": get_arch(arch).n_layers,
          "d_model": cfg.d_model, "dtype": cfg.dtype, "batch": batch,
          "prompt": prompt, "gen": gen,
          "frontend_embed": None if fe is None else list(fe.shape),
          "init_s": init_s,
          "init_peak_gib": init_peak / 2**30, "held_before_gib": held / 2**30,
          "params": M.param_count(model.params),
          "prefill_ms": res["prefill_s"] * 1e3,
          "decode_s": res["decode_s"],
          "decode_tok_s": res["decode_tok_s"], "peak_mem_gib": peak / 2**30,
          "roofline_prefill": _roofline(cfg, "prefill", prompt, batch,
                                        res["prefill_s"]),
          "roofline_decode_token": _roofline(
              cfg, "decode", prompt + gen, batch,
              res["decode_s"] / max(gen - 1, 1)),
          "kernel_launches": launches, "variants": variants,
          "tokens_seq0": toks[0].tolist()})
    del model, res, fe
    torch.cuda.empty_cache()
    return launches


@_phase
def phase_consistency(arch: str, batch: int, seq: int,
                      layers: int = 0) -> dict:
    """fp32 at full width (the first ``layers`` layers when given):
    prefill(S+1) against prefill(S) + one decode step; then ``arch``
    reduced, on the card against the CPU.  A model with a frontend stub
    gets frontend embeddings in both prefills, zero at position S: the
    decode step takes none."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_arch(arch), dtype="float32")
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    gen = torch.Generator(device="cuda").manual_seed(1)
    model = M.DecoderLM.init(cfg, gen, "cuda")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (batch, seq + 1))).cuda()
    fe = _frontend(cfg, batch, seq + 1, "cuda", 1)
    if fe is not None:
        fe[:, seq] = 0.0
    with torch.inference_mode():
        full, _ = model.prefill(toks, seq + 1, fe)
        _, caches = model.prefill(toks[:, :seq], seq + 1,
                                  None if fe is None else fe[:, :seq])
        step, _ = model.decode_step(caches, toks[:, seq:],
                                    torch.full((batch,), seq, device="cuda"))
    torch.cuda.synchronize()
    err = (full[:, -1] - step[:, -1]).abs().max().item()
    scale = full[:, -1].abs().max().item()
    del model, caches, fe
    torch.cuda.empty_cache()
    if not (np.isfinite(err) and err <= 2e-3 * scale):
        raise AssertionError(f"{arch} prefill/decode: err {err} > 2e-3 * "
                             f"{scale}")

    # small input: the kernel path on the card against the plain path on
    # the CPU, same parameters
    small = get_arch(arch).reduced()
    gen = torch.Generator().manual_seed(2)
    cpu_params = M.init_params(small, gen, "cpu")
    tree = M.tree_map(cpu_params, lambda _, t: t.numpy())
    gpu_params = params_from_numpy(tree, "cuda")
    stoks = torch.from_numpy(np.random.default_rng(2).integers(
        0, small.vocab_size, (2, 96)))
    sfe = _frontend(small, 2, 96, "cpu", 2)
    with torch.inference_mode():
        ref, _ = M.prefill(small, cpu_params, stoks, 97, sfe)
        got, _ = M.prefill(small, gpu_params, stoks.cuda(), 97,
                           None if sfe is None else sfe.cuda())
    small_err = (got.cpu() - ref).abs().max().item()
    small_scale = ref.abs().max().item()
    if not (np.isfinite(small_err) and small_err <= 1e-4 * small_scale):
        raise AssertionError(f"reduced {arch} cuda vs cpu: err "
                             f"{small_err} > 1e-4 * {small_scale}")
    res = {"phase": "consistency", "arch": arch, "dtype": "float32",
           "layers": cfg.n_layers, "batch": batch, "seq": seq,
           "frontend": bool(cfg.frontend_dim),
           "max_abs_err": err, "max_abs_logit": scale, "rel": err / scale,
           "small_cuda_vs_cpu_rel": small_err / small_scale}
    emit(res)
    return res


def _dead_rows(sq, sk, causal, window) -> np.ndarray:
    """Query rows that no key is live for."""
    qp = np.arange(sq)[:, None]
    kp = np.arange(sk)[None, :]
    keep = np.ones((sq, sk), bool)
    if causal:
        keep &= kp <= qp
    if window > 0:
        keep &= qp - kp < window
    return ~keep.any(axis=1)


def _grads_close(name, got, want, dtype) -> dict:
    """dq, dk, dv against the plain version's: fp32 within 2e-5 of
    max|plain|, bf16 elementwise within 1e-3 max|plain| + 1e-2 |plain|
    (fp32 sums in another order, then one bf16 rounding each).  Returns
    each grad's largest absolute error and, under ``rel``, the largest
    error over max|plain|."""
    atol, rtol = (2e-5, 0.0) if dtype == torch.float32 else (1e-3, 1e-2)
    errs = {"rel": 0.0}
    for what, g, w in zip("qkv", got, want):
        g, w = g.float(), w.float()
        scale = w.abs().max()
        diff = (g - w).abs()
        over = (diff / (atol * scale + rtol * w.abs())).max().item()
        if not (np.isfinite(over) and over <= 1.0 and scale.item() > 0):
            raise AssertionError(f"flash backward {name} d{what}: max err "
                                 f"{diff.max().item()}, {over} x the "
                                 f"tolerance (max|plain| {scale.item()})")
        errs[what] = diff.max().item()
        errs["rel"] = max(errs["rel"], errs[what] / scale.item())
    return errs


def _flash_bwd_compare(name, case, views, dtype) -> dict:
    b, h, kvh, sq, sk, d, causal, window, softcap = case
    q, k, v = _qkv(case, dtype)
    if views:   # (B, S, H, D) storage seen as (B, H, S, D), as the model does
        q, k, v = (t.transpose(1, 2).contiguous().transpose(1, 2)
                   for t in (q, k, v))
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    g = torch.Generator(device="cuda").manual_seed(1)
    dout = torch.randn(b, h, sq, d, generator=g, device="cuda").to(dtype)
    dead = torch.from_numpy(_dead_rows(sq, sk, causal, window)).cuda()
    # the plain version spreads a row with no live key over every key; the
    # kernel gives it no gradient: compare with dO = 0 on such rows
    dout_live = dout.masked_fill(dead[:, None], 0)
    kw = dict(causal=causal, window=window, softcap=softcap)
    before = dict(flash_ops.BWD_LAUNCHES)
    before_var = dict(flash_ops.BWD_VARIANT_LAUNCHES)
    got = torch.autograd.grad(flash_ops.flash_attention(q, k, v, **kw),
                              (q, k, v), dout_live)
    torch.cuda.synchronize()
    variant = flash_ops.VARIANTS[dtype]
    want_var = {n: c + 2 * (n == variant) for n, c in before_var.items()}
    if flash_ops.BWD_LAUNCHES != {n: c + 1 for n, c in before.items()} or \
            flash_ops.BWD_VARIANT_LAUNCHES != want_var:
        raise AssertionError(f"flash backward {name}: launches "
                             f"{flash_ops.BWD_LAUNCHES} "
                             f"{flash_ops.BWD_VARIANT_LAUNCHES} after "
                             f"{before} {before_var}")
    want = torch.autograd.grad(attention_reference(q, k, v, **kw),
                               (q, k, v), dout_live)
    err = _grads_close(f"{name} {dtype}", got, want, dtype)
    if dead.any():
        full = torch.autograd.grad(flash_ops.flash_attention(q, k, v, **kw),
                                   (q, k, v), dout)
        if not all(bool(torch.isfinite(t).all()) for t in full) or \
                bool(full[0][:, :, dead].any()):
            raise AssertionError(f"flash backward {name}: rows with no key "
                                 f"must give finite grads and dq = 0")
    return err


def _bwd_bound(case, dtype, which: str):
    """Least time (ms) of the backward's work at ``case``: ``which`` is
    ``dq`` (S, dP and dQ: q, k, v, dO and L read, dq and D written),
    ``dkdv`` (S, dP, dK and dV: q, k, v, dO, L and D read, dk and dv
    written) or ``both`` (the function: S once, dP, dQ, dK, dV; q, k, v,
    dO and L read, dq, dk, dv written); bytes at the HBM rate against the
    products' FLOPs over the live (q, k) pairs at the peak for ``dtype``."""
    b, h, kvh, sq, sk, d, causal, window, _ = case
    esize = torch.tensor([], dtype=dtype).element_size()
    qo, kv, rows = b * h * sq * d, b * kvh * sk * d, b * h * sq
    nbytes = {"dq": esize * (3 * qo + 2 * kv) + 4 * 2 * rows,
              "dkdv": esize * (2 * qo + 4 * kv) + 4 * 2 * rows,
              "both": esize * (3 * qo + 4 * kv) + 4 * rows}[which]
    qp = np.arange(sq)[:, None]
    kp = np.arange(sk)[None, :]
    keep = np.ones((sq, sk), bool)
    if causal:
        keep &= kp <= qp
    if window > 0:
        keep &= qp - kp < window
    pairs = b * h * int(keep.sum())
    flops = {"dq": 6, "dkdv": 8, "both": 10}[which] * d * pairs
    return _least_ms(nbytes, flops, dtype)


def _device_ms_by_name(fn, iters: int, counts=None) -> dict:
    """Device ms per call of every kernel ``fn`` launches, by name, from
    ``torch.profiler`` over ``iters`` calls (after one more); ``counts``,
    where given, receives each name's number of recorded launches."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out: dict = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            out[evt.name] = out.get(evt.name, 0.0) + \
                evt.time_range.elapsed_us() / 1e3 / iters
            if counts is not None:
                counts[evt.name] = counts.get(evt.name, 0) + 1
    return out


def _kernel_ms_by_name(fn, iters: int, marks, tries: int = 3) -> dict:
    """Device ms a launch of the kernels whose name holds each of
    ``marks`` (each launched once a call of ``fn``): the mean over the
    launches ``torch.profiler`` recorded in ``iters`` calls.  A trace does
    not always hold every launch (on the card one held none of the dq
    kernel's, another 19 of 20): a trace without a launch of some mark is
    taken again, at most ``tries`` times in all."""
    for _ in range(tries):
        counts: dict = {}
        by_name = _device_ms_by_name(fn, iters, counts)
        seen = {mark: sum(n for name, n in counts.items() if mark in name)
                for mark in marks}
        if all(seen.values()):
            return {mark: sum(ms for name, ms in by_name.items()
                              if mark in name) * iters / seen[mark]
                    for mark in marks}
        print(f"chip_smoke: incomplete profiler trace, launches {seen} "
              f"over {iters} calls", file=sys.stderr, flush=True)
    raise AssertionError(f"the profiler saw {seen} launches of {marks} "
                         f"over {iters} calls")


@_phase
def phase_flash_bwd() -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sass = _sass_counts("flash_attention_bwd")
    if sass is not None:
        for kern in ("flash_bwd_dq_kernel_mma", "flash_bwd_dkdv_kernel_mma"):
            if sass.get(kern, {}).get("HMMA", 0) == 0:
                raise AssertionError(f"{kern}: no HMMA instructions in its "
                                     f"SASS: {sass}")
    errs, main = {}, None
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype)[6:]
        cases = dict(BWD_CASES, **(BWD_BF16_CASES
                                   if dtype == torch.bfloat16 else {}))
        for name, (case, views) in cases.items():
            err = _flash_bwd_compare(name, case, views, dtype)
            errs[f"{name}-{tag}"] = err["rel"]
            if case == TRAIN_SHAPE and dtype == torch.bfloat16:
                main = err
    dtype = torch.bfloat16
    q, k, v = (t.transpose(1, 2).contiguous().transpose(1, 2)
               for t in _qkv(TRAIN_SHAPE, dtype))
    g = torch.Generator(device="cuda").manual_seed(1)
    dout = torch.randn(q.shape, generator=g, device="cuda").to(dtype)
    _, lse = flash_ops._forward(q, k, v, True, 0, 0.0, with_lse=True)
    fwd_ms = _time_ms(lambda: flash_ops._forward(q, k, v, True, 0, 0.0,
                                                 with_lse=True), 20)
    bwd_ms = _time_ms(lambda: flash_ops._backward(q, k, v, lse, dout, True,
                                                  0, 0.0), 20)
    by_kernel = _kernel_ms_by_name(
        lambda: flash_ops._backward(q, k, v, lse, dout, True, 0, 0.0), 20,
        ("flash_bwd_dq_kernel", "flash_bwd_dkdv_kernel"))
    qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))
    ref_out = attention_reference(qr, kr, vr)
    plain_bwd_ms = _time_ms(lambda: torch.autograd.grad(
        ref_out, (qr, kr, vr), dout, retain_graph=True), 5, warmup=1)
    sdpa_out = F.scaled_dot_product_attention(qr, kr, vr, is_causal=True)
    sdpa_bwd_ms = _time_ms(lambda: torch.autograd.grad(
        sdpa_out, (qr, kr, vr), dout, retain_graph=True), 20)
    sdpa_bwd_device_ms = sum(_device_ms_by_name(
        lambda: torch.autograd.grad(sdpa_out, (qr, kr, vr), dout,
                                    retain_graph=True), 10).values())
    sdpa_fwd_bwd_ms = _time_ms(lambda: torch.autograd.grad(
        F.scaled_dot_product_attention(qr, kr, vr, is_causal=True),
        (qr, kr, vr), dout), 20)
    bwd_ms_2 = _time_ms(lambda: flash_ops._backward(q, k, v, lse, dout,
                                                    True, 0, 0.0), 20)
    fwd_bound, fwd_by, fwd_bytes, fwd_flops = _bound(TRAIN_SHAPE, dtype)
    fwd_bytes += 4 * q.shape[0] * q.shape[1] * q.shape[2]   # the LSE
    fwd_bound = max(fwd_bound, fwd_bytes / HBM_BYTES_S * 1e3)
    bounds = {w: _bwd_bound(TRAIN_SHAPE, dtype, w)
              for w in ("dq", "dkdv", "both")}
    qwen3 = _bwd_timing(MOE_TRAIN_SHAPE, errs["qwen3-train-views-bfloat16"])
    pair = {"gemma2-local": _bwd_timing(
                GEMMA2_BWD_SHAPE, errs["gemma2-local-views-bfloat16"]),
            "zamba2-train": _bwd_timing(
                ZAMBA2_TRAIN_SHAPE, errs["zamba2-d112-views-bfloat16"])}
    emit({"phase": "flash_bwd", "max_rel_err": errs,
          "train_shape_max_abs_err": main, "shape": TRAIN_SHAPE,
          "dtype": "bfloat16", "variant": flash_ops.VARIANTS[dtype],
          "sass": sass, "fwd_with_lse_ms": fwd_ms,
          "fwd_with_lse_bound_ms": fwd_bound, "bwd_ms": bwd_ms,
          "bwd_ms_repeat": bwd_ms_2, "bwd_kernel_ms": by_kernel,
          "bwd_bound_ms": bounds["both"][0],
          "bwd_bound_by": bounds["both"][1],
          "bwd_tflops": bounds["both"][3] / bwd_ms / 1e9,
          "plain_bwd_ms": plain_bwd_ms, "sdpa_bwd_ms": sdpa_bwd_ms,
          "sdpa_bwd_device_ms": sdpa_bwd_device_ms,
          "sdpa_fwd_bwd_ms": sdpa_fwd_bwd_ms,
          "bounds": {w: {"ms": b[0], "by": b[1], "bytes": b[2],
                         "flops": b[3]} for w, b in bounds.items()},
          "ptxas": {k: v for k, v in PTXAS.items()
                    if k.startswith("flash_bwd")}, "qwen3_train": qwen3,
          "pair_hybrid": pair})
    main_err = {"dq": main["q"], "dkdv": max(main["k"], main["v"])}
    return {w: {"variant": flash_ops.VARIANTS[dtype],
                "max_abs_err": main_err[w],
                "ms": by_kernel[f"flash_bwd_{w}_kernel"],
                "plain_ms": plain_bwd_ms, "library_ms": sdpa_bwd_ms,
                "bound_ms": bounds[w][0], "bound_by": bounds[w][1],
                "qwen3_train": qwen3[w],
                "pair_hybrid": {n: {**t[w], **{k: t[k] for k in t
                                               if k.startswith(("library",
                                                                "sdpa"))}}
                                for n, t in pair.items()}}
            for w in ("dq", "dkdv")}


def _sdpa_backends(case) -> dict:
    """SDPA's backward at ``case`` (bf16, the model's views), as chosen
    by default and under each backend forced by ``sdpa_kernel``: two
    CUDA-event times of 20 calls of ``autograd.grad`` (host work
    included), the device time of a call summed over its kernels
    (``torch.profiler``), and for the default its three longest kernels;
    for a backend that refuses the shape, the first line of its error."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    dtype = torch.bfloat16
    q, k, v = (t.transpose(1, 2).contiguous().transpose(1, 2)
               .requires_grad_() for t in _qkv(case, dtype))
    g = torch.Generator(device="cuda").manual_seed(1)
    dout = torch.randn(q.shape, generator=g, device="cuda").to(dtype)

    def timed() -> dict:
        out = _sdpa(q, k, v, case[6])

        def bwd():
            return torch.autograd.grad(out, (q, k, v), dout,
                                       retain_graph=True)
        kernels = _device_ms_by_name(bwd, 10)
        return {"ms": [_time_ms(bwd, 20) for _ in range(2)],
                "device_ms": sum(kernels.values()),
                "kernels_ms": {n[:80]: ms for n, ms in sorted(
                    kernels.items(), key=lambda kv: -kv[1])[:3]}}

    res = {"default": timed()}
    for name in ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION",
                 "MATH"):
        try:
            with sdpa_kernel(getattr(SDPBackend, name)):
                res[name.lower()] = timed()
        except RuntimeError as exc:     # the backend does not take it
            res[name.lower()] = {"refused": str(exc).strip().splitlines()[0]
                                 [:160]}
    return res


def _bwd_timing(case, rel_err) -> dict:
    """The bf16 backward kernels at ``case`` as the model's views: each
    kernel's device ms (``torch.profiler``) beside its bound, and the
    library call's backward at the same shape (:func:`_library`), CUDA
    events and device time."""
    dtype = torch.bfloat16
    q, k, v = (t.transpose(1, 2).contiguous().transpose(1, 2)
               for t in _qkv(case, dtype))
    g = torch.Generator(device="cuda").manual_seed(1)
    dout = torch.randn(q.shape, generator=g, device="cuda").to(dtype)
    kw = (case[6], case[7], case[8])
    _, lse = flash_ops._forward(q, k, v, *kw, with_lse=True)
    by_kernel = _kernel_ms_by_name(
        lambda: flash_ops._backward(q, k, v, lse, dout, *kw), 20,
        ("flash_bwd_dq_kernel", "flash_bwd_dkdv_kernel"))
    qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))
    device_ms = []      # SDPA's, then flex_attention's where it is timed

    def bwd_ms(call):
        out = call(qr, kr, vr)

        def bwd():
            return torch.autograd.grad(out, (qr, kr, vr), dout,
                                       retain_graph=True)
        device_ms.append(sum(_device_ms_by_name(bwd, 10).values()))
        return _time_ms(bwd, 20)
    res = {"shape": case, "max_rel_err": rel_err,
           **_library(case, qr, kr, vr, bwd_ms),
           "library_device_ms": device_ms[-1]}
    if len(device_ms) == 2:
        res["sdpa_device_ms"] = device_ms[0]
    for w in ("dq", "dkdv"):
        bound = _bwd_bound(case, dtype, w)
        res[w] = {"ms": by_kernel[f"flash_bwd_{w}_kernel"],
                  "bound_ms": bound[0], "bound_by": bound[1]}
    return res


def _ssd_bwd_compare(name, inputs, h0=None, seed=5) -> dict:
    """The SSD backward kernel, through autograd of ``ssd_ops.ssd_scan``,
    against the plain version's autograd on the same inputs, for a seeded
    cotangent on y and on the final state: dx, ddt, da, db, dc (and dh0
    from a given h0).  fp32 within 1e-4 of each grad's max|plain| (fp32
    sums in another order); bf16 within 1e-3 max|plain| + 1e-2 |plain|
    elementwise (both compute in fp32 from the same bf16 inputs; dx, db,
    dc are rounded once to bf16).  One forward and one backward launch of
    the dtype's variant.  Returns each grad's largest error over its
    max|plain|, and ``abs``, the largest absolute error."""
    x, b = inputs[0], inputs[3]
    bsz, h, l, p = x.shape
    n = b.shape[2]
    g = torch.Generator(device="cuda").manual_seed(seed)
    dy = torch.randn(bsz, l, h, p, generator=g, device="cuda").to(
        x.dtype).transpose(1, 2)
    dh = torch.randn(bsz, h, p, n, generator=g, device="cuda")
    ins = [t.detach().requires_grad_() for t in inputs]
    if h0 is not None:
        ins.append(h0.detach().requires_grad_())
    before = (ssd_ops.LAUNCHES, ssd_ops.BWD_LAUNCHES,
              dict(ssd_ops.BWD_VARIANT_LAUNCHES))
    y, h_final = ssd_ops.ssd_scan(*ins)
    got = torch.autograd.grad((y, h_final), ins, (dy, dh))
    torch.cuda.synchronize()
    variant = ssd_ops.BWD_VARIANTS[x.dtype]
    want_var = {k: c + (k == variant) for k, c in before[2].items()}
    if (ssd_ops.LAUNCHES, ssd_ops.BWD_LAUNCHES) != \
            (before[0] + 1, before[1] + 1) or \
            ssd_ops.BWD_VARIANT_LAUNCHES != want_var:
        raise AssertionError(f"ssd backward {name}: launches forward "
                             f"{ssd_ops.LAUNCHES}, backward "
                             f"{ssd_ops.BWD_LAUNCHES} "
                             f"{ssd_ops.BWD_VARIANT_LAUNCHES} after {before}")
    want = ssd_scan_backward_reference(*inputs, h0, dy, dh)
    atol, rtol = (1e-3, 1e-2) if x.dtype == torch.bfloat16 else (1e-4, 0.0)
    errs = {"abs": 0.0}
    for what, gg, ww in zip(SSD_GRADS, got, want):
        if ww is None:
            continue
        gg, ww = gg.float(), ww.float()
        scale = ww.abs().max().item()
        diff = (gg - ww).abs()
        over = (diff / (atol * scale + rtol * ww.abs())).max().item()
        if not (np.isfinite(over) and over <= 1.0 and scale > 0):
            raise AssertionError(f"ssd backward {name} {what}: max err "
                                 f"{diff.max().item()}, {over} x the "
                                 f"tolerance (max|plain| {scale})")
        errs[what] = diff.max().item() / scale
        errs["abs"] = max(errs["abs"], diff.max().item())
    return errs


def _ssd_bwd_bound(shape, dtype):
    """Least time (ms) of the SSD backward at ``shape``: x, dy, dt, a, B, C
    read once and dx, ddt, da, dB, dC written once at the HBM rate, against
    the FLOPs of the chunked form at the kernel's tile (C B^T, dy u^T,
    M^T dy, dS B and dS^T C over causal pairs; the chunk states, B g^T,
    dy h_prev, x g and the adjoint update over Q x P x N) at the peak for
    ``dtype``."""
    b, h, l, p, n = shape
    esize = torch.tensor([], dtype=dtype).element_size()
    nbytes = (esize * (3 * b * h * l * p + 4 * b * l * n)
              + 4 * (2 * b * h * l + 2 * h))
    flops = 0
    for l0 in range(0, l, SSD_Q):
        q = min(SSD_Q, l - l0)
        pairs = q * (q + 1) // 2
        flops += 2 * pairs * (3 * n + 2 * p) + 10 * q * p * n
    flops *= b * h
    return _least_ms(nbytes, flops, dtype)


def _ssd_bwd_occupancy() -> dict:
    """Shared memory a block and blocks an SM of each backward kernel at
    mamba2-370m's heads (P 64, N 128), from the CUDA runtime."""
    fn = build.load("ssd_scan_bwd").ssd_scan_bwd_occupancy
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)] * 2
    out = {}
    for name, dtype in (("ssd_scan_bwd_kernel", 0),
                        ("ssd_scan_bwd_kernel_mma", 1)):
        smem, blocks = ctypes.c_int(0), ctypes.c_int(0)
        rc = fn(dtype, 64, 128, ctypes.byref(smem), ctypes.byref(blocks))
        if rc != 0:
            raise RuntimeError(f"{name}: occupancy query failed: CUDA "
                               f"error {rc}")
        out[name] = {"smem_bytes": smem.value, "blocks_per_sm": blocks.value}
    return out


@_phase
def phase_ssd_bwd() -> dict:
    """The SSD backward kernels against the plain version's autograd on
    the card; the bf16 kernel's tensor-core instructions, registers and
    occupancy; its time at the training shape beside its bound, the plain
    backward's and the wrapper's whole call."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sass = _sass_counts("ssd_scan_bwd")
    if sass is not None and \
            sass.get("ssd_scan_bwd_kernel_mma", {}).get("HMMA", 0) == 0:
        raise AssertionError(f"bf16 SSD backward kernel: no tensor-core "
                             f"instructions in its SASS: {sass}")
    occupancy = _ssd_bwd_occupancy()
    errs = {}
    h0_gen = torch.Generator("cuda").manual_seed(3)
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype)[6:]
        cases = [(f"case{i}", c, False) for i, c in enumerate(SSD_CASES)]
        cases.append(("ragged", SSD_RAGGED, True))
        for name, case, slow in cases:
            b, h, _, p, n = case
            for with_h0 in (False, True):
                h0 = torch.randn(b, h, p, n, device="cuda",
                                 generator=h0_gen) if with_h0 else None
                key = f"{name}{'-h0' if with_h0 else ''}-{tag}"
                errs[key] = _ssd_bwd_compare(
                    key, _ssd_inputs(case, dtype, seed=2, slow=slow), h0)
    for name, (shape, with_h0) in SSD_BWD_VIEWS.items():
        b, h, _, p, n = shape
        h0 = torch.randn(b, h, p, n, device="cuda",
                         generator=h0_gen) if with_h0 else None
        errs[f"{name}-bfloat16"] = _ssd_bwd_compare(
            name, _ssd_model_views(shape, seed=7), h0)
    main_err = errs["views-2048-bfloat16"]["abs"]

    dtype = torch.bfloat16
    b, h, l, p, n = SSD_TRAIN_SHAPE
    inputs = _ssd_model_views(SSD_TRAIN_SHAPE, seed=6)
    g = torch.Generator(device="cuda").manual_seed(6)
    dy = torch.randn(b, l, h, p, generator=g, device="cuda").to(
        dtype).transpose(1, 2)

    def bwd():
        return ssd_ops._backward(*inputs, None, dy, None)
    first, again = bwd(), bwd()
    if not all(torch.equal(u, v) for u, v in zip(first[:5], again[:5])):
        raise AssertionError("ssd backward: two runs on the same inputs "
                             "differ (it must sum in a fixed order)")
    del first, again
    call_ms = _time_ms(bwd, 10)
    kernel_ms = _kernel_ms_by_name(bwd, 10, ("ssd_scan_bwd_kernel",))[
        "ssd_scan_bwd_kernel"]
    plain_in = _ssd_model_views((SSD_PLAIN_BATCH,) + SSD_TRAIN_SHAPE[1:],
                                seed=6)
    plain_dy = dy[:SSD_PLAIN_BATCH]
    plain_ms = _time_ms(lambda: ssd_scan_backward_reference(
        *plain_in, None, plain_dy), 2, warmup=1)
    kernel_ms_2 = _kernel_ms_by_name(bwd, 10, ("ssd_scan_bwd_kernel",))[
        "ssd_scan_bwd_kernel"]
    bound_ms, bound_by, nbytes, flops = _ssd_bwd_bound(SSD_TRAIN_SHAPE,
                                                       dtype)
    plain_bound = _ssd_bwd_bound((SSD_PLAIN_BATCH,) + SSD_TRAIN_SHAPE[1:],
                                 dtype)[0]
    variant = ssd_ops.BWD_VARIANTS[dtype]
    emit({"phase": "ssd_bwd", "max_rel_err": errs,
          "views_max_abs_err": main_err, "shape": SSD_TRAIN_SHAPE,
          "dtype": "bfloat16", "variant": variant,
          "ptxas": {k: v for k, v in PTXAS.items()
                    if k.startswith("ssd_scan_bwd")},
          "sass": sass, "occupancy_p64_n128": occupancy,
          "kernel_ms": kernel_ms, "kernel_ms_repeat": kernel_ms_2,
          "call_ms": call_ms, "call_minus_kernel_ms": call_ms - kernel_ms,
          "plain_ms": plain_ms,
          "plain_batch": SSD_PLAIN_BATCH, "plain_bound_ms": plain_bound,
          "library_ms": None,
          "library_note": "no PyTorch call computes the SSD scan's "
                          "gradient",
          "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
          "flops": flops, "kernel_tflops": flops / kernel_ms / 1e9})
    del inputs, dy, plain_in, plain_dy
    torch.cuda.empty_cache()
    return {"variant": variant, "max_abs_err": main_err, "ms": kernel_ms,
            "plain_ms": plain_ms, "plain_batch": SSD_PLAIN_BATCH,
            "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by}


def _loss_and_grads(cfg, params, batch):
    leaves, _ = fsdp.tree_flatten(params)
    for t in leaves:
        t.requires_grad_(True)
    loss, _ = M.loss_fn(cfg, params, batch)
    return float(loss.detach()), torch.autograd.grad(loss, leaves)


def _train_kernel_calls(cfg) -> dict:
    """The kernel launches of one rank call of a training step (every
    element checkpointed): each attention layer's flash forward twice and
    each backward kernel once; each SSM block's scan forward twice, three
    times inside a zamba group (its blocks are checkpointed again inside
    the group's checkpoint: the outer recompute runs them, and the inner
    recompute again), and its backward once."""
    attn = ssm = nested = 0
    for spec in M.build_stages(cfg):
        if spec.kind in ("dense", "pair"):
            attn += spec.count * (2 if spec.kind == "pair" else 1)
        elif spec.kind == "ssm":
            ssm += spec.count
        else:
            attn += spec.count
            nested += spec.count * spec.inner
    return {"flash_attention": 2 * attn, "flash_bwd_dq": attn,
            "flash_bwd_dkdv": attn, "ssd_scan": 2 * ssm + 3 * nested,
            "ssd_scan_bwd": ssm + nested}


def _launch_counts() -> dict:
    return {"flash_attention": flash_ops.LAUNCHES,
            **dict(flash_ops.BWD_LAUNCHES), "ssd_scan": ssd_ops.LAUNCHES,
            "ssd_scan_bwd": ssd_ops.BWD_LAUNCHES}


@_phase
def phase_train_grads() -> dict:
    """fp32, TF32 off: reduced models' loss and grads through the kernels
    on the card against the plain versions on the CPU, same params; the
    dense, MoE and gemma2 pair models through the flash kernels, mamba2
    (P 32, N 16) through the SSD kernels, zamba2 through both.  The MoE
    model (mixtral, 4 experts, top-2) gets tokens of 8 ids, so that
    routing is skewed: its capacity dispatches must drop assignments, the
    same number on both devices."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res = {}
    for arch in ("gpt-1.3b", "bert-large", MAMBA, MIXTRAL, GEMMA2, ZAMBA2):
        cfg = get_arch(arch).reduced()
        cpu_params = M.init_params(cfg, torch.Generator().manual_seed(3),
                                   "cpu", all_fp32=True)
        tree = M.tree_map(cpu_params, lambda _, t: t.numpy())
        toks = np.random.default_rng(3).integers(
            0, 8 if cfg.is_moe else cfg.vocab_size, (2, 129))
        out, drops = {}, {}
        for device in ("cpu", "cuda"):
            t = torch.from_numpy(toks).to(device)
            batch = {"tokens": t[:, :-1], "labels": t[:, 1:],
                     "weights": torch.full((2, 128), 1 / 256,
                                           device=device)}
            before = _launch_counts()
            with moe.counting_drops() as dropped:
                out[device] = _loss_and_grads(
                    cfg, params_from_numpy(tree, device), batch)
            drops[device] = sum(int(d) for _, d in dropped)
            torch.cuda.synchronize()
        launches = {n: c - before[n] for n, c in _launch_counts().items()}
        if launches != _train_kernel_calls(cfg):
            raise AssertionError(f"{arch}: launches {launches}, expected "
                                 f"{_train_kernel_calls(cfg)}")
        if cfg.is_moe and not drops["cpu"] == drops["cuda"] > 0:
            raise AssertionError(f"{arch}: dropped assignments {drops}: "
                                 f"the same number on both, more than 0")
        (loss_c, grads_c), (loss_g, grads_g) = out["cpu"], out["cuda"]
        if not abs(loss_g - loss_c) <= 1e-5 * abs(loss_c):
            raise AssertionError(f"{arch}: loss {loss_g} on the card, "
                                 f"{loss_c} on the CPU")
        worst = 0.0
        for i, (gg, gc) in enumerate(zip(grads_g, grads_c)):
            scale = gc.abs().max().item()
            err = (gg.cpu() - gc).abs().max().item()
            if not (np.isfinite(err) and err <= 1e-4 * scale and scale > 0):
                raise AssertionError(f"{arch} grad leaf {i}: err {err} > "
                                     f"1e-4 * {scale}")
            worst = max(worst, err / scale)
        res[arch] = {"loss_cuda": loss_g, "loss_cpu": loss_c,
                     "grad_max_rel_err": worst, "leaves": len(grads_c),
                     "dropped_assignments": drops["cuda"],
                     "launches": launches}
    emit({"phase": "train_grads", "dtype": "float32", **res})
    return res


def _zero_flash_counts() -> None:
    flash_ops.LAUNCHES = 0
    flash_ops.VARIANT_LAUNCHES.update(
        dict.fromkeys(flash_ops.VARIANT_LAUNCHES, 0))
    flash_ops.BWD_LAUNCHES.update(dict.fromkeys(flash_ops.BWD_LAUNCHES, 0))
    flash_ops.BWD_VARIANT_LAUNCHES.update(
        dict.fromkeys(flash_ops.BWD_VARIANT_LAUNCHES, 0))


def _zero_counts() -> None:
    """Every kernel's launch counts, flash and SSD, forward and backward."""
    _zero_flash_counts()
    ssd_ops.LAUNCHES = ssd_ops.BWD_LAUNCHES = 0
    ssd_ops.VARIANT_LAUNCHES.update(dict.fromkeys(ssd_ops.VARIANT_LAUNCHES,
                                                  0))
    ssd_ops.BWD_VARIANT_LAUNCHES.update(
        dict.fromkeys(ssd_ops.BWD_VARIANT_LAUNCHES, 0))


def _rank_calls(schedule, plan: Plan) -> int:
    """Rank calls a step makes: each round, each rank with microbatches
    in it."""
    chunks = schedule.chunks(max(plan.ell_pad, 1))
    calls, lo = 0, 0
    for size in chunks:
        calls += sum(1 for r in plan.ranks
                     if min(lo + size, r.ell) > min(lo, r.ell))
        lo += size
    return calls


def _check_train_launches(phase: str, cfg, calls: int) -> dict:
    """The launches since the counts were zeroed: ``calls`` rank calls,
    each making :func:`_train_kernel_calls`' launches, every one on the
    bf16 tensor-core kernels (a backward variant counts each of the flash
    backward's two kernels)."""
    per = _train_kernel_calls(cfg)
    want = {n: c * calls for n, c in per.items()}
    variants = {
        "flash": (flash_ops.VARIANT_LAUNCHES, want["flash_attention"]),
        "flash_bwd": (flash_ops.BWD_VARIANT_LAUNCHES,
                      2 * want["flash_bwd_dq"]),
        "ssd": (ssd_ops.VARIANT_LAUNCHES, want["ssd_scan"]),
        "ssd_bwd": (ssd_ops.BWD_VARIANT_LAUNCHES, want["ssd_scan_bwd"])}
    launches = _launch_counts()
    if launches != want or any(
            got != {"fp32-fma": 0, "bf16-mma": n}
            for got, n in variants.values()):
        raise AssertionError(f"{phase}: launches {launches} (variants "
                             f"{ {k: v[0] for k, v in variants.items()} }),"
                             f" expected {want}, all bf16")
    return launches


def _train_plan(model: str) -> Plan:
    ranks = [RankPlan(i, dev, m=m, ell=ell, state_ratio=r)
             for i, (dev, m, ell, r) in enumerate(TRAIN_RANKS)]
    return Plan(model=model, cluster="loopback-1-gpu",
                global_batch=sum(r.b for r in ranks), ranks=ranks)


def _same_batch_losses(cfg, plan, block, lr: float) -> list:
    """The losses of TREND_STEPS steps on one batch from the seeded state,
    at Adam's ``lr``: whether the steps descend on the batch they were
    taken on."""
    engine = build_train_step(cfg, plan, substrate="loopback",
                              schedule="layered", seq_len=TRAIN_SEQ,
                              adam=AdamConfig(lr=lr))
    state = engine.init_state(torch.Generator(device="cuda").manual_seed(0))
    losses = []
    for _ in range(TREND_STEPS):
        state, loss = engine.step(state, block)
        losses.append(loss)
    del engine, state
    torch.cuda.empty_cache()
    return losses


@_phase
def phase_train(arch: str = TRAIN_ARCH, layers: int = 0,
                phase: str = "train", trend_lrs=()) -> dict:
    """``arch`` at full width (its first ``layers`` layers when given,
    else full depth) through the loopback MPMD engine on the fixed
    two-rank plan (TRAIN_RANKS); returns the flash launches of the timed
    steps.  For each of ``trend_lrs``, then, :func:`_same_batch_losses`
    on the first timed step's batch (printed, not a gate)."""
    cfg = get_arch(arch)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    plan = _train_plan(cfg.name)
    engine = build_train_step(cfg, plan, substrate="loopback",
                              schedule="layered", seq_len=TRAIN_SEQ)
    t0 = time.perf_counter()
    state = engine.init_state(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    stream = SyntheticStream(DataConfig(cfg.vocab_size, TRAIN_SEQ, seed=0))
    blocks = [stream.sample(i, plan.global_batch)
              for i in range(TRAIN_STEPS + 1)]
    state, warm_loss = engine.step(state, blocks[0])
    torch.cuda.synchronize()
    _zero_counts()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms = [], []
    units = [g.name for g in engine.trainer.groups]
    for blk in blocks[1:]:
        before = {(r, u): state[r][u]["p"].view(-1)[::1009].clone()
                  for r in range(plan.n) for u in units}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = engine.step(state, blk)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
        for (r, u), old in before.items():
            if torch.equal(old, state[r][u]["p"].view(-1)[::1009]):
                raise AssertionError(f"rank {r} unit {u}: shard unchanged "
                                     f"by a step")
    peak = torch.cuda.max_memory_allocated()
    if not all(np.isfinite(losses + [warm_loss])):
        raise AssertionError(f"non-finite loss: {warm_loss}, {losses}")
    launches = _check_train_launches(
        phase, cfg, TRAIN_STEPS * _rank_calls(engine.schedule, plan))
    mean_ms = float(np.mean(step_ms))
    samples_s = plan.global_batch / (mean_ms / 1e3)
    res = {"phase": phase, "arch": cfg.name, "layers": cfg.n_layers,
           "of_layers": get_arch(arch).n_layers,
           "d_model": cfg.d_model, "params": sum(
               g.layout.size * g.count for g in engine.trainer.groups),
           "seq": TRAIN_SEQ, "global_batch": plan.global_batch,
           "ranks": TRAIN_RANKS, "schedule": "layered", "init_s": init_s,
           "warmup_loss": warm_loss, "losses": losses, "step_ms": step_ms,
           "mean_step_ms": mean_ms, "samples_s": samples_s,
           "tokens_s": samples_s * TRAIN_SEQ, "peak_mem_gib": peak / 2**30,
           "launches_per_step": {k: v // TRAIN_STEPS
                                 for k, v in launches.items()},
           "bwd_variant_launches_per_step": {
               k: v // TRAIN_STEPS
               for k, v in flash_ops.BWD_VARIANT_LAUNCHES.items()},
           "ssd_bwd_variant_launches_per_step": {
               k: v // TRAIN_STEPS
               for k, v in ssd_ops.BWD_VARIANT_LAUNCHES.items()},
           "collectives": dict(engine.trainer.substrate.stats),
           "memory": engine.memory_report(state).splitlines()}
    del engine, state
    torch.cuda.empty_cache()
    if trend_lrs:
        res["same_batch_losses"] = {
            lr: _same_batch_losses(cfg, plan, blocks[1], lr)
            for lr in trend_lrs}
    emit(res)
    return launches


class _MemPoll:
    """The card's used memory (all processes: ``torch.cuda.mem_get_info``)
    and the host's (the machine's cgroup, where it can be read) polled
    every 20 ms on a thread while the block runs; ``.max`` and
    ``.host_max`` are the most seen (``host_max`` None where unread)."""

    def __enter__(self):
        self.max, self.host_max = 0, None
        self._stop = threading.Event()

        def poll():
            while not self._stop.is_set():
                free, total = torch.cuda.mem_get_info()
                self.max = max(self.max, total - free)
                for path in CGROUP_MEM:
                    if os.path.exists(path):
                        with open(path) as f:
                            self.host_max = max(self.host_max or 0,
                                                int(f.read()))
                        break
                self._stop.wait(0.02)
        self._thread = threading.Thread(target=poll, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()


def _progress(what: str, t0: float) -> None:
    """One line on stderr: how long ``what`` took (a long phase's
    progress; stdout keeps the JSON lines)."""
    print(f"chip_smoke: {what}: {time.perf_counter() - t0:.1f} s",
          file=sys.stderr, flush=True)


def _mp_steps(engine, blocks, observe=None, label="") -> dict:
    """1 warm-up step and the timed ones on ``engine`` from its seeded
    state; returns the state, the losses (warm-up first), the timed
    steps' ms and ``observe(engine)`` after every step, where given."""
    t0 = time.perf_counter()
    state = engine.init_state(torch.Generator(device="cuda").manual_seed(0))
    _progress(f"{label} init_state", t0)
    losses, step_ms, seen = [], [], []
    for i, blk in enumerate(blocks):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = engine.step(state, blk)
        torch.cuda.synchronize()
        _progress(f"{label} step {i}", t0)
        if i:
            step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
        if observe is not None:
            seen.append(observe(engine))
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite loss: {losses}")
    return {"state": state, "losses": losses, "step_ms": step_ms,
            "seen": seen}


def _state_diff(a: dict, b: dict) -> float:
    """max |a - b| over every leaf of the parts (p, m, v) of two exported
    states.  Raises unless both hold the same parts, each with the same
    number of leaves (at least one), pairwise of one shape and dtype."""
    parts = [part for part in ("p", "m", "v") if part in a]
    if not parts or parts != [part for part in ("p", "m", "v") if part in b]:
        raise AssertionError(f"state parts differ: {sorted(a)} {sorted(b)}")
    worst = 0.0
    for part in parts:
        xs, ys = fsdp.tree_flatten(a[part])[0], fsdp.tree_flatten(b[part])[0]
        if not xs or len(xs) != len(ys):
            raise AssertionError(
                f"state part {part}: {len(xs)} leaves against {len(ys)}")
        for i, (x, y) in enumerate(zip(xs, ys)):
            if x.shape != y.shape or x.dtype != y.dtype:
                raise AssertionError(
                    f"state part {part} leaf {i}: {tuple(x.shape)} "
                    f"{x.dtype} against {tuple(y.shape)} {y.dtype}")
            if not torch.equal(x, y):
                worst = max(worst, (x - y).abs().max().item())
    return worst


def _loopback_reference(cfg, plan, blocks) -> dict:
    """The loopback engine's run (:func:`_mp_steps`) with its exported
    state moved to the host, the card freed after it."""
    engine = build_train_step(cfg, plan, substrate="loopback",
                              schedule="layered", seq_len=TRAIN_SEQ)
    run = _mp_steps(engine, blocks, label="train_multiproc loopback")
    state = run.pop("state")
    run["export"] = {k: v if k == "step" else
                     M.tree_map(v, lambda _, t: t.cpu())
                     for k, v in engine.export_state(state).items()}
    del engine, state
    torch.cuda.empty_cache()
    return run


@_phase
def phase_train_multiproc() -> dict:
    """gpt-1.3b at full width and depth on the fixed two-rank plan
    (TRAIN_RANKS, seq 512, ``layered``, blocks of ``SyntheticStream``
    seed 0) through the process fleet (``substrate="multiproc"``): two
    worker processes share the card, each holding its rank's shard and
    running the kernels; 1 warm-up step and MP_STEPS timed ones under
    each topology.  First the loopback engine takes the same steps from
    the same generator seed; after each fleet run the fleet's state,
    gathered part by part as ``export_state`` gathers it, must equal the
    loopback's bit for bit.  Should it not, the loopback runs a second
    time: if the two loopback runs differ, their max difference is the
    bound (printed); if they agree, the fleet's difference fails the
    phase.  Each timed step's flash launches, reported by the workers,
    must be what the plan and the checkpointing predict, all bf16."""
    from repro_torch.core.engine.multiproc import COLLECTIVE_TAGS
    cfg = get_arch(TRAIN_ARCH)
    plan = _train_plan(cfg.name)
    stream = SyntheticStream(DataConfig(cfg.vocab_size, TRAIN_SEQ, seed=0))
    blocks = [stream.sample(i, plan.global_batch)
              for i in range(MP_STEPS + 1)]
    if torch.cuda.memory_allocated() > 2**30:
        raise AssertionError("train_multiproc: earlier phases still hold "
                             f"{torch.cuda.memory_allocated()} B")
    ref = _loopback_reference(cfg, plan, blocks)
    want = {n: c * _rank_calls(get_schedule("layered"), plan)
            for n, c in _train_kernel_calls(cfg).items()}
    want_variants = {"flash_attention/bf16-mma": want["flash_attention"],
                     "flash_attention/fp32-fma": 0,
                     "flash_bwd/bf16-mma": 2 * want["flash_bwd_dq"],
                     "flash_bwd/fp32-fma": 0}
    flat_bytes = 4 * sum(g.layout.padded * g.count
                         for g in UnitPlanner(cfg, [r[3] for r in
                                                    TRAIN_RANKS]).groups)
    shm = shutil.disk_usage("/dev/shm") if os.path.isdir("/dev/shm") \
        else None
    runs = {}
    loopback_bound = None
    for topology in MP_TOPOLOGIES:
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        engine = build_train_step(cfg, plan, substrate="multiproc",
                                  schedule="layered", seq_len=TRAIN_SEQ,
                                  topology=topology, transport=MP_TRANSPORT)
        try:
            start_s = time.perf_counter() - t0

            def observe(eng):
                return {"launches": dict(eng.last_step_launches),
                        "compute_s": dict(eng.last_step_walls),
                        "wall_s": eng.last_step_wall_s,
                        "comm": {r: dict(c) for r, c in
                                 eng.last_step_comm.items()},
                        "coord_bytes": eng.substrate.coordinator_bytes(
                            COLLECTIVE_TAGS)}
            _progress(f"train_multiproc {topology} start", t0)
            with _MemPoll() as mem:
                run = _mp_steps(engine, blocks, observe,
                                f"train_multiproc {topology}")
            for i, seen in enumerate(run["seen"]):
                got = seen["launches"]
                bad = {k: (got.get(k, 0), n) for k, n in
                       {**want, **want_variants}.items()
                       if got.get(k, 0) != n}
                if bad:
                    raise AssertionError(
                        f"train_multiproc {topology} step {i}: the "
                        f"workers' launches (got, want) {bad}")
            state = run.pop("state")
            planes = engine.transport_planes()
            report = engine.memory_report(state).splitlines()
            t0 = time.perf_counter()
            diff = 0.0
            for part in ("p", "m", "v"):
                got = engine.substrate.allgather_params(None, part)
                diff = max(diff, _state_diff({part: ref["export"][part]},
                                             {part: got}))
                del got
            gather_s = time.perf_counter() - t0
            _progress(f"train_multiproc {topology} gather", t0)
        finally:
            engine.close()
        del engine
        if run["losses"] != ref["losses"] or diff > 0.0:
            if loopback_bound is None:
                again = _loopback_reference(cfg, plan, blocks)
                loopback_bound = _state_diff(ref["export"], again["export"])
                del again
            if not (loopback_bound > 0.0 and diff <= loopback_bound):
                raise AssertionError(
                    f"train_multiproc {topology}: losses {run['losses']} "
                    f"against the loopback's {ref['losses']}, state max "
                    f"diff {diff}; two loopback runs differ by "
                    f"{loopback_bound}")
        mean_ms = float(np.mean(run["step_ms"]))
        coord = [seen["coord_bytes"] for seen in run["seen"]]
        runs[topology] = {
            "start_s": start_s, "losses": run["losses"],
            "step_ms": run["step_ms"], "mean_step_ms": mean_ms,
            "samples_s": plan.global_batch / (mean_ms / 1e3),
            "state_max_diff": diff, "gather_s": gather_s,
            "comm_per_step": [seen["comm"] for seen in run["seen"][1:]],
            "compute_s_per_step": [seen["compute_s"]
                                   for seen in run["seen"][1:]],
            "engine_wall_s_per_step": [seen["wall_s"]
                                       for seen in run["seen"][1:]],
            "coordinator_bytes_per_step": np.diff(coord).tolist(),
            "launches_per_step": run["seen"][-1]["launches"],
            "planes": planes, "memory": report,
            "card_used_gib_max": mem.max / 2**30,
            "host_used_gib_max": None if mem.host_max is None
            else mem.host_max / 2**30}
    res = {"phase": "train_multiproc", "arch": cfg.name,
           "layers": cfg.n_layers, "d_model": cfg.d_model,
           "params": flat_bytes // 4, "seq": TRAIN_SEQ,
           "global_batch": plan.global_batch, "ranks": TRAIN_RANKS,
           "schedule": "layered", "transport": MP_TRANSPORT,
           "flat_bytes": flat_bytes,
           "dev_shm_bytes": None if shm is None else shm.total,
           "dev_shm_free": None if shm is None else shm.free,
           "loopback": {"losses": ref["losses"], "step_ms": ref["step_ms"],
                        "mean_step_ms": float(np.mean(ref["step_ms"]))},
           "loopback_bound": loopback_bound,
           "expected_launches_per_step": {**want, **want_variants},
           **runs}
    emit(res)
    return {t: r["launches_per_step"] for t, r in runs.items()}


def _held_out_errors(samples) -> dict:
    """App. A.3: fit on PROFILE_FIT_MS, |relative error| at the rest."""
    t = dict(samples)
    model = fit_piecewise([(m, t[m]) for m in PROFILE_FIT_MS])
    return {m: abs(model.one(m) - t[m]) / t[m] for m in PROFILE_HELD_MS}


@_phase
def phase_profile() -> dict:
    """The profiler on the card: one gpt-1.3b layer at seq 512, forward
    and backward, fit and held-out error; then the paper's workflow,
    ``profiled_cluster_model`` for Cluster A, solved at batch 128."""
    cfg = get_arch(TRAIN_ARCH)
    ms = PROFILE_FIT_MS + PROFILE_HELD_MS
    _zero_flash_counts()
    fwd = profiler.profile_layer_forward(cfg, TRAIN_SEQ, ms=ms)
    bwd = profiler.profile_layer_backward(cfg, TRAIN_SEQ, ms=ms)
    cm = profiler.profiled_cluster_model(device_specs.cluster_a(), cfg,
                                         TRAIN_SEQ)
    torch.cuda.synchronize()
    for name, samples in (("forward", fwd), ("backward", bwd)):
        if not all(np.isfinite(t) and t > 0 for _, t in samples):
            raise AssertionError(f"profile: {name} samples {samples}")
    # every timed call and its warm-up: the sweep above, then the
    # cost model's own sweep (PROFILE_FIT_MS, 3 repeats)
    # (the forward sweeps' calls and the backward sweeps' forwards; the
    # backward count has one launch of each of its two kernels)
    calls = (1 + 3) * (len(ms) + len(PROFILE_FIT_MS))
    want = {"fp32-fma": 0, "bf16-mma": 2 * calls}
    if flash_ops.VARIANT_LAUNCHES != want or \
            flash_ops.BWD_VARIANT_LAUNCHES != want:
        raise AssertionError(
            f"profile: flash launches forward {flash_ops.VARIANT_LAUNCHES},"
            f" backward {flash_ops.BWD_VARIANT_LAUNCHES}; expected {want} "
            f"each")
    plan = auto_solve(cm, 128)
    if not plan.feasible:
        raise AssertionError(f"profile: infeasible plan from the profiled "
                             f"cost model: {plan.infeasible_reason}")
    plan.check()
    errs = {"forward": _held_out_errors(fwd),
            "backward": _held_out_errors(bwd)}
    every = [e for v in errs.values() for e in v.values()]
    h100 = device_specs.H100
    res = {"phase": "profile", "arch": cfg.name, "seq": TRAIN_SEQ,
           "dtype": str(M.compute_dtype(cfg))[6:],
           "fwd_ms": {m: t * 1e3 for m, t in fwd},
           "bwd_ms": {m: t * 1e3 for m, t in bwd},
           "held_out_rel_err": errs,
           "held_out_mean_err": float(np.mean(every)),
           "held_out_max_err": float(np.max(every)),
           "flash_variant_launches": {
               "forward": dict(flash_ops.VARIANT_LAUNCHES),
               "backward": dict(flash_ops.BWD_VARIANT_LAUNCHES)},
           "plan": [(r.device, r.m, r.ell, r.state_ratio)
                    for r in plan.ranks],
           "plan_predicted_iter_s": plan.predicted_iter_s,
           "h100_spec": dataclasses.asdict(h100),
           "h100_spec_memory_bytes": h100.memory_bytes,
           "card_total_memory_bytes":
               torch.cuda.get_device_properties(0).total_memory,
           "zamba2": _profile_zamba2()}
    emit(res)
    return res


def _profile_zamba2() -> dict:
    """zamba2-7b's element through the profiler on the card: its 6 SSM
    blocks and the shared block (fp32 params, bf16 activations) at m =
    ZAMBA2_PROFILE_MS, seq 512, forward and backward, and the launches
    the sweeps made.  Printed, not a gate."""
    cfg = get_arch(ZAMBA2)
    _zero_counts()
    fwd = profiler.profile_layer_forward(cfg, TRAIN_SEQ,
                                         ms=ZAMBA2_PROFILE_MS)
    bwd = profiler.profile_layer_backward(cfg, TRAIN_SEQ,
                                          ms=ZAMBA2_PROFILE_MS)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return {"arch": cfg.name, "element": "6 SSM blocks, the shared block",
            "seq": TRAIN_SEQ, "fwd_ms": {m: t * 1e3 for m, t in fwd},
            "bwd_ms": {m: t * 1e3 for m, t in bwd},
            "launches": _launch_counts()}


class _TimedEngine:
    """The engine as the launcher's loop sees it, each step timed (host
    clock around work that ends in a device synchronise), its loss kept,
    and every rank's shard of every unit checked to change."""

    def __init__(self, engine):
        self.engine, self.cfg = engine, engine.cfg
        self.step_ms, self.losses = [], []
        # each rank's shard of each unit, cut to the unit's real elements
        # (a small rank's shard may hold only the unit's zero padding)
        self.real = {}
        for g in engine.trainer.groups:
            off = 0
            for r, n in enumerate(g.layout.shard_sizes):
                self.real[(r, g.name)] = max(0, min(n, g.layout.size - off))
                off += n

    def _sample(self, state, r, u):
        return state[r][u]["p"][..., :self.real[(r, u)]].reshape(-1)[::1009]

    def step(self, state, big):
        before = {(r, u): self._sample(state, r, u).clone()
                  for (r, u), n in self.real.items() if n}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = self.engine.step(state, big)
        torch.cuda.synchronize()
        self.step_ms.append((time.perf_counter() - t0) * 1e3)
        self.losses.append(loss)
        for (r, u), old in before.items():
            if torch.equal(old, self._sample(state, r, u)):
                raise AssertionError(f"rank {r} unit {u}: shard unchanged "
                                     f"by a step")
        return state, loss


def _launcher_engine(args):
    """``launch.train``'s plan and engine for ``args``, its printed plan
    captured."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cfg, plan, _ = train_launch.solve_plan(args)
    return (train_launch.build_engine(args, cfg, plan), plan,
            out.getvalue().splitlines())


def _resume_check() -> dict:
    """Reduced gpt-1.3b on the card: 3 steps straight, against 2 steps,
    a checkpoint of the exported state saved and loaded, imported into a
    fresh engine, and the third step."""
    args = train_launch.parser().parse_args(RESUME_ARGS + ["--steps", "3"])
    engine, plan, _ = _launcher_engine(args)
    gen = torch.Generator(args.device).manual_seed(args.seed)
    straight = _TimedEngine(engine)
    with contextlib.redirect_stdout(io.StringIO()):
        train_launch._train_loop(straight, args, plan,
                                 state=engine.init_state(gen))
    args.steps = 2
    engine, plan, _ = _launcher_engine(args)
    gen = torch.Generator(args.device).manual_seed(args.seed)
    with contextlib.redirect_stdout(io.StringIO()):
        state = train_launch._train_loop(engine, args, plan,
                                         state=engine.init_state(gen))
    exported = engine.export_state(state)
    with tempfile.TemporaryDirectory() as d:
        checkpointing.save(d, exported["step"],
                           [{k: exported[k] for k in "pmv"}],
                           {"step": exported["step"]},
                           meta={"plan": plan.to_json(),
                                 "format": "exported"})
        template = {k: exported[k] for k in "pmv"}
        step, shards, rep, _ = checkpointing.load(d, template,
                                                  {"step": None})
    for k in "pmv":
        for a, b in zip(fsdp.tree_flatten(shards[0][k])[0],
                        fsdp.tree_flatten(exported[k])[0]):
            if not np.array_equal(a, b.cpu().numpy()):
                raise AssertionError(f"resume: loaded {k} differs")
    fresh, _, _ = _launcher_engine(args)
    state = fresh.import_state({"step": int(rep["step"]), **{
        k: params_from_numpy(shards[0][k], args.device) for k in "pmv"}})
    stream = SyntheticStream(DataConfig(fresh.cfg.vocab_size, args.seq,
                                        seed=args.seed))
    _, loss = fresh.step(state, stream.sample(2, plan.global_batch))
    want = straight.losses[2]
    if loss != want:
        raise AssertionError(f"resume: step 3 loss {loss} after the "
                             f"checkpoint, {want} straight")
    return {"arch": fresh.cfg.name, "checkpoint_step": step,
            "resumed_loss": loss, "straight_loss": want}


def _planned_run(phase: str, argv) -> dict:
    """The launcher's plan for ``argv`` at full width and depth through
    its ``_train_loop``: 1 warm-up step and PLAN_STEPS timed ones, every
    launch count zeroed after the warm-up and checked by
    :func:`_check_train_launches` after the last step; finite losses,
    every rank's shard changed by each step.  Returns the phase's record,
    ``launches_per_step`` included."""
    args = train_launch.parser().parse_args(
        argv + ["--steps", str(1 + PLAN_STEPS)])
    engine, plan, summary = _launcher_engine(args)
    cfg = engine.cfg
    timed = _TimedEngine(engine)
    t0 = time.perf_counter()
    state = engine.init_state(
        torch.Generator(args.device).manual_seed(args.seed))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0

    def on_step(step):
        if step == 1:               # after the warm-up step
            _zero_counts()
            torch.cuda.reset_peak_memory_stats()

    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        state = train_launch._train_loop(timed, args, plan, state=state,
                                         on_step=on_step)
    peak = torch.cuda.max_memory_allocated()
    if not all(np.isfinite(timed.losses)):
        raise AssertionError(f"{phase}: non-finite loss {timed.losses}")
    rank_calls = _rank_calls(engine.schedule, plan)
    launches = _check_train_launches(phase, cfg, PLAN_STEPS * rank_calls)
    step_ms = timed.step_ms[1:]
    mean_ms = float(np.mean(step_ms))
    sim = engine.simulated_iteration_seconds()
    res = {"phase": phase, "arch": cfg.name,
           "layers": cfg.n_layers, "d_model": cfg.d_model,
           "params": sum(g.layout.size * g.count
                         for g in engine.trainer.groups),
           "seq": args.seq, "global_batch": plan.global_batch,
           "cluster": plan.cluster, "schedule": args.ga_mode,
           "plan": [(r.device, r.m, r.ell, r.state_ratio)
                    for r in plan.ranks], "rank_calls": rank_calls,
           "plan_summary": summary, "printed": printed.getvalue()
           .splitlines(), "init_s": init_s,
           "warmup_loss": timed.losses[0], "losses": timed.losses[1:],
           "step_ms": step_ms, "mean_step_ms": mean_ms,
           "samples_s": plan.global_batch / (mean_ms / 1e3),
           "tokens_s": plan.global_batch * args.seq / (mean_ms / 1e3),
           "peak_mem_gib": peak / 2**30,
           "predicted_iter_ms_cluster_a": sim["iteration_s"] * 1e3,
           "predicted_samples_s_cluster_a": sim["throughput_samples_s"],
           "launches_per_step": {k: v // PLAN_STEPS
                                 for k, v in launches.items()},
           "memory": engine.memory_report(state).splitlines()}
    del engine, timed, state
    torch.cuda.empty_cache()
    return res


@_phase
def phase_plan_train() -> dict:
    """gpt-1.3b at full width and depth on the plan ``launch.train``
    solves for Cluster A at batch 128, through its ``_train_loop``: 1
    warm-up step and 2 timed ones; then a checkpoint's exact resume."""
    res = _planned_run("plan_train", PLAN_ARGS)
    res["resume"] = _resume_check()
    emit(res)
    return res["launches_per_step"]


@_phase
def phase_plan_train_mamba2() -> dict:
    """mamba2-370m at full width and depth on the plan ``launch.train``
    solves for Cluster A at seq 2048, batch 32, through its
    ``_train_loop``: 1 warm-up step and 2 timed ones; every SSD gradient
    from the CUDA backward kernel."""
    res = _planned_run("plan_train_mamba2", MAMBA_PLAN_ARGS)
    emit(res)
    return res["launches_per_step"]


def _state_step(state) -> int:
    """The step counter of an engine's state: a fleet's ``{"step": n}``
    or the loopback's per-rank shards."""
    return int(state["step"] if isinstance(state, dict)
               else state[0]["step"])


def _gather_part(engine, state, part: str):
    """One part (p, m or v) of ``engine``'s state gathered into the
    model's tree, as ``export_state`` gathers it."""
    if hasattr(engine, "trainer"):
        return engine.trainer.substrate.allgather_params(state, part)
    return engine.substrate.allgather_params(None, part)


@contextlib.contextmanager
def _checked_migrations(record: list):
    """While the block runs, every ``elastic.migrate_state`` (each
    replan's and each cluster change's) is timed, its card peak read
    (``max_memory_allocated`` from the export to the end of the import),
    and the new engine's state, gathered part by part, held against the
    old engine's export bit for bit, step counter included; each
    migration's record is appended to ``record``."""
    real = elastic.migrate_state

    def checked(src, state, dst):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        exported = src.export_state(state)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        new = dst.import_state(exported)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        peak = torch.cuda.max_memory_allocated()
        diff = 0.0
        for part in ("p", "m", "v"):
            got = _gather_part(dst, new, part)
            diff = max(diff, _state_diff({part: exported[part]},
                                         {part: got}))
            del got
        steps = (int(exported["step"]), _state_step(new))
        if diff != 0.0 or steps[0] != steps[1]:
            raise AssertionError(f"migration {len(record)}: state max "
                                 f"diff {diff}, step {steps}")
        record.append({"ranks": [src.plan.n, dst.plan.n],
                       "step": steps[0], "export_s": t1 - t0,
                       "import_s": t2 - t1,
                       "check_s": time.perf_counter() - t2,
                       "allocated_before_gib": before / 2**30,
                       "peak_gib": peak / 2**30, "max_diff": diff})
        return new

    elastic.migrate_state = checked
    try:
        yield record
    finally:
        elastic.migrate_state = real


def _plan_index(plans: list, plan: Plan) -> int:
    """``plan``'s index among the plans seen so far (appended if new)."""
    for i, seen in enumerate(plans):
        if seen is plan:
            return i
    plans.append(plan)
    return len(plans) - 1


def _event(ev) -> dict:
    return {"step": ev.step, "adopted": ev.adopted, "reason": ev.reason,
            "observed_layer_ms": ev.observed_layer_s * 1e3,
            "old_predicted_layer_ms": ev.old_predicted_layer_s * 1e3,
            "new_predicted_layer_ms": ev.new_predicted_layer_s * 1e3,
            "seconds": ev.seconds,
            "old_b": [r.b for r in ev.old_plan.ranks] if ev.old_plan
            else None,
            "new_b": [r.b for r in ev.new_plan.ranks] if ev.new_plan
            else None}


def _per_plan_ms(records: list) -> dict:
    """Each plan's mean step ms, over its steps that neither warm up nor
    replan (``None`` where it has none), beside every step's ms."""
    out = {}
    for rec in records:
        got = out.setdefault(f"plan{rec['plan']}",
                             {"step_ms": [], "clean": []})
        got["step_ms"].append(rec["ms"])
        if not rec["warmup"] and not rec["events"]:
            got["clean"].append(rec["ms"])
    for got in out.values():
        clean = got.pop("clean")
        got["mean_step_ms"] = float(np.mean(clean)) if clean else None
    return out


class _ElasticSteps:
    """The elastic engine as the launcher's loop sees it: each step timed
    (host clock around work that ends in a device synchronise, its
    replan included), and its launches checked against the plan in
    force when it ran (:func:`_check_train_launches`: the rank calls
    that plan makes, all bf16)."""

    def __init__(self, engine, phase: str):
        self.engine, self.cfg, self.phase = engine, engine.cfg, phase
        self.plans = [engine.plan]
        self.records = []

    def step(self, state, big):
        plan = self.engine.plan
        events = len(self.engine.events)
        _zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = self.engine.step(state, big)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        calls = _rank_calls(self.engine.schedule, plan)
        launches = _check_train_launches(
            f"{self.phase} step {len(self.records)}", self.cfg, calls)
        self.records.append({
            "step": len(self.records), "plan": _plan_index(self.plans, plan),
            "warmup": not self.records,
            "ranks": plan.n, "rank_calls": calls, "ms": ms, "loss": loss,
            "events": len(self.engine.events) - events,
            "launches": launches})
        return state, loss


@_phase
def phase_plan_train_elastic() -> dict:
    """The launcher's elastic path (``solve_plan``, ``elastic_knobs``,
    ``build_engine``, ``_train_loop``) on gpt-1.3b at full width and
    depth: Cluster A's plan at batch 128, rank 2 three times slower from
    step 2 (the cost-model oracle), 6 steps; then rank 7 leaves
    (``on_cluster_change`` onto the survivors' refit models) and one more
    step.  Fails unless the first event is an adopted replan after the
    third step that gives rank 2 fewer samples, no event comes before it,
    each migration leaves the state equal bit for bit, every step
    launches the plan in force's bf16 kernels, and the losses are
    finite."""
    args = train_launch.parser().parse_args(ELASTIC_ARGS)
    if torch.cuda.memory_allocated() > 2**30:
        raise AssertionError("plan_train_elastic: earlier phases still "
                             f"hold {torch.cuda.memory_allocated()} B")
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        cfg, plan0, cm = train_launch.solve_plan(args)
        knobs, on_step = train_launch.elastic_knobs(args, cm)
    engine = train_launch.build_engine(args, cfg, plan0, **knobs)
    timed = _ElasticSteps(engine, "plan_train_elastic")
    migrations = []
    t0 = time.perf_counter()
    state = engine.init_state(
        torch.Generator(args.device).manual_seed(args.seed))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    with _checked_migrations(migrations), \
            contextlib.redirect_stdout(printed):
        state = train_launch._train_loop(timed, args, plan0, state=state,
                                         on_step=on_step)
        cluster = train_launch.CLUSTERS[args.cluster]()
        survivors = [i for i in range(cluster.n) if i != ELASTIC_LEAVER]
        cluster = dataclasses.replace(
            cluster, devices=[cluster.devices[i] for i in survivors],
            name=f"{cluster.name}-without-rank{ELASTIC_LEAVER}")
        fresh = train_launch.analytic_cluster_model(
            cluster, train_launch.build_model_stats(cfg, args.seq))
        cm7 = dataclasses.replace(
            engine.cm, cluster=cluster, comm=fresh.comm,
            per_rank=[engine.cm.per_rank[i] for i in survivors])
        state = engine.on_cluster_change(cm7, state)
        stream = SyntheticStream(DataConfig(cfg.vocab_size, args.seq,
                                            seed=args.seed))
        state, _ = timed.step(state, stream.sample(args.steps,
                                                   plan0.global_batch))
    events = engine.events
    first = events[0] if events else None
    if not (first is not None and first.step == 3 and first.adopted
            and first.new_plan.ranks[2].b < plan0.ranks[2].b):
        raise AssertionError(f"plan_train_elastic: events "
                             f"{[_event(e) for e in events]}")
    if events[-1].reason != "cluster change" or engine.plan.n != 7 or \
            len(migrations) != sum(e.adopted for e in events):
        raise AssertionError(f"plan_train_elastic: cluster change "
                             f"{_event(events[-1])}, {len(migrations)} "
                             f"migrations")
    losses = [r["loss"] for r in timed.records]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"plan_train_elastic: losses {losses}")
    by_plan = {}
    for r in timed.records:
        by_plan.setdefault(f"plan{r['plan']}", r["launches"])
    if by_plan["plan0"] == by_plan[f"plan{len(timed.plans) - 1}"]:
        raise AssertionError(f"plan_train_elastic: the same launches "
                             f"under the first and the last plan "
                             f"{by_plan}")
    res = {"phase": "plan_train_elastic", "arch": cfg.name,
           "layers": cfg.n_layers, "d_model": cfg.d_model,
           "seq": args.seq, "global_batch": plan0.global_batch,
           "argv": ELASTIC_ARGS, "init_s": init_s,
           "plans": [[(r.device, r.m, r.ell, round(r.state_ratio, 4))
                      for r in p.ranks] for p in timed.plans],
           "rank_calls": [_rank_calls(engine.schedule, p)
                          for p in timed.plans],
           "events": [_event(e) for e in events],
           "migrations": migrations,
           "steps": [{k: v for k, v in r.items() if k != "launches"}
                     for r in timed.records],
           "per_plan": _per_plan_ms(timed.records),
           "launches_per_step": by_plan,
           "printed": [ln for ln in printed.getvalue().splitlines()
                       if not ln.startswith(("  rank", "Plan["))]}
    del engine, timed, state
    torch.cuda.empty_cache()
    emit(res)
    return by_plan


def _elastic_replay(cfg, args, plan0, events, blocks) -> dict:
    """A loopback engine on ``plan0`` from the fleet's seed, migrated
    after each adopted event's step to its new plan (as the fleet was):
    the losses and the final state on the host."""
    mk = dict(substrate="loopback", schedule=args.ga_mode,
              adam=AdamConfig(lr=args.lr), seq_len=args.seq,
              device=args.device)
    engine = build_train_step(cfg, plan0, **mk)
    state = engine.init_state(
        torch.Generator(args.device).manual_seed(args.seed))
    moves = {ev.step: ev.new_plan for ev in events if ev.adopted}
    losses = []
    for i, blk in enumerate(blocks):
        state, loss = engine.step(state, blk)
        losses.append(loss)
        if i + 1 in moves:
            new = build_train_step(cfg, moves[i + 1], **mk)
            state = elastic.migrate_state(engine, state, new)
            engine = new
    export = {k: v if k == "step" else M.tree_map(v, lambda _, t: t.cpu())
              for k, v in engine.export_state(state).items()}
    del engine, state
    torch.cuda.empty_cache()
    return {"losses": losses, "export": export}


@_phase
def phase_train_elastic_multiproc() -> dict:
    """The elastic runtime on the process fleet with wall-clock telemetry:
    gpt-1.3b at full width on ELASTIC_MP_LAYERS layers, two worker
    processes on a ring (pipe plane, comm sanitizer armed), the plan
    ``launch.train.solve_plan`` solves from wall-clock models and the
    ``WallClockOracle`` of ``elastic_knobs``; rank 0 three times slower
    (its worker sleeps) from step 2, until ELASTIC_MP_AFTER steps after the
    first adopted replan (at most ``--steps``).  Fails unless an adopted
    replan sheds batch off rank 0, the refit models rank 0 at least 2x
    slower than rank 1, each migration leaves the state equal bit for
    bit, each step's worker launches are the plan in force's, all bf16,
    and a loopback engine that takes the same blocks and migrates at the
    same steps ends with the fleet's losses and state, bit for bit."""
    args = train_launch.parser().parse_args(ELASTIC_MP_ARGS)
    if torch.cuda.memory_allocated() > 2**30:
        raise AssertionError("train_elastic_multiproc: earlier phases "
                             f"still hold {torch.cuda.memory_allocated()}"
                             " B")
    cfg = dataclasses.replace(get_arch(args.arch),
                              n_layers=ELASTIC_MP_LAYERS)
    printed = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        cfg, plan0, cm = train_launch.solve_plan(args, cfg)
        knobs, on_step = train_launch.elastic_knobs(args, cm)
    profile_s = time.perf_counter() - t0
    stream = SyntheticStream(DataConfig(cfg.vocab_size, args.seq,
                                        seed=args.seed))
    blocks = [stream.sample(i, plan0.global_batch)
              for i in range(args.steps)]
    per_call = _train_kernel_calls(cfg)
    plans, records, migrations, prev = [plan0], [], [], None
    with _MemPoll() as mem, _checked_migrations(migrations):
        t0 = time.perf_counter()
        engine = build_train_step(
            cfg, plan0, schedule=args.ga_mode, substrate="multiproc",
            adam=AdamConfig(lr=args.lr), seq_len=args.seq,
            device=args.device, topology="ring", transport=MP_TRANSPORT,
            sanitize=True, **knobs)
        try:
            start_s = time.perf_counter() - t0
            _progress("train_elastic_multiproc start", t0)
            state = engine.init_state(
                torch.Generator(args.device).manual_seed(args.seed))
            adopted_at = None
            for i, blk in enumerate(blocks):
                if adopted_at is not None and \
                        i - adopted_at >= ELASTIC_MP_AFTER:
                    break
                with contextlib.redirect_stdout(printed):
                    on_step(i)
                inner, plan = engine.engine, engine.plan
                n_events = len(engine.events)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, loss = engine.step(state, blk)
                torch.cuda.synchronize()
                _progress(f"train_elastic_multiproc step {i}", t0)
                calls = _rank_calls(engine.schedule, plan)
                want = {n: c * calls for n, c in per_call.items()}
                want.update({
                    "flash_attention/bf16-mma": want["flash_attention"],
                    "flash_attention/fp32-fma": 0,
                    "flash_bwd/bf16-mma": 2 * want["flash_bwd_dq"],
                    "flash_bwd/fp32-fma": 0})
                got = dict(inner.last_step_launches)
                bad = {k: (got.get(k, 0), n) for k, n in want.items()
                       if got.get(k, 0) != n}
                if bad:
                    raise AssertionError(
                        f"train_elastic_multiproc step {i}: the workers' "
                        f"launches (got, want) {bad}")
                records.append({
                    "step": i, "plan": _plan_index(plans, plan),
                    # a fleet's first step warms its workers up
                    "warmup": inner is not prev,
                    "ms": (time.perf_counter() - t0) * 1e3,
                    "loss": loss, "events": len(engine.events) - n_events,
                    "worker_compute_s": dict(inner.last_step_walls),
                    "samples": {r: list(v) for r, v in
                                inner.last_step_samples.items()},
                    "launches": {k: got.get(k, 0) for k in want}})
                prev = inner
                if adopted_at is None and any(
                        e.adopted for e in engine.events):
                    adopted_at = i + 1
            _plan_index(plans, engine.plan)
            final = {"step": _state_step(state), **{
                part: M.tree_map(engine.engine.substrate.allgather_params(
                    None, part), lambda _, t: t.cpu())
                for part in ("p", "m", "v")}}
            planes = engine.engine.transport_planes()
            cm_end = engine.cm
        finally:
            engine.close()
    events = engine.events
    adopted = [e for e in events if e.adopted]
    slow, fast = (cm_end.per_rank[r].t_fwd.one(1) for r in (0, 1))
    if not adopted or not \
            adopted[0].new_plan.ranks[0].b < plan0.ranks[0].b:
        raise AssertionError(
            f"train_elastic_multiproc: no adopted replan that sheds rank 0: "
            f"{[_event(e) for e in events]}; the first plan's (b, m, "
            f"t_fwd_s, t_bwd_s) "
            f"{[(r.b, r.m, r.t_fwd_s, r.t_bwd_s) for r in plan0.ranks]}, "
            f"refit t_fwd(1) {slow}, {fast}; step ms "
            f"{[round(r['ms'], 1) for r in records]}")
    if not slow > 2.0 * fast:
        raise AssertionError(f"train_elastic_multiproc: refit t_fwd(1) "
                             f"rank 0 {slow}, rank 1 {fast}")
    if len(migrations) != len(adopted):
        raise AssertionError(f"train_elastic_multiproc: {len(migrations)}"
                             f" migrations, {len(adopted)} adopted")
    losses = [r["loss"] for r in records]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"train_elastic_multiproc: losses {losses}")
    t0 = time.perf_counter()
    blocks = blocks[:len(records)]
    replay = _elastic_replay(cfg, args, plan0, events, blocks)
    replay_s = time.perf_counter() - t0
    diff = _state_diff(replay["export"], final)
    bound = None
    if replay["losses"] != losses or diff > 0.0 or \
            replay["export"]["step"] != final["step"]:
        again = _elastic_replay(cfg, args, plan0, events, blocks)
        bound = _state_diff(replay["export"], again["export"])
        del again
        if not (bound > 0.0 and diff <= bound):
            raise AssertionError(
                f"train_elastic_multiproc: losses {losses} against the "
                f"loopback replay's {replay['losses']}, state max diff "
                f"{diff}; two replays differ by {bound}")
    by_plan = {}
    for r in records:
        by_plan.setdefault(f"plan{r['plan']}", r["launches"])
    res = {"phase": "train_elastic_multiproc", "arch": cfg.name,
           "layers": cfg.n_layers, "of_layers": get_arch(args.arch).n_layers,
           "d_model": cfg.d_model, "seq": args.seq,
           "global_batch": plan0.global_batch, "argv": ELASTIC_MP_ARGS,
           "transport": MP_TRANSPORT, "sanitize": True,
           "profile_s": profile_s, "start_s": start_s,
           "plans": [[(r.device, r.m, r.ell, round(r.state_ratio, 4))
                      for r in p.ranks] for p in plans],
           "events": [_event(e) for e in events],
           "migrations": migrations,
           "refit_t_fwd_1_ms": [slow * 1e3, fast * 1e3],
           "steps": [{k: v for k, v in r.items() if k != "launches"}
                     for r in records],
           "per_plan": _per_plan_ms(records),
           "replay_losses": replay["losses"], "replay_s": replay_s,
           "state_max_diff": diff, "loopback_bound": bound,
           "launches_per_step": by_plan, "planes": planes,
           "card_used_gib_max": mem.max / 2**30,
           "host_used_gib_max": None if mem.host_max is None
           else mem.host_max / 2**30,
           "printed": [ln for ln in printed.getvalue().splitlines()
                       if not ln.startswith(("  rank", "Plan["))]}
    emit(res)
    return by_plan


@_phase
def phase_verify_protocol() -> dict:
    """The offline protocol checker's entry point (``python -m
    repro_torch.core.engine.verify``, run here on the machine's host):
    the 132-cell grid on both data planes, the determinism lint on the
    port's data plane, the seeded mutants.  Fails unless it exits 0."""
    t0 = time.perf_counter()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = verify_cli.main([])
    seconds = time.perf_counter() - t0
    grid = verify.verify_grid()
    planes = {}
    for r in grid.reports:
        for p in r.planes:
            planes[p.plane] = planes.get(p.plane, 0) + int(p.ok)
    findings = verify.lint_determinism()
    mutants = verify.run_mutation_harness()
    res = {"phase": "verify_protocol", "rc": rc, "seconds": seconds,
           "grid_cells": len(grid.reports), "checked": grid.checked,
           "rejected_by_construction": grid.rejected,
           "cells_ok_per_plane": planes, "lint_findings": len(findings),
           "mutants": len(mutants.results),
           "mutants_caught": sum(r.detected for r in mutants.results),
           "printed": out.getvalue().splitlines()[-4:]}
    if rc != 0 or not grid.ok or findings or not mutants.ok:
        raise AssertionError(f"verify_protocol: {res}")
    emit(res)
    return res


def _spmd_launches(cfg, microbatches: int, variant: str) -> dict:
    """The kernel launches of an SPMD step: each rank runs every
    microbatch of its padded grid through each element once forward and
    once in the backward's recompute, and the backward kernels once;
    every launch on ``variant``."""
    per = _train_kernel_calls(cfg)
    want = {k: per[k] * microbatches for k in ("flash_attention",
                                               "flash_bwd_dq",
                                               "flash_bwd_dkdv")}
    return {**want, f"flash_attention/{variant}": want["flash_attention"],
            f"flash_bwd/{variant}": 2 * want["flash_bwd_dq"]}


def _spmd_collectives(cfg, rounds: int) -> dict:
    """Per rank and step: each round gathers every unit in its forward
    (the embedding, each stage element, the misc unit in the head, the
    head; misc in the embedding too with learned positions) and again in
    the backward's recompute, and ReduceScatters each gather's gradient
    (no replica all-reduce: the state is sharded over every rank)."""
    units = sum(g.count for g in UnitPlanner(cfg, [1.0]).groups) + \
        int(cfg.learned_pos)
    return {"all_gather": 2 * rounds * units,
            "reduce_scatter": rounds * units, "all_reduce": 0}


def _check_spmd_step(phase: str, rec: list, launches: dict,
                     collectives: dict, backend: str) -> dict:
    """Every rank's record of one step: its launches (summed over the
    ranks) and its collectives as predicted, on ``backend``."""
    got = {}
    for r in rec:
        for k, n in r["launches"].items():
            got[k] = got.get(k, 0) + n
        if r["collectives"] != collectives or r["backend"] != backend:
            raise AssertionError(f"{phase}: rank collectives "
                                 f"{r['collectives']} on {r['backend']}, "
                                 f"expected {collectives} on {backend}")
    got = {k: n for k, n in got.items() if n}
    if got != launches:
        raise AssertionError(f"{phase}: launches {got}, expected {launches}")
    return got


def _check_spmd_dryrun(cfg, mesh, plan, args, records) -> dict:
    """Each rank's p, m and v bytes must be the memory dry-run's for the
    same program (``launch.dryrun.state_bytes`` of a ``CephaloProgram`` on
    the mesh alone), exactly; its collectives of each step the roofline
    analogue's (``roofline.program_collectives``): the counts, the padded
    bytes exactly, the unpadded no more than the run's."""
    prog = CephaloProgram(
        cfg, mesh, ratios=[float(r) for r in
                           normalized_ratios(plan.state_ratios())],
        ell=max(plan.ell_pad, 1), m=max(plan.m_pad, 1), seq=args.seq,
        schedule=args.ga_mode)
    state = {k: v for k, v in dryrun.state_bytes(prog).items() if k != "step"}
    coll = roofline.program_collectives(prog)
    bytes_want = {k: int(v) for k, v in coll.bytes_by_op.items()}
    floor = roofline.program_collectives(prog, padded=False).bytes_by_op
    for i, rec in enumerate(records):
        for r in rec["ranks"]:
            if r["state_bytes"] != state:
                raise AssertionError(f"train_spmd step {i + 1}: the rank's "
                                     f"state bytes {r['state_bytes']}, the "
                                     f"dry-run's {state}")
            got = r["collective_bytes"]
            if r["collectives"] != coll.counts or got != bytes_want or \
                    any(got[k] < floor[k] for k in floor):
                raise AssertionError(
                    f"train_spmd step {i + 1}: collectives "
                    f"{r['collectives']}, {got} B; the analytic "
                    f"{coll.counts}, {bytes_want} B (unpadded {floor})")
    return {"state_bytes": state, "collectives": coll.counts,
            "collective_bytes": bytes_want,
            "collective_bytes_unpadded": floor}


@_phase
def phase_train_spmd() -> dict:
    """The launcher's ``--runtime spmd`` (``launch.train.run_spmd``) on
    gpt-1.3b at full width and depth: the world sized from the card count
    (one rank, mesh (1, 1), NCCL), ``--batch 16 --ell 4`` (4 microbatches
    of 4), layered, 1 warm-up step and SPMD_STEPS timed ones.  Each timed
    step's flash launches, counted in the rank process, and its
    collectives must be what the schedule predicts, all ``bf16-mma``.
    Then, the SPMD world closed, the loopback engine takes the same steps
    on the same plan from the same generator seed: each loss within
    SPMD_REL_TOL relative.  Returns the launches of a timed step."""
    if torch.cuda.memory_allocated() > 2**30:
        raise AssertionError("train_spmd: earlier phases still hold "
                             f"{torch.cuda.memory_allocated()} B")
    args = train_launch.parser().parse_args(SPMD_ARGS)
    cfg = get_arch(TRAIN_ARCH)
    mesh, plan = train_launch.spmd_world(args)
    place = spmd_world.placement("cuda", plan.n)
    if (plan.n, place.backend) != (1, "nccl"):
        raise AssertionError(f"train_spmd: {plan.n} ranks on "
                             f"{place.backend}, expected one on nccl")
    t0 = time.perf_counter()
    records = train_launch.run_spmd(args)
    run_s = time.perf_counter() - t0
    _progress("train_spmd spmd", t0)
    ell = plan.ranks[0].ell
    want = _spmd_launches(cfg, ell * plan.n, "bf16-mma")
    colls = _spmd_collectives(cfg, len(get_schedule("layered").chunks(ell)))
    for i, rec in enumerate(records[1:]):
        _check_spmd_step(f"train_spmd step {i + 1}", rec["ranks"], want,
                         colls, "nccl")
    dry = _check_spmd_dryrun(cfg, mesh, plan, args, records[1:])
    losses = [rec["loss"] for rec in records]
    step_ms = [rec["step_ms"] for rec in records[1:]]
    # the loopback engine on the same plan, blocks and seed
    t0 = time.perf_counter()
    engine = build_train_step(cfg, plan, substrate="loopback",
                              schedule="layered", seq_len=args.seq,
                              adam=AdamConfig(lr=args.lr))
    state = engine.init_state(
        torch.Generator(device="cuda").manual_seed(args.seed))
    stream = SyntheticStream(DataConfig(cfg.vocab_size, args.seq,
                                        seed=args.seed))
    ref, ref_ms = [], []
    for step in range(args.steps):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, loss = engine.step(state, stream.sample(step,
                                                       plan.global_batch))
        torch.cuda.synchronize()
        ref.append(loss)
        if step:
            ref_ms.append((time.perf_counter() - t1) * 1e3)
    del engine, state
    torch.cuda.empty_cache()
    _progress("train_spmd loopback", t0)
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref)]
    if not (all(np.isfinite(losses)) and max(rel) <= SPMD_REL_TOL):
        raise AssertionError(f"train_spmd: losses {losses} against the "
                             f"loopback's {ref}: relative {rel}")
    mean_ms = float(np.mean(step_ms))
    rank = records[-1]["ranks"][0]
    emit({"phase": "train_spmd", "arch": cfg.name, "layers": cfg.n_layers,
          "d_model": cfg.d_model, "params": sum(
              g.layout.size * g.count
              for g in UnitPlanner(cfg, [1.0]).groups),
          "seq": args.seq, "global_batch": plan.global_batch,
          "mesh": mesh.shape, "ranks": plan.n, "ell": ell,
          "m": plan.ranks[0].m, "backend": rank["backend"],
          "device": rank["device"], "schedule": "layered",
          "run_s": run_s, "losses": losses, "step_ms": step_ms,
          "mean_step_ms": mean_ms,
          "samples_s": plan.global_batch / (mean_ms / 1e3),
          "tokens_s": plan.global_batch * args.seq / (mean_ms / 1e3),
          "rank_step_s": [rec["ranks"][0]["seconds"]
                          for rec in records[1:]],
          "peak_mem_gib": max(rec["ranks"][0]["peak_bytes"]
                              for rec in records[1:]) / 2**30,
          "launches_per_step": rank["launches"],
          "collectives_per_step": rank["collectives"],
          "loopback": {"losses": ref, "step_ms": ref_ms,
                       "mean_step_ms": float(np.mean(ref_ms))},
          "loss_rel_diff": rel, "tolerance": SPMD_REL_TOL,
          "dryrun": dry,
          "roofline_step": _roofline(cfg, "train", args.seq,
                                     plan.global_batch, mean_ms / 1e3)})
    return {k: rank["launches"][k] for k in ("flash_attention",
                                             "flash_bwd_dq",
                                             "flash_bwd_dkdv")}


def _seqshard_want(cfg, n: int) -> tuple:
    """(kernel launches, launches by head count) a rank's tensor-parallel
    prefill must make: the flash kernel once an attention layer at the
    rank's query and KV heads, or the SSD scan once an SSM layer at its
    heads, all bf16."""
    if cfg.is_ssm:
        heads = cfg.d_inner // cfg.ssm_head_dim // n
        return ({"ssd_scan": cfg.n_layers,
                 "ssd_scan/bf16-mma": cfg.n_layers},
                {"flash_attention": {},
                 "ssd_scan": {str(heads): cfg.n_layers}})
    heads = str((cfg.n_heads // n, cfg.n_kv_heads // n))
    return ({"flash_attention": cfg.n_layers,
             "flash_attention/bf16-mma": cfg.n_layers},
            {"flash_attention": {heads: cfg.n_layers}, "ssd_scan": {}})


def _check_seqshard(cfg, out, batch: int, prompt: int, gen: int,
                    run_s: float) -> dict:
    """The checks of :func:`phase_serve_seqshard` on one model's payloads;
    emits its line and returns each rank's prefill launches."""
    name = f"serve_seqshard {cfg.name}"
    whole = out[0].arrays["whole_logits"]     # fp32, (gen - 1, B, V)
    # the tokens each step of the unsharded decode was fed, (gen - 1, B)
    fed = out[0].arrays["whole_tokens"][:, :-1].T
    want_bytes = dryrun.serving_bytes(cfg, SEQSHARD_MESH, batch,
                                      prompt + gen)
    want, want_heads = _seqshard_want(cfg, SEQSHARD_MESH.size)
    errs, agree, bf16_errs, dropped_errs, bf16_rows = [], 0, [], [], 0
    whole_routes = out[0].arrays["whole_routes"]   # (gen - 1, layers, B, K)
    # the prefill, block by block: rank 0's unsharded blocks fed the split
    # prefill's inputs to them, its embedding, logits and every cache leaf
    # (layer by layer) within SEQSHARD_BF16_TOL of the split's
    pre = out[0].meta["prefill_check"]
    pre_errs = {"embed": pre["embed"], "blocks": max(pre["blocks"]),
                "logits": pre["logits"],
                "caches": max(pre["caches"].values())}
    if not max(pre_errs.values()) <= SEQSHARD_BF16_TOL:
        raise AssertionError(f"{name}: the split prefill differs from the "
                             f"unsharded one fed its inputs by {pre_errs} "
                             f"> {SEQSHARD_BF16_TOL}: {pre}")
    top2 = np.sort(whole, axis=-1)[..., -2:]
    margin = top2[..., 1] - top2[..., 0]
    for p in out:
        logits, meta = p.arrays["check_logits"], p.meta
        rank = meta["rank"]
        r = slice(*meta["rows"])
        bf16_errs.append([])
        if not np.array_equal(p.arrays["tokens"], out[0].arrays["tokens"]):
            raise AssertionError(f"{name} rank {rank}: bf16 tokens differ "
                                 f"from rank 0's")
        if logits.shape != whole.shape or not np.isfinite(logits).all():
            raise AssertionError(f"{name} rank {rank}: logits "
                                 f"{logits.shape}, finite "
                                 f"{np.isfinite(logits).all()}")
        for i in range(whole.shape[0]):
            scale = float(np.abs(whole[i]).max())
            bound = SEQSHARD_TOL * scale
            err = float(np.abs(logits[i] - whole[i]).max())
            errs.append(err / scale)
            if not err <= bound:
                raise AssertionError(f"{name} rank {rank} step {i}: logits "
                                     f"differ by {err} > {bound}")
            sure = margin[i] > bound
            if not (logits[i].argmax(-1) == whole[i].argmax(-1))[sure].all():
                raise AssertionError(f"{name} rank {rank} step {i}: greedy "
                                     f"tokens differ")
            agree += int(sure.sum())
        # the bf16 decode within SEQSHARD_BF16_TOL of the fp32 one, on the
        # rows whose fed tokens and whose experts at every MoE layer have
        # been the fp32 decode's at every step so far
        same = np.cumprod(p.arrays["tokens"][:, :-1].T == fed[:, r], axis=0)
        routed = np.cumprod((p.arrays["routes"] == whole_routes[:, :, r]
                             ).all(axis=(1, 3)), axis=0)
        for i in range(whole.shape[0]):
            rows = (same[i] * routed[i]).astype(bool)
            if not rows.any():
                continue
            scale = float(np.abs(whole[i]).max())
            err = float(np.abs(p.arrays["logits"][i][rows] -
                               whole[i][r][rows]).max()) / scale
            bf16_errs[-1].append(err)
            bf16_rows += int(rows.sum())
            if not err <= SEQSHARD_BF16_TOL:
                raise AssertionError(
                    f"{name} rank {rank} step {i}: bf16 logits differ by "
                    f"{err} of max|logits| > {SEQSHARD_BF16_TOL}; by step "
                    f"{bf16_errs}")
        if not bf16_errs[-1]:
            raise AssertionError(f"{name} rank {rank}: no bf16 step "
                                 f"checked")
        dropped = float(np.abs(p.arrays["dropped_logits"] - whole[0][r]
                               ).max()) / float(np.abs(whole[0]).max())
        dropped_errs.append(dropped)
        if not dropped > SEQSHARD_BF16_TOL:
            raise AssertionError(
                f"{name} rank {rank}: the partial sums skipped move the "
                f"logits by {dropped} of max|logits|, within the bf16 limit "
                f"{SEQSHARD_BF16_TOL}")
        got = {k: n for k, n in meta["launches"].items() if n}
        if got != want or meta["launch_heads"] != want_heads:
            raise AssertionError(
                f"{name} rank {rank}: prefill launches {got}, by heads "
                f"{meta['launch_heads']}; expected {want}, {want_heads}")
        if (meta["weight_bytes"], meta["cache_bytes"]) != \
                (want_bytes["weights"], want_bytes["cache"]):
            raise AssertionError(
                f"{name} rank {rank}: weights {meta['weight_bytes']} B, "
                f"caches {meta['cache_bytes']} B; the dry-run's "
                f"{want_bytes}")
    steps = gen - 1
    meta0 = out[0].meta
    shard_s = max(p.meta["decode_s"] for p in out)
    prefill_s = max(p.meta["prefill_s"] for p in out)
    n = SEQSHARD_MESH.size
    emit({"phase": "serve_seqshard", "arch": cfg.name, "seconds": run_s,
          "layers": cfg.n_layers, "d_model": cfg.d_model,
          "vocab": cfg.vocab_size, "batch": batch, "prompt": prompt,
          "gen": gen, "cache_slots": prompt + gen,
          "mesh": SEQSHARD_MESH.shape,
          "note": "two ranks share one card over gloo through pinned host "
                  "copies: a check of correctness, not a cross-card speed",
          "prefill_ms": [p.meta["prefill_s"] * 1e3 for p in out],
          "decode_tok_s_sharded": steps * batch / shard_s,
          "check_fp32_decode_tok_s": {
              "unsharded": steps * batch / meta0["whole_decode_s"],
              "sharded": steps * batch / max(p.meta["check_decode_s"]
                                             for p in out)},
          "prefill_collectives": meta0["prefill_collectives"],
          "prefill_host_bytes": [p.meta["prefill_host_bytes"] for p in out],
          "collectives_per_step": {
              "merge": {k: c / steps for k, c in
                        meta0["collectives"].items()},
              "tensor_parallel": {k: c / steps for k, c in
                                  meta0["tp_collectives"].items()}},
          "collective_bytes_per_step": {
              k: c / steps for k, c in meta0["collective_bytes"].items()},
          "host_bytes_per_step": [p.meta["host_bytes"] / steps
                                  for p in out],
          "weight_bytes": [p.meta["weight_bytes"] for p in out],
          "cache_bytes": [p.meta["cache_bytes"] for p in out],
          "dryrun_bytes": want_bytes,
          "rank_peak_gib": [p.meta["peak_bytes"] / 2**30 for p in out],
          "launches": [p.meta["launches"] for p in out],
          "launch_heads": [p.meta["launch_heads"] for p in out],
          "logit_err_over_max": max(errs), "tolerance": SEQSHARD_TOL,
          "greedy_rows_checked": agree,
          "bf16_logit_err_over_max": max(x for e in bf16_errs for x in e),
          "bf16_rows_checked": bf16_rows,
          "bf16_tolerance": SEQSHARD_BF16_TOL,
          "bf16_logit_err_by_rank_step": bf16_errs,
          "route_agreement_by_step": (
              (out[0].arrays["routes"] == whole_routes).all(axis=(1, 3))
              .mean(axis=1).tolist()),
          "prefill_block_by_block_err_over_max": pre_errs,
          "prefill_block_err_by_block": pre["blocks"],
          "prefill_cache_err_by_leaf": pre["caches"],
          "dropped_sums_err_over_max": dropped_errs,
          "tokens_seq0": out[0].arrays["tokens"][0].tolist(),
          # the H100's terms for a tensor-parallel pair on NVLink
          "roofline_prefill_rank": _roofline(
              cfg, "prefill", prompt, batch, prefill_s, chips=n),
          "roofline_decode_token": _roofline(
              cfg, "decode", prompt + gen, batch, shard_s / steps,
              chips=n)})
    kind = "ssd_scan" if cfg.is_ssm else "flash_attention"
    return {f"rank{p.meta['rank']}": p.meta["launches"][kind] for p in out}


@_phase
def phase_serve_seqshard() -> dict:
    """Tensor-parallel serving through ``launch.serving.serve_sharded``
    (the reference's ``build_prefill`` / ``build_decode``) of each of
    SEQSHARD_MODELS at full width, in one world of the two ranks of
    SEQSHARD_MESH, which share the card (gloo over pinned host copies: a
    check of correctness, not of a cross-card path).  Each rank draws the
    weights from one seed on the card and keeps its shard (heads, d_ff,
    experts, vocab, SSM channels over 'model'), prefills through the
    flash or SSD kernel at its heads, its K/V moved to its slots of the
    sequence and its SSM state to its heads, and decodes greedily in bf16,
    issuing the collectives GSPMD would insert.  Then the check against
    the unsharded path, which rank 0 runs on the whole weights: its
    prefill, each block fed the split prefill's input to it, then, in
    fp32 (TF32 off) on fp32 copies of the weights and the prefilled
    caches, the port's parity rule on the card, its greedy decode of the
    gathered whole caches, on whose tokens every rank's sharded decode is
    teacher-forced.  Fails unless, for each model, the split prefill's
    embedding, block outputs, last-position logits and every leaf of its
    caches gathered from the ranks' shards are within SEQSHARD_BF16_TOL of
    the unsharded blocks', every decode step's logits on
    every rank are within SEQSHARD_TOL of max|logits| of the unsharded
    ones, the greedy tokens agree wherever the unsharded top-2 margin
    exceeds that bound, each rank's bf16 tokens are the same, the bf16
    decode's logits are within SEQSHARD_BF16_TOL of the unsharded fp32
    ones on every row whose fed tokens and expert choices agree so far
    (one step at least), the first step with the partial sums skipped
    moves them by more than that limit, each rank's prefill launched the
    flash or SSD kernel once a layer at its heads (``bf16-mma``) and
    nothing else, and each rank's weights and caches hold the memory
    dry-run's per-rank
    bytes exactly.  Returns each model's ranks' launches."""
    held = torch.cuda.memory_allocated()
    if held > 2**30:
        raise AssertionError(f"serve_seqshard: {held} B still held by "
                             f"earlier phases")
    place = spmd_world.placement("cuda", SEQSHARD_MESH.size)
    if (place.backend, place.staged) != ("gloo", True):
        raise AssertionError(f"serve_seqshard: {place}")
    t_phase = time.perf_counter()
    launches = {}
    with spmd_world.World(SEQSHARD_MESH, "cuda") as world:
        start_s = time.perf_counter() - t_phase
        for arch, layers, batch, prompt, gen in SEQSHARD_MODELS:
            cfg = get_arch(arch)
            if layers:
                cfg = dataclasses.replace(cfg, n_layers=layers)
            prompts = np.random.default_rng(0).integers(
                0, cfg.vocab_size, (batch, prompt))
            t0 = time.perf_counter()
            out = serving.serve_sharded(cfg, prompts, gen, SEQSHARD_MESH,
                                        "cuda", seed=0, check=True,
                                        world=world)
            run_s = time.perf_counter() - t0
            _progress(f"serve_seqshard {arch}", t0)
            launches[arch] = _check_seqshard(cfg, out, batch, prompt, gen,
                                             run_s)
    emit({"phase": "serve_seqshard_world", "backend": place.backend,
          "devices": place.devices, "world_start_s": start_s,
          "seconds": time.perf_counter() - t_phase})
    torch.cuda.empty_cache()
    return launches


def _m_rel(got: dict, want: dict) -> float:
    """max over the leaves of |got - want| / |want| (2-norms).  After one
    step Adam's m is (1 - b1) g: this holds the gradient, its scale
    included, which p after a first step (lr sign(g)) cannot show."""
    worst = 0.0
    for a, b in zip(fsdp.tree_flatten(got)[0], fsdp.tree_flatten(want)[0]):
        a, b = a.double(), b.double()
        d, nb = (a - b).norm().item(), b.norm().item()
        worst = max(worst, d / nb if nb else d)
    return worst


def _p_close(got: dict, want: dict, v: dict, bound: float) -> tuple:
    """(max |got - want| over the params where Adam's steps were well
    conditioned — sqrt(v_hat) >= 1e-6, 100x Adam's eps — and over all).
    Where a grad is near 1e-8 an fp32-level difference of it moves p by
    a fraction of lr; no element may be more than ``bound`` apart."""
    well_err, all_err = 0.0, 0.0
    for a, b, vv in zip(fsdp.tree_flatten(got)[0], fsdp.tree_flatten(want)[0],
                        fsdp.tree_flatten(v)[0]):
        e = (a.float() - b.float()).abs()
        well = torch.sqrt(vv / (1 - AdamConfig().b2)) >= 1e-6
        all_err = max(all_err, e.max().item())
        if well.any():
            well_err = max(well_err, e[well].max().item())
    if all_err > bound:
        raise AssertionError(f"p differs by {all_err} > {bound}")
    return well_err, all_err


@_phase
def phase_train_spmd_shared() -> dict:
    """Two uneven ranks of the SPMD runtime on the one card: gpt-1.3b at
    full width on SHARED_LAYERS layers, fp32 (TF32 off), seq 512, the
    parity matrix's plan (SHARED_RANKS).  The ranks share the card, so
    they run gloo over pinned host copies.  Per schedule
    (SHARED_SCHEDULES), SHARED_STEPS steps from a seeded generator
    against the loopback engine's on the card: each loss within
    SHARED_LOSS_TOL, p after the steps within SHARED_P_TOL where Adam was
    well conditioned, Adam's m within SHARED_M_TOL relative (it carries
    the gradients' scale, which a first step's p does not); each step's
    collectives and launches as the
    schedule predicts, all ``fp32-fma``.  Then the state migrates from
    the last schedule's world to the loopback engine and to a second
    SPMD world with the ratios swapped: both bit for bit.  Returns the
    launches that the ranks counted in a step."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_arch(TRAIN_ARCH), n_layers=SHARED_LAYERS,
                              dtype="float32")
    ranks = [RankPlan(i, d, m=m, ell=ell, state_ratio=r)
             for i, (d, m, ell, r) in enumerate(SHARED_RANKS)]
    plan = Plan(model=cfg.name, cluster="spmd-1-gpu",
                global_batch=sum(r.b for r in ranks), ranks=ranks)
    place = spmd_world.placement("cuda", plan.n)
    if (place.backend, place.staged) != ("gloo", True):
        raise AssertionError(f"train_spmd_shared: {place}")
    stream = SyntheticStream(DataConfig(cfg.vocab_size, TRAIN_SEQ, seed=0))
    blocks = [stream.sample(i, plan.global_batch)
              for i in range(SHARED_STEPS)]
    microbatches = plan.n * max(plan.ell_pad, 1)
    want = _spmd_launches(cfg, microbatches, "fp32-fma")
    lr = AdamConfig().lr
    res = {"phase": "train_spmd_shared", "arch": cfg.name,
           "layers": cfg.n_layers, "d_model": cfg.d_model,
           "dtype": cfg.dtype, "seq": TRAIN_SEQ, "ranks": SHARED_RANKS,
           "global_batch": plan.global_batch, "backend": place.backend,
           "devices": place.devices, "expected_launches_per_step": want}

    def run(substrate, sched):
        engine = build_train_step(cfg, plan, substrate=substrate,
                                  schedule=sched, seq_len=TRAIN_SEQ)
        t0 = time.perf_counter()
        state = engine.init_state(
            torch.Generator(device="cuda").manual_seed(0))
        out = {"init_s": time.perf_counter() - t0, "losses": [],
               "step_ms": [], "records": []}
        for blk in blocks:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, loss = engine.step(state, blk)
            torch.cuda.synchronize()
            out["step_ms"].append((time.perf_counter() - t0) * 1e3)
            out["losses"].append(loss)
            out["records"].append(getattr(engine, "last_step", None))
        return engine, state, out

    def host(exported):
        return {k: v if k == "step" else
                M.tree_map(v, lambda _, t: t.cpu()) for k, v in
                exported.items()}

    spmd = state = None
    try:
        for sched in SHARED_SCHEDULES:
            t0 = time.perf_counter()
            engine, lstate, ref = run("loopback", sched)
            ref_export = host(engine.export_state(lstate))
            del engine, lstate
            torch.cuda.empty_cache()
            if spmd is not None:
                spmd.close()
            torch.cuda.reset_peak_memory_stats()
            with _MemPoll() as mem:
                t1 = time.perf_counter()
                spmd, state, got = run("shard_map", sched)
                start_s = time.perf_counter() - t1 - got["init_s"] - \
                    sum(got["step_ms"]) / 1e3
                export = spmd.export_state(state)
            rounds = len(get_schedule(sched).chunks(max(plan.ell_pad, 1)))
            colls = _spmd_collectives(cfg, rounds)
            for i, rec in enumerate(got["records"]):
                launches = _check_spmd_step(
                    f"train_spmd_shared {sched} step {i}", rec, want, colls,
                    "gloo")
            loss_diff = max(abs(a - b) for a, b in zip(got["losses"],
                                                       ref["losses"]))
            if not loss_diff <= SHARED_LOSS_TOL:
                raise AssertionError(
                    f"train_spmd_shared {sched}: losses {got['losses']} "
                    f"against the loopback's {ref['losses']}")
            p_well, p_all = _p_close(export["p"], ref_export["p"],
                                     ref_export["v"],
                                     2 * lr * SHARED_STEPS)
            if not p_well <= SHARED_P_TOL:
                raise AssertionError(f"train_spmd_shared {sched}: p "
                                     f"differs by {p_well}")
            m_rel = _m_rel(export["m"], ref_export["m"])
            if not m_rel <= SHARED_M_TOL:
                raise AssertionError(f"train_spmd_shared {sched}: m "
                                     f"differs by {m_rel} relative")
            res[sched] = {
                "losses": got["losses"], "loopback_losses": ref["losses"],
                "loss_max_diff": loss_diff, "p_max_diff_well": p_well,
                "p_max_diff_all": p_all, "m_rel_diff": m_rel,
                "m_tolerance": SHARED_M_TOL, "world_start_s": start_s,
                "init_s": got["init_s"], "step_ms": got["step_ms"],
                "loopback_step_ms": ref["step_ms"],
                "rank_step_s": [[r["seconds"] for r in rec]
                                for rec in got["records"]],
                "host_bytes_per_step": [sum(r["host_bytes"] for r in rec)
                                        for rec in got["records"]],
                "rank_peak_gib": [max(r["peak_bytes"] for r in rec) / 2**30
                                  for rec in got["records"]],
                "collectives_per_step": got["records"][-1][0]["collectives"],
                "expected_collectives": colls,
                "card_used_gib_max": mem.max / 2**30,
                "host_used_gib_max": None if mem.host_max is None
                else mem.host_max / 2**30,
                "seconds": time.perf_counter() - t0}
            _progress(f"train_spmd_shared {sched}", t0)
        # migrations from the last world (its export above is
        # migrate_state's first half): to the loopback engine and to a
        # second world with the ratios swapped, bit for bit
        t0 = time.perf_counter()
        loop = build_train_step(cfg, plan, substrate="loopback",
                                seq_len=TRAIN_SEQ)
        moved = host(loop.export_state(loop.import_state(export)))
        diff_loop = _state_diff(export, moved)
        steps = [moved["step"]]
        del loop, moved
        torch.cuda.empty_cache()
        swapped = dataclasses.replace(plan, ranks=[
            dataclasses.replace(r, state_ratio=SHARED_RANKS[1 - i][3])
            for i, r in enumerate(ranks)])
        with build_train_step(cfg, swapped, substrate="shard_map",
                              seq_len=TRAIN_SEQ) as other:
            moved = other.export_state(other.import_state(export))
            diff_swap = _state_diff(export, moved)
            steps.append(moved["step"])
            del moved
        if diff_loop != 0.0 or diff_swap != 0.0 or \
                steps != [export["step"]] * 2:
            raise AssertionError(f"train_spmd_shared: migrations differ by "
                                 f"{diff_loop} (loopback), {diff_swap} "
                                 f"(swapped ratios); steps {steps}")
        res["migration"] = {"to_loopback_max_diff": diff_loop,
                            "to_swapped_max_diff": diff_swap,
                            "step": export["step"],
                            "seconds": time.perf_counter() - t0}
    finally:
        if spmd is not None:
            spmd.close()
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = tf32
    torch.cuda.empty_cache()
    emit(res)
    return {k: launches[k] for k in ("flash_attention", "flash_bwd_dq",
                                     "flash_bwd_dkdv")}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    dev = phase_device()
    if sys.argv[1:] == ["--sdpa-backends"]:
        emit({"phase": "sdpa_backends", "shape": MOE_TRAIN_SHAPE,
              **_sdpa_backends(MOE_TRAIN_SHAPE)})
        return 0
    phase_build()
    flash = phase_kernel()
    ssd = phase_ssd_kernel()
    llama = get_arch("llama-7b")
    flash_launches = phase_serve(
        "llama-7b", SERVE_BATCH, SERVE_PROMPT, SERVE_GEN, "serve",
        {"flash_attention": llama.n_layers, "ssd_scan": 0})
    ssd_launches = phase_serve(
        MAMBA, MAMBA_BATCH, MAMBA_PROMPT, MAMBA_GEN, "serve_mamba2",
        {"flash_attention": 0, "ssd_scan": get_arch(MAMBA).n_layers})
    moe_launches = {
        "serve_qwen3_moe": phase_serve(
            QWEN3, SERVE_BATCH, SERVE_PROMPT, SERVE_GEN, "serve_qwen3_moe",
            {"flash_attention": get_arch(QWEN3).n_layers, "ssd_scan": 0}),
        "serve_mixtral": phase_serve(
            MIXTRAL, SERVE_BATCH, SERVE_PROMPT, SERVE_GEN, "serve_mixtral",
            {"flash_attention": MIXTRAL_SERVE_LAYERS, "ssd_scan": 0},
            layers=MIXTRAL_SERVE_LAYERS)}
    zamba2 = dataclasses.replace(get_arch(ZAMBA2),
                                 n_layers=ZAMBA2_SERVE_LAYERS)
    pair_launches = {
        "serve_gemma2": phase_serve(
            GEMMA2, GEMMA2_BATCH, GEMMA2_PROMPT, SERVE_GEN, "serve_gemma2",
            {"flash_attention": get_arch(GEMMA2).n_layers, "ssd_scan": 0}),
        "serve_zamba2": phase_serve(
            ZAMBA2, MAMBA_BATCH, MAMBA_PROMPT, MAMBA_GEN, "serve_zamba2",
            {"flash_attention": zamba2.n_layers // zamba2.hybrid_attn_every,
             "ssd_scan": zamba2.n_layers}, layers=ZAMBA2_SERVE_LAYERS),
        "serve_yi34b": phase_serve(
            YI, SERVE_BATCH, SERVE_PROMPT, SERVE_GEN, "serve_yi34b",
            {"flash_attention": get_arch(YI).n_layers, "ssd_scan": 0})}
    frontend_launches = {
        "serve_" + arch.split("-")[0]: phase_serve(
            arch, batch, prompt, SERVE_GEN, "serve_" + arch.split("-")[0],
            {"flash_attention": get_arch(arch).n_layers, "ssd_scan": 0})
        for arch, (batch, prompt) in FRONTEND_SERVE.items()}
    phase_consistency("llama-7b", 2, 256)
    phase_consistency(MAMBA, 2, 1024)
    phase_consistency(QWEN3, 2, 256, layers=QWEN3_CONSISTENCY_LAYERS)
    for arch, (layers, seq) in PAIR_CONSISTENCY.items():
        phase_consistency(arch, 2, seq, layers=layers)
    for arch, (layers, seq) in FRONTEND_CONSISTENCY.items():
        phase_consistency(arch, 2, seq, layers=layers)
    bwd = phase_flash_bwd()
    ssd_bwd = phase_ssd_bwd()
    phase_train_grads()
    bwd_launches = phase_train()
    moe_launches["train_moe"] = phase_train(QWEN3, MOE_TRAIN_LAYERS,
                                            "train_moe")
    for arch, layers in PAIR_TRAIN_LAYERS.items():
        phase = "train_" + arch.split("-")[0]
        pair_launches[phase] = phase_train(arch, layers, phase,
                                           TREND_LRS.get(arch, ()))
    fleet_launches = phase_train_multiproc()
    phase_profile()
    plan_launches = phase_plan_train()
    mamba_launches = phase_plan_train_mamba2()
    elastic_launches = phase_plan_train_elastic()
    elastic_mp_launches = phase_train_elastic_multiproc()
    spmd_launches = {"train_spmd": phase_train_spmd(),
                     "train_spmd_shared": phase_train_spmd_shared()}
    seqshard_launches = phase_serve_seqshard()
    phase_verify_protocol()
    emit({"phase": "wall", "seconds": time.perf_counter() - t_start})
    print(dev["nvidia_smi"], flush=True)
    emit({"kernels": [
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/flash_attention/csrc/"
                   "flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/flash_attention.py:93",
         "launches": flash_launches["flash_attention"],
         "launches_planned_step": plan_launches["flash_attention"],
         "launches_moe": {k: v["flash_attention"]
                          for k, v in moe_launches.items()},
         "launches_pair_hybrid": {k: v["flash_attention"]
                                  for k, v in pair_launches.items()},
         "launches_frontend": {k: v["flash_attention"]
                               for k, v in frontend_launches.items()},
         "launches_train_multiproc_step": {
             k: v["flash_attention"] for k, v in fleet_launches.items()},
         "launches_train_elastic": {
             k: v["flash_attention"] for k, v in elastic_launches.items()},
         "launches_train_elastic_multiproc_step": {
             k: v["flash_attention"]
             for k, v in elastic_mp_launches.items()},
         "launches_train_spmd_step": {
             k: v["flash_attention"] for k, v in spmd_launches.items()},
         "launches_serve_sharded": {
             k: v for k, v in seqshard_launches.items()
             if not get_arch(k).is_ssm},
         **flash},
        *({"name": f"flash_bwd_{w}", "route": "cuda",
           "source": "src/repro_torch/kernels/flash_attention/csrc/"
                     "flash_attention_bwd.cu",
           "replaces": None,
           "differentiates":
               "src/repro/kernels/flash_attention/flash_attention.py:93",
           "launches": bwd_launches[f"flash_bwd_{w}"],
           "launches_planned_step": plan_launches[f"flash_bwd_{w}"],
           "launches_train_moe": moe_launches["train_moe"][f"flash_bwd_{w}"],
           "launches_pair_hybrid": {
               k: pair_launches[k][f"flash_bwd_{w}"]
               for k in ("train_gemma2", "train_zamba2")},
           "launches_train_multiproc_step": {
               k: v[f"flash_bwd_{w}"] for k, v in fleet_launches.items()},
           "launches_train_elastic": {
               k: v[f"flash_bwd_{w}"] for k, v in elastic_launches.items()},
           "launches_train_elastic_multiproc_step": {
               k: v[f"flash_bwd_{w}"]
               for k, v in elastic_mp_launches.items()},
           "launches_train_spmd_step": {
               k: v[f"flash_bwd_{w}"] for k, v in spmd_launches.items()},
           **bwd[w]}
          for w in ("dq", "dkdv")),
        {"name": "ssd_scan", "route": "cuda",
         "source": "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
         "replaces": "src/repro/kernels/ssd_scan/ssd_scan.py:72",
         "launches": ssd_launches["ssd_scan"],
         "launches_planned_step": mamba_launches["ssd_scan"],
         "launches_pair_hybrid": {
             k: pair_launches[k]["ssd_scan"]
             for k in ("serve_zamba2", "train_zamba2")},
         "launches_serve_sharded": {
             k: v for k, v in seqshard_launches.items()
             if get_arch(k).is_ssm}, **ssd},
        {"name": "ssd_scan_bwd", "route": "cuda",
         "source": "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan_bwd.cu",
         "replaces": None,
         "differentiates": "src/repro/kernels/ssd_scan/ssd_scan.py:72",
         "launches": mamba_launches["ssd_scan_bwd"] * PLAN_STEPS,
         "launches_planned_step": mamba_launches["ssd_scan_bwd"],
         "launches_pair_hybrid": {
             "train_zamba2": pair_launches["train_zamba2"]["ssd_scan_bwd"]},
         **ssd_bwd}]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": dev["name"],
                                 "count": dev["count"]}})
    _stop_helpers()
    return 0


def _stop_helpers() -> None:
    """Stop the helper processes ``multiprocessing`` started for the run
    (the forkserver the SPMD worlds fork from, the resource tracker),
    which would otherwise end only after this process."""
    from multiprocessing import forkserver, resource_tracker
    for helper in (forkserver._forkserver, resource_tracker._resource_tracker):
        stop = getattr(helper, "_stop", None)
        if stop is not None:
            stop()


if __name__ == "__main__":
    sys.exit(main())
