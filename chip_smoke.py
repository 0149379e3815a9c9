#!/usr/bin/env python3
"""Build and run the PyTorch/CUDA port on one NVIDIA H100, end to end.

    python3 chip_smoke.py

Phases, each printing its own lines (no phase catches its own failure; any
failed check exits non-zero):

1. env     — card name and power limit, torch/CUDA/nvcc versions.
2. build   — compile the nine hand-written CUDA sources from the
             checkout (K1, K2 on its three routes, K3, K2-bwd on its three
             routes, K3-bwd; all but K2's ``simt`` forward source include
             ``csrc/sm90_tf32x3.cuh``), one ``nvcc`` each, all started
             together; ptxas's registers and spills for each kernel and
             instantiation (K2-bwd's ``sm90`` instantiations, up to head dim
             256, must spill 0 bytes; K2's ``sm90`` instantiations must
             get 168 registers, what their setmaxnreg split needs) and any
             wgmma serialisation it reports.
3. kernel  — every kernel against its plain PyTorch version on the card, at
             test shapes and at the main path's shapes, with times beside
             the card's bound and a PyTorch library call.  Every K1 and K3
             row prints the C entry point it launched (K1: float32 through
             3xTF32 on wgmma, bf16 on bf16 wgmma; K3: 3xTF32 on wgmma, bf16
             inputs widened), and one K1 row at the i1 depth K = 30000 is
             held against float64 at the unscaled gate.  K2 runs bf16 at
             head dims that are multiples of 16 on its bf16 tensor-core
             route (``sm90``, each row with the K/V tile and ring depth
             ``sm90_plan`` gives it), float32 on its 3xTF32 tensor-core
             route (``tf32x3``: at head dims 32, 40, 64, 96/64, 128, 160
             and 256, each row also timing ``simt``'s float32 entry at its
             shape and printing its bound at 3xTF32 and at the 67 TFLOP/s
             CUDA-core rate; 128, 96/64 and 160 also at 2 x 1024 tokens),
             and bf16 at other head dims on its CUDA-core route (``simt``);
             every row prints its route and fails if it is not
             the rule's.  K2 also runs at query offsets (``q_offset``, off
             the 64-row tile, with and without a window, Skv = q_offset +
             Sq and beyond it, one shape whose last rows keep no key and
             must be 0) on the ``tf32x3`` and ``sm90`` routes.
4. predict — fit the node (host CPU + card) with ``Profiler``/``fit_linear``
             and a timed host->device copy; no rate is hard-coded.
5. main    — ``HGemms(fitted, device="cuda").execute`` on the paper's
             instance i1 (30000^3, float32): kernel launches counted, the bus
             invariants of the measured timeline held, sampled rows of C
             checked against float64, then the card alone for comparison.
6. serve   — hymba-1.5B at full width (weights from a seed): (a) in float32,
             prefill through K2 (``tf32x3``)/K3 against decode through plain
             torch on a 1300-token prompt, K2 launches counted per route;
             (b) in bfloat16, eight requests dispatched by
             ``PoasDispatcher`` over two groups and served by
             ``ServingEngine``, with K2/K3 launches counted (32 each per
             prefill, every K2 launch on ``sm90``); (c) one bucket's prefill
             and decode steps traced with ``torch.profiler``; then K2 and K3
             held against their plain versions and timed at those runs'
             shapes (at window 0 K2 is also timed against sdpa's
             ``is_causal`` form).
7. train   — hymba-1.5B training: (a) the backward kernels K2-bwd and
             K3-bwd against their plain backwards at test shapes and at the
             training path's shapes, timed beside their bounds and sdpa's
             backward.  Every K2-bwd row prints its route and fails if it is
             not ``route_bwd``'s: bf16 ``sm90`` rows (bf16 wgmma) are held
             against the plain backward that rounds P and dS to bf16 where
             the kernel does, and at relative norm 1e-2 against the float32
             plain backward; float32 rows run ``tf32x3`` at 1e-4 (head
             dims 32, 40, 64, 96/64, 128, 160 and 256; 128, 96/64 and 160
             also at 2 x 1024 tokens), ``simt``'s float32 entry timed beside
             each.  The training-shape rows run each
             kernel twice and require bit-equal gradients; phase 3's offset
             shapes run through K2-bwd on both routes too, twice,
             bit-equal; bf16 at
             head dims in (128, 256] runs ``sm90``'s two-warpgroup kernels
             (144, 160 with GQA 32:8, 192/128, 256 with a window, ragged
             rows and a ``q_offset`` whose last rows keep no key, their dq
             exactly 0), twice, bit-equal, the shared memory the source
             reckons equal to the wrapper's figure; one bf16 row at head
             dim 40 keeps ``simt``'s bf16 entry.  K2's ``lse`` output on
             both tensor-core routes against the plain version's at the
             training shape, K2
             forward and K2-bwd chained through autograd there against
             the plain backward, and K2's forward timed with and without
             ``lse``; (b) a float32 gradient gate: at full width cut to 2
             layers (one global, one windowed) and one 1100-token
             sequence, the loss and every parameter gradient on the card
             through the kernels against the same model on the CPU
             through the plain versions; (c) the path itself: bf16, full
             width and depth, batch 4 x 2048, through the objects
             ``repro_torch.launch.train`` builds, a few AdamW steps with
             every K2/K2-bwd/K3/K3-bwd launch counted per step, ms/step,
             tokens/s, model TFLOP/s, peak memory, one step traced with
             ``torch.profiler`` and the loss head timed alone; (d) a checkpoint round trip through
             ``FaultTolerantRunner`` at the 2-layer cut, bit-equal, with
             the next step's loss equal to the uninterrupted run's.
8. moe     — dbrx-132B (16 experts, top-4) at full width, weights from a
             seed: (a) in float32 cut to 1 layer, a 512-token prefill on
             the card (K2 ``tf32x3``) against the same weights moved to the
             CPU (plain versions): last-token logits at rtol/atol 3e-3 and
             every (token, choice)'s kept (expert, slot) identical; (b) in
             bfloat16 cut to 8 of 40 layers (~54.6 GB of weights), phase 6
             (b)'s traffic through ``PoasDispatcher`` and
             ``ServingEngine``: 16 in-vocabulary tokens per completion, 8
             K2 launches per prefill, all ``sm90``, kept and dropped
             choices per prefill, peak memory; (c) the larger bucket traced
             with ``torch.profiler``, device time by kind (K2, the MoE's
             router, dispatch, expert products and combine); (d) K2 at
             that bucket's shape (48/8 heads of 128, window 0) against its
             plain version, its bound and sdpa's ``is_causal``; (e) the MoE
             layer twice at that shape, bit-equal; (f) ``moe_stack`` of the
             same cut planned by ``TaskGraphDomain`` over phase 4's fitted
             profiles, and phase 7 (d)'s runner re-homed through
             ``remesh(..., scheduler=, lost=)`` with a two-pod
             ``HeteroBatchScheduler``.
9. shard   — the sharded layer (``distributed.context``/``sharding``/
             ``collectives``, ``launch.mesh``) with dbrx-132B's
             expert-parallel MoE: (a) one process, NCCL at world size 1,
             ``make_debug_mesh((1, 1))``: dbrx-132B in bfloat16 at full
             width cut to 4 of 40 layers, phase 6 (b)'s traffic through
             ``PoasDispatcher`` and ``ServingEngine`` first with no mesh,
             then with the same parameters placed by ``shard_params`` under
             ``use_mesh``: each bucket's prefill logits bit-equal, the same
             greedy tokens and kept/dropped pairs, 4 K2 ``sm90`` launches a
             prefill, peak memory; ``compressed_psum_mean`` on a CUDA
             tensor over NCCL in its three modes; (b) two processes on the
             one card over gloo (NCCL puts no two ranks of a communicator
             on one card; gloo all-reduces CUDA tensors through the host),
             mesh ("data", "model") = (1, 2): dbrx-132B in float32 at full
             width cut to 1 layer, each rank holding 8 of the 16 experts,
             phase 8 (a)'s 512-token prefill against an unsharded run of
             the same weights on the card, its largest distance at most
             twice that of phase 8 (a)'s host float32 logits from the
             card's (allclose at rtol = atol = 1e-5 printed), every kept
             (token, choice)'s (expert, slot) identical and each rank
             keeping only its own experts' pairs, K2 ``tf32x3`` launches per
             rank, each rank's peak memory (no time: the two share the
             card and gloo stages the sum through the host); its attention
             is tensor-parallel too (24/4 heads a rank); (c) the same two
             ranks, attention and MLP tensor-parallel over "model":
             qwen2-72b at full width (64/8 heads of 128, d_ff 29568, QKV
             bias) cut to 1 layer, each rank 32/4 heads and 14784 MLP
             columns; in float32 a 512-token prefill's logits against the
             unsharded run on the card as in (b), the yardstick the host's
             float32 prefill of the cut, a training step's loss
             (1e-4) and each rank's gradient shards (1e-3) against the
             unsharded step's slices, K2 and K2-bwd once a rank on
             ``tf32x3``; in bf16 the logits in K2's bf16 band, K2 and K2-bwd
             once a rank on ``sm90``; the heads K2 saw, parameter bytes
             held (equal to the dry run's) and prefill peak per rank
             beside the dry run's prediction (mesh (1, 2), fake ``cuda``
             tensors); (d) the same two ranks, the SSM tensor-parallel:
             mamba2-2.7B at full width (80 SSM heads of 64, state 128) cut
             to 2 layers, 40 heads a rank through K3 / K3-bwd (one K3 a
             layer a prefill, one K3-bwd a layer a step, on 40 heads), the
             gates of (c) and three float32 decode steps held against the
             unsharded decode as the prefill is, bf16 logits in K3's bf16
             band; (e) MLA tensor-parallel: minicpm3-4B at full width cut
             to 2 layers, 20 of 40 heads a rank through K2 / K2-bwd at Dk
             96 / Dv 64, the latent cache whole, the absorbed decode held
             as in (d), bf16 logits in K2's band.  In (c)-(e) the embedding
             and head are vocab-parallel (each rank's V/2 rows and
             columns), and each cut's float32 and bf16 step runs again
             under Megatron-SP (``seq_shard_activations``: 256 of the 512
             rows a rank between the regions): float32 loss and gradient
             shards at (c)'s gates against the unsharded step, bf16 loss
             against the step without SP, the same launches.
10. dryrun — ``launch.dryrun`` and ``launch.hlo_costs`` against the card:
             (a) at world size 1 on fake ``cuda`` tensors, a prediction of
             phase 7 (c)'s training step (hymba-1.5B, bf16, 4 x 2048,
             remat "full", AdamW) and of phase 9 (a)'s largest prefill
             (dbrx-132B bf16 at 4 layers, no mesh), then the same step for
             real on those phases' models under the same accounting: FLOPs
             and collective counts equal, the arguments within 1 % of
             ``memory_allocated`` before the step, the peak within 15 % of
             ``max_memory_allocated`` over it; the predicted H100 roofline
             beside the measured time, and phase 6's prefill busy time and
             phase 7's step time printed for comparison with earlier runs
             (``PERF.md`` §5); (b) on the host, in subprocesses with a time
             limit, started before phase 9 and run behind it at niceness 19
             (so is the first dry run of phases 12 and 13's depth searches):
             the full-config dry run of dbrx-132B ``train_4k`` and
             hymba-1.5B ``long_500k`` on the 16 x 16 mesh (fake process
             group of 256 ranks), records printed, and two tiny cells on
             the (2, 2, 2) mesh traced on fake ``cuda`` and fake ``cpu``
             tensors with equal accounting; three ``train_4k`` cells
             tensor-parallel over "model": stablelm-12b on 16 x 16
             (attention and MLP), mamba2-2.7B on 16 x 16 (the SSM) and
             minicpm3-4B on 32 x 8 (MLA): each one's FLOPs a rank below
             what it took with those layers gathered on every rank (6331,
             1394.356 and 658.830 TFLOP, PERF.md section 6), split into
             the tensor-parallel products, the replicated ones (K/V or
             MLA's down projections), the loss head (V/n columns where n
             divides the vocab), the kernels and the other operators, the
             products equal to the split's from the shapes, and the FLOPs
             a rank held at 412.841, 171.418 and 200.893 TFLOP; stablelm's
             cell again under ``--opt`` (Megatron-SP): the same FLOPs, its
             peak below by at least half of what the saved layer inputs
             take at S rather than S/16, collectives printed beside.
11. moe-train — MoE training, remat "dots", llama4 served: (a) a float32
             gradient gate of dbrx-132B at full width cut to 1 layer, phase 8
             (a)'s 512-token prompt: the loss and every parameter gradient on
             the card (K2 and K2-bwd ``tf32x3``) against the same weights moved
             to the host (plain versions) at phase 7 (b)'s gates, every kept
             (expert, slot) identical; (b) dbrx-132B in bfloat16 cut to 2 of
             40 layers, batch 2 x 2048 (1 x 2048 if the dry run's predicted
             peak passes 72 GiB), remat "full", AdamW with bf16 states,
             through ``launch.train``'s objects: K2's ``lse``, K2-bwd (Dk =
             Dv = 128) and the two chained through autograd at the step's
             attention shape against their plain versions, 4 steps with
             launches and kept/dropped pairs per step, ms/step, tokens/s,
             model TFLOP/s, peak, one step traced by kind (K2, K2-bwd, the
             expert products and the combine forward and backward, the
             optimizer), the dry run held against a step as phase 10 (a)
             holds its cells, the loss and gradients taken twice from one
             state, bit-equal, and once with K2-bwd's plain version in its
             place, every leaf within K2-bwd's bf16 band; (c) phase 7 (c)'s
             hymba-1.5B step under remat "dots" (K2 and K3 still recomputed:
             64 of each a step), one step traced against phase 7 (c)'s "full"
             one, its step 1 loss against phase 7 (c)'s under "full", the dry
             run's prediction of it held as in (b), and one step of (b)'s
             dbrx cut under "dots"; (d) llama4-maverick-400B-A17B in bfloat16
             cut to 2 of 48 layers (one dense, one MoE layer), phase 6 (b)'s
             traffic through ``PoasDispatcher`` and ``ServingEngine`` (2 K2
             launches a prefill, all ``sm90``; kept and dropped pairs; peak),
             the larger bucket traced, and its prefill with K2, with K2's
             plain version and with sdpa on the card (last-token logits and
             the router logits within K2's bf16 band; the tokens routed to
             another expert than through the plain version counted, at most
             twice sdpa's count), and with K2 twice, bit-equal.
12. mla    — minicpm3-4B (MLA: q rank 768, kv rank 256, K2 at Dk 96 / Dv
             64, absorbed-matmul decode over the latent cache): (a) float32
             at full width cut to 2 layers, a 1100-token prefill's
             last-token logits and one loss with every parameter gradient
             on the card (K2 and K2-bwd ``tf32x3``) against the same weights
             on the host (plain versions), then the cut's prefill against
             its decode (phase 6 (a)'s check); (b) bf16 at full width and
             depth (62 layers, 4.26 B params), phase 6 (b)'s traffic
             through ``PoasDispatcher`` and ``ServingEngine``: 62 K2
             ``sm90`` launches a prefill and none in decode, rates, peak,
             the larger bucket traced; (c) bf16 training at full width
             through ``launch.train``'s objects at the largest depth whose
             dry-run peak stays under 66 GiB, batch 4 x 2048, remat
             "full": launches per step, ms/step, tokens/s, model TFLOP/s,
             peak, a traced step, the dry run held as phase 10 (a) holds
             its cells, loss and gradients twice from one state,
             bit-equal; (d) K2 at (b)'s larger prefill and at the
             benchmark's serving cell (4 x 16384 tokens, 40 heads, window
             0; its first 128 and last 256 rows held against the plain
             version) and K2-bwd at (c)'s step against their plain
             versions, timed beside their bounds and sdpa, and which of
             sdpa's backends take Dk != Dv.
13. zoo    — the six configurations no earlier phase runs as models:
             mamba2-2.7B (attention-free, 80 SSM heads at state 128),
             stablelm-12b (32/8 heads of 160), musicgen-medium (24/24
             heads of 64, audio stub), internvl2-26b (48/8 of 128, vision
             stub), qwen2-72b (QKV bias) and deepseek-67b, weights from a
             seed; each through the helpers phase 12 uses: (a) a float32
             gate at full width against the same weights on the host (2
             layers and 600 tokens; 1 layer above d_model 4096, and 512
             tokens above 6144), prefill against decode, launches per
             route as ``route``/``route_bwd`` name them; (b) bf16 serving
             at full width and the largest depth whose weights stay under
             64 GiB (a cut for qwen2-72b and deepseek-67b only), phase 6 (b)'s
             traffic (a stub frontend's bucket shapes as seeded
             embeddings through ``Model`` itself, which the reference's
             serving refuses), one K2 or K3 launch a layer a prefill, none
             in decode, finite logits, rates and peak, mamba2 and
             stablelm traced; (c) for the first four, bf16 training at the
             depth the dry run fits under 66 GiB, launches per step,
             bit-equal reruns, the dry run held; (d) K2 (``sm90``) at
             stablelm's prefill and K2-bwd (``sm90``, head dim 160) at its
             step, with ``simt``'s bf16 entry timed at that shape beside it,
             K3 at mamba2's prefill and K3-bwd at its step, against their
             plain versions, beside their bounds and sdpa.

The second-to-last line is a JSON summary of the kernels; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA card, or run outside the
repository (the import of ``repro_torch`` fails), it exits non-zero and
prints no result.
"""
from __future__ import annotations

import atexit
import dataclasses
import functools
import gc
import importlib
import json
import math
import socket
import os
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.tensor import DTensor
from torch.utils._pytree import tree_flatten

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import (POAS, CopyModel, DeviceProfile,  # noqa: E402
                              HGemms, LinearTimeModel, NO_COPY, Profiler,
                              TaskGraphDomain, cuda_kernel_runner,
                              host_cpu_runner, moe_stack,
                              verify_graph_dependencies)
from repro_torch.checkpoint import store  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.distributed.collectives import (  # noqa: E402
    compressed_psum_mean)
from repro_torch.distributed.context import use_mesh  # noqa: E402
from repro_torch.distributed.elastic import (  # noqa: E402
    FaultTolerantRunner, RunnerConfig)
from repro_torch.distributed.sharding import shard_params  # noqa: E402
from repro_torch.distributed.hetero import (  # noqa: E402
    HeteroBatchScheduler, PodProfile)
from repro_torch.kernels import (flash_attention,  # noqa: E402
                                 flash_attention_bwd, matmul, ssd_chunk,
                                 ssd_chunk_bwd)
from repro_torch.kernels.flash_attention import build as build_k2  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    MAX_HEAD_DIM, ROUTES as K2_ROUTES, _forward as k2_forward,
    _launch as k2_launch, _launch_bwd as k2b_launch, band_pairs,
    build_bwd as build_k2_bwd, build_bwd_sm90 as build_k2_bwd_sm90,
    build_bwd_tf32x3 as build_k2_bwd_tf32x3, bwd_sm90_kernel_smem_bytes,
    bwd_sm90_smem_bytes, bwd_tf32x3_smem_bytes, build_sm90 as build_k2_sm90,
    build_tf32x3 as build_k2_tf32x3, reset_counts as reset_k2_counts, route,
    route_bwd, sm90_plan, tf32x3_kernel_smem_bytes, tf32x3_smem_bytes)
from repro_torch.kernels.matmul import build  # noqa: E402
from repro_torch.kernels.matmul import entry as k1_entry  # noqa: E402
from repro_torch.kernels.ref import (  # noqa: E402
    flash_attention_bwd_ref, flash_attention_ref, matmul_ref,
    ssd_chunk_bwd_ref, ssd_chunk_ref)
from repro_torch.kernels.ssd_chunk import build as build_k3  # noqa: E402
from repro_torch.kernels.ssd_chunk import entry as k3_entry  # noqa: E402
from repro_torch.kernels.ssd_chunk import (  # noqa: E402
    SMEM_LIMIT as k3_smem_limit, build_bwd as build_k3_bwd,
    bwd_heads_per_slice, bwd_kernel_figures, bwd_scratch_floats,
    bwd_smem_bytes, kernel_smem_bytes as k3_kernel_smem,
    smem_bytes as k3_smem)
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.launch.hlo_costs import CostMode  # noqa: E402
from repro_torch.launch.specs import ShapeSpec, input_specs  # noqa: E402
from repro_torch.launch.mesh import make_debug_mesh  # noqa: E402
from repro_torch.models import Model, moe  # noqa: E402
from repro_torch.models import layers as model_layers  # noqa: E402
from repro_torch.models import ssm as model_ssm  # noqa: E402
from repro_torch.models import transformer as model_tf  # noqa: E402
from repro_torch.models.transformer import chunked_xent  # noqa: E402
from repro_torch.serving.engine import (Completion,  # noqa: E402
                                        PoasDispatcher, Request,
                                        ServingEngine)
from repro_torch.training.optim import AdamW, cosine_schedule  # noqa: E402
from repro_torch.training.step import (init_state,  # noqa: E402
                                       make_train_step)

# Paper instance i1 (benchmarks/common.py): the smallest of the six.
M = N = K = 30_000
SAMPLE_ROWS = 64
F32_TOL = (1e-4, 1e-3)    # rtol, atol: tests/test_kernels_matmul.py:34
BF16_TOL = (2e-2, 2e-1)
# NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit.  The
# float32 kernels (K1 f32, K3) run each product as three TF32 products
# (3xTF32), so their operations are held to a third of the TF32 rate.
PEAK = {"float32": (67e12, "67 TFLOP/s fp32 CUDA cores, H100 SXM data sheet"),
        "tf32x3": (495e12 / 3, "495 TFLOP/s TF32 dense tensor cores / 3 "
                               "for 3xTF32, H100 SXM data sheet"),
        "bfloat16": (989e12, "989 TFLOP/s bf16 dense tensor cores, "
                             "H100 SXM data sheet")}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
K2_TOL = {"float32": 2e-5, "bfloat16": 2e-2}   # tests/test_kernels_flash.py:33
K3_TOL = {"float32": 1e-4, "bfloat16": 3e-2}   # tests/test_kernels_ssd.py:34,45
PREFILL_DECODE_TOL = 3e-3                      # tests/test_prefill_decode.py:42
DTYPE_NAME = {torch.float32: "float32", torch.bfloat16: "bfloat16"}
SERVE_ARCH = "hymba-1_5b"
DEV = "cuda"
SERVE_REQUESTS, SERVE_MAX_NEW = 8, 16
SERVE_A_PROMPT = 1300     # tokens of phase (a)'s float32 prompt
# Backward kernels against their plain backwards: float32 sums over up to
# 2048 keys (K2) or 256 positions (K3) taken in another order (observed
# ~1e-6 relative).  K2-bwd's bf16 gradients are f32 sums rounded to bf16 on
# both sides, so they differ by at most one bf16 ulp (<= 2**-7 relative):
# rtol 1e-2 and an atol of 1e-3 times each output's largest magnitude.  The
# sm90 route rounds P and dS to bf16 as MMA operands, as the reference's
# own gradient rounds P (src/repro/models/layers.py:143-146), so its "want"
# is the plain backward rounding at the same places (round_to=bf16); beside
# that band, each of its outputs is held at a relative norm of 1e-2 against
# the float32 plain backward (jax.vjp of the reference in bf16 differs from
# it by 2-4e-3, tests/test_torch_kernels_bwd_sm90.py).
# K3-bwd's bf16 row as K3's forward band.
K2B_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-2, 1e-3)}  # rtol, atol
K2B_NORM = 1e-2
K3B_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
# K2's row log-sum-exp (m * scale + ln l, l a float32 sum of exponentials)
# against the plain version's torch.logsumexp: rtol = atol.
LSE_TOL = 1e-5
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 2048, 4   # step 1 warms up
GATE_TOKENS = 1100        # phase 7 (b): one sequence, > the 1024 window
GATE_LOSS_RTOL, GATE_LEAF_RTOL = 1e-4, 1e-3
MOE_ARCH = "dbrx-132b"
# 8 of dbrx's 40 layers: a layer holds 3.171 G expert and 0.088 G attention
# parameters (6.52 GB in bf16), embedding and head 2.47 GB, so 8 layers
# are ~54.6 GB of the card's 80 GB and all 40 would need ~263 GB.
MOE_LAYERS = 8
MOE_GATE_TOKENS = 512     # phase 8 (a): one float32 prompt, also run on the host
MOE_RANGES = ("moe.router", "moe.dispatch", "moe.experts", "moe.combine")
# the port's spans (repro_torch.tracing), record_function ranges: their
# device rows in a trace are spans, not kernels
RANGES = MOE_RANGES + ("transformer.layer", "train_step.forward",
                       "train_step.backward", "train_step.optimizer",
                       "model.decode_step")
# Phase 9 (a): 4 of dbrx's 40 layers in bf16 (4 x 6.52 GB + 2.47 GB of
# embedding and head, ~28.6 GB), served twice: no mesh, then the mesh.
SHARD_LAYERS = 4
# Phases 9 (b), (c): the two ranks' float32 logits against the unsharded
# run on the card (``shard_close``).  With attention and the MLP
# tensor-parallel the ranks sum their partial products over "model" (and
# cuBLAS takes the halves in its own order), so the logits move as far as
# any other float32 evaluation of the same cut moves them: dbrx at 1 layer
# 3.374e-05 on the mesh, where the host's float32 prefill of the same
# weights and prompt is 3.409e-05 from the card's (phase 8 (a)); qwen2-72b
# 5.770e-05 against 5.794e-05 (NVIDIA H100 80GB HBM3, 700.00 W), past a
# flat allclose(rtol=atol=SHARD_TOL), which is printed as a reading.  The
# gate is the measured yardstick: the mesh's largest distance from the
# unsharded run at most SHARD_SPREAD times the host's float32 run's on the
# same prompt.
SHARD_TOL, SHARD_SPREAD = 1e-5, 2.0
SHARD_RANKS, SHARD_TIMEOUT = 2, 900   # (b): ranks on the one card; seconds
# Phases 9 (c), (d), (e): each cut at full width, tensor-parallel over
# "model" on the same two ranks: (configuration, layers, the bf16 logits'
# band, float32 decode steps held against the unsharded decode).  (c)
# qwen2-72b (64/8 heads of 128, d_ff 29568, QKV bias): each rank's 32 query
# and 4 KV heads, 14784 MLP columns; (d) mamba2-2.7B (80 SSM heads of 64,
# state 128): 40 heads a rank through K3 / K3-bwd; (e) minicpm3-4B (MLA, 40
# heads, Dk 96 / Dv 64): 20 heads a rank through K2 / K2-bwd, the latent
# whole.  Float32: the prefill logits (and decode steps) against the
# unsharded run as in (b), the yardstick the host's float32 run of the cut,
# run by the parent while the ranks work; a training step's loss and
# gradient shards at phase 7 (b)'s gates.  bf16: the logits in the band of
# the cut's kernel (rtol, and atol as a share of the largest logit).
TP_TOKENS, TP_DECODE = 512, 3
TP_PARTS = {"(c)": ("qwen2-72b", 1, K2_TOL["bfloat16"], False),
            "(d)": ("mamba2-2_7b", 2, K3_TOL["bfloat16"], True),
            "(e)": ("minicpm3-4b", 2, K2_TOL["bfloat16"], True)}
# Phase 10 (a): the predicted arguments less the batch must equal the bytes
# the built tensors requested; against memory_allocated's growth they
# differ by the caching allocator's rounding of those blocks (512 bytes,
# and up to 1 MiB of a new segment's remainder a block): 0.593-0.683 %
# for hymba's 1834 blocks of weights and AdamW moments, by what the cache
# already holds, 0 for dbrx's 43, and 1.659 % for minicpm3-4b's 2428,
# whose 31.25 MiB MLP leaves each take a 32 MiB block (the readings this
# phase prints; NVIDIA H100 80GB HBM3, 700.00 W).  So the prediction is
# held with that rounding modelled (``allocator_charge``: 0.248 % of
# hymba's arguments, 1.716 % of minicpm3's), to 1 %.
# The peak against max_memory_allocated: scratch the kernels allocate inside
# their operators and the same rounding are not in the prediction.
DRYRUN_ARG_TOL, DRYRUN_PEAK_TOL = 0.01, 0.15
DRYRUN_TIMEOUT = 600      # (b): seconds for each host-only dry run
# (b): the train_4k cells whose per-rank FLOPs split is printed, each
# tensor-parallel over "model": (configuration, mesh shape, or None for
# 16 x 16, its FLOPs a rank when its layers were gathered and repeated on
# every rank of "model": the dry run's earlier records, PERF.md section 6;
# its TFLOP a rank now, to the third decimal).  stablelm-12b: attention and
# MLP over 16 (its 8 KV heads do not divide it); mamba2-2.7B: the SSM, 5 of
# 80 heads a rank; minicpm3-4B on 32 x 8: MLA, 5 of 40 heads a rank (40
# heads do not divide 16).  The vocab-parallel loss head: stablelm's 100352
# and minicpm3's 73448 divide "model", mamba2's 50280 does not (whole).
TP_DRYRUN_CELLS = (("stablelm-12b", None, 6331, 412.841),
                   ("mamba2-2_7b", None, 1394.356, 171.418),
                   ("minicpm3-4b", (32, 8), 658.830, 200.893))
# (b): the cell run again with the dry run's --opt (Megatron-SP, loss
# chunks of 8192): the same FLOPs, and a peak below the cell's by about
# what remat "full" no longer holds: each layer's input at S/16 rows
# (40 x 65536 x 5120 bf16 = 25.0 GiB a rank at S, 1.56 at S/16)
TP_DRYRUN_OPT = "stablelm-12b"
DRYRUN_OUT = ROOT / "experiments" / "dryrun_torch_chip"
# Phase 11 (b): 2 of dbrx's 40 layers in bf16 with their gradients and
# AdamW's bf16 moments: 7.751 B parameters at 8 bytes, ~62 GB, and the f32
# head; a batch of 2 x TRAIN_SEQ unless the dry run's peak passes 72 GiB.
MOE_TRAIN_LAYERS, MOE_TRAIN_BATCH, MOE_TRAIN_STEPS = 2, 2, 4
MOE_TRAIN_PEAK = 72 * 2**30
# (b): gradient leaves held in float32 blocks of this many elements
GRAD_BLOCK = 2**26
# (c): the forward is the same arithmetic under "dots" and "full"
DOTS_LOSS_RTOL = 1e-6
# (d): 2 of llama4's 48 layers (one dense, one MoE), 18.55 B parameters;
# its prefill's last-token logits through K2 against K2's plain version,
# both bf16: K2's bf16 band (tests/test_kernels_flash.py:33) as rtol and
# as a share of the largest logit
LLAMA4_ARCH, LLAMA4_LAYERS = "llama4-maverick-400b-a17b", 2
LLAMA4_TOL = 2e-2
# (d): tokens K2 may route to another top-1 expert than K2's plain version
# does, as a multiple of those the library's bf16 attention (sdpa) moves
LLAMA4_MOVED_FACTOR = 2
# Phases 3 and 7 (a): K2 and K2-bwd with query row i at position q_offset
# + i, on every route.  Offsets off the 64-row tile; Skv = q_offset + Sq
# (chunked prefill) and Skv > q_offset + Sq (keys after the last query);
# the "empty-rows" rows keep no key for their last 17 rows (all write 0
# there); at the ragged head dim 40, route() sends bf16 to simt itself.
# label, B, S, H, KH, Dk, Dv, window, causal, q_offset, Skv
K2_OFFSET_ROWS = (
    ("offset-chunk", 1, 200, 8, 2, 64, 64, 0, True, 37, 237),
    ("offset-window-beyond", 2, 200, 8, 2, 64, 64, 100, True, 37, 287),
    ("offset-mla-window-beyond", 1, 333, 8, 8, 96, 64, 256, True, 1000,
     1410),
    ("offset-empty-rows", 1, 130, 4, 2, 64, 64, 64, True, 300, 350),
    ("offset-empty-rows-40", 1, 130, 4, 2, 40, 40, 64, True, 300, 350),
    ("offset-noncausal-window", 1, 100, 4, 4, 32, 32, 30, False, 45, 150),
)
# Phases 3 and 7 (a): K2 and K2-bwd in float32 (tf32x3, simt's float32
# entry timed beside) at the zoo's other head dims, at a prefill's and a
# step's size: 2 x 1024 tokens, window 0 (dbrx, qwen2, deepseek, internvl2
# at 128; minicpm3's MLA at 96/64; stablelm at 160).
# label, B, S, H, KH, Dk, Dv
F32_ZOO_ROWS = (("f32-dk128", 2, 1024, 32, 8, 128, 128),
                ("f32-mla", 2, 1024, 40, 40, 96, 64),
                ("f32-dk160", 2, 1024, 32, 8, 160, 160))
# Phase 7 (a): K2-bwd bf16 at head dims in (128, 256], the sm90 route's
# two-warpgroup kernels (NB = 3 or 4 blocks of 64 columns); the last rows of
# "wide-256-window-offset" keep no key (as "offset-empty-rows").
# label, B, S, H, KH, Dk, Dv, window, q_offset, Skv
K2B_WIDE_ROWS = (
    ("wide-144", 1, 130, 8, 2, 144, 144, 0, 0, 130),
    ("wide-160-gqa", 1, 333, 32, 8, 160, 160, 0, 0, 333),
    ("wide-192-128", 2, 200, 4, 2, 192, 128, 0, 0, 200),
    ("wide-256-window-offset", 1, 130, 4, 2, 256, 256, 64, 300, 350),
    ("wide-256-window-ragged", 2, 77, 4, 2, 256, 256, 20, 0, 77),
)
# Phase 12: minicpm3-4B (MLA), (a) float32 at 2 layers, also run on the
# host.  Phases 12 and 13: (b) served at the largest depth whose bf16
# weights stay under SERVE_WEIGHTS (the rest of the card's 79.2 GiB holds
# the caches, 2.1 GB at qwen2-72b's cut, and the prefill's activations);
# (c) trained at the largest depth whose dry-run peak stays under
# TRAIN_PEAK (minicpm3's 62 layers are predicted at ~34 GiB at 4 x 2048).
# The rest of the card is the caching allocator's: stablelm-12b at 29
# layers (dry-run peak 71.53 GiB) took four steps at a peak of 71.79 GiB,
# then ran out of memory on a 1.91 GiB block with 7.19 GiB free in the
# allocator's cached blocks (NVIDIA H100 80GB HBM3, 700.00 W).
MLA_ARCH, MLA_GATE_LAYERS = "minicpm3-4b", 2
SERVE_WEIGHTS, TRAIN_PEAK = 64 * 2**30, 66 * 2**30
# Phase 12 (d): K2 at the prefill of the benchmark's minicpm3-4b.serve-longdoc
# cell (perfbench/): B, S of its padded batch at the longest prompts.
MLA_CELL = (4, 16384)
# Phase 13: the six configurations no earlier phase runs, in this order;
# all are served, the first four trained (as the reference trains them).
# ZOO_TRACED's serving is traced, and stablelm-12b's step (K2-bwd's share
# at head dim 160).  The float32 gate, on the host, takes 2 layers and
# ZOO_GATE_TOKENS; 1 layer above d_model ZOO_DEEP (stablelm-12b 5120,
# internvl2-26b 6144: 2 layers took 22.2 and 26.8 s of a run until phase 9
# (c) needed the time, NVIDIA H100 80GB HBM3, 700.00 W), and also
# MOE_GATE_TOKENS above ZOO_WIDE (qwen2-72b and deepseek-67b, 8192).
# ZOO_GATE_TOKENS was GATE_TOKENS (1100) until phase 9 (d) and (e) needed
# the time: no zoo configuration has a window for 1100 to pass, and 600
# still gives mamba2 three chunks of 256, the last one ragged.
ZOO = ("mamba2-2_7b", "stablelm-12b", "musicgen-medium", "internvl2-26b",
       "qwen2-72b", "deepseek-67b")
ZOO_TRAINED, ZOO_TRACED = ZOO[:4], ZOO[:2]
ZOO_DEEP, ZOO_WIDE, ZOO_GATE_TOKENS = 4096, 6144, 600
MEASURED: dict = {}       # phase 6's prefill busy s, phase 7's step times
                          # and its traced step's (busy, wall) s


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn) -> float:
    """Mean device time of ``fn`` in ms: one warm call, then enough calls
    between two CUDA events to span ~0.2 s."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    reps = max(1, min(50, int(0.2 / max(time.perf_counter() - t0, 1e-6))))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def roofline(ops: float, nbytes: float, peak: str) -> tuple[float, str]:
    """Least time in ms for ``ops`` operations at rate ``PEAK[peak]``
    moving ``nbytes``, and what bounds it."""
    t_ops = ops / PEAK[peak][0]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def bound_text(row: dict) -> str:
    return (f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']}; "
            f"{PEAK[row['peak']][1]}; {HBM_BYTES_PER_S / 1e12} TB/s HBM, "
            f"H100 SXM data sheet)")


def bound_ms(m: int, k: int, n: int, peak: str) -> tuple[float, str]:
    """Least time for C = A @ B on this card: the larger of the operations
    over the rate ``PEAK[peak]`` and the bytes (A, B read once, C written
    once) over the memory rate."""
    size = 2 if peak == "bfloat16" else 4
    return roofline(2.0 * m * n * k, size * (m * k + k * n + m * n), peak)


def k2_counts() -> tuple[int, int, int]:
    """K2's launches per route, in ``K2_ROUTES`` order (sm90, tf32x3,
    simt)."""
    return tuple(getattr(flash_attention, f"launches_{r}")
                 for r in K2_ROUTES)


def once_on(kind: str) -> list[int]:
    """``k2_counts``' growth for one launch on route ``kind``."""
    return [int(r == kind) for r in K2_ROUTES]


def band_mask(S: int, skv: int, causal: bool, window: int,
              q_offset: int = 0) -> torch.Tensor:
    """(S, skv) bool on the card: K2's mask, query row i at position
    ``q_offset + i``, keys at 0..skv-1 (sdpa's ``attn_mask``)."""
    qp = q_offset + torch.arange(S, device=DEV)[:, None]
    kp = torch.arange(skv, device=DEV)[None, :]
    mask = torch.ones((S, skv), dtype=torch.bool, device=DEV)
    if causal:
        mask &= qp >= kp
    if window > 0:
        mask &= kp > qp - window
    return mask


def flash_row(label, gen, B, S, H, KH, Dk, Dv, window, dtype,
              causal=True, q_offset: int = 0, skv: int | None = None,
              phase: str = "kernel", kind: str | None = None,
              sample: bool = False) -> dict:
    """K2 against its plain version on the same card tensors, then kernel,
    plain version and ``scaled_dot_product_attention`` timed (at window 0
    and offset 0, also sdpa's ``is_causal`` form, which needs no mask
    tensor and may take PyTorch's flash backend); a ``tf32x3`` row also
    times ``simt``'s float32 entry at its shape (``simt_ms``) and gives its
    bound at the 67 TFLOP/s CUDA-core rate beside the 3xTF32 one; an
    ``sm90`` row prints ``sm90_plan``'s tile, stages and shared memory.
    ``q_offset``: query row i at position ``q_offset + i`` over ``skv``
    keys (default S); rows that keep no key must be 0 in both.
    ``sample``: a shape whose score matrix the plain version cannot hold
    (causal, window 0): its first 128 and last 256 query rows are held
    against the plain version run at their offsets, and neither the plain
    version nor sdpa's mask form is timed.  Fails if
    the launch did not take the route that ``route`` names, or bf16 at head
    dims that are multiples of 16 did not run on ``sm90``, or float32 on
    ``tf32x3``.  ``kind`` names a kernel to run in the route's place (the
    entry called directly, as ``simt``'s float32 entry is timed)."""
    name = DTYPE_NAME[dtype]
    skv = S if skv is None else skv
    q, k, v = (torch.randn(shape, generator=gen, device=DEV).to(dtype)
               for shape in ((B, S, H, Dk), (B, skv, KH, Dk),
                             (B, skv, KH, Dv)))
    named = kind is not None
    kind = kind or route(dtype, Dk, Dv)

    def run():
        if named:
            return k2_launch(kind, q, k, v, causal, window, None, False,
                             q_offset)[0]
        return flash_attention(q, k, v, causal=causal, window=window,
                               q_offset=q_offset)

    before = k2_counts()
    out = run()
    torch.cuda.synchronize()
    ran = [r for r, a, b in zip(K2_ROUTES, k2_counts(), before) if a > b]
    check(ran == [kind], f"K2 {label}: launched on {ran}, not {kind}")
    plan = sm90_plan(Dk, Dv) if kind == "sm90" else None
    if not named and dtype == torch.bfloat16 and Dk % 16 == 0 \
            and Dv % 16 == 0:
        check(kind == "sm90", f"K2 {label}: bf16 at Dk {Dk}, Dv {Dv} did not "
              f"take the tensor-core route")
    if not named and dtype == torch.float32:
        check(kind == "tf32x3", f"K2 {label}: float32 did not take the "
              f"3xTF32 tensor-core route")
    tol = K2_TOL[name]
    row = {"label": label, "dtype": name, "route": kind, "tol": tol}

    # against the plain version, all rows or (sample) the first 128 and
    # the last 256, each run at its offset
    row.update(max_abs_err=0.0, violations=0, empty_rows=0, empty_nonzero=0)
    for r0, n in ((0, 128), (S - 256, 256)) if sample else ((0, S),):
        plain = flash_attention_ref(q[:, r0:r0 + n], k, v, causal=causal,
                                    window=window, q_offset=q_offset + r0)
        empty = ~band_mask(n, skv, causal, window, q_offset + r0).any(-1)
        part = out[:, r0:r0 + n]
        diff = (part.float() - plain.float()).abs()
        row["max_abs_err"] = max(row["max_abs_err"], float(diff.max()))
        row["violations"] += int(
            (diff > tol + tol * plain.float().abs()).sum())
        row["empty_rows"] += int(empty.sum())
        row["empty_nonzero"] += int((part[:, empty] != 0).sum()
                                    + (plain[:, empty] != 0).sum())
        del plain, diff
    del out
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    row["kernel_ms"] = cuda_ms(run)
    simt_text = ""
    if kind == "tf32x3":
        row["simt_ms"] = cuda_ms(lambda: k2_launch(
            "simt", q, k, v, causal, window, None, False, q_offset))
        simt_text = (f" simt_ms={row['simt_ms']:.4f} (simt's float32 entry, "
                     f"{row['simt_ms'] / row['kernel_ms']:.2f}x)")
    if sample:
        row["plain_ms"] = row["library_ms"] = float("nan")
        mask_text = "not timed (an S x S mask)"
    else:
        mask = band_mask(S, skv, causal, window, q_offset)
        row["plain_ms"] = cuda_ms(lambda: flash_attention_ref(
            q, k, v, causal=causal, window=window, q_offset=q_offset))
        row["library_ms"] = cuda_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, scale=1.0 / math.sqrt(Dk),
                enable_gqa=True))
        del mask
        mask_text = f"{row['library_ms']:.4f}"
    causal_text = ""
    if causal and window == 0 and q_offset == 0 and skv == S:
        row["library_causal_ms"] = cuda_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, scale=1.0 / math.sqrt(Dk),
                enable_gqa=True))
        causal_text = (f" library_causal_ms={row['library_causal_ms']:.4f} "
                       f"(sdpa, is_causal, enable_gqa)")
    size = q.element_size()
    ops = 2.0 * B * H * band_pairs(S, skv, causal, window, q_offset) * (
        Dk + Dv)
    nbytes = size * (B * S * H * (Dk + Dv) + B * skv * KH * (Dk + Dv))
    row["peak"] = "tf32x3" if kind == "tf32x3" else name
    row["bound_ms"], row["bound_by"] = roofline(ops, nbytes, row["peak"])
    smem = (f", {plan.keys} keys a tile, {plan.stages} stages, "
            f"{plan.smem / 1024:.0f} KiB dynamic shared memory" if plan
            else "")
    if kind == "tf32x3":
        row["fma_bound_ms"], _ = roofline(ops, nbytes, "float32")
        got = tf32x3_kernel_smem_bytes(Dk, Dv)[0]
        check(got == tf32x3_smem_bytes(Dk, Dv), f"K2 {label}: the source "
              f"reckons {got} bytes of shared memory, the wrapper "
              f"{tf32x3_smem_bytes(Dk, Dv)}")
        smem = (f", {got} B dynamic shared memory (the wrapper's figure); "
                f"bound at the 67 TFLOP/s f32 CUDA-core rate "
                f"{row['fma_bound_ms']:.4f} ms")
    offset = (f" q_offset {q_offset} Skv {skv} ({row['empty_rows']} rows "
              f"keep no key, nonzero there: {row['empty_nonzero']})"
              if q_offset or skv != S else "")
    held = " (rows 0..127 and the last 256)" if sample else ""
    say(phase, f"K2 {label} B{B} S{S} H{H}/{KH} Dk{Dk} Dv{Dv} "
        f"window {window}{'' if causal else ' noncausal'}{offset} {name} "
        f"route {kind}{smem}: vs plain{held} max_abs_err="
        f"{row['max_abs_err']:.3e} violations={row['violations']} "
        f"(rtol=atol={tol}); kernel_ms={row['kernel_ms']:.4f} plain_ms="
        f"{row['plain_ms']:.4f} library_ms={mask_text} (sdpa, bool mask, "
        f"enable_gqa){causal_text}{simt_text} "
        f"({100 * row['bound_ms'] / row['kernel_ms']:.1f} % of the bound) "
        + bound_text(row))
    check(row["violations"] == 0, f"K2 disagrees with its plain version: "
          f"{row}")
    check(row["empty_nonzero"] == 0, f"K2 {label}: rows that keep no key "
          f"are not 0: {row}")
    return row


def ssd_row(label, gen, b, nc, Q, nh, G, hp, ds, dtype,
            phase: str = "kernel") -> dict:
    """K3 against its plain version on the same card tensors, then kernel
    and plain version timed (no single PyTorch call computes it).  The
    wrapper's shared-memory figure must be the kernel's."""
    name = DTYPE_NAME[dtype]

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=DEV)

    xdt = (rnd(b, nc, Q, nh, hp) * 0.5).to(dtype)
    B = (rnd(b, nc, Q, G, ds) * 0.5).to(dtype)
    C = (rnd(b, nc, Q, G, ds) * 0.5).to(dtype)
    cum = torch.cumsum(-torch.nn.functional.softplus(rnd(b, nc, Q, nh)),
                       dim=2)
    before = ssd_chunk.launches
    y, st = ssd_chunk(xdt, B, C, cum)
    torch.cuda.synchronize()
    check(ssd_chunk.launches == before + 1, f"K3 {label}: no kernel launch")
    y_ref, st_ref = ssd_chunk_ref(xdt, B, C, cum)
    tol = K3_TOL[name]
    dy = (y.float() - y_ref.float()).abs()
    dst = (st - st_ref).abs()
    row = {"label": label, "dtype": name, "peak": "tf32x3",
           "entry": k3_entry(dtype),
           "max_abs_err": max(float(dy.max()), float(dst.max())),
           "violations": int((dy > tol + tol * y_ref.float().abs()).sum()
                             + (dst > tol + tol * st_ref.abs()).sum()),
           "tol": tol, "library_ms": None}
    del y, st, y_ref, st_ref, dy, dst
    row["kernel_ms"] = cuda_ms(lambda: ssd_chunk(xdt, B, C, cum))
    row["plain_ms"] = cuda_ms(lambda: ssd_chunk_ref(xdt, B, C, cum))
    pairs = Q * (Q + 1) // 2
    ops = 2.0 * b * nc * nh * (pairs * (ds + hp) + Q * ds * hp)
    size = xdt.element_size()
    nbytes = (size * (2 * b * nc * Q * nh * hp + 2 * b * nc * Q * G * ds)
              + 4 * (b * nc * Q * nh + b * nc * nh * ds * hp))
    row["bound_ms"], row["bound_by"] = roofline(ops, nbytes, "tf32x3")
    widened = ", bf16 inputs widened to f32" if dtype == torch.bfloat16 else ""
    smem = k3_kernel_smem(hp, ds)
    check(smem == k3_smem(hp, ds), f"K3 {label}: the wrapper reckons "
          f"{k3_smem(hp, ds)} bytes of shared memory, the kernel {smem}")
    say(phase, f"K3 {label} b{b} NC{nc} Q{Q} nh{nh} G{G} hp{hp} ds{ds} "
        f"{name} entry {row['entry']} (3xTF32 wgmma{widened}, "
        f"{smem / 1024:.0f} KiB dynamic shared memory: the kernel's "
        f"kernel_smem_bytes {smem} B, the wrapper's smem_bytes "
        f"{k3_smem(hp, ds)} B of {k3_smem_limit} B a block): vs plain "
        f"max_abs_err={row['max_abs_err']:.3e} violations="
        f"{row['violations']} (rtol=atol={tol}); kernel_ms="
        f"{row['kernel_ms']:.4f} plain_ms={row['plain_ms']:.4f} "
        f"library_ms=— (no single PyTorch call) " + bound_text(row))
    check(row["violations"] == 0, f"K3 disagrees with its plain version: "
          f"{row}")
    return row


def compare(a, b, dtype: str, tol, label: str, exact_rows=None) -> dict:
    """Kernel vs plain version on the same card tensors, then both timed
    beside one library call.  ``exact_rows``: also hold the kernel against
    float64 on those rows, at the unscaled tolerance."""
    m, k = a.shape
    n = b.shape[1]
    rtol, atol = tol
    if dtype == "float32" and k > 4096:
        # The plain version is itself a float32 product: its rounding grows
        # with K (worst case linearly), and the gate was set at K <= 4096.
        atol = tol[1] * k / 4096
    before = matmul.launches
    out = matmul(a, b)
    torch.cuda.synchronize()
    check(matmul.launches == before + 1, f"K1 {label}: no kernel launch")
    plain = matmul_ref(a, b)
    torch.cuda.synchronize()
    diff = (out.float() - plain.float()).abs()
    err = float(diff.max())
    bad = int((diff > atol + rtol * plain.float().abs()).sum())
    entry = k1_entry(a.dtype)
    datapath = ("3xTF32 on wgmma.m64n128k8" if dtype == "float32"
                else "bf16 wgmma.m64n128k16")
    row = {"shape": [m, k, n], "dtype": dtype, "entry": entry,
           "max_abs_err": err, "violations": bad, "rtol": rtol,
           "atol": atol,
           "peak": "tf32x3" if dtype == "float32" else "bfloat16"}
    say("kernel", f"{label} {m}x{k}x{n} {dtype} entry {entry} ({datapath}): "
        f"vs plain max_abs_err={err:.3e} violations={bad} (rtol {rtol}, "
        f"atol {atol:.3g})")
    if exact_rows is not None:
        exact = a[exact_rows].double() @ b.double()
        k_err = (out[exact_rows].double() - exact).abs()
        p_err = float((plain[exact_rows].double() - exact).abs().max())
        row["violations"] += int((k_err > tol[1] + tol[0] * exact.abs())
                                 .sum())
        say("kernel", f"{label}: {len(exact_rows)} rows vs float64: kernel "
            f"max_abs_err={float(k_err.max()):.3e} (rtol {tol[0]}, atol "
            f"{tol[1]}), plain version {p_err:.3e}")
        del exact, k_err
    del out, plain, diff
    row["kernel_ms"] = cuda_ms(lambda: matmul(a, b))
    row["plain_ms"] = cuda_ms(lambda: matmul_ref(a, b))
    row["library_ms"] = cuda_ms(lambda: torch.matmul(a, b))
    row["bound_ms"], row["bound_by"] = bound_ms(m, k, n, row["peak"])
    fma = ""
    if dtype == "float32":
        row["fma_bound_ms"], _ = bound_ms(m, k, n, "float32")
        fma = (f"; f32 FMA bound {row['fma_bound_ms']:.4f} ms "
               f"({PEAK['float32'][1]})")
    say("kernel", f"{label} {m}x{k}x{n} {dtype}: kernel_ms="
        f"{row['kernel_ms']:.4f} plain_ms={row['plain_ms']:.4f} library_ms="
        f"{row['library_ms']:.4f} (torch.matmul) " + bound_text(row) + fma)
    return row


def bus_invariants(measured, planned) -> None:
    """The reference's invariants on a measured timeline
    (tests/test_bus_timeline.py): per-link transfers never overlap, each
    link grants in the plan's ticket order, and every compute starts after
    its own input copy."""
    for link, seq in planned.link_ticket_order().items():
        evs = measured.link_events(link)
        for x, y in zip(evs, evs[1:]):
            check(y.start >= x.end - 1e-9, f"transfers overlap on {link}: "
                  f"{x} / {y}")
        got = []
        for e in sorted(evs, key=lambda e: e.start):
            if (e.device, e.kind) not in got:
                got.append((e.device, e.kind))
        check(got == seq, f"link {link} order {got} != plan {seq}")
    for name in {e.device for e in measured.events}:
        evs = measured.device_events(name)
        ins = sorted((e for e in evs if e.kind == "copy_in"),
                     key=lambda e: e.chunk)
        comps = sorted((e for e in evs if e.kind == "compute"),
                       key=lambda e: e.chunk)
        for i_ev, c_ev in zip(ins, comps):
            check(c_ev.start >= i_ev.end - 1e-9,
                  f"{name} computed before its input landed")


def check_rows(c, a, b, rows, label: str) -> float:
    """Sampled rows of C against float64 numpy."""
    want = a[rows].astype(np.float64) @ b
    got = c[rows].astype(np.float64)
    err = float(np.max(np.abs(got - want)))
    ok = np.allclose(got, want, rtol=F32_TOL[0], atol=F32_TOL[1])
    say("main", f"{label}: {len(rows)} sampled rows vs float64: "
        f"max_abs_err={err:.3e} allclose(rtol {F32_TOL[0]}, atol "
        f"{F32_TOL[1]})={ok}")
    check(bool(np.isfinite(c).all()), f"{label}: C is not finite")
    check(ok, f"{label}: sampled rows of C disagree with float64 A@B")
    return err


def inputs_key(cfg) -> str:
    """The batch key of ``cfg``'s inputs: embeddings for a stub frontend
    (``Model.embed_inputs``), else token ids."""
    return "embeds" if cfg.frontend != "none" else "tokens"


def prefill_matches_decode(cfg, phase: str = "serve") -> None:
    """Serve phase (a): in float32, decode through plain torch must give
    the last-token logits of a prefill through K2/K3 over the same inputs
    (``cfg``'s model, weights from seed 0): the greedy tokens fed back, or
    for a stub frontend seeded embeddings (as ``SyntheticLM`` makes them)."""
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model = Model(cfg32, device=DEV,
                  generator=torch.Generator(DEV).manual_seed(0))
    key = inputs_key(cfg)
    rng = np.random.default_rng(1)
    if key == "embeds":
        seq = (rng.standard_normal((SERVE_A_PROMPT + 4, cfg.d_model))
               .astype(np.float32) * 0.02)
        prompt = seq[:SERVE_A_PROMPT]
    else:
        prompt = rng.integers(1, cfg.vocab_size, SERVE_A_PROMPT)
    fed: list = []

    def prefill(x):
        return model.prefill({key: torch.as_tensor(np.asarray(x)[None],
                                                   device=DEV)})

    with torch.inference_mode():
        logits, cache = prefill(prompt)
        cache = model.extend_cache(cache, 4)
        for step in range(1, 5):
            if key == "embeds":
                fed.append(seq[SERVE_A_PROMPT + step - 1])
                x = torch.as_tensor(fed[-1][None, None], device=DEV)
            else:
                x = logits.argmax(-1)[:, None]
                fed.append(int(x[0, 0]))
            logits, cache = model.decode_step(cache, {key: x})
            want, _ = prefill(np.concatenate([prompt, np.asarray(fed)]))
            err = float((logits - want).abs().max())
            ok = torch.allclose(logits, want, rtol=PREFILL_DECODE_TOL,
                                atol=PREFILL_DECODE_TOL)
            say(phase, f"(a) float32 decode step {step} (position "
                f"{SERVE_A_PROMPT - 1 + step}) vs prefill of "
                f"{SERVE_A_PROMPT + step} tokens: "
                f"max_abs_err={err:.3e}, logits std {float(want.std()):.3e}"
                f", allclose(rtol=atol={PREFILL_DECODE_TOL})={ok}")
            check(bool(torch.isfinite(logits).all()), "decode logits are not "
                  "finite")
            check(ok, f"decode step {step} disagrees with the prefill")
    del model, cache
    torch.cuda.empty_cache()


def traced(phase: str, label: str, fn, steps: int, part: str = "(c)"):
    """``fn`` under ``torch.profiler``: prints the device-busy share of the
    host wall, launches per step and the kernels that take the most device
    time; returns (profile, device kernels, busy seconds), or None when
    the trace holds no device time.  Device rows of ``record_function``
    ranges (``RANGES``) are spans, not kernels, and are left out."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.key not in RANGES]
    if not kern:
        say(phase, f"{part} {label}: the trace holds no device time")
        return None
    busy = sum(e.self_device_time_total for e in kern) / 1e6
    launches = sum(e.count for e in kern)
    say(phase, f"{part} {label} under torch.profiler: wall {wall:.4f} s, "
        f"device busy {busy:.4f} s ({busy / wall * 100:.1f} %, idle "
        f"{(1 - busy / wall) * 100:.1f} %), {launches / steps:.0f} "
        f"kernel launches per step")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:8]:
        t = e.self_device_time_total / 1e6
        say(phase, f"{part}   {t:.4f} s ({t / busy * 100:.1f} % of busy)"
            f" x{e.count} {e.key[:90]}")
    return prof, kern, busy


def bucket_tokens(bucket) -> torch.Tensor:
    """A bucket's prompts left-padded with token 0, as the engine pads."""
    plen = max(len(r.tokens) for r in bucket)
    prompts = np.zeros((len(bucket), plen), np.int64)
    for i, r in enumerate(bucket):
        prompts[i, plen - len(r.tokens):] = r.tokens
    return torch.from_numpy(prompts).to(DEV)


def seeded_embeds(rng, B: int, S: int, d: int) -> torch.Tensor:
    """(B, S, d) float32 embeddings on the card, as ``SyntheticLM`` makes a
    stub frontend's: standard normal times 0.02 from ``rng``."""
    return torch.from_numpy(rng.standard_normal((B, S, d), dtype=np.float32)
                            * 0.02).to(DEV)


def events_s(fn) -> float:
    """Seconds between two CUDA events around one call of ``fn``."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def profile_serve(phase: str, model, bucket, breakdown=None,
                  part: str = "(c)", trace: bool = True) -> float:
    """Where a bucket's time goes on the card: one prefill and three decode
    steps under ``torch.profiler``; device-busy share of the host wall time
    and the kernels that take the most device time, then
    ``breakdown(phase, label, traced's result, part)`` of each trace.
    Without ``trace``, the same prefill and steps timed by CUDA events.  A
    stub frontend's model is fed seeded embeddings.  The prefill's and the
    decode steps' logits must be finite.  Returns the prefill's device busy
    seconds (its CUDA-event seconds without ``trace``).  Measurement only."""
    key = inputs_key(model.cfg)
    rng = np.random.default_rng(3)
    if key == "embeds":
        plen = max(len(r.tokens) for r in bucket)
        prompt = seeded_embeds(rng, len(bucket), plen, model.cfg.d_model)
    else:
        prompt = bucket_tokens(bucket)
    B, S = prompt.shape[:2]
    with torch.inference_mode():
        out = {}

        def prefill():
            out["logits"], out["cache"] = model.prefill({key: prompt})

        label = f"prefill of {B} x {S}"
        if trace:
            result = traced(phase, label, prefill, 1, part)
            busy = result[2] if result else float("nan")
            if breakdown and result:
                breakdown(phase, label, result, part)
        else:
            busy = events_s(prefill)
            say(phase, f"{part} {label}: {busy:.4f} s between CUDA events "
                f"({B * S / busy:.1f} tok/s)")
        check(bool(torch.isfinite(out["logits"]).all()),
              f"({phase}) prefill logits are not finite")
        cache = model.extend_cache(out["cache"], 4)
        x = (out["logits"].argmax(-1)[:, None] if key == "tokens"
             else seeded_embeds(rng, B, 1, model.cfg.d_model))
        _, cache = model.decode_step(cache, {key: x})   # warm

        def decode():
            c = cache
            for _ in range(3):
                out["logits"], c = model.decode_step(c, {key: x})

        if trace:
            result = traced(phase, "3 decode steps", decode, 3, part)
            if breakdown and result:
                breakdown(phase, "3 decode steps", result, part)
        else:
            say(phase, f"{part} 3 decode steps: {events_s(decode) / 3e-3:.2f}"
                f" ms a step between CUDA events")
        check(bool(torch.isfinite(out["logits"]).all()),
              f"({phase}) decode logits are not finite")
    return busy


def serve_traffic(phase: str, cfg):
    """Phase 6 (b)'s traffic at ``cfg``'s vocabulary: eight requests of
    ``default_rng(0).integers(1500, 3001)`` prompt tokens, 16 new tokens
    each, split by ``PoasDispatcher`` over two modelled groups (as
    ``launch/serve.py``); returns the buckets and a 300-token warm-up
    request."""
    rng = np.random.default_rng(0)
    lengths = rng.integers(1500, 3001, size=SERVE_REQUESTS)
    reqs = [Request(uid=i, tokens=rng.integers(1, cfg.vocab_size, int(n)),
                    max_new_tokens=SERVE_MAX_NEW)
            for i, n in enumerate(lengths)]
    groups = [DeviceProfile(f"group{i}", "gpu-group",
                            LinearTimeModel(a=(1 + i) * 1e-6, b=1e-3),
                            NO_COPY) for i in range(2)]
    disp = PoasDispatcher(groups)
    buckets = disp.split(reqs)
    say(phase, f"prompt lengths {lengths.tolist()}; dispatch "
        f"{[[r.uid for r in b] for b in buckets]} shares "
        f"{[round(x, 4) for x in disp.last_plan.optimize.shares()]} "
        f"predicted makespan {disp.predicted_makespan(buckets):.6f} s "
        f"(modelled groups, as launch/serve.py)")
    warm = [Request(uid=-1, tokens=rng.integers(1, cfg.vocab_size, 300),
                    max_new_tokens=2)]
    return buckets, warm


def serve_buckets(phase: str, generate, buckets, cfg, card: str = "") -> list:
    """(b) ``buckets`` through ``generate`` (``ServingEngine.generate`` of
    ``cfg``'s model in bf16, or ``embed_generate``): each bucket's prefill
    and decode steps launch K2 once a layer with attention, on the route
    ``route`` names, and K3 once a layer where ``cfg`` has SSM layers, all
    in the prefill, and no other kernel; every completion holds
    in-vocabulary tokens.  Prints each bucket's rates and peak; returns
    each bucket's (B * padded length, B, padded length)."""
    want = kernel_launches(cfg, torch.bfloat16, 1, 0)
    k2 = f"flash_attention/{route(torch.bfloat16, *attention_dims(cfg))}"
    shapes = []
    for gi, bucket in enumerate(buckets):
        if not bucket:
            continue
        before = launch_counts()
        torch.cuda.reset_peak_memory_stats()
        done = generate(bucket)
        peak = torch.cuda.max_memory_allocated()
        per = {k: v - before[k] for k, v in launch_counts().items()}
        check(per == want, f"({phase}) bucket {gi}: a prefill and "
              f"{SERVE_MAX_NEW - 1} decode steps launched {per}, not {want}")
        for c in done:
            check(len(c.tokens) == SERVE_MAX_NEW and bool(
                ((c.tokens >= 0) & (c.tokens < cfg.vocab_size)).all()),
                f"({phase}) completion {c.uid}: {c.tokens}")
        B = len(bucket)
        plen = max(len(r.tokens) for r in bucket)
        real = sum(len(r.tokens) for r in bucket)
        pre, dec = done[0].prefill_s, done[0].decode_s
        say(phase, f"(b) bucket {gi}: {B} requests, prompts padded to "
            f"{plen} ({real} real tokens); prefill {pre:.4f} s = "
            f"{B * plen / pre:.1f} tok/s ({real / pre:.1f} real tok/s); "
            f"decode {SERVE_MAX_NEW - 1} steps {dec:.4f} s = "
            f"{B * (SERVE_MAX_NEW - 1) / dec:.1f} tok/s "
            f"({dec / (SERVE_MAX_NEW - 1) * 1e3:.2f} ms/step); peak "
            f"max_memory_allocated {peak / 2**30:.3f} GiB; K2 "
            f"+{per[k2]} ({k2.split('/')[1]}), K3 +{per['ssd_chunk']}"
            f"; first completion {done[0].tokens.tolist()}"
            + (f"; {card}" if card else ""))
        shapes.append((B * plen, B, plen))
    return shapes


def serve(gen) -> tuple[dict, dict, dict]:
    """Serve phase: (a) the float32 check, (b) eight requests in bfloat16
    through ``PoasDispatcher`` and ``ServingEngine`` with K2/K3 launches
    counted, (c) K2 and K3 at the shapes (b) gave them."""
    cfg = get_config(SERVE_ARCH)
    say("serve", f"{cfg.name}: {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads of "
        f"{cfg.head_dim}, window {cfg.window} (full on layers "
        f"{list(cfg.global_layers)}), {cfg.ssm_heads} SSM heads of "
        f"{cfg.ssm_head_dim}, state {cfg.ssm_state}, chunk {cfg.ssm_chunk}, "
        f"vocab {cfg.vocab_size}; {cfg.param_count() / 1e9:.3f} B params "
        f"(ArchConfig.param_count), weights from seed 0")
    t0 = time.perf_counter()
    reset_k2_counts()
    prefill_matches_decode(cfg)
    sm90_a, f32_a, simt_a = k2_counts()
    say("serve", f"(a) done in {time.perf_counter() - t0:.1f} s; K2 launches "
        f"sm90 {sm90_a}, tf32x3 {f32_a}, simt {simt_a}")
    check(sm90_a == 0 and simt_a == 0 and f32_a == 5 * cfg.num_layers,
          f"(a) five float32 prefills launched K2 sm90 {sm90_a}, tf32x3 "
          f"{f32_a}, simt {simt_a} times, not 0, {5 * cfg.num_layers} and 0")

    model = Model(cfg, device=DEV,
                  generator=torch.Generator(DEV).manual_seed(0))
    engine = ServingEngine(model)
    buckets, warm = serve_traffic("serve", cfg)
    engine.generate(warm)                              # warm-up, not counted

    reset_launches()
    shapes = serve_buckets("serve", engine.generate, buckets, cfg)
    launches = {"flash_attention/sm90": flash_attention.launches_sm90,
                "flash_attention/tf32x3": f32_a,
                "ssd_chunk": ssd_chunk.launches}
    say("serve", f"(b) main path launches: {launches} (K2 tf32x3: phase "
        f"(a), float32; sm90 and K3: phase (b))")
    check(all(n > 0 for n in launches.values()),
          "the serve path launched no K2 or K3")
    check(flash_attention.launches_simt == 0
          and flash_attention.launches_tf32x3 == 0,
          "the bf16 serve path launched a float32 or CUDA-core K2")
    MEASURED["prefill_busy_s"] = profile_serve("serve", model,
                                               max(buckets, key=len))
    del model, engine
    torch.cuda.empty_cache()

    # (c) K2 and K3 at the largest bucket's prefill shapes; K2's tf32x3
    # route at phase (a)'s float32 prompt, and simt's float32 entry there.
    _, B, S = max(shapes)
    k2 = flash_row("serve-path", gen, B, S, cfg.num_heads, cfg.num_kv_heads,
                   cfg.head_dim, cfg.head_dim, cfg.window, torch.bfloat16)
    flash_row("serve-path", gen, B, S, cfg.num_heads, cfg.num_kv_heads,
              cfg.head_dim, cfg.head_dim, 0, torch.bfloat16)
    k2_f32 = flash_row("serve-a", gen, 1, SERVE_A_PROMPT, cfg.num_heads,
                       cfg.num_kv_heads, cfg.head_dim, cfg.head_dim,
                       cfg.window, torch.float32)
    k2_simt = flash_row("serve-a", gen, 1, SERVE_A_PROMPT, cfg.num_heads,
                        cfg.num_kv_heads, cfg.head_dim, cfg.head_dim,
                        cfg.window, torch.float32, kind="simt")
    Q = min(cfg.ssm_chunk, S)
    k3 = ssd_row("serve-path", gen, B, -(-S // Q), Q, cfg.ssm_heads,
                 cfg.ssm_groups, cfg.ssm_head_dim, cfg.ssm_state,
                 torch.float32)
    torch.cuda.empty_cache()
    return {"sm90": k2, "tf32x3": k2_f32, "simt": k2_simt}, k3, launches


def sdpa_bwd_ms(q, k, v, do, window: int, causal: bool = True,
                q_offset: int = 0) -> float:
    """Device time of the backward alone of one
    ``scaled_dot_product_attention`` call on the same tensors: ``is_causal``
    at window 0 (offset 0, Sq = Skv), a bool band mask with ``enable_gqa``
    otherwise."""
    S, Skv, Dk = q.shape[1], k.shape[1], q.shape[3]
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    kw = dict(scale=1.0 / math.sqrt(Dk), enable_gqa=True)
    if window > 0 or q_offset or Skv != S or not causal:
        kw["attn_mask"] = band_mask(S, Skv, causal, window, q_offset)
    else:
        kw["is_causal"] = True
    out = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, **kw)
    dot = do.transpose(1, 2)
    return cuda_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                               retain_graph=True))


def k2b_violations(got, want, name: str) -> tuple[float, int, str]:
    """Max |error| and count of elements outside ``K2B_TOL[name]`` over
    (dq, dk, dv); in bf16 the atol scales with each output's largest
    magnitude."""
    rtol, atol = K2B_TOL[name]
    err, bad = 0.0, 0
    for g, w in zip(got, want):
        w = w.float()
        a = atol * float(w.abs().max()) if name == "bfloat16" else atol
        diff = (g.float() - w).abs()
        err = max(err, float(diff.max()))
        bad += int((diff > a + rtol * w.abs()).sum())
    text = (f"rtol {rtol}, atol {atol} x max|want| per output"
            if name == "bfloat16" else f"rtol=atol={rtol}")
    return err, bad, text


def rel_norms(got, want) -> list[float]:
    """||got - want|| / ||want|| per output."""
    return [float((g.float() - w.float()).norm()
                  / w.float().norm().clamp(min=1e-30))
            for g, w in zip(got, want)]


def k2b_counts() -> tuple[int, int, int]:
    """K2-bwd's launches per route, in ``K2_ROUTES`` order."""
    return tuple(getattr(flash_attention_bwd, f"launches_{r}")
                 for r in K2_ROUTES)


def flash_bwd_row(label, gen, B, S, H, KH, Dk, Dv, window, dtype,
                  twice: bool = False, phase: str = "train",
                  part: str = "(a)", causal: bool = True, q_offset: int = 0,
                  skv: int | None = None, kind: str | None = None) -> dict:
    """K2-bwd against its plain backward on the same card tensors (q, k, v,
    dO random; o and lse from the plain forward), then kernel, plain
    version and sdpa's backward timed.  Fails if the launch did not take
    ``route_bwd``'s route.  On ``sm90`` the band's "want" rounds P and dS
    to bf16 where the kernel does, and each output is also held at
    relative norm ``K2B_NORM`` against the float32 plain backward.
    ``twice``: a second call must give bit-equal gradients.  ``q_offset``:
    query row i at position ``q_offset + i`` over ``skv`` keys (default
    S).  Bound: the five products over the band's pairs, 2 * pairs * (3 Dk
    + 2 Dv) per head, and the bytes of q, k, v, o, dO, lse read and dq,
    dk, dv written; a ``tf32x3`` row's at 3xTF32, with ``simt``'s float32
    entry timed at its shape (``simt_ms``).  ``kind`` names a kernel to
    run in the route's place (its entry called directly)."""
    name = DTYPE_NAME[dtype]
    skv = S if skv is None else skv
    q, k, v, do = (torch.randn(shape, generator=gen, device=DEV).to(dtype)
                   for shape in ((B, S, H, Dk), (B, skv, KH, Dk),
                                 (B, skv, KH, Dv), (B, S, H, Dv)))
    mask = dict(causal=causal, window=window, q_offset=q_offset)
    o, lse = flash_attention_ref(q, k, v, return_lse=True, **mask)
    named = kind is not None
    kind = kind or route_bwd(dtype, Dk, Dv)

    def run():
        if named:
            return k2b_launch(kind, q, k, v, o, do, lse, causal, window,
                              None, q_offset)
        return flash_attention_bwd(q, k, v, o, do, lse, **mask)

    before = k2b_counts()
    got = run()
    torch.cuda.synchronize()
    ran = [r for r, a, b in zip(K2_ROUTES, k2b_counts(), before) if a > b]
    check(ran == [kind], f"K2-bwd {label}: launched on {ran}, not {kind}")
    if not named and dtype == torch.bfloat16 and Dk % 16 == 0 \
            and Dv % 16 == 0 and max(Dk, Dv) <= MAX_HEAD_DIM:
        check(kind == "sm90", f"K2-bwd {label}: bf16 at Dk {Dk}, Dv {Dv} "
              f"did not take the tensor-core route")
    if not named and dtype == torch.float32:
        check(kind == "tf32x3", f"K2-bwd {label}: float32 did not take the "
              f"3xTF32 tensor-core route")
    # Query rows that keep no key: their dq is exactly 0.
    empty = ~band_mask(S, skv, causal, window, q_offset).any(1)
    row_empty = int(empty.sum())
    check(row_empty == 0 or not bool(got[0][:, empty].any()),
          f"K2-bwd {label}: dq of the {row_empty} rows that keep no key is "
          f"not 0")
    rounded = kind == "sm90"
    want = flash_attention_bwd_ref(
        q, k, v, o, do, lse, round_to=torch.bfloat16 if rounded else None,
        **mask)
    err, bad, tol = k2b_violations(got, want, name)
    row = {"label": label, "dtype": name, "route": kind, "max_abs_err": err,
           "violations": bad, "tol": tol}
    extra = ""
    if rounded:
        norms = rel_norms(got, flash_attention_bwd_ref(
            q.float(), k.float(), v.float(), o.float(), do.float(), lse,
            **mask))
        row["norms"] = norms
        extra = (f"; vs the float32 plain backward ||d||/||want|| dq, dk, "
                 f"dv = {', '.join(f'{x:.3e}' for x in norms)} (<= "
                 f"{K2B_NORM})")
    if twice:
        again = run()
        row["bit_equal"] = all(torch.equal(a, b) for a, b in zip(got, again))
        extra += f"; second run bit-equal {row['bit_equal']}"
        del again
    del got, want
    row["kernel_ms"] = cuda_ms(run)
    if kind == "tf32x3":
        row["simt_ms"] = cuda_ms(lambda: k2b_launch(
            "simt", q, k, v, o, do, lse, causal, window, None, q_offset))
        extra += (f"; simt_ms={row['simt_ms']:.4f} (simt's float32 entry, "
                  f"{row['simt_ms'] / row['kernel_ms']:.2f}x)")
    row["plain_ms"] = cuda_ms(lambda: flash_attention_bwd_ref(
        q, k, v, o, do, lse, **mask))
    row["library_ms"] = sdpa_bwd_ms(q, k, v, do, window, causal, q_offset)
    size = q.element_size()
    ops = 2.0 * B * H * band_pairs(S, skv, causal, window, q_offset) * (
        3 * Dk + 2 * Dv)
    nbytes = (size * (B * S * H * 2 * (Dk + Dv)
                      + B * skv * KH * 2 * (Dk + Dv))
              + 4 * B * H * S)   # q, o, dO, dq; k, v, dk, dv; lse
    row["peak"] = "tf32x3" if kind == "tf32x3" else name
    row["bound_ms"], row["bound_by"] = roofline(ops, nbytes, row["peak"])
    row["fma_bound_ms"], _ = roofline(ops, nbytes, "float32")
    row["tc_bound_ms"], _ = roofline(ops, nbytes, "bfloat16")
    smem = ""
    if rounded:
        smem = bwd_sm90_kernel_smem_bytes(Dk, Dv)
        check(smem == bwd_sm90_smem_bytes(Dk, Dv), f"K2-bwd {label}: the "
              f"source reckons {smem} bytes of shared memory, the wrapper "
              f"{bwd_sm90_smem_bytes(Dk, Dv)}")
        smem = (f", {smem} B dynamic shared memory (the larger kernel; "
                f"the wrapper's figure)")
    elif kind == "tf32x3":
        smem = tf32x3_kernel_smem_bytes(Dk, Dv)[1]
        check(smem == bwd_tf32x3_smem_bytes(Dk, Dv), f"K2-bwd {label}: the "
              f"source reckons {smem} bytes of shared memory, the wrapper "
              f"{bwd_tf32x3_smem_bytes(Dk, Dv)}")
        smem = (f", {smem} B dynamic shared memory (the dK/dV kernel; the "
                f"wrapper's figure)")
    if row_empty:
        smem += f"; the {row_empty} rows that keep no key: dq 0"
    offset = (f" q_offset {q_offset} Skv {skv}" if q_offset or skv != S
              else "")
    say(phase, f"{part} K2-bwd {label} B{B} S{S} H{H}/{KH} Dk{Dk} Dv{Dv} "
        f"window {window}{'' if causal else ' noncausal'}{offset} {name} "
        f"route {kind}{smem}: vs plain"
        f"{' (P, dS rounded to bf16)' if rounded else ''} max_abs_err="
        f"{err:.3e} violations={bad} ({tol}){extra}; kernel_ms="
        f"{row['kernel_ms']:.4f} plain_ms={row['plain_ms']:.4f} "
        f"library_ms={row['library_ms']:.4f} (sdpa backward alone, "
        f"{'bool mask' if window or offset or not causal else 'is_causal'}"
        f", enable_gqa) "
        + bound_text(row) + f"; at the f32 FMA rate "
        f"{row['fma_bound_ms']:.4f} ms, at bf16 tensor-core peak "
        f"{row['tc_bound_ms']:.4f} ms")
    check(bad == 0, f"K2-bwd disagrees with its plain backward: {row}")
    if rounded:
        check(max(row["norms"]) <= K2B_NORM, f"K2-bwd {label}: relative norm "
              f"against the float32 plain backward above {K2B_NORM}: {row}")
    if twice:
        check(row["bit_equal"], f"K2-bwd {label}: two runs differ")
    return row


def ssd_bwd_row(label, gen, b, nc, Q, nh, G, hp, ds, dtype,
                twice: bool = False, phase: str = "train",
                part: str = "(a)") -> dict:
    """K3-bwd against its plain backward on the same card tensors, then
    kernel and plain version timed (no single PyTorch call computes it).
    The wrapper's shared-memory and scratch figures must be the kernel's;
    ``twice``: a second call must give bit-equal gradients.
    Bound, per (batch, chunk) over the Q(Q+1)/2 kept pairs: the two
    products of hp a pair per head (dM = dy xdt^T, dxdt = M^T dy), the
    three of ds a pair per group (C B^T, dC = dCB B, dB = dCB^T C: dCB is
    the sum of the group's heads' dM o L, taken elementwise) and the
    state terms, 2 Q ds hp per head, at 2 operations a product; the bytes
    of xdt, B, C, cum, dy, dstates read and dxdt, dB, dC, dcum written."""
    name = DTYPE_NAME[dtype]

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=DEV)

    xdt = (rnd(b, nc, Q, nh, hp) * 0.5).to(dtype)
    B = (rnd(b, nc, Q, G, ds) * 0.5).to(dtype)
    C = (rnd(b, nc, Q, G, ds) * 0.5).to(dtype)
    cum = torch.cumsum(-torch.nn.functional.softplus(rnd(b, nc, Q, nh)),
                       dim=2)
    dy = rnd(b, nc, Q, nh, hp).to(dtype)
    dst = rnd(b, nc, nh, ds, hp)
    before = ssd_chunk_bwd.launches
    got = ssd_chunk_bwd(xdt, B, C, cum, dy, dst)
    torch.cuda.synchronize()
    check(ssd_chunk_bwd.launches == before + 1,
          f"K3-bwd {label}: no kernel launch")
    want = ssd_chunk_bwd_ref(xdt, B, C, cum, dy, dst)
    tol = K3B_TOL[name]
    err, bad = 0.0, 0
    for g, w in zip(got, want):
        check(bool(torch.isfinite(g).all()), f"K3-bwd {label}: not finite")
        diff = (g.float() - w.float()).abs()
        err = max(err, float(diff.max()))
        bad += int((diff > tol + tol * w.float().abs()).sum())
    row = {"label": label, "dtype": name, "max_abs_err": err,
           "violations": bad, "tol": tol, "library_ms": None,
           "peak": "tf32x3"}
    extra = ""
    if twice:
        again = ssd_chunk_bwd(xdt, B, C, cum, dy, dst)
        row["bit_equal"] = all(torch.equal(a, b) for a, b in zip(got, again))
        extra = f"; second run bit-equal {row['bit_equal']}"
        del again
    del got, want
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    hs = bwd_heads_per_slice(b, nc, Q, nh, G, sms)
    mine = (bwd_smem_bytes(Q, hp, ds),
            bwd_scratch_floats(b, nc, Q, nh, G, ds, hs))
    theirs = bwd_kernel_figures(Q, hp, ds, b, nc, nh, G, hs)
    check(tuple(theirs) == mine, f"K3-bwd {label}: the wrapper reckons "
          f"(shared memory, scratch floats) {mine}, the kernel {theirs}")
    row["kernel_ms"] = cuda_ms(lambda: ssd_chunk_bwd(xdt, B, C, cum, dy,
                                                     dst))
    row["plain_ms"] = cuda_ms(lambda: ssd_chunk_bwd_ref(xdt, B, C, cum, dy,
                                                        dst))
    pairs = Q * (Q + 1) // 2
    ops = 2.0 * b * nc * (pairs * (nh * 2 * hp + G * 3 * ds)
                          + nh * 2 * Q * ds * hp)
    size = xdt.element_size()
    nbytes = (size * (3 * b * nc * Q * nh * hp + 4 * b * nc * Q * G * ds)
              + 4 * (2 * b * nc * Q * nh + b * nc * nh * ds * hp))
    row["bound_ms"], row["bound_by"] = roofline(ops, nbytes, "tf32x3")
    row["fma_bound_ms"], _ = roofline(ops, nbytes, "float32")
    say(phase, f"{part} K3-bwd {label} b{b} NC{nc} Q{Q} nh{nh} G{G} hp{hp} "
        f"ds{ds} {name} (3xTF32 wgmma; {hs} heads a slice, "
        f"{mine[0] / 1024:.0f} KiB dynamic shared memory, {mine[1]} scratch "
        f"floats; (shared memory B, scratch floats): the kernel's "
        f"bwd_kernel_figures {tuple(theirs)}, the wrapper's bwd_smem_bytes "
        f"and bwd_scratch_floats {mine}): vs plain max_abs_err={err:.3e} "
        f"violations={bad} "
        f"(rtol=atol={tol}){extra}; "
        f"kernel_ms={row['kernel_ms']:.4f} plain_ms={row['plain_ms']:.4f} "
        f"library_ms=— (no single PyTorch call) " + bound_text(row)
        + f"; at the f32 FMA rate {row['fma_bound_ms']:.4f} ms")
    check(bad == 0, f"K3-bwd disagrees with its plain backward: {row}")
    if twice:
        check(row["bit_equal"], f"K3-bwd {label}: two runs differ")
    return row


def train_qkv(gen, cfg, dtype, dv: bool = False, batch: int = TRAIN_BATCH):
    """Random q, k, v (and dO when ``dv``) at ``cfg``'s training attention
    shape: (``batch``, ``TRAIN_SEQ``) tokens, its query and KV heads."""
    shapes = [(batch, TRAIN_SEQ, h, cfg.head_dim)
              for h in (cfg.num_heads, cfg.num_kv_heads, cfg.num_kv_heads)]
    if dv:
        shapes.append(shapes[0])
    return [torch.randn(shape, generator=gen, device=DEV).to(dtype)
            for shape in shapes]


def k2_lse(gen, cfg, batch: int = TRAIN_BATCH, phase: str = "train",
           part: str = "(a)") -> None:
    """K2's ``lse`` output at ``cfg``'s training shape, on both tensor-core
    routes (bf16 -> sm90, float32 -> tf32x3), against the plain version's
    log-sum-exp on the same card tensors; then sm90's forward timed with
    and without ``lse``, in turns (without, with, with, without)."""
    for dtype, kind in ((torch.bfloat16, "sm90"),
                        (torch.float32, "tf32x3")):
        q, k, v = train_qkv(gen, cfg, dtype, batch=batch)
        for window in dict.fromkeys((cfg.window, 0)):
            before = k2_counts()
            _, lse = k2_forward(q, k, v, True, window, None, True)
            torch.cuda.synchronize()
            ran = [a - b for a, b in zip(k2_counts(), before)]
            check(ran == once_on(kind),
                  f"K2 lse {DTYPE_NAME[dtype]}: launched sm90/tf32x3/simt "
                  f"{ran}, not the {kind} route once")
            want = flash_attention_ref(q, k, v, window=window,
                                       return_lse=True)[1]
            diff = (lse - want).abs()
            bad = int((diff > LSE_TOL + LSE_TOL * want.abs()).sum())
            say(phase, f"{part} K2 lse ({kind}) B{batch} S{TRAIN_SEQ} "
                f"H{cfg.num_heads}/{cfg.num_kv_heads} D{cfg.head_dim} window "
                f"{window} {DTYPE_NAME[dtype]}: vs plain max_abs_err="
                f"{float(diff.max()):.3e} violations={bad} (rtol=atol="
                f"{LSE_TOL}; |lse| up to {float(want.abs().max()):.3f})")
            check(bad == 0, f"K2's lse ({kind}, window {window}) disagrees "
                  f"with the plain version's")
            if kind != "sm90":
                continue
            times = [cuda_ms(lambda: k2_forward(q, k, v, True, window, None,
                                                w))
                     for w in (False, True, True, False)]
            say(phase, f"{part} K2 forward (sm90) B{batch} S{TRAIN_SEQ} "
                f"window {window}: without lse {times[0]:.4f}/"
                f"{times[3]:.4f} ms, with lse {times[1]:.4f}/{times[2]:.4f} "
                f"ms")
        del q, k, v, lse, want, diff


def flash_autograd_row(gen, cfg, window: int, batch: int = TRAIN_BATCH,
                       phase: str = "train", part: str = "(a)") -> None:
    """K2's forward (sm90, writing ``lse``) and K2-bwd (sm90) chained
    through autograd at the training shape in bf16, as the training step
    runs them: the forward's o against the plain forward at K2's band, and
    the leaves' gradients against the plain backward given that o and the
    plain forward's lse, rounding P and dS to bf16 where the backward
    kernel does, and at relative norm ``K2B_NORM`` against the float32
    plain backward of the same o and lse.  The backward's D = rowsum(dO o
    O) takes the forward's own bf16 O (the sm90 kernel's P enters P V as
    bf16), so only the kernel's o isolates what the chain adds: its lse,
    and K2-bwd."""
    q, k, v, do = train_qkv(gen, cfg, torch.bfloat16, dv=True, batch=batch)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    before = k2_counts() + k2b_counts()
    out = flash_attention(*leaves, window=window)
    out.backward(do)
    torch.cuda.synchronize()
    ran = [a - b for a, b in zip(k2_counts() + k2b_counts(), before)]
    check(ran == once_on("sm90") * 2, f"K2 autograd: launched forward "
          f"sm90/tf32x3/simt, backward sm90/tf32x3/simt {ran}, not "
          f"{once_on('sm90') * 2}")
    o, lse = flash_attention_ref(q, k, v, window=window, return_lse=True)
    tol = K2_TOL["bfloat16"]
    diff = (out.detach().float() - o.float()).abs()
    o_bad = int((diff > tol + tol * o.float().abs()).sum())
    grads = [x.grad for x in leaves]
    want = flash_attention_bwd_ref(q, k, v, out.detach(), do, lse,
                                   window=window, round_to=torch.bfloat16)
    err, bad, gtol = k2b_violations(grads, want, "bfloat16")
    del want
    norms = rel_norms(grads, flash_attention_bwd_ref(
        q.float(), k.float(), v.float(), out.detach().float(), do.float(),
        lse, window=window))
    say(phase, f"{part} K2 -> K2-bwd through autograd (sm90 lse, sm90 "
        f"backward) B{batch} S{TRAIN_SEQ} H{cfg.num_heads}/"
        f"{cfg.num_kv_heads} D{cfg.head_dim} window {window} bfloat16: o vs "
        f"the plain forward max_abs_err={float(diff.max()):.3e} violations="
        f"{o_bad} (rtol=atol={tol}); dq, dk, dv vs the plain backward (the "
        f"kernel's o, the plain lse, P and dS rounded to bf16) max_abs_err="
        f"{err:.3e} violations={bad} ({gtol}); vs the float32 plain "
        f"backward ||d||/||want|| {', '.join(f'{x:.3e}' for x in norms)} "
        f"(<= {K2B_NORM})")
    check(o_bad == 0 and bad == 0 and max(norms) <= K2B_NORM,
          f"K2's autograd forward or gradients (window {window}) disagree "
          f"with the plain versions")


def batch_on_card(batch: dict) -> dict:
    return {k: torch.as_tensor(v).to(DEV) for k, v in batch.items()}


def gradient_gate(cfg) -> int:
    """(b) float32, full width cut to 2 layers (layer 0 global, layer 1
    windowed) and one sequence longer than the window: the loss and every
    parameter gradient through the kernels on the card against the same
    weights through the plain versions on the CPU.  Returns the K2-bwd
    (tf32x3) launches of the card's step, counted from 0."""
    cut = dataclasses.replace(cfg, num_layers=2, global_layers=(0,),
                              dtype="float32", remat="none")
    t0 = time.perf_counter()
    batch = SyntheticLM(DataConfig(vocab_size=cut.vocab_size,
                                   seq_len=GATE_TOKENS, global_batch=1,
                                   seed=0)).batch(0)
    result = {}
    host = Model(cut, device="cpu",
                 generator=torch.Generator().manual_seed(0))
    card = Model(cut, device=DEV)
    card.load_state_dict(host.state_dict())
    reset_launches()
    before = (flash_attention.launches_tf32x3,
              flash_attention_bwd.launches_tf32x3, ssd_chunk.launches,
              ssd_chunk_bwd.launches)
    for where, model in (("host", host), ("card", card)):
        model.requires_grad_(True)
        loss = model.loss({k: torch.as_tensor(v).to(model.device)
                           for k, v in batch.items()})
        loss.backward()
        result[where] = (float(loss.detach()),
                         {n: p.grad.detach().double().cpu()
                          for n, p in model.named_parameters()})
    after = (flash_attention.launches_tf32x3,
             flash_attention_bwd.launches_tf32x3, ssd_chunk.launches,
             ssd_chunk_bwd.launches)
    check([a - b for a, b in zip(after, before)] == [2, 2, 2, 2]
          and k2_counts()[::2] == (0, 0) and k2b_counts()[::2] == (0, 0),
          f"(b) the card's step launched K2 (tf32x3), K2-bwd (tf32x3), K3, "
          f"K3-bwd {[a - b for a, b in zip(after, before)]} times, not 2 "
          f"each, or a float32 K2/K2-bwd on sm90 or simt")
    launches = flash_attention_bwd.launches_tf32x3
    (loss_h, g_h), (loss_c, g_c) = result["host"], result["card"]
    rel = {n: float((g_c[n] - g_h[n]).norm() / g_h[n].norm().clamp(
        min=1e-30)) for n in g_h}
    worst = max(rel, key=rel.get)
    loss_rel = abs(loss_c - loss_h) / abs(loss_h)
    say("train", f"(b) float32 gate, {cut.name} cut to 2 layers (windows "
        f"{[0, cut.window]}), 1 x {GATE_TOKENS} tokens: loss card "
        f"{loss_c:.6f} vs cpu {loss_h:.6f} (rel {loss_rel:.2e} <= "
        f"{GATE_LOSS_RTOL}); {len(rel)} gradient leaves, worst "
        f"||g_card - g_cpu|| / ||g_cpu|| = {rel[worst]:.3e} ({worst}) <= "
        f"{GATE_LEAF_RTOL}; {time.perf_counter() - t0:.1f} s")
    check(math.isfinite(loss_c) and loss_rel <= GATE_LOSS_RTOL,
          "(b) the card's loss disagrees with the CPU's")
    check(rel[worst] <= GATE_LEAF_RTOL, f"(b) gradient of {worst} "
          f"disagrees: {rel[worst]}")
    del host, card, result
    torch.cuda.empty_cache()
    return launches


def reset_launches() -> None:
    """Every kernel's launch counts to 0."""
    reset_k2_counts()
    ssd_chunk.launches = ssd_chunk_bwd.launches = 0


def launch_counts() -> dict:
    return {**{f"flash_attention/{r}": n
               for r, n in zip(K2_ROUTES, k2_counts())},
            **{f"flash_attention_bwd/{r}": n
               for r, n in zip(K2_ROUTES, k2b_counts())},
            "ssd_chunk": ssd_chunk.launches,
            "ssd_chunk_bwd": ssd_chunk_bwd.launches}


def add_launches(total: dict, *parts: dict) -> dict:
    """``total`` with each kernel's launches in ``parts`` added."""
    for part in parts:
        for name, n in part.items():
            total[name] += n
    return total


def profile_step(job, state, batch, phase: str = "train",
                 part: str = "(c)") -> tuple[float, float]:
    """One training step under ``torch.profiler``: device-busy share of
    the host wall, the top device ops, and each hand-written kernel's
    share of device time; returns (busy, wall) seconds.  Measurement
    only."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        job.step_fn(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.key not in RANGES]
    check(bool(kern), f"{part} the trace holds no device time")
    busy = sum(e.self_device_time_total for e in kern) / 1e6
    say(phase, f"{part} one step under torch.profiler: wall {wall:.4f} s, "
        f"device busy {busy:.4f} s ({busy / wall * 100:.1f} %, idle "
        f"{(1 - busy / wall) * 100:.1f} %), "
        f"{sum(e.count for e in kern)} kernel launches")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:10]:
        t = e.self_device_time_total / 1e6
        say(phase, f"{part}   {t:.4f} s ({t / busy * 100:.1f} % of busy) "
            f"x{e.count} {e.key[:90]}")
    groups = (("hand-written K2 sm90", ("flash_sm90_kernel",)),
              ("hand-written K2 tf32x3", ("flash_tf32x3_fwd",)),
              ("hand-written K2-bwd sm90", ("flash_bwd_sm90_",)),
              ("hand-written K2-bwd tf32x3", ("flash_bwd_tf32x3_",)),
              ("hand-written K2-bwd simt", ("flash_bwd_",)),
              ("hand-written K3", ("ssd_chunk_tf32x3",)),
              ("hand-written K3-bwd", ("ssd_bwd_",)),
              ("library GEMMs", ("gemm", "nvjet", "cutlass", "Kernel2")))
    seen = set()
    for label, keys in groups:
        mine = [e for e in kern if e.key not in seen
                and any(k in e.key for k in keys)]
        seen.update(e.key for e in mine)
        t = sum(e.self_device_time_total for e in mine) / 1e6
        say(phase, f"{part}   {label}: {t:.4f} s ({t / busy * 100:.1f} % "
            f"of busy), {sum(e.count for e in mine)} launches")
    rest = [e for e in kern if e.key not in seen]
    t = sum(e.self_device_time_total for e in rest) / 1e6
    say(phase, f"{part}   other PyTorch kernels (elementwise, copies, "
        f"reductions, embedding): {t:.4f} s ({t / busy * 100:.1f} % of "
        f"busy), {sum(e.count for e in rest)} launches")
    return busy, wall


def loss_head(model, busy: float) -> None:
    """(c) the loss head alone at the training shape: ``chunked_xent``'s
    forward, its chunks' recompute and backward on random hidden states
    and labels, timed with CUDA events against the traced step's busy
    time.  Its four (T, d) x (d, V) products run in f32, as the
    reference's f32-accumulated head.  Measurement only."""
    cfg = model.cfg
    T = TRAIN_BATCH * TRAIN_SEQ
    g = torch.Generator(DEV).manual_seed(0)
    h = (torch.randn((T, cfg.d_model), generator=g, device=DEV)
         .to(model.unembed().dtype).requires_grad_())
    labels = torch.randint(0, cfg.vocab_size, (T,), generator=g, device=DEV)
    w = model.unembed().detach().requires_grad_()
    ms = cuda_ms(lambda: chunked_xent(h, labels, w, cfg.loss_chunk)
                 .backward())
    flops = 4 * 2.0 * T * cfg.d_model * cfg.vocab_size
    say("train", f"(c) loss head alone ({T} tokens x {cfg.vocab_size} "
        f"logits in chunks of {cfg.loss_chunk}; forward, recompute, "
        f"backward; f32 products): {ms:.4f} ms = {ms / 1e3 / busy * 100:.1f} "
        f"% of the traced step's busy time; its products "
        f"{flops:.4e} FLOP at {flops / ms / 1e9:.2f} TFLOP/s")


def take_steps(phase: str, part: str, job, steps: int, want: dict,
               records: list | None = None):
    """``steps`` steps of ``job`` from its state on its data stream from
    batch 0, each step's kernel launches held to ``want``; with
    ``records`` (``record_moe``'s), each step's kept and dropped (token,
    choice) pairs over the forward's MoE calls (remat's recompute calls
    the layers again).  The peak is read over steps 2.. (over the one step
    when ``steps`` is 1).  Returns (state, the data stream, the losses,
    the times of steps 2.. in s, the peak in bytes)."""
    data = job.data.stream(0)
    state = job.state
    L = sum(hasattr(blk, "moe") for blk in job.model.layers)
    losses, times = [], []
    for step in range(1, steps + 1):
        batch = next(data)
        if step == min(2, steps):
            torch.cuda.reset_peak_memory_stats()
        before = launch_counts()
        if records is not None:
            records.clear()
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = job.step_fn(state, batch)
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        per = {k: v - before[k] for k, v in launch_counts().items()}
        pairs = ""
        if records is not None:
            kept, dropped = kept_dropped(job.cfg, records[:L])
            pairs = (f"; MoE kept {kept}, dropped {dropped} (token, choice) "
                     f"pairs over the forward's {L} layers")
        say(phase, f"{part} step {step}: loss {loss:.4f} grad_norm "
            f"{gnorm:.4f} lr {float(m['lr']):.3e}; {dt:.4f} s; launches "
            f"{per}{pairs}")
        check(math.isfinite(loss) and math.isfinite(gnorm),
              f"{part} step {step}: loss {loss}, grad_norm {gnorm}")
        check(per == want, f"{part} step {step} launched {per}, remat "
              f"{job.cfg.remat} implies {want}")
        losses.append(loss)
        if step > 1:
            times.append(dt)
    return state, data, losses, times, torch.cuda.max_memory_allocated()


def kernel_launches(cfg, dtype, forward: int, backward: int) -> dict:
    """Each kernel's launches over ``forward`` forward and ``backward``
    backward passes of ``cfg``'s layers in ``dtype``: K2 on the route
    ``route`` names and K2-bwd on ``route_bwd``'s once a layer with
    attention, K3 and K3-bwd once a layer with an SSM."""
    Dk, Dv = attention_dims(cfg)
    attn = 0 if cfg.is_attention_free else cfg.num_layers
    ssm = cfg.num_layers if cfg.uses_ssm else 0
    out = dict.fromkeys(launch_counts(), 0)
    out[f"flash_attention/{route(dtype, Dk, Dv)}"] += forward * attn
    out[f"flash_attention_bwd/{route_bwd(dtype, Dk, Dv)}"] += backward * attn
    out["ssd_chunk"] = forward * ssm
    out["ssd_chunk_bwd"] = backward * ssm
    return out


def step_launches(cfg) -> dict:
    """The kernel launches of one training step of ``cfg`` in its dtype:
    K2 and K3 once a layer forward, again in remat's recompute, and their
    backwards once a layer, each on the route its rule names."""
    fwd = 1 if cfg.remat == "none" else 2     # forward, then recompute
    return kernel_launches(cfg, getattr(torch, cfg.dtype), fwd, 1)


def attention_dims(cfg) -> tuple[int, int]:
    """K2's head dims (Dk, Dv) in ``cfg``'s layers: MLA's nope + rope
    query/key dims and its value dim, else the head dim twice."""
    if cfg.attention == "mla":
        return cfg.qk_nope_head_dim + cfg.qk_rope_head_dim, cfg.v_head_dim
    return cfg.head_dim, cfg.head_dim


def model_flop(cfg, n_params: int, batch: int, seq: int,
               windows) -> tuple[float, float]:
    """(6·N·T, attention) model FLOP of one training step: N the active
    parameters (a MoE's routed top-k experts), attention 6·B·H·(Dk+Dv)
    per kept (query, key) pair over the layers."""
    if cfg.uses_moe:
        n_params -= (cfg.num_layers // cfg.moe_every) * (
            cfg.num_experts - cfg.experts_per_token) * 3 * cfg.d_model * cfg.d_ff
    attn = 6.0 * batch * cfg.num_heads * sum(attention_dims(cfg)) * sum(
        band_pairs(seq, seq, True, w) for w in windows)
    return 6.0 * n_params * batch * seq, attn


def train_path(cfg) -> dict:
    """(c) bf16 at full width and depth through ``launch.train``'s own
    objects; returns the launch counts of the steps' run."""
    args = train_cli.parse_args([
        "--arch", cfg.name, "--batch", str(TRAIN_BATCH), "--seq",
        str(TRAIN_SEQ), "--steps", str(TRAIN_STEPS), "--device", DEV])
    t0 = time.perf_counter()
    job, reading = built(lambda: train_cli.build(args),
                         lambda job: tree_flatten(job.state)[0])
    n_params = sum(p.numel() for p in job.model.parameters())
    say("train", f"(c) {job.cfg.name} bf16, remat {job.cfg.remat}, AdamW "
        f"(state {job.opt.state_dtype}), {n_params / 1e9:.4f} B params "
        f"(seed {args.seed}), batch {TRAIN_BATCH} x {TRAIN_SEQ} tokens of "
        f"SyntheticLM (seed {args.seed}); built in "
        f"{time.perf_counter() - t0:.1f} s")
    reset_launches()
    state, data, losses, times, peak = take_steps(
        "train", "(c)", job, TRAIN_STEPS, step_launches(job.cfg))
    launches = launch_counts()
    step_s = float(np.mean(times))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    dense, attn = model_flop(job.cfg, n_params, TRAIN_BATCH, TRAIN_SEQ,
                             job.model.windows)
    flops = dense + attn
    say("train", f"(c) steps 2-{TRAIN_STEPS}: {step_s * 1e3:.2f} ms/step "
        f"({', '.join(f'{t * 1e3:.2f}' for t in times)}), "
        f"{tokens / step_s:.1f} training tokens/s, model "
        f"{flops / step_s / 1e12:.2f} TFLOP/s (6*N*T "
        f"{dense:.4e} + attention {attn:.4e} = "
        f"6*B*H*(Dk+Dv)*band pairs over the "
        f"layers; SSD's intra-chunk products not counted; "
        f"{flops / step_s / PEAK['bfloat16'][0] * 100:.1f} % of the 989 "
        f"TFLOP/s bf16 peak); peak max_memory_allocated "
        f"{peak / 2**30:.3f} GiB; main path launches {launches}")
    MEASURED["step_ms"] = [t * 1e3 for t in times]
    MEASURED["train_loss"] = losses[0]
    MEASURED["step_trace"] = profile_step(job, state, next(data))
    loss_head(job.model, MEASURED["step_trace"][0])
    batch = next(data)
    dryrun_hold("hymba-1.5B training step", job.cfg,
                ShapeSpec("train", "train", TRAIN_SEQ, TRAIN_BATCH),
                lambda: job.step_fn(state, batch), reading, step_s,
                "step time")
    del job, state
    torch.cuda.empty_cache()
    return launches


def runner_cut(cfg):
    """Phase 7 (d)'s configuration: full width, 2 layers (one global), and
    its batches (2 x ``TRAIN_SEQ`` tokens of ``SyntheticLM``, seed 0)."""
    cut = dataclasses.replace(cfg, num_layers=2, global_layers=(0,))
    return cut, SyntheticLM(DataConfig(vocab_size=cut.vocab_size,
                                       seq_len=TRAIN_SEQ, global_batch=2,
                                       seed=0))


def runner_job(cut, seed):
    """A model of ``cut`` from ``seed`` with bf16 AdamW: the runner's
    state and step function."""
    model = Model(cut, device=DEV,
                  generator=torch.Generator(DEV).manual_seed(seed))
    opt = AdamW(learning_rate=cosine_schedule(1e-3, warmup=20, total=100),
                state_dtype=torch.bfloat16)
    step = make_train_step(model, opt)
    return init_state(model, opt), (
        lambda state, batch: step(state, batch_on_card(batch)))


def checkpoint_round_trip(cfg) -> None:
    """(d) bf16 at the 2-layer full-width cut through
    ``FaultTolerantRunner``: run A takes 2 steps and checkpoints; a fresh
    model and optimizer (other weights) restore it and must hold every
    parameter and optimizer state bit for bit; then both take step 3 on the
    same batch, whose losses must be equal."""
    cut, data = runner_cut(cfg)
    losses = {}
    with tempfile.TemporaryDirectory() as tmp:
        runners = {}
        for name, seed in (("A", 0), ("B", 1)):
            state, step_fn = runner_job(cut, seed)
            runners[name] = FaultTolerantRunner(
                RunnerConfig(checkpoint_dir=tmp, checkpoint_every=2),
                step_fn=step_fn, state=state)
        a, b = runners["A"], runners["B"]
        a.run(data.stream(0), 2)
        check(store.latest_step(tmp) == 2, "(d) no checkpoint at step 2")
        check(b.restore_latest() and b.step == 2, "(d) restore failed")
        leaves_a, leaves_b = store.flatten(a.state), store.flatten(b.state)
        same = [ka == kb and x.dtype == y.dtype and torch.equal(x, y)
                for (ka, x), (kb, y) in zip(leaves_a, leaves_b)]
        check(len(leaves_a) == len(leaves_b) and all(same),
              f"(d) {same.count(False)} of {len(same)} leaves differ after "
              f"restore")
        for name, r in runners.items():
            r.run(data.stream(2), 3, on_metrics=lambda s, m, name=name:
                  losses.setdefault(name, float(m["loss"])))
    say("train", f"(d) checkpoint round trip at {cut.name} cut to 2 layers, "
        f"bf16, batch 2 x {TRAIN_SEQ}: {len(leaves_a)} leaves (params, "
        f"AdamW m/v, step) bit-equal after restore into a fresh model "
        f"and optimizer; step 3 loss {losses['A']:.6f} uninterrupted vs "
        f"{losses['B']:.6f} restored")
    check(losses["A"] == losses["B"], "(d) the restored run's step-3 loss "
          "differs from the uninterrupted run's")
    del runners, a, b
    torch.cuda.empty_cache()


def train(gen) -> tuple[dict, dict, dict]:
    """Train phase: (a) the backward kernels' rows, (b) the float32 gate,
    (c) the path, (d) the checkpoint round trip."""
    cfg = get_config(SERVE_ARCH)
    t0 = time.perf_counter()
    f32, bf16 = torch.float32, torch.bfloat16
    for dt in (f32, bf16):
        for label, B, S, H, KH, Dk, Dv, window in (
                ("test", 1, 128, 4, 4, 64, 64, 0),
                ("test-gqa-window-ragged", 2, 77, 4, 2, 32, 32, 20),
                ("test-mla", 1, 70, 2, 2, 96, 64, 0),
                ("test-head-dim-160", 1, 130, 8, 2, 160, 160, 0),
                ("test-head-dim-40-window", 2, 200, 4, 2, 40, 40, 16)):
            flash_bwd_row(label, gen, B, S, H, KH, Dk, Dv, window, dt)
    # float32 at the head dims the sm90 rows below cover in bf16
    for label, B, S, H, KH, Dk, Dv, window in (
            ("test-head-dim-128", 1, 200, 8, 2, 128, 128, 0),
            ("test-head-dim-256-window", 2, 130, 4, 2, 256, 256, 64)):
        flash_bwd_row(label, gen, B, S, H, KH, Dk, Dv, window, f32,
                      twice=True)
    for label, B, S, H, KH, Dk, Dv in F32_ZOO_ROWS:
        flash_bwd_row(label, gen, B, S, H, KH, Dk, Dv, 0, f32, twice=True)
    # K2-bwd with q_offset on both routes and on simt's two entries named
    # (as phase 3 runs K2), bit-equal on rerun.
    for label, B, S, H, KH, Dk, Dv, window, causal, off, skv in \
            K2_OFFSET_ROWS:
        for dt in (f32, bf16):
            for kind in (None, "simt"):
                flash_bwd_row(label, gen, B, S, H, KH, Dk, Dv, window, dt,
                              twice=True, causal=causal, q_offset=off,
                              skv=skv, kind=kind)
    # K2-bwd sm90 at head dims in (128, 256]: the two-warpgroup kernels.
    for label, B, S, H, KH, Dk, Dv, window, off, skv in K2B_WIDE_ROWS:
        flash_bwd_row(label, gen, B, S, H, KH, Dk, Dv, window, bf16,
                      twice=True, q_offset=off, skv=skv)
    for label, shape, dt in (
            ("test", (1, 2, 16, 4, 1, 16, 16), f32),
            ("test-grouped", (2, 3, 32, 4, 2, 32, 16), f32),
            ("test-mamba2-dims", (1, 1, 64, 8, 1, 64, 128), f32),
            ("ragged-q", (2, 1, 37, 8, 2, 64, 16), f32),
            ("test-bf16", (1, 2, 32, 4, 1, 32, 32), bf16)):
        ssd_bwd_row(label, gen, *shape, dt)
    k2b = {(dt, window): flash_bwd_row(
        "train-path", gen, TRAIN_BATCH, TRAIN_SEQ, cfg.num_heads,
        cfg.num_kv_heads, cfg.head_dim, cfg.head_dim, window, dt,
        twice=True)
        for dt in (bf16, f32) for window in (cfg.window, 0)}
    k2b_simt = flash_bwd_row(
        "train-path", gen, TRAIN_BATCH, TRAIN_SEQ, cfg.num_heads,
        cfg.num_kv_heads, cfg.head_dim, cfg.head_dim, cfg.window, f32,
        kind="simt")
    torch.cuda.empty_cache()
    k3b = ssd_bwd_row("train-path", gen, TRAIN_BATCH,
                      TRAIN_SEQ // cfg.ssm_chunk, cfg.ssm_chunk,
                      cfg.ssm_heads, cfg.ssm_groups, cfg.ssm_head_dim,
                      cfg.ssm_state, f32, twice=True)
    k2_lse(gen, cfg)
    for window in (cfg.window, 0):
        flash_autograd_row(gen, cfg, window)
    torch.cuda.empty_cache()
    say("train", f"(a) done in {time.perf_counter() - t0:.1f} s")
    launches = {"flash_attention_bwd/tf32x3": gradient_gate(cfg)}
    launches.update((k, v) for k, v in train_path(cfg).items()
                    if k != "flash_attention_bwd/tf32x3")
    checkpoint_round_trip(cfg)
    return {"sm90": k2b[(bf16, cfg.window)],
            "tf32x3": k2b[(f32, cfg.window)], "simt": k2b_simt}, k3b, launches

# ---------------------------------------------------------------------------
# Phase 8: dbrx-132B (MoE) served at full width, depth cut
# ---------------------------------------------------------------------------


def moe_layers(model) -> list:
    return [blk.moe for blk in model.layers if hasattr(blk, "moe")]


def moe_input(model):
    """A forward pre-hook on ``model``'s first MoE layer that keeps its last
    input (tokens, d) in the returned dict under "x"; and the hook."""
    seen: dict = {}
    layer = moe_layers(model)[0]
    hook = layer.register_forward_pre_hook(
        lambda m, args: seen.__setitem__(
            "x", args[0].detach().reshape(-1, args[0].shape[-1])))
    return seen, hook


def kept_slots(model, x: torch.Tensor) -> list:
    """(expert ids, slot, keep) of every (token, choice) of the first MoE
    layer's input ``x``, on the host: the layer's router and dispatch."""
    layer = moe_layers(model)[0]
    cfg = layer.cfg
    with torch.inference_mode():
        _, top_i = moe.route(x, layer.router, cfg.experts_per_token)
        return [t.cpu() for t in (top_i, *moe.dispatch(
            top_i, e_off=0, num_local=cfg.num_experts,
            capacity=moe.capacity_for(x.shape[0], cfg)))]


def record_moe(layers, records: list, routed: dict | None = None) -> None:
    """Shadow each MoE layer's ``moe_local`` with an instance attribute that
    appends (tokens, per-expert counts) of every call to ``records``; with
    ``routed``, the first layer also routes a prefill's input again (router
    and dispatch only) and keeps (expert ids, keep) in ``routed[tokens]``.
    ``del layer.moe_local`` restores the method."""
    def recording(m, first):
        inner = m.moe_local

        def moe_local(x, **kw):
            out, counts = inner(x, **kw)
            records.append((x.shape[0], counts))
            if (first and routed is not None
                    and x.shape[0] > SERVE_REQUESTS):      # a prefill
                _, top_i = moe.route(x, m.router, m.cfg.experts_per_token)
                routed[x.shape[0]] = top_i, moe.dispatch(
                    top_i, e_off=kw["e_off"], num_local=kw["num_local"],
                    capacity=kw["capacity"])[1]
            return out, counts
        return moe_local

    for i, m in enumerate(layers):
        m.moe_local = recording(m, i == 0)


def pad_drops(cut, bucket, top_i, keep) -> str:
    """Who fills and who loses a prefill's expert slots: per expert, the
    (token, choice) pairs routed from left-padding and from real tokens,
    and the dropped pairs of each kind."""
    pad = (bucket_tokens(bucket).reshape(-1) == 0)[:, None].expand_as(top_i)
    E = cut.num_experts
    per = [torch.bincount(top_i[sel], minlength=E).tolist()
           for sel in (pad, ~pad)]
    lost = [int((~keep & sel).sum()) for sel in (pad, ~pad)]
    return (f"routed per expert from pads {per[0]}, from real tokens "
            f"{per[1]}; dropped {lost[0]} pad and {lost[1]} real choices "
            f"of {int(pad.sum())} and {int((~pad).sum())}")


def kept_dropped(cfg, records) -> tuple[int, int]:
    """(kept, dropped) (token, choice) pairs over MoE calls recorded as
    (tokens, per-expert counts): an expert keeps at most its capacity."""
    kept = sum(int(torch.clamp(counts, max=moe.capacity_for(T, cfg)).sum())
               for T, counts in records)
    total = sum(T * cfg.experts_per_token for T, _ in records)
    return kept, total - kept


def moe_gate(cfg, card: str) -> int:
    """(a) float32, full width cut to 1 layer, one seeded prompt: the
    prefill on the card (K2 tf32x3, the MoE on cuBLAS) against the same
    weights moved to the CPU (the plain versions); the last-token logits
    at ``PREFILL_DECODE_TOL`` and the (expert, slot) of every (token,
    choice) identical.  The host's logits are kept for phase 9 (b)'s
    gate.  Returns K2's tf32x3 launches."""
    cut = dataclasses.replace(cfg, num_layers=1, dtype="float32")
    prompt = torch.as_tensor(np.random.default_rng(1).integers(
        1, cfg.vocab_size, MOE_GATE_TOKENS)[None])
    model = Model(cut, device=DEV,
                  generator=torch.Generator(DEV).manual_seed(0))
    seen, hook = moe_input(model)
    T, k = MOE_GATE_TOKENS, cut.experts_per_token
    C = moe.capacity_for(T, cut)
    reset_k2_counts()
    logits, times, slots = {}, {}, {}
    for where in ("cuda", "cpu"):
        model.to(where)
        t0 = time.perf_counter()
        with torch.inference_mode():
            logits[where] = model.prefill(
                {"tokens": prompt.to(where)})[0][0].cpu()
        slots[where] = kept_slots(model, seen["x"])
        times[where] = time.perf_counter() - t0
    hook.remove()
    MEASURED["moe_host_logits"] = logits["cpu"]
    sm90, f32, simt = k2_counts()
    check((sm90, f32, simt) == (0, 1, 0), f"(a) the card's float32 prefill "
          f"launched K2 sm90 {sm90}, tf32x3 {f32}, simt {simt} times, not 0, "
          f"1 and 0")
    err = float((logits["cuda"] - logits["cpu"]).abs().max())
    ok = torch.allclose(logits["cuda"], logits["cpu"],
                        rtol=PREFILL_DECODE_TOL, atol=PREFILL_DECODE_TOL)
    differ = int((slots["cuda"][0] != slots["cpu"][0]).any(-1).sum())
    same_slots = all(torch.equal(a, b)
                     for a, b in zip(slots["cuda"], slots["cpu"]))
    kept = int(slots["cpu"][2].sum())
    say("moe", f"(a) float32 gate, {cut.name} cut to 1 layer, 1 x {T} "
        f"tokens (seed 1), capacity {C} per expert: last-token logits card "
        f"vs cpu max_abs_err={err:.3e}, logits std "
        f"{float(logits['cpu'].std()):.3e}, allclose(rtol=atol="
        f"{PREFILL_DECODE_TOL})={ok}; MoE (token, choice) -> (expert, slot) "
        f"identical={same_slots} ({differ} tokens route differently), kept "
        f"{kept}, dropped {T * k - kept} of {T * k} choices; card "
        f"{times['cuda']:.2f} s, cpu {times['cpu']:.2f} s (prefill and "
        f"dispatch); {card}")
    check(bool(torch.isfinite(logits["cuda"]).all()),
          "(a) the card's logits are not finite")
    check(ok, "(a) the card's float32 prefill disagrees with the CPU's")
    check(same_slots, "(a) the card's MoE keeps other (expert, slot) pairs "
          "than the CPU's")
    del model, seen
    gc.collect()
    torch.cuda.empty_cache()
    return f32


def moe_breakdown(phase: str, label: str, result, part: str) -> None:
    """Device time of a trace by kind: K2, each MoE stage (its
    ``record_function`` range: the router; dispatch = sort, positions and
    the scatter/gather into the expert buffer; the expert products; the
    combine's gathers and sum) and the rest."""
    from torch.autograd import DeviceType

    prof, kern, busy = result
    parts = {name: 0.0 for name in MOE_RANGES}
    for e in prof.events():
        if e.name in parts and e.device_type == DeviceType.CPU:
            parts[e.name] += e.device_time_total / 1e6
    k2 = sum(e.self_device_time_total for e in kern
             if "flash_sm90_kernel" in e.key) / 1e6
    rest = busy - k2 - sum(parts.values())
    say(phase, f"{part}   {label} by kind: K2 sm90 {k2:.4f} s "
        f"({k2 / busy * 100:.1f} %), " + ", ".join(
            f"{n} {t:.4f} s ({t / busy * 100:.1f} %)"
            for n, t in parts.items())
        + f", everything else {rest:.4f} s ({rest / busy * 100:.1f} %)")


def serve_moe_buckets(phase: str, part: str, model, buckets, warm,
                      card: str, routed: dict | None = None) -> dict:
    """``buckets`` through a ``ServingEngine`` of ``model`` (``warm``
    first, not counted): each prefill launches K2 once a layer, all on
    sm90, and every completion holds in-vocabulary tokens; per bucket the
    time, the peak and the kept and dropped (token, choice) pairs of the
    prefill and of the decode steps over the MoE layers; with ``routed``,
    who the first MoE layer drops at prefill, pads or real tokens.
    Returns the buckets' launches."""
    cut = model.cfg
    engine = ServingEngine(model)
    layers = moe_layers(model)
    records: list = []
    record_moe(layers, records, routed)
    engine.generate(warm)
    L, n_moe = cut.num_layers, len(layers)
    reset_launches()
    for gi, bucket in enumerate(buckets):
        B = len(bucket)
        plen = max(len(r.tokens) for r in bucket)
        records.clear()
        sm0, f0 = flash_attention.launches_sm90, flash_attention.launches
        torch.cuda.reset_peak_memory_stats()
        done = engine.generate(bucket)
        peak = torch.cuda.max_memory_allocated()
        df = flash_attention.launches - f0
        dsm = flash_attention.launches_sm90 - sm0
        check(df == L and dsm == df, f"{part} bucket {gi}: one prefill "
              f"launched K2 {df} times ({dsm} sm90), not {L}, all sm90")
        pre, dec = records[:n_moe], records[n_moe:]
        check([T for T, _ in pre] == [B * plen] * n_moe
              and all(T == B for T, _ in dec),
              f"{part} bucket {gi}: MoE calls of "
              f"{[T for T, _ in records]} tokens")
        (pk, pd), (dk, dd) = kept_dropped(cut, pre), kept_dropped(cut, dec)
        for c in done:
            check(len(c.tokens) == SERVE_MAX_NEW and bool(
                ((c.tokens >= 0) & (c.tokens < cut.vocab_size)).all()),
                f"{part} completion {c.uid}: {c.tokens}")
        real = sum(len(r.tokens) for r in bucket)
        pre_s, dec_s = done[0].prefill_s, done[0].decode_s
        say(phase, f"{part} bucket {gi}: {B} requests, prompts padded to "
            f"{plen} ({real} real tokens); prefill {pre_s:.4f} s = "
            f"{B * plen / pre_s:.1f} tok/s ({real / pre_s:.1f} real tok/s);"
            f" decode {SERVE_MAX_NEW - 1} steps {dec_s:.4f} s = "
            f"{B * (SERVE_MAX_NEW - 1) / dec_s:.1f} tok/s "
            f"({dec_s / (SERVE_MAX_NEW - 1) * 1e3:.2f} ms/step); MoE "
            f"capacity {moe.capacity_for(B * plen, cut)} per expert at "
            f"prefill: kept {pk}, dropped {pd} choices over {n_moe} MoE "
            f"layers (decode: kept {dk}, dropped {dd}); peak "
            f"max_memory_allocated {peak / 2**30:.3f} GiB; K2 +{df} (sm90); "
            f"first completion {done[0].tokens.tolist()}; {card}")
        if routed is not None:
            say(phase, f"{part} bucket {gi}, first MoE layer's prefill: "
                + pad_drops(cut, bucket, *routed[B * plen]) + f"; {card}")
    for m in layers:
        del m.moe_local
    return launch_counts()


def moe_serve(cfg, card: str) -> tuple[int, int, int]:
    """(b) bf16 at full width cut to ``MOE_LAYERS`` layers: phase 6 (b)'s
    traffic through ``PoasDispatcher`` and ``ServingEngine``, K2 launched
    once per layer per prefill, all on sm90, and who the first MoE layer
    drops at prefill, pads or real tokens; (c) the larger bucket traced,
    its prefill and decode logits finite; (e) the MoE layer twice at that
    bucket's shape, bit-equal.  Returns
    (K2 sm90 launches of (b), the larger bucket's batch and padded
    length)."""
    cut = dataclasses.replace(cfg, num_layers=MOE_LAYERS)
    free0, total = torch.cuda.mem_get_info()
    t0 = time.perf_counter()
    model = Model(cut, device=DEV,
                  generator=torch.Generator(DEV).manual_seed(0))
    torch.cuda.synchronize()
    free1, _ = torch.cuda.mem_get_info()
    n_params = sum(p.numel() for p in model.parameters())
    wbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    say("moe", f"(b) {cut.name} bf16 cut to {MOE_LAYERS} of "
        f"{cfg.num_layers} layers: {n_params / 1e9:.4f} B params, "
        f"{wbytes / 1e9:.3f} GB of weights (seed 0), built in "
        f"{time.perf_counter() - t0:.1f} s; memory_allocated "
        f"{torch.cuda.memory_allocated() / 1e9:.3f} GB; mem_get_info free "
        f"{free0 / 1e9:.3f} -> {free1 / 1e9:.3f} GB of {total / 1e9:.3f} GB "
        f"(the allocator also keeps the init's float32 draws cached)")
    buckets, warm = serve_traffic("moe", cut)
    launches = serve_moe_buckets("moe", "(b)", model, buckets, warm, card,
                                 routed={})["flash_attention/sm90"]
    big = max(buckets, key=len)
    profile_serve("moe", model, big, moe_breakdown)

    # (e) the MoE layer twice at the larger bucket's prefill shape
    B, S = len(big), max(len(r.tokens) for r in big)
    layer = moe_layers(model)[0]
    x = torch.randn((B, S, cut.d_model), generator=torch.Generator(
        DEV).manual_seed(5), device=DEV).to(layer.w_in.dtype)
    with torch.inference_mode():
        (a, ca), (b, cb) = (layer.moe_local(
            x.view(B * S, cut.d_model), e_off=0, num_local=cut.num_experts,
            capacity=moe.capacity_for(B * S, cut)) for _ in range(2))
        same_out = torch.equal(a, b) and torch.equal(ca, cb)
    say("moe", f"(e) the MoE layer twice at {B} x {S} x {cut.d_model} "
        f"{x.dtype} on the card: outputs and counts bit-equal={same_out}")
    check(same_out, "(e) two runs of the MoE layer differ")
    del model, layer, a, b, x
    gc.collect()
    torch.cuda.empty_cache()
    return launches, B, S


def moe_graph(fitted, card: str) -> None:
    """(f) the same model as a task graph: ``TaskGraphDomain`` plans
    ``moe_stack`` at the depth cut over phase 4's fitted host and card."""
    t0 = time.perf_counter()
    g = moe_stack(MOE_ARCH, layers=MOE_LAYERS)
    plan = POAS(TaskGraphDomain(fitted, bus="serialized")).plan(g)
    viol = verify_graph_dependencies(g, plan.schedule.timeline)
    shares = plan.optimize.shares()
    say("moe", f"(f) moe_stack({MOE_ARCH!r}, layers={MOE_LAYERS}): "
        f"{len(g)} tasks, {len(g.edges)} edges, {g.total_ops():.4e} ops, "
        f"planned by TaskGraphDomain over phase 4's fitted profiles in "
        f"{time.perf_counter() - t0:.2f} s: predicted makespan "
        f"{plan.optimize.makespan:.6f} s; shares " + ", ".join(
            f"{d.name} {x * 100:.2f} % ({len(plan.adapted.tasks_of(d.name))}"
            f" tasks)" for d, x in zip(fitted, shares))
        + f"; dependency violations {len(viol)}; {card}")
    check(viol == [], f"(f) the planned timeline breaks dependencies: "
          f"{viol[:3]}")


def moe_remesh(cfg) -> None:
    """(f) phase 7 (d)'s runner re-homed through ``remesh`` with a two-pod
    ``HeteroBatchScheduler``: the lost pod leaves the split, the state is
    restored bit for bit at the same step."""
    cut, data = runner_cut(cfg)
    pods = [PodProfile(f"pod{i}", chips=1, peak_flops=PEAK["bfloat16"][0])
            for i in range(2)]
    sched = HeteroBatchScheduler(pods, flops_per_token=6 * cut.param_count(),
                                 seq_len=TRAIN_SEQ)
    with tempfile.TemporaryDirectory() as tmp:
        state, step_fn = runner_job(cut, 0)
        runner = FaultTolerantRunner(
            RunnerConfig(checkpoint_dir=tmp, checkpoint_every=2),
            step_fn=step_fn, state=state)
        runner.run(data.stream(0), 2)
        before = [(k, x.clone()) for k, x in store.flatten(runner.state)]
        split = sched.plan(8)
        runner.remesh(DEV, scheduler=sched, lost=("pod1",))
        after = store.flatten(runner.state)
        alone = sched.plan(8)
        same = len(before) == len(after) and all(
            ka == kb and torch.equal(x, y)
            and y.device.type == torch.device(DEV).type
            for (ka, x), (kb, y) in zip(before, after))
    say("moe", f"(f) FaultTolerantRunner.remesh({DEV!r}, scheduler=, "
        f"lost=('pod1',)) at step {runner.step}: batch of 8 split "
        f"{split.sizes} before, {alone.sizes} after over "
        f"{[p.name for p in sched.pods]}; {len(after)} leaves restored "
        f"bit-equal={same}")
    check(alone.sizes == (8,) and [p.name for p in sched.pods] == ["pod0"],
          f"(f) the split after pod1 left is {alone.sizes}")
    check(same and runner.step == 2, "(f) remesh lost the state")
    del runner, state, before, after
    torch.cuda.empty_cache()


def moe_phase(gen, fitted, card: str) -> tuple[dict, dict]:
    """Phase 8: dbrx-132B, MoE on every layer, at full width."""
    cfg = get_config(MOE_ARCH)
    gc.collect()
    torch.cuda.empty_cache()
    say("moe", f"{cfg.name}: d_model {cfg.d_model}, {cfg.num_heads}/"
        f"{cfg.num_kv_heads} heads of {cfg.head_dim}, full causal "
        f"attention, {cfg.num_experts} experts top-{cfg.experts_per_token} "
        f"of d_ff {cfg.d_ff}, capacity factor {cfg.moe_capacity_factor}, "
        f"vocab {cfg.vocab_size}; {cfg.param_count() / 1e9:.3f} B params "
        f"over {cfg.num_layers} layers (ArchConfig.param_count); "
        f"mem_get_info free {torch.cuda.mem_get_info()[0] / 1e9:.3f} GB; "
        f"{card}")
    t0 = time.perf_counter()
    f32 = moe_gate(cfg, card)
    sm90, B, S = moe_serve(cfg, card)
    # (d) K2 at the serving path's dbrx shape (the larger bucket)
    row = flash_row("dbrx-serve-path", gen, B, S, cfg.num_heads,
                    cfg.num_kv_heads, cfg.head_dim, cfg.head_dim, 0,
                    torch.bfloat16)
    torch.cuda.empty_cache()
    moe_graph(fitted, card)
    moe_remesh(get_config(SERVE_ARCH))
    say("moe", f"done in {time.perf_counter() - t0:.1f} s")
    return row, {"flash_attention/sm90": sm90, "flash_attention/tf32x3": f32}



# ---------------------------------------------------------------------------
# Phase 9: the sharded layer, dbrx-132B's expert-parallel MoE under a mesh
# ---------------------------------------------------------------------------


class MoeCalls:
    """Shadows ``models.moe.moe_local`` (which ``MoE.forward`` and the
    expert-parallel ``moe_block`` both call): per call, the (token,
    choice) pairs its own experts keep and drop, and, with ``slots``, the
    kept (token, choice, expert, slot) rows, global expert ids."""

    def __init__(self, slots: bool = False):
        self.calls: list[dict] = []
        self.slots = slots

    def __enter__(self):
        self.inner = moe.moe_local

        def recording(p, x, cfg, *, e_off, num_local, capacity):
            out, counts = self.inner(p, x, cfg, e_off=e_off,
                                     num_local=num_local, capacity=capacity)
            mine = counts[e_off:e_off + num_local]
            kept = int(torch.clamp(mine, max=capacity).sum())
            rec = {"tokens": x.shape[0], "kept": kept,
                   "dropped": int(mine.sum()) - kept}
            if self.slots:
                _, top_i = moe.route(x, p["router"], cfg.experts_per_token)
                slot, keep = moe.dispatch(top_i, e_off=e_off,
                                          num_local=num_local,
                                          capacity=capacity)
                tok, ch = torch.nonzero(keep, as_tuple=True)
                sl = slot[tok, ch]
                rec["slots"] = {tuple(r) for r in torch.stack(
                    [tok, ch, sl // capacity + e_off, sl % capacity],
                    1).tolist()}
            self.calls.append(rec)
            return out, counts

        moe.moe_local = recording
        return self

    def __exit__(self, *exc):
        moe.moe_local = self.inner


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def serve_run(label: str, model, engine, buckets, warm, card: str) -> dict:
    """Phase 6 (b)'s buckets through ``engine``: each prefill's logits (the
    engine's ``model.prefill``, shadowed), the completions, MoE kept and
    dropped pairs per call, K2 launches from 0 and peak memory."""
    engine.generate(warm)                              # warm-up, not counted
    logits: list = []
    prefill = model.prefill

    def recording(batch):
        out = prefill(batch)
        logits.append(out[0].clone())
        return out

    model.prefill = recording
    reset_k2_counts()
    torch.cuda.reset_peak_memory_stats()
    with MoeCalls() as calls:
        done = [engine.generate(b) for b in buckets]
    peak = torch.cuda.max_memory_allocated()
    sm90, f32, simt = k2_counts()
    del model.prefill
    big = max(buckets, key=len)
    tokens = bucket_tokens(big)
    with torch.inference_mode():
        result = traced("shard", f"{label}: prefill of {len(big)} x "
                        f"{tokens.shape[1]}",
                        lambda: model.prefill({"tokens": tokens}), 1, "(a)")
    check(result is not None, f"(a) {label}: the trace holds no device time")
    for gi, (bucket, d) in enumerate(zip(buckets, done)):
        B, plen = len(bucket), max(len(r.tokens) for r in bucket)
        say("shard", f"(a) {label}, bucket {gi}: {B} x {plen}, prefill "
            f"{d[0].prefill_s:.4f} s, decode {SERVE_MAX_NEW - 1} steps "
            f"{d[0].decode_s:.4f} s; first completion "
            f"{d[0].tokens.tolist()}")
    say("shard", f"(a) {label}: K2 launches sm90 {sm90}, tf32x3 {f32}, "
        f"simt {simt} over "
        f"{len(buckets)} prefills; MoE calls {len(calls.calls)}, kept "
        f"{sum(c['kept'] for c in calls.calls)}, dropped "
        f"{sum(c['dropped'] for c in calls.calls)}; peak "
        f"max_memory_allocated {peak / 2**30:.3f} GiB; {card}")
    return {"logits": logits, "tokens": [[c.tokens for c in d] for d in done],
            "calls": [(c["tokens"], c["kept"], c["dropped"])
                      for c in calls.calls], "sm90": sm90, "tf32x3": f32,
            "simt": simt,
            "busy": result[2]}


def shard_world1(card: str) -> int:
    """(a) One process, NCCL at world size 1, mesh (1, 1): dbrx-132B bf16
    at full width cut to ``SHARD_LAYERS`` layers, phase 6 (b)'s traffic with
    no mesh and then placed by ``shard_params`` under ``use_mesh``; then
    ``compressed_psum_mean`` over NCCL.  Returns the sharded run's K2
    sm90 launches."""
    cfg = dataclasses.replace(get_config(MOE_ARCH), num_layers=SHARD_LAYERS)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", rank=0, world_size=1)
    try:
        torch.cuda.set_device(0)
        mesh = make_debug_mesh((1, 1))
        say("shard", f"(a) NCCL world 1, mesh {tuple(mesh.shape)} "
            f"{mesh.mesh_dim_names} on {mesh.device_type}")
        model, reading = built(
            lambda: Model(cfg, device=DEV,
                          generator=torch.Generator(DEV).manual_seed(0)),
            lambda model: list(model.parameters()))
        wbytes = sum(p.numel() * p.element_size() for p in model.parameters())
        say("shard", f"(a) {cfg.name} bf16 cut to {SHARD_LAYERS} of 40 "
            f"layers: {wbytes / 1e9:.3f} GB of weights (seed 0)")
        engine = ServingEngine(model)
        buckets, warm = serve_traffic("shard", cfg)
        plain = serve_run("no mesh", model, engine, buckets, warm, card)
        tokens = bucket_tokens(max(buckets, key=len))
        dryrun_hold(f"dbrx-132B ({SHARD_LAYERS} layers) prefill", cfg,
                    ShapeSpec("prefill", "prefill", tokens.shape[1],
                              tokens.shape[0]),
                    lambda: model.prefill({"tokens": tokens}), reading,
                    plain["busy"], "traced device-busy time")
        shard_params(model, mesh)
        check(all(isinstance(p, DTensor) for p in model.parameters()),
              "(a) shard_params left a parameter that is not a DTensor")
        with use_mesh(mesh):
            ep = serve_run("mesh (1, 1)", model, engine, buckets, warm, card)
        same_logits = all(torch.equal(a, b) for a, b in
                          zip(plain["logits"], ep["logits"]))
        same_tokens = all(np.array_equal(a, b) for x, y in
                          zip(plain["tokens"], ep["tokens"])
                          for a, b in zip(x, y))
        say("shard", f"(a) prefill logits bit-equal={same_logits}, greedy "
            f"tokens identical={same_tokens}, kept/dropped pairs equal="
            f"{plain['calls'] == ep['calls']}; traced prefill device busy "
            f"{plain['busy']:.4f} s with no mesh, {ep['busy']:.4f} s on the "
            f"mesh; {card}")
        check(len(ep["logits"]) == len(buckets) and same_logits,
              "(a) the mesh's prefill logits differ from the unsharded ones")
        check(same_tokens, "(a) the mesh's greedy tokens differ")
        check(plain["calls"] == ep["calls"],
              "(a) the mesh keeps or drops other MoE pairs")
        for run in (plain, ep):
            check(run["sm90"] == SHARD_LAYERS * len(buckets)
                  and run["simt"] == run["tf32x3"] == 0, f"(a) K2 launched "
                  f"sm90 {run['sm90']}, tf32x3 {run['tf32x3']}, simt "
                  f"{run['simt']} times, not {SHARD_LAYERS} sm90 a prefill")
        del model, engine
        gc.collect()
        torch.cuda.empty_cache()

        x = torch.randn(1 << 22, generator=torch.Generator(DEV).manual_seed(3),
                        device=DEV)
        step = float(x.abs().max()) / 127.0
        with use_mesh(mesh):
            outs = {mode: compressed_psum_mean(
                x, "model", torch.Generator(DEV).manual_seed(4), mode=mode)
                for mode in ("none", "bf16", "int8")}
        err = float((outs["int8"] - x).abs().max())
        say("shard", f"(a) compressed_psum_mean over NCCL ({x.numel()} f32 "
            f"on the card): none equal={torch.equal(outs['none'], x)}, "
            f"bf16 equal to x in bf16="
            f"{torch.equal(outs['bf16'], x.bfloat16().float())}, int8 "
            f"max_abs_err {err:.3e} (one step {step:.3e})")
        check(torch.equal(outs["none"], x), "(a) psum 'none' changed x")
        check(torch.equal(outs["bf16"], x.bfloat16().float()),
              "(a) psum 'bf16' is not x rounded to bf16")
        # tests/test_distributed.py's bound: one step (x 1.01 for the f32
        # rounding of q * scale)
        check(err <= step * 1.01,
              "(a) psum 'int8' is off by more than one step")
    finally:
        dist.destroy_process_group()
    return ep["sm90"]


def shard_close(got: torch.Tensor, want: torch.Tensor,
                host: torch.Tensor) -> tuple[bool, str]:
    """(b)-(e): float32 logits of the mesh against the unsharded run's on
    the card, held to ``SHARD_SPREAD`` times the largest distance of the
    host's float32 logits of the same weights and prompt from that run;
    the gate's text, with allclose at rtol = atol = ``SHARD_TOL`` beside
    it as a reading.  The yardstick itself is held to phase 8 (a)'s gate
    of the host against the card."""
    check(torch.allclose(host, want, rtol=PREFILL_DECODE_TOL,
                         atol=PREFILL_DECODE_TOL),
          "the host's float32 logits disagree with the unsharded card run's")
    err = float((got - want).abs().max())
    spread = float((host - want).abs().max())
    ok = err <= SHARD_SPREAD * spread
    tight = torch.allclose(got, want, rtol=SHARD_TOL, atol=SHARD_TOL)
    return ok, (f"<= {SHARD_SPREAD} x the host's float32 distance "
                f"{spread:.3e}: {ok} (allclose(rtol=atol={SHARD_TOL}) "
                f"{tight})")


def shard_rank(rank: int, world: int, store: str, out: str) -> None:
    """(b) One rank on the one card over gloo: dbrx-132B float32 at full
    width cut to 1 layer; phase 8 (a)'s prompt prefilled unsharded, then
    with the parameters placed on mesh (1, 2) under ``use_mesh``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        cfg = dataclasses.replace(get_config(MOE_ARCH), num_layers=1,
                                  dtype="float32")
        prompt = torch.as_tensor(np.random.default_rng(1).integers(
            1, cfg.vocab_size, MOE_GATE_TOKENS)[None]).to(DEV)
        model = Model(cfg, device=DEV,
                      generator=torch.Generator(DEV).manual_seed(0))
        with MoeCalls(slots=True) as plain, torch.inference_mode():
            want = model.prefill({"tokens": prompt})[0]
        mesh = make_debug_mesh((1, SHARD_RANKS))
        shard_params(model, mesh)
        gc.collect()
        torch.cuda.empty_cache()
        held = sum(p.to_local().numel() * 4 for p in model.parameters())
        reset_k2_counts()
        torch.cuda.reset_peak_memory_stats()
        with MoeCalls(slots=True) as ep, use_mesh(mesh), \
                torch.inference_mode():
            got = model.prefill({"tokens": prompt})[0]
        torch.cuda.synchronize()
        torch.save({"coord": tuple(mesh.get_coordinate()),
                    "want": want.cpu(), "got": got.cpu(),
                    "plain": plain.calls, "ep": ep.calls, "k2": k2_counts(),
                    "held": held, "peak": torch.cuda.max_memory_allocated()},
                   Path(out) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def shard_two_ranks(card: str) -> int:
    """(b) ``SHARD_RANKS`` spawned ranks on the one card over gloo; the
    gates on what each wrote.  Returns their K2 tf32x3 launches."""
    cfg = get_config(MOE_ARCH)
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=shard_rank, args=(
            r, SHARD_RANKS, f"{tmp}/store", tmp)) for r in range(SHARD_RANKS)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + SHARD_TIMEOUT
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join()
        check(not hung, f"(b) {len(hung)} ranks still ran after "
              f"{SHARD_TIMEOUT} s")
        codes = [p.exitcode for p in procs]
        check(codes == [0] * SHARD_RANKS, f"(b) rank exit codes {codes}")
        ranks = [torch.load(Path(tmp) / f"rank{r}.pt")
                 for r in range(SHARD_RANKS)]
    num_local = cfg.num_experts // SHARD_RANKS
    plain_slots = ranks[0]["plain"][0]["slots"]
    union = set()
    f32 = 0
    for r, res in enumerate(ranks):
        _, j = res["coord"]
        err = float((res["got"] - res["want"]).abs().max())
        ok, tol = shard_close(res["got"], res["want"],
                              MEASURED["moe_host_logits"][None])
        mine = {s for s in res["plain"][0]["slots"]
                if j * num_local <= s[2] < (j + 1) * num_local}
        got = res["ep"][0]["slots"]
        union |= got
        own = all(j * num_local <= s[2] < (j + 1) * num_local for s in got)
        sm90, n, simt = res["k2"]
        f32 += n
        say("shard", f"(b) rank {r} at {res['coord']}: experts "
            f"[{j * num_local}, {(j + 1) * num_local}) of {cfg.num_experts}; "
            f"holds {res['held'] / 1e9:.3f} GB of parameters; last-token "
            f"logits vs the unsharded float32 run max_abs_err={err:.3e} "
            f"(std {float(res['want'].std()):.3e}) {tol}; kept "
            f"{len(got)} pairs, all its own={own}, "
            f"identical to the unsharded run's={got == mine}; K2 launches "
            f"sm90 {sm90}, tf32x3 {n}, simt {simt}; peak max_memory_allocated "
            f"{res['peak'] / 2**30:.3f} GiB; {card}")
        check(bool(torch.isfinite(res["got"]).all()),
              f"(b) rank {r}: logits are not finite")
        check(ok, f"(b) rank {r}: the sharded prefill disagrees")
        check(own, f"(b) rank {r} kept pairs of another rank's experts")
        check(got == mine, f"(b) rank {r}: kept (expert, slot) pairs differ")
        check((sm90, n, simt) == (0, 1, 0), f"(b) rank {r}: K2 launched "
              f"sm90 {sm90}, tf32x3 {n}, simt {simt} times, not 0, 1 and 0")
    check(union == plain_slots, "(b) the ranks' kept pairs are not the "
          "unsharded run's")
    say("shard", f"(b) the {SHARD_RANKS} ranks keep {len(union)} pairs, the "
        f"unsharded run's {len(plain_slots)}")
    return f32


def tp_cut(part: str, dtype: str):
    arch, layers = TP_PARTS[part][:2]
    return dataclasses.replace(get_config(arch), num_layers=layers,
                               dtype=dtype, remat="none")


def tp_batch(part: str) -> dict:
    """Phase 9 ``part``'s prompt of ``TP_TOKENS`` ids, its next tokens
    (the labels) and ``TP_DECODE`` decode steps of one id each."""
    vocab = get_config(TP_PARTS[part][0]).vocab_size
    ids = np.random.default_rng(1).integers(1, vocab,
                                            TP_TOKENS + 1 + TP_DECODE)
    t = torch.as_tensor(ids[None]).to(DEV)
    return {"tokens": t[:, :TP_TOKENS], "labels": t[:, 1:TP_TOKENS + 1],
            "steps": [t[:, TP_TOKENS + 1 + i:TP_TOKENS + 2 + i]
                      for i in range(TP_DECODE)]}


def tp_shapes():
    """Shadows ``models.layers.flash_attention`` and ``models.ssm.
    ssd_chunk`` with recording wrappers: the (query, KV) heads of each K2
    call and the heads of each K3 call, in a list of ("K2", (q, kv)) and
    ("K3", nh); and a function that puts both back."""
    seen: list = []
    k2, k3 = model_layers.flash_attention, model_ssm.ssd_chunk

    def k2_rec(q, k, v, **kw):
        seen.append(("K2", (q.shape[2], k.shape[2])))
        return k2(q, k, v, **kw)

    def k3_rec(xdt, *args, **kw):
        seen.append(("K3", xdt.shape[3]))
        return k3(xdt, *args, **kw)

    def restore():
        model_layers.flash_attention, model_ssm.ssd_chunk = k2, k3
    model_layers.flash_attention, model_ssm.ssd_chunk = k2_rec, k3_rec
    return seen, restore


def tp_serve(model, batch: dict, decode: bool, marks=None) -> dict:
    """The prefill's last-token logits and, where ``decode``, those of
    each decode step after it (on the host for a model there), float32 on
    the host.  ``marks`` (a list) gets the launch counts and the card's
    peak memory as the prefill leaves them."""
    dev = model.device
    with torch.inference_mode():
        logits, cache = model.prefill({"tokens": batch["tokens"].to(dev)})
        out = {"logits": logits.float().cpu(), "decode": []}
        if marks is not None:
            torch.cuda.synchronize()
            marks += [launch_counts(), torch.cuda.max_memory_allocated()]
        if decode:
            cache = model.extend_cache(cache, TP_DECODE)
            for step in batch["steps"]:
                logits, cache = model.decode_step(cache,
                                                  {"tokens": step.to(dev)})
                out["decode"].append(logits.float().cpu())
    return out


def tp_pass(rank: int, mesh, part: str, dtype: str) -> dict:
    """``part`` on one rank in one dtype: the unsharded cut's prefill
    logits (float32: and decode steps), loss and gradient slices (the
    ranks in turn, so that one unsharded model with its gradients is on
    the card at a time), then the same weights placed on ``mesh``: prefill
    (and decode) under ``use_mesh`` (parameter bytes held, the prefill's
    peak net of what the process holds besides), a loss and backward, the
    kernels' launches in the prefill and in the step, and the heads K2 and
    K3 saw."""
    from repro_torch.distributed.sharding import local_slice, param_shardings
    cfg = tp_cut(part, dtype)
    batch = tp_batch(part)
    decode = dtype == "float32" and TP_PARTS[part][3]
    want = {}
    for turn in range(SHARD_RANKS):
        if turn == rank:
            model = Model(cfg, device=DEV,
                          generator=torch.Generator(DEV).manual_seed(0))
            want = tp_serve(model, batch, decode)
            if dtype == "float32":      # no gate reads bf16's gradients
                model.requires_grad_(True)
                loss = model.loss(batch)
                loss.backward()
                want["loss"] = float(loss.detach())
                places = param_shardings(model, mesh)
                want["grads"] = {n: local_slice(p.grad, mesh,
                                                places[n].placements).cpu()
                                 for n, p in model.named_parameters()}
                model.zero_grad(set_to_none=True)
                model.requires_grad_(False)
                del loss
        dist.barrier()
    shard_params(model, mesh)
    gc.collect()
    torch.cuda.empty_cache()
    held = sum(p.to_local().numel() * p.to_local().element_size()
               for p in model.parameters())
    base = torch.cuda.memory_allocated()
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    seen, restore = tp_shapes()
    marks: list = []
    try:
        with use_mesh(mesh):
            got = tp_serve(model, batch, decode, marks)
        served = launch_counts()
        prefill, peak = marks
        # the dry run's peak counts from the arguments on: the parameters
        # and the batch (int32 ids there)
        peak = peak - base + held + 4 * TP_TOKENS
        model.requires_grad_(True)
        with use_mesh(mesh):
            loss = model.loss(batch)
            loss.backward()
        torch.cuda.synchronize()
    finally:
        restore()
    step = {k: v - served[k] for k, v in launch_counts().items()}
    rel = {n: leaf_rel(want["grads"][n], p.grad.to_local())
           for n, p in model.named_parameters() if "grads" in want}
    sp = tp_sp_step(model, mesh, batch, want, dtype)
    return {"coord": tuple(mesh.get_coordinate()), "want": want["logits"],
            "got": got["logits"], "want_decode": want["decode"],
            "got_decode": got["decode"], "want_loss": want.get("loss"),
            "loss": float(loss.detach()), "rel": rel, "held": held,
            "peak": peak, "prefill": prefill,
            "decode": {k: served[k] - v for k, v in prefill.items()},
            "step": step, "shapes": seen, "sp": sp}


def tp_sp_step(model, mesh, batch: dict, want: dict, dtype: str) -> dict:
    """The same loss and backward again under Megatron-SP
    (``seq_shard_activations``: 256 of the 512 rows a rank between the
    regions): the loss, the float32 gradient shards against the unsharded
    run's (``want``), the bf16 ones against the step without SP just
    taken, the rows each layer took, the kernels' launches and the step's
    peak beside the step's without SP."""
    # the step's bf16 gradients kept on the host, so that the SP step's
    # peak counts what it allocates itself
    plain = want["grads"] if dtype == "float32" else {
        n: p.grad.to_local().cpu() for n, p in model.named_parameters()}
    torch.cuda.synchronize()
    plain_peak = torch.cuda.max_memory_allocated()
    model.zero_grad(set_to_none=True)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    flag = model.cfg
    model.cfg = dataclasses.replace(flag, seq_shard_activations=True)
    rows: list = []
    block_out = model_tf._block_out

    def recording(blk, x, *args):
        rows.append(x.shape[1])
        return block_out(blk, x, *args)
    model_tf._block_out = recording
    before = launch_counts()
    try:
        with use_mesh(mesh):
            loss = model.loss(batch)
            loss.backward()
        torch.cuda.synchronize()
    finally:
        model_tf._block_out = block_out
        model.cfg = flag
    grads = {n: p.grad.to_local() for n, p in model.named_parameters()}
    return {"loss": float(loss.detach()), "rows": rows,
            "rel": {n: leaf_rel(plain[n], g) for n, g in grads.items()},
            "step": {k: v - before[k] for k, v in launch_counts().items()},
            "peak": torch.cuda.max_memory_allocated(),
            "plain_peak": plain_peak}


def tp_rank(rank: int, world: int, store: str, out: str) -> None:
    """(c)-(e) One rank on the one card over gloo, mesh (1, 2): each
    part's ``tp_pass`` in float32, then in bf16."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        mesh = make_debug_mesh((1, SHARD_RANKS))
        res = {}
        for part in TP_PARTS:
            for dtype in ("float32", "bfloat16"):
                t0 = time.perf_counter()
                res[part, dtype] = tp_pass(rank, mesh, part, dtype)
                res[part, dtype]["s"] = time.perf_counter() - t0
                gc.collect()
                torch.cuda.empty_cache()
        torch.save(res, Path(out) / f"tp{rank}.pt")
    finally:
        dist.destroy_process_group()


def tp_predict() -> dict:
    """(c)-(e) The dry run's record of each rank's prefill of each cut,
    per dtype: rank 0 of a fake group of ``SHARD_RANKS`` on fake cuda
    tensors, mesh (1, 2)."""
    recs = {}
    dryrun._fake_group(SHARD_RANKS)
    try:
        mesh = make_debug_mesh((1, SHARD_RANKS))
        for part in TP_PARTS:
            for dtype in ("float32", "bfloat16"):
                cfg = tp_cut(part, dtype)
                recs[part, dtype] = rec = dryrun.run_cell(
                    cfg.name, "prefill", mesh, False, device=DEV, cfg=cfg,
                    shape=ShapeSpec("prefill", "prefill", TP_TOKENS, 1))
                check(rec["status"] == "ok", f"{part} dry run: {rec}")
    finally:
        dist.destroy_process_group()
    return recs


def tp_step_gates(res: dict) -> tuple[float, str]:
    """float32: the step's loss against the unsharded one (relative) and
    the gradient leaf whose shard is furthest from the unsharded's."""
    return (abs(res["loss"] - res["want_loss"]) / abs(res["want_loss"]),
            max(res["rel"], key=res["rel"].get))


def tp_step_text(res: dict) -> str:
    loss_rel, worst = tp_step_gates(res)
    return (f"loss {res['loss']:.6f} vs {res['want_loss']:.6f} (rel "
            f"{loss_rel:.2e}); {len(res['rel'])} gradient shards, worst "
            f"||g_tp - g||/||g|| {res['rel'][worst]:.3e} ({worst}); ")


def tp_heads(part: str) -> dict:
    """What a rank of two computes in ``part``: its heads of each mixer
    and kernel, as ``tp_shapes`` records them, and its text."""
    cfg = get_config(TP_PARTS[part][0])
    n = SHARD_RANKS
    V = cfg.vocab_size
    vocab = (f"; embedding rows and head columns {V // n} of {V}"
             if V % n == 0 else f"; embedding and head whole ({V})")
    if cfg.uses_ssm:
        return {"seen": {("K3", cfg.ssm_heads // n)},
                "text": f"{cfg.ssm_heads // n} of {cfg.ssm_heads} SSM heads "
                        f"(d_inner {cfg.d_inner // n} of {cfg.d_inner})"
                        + vocab}
    hl = cfg.num_heads // n
    if cfg.attention == "mla":
        return {"seen": {("K2", (hl, hl))},
                "text": f"MLA {hl} of {cfg.num_heads} heads, Dk "
                        f"{cfg.qk_nope_head_dim + cfg.qk_rope_head_dim} / Dv "
                        f"{cfg.v_head_dim}, latent whole" + vocab}
    kl = cfg.num_kv_heads // n
    return {"seen": {("K2", (hl, kl))},
            "text": f"heads {hl}/{kl} of {cfg.num_heads}/{cfg.num_kv_heads},"
                    f" MLP columns {cfg.d_ff // n} of {cfg.d_ff}" + vocab}


def tp_kernels(part: str, dtype: str) -> dict:
    """The launches each rank's prefill (and its training step, its
    forward and backward) of ``part`` must make, by kernel and route: one
    K2 or K3 a layer, one backward a layer."""
    cfg = tp_cut(part, dtype)
    L = cfg.num_layers
    if cfg.uses_ssm:
        return {"prefill": {"ssd_chunk": L},
                "step": {"ssd_chunk": L, "ssd_chunk_bwd": L}}
    r = "sm90" if dtype == "bfloat16" else "tf32x3"
    return {"prefill": {f"flash_attention/{r}": L},
            "step": {f"flash_attention/{r}": L,
                     f"flash_attention_bwd/{r}": L}}


def shard_tp(card: str) -> dict:
    """(c)-(e) ``SHARD_RANKS`` spawned ranks on the one card over gloo,
    mesh (1, 2): each of ``TP_PARTS`` at full width, depth cut, its token
    mixer and MLP tensor-parallel; the gates on what each wrote.  Returns
    the ranks' launches by kernel."""
    # the float32 gate's yardstick: each cut's prefill (and decode) on the
    # host, its weights drawn on the card as the ranks draw them, run while
    # they work, and the dry run's records of the cuts after them: (c)-(e)
    # took 100.0 s so, where (c) alone took 115.6 s with both before the
    # ranks (NVIDIA H100 80GB HBM3, 700.00 W)
    t0 = time.perf_counter()
    host = {}
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=tp_rank, args=(r, SHARD_RANKS,
                                                   f"{tmp}/store", tmp))
                 for r in range(SHARD_RANKS)]
        for p in procs:
            p.start()
        for part, (_, _, _, decode) in TP_PARTS.items():
            host_m = Model(tp_cut(part, "float32"), device=DEV,
                           generator=torch.Generator(DEV).manual_seed(0)
                           ).to("cpu")
            gc.collect()
            torch.cuda.empty_cache()
            host[part] = tp_serve(host_m, tp_batch(part), bool(decode))
            del host_m
        say("shard", f"(c)-(e) the host's float32 prefills (and decode "
            f"steps) of the cuts, weights drawn and moved: "
            f"{time.perf_counter() - t0:.1f} s beside the ranks")
        deadline = time.monotonic() + SHARD_TIMEOUT
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join()
        check(not hung, f"(c)-(e) {len(hung)} ranks still ran after "
              f"{SHARD_TIMEOUT} s")
        codes = [p.exitcode for p in procs]
        check(codes == [0] * SHARD_RANKS, f"(c)-(e) rank exit codes {codes}")
        ranks = [torch.load(Path(tmp) / f"tp{r}.pt")
                 for r in range(SHARD_RANKS)]
    pred = tp_predict()
    launches: dict = {}
    for part, (arch, _, bf16_tol, _) in TP_PARTS.items():
        heads = tp_heads(part)
        for dtype in ("float32", "bfloat16"):
            rec = pred[part, dtype]
            batch_b = sum(t.numel() * t.element_size() for t in input_specs(
                tp_cut(part, dtype), ShapeSpec("prefill", "prefill",
                                               TP_TOKENS, 1))[
                    "batch"].values())
            want_k = tp_kernels(part, dtype)
            for r, all_res in enumerate(ranks):
                res = all_res[part, dtype]
                err = float((res["got"] - res["want"]).abs().max())
                if dtype == "float32":
                    ok, tol = shard_close(res["got"], res["want"],
                                          host[part]["logits"])
                    for t, (g, w, h) in enumerate(zip(
                            res["got_decode"], res["want_decode"],
                            host[part]["decode"])):
                        d_ok, d_tol = shard_close(g, w, h)
                        say("shard", f"{part} float32 rank {r}: decode step "
                            f"{t} vs the unsharded decode max_abs_err="
                            f"{float((g - w).abs().max()):.3e} {d_tol}")
                        check(d_ok, f"{part} rank {r}: decode step {t} "
                              f"disagrees")
                    check(len(res["got_decode"]) == len(host[part]["decode"]),
                          f"{part} rank {r}: decode steps missing")
                else:
                    atol = bf16_tol * float(res["want"].abs().max())
                    ok = torch.allclose(res["got"], res["want"],
                                        rtol=bf16_tol, atol=atol)
                    tol = (f"allclose(rtol={bf16_tol}, atol={bf16_tol} x "
                           f"max|want|)={ok}")
                pre = {k: v for k, v in res["prefill"].items() if v}
                stp = {k: v for k, v in res["step"].items() if v}
                seen = set(res["shapes"])
                pred_held = rec["memory"]["argument_bytes"] - batch_b
                peak_err = abs(rec["memory"]["peak_bytes"] - res["peak"]) / \
                    res["peak"]
                say("shard", f"{part} {dtype} rank {r} at {res['coord']}: "
                    f"{arch} cut to {tp_cut(part, dtype).num_layers} "
                    f"layer(s), {heads['text']}; prefill of {TP_TOKENS} "
                    f"tokens: last-token logits vs the unsharded {dtype} run "
                    f"max_abs_err={err:.3e} (std "
                    f"{float(res['want'].std()):.3e}) {tol}; "
                    + (tp_step_text(res) if dtype == "float32" else
                       f"the step's loss {res['loss']:.6f}; ")
                    + f"kernel heads seen {sorted(seen)}; launches prefill "
                    f"{pre}, step {stp}; parameters held {res['held']} B (dry "
                    f"run {pred_held} B); prefill peak "
                    f"{res['peak'] / 2**30:.3f} GiB (dry run "
                    f"{rec['memory']['peak_bytes'] / 2**30:.3f} GiB, error "
                    f"{peak_err * 100:.2f} %); {res['s']:.1f} s; {card}")
                check(bool(torch.isfinite(res["got"]).all()),
                      f"{part} {dtype} rank {r}: logits are not finite")
                check(ok, f"{part} {dtype} rank {r}: the tensor-parallel "
                      f"prefill disagrees")
                check(seen == heads["seen"], f"{part} {dtype} rank {r}: the "
                      f"kernels saw heads {seen}, not {heads['seen']}")
                check(pre == want_k["prefill"] and stp == want_k["step"]
                      and not any(res["decode"].values()),
                      f"{part} {dtype} rank {r}: launched {pre} in the "
                      f"prefill, {stp} in the step, "
                      f"{res['decode']} in decode; want {want_k}")
                check(res["held"] == pred_held, f"{part} {dtype} rank {r}: "
                      f"holds {res['held']} B of parameters, the dry run "
                      f"{pred_held}")
                check(math.isfinite(res["loss"]), f"{part} {dtype} rank "
                      f"{r}: the loss is not finite")
                if dtype == "float32":
                    loss_rel, worst = tp_step_gates(res)
                    check(loss_rel <= GATE_LOSS_RTOL, f"{part} rank {r}: "
                          f"the tensor-parallel loss disagrees")
                    check(res["rel"][worst] <= GATE_LEAF_RTOL,
                          f"{part} rank {r}: gradient shard of {worst} "
                          f"disagrees")
                tp_sp_check(part, dtype, r, res, want_k["step"], bf16_tol,
                            card)
                add = add_launches(dict.fromkeys(res["step"], 0),
                                   res["prefill"], res["step"],
                                   res["sp"]["step"])
                for name, k in add.items():
                    launches[name] = launches.get(name, 0) + k
    say("shard", f"(c)-(e) done in {time.perf_counter() - t0:.1f} s")
    return launches


def tp_sp_check(part: str, dtype: str, r: int, res: dict, want_step: dict,
                bf16_tol: float, card: str) -> None:
    """(c)-(e) The Megatron-SP step of ``tp_sp_step``: every layer took
    TP_TOKENS / 2 rows; float32: loss and gradient shards at phase 7 (b)'s
    gates against the unsharded run; bf16: the loss in the cut's band of
    the step's without SP (the forward's arithmetic is the same), its
    gradient shards' distance from that step's printed; the same kernel
    launches as that step."""
    sp = res["sp"]
    worst = max(sp["rel"], key=sp["rel"].get)
    stp = {k: v for k, v in sp["step"].items() if v}
    if dtype == "float32":
        base = res["want_loss"]
        ok = abs(sp["loss"] - base) <= GATE_LOSS_RTOL * abs(base)
        gate = (f"gates {GATE_LOSS_RTOL} / {GATE_LEAF_RTOL} against the "
                f"unsharded run")
        check(sp["rel"][worst] <= GATE_LEAF_RTOL, f"{part} rank {r}: the "
              f"SP gradient shard of {worst} disagrees")
    else:
        base = res["loss"]
        ok = abs(sp["loss"] - base) <= bf16_tol * abs(base)
        gate = f"rtol {bf16_tol} against the step without SP"
    say("shard", f"{part} {dtype} rank {r}: Megatron-SP step, layers took "
        f"{sorted(set(sp['rows']))} of {TP_TOKENS} rows; loss "
        f"{sp['loss']:.6f} vs {base:.6f} (bit-equal "
        f"{sp['loss'] == res['loss']} to the step without SP); "
        f"{len(sp['rel'])} gradient shards, worst ||g_sp - g||/||g|| "
        f"{sp['rel'][worst]:.3e} ({worst}); {gate}; launches {stp}; step "
        f"peak {sp['peak'] / 2**30:.3f} GiB (without SP "
        f"{sp['plain_peak'] / 2**30:.3f}); {card}")
    check(set(sp["rows"]) == {TP_TOKENS // SHARD_RANKS}, f"{part} rank {r}: "
          f"the SP layers took {sp['rows']} rows")
    check(math.isfinite(sp["loss"]) and ok, f"{part} {dtype} rank {r}: the "
          f"SP loss disagrees")
    check(stp == want_step, f"{part} {dtype} rank {r}: the SP step launched "
          f"{stp}, not {want_step}")


def shard_phase(card: str) -> dict:
    """Phase 9: the sharded layer on the card."""
    t0 = time.perf_counter()
    sm90 = shard_world1(card)
    f32 = shard_two_ranks(card)
    launches = shard_tp(card)
    launches["flash_attention/sm90"] += sm90
    launches["flash_attention/tf32x3"] = (
        launches.get("flash_attention/tf32x3", 0) + f32)
    say("shard", f"done in {time.perf_counter() - t0:.1f} s")
    return launches



# ---------------------------------------------------------------------------
# Phase 10: the dry run against the card
# ---------------------------------------------------------------------------


DRYRUN_HELD: list = []    # (a)'s cells held, from phases 7 and 9


def _site(block: dict) -> str:
    """The innermost line of this repository that allocated ``block``
    (the caching allocator's recorded frames), else the innermost line."""
    frames = block.get("frames") or []
    for f in frames:
        if "repro_torch" in f["filename"] or "chip_smoke" in f["filename"]:
            return f"{Path(f['filename']).name}:{f['line']} {f['name']}"
    return (f"{Path(frames[0]['filename']).name}:{frames[0]['line']}"
            if frames else "no frames recorded")


def built(build, tensors) -> tuple:
    """``build()`` under the caching allocator's record.  Returns its
    result and the allocator's reading of what the build left allocated:
    ``grown``, what ``memory_allocated`` grew by; for the blocks that hold
    ``tensors(result)``, their ``blocks`` count, the bytes ``requested``
    for them and the bytes ``charged`` (each block rounded up to 512 bytes,
    and a large block cut from a new segment keeps the segment's remainder
    when that is 1 MiB or less); ``other``, the bytes of every other block
    allocated on the way and still held, by the line that allocated it."""
    def active() -> dict:
        return {b["address"]: b
                for seg in torch.cuda.memory._snapshot()["segments"]
                for b in seg["blocks"] if b["state"] == "active_allocated"}

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.memory._record_memory_history(max_entries=1_000_000)
    try:
        before = set(active())
        base = torch.cuda.memory_allocated()
        out = build()
        torch.cuda.synchronize()
        grown = torch.cuda.memory_allocated() - base
        new = {a: b for a, b in active().items() if a not in before}
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
    ptrs = {t.untyped_storage().data_ptr() for t in tensors(out)}
    own = [b for a, b in new.items() if a in ptrs]
    other: dict = {}
    for a, b in new.items():
        if a not in ptrs:
            other[_site(b)] = other.get(_site(b), 0) + b["size"]
    return out, {"grown": grown, "blocks": len(own),
                 "requested": sum(b["requested_size"] for b in own),
                 "charged": sum(b["size"] for b in own), "other": other,
                 "sizes": [b["requested_size"] for b in own]}


def allocator_charge(size: int) -> int:
    """Bytes PyTorch's caching allocator charges a request of ``size``
    bytes from a new segment: rounded up to 512 bytes; from 10 MiB up
    the segment is rounded up to 2 MiB and the block keeps a remainder of
    at most 1 MiB (it is not split off).  Blocks cut from a 20 MiB segment
    of smaller requests, whose last block may keep such a remainder too,
    are taken at 512 bytes."""
    r = max(512, -(-size // 512) * 512)
    if r >= 10 * 2**20:
        segment = -(-r // 2**21) * 2**21
        if segment - r <= 2**20:
            return segment
    return r


def dryrun_hold(label: str, cfg, shape, step, reading: dict,
                measured_s: float, measured_what: str,
                rec: dict | None = None) -> None:
    """(a) ``launch.dryrun``'s prediction of ``cfg``'s step at ``shape``
    at world size 1, traced on fake ``cuda`` tensors, then ``step()``, the
    same step on the calling phase's model, under the same accounting
    (``launch.hlo_costs``): FLOPs and collective counts equal.  The
    predicted arguments, less the batch (on the host while the phase built
    its state), equal the bytes the built tensors' blocks asked the caching
    allocator for (``reading``, from ``built``); ``memory_allocated`` grew
    by what the allocator charged those blocks and nothing else, and the
    predicted arguments plus the rounding ``allocator_charge`` gives
    those blocks are within ``DRYRUN_ARG_TOL`` of that growth.  The
    predicted peak is held against ``max_memory_allocated`` over the step,
    net of what the process holds besides the state (cuBLAS workspaces,
    earlier phases' tensors).  The roofline at the H100's data-sheet peaks
    is printed beside ``measured_s``; no gate.  ``rec``: the prediction,
    when the caller has traced it already."""
    if rec is None:
        rec = dryrun.run_cell(cfg.name, shape.name, None, False, shape=shape,
                              device=DEV, cfg=cfg)
    trace_s = rec["trace_s"]
    check(rec.get("status") == "ok", f"(a) {label}: the dry run gave {rec}")
    gc.collect()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - reading["grown"]
    torch.cuda.reset_peak_memory_stats()
    with CostMode() as costs:
        step()
        torch.cuda.synchronize()
    real = costs.totals()
    peak = torch.cuda.max_memory_allocated() - held
    mem = rec["memory"]
    batch = sum(t.numel() * t.element_size()
                for t in input_specs(cfg, shape)["batch"].values())
    state = mem["argument_bytes"] - batch
    other = sum(reading["other"].values())
    rounding = reading["charged"] - reading["requested"]
    modelled = sum(map(allocator_charge, reading["sizes"])) - reading[
        "requested"]
    arg_err = abs(mem["argument_bytes"] + modelled - reading["grown"]) / \
        reading["grown"]
    peak_err = abs(mem["peak_bytes"] - peak) / peak
    say("dryrun", f"(a) {label}: traced on fake cuda tensors in "
        f"{trace_s:.1f} s; FLOPs predicted {rec['flops_per_device']:.6e}, "
        f"on the card {real['flops']:.6e}; collectives predicted "
        f"{rec['collective_counts']}, on the card "
        f"{real['collective_counts']}; kernelized bytes predicted "
        f"{rec['bytes_per_device_kernelized']:.6e}, on the card "
        f"{real['bytes_kernelized']:.6e}; flash-loop bytes "
        f"{rec['flash_loop_bytes_per_device']:.6e}")
    say("dryrun", f"(a) {label}: arguments predicted "
        f"{mem['argument_bytes']} B, less the batch's {batch} B: {state} B; "
        f"the built tensors' {reading['blocks']} blocks requested "
        f"{reading['requested']} B and were charged {reading['charged']} B "
        f"(the allocator's rounding {rounding} B, "
        f"{rounding / reading['requested'] * 100:.3f} %); other blocks the "
        f"build left {other} B {sorted(reading['other'].items())[:8]}; "
        f"memory_allocated grew by {reading['grown']} B; the rounding "
        f"allocator_charge gives those blocks {modelled} B; predicted "
        f"arguments plus that against the growth {arg_err * 100:.3f} % "
        f"(gate {DRYRUN_ARG_TOL * 100:.0f} %)")
    say("dryrun", f"(a) {label}: peak predicted "
        f"{mem['peak_bytes'] / 2**30:.3f} GiB, max_memory_allocated "
        f"net of the {held / 2**30:.3f} GiB held besides "
        f"{peak / 2**30:.3f} GiB (error {peak_err * 100:.2f} %, gate "
        f"{DRYRUN_PEAK_TOL * 100:.0f} %); roofline at the H100 data "
        f"sheet's peaks {rec['roofline_s_h100'] * 1e3:.2f} ms against the "
        f"measured {measured_what} {measured_s * 1e3:.2f} ms "
        f"({rec['roofline_s_h100'] / measured_s * 100:.1f} %)")
    check(rec["flops_per_device"] == real["flops"],
          f"(a) {label}: predicted {rec['flops_per_device']} FLOPs, the "
          f"card's step dispatched {real['flops']}")
    check(rec["collective_counts"] == real["collective_counts"],
          f"(a) {label}: collectives differ")
    check(state == reading["requested"], f"(a) {label}: predicted state "
          f"{state} B, the built tensors requested {reading['requested']} B")
    check(reading["grown"] == reading["charged"] + other,
          f"(a) {label}: memory_allocated grew by {reading['grown']} B, "
          f"the blocks the build left hold {reading['charged'] + other} B")
    check(arg_err <= DRYRUN_ARG_TOL, f"(a) {label}: arguments off by "
          f"{arg_err * 100:.3f} %")
    check(peak_err <= DRYRUN_PEAK_TOL, f"(a) {label}: peak off by "
          f"{peak_err * 100:.2f} %")
    DRYRUN_HELD.append(label)


def tp_split(rec: dict, cfg, shape, n: int) -> dict:
    """A train cell's FLOPs per rank of a mesh whose "model" axis has
    ``n`` ranks, from the shapes: the tensor-parallel products (attention's
    q and output projections on H/n heads, the dense MLP's d_ff/n columns;
    MLA's ``wq_b``, ``wk_b``, ``wv_b``, ``wo`` on H/n heads; the SSM's
    ``w_in`` on its heads' z, x and dt columns and its groups' B and C, and
    ``w_out`` on their d_inner/n rows), the products every rank of "model"
    repeats (attention's K/V projections of the KV heads the rank's query
    heads read, KH/n where n divides KH, else those heads whole; MLA's
    down projections ``wq_a`` and ``wkv_a``) and the loss head (V/n
    columns where n divides the vocab, else V); each product 2·T·m·k
    forward, again in remat "full"'s recompute (but the
    layer's last, where the recompute stops), twice in the backward.  The
    kernels (K2, K2-bwd, K3, K3-bwd) and the other operators (the SSM's
    inter-chunk ``bmm``) come from ``rec``'s operators; ``products`` is
    ``rec``'s ``mm``s, which must equal the three parts' sum."""
    T = shape.batch * shape.seq // (rec["chips"] // n)
    d, L = cfg.d_model, cfg.num_layers
    passes = 8 if cfg.remat == "full" else 6
    ff = cfg.d_ff // n
    # the MLP's wo is the layer's last product; a lone mixer's is its own
    mlp = passes * 2 * d * ff + 6 * ff * d if cfg.d_ff else 0
    last = 6 if not cfg.d_ff else passes
    if cfg.uses_ssm:
        sh = model_layers.split_heads(cfg.ssm_heads, cfg.ssm_groups, n, 0)
        di = sh.hl * cfg.ssm_head_dim
        cols = 2 * di + 2 * (sh.kv1 - sh.kv0) * cfg.ssm_state + sh.hl
        tp, rep = passes * d * cols + last * di * d, 0
    elif cfg.attention == "mla":
        hl = cfg.num_heads // n
        nope, rope = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
        qr, kvr, vd = cfg.q_lora_rank, cfg.kv_lora_rank, cfg.v_head_dim
        tp = passes * (qr * hl * (nope + rope) + kvr * hl * (nope + vd)
                       + hl * vd * d)
        rep = passes * d * (qr + kvr + rope)
    else:
        sh = model_layers.head_shard(cfg, n, 0)
        hd = cfg.head_dim
        tp = passes * 2 * d * sh.hl * hd
        rep = passes * 2 * d * (sh.kv1 - sh.kv0) * hd
    ops = rec["flops_per_operator"]
    kernels = sum(v for k, v in ops.items() if k.startswith("repro_torch."))
    mm = sum(v for k, v in ops.items() if k in ("aten.mm", "aten.addmm"))
    V = cfg.vocab_size
    return {"tensor-parallel products": T * L * (tp + mlp),
            "replicated products": T * L * rep,
            # the vocab-parallel head: V/n columns where n divides V
            "loss head": 8 * T * d * (V // n if V % n == 0 else V),
            "kernels": kernels,
            "other operators": rec["flops_per_device"] - kernels - mm,
            "products": mm}


def tp_dryrun_check(arch: str, mesh, gathered_tflop: float,
                    tflop: float) -> None:
    """(b) One of ``TP_DRYRUN_CELLS``: its record's FLOPs a rank, split
    by ``tp_split``, below its gathered layers', equal to the split's
    products and ``tflop`` TFLOP to the third decimal."""
    tag = f"{arch}__train_4k__single"
    rec = json.loads((DRYRUN_OUT / f"tp-{arch}" / f"{tag}.json").read_text())
    check(rec["status"] == "ok" and rec["chips"] == 256, f"(b) {tag}: {rec}")
    n = mesh[1] if mesh else 16
    split = tp_split(rec, get_config(arch), dryrun.SHAPES["train_4k"], n)
    parts = sum(split[k] for k in ("tensor-parallel products",
                                   "replicated products", "loss head"))
    say("dryrun", f"(b) {tag} on {mesh or (16, 16)} (\"model\" = {n}): "
        f"{rec['flops_per_device'] / 1e12:.3f} TFLOP a rank (its layers "
        f"gathered: {gathered_tflop} TFLOP); split per rank, TFLOP: "
        + ", ".join(f"{k} {v / 1e12:.3f}" for k, v in split.items())
        + f"; products from the shapes {parts / 1e12:.3f}, equal="
        f"{parts == split['products']}; per operator "
        f"{rec['flops_per_operator']}; collectives "
        f"{rec['collective_counts']}, bytes "
        f"{rec['collective_bytes_per_device']}; peak "
        f"{rec['memory']['peak_bytes'] / 2**30:.3f} GiB, arguments "
        f"{rec['memory']['argument_bytes'] / 2**30:.3f} GiB; traced in "
        f"{rec['trace_s']} s")
    check(parts == split["products"], f"(b) {tag}: the products are not "
          f"the tensor-parallel split's")
    check(rec["flops_per_device"] < gathered_tflop * 1e12,
          f"(b) {tag}: not below the gathered layers' {gathered_tflop} "
          f"TFLOP")
    check(round(rec["flops_per_device"] / 1e12, 3) == tflop,
          f"(b) {tag}: {rec['flops_per_device'] / 1e12:.3f} TFLOP a rank, "
          f"not {tflop}")


def tp_opt_check(card: str) -> None:
    """(b) ``TP_DRYRUN_OPT`` under --opt beside the same cell without it:
    FLOPs equal; peak, collectives; the peak below by at least half the
    saved inputs' term (25.0 - 1.56 GiB)."""
    tag = f"{TP_DRYRUN_OPT}__train_4k__single"
    plain, opt = (json.loads((DRYRUN_OUT / d / f"{tag}.json").read_text())
                  for d in (f"tp-{TP_DRYRUN_OPT}", f"tp-{TP_DRYRUN_OPT}-opt"))
    check(opt["status"] == "ok", f"(b) {tag} --opt: {opt}")
    cfg = get_config(TP_DRYRUN_OPT)
    T = dryrun.SHAPES["train_4k"].batch * dryrun.SHAPES["train_4k"].seq // 16
    term = cfg.num_layers * T * cfg.d_model * 2 * (1 - 1 / 16)
    drop = plain["memory"]["peak_bytes"] - opt["memory"]["peak_bytes"]
    say("dryrun", f"(b) {tag} with --opt (Megatron-SP, loss chunks of "
        f"8192) beside it without: {opt['flops_per_device'] / 1e12:.3f} "
        f"against {plain['flops_per_device'] / 1e12:.3f} TFLOP a rank; peak "
        f"{opt['memory']['peak_bytes'] / 2**30:.3f} against "
        f"{plain['memory']['peak_bytes'] / 2**30:.3f} GiB (down "
        f"{drop / 2**30:.3f}; the saved inputs' term {term / 2**30:.3f}); "
        f"collectives {opt['collective_counts']} against "
        f"{plain['collective_counts']}, bytes "
        f"{opt['collective_bytes_per_device']} against "
        f"{plain['collective_bytes_per_device']}; traced in "
        f"{opt['trace_s']} s; {card}")
    check(opt["flops_per_device"] == plain["flops_per_device"],
          f"(b) {tag}: --opt changed the FLOPs")
    check(drop >= term / 2, f"(b) {tag}: --opt's peak is down "
          f"{drop / 2**30:.3f} GiB, not about {term / 2**30:.3f}")


def tp_dryrun_cli(arch: str, mesh, opt: bool = False) -> subprocess.Popen:
    """(b) The dry run of one of ``TP_DRYRUN_CELLS`` on fake cuda
    tensors (with ``--opt``: ``TP_DRYRUN_OPT``), in a subprocess."""
    return dryrun_cli(["--singlepod", "--arch", arch, "--shape", "train_4k",
                       "--device", "cuda"]
                      + (["--mesh-shape", ",".join(map(str, mesh))]
                         if mesh else []) + (["--opt"] if opt else []),
                      DRYRUN_OUT / f"tp-{arch}{'-opt' if opt else ''}")


def dryrun_cli(args: list, out: Path) -> subprocess.Popen:
    """One dry run CLI in a subprocess at the lowest scheduling priority
    (niceness 19: it yields the host's cores to this process's own work),
    its output in ``out``/cli.log (``dryrun_log``), killed at exit if it
    still runs."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out.mkdir(parents=True, exist_ok=True)
    with open(out / "cli.log", "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", *args,
             "--out", str(out)], cwd=ROOT, env=env, stdout=log,
            stderr=subprocess.STDOUT, text=True,
            preexec_fn=lambda: os.nice(19))
    proc.log_path = out / "cli.log"
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc


def dryrun_log(proc: subprocess.Popen, what: str) -> str:
    """``dryrun_cli``'s subprocess waited for; its output."""
    try:
        proc.wait(timeout=DRYRUN_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        fail(f"(b) the {what} dry run ran past {DRYRUN_TIMEOUT} s")
    return proc.log_path.read_text()


def dryrun_start() -> dict:
    """Phase 10 (b)'s dry runs started on the host, each in a subprocess
    at the lowest scheduling priority, to run while phase 9, which claims
    no time, works on the card (``dryrun_finish`` collects them): the
    full-config cells no package has a record of, and the same records on
    fake cuda and fake cpu tensors: dbrx-132B's full train_4k and three
    tiny train cells, hymba's under AdamW, dbrx's and llama4's under
    FactoredAdam (a tiny cell keeps its full configuration's optimizer);
    hymba's long_500k; the tensor-parallel train_4k cells."""
    devices = ("cuda", "cpu")
    tiny_args = ["--tiny", "--singlepod", "--mesh-shape", "2,2,2", "--shape",
                 "train_4k", "--seq", "64", "--batch", "8"]
    runs = {   # name -> (CLI arguments, records compared across devices)
        "full": (["--singlepod", "--arch", "dbrx-132b", "--shape",
                  "train_4k"], ["dbrx-132b__train_4k__single"]),
        "tiny": (tiny_args + ["--arch", "hymba-1_5b", "dbrx-132b",
                              "llama4-maverick-400b-a17b"],
                 ["hymba-1_5b__train_4k__single",
                  "dbrx-132b__train_4k__single",
                  "llama4-maverick-400b-a17b__train_4k__single"])}
    procs = {(name, dev): dryrun_cli(args + ["--device", dev],
                                     DRYRUN_OUT / f"{name}-{dev}")
             for name, (args, _) in runs.items() for dev in devices}
    procs["long", "cuda"] = dryrun_cli(
        ["--singlepod", "--arch", "hymba-1_5b", "--shape", "long_500k",
         "--device", "cuda"], DRYRUN_OUT / "long-cuda")
    # TP_DRYRUN_CELLS: train_4k tensor-parallel over "model"
    for arch, mesh, *_ in TP_DRYRUN_CELLS:
        procs[f"tp-{arch}", "cuda"] = tp_dryrun_cli(arch, mesh)
    procs[f"tp-{TP_DRYRUN_OPT}-opt", "cuda"] = tp_dryrun_cli(
        TP_DRYRUN_OPT, None, opt=True)
    return {"procs": procs, "runs": runs, "t0": time.perf_counter()}


def dryrun_finish(started: dict, card: str) -> None:
    """Phase 10: (a)'s rows (taken in phases 7 and 9) summed up; (b)
    ``dryrun_start``'s dry runs waited for and held."""
    check(len(DRYRUN_HELD) == 2, f"(a) held {DRYRUN_HELD}, not 2 cells")
    steps = MEASURED.get("step_ms", [])
    say("dryrun", f"(a) both cells held; this run's phase 6 prefill "
        f"(5 x 2776) device busy {MEASURED.get('prefill_busy_s', 0):.4f} "
        f"s and phase 7 steps 2-{TRAIN_STEPS} "
        f"{', '.join(f'{t:.2f}' for t in steps)} ms, beside earlier runs "
        f"of this script with the kernels called through ctypes alone "
        f"(PERF.md section 5); {card}")
    procs, runs = started["procs"], started["runs"]
    devices = ("cuda", "cpu")
    for (name, dev), proc in procs.items():
        log = dryrun_log(proc, f"{name} on {dev}")
        for line in log.splitlines():
            if line.split(" ", 1)[0] in ("[ok]", "[skip]", "[error]"):
                say("dryrun", f"(b) {name} on {dev}: {line}")
        check(proc.returncode == 0, f"(b) the {name} dry run on {dev} "
              f"exited {proc.returncode}:\n{log[-3000:]}")
    for name, tag in (("full", "dbrx-132b__train_4k__single"),
                      ("long", "hymba-1_5b__long_500k__single")):
        rec = json.loads((DRYRUN_OUT / f"{name}-cuda" / f"{tag}.json")
                         .read_text())
        check(rec["status"] == "ok" and rec["chips"] == 256,
              f"(b) {tag}: {rec}")
        say("dryrun", f"(b) {tag}: {json.dumps(rec)}")
    for cell in TP_DRYRUN_CELLS:
        tp_dryrun_check(*cell)
    tp_opt_check(card)
    keys = ("flops_per_device", "bytes_per_device", "collective_counts",
            "collective_bytes_per_device", "memory", "optimizer")
    for name, (_, tags) in runs.items():
        for tag in tags:
            a, b = (json.loads((DRYRUN_OUT / f"{name}-{d}" / f"{tag}.json")
                               .read_text()) for d in devices)
            same = all(a[k] == b[k] for k in keys)
            say("dryrun", f"(b) {name} {tag} ({a['optimizer']}) on fake "
                f"cuda and fake cpu tensors: accounting equal={same} (FLOPs "
                f"{a['flops_per_device']:.6e}, collective bytes "
                f"{a['collective_bytes_per_device']})")
            check(same, f"(b) {name} {tag}: the accounting depends on the "
                  f"device")
    say("dryrun", f"(b) done in {time.perf_counter() - started['t0']:.1f} "
        f"s from the start of its dry runs (phase 9 ran meanwhile)")


# ---------------------------------------------------------------------------
# Phase 11: MoE training on the card, remat "dots", llama4 served
# ---------------------------------------------------------------------------


def host_available() -> int:
    """The host's available memory in bytes (``MemAvailable``)."""
    for line in Path("/proc/meminfo").read_text().splitlines():
        if line.startswith("MemAvailable:"):
            return int(line.split()[1]) * 1024
    return 0


def moe_train_gate(cfg, card: str) -> dict:
    """(a) float32, full width cut to 1 layer, phase 8 (a)'s 512-token
    prompt (labels: the next token): the loss and every parameter gradient
    on the card (K2 and K2-bwd ``tf32x3``) against the same weights moved to
    the host (the plain versions), at phase 7 (b)'s gates, and every
    (token, choice)'s kept (expert, slot) identical.  Returns the launches
    of the card's step, counted from 0."""
    cut = dataclasses.replace(cfg, num_layers=1, dtype="float32",
                              remat="none")
    T = MOE_GATE_TOKENS
    prompt = np.random.default_rng(1).integers(1, cfg.vocab_size, T)
    batch = {"tokens": prompt[None], "labels": np.append(prompt[1:], -1)[None]}
    need = 2 * 4 * cut.param_count()          # float32 weights and grads
    avail = host_available()
    say("moe-train", f"(a) host MemAvailable {avail / 1e9:.1f} GB; the "
        f"host's float32 weights and gradients need {need / 1e9:.1f} GB")
    check(avail > 1.2 * need, f"(a) the host has {avail / 1e9:.1f} GB "
          f"available, the gate needs {need / 1e9:.1f} GB and more")
    t0 = time.perf_counter()
    card_m = Model(cut, device=DEV,
                   generator=torch.Generator(DEV).manual_seed(0))
    host_m = Model(cut, device="meta")
    host_m.load_state_dict({k: v.cpu() for k, v in
                            card_m.state_dict().items()}, assign=True)
    losses, slots = {}, {}
    reset_launches()
    for where, model in (("card", card_m), ("host", host_m)):
        model.requires_grad_(True)
        seen, hook = moe_input(model)
        loss = model.loss({k: torch.as_tensor(v).to(model.device)
                           for k, v in batch.items()})
        loss.backward()
        hook.remove()
        losses[where] = float(loss.detach())
        slots[where] = kept_slots(model, seen["x"])
        if where == "card":
            torch.cuda.synchronize()
            launches = launch_counts()
    check(launches == {**dict.fromkeys(launch_counts(), 0),
                       "flash_attention/tf32x3": 1,
                       "flash_attention_bwd/tf32x3": 1},
          f"(a) the card's float32 step launched {launches}")
    rel = {}
    for (name, pc), (_, ph) in zip(card_m.named_parameters(),
                                   host_m.named_parameters()):
        diff = pc.grad.cpu() - ph.grad
        rel[name] = float(diff.norm() / ph.grad.norm().clamp(min=1e-30))
        del diff
    worst = max(rel, key=rel.get)
    loss_rel = abs(losses["card"] - losses["host"]) / abs(losses["host"])
    same = all(torch.equal(a, b)
               for a, b in zip(slots["card"], slots["host"]))
    kept = int(slots["host"][2].sum())
    k = cut.experts_per_token
    say("moe-train", f"(a) float32 gate, {cut.name} cut to 1 layer, 1 x {T} "
        f"tokens (seed 1), capacity {moe.capacity_for(T, cut)} per expert: "
        f"loss card {losses['card']:.6f} vs cpu {losses['host']:.6f} (rel "
        f"{loss_rel:.2e} <= {GATE_LOSS_RTOL}); {len(rel)} gradient leaves, "
        f"worst ||g_card - g_cpu|| / ||g_cpu|| = {rel[worst]:.3e} ({worst}) "
        f"<= {GATE_LEAF_RTOL}; router {rel['layers.0.moe.router']:.3e}, "
        f"experts {max(rel['layers.0.moe.' + n] for n in moe.MoE.expert_leaves):.3e}; "
        f"(token, choice) -> (expert, slot) identical={same}, kept {kept}, "
        f"dropped {T * k - kept} of {T * k}; {time.perf_counter() - t0:.1f} "
        f"s; {card}")
    check(math.isfinite(losses["card"]) and loss_rel <= GATE_LOSS_RTOL,
          "(a) the card's loss disagrees with the host's")
    check(rel[worst] <= GATE_LEAF_RTOL, f"(a) gradient of {worst} "
          f"disagrees: {rel[worst]}")
    check(same, "(a) the card's MoE keeps other (expert, slot) pairs than "
          "the host's")
    del card_m, host_m
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def node_time(prof, nodes) -> dict:
    """Device seconds of the kernels that each autograd node of ``nodes``
    (by the name of its ``evaluate_function`` event) launched itself:
    each host op's own kernels go to the innermost such node above it,
    and to none when a ``record_function`` range (``RANGES``: a layer's
    recompute run from inside the node) comes first."""
    from torch.autograd import DeviceType

    prefix = "autograd::engine::evaluate_function: "
    out = {n: 0.0 for n in nodes}
    for e in prof.events():
        if e.device_type != DeviceType.CPU or not e.self_device_time_total:
            continue
        a = e
        while a is not None and a.name not in RANGES and \
                a.name.removeprefix(prefix) not in out:
            a = a.cpu_parent
        if a is not None and a.name not in RANGES:
            out[a.name.removeprefix(prefix)] += e.self_device_time_total / 1e6
    return out


def train_breakdown(phase: str, part: str, job, state, batch) -> None:
    """One training step under ``torch.profiler``: device time by kind.
    Ranges by their device-side spans (the trace's rows of
    ``record_function`` ranges): the MoE's router, dispatch, expert
    products and combine in the forward and remat's recompute (``moe.*``)
    and the optimizer (``train_step.optimizer``).  Backward nodes by the
    kernels they launched (``node_time``; the recompute they run is under
    ``transformer.layer`` ranges and left out): the expert products'
    (``BmmBackward0``), the gathers' (``IndexBackward0``: the combine's,
    the dispatch's, the embedding's) and the combine's sum
    (``AddcmulBackward0``).  Kernels by name: K2, K2-bwd and the float32
    GEMMs (the loss head's products)."""
    result = traced(phase, "one training step", lambda: job.step_fn(
        state, batch), 1, part)
    check(result is not None, f"{part} the step's trace holds no device time")
    prof, kern, busy = result
    from torch.autograd import DeviceType
    span = {r: 0.0 for r in RANGES}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.key in span:
            span[e.key] += e.self_device_time_total / 1e6
    nodes = node_time(prof, ("BmmBackward0", "IndexBackward0",
                             "AddcmulBackward0"))
    rest = (busy - sum(span[n] for n in MOE_RANGES)
            - span["train_step.optimizer"] - sum(nodes.values()))
    kernels = {"K2 sm90": ("flash_sm90_kernel",),
               "K2-bwd sm90": ("flash_bwd_sm90_",),
               "float32 GEMMs (the loss head)": ("f32f32", "sgemm")}
    by_key = {label: sum(e.self_device_time_total for e in kern
                         if any(k in e.key for k in keys)) / 1e6
              for label, keys in kernels.items()}
    parts = {**{f"{n} forward+recompute": span[n] for n in MOE_RANGES},
             "expert bmms backward": nodes["BmmBackward0"],
             "gathers' backward (combine, dispatch, embedding)":
                 nodes["IndexBackward0"],
             "combine's sum backward": nodes["AddcmulBackward0"],
             "optimizer": span["train_step.optimizer"],
             "everything else (attention, projections and norms forward, "
             "recompute and backward; the loss head; the embedding)": rest}
    say(phase, f"{part}   device time by kind: " + ", ".join(
        f"{n} {t:.4f} s ({t / busy * 100:.1f} %)" for n, t in parts.items())
        + "; by kernel: " + ", ".join(
            f"{n} {t:.4f} s ({t / busy * 100:.1f} %)"
            for n, t in by_key.items()))


def plain_k2_bwd(q, k, v, o, do, lse, *, causal: bool = True,
                 window: int = 0, scale: float | None = None,
                 q_offset: int = 0):
    """K2-bwd's plain version in its place, one sequence at a time, P and
    dS rounded to bf16 where the ``sm90`` kernel rounds them."""
    parts = [flash_attention_bwd_ref(
        *(x[i:i + 1] for x in (q, k, v, o, do, lse)), causal=causal,
        window=window, scale=scale, round_to=torch.bfloat16,
        q_offset=q_offset)
        for i in range(q.shape[0])]
    return tuple(torch.cat(g) for g in zip(*parts))


def leaf_rel(host: torch.Tensor, card: torch.Tensor) -> float:
    """||card - host|| / ||host|| of one gradient leaf (``host`` on the
    host), summed in float32 blocks of ``GRAD_BLOCK`` elements."""
    h, c = host.reshape(-1), card.reshape(-1)
    num = den = 0.0
    for i in range(0, h.numel(), GRAD_BLOCK):
        w = h[i:i + GRAD_BLOCK].to(DEV).float()
        num += float((c[i:i + GRAD_BLOCK].float() - w).square().sum())
        den += float(w.square().sum())
    return math.sqrt(num / den) if den else math.sqrt(num)


def grads_held(job, batch, plain: bool = True) -> dict:
    """``job``'s loss and gradients from its state on ``batch`` three times
    (no optimizer step between; twice without ``plain``): twice through
    K2-bwd, bit-equal; then with K2-bwd's plain version in its place
    (``plain_k2_bwd``): the
    forward, so the routing, is the same, and each gradient leaf may
    differ only by what K2-bwd's band lets through the rest of the
    backward, held at relative norm ``K2B_NORM``.  The first run's
    gradients wait on the host.  Returns the loss, whether the reruns were
    bit-equal, and each leaf's relative norm against the plain backward."""
    model = job.model
    batch = batch_on_card(batch)
    k2_module = importlib.import_module("repro_torch.kernels.flash_attention")
    kernel_bwd = k2_module.flash_attention_bwd
    out: dict = {}
    runs = (kernel_bwd, kernel_bwd) + ((plain_k2_bwd,) if plain else ())
    for run, bwd in enumerate(runs):
        for p in model.parameters():
            p.grad = None
        k2_module.flash_attention_bwd = bwd
        try:
            loss = model.loss(batch)
            loss.backward()
        finally:
            k2_module.flash_attention_bwd = kernel_bwd
        loss = loss.detach()
        grads = {n: p.grad for n, p in model.named_parameters()
                 if p.grad is not None}    # a stub frontend's token table
        if run == 0:
            out["loss"], host = loss, {n: g.cpu() for n, g in grads.items()}
        elif run == 1:
            out["twice"] = torch.equal(loss, out["loss"]) and all(
                torch.equal(host[n], g.cpu()) for n, g in grads.items())
        else:
            out["plain_loss_equal"] = torch.equal(loss, out["loss"])
            out["rel"] = {n: leaf_rel(host[n], g) for n, g in grads.items()}
        del grads
    for p in model.parameters():
        p.grad = None
    out["loss"] = float(out["loss"])
    return out


def moe_train_path(gen, cfg, card: str) -> tuple[dict, float, int]:
    """(b) bf16 at full width cut to ``MOE_TRAIN_LAYERS`` layers, remat
    "full", AdamW with bf16 states, through ``launch.train``'s objects:
    the dry run's peak first (batch ``MOE_TRAIN_BATCH``, else 1); K2's
    ``lse``, K2-bwd and the two chained through autograd at the step's
    attention shape against their plain versions; then
    ``MOE_TRAIN_STEPS`` steps with launches and kept/dropped pairs counted,
    one step traced by kind, the dry run held against a step, and the
    loss and gradients taken twice from one state, bit-equal, and once
    with K2-bwd's plain version (``grads_held``).  Returns the steps'
    launches, the first step's loss and the batch size."""
    cut = dataclasses.replace(cfg, num_layers=MOE_TRAIN_LAYERS)
    batch_n = MOE_TRAIN_BATCH
    shape = ShapeSpec("train", "train", TRAIN_SEQ, batch_n)
    rec = dryrun.run_cell(cut.name, "train", None, False, shape=shape,
                          device=DEV, cfg=cut)
    check(rec.get("status") == "ok", f"(b) the dry run gave {rec}")
    peak = rec["memory"]["peak_bytes"]
    say("moe-train", f"(b) dry run of {cut.name} cut to {cut.num_layers} "
        f"layers, batch {batch_n} x {TRAIN_SEQ}: arguments "
        f"{rec['memory']['argument_bytes'] / 2**30:.3f} GiB, peak "
        f"{peak / 2**30:.3f} GiB (limit {MOE_TRAIN_PEAK / 2**30:.0f} GiB), "
        f"{rec['flops_per_device']:.4e} FLOP; traced in {rec['trace_s']} s")
    if peak > MOE_TRAIN_PEAK:
        batch_n = 1
        shape = ShapeSpec("train", "train", TRAIN_SEQ, batch_n)
        rec = dryrun.run_cell(cut.name, "train", None, False, shape=shape,
                              device=DEV, cfg=cut)
        say("moe-train", f"(b) over the limit: batch 1 x {TRAIN_SEQ}, peak "
            f"predicted {rec['memory']['peak_bytes'] / 2**30:.3f} GiB")
    # K2 (with lse) and K2-bwd at this step's attention shape (Dk = Dv =
    # 128: K2-bwd's DKB = DVB = 2 instantiation), before the model is built
    flash_bwd_row(f"{cut.name}-train-path", gen, batch_n, TRAIN_SEQ,
                  cut.num_heads, cut.num_kv_heads, cut.head_dim,
                  cut.head_dim, cut.window, torch.bfloat16, twice=True,
                  phase="moe-train", part="(b)")
    k2_lse(gen, cut, batch_n, "moe-train", "(b)")
    flash_autograd_row(gen, cut, cut.window, batch_n, "moe-train", "(b)")
    torch.cuda.empty_cache()
    args = train_cli.parse_args([
        "--arch", cfg.name, "--batch", str(batch_n), "--seq",
        str(TRAIN_SEQ), "--steps", str(MOE_TRAIN_STEPS), "--device", DEV])
    t0 = time.perf_counter()
    job, reading = built(lambda: train_cli.build(args, cut),
                         lambda job: tree_flatten(job.state)[0])
    n_params = sum(p.numel() for p in job.model.parameters())
    say("moe-train", f"(b) {cut.name} bf16 cut to {cut.num_layers} of "
        f"{cfg.num_layers} layers, remat {cut.remat}, AdamW (state "
        f"{job.opt.state_dtype}): {n_params / 1e9:.4f} B params (seed "
        f"{args.seed}), batch {batch_n} x {TRAIN_SEQ} tokens of SyntheticLM; "
        f"built in {time.perf_counter() - t0:.1f} s; memory_allocated "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB; {card}")
    records: list = []
    record_moe(moe_layers(job.model), records)
    reset_launches()
    state, data, losses, times, peak = take_steps(
        "moe-train", "(b)", job, MOE_TRAIN_STEPS, step_launches(cut), records)
    launches = launch_counts()
    for m in moe_layers(job.model):
        del m.moe_local
    step_s = float(np.mean(times))
    tokens = batch_n * TRAIN_SEQ
    dense, attn = model_flop(cut, n_params, batch_n, TRAIN_SEQ,
                             job.model.windows)
    flops = dense + attn
    say("moe-train", f"(b) steps 2-{MOE_TRAIN_STEPS}: {step_s * 1e3:.2f} "
        f"ms/step ({', '.join(f'{t * 1e3:.2f}' for t in times)}), "
        f"{tokens / step_s:.1f} training tokens/s, model "
        f"{flops / step_s / 1e12:.2f} TFLOP/s (6*N_active*T {dense:.4e}, "
        f"top-{cut.experts_per_token} of {cut.num_experts} experts, + "
        f"attention {attn:.4e}; {flops / step_s / PEAK['bfloat16'][0] * 100:.1f}"
        f" % of the 989 TFLOP/s bf16 peak); peak max_memory_allocated "
        f"{peak / 2**30:.3f} GiB; launches {launches}; {card}")
    train_breakdown("moe-train", "(b)", job, state, next(data))
    batch = next(data)
    dryrun_hold(f"{cut.name} at {cut.num_layers} layers, training step",
                cut, shape, lambda: job.step_fn(state, batch), reading,
                step_s, "step time", rec=rec)
    held = grads_held(job, next(data))
    rel = held["rel"]
    worst = max(rel, key=rel.get)
    exact = sum(r == 0.0 for r in rel.values())
    say("moe-train", f"(b) loss and {n_params / 1e9:.4f} B gradients taken "
        f"twice from one state on one batch: bit-equal={held['twice']} "
        f"(loss {held['loss']:.6f}; the MoE's backward: PyTorch's gathers' "
        f"index_put_ with accumulate, as it stands); with K2-bwd's plain "
        f"version (P, dS rounded to bf16) in its place: loss bit-equal="
        f"{held['plain_loss_equal']}, {len(rel)} gradient leaves, {exact} "
        f"bit-equal, worst ||g_K2-bwd - g_plain|| / ||g_plain|| = "
        f"{rel[worst]:.3e} ({worst}) <= {K2B_NORM}; {card}")
    check(held["twice"], "(b) two runs of the step's loss and gradients "
          "differ")
    check(held["plain_loss_equal"], "(b) the step's loss changed with the "
          "backward")
    check(rel[worst] <= K2B_NORM, f"(b) the step's gradient of {worst} "
          f"through K2-bwd disagrees with the plain backward's: {rel[worst]}")
    del job, state, records
    gc.collect()
    torch.cuda.empty_cache()
    return launches, losses[0], batch_n


def dots_hymba(card: str) -> dict:
    """(c) phase 7 (c)'s hymba-1.5B step (bf16, full depth, batch
    ``TRAIN_BATCH`` x ``TRAIN_SEQ``) under remat "dots": launches, ms/step,
    peak, one step traced (device busy and idle against phase 7 (c)'s
    traced "full" step), step 1's loss against phase 7 (c)'s under "full"
    from the same weights and batch, and the dry run's prediction of the
    step held as phase 10 (a) holds it.  Returns the steps' launches."""
    cfg = dataclasses.replace(get_config(SERVE_ARCH), remat="dots")
    args = train_cli.parse_args([
        "--arch", cfg.name, "--batch", str(TRAIN_BATCH), "--seq",
        str(TRAIN_SEQ), "--steps", str(TRAIN_STEPS), "--device", DEV])
    job, reading = built(lambda: train_cli.build(args, cfg),
                         lambda job: tree_flatten(job.state)[0])
    reset_launches()
    state, data, losses, times, peak = take_steps(
        "moe-train", "(c)", job, TRAIN_STEPS, step_launches(cfg))
    launches = launch_counts()
    step_s = float(np.mean(times))
    full = MEASURED.get("train_loss", float("nan"))
    busy, wall = profile_step(job, state, next(data), "moe-train", "(c)")
    f_busy, f_wall = MEASURED.get("step_trace", (float("nan"),) * 2)
    say("moe-train", f"(c) traced step, dots against phase 7 (c)'s full: "
        f"device busy {busy:.4f} s vs {f_busy:.4f} s, wall {wall:.4f} s vs "
        f"{f_wall:.4f} s, idle {(1 - busy / wall) * 100:.1f} % vs "
        f"{(1 - f_busy / f_wall) * 100:.1f} %; {card}")
    say("moe-train", f"(c) {cfg.name} bf16, remat dots, batch {TRAIN_BATCH} "
        f"x {TRAIN_SEQ}: steps 2-{TRAIN_STEPS} {step_s * 1e3:.2f} ms/step "
        f"({', '.join(f'{t * 1e3:.2f}' for t in times)}; phase 7 (c) under "
        f"full: {', '.join(f'{t:.2f}' for t in MEASURED.get('step_ms', []))}"
        f"); peak max_memory_allocated {peak / 2**30:.3f} GiB; launches "
        f"{launches}; step 1 loss {losses[0]!r} vs full's {full!r}: "
        f"bit-equal={losses[0] == full}; {card}")
    check(abs(losses[0] - full) <= DOTS_LOSS_RTOL * abs(full),
          f"(c) step 1's loss under dots {losses[0]} is not full's {full}")
    batch = next(data)
    dryrun_hold("hymba-1.5B training step, remat dots", cfg,
                ShapeSpec("train", "train", TRAIN_SEQ, TRAIN_BATCH),
                lambda: job.step_fn(state, batch), reading, step_s,
                "step time")
    del job, state
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def dots_dbrx(cfg, loss_full: float, batch_n: int, card: str) -> dict:
    """(c) one step of (b)'s dbrx-132B cut under remat "dots" from the same
    seed and batch (``batch_n`` x ``TRAIN_SEQ``): launches, peak, and its
    loss against (b)'s first.  Returns the step's launches."""
    cut = dataclasses.replace(cfg, num_layers=MOE_TRAIN_LAYERS, remat="dots")
    args = train_cli.parse_args([
        "--arch", cfg.name, "--batch", str(batch_n), "--seq",
        str(TRAIN_SEQ), "--steps", "1", "--device", DEV])
    job = train_cli.build(args, cut)
    reset_launches()
    _, _, losses, _, peak = take_steps("moe-train", "(c)", job, 1,
                                       step_launches(cut))
    launches = launch_counts()
    say("moe-train", f"(c) {cut.name} cut to {cut.num_layers} layers under "
        f"remat dots, batch {batch_n} x {TRAIN_SEQ}: one step, peak "
        f"max_memory_allocated {peak / 2**30:.3f} GiB; loss {losses[0]!r} "
        f"vs (b)'s full {loss_full!r}: bit-equal={losses[0] == loss_full}; "
        f"{card}")
    check(abs(losses[0] - loss_full) <= DOTS_LOSS_RTOL * abs(loss_full),
          f"(c) the dbrx step's loss under dots {losses[0]} is not full's "
          f"{loss_full}")
    del job
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def llama4_prefill(model, tokens) -> tuple:
    """The prefill of ``tokens``: (last-token logits on the host, the first
    MoE layer's router logits (tokens, experts) in float32 on the host, its
    (expert ids, slot, keep))."""
    seen, hook = moe_input(model)
    try:
        with torch.inference_mode():
            logits = model.prefill({"tokens": tokens})[0].float().cpu()
            router = (seen["x"].float() @ moe_layers(model)[0].router).cpu()
    finally:
        hook.remove()
    return logits, router, kept_slots(model, seen["x"])


def sdpa_attention(q, k, v, *, causal: bool = True, window: int = 0,
                   scale: float | None = None) -> torch.Tensor:
    """``flash_attention``'s function through one
    ``scaled_dot_product_attention`` call in q's dtype, KV heads repeated
    to the query heads: the library's bf16 attention, the yardstick of
    (d)'s routing."""
    G = q.shape[2] // k.shape[2]
    qt, kt, vt = (x.transpose(1, 2) for x in (
        q, k.repeat_interleave(G, 2), v.repeat_interleave(G, 2)))
    kw: dict = {"scale": scale}
    if window > 0:
        kw["attn_mask"] = band_mask(q.shape[1], k.shape[1], causal, window)
    else:
        kw["is_causal"] = causal
    return torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, **kw).transpose(1, 2).contiguous()


def llama4_serve(card: str) -> dict:
    """(d) llama4-maverick-400B-A17B bf16 at full width cut to
    ``LLAMA4_LAYERS`` layers (one dense, one MoE): phase 6 (b)'s traffic
    through ``PoasDispatcher`` and ``ServingEngine`` with K2 (all
    ``sm90``) and kept/dropped pairs counted per prefill, the larger bucket
    traced, then its prefill with K2, with K2's plain version and with
    sdpa on the card: logits and the MoE layer's router logits within the
    bf16 gate; the kept pairs only through that band, so the tokens K2
    routes to another expert than the plain version are counted and held
    to ``LLAMA4_MOVED_FACTOR`` times sdpa's; and with K2 again, bit-equal.
    Returns the launches of the served traffic."""
    cfg = get_config(LLAMA4_ARCH)
    cut = dataclasses.replace(cfg, num_layers=LLAMA4_LAYERS)
    t0 = time.perf_counter()
    model = Model(cut, device=DEV,
                  generator=torch.Generator(DEV).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    wbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    say("moe-train", f"(d) {cut.name} bf16 cut to {LLAMA4_LAYERS} of "
        f"{cfg.num_layers} layers ({cut.num_experts} experts top-"
        f"{cut.experts_per_token}, shared expert of {cut.shared_expert_ff}, "
        f"dense and MoE layers alternating, vocab {cut.vocab_size}): "
        f"{n_params / 1e9:.4f} B params, {wbytes / 1e9:.3f} GB of weights "
        f"(seed 0), built in {time.perf_counter() - t0:.1f} s; {card}")
    buckets, warm = serve_traffic("moe-train", cut)
    launches = serve_moe_buckets("moe-train", "(d)", model, buckets, warm,
                                 card)
    big = max(buckets, key=len)
    profile_serve("moe-train", model, big, moe_breakdown, "(d)")
    tokens = bucket_tokens(big)
    (a, ra, sa), (b, rb, sb) = (llama4_prefill(model, tokens)
                                for _ in range(2))
    kernel_attention = model_layers.flash_attention
    swapped = {}
    for name, fn in (("plain", flash_attention_ref), ("sdpa", sdpa_attention)):
        model_layers.flash_attention = fn
        try:
            swapped[name] = llama4_prefill(model, tokens)
        finally:
            model_layers.flash_attention = kernel_attention
    (p, rp, sp), (_, _, sl) = swapped["plain"], swapped["sdpa"]
    twice = (torch.equal(a, b) and torch.equal(ra, rb)
             and all(torch.equal(x, y) for x, y in zip(sa, sb)))
    err, scale = float((a - p).abs().max()), float(p.abs().max())
    ok = torch.allclose(a, p, rtol=LLAMA4_TOL, atol=LLAMA4_TOL * scale)
    r_err, r_scale = float((ra - rp).abs().max()), float(rp.abs().max())
    r_ok = torch.allclose(ra, rp, rtol=LLAMA4_TOL,
                          atol=LLAMA4_TOL * r_scale)
    # The expert ids come from these router logits, so a token moves only
    # where its top-1 margin is below their difference: the band above is
    # all that holds the kept pairs.  How many move is held against the
    # library's bf16 attention.
    moved = (sa[0] != sp[0]).any(-1)
    lib_moved = int((sl[0] != sp[0]).any(-1).sum())
    top2 = rp.topk(2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1]
    same = all(torch.equal(x, y) for x, y in zip(sa, sp))
    say("moe-train", f"(d) prefill of {tuple(tokens.shape)} with K2 against "
        f"K2's plain version (flash_attention_ref) on the card: last-token "
        f"logits max_abs_err={err:.3e} of max |logit| {scale:.3e}, "
        f"allclose(rtol={LLAMA4_TOL}, atol={LLAMA4_TOL} x max)={ok}; the "
        f"MoE layer's router logits max_abs_err={r_err:.3e} of "
        f"{r_scale:.3e}, allclose={r_ok}; kept (token, choice) -> (expert, "
        f"slot) identical={same}: {int(moved.sum())} of {moved.numel()} "
        f"tokens routed to another expert (top-1 margin of those "
        f"<= {float(margin[moved].max()) if moved.any() else 0.0:.3e}, "
        f"median margin of all {float(margin.median()):.3e}), kept "
        f"{int(sa[2].sum())} vs {int(sp[2].sum())}; through sdpa (bf16) "
        f"{lib_moved} tokens moved (bound: K2's <= {LLAMA4_MOVED_FACTOR} x "
        f"sdpa's); with K2 twice: logits, "
        f"router logits and kept pairs bit-equal={twice}; {card}")
    check(bool(torch.isfinite(a).all()), "(d) the prefill's logits are not "
          "finite")
    check(ok, "(d) the prefill through K2 disagrees with its plain version")
    check(r_ok, "(d) the MoE layer's router logits through K2 disagree "
          "with its plain version's")
    check(int(moved.sum()) <= LLAMA4_MOVED_FACTOR * lib_moved,
          f"(d) K2 routes {int(moved.sum())} tokens to another expert than "
          f"its plain version, sdpa {lib_moved}")
    check(twice, "(d) two prefills through K2 differ")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def moe_train_phase(gen, card: str) -> dict:
    """Phase 11: (a) dbrx-132B's float32 gradient gate, (b) its bf16
    training path at 2 layers, (c) remat "dots" on hymba-1.5B and on (b)'s
    cut, (d) llama4-maverick served at 2 layers.  Returns each kernel's
    launches over the phase's main paths."""
    cfg = get_config(MOE_ARCH)
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    total = moe_train_gate(cfg, card)
    b, loss_full, batch_n = moe_train_path(gen, cfg, card)
    add_launches(total, b, dots_hymba(card),
                 dots_dbrx(cfg, loss_full, batch_n, card), llama4_serve(card))
    say("moe-train", f"main path launches {total}; done in "
        f"{time.perf_counter() - t0:.1f} s")
    return total


# ---------------------------------------------------------------------------
# Phases 12 and 13: one configuration gated, served and trained on the card
# ---------------------------------------------------------------------------


def model_gate(cfg, phase: str, card: str, layers: int, tokens: int) -> dict:
    """(a) float32, full width cut to ``layers`` layers, one ``tokens``-long
    sequence of ``SyntheticLM`` (seed 0; embeddings for a stub frontend):
    the prefill's last-token logits and the loss with every parameter
    gradient on the card (K2 and K2-bwd ``tf32x3``, K3 and K3-bwd) against
    the same weights moved to the host (the plain versions), at phase 8
    (a)'s and phase 7 (b)'s gates, every card gradient finite; then the
    same cut's prefill against its decode (``prefill_matches_decode``).
    Launches per route as ``route`` and ``route_bwd`` name them.  Returns
    the launches of the card's prefills and step, counted from 0."""
    cut = dataclasses.replace(cfg, num_layers=layers, dtype="float32",
                              remat="none")
    t0 = time.perf_counter()
    need = 2 * 4 * cut.param_count()          # float32 weights and grads
    avail = host_available()
    check(avail > 1.2 * need, f"(a) the host has {avail / 1e9:.1f} GB "
          f"available, the gate needs {need / 1e9:.1f} GB and more")
    key = inputs_key(cut)
    batch = SyntheticLM(DataConfig(
        vocab_size=cut.vocab_size, seq_len=tokens, global_batch=1, seed=0,
        embed_dim=cut.d_model if key == "embeds" else 0)).batch(0)
    card_m = Model(cut, device=DEV,
                   generator=torch.Generator(DEV).manual_seed(0))
    host_m = Model(cut, device="meta")
    host_m.load_state_dict({k: v.cpu() for k, v in
                            card_m.state_dict().items()}, assign=True)
    logits, losses = {}, {}
    reset_launches()
    for where, model in (("card", card_m), ("host", host_m)):
        on = {k: torch.as_tensor(v).to(model.device)
              for k, v in batch.items()}
        with torch.inference_mode():
            logits[where] = model.prefill({key: on[key]})[0][0].cpu()
        model.requires_grad_(True)
        loss = model.loss(on)
        loss.backward()
        losses[where] = float(loss.detach())
        if where == "card":
            torch.cuda.synchronize()
            launches = launch_counts()
    want = kernel_launches(cut, torch.float32, 2, 1)
    check(launches == want, f"(a) the card's float32 prefill and step "
          f"launched {launches}, not {want}")
    rel, finite = {}, True
    for (name, pc), (_, ph) in zip(card_m.named_parameters(),
                                   host_m.named_parameters()):
        if ph.grad is None:      # a stub frontend's token table
            check(pc.grad is None, f"(a) {name}: a gradient on the card only")
            continue
        finite &= bool(torch.isfinite(pc.grad).all())
        rel[name] = leaf_rel(ph.grad, pc.grad)
    worst = max(rel, key=rel.get)
    mixer = max((n for n in rel if ".attn." in n or ".ssm." in n),
                key=rel.get)
    err = float((logits["card"] - logits["host"]).abs().max())
    ok = torch.allclose(logits["card"], logits["host"],
                        rtol=PREFILL_DECODE_TOL, atol=PREFILL_DECODE_TOL)
    loss_rel = abs(losses["card"] - losses["host"]) / abs(losses["host"])
    say(phase, f"(a) float32 gate, {cut.name} cut to {layers} layers, 1 x "
        f"{tokens} {key} (SyntheticLM seed 0): last-token logits card vs "
        f"host max_abs_err={err:.3e}, logits std "
        f"{float(logits['host'].std()):.3e}, allclose(rtol=atol="
        f"{PREFILL_DECODE_TOL})={ok}; loss card {losses['card']:.6f} vs host "
        f"{losses['host']:.6f} (rel {loss_rel:.2e} <= {GATE_LOSS_RTOL}); "
        f"{len(rel)} gradient leaves, all finite on the card={finite}, worst "
        f"||g_card - g_host|| / ||g_host|| = {rel[worst]:.3e} ({worst}) <= "
        f"{GATE_LEAF_RTOL}, worst attention/SSM leaf {rel[mixer]:.3e} "
        f"({mixer}); launches {launches}; host MemAvailable "
        f"{avail / 1e9:.1f} GB; {time.perf_counter() - t0:.1f} s; {card}")
    check(bool(torch.isfinite(logits["card"]).all()) and ok,
          "(a) the card's float32 prefill disagrees with the host's")
    check(math.isfinite(losses["card"]) and loss_rel <= GATE_LOSS_RTOL,
          "(a) the card's loss disagrees with the host's")
    check(finite, "(a) a gradient on the card is not finite")
    check(rel[worst] <= GATE_LEAF_RTOL, f"(a) gradient of {worst} "
          f"disagrees: {rel[worst]}")
    del card_m, host_m
    gc.collect()
    torch.cuda.empty_cache()
    before = launch_counts()
    prefill_matches_decode(cut, phase)
    n = {k: v - before[k] for k, v in launch_counts().items()}
    want = kernel_launches(cut, torch.float32, 5, 0)
    check(n == want, f"(a) five float32 prefills launched {n}, not {want}")
    say(phase, f"(a) done in {time.perf_counter() - t0:.1f} s")
    return {k: v + n[k] for k, v in launches.items()}


def embed_generate(model, rng, requests) -> list:
    """``ServingEngine.generate``'s loop for a stub frontend: the bucket's
    padded prompt and one new position a decode step as seeded embeddings
    (``seeded_embeds``, put on the card before the clock starts) in place
    of token ids; the greedy ids are what the completions hold.  The
    reference's serving refuses stub frontends, so this drives ``Model``
    itself."""
    plen = max(len(r.tokens) for r in requests)
    max_new = max(r.max_new_tokens for r in requests)
    x = seeded_embeds(rng, len(requests), plen + max_new - 1,
                      model.cfg.d_model)
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = model.prefill({"embeds": x[:, :plen]})
        cache = model.extend_cache(cache, max_new)
        torch.cuda.synchronize()
        t_prefill = time.perf_counter() - t0
        outs = [logits.argmax(-1)]
        t0 = time.perf_counter()
        for i in range(plen, plen + max_new - 1):
            logits, cache = model.decode_step(cache,
                                              {"embeds": x[:, i:i + 1]})
            outs.append(logits.argmax(-1))
        torch.cuda.synchronize()
        t_decode = time.perf_counter() - t0
        check(bool(torch.isfinite(logits).all()), "a stub frontend's decode "
              "logits are not finite")
        gen = torch.stack(outs, dim=1).cpu().numpy()
    return [Completion(r.uid, gen[i, :r.max_new_tokens], t_prefill, t_decode)
            for i, r in enumerate(requests)]


def serve_depth(cfg) -> int:
    """The largest depth whose bf16 weights (``ArchConfig.param_count``)
    stay under ``SERVE_WEIGHTS``."""
    L = cfg.num_layers
    while L > 1 and 2 * dataclasses.replace(
            cfg, num_layers=L).param_count() > SERVE_WEIGHTS:
        L -= 1
    return L


def model_serve(cfg, phase: str, card: str, trace: bool = True
                ) -> tuple[dict, tuple]:
    """(b) bf16 at full width and the largest depth ``serve_depth`` gives:
    phase 6 (b)'s traffic through ``PoasDispatcher`` and ``ServingEngine``
    (a stub frontend: its bucket shapes as seeded embeddings through
    ``embed_generate``), each prefill launching K2 or K3 once a layer and
    the decode steps none, completions in vocabulary; prefill and decode
    rates, peak memory; the larger bucket traced (``trace``) or timed by
    CUDA events.  Returns the launches and the larger bucket's (B, S)."""
    t0 = time.perf_counter()
    L = serve_depth(cfg)
    cut = dataclasses.replace(cfg, num_layers=L)
    model = Model(cut, device=DEV,
                  generator=torch.Generator(DEV).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    wbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    why = ("full depth" if L == cfg.num_layers else
           f"cut: {L + 1} layers' bf16 weights would pass "
           f"{SERVE_WEIGHTS / 2**30:.0f} GiB")
    Dk, Dv = attention_dims(cfg)
    mixer = (f"{cfg.ssm_heads} SSM heads of {cfg.ssm_head_dim}, state "
             f"{cfg.ssm_state}, chunk {cfg.ssm_chunk} (K3)"
             if cfg.is_attention_free else
             f"{cfg.num_heads}/{cfg.num_kv_heads} heads, K2 at Dk {Dk} / Dv "
             f"{Dv} ({route(torch.bfloat16, Dk, Dv)})"
             + (", QKV bias" if cfg.qkv_bias else ""))
    say(phase, f"(b) {cfg.name} bf16 at full width, {L} of "
        f"{cfg.num_layers} layers ({why}): d_model {cfg.d_model}, {mixer}, "
        f"vocab {cfg.vocab_size}, inputs {inputs_key(cfg)}; "
        f"{n_params / 1e9:.4f} B params, {wbytes / 1e9:.3f} GB of weights "
        f"(seed 0), built in {time.perf_counter() - t0:.1f} s; {card}")
    buckets, warm = serve_traffic(phase, cut)
    if inputs_key(cut) == "embeds":
        generate = functools.partial(embed_generate, model,
                                     np.random.default_rng(2))
    else:
        generate = ServingEngine(model).generate
    generate(warm)                                     # warm-up, not counted
    reset_launches()
    shapes = serve_buckets(phase, generate, buckets, cut, card)
    launches = launch_counts()
    profile_serve(phase, model, max(buckets, key=len), part="(b)",
                  trace=trace)
    del model, generate
    gc.collect()
    torch.cuda.empty_cache()
    say(phase, f"(b) done in {time.perf_counter() - t0:.1f} s")
    return launches, max(shapes)[1:]


# Phases 12 and 13 (c): the first dry run of each trained configuration's
# depth search, traced ahead in worker processes (``depth_prefetch``)
DEPTH_AHEAD: dict = {}


def first_depth(cfg) -> int:
    """The depth ``train_depth`` traces first: the full depth where the
    state of the full depth fits ``TRAIN_PEAK``, else half of it."""
    full = cfg.num_layers
    fits = 8 * cfg.param_count() <= TRAIN_PEAK
    return full if fits else max(1, full // 2)


def depth_prefetch(cfgs) -> ProcessPoolExecutor:
    """Start the first dry run of ``train_depth`` for each of ``cfgs`` in
    a pool of spawned processes at the lowest scheduling priority, to be
    traced while the card works on other phases; ``depth_collect`` waits
    for the records and ``train_depth`` takes them from ``DEPTH_AHEAD``.
    Returns the pool (shut down at exit too)."""
    pool = ProcessPoolExecutor(len(cfgs), mp_context=mp.get_context("spawn"),
                               initializer=os.nice, initargs=(19,))

    def stop() -> None:
        for proc in list((pool._processes or {}).values()):
            proc.kill()
        pool.shutdown(wait=False, cancel_futures=True)
    atexit.register(stop)
    shape = ShapeSpec("train", "train", TRAIN_SEQ, TRAIN_BATCH)
    for cfg in cfgs:
        cut = dataclasses.replace(cfg, num_layers=first_depth(cfg))
        DEPTH_AHEAD[cut.name, cut.num_layers] = pool.submit(
            dryrun.run_cell, cut.name, "train", None, False, shape=shape,
            device=DEV, cfg=cut)
    return pool


def depth_collect(pool: ProcessPoolExecutor) -> None:
    """``depth_prefetch``'s records waited for, and its pool shut down: no
    worker holds the card's memory past this point."""
    for key, fut in list(DEPTH_AHEAD.items()):
        DEPTH_AHEAD[key] = fut.result()
    pool.shutdown(wait=True)


def train_depth(cfg, phase: str, shape) -> tuple:
    """The largest depth whose dry-run peak (``launch.dryrun``'s
    ``run_cell`` on fake cuda tensors) stays under ``TRAIN_PEAK``.  A
    layer adds its parameters' bf16 weights, gradients and two AdamW
    moments (8 bytes a parameter) to the peak, so the full depth is traced
    only where those bytes fit; else, and where its peak does not fit, the
    depth that growth from the half depth's peak puts under the limit is
    traced, and stepped down until its own peak fits.  Returns the cut and
    its record."""
    @functools.cache
    def dry(L):
        cut = dataclasses.replace(cfg, num_layers=L)
        rec = DEPTH_AHEAD.pop((cut.name, L), None)
        if rec is None or shape != ShapeSpec("train", "train", TRAIN_SEQ,
                                             TRAIN_BATCH):
            rec = dryrun.run_cell(cut.name, "train", None, False,
                                  shape=shape, device=DEV, cfg=cut)
        check(rec.get("status") == "ok", f"(c) the dry run gave {rec}")
        say(phase, f"(c) dry run of {cut.name} at {L} of {cfg.num_layers} "
            f"layers, batch {shape.batch} x {shape.seq}: arguments "
            f"{rec['memory']['argument_bytes'] / 2**30:.3f} GiB, peak "
            f"{rec['memory']['peak_bytes'] / 2**30:.3f} GiB (limit "
            f"{TRAIN_PEAK / 2**30:.0f} GiB), {rec['flops_per_device']:.4e} "
            f"FLOP; traced in {rec['trace_s']} s")
        return cut, rec

    def peak(L):
        return dry(L)[1]["memory"]["peak_bytes"]

    def state_bytes(L):
        return 8 * dataclasses.replace(cfg, num_layers=L).param_count()

    full = L = cfg.num_layers
    if first_depth(cfg) != full or peak(full) > TRAIN_PEAK:
        half = max(1, full // 2)
        per = (state_bytes(full) - state_bytes(half)) / (full - half)
        L = max(1, min(full - 1,
                       half + int((TRAIN_PEAK - peak(half)) // per)))
        while L > 1 and peak(L) > TRAIN_PEAK:
            L -= 1
    why = ("not cut" if L == full else
           f"cut: a layer adds {per / 2**30:.3f} GiB, so {L + 1} layers "
           f"would peak at ~{(peak(L) + per) / 2**30:.3f} GiB")
    say(phase, f"(c) depth {L} of {full} layers ({why}); full width")
    return dry(L)


def model_train(cfg, phase: str, card: str, trace: bool = True) -> dict:
    """(c) bf16 at full width, remat "full", AdamW with bf16 states,
    ``TRAIN_BATCH`` x ``TRAIN_SEQ`` tokens (embeddings for a stub
    frontend), through ``launch.train``'s objects, at the depth
    ``train_depth`` gives: ``TRAIN_STEPS`` steps with each kernel's
    launches held per step (``step_launches``: K2-bwd on ``route_bwd``'s
    route), ms/step, tokens/s, model TFLOP/s, peak; one step traced
    (``trace``); the dry run held against a step as phase 10 (a) holds its
    cells; the loss and gradients taken twice from one state, bit-equal.
    Returns the steps' launches."""
    t0 = time.perf_counter()
    shape = ShapeSpec("train", "train", TRAIN_SEQ, TRAIN_BATCH)
    cut, rec = train_depth(cfg, phase, shape)
    L = cut.num_layers
    args = train_cli.parse_args([
        "--arch", cfg.name, "--batch", str(TRAIN_BATCH), "--seq",
        str(TRAIN_SEQ), "--steps", str(TRAIN_STEPS), "--device", DEV])
    t1 = time.perf_counter()
    job, reading = built(lambda: train_cli.build(args, cut),
                         lambda job: tree_flatten(job.state)[0])
    n_params = sum(p.numel() for p in job.model.parameters())
    say(phase, f"(c) {cut.name} bf16 at {L} layers, remat {cut.remat}, "
        f"AdamW (state {job.opt.state_dtype}): {n_params / 1e9:.4f} B "
        f"params (seed {args.seed}), batch {TRAIN_BATCH} x {TRAIN_SEQ} "
        f"{inputs_key(cut)} of SyntheticLM; built in "
        f"{time.perf_counter() - t1:.1f} s; {card}")
    reset_launches()
    state, data, losses, times, peak = take_steps(
        phase, "(c)", job, TRAIN_STEPS, step_launches(cut))
    launches = launch_counts()
    step_s = float(np.mean(times))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    dense, attn = model_flop(cut, n_params, TRAIN_BATCH, TRAIN_SEQ,
                             job.model.windows)
    flops = dense + attn
    say(phase, f"(c) steps 2-{TRAIN_STEPS}: {step_s * 1e3:.2f} ms/step "
        f"({', '.join(f'{t * 1e3:.2f}' for t in times)}), "
        f"{tokens / step_s:.1f} training tokens/s, model "
        f"{flops / step_s / 1e12:.2f} TFLOP/s (6*N*T {dense:.4e} + "
        f"attention {attn:.4e} = 6*B*H*(Dk+Dv)*band pairs over the layers; "
        f"SSD's intra-chunk products not counted; "
        f"{flops / step_s / PEAK['bfloat16'][0] * 100:.1f} % of the 989 "
        f"TFLOP/s bf16 peak); peak max_memory_allocated "
        f"{peak / 2**30:.3f} GiB; launches {launches}; {card}")
    if trace:
        profile_step(job, state, next(data), phase, "(c)")
    batch = next(data)
    dryrun_hold(f"{cut.name} at {L} layers, training step", cut, shape,
                lambda: job.step_fn(state, batch), reading, step_s,
                "step time", rec=rec)
    held = grads_held(job, next(data), plain=False)
    say(phase, f"(c) loss and {n_params / 1e9:.4f} B gradients taken twice "
        f"from one state on one batch: bit-equal={held['twice']} (loss "
        f"{held['loss']:.6f}); done in {time.perf_counter() - t0:.1f} s; "
        f"{card}")
    check(held["twice"], "(c) two runs of the step's loss and gradients "
          "differ")
    del job, state
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def sdpa_backends(q, k, v) -> str:
    """Which of sdpa's CUDA backends take ``q``, ``k``, ``v`` (B, S, H, D)
    with ``is_causal``: one call under each, its refusal's first line
    where it refuses."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    out = []
    for b in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
              SDPBackend.CUDNN_ATTENTION):
        try:
            with sdpa_kernel([b]):
                torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True,
                    enable_gqa=qt.shape[1] != kt.shape[1])
            torch.cuda.synchronize()
            out.append(f"{b.name} takes it")
        except RuntimeError as e:
            out.append(f"{b.name} refuses ({str(e).splitlines()[0][:80]})")
    return "; ".join(out)


def mla_phase(gen, card: str) -> dict:
    """Phase 12: (a) minicpm3-4B's float32 gate at 2 layers, (b) bf16
    serving at full width and depth, (c) bf16 training at full width, (d)
    K2 at (b)'s larger prefill and K2-bwd at (c)'s step, at Dk 96 / Dv 64,
    against their plain versions.  Returns each kernel's launches over
    (a)-(c)."""
    cfg = get_config(MLA_ARCH)
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    total = model_gate(cfg, "mla", card, MLA_GATE_LAYERS, GATE_TOKENS)
    served, (B, S) = model_serve(cfg, "mla", card)
    add_launches(total, served, model_train(cfg, "mla", card))
    H = cfg.num_heads
    Dk, Dv = attention_dims(cfg)
    bf16 = torch.bfloat16
    k2 = flash_row("mla-serve-path", gen, B, S, H, H, Dk, Dv, 0, bf16,
                   phase="mla")
    flash_row("mla-serve-cell", gen, *MLA_CELL, H, H, Dk, Dv, 0, bf16,
              phase="mla", sample=True)
    k2b = flash_bwd_row("mla-train-path", gen, TRAIN_BATCH, TRAIN_SEQ, H, H,
                        Dk, Dv, 0, bf16, twice=True, phase="mla", part="(d)")
    check(k2["route"] == "sm90" and k2b["route"] == "sm90",
          "(d) K2 or K2-bwd at Dk 96 / Dv 64 did not run on sm90")
    q, k, v = (torch.randn((B, S, H, d), generator=gen, device=DEV).to(bf16)
               for d in (Dk, Dk, Dv))
    say("mla", f"(d) sdpa at B{B} S{S} H{H} Dk {Dk} Dv {Dv} bf16, "
        f"is_causal: {sdpa_backends(q, k, v)}; {card}")
    del q, k, v
    torch.cuda.empty_cache()
    say("mla", f"main path launches {total}; done in "
        f"{time.perf_counter() - t0:.1f} s")
    return total


# ---------------------------------------------------------------------------
# Phase 13: the other six configurations served, gated and trained
# ---------------------------------------------------------------------------


def simt_bwd_ms(gen, B: int, S: int, H: int, KH: int, D: int) -> float:
    """Device time of K2-bwd's ``simt`` kernel (its bf16 entry) at a causal
    bf16 shape that ``route_bwd`` sends to ``sm90``: the entry called
    directly, on seeded q, k, v, dO and the plain forward's o and lse."""
    bf16 = torch.bfloat16
    q, k, v, do = (torch.randn(shape, generator=gen, device=DEV).to(bf16)
                   for shape in ((B, S, H, D), (B, S, KH, D), (B, S, KH, D),
                                 (B, S, H, D)))
    o, lse = flash_attention_ref(q, k, v, return_lse=True)
    return cuda_ms(lambda: k2b_launch("simt", q, k, v, o, do, lse, True, 0,
                                      None))


def zoo_phase(gen, card: str) -> dict:
    """Phase 13: each of ``ZOO`` in turn: (a) its float32 gate (2 layers
    and ``ZOO_GATE_TOKENS``; 1 layer above d_model ``ZOO_DEEP``, and
    ``MOE_GATE_TOKENS`` above ``ZOO_WIDE``), (b) bf16 serving (traced for
    ``ZOO_TRACED``), (c) bf16 training for ``ZOO_TRAINED``; then (d) the
    kernels at the shapes these
    paths gave them that no earlier phase ran: K2 (``sm90``) at
    stablelm-12b's prefill and K2-bwd (``sm90``'s two-warpgroup kernels)
    at its step, head dim 160, with ``simt``'s bf16 entry timed at that
    step beside it; K3 at mamba2-2.7B's prefill and K3-bwd at its step,
    state 128.  Returns each kernel's launches over (a)-(c)."""
    t0 = time.perf_counter()
    total = dict.fromkeys(launch_counts(), 0)
    shapes = {}
    for arch in ZOO:
        t1 = time.perf_counter()
        cfg = get_config(arch)
        gc.collect()
        torch.cuda.empty_cache()
        add_launches(total, model_gate(
            cfg, "zoo", card, 1 if cfg.d_model > ZOO_DEEP else 2,
            MOE_GATE_TOKENS if cfg.d_model > ZOO_WIDE else ZOO_GATE_TOKENS))
        served, shapes[arch] = model_serve(cfg, "zoo", card,
                                           trace=arch in ZOO_TRACED)
        add_launches(total, served)
        if arch in ZOO_TRAINED:
            add_launches(total, model_train(cfg, "zoo", card,
                                            trace=arch == "stablelm-12b"))
        say("zoo", f"{arch} done in {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    bf16 = torch.bfloat16
    lm = get_config("stablelm-12b")
    B, S = shapes[lm.name]
    H, KH, D = lm.num_heads, lm.num_kv_heads, lm.head_dim
    k2 = flash_row("stablelm-serve-path", gen, B, S, H, KH, D, D, 0, bf16,
                   phase="zoo")
    q, k, v = (torch.randn((B, S, h, D), generator=gen, device=DEV).to(bf16)
               for h in (H, KH, KH))
    say("zoo", f"(d) sdpa at B{B} S{S} H{H}/{KH} D {D} bf16, is_causal, "
        f"enable_gqa: {sdpa_backends(q, k, v)}; {card}")
    del q, k, v
    k2b = flash_bwd_row("stablelm-train-path", gen, TRAIN_BATCH, TRAIN_SEQ,
                        H, KH, D, D, 0, bf16, twice=True, phase="zoo",
                        part="(d)")
    check(k2["route"] == "sm90" and k2b["route"] == "sm90",
          f"(d) K2 / K2-bwd at head dim {D} ran {k2['route']} / "
          f"{k2b['route']}, not sm90 / sm90")
    simt_ms = simt_bwd_ms(gen, TRAIN_BATCH, TRAIN_SEQ, H, KH, D)
    say("zoo", f"(d) K2-bwd at the same shape through simt's bf16 entry "
        f"(f32 on the CUDA cores, called directly): {simt_ms:.4f} ms, "
        f"{simt_ms / k2b['kernel_ms']:.1f}x sm90's {k2b['kernel_ms']:.4f} "
        f"ms; {card}")
    torch.cuda.empty_cache()
    m2 = get_config("mamba2-2_7b")
    B, S = shapes[m2.name]
    Q = m2.ssm_chunk
    k3 = ssd_row("mamba2-serve-path", gen, B, -(-S // Q), Q, m2.ssm_heads,
                 m2.ssm_groups, m2.ssm_head_dim, m2.ssm_state, bf16,
                 phase="zoo")
    k3b = ssd_bwd_row("mamba2-train-path", gen, TRAIN_BATCH, TRAIN_SEQ // Q,
                      Q, m2.ssm_heads, m2.ssm_groups, m2.ssm_head_dim,
                      m2.ssm_state, torch.float32, twice=True, phase="zoo",
                      part="(d)")
    torch.cuda.empty_cache()
    say("zoo", f"(d) K2 {k2['kernel_ms']:.4f} ms, K2-bwd "
        f"{k2b['kernel_ms']:.4f} ms, K3 {k3['kernel_ms']:.4f} ms, K3-bwd "
        f"{k3b['kernel_ms']:.4f} ms; done in {time.perf_counter() - t1:.1f}"
        f" s")
    say("zoo", f"main path launches {total}; done in "
        f"{time.perf_counter() - t0:.1f} s")
    return total


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        sys.exit(2)
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False   # library yardstick: fp32
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. env ----------------------------------------------------------
    card = smi()
    print(card, flush=True)
    nvcc = subprocess.run(["bash", "-c", "nvcc --version 2>/dev/null || "
                           "/usr/local/cuda/bin/nvcc --version"],
                          capture_output=True, text=True).stdout
    cap = torch.cuda.get_device_capability(0)
    say("env", f"card: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, nvcc "
        f"{(nvcc.strip().splitlines() or ['?'])[-1]}; capability {cap} "
        f"(9, 0): {cap == (9, 0)}; python {sys.version.split()[0]}")

    # ---- 2. build: one nvcc per source, all started together --------------
    # i1's A and B are drawn on a thread meanwhile (numpy fills them without
    # the interpreter lock; the build waits on nvcc), joined before phase
    # 4's host profile, which they would disturb
    i1: dict = {}

    def draw_i1() -> None:
        t = time.perf_counter()
        rng = np.random.default_rng(0)
        i1["a"] = rng.standard_normal((M, K), dtype=np.float32)
        i1["b"] = rng.standard_normal((K, N), dtype=np.float32)
        i1["s"] = time.perf_counter() - t

    drawing = threading.Thread(target=draw_i1)
    drawing.start()
    t0 = time.perf_counter()
    builders = (build, build_k2, build_k2_sm90, build_k2_tf32x3, build_k3,
                build_k2_bwd, build_k2_bwd_sm90, build_k2_bwd_tf32x3,
                build_k3_bwd)
    with ThreadPoolExecutor(len(builders)) as pool:
        infos = list(pool.map(lambda f: f(), builders))
    for builder, info in zip(builders, infos):
        say("build", f"{info.path.relative_to(ROOT)} in {info.seconds:.1f} s")
        entry = ""
        for line in info.log.splitlines():   # ptxas -v, one kernel each
            if "Compiling entry" in line:
                entry = line
            if ("Compiling entry" in line or "Used" in line
                    or "spill" in line or "C7515" in line):
                say("build", line.strip())
            # K2's sm90 kernel hands registers from its producer to its
            # consumers (setmaxnreg 24 / 240), which balances only at the
            # 168 a thread that __launch_bounds__(384, 1) gives (its launch
            # refuses any other count)
            if (builder is build_k2_sm90 and "flash_sm90_kernel" in entry
                    and "Used" in line):
                check("Used 168 registers" in line, f"K2 sm90: ptxas "
                      f"gave {line.strip()}, not 168 registers")
            if builder is build_k2_bwd_sm90 and "spill" in line:
                check("0 bytes spill stores, 0 bytes spill loads" in line,
                      f"K2-bwd sm90: ptxas spills: {line.strip()}")
    say("build", f"all {len(builders)} in {time.perf_counter() - t0:.1f} s "
        f"wall")

    # ---- 3. kernel vs plain version (test shapes) ------------------------
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    rows_out = []
    for dtype_name, dtype, tol in (("float32", torch.float32, F32_TOL),
                                   ("bfloat16", torch.bfloat16, BF16_TOL)):
        for m, k, n in ((128, 128, 128), (100, 130, 50), (8, 128, 128),
                        (4096, 4096, 4096)):
            rows_out.append(compare(randn(m, k, dtype=dtype),
                                    randn(k, n, dtype=dtype),
                                    dtype_name, tol, "test"))
    # 64-bit offsets: A holds more than 2**31 elements (as A of i3-i6 does);
    # the float64 rows are the last ones, past the 32-bit range.
    big_a = randn(70_000, 32_000, dtype=torch.float32)
    rows_out.append(compare(big_a, randn(32_000, 64, dtype=torch.float32),
                            "float32", F32_TOL, "int64-offsets",
                            exact_rows=torch.arange(69_936, 70_000,
                                                    device=dev)))
    del big_a
    # The i1 depth: K = 30000 against float64 at the unscaled gate (the
    # kernel's 256-deep panels keep its sum within it; one running f32 sum,
    # the plain version's, does not).
    rows_out.append(compare(randn(1024, K, dtype=torch.float32),
                            randn(K, 1024, dtype=torch.float32), "float32",
                            F32_TOL, "i1-depth",
                            exact_rows=torch.randperm(
                                1024, generator=gen, device=dev)[:SAMPLE_ROWS]))
    acc_a = torch.full((8, 4096), 0.01, dtype=torch.bfloat16, device=dev)
    acc_b = torch.full((4096, 128), 0.01, dtype=torch.bfloat16, device=dev)
    rows_out.append(compare(acc_a, acc_b, "bfloat16", BF16_TOL,
                            "bf16-accumulation"))
    got = float(matmul(acc_a, acc_b)[0, 0])
    want = 4096 * 0.01 * 0.01
    say("kernel", f"bf16 k=4096 accumulation: {got:.5f} vs {want:.5f} "
        f"(rel {abs(got - want) / want:.2e} < 0.02)")
    check(abs(got - want) / want < 0.02, "bf16 inputs do not accumulate in f32")
    for r in rows_out:
        check(r["violations"] == 0, f"kernel disagrees with plain version: {r}")

    # K2 at the shapes of tests/test_kernels_flash.py, then windowed, GQA,
    # ragged S and head dims 96/64 (MLA) and 160 (stablelm).
    f32, bf16 = torch.float32, torch.bfloat16
    for dt in (f32, bf16):
        for B, S, H, KH, D in ((1, 128, 4, 4, 64), (2, 256, 8, 2, 64),
                               (1, 96, 4, 1, 128), (2, 128, 2, 2, 32)):
            flash_row("test", gen, B, S, H, KH, D, D, 0, dt)
    for window in (16, 64):
        flash_row("test-window", gen, 1, 128, 4, 2, 32, 32, window, f32)
    flash_row("test-noncausal", gen, 2, 64, 4, 4, 32, 32, 0, f32,
              causal=False)
    for dt in (f32, bf16):
        flash_row("gqa-window-ragged", gen, 2, 1037, 25, 5, 64, 64, 256, dt)
        flash_row("mla", gen, 2, 300, 8, 8, 96, 64, 0, dt)
        flash_row("head-dim-160", gen, 1, 333, 8, 2, 160, 160, 0, dt)
    # float32 at the widest head dim and a ragged one (tf32x3 zero-fills
    # the k8 step), as phase 7 (a) runs K2-bwd there
    flash_row("head-dim-256-window", gen, 1, 333, 4, 2, 256, 256, 128, f32)
    flash_row("head-dim-40", gen, 2, 257, 8, 2, 40, 40, 0, f32)
    for label, B, S, H, KH, Dk, Dv in F32_ZOO_ROWS:
        flash_row(label, gen, B, S, H, KH, Dk, Dv, 0, f32)
    # bf16 at head dims that are not multiples of 16 takes the CUDA-core
    # kernel's bf16 entry; no configuration has such dims.
    for label, B, S, H, KH, Dk, Dv, window in (
            ("bf16-simt-40", 2, 257, 8, 2, 40, 40, 0),
            ("bf16-simt-64-40", 1, 300, 8, 8, 64, 40, 0),
            ("bf16-simt-40-window", 1, 333, 4, 2, 40, 40, 64)):
        row = flash_row(label, gen, B, S, H, KH, Dk, Dv, window, bf16)
        check(row["route"] == "simt", f"K2 {label}: bf16 at Dk {Dk}, Dv {Dv} "
              f"ran {row['route']}, not the CUDA-core route")
    # K2 with q_offset on both routes (float32 -> tf32x3, bf16 -> sm90),
    # and on simt's two entries named, which route() reaches with any
    # offset for bf16 at head dims that are not multiples of 16: its offset
    # masks and its rows that keep no key are held here.
    for label, B, S, H, KH, Dk, Dv, window, causal, off, skv in \
            K2_OFFSET_ROWS:
        for dt in (f32, bf16):
            for kind in (None, "simt"):
                flash_row(label, gen, B, S, H, KH, Dk, Dv, window, dt,
                          causal=causal, q_offset=off, skv=skv, kind=kind)
    # K3 at the shapes of tests/test_kernels_ssd.py, a ragged Q, and the
    # chunk shapes of hymba-1.5B and mamba2-2.7b at ssm_chunk 256.
    for label, shape, dt in (
            ("test", (1, 2, 16, 4, 1, 16, 16), torch.float32),
            ("test-grouped", (2, 3, 32, 4, 2, 32, 16), torch.float32),
            ("test-mamba2-dims", (1, 1, 64, 8, 1, 64, 128), torch.float32),
            ("test-bf16", (1, 2, 32, 4, 1, 32, 32), torch.bfloat16),
            ("ragged-q", (2, 1, 37, 8, 2, 64, 16), torch.float32),
            ("hymba", (2, 4, 256, 50, 1, 64, 16), torch.float32),
            ("hymba", (2, 4, 256, 50, 1, 64, 16), torch.bfloat16),
            ("mamba2", (1, 4, 256, 80, 1, 64, 128), torch.float32)):
        ssd_row(label, gen, *shape, dt)

    # ---- 4. predict: fit the node ----------------------------------------
    t0 = time.perf_counter()
    drawing.join()
    cpu_prof = Profiler(host_cpu_runner(np.float32), repeats=3)
    cpu_prof.run(range(1000, 2001, 100))
    cpu_fit = cpu_prof.fit()
    if cpu_fit.a <= 1e-18:
        # fit_linear's floor: the host's times did not grow with the size
        # (a busy host: one run fitted b = 18 ms), and a device of free
        # compute would take the whole GEMM; profile the host once more
        say("predict", f"host fit degenerate (a={cpu_fit.a:.1e}, "
            f"b={cpu_fit.b:.4e} s) on the readings " + ", ".join(
                f"{r.size}^3 {r.seconds * 1e3:.3f} ms"
                for r in cpu_prof.records) + ": profiling the host again")
        cpu_prof = Profiler(host_cpu_runner(np.float32), repeats=3)
        cpu_prof.run(range(1000, 2001, 100))
        cpu_fit = cpu_prof.fit()
        check(cpu_fit.a > 1e-18, "the host's times did not grow with the "
              "size twice: " + ", ".join(f"{r.size}^3 {r.seconds * 1e3:.3f}"
                                         f" ms" for r in cpu_prof.records))
    gpu_prof =Profiler(cuda_kernel_runner(dev, torch.float32), repeats=3)
    gpu_prof.run(range(3000, 6001, 300))
    gpu_fit = gpu_prof.fit()

    def copy_rate(pinned: bool, to_card: bool) -> float:
        """Median of 3 timed 1 GiB copies, after one warm copy."""
        host = torch.ones(1 << 28, dtype=torch.float32, pin_memory=pinned)
        card_t = torch.ones(1 << 28, dtype=torch.float32, device=dev)
        src, dst = (host, card_t) if to_card else (card_t, host)
        times = []
        for _ in range(4):
            t = time.perf_counter()
            dst.copy_(src, non_blocking=True)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        return host.numel() * 4 / float(np.median(times[1:]))

    h2d = copy_rate(pinned=False, to_card=True)
    rates = {"pageable D2H": copy_rate(pinned=False, to_card=False),
             "pinned H2D": copy_rate(pinned=True, to_card=True),
             "pinned D2H": copy_rate(pinned=True, to_card=False)}
    say("predict", f"host-cpu torch.matmul fit: a={cpu_fit.a:.4e} s/MAC "
        f"b={cpu_fit.b:.4e} s ({1 / cpu_fit.a * 2 / 1e12:.3f} TFLOP/s), "
        f"sizes 1000..2000")
    say("predict", f"card kernel fit: a={gpu_fit.a:.4e} s/MAC "
        f"b={gpu_fit.b:.4e} s ({1 / gpu_fit.a * 2 / 1e12:.3f} TFLOP/s), "
        f"sizes 3000..6000")
    say("predict", f"1 GiB pageable H2D copy: {h2d / 1e9:.3f} GB/s (the "
        f"CopyModel); not modelled: " + ", ".join(
            f"{k} {v / 1e9:.3f} GB/s" for k, v in rates.items()))
    for r in gpu_prof.records:
        say("predict", f"  card {r.size}^3: {r.seconds * 1e3:.3f} ms "
            f"({2 * r.ops / r.seconds / 1e12:.2f} TFLOP/s)")
    # No row grain for the card: K1 masks its edge tiles, and adapt hands
    # the rows a grain rounds away to the other device (a 128-row grain
    # cost the host up to 0.35 s of extra work at i1).
    fitted = [DeviceProfile("host-cpu", "cpu", cpu_fit, NO_COPY),
              DeviceProfile("h100", "gpu", gpu_fit,
                            CopyModel(h2d, dtype_size=4))]
    say("predict", f"done in {time.perf_counter() - t0:.1f} s")

    # ---- 3b. kernel vs plain version at the main path's card shape -------
    hg = HGemms(fitted, device="cuda")
    plan = hg.plan(M, N, K)
    card_rows = max(asg.m for d, asg in zip(hg.devices,
                                            plan.adapted.assignments)
                    if d.kind != "cpu")
    # card_rows comes from the timed fit: drawn from ``gen``, it would move
    # every later phase's random inputs with the host's timing
    part_gen = torch.Generator(device=dev).manual_seed(1)
    a_dev = torch.randn((card_rows, K), generator=part_gen, device=dev)
    b_dev = torch.randn((K, N), generator=part_gen, device=dev)
    sample = torch.randperm(card_rows, generator=part_gen,
                            device=dev)[:SAMPLE_ROWS]
    main_row = compare(a_dev, b_dev, "float32", F32_TOL,
                       "main-path partition", exact_rows=sample)
    del a_dev, b_dev
    torch.cuda.empty_cache()
    check(main_row["violations"] == 0,
          f"kernel disagrees with plain version at the main path's shape: "
          f"{main_row}")

    # ---- 5. main path: co-execution at i1 --------------------------------
    a, b = i1["a"], i1["b"]
    say("main", f"A, B of i1 ({M}x{K}x{N} float32) made in {i1['s']:.1f} s "
        f"during the build")
    for d, asg in zip(hg.devices, plan.adapted.assignments):
        say("main", f"plan: {d.name:9s} rows {asg.row0}..{asg.row0 + asg.m} "
            f"share {asg.ops / (float(M) * N * K) * 100:.3f}%")

    b64 = b.astype(np.float64)
    rows = np.sort(np.random.default_rng(1).choice(M, SAMPLE_ROWS,
                                                   replace=False))

    def run(hgemms, p, label):
        c, rep = hgemms.execute(a, b, plan=p)
        say("main", f"{label}: predicted makespan "
            f"{rep.predicted_makespan:.4f} s; measured makespan "
            f"{rep.measured.makespan:.4f} s; wall {rep.wall_seconds:.4f} s")
        for e in sorted(rep.measured.events, key=lambda e: e.start):
            say("main", f"  measured {e.device:9s} {e.kind:8s} chunk "
                f"{e.chunk} {e.start:.4f} -> {e.end:.4f} s")
        bus_invariants(rep.measured, p.schedule.timeline)
        check_rows(c, a, b64, rows, label)
        return rep

    for e in sorted(plan.schedule.timeline.events, key=lambda e: e.start):
        say("main", f"  planned  {e.device:9s} {e.kind:8s} chunk {e.chunk} "
            f"{e.start:.4f} -> {e.end:.4f} s")
    matmul.launches = 0
    rep = run(hg, plan, "co-execution")
    launches = matmul.launches
    say("main", f"co-execution: kernel launches {launches}; bus invariants "
        f"hold on the measured timeline")
    check(launches > 0, "the main path launched no kernel")

    # The card alone, the paper's baseline (not a gate), in turns with a
    # second co-executed run: co, alone, alone, co.
    hg1 = HGemms(fitted[1:], device="cuda")
    plan1 = hg1.plan(M, N, K)
    alone = [run(hg1, plan1, "card alone") for _ in range(2)]
    co = [rep, run(hg, plan, "co-execution (repeat)")]
    say("main", "co-execution speedup over the card alone: measured "
        + ", ".join(f"{x.measured.makespan / y.measured.makespan:.4f}x"
                    for x, y in zip(alone, co))
        + f"; predicted "
        f"{plan1.schedule.timeline.makespan / plan.schedule.timeline.makespan:.4f}x")
    say("main", f"total {time.perf_counter() - t_start:.1f} s")
    del a, b, b64
    torch.cuda.empty_cache()

    # ---- 6. serve: hymba-1.5B at full width -------------------------------
    k2_rows, k3_row, serve_launches = serve(gen)
    say("serve", f"total {time.perf_counter() - t_start:.1f} s")

    # ---- 7. train: hymba-1.5B -------------------------------------------
    k2b_rows, k3b_row, train_launches = train(gen)
    say("train", f"total {time.perf_counter() - t_start:.1f} s")

    # ---- 8. moe: dbrx-132B at full width, depth cut ------------------------
    _, moe_launches = moe_phase(gen, fitted, card)
    say("moe", f"total {time.perf_counter() - t_start:.1f} s")
    for name, n in moe_launches.items():     # K2's launches on both paths
        serve_launches[name] += n

    # ---- 9. shard: dbrx-132B's expert-parallel MoE under a mesh -----------
    # Phase 10 (b)'s host-only dry runs and the first dry run of phases 12
    # and 13's depth searches run behind phase 9, which claims no time:
    # behind phase 12 they doubled minicpm3-4b's host-bound decode steps
    # (191.69 -> 379.57 ms, NVIDIA H100 80GB HBM3, 700.00 W)
    dry = dryrun_start()
    ahead = depth_prefetch([get_config(a) for a in (MLA_ARCH,) + ZOO_TRAINED])
    for name, n in shard_phase(card).items():
        launches_of = (train_launches if "bwd" in name else serve_launches)
        launches_of[name] = launches_of.get(name, 0) + n
    say("shard", f"total {time.perf_counter() - t_start:.1f} s")

    # ---- 10. dryrun: the dry run and its accounting against the card ------
    dryrun_finish(dry, card)
    depth_collect(ahead)
    say("dryrun", f"total {time.perf_counter() - t_start:.1f} s")

    # ---- 11. moe-train: MoE training, remat "dots", llama4 served ---------
    for name, n in moe_train_phase(gen, card).items():
        launches_of = (train_launches if "bwd" in name else serve_launches)
        launches_of[name] = launches_of.get(name, 0) + n
    say("moe-train", f"total {time.perf_counter() - t_start:.1f} s")

    # ---- 12. mla: minicpm3-4B (MLA) served and trained at full width -----
    for name, n in mla_phase(gen, card).items():
        launches_of = (train_launches if "bwd" in name else serve_launches)
        launches_of[name] = launches_of.get(name, 0) + n
    say("mla", f"total {time.perf_counter() - t_start:.1f} s")

    # ---- 13. zoo: the other six configurations at full width ------------
    for name, n in zoo_phase(gen, card).items():
        launches_of = (train_launches if "bwd" in name else serve_launches)
        launches_of[name] = launches_of.get(name, 0) + n
    say("zoo", f"total {time.perf_counter() - t_start:.1f} s")

    kernels = [{"name": "matmul", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/matmul.cu",
                "replaces": "src/repro/kernels/matmul.py:35",
                "launches": launches,
                "max_abs_err": main_row["max_abs_err"],
                "ms": main_row["kernel_ms"],
                "plain_ms": main_row["plain_ms"],
                "bound_ms": main_row["bound_ms"],
                "bound_by": main_row["bound_by"],
                "library_ms": main_row["library_ms"]}]
    for name, row, source, replaces in (
            ("flash_attention/sm90", k2_rows["sm90"],
             "src/repro_torch/kernels/csrc/flash_attention_sm90.cu",
             "src/repro/kernels/flash_attention.py:70"),
            ("flash_attention/tf32x3", k2_rows["tf32x3"],
             "src/repro_torch/kernels/csrc/flash_attention_tf32x3.cu",
             "src/repro/kernels/flash_attention.py:70"),
            ("flash_attention/simt", k2_rows["simt"],
             "src/repro_torch/kernels/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention.py:70"),
            ("ssd_chunk", k3_row, "src/repro_torch/kernels/csrc/ssd_chunk.cu",
             "src/repro/kernels/ssd_chunk.py:56")):
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces,
                        "launches": serve_launches.get(name, 0),
                        "max_abs_err": row["max_abs_err"],
                        "ms": row["kernel_ms"], "plain_ms": row["plain_ms"],
                        "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"],
                        "library_ms": row["library_ms"]})
    for name, row, source, replaces in (
            ("flash_attention_bwd/sm90", k2b_rows["sm90"],
             "src/repro_torch/kernels/csrc/flash_attention_bwd_sm90.cu",
             "src/repro/models/layers.py:90"),
            ("flash_attention_bwd/tf32x3", k2b_rows["tf32x3"],
             "src/repro_torch/kernels/csrc/flash_attention_bwd_tf32x3.cu",
             "src/repro/models/layers.py:90"),
            ("flash_attention_bwd/simt", k2b_rows["simt"],
             "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
             "src/repro/models/layers.py:90"),
            ("ssd_chunk_bwd", k3b_row,
             "src/repro_torch/kernels/csrc/ssd_chunk_bwd.cu",
             "src/repro/models/ssm.py:67")):
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces,
                        "launches": train_launches.get(name, 0),
                        "max_abs_err": row["max_abs_err"],
                        "ms": row["kernel_ms"], "plain_ms": row["plain_ms"],
                        "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"],
                        "library_ms": row["library_ms"]})
    # simt runs bf16 at head dims that are not multiples of 16, which no
    # configuration has: its rows (float32 entry, at the tf32x3 rows'
    # shapes) count no main-path launch; every other kernel must have one.
    idle = [k["name"] for k in kernels if k["launches"] == 0]
    check(idle == ["flash_attention/simt", "flash_attention_bwd/simt"],
          f"kernels the main path never launched: {idle}")
    print(smi(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
