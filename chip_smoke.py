#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

Run from the root of a checkout, on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each printed as it ends; any failure raises and exits non-zero:

1. the card: ``nvidia-smi`` name and power limit; TF32 off;
2. the build of every CUDA kernel from ``src/repro_torch/kernels/csrc``,
   and the flash and paged kernels' registers, spills, shared memory and
   any note of ptxas that it serialised their wgmma (C7510-C7515);
3. each kernel against its plain PyTorch version on the card, at the
   serving path's shapes (flash: every prefill bucket, 64-2048), with the
   tolerance stated, timed beside the plain version, the bound and
   (flash) ``scaled_dot_product_attention`` (both with the card's queue
   filled ahead, and flash also back to back), flash and the SSD scan also
   in TFLOP/s and as a share of their bound (fp32 products bounded by the
   faster of fp32 FMAs and 3xTF32 on the tensor cores, the route named);
   the SSD scan also against an fp64 recurrence on the card beside its
   plain version, and each of
   its three kernels' time and grid inside whole scans (``torch.profiler``);
   the paged kernel with the queue filled ahead and back to back, with
   its grid, its working blocks and the time of one contiguous read of
   as many bytes, at the decode shapes of llama2-7b, opt-13b, qwen3-14b
   (GQA 5), qwen2-0.5b (GQA 7, head_dim 64), granite-moe-1b (GQA 2,
   head_dim 64), granite-moe-3b (GQA 3, head_dim 64, bf16 and fp32) and
   stablelm-3b (head_dim 80, bf16 and fp32); flash also at the 1024-token
   prefills of the two granite models and at head_dim 80 in every bucket
   (stablelm-3b's prefills and zamba2-2.7b's shared block, 32/32); the
   widened shapes: bf16 flash at head_dim 16, 32 and 96, the fp32 flash
   kernel at llama2-7b's and qwen3-14b's 1024-token prefills (SDPA on
   the same fp32 tensors beside it), paged at head_dim 16 and 32, group
   6, multi-query 16/1 and 32/1, and in fp32 at llama2-7b's decode; in
   fp16 (the bf16 kernels' templates) paged at llama2-7b's decode and
   at head_dim 16 (32/8) and 80 (32/32), flash at llama2-7b's and
   qwen3-14b's 1024-token prefills and at head_dim 16 and 80; at head_dim
   256 (the kernels' wide shapes) paged at llama2-7b's decode
   lengths with 16/16 heads (bf16, fp16, fp32) and 16/8, flash at a
   causal 1024-token prefill with 16/16 and 16/8 heads in each dtype,
   16/8 with a softcap of 50 in bf16 and fp16 and llama2-7b's served
   32/32 in bf16 and fp32 (the shape of the ``flash_attention_d256`` and
   ``flash_attention_fp32_d256`` lines), and both at head_dim
   144 and 192 (32/8), flash there in bf16 and fp32;
   head_dims 272 and 136 must raise ``ValueError`` on the card; the
   SSD scan also at zamba2-2.7b's prefill (80 heads, N 64) and at the
   training CLI's mamba2-130m shape (B 4, S 1024); then every case of
   the reference's tests/test_kernels.py flash, softcap, paged and
   permutation tests at its shape, dtype, causal flag and softcap
   (inputs drawn with numpy), with group 6, 16/1 and 32/1 paged at D
   128, fp32 flash at S 1024 (32/32, 40/8), bf16 flash at D 96, the
   reference's bf16 flash and paged cases once more in fp16, and
   FLASH_CASES[4] and PAGED_CASES[2] and [3] at head_dim 256 (flash also
   at 16/8 with a softcap of 50, fp32 and bf16), each
   launched through the kernel (counted) and held to its plain version
   on the card within the reference test's elementwise tolerance (2e-5
   fp32, 2.5e-2 bf16 flash, 3e-2 bf16 paged; fp16 held to bf16's) and
   the row limit, the two permuted outputs within 1e-5;
4. serving: llama2-7b at full width and depth (random weights from
   ``init_params(seed=0)``) behind ``ServingEngine``, 16 requests of
   64-1024 prompt tokens and 32 output tokens, on the kernel path; the
   main path is the engine as a user builds it, which on the card runs
   its steps as CUDA graphs (the paged and flash kernels inside them);
   the kernels' launch counts over that run (flash also by query
   length; a replay adds what its graph launched at capture); then the
   same requests served eagerly (``graphs=False``) and graphed, in
   turns, three request sets each: greedy tokens, iteration records,
   launch counts and the page store must be identical, and the
   sampled logits of one more set are compared; mean prefill and decode
   walls (apart from the steps that captured a graph), tokens/s, the
   spread of the walls between sets, the graphs and their capture time,
   and the runtime launches left outside the graphs per step (a
   ``torch.profiler`` window per step); first-token logits of the kernel
   path against the plain path; one decode step of a full batch on
   prefilled pages, kernel path against plain path; a profile of a
   decode step (with the paged kernel's share of its device time) and
   of a 1024-token prefill, eager and graphed; the same requests on the
   plain path.  llama2-7b once more with its config's dtype set to
   float32 (27 GB of weights): 8 of the requests, 16 output tokens each,
   on the graphed engine through the fp32 flash kernel (one launch a
   layer a prefill) and the paged kernel in fp32 (one a layer a decode
   step), its first-token and decode-step logits against the plain
   routes within 1e-4 (largest error and L2, over the plain route's),
   the graphed decode-step and 1024-token prefill profiles and the peak
   memory; then the same in fp16 (13.5 GB of weights; the dtype of
   llama2-7b's published checkpoint) through both kernels' fp16
   instances, its logits within ``LOGIT_LIMITS[torch.float16]`` of the
   plain routes; then the same in bf16 with ``head_dim`` set to 256 (32
   heads of 256, q width 8192, 17.8 GB of weights) through both kernels'
   head_dim-256 shapes, and in fp32 at that head_dim (35.5 GB of weights,
   a pool of 640 pages, sized to its requests) through the fp32 flash kernel's
   wide shape and the paged kernel's D-256 shape in fp32, its logits
   within 1e-4 of the plain routes.  opt-13b (learned positions, LayerNorm, GELU; MHA 40/40)
   and qwen3-14b (qk-norm, GQA 40/8) at full width and depth run the
   main path (one graphed engine on the kernel routes), the two logit
   comparisons and the profiles; so do granite-moe-3b (MoE, 40 experts
   top 8, GQA 24/8, head_dim 64), granite-moe-1b (32 experts top 8, GQA
   16/8; and one more request set on the ``sort`` MoE route: greedy
   tokens against ``dense_onehot``'s, walls) and stablelm-3b (32 heads
   of 80, LayerNorm; both kernels at head_dim 80).  For the MoE
   models the logit comparisons record each route's expert sets per
   layer (a hook on ``models.moe._router``), report the share of
   (token, layer) pairs whose set differs, and hold the limits on the
   rows whose own token's set agrees in every layer; and the profiles
   add the MoE's share of a graphed decode step and prefill (a graph of
   every layer's MoE, timed apart).  Every main path launches the paged
   kernel once a layer a decode iteration and flash once a layer a
   prefill.  Each model frees its weights and pages before the next
   one loads.  On llama2-7b's weights, drawn once for its phases and
   these, the serve-then-simulate example
   (``repro_torch.examples.serve_smoke``): its ``main`` as a user runs
   it (the smoke config on the card; its four lines), then through its
   functions (``serve``, ``simulate``, ``throughput_error``) (a) the
   smoke config as written (default routes, graphed: no kernel
   launches), (b) the smoke config on the kernel routes, (c) llama2-7b
   at full width and depth on the kernel routes, the example's request
   set cold and two more, drawn with seeds 1 and 2, warm on the same
   engine.  The kernel routes must launch paged once a layer a decode
   iteration and flash once a layer a request's prefill.  Each set
   prints the finished requests and iterations of engine and
   simulator, real and simulated req/s, the error, the graphs captured
   and their seconds, the capturing iterations' walls and share of the
   engine clock, and the predictions the tabular fit clamps; (c) also
   the held-out error (fitted to set 1's records, simulating seed 2's
   workload, against set 2's throughput);
5. serving: mamba2-130m at full width and depth (random weights from
   ``init_params(seed=0)``) through ``launch/serve.py``'s engine on the
   slot path (graphed on the card), 16 requests of 20-990 prompt tokens
   (buckets on both SSD branches) and 32 output tokens; the SSD kernel's
   launches over that run, which must be 24 per prefill whose bucket is
   a multiple of the chunk (256); eager against graphed as for llama2-7b
   (the slot cache must be identical); every layer's ``mamba2_apply``
   through the kernel against ``impl="recurrent"`` on the hidden states
   the prefill feeds it, and first-token logits of the two routes; a
   profile of a decode step at batch 8 and of a 1024-token prefill (with
   the SSD scan's share of the prefill's device time), eager and
   graphed;
6. serving: whisper-base at full width and depth (6 encoder and 6
   decoder layers, d 512, 8 heads of 64, 1500 frames; random weights
   from ``init_params(seed=0)``) through ``launch/serve.py``'s engine
   with ``attn_impl="pallas"`` on the slot path (graphed on the card),
   16 requests of 8-448 prompt tokens (buckets 8-512) and 32 output
   tokens: flash must launch 18 times a prefill (the encoder's
   non-causal 1500 x 1500 self-attention, the decoder's causal
   self-attention and its non-causal bucket x 1500 cross-attention, a
   layer each); the device's idle share over one more request set under
   ``torch.profiler``; eager against graphed as for llama2-7b (the slot
   cache's ``k``, ``v``, ``xk``, ``xv`` must be identical); first-token
   and decode-step logits of the kernel route against ``naive``; flash
   at whisper's shapes (non-causal 1500 x 1500, 8 x 1500 and 512 x
   1500, causal 512, D 64) against its plain version, with its bound and
   SDPA's time; a profile of a decode step at batch 8 and of a 448-token
   prefill (with flash's share of its device time), eager and graphed;
7. the repaired ``blocked`` attention route at full width on the card,
   right after stablelm-3b's paged-path phases and on the same weights
   (32 layers, 32 heads of 80, bf16, ``init_params(seed=0)``): one
   4096-token prompt through ``model_zoo.forward`` with the default
   ``RunSettings()`` (``auto`` resolves to ``blocked``, 4 x 4 blocks of
   1024), against ``attn_impl="naive"``: the last position's logits
   within LOGIT_REL_MAX of the naive route's largest logit, the greedy
   tokens, both walls and the peak memory;
8. serving: zamba2-2.7b at full width and depth (54 Mamba2 layers of 80
   SSD heads, d 2560, and after every 6 the shared block, 32 heads of
   80; random weights from ``init_params(seed=0)``) through
   ``launch/serve.py``'s engine sizes with ``attn_impl="pallas"`` on the
   slot path (graphed on the card), mamba2-130m's 16 requests: flash
   must launch 9 times a prefill and the SSD scan 54 times a prefill
   whose bucket is a multiple of 256; eager against graphed as for
   llama2-7b (the slot cache's ``conv``, ``ssd``, ``k``, ``v`` identical);
   first-token and decode-step logits of the kernel route against
   ``naive``; a profile of a decode step at batch 8 and of a 1024-token
   prefill (flash's and the SSD scans' shares), eager and graphed;
9. training, with autograd on: llama2-7b at full width cut to 8 of its
   32 layers (fp32 master weights, gradients and AdamW state of the
   whole model take 108 GB) through ``Trainer``, B 8, S 512,
   ``remat="full"``, 10 steps: step walls, tokens/s, MFU (6 N tokens /
   wall / the bf16 peak), the optimizer's share of a step's device time
   (CUDA events), peak memory and the loss at each step, which must be
   finite and end below where it began, then a profile of one step
   (GEMMs' share, top kernels); mamba2-130m whole through the training
   CLI's trainer (``--steps 10 --seq-len 1024 --batch 4``): the SSD scan
   must launch 24 times in each step's forward and 24 more in remat's
   recompute, then a profile of one step (the SSD kernels' share); the
   SSD wrapper's gradients (kernel forward, the
   plain version recomputed for the backward) against the plain
   version's at mamba2-130m's and zamba2-2.7b's prefill shapes; the
   100M example (12 layers, d 768) for 20 steps, saving every 10, then a
   new ``Trainer`` on its directory, which must restore step 20 bit for
   bit and take the next 5 steps as the first run took them, and 3
   steps with int8 gradient compression; flash, paged and
   ``attend(impl="pallas")`` must refuse a call autograd would record;
10. the sharding plan (``distributed.shard_plan`` on DTensor), each phase
   on a 1 x 1 mesh (``launch.mesh.make_host_mesh``) of a one-rank NCCL
   group, the trees placed with ``shard_plan.distribute`` and run under
   ``use_rules(mesh, default_rules())``, against the same run without
   the plan (a one-card mesh shows op coverage, the kernel boundaries
   and DTensor's host cost; multi-rank values are checked by the CPU
   tests): llama2-7b at full width and depth with
   ``attn_impl="pallas"``, a B 8, S 1024 prefill (twice, the second
   timed) and 32 decode steps on the unsharded run's tokens, flash
   counted (once a layer a prefill), logits and walls beside the
   unsharded ones; llama2-7b cut to 8 layers through ``Trainer`` with
   ``shardings``, 3 steps at B 8, S 512, its losses held to the training
   phase's first three, step walls and peak memory beside that phase's;
   mamba2-130m whole, a B 8, S 1024 prefill through the SSD scan (counted,
   once a layer), logits and states against the unsharded prefill's;
   the dry run's counters (``launch.dryrun``) on llama2-7b's sharded
   decode step at full width, first on meta tensors of the same local
   shapes and placements, then on the real step with the weights loaded:
   equal FLOP counts, argument bytes equal to the placed tensors' bytes,
   the temp estimate beside ``max_memory_allocated`` less the arguments;
11. the simulator (``repro_torch.launch.simulate``, llama2-7b on A100,
   1000 requests at 8 QPS) twice, each in its own process: the two
   summaries must be equal apart from the host's wall time; a third
   process imports the port's simulator, sweep and CLI and must load
   nothing of jax or of the reference package; then the five
   simulator-only examples (quickstart, multi_tenant,
   disaggregated_serving, speculative, observability), each ``main()``
   in this process: its wall and its lines, as many as the reference's;
12. the script's total seconds, the ``kernels`` JSON line (each
   kernel's launches summed over the main paths that run it, the
   sharded phases' and the serve-then-simulate example's kernel routes
   among them, with ``launches_by_path``; its times at
   the llama2-7b case; the fp32 flash kernel a line of its own, its
   launches those of the fp32 llama2-7b run; the fp16 run's launches
   under the paged and flash lines' ``llama2-7b-float16`` path; the
   head_dim-256 run's on lines of their own, ``paged_attention_d256`` and
   ``flash_attention_d256``, timed at head_dim 256, paged with 16/16
   heads and flash with the served 32/32, the fp32 head_dim-256 run's
   paged launches under ``paged_attention_d256`` and its flash launches
   on ``flash_attention_fp32_d256``, timed at the served 32/32),
   then the result line.

Without a CUDA device, or without the rest of the checkout, it fails
before printing a result.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import gc
import importlib
import io
import json
import os
import re
import shutil
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.core.costmodel.backends import TabularBackend  # noqa: E402
from repro_torch.core.metrics import Results  # noqa: E402
from repro_torch.core.request import Request  # noqa: E402
from repro_torch.core.workload import generate  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import counts as launch_counts  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.paged_attention import ops as paged_ops  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.configs.base import MOE  # noqa: E402
from repro_torch.distributed import shard_plan  # noqa: E402
from repro_torch.distributed.api import placements, use_rules  # noqa: E402
from repro_torch.examples import serve_smoke as ex_serve  # noqa: E402
from repro_torch.examples import train_100m as ex100m  # noqa: E402
from repro_torch.models import attention_impl  # noqa: E402
from repro_torch.models import model_zoo as zoo  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models.common import (RunSettings, tree_leaves,  # noqa: E402
                                       tree_map)
from repro_torch.models.layers import norm_apply  # noqa: E402
from repro_torch.serving import paged_model  # noqa: E402
from repro_torch.serving.engine import EngineConfig, ServingEngine  # noqa: E402
from repro_torch.serving.graphs import StepGraphs  # noqa: E402
from repro_torch.training import trainer as train_step_mod  # noqa: E402
from repro_torch.training.data import DataConfig  # noqa: E402
from repro_torch.training.optimizer import AdamWConfig  # noqa: E402
from repro_torch.training.trainer import TrainConfig, Trainer  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet, dense): bf16 and fp16 on
# the tensor cores, fp32 as FMAs on the CUDA cores, and TF32 on the tensor
# cores
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS_S = {torch.bfloat16: 989e12, torch.float16: 989e12,
                torch.float32: 67e12}
PEAK_TF32_S = 495e12
#: TF32 products an fp32-grade product takes on the tensor cores
#: (3xTF32: each operand split into hi + lo, hi·hi + hi·lo + lo·hi)
TF32_SPLIT_PRODUCTS = 3
#: kernel vs its plain version run in fp32 on the same (bf16-valued)
#: inputs, per output row (one q head of one token): the row's largest
#: error over its largest |value|, the worst row of a case.  A sound bf16
#: kernel rounds its output (at most 2^-8 of a value) and its softmax
#: weights; a kernel that drops one attended position, or reads one too
#: many, is caught on rows thousands of positions long.  The limit lies
#: between the two readings (PERF.md, PR 11; the planted faults are in
#: tests/test_torch_kernels_cuda.py).  fp16 rounds as finely or more
#: finely (10 mantissa bits to bf16's 7) and is held to the same limit.
REL_TOL = {torch.bfloat16: 1e-2, torch.float16: 1e-2, torch.float32: 1e-4}
#: logits, kernel path vs plain path (first tokens of the served
#: requests, and one decode step of a full batch), per row, relative
#: to the plain path's largest |logit| (max) and norm (L2).  bf16 through
#: 32 layers: the two attention routes round at different points (the
#: flash kernel rounds unnormalised probabilities to bf16, the naive route
#: normalised ones) and each layer's difference passes through the layers
#: above it.  A wrong kernel gives errors of the logits' own size.
LOGIT_REL_MAX = 0.1
LOGIT_REL_L2 = 0.1
#: (max, L2) logit limits by the model's compute dtype: in fp32 both
#: attention routes compute in fp32 and differ in summation order only,
#: so the kernels' fp32 row limit holds the logits; fp16 rounds where
#: bf16 does with 3 more mantissa bits, so its differences are about 8x
#: smaller than bf16's (llama2-7b's first-token logits at full width
#: read 0.0252 in bf16; PERF.md §6) and its limit a quarter of bf16's
LOGIT_LIMITS = {torch.bfloat16: (LOGIT_REL_MAX, LOGIT_REL_L2),
                torch.float16: (LOGIT_REL_MAX / 4, LOGIT_REL_L2 / 4),
                torch.float32: (1e-4, 1e-4)}

#: mamba2-130m, kernel route vs ``impl="recurrent"`` on the card, per
#: layer: the norm of the difference over the recurrent route's norm, of
#: the block output and of the final state.  Both routes compute the SSD
#: in fp32 and differ in summation order; the chunked form also takes
#: exp(seg_i - seg_j) of cumulative sums that grow large on heads that
#: decay fast, and the block output rounds to bf16 (gated norm,
#: out_proj).  Those differences are local, so the largest error of a
#: row (printed too) is far larger than the norm; a kernel fault moves
#: every row.  The limits lie between the sound readings and those of a
#: planted kernel fault (PERF.md;
#: tests/test_torch_kernels_cuda.py::test_ssd_limits_catch_a_planted_
#: fault).
SSM_BLOCK_REL = 1e-4
SSM_STATE_REL = 1e-4
#: first-token logits of the all-kernel chain against the all-recurrent
#: chain through 24 bf16 layers, largest error over the largest |logit|:
#: each layer's rounding differences pass through every layer above, so
#: sound and planted readings lie close together, and the per-layer
#: limits above are the ones that tell a fault.  This limit lies between
#: the two readings.
SSM_LOGIT_REL = 1.8e-2

#: two runs of the SSD plain version on the same inputs agree when they
#: differ by a summation order's rounding at most: the kernel, which sums
#: every product in another order, reads within 1.6e-6 of a row of it
#: (PERF.md)
PLAIN_SPREAD_REL = 1e-5

#: about 10 ms of the card's clock: longer than the host takes to enqueue
#: 20 calls of a kernel's wrapper
QUEUE_AHEAD_CYCLES = 20_000_000
#: the kernels of one SSD scan (kernels/csrc/ssd_scan.cu)
SSD_KERNELS = ("chunk_state_kernel", "state_passing_kernel",
               "chunk_scan_kernel")
#: the paged kernel (kernels/csrc/paged_attention.cu; the merge of the
#: splits is inside it)
PAGED_KERNELS = ("paged_attn_kernel",)
#: the flash kernels, bf16 and fp16 (one template) and fp32
#: (kernels/csrc/flash_attention.cu); the names match their wide twins of
#: head_dims 144 to 256 too (flash_kernel_wide, flash_fp32_kernel_wide)
FLASH_KERNELS = ("flash_kernel", "flash_fp32_kernel")

PAGE = 16
NUM_BLOCKS = 1024
MAX_PAGES = 128
MAX_BATCH = 8
N_REQUESTS = 16
OUTPUT_LEN = 32
PROMPT_RANGE = (64, 1024)
FLASH_BUCKETS = (64, 128, 256, 512, 1024, 2048)
SEED = 0


#: the script's start on the host's clock; every phase line carries its
#: end as ``t_s``, seconds after it
T0 = time.perf_counter()


def phase(name, **fields):
    print(json.dumps({"phase": name, **fields,
                      "t_s": time.perf_counter() - T0}), flush=True)


def time_ms(fn, reps, queue_ahead=False):
    """Mean device time of ``fn`` over ``reps`` calls, after a warm-up.
    With ``queue_ahead`` the card first spins (``QUEUE_AHEAD_CYCLES``)
    while the host enqueues every call, so the reading is the device's
    time even where a call costs the host more time than the card."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queue_ahead:
        torch.cuda._sleep(QUEUE_AHEAD_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def row_rel_err(got, want):
    """Per output row (the last axis): largest |error| over largest
    |value| of ``want``."""
    err = (got.float() - want.float()).abs().amax(-1)
    return err / want.float().abs().amax(-1).clamp_min(1e-30)


def ops_route(flops, dtype):
    """The least time of ``flops`` products in ``dtype`` on the card, in
    seconds, and the route that takes it.  fp32: the faster of fp32 FMAs
    (67 TFLOP/s) and 3xTF32 on the tensor cores (495 / 3 = 165 TFLOP/s),
    since a kernel may take either and keep fp32's accuracy (the fp32
    flash kernel takes 3xTF32)."""
    if dtype == torch.float32:
        return min((flops / PEAK_FLOPS_S[dtype], "fp32 FMAs"),
                   (TF32_SPLIT_PRODUCTS * flops / PEAK_TF32_S,
                    "3xTF32 tensor cores"))
    return flops / PEAK_FLOPS_S[dtype], f"{dtype} tensor cores"


def bound(nbytes, flops, dtype):
    """(bound ms, "bytes" or "operations", the operations' route)."""
    t_bytes = nbytes / PEAK_BYTES_S
    t_ops, route = ops_route(flops, dtype)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", route)


def esize(dtype):
    return torch.empty((), dtype=dtype).element_size()


# ---------------------------------------------------------------------------
# Kernels against their plain versions
# ---------------------------------------------------------------------------
def paged_case(name, *, batch, hq, hkv, dtype, d=128, seed=0):
    """Decode attention over a serving-sized page store: permuted block
    tables, contexts of 64-1056 tokens, the last row a padded row of
    length 1 on the trash page."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    rng = np.random.RandomState(seed)
    n_pages = NUM_BLOCKS + 1
    trash = NUM_BLOCKS
    dev = "cuda"
    q = torch.randn(batch, hq, d, generator=g, device=dev).to(dtype)
    kp = torch.randn(n_pages, PAGE, hkv, d, generator=g, device=dev).to(dtype)
    vp = torch.randn(n_pages, PAGE, hkv, d, generator=g, device=dev).to(dtype)
    lens = rng.randint(PROMPT_RANGE[0], PROMPT_RANGE[1] + OUTPUT_LEN + 1,
                       size=batch).astype(np.int32)
    tables = np.full((batch, MAX_PAGES), trash, np.int32)
    perm = rng.permutation(NUM_BLOCKS)
    used = 0
    for b in range(batch):
        n = -(-int(lens[b]) // PAGE)
        tables[b, :n] = perm[used:used + n]
        used += n
    lens[-1] = 1
    tables[-1] = trash
    t = torch.from_numpy(tables).to(dev)
    ln = torch.from_numpy(lens).to(dev)

    out = paged_ops.paged_attention(q, kp, vp, t, ln)
    torch.cuda.synchronize()
    want = paged_ops.paged_attention_ref(q.float(), kp.float(), vp.float(),
                                         t, ln)
    err = float((out.float() - want).abs().max())
    rel = float(row_rel_err(out, want).max())
    finite = bool(torch.isfinite(out).all())
    ok = finite and rel <= REL_TOL[dtype]

    touched = sum(-(-int(x) // PAGE) * PAGE for x in lens)
    nbytes = (2 * touched * hkv * d + 2 * batch * hq * d) * esize(dtype) \
        + tables.nbytes + lens.nbytes
    flops = 4 * int(lens.sum()) * hq * d
    bound_ms, bound_by, bound_route = bound(nbytes, flops, dtype)
    grid, split = paged_ops.grid(q, kp, t)
    # blocks whose split starts below the length (at least one a row and
    # chunk of q heads)
    active = grid[1] * sum(max(1, -(-min(int(x), MAX_PAGES * PAGE) // split))
                           for x in lens)

    def call():
        paged_ops.paged_attention(q, kp, vp, t, ln)

    # the card's time (the wrapper's host time hidden behind a queue
    # filled ahead), and the time a call takes back to back
    kernel_ms = time_ms(call, 50, queue_ahead=True)
    # yardstick of the rate the card reaches reading this many bytes in
    # one contiguous sweep (a sum of that many bf16 values)
    sweep = torch.randn(nbytes // 2, generator=g, device=dev).to(
        torch.bfloat16)
    read_ms = time_ms(lambda: sweep.sum(), 50, queue_ahead=True)
    del sweep
    rec = {"case": name, "dtype": str(dtype), "batch": batch, "hq": hq,
           "hkv": hkv, "head_dim": d, "page": PAGE,
           "lens": [int(x) for x in lens], "max_abs_err": err,
           "max_rel_err": rel, "tol_rel": REL_TOL[dtype], "finite": finite,
           "kernel_ms": kernel_ms, "call_ms": time_ms(call, 50),
           "kernel": kernel_profile(call, 20, PAGED_KERNELS, "paged"),
           "grid": grid, "active_blocks": active, "split_len": split,
           "plain_ms": time_ms(
               lambda: paged_ops.paged_attention_ref(q, kp, vp, t, ln), 10),
           "bound_ms": bound_ms, "bound_by": bound_by,
           "bound_route": bound_route, "library_ms": None,
           "bound_share": bound_ms / kernel_ms, "bytes": nbytes,
           "read_ms": read_ms}
    phase("paged_attention", **rec)
    if not ok:
        raise AssertionError(f"paged_attention {name}: row error {rel} "
                             f"(tol {REL_TOL[dtype]}), finite={finite}")
    return rec


def flash_grid(dtype, d, batch, sq, h):
    """The grid of a flash launch, as the library computes it for the
    launch: (heads, batch, q tiles), or for bf16 and fp16 above head_dim
    128 (pairs of 64-row q units, heads, batch)."""
    lib = build.load("flash_attention")
    grid = (ctypes.c_int * 3)()
    if lib.flash_attention_grid(flash_ops.DTYPES[dtype], d, batch, sq, h,
                                grid) != 0:
        raise AssertionError(f"no flash grid for {dtype} at head_dim {d}")
    return list(grid)


def flash_case(name, *, sq, skv, h, hkv, causal, dtype, d=128, softcap=0.0,
               seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    q = torch.randn(1, sq, h, d, generator=g, device=dev).to(dtype)
    k = torch.randn(1, skv, hkv, d, generator=g, device=dev).to(dtype)
    v = torch.randn(1, skv, hkv, d, generator=g, device=dev).to(dtype)
    kw = dict(causal=causal, softcap=softcap)

    out = flash_ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    want = flash_ops.flash_attention_ref(q.float(), k.float(), v.float(),
                                         **kw)
    err = float((out.float() - want).abs().max())
    rel = float(row_rel_err(out, want).max())
    finite = bool(torch.isfinite(out).all())
    ok = finite and rel <= REL_TOL[dtype]

    pairs = sum(min(i + 1, skv) for i in range(sq)) if causal else sq * skv
    flops = 4 * h * d * pairs
    nbytes = (2 * sq * h * d + 2 * skv * hkv * d) * esize(dtype)
    bound_ms, bound_by, bound_route = bound(nbytes, flops, dtype)

    def call():
        flash_ops.flash_attention(q, k, v, **kw)

    # the card's time (the wrapper's host time hidden behind a queue
    # filled ahead), and the time a call takes back to back
    kernel_ms = time_ms(call, 20, queue_ahead=True)
    call_ms = time_ms(call, 20)

    library_ms = None
    if not softcap:
        # yardstick only: one PyTorch call for the same function (GQA kv
        # expanded outside the timed region); the port never calls it
        rep = h // hkv
        qt = q.transpose(1, 2).contiguous()
        kt = k.repeat_interleave(rep, dim=2).transpose(1, 2).contiguous()
        vt = v.repeat_interleave(rep, dim=2).transpose(1, 2).contiguous()
        sdpa = torch.nn.functional.scaled_dot_product_attention
        library_ms = time_ms(lambda: sdpa(qt, kt, vt, is_causal=causal), 20,
                             queue_ahead=True)
    rec = {"case": name, "dtype": str(dtype), "sq": sq, "skv": skv, "h": h,
           "hkv": hkv, "head_dim": d, "causal": causal, "softcap": softcap,
           "grid": flash_grid(dtype, d, 1, sq, h),
           "max_abs_err": err, "max_rel_err": rel,
           "tol_rel": REL_TOL[dtype], "finite": finite,
           "kernel_ms": kernel_ms, "call_ms": call_ms,
           "plain_ms": time_ms(
               lambda: flash_ops.flash_attention_ref(q, k, v, **kw), 5),
           "bound_ms": bound_ms, "bound_by": bound_by,
           "bound_route": bound_route, "library_ms": library_ms,
           # the least flops (attended pairs only) over the kernel's time
           "tflops_s": flops / kernel_ms / 1e9,
           "bound_share": bound_ms / kernel_ms}
    phase("flash_attention", **rec)
    if not ok:
        raise AssertionError(f"flash_attention {name}: row error {rel} "
                             f"(tol {REL_TOL[dtype]}), finite={finite}")
    return rec


def check_kernels():
    bf16, f32 = torch.bfloat16, torch.float32
    paged = [
        paged_case("llama2-7b decode", batch=MAX_BATCH, hq=32, hkv=32,
                   dtype=bf16),
        paged_case("gqa 32/8", batch=MAX_BATCH, hq=32, hkv=8, dtype=bf16,
                   seed=1),
        paged_case("fp32 gqa 8/4 d64", batch=4, hq=8, hkv=4, d=64, dtype=f32,
                   seed=2),
        paged_case("opt-13b decode", batch=MAX_BATCH, hq=40, hkv=40,
                   dtype=bf16, seed=3),
        # GQA 5 (qwen3-14b, 40/8) and GQA 7 (qwen2-0.5b, 14/2, d 64)
        paged_case("qwen3-14b decode", batch=MAX_BATCH, hq=40, hkv=8,
                   dtype=bf16, seed=4),
        paged_case("fp32 qwen3-14b decode", batch=MAX_BATCH, hq=40, hkv=8,
                   dtype=f32, seed=5),
        paged_case("qwen2-0.5b decode", batch=MAX_BATCH, hq=14, hkv=2, d=64,
                   dtype=bf16, seed=6),
        paged_case("fp32 qwen2-0.5b decode", batch=MAX_BATCH, hq=14, hkv=2,
                   d=64, dtype=f32, seed=7),
        # GQA 2 (granite-moe-1b, 16/8) and GQA 3 (granite-moe-3b, 24/8),
        # d 64
        paged_case("granite-moe-1b decode", batch=MAX_BATCH, hq=16, hkv=8,
                   d=64, dtype=bf16, seed=8),
        paged_case("granite-moe-3b decode", batch=MAX_BATCH, hq=24, hkv=8,
                   d=64, dtype=bf16, seed=9),
        paged_case("fp32 granite-moe-3b decode", batch=MAX_BATCH, hq=24,
                   hkv=8, d=64, dtype=f32, seed=10),
        # head_dim 80 (stablelm-3b, 32/32): 16 lanes a row, 6 of them dead
        paged_case("stablelm-3b decode", batch=MAX_BATCH, hq=32, hkv=32,
                   d=80, dtype=bf16, seed=11),
        paged_case("fp32 stablelm-3b decode", batch=MAX_BATCH, hq=32,
                   hkv=32, d=80, dtype=f32, seed=12),
    ]
    # every prefill bucket of the serving path (64 ... max_ctx 2048)
    flash = {s: flash_case(f"causal S={s}", sq=s, skv=s, h=32, hkv=32,
                           causal=True, dtype=bf16)
             for s in FLASH_BUCKETS}
    flash_case("non-causal ragged kv", sq=200, skv=333, h=32, hkv=8,
               causal=False, dtype=bf16, seed=1)
    flash_case("softcap 30", sq=512, skv=512, h=32, hkv=32, causal=True,
               dtype=bf16, softcap=30.0, seed=2)
    flash_case("causal ragged d64", sq=300, skv=300, h=8, hkv=4, d=64,
               causal=True, dtype=bf16, seed=3)
    flash_case("causal ragged d128", sq=1000, skv=1000, h=32, hkv=8,
               causal=True, dtype=bf16, seed=4)
    flash_case("top-left Sq<Skv d64", sq=130, skv=300, h=8, hkv=8, d=64,
               causal=True, dtype=bf16, seed=5)
    # the prefills of opt-13b (40/40) and qwen3-14b (40/8)
    flash_case("opt-13b causal S=1024", sq=1024, skv=1024, h=40, hkv=40,
               causal=True, dtype=bf16, seed=6)
    flash_case("qwen3-14b causal S=1024", sq=1024, skv=1024, h=40, hkv=8,
               causal=True, dtype=bf16, seed=7)
    # the prefills of granite-moe-1b (16/8) and granite-moe-3b (24/8), d 64
    flash_case("granite-moe-1b causal S=1024", sq=1024, skv=1024, h=16,
               hkv=8, d=64, causal=True, dtype=bf16, seed=8)
    flash_case("granite-moe-3b causal S=1024", sq=1024, skv=1024, h=24,
               hkv=8, d=64, causal=True, dtype=bf16, seed=9)
    # head_dim 80 in the D-128 tiles, every prefill bucket: stablelm-3b's
    # prefills and zamba2-2.7b's shared block (both 32/32)
    for s in FLASH_BUCKETS:
        flash_case(f"head_dim 80 causal S={s} (stablelm-3b, zamba2-2.7b)",
                   sq=s, skv=s, h=32, hkv=32, d=80, causal=True, dtype=bf16,
                   seed=20 + s)
    # the widened shapes: bf16 flash at head_dim 16 and 32 (D-64 tiles)
    # and 96 (D-128 tiles); the fp32 flash kernel at llama2-7b's and
    # qwen3-14b's 1024-token prefills; paged at head_dim 16 and 32, group
    # 6, multi-query 16/1 and 32/1 (chunks of 8 q heads), and in fp32 at
    # llama2-7b's decode (the fp32 serving phase's)
    for d in (16, 32, 96):
        flash_case(f"head_dim {d} causal S=1024 32/8", sq=1024, skv=1024,
                   h=32, hkv=8, d=d, causal=True, dtype=bf16, seed=40 + d)
    flash32 = flash_case("fp32 llama2-7b causal S=1024", sq=1024, skv=1024,
                         h=32, hkv=32, causal=True, dtype=f32, seed=10)
    flash_case("fp32 qwen3-14b causal S=1024", sq=1024, skv=1024, h=40,
               hkv=8, causal=True, dtype=f32, seed=11)
    for d in (16, 32):
        paged_case(f"head_dim {d} decode 32/8", batch=MAX_BATCH, hq=32, hkv=8,
                   d=d, dtype=bf16, seed=20 + d)
    for hq, hkv in ((48, 8), (16, 1), (32, 1)):
        paged_case(f"group {hq // hkv} decode {hq}/{hkv}", batch=MAX_BATCH,
                   hq=hq, hkv=hkv, dtype=bf16, seed=30 + hq + hkv)
    paged_case("fp32 llama2-7b decode", batch=MAX_BATCH, hq=32, hkv=32,
               dtype=f32, seed=13)
    # fp16 (the bf16 kernels' templates): llama2-7b's decode and prefill
    # (the fp16 serving phase's), qwen3-14b's 40/8 prefill, and head_dim
    # 16 and 80 in both kernels
    f16 = torch.float16
    # at the bf16 case's seed: the same lengths, a like-for-like time
    paged_case("fp16 llama2-7b decode", batch=MAX_BATCH, hq=32, hkv=32,
               dtype=f16)
    paged_case("fp16 head_dim 16 decode 32/8", batch=MAX_BATCH, hq=32, hkv=8,
               d=16, dtype=f16, seed=15)
    paged_case("fp16 head_dim 80 decode 32/32", batch=MAX_BATCH, hq=32,
               hkv=32, d=80, dtype=f16, seed=16)
    flash_case("fp16 llama2-7b causal S=1024", sq=1024, skv=1024, h=32,
               hkv=32, causal=True, dtype=f16, seed=12)
    flash_case("fp16 qwen3-14b causal S=1024", sq=1024, skv=1024, h=40,
               hkv=8, causal=True, dtype=f16, seed=13)
    flash_case("fp16 head_dim 16 causal S=1024 32/8", sq=1024, skv=1024,
               h=32, hkv=8, d=16, causal=True, dtype=f16, seed=14)
    flash_case("fp16 head_dim 80 causal S=1024 32/32", sq=1024, skv=1024,
               h=32, hkv=32, d=80, causal=True, dtype=f16, seed=15)
    wide = check_wide_kernels()
    # the rows of the kernels line: the serving path's shapes
    return paged[0], flash[PROMPT_RANGE[1]], flash32, wide


#: head_dims above 128: the served llama2-7b at head_dim 256 has
#: 32/32 heads; 16/16 reads as many bytes a position as llama2-7b's 32/32
#: at 128, and 16/8 is Gemma-2-9B's GQA
WIDE_HEAD_DIM = 256


def check_wide_kernels():
    """Both kernels at head_dim 256 (and once each at 144 and 192): paged
    at llama2-7b's decode lengths (seed 0) with 16/16 and 16/8 heads,
    flash at a causal 1024-token prefill with 16/16 and 16/8 heads, each
    in bf16, fp16 and fp32 (paged's 16/8 in bf16), and 16/8 with
    Gemma-2-9B's softcap of 50 in bf16 and fp16, and flash at the served
    32/32 in bf16 and fp32, and at head_dims 144 and 192 (32/8) in bf16
    and fp32;
    then the head_dims the kernels refuse, 272 (past 256) and 136 (not a
    multiple of 16), raising ValueError on CUDA tensors.  Returns the
    bf16 16/16 paged record and the bf16 and fp32 32/32 flash records."""
    bf16, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    d = WIDE_HEAD_DIM
    out = {}
    for dt, tag in ((bf16, ""), (f16, "fp16 "), (f32, "fp32 ")):
        out["paged", dt] = paged_case(
            f"{tag}head_dim {d} decode 16/16", batch=MAX_BATCH, hq=16, hkv=16,
            d=d, dtype=dt)
        for hkv in (16, 8):
            out["flash", dt, hkv] = flash_case(
                f"{tag}head_dim {d} causal S=1024 16/{hkv}", sq=1024,
                skv=1024, h=16, hkv=hkv, d=d, causal=True, dtype=dt,
                seed=60 + hkv)
    paged_case(f"head_dim {d} decode 16/8", batch=MAX_BATCH, hq=16, hkv=8,
               d=d, dtype=bf16)
    # the served prefill of llama2-7b at head_dim 256 (32/32), the flash
    # lines' shape
    for dt, tag in ((bf16, ""), (f32, "fp32 ")):
        out["flash", dt, 32] = flash_case(
            f"{tag}head_dim {d} causal S=1024 32/32", sq=1024, skv=1024,
            h=32, hkv=32, d=d, causal=True, dtype=dt, seed=62)
    for dt, tag in ((bf16, ""), (f16, "fp16 ")):
        flash_case(f"{tag}head_dim {d} causal S=1024 16/8 softcap 50",
                   sq=1024, skv=1024, h=16, hkv=8, d=d, causal=True,
                   dtype=dt, softcap=50.0, seed=61)
    for dd in (144, 192):
        paged_case(f"head_dim {dd} decode 32/8", batch=MAX_BATCH, hq=32,
                   hkv=8, d=dd, dtype=bf16, seed=dd)
        for dt, tag in ((bf16, ""), (f32, "fp32 ")):
            flash_case(f"{tag}head_dim {dd} causal S=1024 32/8", sq=1024,
                       skv=1024, h=32, hkv=8, d=dd, causal=True, dtype=dt,
                       seed=dd)
    refused = {}
    for dd in (272, 136):
        q = torch.zeros(2, 16, dd, device="cuda", dtype=bf16)
        kp = torch.zeros(9, PAGE, 16, dd, device="cuda", dtype=bf16)
        bt = torch.zeros(2, 4, dtype=torch.int32, device="cuda")
        ln = torch.ones(2, dtype=torch.int32, device="cuda")
        x = torch.zeros(1, 64, 16, dd, device="cuda", dtype=bf16)
        for name, call in (
                ("paged_attention",
                 lambda: paged_ops.paged_attention(q, kp, kp, bt, ln)),
                ("flash_attention",
                 lambda: flash_ops.flash_attention(x, x, x))):
            before = launch_counts.get(name)
            try:
                call()
                refused[f"{name} {dd}"] = False
            except ValueError:
                refused[f"{name} {dd}"] = launch_counts.get(name) == before
    phase("wide_head_dim_refusals", refused=refused)
    if not all(refused.values()):
        raise AssertionError(f"a head_dim the kernels do not take went "
                             f"through: {refused}")
    return out["paged", bf16], out["flash", bf16, 32], out["flash", f32, 32]


#: tests/test_kernels.py's own kernel cases at their shapes, dtypes,
#: causal flags and softcap (that file needs JAX, which this machine has
#: not: the inputs are drawn with numpy from a seed instead), then the
#: widened shapes of the serving models.  Flash: (name, b, sq, skv, h,
#: hkv, d, causal, softcap, dtype)
REF_FLASH_CASES = [
    ("FLASH_CASES[0]", 2, 128, 128, 4, 2, 64, True, 0.0, torch.float32),
    ("FLASH_CASES[1]", 1, 256, 256, 4, 4, 64, True, 0.0, torch.bfloat16),
    ("FLASH_CASES[2]", 2, 64, 192, 4, 1, 32, False, 0.0, torch.float32),
    ("FLASH_CASES[3]", 1, 100, 100, 2, 2, 16, True, 0.0, torch.float32),
    ("FLASH_CASES[4]", 1, 128, 128, 8, 8, 128, True, 0.0, torch.float32),
    ("test_flash_softcap", 1, 64, 64, 2, 2, 32, True, 20.0, torch.float32),
    ("fp32 llama2-7b causal S=1024", 1, 1024, 1024, 32, 32, 128, True, 0.0,
     torch.float32),
    ("fp32 qwen3-14b causal S=1024", 1, 1024, 1024, 40, 8, 128, True, 0.0,
     torch.float32),
    ("bf16 head_dim 96 causal S=1024", 1, 1024, 1024, 32, 32, 96, True, 0.0,
     torch.bfloat16),
    # the reference's bf16 case once more in fp16 (its wrapper takes any
    # dtype; its tests run no fp16 case)
    ("FLASH_CASES[1] in fp16", 1, 256, 256, 4, 4, 64, True, 0.0,
     torch.float16),
    # FLASH_CASES[4]'s shape at head_dim 256 in fp32 (the D-split kernel),
    # and Gemma-2-9B's 16/8 heads of 256 with its softcap of 50
    ("FLASH_CASES[4] at head_dim 256", 1, 128, 128, 8, 8, 256, True, 0.0,
     torch.float32),
    ("16/8 head_dim 256 softcap 50", 1, 128, 128, 16, 8, 256, True, 50.0,
     torch.float32),
    ("16/8 head_dim 256 softcap 50 in bf16", 1, 128, 128, 16, 8, 256, True,
     50.0, torch.bfloat16),
]
#: paged: (name, b, hq, hkv, d, npages, page, mp, dtype)
REF_PAGED_CASES = [
    ("PAGED_CASES[0]", 2, 4, 2, 64, 16, 16, 4, torch.float32),
    ("PAGED_CASES[1]", 3, 8, 1, 32, 32, 8, 6, torch.float32),
    ("PAGED_CASES[2]", 2, 4, 4, 64, 16, 16, 3, torch.bfloat16),
    ("PAGED_CASES[3]", 1, 16, 2, 128, 8, 32, 2, torch.float32),
    ("group 6 48/8 d128", MAX_BATCH, 48, 8, 128, NUM_BLOCKS + 1, PAGE,
     MAX_PAGES, torch.bfloat16),
    ("multi-query 16/1 d128", MAX_BATCH, 16, 1, 128, NUM_BLOCKS + 1, PAGE,
     MAX_PAGES, torch.bfloat16),
    ("multi-query 32/1 d128", MAX_BATCH, 32, 1, 128, NUM_BLOCKS + 1, PAGE,
     MAX_PAGES, torch.bfloat16),
    ("PAGED_CASES[2] in fp16", 2, 4, 4, 64, 16, 16, 3, torch.float16),
    ("PAGED_CASES[3] at head_dim 256", 1, 16, 2, 256, 8, 32, 2,
     torch.float32),
    ("PAGED_CASES[2] at head_dim 256", 2, 4, 4, 256, 16, 16, 3,
     torch.bfloat16),
]
#: tests/test_kernels.py's elementwise tolerances (rtol = atol) by kernel
#: and dtype; it has none for fp16, which is held to bf16's
REF_TOL = {("flash_attention", torch.float32): 2e-5,
           ("flash_attention", torch.bfloat16): 2.5e-2,
           ("flash_attention", torch.float16): 2.5e-2,
           ("paged_attention", torch.float32): 2e-5,
           ("paged_attention", torch.bfloat16): 3e-2,
           ("paged_attention", torch.float16): 3e-2}
#: the permutation test's limit between its two outputs
PERMUTATION_TOL = 1e-5


def held_to_reference(kernel, case, got, want, dtype):
    """The kernel's output ``got`` against the plain version's ``want``
    (fp32, same inputs): the reference test's elementwise tolerance and
    the row limit; prints the case's phase, raises past either."""
    tol = REF_TOL[kernel, dtype]
    err = (got.float() - want).abs()
    # the largest |err| over what assert_allclose allows there: <= 1
    ratio = float((err / (tol + tol * want.abs())).max())
    rel = float(row_rel_err(got, want).max())
    finite = bool(torch.isfinite(got).all())
    rec = {"kernel": kernel, "case": case, "dtype": str(dtype),
           "shape": list(got.shape), "max_abs_err": float(err.max()),
           "tol_elementwise": tol, "max_err_over_tol": ratio,
           "max_rel_err": rel, "tol_rel": REL_TOL[dtype], "finite": finite}
    phase("kernel_reference_case", **rec)
    if not (finite and ratio <= 1 and rel <= REL_TOL[dtype]):
        raise AssertionError(f"{kernel} {case}: elementwise {ratio} of its "
                             f"tolerance, row error {rel}, finite={finite}")
    return rec


def launched(kernel, fn, times=1):
    """``fn()``, which must launch ``kernel`` ``times`` times (not its
    plain version)."""
    before = launch_counts.get(kernel)
    out = fn()
    torch.cuda.synchronize()
    n = launch_counts.get(kernel) - before
    if n != times:
        raise AssertionError(f"{kernel} launched {n} times, expected "
                             f"{times}")
    return out


def flash_reference_case(name, b, sq, skv, h, hkv, d, causal, softcap,
                         dtype):
    """One flash case with numpy inputs, through the kernel (its launch
    counted) against the plain version: ``held_to_reference``."""
    rng = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rng.randn(b, s, n, d).astype(np.float32))
               .to("cuda", dtype)
               for s, n in ((sq, h), (skv, hkv), (skv, hkv)))
    kw = dict(causal=causal, softcap=softcap)
    got = launched("flash_attention",
                   lambda: flash_ops.flash_attention(q, k, v, **kw))
    want = flash_ops.flash_attention_ref(q.float(), k.float(), v.float(),
                                         **kw)
    return held_to_reference("flash_attention", name, got, want, dtype)


def paged_reference_case(name, b, hq, hkv, d, npages, page, mp, dtype):
    """One paged case as the reference draws it (tables with replacement,
    lengths 1 to ``mp * page``), numpy inputs, through the kernel against
    the plain version: ``held_to_reference``."""
    rng = np.random.RandomState(2)
    q, kp, vp = (torch.from_numpy(rng.randn(*shape).astype(np.float32))
                 .to("cuda", dtype) for shape in
                 ((b, hq, d), (npages, page, hkv, d), (npages, page, hkv, d)))
    bt = torch.from_numpy(rng.randint(0, npages, size=(b, mp))
                          .astype(np.int32)).cuda()
    cl = torch.from_numpy(rng.randint(1, mp * page + 1, size=(b,))
                          .astype(np.int32)).cuda()
    got = launched("paged_attention",
                   lambda: paged_ops.paged_attention(q, kp, vp, bt, cl))
    want = paged_ops.paged_attention_ref(q.float(), kp.float(), vp.float(),
                                         bt, cl)
    return held_to_reference("paged_attention", name, got, want, dtype)


def check_reference_cases():
    """Every case of tests/test_kernels.py's flash and paged tests, its
    softcap test and its permutation test, and the widened serving
    shapes, through the kernels (each launch counted) against their
    plain versions on the card."""
    recs = [flash_reference_case(*case) for case in REF_FLASH_CASES]
    recs += [paged_reference_case(*case) for case in REF_PAGED_CASES]
    # test_paged_attention_respects_block_table_permutation: head_dim 16,
    # 2/1, the same K/V through two page orders
    b, hq, hkv, d, npages, page, mp = 1, 2, 1, 16, 8, 4, 4
    rng = np.random.RandomState(3)
    q, kseq, vseq = (torch.from_numpy(rng.randn(*shape).astype(np.float32))
                     .cuda() for shape in
                     ((b, hq, d), (mp * page, hkv, d), (mp * page, hkv, d)))
    cl = torch.tensor([mp * page], dtype=torch.int32, device="cuda")
    outs = []
    for perm in ([0, 1, 2, 3], [3, 1, 0, 2]):
        kp, vp = (torch.zeros(npages, page, hkv, d, device="cuda")
                  for _ in range(2))
        for logical, phys in enumerate(perm):
            kp[phys] = kseq[logical * page:(logical + 1) * page]
            vp[phys] = vseq[logical * page:(logical + 1) * page]
        bt = torch.tensor([perm], dtype=torch.int32, device="cuda")
        outs.append(launched("paged_attention",
                             lambda: paged_ops.paged_attention(q, kp, vp, bt,
                                                               cl)))
        recs.append(held_to_reference(
            "paged_attention", f"permutation {perm}", outs[-1],
            paged_ops.paged_attention_ref(q, kp, vp, bt, cl), torch.float32))
    diff = (outs[0] - outs[1]).abs()
    ratio = float((diff / (PERMUTATION_TOL
                           + PERMUTATION_TOL * outs[1].abs())).max())
    phase("kernel_reference_cases", cases=len(recs),
          permutation_max_abs_diff=float(diff.max()),
          permutation_tol=PERMUTATION_TOL,
          permutation_max_diff_over_tol=ratio,
          worst_err_over_tol=max(r["max_err_over_tol"] for r in recs),
          worst_rel_err={str(dt): max((r["max_rel_err"] for r in recs
                                       if r["dtype"] == str(dt)), default=None)
                         for dt in (torch.bfloat16, torch.float16,
                                    torch.float32)})
    if ratio > 1:
        raise AssertionError(f"the permuted tables differ: {ratio} of the "
                             f"tolerance")


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------
#: request sets each engine serves in the eager-against-graphed phases
#: (the graphed engine's first set is the main path's run); then one set
#: whose sampled logits are compared, and one whose steps are profiled
GRAPH_SETS = 3
#: request ids of set k are k * SET_IDS + the id in set 0
SET_IDS = 1000
#: steps of each kind profiled for their launches outside the graphs
LAUNCH_STEPS = 3
#: runtime calls that enqueue work one by one (kernels, copies, fills)
RUNTIME_LAUNCHES = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cudaMemset")


def make_requests(offset=0, n=N_REQUESTS, output_len=OUTPUT_LEN):
    """The first ``n`` of the ``N_REQUESTS`` requests (prompts of 64-1024
    tokens), each generating ``output_len`` tokens."""
    rng = np.random.RandomState(SEED)
    lens = rng.randint(PROMPT_RANGE[0], PROMPT_RANGE[1] + 1, size=N_REQUESTS)
    return [Request(id=offset + i, arrival_time=1e-3 * i, prompt_len=int(p),
                    output_len=output_len) for i, p in enumerate(lens[:n])]


def paged_engine(model, params, attn_path, graphs=None,
                 num_blocks=NUM_BLOCKS):
    ec = EngineConfig(num_blocks=num_blocks, block_size=PAGE,
                      max_batch=MAX_BATCH, max_pages_per_seq=MAX_PAGES,
                      attn_path=attn_path)
    return ServingEngine(model, params, ec, graphs=graphs)


def launches_now():
    counts = launch_counts.snapshot()
    out = {name: counts.get(name, 0)
           for name in ("paged_attention", "flash_attention", "ssd_scan")}
    out["flash_attention_by_sq"] = {
        str(k[1]): n for k, n in sorted(
            (k, n) for k, n in counts.items() if isinstance(k, tuple))}
    return out


def free_memory():
    """Return the memory of the engines just deleted to the card: an
    engine that ``instrument`` or a test wrapper has touched sits in a
    reference cycle until the collector runs."""
    gc.collect()
    torch.cuda.empty_cache()


def _logged(eng, run, log):
    """``run`` (``eng``'s step), logging into ``log`` as ``instrument``
    says."""
    def step(key, fn):
        n = len(eng.graphs) if eng.graphs is not None else 0
        out = run(key, fn)
        log["keys"].append(key)
        if eng.graphs is not None and len(eng.graphs) > n:
            log["captured"].add(len(eng.records))
        return out

    return step


def instrument(eng):
    """Log the key of every step ``eng`` runs (``("prefill", bucket)`` or
    ``("decode",)``), and the index of each iteration record whose step
    captured a graph."""
    log = {"keys": [], "captured": set()}
    eng._step = _logged(eng, eng._step, log)
    return log


class StepLog:
    """``instrument`` for the engines built inside the ``with`` block (the
    example builds its engine inside ``serve``): a hook on
    ``ServingEngine._step``; yields the log."""

    def __enter__(self):
        log = {"keys": [], "captured": set()}
        self._step = run = ServingEngine._step
        ServingEngine._step = lambda eng, key, fn: _logged(
            eng, functools.partial(run, eng), log)(key, fn)
        return log

    def __exit__(self, *exc):
        ServingEngine._step = self._step


def set_stats(eng, reqs, log, start, n_keys, run_s):
    """What the request set ``reqs`` shows, served on ``eng`` in
    ``run_s`` seconds with its iteration records from ``start`` and its
    step keys in ``log`` from ``n_keys`` on: counts, walls, the walls of
    the iterations that captured a graph and their share of the set's
    clock.  Raises unless every request finished."""
    if any(r.tokens_generated != r.output_len for r in reqs):
        raise AssertionError("not every request finished")
    recs = eng.records[start:]
    captured = {i - start for i in log["captured"] if i >= start}

    def mean_ms(kind, warm=None):
        w = [r.wall for i, r in enumerate(recs) if r.kind == kind
             and (warm is None or (i not in captured) == warm)]
        return 1e3 * float(np.mean(w)) if w else None

    walls = sum(r.wall for r in recs)
    capture_walls = [recs[i].wall for i in sorted(captured)]
    new_keys = set(log["keys"][n_keys:]) - set(log["keys"][:n_keys])
    generated = sum(r.tokens_generated for r in reqs)
    prompt = sum(r.prompt_len for r in reqs)
    return {"graphed": eng.graphs is not None,
            "iterations": len(recs),
            "prefill_iterations": sum(r.kind == "prefill" for r in recs),
            "decode_iterations": sum(r.kind == "decode" for r in recs),
            "mean_prefill_wall_ms": mean_ms("prefill"),
            "mean_decode_wall_ms": mean_ms("decode"),
            "capture_iterations": len(captured),
            "graphs_captured": len(new_keys) if eng.graphs is not None
            else 0,
            "capture_walls_s": capture_walls,
            "capture_share": sum(capture_walls) / walls,
            "mean_prefill_wall_ms_without_capture": mean_ms("prefill", True),
            "mean_decode_wall_ms_without_capture": mean_ms("decode", True),
            "generated_tokens": generated, "prompt_tokens": prompt,
            "generated_tokens_per_s": generated / walls,
            "all_tokens_per_s": (generated + prompt) / walls,
            "run_s": run_s,
            "preemptions": sum(r.preempt_count for r in reqs)}


def serve_set(eng, reqs, prompts, log, serve_fn=None):
    """Serve ``reqs`` on ``eng`` with launch counts from zero; returns
    what the eager-against-graphed comparison reads: greedy tokens and
    iteration records (ids as in set 0), launches, walls, prefill
    buckets."""
    offset = min(r.id for r in reqs) // SET_IDS * SET_IDS
    start, n_keys = len(eng.records), len(log["keys"])
    launch_counts.reset()
    t0 = time.perf_counter()
    if serve_fn is None:
        for r in reqs:
            eng.add_request(r, prompts.get(r.id - offset))
        eng.run()
    else:
        serve_fn(eng, reqs)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = launches_now()
    stats = set_stats(eng, reqs, log, start, n_keys, run_s)
    return {"stats": stats, "launches": launches,
            "buckets": [k[1] for k in log["keys"][n_keys:]
                        if k[0] == "prefill"],
            "tokens": {r.id - offset: list(eng.tokens_by_req[r.id])
                       for r in reqs},
            "records": [(r.kind, tuple(b - offset for b in r.batch_ids),
                         dataclasses.asdict(r.mix))
                        for r in eng.records[start:]]}


def runtime_launches(prof):
    """(runtime calls that enqueue one kernel, copy or fill; graph
    launches) in a ``torch.profiler`` window."""
    ka = prof.key_averages()
    return (sum(e.count for e in ka if e.key.startswith(RUNTIME_LAUNCHES)),
            sum(e.count for e in ka if e.key == "cudaGraphLaunch"))


def launches_per_step(eng, reqs, prompts):
    """Serve ``reqs``, profiling the first LAUNCH_STEPS steps of each
    kind: the mean runtime launches and graph launches of a step."""
    for r in reqs:
        eng.add_request(r, prompts.get(r.id % SET_IDS))
    seen = {"prefill": [], "decode": []}
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    while eng.has_work:
        if min(len(v) for v in seen.values()) >= LAUNCH_STEPS:
            eng.run()
            break
        with torch.profiler.profile(activities=acts) as prof:
            rec = eng.step()
            torch.cuda.synchronize()
        if rec is None:
            break
        if len(seen[rec.kind]) < LAUNCH_STEPS:
            seen[rec.kind].append(runtime_launches(prof))
    return {kind: {"steps": len(v),
                   "runtime_launches_per_step":
                       float(np.mean([a for a, _ in v])) if v else None,
                   "graph_launches_per_step":
                       float(np.mean([b for _, b in v])) if v else None}
            for kind, v in seen.items()}


def sampled_logits(eng, reqs, prompts):
    """Serve ``reqs``, keeping a copy of every logits row sampled."""
    rows = []
    sample = eng._sample

    def keep(logits):
        rows.append(logits.float().clone())
        return sample(logits)

    eng._sample = keep
    for r in reqs:
        eng.add_request(r, prompts.get(r.id % SET_IDS))
    eng.run()
    del eng._sample
    return rows, {r.id % SET_IDS: list(eng.tokens_by_req[r.id])
                  for r in reqs}


def spread(xs):
    xs = [x for x in xs if x is not None]
    return (max(xs) - min(xs)) / float(np.mean(xs)) if len(xs) > 1 else None


def eager_vs_graphed(label, graphed, log, eager, make_reqs, prompts, main,
                     state_keys, expect_launches=None):
    """Serve request sets 1.. on the graphed engine (set 0 was the main
    path's run, ``main``) and sets 0.. on the eager engine, in turns;
    each set's greedy tokens, iteration records and launch counts must
    be identical between the two, and so must the engines' persistent
    state after the sets (``state_keys`` of their page store or slot
    cache).  Then the logits of one more set, and the runtime launches
    of a step.  ``expect_launches(run)`` (optional) raises if a run's
    launch counts are not what its prefill buckets need."""
    logs = {"eager": instrument(eager), "graphed": log}
    runs = {"graphed": [main], "eager": []}
    for k in range(GRAPH_SETS):
        order = ("eager", "graphed") if k % 2 == 0 else ("graphed", "eager")
        for mode in order:
            if mode == "graphed" and k == 0:
                continue
            eng = graphed if mode == "graphed" else eager
            runs[mode].append(serve_set(eng, make_reqs(k * SET_IDS), prompts,
                                        logs[mode]))
    for k, (e, g) in enumerate(zip(runs["eager"], runs["graphed"])):
        for what in ("tokens", "records", "launches"):
            if e[what] != g[what]:
                raise AssertionError(f"{label}: set {k}: graphed {what} "
                                     f"differ from eager")
        if expect_launches is not None:
            expect_launches(e)
            expect_launches(g)
    def state(eng, key):
        # the trash page takes colliding writes in no fixed order
        return eng.pages[key][:, :eng.trash_page] if eng.paged \
            else eng.cache[key]

    state_diff = max(float((state(graphed, key) - state(eager, key))
                           .abs().max()) for key in state_keys)

    n = GRAPH_SETS * SET_IDS
    reqs = make_reqs(n)[:MAX_BATCH]
    rows_e, tok_e = sampled_logits(eager, reqs, prompts)
    rows_g, tok_g = sampled_logits(graphed, make_reqs(n)[:MAX_BATCH],
                                   prompts)
    if tok_e != tok_g or len(rows_e) != len(rows_g):
        raise AssertionError(f"{label}: graphed tokens differ from eager")
    logit_diff = max(float((a - b).abs().max())
                     for a, b in zip(rows_e, rows_g))
    steps = {mode: launches_per_step(
        eng, make_reqs((GRAPH_SETS + 1) * SET_IDS)[:MAX_BATCH // 2], prompts)
        for mode, eng in (("eager", eager), ("graphed", graphed))}

    def per_run(mode, key):
        return [r["stats"][key] for r in runs[mode]]

    out = {"model": label, "sets": GRAPH_SETS,
           "identical_tokens_records_launches": True,
           "state_max_abs_diff": state_diff,
           "sampled_logit_rows": len(rows_e),
           "logits_max_abs_diff": logit_diff,
           "graphs": len(graphed.graphs),
           "graph_keys": [list(k) for k in graphed.graphs.graphs],
           "capture_s": graphed.graphs.capture_seconds,
           "launches_per_set": runs["eager"][0]["launches"],
           "steps": steps}
    for mode in ("eager", "graphed"):
        for key in ("mean_prefill_wall_ms", "mean_decode_wall_ms",
                    "mean_prefill_wall_ms_without_capture",
                    "mean_decode_wall_ms_without_capture",
                    "generated_tokens_per_s", "run_s",
                    "capture_iterations"):
            out[f"{mode}_{key}"] = per_run(mode, key)
    # spread of the mean walls between sets: the eager sets, and the
    # graphed sets after set 0 (which holds the captures)
    for kind in ("prefill", "decode"):
        key = f"mean_{kind}_wall_ms"
        out[f"eager_{kind}_spread"] = spread(per_run("eager", key))
        out[f"graphed_{kind}_spread"] = spread(per_run("graphed", key)[1:])
    phase(f"{label}_eager_vs_graphed", **out)
    return out


class RoutingLog:
    """A hook on ``models.moe._router`` while in the ``with`` block: keeps
    each MoE call's top-k expert ids, sorted per token (a set), one
    (T, k) tensor a layer in call order.  The logit checks read it to
    tell the rows whose routing the two attention routes agree on; the
    package has no knob for it."""

    def __enter__(self):
        self.calls = []
        self._router = moe._router

        def router(*args, **kw):
            out = self._router(*args, **kw)
            self.calls.append(out[1].sort(dim=-1).values)
            return out

        moe._router = router
        return self

    def __exit__(self, *exc):
        moe._router = self._router

    def ids(self):
        """(L, T, k): every layer's expert set of every token."""
        return torch.stack(self.calls)


def first_token_logits(model, params, prompts, routes=None):
    """Logits of each prompt's first generated token, as the engine's
    prefill computes them (power-of-two bucket, last real position), over
    the logical vocabulary (past it, both routes hold the -1e30 mask).
    For an MoE model, ``routes`` (a list) receives each prompt's expert
    sets, (L, prompt length, k), the last position being the row's."""
    vocab = model.plan.vocab_logical
    out = []
    for p in prompts:
        plen = len(p)
        spad = min(ServingEngine._bucket(plen), MAX_PAGES * PAGE)
        toks = torch.zeros((1, spad), dtype=torch.long, device="cuda")
        toks[0, :plen] = torch.from_numpy(p.astype(np.int64))
        with RoutingLog() as log:
            logits, _, _ = paged_model.prefill_forward(model, params, toks)
        out.append(logits[0, plen - 1, :vocab].clone())
        if routes is not None:
            routes.append(log.ids()[:, :plen])
    return out


def routing_agreement(got, want):
    """Expert sets of the kernel route (``got``) against the plain route
    (``want``), one (L, T, k) tensor a logits row whose last token is the
    row's: the share of (token, layer) pairs whose set differs, and for
    each row whether its own token's set agrees in every layer."""
    flips = [(a != b).any(-1) for a, b in zip(got, want)]     # (L, T)
    pairs = sum(f.numel() for f in flips)
    return {"flip_share": sum(int(f.sum()) for f in flips) / pairs,
            "pairs": pairs,
            "agree": [not bool(f[:, -1].any()) for f in flips]}


def check_serving(arch, params=None, dtype=None, head_dim=None):
    """``arch`` at full width and depth on the paged path (``params``: its
    weights, else drawn here; ``dtype``: the compute dtype in place of
    the config's, ``head_dim`` the head width in place of the config's
    (its q, k, v and output projections widen with it), either with
    FP32_REQUESTS requests of FP32_OUTPUT_LEN tokens and the graphed
    profiles alone, and on a page pool sized to those requests where
    the engine's NUM_BLOCKS pages would take over half of what the
    weights leave of the card).  The main
    path: the engine on the kernel routes (``attn_impl="pallas"``,
    ``attn_path="pallas"``), graphed, with one paged launch a layer a
    decode iteration and one flash launch a layer a prefill; then
    first-token and decode-step logits of the kernel routes against the
    plain routes (for an MoE model, with the routing flips between the
    two), and the profiles of a decode step and a 1024-token prefill,
    eager and graphed (for an MoE model, with the MoE's share).  For the
    archs of FULL_PHASE_SET, also eager against graphed engines and the
    same requests on the plain path; for SORT_ROUTE_ARCH, one request
    set on the ``sort`` MoE route.  Phase names carry the arch (and a
    ``dtype`` or ``head_dim`` given) as a prefix (none for llama2-7b, as
    before)."""
    variant = (f"-{dtype}" if dtype is not None else "") + \
        (f"-head_dim{head_dim}" if head_dim is not None else "")
    prefix = "" if arch == "llama2-7b" and not variant else \
        f"{arch}{variant}_"
    full = arch in FULL_PHASE_SET and not variant
    cfg = get_config(arch)
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    if head_dim is not None:
        cfg = dataclasses.replace(cfg, head_dim=head_dim)
    requests = make_requests if not variant else functools.partial(
        make_requests, n=FP32_REQUESTS, output_len=FP32_OUTPUT_LEN)
    is_moe = cfg.family == MOE
    kernel_model = zoo.build(cfg, settings=RunSettings(attn_impl="pallas"))
    plain_model = kernel_model.with_settings(attn_impl="naive")
    t0 = time.perf_counter()
    drawn = params is None
    if drawn:
        params = zoo.init_params(kernel_model, seed=SEED)
    torch.cuda.synchronize()
    n_bytes = sum(t.numel() * t.element_size()
                  for t in _leaves(params))
    plan = kernel_model.plan
    moe_fields = {"n_experts": plan.n_experts, "top_k": cfg.moe.top_k,
                  "d_expert": cfg.moe.d_expert,
                  "moe_impl": kernel_model.settings.moe_impl} \
        if is_moe else {}
    phase(f"{prefix}init_params", model=cfg.name, dtype=cfg.dtype,
          layers=cfg.num_layers, d_model=cfg.d_model, n_heads=cfg.n_heads,
          n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
          d_ff=cfg.d_ff, vocab=cfg.vocab_size, vocab_padded=plan.vocab,
          norm=cfg.norm, act=cfg.act, pos_emb=cfg.pos_emb,
          qk_norm=cfg.qk_norm, **moe_fields, param_gb=n_bytes / 1e9,
          seconds=time.perf_counter() - t0 if drawn else None)

    num_blocks = NUM_BLOCKS
    page_bytes = (2 * cfg.num_layers * cfg.n_kv_heads * cfg.head_dim * PAGE
                  * getattr(torch, cfg.dtype).itemsize)
    if variant and NUM_BLOCKS * page_bytes > torch.cuda.mem_get_info()[0] / 2:
        # the pages of the requests (their longest prompt and output),
        # rounded up to 128
        need = FP32_REQUESTS * -(-(PROMPT_RANGE[1] + FP32_OUTPUT_LEN) // PAGE)
        num_blocks = -(-need // 128) * 128

    # the main path: the engine as a user builds it, graphed on the card
    torch.cuda.reset_peak_memory_stats()
    graphed = paged_engine(kernel_model, params, "pallas",
                           num_blocks=num_blocks)
    log = instrument(graphed)
    main = serve_set(graphed, requests(), {}, log)
    launches = main["launches"]
    kernel_stats = {"model": cfg.name, "dtype": cfg.dtype,
                    "attn_path": "pallas", "num_blocks": num_blocks,
                    "attn_impl": kernel_model.settings.attn_impl,
                    **main["stats"],
                    "launches": {k: launches[k] for k in
                                 ("paged_attention", "flash_attention")},
                    "flash_launches_by_sq": launches["flash_attention_by_sq"],
                    "flash_launches_per_prefill":
                        launches["flash_attention"] / len(main["buckets"]),
                    "paged_launches_per_decode":
                        launches["paged_attention"]
                        / main["stats"]["decode_iterations"],
                    "graphs": len(graphed.graphs),
                    "capture_s": graphed.graphs.capture_seconds,
                    "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    phase(f"{prefix}serve_kernel_path", **kernel_stats)
    expect = {"paged_attention":
              cfg.num_layers * main["stats"]["decode_iterations"],
              "flash_attention": cfg.num_layers * len(main["buckets"])}
    for name, n in kernel_stats["launches"].items():
        if n <= 0 or n != expect[name]:
            raise AssertionError(f"{arch}: {name} launched {n} times while "
                                 f"serving, expected {expect[name]}")
    prompts = dict(graphed.prompt_tokens)
    kernel_tokens = main["tokens"]
    if arch == SORT_ROUTE_ARCH:
        check_sort_route(kernel_model, params, prompts, main)

    if full:
        eager = paged_engine(kernel_model, params, "pallas", graphs=False)
        eager_vs_graphed(cfg.name, graphed, log, eager, make_requests,
                         prompts, main, ("k", "v"))
        del eager
    del graphed
    free_memory()

    ordered = [prompts[rid] for rid in sorted(prompts)]
    routes = {"kernel": [], "plain": []} if is_moe else {}
    limits = LOGIT_LIMITS[kernel_model.compute_dtype]
    got = first_token_logits(kernel_model, params, ordered,
                             routes.get("kernel"))
    want = first_token_logits(plain_model, params, ordered,
                              routes.get("plain"))
    compare_logits(f"{prefix}first_token_logits", got, want, cfg.vocab_size,
                   routing_agreement(routes["kernel"], routes["plain"])
                   if is_moe else None, limits)

    pages, lens, toks, free_row = decode_state(kernel_model, params)
    routes = {} if is_moe else None
    got, want = decode_logits(kernel_model, params, pages, lens, toks,
                              routes)
    # a decode row is one token: its (L, 1, k) expert sets
    compare_logits(f"{prefix}decode_logits", got, want, cfg.vocab_size,
                   routing_agreement(routes["pallas"].split(1, dim=1),
                                     routes["gather"].split(1, dim=1))
                   if is_moe else None, limits)
    profile_serving(kernel_model, params, pages, lens, toks, free_row,
                    prefix, eager=not variant)
    del pages
    free_memory()
    if not full:
        return kernel_stats

    plain = paged_engine(plain_model, params, "gather")
    plain_run = serve_set(plain, make_requests(), prompts, instrument(plain))
    plain_stats = {"model": cfg.name, "attn_path": "gather",
                   "attn_impl": plain_model.settings.attn_impl,
                   **plain_run["stats"], "graphs": len(plain.graphs)}
    del plain
    free_memory()
    plain_tokens = plain_run["tokens"]
    same = sum(int(x == y) for rid in kernel_tokens
               for x, y in zip(kernel_tokens[rid], plain_tokens[rid]))
    first_same = sum(int(kernel_tokens[rid][0] == plain_tokens[rid][0])
                     for rid in kernel_tokens)
    plain_stats["generated_tokens_agreeing"] = same
    plain_stats["first_tokens_agreeing"] = first_same
    phase(f"{prefix}serve_plain_path", **plain_stats)
    return kernel_stats


def check_sort_route(model, params, prompts, main):
    """Set 0 of the main path's requests (same prompts) on the ``sort``
    MoE route, graphed, beside the main path's ``dense_onehot`` run:
    greedy tokens that agree, and both runs' walls.  The two routes
    compute one function; in bf16 they round at other points (``sort``
    weights and sums each token's top-k outputs, ``dense_onehot`` sums
    over every expert in one product), so a near tie may part the
    tokens.  The CPU tests hold the two routes equal in fp32."""
    eng = paged_engine(model.with_settings(moe_impl="sort"), params,
                       "pallas")
    run = serve_set(eng, make_requests(), prompts, instrument(eng))
    dense, sort = main["tokens"], run["tokens"]

    def agreeing_prefix(a, b):
        n = 0
        while n < min(len(a), len(b)) and a[n] == b[n]:
            n += 1
        return n

    keys = ("mean_prefill_wall_ms", "mean_decode_wall_ms",
            "mean_prefill_wall_ms_without_capture",
            "mean_decode_wall_ms_without_capture",
            "generated_tokens_per_s", "capture_iterations")
    phase(f"{model.cfg.name}_sort_route", moe_impl="sort",
          requests=len(sort), graphs=len(eng.graphs),
          generated_tokens_agreeing=sum(
              int(x == y) for rid in dense
              for x, y in zip(dense[rid], sort[rid])),
          generated_tokens=sum(len(t) for t in sort.values()),
          first_tokens_agreeing=sum(int(dense[rid][0] == sort[rid][0])
                                    for rid in dense),
          mean_agreeing_prefix=float(np.mean(
              [agreeing_prefix(dense[rid], sort[rid]) for rid in dense])),
          **{f"sort_{k}": run["stats"][k] for k in keys},
          **{f"dense_onehot_{k}": main["stats"][k] for k in keys})
    del eng
    free_memory()


def compare_logits(label, got, want, vocab, routing=None,
                   limits=(LOGIT_REL_MAX, LOGIT_REL_L2)):
    """Kernel-path logits ``got`` against plain-path ``want``, row by
    row; fails past ``limits`` (largest error over the largest |logit|,
    and the L2 ratio; LOGIT_REL_MAX and LOGIT_REL_L2 by default).  For an
    MoE model,
    ``routing`` (``routing_agreement``) says which rows' tokens the two
    routes sent to the same experts in every layer: the limits hold those
    rows; a row whose expert set flipped swaps part of its FFN output,
    which is not the attention's rounding, and its errors are reported
    beside them."""
    agree = routing["agree"] if routing else [True] * len(got)
    errs = {True: [], False: []}
    argmax_same = 0
    for a, b, same in zip(got, want, agree):
        if not (torch.isfinite(a).all() and torch.isfinite(b).all()
                and a.shape == b.shape == (vocab,)):
            raise AssertionError(f"{label}: logits not finite or misshapen")
        err = float((a - b).abs().max())
        errs[same].append((err, err / float(b.abs().max()),
                           float((a - b).norm() / b.norm())))
        argmax_same += int(a.argmax() == b.argmax())

    def worst(rows, i):
        return max((r[i] for r in rows), default=None)

    held = errs[True]
    fields = {}
    if routing:
        fields = {"routing_flip_share": routing["flip_share"],
                  "routing_pairs": routing["pairs"],
                  "rows_routing_agrees": len(held),
                  "rows_routing_differs": len(errs[False]),
                  "routing_differs_max_rel_err": worst(errs[False], 1),
                  "routing_differs_max_rel_l2": worst(errs[False], 2)}
    rel_max, rel_l2 = worst(held, 1), worst(held, 2)
    tol_max, tol_l2 = limits
    phase(label, rows=len(got), max_abs_err=worst(held, 0),
          max_rel_err=rel_max, tol_rel_max=tol_max, max_rel_l2=rel_l2,
          tol_rel_l2=tol_l2, argmax_agree=argmax_same,
          logit_scale=float(torch.stack(list(want)).abs().max()), **fields)
    if held and (rel_max > tol_max or rel_l2 > tol_l2):
        raise AssertionError(f"{label} differ: max {rel_max}, rel L2 "
                             f"{rel_l2} of the plain path's")


def decode_state(model, params, *, page=PAGE, batch=MAX_BATCH,
                 max_pages=MAX_PAGES, prompt_range=PROMPT_RANGE):
    """A full decode batch on real KV: prompts of lengths drawn like the
    serving run's, each prefilled and scattered into its own pages, plus
    room for one more longest prompt (``free_row``).  The keywords give
    another engine's page size, batch, table width and prompt lengths."""
    rng = np.random.RandomState(1)
    lens = rng.randint(prompt_range[0], prompt_range[1] + 1, size=batch)
    need = [-(-(int(n) + 1) // page) for n in lens]
    trash = sum(need) + prompt_range[1] // page
    pages = paged_model.init_pages(model, trash + 1, page, batch, max_pages,
                                   "cuda")
    tables = np.full((batch, max_pages), trash, np.int32)
    start = 0
    for b, n in enumerate(need):
        tables[b, :n] = np.arange(start, start + n)
        start += n
    pages["tables"].copy_(torch.from_numpy(tables))
    for b, n in enumerate(lens):
        n = int(n)
        toks = torch.zeros((1, min(ServingEngine._bucket(n),
                                   max_pages * page)),
                           dtype=torch.long, device="cuda")
        toks[0, :n] = torch.from_numpy(
            rng.randint(0, model.cfg.vocab_size, size=n))
        _, k, v = paged_model.prefill_forward(model, params, toks)
        paged_model.scatter_prefill(model, pages, k, v, pages["tables"][b], n)
    free_row = torch.full((max_pages,), trash, dtype=torch.long,
                          device="cuda")
    free_row[:prompt_range[1] // page] = torch.arange(
        start, start + prompt_range[1] // page)
    toks = torch.from_numpy(rng.randint(0, model.cfg.vocab_size,
                                        size=batch)).cuda()
    return (pages, torch.from_numpy(lens.astype(np.int32)).cuda(), toks,
            free_row)


def decode_logits(model, params, pages, lens, toks, routes=None):
    """One decode step's logits through the paged kernel and through the
    plain gather path, from the same page state (each writes the new
    token's K/V into the same slot before it reads it).  For an MoE
    model, ``routes`` (a dict) receives each path's expert sets,
    (L, B, k)."""
    vocab = model.plan.vocab_logical
    out = {}
    for path in ("pallas", "gather"):
        pages["len"].copy_(lens)
        with RoutingLog() as log:
            logits, _ = paged_model.paged_decode_step(model, params, pages,
                                                      toks, path)
        out[path] = logits[:, :vocab].float()
        if routes is not None:
            routes[path] = log.ids()
    return out["pallas"], out["gather"]


def profile(label, fn, reps, shares=None):
    """Where one call's time goes: host wall per call (no profiler), then
    under ``torch.profiler`` the device-busy time per call (sum of the
    device time of every kernel and copy), the idle share, the kernels
    that take the most device time, the runtime calls that enqueue one
    kernel, copy or fill and the CUDA graph launches per call, and, for
    each entry of ``shares`` (label -> kernel names), the share of the
    busy time that the kernels whose names contain one of those names
    take."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / reps
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in dev) / 1e3 / reps
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:8]
    busy_share = {
        key: sum(e.self_device_time_total for e in dev
                 if any(k in e.key for k in names)) / 1e3 / reps / busy_ms
        for key, names in (shares or {}).items()} if dev else "not measured"
    launches, graph_launches = runtime_launches(prof)
    phase(f"profile_{label}", wall_ms=wall_ms,
          busy_share=busy_share,
          runtime_launches_per_call=launches / reps,
          graph_launches_per_call=graph_launches / reps,
          device_busy_ms=busy_ms if dev else "not measured",
          idle_share=1 - busy_ms / wall_ms if dev else "not measured",
          top_kernels=[{"name": e.key[:80],
                        "ms_per_call": e.self_device_time_total / 1e3 / reps,
                        "calls_per_call": e.count / reps}
                       for e in top])


def profile_serving(model, params, pages, lens, toks, free_row, prefix="",
                    eager=True):
    """One prefill of a 1024-token prompt and one decode step of the
    ``decode_state`` batch, on the kernel path: eager (unless ``eager`` is
    false), then as the engine's CUDA graphs run them (the step in a
    graph, the copy of the lengths and the scatter of the prefill's K/V
    outside)."""
    graphs = StepGraphs("cuda")

    def decode_step():
        return paged_model.paged_decode_step(model, params, pages, toks,
                                             "pallas")[0]

    def decode():
        pages["len"].copy_(lens)
        decode_step()

    def decode_graphed():
        pages["len"].copy_(lens)
        graphs.run("decode", decode_step)

    s = PROMPT_RANGE[1]
    prompt = torch.from_numpy(np.random.RandomState(2).randint(
        0, model.cfg.vocab_size, size=(1, s))).cuda()

    def prefill_step():
        return paged_model.prefill_forward(model, params, prompt)

    def prefill():
        _, k, v = prefill_step()
        paged_model.scatter_prefill(model, pages, k, v, free_row, s)

    def prefill_graphed():
        _, k, v = graphs.run("prefill", prefill_step)
        paged_model.scatter_prefill(model, pages, k, v, free_row, s)

    runs = (("", decode, prefill),
            ("_graphed", decode_graphed, prefill_graphed))
    for suffix, dec, pre in runs if eager else runs[1:]:
        profile(f"{prefix}decode_step{suffix}", dec, 5,
                shares={"paged_attention": PAGED_KERNELS})
        profile(f"{prefix}prefill_1024{suffix}", pre, 3,
                shares={"flash_attention": FLASH_KERNELS})
    if model.cfg.family == MOE:
        moe_share(model, params, {"decode": decode_graphed,
                                  "prefill_1024": prefill_graphed}, prefix)


def moe_share(model, params, steps, prefix):
    """The MoE's share of a graphed step: the device time (CUDA events)
    of a CUDA graph of every layer's ``moe_apply`` at the step's rows
    (``MAX_BATCH`` for the decode step, ``PROMPT_RANGE[1]`` for the
    prefill; random hidden states) over that of the step as
    ``profile_serving`` replays it.  The MoE has no kernel name of its
    own in a trace (cuBLAS GEMMs, top-k, elementwise), so it is timed
    apart, graphed as in the step."""
    cfg, cd = model.cfg, model.compute_dtype
    layers = [zoo.layer(params["layers"], i)["moe"]
              for i in range(cfg.num_layers)]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    graphs = StepGraphs("cuda")
    out = {}
    for kind, step in steps.items():
        rows = MAX_BATCH if kind == "decode" else PROMPT_RANGE[1]
        x = torch.randn(rows, cfg.d_model, generator=gen,
                        device="cuda").to(cd)

        def moe_layers():
            return [moe.moe_apply(lp, x, top_k=cfg.moe.top_k,
                                  n_experts_logical=model.plan
                                  .n_experts_logical,
                                  impl=model.settings.moe_impl,
                                  compute_dtype=cd)[0] for lp in layers]

        moe_ms = time_ms(lambda: graphs.run(kind, moe_layers), 10)
        step_ms = time_ms(step, 10)
        out[kind] = {"rows": rows, "moe_ms": moe_ms, "step_ms": step_ms,
                     "moe_share": moe_ms / step_ms}
    phase(f"{prefix}moe_share", moe_impl=model.settings.moe_impl,
          layers=cfg.num_layers, **out)


# ---------------------------------------------------------------------------
# The SSD kernel, and mamba2-130m on the slot path
# ---------------------------------------------------------------------------
def ssd_inputs(b, s, h, p, g, n, *, bc_dtype=torch.float32, strided=False,
               with_state=False, model_decay=False, seed=0):
    """SSD inputs on the card, drawn like tests/test_kernels.py's (dt·A
    about -1 a step).  ``model_decay`` draws dt·A as a mamba2 layer does
    (dt = softplus(N(0,1) + dt_bias), dt_bias as ``mamba2_init`` draws
    it, A = -linspace(1, 16)), so slow heads carry the state across
    chunks.  With ``strided``, B/C are column slices of one
    (B,S,H*P+2*G*N) tensor, as the model hands them over."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    xbar = torch.randn(b, s, h, p, generator=gen, device=dev)
    if model_decay:
        lo, hi = np.log(1e-3), np.log(1e-1)
        u = torch.rand(h, generator=gen, device=dev) * (hi - lo) + lo
        dt = torch.nn.functional.softplus(
            torch.randn(b, s, h, generator=gen, device=dev)
            + torch.log(torch.expm1(torch.exp(u))))
        dA_log = -dt * torch.linspace(1.0, 16.0, h, device=dev)
    else:
        dt = torch.nn.functional.softplus(
            torch.randn(b, s, h, generator=gen, device=dev))
        dA_log = -dt * torch.exp(torch.rand(1, 1, h, generator=gen,
                                            device=dev))
    if strided:
        xbc = torch.randn(b, s, h * p + 2 * g * n, generator=gen,
                          device=dev).to(bc_dtype)
        Bm = xbc[..., h * p:h * p + g * n].reshape(b, s, g, n)
        Cm = xbc[..., h * p + g * n:].reshape(b, s, g, n)
    else:
        Bm = torch.randn(b, s, g, n, generator=gen, device=dev).to(bc_dtype)
        Cm = torch.randn(b, s, g, n, generator=gen, device=dev).to(bc_dtype)
    state0 = torch.randn(b, h, n, p, generator=gen, device=dev) \
        if with_state else None
    return xbar, dA_log, Bm, Cm, state0


def ssd_flops(b, s, h, p, g, n, chunk, with_state):
    """(least, as counted by the Pallas kernel) flops of one scan: the
    least counts the lower triangle of each chunk's L x L products only,
    C.B^T once per group, 2 L N P per (chunk, head) for the chunk's own
    state and 2 L N P per (chunk, head) for the state's share of y only
    where the state before the chunk can be non-zero (a chunk after the
    first, or ``with_state``); the Pallas count is
    2 L^2 N + 2 L^2 P + 4 L N P per (chunk, head)."""
    full, ragged = divmod(s, chunk)
    lens = [chunk] * full + ([ragged] if ragged else [])
    least = pallas = 0
    for c, L in enumerate(lens):
        tri = L * (L + 1) // 2
        carried = 2 * L * n * p if c > 0 or with_state else 0
        least += b * (2 * tri * n * g
                      + h * (2 * tri * p + 2 * L * n * p + carried))
        pallas += b * h * (2 * L * L * n + 2 * L * L * p + 4 * L * n * p)
    return least, pallas


def ssd_fp64(xbar, dA_log, Bm, Cm, state0):
    """The SSD recurrence token by token in fp64 (S <- S exp(dA) + B (x) x,
    y = C . S), on the inputs' device: no chunks, no segment sums, and
    rounding far below the fp32 limits, so it shares neither code nor
    error with the plain version."""
    b, s, h, p = xbar.shape
    hpg = h // Bm.shape[2]
    x, a = xbar.double(), torch.exp(dA_log.double())
    Bh = Bm.double().repeat_interleave(hpg, dim=2)           # (B,S,H,N)
    Ch = Cm.double().repeat_interleave(hpg, dim=2)
    state = torch.zeros(b, h, Bm.shape[3], p, dtype=torch.float64,
                        device=xbar.device) \
        if state0 is None else state0.double().clone()
    y = torch.empty(b, s, h, p, dtype=torch.float64, device=xbar.device)
    for t in range(s):
        state.mul_(a[:, t, :, None, None]).add_(
            Bh[:, t, :, :, None] * x[:, t, :, None, :])
        y[:, t] = torch.einsum("bhn,bhnp->bhp", Ch[:, t], state)
    return y, state


def ssd_errors(y, fs, xbar, dA_log, Bm, Cm, chunk, state0):
    """The SSD kernel's y and final state against its references, per row
    of P: the plain version (fp32, on CPU copies of the same values, the
    ragged case through the wrapper's padding), and ``ssd_fp64`` on the
    card, which does not use the CPU.  The plain version runs twice, and
    a third time if those two differ by more than ``PLAIN_SPREAD_REL``:
    on the H100 host these checks were run on, the CPU now and then
    computed ``torch.exp`` wrong on one OpenMP thread's share of the
    first plain run after a process's first scan (PERF.md), and the fp64
    reading shows which run is off.  Every run's error is recorded.  ``rel_y``/``rel_s`` are the
    largest errors against fp64 and against the two plain runs that
    agree; ``ok`` needs such a pair and both within the limit."""
    ins = (xbar.cpu(), dA_log.cpu(), Bm.float().cpu(), Cm.float().cpu())
    s0 = None if state0 is None else state0.cpu()

    def plain_run():
        return ssd_ops.ssd_scan(*ins, chunk=chunk, state0=s0)

    def rel(a, b):
        return [float(row_rel_err(u.cpu(), v.cpu()).max())
                for u, v in zip(a, b)]

    plain = [plain_run(), plain_run()]
    if max(rel(plain[1], plain[0])) > PLAIN_SPREAD_REL:
        plain.append(plain_run())
    pair = next(((u, v) for k, u in enumerate(plain) for v in plain[k + 1:]
                 if max(rel(v, u)) <= PLAIN_SPREAD_REL), None)
    exact = ssd_fp64(xbar, dA_log, Bm, Cm, state0)
    got = (y, fs)
    e = {"plain_runs": len(plain),
         "plain_spread": max(rel(plain[1], plain[0])),
         "plain_pair_agrees": pair is not None,
         "vs_plain": [rel(got, r) for r in plain],
         "plain_vs_fp64": [rel(r, exact) for r in plain],
         "vs_fp64": rel(got, exact),
         "max_abs_err": max(float((u.cpu() - v).abs().max())
                            for u, v in zip(got, plain[0])),
         "finite": bool(all(torch.isfinite(u).all() for u in got))}
    refs = [e["vs_fp64"]] + ([rel(got, r) for r in pair] if pair else [])
    e["rel_y"] = max(r[0] for r in refs)
    e["rel_s"] = max(r[1] for r in refs)
    e["ok"] = (e["finite"] and pair is not None
               and max(e["rel_y"], e["rel_s"]) <= REL_TOL[torch.float32])
    return e


def kernel_profile(fn, reps, names, label):
    """Each named kernel inside ``reps`` calls of ``fn``, under
    ``torch.profiler``: device ms per call, launches per call and launch
    grid, by kernel name (read from the trace, which lands in the build
    directory as ``<label>_trace.json``)."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    trace = build.BUILD_DIR / f"{label}_trace.json"
    prof.export_chrome_trace(str(trace))
    events = [e for e in json.loads(trace.read_text())["traceEvents"]
              if e.get("cat") == "kernel"]
    out = {}
    for name in names:
        ev = [e for e in events if name in e.get("name", "")]
        if not ev:
            out[name] = "not measured"
            continue
        grid = tuple(ev[0].get("args", {}).get("grid", ()))
        out[name] = {"ms": sum(e["dur"] for e in ev) / 1e3 / reps,
                     "launches_per_call": len(ev) / reps, "grid": grid,
                     "blocks": int(np.prod(grid)) if grid else None}
    return out


def ssd_case(name, b, s, h, p, g, n, chunk, **kw):
    """The SSD kernel against its references (``ssd_errors``), per row of
    P: y and the final state."""
    xbar, dA_log, Bm, Cm, state0 = ssd_inputs(b, s, h, p, g, n, **kw)
    y, fs = ssd_ops.ssd_scan(xbar, dA_log, Bm, Cm, chunk=chunk,
                             state0=state0)
    torch.cuda.synchronize()
    errs = ssd_errors(y, fs, xbar, dA_log, Bm, Cm, chunk, state0)

    least, pallas = ssd_flops(b, s, h, p, g, n, chunk, state0 is not None)
    nbytes = (2 * xbar.numel() + dA_log.numel() + fs.numel()
              * (2 if state0 is not None else 1)) * 4 \
        + 2 * b * s * g * n * esize(Bm.dtype)
    bound_ms, bound_by, bound_route = bound(nbytes, least, torch.float32)
    # the plain version on the card: the chunked formula in fp32, on
    # inputs made contiguous as it would need them
    xc, dc, bc, cc = (t.contiguous() for t in (xbar, dA_log, Bm.float(),
                                               Cm.float()))
    pad = (-s) % chunk
    plain_ms = None
    if not pad and s >= chunk:
        plain_ms = time_ms(lambda: ssd_ops.ssd_chunked_ref(
            xc, dc, bc, cc, chunk, state0), 5)
    def scan():
        ssd_ops.ssd_scan(xbar, dA_log, Bm, Cm, chunk=chunk, state0=state0)

    # the card's time (the wrapper's host time hidden behind a queue
    # filled ahead), the time a call takes back to back, and each kernel
    # of the scan inside whole scans
    kernel_ms = time_ms(scan, 20, queue_ahead=True)
    call_ms = time_ms(scan, 20)
    rec = {"case": name, "b": b, "s": s, "h": h, "p": p, "g": g, "n": n,
           "chunk": chunk, "bc_dtype": str(Bm.dtype),
           "model_decay": kw.get("model_decay", False),
           "bc_strided": not Bm.is_contiguous(),
           "state0": state0 is not None,
           "max_abs_err": errs.pop("max_abs_err"),
           "max_rel_err_y": errs["rel_y"], "max_rel_err_state": errs["rel_s"],
           "tol_rel": REL_TOL[torch.float32],
           "plain_spread_tol": PLAIN_SPREAD_REL, "errors": errs,
           "kernel_ms": kernel_ms, "call_ms": call_ms,
           "phases": kernel_profile(scan, 20, SSD_KERNELS, "ssd_scan"),
           "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
           "bound_route": bound_route,
           "tflops_least": least / kernel_ms / 1e9,
           "bound_share": bound_ms / kernel_ms,
           "flops_least": least, "flops_pallas_count": pallas,
           "bytes": nbytes, "library_ms": None}
    phase("ssd_scan", **rec)
    if not errs["ok"]:
        raise AssertionError(f"ssd_scan {name}: row errors y {errs['rel_y']}"
                             f", state {errs['rel_s']} (tol "
                             f"{REL_TOL[torch.float32]}), two plain runs "
                             f"within {PLAIN_SPREAD_REL}: "
                             f"{errs['plain_pair_agrees']}, finite="
                             f"{errs['finite']}")
    return rec


def check_ssd_kernel():
    """tests/test_kernels.py's SSD_CASES (b, s, h, p, g, n, chunk; the
    third ragged), then the serving path's shapes, a ragged last chunk
    that is not a multiple of the kernels' 64-row tile, and many chunks
    with a batch; returns the record of the mamba2-130m prefill shape."""
    bf16 = torch.bfloat16
    for i, c in enumerate([(2, 128, 4, 32, 1, 64, 32),
                           (1, 96, 4, 16, 2, 32, 32),
                           (2, 100, 2, 16, 1, 16, 32),
                           (1, 64, 8, 64, 1, 128, 64)]):
        ssd_case(f"SSD_CASES[{i}]", *c)
    full = ssd_case("mamba2-130m prefill S=1024", 1, 1024, 24, 64, 1, 128,
                    256, bc_dtype=bf16, strided=True, model_decay=True,
                    seed=1)
    ssd_case("G=2", 1, 512, 24, 64, 2, 128, 256, bc_dtype=bf16,
             strided=True, model_decay=True, seed=2)
    ssd_case("initial state", 2, 512, 8, 64, 1, 128, 256, with_state=True,
             model_decay=True, seed=3)
    ssd_case("ragged last chunk S=1000", 1, 1000, 24, 64, 1, 128, 256,
             bc_dtype=bf16, strided=True, model_decay=True, seed=4)
    ssd_case("B=2 S=4096 initial state", 2, 4096, 24, 64, 1, 128, 256,
             bc_dtype=bf16, strided=True, with_state=True, model_decay=True,
             seed=5)
    ssd_case("zamba2-2.7b prefill S=1024", 1, 1024, 80, 64, 1, 64, 256,
             bc_dtype=bf16, strided=True, model_decay=True, seed=6)
    # the training CLI's shape (mamba2-130m, B 4, S 1024)
    ssd_case("mamba2-130m training B=4 S=1024", 4, 1024, 24, 64, 1, 128,
             256, bc_dtype=bf16, strided=True, model_decay=True, seed=7)
    return full


MAMBA_PROMPTS_SHORT = (20, 128)     # bucket <= 128: the recurrent scan
MAMBA_PROMPTS_LONG = (300, 990)     # bucket 512 or 1024: the SSD kernel
MAMBA_SHORT, MAMBA_LONG = 4, 12


def mamba_requests(offset=0):
    rng = np.random.RandomState(SEED)
    lens = np.concatenate([
        rng.randint(MAMBA_PROMPTS_SHORT[0], MAMBA_PROMPTS_SHORT[1] + 1,
                    size=MAMBA_SHORT),
        rng.randint(MAMBA_PROMPTS_LONG[0], MAMBA_PROMPTS_LONG[1] + 1,
                    size=MAMBA_LONG)])
    rng.shuffle(lens)
    return [Request(id=offset + i, arrival_time=0.0, prompt_len=int(p),
                    output_len=OUTPUT_LEN) for i, p in enumerate(lens)]


def check_mamba2():
    args = serve_cli.parse_args(["--arch", "mamba2-130m", "--max-batch",
                                 str(MAX_BATCH), "--seed", str(SEED)])
    cfg = get_config(args.arch)
    t0 = time.perf_counter()
    engine = serve_cli.build_engine(args)
    torch.cuda.synchronize()
    model, params = engine.model, engine.params
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    phase("mamba2_init_params", model=cfg.name, layers=cfg.num_layers,
          d_model=cfg.d_model, ssd_heads=model.plan.ssm_heads,
          head_dim=cfg.ssm.head_dim, d_state=cfg.ssm.d_state,
          chunk=cfg.ssm.chunk_size, vocab=model.plan.vocab,
          param_gb=n_bytes / 1e9, seconds=time.perf_counter() - t0)

    chunk = cfg.ssm.chunk_size

    def chunked(run):
        """The run's prefill calls whose bucket takes the chunked scan."""
        return sum(1 for s in run["buckets"] if s % chunk == 0 and s > 1)

    def expect_launches(run):
        n = run["launches"]["ssd_scan"]
        if n != cfg.num_layers * chunked(run):
            raise AssertionError(f"ssd_scan launched {n} times, expected "
                                 f"{cfg.num_layers} x {chunked(run)}")

    # the main path: launch/serve.py's engine, graphed on the card
    log = instrument(engine)
    reqs = mamba_requests()
    torch.cuda.reset_peak_memory_stats()
    summary = {}
    main = serve_set(engine, reqs, {}, log, serve_fn=lambda e, rs:
                     summary.update(serve_cli.serve(e, rs)))
    spads = main["buckets"]
    stats = {"model": cfg.name, "max_ctx": engine.max_ctx,
             "requests": len(reqs),
             "prompt_lens": [r.prompt_len for r in reqs],
             "finished": summary["n_finished"],
             **main["stats"],
             "prefill_calls": len(spads),
             "prefill_buckets": sorted(set(spads)),
             "chunked_prefill_calls": chunked(main),
             "launches": {"ssd_scan": main["launches"]["ssd_scan"]},
             "expected_ssd_launches": cfg.num_layers * chunked(main),
             "graphs": len(engine.graphs),
             "capture_s": engine.graphs.capture_seconds,
             "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    phase("serve_mamba2_slot_path", **stats)
    if summary["n_finished"] != len(reqs):
        raise AssertionError("mamba2: not every request finished")
    if chunked(main) == 0 or chunked(main) == len(spads):
        raise AssertionError(f"mamba2: prefill buckets {sorted(set(spads))}"
                             f" do not reach both SSD branches")
    expect_launches(main)

    eager = ServingEngine(model, params, engine.ec, graphs=False)
    eager_vs_graphed("mamba2-130m", engine, log, eager, mamba_requests,
                     dict(engine.prompt_tokens), main, ("conv", "ssd", "len"),
                     expect_launches)
    del eager
    free_memory()
    compare_ssm_routes(model, params, route_prompts(engine), engine.max_ctx)
    profile_slot_model("mamba2", model, params, engine.max_ctx,
                       {"ssd_scan": SSD_KERNELS})
    del engine
    free_memory()
    return stats


def route_prompts(engine):
    """The engine's first two prompts of over 128 tokens, by request id:
    those the two routes are compared on."""
    return [p for _, p in sorted(engine.prompt_tokens.items())
            if len(p) > MAMBA_PROMPTS_SHORT[1]][:2]


def ssm_route_errors(model, params, prompts, max_ctx):
    """For each prompt, padded as the engine pads it: every layer's block
    through the kernel (``impl="chunked"``) against ``impl="recurrent"``
    on the hidden states the kernel-route prefill feeds that layer, and
    first-token logits of the all-kernel chain against the all-recurrent
    chain.  Returns the worst layer's relative L2 error (norm of the
    difference over the recurrent route's norm) and worst row error of
    the block output and of the final state, the worst prompt's logit
    error (largest error over the largest |logit|), and the two chains'
    logits."""
    cfg = model.cfg
    cd = model.compute_dtype
    err = {"block_rel_l2": 0.0, "state_rel_l2": 0.0, "block_row_rel": 0.0,
           "state_row_rel": 0.0, "logits_rel": 0.0}
    got_logits, want_logits = [], []

    def worst(key, value):
        err[key] = max(err[key], float(value))

    for p in prompts:
        plen = len(p)
        spad = min(ServingEngine._bucket(plen), max_ctx)
        toks = torch.zeros((1, spad), dtype=torch.long, device="cuda")
        toks[0, :plen] = torch.from_numpy(p.astype(np.int64))
        xk = xr = zoo._embed_tokens(model, params, toks)
        for i in range(cfg.num_layers):
            lp = zoo.layer(params["layers"], i)
            h = norm_apply(lp["ln"], xk, cfg.norm)
            yk, (_, sk) = ssm.mamba2_apply(lp["mixer"], h, cfg.ssm,
                                           compute_dtype=cd)
            yr, (_, sr) = ssm.mamba2_apply(lp["mixer"], h, cfg.ssm,
                                           compute_dtype=cd,
                                           impl="recurrent")
            for key, a, b in (("block", yk, yr), ("state", sk, sr)):
                a, b = a.float(), b.float()
                worst(f"{key}_rel_l2", (a - b).norm() / b.norm())
                worst(f"{key}_row_rel", row_rel_err(a, b).max())
            hr = norm_apply(lp["ln"], xr, cfg.norm)
            yr2, _ = ssm.mamba2_apply(lp["mixer"], hr, cfg.ssm,
                                      compute_dtype=cd, impl="recurrent")
            xk, xr = xk + yk, xr + yr2
        vocab = model.plan.vocab_logical          # past it: the -1e30 mask
        got_logits.append(zoo._lm_head(model, params, xk)[0, plen - 1,
                                                           :vocab])
        want_logits.append(zoo._lm_head(model, params, xr)[0, plen - 1,
                                                            :vocab])
        a, b = got_logits[-1], want_logits[-1]
        worst("logits_rel", (a - b).abs().max() / b.abs().max())
    return err, got_logits, want_logits


def compare_ssm_routes(model, params, prompts, max_ctx):
    """``ssm_route_errors``, printed and held to the limits."""
    err, got_logits, want_logits = ssm_route_errors(model, params, prompts,
                                                    max_ctx)
    rel = err.pop("logits_rel")
    phase("mamba2_kernel_vs_recurrent", prompts=[len(p) for p in prompts],
          layers=model.cfg.num_layers, **err,
          tol_block_rel_l2=SSM_BLOCK_REL, tol_state_rel_l2=SSM_STATE_REL)
    if err["block_rel_l2"] > SSM_BLOCK_REL or \
            err["state_rel_l2"] > SSM_STATE_REL:
        raise AssertionError(f"mamba2 block routes differ: {err}")
    phase("mamba2_first_token_logits", rows=len(got_logits),
          max_rel_err=rel, tol_rel=SSM_LOGIT_REL,
          argmax_agree=sum(int(a.argmax() == b.argmax())
                           for a, b in zip(got_logits, want_logits)),
          finite=all(bool(torch.isfinite(a).all()) for a in got_logits))
    if rel > SSM_LOGIT_REL or not all(
            torch.isfinite(a).all()
            and a.shape == (model.plan.vocab_logical,)
            for a in got_logits):
        raise AssertionError(f"mamba2 first-token logits differ: {rel}")


def profile_slot_model(label, model, params, max_ctx, prefill_shares):
    """One decode step of all MAX_BATCH slots and one prefill of a
    1024-token prompt, as the engine runs them: eager, then graphed (a
    model of the SSM families; ``prefill_shares`` as ``profile``'s)."""
    rng = np.random.RandomState(3)
    cache = zoo.init_cache(model, MAX_BATCH, max_ctx, "cuda")
    toks = torch.from_numpy(rng.randint(0, model.cfg.vocab_size,
                                        size=MAX_BATCH)).cuda()
    prompt = torch.from_numpy(rng.randint(0, model.cfg.vocab_size,
                                          size=(1, 1024))).cuda()
    graphs = StepGraphs("cuda")

    def decode():
        return zoo.decode_step(model, params, cache, toks)[0]

    def prefill():
        cache1 = zoo.init_cache(model, 1, max_ctx, "cuda")
        logits, cache1 = zoo.prefill(model, params, {"tokens": prompt},
                                     cache1)
        return logits, cache1

    for suffix, dec, pre in (
            ("", decode, prefill),
            ("_graphed", lambda: graphs.run("decode", decode),
             lambda: graphs.run("prefill", prefill))):
        profile(f"{label}_decode_step{suffix}", dec, 5)
        profile(f"{label}_prefill_1024{suffix}", pre, 3,
                shares=prefill_shares)


# ---------------------------------------------------------------------------
# whisper-base: the encoder-decoder family on the slot path
# ---------------------------------------------------------------------------
WHISPER_ARCH = "whisper-base"
#: prompt lengths, chosen to cover the flash kernel's shapes and not as
#: a user's traffic: one prompt in each power-of-two bucket 8 ... 512, the
#: others drawn up to 448, the decoder's whole text context (a published
#: Whisper decoder cuts its prompt to 223 tokens)
WHISPER_PROMPTS = (8, 448)
WHISPER_BUCKETS = (8, 16, 32, 64, 128, 256, 512)
WHISPER_MAX_CTX = 1024


def whisper_requests(offset=0):
    rng = np.random.RandomState(SEED)
    lo, hi = WHISPER_PROMPTS
    lens = [lo] + [rng.randint(b // 2 + 1, min(b, hi) + 1)
                   for b in WHISPER_BUCKETS[1:]]
    lens += list(rng.randint(lo, hi + 1, size=N_REQUESTS - len(lens)))
    rng.shuffle(lens)
    return [Request(id=offset + i, arrival_time=0.0, prompt_len=int(p),
                    output_len=OUTPUT_LEN) for i, p in enumerate(lens)]


def profiled_serving(eng, reqs, prompts):
    """Serve ``reqs`` under ``torch.profiler``: the run's wall and its
    device-busy time (every kernel and copy), in seconds."""
    for r in reqs:
        eng.add_request(r, prompts.get(r.id % SET_IDS))
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in dev) / 1e6 if dev else None
    return wall, busy


def check_whisper():
    """whisper-base at full width and depth (6 encoder and 6 decoder
    layers, 1500 frames) on the slot path: the engine ``launch/serve.py``
    builds, but with ``attn_impl="pallas"``, graphed, serving 16 requests
    of 8-448 prompt tokens whose buckets reach 8 ... 512 (kernel-shape
    coverage, not a user's traffic); every prefill launches
    flash once a layer in the encoder (non-causal, 1500 x 1500) and twice
    a layer in the decoder (causal self-attention over the bucket,
    non-causal cross-attention bucket x 1500).  Then eager against
    graphed, first-token and decode-step logits of the kernel route
    against ``naive``, flash at whisper's shapes, and the profiles of a
    decode step and a 448-token prefill."""
    cfg = get_config(WHISPER_ARCH)
    t0 = time.perf_counter()
    model = zoo.build(cfg, settings=RunSettings(attn_impl="pallas"))
    params = zoo.init_params(model, seed=SEED)
    torch.cuda.synchronize()
    # the serve CLI's engine sizes (512 blocks of 16, a context of 1024)
    engine = ServingEngine(model, params, EngineConfig(
        num_blocks=512, block_size=PAGE, max_batch=MAX_BATCH,
        max_pages_per_seq=WHISPER_MAX_CTX // PAGE, seed=SEED))
    table = params["embed"]["table"]
    phase("whisper-base_init_params", model=cfg.name,
          enc_layers=cfg.n_enc_layers, dec_layers=cfg.n_dec_layers,
          d_model=cfg.d_model, n_heads=cfg.n_heads,
          n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim, d_ff=cfg.d_ff,
          vocab=cfg.vocab_size, vocab_padded=model.plan.vocab,
          enc_seq_len=cfg.enc_seq_len,
          dec_pos_rows=params["dec_pos"].shape[0], norm=cfg.norm,
          act=cfg.act, pos_emb=cfg.pos_emb,
          param_gb=sum(t.numel() * t.element_size()
                       for t in _leaves(params)) / 1e9,
          embed_table_gb=table.numel() * table.element_size() / 1e9,
          embed_table_dtype=str(table.dtype),
          seconds=time.perf_counter() - t0)

    per_prefill = cfg.n_enc_layers + 2 * cfg.n_dec_layers

    def expect_launches(run):
        n, want = run["launches"], per_prefill * len(run["buckets"])
        if n["flash_attention"] != want or n["paged_attention"] \
                or n["ssd_scan"]:
            raise AssertionError(f"whisper-base: launches {n}, expected "
                                 f"flash {per_prefill} x "
                                 f"{len(run['buckets'])} and nothing else")

    # the main path: the engine, graphed on the card
    log = instrument(engine)
    reqs = whisper_requests()
    torch.cuda.reset_peak_memory_stats()
    summary = {}
    main = serve_set(engine, reqs, {}, log, serve_fn=lambda e, rs:
                     summary.update(serve_cli.serve(e, rs)))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    prompts = dict(engine.prompt_tokens)
    spads = main["buckets"]
    # the device's idle share: one more request set (same lengths) on the
    # same engine, every step a replay, under torch.profiler
    wall_s, busy_s = profiled_serving(
        engine, whisper_requests((GRAPH_SETS + 2) * SET_IDS), prompts)
    launches = main["launches"]
    stats = {"model": cfg.name, "attn_impl": model.settings.attn_impl,
             "max_ctx": engine.max_ctx, "requests": len(reqs),
             "prompt_lens": [r.prompt_len for r in reqs],
             "finished": summary["n_finished"], **main["stats"],
             "prefill_calls": len(spads),
             "prefill_buckets": sorted(set(spads)),
             "launches": {k: launches[k] for k in
                          ("flash_attention", "paged_attention",
                           "ssd_scan")},
             "flash_launches_by_sq": launches["flash_attention_by_sq"],
             "expected_flash_launches": per_prefill * len(spads),
             "graphs": len(engine.graphs),
             "capture_s": engine.graphs.capture_seconds,
             "peak_memory_gb": peak_gb,
             "profiled_set_wall_s": wall_s,
             "profiled_set_device_busy_s": busy_s if busy_s is not None
             else "not measured",
             "idle_share": 1 - busy_s / wall_s if busy_s is not None
             else "not measured"}
    phase("whisper-base_serve_slot_path", **stats)
    if summary["n_finished"] != len(reqs):
        raise AssertionError("whisper-base: not every request finished")
    if sorted(set(spads)) != list(WHISPER_BUCKETS):
        raise AssertionError(f"whisper-base: prefill buckets "
                             f"{sorted(set(spads))}, expected "
                             f"{WHISPER_BUCKETS}")
    expect_launches(main)

    eager = ServingEngine(model, params, engine.ec, graphs=False)
    eager_vs_graphed(cfg.name, engine, log, eager, whisper_requests, prompts,
                     main, ("k", "v", "xk", "xv", "len"), expect_launches)
    del eager
    free_memory()

    vocab = model.plan.vocab_logical
    plain = model.with_settings(attn_impl="naive")
    got, got_cache = slot_states(model, params, engine, reqs, prompts)
    want, want_cache = slot_states(plain, params, engine, reqs, prompts)
    compare_logits("whisper-base_first_token_logits", got, want,
                   cfg.vocab_size)
    # one decode step on the slots each route prefilled (the decode
    # attention is the plain one on both, as in the reference)
    toks = torch.from_numpy(np.random.RandomState(1).randint(
        0, cfg.vocab_size, size=MAX_BATCH)).cuda()
    got = zoo.decode_step(model, params, got_cache, toks)[0]
    want = zoo.decode_step(plain, params, want_cache, toks)[0]
    compare_logits("whisper-base_decode_logits",
                   list(got[:, :vocab].float()),
                   list(want[:, :vocab].float()), cfg.vocab_size)
    del got_cache, want_cache
    free_memory()

    bf16, d, h = torch.bfloat16, cfg.head_dim, cfg.n_heads
    senc = cfg.enc_seq_len
    flash_case(f"whisper-base encoder non-causal S={senc}", sq=senc,
               skv=senc, h=h, hkv=h, d=d, causal=False, dtype=bf16, seed=10)
    for sq in (WHISPER_BUCKETS[0], WHISPER_BUCKETS[-1]):
        flash_case(f"whisper-base cross non-causal {sq}x{senc}", sq=sq,
                   skv=senc, h=h, hkv=h, d=d, causal=False, dtype=bf16,
                   seed=11 + sq)
    flash_case(f"whisper-base decoder causal S={WHISPER_BUCKETS[-1]}",
               sq=WHISPER_BUCKETS[-1], skv=WHISPER_BUCKETS[-1], h=h, hkv=h,
               d=d, causal=True, dtype=bf16, seed=12)
    profile_whisper(model, params, engine, reqs)
    del engine
    free_memory()
    return stats


def slot_states(model, params, engine, reqs, prompts):
    """Each request prefilled as the engine prefills it (its prompt in its
    bucket; an encoder-decoder model's frame embeddings): the first
    token's logits over the logical vocabulary, and a slot cache holding
    the first MAX_BATCH requests."""
    vocab = model.plan.vocab_logical
    cache = zoo.init_cache(model, MAX_BATCH, engine.max_ctx, "cuda")
    first = []
    for i, r in enumerate(reqs):
        p = prompts[r.id]
        plen = len(p)
        toks = torch.zeros((1, min(ServingEngine._bucket(plen),
                                   engine.max_ctx)),
                           dtype=torch.long, device="cuda")
        toks[0, :plen] = torch.from_numpy(p.astype(np.int64))
        batch = {"tokens": toks}
        if engine._embeds is not None:
            batch["embeds"] = torch.from_numpy(engine._enc_embeds(r))[None] \
                .cuda()
        cache1 = zoo.init_cache(model, 1, engine.max_ctx, "cuda")
        logits, cache1 = zoo.prefill(model, params, batch, cache1)
        first.append(logits[0, plen - 1, :vocab].float().clone())
        del logits
        if i < MAX_BATCH:
            for key, t in cache1.items():
                if key != "len":
                    cache[key][:, i] = t[:, 0]
            cache["len"][i] = plen
    return first, cache


def profile_whisper(model, params, engine, reqs):
    """One decode step of all MAX_BATCH slots and one prefill of a
    448-token prompt (bucket 512, the encoder included), as the engine
    runs them: eager, then graphed."""
    rng = np.random.RandomState(3)
    hi = WHISPER_PROMPTS[1]
    cache = zoo.init_cache(model, MAX_BATCH, engine.max_ctx, "cuda")
    cache["len"].copy_(torch.from_numpy(rng.randint(
        WHISPER_PROMPTS[0], hi + 1, size=MAX_BATCH).astype(np.int32)))
    toks = torch.from_numpy(rng.randint(0, model.cfg.vocab_size,
                                        size=MAX_BATCH)).cuda()
    prompt = torch.zeros((1, ServingEngine._bucket(hi)), dtype=torch.long,
                         device="cuda")
    prompt[0, :hi] = torch.from_numpy(rng.randint(0, model.cfg.vocab_size,
                                                  size=hi))
    embeds = torch.from_numpy(engine._enc_embeds(reqs[0]))[None].cuda()
    graphs = StepGraphs("cuda")

    def decode():
        return zoo.decode_step(model, params, cache, toks)[0]

    def prefill():
        cache1 = zoo.init_cache(model, 1, engine.max_ctx, "cuda")
        logits, cache1 = zoo.prefill(model, params, {"tokens": prompt,
                                                     "embeds": embeds},
                                     cache1)
        return logits, cache1

    for suffix, dec, pre in (
            ("", decode, prefill),
            ("_graphed", lambda: graphs.run("decode", decode),
             lambda: graphs.run("prefill", prefill))):
        profile(f"whisper-base_decode_step{suffix}", dec, 5)
        profile(f"whisper-base_prefill_{hi}{suffix}", pre, 3,
                shares={"flash_attention": FLASH_KERNELS})


# ---------------------------------------------------------------------------
# zamba2-2.7b: the hybrid family on the slot path
# ---------------------------------------------------------------------------
HYBRID_ARCH = "zamba2-2.7b"


def check_zamba2():
    """zamba2-2.7b at full width and depth (54 Mamba2 layers in 9 groups,
    each followed by the shared block, 32 heads of 80) on the slot path:
    the engine ``launch/serve.py`` builds (its sizes: 512 blocks of 16, a
    context of 1024), but with ``attn_impl="pallas"``, graphed, serving
    mamba2-130m's 16 requests of 20-990 prompt tokens (buckets on both
    SSD branches); every prefill launches flash once a group (9 times,
    head_dim 80) and, where its bucket is a multiple of the chunk (256),
    the SSD scan once a layer (54 times).  Then eager against graphed
    (the slot cache's ``conv``, ``ssd``, ``k``, ``v`` identical),
    first-token and decode-step logits of the kernel route against
    ``naive``, and the profiles of a decode step and a 1024-token
    prefill with flash's and the SSD scans' shares."""
    cfg = get_config(HYBRID_ARCH)
    args = serve_cli.parse_args(["--arch", HYBRID_ARCH, "--max-batch",
                                 str(MAX_BATCH), "--seed", str(SEED)])
    t0 = time.perf_counter()
    model = zoo.build(cfg, settings=RunSettings(attn_impl="pallas"))
    params = zoo.init_params(model, seed=SEED)
    torch.cuda.synchronize()
    engine = ServingEngine(model, params, EngineConfig(
        num_blocks=args.num_blocks, block_size=args.block_size,
        max_batch=args.max_batch,
        max_pages_per_seq=args.num_blocks // max(4, args.max_batch),
        seed=args.seed))
    groups = cfg.num_layers // cfg.attn_period
    shared = sum(t.numel() * t.element_size()
                 for t in _leaves(params["shared_attn"]))
    phase(f"{HYBRID_ARCH}_init_params", model=cfg.name,
          layers=cfg.num_layers, groups=groups, attn_period=cfg.attn_period,
          n_shared_attn=cfg.n_shared_attn, d_model=cfg.d_model,
          n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
          head_dim=cfg.head_dim, d_ff=cfg.d_ff,
          ssd_heads=model.plan.ssm_heads, ssd_head_dim=cfg.ssm.head_dim,
          d_state=cfg.ssm.d_state, chunk=cfg.ssm.chunk_size,
          vocab=cfg.vocab_size, vocab_padded=model.plan.vocab,
          param_gb=sum(t.numel() * t.element_size()
                       for t in _leaves(params)) / 1e9,
          shared_block_gb=shared / 1e9,
          slot_cache_gb=sum(t.numel() * t.element_size()
                            for t in engine.cache.values()) / 1e9,
          seconds=time.perf_counter() - t0)

    chunk = cfg.ssm.chunk_size

    def chunked(run):
        return sum(1 for s in run["buckets"] if s % chunk == 0)

    def expect_launches(run):
        n = run["launches"]
        want = {"flash_attention": groups * len(run["buckets"]),
                "ssd_scan": cfg.num_layers * chunked(run),
                "paged_attention": 0}
        if any(n[k] != v for k, v in want.items()):
            raise AssertionError(f"{HYBRID_ARCH}: launches {n}, expected "
                                 f"{want}")

    # the main path: the engine, graphed on the card
    log = instrument(engine)
    reqs = mamba_requests()
    torch.cuda.reset_peak_memory_stats()
    summary = {}
    main = serve_set(engine, reqs, {}, log, serve_fn=lambda e, rs:
                     summary.update(serve_cli.serve(e, rs)))
    spads = main["buckets"]
    launches = main["launches"]
    stats = {"model": cfg.name, "attn_impl": model.settings.attn_impl,
             "max_ctx": engine.max_ctx, "requests": len(reqs),
             "prompt_lens": [r.prompt_len for r in reqs],
             "finished": summary["n_finished"], **main["stats"],
             "prefill_calls": len(spads),
             "prefill_buckets": sorted(set(spads)),
             "chunked_prefill_calls": chunked(main),
             "launches": {k: launches[k] for k in
                          ("flash_attention", "ssd_scan", "paged_attention")},
             "flash_launches_by_sq": launches["flash_attention_by_sq"],
             "expected_flash_launches": groups * len(spads),
             "expected_ssd_launches": cfg.num_layers * chunked(main),
             "graphs": len(engine.graphs),
             "capture_s": engine.graphs.capture_seconds,
             "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    phase(f"{HYBRID_ARCH}_serve_slot_path", **stats)
    if summary["n_finished"] != len(reqs):
        raise AssertionError(f"{HYBRID_ARCH}: not every request finished")
    if chunked(main) == 0 or chunked(main) == len(spads):
        raise AssertionError(f"{HYBRID_ARCH}: prefill buckets "
                             f"{sorted(set(spads))} do not reach both SSD "
                             f"branches")
    expect_launches(main)
    prompts = dict(engine.prompt_tokens)

    eager = ServingEngine(model, params, engine.ec, graphs=False)
    eager_vs_graphed(cfg.name, engine, log, eager, mamba_requests, prompts,
                     main, ("conv", "ssd", "k", "v", "len"), expect_launches)
    del eager
    free_memory()

    vocab = model.plan.vocab_logical
    plain = model.with_settings(attn_impl="naive")
    got, got_cache = slot_states(model, params, engine, reqs, prompts)
    want, want_cache = slot_states(plain, params, engine, reqs, prompts)
    compare_logits(f"{HYBRID_ARCH}_first_token_logits", got, want,
                   cfg.vocab_size)
    # one decode step on the slots each route prefilled (the decode
    # attention is the plain one on both, as in the reference)
    toks = torch.from_numpy(np.random.RandomState(1).randint(
        0, cfg.vocab_size, size=MAX_BATCH)).cuda()
    got = zoo.decode_step(model, params, got_cache, toks)[0]
    want = zoo.decode_step(plain, params, want_cache, toks)[0]
    compare_logits(f"{HYBRID_ARCH}_decode_logits",
                   list(got[:, :vocab].float()),
                   list(want[:, :vocab].float()), cfg.vocab_size)
    del got_cache, want_cache
    free_memory()
    profile_slot_model(HYBRID_ARCH, model, params, engine.max_ctx,
                       {"flash_attention": FLASH_KERNELS,
                        "ssd_scan": SSD_KERNELS})
    del engine
    free_memory()
    return stats


#: ptxas's notes that it serialised a kernel's wgmma ("wgmma.mma_async
#: instructions are serialized due to ..."), by code
WGMMA_SERIALIZED = re.compile(r"\((C751[0-5])\)")


def wgmma_serialized(report):
    """{entry: sorted C7510-C7515 codes} of a ptxas report: a note names
    its function, or else belongs to the entry being compiled."""
    out, entry = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
        code = WGMMA_SERIALIZED.search(line)
        if code:
            named = re.search(r"function '(\S+?)'", line)
            key = named.group(1) if named else entry
            out.setdefault(key, set()).add(code.group(1))
    return {k: sorted(v) for k, v in out.items()}


def ptxas_entries(lib):
    """Each kernel of ``csrc/<lib>.cu``: registers, stack, spills and
    static shared memory as ``ptxas -v`` reported them at the build, and
    the codes of any note that its wgmma were serialised
    (``wgmma_serialized``, C7510-C7515)."""
    out = []
    report = build.ptxas_report(lib)
    serialized = wgmma_serialized(report)
    for chunk in report.split("Compiling entry function")[1:]:
        stack, stores, loads = map(int, re.search(
            r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) "
            r"bytes spill loads", chunk).groups())
        static = re.search(r"(\d+) bytes smem", chunk)
        entry = re.search(r"'(\S+)'", chunk).group(1)
        out.append({"entry": entry,
                    "registers": int(re.search(r"Used (\d+) registers",
                                               chunk).group(1)),
                    "stack_bytes": stack, "spill_store_bytes": stores,
                    "spill_load_bytes": loads,
                    "static_smem_bytes": int(static.group(1)) if static
                    else 0,
                    "wgmma_serialized": serialized.get(entry, [])})
    if not out:
        raise AssertionError(f"no kernel in the ptxas report of {lib}")
    return out


def flash_resources():
    """Per (dtype, head_dim) instance of the flash kernels and the width
    of its P·V product (bf16 and fp16: the tile width they run in; fp32:
    the rows of its Vᵀ tiles; all 64 up to head_dim 64 and 128 above):
    ``ptxas_entries`` and the dynamic shared memory a block takes."""
    lib = build.load("flash_attention")
    lib.flash_attention_smem_bytes.argtypes = [ctypes.c_int] * 2
    out = []
    for e in ptxas_entries("flash_attention"):
        name = e.pop("entry")
        half = re.search(r"flash_kernelI(\w+?)Li(\d+)ELi(\d+)E", name)
        fp32 = re.search(r"flash_fp32_kernelILi(\d+)E", name)
        # the wide twins: one kernel a type for head_dims 144 to 256
        half_wide = re.search(r"flash_kernel_wideI(\w+?)E", name)
        if half:
            dtype, code = (("bfloat16", 1) if "bfloat16" in half.group(1)
                           else ("float16", 2))
            tile, d = int(half.group(2)), int(half.group(3))
        elif fp32:
            dtype, code, d = "float32", 0, int(fp32.group(1))
            tile = 64 if d <= 64 else 128
        elif half_wide:
            dtype, code = (("bfloat16", 1) if "bfloat16" in
                           half_wide.group(1) else ("float16", 2))
            tile, d = 256, "144-256"
        elif "flash_fp32_kernel_wide" in name:
            dtype, code, tile, d = "float32", 0, 256, "144-256"
        else:
            continue
        out.append({"dtype": dtype, "head_dim": d, "tile_d": tile, **e,
                    "dynamic_smem_bytes": lib.flash_attention_smem_bytes(
                        code, d if tile <= 128 else WIDE_HEAD_DIM)})
    if not out:
        raise AssertionError("no flash kernel in the ptxas report")
    return out


def paged_resources():
    """Per (dtype, head_dim, q heads a block, chunked) instance of the
    paged kernel (chunked: a group above 8, in chunks of ``group`` q
    heads): ``ptxas_entries`` (its shared memory is all static)."""
    out = []
    for e in ptxas_entries("paged_attention"):
        m = re.search(r"paged_attn_kernelI(\w+?)Li(\d+)ELi(\d+)ELb([01])E",
                      e.pop("entry"))
        if m:
            t = m.group(1)
            d = int(m.group(2))
            out.append({"dtype": "bfloat16" if "bfloat16" in t else
                        "float16" if "half" in t else "float32",
                        # the D-256 shape takes every head_dim from 144
                        "head_dim": d if d <= 128 else f"144-{d}",
                        "group": int(m.group(3)),
                        "chunked": m.group(4) == "1", **e})
    if not out:
        raise AssertionError("no paged kernel in the ptxas report")
    return out


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


#: the blocked-route check: stablelm-3b's head_dim 80 at a prompt that
#: ``auto`` sends to ``blocked``
BLOCKED_ARCH = "stablelm-3b"
BLOCKED_PROMPT = 4096


def check_blocked_prefill(params):
    """One ``BLOCKED_PROMPT``-token prompt through the full-size
    ``BLOCKED_ARCH`` (weights ``params``, those its paged-path phases
    served) with the default settings (``auto``, which resolves to
    ``blocked`` past ``naive_attn_max_seq``) and with ``naive``: the
    last position's logits, and the greedy token of every position."""
    cfg = get_config(BLOCKED_ARCH)
    model = zoo.build(cfg)
    if model.settings.resolve_attn(BLOCKED_PROMPT) != "blocked":
        raise AssertionError("auto does not resolve to blocked at "
                             f"{BLOCKED_PROMPT} tokens")
    naive = model.with_settings(attn_impl="naive")
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    toks = torch.randint(0, cfg.vocab_size, (1, BLOCKED_PROMPT),
                         generator=gen, device="cuda")
    vocab = model.plan.vocab_logical
    out = {}
    for label, m in (("blocked", model), ("naive", naive)):
        zoo.forward(m, params, {"tokens": toks})    # warm-up
        launch_counts.reset()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        logits, _ = zoo.forward(m, params, {"tokens": toks})
        torch.cuda.synchronize()
        out[label] = {"logits": logits[0, :, :vocab].float(),
                      "wall_ms": (time.perf_counter() - t0) * 1e3,
                      "peak_memory_gb":
                          torch.cuda.max_memory_allocated() / 1e9,
                      "launches": launch_counts.snapshot()}
        del logits
    got, want = out["blocked"]["logits"], out["naive"]["logits"]
    if not (torch.isfinite(got).all() and got.shape == want.shape
            == (BLOCKED_PROMPT, vocab)):
        raise AssertionError("blocked prefill logits not finite or "
                             "misshapen")
    last_err = float((got[-1] - want[-1]).abs().max())
    rel = last_err / float(want[-1].abs().max())
    greedy_same = (got.argmax(-1) == want.argmax(-1))
    rec = {"model": cfg.name, "layers": cfg.num_layers,
           "d_model": cfg.d_model, "n_heads": cfg.n_heads,
           "head_dim": cfg.head_dim, "dtype": cfg.dtype,
           "param_gb": n_bytes / 1e9, "prompt": BLOCKED_PROMPT,
           "attn_impl": model.settings.attn_impl,
           "resolved": model.settings.resolve_attn(BLOCKED_PROMPT),
           "blocks": [model.settings.attn_block_q,
                      model.settings.attn_block_kv],
           "last_max_abs_err": last_err, "last_rel_err": rel,
           "tol_rel": LOGIT_REL_MAX,
           "last_logit_scale": float(want[-1].abs().max()),
           "last_greedy_agree": bool(greedy_same[-1]),
           "greedy_agree_share": float(greedy_same.float().mean()),
           **{f"{k}_{f}": out[k][f] for k in out
              for f in ("wall_ms", "peak_memory_gb")},
           "blocked_kernel_launches": {str(k): n for k, n in
                                       out["blocked"]["launches"].items()
                                       if n}}
    phase("stablelm_3b_blocked_prefill", **rec)
    if rel > LOGIT_REL_MAX:
        raise AssertionError(f"blocked prefill logits differ from naive: "
                             f"{rel} of the largest logit")
    if rec["blocked_kernel_launches"]:
        raise AssertionError("the blocked route launched a kernel: "
                             f"{rec['blocked_kernel_launches']}")


#: the simulator check: the reference CLI's arguments
# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------
TRAIN_ARCH = "llama2-7b"
#: depth of the llama2-7b training phase, of 32 layers: fp32 master
#: weights, gradients, mu and nu take 16 bytes a parameter, 108 GB for
#: the whole model; at 8 layers (1.88 B parameters) they take 30 GB
TRAIN_LAYERS = 8
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 512, 10
MAMBA_TRAIN_ARGS = ("--arch", "mamba2-130m", "--steps", "10", "--seq-len",
                    "1024", "--batch", "4")
#: substrings of cuBLAS's GEMM kernel names on Hopper
GEMM_KERNELS = ("gemm", "nvjet", "xmma", "cutlass")
#: the SSD wrapper's gradients against the plain version's, each input's
#: largest error over its largest gradient
SSD_GRAD_REL = 1e-4
LM100M_STEPS, LM100M_SAVE_EVERY, LM100M_MORE = 20, 10, 5


def _finite(history, key):
    return all(np.isfinite(h[key]) for h in history)


def timed_steps(trainer, steps):
    """Run ``steps`` steps one at a time: each step's wall (host clock;
    the step ends on the host reading its metrics) and its device time
    and the optimizer's (``adamw_update``) from CUDA events, and the
    kernel launches each step made."""
    records = []
    real_update = train_step_mod.adamw_update

    def timed_update(*args, **kw):
        ev[1].record()
        out = real_update(*args, **kw)
        ev[2].record()
        return out

    train_step_mod.adamw_update = timed_update
    try:
        for _ in range(steps):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            before = launch_counts.snapshot()
            t0 = time.perf_counter()
            ev[0].record()
            trainer.run(1, log=None)
            ev[3].record()
            wall = time.perf_counter() - t0
            torch.cuda.synchronize()
            after = launch_counts.snapshot()
            records.append({
                "wall_s": wall, "device_ms": ev[0].elapsed_time(ev[3]),
                "optimizer_ms": ev[1].elapsed_time(ev[2]),
                "launches": {k: n - before.get(k, 0)
                             for k, n in after.items()
                             if isinstance(k, str)},
                **trainer.history[-1]})
    finally:
        train_step_mod.adamw_update = real_update
    return records


def train_summary(trainer, records, tokens_per_step):
    """Step wall (mean and median), tokens/s and MFU (6 N tokens / mean
    wall / the bf16 peak) over the steps after the first, the
    optimizer's share of their device time, peak memory and the loss
    curve."""
    n = zoo.param_count(trainer.params)
    warm = records[1:] or records
    wall = sum(r["wall_s"] for r in warm) / len(warm)
    opt = sum(r["optimizer_ms"] for r in warm)
    return {"params": n, "tokens_per_step": tokens_per_step,
            "step_wall_s": [r["wall_s"] for r in records],
            "mean_step_wall_s": wall,
            "median_step_wall_s": float(np.median(
                [r["wall_s"] for r in warm])),
            "tokens_per_s": tokens_per_step / wall,
            "mfu": 6 * n * tokens_per_step / wall
            / PEAK_FLOPS_S[torch.bfloat16],
            "step_device_ms": [r["device_ms"] for r in records],
            "optimizer_ms": [r["optimizer_ms"] for r in records],
            "optimizer_share": opt / sum(r["device_ms"] for r in warm),
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "loss": [r["loss"] for r in records],
            "grad_norm": [r["grad_norm"] for r in records],
            "lr": [r["lr"] for r in records]}


def require_learning(label, history):
    if not (_finite(history, "loss") and _finite(history, "grad_norm")):
        raise AssertionError(f"{label}: a loss or grad norm is not finite")
    if not history[-1]["loss"] < history[0]["loss"]:
        raise AssertionError(f"{label}: the loss went from "
                             f"{history[0]['loss']} to {history[-1]['loss']}")


def check_llama_training():
    """llama2-7b at full width, cut to TRAIN_LAYERS layers, through
    ``Trainer`` (B 8, S 512, remat full, lr 3e-4, warmup 2)."""
    cfg = dataclasses.replace(get_config(TRAIN_ARCH),
                              num_layers=TRAIN_LAYERS)
    model = zoo.build(cfg, settings=RunSettings(remat="full"))
    tc = TrainConfig(opt=AdamWConfig(lr=3e-4, warmup_steps=2,
                                     total_steps=TRAIN_STEPS))
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                    global_batch=TRAIN_BATCH, seed=SEED)
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(model, tc, dc, seed=SEED)
    records = timed_steps(trainer, TRAIN_STEPS)
    rec = train_summary(trainer, records, TRAIN_BATCH * TRAIN_SEQ)
    phase(f"{TRAIN_ARCH}_train_{TRAIN_LAYERS}_layers", model=cfg.name,
          layers=f"{TRAIN_LAYERS} of {get_config(TRAIN_ARCH).num_layers}",
          d_model=cfg.d_model, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
          remat="full", attn=model.settings.resolve_attn(TRAIN_SEQ),
          master_dtype=cfg.param_dtype, **rec)
    require_learning(TRAIN_ARCH, trainer.history)
    profile(f"{TRAIN_ARCH}_train_step", lambda: trainer.run(1, log=None), 2,
            shares={"gemm": GEMM_KERNELS})
    del trainer
    free_memory()
    return rec


def check_mamba_training():
    """mamba2-130m whole through the training CLI's ``build_trainer``:
    every step must launch the SSD scan once a layer in the forward and
    once more a layer in remat's recompute."""
    args = train_cli.parse_args(list(MAMBA_TRAIN_ARGS))
    trainer = train_cli.build_trainer(args)
    cfg = trainer.model.cfg
    if args.seq_len % cfg.ssm.chunk_size:
        raise AssertionError("the sequence must be a multiple of the chunk "
                             "for the SSD kernel to run")
    per_pass = cfg.num_layers
    expected = per_pass * (2 if args.remat != "none" else 1)
    torch.cuda.reset_peak_memory_stats()
    launch_counts.reset()
    records = timed_steps(trainer, args.steps)
    launches = launch_counts.snapshot()
    rec = train_summary(trainer, records, args.batch * args.seq_len)
    per_step = [r["launches"].get("ssd_scan", 0) for r in records]
    phase("mamba2-130m_train", model=cfg.name, layers=cfg.num_layers,
          cli=" ".join(MAMBA_TRAIN_ARGS), remat=args.remat,
          ssd_scan_per_step=per_step,
          ssd_scan_expected_per_step=f"{per_pass} forward + {per_pass} "
          f"recomputed = {expected}", launches=launches, **rec)
    if per_step != [expected] * args.steps:
        raise AssertionError(f"SSD scan launches per step {per_step}, "
                             f"expected {expected} each")
    require_learning("mamba2-130m", trainer.history)
    profile("mamba2-130m_train_step", lambda: trainer.run(1, log=None), 2,
            shares={"ssd_scan": SSD_KERNELS, "gemm": GEMM_KERNELS})
    del trainer
    free_memory()
    return launches.get("ssd_scan", 0)


def ssd_grad_case(name, b, s, h, p, g, n, chunk, with_state, seed):
    """Gradients of a seeded scalar of (y, final state) through the
    wrapper (kernel forward, plain recompute for the backward) against
    ``torch.autograd.grad`` through ``ssd_chunked_ref``, on the card."""
    xbar, dA_log, Bm, Cm, state0 = ssd_inputs(
        b, s, h, p, g, n, bc_dtype=torch.bfloat16, strided=True,
        with_state=with_state, model_decay=True, seed=seed)
    inputs = [t.detach().requires_grad_() if t is not None else None
              for t in (xbar, dA_log, Bm, Cm, state0)]
    wanted = [t for t in inputs if t is not None]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    wy = torch.randn(b, s, h, p, generator=gen, device="cuda")
    wf = torch.randn(b, h, n, p, generator=gen, device="cuda")

    def scalar(y, fs):
        return (y * wy).sum() + (fs * wf).sum()

    def kernel_grads():
        y, fs = ssd_ops.ssd_scan(*inputs[:4], chunk=chunk, state0=inputs[4])
        return torch.autograd.grad(scalar(y, fs), wanted)

    def plain_grads():
        y, fs = ssd_ops.ssd_chunked_ref(*inputs[:4], chunk, inputs[4])
        return torch.autograd.grad(scalar(y, fs), wanted)

    before = launch_counts.get("ssd_scan")
    got, want = kernel_grads(), plain_grads()
    launched = launch_counts.get("ssd_scan") - before
    errs = {nm: float((a.float() - w.float()).abs().max()
                      / w.float().abs().max().clamp_min(1e-30))
            for nm, a, w in zip(("xbar", "dA_log", "B", "C", "state0"),
                                got, want)}
    with torch.no_grad():
        fwd_ms = time_ms(lambda: ssd_ops.ssd_scan(
            *inputs[:4], chunk=chunk, state0=inputs[4]), 10)
    rec = {"shape": dict(b=b, s=s, h=h, p=p, g=g, n=n, chunk=chunk),
           "state0": with_state, "kernel_launches": launched,
           "grad_rel_err": errs, "limit": SSD_GRAD_REL,
           "max_grad_rel_err": max(errs.values()),
           "kernel_forward_ms": fwd_ms,
           "kernel_forward_plain_backward_ms": time_ms(kernel_grads, 5),
           "plain_forward_backward_ms": time_ms(plain_grads, 5)}
    phase("ssd_scan_grad", case=name, **rec)
    if launched != 1 or any(not g.isfinite().all() for g in got):
        raise AssertionError(f"ssd_scan_grad {name}: {launched} launches "
                             "or a gradient not finite")
    if rec["max_grad_rel_err"] > SSD_GRAD_REL:
        raise AssertionError(f"ssd_scan_grad {name}: {errs} over "
                             f"{SSD_GRAD_REL}")


def _state_copy(trainer):
    return [t.clone() for t in tree_leaves(trainer._state_tree())]


def _max_diff(a, b):
    return max(float((x.double() - y.double()).abs().max())
               for x, y in zip(a, b))


def check_lm100m_restart():
    """The 100M example (``repro_torch.examples.train_100m``: 12 layers,
    d 768, S 256, B 8, microbatches 2) for 20 steps, saving every 10; a
    new ``Trainer`` on the same directory restores step 20 bit for bit
    and its next 5 steps equal those of the run that went on; then a
    few steps with int8 gradient compression."""
    out = Path(__file__).resolve().parent / "build" / "repro_torch_train"
    ckpt = out / "lm-100m"
    shutil.rmtree(ckpt, ignore_errors=True)
    total = LM100M_STEPS + LM100M_MORE
    tc = dataclasses.replace(ex100m.train_config(total, str(ckpt)),
                             checkpoint_every=LM100M_SAVE_EVERY)
    dc = ex100m.data_config(8, 256)
    model = zoo.build(ex100m.CFG_100M)
    torch.cuda.reset_peak_memory_stats()
    first = Trainer(model, tc, dc, seed=SEED)
    records = timed_steps(first, LM100M_STEPS)
    first.ckpt.wait()
    at_save = _state_copy(first)
    more = timed_steps(first, LM100M_MORE)
    rec = train_summary(first, records + more, 8 * 256)
    second = Trainer(model, tc, dc, seed=SEED + 1)
    restored = _state_copy(second)
    exact = len(restored) == len(at_save) and all(
        torch.equal(a, b) for a, b in zip(restored, at_save))
    second.run(LM100M_MORE, log=None)
    cont = _max_diff(_state_copy(second), _state_copy(first))
    losses = ([h["loss"] for h in first.history[-LM100M_MORE:]],
              [h["loss"] for h in second.history])
    del first, second
    free_memory()
    comp = Trainer(model, dataclasses.replace(
        tc, grad_compression=True, checkpoint_dir=None), dc, seed=SEED)
    comp.run(3, log=None)
    phase("lm-100m_train_restart", model=ex100m.CFG_100M.name,
          saved_steps=sorted(os.listdir(ckpt)), restored_step=LM100M_STEPS,
          restored_bit_for_bit=exact,
          continued_max_abs_diff=cont, continued_bit_for_bit=cont == 0.0,
          continued_losses=losses[0], restored_run_losses=losses[1],
          grad_compression_loss=[h["loss"] for h in comp.history], **rec)
    if not exact:
        raise AssertionError("the restored state differs from the saved")
    if cont > 1e-6:
        raise AssertionError(f"the restored run drifts by {cont}")
    require_learning("lm-100m", records + more)
    if not _finite(comp.history, "loss"):
        raise AssertionError("a loss with grad compression is not finite")
    del comp
    free_memory()


def check_grad_refusals():
    """Flash and paged under grad raise on the card, as does
    ``attend(impl="pallas")``; under no_grad they launch."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    q = torch.randn(1, 128, 8, 64, generator=gen, device="cuda",
                    dtype=torch.bfloat16).requires_grad_()
    k = torch.randn(1, 128, 8, 64, generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    pages = torch.randn(4, PAGE, 8, 64, generator=gen, device="cuda",
                        dtype=torch.bfloat16)
    tables = torch.arange(4, dtype=torch.int32, device="cuda")[None]
    lens = torch.tensor([50], dtype=torch.int32, device="cuda")
    calls = {
        "flash_attention": lambda: flash_ops.flash_attention(q, k, k),
        "attend_pallas": lambda: attention_impl.attend(
            q, k, k, causal=True, impl="pallas"),
        "paged_attention": lambda: paged_ops.paged_attention(
            q[:, 0], pages, pages, tables, lens)}
    refused = {}
    for name, call in calls.items():
        try:
            call()
            refused[name] = None
        except RuntimeError as e:
            refused[name] = str(e)
    with torch.no_grad():
        for call in calls.values():
            call()
    phase("grad_refusals", refused=refused)
    if any(v is None or "no backward" not in v for v in refused.values()):
        raise AssertionError(f"a kernel route took a grad call: {refused}")


def check_training():
    """The training phases; returns the SSD-scan launches of
    mamba2-130m's training run and the llama2-7b phase's record."""
    llama = check_llama_training()
    ssd = check_mamba_training()
    ssd_grad_case("mamba2-130m prefill shape", 1, 1024, 24, 64, 1, 128, 256,
                  with_state=False, seed=11)
    ssd_grad_case("zamba2-2.7b prefill shape", 1, 1024, 80, 64, 1, 64, 256,
                  with_state=True, seed=12)
    check_lm100m_restart()
    check_grad_refusals()
    return ssd, llama


# ---------------------------------------------------------------------------
# The sharding plan on one card (a 1 x 1 mesh)
# ---------------------------------------------------------------------------
#: llama2-7b's sharded serving phase: one prefill of B x S, then decode
#: steps on the unsharded run's greedy tokens
SHARDED_BATCH, SHARDED_SEQ, SHARDED_DECODE = 8, 1024, 32
SHARDED_TRAIN_STEPS = 3
#: mamba2-130m's sharded prefill: B x S, S a multiple of the chunk
SHARDED_SSM_BATCH, SHARDED_SSM_SEQ = 8, 1024
#: sharded against unsharded on one card, largest |difference| over the
#: unsharded run's largest |value| (logits), or relative (losses): on a
#: 1 x 1 mesh every shard is the whole tensor and each op runs the same
#: kernel on it, so a sound plan reads 0 or rounding; a lost or doubled
#: shard, or a boundary that hands a kernel the wrong heads, reads the
#: values' own size
SHARDED_REL = 1e-3


def _one_rank_group():
    """A one-rank NCCL group on the card (the mesh's world)."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", rank=0, world_size=1,
                            init_method=f"tcp://127.0.0.1:{port}")


def _full(x):
    return x.full_tensor() if isinstance(x, DTensor) else x


def _rel(got, want):
    return float((_full(got).float() - want.float()).abs().max()
                 / want.float().abs().max().clamp_min(1e-30))


def _wall(fn):
    """(result, host seconds) of ``fn`` ending in a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _serve_run(model, params, cache, tokens, decode_tokens, place=None):
    """A prefill (run twice, the second timed) and one decode step for
    each of ``decode_tokens`` (None: the greedy tokens of this run); with
    ``place`` each token vector is placed by it first.  Returns the
    prefill's logits, every decode step's logits, the
    tokens fed, the prefill wall and the decode walls."""
    zoo.prefill(model, params, {"tokens": tokens}, cache)
    (logits, cache), prefill_s = _wall(lambda: zoo.prefill(
        model, params, {"tokens": tokens}, cache))
    first = _full(logits)
    del logits
    tok = first[:, -1].argmax(-1)
    steps, fed, walls = [], [], []
    for i in range(SHARDED_DECODE):
        if decode_tokens is not None:
            tok = decode_tokens[i]
        fed.append(tok)
        arg = tok if place is None else place(tok)
        (logits, cache), wall = _wall(lambda: zoo.decode_step(
            model, params, cache, arg))
        walls.append(wall)
        logits = _full(logits).float()
        steps.append(logits)
        tok = logits.argmax(-1)
    return first, steps, fed, prefill_s, walls


def check_sharded_serving(mesh):
    """llama2-7b at full width and depth with ``attn_impl="pallas"``: a
    prefill of SHARDED_BATCH x SHARDED_SEQ and SHARDED_DECODE decode
    steps, unsharded, then with the weights, cache and tokens placed by
    the plan under its rules; the flash launches of the sharded run, the
    logits against the unsharded run's, and the walls."""
    cfg = get_config("llama2-7b")
    model = zoo.build(cfg, settings=RunSettings(attn_impl="pallas"))
    params = zoo.init_params(model, seed=SEED)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    tokens = torch.randint(0, cfg.vocab_size,
                           (SHARDED_BATCH, SHARDED_SEQ), generator=gen,
                           device="cuda")
    max_len = SHARDED_SEQ + SHARDED_DECODE
    cache = zoo.init_cache(model, SHARDED_BATCH, max_len)
    first, steps, fed, prefill_s, walls = _serve_run(
        model, params, cache, tokens, None)
    del cache
    free_memory()

    rules = shard_plan.default_rules()
    dparams = shard_plan.distribute(params, mesh,
                                    shard_plan.param_pspecs(model))
    del params
    dcache = shard_plan.distribute(
        zoo.init_cache(model, SHARDED_BATCH, max_len), mesh,
        shard_plan.cache_pspecs(model, rules))
    dtokens = distribute_tensor(tokens, mesh, placements(
        mesh, rules.spec("batch", "seq")))
    batch_placed = placements(mesh, rules.spec("batch"))
    with use_rules(mesh, rules):
        launch_counts.reset()
        got_first, got_steps, _, sh_prefill_s, sh_walls = _serve_run(
            model, dparams, dcache, dtokens, fed,
            place=lambda t: distribute_tensor(t, mesh, batch_placed))
        flash = launch_counts.get("flash_attention")
    errs = [_rel(got_first, first)] + [_rel(g, w)
                                       for g, w in zip(got_steps, steps)]
    exact = torch.equal(got_first, first) and all(
        torch.equal(g, w) for g, w in zip(got_steps, steps))
    rec = {"model": cfg.name, "layers": cfg.num_layers, "mesh": "1 x 1",
           "attn_impl": "pallas", "batch": SHARDED_BATCH,
           "seq": SHARDED_SEQ, "decode_steps": SHARDED_DECODE,
           "flash_launches": flash,
           "flash_expected": 2 * cfg.num_layers,
           "max_rel_err": max(errs), "prefill_rel_err": errs[0],
           "decode_rel_err": errs[1:], "limit": SHARDED_REL,
           "bit_for_bit": exact,
           "prefill_wall_ms": 1e3 * sh_prefill_s,
           "unsharded_prefill_wall_ms": 1e3 * prefill_s,
           "decode_wall_ms_mean": 1e3 * float(np.mean(sh_walls[1:])),
           "unsharded_decode_wall_ms_mean": 1e3 * float(np.mean(walls[1:])),
           "decode_wall_ms": [1e3 * w for w in sh_walls],
           "unsharded_decode_wall_ms": [1e3 * w for w in walls],
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    phase("llama2-7b_sharded_serve", **rec)
    check_dryrun_counters(model, dparams, dcache, mesh, rules)
    del dparams, dcache
    free_memory()
    if flash != 2 * cfg.num_layers:
        raise AssertionError(f"sharded prefills launched flash {flash} "
                             f"times, expected {2 * cfg.num_layers}")
    if not max(errs) <= SHARDED_REL:
        raise AssertionError(f"sharded logits differ by {max(errs)}")
    return flash


def _meta_like(x):
    """A meta DTensor of ``x``'s local shape, dtype and placements."""
    return DTensor.from_local(
        torch.empty(x.to_local().shape, dtype=x.dtype, device="meta"),
        x.device_mesh, x.placements, run_check=False,
        shape=x.shape, stride=x.stride())


def check_dryrun_counters(model, dparams, dcache, mesh, rules):
    """The dry run's counters (``launch.dryrun.measure``) on one sharded
    decode step of SHARDED_BATCH rows against the cache of the phase
    before: on meta tensors of the same local shapes and placements (what
    the dry run traces), then on the card's tensors, the weights loaded.
    The two FLOP counts must be equal, and so must the argument bytes and
    the bytes of the placed tensors; the temp estimate is printed beside
    the card's peak less the arguments."""
    tokens = distribute_tensor(
        torch.zeros(SHARDED_BATCH, dtype=torch.int32, device="cuda"), mesh,
        placements(mesh, rules.spec("batch")))
    args = (dparams, dcache, tokens)
    step = dryrun.serve_step(model)
    meta_args = tuple(tree_map(_meta_like, a) if isinstance(a, dict)
                      else _meta_like(a) for a in args)
    with torch.no_grad():
        _, meta_mem, meta_cost, meta_coll, meta_s, _ = dryrun.measure(
            step, meta_args, mesh=mesh, rules=rules)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        (logits, _), mem, cost, coll, wall, _ = dryrun.measure(
            step, args, mesh=mesh, rules=rules)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
    placed = sum(x.to_local().numel() * x.to_local().element_size()
                 for a in args for x in tree_leaves(
                     a if isinstance(a, dict) else {"x": a}))
    finite = bool(torch.isfinite(
        logits.to_local()[:, :model.cfg.vocab_size]).all())
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    phase("llama2-7b_dryrun_counters", model=model.cfg.name, mesh="1 x 1",
          batch=SHARDED_BATCH,
          cache_len=int(dcache["len"].to_local().max()),
          card=card, flops_meta=meta_cost["flops"], flops_card=cost["flops"],
          bytes_accessed_meta=meta_cost["bytes accessed"],
          bytes_accessed_card=cost["bytes accessed"],
          transcendentals_meta=meta_cost["transcendentals"],
          transcendentals_card=cost["transcendentals"],
          argument_bytes_meta=meta_mem["argument_size_in_bytes"],
          argument_bytes_card=mem["argument_size_in_bytes"],
          placed_tensor_bytes=placed,
          output_bytes_meta=meta_mem["output_size_in_bytes"],
          output_bytes_card=mem["output_size_in_bytes"],
          temp_bytes_meta=meta_mem["temp_size_in_bytes"],
          temp_bytes_card=mem["temp_size_in_bytes"],
          card_peak_less_arguments=peak - placed,
          card_peak_over_allocated_before=peak - before,
          collectives_meta=meta_coll, collectives_card=coll,
          trace_s_meta=meta_s, step_s_card=wall, logits_finite=finite)
    if meta_cost["flops"] != cost["flops"] or not cost["flops"] > 0:
        raise AssertionError(f"the dry run's FLOPs on meta tensors, "
                             f"{meta_cost['flops']}, differ from the "
                             f"card's step's, {cost['flops']}")
    if not (meta_mem["argument_size_in_bytes"]
            == mem["argument_size_in_bytes"] == placed):
        raise AssertionError(f"argument bytes {meta_mem} / {mem} against "
                             f"{placed} placed")
    if not finite:
        raise AssertionError("the counted decode step's logits are not "
                             "finite")


def check_sharded_training(mesh, unsharded):
    """llama2-7b cut to TRAIN_LAYERS layers through ``Trainer`` with the
    state placed by the plan (``shardings``) and each batch placed under
    its rules: SHARDED_TRAIN_STEPS steps from the unsharded phase's seed,
    its losses held to that phase's first ones."""
    cfg = dataclasses.replace(get_config(TRAIN_ARCH),
                              num_layers=TRAIN_LAYERS)
    model = zoo.build(cfg, settings=RunSettings(remat="full"))
    tc = TrainConfig(opt=AdamWConfig(lr=3e-4, warmup_steps=2,
                                     total_steps=TRAIN_STEPS))
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                    global_batch=TRAIN_BATCH, seed=SEED)
    specs = {"params": shard_plan.param_pspecs(model),
             "opt": shard_plan.opt_pspecs(model),
             "ef": shard_plan.ef_pspecs(model, tc.grad_compression)}
    torch.cuda.reset_peak_memory_stats()
    with use_rules(mesh, shard_plan.default_rules()):
        trainer = Trainer(model, tc, dc, seed=SEED,
                          shardings=shard_plan.named(mesh, specs))
        records = timed_steps(trainer, SHARDED_TRAIN_STEPS)
    rec = train_summary(trainer, records, TRAIN_BATCH * TRAIN_SEQ)
    want = unsharded["loss"][:SHARDED_TRAIN_STEPS]
    errs = [abs(a - b) / abs(b) for a, b in zip(rec["loss"], want)]
    sharded = all(isinstance(x, DTensor)
                  for x in tree_leaves(trainer._state_tree()))
    phase(f"{TRAIN_ARCH}_sharded_train_{TRAIN_LAYERS}_layers",
          model=cfg.name, mesh="1 x 1", batch=TRAIN_BATCH, seq=TRAIN_SEQ,
          steps=SHARDED_TRAIN_STEPS, state_on_mesh=sharded,
          loss_rel_err=errs, limit=SHARDED_REL,
          unsharded_loss=want, unsharded_step_wall_s=unsharded[
              "step_wall_s"][:SHARDED_TRAIN_STEPS],
          unsharded_mean_step_wall_s=unsharded["mean_step_wall_s"],
          unsharded_peak_gb=unsharded["peak_gb"], **rec)
    del trainer
    free_memory()
    if not sharded:
        raise AssertionError("the trainer's state is not on the mesh")
    if not max(errs) <= SHARDED_REL:
        raise AssertionError(f"sharded losses {rec['loss']} against {want}")


def check_sharded_ssm(mesh):
    """mamba2-130m whole: a prefill of SHARDED_SSM_BATCH x SHARDED_SSM_SEQ
    (the SSD kernel once a layer), unsharded and under the plan; the SSD
    launches of the sharded prefill, logits and states against the
    unsharded ones, and the walls."""
    cfg = get_config("mamba2-130m")
    model = zoo.build(cfg)
    params = zoo.init_params(model, seed=SEED)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    tokens = torch.randint(0, cfg.vocab_size,
                           (SHARDED_SSM_BATCH, SHARDED_SSM_SEQ),
                           generator=gen, device="cuda")
    b, s = tokens.shape

    def prefill(p, cache, toks):
        zoo.prefill(model, p, {"tokens": toks}, cache)
        return _wall(lambda: zoo.prefill(model, p, {"tokens": toks},
                                         cache))

    (want, cache), wall = prefill(params, zoo.init_cache(model, b, s),
                                  tokens)
    rules = shard_plan.default_rules()
    dparams = shard_plan.distribute(params, mesh,
                                    shard_plan.param_pspecs(model))
    dcache = shard_plan.distribute(zoo.init_cache(model, b, s), mesh,
                                   shard_plan.cache_pspecs(model, rules))
    dtokens = distribute_tensor(tokens, mesh, placements(
        mesh, rules.spec("batch", "seq")))
    with use_rules(mesh, rules):
        launch_counts.reset()
        (got, dcache), sh_wall = prefill(dparams, dcache, dtokens)
        ssd = launch_counts.get("ssd_scan")
    errs = {"logits": _rel(got, want),
            "conv": _rel(dcache["conv"], cache["conv"]),
            "ssd": _rel(dcache["ssd"], cache["ssd"])}
    phase("mamba2-130m_sharded_prefill", model=cfg.name, mesh="1 x 1",
          batch=b, seq=s, chunk=cfg.ssm.chunk_size, ssd_launches=ssd,
          ssd_expected=2 * cfg.num_layers, rel_err=errs,
          limit=SHARDED_REL,
          bit_for_bit=torch.equal(_full(got), want),
          prefill_wall_ms=1e3 * sh_wall, unsharded_prefill_wall_ms=1e3 * wall)
    del params, dparams, cache, dcache
    free_memory()
    if ssd != 2 * cfg.num_layers:
        raise AssertionError(f"the sharded prefills launched the SSD scan "
                             f"{ssd} times, expected {2 * cfg.num_layers}")
    if not max(errs.values()) <= SHARDED_REL:
        raise AssertionError(f"sharded mamba2-130m prefill differs: {errs}")
    return ssd


def check_sharded(unsharded_training):
    """The sharded phases, each on a 1 x 1 mesh of a one-rank NCCL group
    under ``default_rules()``; returns the flash and SSD-scan launches of
    their runs."""
    _one_rank_group()
    try:
        mesh = make_host_mesh()
        with torch.no_grad():
            flash = check_sharded_serving(mesh)
        check_sharded_training(mesh, unsharded_training)
        with torch.no_grad():
            ssd = check_sharded_ssm(mesh)
    finally:
        dist.destroy_process_group()
    return flash, ssd


SIM_ARGS = ("--arch", "llama2-7b", "--hw", "A100", "--requests", "1000",
            "--qps", "8", "--seed", "0")
#: the simulator-only examples (``python -m repro_torch.examples.<name>``)
#: and the lines each prints (tests/test_torch_examples.py holds them to
#: the reference's, line for line)
SIM_EXAMPLES = {"quickstart": 19, "multi_tenant": 10,
                "disaggregated_serving": 9, "speculative": 4,
                "observability": 25}
WALL_FIGURE = re.compile(r"in \d+\.\d+s wall")


def check_simulator_examples():
    """Run each simulator-only example's ``main()`` in this process, on
    the card's host, in a directory of the build tree (``observability``
    writes ``results/obs/`` under the working directory): its wall, its
    lines (the wall figure masked), which must be as many as the
    reference's, and ``observability``'s two files."""
    out_dir = Path(__file__).resolve().parent / "build" / \
        "repro_torch_examples"
    out_dir.mkdir(parents=True, exist_ok=True)
    walls = {}
    for name, n_lines in SIM_EXAMPLES.items():
        module = importlib.import_module(f"repro_torch.examples.{name}")
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.chdir(out_dir), contextlib.redirect_stdout(buf):
            module.main()
        walls[name] = time.perf_counter() - t0
        lines = WALL_FIGURE.sub("in <wall>s wall", buf.getvalue()).splitlines()
        files = {}
        if name == "observability":
            obs = out_dir / module.OUT_DIR
            files = {f: (obs / f).stat().st_size
                     for f in ("example_trace.json",
                               "example_timeseries.csv")}
        phase(f"simulator_example_{name}", seconds=walls[name],
              lines=lines, files_bytes=files)
        if len(lines) != n_lines:
            raise AssertionError(f"example {name} printed {len(lines)} "
                                 f"lines, expected {n_lines}")
    phase("simulator_examples", examples=len(walls), seconds=walls,
          total_seconds=sum(walls.values()))


def check_simulator():
    """Run the port's simulator CLI twice, each in a process of its own,
    and require equal summaries (``wall_time_s`` is the host's time);
    then import the simulator, the sweep and the CLI in a third process
    and require that nothing of jax or of the reference package loads."""
    root = Path(__file__).resolve().parent
    out_dir = root / "build" / "repro_torch_simulator"
    out_dir.mkdir(parents=True, exist_ok=True)
    env = {**os.environ, "PYTHONPATH": str(root / "src")}
    runs = []
    for i in range(2):
        path = out_dir / f"summary_{i}.json"
        path.unlink(missing_ok=True)
        t0 = time.perf_counter()
        subprocess.run([sys.executable, "-m", "repro_torch.launch.simulate",
                        *SIM_ARGS, "--out", str(path)], env=env,
                       check=True, capture_output=True, timeout=300)
        summary = json.loads(path.read_text())
        runs.append((summary, summary.pop("wall_time_s"),
                     time.perf_counter() - t0))
    (first, sim_wall, proc_wall), (second, sim_wall2, proc_wall2) = runs
    if json.dumps(first, sort_keys=True) != json.dumps(second,
                                                       sort_keys=True):
        raise AssertionError(f"the simulator is not deterministic: "
                             f"{first} != {second}")
    code = ("import sys, repro_torch.core.simulator, repro_torch.explore, "
            "repro_torch.launch.simulate; print(sorted(m for m in "
            "sys.modules if m.split('.')[0] in ('jax', 'jaxlib', "
            "'repro')))")
    loaded = subprocess.run([sys.executable, "-c", code], env=env,
                            check=True, capture_output=True, text=True,
                            timeout=120).stdout.strip()
    phase("simulator", args=" ".join(SIM_ARGS),
          n_finished=first["n_finished"],
          throughput_rps=first["throughput_rps"],
          throughput_tps=first["throughput_tps"],
          latency_p50_s=first["latency_p50"],
          latency_p99_s=first["latency_p99"], sim_time_s=first["sim_time"],
          runs_equal=True, wall_time_s=[sim_wall, sim_wall2],
          process_wall_s=[proc_wall, proc_wall2],
          jax_or_reference_modules_loaded=loaded)
    if loaded != "[]":
        raise AssertionError(f"the port's simulator loads {loaded}")
    if first["n_finished"] != 1000:
        raise AssertionError(f"{first['n_finished']} of 1000 requests "
                             "finished")


# -- the serve-then-simulate example (repro_torch.examples.serve_smoke) -------
#: workload seeds of the request sets the full-width run serves warm on
#: the engine after the example's own (cold); set k's ids start at
#: k * SET_IDS
SERVE_SMOKE_WARM_SEEDS = (1, 2)
#: the tabular cost model's floor: a fitted wall at or below it is clamped
TABULAR_FLOOR = 1e-6


def clamped_predictions(samples, mixes):
    """How many of ``mixes`` the tabular fit to ``samples`` predicts at its
    floor, where ``TabularBackend`` clamps."""
    tb = TabularBackend.fit(samples)
    return sum(tb.iteration_time(m) <= TABULAR_FLOOR for m in mixes)


def example_set(eng, log, workload, reqs, start, n_keys, run_s):
    """A request set of the example served on ``eng`` (records from
    ``start``, step keys from ``n_keys``): its workload, requests,
    records, real results and ``set_stats``."""
    return {"workload": workload, "reqs": reqs,
            "records": eng.records[start:],
            "real": Results(requests=reqs, sim_time=eng.clock),
            "stats": set_stats(eng, reqs, log, start, n_keys, run_s)}


def serve_warm_set(eng, log, seed, offset):
    """Serve the example's workload drawn with ``seed`` on the warm engine
    ``eng``: ids ``offset`` past set 0's, arrivals moved to the engine
    clock when the set is added; returns its ``example_set``."""
    wl = dataclasses.replace(ex_serve.WORKLOAD, seed=seed)
    reqs = generate(wl)
    start, n_keys, now = len(eng.records), len(log["keys"]), eng.clock
    t0 = time.perf_counter()
    for r in reqs:
        r.id += offset
        r.arrival_time += now
        eng.add_request(r)
    eng.run()
    torch.cuda.synchronize()
    return example_set(eng, log, wl, reqs, start, n_keys,
                       time.perf_counter() - t0)


def simulated(cfg, workload, samples, recs, reqs, real):
    """The example's comparison: ``workload`` simulated with the tabular
    fit to ``samples`` against the engine's run of it (``reqs``, its
    iteration records ``recs``, real results ``real``).  Raises if the
    two finished counts differ or the error is not finite."""
    sim, res = ex_serve.simulate(cfg, workload, samples)
    err = ex_serve.throughput_error(res, real)
    finished = sum(r.finished for r in reqs)
    if len(res.finished) != finished or not np.isfinite(err):
        raise AssertionError(f"serve_smoke: simulator {len(res.finished)} "
                             f"finished against the engine's {finished}, "
                             f"error {err}")
    return {"finished": [finished, len(res.finished)],
            "iterations": [len(recs), sim.workers[0].iterations],
            "real_req_s": real.throughput(), "sim_req_s": res.throughput(),
            "error_pct": 100 * err,
            "clamped_predictions": clamped_predictions(
                samples, [r.mix for r in recs])}


def serve_smoke_run(label, cfg, model, params, attn_path, kernels,
                    warm_seeds=()):
    """The example's functions on the card: ``serve`` (graphed, launch
    counts from zero), then (``warm_seeds``) more request sets on the
    same engine; per set the example's comparison and ``set_stats``;
    with two warm sets, the held-out error (fitted to the first's
    records, simulating the second's workload).  ``kernels``: the routes
    must launch paged once a layer a decode iteration and flash once a
    layer a prefill, else neither may launch.  Returns the engine, the
    launches and the prefill buckets."""
    t0 = time.perf_counter()
    launch_counts.reset()
    with StepLog() as log:
        eng, reqs, _ = ex_serve.serve(model, params, attn_path=attn_path)
        torch.cuda.synchronize()
        sets = [example_set(eng, log, ex_serve.WORKLOAD, reqs, 0, 0,
                            time.perf_counter() - t0)]
        sets += [serve_warm_set(eng, log, seed, k * SET_IDS)
                 for k, seed in enumerate(warm_seeds, 1)]
    launches = launches_now()
    seconds = time.perf_counter() - t0

    def compared(s, fitted=None):
        fitted = fitted or s
        return simulated(cfg, s["workload"],
                         [(r.mix, r.wall) for r in fitted["records"]],
                         s["records"], s["reqs"], s["real"])

    per_set = [{"seed": s["workload"].seed, **s["stats"],
                "engine_clock_s": sum(r.wall for r in s["records"]),
                **compared(s)} for s in sets]
    held_out = None
    if len(sets) >= 3:
        held_out = {"fitted_on_seed": sets[1]["workload"].seed,
                    "simulated_seed": sets[2]["workload"].seed,
                    **compared(sets[2], fitted=sets[1])}

    buckets = [key[1] for key in log["keys"] if key[0] == "prefill"]
    decodes = sum(r.kind == "decode" for r in eng.records)
    got = {k: launches[k] for k in ("paged_attention", "flash_attention")}
    expect = {"paged_attention": cfg.num_layers * decodes if kernels else 0,
              "flash_attention": cfg.num_layers * len(buckets)
              if kernels else 0}
    phase(label, model=cfg.name, dtype=cfg.dtype, layers=cfg.num_layers,
          d_model=cfg.d_model, n_heads=cfg.n_heads, head_dim=cfg.head_dim,
          attn_impl=model.settings.attn_impl, attn_path=attn_path,
          graphed=eng.graphs is not None, sets=per_set, held_out=held_out,
          launches=got, prefill_steps=len(buckets),
          prefill_buckets=sorted(set(buckets)), decode_iterations=decodes,
          flash_launches_per_prefill=got["flash_attention"] / len(buckets),
          paged_launches_per_decode=got["paged_attention"] / decodes,
          graphs=len(eng.graphs), capture_s=eng.graphs.capture_seconds,
          seconds=seconds)
    if got != expect:
        raise AssertionError(f"{label}: launches {got}, expected {expect}")
    return eng, got, buckets


def check_serve_smoke_values(label, model, params, eng, buckets):
    """The kernel routes of a ``serve_smoke_run`` (``eng``, its prefill
    ``buckets``) held to the plain versions at that run's shapes: flash
    at every prefill bucket and paged at the engine's page store (page
    size, batch, table width), each with numpy inputs within the
    reference's elementwise tolerance and the row limit; then the
    logits of the first token of every prompt the run served and of one
    decode step at the engine's page size, kernel routes against plain
    routes on the same weights, within LOGIT_LIMITS (the kernel routes
    launching flash once a layer a prompt and paged once a layer)."""
    cfg, ec = model.cfg, ex_serve.ENGINE
    dtype = model.compute_dtype
    for s in sorted(set(buckets)):
        flash_reference_case(f"{label} prefill S={s}", 1, s, s, cfg.n_heads,
                             cfg.n_kv_heads, cfg.head_dim, True,
                             cfg.attn_logit_softcap, dtype)
    paged_reference_case(f"{label} decode", ec.max_batch, cfg.n_heads,
                         cfg.n_kv_heads, cfg.head_dim, ec.num_blocks + 1,
                         ec.block_size, ec.max_pages_per_seq, dtype)
    plain = model.with_settings(attn_impl="naive")
    limits = LOGIT_LIMITS[dtype]
    prompts = [eng.prompt_tokens[rid] for rid in sorted(eng.prompt_tokens)]
    compare_logits(f"{label}_first_token_logits",
                   launched("flash_attention",
                            lambda: first_token_logits(model, params,
                                                       prompts),
                            cfg.num_layers * len(prompts)),
                   first_token_logits(plain, params, prompts),
                   cfg.vocab_size, limits=limits)
    pages, lens, toks, _ = decode_state(
        model, params, page=ec.block_size, batch=ec.max_batch,
        max_pages=ec.max_pages_per_seq,
        prompt_range=(1, ex_serve.WORKLOAD.max_prompt_len))
    compare_logits(f"{label}_decode_logits",
                   *launched("paged_attention",
                             lambda: decode_logits(model, params, pages,
                                                   lens, toks),
                             cfg.num_layers),
                   cfg.vocab_size, limits=limits)


def check_serve_smoke(params):
    """``repro_torch.examples.serve_smoke`` on the card: its ``main`` as a
    user runs it (its four lines); then through its functions (a) the
    smoke config as written (default routes, no kernel), (b) the smoke
    config on the kernel routes, (c) ``params``, the example's arch at
    full width and depth, on the kernel routes, the example's request
    set cold and SERVE_SMOKE_WARM_SEEDS' warm on one engine; (b) and (c)
    each held to the plain versions (``check_serve_smoke_values``).
    Returns the kernel routes' launches by path."""
    t0 = time.perf_counter()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        err = ex_serve.main([])
    lines = out.getvalue().splitlines()
    phase("serve_smoke_main", lines=lines, error_pct=100 * err,
          seconds=time.perf_counter() - t0)
    if len(lines) != 4 or not np.isfinite(err):
        raise AssertionError(f"serve_smoke main printed {lines}, "
                             f"error {err}")

    cfg = get_smoke_config(ex_serve.ARCH)
    plain = zoo.build(cfg)
    kernel = zoo.build(cfg, settings=RunSettings(attn_impl="pallas"))
    smoke_params = zoo.init_params(plain, seed=ex_serve.SEED)
    serve_smoke_run("serve_smoke_as_written", cfg, plain, smoke_params,
                    "gather", kernels=False)
    full = get_config(ex_serve.ARCH)
    paths = {}
    for label, cfg, model, weights, warm_seeds in (
            ("serve_smoke_kernel_routes", cfg, kernel, smoke_params, ()),
            (f"serve_smoke_{ex_serve.ARCH}", full,
             zoo.build(full, settings=RunSettings(attn_impl="pallas")),
             params, SERVE_SMOKE_WARM_SEEDS)):
        eng, paths[label], buckets = serve_smoke_run(
            label, cfg, model, weights, "pallas", kernels=True,
            warm_seeds=warm_seeds)
        check_serve_smoke_values(label, model, weights, eng, buckets)
        del eng
        free_memory()
    return paths


#: the paged models served at full width and depth, in this order
PAGED_MODELS = ("llama2-7b", "opt-13b", "qwen3-14b", "granite-moe-3b-a800m",
                "granite-moe-1b-a400m")
#: served once more at full width and depth in fp32 (its config's dtype
#: set to float32, as the reference's ``ArchConfig.dtype`` allows): the
#: fp32 flash kernel in every prefill, the paged kernel in fp32 in every
#: decode, FP32_REQUESTS requests of FP32_OUTPUT_LEN tokens
FP32_ARCH = "llama2-7b"
FP32_REQUESTS = 8
FP32_OUTPUT_LEN = 16
#: and once more in fp16 (the dtype of llama2-7b's published checkpoint),
#: as many requests of as many tokens: both kernels in fp16
FP16_ARCH = "llama2-7b"
#: and once more in bf16 with its heads WIDE_HEAD_DIM wide (the reference's
#: ``ArchConfig.head_dim`` set; 32 heads of 256, as Gemma-7B's 16 are):
#: both kernels' head_dim-256 shapes, as many requests of as many tokens
WIDE_ARCH = "llama2-7b"
#: and in fp32 at that head_dim: the fp32 flash kernel's wide shape in
#: every prefill.  Its weights take 35.5 GB and its KV 2 MiB a token, so
#: the engine's pool of NUM_BLOCKS pages (34.4 GB) would leave too little
#: of the card's 80 GB for the activations and graphs: check_serving
#: sizes its pool to its requests (FP32_REQUESTS of at most 1040 tokens,
#: 65 pages each), 640 pages, 21.5 GB
#: those that also run eager against graphed engines and the plain path
FULL_PHASE_SET = {"llama2-7b"}
#: the MoE model that also serves one request set on the ``sort`` route
SORT_ROUTE_ARCH = "granite-moe-1b-a400m"


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the card",
              file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase("card", nvidia_smi=card, torch=torch.__version__,
          cuda=torch.version.cuda, device=torch.cuda.get_device_name(0))

    t0 = time.perf_counter()
    libs = build.build()
    phase("build", seconds=time.perf_counter() - t0,
          libraries=sorted(p.name for p in libs.values()))
    phase("flash_attention_resources", kernels=flash_resources())
    phase("paged_attention_resources", kernels=paged_resources())

    served = {}
    with torch.no_grad():
        paged, flash, flash32, (paged_wide, flash_wide,
                                flash32_wide) = check_kernels()
        check_reference_cases()
        ssd = check_ssd_kernel()
        # one model at a time: each frees its weights and pages before
        # the next loads
        for arch in PAGED_MODELS:
            if arch == ex_serve.ARCH:
                # drawn once, for its serving phases and the example's
                params = zoo.init_params(zoo.build(get_config(arch)),
                                         seed=SEED)
                served[arch] = check_serving(arch, params)["launches"]
                serve_smoke = check_serve_smoke(params)
                del params
            else:
                served[arch] = check_serving(arch)["launches"]
            free_memory()
        served_fp32 = check_serving(FP32_ARCH, dtype="float32")["launches"]
        free_memory()
        served_fp16 = check_serving(FP16_ARCH, dtype="float16")["launches"]
        free_memory()
        served_wide = check_serving(WIDE_ARCH,
                                    head_dim=WIDE_HEAD_DIM)["launches"]
        free_memory()
        served_fp32_wide = check_serving(
            WIDE_ARCH, dtype="float32", head_dim=WIDE_HEAD_DIM)["launches"]
        free_memory()
        # stablelm-3b (head_dim 80) on the paged path, then its 4096-token
        # prefill on the blocked route, on the same weights
        params = zoo.init_params(zoo.build(get_config(BLOCKED_ARCH)),
                                 seed=SEED)
        served[BLOCKED_ARCH] = check_serving(BLOCKED_ARCH, params)["launches"]
        check_blocked_prefill(params)
        del params
        free_memory()
        mamba = check_mamba2()
        free_memory()
        whisper = check_whisper()
        free_memory()
        zamba = check_zamba2()
        free_memory()
    ssd_train, llama_train = check_training()
    sharded_flash, sharded_ssd = check_sharded(llama_train)
    check_simulator()
    check_simulator_examples()

    kernels = []
    # the main paths' runs: each paged model's, the serve-then-simulate
    # example's kernel routes, mamba2-130m's, whisper-base's and
    # zamba2-2.7b's, and mamba2-130m's training run
    by_path = {name: {arch: n[name] for arch, n in served.items()}
               for name in ("paged_attention", "flash_attention")}
    # the fp32 run: its flash launches are the fp32 kernel's
    fp32_path = f"{FP32_ARCH}-float32"
    by_path["paged_attention"][fp32_path] = served_fp32["paged_attention"]
    by_path["flash_attention_fp32"] = {
        fp32_path: served_fp32["flash_attention"]}
    # the fp16 run: its kernels are the bf16 ones' fp16 instances
    fp16_path = f"{FP16_ARCH}-float16"
    for name in ("paged_attention", "flash_attention"):
        by_path[name][fp16_path] = served_fp16[name]
    # the head_dim-256 run: its kernels are the wide shapes (their own
    # lines, timed at head_dim 256)
    wide_path = f"{WIDE_ARCH}-head_dim{WIDE_HEAD_DIM}"
    for name in ("paged_attention", "flash_attention"):
        by_path[f"{name}_d{WIDE_HEAD_DIM}"] = {wide_path: served_wide[name]}
    # the fp32 head_dim-256 run: the paged kernel's D-256 shape in fp32
    # and the fp32 flash kernel's wide shape (a line of its own)
    fp32_wide_path = f"{WIDE_ARCH}-float32-head_dim{WIDE_HEAD_DIM}"
    by_path[f"paged_attention_d{WIDE_HEAD_DIM}"][fp32_wide_path] = \
        served_fp32_wide["paged_attention"]
    by_path[f"flash_attention_fp32_d{WIDE_HEAD_DIM}"] = {
        fp32_wide_path: served_fp32_wide["flash_attention"]}
    by_path["flash_attention"][WHISPER_ARCH] = \
        whisper["launches"]["flash_attention"]
    by_path["flash_attention"][HYBRID_ARCH] = \
        zamba["launches"]["flash_attention"]
    by_path["flash_attention"]["llama2-7b_sharded_serve"] = sharded_flash
    for path, n in serve_smoke.items():
        for name in ("paged_attention", "flash_attention"):
            by_path[name][path] = n[name]
    by_path["ssd_scan"] = {"mamba2-130m": mamba["launches"]["ssd_scan"],
                           HYBRID_ARCH: zamba["launches"]["ssd_scan"],
                           "mamba2-130m_train": ssd_train,
                           "mamba2-130m_sharded_prefill": sharded_ssd}
    launches = {name: sum(n.values()) for name, n in by_path.items()}
    for name, rec, src, replaces in (
            ("paged_attention", paged,
             "src/repro_torch/kernels/csrc/paged_attention.cu",
             "src/repro/kernels/paged_attention/kernel.py:79"),
            ("flash_attention", flash,
             "src/repro_torch/kernels/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention/kernel.py:96"),
            ("flash_attention_fp32", flash32,
             "src/repro_torch/kernels/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention/kernel.py:96"),
            (f"paged_attention_d{WIDE_HEAD_DIM}", paged_wide,
             "src/repro_torch/kernels/csrc/paged_attention.cu",
             "src/repro/kernels/paged_attention/kernel.py:79"),
            (f"flash_attention_d{WIDE_HEAD_DIM}", flash_wide,
             "src/repro_torch/kernels/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention/kernel.py:96"),
            (f"flash_attention_fp32_d{WIDE_HEAD_DIM}", flash32_wide,
             "src/repro_torch/kernels/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention/kernel.py:96"),
            ("ssd_scan", ssd,
             "src/repro_torch/kernels/csrc/ssd_scan.cu",
             "src/repro/kernels/ssd_scan/kernel.py:75")):
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces,
                        "launches": launches[name],
                        "launches_by_path": by_path[name],
                        "max_abs_err": rec["max_abs_err"],
                        "ms": rec["kernel_ms"],
                        "plain_ms": rec["plain_ms"],
                        "bound_ms": rec["bound_ms"],
                        "bound_by": rec["bound_by"],
                        "bound_route": rec["bound_route"],
                        "library_ms": rec["library_ms"]})
    phase("total", seconds=time.perf_counter() - T0)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
