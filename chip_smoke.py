#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

Run from the root of a checkout, on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each printed as it ends; any failure raises and exits non-zero:

1. the card: ``nvidia-smi`` name and power limit; TF32 off;
2. the build of every CUDA kernel from ``src/repro_torch/kernels/csrc``,
   and the flash and paged kernels' registers, spills and shared memory;
3. each kernel against its plain PyTorch version on the card, at the
   serving path's shapes (flash: every prefill bucket, 64-2048), with the
   tolerance stated, timed beside the plain version, the bound and
   (flash) ``scaled_dot_product_attention``, flash and the SSD scan also
   in TFLOP/s and as a share of their bound; the SSD scan also against
   an fp64 recurrence on the card beside its plain version, and each of
   its three kernels' time and grid inside whole scans (``torch.profiler``);
   the paged kernel with the queue filled ahead and back to back, with
   its grid, its working blocks and the time of one contiguous read of
   as many bytes, at the decode shapes of llama2-7b, opt-13b, qwen3-14b
   (GQA 5) and qwen2-0.5b (GQA 7, head_dim 64);
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
   plain path.  opt-13b (learned positions, LayerNorm, GELU; MHA 40/40)
   runs the same phase set at full width and depth; qwen3-14b (qk-norm,
   GQA 40/8) at full width and depth runs the main path (one graphed
   engine on the kernel routes), the two logit comparisons and the
   profiles.  Each model frees its weights and pages before the next
   one loads;
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
6. the repaired ``blocked`` attention route at full width on the card:
   stablelm-3b at full width and depth (32 layers, 32 heads of 80, bf16,
   random weights from ``init_params(seed=0)``), one 4096-token prompt
   through ``model_zoo.forward`` with the default ``RunSettings()``
   (``auto`` resolves to ``blocked``, 4 x 4 blocks of 1024; the flash
   kernel takes no head_dim 80), against ``attn_impl="naive"``: the last
   position's logits within LOGIT_REL_MAX of the naive route's largest
   logit, the greedy tokens, both walls and the peak memory;
7. the simulator (``repro_torch.launch.simulate``, llama2-7b on A100,
   1000 requests at 8 QPS) twice, each in its own process: the two
   summaries must be equal apart from the host's wall time; a third
   process imports the port's simulator, sweep and CLI and must load
   nothing of jax or of the reference package;
8. the ``kernels`` JSON line (each kernel's launches summed over the
   main paths that run it, with ``launches_by_path``; its times at the
   llama2-7b case), then the result line.

Without a CUDA device, or without the rest of the checkout, it fails
before printing a result.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.request import Request  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import counts as launch_counts  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.paged_attention import ops as paged_ops  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models import model_zoo as zoo  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models.common import RunSettings  # noqa: E402
from repro_torch.models.layers import norm_apply  # noqa: E402
from repro_torch.serving import paged_model  # noqa: E402
from repro_torch.serving.engine import EngineConfig, ServingEngine  # noqa: E402
from repro_torch.serving.graphs import StepGraphs  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet, dense)
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
#: kernel vs its plain version run in fp32 on the same (bf16-valued)
#: inputs, per output row (one q head of one token): the row's largest
#: error over its largest |value|, the worst row of a case.  A sound bf16
#: kernel rounds its output (at most 2^-8 of a value) and its softmax
#: weights; a kernel that drops one attended position, or reads one too
#: many, is caught on rows thousands of positions long.  The limit lies
#: between the two readings (PERF.md, PR 11; the planted faults are in
#: tests/test_torch_kernels_cuda.py).
REL_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}
#: logits, kernel path vs plain path (first tokens of the served
#: requests, and one decode step of a full batch), per row, relative
#: to the plain path's largest |logit| (max) and norm (L2).  bf16 through
#: 32 layers: the two attention routes round at different points (the
#: flash kernel rounds unnormalised probabilities to bf16, the naive route
#: normalised ones) and each layer's difference passes through the layers
#: above it.  A wrong kernel gives errors of the logits' own size.
LOGIT_REL_MAX = 0.1
LOGIT_REL_L2 = 0.1

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
#: the flash kernel (kernels/csrc/flash_attention.cu)
FLASH_KERNELS = ("flash_kernel",)

PAGE = 16
NUM_BLOCKS = 1024
MAX_PAGES = 128
MAX_BATCH = 8
N_REQUESTS = 16
OUTPUT_LEN = 32
PROMPT_RANGE = (64, 1024)
FLASH_BUCKETS = (64, 128, 256, 512, 1024, 2048)
SEED = 0


def phase(name, **fields):
    print(json.dumps({"phase": name, **fields}), flush=True)


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


def bound(nbytes, flops, dtype):
    t_bytes = nbytes / PEAK_BYTES_S
    t_ops = flops / PEAK_FLOPS_S[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


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
    bound_ms, bound_by = bound(nbytes, flops, dtype)
    grid, split = paged_ops.grid(q, kp, t)
    # blocks whose split starts below the length (at least one a row)
    active = hkv * sum(max(1, -(-min(int(x), MAX_PAGES * PAGE) // split))
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
           "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
           "bound_share": bound_ms / kernel_ms, "bytes": nbytes,
           "read_ms": read_ms}
    phase("paged_attention", **rec)
    if not ok:
        raise AssertionError(f"paged_attention {name}: row error {rel} "
                             f"(tol {REL_TOL[dtype]}), finite={finite}")
    return rec


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
    bound_ms, bound_by = bound(nbytes, flops, dtype)
    kernel_ms = time_ms(lambda: flash_ops.flash_attention(q, k, v, **kw), 20)

    library_ms = None
    if not softcap:
        # yardstick only: one PyTorch call for the same function (GQA kv
        # expanded outside the timed region); the port never calls it
        rep = h // hkv
        qt = q.transpose(1, 2).contiguous()
        kt = k.repeat_interleave(rep, dim=2).transpose(1, 2).contiguous()
        vt = v.repeat_interleave(rep, dim=2).transpose(1, 2).contiguous()
        sdpa = torch.nn.functional.scaled_dot_product_attention
        library_ms = time_ms(lambda: sdpa(qt, kt, vt, is_causal=causal), 20)
    rec = {"case": name, "dtype": str(dtype), "sq": sq, "skv": skv, "h": h,
           "hkv": hkv, "head_dim": d, "causal": causal, "softcap": softcap,
           "max_abs_err": err, "max_rel_err": rel,
           "tol_rel": REL_TOL[dtype], "finite": finite,
           "kernel_ms": kernel_ms,
           "plain_ms": time_ms(
               lambda: flash_ops.flash_attention_ref(q, k, v, **kw), 5),
           "bound_ms": bound_ms, "bound_by": bound_by,
           "library_ms": library_ms,
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
    # the rows of the kernels line: the serving path's shapes
    return paged[0], flash[PROMPT_RANGE[1]]


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


def make_requests(offset=0):
    rng = np.random.RandomState(SEED)
    lens = rng.randint(PROMPT_RANGE[0], PROMPT_RANGE[1] + 1, size=N_REQUESTS)
    return [Request(id=offset + i, arrival_time=1e-3 * i, prompt_len=int(p),
                    output_len=OUTPUT_LEN) for i, p in enumerate(lens)]


def paged_engine(model, params, attn_path, graphs=None):
    ec = EngineConfig(num_blocks=NUM_BLOCKS, block_size=PAGE,
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


def instrument(eng):
    """Log the key of every step ``eng`` runs (``("prefill", bucket)`` or
    ``("decode",)``), and the index of each iteration record whose step
    captured a graph."""
    log = {"keys": [], "captured": set()}
    run = eng._step

    def step(key, fn):
        n = len(eng.graphs) if eng.graphs is not None else 0
        out = run(key, fn)
        log["keys"].append(key)
        if eng.graphs is not None and len(eng.graphs) > n:
            log["captured"].add(len(eng.records))
        return out

    eng._step = step
    return log


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
    if any(r.tokens_generated != OUTPUT_LEN for r in reqs):
        raise AssertionError("not every request finished")
    recs = eng.records[start:]
    captured = {i - start for i in log["captured"] if i >= start}

    def mean_ms(kind, warm=None):
        w = [r.wall for i, r in enumerate(recs) if r.kind == kind
             and (warm is None or (i not in captured) == warm)]
        return 1e3 * float(np.mean(w)) if w else None

    walls = sum(r.wall for r in recs)
    generated = sum(r.tokens_generated for r in reqs)
    prompt = sum(r.prompt_len for r in reqs)
    stats = {"graphed": eng.graphs is not None,
             "iterations": len(recs),
             "prefill_iterations": sum(r.kind == "prefill" for r in recs),
             "decode_iterations": sum(r.kind == "decode" for r in recs),
             "mean_prefill_wall_ms": mean_ms("prefill"),
             "mean_decode_wall_ms": mean_ms("decode"),
             "capture_iterations": len(captured),
             "mean_prefill_wall_ms_without_capture": mean_ms("prefill", True),
             "mean_decode_wall_ms_without_capture": mean_ms("decode", True),
             "generated_tokens": generated, "prompt_tokens": prompt,
             "generated_tokens_per_s": generated / walls,
             "all_tokens_per_s": (generated + prompt) / walls,
             "run_s": run_s,
             "preemptions": sum(r.preempt_count for r in reqs)}
    return {"stats": stats, "launches": launches,
            "buckets": [k[1] for k in log["keys"][n_keys:]
                        if k[0] == "prefill"],
            "tokens": {r.id - offset: list(eng.tokens_by_req[r.id])
                       for r in reqs},
            "records": [(r.kind, tuple(b - offset for b in r.batch_ids),
                         dataclasses.asdict(r.mix)) for r in recs]}


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


def first_token_logits(model, params, prompts):
    """Logits of each prompt's first generated token, as the engine's
    prefill computes them (power-of-two bucket, last real position), over
    the logical vocabulary (past it, both routes hold the -1e30 mask)."""
    vocab = model.plan.vocab_logical
    out = []
    for p in prompts:
        plen = len(p)
        spad = min(ServingEngine._bucket(plen), MAX_PAGES * PAGE)
        toks = torch.zeros((1, spad), dtype=torch.long, device="cuda")
        toks[0, :plen] = torch.from_numpy(p.astype(np.int64))
        logits, _, _ = paged_model.prefill_forward(model, params, toks)
        out.append(logits[0, plen - 1, :vocab].clone())
    return out


def check_serving(arch):
    """``arch`` at full width and depth on the paged path.  The main
    path: the engine on the kernel routes (``attn_impl="pallas"``,
    ``attn_path="pallas"``), graphed; then first-token and decode-step
    logits of the kernel routes against the plain routes, and the
    profiles of a decode step and a 1024-token prefill, eager and
    graphed.  For the archs of FULL_PHASE_SET, also eager against
    graphed engines and the same requests on the plain path.  Phase
    names carry the arch as a prefix (none for llama2-7b, as before)."""
    prefix = "" if arch == "llama2-7b" else f"{arch}_"
    full = arch in FULL_PHASE_SET
    cfg = get_config(arch)
    kernel_model = zoo.build(cfg, settings=RunSettings(attn_impl="pallas"))
    plain_model = kernel_model.with_settings(attn_impl="naive")
    t0 = time.perf_counter()
    params = zoo.init_params(kernel_model, seed=SEED)
    torch.cuda.synchronize()
    n_bytes = sum(t.numel() * t.element_size()
                  for t in _leaves(params))
    plan = kernel_model.plan
    phase(f"{prefix}init_params", model=cfg.name, layers=cfg.num_layers,
          d_model=cfg.d_model, n_heads=cfg.n_heads,
          n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
          d_ff=cfg.d_ff, vocab=cfg.vocab_size, vocab_padded=plan.vocab,
          norm=cfg.norm, act=cfg.act, pos_emb=cfg.pos_emb,
          qk_norm=cfg.qk_norm, param_gb=n_bytes / 1e9,
          seconds=time.perf_counter() - t0)

    # the main path: the engine as a user builds it, graphed on the card
    torch.cuda.reset_peak_memory_stats()
    graphed = paged_engine(kernel_model, params, "pallas")
    log = instrument(graphed)
    main = serve_set(graphed, make_requests(), {}, log)
    launches = main["launches"]
    kernel_stats = {"model": cfg.name, "attn_path": "pallas",
                    "attn_impl": kernel_model.settings.attn_impl,
                    **main["stats"],
                    "launches": {k: launches[k] for k in
                                 ("paged_attention", "flash_attention")},
                    "flash_launches_by_sq": launches["flash_attention_by_sq"],
                    "graphs": len(graphed.graphs),
                    "capture_s": graphed.graphs.capture_seconds,
                    "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    phase(f"{prefix}serve_kernel_path", **kernel_stats)
    for name, n in kernel_stats["launches"].items():
        if n <= 0:
            raise AssertionError(f"{arch}: {name} was never launched while "
                                 f"serving")
    prompts = dict(graphed.prompt_tokens)
    kernel_tokens = main["tokens"]

    if full:
        eager = paged_engine(kernel_model, params, "pallas", graphs=False)
        eager_vs_graphed(cfg.name, graphed, log, eager, make_requests,
                         prompts, main, ("k", "v"))
        del eager
    del graphed
    free_memory()

    ordered = [prompts[rid] for rid in sorted(prompts)]
    compare_logits(f"{prefix}first_token_logits",
                   first_token_logits(kernel_model, params, ordered),
                   first_token_logits(plain_model, params, ordered),
                   cfg.vocab_size)

    pages, lens, toks, free_row = decode_state(kernel_model, params)
    compare_logits(f"{prefix}decode_logits",
                   *decode_logits(kernel_model, params, pages, lens, toks),
                   cfg.vocab_size)
    profile_serving(kernel_model, params, pages, lens, toks, free_row,
                    prefix)
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


def compare_logits(label, got, want, vocab):
    """Kernel-path logits ``got`` against plain-path ``want``, row by
    row; fails past LOGIT_REL_MAX or LOGIT_REL_L2."""
    max_abs, rel_max, rel_l2, argmax_same = 0.0, 0.0, 0.0, 0
    for a, b in zip(got, want):
        if not (torch.isfinite(a).all() and a.shape == (vocab,)):
            raise AssertionError(f"{label}: logits not finite or misshapen")
        err = float((a - b).abs().max())
        max_abs = max(max_abs, err)
        rel_max = max(rel_max, err / float(b.abs().max()))
        rel_l2 = max(rel_l2, float((a - b).norm() / b.norm()))
        argmax_same += int(a.argmax() == b.argmax())
    phase(label, rows=len(got), max_abs_err=max_abs,
          max_rel_err=rel_max, tol_rel_max=LOGIT_REL_MAX, max_rel_l2=rel_l2,
          tol_rel_l2=LOGIT_REL_L2, argmax_agree=argmax_same,
          logit_scale=float(torch.stack(list(want)).abs().max()))
    if rel_max > LOGIT_REL_MAX or rel_l2 > LOGIT_REL_L2:
        raise AssertionError(f"{label} differ: max {rel_max}, rel L2 "
                             f"{rel_l2} of the plain path's")


def decode_state(model, params):
    """A full decode batch on real KV: prompts of lengths drawn like the
    serving run's, each prefilled and scattered into its own pages, plus
    room for one more 1024-token prompt (``free_row``)."""
    rng = np.random.RandomState(1)
    lens = rng.randint(PROMPT_RANGE[0], PROMPT_RANGE[1] + 1, size=MAX_BATCH)
    need = [-(-(int(n) + 1) // PAGE) for n in lens]
    trash = sum(need) + PROMPT_RANGE[1] // PAGE
    pages = paged_model.init_pages(model, trash + 1, PAGE, MAX_BATCH,
                                   MAX_PAGES, "cuda")
    tables = np.full((MAX_BATCH, MAX_PAGES), trash, np.int32)
    start = 0
    for b, n in enumerate(need):
        tables[b, :n] = np.arange(start, start + n)
        start += n
    pages["tables"].copy_(torch.from_numpy(tables))
    for b, n in enumerate(lens):
        n = int(n)
        toks = torch.zeros((1, min(ServingEngine._bucket(n),
                                   MAX_PAGES * PAGE)),
                           dtype=torch.long, device="cuda")
        toks[0, :n] = torch.from_numpy(
            rng.randint(0, model.cfg.vocab_size, size=n))
        _, k, v = paged_model.prefill_forward(model, params, toks)
        paged_model.scatter_prefill(model, pages, k, v, pages["tables"][b], n)
    free_row = torch.full((MAX_PAGES,), trash, dtype=torch.long,
                          device="cuda")
    free_row[:PROMPT_RANGE[1] // PAGE] = torch.arange(
        start, start + PROMPT_RANGE[1] // PAGE)
    toks = torch.from_numpy(rng.randint(0, model.cfg.vocab_size,
                                        size=MAX_BATCH)).cuda()
    return (pages, torch.from_numpy(lens.astype(np.int32)).cuda(), toks,
            free_row)


def decode_logits(model, params, pages, lens, toks):
    """One decode step's logits through the paged kernel and through the
    plain gather path, from the same page state (each writes the new
    token's K/V into the same slot before it reads it)."""
    vocab = model.plan.vocab_logical
    out = {}
    for path in ("pallas", "gather"):
        pages["len"].copy_(lens)
        logits, _ = paged_model.paged_decode_step(model, params, pages,
                                                  toks, path)
        out[path] = logits[:, :vocab].float()
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


def profile_serving(model, params, pages, lens, toks, free_row, prefix=""):
    """One prefill of a 1024-token prompt and one decode step of the
    ``decode_state`` batch, on the kernel path: eager, then as the
    engine's CUDA graphs run them (the step in a graph, the copy of the
    lengths and the scatter of the prefill's K/V outside)."""
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

    for suffix, dec, pre in (("", decode, prefill),
                             ("_graphed", decode_graphed, prefill_graphed)):
        profile(f"{prefix}decode_step{suffix}", dec, 5,
                shares={"paged_attention": PAGED_KERNELS})
        profile(f"{prefix}prefill_1024{suffix}", pre, 3,
                shares={"flash_attention": FLASH_KERNELS})


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
    bound_ms, bound_by = bound(nbytes, least, torch.float32)
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
    profile_mamba2(model, params, engine.max_ctx)
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


def profile_mamba2(model, params, max_ctx):
    """One decode step of all MAX_BATCH slots and one prefill of a
    1024-token prompt, as the engine runs them: eager, then graphed."""
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
        return logits, cache1["conv"], cache1["ssd"]

    for suffix, dec, pre in (
            ("", decode, prefill),
            ("_graphed", lambda: graphs.run("decode", decode),
             lambda: graphs.run("prefill", prefill))):
        profile(f"mamba2_decode_step{suffix}", dec, 5)
        profile(f"mamba2_prefill_1024{suffix}", pre, 3,
                shares={"ssd_scan": SSD_KERNELS})


def ptxas_entries(lib):
    """Each kernel of ``csrc/<lib>.cu``: registers, stack, spills and
    static shared memory as ``ptxas -v`` reported them at the build."""
    out = []
    for chunk in build.ptxas_report(lib).split("Compiling entry function")[1:]:
        stack, stores, loads = map(int, re.search(
            r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) "
            r"bytes spill loads", chunk).groups())
        static = re.search(r"(\d+) bytes smem", chunk)
        out.append({"entry": re.search(r"'(\S+)'", chunk).group(1),
                    "registers": int(re.search(r"Used (\d+) registers",
                                               chunk).group(1)),
                    "stack_bytes": stack, "spill_store_bytes": stores,
                    "spill_load_bytes": loads,
                    "static_smem_bytes": int(static.group(1)) if static
                    else 0})
    if not out:
        raise AssertionError(f"no kernel in the ptxas report of {lib}")
    return out


def flash_resources():
    """Per head_dim instance of the flash kernel: ``ptxas_entries`` and
    the dynamic shared memory a block takes."""
    lib = build.load("flash_attention")
    out = []
    for e in ptxas_entries("flash_attention"):
        name = e.pop("entry")
        if "flash_kernel" not in name:
            continue
        d = int(re.search(r"flash_kernelILi(\d+)E", name).group(1))
        out.append({"head_dim": d, **e,
                    "dynamic_smem_bytes": lib.flash_attention_smem_bytes(d)})
    if not out:
        raise AssertionError("no flash kernel in the ptxas report")
    return out


def paged_resources():
    """Per (dtype, head_dim, group) instance of the paged kernel:
    ``ptxas_entries`` (its shared memory is all static)."""
    out = []
    for e in ptxas_entries("paged_attention"):
        m = re.search(r"paged_attn_kernelI(\w+?)Li(\d+)ELi(\d+)E",
                      e.pop("entry"))
        if m:
            out.append({"dtype": "bfloat16" if "bfloat16" in m.group(1)
                        else "float32", "head_dim": int(m.group(2)),
                        "group": int(m.group(3)), **e})
    if not out:
        raise AssertionError("no paged kernel in the ptxas report")
    return out


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


#: the blocked-route check: stablelm-3b's head_dim 80, which the flash
#: kernel refuses, at a prompt that ``auto`` sends to ``blocked``
BLOCKED_ARCH = "stablelm-3b"
BLOCKED_PROMPT = 4096


def check_blocked_prefill():
    """One ``BLOCKED_PROMPT``-token prompt through the full-size
    ``BLOCKED_ARCH`` with the default settings (``auto``, which resolves
    to ``blocked`` past ``naive_attn_max_seq``) and with ``naive``: the
    last position's logits, and the greedy token of every position."""
    cfg = get_config(BLOCKED_ARCH)
    model = zoo.build(cfg)
    if model.settings.resolve_attn(BLOCKED_PROMPT) != "blocked":
        raise AssertionError("auto does not resolve to blocked at "
                             f"{BLOCKED_PROMPT} tokens")
    naive = model.with_settings(attn_impl="naive")
    t0 = time.perf_counter()
    params = zoo.init_params(model, seed=SEED)
    torch.cuda.synchronize()
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    load_s = time.perf_counter() - t0
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
           "param_gb": n_bytes / 1e9, "init_s": load_s,
           "prompt": BLOCKED_PROMPT,
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
SIM_ARGS = ("--arch", "llama2-7b", "--hw", "A100", "--requests", "1000",
            "--qps", "8", "--seed", "0")


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


#: the paged models served at full width and depth, in this order
PAGED_MODELS = ("llama2-7b", "opt-13b", "qwen3-14b")
#: those that also run eager against graphed engines and the plain path
FULL_PHASE_SET = {"llama2-7b", "opt-13b"}


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
        paged, flash = check_kernels()
        ssd = check_ssd_kernel()
        # one model at a time: each frees its weights and pages before
        # the next loads
        for arch in PAGED_MODELS:
            served[arch] = check_serving(arch)["launches"]
            free_memory()
        mamba = check_mamba2()
        free_memory()
        check_blocked_prefill()
        free_memory()
    check_simulator()

    kernels = []
    # the main paths' runs: each paged model's, and mamba2-130m's
    by_path = {name: {arch: n[name] for arch, n in served.items()}
               for name in ("paged_attention", "flash_attention")}
    by_path["ssd_scan"] = {"mamba2-130m": mamba["launches"]["ssd_scan"]}
    launches = {name: sum(n.values()) for name, n in by_path.items()}
    for name, rec, src, replaces in (
            ("paged_attention", paged,
             "src/repro_torch/kernels/csrc/paged_attention.cu",
             "src/repro/kernels/paged_attention/kernel.py:79"),
            ("flash_attention", flash,
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
                        "library_ms": rec["library_ms"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
