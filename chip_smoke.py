#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

Run from the root of a checkout, on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each printed as it ends; any failure raises and exits non-zero:

1. the card: ``nvidia-smi`` name and power limit; TF32 off;
2. the build of every CUDA kernel from ``src/repro_torch/kernels/csrc``;
3. each kernel against its plain PyTorch version on the card, at the
   serving path's shapes, with the tolerance stated, timed beside the
   plain version, the bound and (flash) ``scaled_dot_product_attention``;
4. serving: llama2-7b at full width and depth (random weights from
   ``init_params(seed=0)``) behind ``ServingEngine``, 16 requests of
   64-1024 prompt tokens and 32 output tokens, on the kernel path; the
   kernels' launch counts over that run; first-token logits of the
   kernel path against the plain path; one decode step of a full batch
   on prefilled pages, kernel path against plain path; a profile of a
   decode step and of a 1024-token prefill; the same requests on the
   plain path;
5. the ``kernels`` JSON line, then the result line.

Without a CUDA device, or without the rest of the checkout, it fails
before printing a result.
"""
from __future__ import annotations

import json
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
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.paged_attention import ops as paged_ops  # noqa: E402
from repro_torch.models import model_zoo as zoo  # noqa: E402
from repro_torch.models.common import RunSettings  # noqa: E402
from repro_torch.serving import paged_model  # noqa: E402
from repro_torch.serving.engine import EngineConfig, ServingEngine  # noqa: E402

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

PAGE = 16
NUM_BLOCKS = 1024
MAX_PAGES = 128
MAX_BATCH = 8
N_REQUESTS = 16
OUTPUT_LEN = 32
PROMPT_RANGE = (64, 1024)
SEED = 0


def phase(name, **fields):
    print(json.dumps({"phase": name, **fields}), flush=True)


def time_ms(fn, reps):
    """Mean device time of ``fn`` over ``reps`` calls, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
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
    rec = {"case": name, "dtype": str(dtype), "batch": batch, "hq": hq,
           "hkv": hkv, "head_dim": d, "page": PAGE,
           "lens": [int(x) for x in lens], "max_abs_err": err,
           "max_rel_err": rel, "tol_rel": REL_TOL[dtype], "finite": finite,
           "kernel_ms": time_ms(
               lambda: paged_ops.paged_attention(q, kp, vp, t, ln), 50),
           "plain_ms": time_ms(
               lambda: paged_ops.paged_attention_ref(q, kp, vp, t, ln), 10),
           "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}
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
           "kernel_ms": time_ms(
               lambda: flash_ops.flash_attention(q, k, v, **kw), 20),
           "plain_ms": time_ms(
               lambda: flash_ops.flash_attention_ref(q, k, v, **kw), 5),
           "bound_ms": bound_ms, "bound_by": bound_by,
           "library_ms": library_ms}
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
    ]
    flash = [flash_case(f"causal S={s}", sq=s, skv=s, h=32, hkv=32,
                        causal=True, dtype=bf16)
             for s in (128, 512, 1024, 2048)]
    flash += [
        flash_case("non-causal ragged kv", sq=200, skv=333, h=32, hkv=8,
                   causal=False, dtype=bf16, seed=1),
        flash_case("softcap 30", sq=512, skv=512, h=32, hkv=32, causal=True,
                   dtype=bf16, softcap=30.0, seed=2),
        flash_case("fp32 causal ragged d64", sq=300, skv=300, h=8, hkv=4,
                   d=64, causal=True, dtype=f32, seed=3),
        flash_case("fp32 causal ragged d128", sq=300, skv=300, h=8, hkv=2,
                   causal=True, dtype=f32, seed=4),
    ]
    # the rows of the kernels line: the serving path's shapes
    return paged[0], flash[2]


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------
def make_requests():
    rng = np.random.RandomState(SEED)
    lens = rng.randint(PROMPT_RANGE[0], PROMPT_RANGE[1] + 1, size=N_REQUESTS)
    return [Request(id=i, arrival_time=1e-3 * i, prompt_len=int(p),
                    output_len=OUTPUT_LEN) for i, p in enumerate(lens)]


def serve(model, params, attn_path):
    ec = EngineConfig(num_blocks=NUM_BLOCKS, block_size=PAGE,
                      max_batch=MAX_BATCH, max_pages_per_seq=MAX_PAGES,
                      attn_path=attn_path)
    eng = ServingEngine(model, params, ec)
    reqs = make_requests()
    for r in reqs:
        eng.add_request(r)
    t0 = time.perf_counter()
    eng.run()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    if len(eng.finished) != len(reqs) or \
            any(r.tokens_generated != OUTPUT_LEN for r in reqs):
        raise AssertionError(f"{attn_path}: {len(eng.finished)} of "
                             f"{len(reqs)} requests finished")
    pre = [r.wall for r in eng.records if r.kind == "prefill"]
    dec = [r.wall for r in eng.records if r.kind == "decode"]
    generated = sum(r.tokens_generated for r in reqs)
    prompt = sum(r.prompt_len for r in reqs)
    walls = sum(r.wall for r in eng.records)
    stats = {"attn_path": attn_path,
             "attn_impl": model.settings.attn_impl,
             "iterations": len(eng.records),
             "prefill_iterations": len(pre), "decode_iterations": len(dec),
             "mean_prefill_wall_ms": 1e3 * float(np.mean(pre)),
             "mean_decode_wall_ms": 1e3 * float(np.mean(dec)),
             "generated_tokens": generated, "prompt_tokens": prompt,
             "generated_tokens_per_s": generated / walls,
             "all_tokens_per_s": (generated + prompt) / walls,
             "run_s": elapsed,
             "preemptions": sum(r.preempt_count for r in reqs)}
    tokens, prompts = dict(eng.tokens_by_req), dict(eng.prompt_tokens)
    del eng
    torch.cuda.empty_cache()
    return stats, tokens, prompts


def first_token_logits(model, params, prompts):
    """Logits of each prompt's first generated token, as the engine's
    prefill computes them (power-of-two bucket, last real position)."""
    out = []
    for p in prompts:
        plen = len(p)
        spad = min(ServingEngine._bucket(plen), MAX_PAGES * PAGE)
        toks = torch.zeros((1, spad), dtype=torch.long, device="cuda")
        toks[0, :plen] = torch.from_numpy(p.astype(np.int64))
        logits, _, _ = paged_model.prefill_collect(model, params, toks, plen)
        out.append(logits)
    return out


def check_serving():
    cfg = get_config("llama2-7b")
    kernel_model = zoo.build(cfg, settings=RunSettings(attn_impl="pallas"))
    plain_model = kernel_model.with_settings(attn_impl="naive")
    t0 = time.perf_counter()
    params = zoo.init_params(kernel_model, seed=SEED)
    torch.cuda.synchronize()
    n_bytes = sum(t.numel() * t.element_size()
                  for t in _leaves(params))
    phase("init_params", model=cfg.name, layers=cfg.num_layers,
          d_model=cfg.d_model, n_heads=cfg.n_heads, head_dim=cfg.head_dim,
          d_ff=cfg.d_ff, vocab=cfg.vocab_size, param_gb=n_bytes / 1e9,
          seconds=time.perf_counter() - t0)

    torch.cuda.reset_peak_memory_stats()
    paged_ops.launches = 0
    flash_ops.launches = 0
    kernel_stats, kernel_tokens, prompts = serve(kernel_model, params,
                                                 "pallas")
    launches = {"paged_attention": paged_ops.launches,
                "flash_attention": flash_ops.launches}
    kernel_stats["launches"] = launches
    kernel_stats["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    phase("serve_kernel_path", **kernel_stats)
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was never launched while serving")

    ordered = [prompts[rid] for rid in sorted(prompts)]
    compare_logits("first_token_logits",
                   first_token_logits(kernel_model, params, ordered),
                   first_token_logits(plain_model, params, ordered),
                   cfg.vocab_size)

    pages, lens, toks, free_row = decode_state(kernel_model, params)
    compare_logits("decode_logits",
                   *decode_logits(kernel_model, params, pages, lens, toks),
                   cfg.vocab_size)
    profile_serving(kernel_model, params, pages, lens, toks, free_row)
    del pages
    torch.cuda.empty_cache()

    plain_stats, plain_tokens, _ = serve(plain_model, params, "gather")
    same = sum(int(x == y) for rid in kernel_tokens
               for x, y in zip(kernel_tokens[rid], plain_tokens[rid]))
    first_same = sum(int(kernel_tokens[rid][0] == plain_tokens[rid][0])
                     for rid in kernel_tokens)
    plain_stats["generated_tokens_agreeing"] = same
    plain_stats["first_tokens_agreeing"] = first_same
    phase("serve_plain_path", **plain_stats)
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
    pages["tables"] = torch.from_numpy(tables).cuda()
    for b, n in enumerate(lens):
        n = int(n)
        toks = torch.zeros((1, min(ServingEngine._bucket(n),
                                   MAX_PAGES * PAGE)),
                           dtype=torch.long, device="cuda")
        toks[0, :n] = torch.from_numpy(
            rng.randint(0, model.cfg.vocab_size, size=n))
        _, k, v = paged_model.prefill_collect(model, params, toks, n)
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
    out = {}
    for path in ("pallas", "gather"):
        pages["len"] = lens
        out[path], _ = paged_model.paged_decode_step(model, params, pages,
                                                     toks, path)
    return out["pallas"].float(), out["gather"].float()


def profile(label, fn, reps):
    """Where one call's time goes: host wall per call (no profiler), then
    under ``torch.profiler`` the device-busy time per call (sum of the
    device time of every kernel and copy), the idle share and the kernels
    that take the most device time."""
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
    phase(f"profile_{label}", wall_ms=wall_ms,
          device_busy_ms=busy_ms if dev else "not measured",
          idle_share=1 - busy_ms / wall_ms if dev else "not measured",
          top_kernels=[{"name": e.key[:80],
                        "ms_per_call": e.self_device_time_total / 1e3 / reps,
                        "calls_per_call": e.count / reps}
                       for e in top])


def profile_serving(model, params, pages, lens, toks, free_row):
    """One prefill of a 1024-token prompt and one decode step of the
    ``decode_state`` batch, on the kernel path."""
    def decode():
        pages["len"] = lens
        paged_model.paged_decode_step(model, params, pages, toks, "pallas")

    s = PROMPT_RANGE[1]
    prompt = torch.from_numpy(np.random.RandomState(2).randint(
        0, model.cfg.vocab_size, size=(1, s))).cuda()

    def prefill():
        _, k, v = paged_model.prefill_collect(model, params, prompt, s)
        paged_model.scatter_prefill(model, pages, k, v, free_row, s)

    profile("decode_step", decode, 5)
    profile("prefill_1024", prefill, 3)


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


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

    with torch.no_grad():
        paged, flash = check_kernels()
        serving = check_serving()

    kernels = []
    for name, rec, src, replaces in (
            ("paged_attention", paged,
             "src/repro_torch/kernels/csrc/paged_attention.cu",
             "src/repro/kernels/paged_attention/kernel.py:79"),
            ("flash_attention", flash,
             "src/repro_torch/kernels/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention/kernel.py:96")):
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces,
                        "launches": serving["launches"][name],
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
