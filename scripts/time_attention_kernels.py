"""Time one checkout's attention kernels through chip_smoke.py's own cases.

Usage, from the root of a checkout on a machine with an H100:

    python3 scripts/time_attention_kernels.py [--root DIR]

Imports ``chip_smoke.py`` of the checkout at ``--root`` (default: this
one; the script puts that checkout's ``src`` first on the path), first
builds each of its kernel sources alone into a fresh directory, timing
each build (a source of parts builds them in parallel, as
``chip_smoke.py``'s build does), then runs its ``paged_case`` at
llama2-7b's decode (B 8, 32/32 heads, head_dim 128, bf16) and
qwen3-14b's (40/8), and its ``flash_case`` at a causal 1024-token
prefill (32/32, head_dim 128) in bf16 and in fp32, and in fp16 where the
checkout's kernels take it, and where they take head_dim 256 the paged
case at 16/16 heads of 256 (llama2-7b's decode lengths) and the flash
case at causal S 1024 with 16/16 heads of 256 in bf16, fp16 and fp32,
with 16/8 and llama2-7b's served 32/32 heads of 256 in bf16, fp16 and
fp32, and with 32/8 heads of 144 and of 192 in bf16 and fp32,
``ROUNDS`` times each.
Each case prints its own phase line; the last line is one JSON object:
the card, each source's build seconds, each case's kernel ms (CUDA
events, the card's queue filled ahead) by round and their median, its
bound and the share of it, and the median of SDPA's ms on the same
inputs (flash), the registers and spills (``ptxas -v``) of the bf16
paged kernels at head_dim 128, and every kernel of each source of which
ptxas noted that it serialised its wgmma (C7510-C7515).

To compare two checkouts, run it on each in turns in one call (parent,
change, change, parent): times from two cards differ.
"""
from __future__ import annotations

import argparse
import importlib
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROUNDS = 5


def wgmma_serialized(report):
    """(entry, sorted codes) of each kernel in a ``ptxas -v`` report
    with a note that its wgmma were serialised (C7510-C7515): a note
    names its function, or else belongs to the entry being compiled."""
    out, entry = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
        code = re.search(r"\((C751[0-5])\)", line)
        if code:
            named = re.search(r"function '(\S+?)'", line)
            out.setdefault(named.group(1) if named else entry,
                           set()).add(code.group(1))
    return sorted((k, sorted(v)) for k, v in out.items())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    root = Path(ap.parse_args(argv).root).resolve()
    sys.path.insert(0, str(root))
    smoke = importlib.import_module("chip_smoke")
    torch = smoke.torch
    if not torch.cuda.is_available():
        print("time_attention_kernels: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    build = smoke.build
    build.BUILD_DIR = build.BUILD_DIR.with_name("repro_torch_kernels_timed")
    if build.BUILD_DIR.exists():
        for old in build.BUILD_DIR.iterdir():
            old.unlink()
    build_s = {}
    for name in build.sources():
        t0 = time.perf_counter()
        build.build([name])
        build_s[name] = time.perf_counter() - t0
    bf16, f16 = torch.bfloat16, torch.float16
    cases = {
        "paged llama2-7b decode": lambda: smoke.paged_case(
            "llama2-7b decode", batch=8, hq=32, hkv=32, dtype=bf16),
        "paged qwen3-14b decode": lambda: smoke.paged_case(
            "qwen3-14b decode", batch=8, hq=40, hkv=8, dtype=bf16, seed=4),
        "flash causal S=1024": lambda: smoke.flash_case(
            "causal S=1024", sq=1024, skv=1024, h=32, hkv=32, causal=True,
            dtype=bf16),
        "flash fp32 causal S=1024": lambda: smoke.flash_case(
            "fp32 llama2-7b causal S=1024", sq=1024, skv=1024, h=32, hkv=32,
            causal=True, dtype=torch.float32, seed=10),
    }
    if f16 in smoke.paged_ops.DTYPES and f16 in smoke.flash_ops.DTYPES:
        cases["paged fp16 llama2-7b decode"] = lambda: smoke.paged_case(
            "fp16 llama2-7b decode", batch=8, hq=32, hkv=32, dtype=f16)
        cases["flash fp16 causal S=1024"] = lambda: smoke.flash_case(
            "fp16 llama2-7b causal S=1024", sq=1024, skv=1024, h=32, hkv=32,
            causal=True, dtype=f16, seed=12)
    if 256 in smoke.paged_ops.HEAD_DIMS and 256 in smoke.flash_ops.HEAD_DIMS:
        cases["paged head_dim 256 decode 16/16"] = lambda: smoke.paged_case(
            "head_dim 256 decode 16/16", batch=8, hq=16, hkv=16, d=256,
            dtype=bf16)
        for dt, tag in ((bf16, ""), (torch.float32, "fp32 ")):
            cases[f"flash {tag}head_dim 256 causal S=1024 16/16"] = (
                lambda dt=dt, tag=tag: smoke.flash_case(
                    f"{tag}head_dim 256 causal S=1024 16/16", sq=1024,
                    skv=1024, h=16, hkv=16, d=256, causal=True, dtype=dt,
                    seed=76))
        # the wide kernels' shapes: 16/16 in fp16, Gemma-2-9B's 16/8 and
        # llama2-7b's served 32/32 in every type, and head_dims 144 and
        # 192 at 32/8
        f32 = torch.float32
        shapes = [(f16, "fp16 ", 256, 16, 16)] + [
            (dt, tag, 256, h, hkv) for h, hkv in ((16, 8), (32, 32))
            for dt, tag in ((bf16, ""), (f16, "fp16 "))] + [
            (dt, tag, d, 32, 8) for d in (144, 192)
            for dt, tag in ((bf16, ""), (f32, "fp32 "))] + [
            (f32, "fp32 ", 256, h, hkv) for h, hkv in ((16, 8), (32, 32))]
        for dt, tag, d, h, hkv in shapes:
            name = f"{tag}head_dim {d} causal S=1024 {h}/{hkv}"
            cases[f"flash {name}"] = (
                lambda dt=dt, name=name, d=d, h=h, hkv=hkv: smoke.flash_case(
                    name, sq=1024, skv=1024, h=h, hkv=hkv, d=d, causal=True,
                    dtype=dt, seed=77))
    recs = {name: [] for name in cases}
    with torch.no_grad():
        for _ in range(ROUNDS):
            for name, case in cases.items():
                recs[name].append(case())

    def medians(rs):
        out = {"rounds": [r["kernel_ms"] for r in rs],
               "median": statistics.median(r["kernel_ms"] for r in rs),
               "bound_ms": rs[0]["bound_ms"]}
        out["bound_share"] = out["bound_ms"] / out["median"]
        if rs[0].get("library_ms") is not None:
            out["library_median"] = statistics.median(r["library_ms"]
                                                      for r in rs)
        return out

    serialized = {}
    for name in build_s:
        for entry, codes in wgmma_serialized(build.ptxas_report(name)):
            serialized.setdefault(name, {})[entry] = codes
    print(json.dumps({
        "card": card, "root": str(root), "build_s": build_s,
        "wgmma_serialized": serialized,
        "kernel_ms": {n: medians(rs) for n, rs in recs.items()},
        "paged_registers_bf16_d128": [
            {k: e.get(k) for k in ("group", "chunked", "registers",
                                   "spill_store_bytes")}
            for e in smoke.paged_resources()
            if e["dtype"] == "bfloat16" and e["head_dim"] == 128]}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
