"""Time variants of the wide bf16/fp16 flash kernel against the kernel as written.

Usage, from the root of a checkout on a machine with an H100:

    python3 scripts/wide_flash_variants.py

Each variant is the flash source (``kernels/csrc/flash_attention.cu``)
with one design choice of ``flash_kernel_wide`` undone by a text
replacement, built into a directory of its own under
``build/wide_flash_variants/``:

- ``as written``;
- ``trap inlined``: the barrier wait's one-second trap inlined in the
  kernel's body, as the other kernels of the source have it;
- ``mirror pairs always`` and ``neighbour pairs always``: the pairing
  of q units (and its launch order) fixed, where the kernel takes the
  mirror pairs for a launch of one wave and the neighbour pairs past it;
- ``no overlap in a warpgroup``: each round waits for P·V as well before
  its softmax.

For each it prints what ``ptxas -v`` said of the bf16 kernel (registers,
spill bytes, the C751x notes of wgmma serialised) and, through
``chip_smoke.flash_case``, the kernel's ms, SDPA's ms on the same inputs
and the row error at causal S 1024 with head_dim 256 and 16/16, 16/8 and
32/32 heads, in ``ROUNDS`` rounds; the last line is one JSON object with
the card's name and power limit.
"""
from __future__ import annotations

import json
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ROUNDS = 3
#: (dtype name, head_dim, q heads, kv heads), causal S 1024
SHAPES = [("bfloat16", 256, 16, 16), ("bfloat16", 256, 16, 8),
          ("bfloat16", 256, 32, 32)]


def _wide(src: str):
    a = src.index("namespace wide {")
    return a, src.index("}  // namespace wide")


def _replace(src: str, pairs) -> str:
    a, b = _wide(src)
    w = src[a:b]
    for old, new in pairs:
        if w.count(old) != 1:
            raise ValueError(f"not found once in the wide kernel: {old!r}")
        w = w.replace(old, new)
    return src[:a] + w + src[b:]


def variants(src: str):
    return {
        "as written": src,
        "trap inlined": _replace(src, [
            ("if (now_ns() - t0 > 1000000000ull) wait_failed();",
             "if (now_ns() - t0 > 1000000000ull) __trap();")]),
        "mirror pairs always": _replace(src, [
            ("return pairs * h * batch <= sms;", "return true;")]),
        "neighbour pairs always": _replace(src, [
            ("return pairs * h * batch <= sms;", "return false;")]),
        "no overlap in a warpgroup": _replace(src, [
            ("    wgmma_commit();\n    wgmma_wait1();",
             "    wgmma_commit();\n    wgmma_wait0();")]),
    }


def _ptxas(report: str):
    for chunk in report.split("Compiling entry function")[1:]:
        if "flash_kernel_wideI13__nv_bfloat16" in chunk[:300]:
            t = re.sub(r"\s+", " ", chunk)
            stack, st, ld, regs = re.search(
                r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) "
                r"bytes spill loads.*?Used (\d+) registers", t).groups()
            return {"registers": int(regs), "stack_bytes": int(stack),
                    "spill_store_bytes": int(st), "spill_load_bytes": int(ld)}
    raise AssertionError("no bf16 wide kernel in the ptxas report")


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import chip_smoke as smoke
    torch = smoke.torch
    if not torch.cuda.is_available():
        print("wide_flash_variants: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    build = smoke.build
    src = (build.CSRC / "flash_attention.cu").read_text()
    out = {}
    dirs = {}
    for name, text in variants(src).items():
        d = ROOT / "build" / "wide_flash_variants" / re.sub(r"\W+", "_", name)
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        (d / "flash_attention.cu").write_text(text)
        build.CSRC, build.BUILD_DIR, build._loaded = d, d / "lib", {}
        build.build(["flash_attention"])
        report = build.ptxas_report("flash_attention")
        out[name] = {"ptxas": _ptxas(report),
                     "serialised": sorted({m for m in re.findall(
                         r"\(C751\d\)", report)}),
                     "cases": {}}
        dirs[name] = d
    with torch.no_grad():
        for _ in range(ROUNDS):
            for name, d in dirs.items():
                build.CSRC, build.BUILD_DIR, build._loaded = d, d / "lib", {}
                for dt, hd, h, hkv in SHAPES:
                    rec = smoke.flash_case(
                        f"{name}: head_dim {hd} causal S=1024 {h}/{hkv}",
                        sq=1024, skv=1024, h=h, hkv=hkv, d=hd, causal=True,
                        dtype=getattr(torch, dt), seed=77)
                    out[name]["cases"].setdefault(
                        f"{dt} {h}/{hkv}", []).append(
                        (rec["kernel_ms"], rec["library_ms"],
                         rec["max_rel_err"]))
    for v in out.values():
        for case, runs in v["cases"].items():
            v["cases"][case] = {
                "kernel_ms": statistics.median(r[0] for r in runs),
                "sdpa_ms": statistics.median(r[1] for r in runs),
                "max_rel_err": max(r[2] for r in runs)}
    print(json.dumps({"card": card, "variants": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
