"""Time variants of a wide flash kernel against the kernel as written.

Usage, from the root of a checkout on a machine with an H100:

    python3 scripts/wide_flash_variants.py [--kernel bf16|fp32]

Each variant is the flash source (``kernels/csrc/flash_attention.cu``)
with one design choice of the kernel undone by a text replacement (in
the kernel's own code, or in the whole source where marked), built into
a directory of its own under ``build/wide_flash_variants/<kernel>/``
(the builds run together).

``bf16`` (the default), ``wide::flash_kernel_wide``, bf16/fp16 at head
dims 144 to 256:

- ``as written``;
- ``trap inlined`` (whole source): the barrier wait's one-second trap
  inlined in the kernels' bodies;
- ``wait noreturn``: the kernel's waits trap through ``wait_failed``,
  which does not return, as the other kernels' do;
- ``mirror pairs always`` and ``neighbour pairs always``: the pairing
  of q units (and its launch order) fixed, where the kernel takes the
  mirror pairs for a launch of one wave and the neighbour pairs past it;
- ``no overlap in a warpgroup``: each round waits for P·V as well before
  its softmax.

``fp32``, ``f32::flash_fp32_kernel_wide``, fp32 at head_dims 144 to 256:

- ``as written``;
- ``trap inlined`` (whole source), as above;
- ``registers 56/224``: the producer's and consumers' ``setmaxnreg``
  (72/216 as written);
- ``K ring 2, V ring 3``: the depths of the two rings (3 and 2 as
  written; both fit the shared memory);
- ``one split load in flight``: a splitting thread loads one 16-byte
  step of K at a time (four as written);
- ``no softmax under P·V``: each round waits for P·V as well before its
  exchange and softmax;
- ``no split stores`` (wrong output, a measure of the split's cost): the
  splitting warps load K but store no lo.

For each variant it prints what ``ptxas -v`` said of the kernel
(``chip_smoke.ptxas_entries``: registers, spill bytes, the C751x notes
of wgmma serialised) and, at causal S 1024 at each of the kernel's
``SHAPES``, its ms (CUDA events with the queue filled ahead,
``chip_smoke.time_ms``), the median of ``ROUNDS`` rounds that take the
variants in turns, and the largest row error against the plain version;
the last line is one JSON object with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import json
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ROUNDS = 3
TRAP = ("    if (now_ns() - t0 > 1000000000ull) {\n"
        "      if constexpr (kReturning) wait_failed_returning();\n"
        "      else wait_failed();\n"
        "    }")


def _bf16_variants():
    return {
        "wait noreturn": [("mbar_wait<true>(bar, parity);",
                           "mbar_wait(bar, parity);")],
        "mirror pairs always": [("return pairs * h * batch <= sms;",
                                 "return true;")],
        "neighbour pairs always": [("return pairs * h * batch <= sms;",
                                    "return false;")],
        "no overlap in a warpgroup": [
            ("    wgmma_commit();\n    wgmma_wait1();",
             "    wgmma_commit();\n    wgmma_wait0();")],
    }


def _fp32_variants():
    return {
        "registers 56/224": [
            ("setmaxnreg.dec.sync.aligned.u32 72;",
             "setmaxnreg.dec.sync.aligned.u32 56;"),
            ("setmaxnreg.inc.sync.aligned.u32 216;",
             "setmaxnreg.inc.sync.aligned.u32 224;")],
        "K ring 2, V ring 3": [
            ("constexpr int kWideKStages = 3;",
             "constexpr int kWideKStages = 2;"),
            ("constexpr int kWideVStages = 2;",
             "constexpr int kWideVStages = 3;")],
        "one split load in flight": [("constexpr int kBatch = 4;",
                                      "constexpr int kBatch = 1;")],
        "no softmax under P·V": [
            ("    wgmma_commit();\n    wide::wgmma_wait1();\n    keep(hh);",
             "    wgmma_commit();\n    wgmma_wait0();\n    keep(hh);")],
        "no split stores": [
            ("          sts4(kst + (f / 128) * L::KBOX + 16 * (f % 128) + "
             "L::KROWS,",
             "          if (n < 0) sts4(kst + (f / 128) * L::KBOX + 16 * "
             "(f % 128) + L::KROWS,")],
    }


#: per kernel: the markers around its code, its ptxas entry, its
#: variants and its shapes (dtype name, head_dim, q heads, kv heads)
KERNELS = {
    "bf16": {"code": ("namespace wide {", "}  // namespace wide"),
             "entry": "flash_kernel_wideI13__nv_bfloat16",
             "variants": _bf16_variants,
             "shapes": [("bfloat16", 256, 16, 16), ("bfloat16", 256, 16, 8),
                        ("bfloat16", 256, 32, 32), ("float16", 256, 32, 32),
                        ("bfloat16", 144, 32, 8), ("bfloat16", 192, 32, 8)]},
    "fp32": {"code": ("constexpr int kWideBM = 64;", "}  // namespace f32"),
             "entry": "flash_fp32_kernel_wide",
             "variants": _fp32_variants,
             "shapes": [("float32", 256, 16, 16), ("float32", 256, 16, 8),
                        ("float32", 256, 32, 32), ("float32", 144, 32, 8),
                        ("float32", 192, 32, 8)]},
}


def _replace(src: str, pairs, span=None) -> str:
    """``src`` with each (old, new) of ``pairs`` replaced, each old found
    exactly once between the markers ``span`` (else in the whole
    source)."""
    a, b = (src.index(span[0]), src.index(span[1])) if span else \
        (0, len(src))
    w = src[a:b]
    for old, new in pairs:
        if w.count(old) != 1:
            raise ValueError(f"not found once: {old!r}")
        w = w.replace(old, new)
    return src[:a] + w + src[b:]


def variants(src: str, kernel: str):
    spec = KERNELS[kernel]
    out = {"as written": src,
           "trap inlined": _replace(src, [
               (TRAP, "    if (now_ns() - t0 > 1000000000ull) __trap();")])}
    for name, pairs in spec["variants"]().items():
        out[name] = _replace(src, pairs, spec["code"])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernel", choices=sorted(KERNELS), default="bf16")
    kernel = ap.parse_args(argv).kernel
    spec = KERNELS[kernel]
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
    dirs = {}
    for name, text in variants(src, kernel).items():
        d = ROOT / "build" / "wide_flash_variants" / kernel / re.sub(
            r"\W+", "_", name)
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        (d / "flash_attention.cu").write_text(text)
        dirs[name] = d

    def build_one(name):
        d = dirs[name]
        # build.build reads the module's CSRC and BUILD_DIR: one process
        # each, so the builds run together
        code = ("import sys; sys.path.insert(0, 'src');"
                "from repro_torch.kernels import build;"
                f"build.CSRC = __import__('pathlib').Path({str(d)!r});"
                "build.BUILD_DIR = build.CSRC / 'lib';"
                "build.build(['flash_attention'])")
        subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True)

    with concurrent.futures.ThreadPoolExecutor(len(dirs)) as ex:
        list(ex.map(build_one, dirs))
    out = {}
    for name, d in dirs.items():
        build.CSRC, build.BUILD_DIR, build._loaded = d, d / "lib", {}
        entry = next(e for e in smoke.ptxas_entries("flash_attention")
                     if spec["entry"] in e["entry"])
        out[name] = {"ptxas": {k: entry[k] for k in (
            "registers", "stack_bytes", "spill_store_bytes",
            "spill_load_bytes", "wgmma_serialized")}, "cases": {}}
    inputs = {}
    for dt, hd, h, hkv in spec["shapes"]:
        g = torch.Generator(device="cuda").manual_seed(77)
        inputs[f"{dt} {h}/{hkv} head_dim {hd}"] = tuple(
            torch.randn(1, 1024, n, hd, generator=g, device="cuda").to(
                getattr(torch, dt)) for n in (h, hkv, hkv))
    names = list(dirs)
    with torch.no_grad():
        for r in range(ROUNDS):
            for name in names[r % len(names):] + names[:r % len(names)]:
                d = dirs[name]
                build.CSRC, build.BUILD_DIR, build._loaded = d, d / "lib", {}
                for case, (q, k, v) in inputs.items():
                    def call():
                        return smoke.flash_ops.flash_attention(
                            q, k, v, causal=True)
                    ms = smoke.time_ms(call, 20, queue_ahead=True)
                    want = smoke.flash_ops.flash_attention_ref(
                        q.float(), k.float(), v.float(), causal=True)
                    rel = float(smoke.row_rel_err(call(), want).max())
                    out[name]["cases"].setdefault(case, []).append((ms, rel))
    for v in out.values():
        for case, runs in v["cases"].items():
            v["cases"][case] = {
                "kernel_ms": statistics.median(r[0] for r in runs),
                "max_rel_err": max(r[1] for r in runs)}
    print(json.dumps({"card": card, "kernel": kernel, "variants": out}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
