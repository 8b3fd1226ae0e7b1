"""Read two facts of TF32 ``wgmma`` on the card that the fp32 flash kernel
(``src/repro_torch/kernels/csrc/flash_attention.cu``) is built on.

Usage, from the root of a checkout on a machine with an H100:

    python3 scripts/tf32_wgmma_probe.py

Builds ``scripts/tf32_wgmma_probe.cu`` with nvcc into
``build/tf32_wgmma_probe/`` and runs one ``m64n8k8`` product twice
against an 8 x 8 identity B:

- A from registers, each register holding its own (thread, register)
  id: the output places every id, which gives the A-fragment layout
  (the row and column of registers 0-3 relative to 16 w + g and t, for
  warp w, g = lane / 4, t = lane % 4);
- A from shared memory holding fp32 values with bits below TF32's 10
  mantissa bits set: the output shows which TF32 value the tensor core
  used (the full fp32 value, its bits truncated, or rounded to nearest).

Prints the card (``nvidia-smi`` name and power limit) and, as its last
line, one JSON object with both readings.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import build  # noqa: E402


def main():
    if not torch.cuda.is_available():
        print("tf32_wgmma_probe: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip())
    out_dir = ROOT / "build" / "tf32_wgmma_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / "probe.so"
    subprocess.run([build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-shared", "-Xcompiler", "-fPIC", "-o", str(lib_path),
                    str(Path(__file__).with_suffix(".cu"))], check=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.run_probe.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int]
    out = torch.zeros(64, 8, device="cuda")

    x = torch.zeros(64 * 8, device="cuda")
    if lib.run_probe(out.data_ptr(), x.data_ptr(), 0):
        raise RuntimeError("probe launch failed")
    ids = out.cpu().numpy().astype(int)
    layout = {}
    for row in range(64):
        for col in range(8):
            thread, reg = divmod(int(ids[row, col]), 4)
            rel = (row - 16 * (thread // 32) - (thread % 32) // 4,
                   col - thread % 4)
            layout.setdefault(reg, set()).add(rel)

    # 1 + i 2^-14: the 4 bits below TF32's mantissa vary with i
    xs = (1 + np.arange(64 * 8) * 2.0 ** -14).astype(np.float32)
    if lib.run_probe(out.data_ptr(), torch.from_numpy(xs).cuda().data_ptr(),
                     1):
        raise RuntimeError("probe launch failed")
    got = out.cpu().numpy().reshape(-1)
    bits = xs.view(np.uint32).astype(np.uint64)
    trunc = (bits & 0xFFFFE000).astype(np.uint32).view(np.float32)
    rna = ((bits + 0x1000) & 0xFFFFE000).astype(np.uint32).view(np.float32)
    print(json.dumps({
        "a_fragment_register_to_row_col": {
            str(r): sorted(layout[r]) for r in sorted(layout)},
        "fp32_operand_read_as": {"full_fp32": bool((got == xs).all()),
                                 "truncated_to_tf32": bool((got == trunc)
                                                           .all()),
                                 "rounded_to_tf32": bool((got == rna)
                                                         .all())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
