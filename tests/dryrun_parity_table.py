"""The dry run's parity cells, the port's records beside the reference's.

Run from the root of the repo:

    PYTHONPATH=src python tests/dryrun_parity_table.py

Runs ``dryrun_reference.py`` (the reference's dry run, in a subprocess)
and the port's ``run_cell`` on ``test_torch_dryrun.PARITY``, and prints
a markdown table of FLOPs, bytes accessed, transcendentals, argument,
output and temp bytes and collective bytes by kind, each the port's, the
reference's and their ratio, and the port's FLOPs outside its batched
products (the attention's blocks, which the reference's cost analysis
counts once, its loop body), then the ``RATIOS`` that the test pins.
"""
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import test_torch_dryrun as t  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402


def reference_records():
    with tempfile.TemporaryDirectory() as work:
        cells = os.path.join(work, "cells.json")
        with open(cells, "w") as f:
            json.dump([list(c) + [t.PRESET] for c in t.PARITY], f)
        out = os.path.join(work, "out.json")
        subprocess.run([sys.executable, os.path.join(HERE,
                                                     "dryrun_reference.py"),
                        out, cells], check=True, capture_output=True)
        with open(out) as f:
            return json.load(f)


def quantities(rec):
    out = {"flops": rec["cost"]["flops"],
           "bytes accessed": rec["cost"]["bytes accessed"],
           "transcendentals": rec["cost"]["transcendentals"]}
    for k in ("argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes"):
        out[k.split("_")[0] + " bytes"] = rec["memory"][k]
    for k in dryrun.COLLECTIVES:
        out[k] = rec["collectives"][k]["bytes"]
    return out


def bmm_flops(cell):
    """The port's FLOPs in batched products (``aten.bmm``: the attention's
    scores and values, the MoE's expert down projection), from the
    op-level trace of the cell."""
    arch, shape, multi_pod = cell
    with tempfile.TemporaryDirectory() as work:
        trace = os.path.join(work, "trace.txt")
        dryrun.run_cell(arch, shape, multi_pod=multi_pod,
                        settings=dryrun.SETTINGS_PRESETS[t.PRESET],
                        depth_override=t._depth(arch), save_hlo=trace)
        with open(trace) as f:
            return sum(int(line.rsplit("flops=", 1)[1]) for line in f
                       if line.startswith("  aten.bmm") and "flops=" in line)


def main():
    reference = reference_records()
    ratios = {}
    print("| cell | quantity | port | reference | port / reference |")
    print("|---|---|---|---|---|")
    for cell in t.PARITY:
        got = t._port_record(*cell)
        want = t._ref_record(reference, cell)
        for k, a in quantities(got).items():
            b = quantities(want)[k]
            r = f"{a / b:.4g}" if b else "ref 0"
            print(f"| {t._cell_id(cell)} | {k} | {a:.6g} | {b:.6g} | {r} |")
        bmm = bmm_flops(cell)
        print(f"| {t._cell_id(cell)} | flops outside aten.bmm | "
              f"{got['cost']['flops'] - bmm:.6g} | "
              f"{want['cost']['flops']:.6g} | "
              f"{(got['cost']['flops'] - bmm) / want['cost']['flops']:.4g} |")
        ratios[t._cell_id(cell)] = t._ratios(got, want)
    print("\nRATIOS = {")
    for cell, rs in ratios.items():
        print(f'    "{cell}": {{')
        for k, v in rs.items():
            text = repr(v) if isinstance(v, tuple) else f"{v:.4g}"
            print(f'        "{k}": {text},')
        print("    },")
    print("}")


if __name__ == "__main__":
    main()
