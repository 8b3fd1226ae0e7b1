"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own with ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface (no PyTorch headers, so a
build takes seconds; a source that declares ``constexpr int kParts =
n;`` as n objects in parallel, linked into one library).  ``ptxas
-v``'s report of each kernel (registers, spills, static shared memory)
is kept beside the library (``ptxas_report``).  Libraries go to ``build/repro_torch_kernels/`` at
the root of the checkout, named by a hash of the source, so an edited
source builds anew and an unchanged one loads from disk.  A failed build
raises with nvcc's stderr.  Nothing here runs at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v"]
#: a source's declaration of the objects it is built as, in parallel
#: (``-DREPRO_PART=0`` .. ``n-1``, each holding a share of its kernels),
#: then linked into one library: the paged source's 256 bf16 and fp32
#: kernels took about 93 s in one nvcc on an H100 host, its 384 with fp16
#: 75-79 s in four parts.  (``--split-compile`` builds
#: faster too, but made the paged kernel 7.7% slower at llama2-7b's
#: decode; PERF.md.)
PARTS_DECL = re.compile(rb"^constexpr int kParts = (\d+);", re.M)

_loaded: Dict[str, ctypes.CDLL] = {}


def sources() -> List[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit to build")


def _parts(name: str) -> int:
    """The objects ``csrc/<name>.cu`` is built as (its ``kParts``; 1)."""
    m = PARTS_DECL.search((CSRC / f"{name}.cu").read_bytes())
    return int(m.group(1)) if m else 1


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def _plan(name: str, out: Path, tag: int):
    """The nvcc commands that build ``csrc/<name>.cu`` into ``out``:
    compiles to run together ({label: argv}), then the link of the
    parts' objects (None for a source built whole), and those objects."""
    src = str(CSRC / f"{name}.cu")
    tmp = str(out.with_suffix(f".{tag}.tmp"))
    base = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC)]
    parts = _parts(name)
    if parts == 1:
        return {name: [*base, "-shared", "-o", tmp, src]}, None, []
    objs = [str(out.with_suffix(f".{tag}.{p}.o")) for p in range(parts)]
    compiles = {f"{name} part {p}": [*base, "-c", f"-DREPRO_PART={p}",
                                     "-o", obj, src]
                for p, obj in enumerate(objs)}
    return compiles, [_nvcc(), "-shared", "-o", tmp, *objs], objs


def _run_all(cmds: Dict[str, List[str]]) -> Dict[str, tuple]:
    """Run the commands together: {label: (exit code, stderr)}."""
    procs = {k: subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
             for k, cmd in cmds.items()}
    done = {}
    for k, proc in procs.items():
        err = proc.communicate()[1]
        done[k] = (proc.returncode, err)
    return done


def build(names: Optional[List[str]] = None) -> Dict[str, Path]:
    """Compile the named sources (all by default) that are not built yet:
    one nvcc process per source (per part, for a source of parts),
    all started together, then the links of the parted ones."""
    names = sources() if names is None else names
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: _lib_path(n) for n in names}
    tag = os.getpid()
    plans = {n: _plan(n, out, tag) for n, out in paths.items()
             if not out.exists()}
    compiled = _run_all({k: cmd for compiles, _, _ in plans.values()
                         for k, cmd in compiles.items()})
    linked = _run_all({f"{n} link": link
                       for n, (compiles, link, _) in plans.items()
                       if link and all(compiled[k][0] == 0
                                       for k in compiles)})
    errors = []
    for n, (compiles, link, objs) in plans.items():
        out = paths[n]
        results = {k: compiled[k] for k in compiles}
        if f"{n} link" in linked:
            results[f"{n} link"] = linked[f"{n} link"]
        failed = [f"nvcc failed for {k} (exit {rc}):\n{err}"
                  for k, (rc, err) in results.items() if rc != 0]
        for obj in objs:
            Path(obj).unlink(missing_ok=True)
        if failed:
            errors += failed
            out.with_suffix(f".{tag}.tmp").unlink(missing_ok=True)
            continue
        out.with_suffix(".ptxas.txt").write_text(
            "".join(compiled[k][1] for k in compiles))
        os.replace(out.with_suffix(f".{tag}.tmp"), out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def ptxas_report(name: str) -> str:
    """What ``ptxas -v`` said when ``csrc/<name>.cu`` was built."""
    return _lib_path(name).with_suffix(".ptxas.txt").read_text()


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if need be."""
    lib = _loaded.get(name)
    if lib is None:
        path = build([name])[name]
        lib = ctypes.CDLL(str(path))
        _loaded[name] = lib
    return lib
