"""Build and load the port's hand-written CUDA kernels.

Each source under ``csrc/`` is compiled by ``nvcc`` into a shared
library with a plain C interface and loaded with ``ctypes`` (no
PyTorch headers, so a build takes seconds).  Libraries go to
``build/ompi_tpu_torch/`` at the root of the checkout, named by a hash
of the source, the shared headers (``csrc/*.cuh``) and the flags: a
changed source or header builds anew, an unchanged one is loaded as it
is.  ``build_all`` starts one ``nvcc``
for each source, all at once.

The build runs at first use; there is no other build step.  A traced
rank (ompi_tpu_torch/trace) records a library's first-use build and
load as a ``kernel_load`` span under the compile category — the port's
counterpart of the reference's ``xla_compile``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List, Tuple

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_PKG)), "build",
                         "ompi_tpu_torch")
SOURCES = {"stacked": "stacked.cu", "fused": "fused.cu", "index": "index.cu",
           "mesh": "mesh.cu", "rma": "rma.cu", "digest": "digest.cu",
           "entry": "entry.cu"}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, else nvcc on PATH, else
    the toolkit's default install place."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME); the port's CUDA "
                       "kernels are built from source at first use")


def _paths(name: str) -> Tuple[str, str, str]:
    src = os.path.join(CSRC, SOURCES[name])
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for path in [src] + [os.path.join(CSRC, f) for f in headers]:
        with open(path, "rb") as fh:
            h.update(fh.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    tag = h.hexdigest()[:16]
    lib = os.path.join(BUILD_DIR, f"lib{name}-{tag}.so")
    return src, lib, lib[:-3] + ".ptxas.txt"


def build_all(names: List[str] = None) -> Dict[str, str]:
    """Compile every named source that has no up-to-date library, one
    nvcc process for each, all started together.  Returns name -> the
    compiler's output (ptxas register / shared-memory / spill report)
    for every source, built now or earlier."""
    names = list(SOURCES) if names is None else names
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        src, lib, log = _paths(name)
        if os.path.exists(lib):
            continue
        tmp = f"{lib}.{os.getpid()}.{threading.get_ident()}.tmp"
        procs[name] = (subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-o", tmp, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, lib, log)
    for name, (p, tmp, lib, log) in procs.items():
        out, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {SOURCES[name]} "
                               f"(exit {p.returncode}):\n{out}")
        with open(log, "w") as fh:
            fh.write(out)
        os.replace(tmp, lib)  # atomic: a concurrent loader sees all or none
    reports = {}
    for name in names:
        _, _, log = _paths(name)
        with open(log) as fh:
            reports[name] = fh.read()
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library for source ``name``, built first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            from ompi_tpu_torch import trace
            tr = trace.current_tracer()
            t0 = tr.start() if tr is not None else 0
            path = _paths(name)[1]
            if not os.path.exists(path):
                build_all([name])
            lib = _libs[name] = ctypes.CDLL(path)
            if t0:
                tr.end(t0, trace.NAME_KERNEL_LOAD, trace.CAT_COMPILE,
                       trace.intern_name(name))
    return lib
