"""Build the CUDA kernels with nvcc into plain-C shared libraries.

Each ``csrc/*.cu`` compiles on its own (all nvcc processes started
together) for ``sm_90a``, into ``_build/<digest>/lib<name>.so``, where the
digest covers every source and header and the flags: a library is built at
first use and reused while nothing changed.  The libraries export C
functions (``tt_*``) that launch on the stream they are given and return
``cudaGetLastError()``; torchtlc/kernels/ops.py loads them with ctypes.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from typing import Dict, NamedTuple

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
SOURCES = ("expand.cu", "fp64.cu", "fpset.cu", "commit.cu", "slab.cu",
           "deferred.cu", "ring.cu", "coverage.cu", "route.cu")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]


class BuildInfo(NamedTuple):
    libs: Dict[str, str]  # source stem -> shared library path
    logs: Dict[str, str]  # source stem -> nvcc output (ptxas report)


def nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the kernels are "
                       "built from torchtlc/kernels/csrc on the GPU machine")


def _digest(flags) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for name in sorted(os.listdir(CSRC)):
        if name.endswith((".cu", ".cuh")):
            with open(os.path.join(CSRC, name), "rb") as f:
                h.update(name.encode() + f.read())
    return h.hexdigest()[:16]


def build(ptxas_report: bool = False) -> BuildInfo:
    """Build (or find) every kernel library.  ptxas_report adds
    ``-Xptxas -v`` and forces a fresh build, so the logs carry each
    kernel's registers, shared memory and spills."""
    flags = NVCC_FLAGS + (["-Xptxas", "-v"] if ptxas_report else [])
    out_dir = os.path.join(BUILD_DIR, _digest(flags))
    os.makedirs(out_dir, exist_ok=True)
    libs = {os.path.splitext(s)[0]: os.path.join(
        out_dir, f"lib{os.path.splitext(s)[0]}.so") for s in SOURCES}
    todo = [s for s in SOURCES if ptxas_report
            or not os.path.exists(libs[os.path.splitext(s)[0]])]
    procs = {}
    for s in todo:
        stem = os.path.splitext(s)[0]
        tmp = f"{libs[stem]}.{os.getpid()}.tmp"
        procs[stem] = (tmp, subprocess.Popen(
            [nvcc(), *flags, "-I", CSRC, "-o", tmp, os.path.join(CSRC, s)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    logs, failed = {}, []
    for stem, (tmp, proc) in procs.items():
        out, err = proc.communicate()
        logs[stem] = out + err
        if proc.returncode != 0:
            failed.append(f"{stem}.cu (rc {proc.returncode}):\n{out}{err}")
        else:
            os.replace(tmp, libs[stem])
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return BuildInfo(libs, logs)
