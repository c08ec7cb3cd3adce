"""Build the CUDA kernels with nvcc into plain-C shared libraries.

Each ``csrc/*.cu`` compiles on its own (all nvcc processes started
together) for ``sm_90a``, into ``_build/<digest>/lib<name>.so``, where the
digest covers every source and header and the flags: a library is built at
first use and reused while nothing changed.  The libraries export C
functions (``tt_*``) that launch on the stream they are given and return
``cudaGetLastError()``; torchtlc/kernels/ops.py loads them with ctypes.

The second route, ``build_struct``, builds one spec's emitted kernels -
K17 of a struct spec or K19 of a generic one, each with K18 and K21
(struct_inv_rows.cuh, emitted_sharded.cuh, which both templates
include) and K23 (struct_cert.cuh, which struct_inv_rows.cuh includes:
the runtime certificate of a narrowed struct spec) and K24-K26
(struct_reduce.cuh, which emitted_sharded.cuh includes: the symmetry and
POR reduction) and, in a struct spec's, K27 and K28 (emitted_sim.cuh with
threefry.cuh, which struct_expand.cuh includes: the random walk's round)
and K31 (struct_recheck.cuh, which struct_expand.cuh includes: the
artifact cache's invariant re-check) and K32, K34 and K35
(emitted_batched.cuh, which struct_expand.cuh includes last: the serving
plane's batched expand and walk round),
K20 of a generic spec's temporal operands, K22 of a struct spec's
coverage conditions, K29 / K30 of an inference run's candidate
predicates and K27 / K28 of a generic spec's walk (gen_sim.cuh, a second
text of the spec, built only by a walk): the C++ that torchtlc.struct.emit
prints around a hand-written template (struct_expand.cuh, gen_expand.cuh,
gen_masks.cuh, struct_cov.cuh, struct_infer.cuh, gen_sim.cuh) goes to
``_build/struct/<digest>/spec.cu``, where the digest covers the text,
the templates and the flags; nvcc builds it into
``libstruct.so`` for the card, or g++ into ``libstruct_host.so`` for the
host tests.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, NamedTuple

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
SOURCES = ("expand.cu", "fp64.cu", "fpset.cu", "commit.cu", "slab.cu",
           "deferred.cu", "ring.cu", "coverage.cu", "route.cu", "liveness.cu",
           "fpset_batched.cu", "pod.cu", "kube_sim.cu")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]


# what a warm serve submit must not pay for (serve.pool.CompileMeter):
# "builds" counts compiler runs (nvcc or g++, here and in torchtlc.native),
# LaneCompiler constructions and emitted texts (struct.compile,
# struct.emit); "loads" counts shared-library loads (kernels.ops,
# torchtlc.native).  Monotonic per process.
METER = {"builds": 0, "loads": 0}
_METER_LOCK = threading.Lock()


def meter(kind: str, n: int = 1) -> None:
    with _METER_LOCK:
        METER[kind] += n


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


def _digest(flags, csrc: str) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for name in sorted(os.listdir(csrc)):
        if name.endswith((".cu", ".cuh")):
            with open(os.path.join(csrc, name), "rb") as f:
                h.update(name.encode() + f.read())
    return h.hexdigest()[:16]


def build(ptxas_report: bool = False, csrc: str = CSRC) -> BuildInfo:
    """Build (or find) every kernel library.  ptxas_report adds
    ``-Xptxas -v`` and forces a fresh build, so the logs carry each
    kernel's registers, shared memory and spills.  csrc: another source
    tree of the same files (chip_kernel_ab.py times an earlier one)."""
    flags = NVCC_FLAGS + (["-Xptxas", "-v"] if ptxas_report else [])
    out_dir = os.path.join(BUILD_DIR, _digest(flags, csrc))
    os.makedirs(out_dir, exist_ok=True)
    libs = {os.path.splitext(s)[0]: os.path.join(
        out_dir, f"lib{os.path.splitext(s)[0]}.so") for s in SOURCES}
    todo = [s for s in SOURCES if ptxas_report
            or not os.path.exists(libs[os.path.splitext(s)[0]])]
    procs = {}
    for s in todo:
        stem = os.path.splitext(s)[0]
        tmp = f"{libs[stem]}.{os.getpid()}.tmp"
        meter("builds")
        procs[stem] = (tmp, subprocess.Popen(
            [nvcc(), *flags, "-I", csrc, "-o", tmp, os.path.join(csrc, s)],
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


STRUCT_TEMPLATES = ("common.cuh", "struct_prelude.cuh", "struct_codec.cuh",
                    "struct_expand.cuh", "gen_expand.cuh", "gen_masks.cuh",
                    "struct_inv_rows.cuh", "emitted_sharded.cuh",
                    "struct_cov.cuh", "struct_cert.cuh", "struct_reduce.cuh",
                    "emitted_sim.cuh", "threefry.cuh", "struct_infer.cuh",
                    "struct_recheck.cuh", "emitted_batched.cuh",
                    "gen_sim.cuh")
HOST_FLAGS = ["-x", "c++", "-O1", "-std=c++17", "-shared", "-fPIC"]


def build_struct(text: str, host: bool = False) -> str:
    """Build (or find) one emitted library (K17/K18, K19, K20, K22,
    K29/K30 or a generic spec's K27/K28) from its text: nvcc for sm_90a,
    or g++ with host=True.  Returns the library path; raises with the
    compiler's output when the build fails.  nvcc runs with ``-Xptxas
    -v``: its report (each kernel's registers, stack frame and spills) is
    kept beside the library as ``nvcc.log``."""
    flags = HOST_FLAGS if host else NVCC_FLAGS + ["-Xptxas", "-v"]
    h = hashlib.sha256(" ".join(flags).encode() + text.encode())
    for name in STRUCT_TEMPLATES:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + f.read())
    out_dir = os.path.join(BUILD_DIR, "struct", h.hexdigest()[:16])
    lib = os.path.join(out_dir,
                       "libstruct_host.so" if host else "libstruct.so")
    if os.path.exists(lib):
        return lib
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(out_dir, "spec.cu")
    tmp_src = f"{src}.{os.getpid()}.tmp"
    with open(tmp_src, "w") as f:
        f.write(text)
    os.replace(tmp_src, src)
    tmp = f"{lib}.{os.getpid()}.tmp"
    cc = "g++" if host else nvcc()
    meter("builds")
    proc = subprocess.run([cc, *flags, "-I", CSRC, "-o", tmp, src],
                          stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{cc} failed on {src} (rc {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    if not host:
        with open(os.path.join(out_dir, "nvcc.log"), "w") as f:
            f.write(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib
