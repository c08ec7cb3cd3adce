"""Exhaustive checking of struct-compiled specs on the port's engine (port
of jaxtlc/struct/engine.py, single device).

The struct backend (struct.backend) plugs into the same engine the
KubeAPI path uses (engine.bfs.make_backend_engine): its expand stage is
kernel K17 and its deferred invariant check kernel K18, everything else -
fingerprints, the fingerprint set in both dedup modes, the enqueue, the
counter ring - is the engine's.  Runs on the card unless ``device`` says
otherwise.  ``check_struct_sharded`` runs the same backend on the sharded
engine (engine.sharded: D fingerprint-space shards in one process, kernel
K21 for the emitted step over the shards' raw queue rows and K18 on each
owner's received rows).  ``coverage=True`` carries the device coverage
plane (kernel K22 per popped block, CheckResult.site_coverage) on both
engines; ``pipeline=True`` runs the pipelined body.  ``bounds`` (a
certified analysis.absint.BoundReport, ``-narrow``) runs the narrowed
compile: on one device with the runtime certificate (kernel K23 inside
K17 and K18, CheckResult.cert_violated), on the sharded engine with every
trap kept and no certificate, as the reference.  ``symmetry`` and ``por``
(tri-state, auto OFF: engine.bfs.resolve_symmetry / resolve_por) run the
reduced backend: every candidate canonicalized (kernel K24 inside K17 and
K21) and pruned to singleton ample sets (K26), the orbit check (K25) on
one device - CheckResult.sym_violated and por_pruned.
"""

from __future__ import annotations

import time

import torch

from ..engine.bfs import CheckResult, make_backend_engine, result_from_carry
from ..engine.fingerprint import DEFAULT_FP_INDEX
from .cache import get_backend
from .loader import StructModel


def build_kernels(backend) -> None:
    """Build (or load) a struct backend's emitted libraries: K17/K18/K21,
    and K22 when it carries the coverage plane."""
    from ..kernels import ops

    ops.struct_lib(backend.kernels.prog)
    if backend.kernels.cov is not None:
        ops.struct_cov_lib(backend.kernels.cov)


def check_struct(
    model: StructModel,
    chunk: int = 1024,
    queue_capacity: int = 1 << 15,
    fp_capacity: int = 1 << 20,
    fp_index: int = DEFAULT_FP_INDEX,
    check_deadlock: bool = True,
    obs_slots: int = 0,
    sort_free: bool = None,
    deferred: bool = None,
    capture_fps: bool = False,
    device=None,
    coverage: bool = False,
    pipeline: bool = False,
    bounds=None,
    symmetry: bool = None,
    por: bool = None,
) -> CheckResult:
    """Exhaustive check of a struct-compiled spec on `device` (None = the
    card).  sort_free and deferred are tri-state (None = auto: on at
    chunk >= 2048, as the reference resolves them); obs_slots > 0 carries
    the counter ring; capture_fps reads the final fingerprint table back
    to the host on a clean verdict (CheckResult.fp_table); coverage
    carries the device coverage plane (CheckResult.site_coverage);
    pipeline runs the pipelined body; bounds (a certified BoundReport)
    runs the narrowed engine with the runtime certificate on; symmetry and
    por (tri-state, auto off) the reduced one.  wall_s times the run only:
    the backend is compiled and its kernels built before it."""
    from ..engine.bfs import resolve_por, resolve_symmetry

    backend = get_backend(model, check_deadlock, bounds=bounds,
                          coverage=coverage,
                          symmetry=resolve_symmetry(symmetry, chunk),
                          por=resolve_por(por, chunk))
    init_fn, run_fn, _ = make_backend_engine(
        backend, chunk, queue_capacity, fp_capacity, obs_slots=obs_slots,
        sort_free=sort_free, deferred=deferred, device=device,
        fp_index=fp_index, pipeline=pipeline)
    carry = init_fn()
    if carry.queue.is_cuda:
        build_kernels(backend)  # before the clock
        torch.cuda.synchronize()
    t0 = time.time()
    carry = run_fn(carry)
    if carry.queue.is_cuda:
        torch.cuda.synchronize()
    wall = time.time() - t0
    result = result_from_carry(
        carry, wall, iterations=run_fn.steps, fp_capacity=fp_capacity,
        labels=backend.labels, viol_names=backend.viol_names,
        sites=backend.coverage.sites if backend.coverage else None,
    )
    if capture_fps and result.violation == 0:
        result = result._replace(
            fp_table=carry.fps.table.cpu().numpy().view("uint32"))
    return result


def check_struct_sharded(
    model: StructModel,
    mesh,
    chunk: int = 512,
    queue_capacity: int = 1 << 14,
    fp_capacity: int = 1 << 18,
    route_factor: float = 2.0,
    check_deadlock: bool = True,
    pipeline: bool = False,
    obs_slots: int = 0,
    sort_free: bool = None,
    deferred: bool = None,
    coverage: bool = False,
    bounds=None,
    symmetry: bool = None,
    por: bool = None,
) -> CheckResult:
    """Exhaustive sharded check of a struct-compiled spec over `mesh`
    (engine.sharded.ShardMesh; jaxtlc/struct/engine.py:108): capacities
    PER SHARD, the modes resolved against the per-shard chunk.  `bounds`
    narrows the codec with every trap kept (elide=False): the sharded
    engine carries no certificate.  `symmetry` / `por` (tri-state, auto
    off) canonicalize and prune before routing, with no orbit check and no
    pruned count, as the reference.  wall_s times the run only: the
    backend's kernels are built before it."""
    from ..engine.bfs import resolve_device, resolve_por, resolve_symmetry
    from ..engine.sharded import check_sharded

    backend = get_backend(model, check_deadlock, bounds=bounds, elide=False,
                          coverage=coverage,
                          symmetry=resolve_symmetry(symmetry, chunk),
                          por=resolve_por(por, chunk))
    if resolve_device(mesh.device).type == "cuda":
        build_kernels(backend)  # before the clock
    return check_sharded(
        None, mesh, chunk=chunk, queue_capacity=queue_capacity,
        fp_capacity=fp_capacity, route_factor=route_factor,
        backend=backend, pipeline=pipeline, obs_slots=obs_slots,
        sort_free=sort_free, deferred=deferred)
