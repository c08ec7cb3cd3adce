"""The struct path's device coverage plane against the reference's, with
zero tolerance:

* the site table (key, kind, action, loc) of the port's walk equals
  jaxtlc's on TwoPhase Model_1, Model_sym and RaftReplication Model_1 -
  the action prefix, then the walk's sites in registration order, the `?`
  group of pre-label binders included;
* kernel K22 as g++ builds it from the emitted text, and its plain
  version, equal the reference's coverage count (cov_fn and the
  action-prefix fold) on popped blocks of reachable states whose last
  rows are not popped;
* `site_coverage` after full runs equals the reference's, sorted
  immediate and slab deferred, single-device and on 2 shards, and the
  counts equal the coverage-off run's;
* the dead-site lint's events equal the reference's on a seeded table.
"""

import ctypes
import os

import jax
import jax.numpy as jjnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from jaxtlc.api import _struct_dead_sites as j_dead_sites
from jaxtlc.struct.cache import get_backend as j_get_backend
from jaxtlc.struct.engine import check_struct as j_check
from jaxtlc.struct.engine import check_struct_sharded as j_check_sharded
from jaxtlc.struct.loader import load as j_load
from torchtlc.api import _struct_dead_sites
from torchtlc.engine.sharded import ShardMesh
from torchtlc.kernels.build import build_struct
from torchtlc.struct import oracle
from torchtlc.struct.cache import get_backend
from torchtlc.struct.engine import check_struct, check_struct_sharded
from torchtlc.struct.loader import load
from torchtlc.testing import one_thread

one_thread()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = {"TwoPhase": ("TwoPhase.toolbox/Model_1", 64),
          "TwoPhase_sym": ("TwoPhase.toolbox/Model_sym", 64),
          "RaftReplication": ("RaftReplication.toolbox/Model_1", 256)}
SAMPLE = 512


def _cfg(name):
    return os.path.join(ROOT, "specs", MODELS[name][0], "MC.cfg")


def _site_tuples(plane):
    return [(s.key, s.kind, s.action, s.loc) for s in plane.sites]


@pytest.mark.parametrize("name", list(MODELS))
def test_site_table_equals_reference(name):
    mine = get_backend(load(_cfg(name)), False, coverage=True).coverage
    ref = j_get_backend(j_load(_cfg(name)), False, coverage=True).coverage
    assert _site_tuples(mine) == _site_tuples(ref)
    assert mine.module == ref.module
    kinds = {s.kind for s in mine.sites}
    assert {"action", "guard", "effect", "unchanged", "quant"} <= kinds


def _host_count(cov, block, n, valid):
    lib = ctypes.CDLL(build_struct(cov.text, host=True))
    lib.host_struct_cov_count.argtypes = [ctypes.c_void_p] * 2 + [
        ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
    out = np.zeros(cov.n_sites, np.uint32)
    bl = np.ascontiguousarray(block)
    va = np.ascontiguousarray(valid)

    def p(a):
        return a.ctypes.data_as(ctypes.c_void_p)

    lib.host_struct_cov_count(p(cov.K), p(bl), block.shape[0], n, p(va),
                              p(out))
    return out


@pytest.mark.parametrize("name", list(MODELS))
def test_k22_host_build_and_plain_equal_reference(name):
    """One popped block of reachable states (a seeded sample of at most
    512), its last 3 rows outside the pop: the reference's count on the
    unpacked fields, the pop mask and the masked valid lanes; the port's
    plain version and the g++ build of K22 on the packed block and the
    expand stage's valid flags."""
    m = load(_cfg(name))
    backend = get_backend(m, False, coverage=True)
    prog, cov = backend.kernels.prog, backend.kernels.cov
    r = oracle.bfs(m.system, m.invariants, collect_states=True,
                   check_deadlock=False, stop_on_violation=False)
    rows = np.stack([prog.cdc.encode(s) for s in r.states]).astype(np.int32)
    if len(rows) > SAMPLE:
        rows = rows[np.sort(np.random.default_rng(7).choice(
            len(rows), SAMPLE, replace=False))]
    ck = rows.shape[0]
    n = ck - 3
    block = prog.cdc.pack(torch.from_numpy(rows))
    flags = prog.expand_plain(block, n)[1]
    valid = flags[0]
    ref_plane = j_get_backend(j_load(_cfg(name)), False,
                              coverage=True).coverage
    mask = np.arange(ck) < n
    want = np.asarray(jax.jit(ref_plane.count)(
        jjnp.asarray(rows), jjnp.asarray(mask),
        jjnp.asarray(valid.numpy().reshape(ck, prog.L).astype(bool))))
    assert want.dtype == np.uint32 and want.shape == (cov.n_sites,)
    got = cov.count_plain(block, n, valid).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, want)
    host = _host_count(cov, block.numpy(), n, valid.numpy())
    np.testing.assert_array_equal(host, want)
    assert want[len(backend.labels):].any()


RUNS = [(name, mode) for name in MODELS for mode in ("sorted", "slab")]


@pytest.mark.parametrize("name,mode", RUNS,
                         ids=[f"{n}-{m}" for n, m in RUNS])
def test_site_coverage_equals_reference(name, mode):
    """A full covered run on one device: site_coverage equals the
    reference's; counts and per-action counts equal the coverage-off
    run's (the plane is telemetry)."""
    ck = MODELS[name][1]
    kw = dict(chunk=ck, queue_capacity=1 << 14, fp_capacity=1 << 15,
              check_deadlock=False)
    if mode == "slab":
        kw.update(sort_free=True, deferred=True)
    m = load(_cfg(name))
    r = check_struct(m, device="cpu", coverage=True, **kw)
    ref = j_check(j_load(_cfg(name)), coverage=True, **kw)
    assert r.site_coverage == ref.site_coverage
    off = check_struct(m, device="cpu", **kw)
    assert (r.generated, r.distinct, r.depth, r.action_generated,
            r.action_distinct) == (off.generated, off.distinct, off.depth,
                                   off.action_generated, off.action_distinct)
    assert off.site_coverage is None


@pytest.mark.parametrize("name", ["TwoPhase", "TwoPhase_sym"])
def test_sharded_site_coverage_equals_reference(name):
    """-sharded 2: the summed shard vectors equal the reference's sharded
    run and the single-device vector."""
    kw = dict(chunk=32, queue_capacity=1 << 12, fp_capacity=1 << 13,
              check_deadlock=False)
    m = load(_cfg(name))
    r = check_struct_sharded(m, ShardMesh(2, "cpu"), coverage=True, **kw)
    mesh = Mesh(np.array(jax.devices()[:2]), ("fp",))
    ref = j_check_sharded(j_load(_cfg(name)), mesh, coverage=True, **kw)
    assert r.site_coverage == ref.site_coverage
    single = check_struct(m, device="cpu", coverage=True, **kw)
    assert r.site_coverage == single.site_coverage


def test_dead_site_lint_equals_reference():
    """A fired site seeded to zero becomes a warning `analysis` event,
    the reference's event for event; a fully visited table lints
    nothing."""
    m = load(_cfg("TwoPhase"))
    plane = get_backend(m, False, coverage=True).coverage
    r = check_struct(m, chunk=64, queue_capacity=1 << 10,
                     fp_capacity=1 << 12, check_deadlock=False,
                     device="cpu", coverage=True)
    fired = [k for k, v in r.site_coverage.items() if v and "." in k]
    seeded = dict(r.site_coverage)
    for k in fired[:2]:
        seeded[k] = 0

    class _Spec:
        check_deadlock = False

    class _Args:
        pass

    jm = j_load(_cfg("TwoPhase"))
    ref = j_dead_sites(_Args(), _Spec(), jm, None,
                       r._replace(site_coverage=seeded))
    counts = [seeded[s.key] for s in plane.sites]
    mine = _struct_dead_sites(m, plane, counts)
    assert mine == ref and {e["subject"] for e in mine} >= set(fired[:2])
    full = [max(1, seeded[s.key]) for s in plane.sites]
    assert _struct_dead_sites(m, plane, full) == []
