"""The port's supervised runs against jaxtlc.resil on the FF corner (CPU):
checkpoints written by either package resume in the other to word-equal
carries; an under-sized table regrows to the reference's events and
table words; SIGTERM and transient faults recover exactly; the host
spill tier (alloc_fail@1) equals the reference's spill run - counts,
spill_hits, ring rows and host-store words; a failing spill write ends
in exhausted + a checkpoint that resumes exactly."""

import os

import numpy as np
import pytest
import torch

from jaxtlc.config import MATRIX as J_MATRIX
from jaxtlc.engine import bfs as jbfs
from jaxtlc.engine import checkpoint as jck
from jaxtlc.engine.spill import SpillStore as JStore
from jaxtlc.resil import FaultPlan as JPlan
from jaxtlc.resil import SupervisorOptions as JOpts
from jaxtlc.resil import check_supervised as j_supervised
from torchtlc.config import MATRIX
from torchtlc.engine import bfs, checkpoint as ck
from torchtlc.engine.interop import FIELDS, OBS_FIELDS, carry_to_numpy
from torchtlc.engine.spill import SpillStore
from torchtlc.resil.faults import FaultPlan, TransientFault, truncate_file
from torchtlc.resil.supervisor import (
    SingleDeviceAdapter,
    SupervisorOptions,
    _probe_grow,
    check_supervised,
    is_resource_exhausted,
)
from torchtlc.resil.faults import FaultInjector

FF = MATRIX[(False, False)]
J_FF = J_MATRIX[(False, False)]
KW = dict(chunk=128, queue_capacity=1 << 12, fp_capacity=1 << 14)
OBS = 16
STEPS = 40  # the segment a checkpoint is cut after


def signature(r):
    return (r.generated, r.distinct, r.depth, r.violation,
            tuple(sorted(r.action_generated.items())),
            tuple(sorted(r.action_distinct.items())), r.outdegree)


def ref_leaves(jc) -> dict:
    """A reference carry's unpipelined + ring leaves as numpy, by field."""
    out = {f: np.asarray(getattr(jc, f)) for f in FIELDS + OBS_FIELDS
           if f != "fps"}
    out["fps"] = np.asarray(jc.fps.table)
    return out


def assert_carries_equal(port_carry, jc):
    mine, ref = carry_to_numpy(port_carry), ref_leaves(jc)
    for name, want in ref.items():
        assert mine[name].dtype == want.dtype, name
        assert np.array_equal(mine[name], want), name


@pytest.fixture(scope="module")
def clean_ff():
    return bfs.check(FF, **KW, device="cpu")


@pytest.fixture(scope="module")
def ref_engine():
    return jbfs.make_engine(J_FF, **KW, obs_slots=OBS, donate=False)


def _port_engine():
    return bfs.make_engine(FF, **KW, obs_slots=OBS, device="cpu")


def _meta():
    return SingleDeviceAdapter(FF, chunk=KW["chunk"], obs_slots=OBS,
                               device="cpu").meta(
        {k: KW[k] for k in ("queue_capacity", "fp_capacity")})


def test_meta_equals_reference_meta():
    want = jck._meta(J_FF, chunk=128, fp_index=51,
                     seed=jbfs.DEFAULT_SEED, fp_highwater=0.85,
                     pipeline=False, obs_slots=OBS, coverage=False,
                     sort_free=False, deferred=False, symmetry=False,
                     por=False, queue_capacity=KW["queue_capacity"],
                     fp_capacity=KW["fp_capacity"])
    assert _meta() == want


def test_port_checkpoint_resumes_in_reference(tmp_path, ref_engine):
    init_fn, run_fn, step_fn = _port_engine()
    carry = bfs.make_segment(step_fn, STEPS)(init_fn())
    path = str(tmp_path / "port.npz")
    ck.save_checkpoint(path, carry, _meta())
    j_init, j_run, _ = ref_engine
    meta, jc = jck.load_checkpoint(path, j_init())
    assert meta["config"] == _meta()["config"]
    assert_carries_equal(carry, jc)
    assert_carries_equal(run_fn(carry), j_run(jc))


def test_reference_checkpoint_resumes_in_port(tmp_path, ref_engine):
    j_init, j_run, j_step = ref_engine
    jc = j_init()
    for _ in range(STEPS):
        jc = j_step(jc)
    path = str(tmp_path / "ref.npz")
    jck.save_checkpoint(path, jc, _meta())
    init_fn, run_fn, _ = _port_engine()
    meta, carry = ck.load_checkpoint(path, init_fn())
    assert meta["format"] == ck.FORMAT_VERSION
    assert_carries_equal(carry, jc)
    assert_carries_equal(run_fn(carry), j_run(jc))


def test_regrow_matches_reference(tmp_path):
    """fp 2^12 is far too small for 8,203 states: both supervisors double
    it twice, at the same segments, to the same final table words (read
    from each run's final checkpoint, leaf 0 being the table)."""
    kw = dict(chunk=128, queue_capacity=1 << 12, fp_capacity=1 << 12)
    ev_t, ev_j = [], []
    pt, pj = str(tmp_path / "port.ckpt"), str(tmp_path / "ref.ckpt")
    rt = check_supervised(FF, **kw, device="cpu", opts=SupervisorOptions(
        ckpt_path=pt, ckpt_every=16,
        on_event=lambda k, i: ev_t.append((k, i))))
    rj = j_supervised(J_FF, **kw, opts=JOpts(
        ckpt_path=pj, ckpt_every=16,
        on_event=lambda k, i: ev_j.append((k, i))))
    assert rt.regrows == rj.regrows == 2
    assert rt.params == rj.params and rt.segments == rj.segments

    def grows(ev):
        return [(i["resource"], i["old"], i["new"], i["violation"],
                 i["regrows"]) for k, i in ev if k == "regrow"]

    assert grows(ev_t) == grows(ev_j)
    assert ([k for k, _ in ev_t]
            == [k for k, _ in ev_j if k not in ("phase",)])
    assert signature(rt.result) == signature(rj.result)
    with np.load(pt) as zt, np.load(pj) as zj:
        assert zt["leaf_0"].shape == (kw["fp_capacity"] * 4 // 8, 16)
        assert np.array_equal(zt["leaf_0"], zj["leaf_0"])


def test_sigterm_truncate_resume_exact(tmp_path, clean_ff):
    p = str(tmp_path / "ck.npz")
    events = []
    sr = check_supervised(FF, **KW, device="cpu", opts=SupervisorOptions(
        ckpt_path=p, ckpt_every=8, faults=FaultPlan.parse("sigterm@2"),
        on_event=lambda k, i: events.append(k)))
    assert sr.interrupted and "interrupted" in events
    assert sr.result.queue_left > 0
    gens = ck.list_generations(p)
    assert gens and os.path.exists(p)
    assert ck.read_checkpoint_meta(gens[-1][1])["fp_highwater"] == 0.85
    truncate_file(gens[-1][1])  # the newest generation torn
    events2 = []
    sr2 = check_supervised(FF, **KW, device="cpu", opts=SupervisorOptions(
        ckpt_path=p, ckpt_every=64, resume=True,
        on_event=lambda k, i: events2.append(k)))
    assert "ckpt_fallback" in events2 and "recovery" in events2
    assert not sr2.interrupted
    assert signature(sr2.result) == signature(clean_ff)


def test_transient_retry_and_failed_write(tmp_path, clean_ff):
    p = str(tmp_path / "ck.npz")
    events = []
    sr = check_supervised(FF, **KW, device="cpu", opts=SupervisorOptions(
        ckpt_path=p, ckpt_every=8, backoff_base_s=0.01,
        faults=FaultPlan.parse("transient@1,write_fail@2"),
        on_event=lambda k, i: events.append(k)))
    assert sr.retries == 1 and "retry" in events
    assert "ckpt_write_failed" in events
    assert signature(sr.result) == signature(clean_ff)


def test_spill_matches_reference(tmp_path):
    """The regrow probe denied at fp 2^12: both runs complete in the host
    spill tier with equal counts, spill_hits, flushes, journal events
    (the ring's spill column included) and host-store words."""
    kw = dict(chunk=128, queue_capacity=1 << 12, fp_capacity=1 << 12,
              obs_slots=OBS)
    ev_t, ev_j = [], []
    pt, pj = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    rt = check_supervised(FF, **kw, device="cpu", opts=SupervisorOptions(
        ckpt_path=pt, ckpt_every=16, faults=FaultPlan.parse("alloc_fail@1"),
        on_event=lambda k, i: ev_t.append((k, i))))
    rj = j_supervised(J_FF, **kw, opts=JOpts(
        ckpt_path=pj, ckpt_every=16, faults=JPlan.parse("alloc_fail@1"),
        on_event=lambda k, i: ev_j.append((k, i))))
    assert rt.spilled > 0 and rt.spill_hits > 0
    assert (rt.spilled, rt.spill_hits, rt.spill_flushes) == (
        rj.spilled, rj.spill_hits, rj.spill_flushes)
    assert signature(rt.result) == signature(rj.result)
    drop = ("wall_s", "t_dispatch", "t_fence", "seconds", "path")

    def norm(ev):
        return [(k, {a: b for a, b in i.items() if a not in drop})
                for k, i in ev if k != "phase"]

    assert norm(ev_t) == norm(ev_j)
    assert any(i.get("spill_hits") for k, i in ev_t if k == "level")
    st, sj = SpillStore.load(pt + ".spill"), JStore.load(pj + ".spill")
    assert st.count == sj.count and np.array_equal(st.table, sj.table)


def test_spill_store_files_cross_packages(tmp_path):
    rng = np.random.default_rng(6)
    lo = rng.integers(0, 2**32, 900, dtype=np.uint64).astype(np.uint32)
    hi = rng.integers(0, 2**32, 900, dtype=np.uint64).astype(np.uint32)
    mine, ref = SpillStore(256), JStore(256)
    assert mine.insert_batch(lo, hi) == ref.insert_batch(lo, hi) == 900
    mine.save(str(tmp_path / "t.spill"))
    ref.save(str(tmp_path / "j.spill"))
    a, b = JStore.load(str(tmp_path / "t.spill")), SpillStore.load(
        str(tmp_path / "j.spill"))
    assert np.array_equal(a.table, ref.table)
    assert np.array_equal(b.table, mine.table)
    assert (b.probe(lo, hi).all() and a.probe(lo, hi).all())


def test_spill_fail_exhausts_then_resumes(tmp_path, clean_ff):
    """The flush into the host store fails: the ladder checkpoints both
    tiers and returns exhausted; the resume finishes exactly."""
    p = str(tmp_path / "ck.npz")
    kw = dict(KW, fp_capacity=1 << 12)
    events = []
    sr = check_supervised(FF, **kw, device="cpu", opts=SupervisorOptions(
        ckpt_path=p, ckpt_every=16,
        faults=FaultPlan.parse("alloc_fail@1,spill_fail@1"),
        on_event=lambda k, i: events.append((k, i))))
    assert sr.exhausted and sr.interrupted
    assert [i["resource"] for k, i in events if k == "exhausted"] == ["spill"]
    meta = ck.read_checkpoint_meta(p)
    assert meta["spill"]["active"] and os.path.exists(p + ".spill")
    sr2 = check_supervised(FF, **kw, device="cpu", opts=SupervisorOptions(
        ckpt_path=p, ckpt_every=16, resume=True))
    assert not sr2.interrupted and sr2.spilled > 0
    assert signature(sr2.result) == signature(clean_ff)


def test_oom_classification_and_probe():
    """torch.cuda.OutOfMemoryError and MemoryError are exhaustion (the
    ladder), an injected transient is not; the probe reports a denial."""
    assert is_resource_exhausted(torch.cuda.OutOfMemoryError("CUDA out of "
                                                             "memory"))
    assert is_resource_exhausted(MemoryError())
    assert not is_resource_exhausted(TransientFault("flaky"))
    assert not is_resource_exhausted(RuntimeError("kernel expand: launch "
                                                  "failed, CUDA error 700"))
    faults = FaultInjector(FaultPlan.parse("alloc_fail@1"))
    assert "RESOURCE_EXHAUSTED" in _probe_grow("fp_capacity", 1 << 10,
                                               faults, "cpu")
    assert _probe_grow("fp_capacity", 1 << 10, faults, "cpu") is None


def test_oom_segment_shrinks_chunk(clean_ff, monkeypatch):
    """An allocation failure inside a segment goes to the ladder (a chunk
    shrink here), never to the retry budget; the counts stay exact."""
    from torchtlc.resil import supervisor as sup_mod

    real = sup_mod.SingleDeviceAdapter.build
    calls = []

    def build(self, params, ckpt_every):
        template, seg = real(self, params, ckpt_every)

        def failing(c):
            calls.append(1)
            if len(calls) == 2:
                raise torch.cuda.OutOfMemoryError("CUDA out of memory")
            return seg(c)

        return template, failing

    monkeypatch.setattr(sup_mod.SingleDeviceAdapter, "build", build)
    events = []
    sr = check_supervised(FF, **KW, device="cpu", opts=SupervisorOptions(
        ckpt_every=16, on_event=lambda k, i: events.append((k, i))))
    assert sr.shrinks == 1 and sr.retries == 0
    assert [i["action"] for k, i in events if k == "degrade"] == [
        "shrink", "128->64"]
    r, c = sr.result, clean_ff
    assert (r.generated, r.distinct, r.depth) == (c.generated, c.distinct,
                                                  c.depth)


def test_check_with_checkpoints_resume_exact(tmp_path, clean_ff):
    """The checkpointed driver: stopped after two segments, resumed from
    its file, it ends at the clean run's statistics."""
    p = str(tmp_path / "ck.npz")
    progress = []
    r1 = ck.check_with_checkpoints(
        FF, **KW, ckpt_path=p, ckpt_every=16, max_segments=2,
        on_progress=lambda *a: progress.append(a), device="cpu")
    assert r1.queue_left > 0 and len(progress) == 2
    r2 = ck.check_with_checkpoints(FF, **KW, ckpt_path=p, ckpt_every=16,
                                   resume=True, device="cpu")
    assert signature(r2) == signature(clean_ff)


def test_migrate_table_runs_on_the_card_by_default():
    """regrow.migrate_table's device None is the card, as every entry
    point's: without one it raises instead of running on the CPU; on the
    CPU when asked, every stored word is re-inserted (the word-for-word
    parity with the reference's migration is test_regrow_matches_
    reference's table check)."""
    from torchtlc.engine import fpset as tfs
    from torchtlc.resil import regrow

    rng = np.random.default_rng(9)
    lo, hi = (torch.from_numpy(rng.integers(0, 2**31, 1500).astype(np.int32))
              for _ in range(2))
    fps, _ = tfs.fpset_insert(tfs.fpset_new(1 << 11, "cpu"), lo, hi,
                              torch.ones(1500, dtype=torch.bool))
    old = fps.table.numpy()
    got = regrow.migrate_table(old, 1 << 12, batch=512, device="cpu")
    assert int(tfs.fpset_count(got)) == int(tfs.fpset_count(fps))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            regrow.migrate_table(old, 1 << 12)
