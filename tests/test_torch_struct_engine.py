"""check_struct on the CPU (the plain versions of K17 and K18 inside the
port's engine) against jaxtlc.struct.engine.check_struct: counts,
per-action counts, outdegree, the final fingerprint-table words and the
violating state, in the four combinations of the dedup path (sorted,
slab) and the invariant mode (immediate, deferred); supervised carries
word for word (checkpoints after SIGTERM, the counter ring included), and
checkpoints that load across the packages, while a checkpoint of another
spec is refused.  Exact comparisons throughout."""

import contextlib
import io
import json
import os

import numpy as np
import pytest

from jaxtlc.cli import main as j_main
from jaxtlc.struct.engine import check_struct as j_check
from jaxtlc.struct.loader import load as j_load
from torchtlc.cli import main
from torchtlc.struct.engine import check_struct
from torchtlc.struct.loader import load
from torchtlc.testing import one_thread

one_thread()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = [(False, False), (True, True), (False, True), (True, False)]
RAFT = os.path.join(ROOT, "specs", "RaftReplication.toolbox", "Model_1",
                    "MC.cfg")
SYM = os.path.join(ROOT, "specs", "TwoPhase.toolbox", "Model_sym", "MC.cfg")
TWO = os.path.join(ROOT, "specs", "TwoPhase.toolbox", "Model_1", "MC.cfg")


@pytest.fixture(autouse=True)
def _no_reference_artifact_cache(monkeypatch):
    monkeypatch.setenv("JAXTLC_ARTIFACT_CACHE", "off")
    monkeypatch.setenv("TORCHTLC_ARTIFACT_CACHE", "off")


def stale_leader(tmp_path):
    src = open(os.path.join(os.path.dirname(RAFT),
                            "RaftReplication.tla")).read()
    needle = ("/\\ 2 * Cardinality({m \\in Nodes : UpToDate(n, m)}) "
              "> NodeCount\n            ")
    d = tmp_path / "stale"
    d.mkdir()
    (d / "RaftReplication.tla").write_text(src.replace(needle, "", 1))
    (d / "MC.cfg").write_text(open(RAFT).read())
    return str(d / "MC.cfg")


def _same(r, jr):
    assert (r.generated, r.distinct, r.depth, r.queue_left, r.violation,
            r.violation_name) == (jr.generated, jr.distinct, jr.depth,
                                  jr.queue_left, jr.violation,
                                  jr.violation_name)
    assert r.action_generated == jr.action_generated
    assert r.action_distinct == jr.action_distinct
    assert r.outdegree == jr.outdegree
    np.testing.assert_array_equal(r.violation_state,
                                  np.asarray(jr.violation_state))
    assert r.violation_action == jr.violation_action
    if jr.fp_table is None:
        assert r.fp_table is None
    else:
        np.testing.assert_array_equal(r.fp_table,
                                      np.asarray(jr.fp_table))


@pytest.mark.parametrize("sort_free,deferred", MODES)
@pytest.mark.parametrize("cfg,kw", [
    (SYM, dict(chunk=64, queue_capacity=1024, fp_capacity=4096)),
    (RAFT, dict(chunk=256, queue_capacity=1 << 13, fp_capacity=1 << 15)),
], ids=["TwoPhase_sym", "RaftReplication"])
def test_check_struct_equals_reference(cfg, kw, sort_free, deferred):
    r = check_struct(load(cfg), device="cpu", check_deadlock=False,
                     sort_free=sort_free, deferred=deferred,
                     capture_fps=True, **kw)
    jr = j_check(j_load(cfg), check_deadlock=False, sort_free=sort_free,
                 deferred=deferred, capture_fps=True, **kw)
    assert r.violation == 0 and r.fp_table is not None
    _same(r, jr)


@pytest.mark.parametrize("sort_free,deferred", MODES[:2])
def test_violation_state_equals_reference(tmp_path, sort_free, deferred):
    """The stale-leader RaftReplication violates an invariant: the same
    code, state and action in both invariant modes."""
    cfg = stale_leader(tmp_path)
    kw = dict(chunk=256, queue_capacity=1 << 13, fp_capacity=1 << 15,
              check_deadlock=False, sort_free=sort_free, deferred=deferred)
    r = check_struct(load(cfg), device="cpu", **kw)
    jr = j_check(j_load(cfg), **kw)
    assert r.violation >= 100
    _same(r, jr)


def test_deadlock_equals_reference():
    kw = dict(chunk=64, queue_capacity=512, fp_capacity=4096)
    r = check_struct(load(TWO), device="cpu", **kw)
    jr = j_check(j_load(TWO), **kw)
    assert r.violation_name == "Deadlock reached"
    _same(r, jr)


def _quiet(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(argv)
    return rc, buf.getvalue()


def _ckpt_run(fn, path, extra, reference):
    argv = ["check", RAFT, "-noTool", "-nodeadlock", "-chunk", "256",
            "-checkpoint", path, "-checkpointevery", "4", "-workers",
            "cpu"] + extra
    if reference:
        argv += ["-no-preflight"]
    return _quiet(fn, argv)


def _npz(path):
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"]))
        return meta, {k: z[k] for k in z.files if k != "__meta__"}


def test_supervised_carries_and_checkpoints_equal_reference(tmp_path):
    """SIGTERM after the second segment: exit 75 in both packages and the
    final checkpoints equal leaf for leaf (queue, table, counters, the
    counter ring) and meta for meta; each package's checkpoint resumes in
    the other to the full counts."""
    mine, theirs = str(tmp_path / "p.npz"), str(tmp_path / "j.npz")
    assert _ckpt_run(main, mine, ["-faults", "sigterm@2"], False)[0] == 75
    assert _ckpt_run(j_main, theirs, ["-faults", "sigterm@2"], True)[0] \
        == 75
    pm, pa = _npz(mine)
    jm, ja = _npz(theirs)
    assert pm == jm
    assert pm["config"]["frontend"] == "struct"
    assert sorted(pa) == sorted(ja)
    for k in ja:
        np.testing.assert_array_equal(pa[k], ja[k], err_msg=k)
    for fn, path, ref in ((j_main, mine, True), (main, theirs, False)):
        rc, out = _ckpt_run(fn, path, ["-recover"], ref)
        assert rc == 0
        assert "Starting recovery from checkpoint" in out
        assert "17431 states generated, 7279 distinct states found" in out


def test_checkpoint_of_another_spec_is_refused(tmp_path):
    path = str(tmp_path / "p.npz")
    assert _ckpt_run(main, path, ["-faults", "sigterm@1"], False)[0] == 75
    with pytest.raises(ValueError, match="checkpoint config mismatch"):
        _quiet(main, ["check", TWO, "-noTool", "-nodeadlock", "-chunk",
                      "256", "-checkpoint", path, "-recover", "-workers",
                      "cpu"])
