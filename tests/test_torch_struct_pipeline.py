"""Single-device `-pipeline` on struct specs against the reference, with
zero tolerance: the port's pipelined engine over the struct backend (K17,
K18 at the commit over the staged raw successors `st_flat`) steps body for
body with jaxtlc's pipelined engine over its struct backend on TwoPhase
Model_sym at chunk 16 (bodies inside a level and at level flips), every
carry leaf equal after every body - the staged block with `st_flat` in the
deferred modes and `st_cov` with coverage; the pipelined run's counts and
table words equal the unpipelined run's; a pipelined struct checkpoint
taken by one package resumes in the other; and the `-pipeline` command,
with and without `-coverage`, through a regrow (the staged block and
`st_flat` migrated), a denied regrow (no spill rung: exit 75), SIGTERM
and `-recover`, gives the reference's transcript and exit code."""

import contextlib
import io
import os
import re

import numpy as np
import pytest

from jaxtlc.cli import main as j_main
from jaxtlc.engine import bfs as jb
from jaxtlc.struct.cache import get_backend as j_get_backend
from jaxtlc.struct.loader import load as j_load
from torchtlc.cli import main as t_main
from torchtlc.engine import bfs as tb
from torchtlc.engine.interop import LEAF_ORDER, carry_from_numpy, carry_to_numpy
from torchtlc.struct.cache import get_backend
from torchtlc.struct.engine import check_struct
from torchtlc.struct.loader import load
from torchtlc.testing import one_thread

one_thread()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYM = os.path.join(ROOT, "specs", "TwoPhase.toolbox", "Model_sym", "MC.cfg")
TWO = os.path.join(ROOT, "specs", "TwoPhase.toolbox", "Model_1", "MC.cfg")
KW = dict(chunk=16, queue_capacity=1 << 9, fp_capacity=1 << 11)
# (sort_free, deferred, coverage + ring)
MODES = {"sorted-immediate": (False, False, False),
         "sorted-deferred": (False, True, False),
         "slab-deferred-coverage-ring": (True, True, True)}


def _ref_np(jc) -> dict:
    out = {}
    for f in LEAF_ORDER:
        v = jc.fps.table if f == "fps" else getattr(jc, f, None)
        if v is not None:
            out[f] = np.asarray(v)
    return out


def _assert_words_equal(a: dict, b: dict, where=""):
    assert set(a) == set(b), (where, set(a) ^ set(b))
    for f in a:
        assert a[f].dtype == b[f].dtype and a[f].shape == b[f].shape, (
            where, f)
        assert (a[f] == b[f]).all(), (where, f)


def _engines(mode):
    sf, de, extras = MODES[mode]
    kw = dict(KW, sort_free=sf, deferred=de,
              obs_slots=16 if extras else 0)
    tback = get_backend(load(SYM), False, coverage=extras)
    jback = j_get_backend(j_load(SYM), False, coverage=extras)
    ref = jb.make_backend_engine(jback, pipeline=True, donate=False, **kw)
    port = tb.make_backend_engine(tback, pipeline=True, device="cpu", **kw)
    return ref, port, tback.cdc, de


@pytest.mark.parametrize("mode", list(MODES))
def test_pipelined_struct_carry_equals_reference_every_body(mode):
    (j_init, _, j_step), (t_init, _, t_step), cdc, de = _engines(mode)
    jc, tc = j_init(), t_init()
    _assert_words_equal(carry_to_numpy(tc, codec=cdc, deferred=de),
                        _ref_np(jc), 0)
    bodies = 0
    while not tb.carry_done(tc):
        jc, tc = j_step(jc), t_step(tc)
        bodies += 1
        mine = carry_to_numpy(tc, codec=cdc, deferred=de)
        _assert_words_equal(mine, _ref_np(jc), bodies)
        # the carry converts back to the same words
        back = carry_from_numpy(mine, device="cpu", codec=cdc, flat=de)
        _assert_words_equal(carry_to_numpy(back, codec=cdc, deferred=de),
                            mine, ("round trip", bodies))
    assert ("st_flat" in mine) == de
    assert int(tc.distinct) == 288 and bodies > 20


@pytest.mark.parametrize("mode", ["sorted-deferred",
                                  "slab-deferred-coverage-ring"])
def test_pipelined_equals_unpipelined(mode):
    sf, de, extras = MODES[mode]
    m = load(SYM)
    kw = dict(KW, sort_free=sf, deferred=de, check_deadlock=False,
              device="cpu", coverage=extras, capture_fps=True)
    a = check_struct(m, pipeline=True, **kw)
    b = check_struct(m, **kw)
    assert (a.generated, a.distinct, a.depth) == (810, 288, 11)
    assert (a.generated, a.distinct, a.depth, a.action_generated,
            a.action_distinct, a.outdegree, a.site_coverage) == (
        b.generated, b.distinct, b.depth, b.action_generated,
        b.action_distinct, b.outdegree, b.site_coverage)
    assert np.array_equal(a.fp_table, b.fp_table)


@pytest.mark.parametrize("first,second", [("ref", "port"), ("port", "ref")])
def test_pipelined_struct_checkpoint_resumes_across_packages(tmp_path, first,
                                                             second):
    """A pipelined deferred struct run stopped by SIGTERM (exit 75) resumes
    in the other package with -recover -pipeline: the staged block,
    st_flat included, crosses the checkpoint format."""
    mains = {"ref": (j_main, []), "port": (t_main, ["-workers", "cpu"])}
    p = str(tmp_path / "p")
    base = ["check", SYM, "-noTool", "-nodeadlock", "-chunk", "16",
            "-deferred-inv", "-pipeline", "-checkpoint", p,
            "-checkpointevery", "4"]
    fn, own = mains[first]
    rc, text = _run(fn, base + ["-faults", "sigterm@3", *own])
    assert rc == 75, text[-2000:]
    fn, own = mains[second]
    rc, text = _run(fn, base + ["-recover", *own])
    assert rc == 0, text[-2000:]
    assert "810 states generated, 288 distinct states found" in text


@pytest.fixture(autouse=True)
def _no_reference_artifact_cache(monkeypatch):
    monkeypatch.setenv("JAXTLC_ARTIFACT_CACHE", "off")
    monkeypatch.setenv("TORCHTLC_ARTIFACT_CACHE", "off")


def _masked(text: str, tmp: str = "") -> str:
    if tmp:
        text = text.replace(tmp, "TMP")
    lines = [ln for ln in text.splitlines()
             if not ln.startswith(("jaxtlc ", "torchtlc ",
                                   "Running breadth-first search",
                                   "Resume with: "))]
    text = "\n".join(lines)
    text = re.sub(r"\d{4}-\d\d-\d\d \d\d:\d\d:\d\d", "DATE", text)
    text = re.sub(r"Finished in \d+ms", "Finished in Nms", text)
    text = re.sub(r"python -m (jaxtlc|torchtlc)\.cli", "python -m CLI", text)
    text = text.replace(" -workers cpu", "")
    return re.sub(r"\([\d,]+ (s|ds)/min\)", r"(N \1/min)", text)


def _run(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(argv)
    return rc, buf.getvalue()


SYM16 = ["-nodeadlock", "-chunk", "16", "-pipeline", "-deferred-inv"]
# (MC.cfg, flags, exit code)
COMMANDS = {
    "pipeline": (TWO, ["-nodeadlock", "-pipeline"], 0),
    "pipeline-coverage": (TWO, ["-nodeadlock", "-pipeline", "-coverage"], 0),
    "pipeline-deferred-unsupervised": (TWO, [
        "-nodeadlock", "-pipeline", "-deferred-inv", "-no-auto-grow"], 0),
    "pipeline-deadlock": (TWO, ["-pipeline"], 12),
    # regrows migrate the staged block, st_flat included
    "pipeline-deferred-table-regrow": (SYM, SYM16 + ["-fpcap", "128"], 0),
    # a pipelined run has no spill rung: a denied regrow exits 75
    "pipeline-denied-regrow": (SYM, SYM16 + ["-fpcap", "64", "-faults",
                                             "alloc_fail@1"], 75),
}


@pytest.mark.parametrize("case", list(COMMANDS))
def test_pipeline_command_equals_reference(case):
    cfg, flags, want = COMMANDS[case]
    argv = ["check", cfg, "-noTool", *flags]
    rc, out = _run(t_main, argv + ["-workers", "cpu"])
    ref_rc, ref = _run(j_main, argv)
    assert rc == ref_rc == want
    assert "Finished computing initial states" in out
    assert _masked(out) == _masked(ref)


def test_pipeline_sigterm_recover_transcripts_equal_reference(tmp_path):
    """`-pipeline -checkpoint P -faults sigterm@3`, then `-recover
    -pipeline`: each step's transcript and exit code equal the
    reference's."""
    outs = {}
    for name, fn, own in (("ref", j_main, []),
                          ("port", t_main, ["-workers", "cpu"])):
        d = tmp_path / name
        d.mkdir()
        p = str(d / "p")
        base = ["check", SYM, "-noTool", "-nodeadlock", "-chunk", "16",
                "-pipeline", "-checkpoint", p, "-checkpointevery", "4"]
        r1 = _run(fn, base + ["-faults", "sigterm@3", *own])
        r2 = _run(fn, base + ["-recover", *own])
        outs[name] = [(rc, _masked(t, str(d))) for rc, t in (r1, r2)]
    assert [rc for rc, _ in outs["port"]] == [75, 0]
    assert outs["port"] == outs["ref"]
