"""The sharded engine's host spill tier (torchtlc.engine.sharded.
ShardedSpillRuntime) against the reference's (jaxtlc.engine.sharded.
ShardedSpillRuntime on the CPU mesh of conftest's 8 virtual devices), on
the FF corner with tables small enough to flush, with zero tolerance:
every carry leaf after every segment (spill_hits included), the host
store's bytes and the `spill` events (walls dropped); the supervised
denied-regrow run and `-sharded 4 -spill` through the command, transcript
and journal equal to jaxtlc's; and `-recover` across the two packages
through the spill sibling file."""

import contextlib
import glob
import io
import json
import re

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from jaxtlc.cli import main as j_main
from jaxtlc.config import ModelConfig as JConfig
from jaxtlc.engine import sharded as js
from torchtlc.cli import main as t_main
from torchtlc.config import ModelConfig
from torchtlc.engine import sharded as ts
from torchtlc.engine.interop import SHARD_LEAF_ORDER, shard_carry_to_numpy
from torchtlc.testing import one_thread

one_thread()

FF, J_FF = ModelConfig(False, False), JConfig(False, False)
FF_COUNTS = (17020, 8203, 109)


def _mesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("fp",))


def _assert_carries_equal(port_carry, jc, where=""):
    ref = {f: np.asarray(getattr(jc, f)) for f in SHARD_LEAF_ORDER
           if getattr(jc, f, None) is not None}
    mine = shard_carry_to_numpy(port_carry)
    assert set(mine) == set(ref), (where, set(mine) ^ set(ref))
    for name, want in ref.items():
        assert mine[name].dtype == want.dtype, (where, name)
        assert np.array_equal(mine[name], want), (where, name)


def _events(evs):
    return [(k, {f: v for f, v in i.items() if f != "wall_s"})
            for k, i in evs]


@pytest.mark.parametrize("D,kw", [
    (2, dict(chunk=64, queue_capacity=1 << 11, fp_capacity=1 << 12)),
    (4, dict(chunk=32, queue_capacity=1 << 10, fp_capacity=1 << 11,
             sort_free=True, deferred=True, obs_slots=16)),
], ids=["D2-sorted", "D4-slab-deferred-ring"])
def test_spill_segments_equal_reference(D, kw):
    """Segment by segment (16 chunk steps each) to the end of the run:
    the whole carry, the store's table words and count, and the spill
    events equal the reference's; the run flushes, and a vetoed candidate
    shows up in spill_hits."""
    ev_j, ev_t = [], []
    jr = js.ShardedSpillRuntime(J_FF, _mesh(D), on_event=lambda k, i:
                                ev_j.append((k, i)), **kw)
    tr = ts.ShardedSpillRuntime(FF, ts.ShardMesh(D, "cpu"),
                                on_event=lambda k, i: ev_t.append((k, i)),
                                **kw)
    jc, tc = jr.init_fn(), tr.init_fn()
    _assert_carries_equal(tc, jc, "init")
    jseg, tseg = jr.segment_fn(16), tr.segment_fn(16)
    for seg in range(200):
        jc = jax.block_until_ready(jseg(jc))
        tc = tseg(tc)
        _assert_carries_equal(tc, jc, f"segment {seg}")
        assert tr.store.count == jr.store.count, seg
        assert np.array_equal(tr.store.table, jr.store.table), seg
        assert (tr.flushes, tr.probes) == (jr.flushes, jr.probes), seg
        if not bool(np.asarray(jc.cont).any()):
            break
    assert _events(ev_t) == _events(ev_j)
    assert tr.flushes >= 2 and int(tc.spill_hits.sum()) > 0
    r = ts.result_from_shard_carry(tc, 0.0)
    assert (r.generated, r.distinct, r.depth) == FF_COUNTS


def test_fused_body_unchanged_by_the_split():
    """The fused body is the two halves composed: a sharded run's carry
    (no spill leaf) equals the reference's fused engine's."""
    kw = dict(chunk=64, queue_capacity=1 << 11, fp_capacity=1 << 14)
    ji, jr = js.make_sharded_engine(J_FF, _mesh(2), **kw)
    ti, tr = ts.make_sharded_engine(FF, ts.ShardMesh(2, "cpu"), **kw)
    tc = tr(ti())
    assert tc.spill_hits is None
    _assert_carries_equal(tc, jax.block_until_ready(jr(ji())))


# ---------------------------------------------------------------------------
# the command
# ---------------------------------------------------------------------------

MC_TLA = """---- MODULE MC ----
EXTENDS KubeAPI, TLC

\\* CONSTANT definitions @modelParameterConstants:1REQUESTS_CAN_FAIL
const_fail ==
FALSE

\\* CONSTANT definitions @modelParameterConstants:2REQUESTS_CAN_TIMEOUT
const_to ==
FALSE
====
"""

MC_CFG = """CONSTANT defaultInitValue = defaultInitValue
CONSTANT REQUESTS_CAN_FAIL <- const_fail
CONSTANT REQUESTS_CAN_TIMEOUT <- const_to
SPECIFICATION Spec
INVARIANT TypeOK
INVARIANT OnlyOneVersion
"""
SMALL = ["-chunk", "128", "-qcap", "4096"]
DROP = ("t", "wall_s", "t_dispatch", "t_fence", "seconds", "path",
        "version", "device")


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("shardspill_cli") / "Model_FF"
    d.mkdir()
    (d / "MC.tla").write_text(MC_TLA)
    (d / "MC.cfg").write_text(MC_CFG)
    return d


def _masked(text: str, tmp: str) -> str:
    lines = [ln for ln in text.replace(tmp, "TMP").splitlines()
             if not ln.startswith(("jaxtlc ", "torchtlc ",
                                   "Running breadth-first search",
                                   "Resume with: "))]
    text = "\n".join(lines)
    text = re.sub(r"\d{4}-\d\d-\d\d \d\d:\d\d:\d\d", "DATE", text)
    text = re.sub(r"Finished in \d+ms", "Finished in Nms", text)
    return re.sub(r"\([\d,]+ (s|ds)/min\)", r"(N \1/min)", text)


def _journal(path):
    return [{k: v for k, v in ev.items() if k not in DROP}
            for ev in map(json.loads, open(path)) if ev["event"] != "phase"]


def _run(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(argv)
    return rc, buf.getvalue()


def _both(model_dir, tmp_path, extra):
    """(rc, masked transcript, journal) of the reference and the port."""
    out = {}
    for name, fn, own in (("ref", j_main, []),
                          ("port", t_main, ["-workers", "cpu"])):
        d = tmp_path / name
        d.mkdir(exist_ok=True)
        rc, text = _run(fn, ["check", str(model_dir / "MC.cfg"), "-noTool",
                             *SMALL, "-checkpoint", str(d / "p"),
                             "-checkpointevery", "16", *extra, *own])
        out[name] = (rc, _masked(text, str(d)),
                     _journal(str(d / "p") + ".journal.jsonl"))
    return out


@pytest.mark.parametrize("case", ["denied-regrow-2", "denied-regrow-4",
                                  "spill-first-4"])
def test_sharded_spill_command_equals_reference(model_dir, tmp_path, case):
    """`-sharded N` whose regrow is denied (alloc_fail@1) takes the spill
    rung and completes with exit 0 (the port used to stop with 75), and
    `-sharded 4 -spill` takes the tier at the first saturation: transcript
    and journal equal to jaxtlc's, the FF counts."""
    extra = {"denied-regrow-2": ["-sharded", "2", "-fpcap", "2048",
                                 "-faults", "alloc_fail@1"],
             "denied-regrow-4": ["-sharded", "4", "-fpcap", "1024",
                                 "-faults", "alloc_fail@1"],
             "spill-first-4": ["-sharded", "4", "-fpcap", "1024",
                               "-spill"]}[case]
    out = _both(model_dir, tmp_path, extra)
    assert out["ref"][0] == out["port"][0] == 0
    assert "17020 states generated, 8203 distinct" in out["port"][1]
    assert "Host fingerprint spill tier activated" in out["port"][1]
    assert out["port"][1] == out["ref"][1]
    assert out["port"][2] == out["ref"][2]
    flushes = [e for e in out["port"][2]
               if e["event"] == "spill" and e["phase"] == "flush"]
    assert flushes and all("flushed_tables" in e for e in flushes)


@pytest.mark.parametrize("first,second", [("ref", "port"), ("port", "ref")])
def test_recover_across_packages_through_the_spill_sibling(model_dir,
                                                          tmp_path, first,
                                                          second):
    """A spilling sharded run stopped by SIGTERM (exit 75) leaves a
    checkpoint with its host-store sibling; the other package's -recover
    restores both and finishes with the FF counts and exit 0."""
    mains = {"ref": (j_main, []),
             "port": (t_main, ["-workers", "cpu"])}
    p = str(tmp_path / "p")
    base = ["check", str(model_dir / "MC.cfg"), "-noTool", *SMALL,
            "-sharded", "2", "-fpcap", "2048", "-checkpoint", p,
            "-checkpointevery", "16"]
    fn, own = mains[first]
    rc, text = _run(fn, base + ["-faults", "alloc_fail@1,sigterm@4", *own])
    assert rc == 75 and "Host fingerprint spill tier activated" in text
    assert glob.glob(p + "*.spill"), "no host-store sibling was written"
    fn, own = mains[second]
    rc, text = _run(fn, base + ["-recover", *own])
    assert rc == 0, text[-2000:]
    assert "17020 states generated, 8203 distinct" in text
