"""The port's certified abstract interpretation (torchtlc/analysis/absint.py)
and the narrowed compile it feeds, against jaxtlc with tolerance zero.

- ``BoundReport`` field for field - baseline, bounds, card bounds and
  universes, certified, bits, words, ``digest()``, ``render_lines()``,
  ``findings()`` - on every shipped model the struct loader loads, the
  reference test's synthetic models (tests/test_absint.py: five
  guard-bounded counters, the slot-count spec), TwoPhase with 8 resource
  managers and RaftReplication with 5 nodes;
- the narrowed compile (struct_backend with a certified report): the trap
  statistics (range-trap sites, elided traps, reduced slot lanes), the
  lane count and labels, the codec's widths and words, and the
  certificate's tables, equal to the reference's narrowed backend; an
  elide=False compile keeps every trap and carries no certificate;
- the struct cache's bound memo and the backend memo's bound key.

Host Python only: seconds."""

import dataclasses
import os

import numpy as np
import pytest

from jaxtlc.analysis.absint import analyze_bounds as j_analyze
from jaxtlc.struct.backend import _card_specs as j_card_specs
from jaxtlc.struct.cache import get_backend as j_get_backend
from jaxtlc.struct.loader import load as j_load
from torchtlc.analysis.absint import analyze_bounds
from torchtlc.struct import cache
from torchtlc.struct.loader import load
from torchtlc.testing import one_thread

one_thread()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPECS = os.path.join(ROOT, "specs")
SHIPPED = ("TwoPhase/Model_1", "TwoPhase/Model_sym",
           "RaftReplication/Model_1", "RaftElection/Model_1",
           "Reconciler/Model_1", "ServiceMesh/Model_1")

# the reference test's synthetic models (tests/test_absint.py:56-130)
WIDE = """---- MODULE Wide ----
EXTENDS Naturals
VARIABLES a, b, c, d, e
Init == /\\ a = 0 /\\ b = 0 /\\ c = 0 /\\ d = 0 /\\ e = 0
UpA == /\\ a < 3 /\\ a' = a + 1 /\\ UNCHANGED <<b, c, d, e>>
UpB == /\\ b < 3 /\\ b' = b + 1 /\\ UNCHANGED <<a, c, d, e>>
UpC == /\\ c < 3 /\\ c' = c + 1 /\\ UNCHANGED <<a, b, d, e>>
UpD == /\\ d < 3 /\\ d' = d + 1 /\\ UNCHANGED <<a, b, c, e>>
UpE == /\\ e < 3 /\\ e' = e + 1 /\\ UNCHANGED <<a, b, c, d>>
Next == UpA \\/ UpB \\/ UpC \\/ UpD \\/ UpE
TypeOK == /\\ a \\in 0..100 /\\ b \\in 0..100 /\\ c \\in 0..100
          /\\ d \\in 0..100 /\\ e \\in 0..100
====
"""
WIDE_CFG = "INVARIANT\nTypeOK\n"
SLOTC = """---- MODULE SlotC ----
EXTENDS Naturals, FiniteSets
CONSTANTS RM
VARIABLES msgs, n
Init == /\\ msgs = {} /\\ n = 0
Send == /\\ n < 2
        /\\ \\E r \\in RM : msgs' = msgs \\cup {[kind |-> "a", from |-> r]}
        /\\ n' = n + 1
Drop == /\\ \\E m \\in msgs : msgs' = msgs \\ {m}
        /\\ UNCHANGED n
Next == Send \\/ Drop
TypeOK == /\\ \\A m \\in msgs : m.from \\in RM /\\ n \\in 0..5
====
"""
SLOTC_CFG = ("CONSTANT RM = {r1, r2, r3, r4, r5, r6, r7, r8, r9, "
             "ra, rb, rc, rd}\nINVARIANT\nTypeOK\n")
TP8_CFG = ("CONSTANT RM = {r1, r2, r3, r4, r5, r6, r7, r8}\nSPECIFICATION\n"
           "Spec\nINVARIANT\nTypeOK\nAgreement\nCommitVoted\n")
RR5_CFG = ("CONSTANT Nodes = {n1, n2, n3, n4, n5}\nCONSTANT MaxLog = 2\n"
           "CONSTANT MaxTerm = 3\nSPECIFICATION\nSpec\nINVARIANT\nTypeOK\n"
           "AtMostOneLeader\nCommitWithinLog\nCommittedAgree\n")


def write_model(root, name, module, cfg, tla_name=None):
    d = os.path.join(str(root), name)
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, f"{tla_name or name}.tla"), "w") as f:
        f.write(module)
    with open(os.path.join(d, "MC.cfg" if tla_name else f"{name}.cfg"),
              "w") as f:
        f.write(cfg)
    return os.path.join(d, "MC.cfg" if tla_name else f"{name}.cfg")


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """name -> MC.cfg path of every model the tests hold."""
    root = tmp_path_factory.mktemp("absint")
    out = {s: os.path.join(SPECS, s.replace("/", ".toolbox/"), "MC.cfg")
           for s in SHIPPED}
    out["Wide"] = write_model(root, "Wide", WIDE, WIDE_CFG)
    out["SlotC"] = write_model(root, "SlotC", SLOTC, SLOTC_CFG)
    two = open(os.path.join(SPECS, "TwoPhase.toolbox", "Model_1",
                            "TwoPhase.tla")).read()
    out["TP8"] = write_model(root, "tp8", two, TP8_CFG, "TwoPhase")
    raft = open(os.path.join(SPECS, "RaftReplication.toolbox", "Model_1",
                             "RaftReplication.tla")).read()
    out["RR5"] = write_model(root, "rr5", raft, RR5_CFG, "RaftReplication")
    return out


FIELDS = ("root", "variables", "baseline", "bounds", "card_bounds",
          "card_universe", "certified", "baseline_nbits", "narrowed_nbits",
          "baseline_words", "narrowed_words")
# (certified, baseline -> narrowed bits, baseline -> narrowed words)
EXPECT = {"RaftReplication/Model_1": (True, 40, 28, 2, 1),
          "TP8": (True, 53, 53, 2, 2), "RR5": (True, 67, 53, 3, 2),
          "Wide": (True, 35, 10, 2, 1)}


@pytest.mark.parametrize("name", SHIPPED + ("Wide", "SlotC", "TP8", "RR5"))
def test_bound_report_equals_reference(models, name):
    mine = analyze_bounds(load(models[name]))
    ref = j_analyze(j_load(models[name]))
    for f in FIELDS:
        assert repr(getattr(mine, f)) == repr(getattr(ref, f)), f
    assert mine.iters == ref.iters
    assert mine.digest() == ref.digest()
    assert mine.narrowed() == ref.narrowed()
    assert mine.render_lines() == ref.render_lines()
    assert ([dataclasses.astuple(f) for f in mine.findings()]
            == [dataclasses.astuple(f) for f in ref.findings()])
    if name in EXPECT:
        assert (mine.certified, mine.baseline_nbits, mine.narrowed_nbits,
                mine.baseline_words, mine.narrowed_words) == EXPECT[name]


@pytest.mark.parametrize("name", ("Wide", "SlotC", "RaftReplication/Model_1",
                                  "TwoPhase/Model_1"))
def test_narrowed_compile_equals_reference(models, name):
    """trap_stats, lanes, labels, codec widths and the certificate's
    tables of the narrowed compile (elide) equal the reference's; the
    elide=False compile narrows the codec, keeps every trap and carries no
    certificate, as the reference's sharded form."""
    m, jm = load(models[name]), j_load(models[name])
    rep, jrep = analyze_bounds(m), j_analyze(jm)
    assert rep.certified
    for elide in (True, False):
        b = cache.get_backend(m, False, bounds=rep, elide=elide)
        jb = j_get_backend(jm, False, bounds=jrep, elide=elide)
        assert b.cdc.trap_stats == jb.cdc.trap_stats
        assert b.n_lanes == jb.n_lanes
        assert b.labels == jb.labels
        assert list(b.kernels.prog.lane_action) == list(
            np.asarray(jb.lane_action))
        assert (b.cdc.widths, b.cdc.n_words, b.cdc.nbits) == (
            jb.cdc.widths, jb.cdc.n_words, jb.cdc.nbits)
        if elide:
            max_code, specs = b.kernels.prog.cert
            assert list(max_code) == jb.cdc.max_codes()
            assert [list(s) for s in specs] == [list(s) for s in j_card_specs(
                jb.cdc, jm.system.variables, jrep.card_bounds)]
            assert b.cert_check is not None and jb.cert_check is not None
        else:
            assert b.kernels.prog.cert is None and b.cert_check is None
            assert b.cdc.trap_stats[1:] == (0, 0)
    base = cache.get_backend(m, False)
    assert base.kernels.prog.cert is None and base.cert_check is None
    assert base.cdc.trap_stats == j_get_backend(jm, False).cdc.trap_stats


def test_wide_narrowing_elides_every_trap(models):
    m = load(models["Wide"])
    rep = analyze_bounds(m)
    b0 = cache.get_backend(m, False)
    b1 = cache.get_backend(m, False, bounds=rep)
    assert (b0.cdc.n_words, b1.cdc.n_words) == (2, 1)
    sites0, elided0, _ = b0.cdc.trap_stats
    sites1, elided1, _ = b1.cdc.trap_stats
    assert elided0 == 0 and sites1 == sites0 and elided1 == sites1 > 0
    assert "ST_CERT 1" in b1.kernels.prog.text
    assert "ST_CERT 0" in b0.kernels.prog.text


def test_bounds_memo_and_backend_key(models):
    """get_bounds memoizes by the spec's meaning; the narrowed backend is
    its own memo entry (bound digest and elide in the key); an
    uncertified report narrows nothing."""
    m = load(models["RaftReplication/Model_1"])
    rep = cache.get_bounds(m)
    assert cache.get_bounds(load(models["RaftReplication/Model_1"])) is rep
    narrowed = cache.get_backend(m, False, bounds=rep)
    assert narrowed is cache.get_backend(m, False, bounds=rep)
    assert narrowed is not cache.get_backend(m, False, bounds=rep,
                                             elide=False)
    assert narrowed is not cache.get_backend(m, False)
    assert narrowed.cdc.n_words == 1
    lie = dataclasses.replace(rep, certified=False)
    assert cache.get_backend(m, False, bounds=lie).cdc.n_words == 2
