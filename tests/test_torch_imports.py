"""The torchtlc port stands alone: it imports neither jax nor the jaxtlc
reference package (not even jax-free modules of it), and its copied tables
equal the reference's."""

import ast
import dataclasses
import os
import subprocess
import sys

import pytest

from torchtlc.testing import one_thread, subprocess_env

one_thread()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxtlc")


def _port_files():
    out = [os.path.join(ROOT, n) for n in ("chip_smoke.py",
                                           "chip_kernel_ab.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "torchtlc")):
        out += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return sorted(out)


def _forbidden(mod: str) -> bool:
    return mod.split(".")[0] in FORBIDDEN


def _named_imports(path):
    """Every module a file imports or names to an import function."""
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif isinstance(node, ast.Call):
            fn = node.func
            name = getattr(fn, "attr", None) or getattr(fn, "id", None)
            if name in ("import_module", "__import__") and node.args:
                arg = node.args[0]
                if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                    yield arg.value


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_file_imports_jax_or_the_reference(path):
    bad = [m for m in _named_imports(path) if _forbidden(m)]
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


_BLOCKED_IMPORT = r"""
import importlib, os, pkgutil, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxtlc"):
            raise ImportError(f"blocked import of {name}")
        return None
sys.meta_path.insert(0, Block())
sys.path.insert(0, os.getcwd())
import torchtlc
names = ["torchtlc"] + [m.name for m in pkgutil.walk_packages(
    torchtlc.__path__, "torchtlc.")]
for n in names:
    importlib.import_module(n)
import chip_smoke
assert not [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxtlc")]
print(len(names))
"""


def test_every_module_imports_with_jax_blocked():
    env = subprocess_env()
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 16  # every module of the slices


def test_sim_package_is_checked():
    """The simulation plane (torchtlc/sim) is among the files the import
    checks above walk, every module of it."""
    names = {os.path.relpath(p, ROOT) for p in _port_files()}
    for mod in ("__init__", "threefry", "engine", "replay", "driver",
                "liveness", "plain", "kube"):
        assert os.path.join("torchtlc", "sim", f"{mod}.py") in names


def test_infer_package_is_checked():
    """The inference plane (torchtlc/infer) is among the files the import
    checks above walk, every module of it, and none of them names jax or
    jaxtlc."""
    names = {os.path.relpath(p, ROOT) for p in _port_files()}
    for mod in ("__init__", "candidates", "program", "filter", "certify",
                "driver"):
        path = os.path.join("torchtlc", "infer", f"{mod}.py")
        assert path in names
        bad = [m for m in _named_imports(os.path.join(ROOT, path))
               if _forbidden(m)]
        assert not bad, f"{path} imports {bad}"


def test_capacity_and_recheck_modules_are_checked():
    """The native disk tier (torchtlc/native, torchtlc/engine/hybrid.py)
    and the artifact cache (torchtlc/struct/artifacts.py) are among the
    files the import checks above walk, and none of them names jax or
    jaxtlc."""
    names = {os.path.relpath(p, ROOT) for p in _port_files()}
    for path in (os.path.join("torchtlc", "native", "__init__.py"),
                 os.path.join("torchtlc", "engine", "hybrid.py"),
                 os.path.join("torchtlc", "struct", "artifacts.py")):
        assert path in names
        bad = [m for m in _named_imports(os.path.join(ROOT, path))
               if _forbidden(m)]
        assert not bad, f"{path} imports {bad}"


def test_absint_copy_is_the_reference_line_for_line():
    """torchtlc/analysis/absint.py is jaxtlc/analysis/absint.py with a note
    added to its docstring and nothing else (its BoundReport digest is the
    checkpoint meta's bound_digest in both packages)."""
    import difflib

    mine = open(os.path.join(ROOT, "torchtlc", "analysis",
                             "absint.py")).read().splitlines()
    ref = open(os.path.join(ROOT, "jaxtlc", "analysis",
                            "absint.py")).read().splitlines()
    ops = [op for op in difflib.SequenceMatcher(None, ref, mine,
                                                autojunk=False).get_opcodes()
           if op[0] != "equal"]
    assert [op[0] for op in ops] == ["insert"]
    added = mine[ops[0][3]:ops[0][4]]
    assert len(added) <= 6 and "port's copy" in " ".join(added)


def test_config_copy_equals_reference():
    from jaxtlc import config as jc
    from torchtlc import config as tc

    assert ([f.name for f in dataclasses.fields(tc.ModelConfig)]
            == [f.name for f in dataclasses.fields(jc.ModelConfig)])
    assert dataclasses.astuple(tc.MODEL_1) == dataclasses.astuple(jc.MODEL_1)
    assert ({k: dataclasses.astuple(v) for k, v in tc.MATRIX.items()}
            == {k: dataclasses.astuple(v) for k, v in jc.MATRIX.items()})
    for args in ((1, 1), (2, 1), (3, 2, False, True, "delete_noop")):
        assert (dataclasses.astuple(tc.make_scaled(*args))
                == dataclasses.astuple(jc.make_scaled(*args)))
    (tcfg, tkw), (jcfg, jkw) = tc.scaled_config(), jc.scaled_config()
    assert dataclasses.astuple(tcfg) == dataclasses.astuple(jcfg)
    assert tkw == jkw


def test_label_tables_equal_reference():
    from jaxtlc.spec import labels as jl
    from torchtlc.spec import labels as tl

    for name in ("LABELS", "LABEL_ID", "VERBS", "VERB_ID", "RESPONSES",
                 "RESPONSE_ID", "DEFAULT_INIT", "PROC_API", "PROC_LISTAPI"):
        assert getattr(tl, name) == getattr(jl, name), name


def test_ring_layout_copy_equals_reference():
    """torchtlc.obs.counters keeps its own copy of the reference's ring
    layout and decoder: every column constant, the row width, and the
    decoded rows of one random ring."""
    import numpy as np

    from jaxtlc.obs import counters as jc
    from torchtlc.obs import counters as tc

    names = [n for n in dir(jc) if n.startswith("COL_")] + [
        "N_FIXED_COLS", "DEFAULT_OBS_SLOTS"]
    assert sorted(n for n in dir(tc) if n.startswith("COL_")) == sorted(
        n for n in dir(jc) if n.startswith("COL_"))
    for name in names:
        assert getattr(tc, name) == getattr(jc, name), name
    for n_labels in (0, 3, 22):
        assert tc.ring_cols(n_labels) == jc.ring_cols(n_labels)
    rng = np.random.default_rng(8)
    labels = tuple(f"a{i}" for i in range(4))
    ring = rng.integers(0, 2**32, (6, jc.ring_cols(4)),
                        dtype=np.uint64).astype(np.uint32)
    ring[:, jc.COL_OVERFLOW] = rng.integers(0, 2, 6)
    ring[:, jc.COL_CERT] = rng.integers(0, 2, 6)
    for head, since in ((3, 0), (9, 2), (12, 8)):
        for lab in (None, labels):
            want = jc.rows_from_ring(ring, head, labels=lab, since=since,
                                     fp_capacity=1 << 20)
            assert tc.rows_from_ring(ring, head, labels=lab, since=since,
                                     fp_capacity=1 << 20) == want
            assert tc.rows_from_ring(ring.view(np.int32), head, labels=lab,
                                     since=since, fp_capacity=1 << 20) == want


def test_copied_modules_equal_reference(tmp_path):
    """The port's own copies of jax-free reference modules: the journal
    schema, the fault plan, the transcript's action table and rates, the
    model parsers and the journal file format."""
    from jaxtlc.frontend import launch as jl, mc_cfg as jcfg, mc_tla as jtla
    from jaxtlc.io import tlc_log as jlog
    from jaxtlc.obs import journal as jj, schema as js, views as jv
    from jaxtlc.resil import faults as jf
    from torchtlc.frontend import launch as tl, mc_cfg as tcfg, mc_tla as ttla
    from torchtlc.io import tlc_log as tlog
    from torchtlc.obs import journal as tj, schema as ts, views as tv
    from torchtlc.resil import faults as tf

    for name in ("SCHEMA_VERSION", "ENVELOPE", "EVENTS", "VERDICTS"):
        assert getattr(ts, name) == getattr(js, name), name
    assert ([f.name for f in dataclasses.fields(tf.FaultPlan)]
            == [f.name for f in dataclasses.fields(jf.FaultPlan)])
    spec = "write_fail@2,truncate@1,transient@0,sigterm@3,alloc_fail@1," \
           "spill_fail@2,runner_die@1,slow_dispatch@4"
    assert (dataclasses.astuple(tf.FaultPlan.parse(spec))
            == dataclasses.astuple(jf.FaultPlan.parse(spec)))
    assert tlog.ACTION_LINES == jlog.ACTION_LINES
    for prev in (None, (10.0, 100, 50), (30.0, 5, 5)):
        assert (tv.interval_rates(prev, 20.0, 700, 300)
                == jv.interval_rates(prev, 20.0, 700, 300))
    cfg_text = ("CONSTANT defaultInitValue = defaultInitValue\n"
                "CONSTANT REQUESTS_CAN_FAIL <- const_fail\n"
                "SPECIFICATION Spec\nINVARIANT TypeOK\n"
                "INVARIANT OnlyOneVersion\nPROPERTY ReconcileCompletes\n")
    assert (dataclasses.asdict(tcfg.parse_cfg(cfg_text))
            == dataclasses.asdict(jcfg.parse_cfg(cfg_text)))
    tla_text = ("---- MODULE MC ----\nEXTENDS KubeAPI, TLC\n"
                "const_fail ==\nTRUE\nconst_set ==\n{\"a\", \"b\"}\n====\n")
    assert (dataclasses.asdict(ttla.parse_mc_tla(tla_text))
            == dataclasses.asdict(jtla.parse_mc_tla(tla_text)))
    assert ttla.eval_constant("TRUE") == jtla.eval_constant("TRUE")
    assert [f.name for f in dataclasses.fields(tl.LaunchConfig)] == [
        f.name for f in dataclasses.fields(jl.LaunchConfig)]
    # one journal line each, read back by the other package's reader
    for mine, theirs, name in ((tj, jj, "t"), (jj, tj, "j")):
        path = str(tmp_path / f"{name}.jsonl")
        with mine.RunJournal(path) as j:
            j.event("progress", depth=3, generated=10, distinct=7, queue=2)
        assert [e["event"] for e in theirs.read(path)] == ["progress"]


def test_coverage_copies_equal_reference():
    """The port's copies of the coverage vocabulary (obs.coverage), the
    span table (spec.coverage_spans), the oracle's value helpers and Init
    (spec.values) and the host walker (spec.coverage): field for field,
    value for value, and one FF walk rendered line for line."""
    import numpy as np

    from jaxtlc.config import MATRIX as JM
    from jaxtlc.obs import coverage as jc
    from jaxtlc.spec import coverage as jwalk, coverage_spans as jspans
    from jaxtlc.spec import oracle as jo
    from torchtlc.config import MATRIX as TM
    from torchtlc.obs import coverage as tc
    from torchtlc.spec import coverage as twalk, coverage_spans as tspans
    from torchtlc.spec import values as tv

    assert tc.Site._fields == jc.Site._fields
    assert tc.Site._field_defaults == jc.Site._field_defaults
    assert tc.CoveragePlane._fields == jc.CoveragePlane._fields
    assert (tc.CoveragePlane._field_defaults
            == jc.CoveragePlane._field_defaults)
    acts = ("A", "B", "C")
    locs = {"B": "line 3"}
    assert ([tuple(s) for s in tc.action_site_table("M", acts, locs)]
            == [tuple(s) for s in jc.action_site_table("M", acts, locs)])
    sites_t = tc.action_site_table("M", acts)
    sites_j = jc.action_site_table("M", acts)
    counts = np.array([3, 0, 7], np.uint32)
    assert (tc.site_totals_dict(sites_t, counts)
            == jc.site_totals_dict(sites_j, counts))
    for seen in (None, np.array([1, 0, 7])):
        assert (tc.coverage_delta_event(sites_t, counts, seen)
                == jc.coverage_delta_event(sites_j, counts, seen))
    assert tc.coverage_delta_event(sites_t, counts, counts) is None
    events = [
        {"event": "coverage", "visited": 1, "sites": 3, "delta": {"A": 2}},
        {"event": "level", "level": 3},
        {"event": "coverage", "visited": 2, "sites": 3,
         "delta": {"A": 1, "C": 4}},
        {"event": "coverage", "visited": 2, "sites": 3, "delta": {},
         "saturated": True, "level": 9},
    ]
    assert tc.coverage_from_events(events) == jc.coverage_from_events(events)
    assert tc.coverage_from_events([]) is None
    assert tspans.MODULE == jspans.MODULE
    assert tspans.SPANS == jspans.SPANS
    for key in ((False, False), (True, True)):
        assert tv.initial_states(TM[key]) == jo.initial_states(JM[key])
    vals = [frozenset({("a", 1), ("b", 2)}), (("x", 1),), 3, "s"]
    assert [tv._ckey(v) for v in vals] == [jo._ckey(v) for v in vals]
    assert tv.rec_from((("a", 1),), b=2) == jo.rec_from((("a", 1),), b=2)
    assert tv.pmap_get((("c", 1),), "c") == jo.pmap_get((("c", 1),), "c")
    assert tv._set((1, 2, 3), 1, 9) == jo._set((1, 2, 3), 1, 9)
    ff_t, ff_j = TM[(False, False)], JM[(False, False)]
    mine = twalk.render_coverage(twalk.run_coverage(ff_t), "T", tool_mode=True)
    ref = jwalk.render_coverage(jwalk.run_coverage(ff_j), "T", tool_mode=True)
    assert mine == ref


def test_phases_copy_equals_reference():
    """The port's copy of the fence-mode phase rows (obs.phases): the
    phase names and segment_phases, field for field."""
    from jaxtlc.obs import phases as jp
    from torchtlc.obs import phases as tp

    for name in ("PHASE_EXPAND", "PHASE_COMMIT", "PHASE_DEVICE",
                 "PHASE_READBACK"):
        assert getattr(tp, name) == getattr(jp, name), name
    for args in ((0, 1.2345678), (7, 0.5, 0.0012345), (3, 2.0, None)):
        assert tp.segment_phases(*args) == jp.segment_phases(*args)


def test_site_dump_copies_equal_reference():
    """The port's copies of render_site_dump and zero_sites
    (obs.coverage): line for line, site for site, with and without an
    order and distinct counts, the `?` group of a site with no action
    prefix included."""
    import numpy as np

    from jaxtlc.obs import coverage as jc
    from torchtlc.obs import coverage as tc

    def table(mod):
        return tuple(mod.action_site_table("M", ("B", "A"))) + (
            mod.Site("A.g0", "guard", "A"), mod.Site("B.w0", "effect", "B",
                                                     "x' :="),
            mod.Site("?.e0", "quant", "?", "\\E p"))

    counts = np.array([5, 0, 3, 0, 7], np.uint32)
    for kw in ({}, dict(init_count=2, act_gen={"A": 9},
                        act_dist={"A": 4, "B": 1}, order=["A", "B"])):
        assert (tc.render_site_dump(table(tc), counts, "M", "STAMP", **kw)
                == jc.render_site_dump(table(jc), counts, "M", "STAMP",
                                       **kw))
    assert ([tuple(s) for s in tc.zero_sites(table(tc), counts)]
            == [tuple(s) for s in jc.zero_sites(table(jc), counts)])


def test_phase_recorder_copy_equals_reference():
    """The port's PhaseRecorder (obs.phases): the same rows from the same
    steps, drained oldest level first, expand before commit, and nothing
    after a reset."""
    from jaxtlc.obs import phases as jp
    from torchtlc.obs import phases as tp

    steps = [(1, 0.25, 0.5), (2, 0.125, 1.0), (2, 0.0625, 0.03125),
             (3, 1e-7, 2e-7)]
    rows = []
    for mod in (tp, jp):
        rec = mod.PhaseRecorder()
        for st in steps:
            rec.step(*st)
        rows.append(rec.drain())
        assert rec.drain() == []
        rec.step(4, 1.0, 1.0)
        rec.reset()
        assert rec.drain() == []
    assert rows[0] == rows[1] and len(rows[0]) == 6


def test_cov_collector_copy_equals_reference():
    """The port's CovCollector (struct.compile): the same site keys,
    ordinals and table from the same registrations, identity-keyed (one
    AST node registered twice is one site), and hits recorded only
    between begin and end."""
    from jaxtlc.struct.compile import CovCollector as JCov
    from torchtlc.struct.compile import CovCollector as TCov

    assert TCov._TAG == JCov._TAG
    a, b, c = ("cmp", 1), ("cmp", 2), ("exists", 3)
    regs = [("Vote", "guard", a, ""), ("Vote", "guard", b, ""),
            ("Vote", "guard", a, ""), (None, "quant", c, "\\E r"),
            ("Vote", "effect", b, "x' :="), ("Vote", "branch", c, "THEN")]
    out = []
    for cls in (TCov, JCov):
        cov = cls()
        cov.hit(0, "dropped")
        cov.begin()
        idxs = [cov.site(*r) for r in regs]
        for i in idxs:
            cov.hit(i, f"cond{i}")
        out.append((idxs, list(cov.sites), cov.end(), cov.active))
    assert out[0] == out[1]
    assert out[0][1][2] == ("?.e0", "quant", "?", "\\E r")


def test_table_and_ring_constructors_default_to_the_card():
    """fpset_new and ring_new, like the engines, run on the card unless
    the caller names the CPU: without a card the default raises."""
    import torch

    from torchtlc.engine.fpset import fpset_new
    from torchtlc.obs.counters import ring_new

    if torch.cuda.is_available():
        assert fpset_new(1 << 8).table.is_cuda
        assert ring_new(4, 2)[0].is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fpset_new(1 << 8)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ring_new(4, 2)
    assert fpset_new(1 << 8, "cpu").table.device.type == "cpu"
    assert ring_new(4, 2, "cpu")[1].device.type == "cpu"


def test_sharded_copies_equal_reference():
    """The sharded engine's copies of reference code (torchtlc.engine.
    sharded imports no jax: the walk above imports it with jax blocked):
    the route bucket width, the route-overflow code and its message, the
    regrow table and doubling, and the sharded ring decoder on one random
    3-shard ring."""
    import numpy as np

    from jaxtlc.engine import bfs as jb
    from jaxtlc.engine import sharded as js
    from jaxtlc.obs import counters as jc
    from jaxtlc.resil import regrow as jr
    from torchtlc.engine import bfs as tb
    from torchtlc.engine import sharded as ts
    from torchtlc.obs import counters as tc
    from torchtlc.resil import regrow as tr

    for args in ((512, 10, 1, 2.0), (2048, 10, 8, 2.0), (64, 8, 4, 0.3),
                 (32768, 12, 4, 2.0), (128, 8, 2, 4.0)):
        assert ts.route_bucket_width(*args) == js.route_bucket_width(*args)
    code = jb.VIOL_ROUTE_OVERFLOW
    assert tb.VIOL_ROUTE_OVERFLOW == code
    assert tb.VIOLATION_NAMES[code] == jb.VIOLATION_NAMES[code]
    assert tr.GROWABLE == jr.GROWABLE
    params = {"fp_capacity": 1 << 10, "queue_capacity": 1 << 9,
              "route_factor": 0.5}
    for res in params:
        assert tr.grown(params, res) == jr.grown(params, res)
    rng = np.random.default_rng(7)
    labels = tuple(f"a{i}" for i in range(4))
    ring = rng.integers(0, 2**20, (3, 7, jc.ring_cols(4)),
                        dtype=np.uint64).astype(np.uint32)
    heads = np.array([9, 9, 8])
    for since in (0, 3):
        want = jc.shard_rows_from_ring(ring, heads, labels=labels,
                                       since=since, fp_capacity_total=1 << 12)
        for r in (ring, ring.view(np.int32)):
            assert tc.shard_rows_from_ring(
                r, heads, labels=labels, since=since,
                fp_capacity_total=1 << 12) == want


def test_liveness_copies_equal_reference():
    """The liveness plane's copies of jax-free reference modules: the
    oracle the lassos are replayed through and the lasso builder keep the
    reference's code below their docstrings, and the oracle's initial
    states and successors equal the reference's on FF."""
    import inspect

    from jaxtlc.config import ModelConfig as JConfig
    from jaxtlc.live import lasso as jlasso
    from jaxtlc.spec import oracle as joracle
    from torchtlc.config import ModelConfig
    from torchtlc.live import lasso as tlasso
    from torchtlc.spec import oracle as toracle

    def body(mod):
        src = inspect.getsource(mod)
        return src[src.index("from __future__"):]

    assert body(toracle) == body(joracle)
    assert body(tlasso) == body(jlasso)
    tcfg, jcfg = ModelConfig(False, False), JConfig(False, False)
    inits = toracle.initial_states(tcfg)
    assert inits == joracle.initial_states(jcfg)
    frontier = list(inits)
    for _ in range(12):
        nxt = []
        for st in frontier:
            got = [(x.label, x.state) for x in toracle.successors(st, tcfg)]
            assert got == [(x.label, x.state)
                           for x in joracle.successors(st, jcfg)]
            nxt += [s for _, s in got]
        frontier = nxt[:64]


COPIED = ("struct/parser.py", "struct/eval.py", "struct/actions.py",
          "struct/shapes.py", "struct/loader.py", "struct/oracle.py",
          "gen/tla_parse.py", "gen/ir.py", "spec/texpr.py",
          "gen/oracle.py")


def _code_after_docstring(path):
    src = open(path).read()
    body = ast.parse(src).body
    start = body[1].lineno if isinstance(body[0], ast.Expr) else 1
    return "\n".join(src.splitlines()[start - 1:]).replace("torchtlc",
                                                           "jaxtlc")


@pytest.mark.parametrize("rel", COPIED)
def test_struct_frontend_copies_equal_reference_source(rel):
    """The port's copies of the structural and generic frontends' jax-free
    modules are the reference's code, line for line below the module
    docstring."""
    assert (_code_after_docstring(os.path.join(ROOT, "torchtlc", rel))
            == _code_after_docstring(os.path.join(ROOT, "jaxtlc", rel)))


@pytest.mark.parametrize("name", ["RaftElection", "Reconciler",
                                  "ServiceMesh"])
def test_gen_codec_layout_equals_reference(name):
    """GenCodec (torchtlc.gen.codec keeps the reference's layout code and
    writes pack/unpack in torch): every layout field, field for field, and
    the gen engine's violation names."""
    from jaxtlc.frontend.model import resolve as j_resolve
    from jaxtlc.gen import engine as jeng
    from jaxtlc.gen.codec import GenCodec as JCodec
    from torchtlc.frontend.model import resolve
    from torchtlc.gen import engine as teng
    from torchtlc.gen.codec import GenCodec

    cfg = os.path.join(ROOT, "specs", f"{name}.toolbox", "Model_1",
                       "MC.cfg")
    jspec = j_resolve(cfg, workers="cpu").genspec
    tspec = resolve(cfg, workers="cpu").genspec
    jc, tc = JCodec(jspec), GenCodec(tspec)
    for field in ("strings", "sid", "components", "offsets", "widths",
                  "n_fields", "nbits", "n_words"):
        assert getattr(tc, field) == getattr(jc, field), field
    assert {k: v.tolist() for k, v in tc.value_tables.items()} == {
        k: v.tolist() for k, v in jc.value_tables.items()}
    assert teng.VIOL_INVARIANT_BASE == jeng.VIOL_INVARIANT_BASE
    for code in (0, 4, 5, 6, 7, 100, 101, 102, 109):
        assert (teng.violation_name(tspec, code)
                == jeng.violation_name(jspec, code))


def _code_without_docstrings(path):
    """The module's syntax tree with every docstring removed."""
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
    return ast.dump(tree).replace("torchtlc", "jaxtlc")


def test_gen_coverage_copy_equals_reference_code():
    """torchtlc/gen/coverage.py is the reference's code statement for
    statement (its docstrings differ: one drops a history note)."""
    rel = os.path.join("gen", "coverage.py")
    assert (_code_without_docstrings(os.path.join(ROOT, "torchtlc", rel))
            == _code_without_docstrings(os.path.join(ROOT, "jaxtlc", rel)))


def test_analysis_copies_equal_reference():
    """torchtlc.analysis keeps its own copies of the reference's preflight
    pieces: the severities and the exit code, Finding and AnalysisReport
    field for field, sorted_findings' order, the counter-width arithmetic
    at the saturation edge, and the text report and banner of one report
    rendered by each package."""
    import random

    from jaxtlc import analysis as ja
    from jaxtlc.analysis import engine_audit as jea, report as jr
    from torchtlc import analysis as ta
    from torchtlc.analysis import engine_audit as tea, report as tr

    for name in ("SEV_ERROR", "SEV_WARNING", "SEV_INFO", "_SEV_RANK",
                 "EXIT_PREFLIGHT"):
        assert getattr(ta, name) == getattr(ja, name), name
    for cls in ("Finding", "AnalysisReport"):
        assert ([(f.name, f.type) for f in dataclasses.fields(
            getattr(ta, cls))] == [(f.name, f.type) for f in
                                   dataclasses.fields(getattr(ja, cls))])
    rng = random.Random(11)
    fields = [(rng.choice(("error", "warning", "info")),
               rng.choice(("spec", "engine")), rng.choice("abc"),
               rng.choice("xyz"), f"detail {i}") for i in range(24)]

    def findings(pkg):
        return [pkg.Finding(layer=la, check=ch, severity=sev, subject=su,
                            detail=de) for sev, la, ch, su, de in fields]

    assert ([dataclasses.astuple(f) for f in ta.sorted_findings(
        findings(ta))] == [dataclasses.astuple(f) for f in
                           ja.sorted_findings(findings(ja))])
    for cap, lanes in ((1 << 20, 12), (1 << 28, 16), (1 << 28, 15),
                       (1 << 32, 1)):
        assert ([dataclasses.astuple(f) for f in tea.audit_counter_width(
            "s", cap, lanes)] == [dataclasses.astuple(f) for f in
                                  jea.audit_counter_width("s", cap, lanes)])

    class Log:
        def __init__(self):
            self.lines = []

        def msg(self, code, text, severity=0):
            self.lines.append((code, text, severity))

    out = []
    for pkg, rep in ((ta, tr), (ja, jr)):
        report = pkg.AnalysisReport(name="r", findings=findings(pkg))
        log = Log()
        rep.render_banner(log, report)
        out.append((rep.render_report(report), log.lines,
                    report.exit_code, len(report.errors),
                    len(report.warnings), report.max_severity))
    assert out[0] == out[1]


def test_reduce_copy_equals_reference():
    """torchtlc/engine/reduce.py is the reference's reduction plan with its
    array seam swapped: the same names, the same NamedTuple fields, the
    same atom permutation of evaluator values, and each package's own lie
    variable."""
    from jaxtlc.engine import reduce as jr
    from torchtlc.engine import reduce as tr

    for name in ("RejectSet", "permute_value", "_PermProgram", "_enum_table",
                 "_mask_sigma", "_emit", "_apply_program", "ReducePlan",
                 "build_plan", "por_keep", "ReduceOps"):
        assert hasattr(tr, name) and hasattr(jr, name), name
    assert tr._PermProgram._fields == jr._PermProgram._fields
    assert tr.ReduceOps._fields == jr.ReduceOps._fields
    assert tr.ReduceOps().orbit_factor == jr.ReduceOps().orbit_factor == 1
    for name in ("_build", "_inject_lie", "_canon", "canon", "canon_host",
                 "orbit_check"):
        assert hasattr(tr.ReducePlan, name), name
    pmap = {"a": "b", "b": "a"}
    for v in ("a", "c", frozenset({"a", "c"}), ("a", "b", 3),
              (("a", 1), ("b", frozenset({"b"}))), ()):
        assert tr.permute_value(v, pmap) == jr.permute_value(v, pmap)
    src = open(os.path.join(ROOT, "torchtlc", "engine", "reduce.py")).read()
    assert "TORCHTLC_DEBUG_SYM_LIE" in src
    assert 'os.environ.get("JAXTLC_DEBUG_SYM_LIE"' not in src


def test_serving_plane_modules_are_checked():
    """The serving plane (torchtlc/serve, the monitor and trace of
    torchtlc/obs, the batched engine) is among the files the import
    checks above walk, and none of them names jax or jaxtlc."""
    names = {os.path.relpath(p, ROOT) for p in _port_files()}
    paths = [os.path.join("torchtlc", "serve", f"{m}.py")
             for m in ("__init__", "__main__", "client", "pool",
                       "scheduler", "server", "sweep")]
    paths += [os.path.join("torchtlc", "obs", f"{m}.py")
              for m in ("serve", "trace", "tlcstat", "views")]
    paths += [os.path.join("torchtlc", "engine", "batched.py"),
              os.path.join("torchtlc", "struct", "cache.py"),
              os.path.join("torchtlc", "api.py")]
    for path in paths:
        assert path in names, path
        bad = [m for m in _named_imports(os.path.join(ROOT, path))
               if _forbidden(m)]
        assert not bad, f"{path} imports {bad}"


def test_serving_plane_copies_equal_reference():
    """The port's copies of the serving plane's jax-free reference
    modules, field for field: the scheduler's job model and policy
    constants, the client, the monitor's and the trace's constants, the
    memo and the request / outcome records."""
    from jaxtlc import api as ja
    from jaxtlc.obs import serve as jos, trace as jtr
    from jaxtlc.serve import client as jcl, scheduler as jsch
    from jaxtlc.serve import sweep as jsw
    from jaxtlc.sim import engine as jse
    from jaxtlc.struct import cache as jcache
    from torchtlc import api as ta
    from torchtlc.obs import serve as tos, trace as ttr
    from torchtlc.serve import client as tcl, scheduler as tsch
    from torchtlc.serve import sweep as tsw
    from torchtlc.sim import engine as tse
    from torchtlc.struct import cache as tcache

    for name in ("JOB_FSYNC_EVERY", "DEFAULT_LARGE_FPCAP", "DEFAULT_CHUNK",
                 "DEFAULT_QCAP", "DEFAULT_FPCAP", "DEFAULT_SIM_WALKERS",
                 "DEFAULT_SIM_DEPTH", "DEFAULT_QUEUE_BOUND",
                 "DEFAULT_JOB_RETRIES", "DEFAULT_BREAKER_THRESHOLD",
                 "DEFAULT_BREAKER_COOLDOWN_S", "RETRY_BACKOFF_BASE_S",
                 "RETRY_BACKOFF_CAP_S", "REAPER_PERIOD_S", "TERMINAL_STATES",
                 "_REQUEST_OPTIONS", "_HEAVY_OPTIONS", "_SCHED_OPTIONS"):
        assert getattr(tsch, name) == getattr(jsch, name), name
    assert tsw.DEFAULT_WIDTH == jsw.DEFAULT_WIDTH
    assert tse.DEFAULT_SIM_WIDTH == jse.DEFAULT_SIM_WIDTH
    for name in ("JOURNAL_SUFFIX", "POLL_S", "_VERDICT_RANK"):
        assert getattr(tos, name) == getattr(jos, name), name
    for name in ("PID_DEVICE", "PID_HOST", "POD_PID_BASE", "TID_SEGMENT",
                 "TID_EXPAND", "TID_COMMIT", "TID_CKPT", "TID_REGROW"):
        assert getattr(ttr, name) == getattr(jtr, name), name
    assert [n for n in dir(tcl) if not n.startswith("__")] == [
        n for n in dir(jcl) if not n.startswith("__")]
    kw = dict(constants={"N": 2, "M": [1, 2]},
              sweep={"const": "N", "lo": 0, "hi": 3},
              options={"chunk": 64, "simulate": True, "simseed": 4,
                       "priority": 3, "deadline_s": 5.0}, tenant="ci")
    tj = tsch.Job("---- MODULE M ----\n====\n", "CONSTANT N = 2\n", **kw)
    jj = jsch.Job("---- MODULE M ----\n====\n", "CONSTANT N = 2\n", **kw)
    assert tj.batch_signature() == jj.batch_signature()
    assert tj.digest == jj.digest and tj.sweep_params() == jj.sweep_params()
    for f in ("is_smoke", "is_infer"):
        assert getattr(tj, f)() == getattr(jj, f)()
    assert tj.is_large(1 << 16) == jj.is_large(1 << 16)
    assert tsch._loader_constants(kw["constants"]) == \
        jsch._loader_constants(kw["constants"])
    memos = (tcache._LRUMemo(2), jcache._LRUMemo(2))
    for m in memos:
        for k in ("a", "b", "a", "c", "b"):
            if m.get(k) is None:
                m.put(k, k)
    assert memos[0].stats() == memos[1].stats()
    assert list(memos[0]._d) == list(memos[1]._d)
    assert set(f.name for f in dataclasses.fields(ja.CheckRequest)) <= set(
        f.name for f in dataclasses.fields(ta.CheckRequest))
    assert ta.VERDICT_BY_EXIT == ja.VERDICT_BY_EXIT
    assert ([f.name for f in dataclasses.fields(ta.CheckOutcome)]
            == [f.name for f in dataclasses.fields(ja.CheckOutcome)])


def test_pod_modules_are_checked():
    """The pod (torchtlc/dist) is among the files the import checks above
    walk, every module of it, and none of them names jax or jaxtlc."""
    names = {os.path.relpath(p, ROOT) for p in _port_files()}
    for mod in ("__init__", "__main__", "pod"):
        path = os.path.join("torchtlc", "dist", f"{mod}.py")
        assert path in names, path
        bad = [m for m in _named_imports(os.path.join(ROOT, path))
               if _forbidden(m)]
        assert not bad, f"{path} imports {bad}"


def test_pod_copies_equal_reference():
    """The port's copies of the pod module's constants, field for field:
    the exit codes, the coordinator, the coverage saturation window, the
    resume keys, the gathered statistic leaves, the PodResult fields the
    reference has and the launcher's flags."""
    from jaxtlc.dist import __main__ as jmain
    from jaxtlc.dist import pod as jpod
    from torchtlc.dist import __main__ as tmain
    from torchtlc.dist import pod as tpod

    for name in ("EXIT_OK", "EXIT_VIOLATION", "EXIT_PREEMPTED",
                 "DEFAULT_COORDINATOR", "COVERAGE_SAT_LEVELS",
                 "_ENGINE_KEYS", "_GEOM_KEYS", "_STAT_FIELDS"):
        assert getattr(tpod, name) == getattr(jpod, name), name
    assert tpod.PodResult._fields[:len(jpod.PodResult._fields)] == \
        jpod.PodResult._fields
    assert tmain._TRI == jmain._TRI
    jflags = {a.dest: a.default for a in jmain._parser()._actions}
    tflags = {a.dest: a.default for a in tmain._parser()._actions}
    assert set(tflags) - set(jflags) == {"device", "collectives"}
    for dest, default in jflags.items():
        assert tflags[dest] == default, dest
