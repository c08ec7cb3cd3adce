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
    out = [os.path.join(ROOT, "chip_smoke.py")]
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
