"""The port's copies of the structural frontend's jax-free modules equal
the reference's: parse trees, inferred shapes, codec layouts and the
encoded initial states, the host oracle's counts, the generic subset's
parser (used only for -frontend auto) and the frontend each spec under
specs/ resolves to."""

import dataclasses
import glob
import os

import numpy as np
import pytest

from jaxtlc.frontend.model import GenRunSpec, StructRunSpec as JStructRun
from jaxtlc.frontend.model import resolve as j_resolve
from jaxtlc.struct import oracle as j_oracle
from jaxtlc.struct.codec import StructCodec as JCodec
from jaxtlc.struct.loader import load as j_load
from jaxtlc.struct.shapes import infer_shapes as j_infer
from jaxtlc.struct.shapes import typeok_hints as j_hints
from torchtlc.frontend.model import GenRunSpec as TGenRun
from torchtlc.frontend.model import StructRunSpec, resolve
from torchtlc.struct import oracle
from torchtlc.struct.codec import StructCodec
from torchtlc.struct.loader import load
from torchtlc.struct.shapes import infer_shapes, typeok_hints
from torchtlc.testing import one_thread

one_thread()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPECS = sorted(os.path.relpath(p, ROOT) for p in glob.glob(
    os.path.join(ROOT, "specs", "*", "Model_*", "MC.cfg")))


def _cfg(rel):
    return os.path.join(ROOT, rel)


def _shapes(load_fn, infer, hints, cfg):
    m = load_fn(cfg)
    sy = m.system
    return m, infer(sy.ev, sy.variables, sy.init_ast, sy.next_ast,
                    hints=hints(sy.ev, m.invariants, sy.variables))


def test_every_spec_is_covered():
    assert len(SPECS) == 6


@pytest.mark.parametrize("rel", SPECS)
def test_parse_tree_and_model_equal_reference(rel):
    m, jm = load(_cfg(rel)), j_load(_cfg(rel))
    assert m.root_name == jm.root_name
    assert m.source_digest == jm.source_digest
    assert m.module.def_order == jm.module.def_order
    assert set(m.module.defs) == set(jm.module.defs)
    for name, d in jm.module.defs.items():
        assert tuple(m.module.defs[name]) == tuple(d), name
    assert m.invariants == jm.invariants
    assert m.properties == jm.properties
    assert m.constants == jm.constants
    assert m.system.variables == jm.system.variables


@pytest.mark.parametrize("rel", SPECS)
def test_shapes_codec_and_initial_states_equal_reference(rel):
    m, shapes = _shapes(load, infer_shapes, typeok_hints, _cfg(rel))
    jm, jshapes = _shapes(j_load, j_infer, j_hints, _cfg(rel))
    assert {v: repr(s) for v, s in shapes.items()} == {
        v: repr(s) for v, s in jshapes.items()}
    cdc = StructCodec(m.system.variables, shapes)
    jcdc = JCodec(jm.system.variables, jshapes)
    assert (cdc.widths, cdc.offsets, cdc.n_fields, cdc.n_words) == (
        jcdc.widths, jcdc.offsets, jcdc.n_fields, jcdc.n_words)
    assert cdc.max_codes() == jcdc.max_codes()
    inits = m.system.initial_states()
    assert inits == jm.system.initial_states()
    rows = np.stack([cdc.encode(st) for st in inits])
    np.testing.assert_array_equal(
        rows, np.stack([jcdc.encode(st) for st in inits]))
    assert [cdc.decode(r) for r in rows] == inits


@pytest.mark.parametrize("rel", SPECS)
def test_oracle_counts_equal_reference(rel):
    m, jm = load(_cfg(rel)), j_load(_cfg(rel))
    r = oracle.bfs(m.system, m.invariants, check_deadlock=False)
    jr = j_oracle.bfs(jm.system, jm.invariants, check_deadlock=False)
    assert (r.generated, r.distinct, r.depth, r.max_outdegree,
            r.min_outdegree) == (jr.generated, jr.distinct, jr.depth,
                                 jr.max_outdegree, jr.min_outdegree)
    assert r.action_generated == jr.action_generated
    assert r.action_distinct == jr.action_distinct
    assert r.levels == jr.levels
    assert [k for k, _ in r.violations] == [k for k, _ in jr.violations]


@pytest.mark.parametrize("rel", SPECS)
def test_auto_resolution_follows_reference(rel):
    """auto: the reference's struct specs resolve to StructRunSpec, its
    generic-subset specs to GenRunSpec, each with the reference's run
    knobs; -frontend struct runs every spec."""
    ref = j_resolve(_cfg(rel), workers="cpu")
    got = resolve(_cfg(rel), workers="cpu")
    if isinstance(ref, GenRunSpec):
        assert isinstance(got, TGenRun)
        assert (dataclasses.astuple(got.genspec)
                == dataclasses.astuple(ref.genspec))
        assert os.path.samefile(got.tla_path, ref.tla_path)
    else:
        assert isinstance(ref, JStructRun)
        assert isinstance(got, StructRunSpec)
    assert (got.spec_name, got.model_name, got.check_deadlock,
            got.fp_index, got.invariants, got.properties) == (
        ref.spec_name, ref.model_name, ref.check_deadlock,
        ref.fp_index, ref.invariants, ref.properties)
    forced = resolve(_cfg(rel), workers="cpu", frontend="struct")
    jforced = j_resolve(_cfg(rel), workers="cpu", frontend="struct")
    assert isinstance(forced, StructRunSpec)
    assert forced.spec_name == jforced.spec_name


@pytest.mark.parametrize("rel", [r for r in SPECS if "TwoPhase" not in r
                                 and "RaftReplication" not in r])
def test_generic_subset_parse_equals_reference(rel):
    """The copies of gen/tla_parse, gen/ir and spec/texpr parse the
    generic-subset specs to the reference's IR."""
    from jaxtlc.frontend.mc_cfg import parse_cfg_file
    from jaxtlc.gen.tla_parse import load_genspec as j_gen
    from torchtlc.gen.tla_parse import load_genspec

    cfg = parse_cfg_file(_cfg(rel))
    d = os.path.dirname(_cfg(rel))
    tla = [os.path.join(d, f) for f in os.listdir(d) if f.endswith(".tla")
           and f != "MC.tla"][0]
    args = (dict(cfg.constants), list(cfg.invariants), list(cfg.properties))
    g, jg = load_genspec(tla, *args), j_gen(tla, *args)
    assert [(v.name, repr(v.domain)) for v in g.variables] == [
        (v.name, repr(v.domain)) for v in jg.variables]
    assert [a.name for a in g.actions] == [a.name for a in jg.actions]
    assert list(g.invariants) == list(jg.invariants)
