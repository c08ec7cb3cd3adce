"""The sharded engine over generic backends through checkpoints and the
command, against jaxtlc on the CPU (8 virtual devices): gen checkpoints
written by one package and resumed by the other (the meta's gen `config`
stanza, the carry leaf for leaf), the `-sharded 2` command's transcript
and journal, and `-checkpoint -faults sigterm@3` then `-recover`,
pipelined.  Exact comparisons."""

import numpy as np
import pytest

from jaxtlc.engine import checkpoint as jck
from jaxtlc.engine import sharded as js
from test_torch_gen_sharded import COUNTS, KW, _cfg, _gen_backends
from test_torch_struct_sharded import (
    _assert_carries_equal,
    _mesh,
    commands_both,
)
from torchtlc.engine import checkpoint as tck
from torchtlc.engine import sharded as ts
from torchtlc.testing import one_thread

one_thread()


@pytest.fixture(autouse=True)
def _no_reference_artifact_cache(monkeypatch):
    monkeypatch.setenv("JAXTLC_ARTIFACT_CACHE", "off")
    monkeypatch.setenv("TORCHTLC_ARTIFACT_CACHE", "off")


def _gen_meta(D, pipeline):
    return dict(queue_capacity=KW["queue_capacity"],
                fp_capacity=KW["fp_capacity"], devices=D, pipeline=pipeline,
                obs_slots=0, sort_free=False, deferred=False,
                symmetry=False, por=False)


@pytest.mark.parametrize("writer,pipeline", [("port", False),
                                             ("reference", True)],
                         ids=["port-writes", "reference-writes-pipelined"])
def test_checkpoint_resumes_across_packages(tmp_path, writer, pipeline):
    """check_sharded_with_checkpoints over a generic backend: one package
    stops after two segments, the other resumes its file (the meta's gen
    `config` stanza checked) to the uninterrupted reference run's
    statistics; the written carry loads in the other package leaf for
    leaf."""
    jb, tb = _gen_backends(_cfg("RaftElection"))
    path = str(tmp_path / "c.npz")
    meta_config = {"spec": "RaftElection", "constants": {}}
    kw = dict(KW, ckpt_every=3, ckpt_path=path, meta_config=meta_config,
              pipeline=pipeline)
    first, second = ((ts, tb, ts.ShardMesh(2, "cpu")), (js, jb, _mesh(2)))
    if writer == "reference":
        first, second = second, first
    pkg, b, mesh = first
    pkg.check_sharded_with_checkpoints(None, mesh, max_segments=2, backend=b,
                                       **kw)
    meta = dict(_gen_meta(2, pipeline), config=meta_config)
    if writer == "port":
        saved, jc = jck.load_checkpoint(path, js.make_sharded_engine(
            None, _mesh(2), backend=jb, **KW, pipeline=pipeline)[0]())
        saved2, tc = tck.load_checkpoint(path, ts.make_sharded_engine(
            None, ts.ShardMesh(2, "cpu"), backend=tb, **KW,
            pipeline=pipeline)[0]())
        _assert_carries_equal(tc, jc)
        assert {k: saved[k] for k in meta} == meta
    pkg, b, mesh = second
    r = pkg.check_sharded_with_checkpoints(None, mesh, resume=True,
                                           backend=b, **kw)
    want = js.check_sharded(None, _mesh(2), backend=jb, **KW,
                            pipeline=pipeline)
    for f in ("generated", "distinct", "depth", "violation", "queue_left",
              "action_generated", "action_distinct", "outdegree"):
        assert getattr(r, f) == getattr(want, f), f
    assert (r.generated, r.distinct, r.depth) == COUNTS["RaftElection"]


def test_sharded_command_equals_reference(tmp_path):
    """`check MC.cfg -sharded 2` on a generic spec: exit 13 (its PROPERTY
    lines on the host graph), the transcript and the journal equal the
    reference's."""
    out = commands_both(_cfg("RaftElection"), ["-sharded", "2", "-chunk",
                                               "64"], tmp_path)
    assert out["port"][0] == out["ref"][0] == 13
    assert out["port"][1] == out["ref"][1]
    assert out["port"][2] == out["ref"][2]
    assert "1223 states generated, 492 distinct states found" \
        in out["port"][1]


def test_checkpoint_sigterm_then_recover_equals_reference(tmp_path):
    """`-checkpoint P -checkpointevery 2 -faults sigterm@3`, then
    `-recover`, pipelined: on a generic spec the reference runs its
    checkpointed sharded engine without the supervisor, so the first run
    completes (the fault plan has no seam there) and the second resumes the
    final checkpoint; each exit code, transcript and journal equals the
    reference's, and so do the two checkpoint files, leaf for leaf."""
    base = ["-checkpoint", "@ck.npz", "-checkpointevery", "2", "-chunk",
            "16", "-pipeline"]
    first = commands_both(_cfg("Reconciler"), base + ["-faults",
                                                      "sigterm@3"], tmp_path)
    files = [np.load(tmp_path / n / "ck.npz") for n in ("ref", "port")]
    assert sorted(files[0].files) == sorted(files[1].files)
    for k in files[0].files:
        assert np.array_equal(files[0][k], files[1][k]), k
    second = commands_both(_cfg("Reconciler"), base + ["-recover"], tmp_path)
    for out in (first, second):
        assert out["port"][0] == out["ref"][0] == 0
        assert out["port"][1] == out["ref"][1]
        assert out["port"][2] == out["ref"][2]
        assert "155 states generated, 81 distinct states found" \
            in out["port"][1]
