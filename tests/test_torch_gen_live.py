"""The generic frontend's device liveness path (torchtlc.live.check
check_leads_to_device over torchtlc.engine.backend.gen_backend) against
jaxtlc's on the CPU, on the three shipped generic specs, zero tolerance:
the enumerated states and the captured graph array for array (the
enumerator and the capture sweep through the backend's expand route, the
plain version of kernel K19), the property operands of kernel K20 (its
plain version and a g++ build of the emitted gen_masks.cuh text) against
the reference's vmapped compile_expr, each fixpoint's alive set and sweep
count, and the verdicts and lassos; then the command on the device path
(both packages' HOST_PATH_MAX at 0) against the reference's transcript."""

import contextlib
import ctypes
import io
import os
import re

import jax
import numpy as np
import pytest
import torch

from jaxtlc.cli import main as j_main
from jaxtlc.engine.sharded import gen_backend as j_gen_backend
from jaxtlc.frontend.model import resolve as j_resolve
from jaxtlc.gen.kernel import _Ctx as JCtx
from jaxtlc.gen.kernel import compile_expr as j_compile
from jaxtlc.live import capture as jcap
from jaxtlc.live import check as jchk
from jaxtlc.live import fixpoint as jfix
from torchtlc.cli import main
from torchtlc.engine.backend import gen_backend
from torchtlc.frontend.model import resolve
from torchtlc.kernels.build import build_struct
from torchtlc.live import check as tchk
from torchtlc.live import fixpoint as tfix
from torchtlc.testing import one_thread

one_thread()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ["RaftElection", "Reconciler", "ServiceMesh"]
SIZING = dict(chunk=256, state_capacity=1 << 13, fp_capacity=1 << 14)
P, LL = ctypes.c_void_p, ctypes.c_longlong


def masked(text: str) -> str:
    lines = [ln for ln in text.splitlines()
             if not ln.startswith(("jaxtlc ", "torchtlc ",
                                   "Running breadth-first search"))]
    text = re.sub(r"\d{4}-\d\d-\d\d \d\d:\d\d:\d\d", "DATE",
                  "\n".join(lines))
    text = re.sub(r"Finished in \d+ms", "Finished in Nms", text)
    return re.sub(r"\([\d,]+ (s|ds)/min\)", r"(N \1/min)", text)


def _cfg(name):
    return os.path.join(ROOT, "specs", f"{name}.toolbox", "Model_1", "MC.cfg")


@pytest.fixture(scope="module", params=NAMES)
def model(request):
    """(reference spec, port spec, reference graph, port graph)."""
    jg = j_resolve(_cfg(request.param), workers="cpu").genspec
    tg = resolve(_cfg(request.param), workers="cpu").genspec
    jgraph = jcap.capture_edges(j_gen_backend(jg), chunk=SIZING["chunk"],
                                state_capacity=SIZING["state_capacity"],
                                fp_capacity=SIZING["fp_capacity"])
    tgraph = tchk.capture_gen_graph(tg, **SIZING, device="cpu")
    return jg, tg, jgraph, tgraph


def test_captured_graph_equals_reference(model):
    _, _, jgraph, tgraph = model
    assert tgraph.n_states == jgraph.n_states
    assert tgraph.init_count == jgraph.init_count
    assert np.array_equal(tgraph.states, np.asarray(jgraph.states))
    for leaf in ("src", "dst", "action", "changed"):
        assert np.array_equal(getattr(tgraph, leaf),
                              np.asarray(getattr(jgraph, leaf))), leaf


def _host_masks(masks, states):
    lib = ctypes.CDLL(build_struct(masks.text, host=True))
    lib.host_gen_state_masks.argtypes = [P, P, LL, P]
    st = np.ascontiguousarray(states.view(np.int32))
    out = np.zeros((masks.n_pred, len(st)), np.uint8)
    K = np.ascontiguousarray(masks.K)
    lib.host_gen_state_masks(K.ctypes.data_as(P), st.ctypes.data_as(P),
                             len(st), out.ctypes.data_as(P))
    return out


def test_operands_fixpoints_and_lassos_equal_reference(model):
    """Per property: K20's planes (plain and the g++ build) equal the
    reference's masks; the ~q zone's alive set and sweep count equal the
    reference's surviving_set; check_leads_to_device's verdict and lasso
    equal the reference's on the same graph."""
    jg, tg, jgraph, tgraph = model
    jcdc = j_gen_backend(jg).cdc
    tcdc = gen_backend(tg).cdc
    states = torch.from_numpy(tgraph.states.view(np.int32))
    assert jg.properties.keys() == tg.properties.keys()
    for name, (p_ast, q_ast) in tg.properties.items():
        ctx = JCtx(codec=jcdc, consts=dict(jg.constants), binding={},
                   at=None)
        jp, jq = jcap.eval_state_masks(
            jgraph, jcdc, [jax.vmap(j_compile(a, ctx)[1])
                           for a in jg.properties[name]])
        masks = tchk.gen_operand_masks(tg, tcdc, p_ast, q_ast, title=name)
        plain = masks.masks_plain(states).numpy()
        assert np.array_equal(plain.astype(bool),
                              np.stack([np.asarray(jp), np.asarray(jq)]))
        assert np.array_equal(_host_masks(masks, tgraph.states), plain)
        in_h = ~plain[1].astype(bool)
        j_alive, j_sweeps = jfix.surviving_set(jgraph, in_h)
        t_alive, t_sweeps = tfix.surviving_set(tgraph, in_h, device="cpu")
        assert np.array_equal(t_alive, np.asarray(j_alive))
        assert t_sweeps == int(j_sweeps)
        ref = jchk.check_leads_to_device(jg, p_ast, q_ast, name,
                                         graph=jgraph)
        got = tchk.check_leads_to_device(tg, p_ast, q_ast, name,
                                         graph=tgraph, device="cpu")
        assert got.holds == ref.holds
        assert got.lasso_prefix == ref.lasso_prefix
        assert got.lasso_cycle == ref.lasso_cycle


@pytest.mark.parametrize("name,rc", [("Reconciler", 0), ("ServiceMesh", 13)])
def test_device_path_command_equals_reference(name, rc, monkeypatch):
    """The command with both packages' HOST_PATH_MAX at 0: the properties
    go to the device path, the transcript (masked) and exit code are the
    reference's."""
    monkeypatch.setenv("JAXTLC_ARTIFACT_CACHE", "off")
    monkeypatch.setattr(jchk, "HOST_PATH_MAX", 0)
    monkeypatch.setattr(tchk, "HOST_PATH_MAX", 0)
    outs = []
    for fn, own in ((main, []), (j_main, [])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            got = fn(["check", _cfg(name), "-noTool", "-workers", "cpu",
                      *own])
        outs.append((got, buf.getvalue()))
    (t_rc, out), (j_rc, ref) = outs
    assert (t_rc, j_rc) == (rc, rc)
    assert "with 81 total distinct" in out or "1444 total distinct" in out
    assert "device" in out
    assert masked(out) == masked(ref)
