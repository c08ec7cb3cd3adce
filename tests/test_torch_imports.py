"""The torchtlc port stands alone: it imports neither jax nor the jaxtlc
reference package (not even jax-free modules of it), and its copied tables
equal the reference's."""

import ast
import dataclasses
import os
import subprocess
import sys

import pytest

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
    env = dict(os.environ)
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
