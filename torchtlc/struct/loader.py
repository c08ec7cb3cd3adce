"""Load a TLC model directory through the structural frontend (E1).

Reads the unmodified reference artifacts the way TLC does
(MC.out:8-24's SANY pass): MC.cfg for CONSTANT/SPECIFICATION/INVARIANT/
PROPERTY, MC.tla for the generated constant-override definitions, and
the EXTENDS closure of real module files next to the config (Model_1
carries its own KubeAPI.tla copy) - falling back to the toolbox parent
directory for the root spec.  Standard modules (Naturals, FiniteSets,
Sequences, TLC) are built into the evaluator.

The port's copy of jaxtlc/struct/loader.py, which imports no jax: the port imports
nothing of the reference package and keeps its own.
"""

from __future__ import annotations

import hashlib
import os
from typing import Dict, NamedTuple, Optional

from ..frontend.mc_cfg import parse_cfg_file
from ..spec.labels import DEFAULT_INIT
from .actions import ActionSystem
from .eval import Evaluator
from .parser import Definition, Module, StructParseError, parse_module

_BUILTIN_MODULES = {
    "TLC", "Naturals", "Integers", "Reals", "Sequences", "FiniteSets",
    "Bags", "TLAPS", "Toolbox",
}


class StructModel(NamedTuple):
    system: ActionSystem
    invariants: Dict[str, tuple]  # name -> AST
    properties: Dict[str, tuple]  # name -> AST (leadsto shapes)
    constants: Dict[str, object]
    module: Module
    fairness: Optional[str]  # "wf_next" | None
    root_name: str
    # sha256 over every source text this model was loaded from (cfg +
    # module closure) plus the constant overrides - the step-compile
    # cache key component that changes iff the spec's meaning can
    # (struct.cache keys its memo and the checkpoint meta on it)
    source_digest: str = ""


class StructLoadError(ValueError):
    pass


def _parse_const_literal(text: str):
    t = text.strip()
    if t == "TRUE":
        return True
    if t == "FALSE":
        return False
    if t.startswith('"') and t.endswith('"'):
        return t[1:-1]
    if t.lstrip("-").isdigit():
        return int(t)
    if t.startswith("{") and t.endswith("}"):
        # model-value set: CONSTANT RM = {r1, r2}.  Flat sets of simple
        # literals only - nested braces or quoted commas would split
        # wrong, so they are a loud error, not a garbage constant.
        inner = t[1:-1].strip()
        if not inner:
            return frozenset()
        if "{" in inner or '"' in inner:
            raise StructLoadError(
                f"unsupported constant set literal {t!r} (flat "
                "model-value/number sets only)"
            )
        return frozenset(
            _parse_const_literal(x) for x in inner.split(",")
        )
    if t == "defaultInitValue":
        return DEFAULT_INIT
    # TLC model value: an atom equal only to itself; the hand oracle
    # uses the same string-atom convention (spec/labels.py DEFAULT_INIT)
    return t


def _load_module_closure(path: str, search_dirs, texts=None) -> Module:
    """Parse `path` and fold in its non-builtin EXTENDS (depth-first,
    extended defs first so the extender can override).  `texts`, when
    given, collects every (path, source) read - the digest input."""
    with open(path) as f:
        src = f.read()
    if texts is not None:
        texts.append((path, src))
    root = parse_module(src)
    defs: Dict[str, Definition] = {}
    def_order = []
    variables = []
    constants = []

    def fold(mod: Module):
        for d in mod.def_order:
            if d not in defs:
                def_order.append(d)
            defs[d] = mod.defs[d]
        for v in mod.variables:
            if v not in variables:
                variables.append(v)
        for c in mod.constants:
            if c not in constants:
                constants.append(c)

    for ext in root.extends:
        if ext in _BUILTIN_MODULES:
            continue
        found = None
        for d in search_dirs:
            cand = os.path.join(d, f"{ext}.tla")
            if os.path.exists(cand):
                found = cand
                break
        if found is None:
            raise StructLoadError(
                f"EXTENDS {ext}: no {ext}.tla in {list(search_dirs)}"
            )
        fold(_load_module_closure(found, search_dirs, texts))
    fold(root)
    return Module(
        name=root.name,
        extends=root.extends,
        constants=tuple(constants),
        variables=tuple(variables),
        defs=defs,
        def_order=tuple(def_order),
    )


def load(cfg_path: str,
         const_overrides: Optional[Dict[str, object]] = None) -> StructModel:
    cfg = parse_cfg_file(cfg_path)
    model_dir = os.path.dirname(os.path.abspath(cfg_path))
    toolbox_parent = os.path.dirname(os.path.dirname(model_dir))
    search_dirs = (model_dir, toolbox_parent)
    texts = [(cfg_path, open(cfg_path).read())]

    mc_path = os.path.join(model_dir, "MC.tla")
    if os.path.exists(mc_path):
        module = _load_module_closure(mc_path, search_dirs, texts)
        root_name = next(
            (e for e in module.extends if e not in _BUILTIN_MODULES), "MC"
        )
    else:
        # bare layout: the cfg's own basename names the root module
        base = os.path.splitext(os.path.basename(cfg_path))[0]
        cand = os.path.join(model_dir, f"{base}.tla")
        if not os.path.exists(cand):
            tlas = [f for f in sorted(os.listdir(model_dir))
                    if f.endswith(".tla")]
            if len(tlas) != 1:
                raise StructLoadError(
                    f"no MC.tla and no {base}.tla next to {cfg_path}"
                )
            cand = os.path.join(model_dir, tlas[0])
        module = _load_module_closure(cand, search_dirs, texts)
        root_name = module.name

    digest = hashlib.sha256()
    for _, src in texts:
        digest.update(src.encode())
        digest.update(b"\x00")
    if const_overrides:
        for k in sorted(const_overrides):
            digest.update(f"{k}={const_overrides[k]!r};".encode())

    constants: Dict[str, object] = {}
    for name, val in cfg.constants.items():
        constants[name] = _parse_const_literal(val)
    ev0 = Evaluator(module.defs, {})
    for name, defname in cfg.substitutions.items():
        d = module.defs.get(defname)
        if d is None:
            raise StructLoadError(
                f"CONSTANT {name} <- {defname}: no such definition"
            )
        constants[name] = ev0.eval(d.body, {})
    if const_overrides:
        constants.update(const_overrides)
    # every declared constant needs a value (defaultInitValue is a model
    # value equal only to itself when left unassigned)
    for c in module.constants:
        if c not in constants:
            constants[c] = DEFAULT_INIT if c == "defaultInitValue" else c

    ev = Evaluator(module.defs, constants)

    spec_name = cfg.specification or "Spec"
    spec_def = module.defs.get(spec_name)
    if spec_def is not None and spec_def.body[0] == "spec":
        _, init_name, next_name, fairness = spec_def.body
    else:
        init_name, next_name, fairness = "Init", "Next", None
    if init_name not in module.defs or next_name not in module.defs:
        raise StructLoadError(
            f"cannot resolve Init/Next ({init_name}/{next_name})"
        )

    def _named_defs(names):
        out = {}
        for n in names:
            d = module.defs.get(n)
            if d is None:
                raise StructLoadError(f"no definition for {n!r}")
            out[n] = d.body
        return out

    return StructModel(
        system=ActionSystem(ev, module.variables, init_name, next_name),
        invariants=_named_defs(cfg.invariants),
        properties=_named_defs(cfg.properties),
        constants=constants,
        module=module,
        fairness=fairness,
        root_name=root_name,
        source_digest=digest.hexdigest(),
    )
