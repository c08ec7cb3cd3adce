"""Model resolution: MC.cfg + MC.tla (+ .launch) -> a run spec (port of
jaxtlc/frontend/model.py).

The three config layers a Toolbox model has - the .launch file (Toolbox
knobs), MC.cfg (the TLC DSL) and MC.tla (constant definitions) - resolve
to one of the reference's frontends, as its ``-frontend auto`` does: the
KubeAPI root spec goes to the hand-written KubeAPI path (``RunSpec``), a
module inside the PlusCal-translation subset to the generic frontend
(``GenRunSpec``), any other module to the structural frontend
(``StructRunSpec``).  ``-frontend gen`` forces the generic frontend (a
module outside the subset is an error), ``-frontend struct`` the
structural one, which runs any spec.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional

from ..config import ModelConfig
from ..engine.fingerprint import DEFAULT_FP_INDEX
from .launch import LaunchConfig, parse_launch_file
from .mc_cfg import TLCConfig, parse_cfg_file
from .mc_tla import eval_constant, parse_mc_tla_file

KNOWN_INVARIANTS = ("TypeOK", "OnlyOneVersion")
KNOWN_PROPERTIES = ("ReconcileCompletes", "CleansUpProperly")

@dataclasses.dataclass
class RunSpec:
    model: ModelConfig
    invariants: List[str]
    properties: List[str]
    check_deadlock: bool
    workers: str
    fp_index: int
    spec_name: str
    model_name: str


@dataclasses.dataclass
class GenRunSpec:
    """A resolved run for the generic frontend (non-KubeAPI root spec
    inside the PlusCal-translation subset)."""

    genspec: object  # gen.ir.GenSpec
    invariants: List[str]
    properties: List[str]
    check_deadlock: bool
    workers: str
    fp_index: int
    spec_name: str
    model_name: str
    tla_path: str = ""  # module source (coverage line numbers)


@dataclasses.dataclass
class StructRunSpec:
    """A resolved run for the structural frontend (struct.loader.load's
    StructModel with the run's knobs)."""

    structmodel: object
    invariants: List[str]
    properties: List[str]
    check_deadlock: bool
    workers: str
    fp_index: int
    spec_name: str
    model_name: str


def resolve(
    cfg_path: str,
    launch_path: Optional[str] = None,
    workers: str = "gpu",
    fp_index: Optional[int] = None,
    check_deadlock: bool = True,
    const_overrides: Optional[dict] = None,
    frontend: str = "auto",
):
    """Resolve a run from an MC.cfg (with sibling MC.tla) as TLC would:
    a RunSpec (KubeAPI), a GenRunSpec or a StructRunSpec.  frontend
    "auto" picks as the reference does, "hand" forces the KubeAPI path,
    "gen" the generic one, "struct" the structural one (it runs any
    spec); ValueError for anything that cannot run."""
    if frontend not in ("auto", "hand", "gen", "struct"):
        raise ValueError(f"unknown -frontend {frontend!r}")
    cfg: TLCConfig = parse_cfg_file(cfg_path)
    model_dir = os.path.dirname(os.path.abspath(cfg_path))
    mc_tla_path = os.path.join(model_dir, "MC.tla")
    consts = dict(cfg.constants)
    extends: List[str] = []
    if os.path.exists(mc_tla_path):
        mc = parse_mc_tla_file(mc_tla_path)
        extends = mc.extends
        for name, defname in cfg.substitutions.items():
            if defname in mc.definitions:
                consts[name] = mc.definitions[defname]
    if const_overrides:
        consts.update(const_overrides)

    launch: Optional[LaunchConfig] = None
    if launch_path is None:
        toolbox_dir = os.path.dirname(model_dir)
        names = (sorted(os.listdir(toolbox_dir))
                 if os.path.isdir(toolbox_dir) else [])
        for f in names:
            if f.endswith(".launch"):
                launch_path = os.path.join(toolbox_dir, f)
                break
    if launch_path and os.path.exists(launch_path):
        launch = parse_launch_file(launch_path)

    spec_name = launch.spec_name if launch else (extends[0] if extends
                                                 else "")
    if spec_name == "" and not os.path.exists(mc_tla_path):
        # no MC.tla: TLC's Foo.cfg <-> Foo.tla convention, then a module
        # named like the toolbox directory, then a lone module
        cands = sorted(f[:-4] for f in os.listdir(model_dir)
                       if f.endswith(".tla"))
        cfg_base = os.path.splitext(os.path.basename(cfg_path))[0]
        toolbox = os.path.basename(os.path.dirname(model_dir))
        toolbox = toolbox[:-8] if toolbox.endswith(".toolbox") else toolbox
        preferred = [p for p in (cfg_base, toolbox) if p in cands]
        if preferred:
            spec_name = preferred[0]
        elif len(cands) == 1:
            spec_name = cands[0]
        elif cands:
            raise ValueError(
                f"ambiguous root spec: several .tla modules next to the "
                f"config ({', '.join(cands)}); add a .launch file or an "
                "MC.tla naming the root module")
    if frontend == "struct" or (
        frontend == "auto" and spec_name not in ("", "KubeAPI")
        and not os.path.exists(os.path.join(model_dir, f"{spec_name}.tla"))
        and os.path.exists(mc_tla_path)
    ):
        # forced structural path, or a non-KubeAPI MC whose root module
        # resolves through EXTENDS rather than a sibling file
        return _resolve_struct(cfg_path, cfg, launch, spec_name,
                               check_deadlock, workers, fp_index, model_dir,
                               const_overrides)
    if frontend == "hand" and spec_name not in ("", "KubeAPI"):
        raise ValueError(f"-frontend hand supports only the KubeAPI root "
                         f"spec, not {spec_name!r}")
    if spec_name not in ("", "KubeAPI") or frontend == "gen":
        # the generic frontend: a PlusCal-translation-subset module next
        # to the config; outside the subset, the structural frontend
        tla_path = os.path.join(model_dir, f"{spec_name}.tla")
        if not os.path.exists(tla_path):
            raise ValueError(
                f"root spec {spec_name!r}: no {spec_name}.tla next to the "
                "config (the generic frontend loads the module from there)")
        from ..gen.tla_parse import SpecParseError, load_genspec

        try:
            genspec = load_genspec(tla_path, consts, list(cfg.invariants),
                                   list(cfg.properties))
        except SpecParseError as e:
            if frontend == "gen":
                raise ValueError(
                    f"root spec {spec_name!r} is outside the supported "
                    f"PlusCal-translation subset: {e}")
            return _resolve_struct(cfg_path, cfg, launch, spec_name,
                                   check_deadlock, workers, fp_index,
                                   model_dir, const_overrides)
        if launch:
            # launch-file knobs apply as on the KubeAPI path
            check_deadlock = launch.check_deadlock
            if fp_index is None:
                fp_index = launch.fp_index
        return GenRunSpec(
            genspec=genspec,
            invariants=list(cfg.invariants),
            properties=list(cfg.properties),
            check_deadlock=check_deadlock,
            workers=workers,
            fp_index=DEFAULT_FP_INDEX if fp_index is None else fp_index,
            spec_name=spec_name,
            model_name=os.path.basename(model_dir),
            tla_path=tla_path,
        )
    if cfg.specification not in (None, "Spec"):
        raise ValueError(f"unsupported SPECIFICATION {cfg.specification!r}")

    def boolify(name: str, default: bool) -> bool:
        v = consts.get(name, default)
        if isinstance(v, str):
            v = eval_constant(v)
        if not isinstance(v, bool):
            raise ValueError(f"constant {name} must be BOOLEAN, got {v!r}")
        return v

    model = ModelConfig(
        requests_can_fail=boolify("REQUESTS_CAN_FAIL", True),
        requests_can_timeout=boolify("REQUESTS_CAN_TIMEOUT", True),
    )
    invariants = [i for i in cfg.invariants if i]
    for inv in invariants:
        if inv not in KNOWN_INVARIANTS:
            raise ValueError(f"unknown INVARIANT {inv!r}")
    properties = list(cfg.properties)
    if launch:
        enabled_inv = {n for n, on in launch.invariants if on}
        if launch.invariants:
            invariants = [i for i in invariants if i in enabled_inv]
        properties = [n for n, on in launch.properties if on]
        check_deadlock = launch.check_deadlock
        if fp_index is None:
            fp_index = launch.fp_index
    return RunSpec(
        model=model,
        invariants=invariants,
        properties=properties,
        check_deadlock=check_deadlock,
        workers=workers,
        fp_index=DEFAULT_FP_INDEX if fp_index is None else fp_index,
        spec_name=spec_name or "KubeAPI",
        model_name=(launch.model_name if launch
                    else os.path.basename(model_dir)),
    )


def _resolve_struct(cfg_path, cfg, launch, spec_name, check_deadlock,
                    workers, fp_index, model_dir,
                    const_overrides=None) -> StructRunSpec:
    from ..struct.loader import StructLoadError, load as load_struct
    from ..struct.parser import StructParseError

    try:
        sm = load_struct(cfg_path, const_overrides=const_overrides)
    except (StructLoadError, StructParseError) as e:
        raise ValueError(f"root spec {spec_name!r}: structural frontend "
                         f"cannot load the module: {e}")
    if launch:
        check_deadlock = launch.check_deadlock
        if fp_index is None:
            fp_index = launch.fp_index
    return StructRunSpec(
        structmodel=sm,
        invariants=list(cfg.invariants),
        properties=list(cfg.properties),
        check_deadlock=check_deadlock,
        workers=workers,
        fp_index=DEFAULT_FP_INDEX if fp_index is None else fp_index,
        spec_name=sm.root_name or spec_name,
        model_name=os.path.basename(model_dir),
    )
