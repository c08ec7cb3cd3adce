"""Constant-config sweeps: one dispatch checks K models (port of
jaxtlc/serve/sweep.py).

Real verification practice runs a portfolio of small models per spec -
the same module under many MC.cfg constant overrides.  This module
batches the override layer itself:

* **Swept constants become state fields.**  ``sweep_backend`` compiles
  the module once with each swept CONSTANT promoted to a read-only codec
  field (LaneCompiler ``sweep_vars``): expressions read the value from
  the state vector at runtime, every lane passes it through verbatim,
  and each configuration's Init seeds the field with its value.  The
  class builds one emitted library (K17's text, with K32, K34 and K35
  beside it): the swept fields pass through every lane, so the text
  covers them.  Within one run the field never changes, so a config's
  state graph is isomorphic to the baked-constant run's - verdict, depth
  and every generated / distinct / per-action counter are the same
  numbers (fingerprints differ: the encoding carries the extra field).

* **The config axis is batched.**  K per-config carries (one init_fn
  each) are stacked and engine.batched drives all K BFS loops in one
  dispatch: one launch of K32, K2 and K33 a body for every live lane,
  each lane frozen at its own fixpoint, so every lane's final carry is
  bit for bit a sequential run of the same class step (``run_sequential``
  is that baseline; the tests pin the equality down to the table words).

Supported sweep class: integer scalar CONSTANTs used as values (guards,
arithmetic, comparisons).  A constant that determines shapes - set
universes, quantifier domains, sequence caps - cannot ride a state field;
the compiler then needs a static value and raises CompileError at
class-build time.  Load the anchor model with each swept constant at its
domain max (``load_anchored``) so the inferred integer ranges cover the
whole class; a config whose values escape the anchored ranges halts with
the codec range trap.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..engine.backend import SpecBackend
from ..engine.batched import make_batched_engine
from ..engine.bfs import (
    CheckResult,
    make_backend_engine,
    resolve_deferred,
    resolve_device,
    result_from_carry,
)
from ..engine.fingerprint import DEFAULT_FP_INDEX, DEFAULT_SEED
from ..struct import lanes
from ..struct.backend import (
    VIOL_INVARIANT_BASE,
    StructKernels,
    StructProgram,
    struct_viol_names,
)
from ..struct.codec import StructCodec
from ..struct.compile import LaneCompiler
from ..struct.loader import StructModel, load
from ..struct.shapes import SInt, infer_shapes, typeok_hints

DEFAULT_WIDTH = 4  # configs per batched dispatch (pad-to-width)


class SweepError(ValueError):
    pass


def load_anchored(cfg_path: str,
                  params: Dict[str, Tuple[int, int]],
                  const_overrides: Optional[Dict[str, object]] = None,
                  ) -> StructModel:
    """Load the model with every swept constant at its domain MAX (the
    shape anchor: inferred integer ranges must cover the class).

    const_overrides carries a job's FIXED (non-swept) constants: they
    bake into the anchor like any cfg value, so the model's digest,
    canonical constants - and therefore `class_key` and every
    `config_inits` fallback - all reflect them.  Swept names in the
    dict are ignored (the anchor pins those to the domain max)."""
    overrides = {k: v for k, v in (const_overrides or {}).items()
                 if k not in params}
    overrides.update({c: int(hi) for c, (_lo, hi) in params.items()})
    return load(cfg_path, const_overrides=overrides)


def class_key(model: StructModel,
              params: Dict[str, Tuple[int, int]]) -> tuple:
    """The constants-CLASS cache key: spec digest + canonical constants
    WITHOUT the swept names + their domains.  Every configuration of
    the class maps to the same key, which is the whole point - the
    EnginePool holds one warm engine per class, not per config."""
    from ..struct.backend import canonical_constants

    consts = canonical_constants(model)
    for c in params:
        consts.pop(c, None)
    return (
        model.source_digest,
        tuple(sorted(
            (k, tuple(v) if isinstance(v, list) else v)
            for k, v in consts.items()
        )),
        tuple(model.invariants),
        tuple((c, int(lo), int(hi))
              for c, (lo, hi) in sorted(params.items())),
    )


def sweep_backend(model: StructModel,
                  params: Dict[str, Tuple[int, int]],
                  check_deadlock: bool = True) -> SpecBackend:
    """Compile `model` with the swept constants as runtime state fields
    - the constants-class step every configuration shares, one emitted
    library for the class (batched: K17 with K32, K34 and K35).  With no
    swept constant it is the model's own step, as struct_backend compiles
    it, in a batched library (the smoke class of one configuration)."""
    system = model.system
    names = tuple(sorted(params))
    for c in names:
        if c not in model.constants:
            raise SweepError(f"swept name {c!r} is not a CONSTANT")
        if not isinstance(model.constants[c], int) or isinstance(
            model.constants[c], bool
        ):
            raise SweepError(
                f"swept constant {c!r} must be an integer scalar, "
                f"got {model.constants[c]!r}"
            )
        lo, hi = params[c]
        if not (lo <= model.constants[c] <= hi):
            raise SweepError(
                f"anchor value {model.constants[c]} of {c!r} outside "
                f"its domain [{lo}, {hi}] (load the anchor model at "
                "the domain max: load_anchored)"
            )
    hints = typeok_hints(system.ev, model.invariants, system.variables)
    var_shapes = infer_shapes(system.ev, system.variables,
                              system.init_ast, system.next_ast,
                              hints=hints)
    for c in names:
        lo, hi = params[c]
        var_shapes[c] = SInt(int(lo), int(hi))
    ext_vars = tuple(system.variables) + names
    cdc = StructCodec(ext_vars, var_shapes)
    compiler = LaneCompiler(system.ev, ext_vars, var_shapes, cdc,
                            sweep_vars=frozenset(names))
    inp = lanes.input_node(cdc.n_fields)
    step_outputs = compiler.build_step(system.next_ast)(inp)
    inv_outputs = [compiler.build_invariant(ast)(inp)
                   for ast in model.invariants.values()]
    labels: List[str] = list(compiler.labels)
    action_names: Tuple[str, ...] = tuple(sorted(set(labels)))
    lane_action = np.asarray([action_names.index(x) for x in labels],
                             np.int32)
    prog = StructProgram(
        step_outputs, inv_outputs, cdc, lane_action, len(action_names),
        title=f"{model.root_name} ({model.source_digest}) batched"
              + (f", sweep {', '.join(names)}" if names else ""),
        batched=True)

    def initial_vectors():
        # the anchor configuration's Init set (per-config seeds come from
        # config_inits)
        return config_inits(
            model, params, {c: model.constants[c] for c in names}, cdc
        )

    return SpecBackend(
        cdc=cdc,
        n_lanes=len(labels),
        inv_check=prog.inv_bits_plain,
        inv_codes=tuple(
            VIOL_INVARIANT_BASE + k for k in range(len(model.invariants))
        ),
        initial_vectors=initial_vectors,
        labels=action_names,
        viol_names=struct_viol_names(model),
        check_deadlock=check_deadlock,
        kernels=StructKernels(prog),
    )


def config_inits(model: StructModel,
                 params: Dict[str, Tuple[int, int]],
                 values: Dict[str, int],
                 cdc: StructCodec) -> np.ndarray:
    """One configuration's Init set as [n0, F] field vectors of the
    class codec: enumerate Init host-side under the config's CONSTANT
    values, then append the swept fields."""
    names = tuple(sorted(params))
    missing = [c for c in names if c not in values]
    if missing:
        raise SweepError(f"config misses swept constants {missing}")
    consts = dict(model.constants)
    consts.update({c: int(values[c]) for c in names})
    sysk = model.system.with_constants(consts)
    tail = tuple(int(values[c]) for c in names)
    rows = [cdc.encode(st + tail) for st in sysk.initial_states()]
    if not rows:
        raise SweepError(f"config {values!r} has an empty Init set")
    return np.stack(rows)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class SweepEngine:
    """A warm constants-class engine: one compiled class step (its emitted
    library built at the first launch) and the batched engine that checks
    up to `width` configurations per dispatch.  Build once per class,
    `run` per submitted batch - the EnginePool holds these."""

    def __init__(
        self,
        model: StructModel,
        params: Dict[str, Tuple[int, int]],
        chunk: int = 64,
        queue_capacity: int = 1 << 10,
        fp_capacity: int = 1 << 12,
        fp_index: int = DEFAULT_FP_INDEX,
        seed: int = DEFAULT_SEED,
        check_deadlock: bool = True,
        width: int = DEFAULT_WIDTH,
        sort_free: bool = None,
        deferred: bool = None,
        device=None,
    ):
        if seed != DEFAULT_SEED:
            raise SweepError("the port's engines fingerprint under the "
                             "default seed only")
        self.model = model
        self.params = {c: (int(lo), int(hi))
                       for c, (lo, hi) in params.items()}
        self.width = max(1, int(width))
        self.chunk = int(chunk)
        self.fp_capacity = fp_capacity
        self.deferred = resolve_deferred(deferred, chunk)
        self.device = resolve_device(device)
        self.backend = sweep_backend(model, self.params, check_deadlock)
        geo = dict(chunk=chunk, queue_capacity=queue_capacity,
                   fp_capacity=fp_capacity, sort_free=sort_free,
                   deferred=deferred, device=self.device, fp_index=fp_index)
        self._init_fn, self._run_fn, _ = make_backend_engine(self.backend,
                                                             **geo)
        geo.pop("device")  # the batched engine runs on its carries' device
        self._stack_fn, self._brun, self._unstack = make_batched_engine(
            self.backend, self.width, **geo)

    # -- carries -----------------------------------------------------------

    def carry_for(self, values: Dict[str, int]):
        """A fresh engine carry seeded with one configuration's Init."""
        return self._init_fn(
            config_inits(self.model, self.params, values,
                         self.backend.cdc)
        )

    def _stack(self, configs: List[Dict[str, int]]):
        if not configs:
            raise SweepError("empty config batch")
        if len(configs) > self.width:
            raise SweepError(
                f"{len(configs)} configs > sweep width {self.width} "
                "(the scheduler slices batches to width)"
            )
        # pad to the engine's width by repeating the last config: the pad
        # lanes are computed and discarded, so one engine serves every
        # batch size
        pad = configs + [configs[-1]] * (self.width - len(configs))
        return self._stack_fn([self.carry_for(v) for v in pad])

    def _result(self, carry, wall_s: float, iterations: int = -1
                ) -> CheckResult:
        return result_from_carry(
            carry, wall_s, iterations=iterations,
            fp_capacity=self.fp_capacity, labels=self.backend.labels,
            viol_names=struct_viol_names(self.model),
        )

    # -- execution ---------------------------------------------------------

    def run_carries(self, configs: List[Dict[str, int]]):
        """(final lane carries, pad lanes included, and the dispatch's
        wall) of one batched dispatch."""
        stacked = self._stack(configs)
        _sync(self.device)
        t0 = time.time()
        out = self._brun(stacked)
        _sync(self.device)
        return self._unstack(out), time.time() - t0

    def run(self, configs: List[Dict[str, int]]) -> List[CheckResult]:
        """Check up to `width` configurations in ONE dispatch; per-config
        results in submission order.  wall_s on every result is the whole
        batch's dispatch wall (one dispatch = one wall)."""
        carries, wall = self.run_carries(configs)
        return [self._result(carries[k], wall, self._brun.bodies)
                for k in range(len(configs))]

    def sequential_carries(self, configs: List[Dict[str, int]]):
        """The final carry of each configuration run alone (the same class
        step through make_backend_engine), with its wall."""
        out = []
        for values in configs:
            carry = self.carry_for(values)
            _sync(self.device)
            t0 = time.time()
            carry = self._run_fn(carry)
            _sync(self.device)
            out.append((carry, time.time() - t0, self._run_fn.steps))
        return out

    def run_sequential(self,
                       configs: List[Dict[str, int]]) -> List[CheckResult]:
        """The parity baseline: the SAME class step, one config at a time
        (K dispatches).  The tests pin run() bit for bit against this,
        table words included."""
        return [self._result(c, wall, steps)
                for c, wall, steps in self.sequential_carries(configs)]
