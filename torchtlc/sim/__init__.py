"""Simulation tier: random-walk smoke checking on the card (port of
jaxtlc/sim).

W walker lanes, each holding one state, are stepped depth-D through the
spec's step - a struct or generic spec's emitted step (kernel K27
``struct_sim_step`` and K28 ``sim_fold``, torchtlc/kernels/csrc/
emitted_sim.cuh; a generic spec's in its walk text, gen_sim.cuh), the
KubeAPI spec's hand-written one (K39 ``kube_sim_step`` and K40
``kube_sim_fold``, kube_sim.cu) - each choosing a uniformly random
enabled successor with counter-based threefry bits (sim.threefry), so
every lane is a pure function of ``(run_seed, lane_id)``.  Their plain
versions are sim.plain's.  A tripped
invariant / deadlock / assertion lane needs no on-device trace storage:
``sim.replay`` re-walks the lane on the host from its seed, and the
violation renders as the exit-12 trace a BFS run would print.

A simulation verdict is a smoke verdict: "ok" means no violation was
found in the sampled behaviors, never that none exists.  The serving
plane's batched ``SimEngine`` (sim.engine, kernels K34 and K35) walks
struct specs.
"""

from .engine import (  # noqa: F401
    SimCarry,
    SimResult,
    carry_from_reference,
    carry_to_reference,
    get_sim_engine,
    make_sim_engine,
    result_from_sim_carry,
)
from .replay import replay_lane  # noqa: F401
