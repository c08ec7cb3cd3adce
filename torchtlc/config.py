"""Model configuration: constants + finite bounds for the tensor codec.

A copy of jaxtlc/config.py (the port imports nothing of the JAX package);
the two must stay field-for-field equal, which tests/test_torch_imports.py
checks.

The reference TLC run pins its two fault-injection constants in
Model_1/MC.tla:4-11 (both TRUE) and binds them via MC.cfg:2-8.  The state space is finite because every domain in the spec is
finite; this module records those bounds so the codec can allocate fixed-width
slots (SURVEY.md §7 "hard parts": bounds must be config-driven with overflow
detection).

Scaled configs (BASELINE.json: N controllers x M objects) generalize the
process set: N *reconciler* clients - copies of the spec's `process Client`
(KubeAPI.tla:161-220), each owning a private Secret kind and one PVC - plus
M *binder* controllers - copies of `process PVCController`
(KubeAPI.tla:225-260), each able to bind ANY unbound PVC.  All PVCs share the
"PVC" kind, so binders couple every reconciler's state machine exactly the
way the single PVCController couples with the single Client in Model_1;
secrets get per-reconciler kinds so one client's cleanup (which deletes every
listed object of its secret kind, KubeAPI.tla:618-629) cannot delete another
client's secret and break the reconcile assert (KubeAPI.tla:196).
`shouldReconcile` becomes a function over the reconciler set (the spec's is
`[{"Client"} -> BOOLEAN]`, KubeAPI.tla:465), giving 2^N initial states.

Everything downstream (codec widths, kernel lane counts) derives from this
object; Model_1 is the (1 reconciler, 1 binder) instance with the reference's
exact names.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

RECONCILER = "reconciler"
BINDER = "binder"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Bounds and constants for one model-checking run."""

    # Fault-injection constants (KubeAPI.tla:4-9; MC.tla:4-11)
    requests_can_fail: bool = True
    requests_can_timeout: bool = True

    # Object identities (kind, name) that can ever exist in apiState.
    # Model_1 only ever writes Secret/"foo" (KubeAPI.tla:176) and PVC/"mypvc"
    # (KubeAPI.tla:182).
    identities: Tuple[Tuple[str, str], ...] = (("Secret", "foo"), ("PVC", "mypvc"))

    # Client processes (issue API/ListAPI calls; ProcSet minus the server,
    # KubeAPI.tla:453).  Order fixes the vv bit assignment and the request
    # slot order.
    clients: Tuple[str, ...] = ("Client", "PVCController")

    # Self-test mutation: deliberately break one transition rule so the
    # violation-detection + trace-reconstruction pipeline can be exercised
    # end-to-end (the spec itself is correct, so no real config violates).
    #   ""            - faithful semantics
    #   "delete_noop" - server Delete leaves apiState unchanged; the
    #                   cleanup assert at KubeAPI.tla:216 must then fire
    #   "sticky_reconcile" - C2 does not clear shouldReconcile; the
    #                   ReconcileCompletes liveness property must then fail
    mutation: str = ""

    # Role of each client, aligned with `clients`: RECONCILER runs the
    # Client label machine (CStart..C5), BINDER runs the PVCController one
    # (PVCStart..PVCDone).
    roles: Tuple[str, ...] = (RECONCILER, BINDER)

    # Per-client (secret_identity_index, pvc_identity_index) into
    # `identities` for reconcilers ((-1, -1) for binders): the objects that
    # client's Force/Get calls target (KubeAPI.tla:176,182).
    targets: Tuple[Tuple[int, int], ...] = ((0, 1), (-1, -1))

    def __post_init__(self):
        assert len(self.roles) == len(self.clients) == len(self.targets)
        for role, (si, pi) in zip(self.roles, self.targets):
            if role == RECONCILER:
                assert 0 <= si < len(self.identities)
                assert 0 <= pi < len(self.identities)
                assert self.identities[pi][0] == "PVC", (
                    "reconciler PVC target must have kind 'PVC' "
                    "(binders list that kind, KubeAPI.tla:227)"
                )
            else:
                assert role == BINDER and (si, pi) == (-1, -1)

    @property
    def kinds(self) -> Tuple[str, ...]:
        seen = []
        for k, _ in self.identities:
            if k not in seen:
                seen.append(k)
        return tuple(seen)

    @property
    def n_identities(self) -> int:
        return len(self.identities)

    @property
    def n_clients(self) -> int:
        return len(self.clients)

    @property
    def processes(self) -> Tuple[str, ...]:
        """ProcSet (KubeAPI.tla:453): the clients plus the API server."""
        return self.clients + ("Server",)

    @property
    def reconciler_indices(self) -> Tuple[int, ...]:
        """Client indices running the reconciler label machine, in order;
        position in this tuple == that client's shouldReconcile bit."""
        return tuple(i for i, r in enumerate(self.roles) if r == RECONCILER)

    @property
    def n_reconcilers(self) -> int:
        return len(self.reconciler_indices)

    @property
    def max_per_kind(self) -> int:
        """Max number of identities sharing one kind == list-result bound."""
        return max(sum(1 for k, _ in self.identities if k == kk) for kk in self.kinds)

    def identity_id(self, kind: str, name: str) -> int:
        return self.identities.index((kind, name))

    def sr_index(self, client_index: int) -> int:
        """shouldReconcile bit position for a reconciler client."""
        return self.reconciler_indices.index(client_index)


# The configuration checked by the committed reference TLC run (MC.out).
MODEL_1 = ModelConfig(requests_can_fail=True, requests_can_timeout=True)

# The fault-injection smoke-test matrix (SURVEY.md §4 item 3): turning the
# constants off shrinks the state space - the natural fast-CI corners.
MATRIX = {
    (False, False): ModelConfig(False, False),
    (False, True): ModelConfig(False, True),
    (True, False): ModelConfig(True, False),
    (True, True): MODEL_1,
}


def make_scaled(
    n_reconcilers: int = 2,
    n_binders: int = 1,
    requests_can_fail: bool = True,
    requests_can_timeout: bool = True,
    mutation: str = "",
) -> ModelConfig:
    """N-controller x M-object generalization (BASELINE.json "KubeAPI.tla
    scaled"): n_reconcilers Client copies + n_binders PVCController copies
    over 2*n_reconcilers object identities."""
    assert n_reconcilers >= 1
    identities = []
    clients, roles, targets = [], [], []
    for i in range(n_reconcilers):
        identities.append((f"Secret{i}", "foo"))
        identities.append(("PVC", f"pvc{i}"))
        clients.append(f"Client{i}")
        roles.append(RECONCILER)
        targets.append((2 * i, 2 * i + 1))
    for j in range(n_binders):
        clients.append(f"PVCCtl{j}")
        roles.append(BINDER)
        targets.append((-1, -1))
    return ModelConfig(
        requests_can_fail,
        requests_can_timeout,
        tuple(identities),
        tuple(clients),
        mutation,
        tuple(roles),
        tuple(targets),
    )


def scaled_config():
    """The `bench.py --scaled` workload: config + engine sizing.

    A frontier far wider than Model_1's (whose peak level is ~906 states,
    MC.out:35): 2 reconcilers x 1 binder, faults off, 62,014,325 generated
    / 19,359,985 distinct / depth 186 (SCALED_VALIDATION.json).  The
    sizing is the reference engine's: a 128k-state chunk pops an average
    level (~104k states) in one step, and a 2^26-slot table ends the run
    at 0.29 load.
    """
    cfg = make_scaled(n_reconcilers=2, n_binders=1, requests_can_fail=False,
                      requests_can_timeout=False)
    return cfg, dict(chunk=131072, queue_capacity=1 << 21,
                     fp_capacity=1 << 26)
