"""Device-resident liveness (port of jaxtlc/live): enumerate, capture the
edge relation, survive-set fixpoint, replayed lassos.

1. **Enumerate** - engine.bfs.make_enumerator leaves the reachable set on
   the card in id order (kernels K1-K4).
2. **Capture** (live.capture) - every state is expanded again (K1, K2) and
   each successor's id resolved by a binary search over the
   fingerprint-sorted states (K14), giving (src, dst, action, changed)
   int32 edges; the per-state property operands come from K15.
3. **Fixpoint** (live.fixpoint) - the greatest fixpoint of
   engine.liveness as Jacobi sweeps over the edges (K16), the edges in D
   slices with -sharded N (engine.sharded.sharded_survive_fixpoint).
4. **Lasso** (live.lasso) - prefix and cycle from the captured edges,
   replayed through the host oracle (spec.oracle) before they are shown.
"""

from .check import (  # noqa: F401
    HOST_PATH_MAX,
    check_properties_device,
    use_device_path,
)
