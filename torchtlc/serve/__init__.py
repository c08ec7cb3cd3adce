"""torchtlc.serve - checking as a service (port of jaxtlc.serve).

A persistent, multi-job checking service: the struct memos
(struct.cache) become a warm ``EnginePool`` (serve.pool), the run
journal and monitoring server become the per-job telemetry surface
(serve.server subclasses obs.serve), the MC.cfg constant-override layer
becomes a batch axis (serve.sweep over engine.batched: kernels K32-K33;
the smoke class over sim.engine.SimEngine: K34-K35), and
``torchtlc.api.run_check`` runs the large jobs under the resil supervisor
(serve.scheduler).

``python -m torchtlc.serve`` starts the server; ``torchtlc.serve.client``
submits.
"""

from .pool import CompileMeter, EnginePool, builds, loads  # noqa: F401
from .scheduler import Job, JobError, Scheduler  # noqa: F401
from .server import CheckServer, start_server  # noqa: F401
from .sweep import (  # noqa: F401
    SweepEngine,
    SweepError,
    class_key,
    load_anchored,
    sweep_backend,
)
