"""Self-healing runs: the supervisor (auto-regrow, the host spill tier,
preemption-safe exits, retry with backoff), carry migration across
engine geometries, and the deterministic fault injection that proves
every recovery path."""
