"""Device telemetry of the port: the per-level counter ring (counters)."""
