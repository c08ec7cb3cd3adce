"""torchtlc: the PyTorch/CUDA port of jaxtlc's exhaustive KubeAPI model
checker, for one NVIDIA H100.

Layers, from the entry point down:

* ``cli`` / ``api`` - the user's ``python -m torchtlc.cli check MC.cfg``:
  model resolution (``frontend``), the TLC transcript (``io.tlc_log``),
  the run supervisor (``resil``: segments, checkpoints, -recover,
  auto-regrow, the host spill tier) and the counterexample re-run
  (``engine.hostdriver``, ``engine.trace``);
* ``entry`` - ``entry()`` and ``dryrun_multichip()``, shaped like the
  reference's ``__graft_entry__``;
* ``engine.bfs`` - the host-driven BFS loop (``check``, ``make_engine``);
* ``engine.backend`` / ``engine.fpset`` / ``engine.fingerprint`` - the
  expand stage, the fingerprint set and the fingerprint, each with a plain
  torch version beside the wrapper of its kernel;
* ``spec`` - the KubeAPI codec, next-state function and invariants in
  plain torch; the device coverage plane (``spec.coverage_device``) and
  the host coverage walker (``spec.coverage``) behind ``-coverage``;
* ``kernels`` - the hand-written CUDA kernels (``csrc/``), their nvcc build
  and ctypes wrappers.

Imports torch and numpy only: never jax, never the reference package.
"""

__version__ = "0.2.0"  # the reference release the port tracks
