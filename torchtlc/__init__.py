"""torchtlc: the PyTorch/CUDA port of jaxtlc's exhaustive model checker,
for one NVIDIA H100.

Layers, from the entry point down:

* ``cli`` / ``api`` - the user's ``python -m torchtlc.cli check MC.cfg``:
  model resolution (``frontend``), the preflight lints (``analysis``),
  the TLC transcript (``io.tlc_log``),
  the run supervisor (``resil``: segments, checkpoints, -recover,
  auto-regrow, the host spill tier) and the counterexample re-run
  (``engine.hostdriver``, ``engine.trace``);
* ``entry`` - ``entry()`` and ``dryrun_multichip()``, shaped like the
  reference's ``__graft_entry__``;
* ``engine.bfs`` - the host-driven BFS loop (``check``, ``make_engine``);
  ``engine.sharded`` - D fingerprint-space shards in one process, over any
  backend (KubeAPI's K1 and K7 variants, or K21 and K18 of an emitted
  spec);
* ``engine.backend`` / ``engine.fpset`` / ``engine.fingerprint`` - the
  expand stage, the fingerprint set and the fingerprint, each with a plain
  torch version beside the wrapper of its kernel;
* ``spec`` - the KubeAPI codec, next-state function and invariants in
  plain torch; the device coverage plane (``spec.coverage_device``) and
  the host coverage walker (``spec.coverage``) behind ``-coverage``;
* ``struct`` - the structural frontend: copies of the reference's parser,
  evaluator, shape inference, loader and oracle, the LaneCompiler on a
  lane IR (torch-evaluated: the plain version) and its C++ emission, the
  body of kernels K17/K18/K21 (``struct.engine.check_struct``,
  ``check_struct_sharded``);
* ``gen`` - the generic frontend: copies of the reference's subset parser,
  IR, oracle and coverage walker, the gen compiler on the same lane IR,
  emitted as kernels K19/K20 (and K21/K18 for the sharded engine), and
  the gen engine
  (``gen.engine.check_gen``);
* ``kernels`` - the hand-written CUDA kernels (``csrc/``), their nvcc build
  and ctypes wrappers.

Imports torch and numpy only: never jax, never the reference package.
"""

__version__ = "0.2.0"  # the reference release the port tracks
