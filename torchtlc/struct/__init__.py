"""The structural TLA+ frontend of the port (jaxtlc/struct).

* parser, eval, actions, shapes, loader, oracle: copies of the reference's
  jax-free modules (module parser, TLA+ evaluator, next-state enumeration,
  finite-universe inference, model loader, host BFS oracle);
* codec: layouts and encode/decode copied, pack/unpack in torch;
* lanes: the lane IR, its torch evaluator (the plain version) and the
  numpy-style facade the compiler builds it through;
* compile: the LaneCompiler - the reference's AST walk, building lane IR;
* emit: prints the IR as ``__host__ __device__`` C++ (the bodies of
  kernels K17 struct_expand and K18 struct_inv_rows);
* backend: the compiled spec as a SpecBackend of the engines;
* cache: the in-process memo of backends;
* engine: ``check_struct``.
"""
