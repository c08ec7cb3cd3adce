// The random walk's round over a generic spec: kernels K27
// "struct_sim_step" and K28 "sim_fold" (emitted_sim.cuh) around the
// spec's emitted step.
//
// This is the template of a generic spec's walk library, which only a walk
// builds (gen.program.GenProgram.sim_text): torchtlc.struct.emit prints
// the spec's st_step - its afail outputs constant false, the generic
// subset has no Assert - , its invariants st_inv_bits and the macros (the
// lane actions ST_LANE_ACTION are gen.kernel's lane_action) as it does
// for K19's library (gen_expand.cuh), and includes this file last.  K19's
// library stays as it was, so a check of a generic spec compiles no walk.
//
// K27 / K28 replace jaxtlc/sim/engine.py:118 make_sim_engine's walk over
// jaxtlc/engine/backend.py:480 gen_backend, whose step returns the static
// lane_action (:489) and an all-false afail (:491-494).
#pragma once
#include <stddef.h>

#include "struct_codec.cuh"
#include "emitted_sim.cuh"

extern "C" int tt_gen_sim_dims(int* out) {
  out[0] = ST_F;
  out[1] = ST_W;
  out[2] = ST_L;
  out[3] = ST_NINV;
  out[4] = ST_NLABELS;
  out[5] = ST_NK;
  return 0;
}
