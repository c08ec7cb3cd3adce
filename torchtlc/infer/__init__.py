"""Inductive invariant inference: the third verdict class (port of
jaxtlc/infer).

The counterexample-filter loop of *Plain and Simple Inductive Invariant
Inference* as a dense predicates x states kernel: conjecture bounded
candidate predicates over the struct IR (candidates), kill the ones a
reachable state refutes in one [P, S] kernel launch (filter, kernel K29
``struct_pred_matrix``), certify the survivors inductive over the
reachable set's one-step successors (certify, kernel K30
``struct_certify``) + the absint fixpoint, and run the whole loop as an
`infer` job beside exhaustive BFS and sim smoke (driver).  Both kernels
live in one emitted library a run (infer.program,
torchtlc/kernels/csrc/struct_infer.cuh).
"""

from .candidates import Candidate, conjecture  # noqa: F401
from .driver import InferEngine, InferReport, run_infer  # noqa: F401
