"""The generic frontend (port of jaxtlc/gen): specs written in the
PlusCal-translation subset.  A module parser and finite-domain IR
(``tla_parse``, ``ir``: copies), the host interpreter and coverage walker
(``oracle``, ``coverage``: copies), the codec (``codec``), the AST ->
lane-IR compiler (``kernel``), its emission as kernels K19 and K20
(``program``) and the gen engine's own exhaustive BFS (``engine``).
"""
