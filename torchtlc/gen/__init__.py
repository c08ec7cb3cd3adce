"""The generic frontend's parser and IR (copies of jaxtlc/gen/tla_parse.py
and jaxtlc/gen/ir.py).  The port uses them only to resolve ``-frontend
auto`` as the reference does: a spec inside the generic subset goes to the
generic frontend, which is not ported yet (ROADMAP Queue A item 12).
"""
