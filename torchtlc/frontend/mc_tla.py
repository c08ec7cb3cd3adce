"""MC.tla constant-override parser (a copy of jaxtlc/frontend/mc_tla.py,
which imports no jax; the port keeps its own).

The Toolbox writes model constant overrides as an MC module EXTENDS-ing the
spec with generated definitions:

    \\* CONSTANT definitions @modelParameterConstants:1REQUESTS_CAN_FAIL
    const_1666989587949106000 ==
    TRUE

MC.cfg then binds `REQUESTS_CAN_FAIL <- const_1666989587949106000`.  We
parse the definition bodies (constant expressions only - the subset the
Toolbox generates for constant overrides) and the EXTENDS list.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List


@dataclasses.dataclass
class MCModule:
    extends: List[str]
    definitions: Dict[str, str]  # definition name -> literal body text


_DEF = re.compile(r"^(\w+)\s*==\s*(.*)$")


def parse_mc_tla(text: str) -> MCModule:
    extends: List[str] = []
    definitions: Dict[str, str] = {}
    pending: str = ""
    cur: str = ""
    for raw in text.splitlines():
        line = raw.split("\\*")[0].rstrip()
        s = line.strip()
        if s.startswith("EXTENDS"):
            extends = [x.strip() for x in s[len("EXTENDS"):].split(",")]
            continue
        if s.startswith("----") or s.startswith("===="):
            if cur and pending:
                definitions[cur] = pending.strip()
            cur, pending = "", ""
            continue
        m = _DEF.match(s)
        if m:
            if cur and pending:
                definitions[cur] = pending.strip()
            cur = m.group(1)
            pending = m.group(2)
            continue
        if cur:
            pending = (pending + " " + s).strip()
    if cur and pending:
        definitions[cur] = pending.strip()
    return MCModule(extends, definitions)


def parse_mc_tla_file(path: str) -> MCModule:
    with open(path, "r", encoding="utf-8") as f:
        return parse_mc_tla(f.read())


def eval_constant(body: str):
    """Evaluate a Toolbox-generated constant body (literal subset)."""
    b = body.strip()
    if b == "TRUE":
        return True
    if b == "FALSE":
        return False
    if re.fullmatch(r"-?\d+", b):
        return int(b)
    if b.startswith('"') and b.endswith('"'):
        return b[1:-1]
    return b  # model value / unresolved expression: keep symbolic
