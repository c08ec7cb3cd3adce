"""TLC configuration (MC.cfg) parser (a copy of jaxtlc/frontend/mc_cfg.py,
which imports no jax; the port keeps its own).

Parses the TLC config DSL as a Toolbox model writes it: CONSTANT
declarations/substitutions, SPECIFICATION, INVARIANT and PROPERTY lists.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional


@dataclasses.dataclass
class TLCConfig:
    constants: Dict[str, str]  # CONSTANT name = value
    substitutions: Dict[str, str]  # CONSTANT name <- definition-name
    specification: Optional[str]
    invariants: List[str]
    properties: List[str]
    init: Optional[str] = None
    next: Optional[str] = None


_SECTION = re.compile(
    r"^(CONSTANTS?|SPECIFICATION|INVARIANTS?|PROPERTY|PROPERTIES|INIT|NEXT)\b"
)


def parse_cfg(text: str) -> TLCConfig:
    cfg = TLCConfig({}, {}, None, [], [])
    section = None
    for raw in text.splitlines():
        line = raw.split("\\*")[0].strip()  # \* comments
        if not line:
            continue
        m = _SECTION.match(line)
        if m:
            section = m.group(1)
            line = line[m.end():].strip()
            if not line:
                continue
        if section is None:
            continue
        if section.startswith("CONSTANT"):
            if "<-" in line:
                name, val = (x.strip() for x in line.split("<-", 1))
                cfg.substitutions[name] = val
            elif "=" in line:
                name, val = (x.strip() for x in line.split("=", 1))
                cfg.constants[name] = val
            else:
                # bare model-value declaration
                cfg.constants[line] = line
        elif section == "SPECIFICATION":
            cfg.specification = line
        elif section.startswith("INVARIANT"):
            cfg.invariants.extend(line.split())
        elif section in ("PROPERTY", "PROPERTIES"):
            cfg.properties.extend(line.split())
        elif section == "INIT":
            cfg.init = line
        elif section == "NEXT":
            cfg.next = line
    return cfg


def parse_cfg_file(path: str) -> TLCConfig:
    with open(path, "r", encoding="utf-8") as f:
        return parse_cfg(f.read())
