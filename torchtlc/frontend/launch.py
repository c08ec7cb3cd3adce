"""Toolbox .launch reader (a copy of jaxtlc/frontend/launch.py, which
imports no jax; the port keeps its own).

Parses the Eclipse launch configuration the Toolbox writes per model run:
worker count, fingerprint polynomial index, deadlock checking, the
invariant/property selection with its 1/0 enabled prefix, the
distributed-TLC knobs and constant assignments.
"""

from __future__ import annotations

import dataclasses
import xml.etree.ElementTree as ET
from typing import Dict, List, Tuple


@dataclasses.dataclass
class LaunchConfig:
    spec_name: str
    model_name: str
    behavior_spec: str
    workers: int
    fp_index: int
    check_deadlock: bool
    invariants: List[Tuple[str, bool]]  # (name, enabled)
    properties: List[Tuple[str, bool]]
    constants: Dict[str, str]
    distributed_tlc: str
    distributed_fpset_count: int
    distributed_nodes_count: int


def parse_launch_file(path: str) -> LaunchConfig:
    root = ET.parse(path).getroot()
    s: Dict[str, str] = {}
    i: Dict[str, int] = {}
    b: Dict[str, bool] = {}
    lists: Dict[str, List[str]] = {}
    for el in root:
        key = el.get("key", "")
        if el.tag == "stringAttribute":
            s[key] = el.get("value", "")
        elif el.tag == "intAttribute":
            i[key] = int(el.get("value", "0"))
        elif el.tag == "booleanAttribute":
            b[key] = el.get("value") == "true"
        elif el.tag == "listAttribute":
            lists[key] = [e.get("value", "") for e in el]

    def flagged(entries: List[str]) -> List[Tuple[str, bool]]:
        # leading "1" = enabled, "0" = defined-but-disabled (launch:18-23)
        return [(e[1:], e[:1] == "1") for e in entries if e]

    constants: Dict[str, str] = {}
    for entry in lists.get("modelParameterConstants", []):
        # format: name;;value;kind;flag (launch:28-30)
        parts = entry.split(";")
        if len(parts) >= 3:
            constants[parts[0]] = parts[2]

    return LaunchConfig(
        spec_name=s.get("specName", ""),
        model_name=s.get("configurationName", ""),
        behavior_spec=s.get("modelBehaviorSpec", ""),
        workers=i.get("numberOfWorkers", 1),
        fp_index=i.get("fpIndex", 0),
        check_deadlock=b.get("modelCorrectnessCheckDeadlock", False),
        invariants=flagged(lists.get("modelCorrectnessInvariants", [])),
        properties=flagged(lists.get("modelCorrectnessProperties", [])),
        constants=constants,
        distributed_tlc=s.get("distributedTLC", "off"),
        distributed_fpset_count=i.get("distributedFPSetCount", 0),
        distributed_nodes_count=i.get("distributedNodesCount", 1),
    )
