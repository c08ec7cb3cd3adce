"""Shared label/enum tables for the KubeAPI action system.

A copy of jaxtlc/spec/labels.py.  The integer encodings are also hard-coded
in torchtlc/kernels/csrc/kubeapi.cuh (LBL_*, VERB_*, ST_*).

These enumerate the control-flow labels, verbs, and response codes of the
reference spec (KubeAPI.tla: labels at 471-756, Verbs at :415,
Responses at :421).  Both the host oracle interpreter and the tensorized TPU
kernel index into these tables, so their integer encodings agree by
construction.
"""

# Process identifiers are config-driven (ModelConfig.processes mirrors
# ProcSet, KubeAPI.tla:453): N reconciler clients + M binders + "Server".

# PlusCal labels == TLA actions (KubeAPI.tla:471-756).
# Order is the canonical integer encoding used by the codec.
LABELS = (
    # procedure API (KubeAPI.tla:471-497)
    "DoRequest",
    "DoReply",
    # procedure ListAPI (KubeAPI.tla:499-526)
    "DoListRequest",
    "DoListReply",
    # process Client (KubeAPI.tla:528-653)
    "CStart",
    "C1",
    "C10",
    "C11",
    "c12",
    "C13",
    "C2",
    "C3",
    "C8",
    "C6",
    "C7",
    "C4",
    "C5",
    # process PVCController (KubeAPI.tla:655-693)
    "PVCStart",
    "PVCListedPVCs",
    "PVCHavePVCs",
    "PVCDone",
    # process APIServer (KubeAPI.tla:698-756)
    "APIStart",
)
LABEL_ID = {name: i for i, name in enumerate(LABELS)}

# API verbs (KubeAPI.tla:415).  "Create" is never issued by Model_1's
# processes but is part of the verb enum and the server dispatch.
VERBS = ("Create", "Get", "Update", "Delete", "Force")
VERB_ID = {v: i for i, v in enumerate(VERBS)}

# Request status codes (KubeAPI.tla:421)
RESPONSES = ("Pending", "Ok", "Error")
RESPONSE_ID = {r: i for i, r in enumerate(RESPONSES)}

# TLC's defaultInitValue model value (KubeAPI.tla:374, Init :460-463).
DEFAULT_INIT = "__defaultInitValue__"

# Procedure ids for stack frames (frames at KubeAPI.tla:535-539 etc.)
PROC_API = "API"
PROC_LISTAPI = "ListAPI"
