"""Pods (port of jaxtlc/dist/pod.py): the sharded engine split
across the processes of a torch.distributed group.

One process per host joins the group (`init_pod`), the pod's D shards are
laid out process-major (`pod_mesh`: process p holds the rows [p*S,
(p+1)*S), S = D / H, so the owner of a state stays hi & (D - 1)), and
`run_pod` drives the sharded engine body over that mesh - the candidate
and verdict exchanges are all_to_all calls and the fences one all_gather a
body (engine/sharded.py, "Pods").  Around that body this module keeps the
reference's distribution protocol:

* **Collectives** (`make_stop_vote`, `make_stats_gather`): the SIGTERM vote
  is one all_reduce MAX of one int32 word; the statistics are one
  all_gather of each shard's statistic leaves, packed into one int64 row a
  shard by kernel K38.  With one process both return the local value and
  run no collective.  The backend is explicit: NCCL where every process
  has its own card, gloo where processes share one card (NCCL refuses two
  ranks on one GPU) and on the CPU; under gloo the exchange buffers go
  through pinned host memory.  The chosen backend is journaled in the
  `pod` join event; a backend that cannot start fails the run.
* **Per-host journals and checkpoints**: ``{base}.h{pid}.journal.jsonl``
  and ``{base}.h{pid}`` - each process snapshots only its own rows, the
  reference's file (its meta's ``host_rows``, ``pod_fields`` and
  ``num_hosts``), so either package resumes the other's; a resume at
  another width is refused with the ``--reshard`` hint.
* **Preemption consensus**: SIGTERM on any process is voted on at the next
  segment fence; every process checkpoints there and exits 75.
* **Reshard-on-recover** (`reshard_carry`): a saved pod re-partitioned to
  D' shards on the host, exactly.
* **The spill lifeboat** (``spill="on"``): ShardedSpillRuntime on the pod
  mesh, one SpillStore a process.
* **Observability**: each fence journals this process's ring rows
  (``level``), coverage deltas and a ``segment`` row, each with a ``host``
  field, which obs.views folds back into pod-global counters.
"""

from __future__ import annotations

import json
import os
import re
import signal
import time
import zlib
from types import SimpleNamespace
from typing import NamedTuple, Optional

import numpy as np

from .. import __version__
from ..config import ModelConfig

EXIT_OK = 0
EXIT_VIOLATION = 12  # TLC ExitStatus safety-violation (cli contract)
EXIT_PREEMPTED = 75  # EX_TEMPFAIL: shard checkpointed, relaunch to resume

DEFAULT_COORDINATOR = "127.0.0.1:12731"

# levels with no new site before the once-per-run saturation event
# fires (the supervisor's coverage_sat_levels default)
COVERAGE_SAT_LEVELS = 8

# engine keys a pod resume must always match ("spill" shapes the carry
# leaves)
_ENGINE_KEYS = ("format", "config", "pipeline", "obs_slots", "sort_free",
                "deferred", "symmetry", "por", "spill")
# geometry keys only a --reshard resume may change
_GEOM_KEYS = ("queue_capacity", "fp_capacity", "devices", "num_hosts")

_STAT_FIELDS = ("generated", "distinct", "depth", "qhead", "qtail",
                "level", "cont", "viol", "viol_state", "viol_local",
                "act_gen", "act_dist", "outdeg_hist", "spill_hits",
                "cov_counts")

COLLECTIVES = ("gloo", "nccl")


# ---------------------------------------------------------------------------
# pod bring-up
# ---------------------------------------------------------------------------


def resolve_collectives(collectives: str, device, num_processes: int) -> str:
    """The backend a pod of `num_processes` runs: an explicit "gloo" or
    "nccl" as given; "auto" is NCCL when the engine runs on the card and
    every process has a card of its own, else gloo."""
    import torch

    if collectives in COLLECTIVES:
        return collectives
    if collectives != "auto":
        raise ValueError(f"collectives must be auto, gloo or nccl, got "
                         f"{collectives!r}")
    on_card = str(device or "cuda").startswith("cuda")
    if (on_card and torch.cuda.is_available()
            and torch.cuda.device_count() >= num_processes):
        return "nccl"
    return "gloo"


def process_device(device, process_id: int):
    """The engine's device in process `process_id`: the CPU when asked,
    else card process_id % cards (one card shared when there is one)."""
    import torch

    if device is not None and str(device) == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass --device cpu to run the pod "
            "on the CPU")
    if device is not None and ":" in str(device):
        return torch.device(device)
    return torch.device("cuda", process_id % torch.cuda.device_count())


def init_pod(coordinator_address: str = DEFAULT_COORDINATOR,
             num_processes: int = 1, process_id: int = 0,
             collectives: str = "gloo", device=None) -> Optional[str]:
    """Join the pod: torch.distributed over tcp://coordinator_address with
    the given backend ("gloo" or "nccl"; resolve "auto" first).  One
    process joins nothing and returns None; else the backend.  A backend
    that cannot start raises."""
    import datetime

    import torch
    import torch.distributed as dist

    if num_processes <= 1:
        return None
    if collectives not in COLLECTIVES:
        raise ValueError(f"init_pod needs gloo or nccl, got "
                         f"{collectives!r}")
    if collectives == "nccl":
        dev = process_device(device, process_id)
        if dev.type != "cuda":
            raise ValueError("nccl collectives need the engine on the card")
        torch.cuda.set_device(dev)
    dist.init_process_group(
        collectives, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=600))
    return collectives


def pod_mesh(devices: int = None, device=None, devices_per_host: int = 1):
    """The pod's ShardMesh: D = devices_per_host x processes shards, laid
    out process-major over the joined group, on this process's device.
    Without a group of several processes, one process holds `devices`
    shards (the single-process width knob; default devices_per_host)."""
    import torch.distributed as dist

    from ..engine.sharded import ShardMesh

    hosts = (dist.get_world_size()
             if dist.is_available() and dist.is_initialized() else 1)
    if hosts == 1:
        D = devices or devices_per_host
        mesh = ShardMesh(D, device, timing={})
    else:
        if devices is not None:
            raise ValueError("`devices` is a single-process knob; a pod "
                             "has devices_per_host shards a process")
        rank = dist.get_rank()
        D = devices_per_host * hosts
        mesh = ShardMesh(D, process_device(device, rank), rank=rank,
                         hosts=hosts, collectives=dist.get_backend(),
                         timing={})
    if D < 1 or D & (D - 1):
        raise ValueError(
            f"pod shard count must be a power of two (got {D}: adjust "
            "--devices-per-host or the process count)")
    return mesh


def host_checkpoint_path(base: str, host: int) -> str:
    return f"{base}.h{host}"


def host_journal_path(base: str, host: int) -> str:
    return f"{base}.h{host}.journal.jsonl"


class _SigtermFlag:
    """SIGTERM -> cooperative stop flag, checked at segment fences (the
    segment in flight always completes)."""

    def __init__(self):
        self.hit = False
        self._prev = None

    def _handler(self, signum, frame):
        self.hit = True

    def install(self):
        try:
            self._prev = signal.signal(signal.SIGTERM, self._handler)
        except ValueError:  # not the main thread (serve workers)
            self._prev = None

    def uninstall(self):
        if self._prev is not None:
            try:
                signal.signal(signal.SIGTERM, self._prev)
            except ValueError:
                pass


# ---------------------------------------------------------------------------
# the collectives
# ---------------------------------------------------------------------------


def make_stop_vote(mesh):
    """Pod-wide preemption consensus: the max of every process's stop flag
    (one all_reduce MAX of one int32 word), so one SIGTERM stops every
    process at the same segment fence."""

    def vote(local_hit: bool) -> bool:
        return mesh.any(bool(local_hit))

    return vote


def make_stats_gather(mesh, carry):
    """Host access to the full [D, ...] statistic leaves on every process:
    this process's rows of the `_STAT_FIELDS` leaves the carry has, packed
    into one int64 row a shard (kernel K38), one all_gather, and the rows
    split back into the leaves' dtypes and shapes (CPU tensors).  The
    namespace feeds result_from_shard_carry as a carry does."""
    from ..engine.sharded import pod_stats

    fields = [f for f in _STAT_FIELDS if getattr(carry, f, None) is not None]

    def gather(c) -> SimpleNamespace:
        leaves = [getattr(c, f) for f in fields]
        if mesh.hosts == 1:
            return SimpleNamespace(**{f: t.cpu() for f, t in
                                      zip(fields, leaves)})
        words = mesh.gather(pod_stats(leaves))
        vals, col = {}, 0
        for f, t in zip(fields, leaves):
            w = int(np.prod(t.shape[1:], dtype=np.int64))
            part = words[:, col:col + w].to(t.dtype)
            vals[f] = part.reshape((mesh.n_shards,) + tuple(t.shape[1:]))
            col += w
        return SimpleNamespace(**vals)

    return gather


# ---------------------------------------------------------------------------
# per-host shard checkpoints
# ---------------------------------------------------------------------------


def save_pod_checkpoint(base: str, carry, meta: dict, host: int,
                        host_rows) -> str:
    """Snapshot this process's rows (the carry's, global indices
    `host_rows`) to ``{base}.h{host}``, the reference's format
    (checkpoint.save_checkpoint of the leaves in sorted-name order; meta
    records num_hosts, host_rows and pod_fields)."""
    from ..engine.checkpoint import save_checkpoint
    from ..engine.interop import shard_carry_to_numpy

    payload = shard_carry_to_numpy(carry)
    m = dict(meta, host=host, host_rows=[int(i) for i in host_rows],
             pod_fields=sorted(payload))
    path = host_checkpoint_path(base, host)
    save_checkpoint(path, payload, m)
    return path


def _load_host_payload(path: str):
    """One shard file -> (meta, {field: [rows, ...] np}), CRC-verified."""
    from ..engine.checkpoint import CheckpointCorruptError

    try:
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(str(z["__meta__"]))
            leaves = [z[f"leaf_{i}"] for i in range(
                sum(k.startswith("leaf_") for k in z.files))]
    except Exception as e:  # the file-parsing boundary
        raise CheckpointCorruptError(f"unreadable pod shard {path!r}: {e}")
    manifest = meta.get("manifest") or {}
    for i, a in enumerate(leaves):
        want = manifest.get(f"leaf_{i}")
        got = zlib.crc32(np.ascontiguousarray(a).tobytes())
        if want is None or got != want:
            raise CheckpointCorruptError(
                f"pod shard {path!r} leaf_{i} CRC mismatch "
                f"({got} != {want}) - torn write or bit rot")
    fields = meta.get("pod_fields")
    if fields is None or len(fields) != len(leaves):
        raise ValueError(
            f"{path!r} is not a pod shard checkpoint (no pod_fields "
            "manifest) - whole-carry snapshots resume through "
            "check_sharded_with_checkpoints instead")
    return meta, dict(zip(fields, leaves))


def _host_paths(base: str):
    """Every ``{base}.h<digits>`` shard file, host-ordered (journal
    siblings excluded by the anchored pattern)."""
    pat = re.compile(re.escape(os.path.basename(base)) + r"\.h(\d+)$")
    d = os.path.dirname(os.path.abspath(base)) or "."
    out = {}
    for name in os.listdir(d):
        m = pat.fullmatch(name)
        if m:
            out[int(m.group(1))] = os.path.join(d, name)
    return [out[k] for k in sorted(out)]


def load_pod_full(base: str):
    """Reassemble the full [D_old] host-side carry from every per-host
    shard file (a shared filesystem).  Returns (meta of host 0, a
    namespace of numpy leaves in the reference's dtypes, None where the
    snapshot has no such leaf)."""
    from ..engine.interop import SHARD_DTYPES

    paths = _host_paths(base)
    if not paths:
        raise FileNotFoundError(f"no pod checkpoint shards at {base!r}.h*")
    rows: dict = {}
    m0 = None
    for p in paths:
        m, payload = _load_host_payload(p)
        if m0 is None:
            m0 = m
        for f, arr in payload.items():
            for k, rid in enumerate(m["host_rows"]):
                rows.setdefault(f, {})[int(rid)] = arr[k]
    d_old = int(m0["devices"])
    short = sorted(f for f, r in rows.items() if len(r) != d_old)
    if short:
        raise ValueError(
            f"pod checkpoint {base!r} is missing shard rows for {short} "
            f"- a {m0.get('num_hosts')}-host snapshot needs every host's "
            ".h* file on this filesystem")
    full = {f: np.stack([r[i] for i in range(d_old)])
            for f, r in rows.items()}
    return m0, SimpleNamespace(**{f: full.get(f) for f in SHARD_DTYPES})


def _validate_pod_meta(saved: dict, want: dict, reshard: bool) -> None:
    """Meta gate before any leaf is touched.  A plain resume pins engine
    and geometry keys (a snapshot only reloads at its own pod width);
    --reshard relaxes exactly the geometry keys reshard_carry re-derives."""
    defaults = {"pipeline": False, "sort_free": False, "deferred": False,
                "symmetry": False, "por": False, "spill": False,
                "obs_slots": 0, "num_hosts": 1}
    for key in _ENGINE_KEYS + (() if reshard else _GEOM_KEYS):
        s = saved.get(key, defaults.get(key))
        if s != want[key]:
            hint = (
                "; a pod snapshot resumes only at the width that cut it "
                "- relaunch with --reshard to re-partition the "
                "fingerprint space" if key in ("devices", "num_hosts")
                else "")
            raise ValueError(
                f"checkpoint {key} mismatch: {s!r} != {want[key]!r}{hint}")


# ---------------------------------------------------------------------------
# reshard-on-recover
# ---------------------------------------------------------------------------


def reshard_carry(carry, backend, d_new: int, queue_capacity: int = None,
                  fp_capacity: int = None, fp_index: int = None):
    """Re-partition a full host-side carry (numpy leaves in the reference's
    dtypes, as load_pod_full gives) from D_old to `d_new` shards under the
    new owner mapping hi & (d_new - 1); the reference's algorithm
    (jaxtlc/dist/pod.py:389).

    Tables: stored words are unmixed back to raw fingerprints and
    re-inserted into the new owner's table, so the new words are what a
    fresh run of the new width would hold; each shard's `distinct` becomes
    its new occupancy (their sum is preserved - verified).  Queues: the
    live window [qhead, qtail) is split at the level boundary, each state
    re-fingerprinted and routed to its new owner, current-level states
    before next-level ones, heads renumbered to 0.  Replicated leaves copy
    through; partial counters sum into row 0.  Returns a namespace of the
    new [d_new, ...] leaves."""
    import torch

    from ..engine.fingerprint import DEFAULT_FP_INDEX, fp64_words
    from ..engine.fpset import host_insert, unmix_host
    from ..engine.interop import SHARD_DTYPES

    fp_index = DEFAULT_FP_INDEX if fp_index is None else fp_index
    if d_new < 1 or d_new & (d_new - 1):
        raise ValueError(f"pod width must be a power of two, got {d_new}")
    for f in ("pv_n", "spill_hits"):
        if getattr(carry, f, None) is not None:
            raise ValueError(
                f"reshard does not support carries with {f} (pipelined/"
                "spill pod snapshots resume at their own width)")
    table = np.asarray(carry.table)
    queue = np.asarray(carry.queue)
    d_old = table.shape[0]
    F = queue.shape[-1]
    qcap = int(queue_capacity or (queue.shape[1] - 1))
    fpcap = int(fp_capacity or table.shape[1] * 8)

    # fingerprint tables: unmix -> re-insert by the new owner bits
    table2 = np.zeros((d_new, fpcap // 8, 16), np.uint32)
    distinct2 = np.zeros(d_new, np.uint32)
    for d in range(d_old):
        t = table[d].view(np.uint32)
        lo = t[:, 0::2].reshape(-1)
        hi = t[:, 1::2].reshape(-1)
        occ = (lo != 0) | (hi != 0)
        raw_lo, raw_hi = unmix_host(lo[occ], hi[occ])
        for rl, rh in zip(raw_lo.tolist(), raw_hi.tolist()):
            nd = int(rh) & (d_new - 1)
            if host_insert(table2[nd], int(rl), int(rh)):
                distinct2[nd] += 1
    total = int(np.asarray(carry.distinct, np.int64).sum())
    if int(distinct2.sum()) != total:
        raise ValueError(
            f"reshard integrity: re-inserted {int(distinct2.sum())} "
            f"fingerprints but the snapshot holds {total} distinct - "
            "corrupt shard or fp_capacity too small for the new width")

    # frontier queues: split the live window at the level boundary, route
    # each state to its new fingerprint owner, head renumbers to 0
    qhead = np.asarray(carry.qhead)
    qtail = np.asarray(carry.qtail)
    lend = np.asarray(carry.level_end)
    cur_rows, nxt_rows = [], []
    for d in range(d_old):
        qh, qt, le = int(qhead[d]), int(qtail[d]), int(lend[d])
        live = queue[d, qh:qt]
        ncur = max(0, min(le, qt) - qh)
        cur_rows.append(live[:ncur])
        nxt_rows.append(live[ncur:])

    def owners(states):
        if len(states) == 0:
            return np.zeros(0, np.int64)
        packed = backend.cdc.pack(torch.from_numpy(states))
        _lo, hi = fp64_words(packed.cpu(), backend.cdc.nbits, fp_index)
        return hi.numpy().astype(np.int64) & (d_new - 1)

    queue2 = np.zeros((d_new, qcap + 1, F), np.int32)
    qtail2 = np.zeros(d_new, np.int32)
    lend2 = np.zeros(d_new, np.int32)
    for phase, chunks in (("cur", cur_rows), ("nxt", nxt_rows)):
        states = (np.concatenate(chunks) if chunks
                  else np.zeros((0, F), np.int32))
        own = owners(states)
        for d in range(d_new):
            sel = states[own == d]
            n = len(sel)
            if int(qtail2[d]) + n > qcap:
                raise ValueError(
                    f"resharded frontier does not fit: new device {d} "
                    f"needs {int(qtail2[d]) + n} queue rows > "
                    f"queue_capacity {qcap} - rerun with a larger "
                    "--queue-capacity (reshard re-derives geometry)")
            queue2[d, qtail2[d]:qtail2[d] + n] = sel
            qtail2[d] += n
        if phase == "cur":
            lend2 = qtail2.copy()

    def row0(x):
        x = np.asarray(x)
        out = np.zeros((d_new,) + x.shape[1:], x.dtype)
        out[0] = x.sum(axis=0)
        return out

    def repl(x):
        x = np.asarray(x)
        return np.full((d_new,) + x.shape[1:], x[0], x.dtype)

    vs2 = np.zeros((d_new, F), np.int32)
    vl2 = np.zeros(d_new, bool)
    vl = np.asarray(carry.viol_local)
    if vl.any():
        vs2[0] = np.asarray(carry.viol_state)[int(np.argmax(vl))]
        vl2[0] = True

    out = dict(
        table=table2, queue=queue2, qhead=np.zeros(d_new, np.int32),
        qtail=qtail2, level_end=lend2, level=repl(carry.level),
        depth=repl(carry.depth), generated=row0(carry.generated),
        distinct=distinct2, act_gen=row0(carry.act_gen),
        act_dist=row0(carry.act_dist), outdeg_hist=row0(carry.outdeg_hist),
        viol=repl(carry.viol), viol_state=vs2, viol_local=vl2,
        cont=repl(carry.cont))
    if getattr(carry, "cov_counts", None) is not None:
        out["cov_counts"] = row0(carry.cov_counts)
    if getattr(carry, "obs_ring", None) is not None:
        # the ring's per-level rows are attributions of past partials; the
        # new width starts a fresh ring.  Only the sticky flags survive:
        # the old pod's flag maxima go into every new dump row, and the
        # heads replicate the old minimum (the resumed decode cursor sees
        # no phantom rows)
        from ..obs.counters import COL_CERT, COL_OVERFLOW, COL_SYM

        ring = np.asarray(carry.obs_ring)
        ring2 = np.zeros((d_new,) + ring.shape[1:], ring.dtype)
        for col in (COL_OVERFLOW, COL_CERT, COL_SYM):
            ring2[:, -1, col] = ring[:, :, col].max()
        heads = np.asarray(carry.obs_head)
        out["obs_ring"] = ring2
        out["obs_head"] = np.full(d_new, heads.min(), heads.dtype)
        out["obs_bodies"] = row0(carry.obs_bodies)
        out["obs_expanded"] = row0(carry.obs_expanded)
    return SimpleNamespace(**{f: out.get(f) for f in SHARD_DTYPES})


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------


class PodResult(NamedTuple):
    result: object  # engine.bfs.CheckResult
    exit_code: int
    host: int
    hosts: int
    segments: int
    resumed: bool
    resharded: bool
    checkpoint: Optional[str]
    spilled: int = 0
    spill_flushes: int = 0
    collectives: Optional[str] = None  # the group's backend (None: 1 host)
    timing: Optional[dict] = None  # the mesh's collective seconds


def _local_carry(mesh, full, template):
    """This process's rows of a full numpy carry namespace, as the port's
    carry on the template's device (template leaves the namespace lacks
    stay)."""
    from ..engine.interop import shard_carry_from_numpy

    rows = {f: mesh.local(v) for f, v in vars(full).items()
            if v is not None}
    loaded = shard_carry_from_numpy(rows, device=template.queue.device)
    return _adopt(template, loaded, rows)


def _adopt(template, loaded, names):
    """template with the leaves `names` taken from `loaded`; each must
    exist in the template with the same shape."""
    repl = {}
    for f in names:
        leaf = getattr(template, f, None)
        new = getattr(loaded, f)
        if leaf is None:
            raise ValueError(
                f"checkpoint leaf {f!r} has no home in this engine's carry "
                "- meta validation should have caught this (corrupt "
                "shard?)")
        if tuple(new.shape) != tuple(leaf.shape):
            raise ValueError(
                f"checkpoint leaf {f!r} shape {tuple(new.shape)} != engine "
                f"{tuple(leaf.shape)}")
        repl[f] = new
    return template._replace(bundle=None, **repl)


def run_pod(
    cfg: ModelConfig = None,
    backend=None,
    *,
    chunk: int = 512,
    queue_capacity: int = 1 << 14,
    fp_capacity: int = 1 << 18,
    fp_index: int = None,
    route_factor: float = 2.0,
    sort_free: bool = None,
    deferred: bool = None,
    obs_slots: int = 0,
    coverage: bool = False,
    ckpt_path: str = None,
    ckpt_every: int = 64,
    resume: bool = False,
    reshard: bool = False,
    spill: str = "off",
    spill_capacity: int = 1 << 22,
    fp_highwater: float = None,
    max_segments: int = None,
    meta_config: dict = None,
    workload: str = "kubeapi",
    journal: bool = True,
    progress_every: int = 1,
    on_event=None,
    devices: int = None,
    devices_per_host: int = 1,
    device=None,
) -> PodResult:
    """Drive one pod member to completion (or preemption) and return this
    process's PodResult.  Runs after init_pod; every process of the pod
    calls it with identical parameters (the collectives are
    pod-synchronous).  Without a group, one process runs `devices` shards.

    chunk, queue_capacity and fp_capacity are per shard, the sharded
    engine's contract.  obs_slots > 0 turns the counter ring on (per-host
    partial `level` events with a `host` field); coverage=True attaches
    the workload's coverage plane (per-host `coverage` delta events).
    `device` is the engine's (None: the card; "cpu" for the plain path)."""
    from ..engine.bfs import resolve_deferred, resolve_sort_free
    from ..engine.checkpoint import _meta, read_checkpoint_meta
    from ..engine.fingerprint import DEFAULT_FP_INDEX
    from ..engine.reduce import reduce_flags
    from ..engine.sharded import (
        ShardedSpillRuntime, _sync, cov_totals_local, kubeapi_backend,
        make_sharded_engine, obs_rows_sharded_local, result_from_shard_carry,
    )
    from ..obs.coverage import coverage_delta_event
    from ..obs.phases import segment_phases

    fp_index = DEFAULT_FP_INDEX if fp_index is None else fp_index
    mesh = pod_mesh(devices, device, devices_per_host)
    host, hosts = mesh.rank, mesh.hosts
    D = mesh.n_shards
    rows = range(mesh.row0, mesh.row0 + mesh.rows)
    if cfg is None and backend is None:
        cfg = ModelConfig()
    if backend is None:
        backend = kubeapi_backend(cfg, coverage=coverage)
    if cfg is None and meta_config is None:
        meta_config = {"backend": "custom"}
    sort_free = resolve_sort_free(sort_free, chunk)
    deferred = resolve_deferred(deferred, chunk)
    spill_on = spill == "on"
    if spill_on and reshard:
        raise ValueError(
            "spill + reshard is unsupported: per-host SpillStores are "
            "keyed to the width that cut them - resume at the original "
            "width")
    symmetry, por = reduce_flags(backend)
    meta = _meta(
        cfg if cfg is not None else ModelConfig(),
        meta_config=meta_config, queue_capacity=queue_capacity,
        fp_capacity=fp_capacity, devices=D, pipeline=False,
        obs_slots=obs_slots, sort_free=sort_free, deferred=deferred,
        symmetry=symmetry, por=por, spill=spill_on, num_hosts=hosts)

    jr = None
    if journal and ckpt_path is not None:
        from ..obs.journal import RunJournal

        jr = RunJournal(host_journal_path(ckpt_path, host), resume=resume)

    def emit(kind, **fields):
        if jr is not None:
            jr.event(kind, **fields)
        if on_event is not None:
            on_event(kind, dict(fields))

    # resume validation first: a wrong-width or wrong-mode snapshot
    # refuses before the engine is built
    resume_meta = resume_full = None
    my_path = None
    if resume:
        if ckpt_path is None:
            raise ValueError("resume requires a checkpoint base path")
        my_path = host_checkpoint_path(ckpt_path, host)
        if reshard:
            resume_full = load_pod_full(ckpt_path)
            _validate_pod_meta(resume_full[0], meta, reshard=True)
            if resume_full[0].get("spill"):
                raise ValueError(
                    "reshard of a spill-mode pod checkpoint is "
                    "unsupported - resume at the original width")
        else:
            resume_meta = read_checkpoint_meta(my_path)
            _validate_pod_meta(resume_meta, meta, reshard=False)

    # the engine: the segment loop, or the spill runtime's expand / probe
    # / commit steps when the per-host lifeboat is on
    store = None
    rt = None
    if spill_on:
        from ..engine.spill import SpillStore

        store = SpillStore(spill_capacity)
        rt = ShardedSpillRuntime(
            cfg, mesh, chunk, queue_capacity, fp_capacity,
            fp_index=fp_index, route_factor=route_factor, backend=backend,
            fp_highwater=fp_highwater, obs_slots=obs_slots,
            sort_free=sort_free, deferred=deferred, store=store,
            on_event=lambda kind, info: emit(kind, host=host, **info))
        template = rt.init_fn()
        seg = rt.segment_fn(ckpt_every)
    else:
        init_fn, seg = make_sharded_engine(
            cfg, mesh, chunk, queue_capacity, fp_capacity,
            fp_index=fp_index, route_factor=route_factor,
            segment=ckpt_every, backend=backend, fp_highwater=fp_highwater,
            sort_free=sort_free, deferred=deferred, obs_slots=obs_slots)
        template = init_fn()

    resumed = resharded = False
    carry = template
    if resume:
        if reshard:
            m0, carry_old = resume_full
            carry = _local_carry(mesh, reshard_carry(
                carry_old, backend, D, queue_capacity=queue_capacity,
                fp_capacity=fp_capacity, fp_index=fp_index), template)
            resharded = True
            emit("pod", phase="reshard", host=host, hosts=hosts,
                 old_hosts=int(m0.get("num_hosts", 1)), new_hosts=hosts,
                 old_devices=int(m0["devices"]), new_devices=D)
        else:
            from ..engine.interop import shard_carry_from_numpy

            m, payload = _load_host_payload(my_path)
            ids = [int(i) for i in m["host_rows"]]
            if ids != list(rows):
                raise ValueError(
                    f"checkpoint host_rows mismatch: host {host} owns "
                    f"rows {list(rows)} but the shard file holds {ids} - "
                    "launch hosts in their original order or --reshard")
            carry = _adopt(template, shard_carry_from_numpy(
                payload, device=template.queue.device), payload)
            if spill_on:
                from ..engine.spill import SpillStore, spill_sibling

                sib = spill_sibling(my_path)
                if os.path.exists(sib):
                    rt.store = store = SpillStore.load(sib)
        resumed = True
        emit("run_resume", version=__version__, path=my_path)
    else:
        emit("run_start", version=__version__, workload=workload,
             engine="pod",
             device="cpu" if template.queue.device.type == "cpu" else "gpu",
             params=dict(chunk=chunk, queue_capacity=queue_capacity,
                         fp_capacity=fp_capacity, devices=D, hosts=hosts,
                         route_factor=route_factor, sort_free=sort_free,
                         deferred=deferred, spill=spill_on,
                         obs_slots=obs_slots,
                         coverage=backend.coverage is not None))
    emit("pod", phase="join", host=host, hosts=hosts,
         collectives=mesh.collectives)

    gather = make_stats_gather(mesh, carry)
    vote = make_stop_vote(mesh)

    # per-host obs cursors: each fence decodes only this process's new
    # ring rows / coverage movement (obs.views folds the sibling journals
    # back to pod-global totals).  fp_load is the host partial over the
    # global capacity so the fold can sum loads.  On resume the cursors
    # seed from the restored carry: journal and checkpoint are written at
    # the same fence.
    cov_plane = backend.coverage
    fp_total = fp_capacity * D
    obs_since = 0
    cov_seen = None
    cov_visited = cov_level = cov_last_new_level = 0
    cov_saturated = False
    if resumed:
        if obs_slots:
            _, obs_since = obs_rows_sharded_local(carry, since=1 << 30)
        if cov_plane is not None:
            cov_seen = cov_totals_local(carry)
            if cov_seen is not None:
                cov_visited = int((cov_seen > 0).sum())
        cov_level = cov_last_new_level = int(carry.level[0])

    def save_all(c, label="segment"):
        ts = time.time()
        path = save_pod_checkpoint(ckpt_path, c, meta, host, rows)
        if store is not None:
            from ..engine.spill import spill_sibling

            store.save(spill_sibling(path))
        emit("checkpoint", path=path, seconds=time.time() - ts, label=label,
             host=host)
        return path

    def timing(key):
        return mesh.timing.get(key, 0.0)

    flag = _SigtermFlag()
    flag.install()
    t0 = time.time()
    segments = 0
    preempted = False
    last_ckpt = None
    try:
        while bool(carry.cont[0]):  # replicated: every process agrees
            if max_segments is not None and segments >= max_segments:
                break
            t_dispatch = time.time()
            ex0, ga0 = timing("exchange_s"), timing("gather_s")
            carry = seg(carry)
            _sync(carry)
            t_fence = time.time()
            segments += 1
            tx = time.time()
            stop_now = vote(flag.hit)
            exchange_us = (time.time() - tx) * 1e6
            # obs at every fence (checkpoint cadence, not progress
            # cadence): resume replays from the fence the journal last
            # recorded, so the cursors give exactly-once rows
            emit("segment", index=segments - 1, host=host,
                 t_dispatch=t_dispatch, t_fence=t_fence,
                 wall_s=round(t_fence - t_dispatch, 6),
                 exchange_us=(timing("exchange_s") - ex0) * 1e6,
                 gather_us=(timing("gather_s") - ga0) * 1e6)
            for row in segment_phases(segments - 1, t_fence - t_dispatch):
                emit("phase", host=host, **row)
            if obs_slots:
                obs, obs_since = obs_rows_sharded_local(
                    carry, labels=backend.labels, since=obs_since,
                    fp_capacity_total=fp_total)
                for row in obs:
                    emit("level", host=host, **row)
                if obs:
                    cov_level = max(cov_level, obs[-1]["level"])
            if cov_plane is not None:
                totals = cov_totals_local(carry)
                payload = coverage_delta_event(cov_plane.sites, totals,
                                               cov_seen)
                if payload is not None:
                    emit("coverage", host=host, **payload)
                    cov_seen = totals
                    if payload["visited"] > cov_visited:
                        cov_visited = payload["visited"]
                        cov_last_new_level = cov_level
                if (not cov_saturated and cov_visited
                        and cov_level - cov_last_new_level
                        >= COVERAGE_SAT_LEVELS):
                    cov_saturated = True
                    emit("coverage", host=host, visited=cov_visited,
                         sites=len(cov_plane.sites), delta={},
                         saturated=True, level=cov_level)
            if progress_every and segments % progress_every == 0:
                st = gather(carry)
                emit("progress", depth=int(st.depth.max()),
                     generated=int((st.generated & 0xFFFFFFFF).sum()),
                     distinct=int((st.distinct & 0xFFFFFFFF).sum()),
                     queue=int((st.qtail - st.qhead).sum()))
                emit("pod", phase="stats", host=host, hosts=hosts,
                     shard_occupancy=(int(carry.distinct.max())
                                      / float(fp_capacity)),
                     spill_bytes=(store.count * 8
                                  if store is not None else 0),
                     exchange_us=exchange_us)
            if ckpt_path is not None:
                last_ckpt = save_all(carry)
            if stop_now:
                preempted = True
                break
    finally:
        flag.uninstall()
    wall = time.time() - t0

    st = gather(carry)
    result = result_from_shard_carry(
        st, wall, iterations=segments, labels=backend.labels,
        viol_names=backend.viol_names, fp_capacity_total=fp_capacity * D,
        sites=(cov_plane.sites if cov_plane is not None else None))
    done = not bool(st.cont.any())
    if preempted:
        emit("interrupted", signum=int(signal.SIGTERM), path=last_ckpt,
             generated=result.generated, distinct=result.distinct,
             queue=result.queue_left, wall_s=wall)
        emit("pod", phase="leave", host=host, hosts=hosts, path=last_ckpt)
        verdict, exit_code = "interrupted", EXIT_PREEMPTED
    elif result.violation:
        verdict, exit_code = "violation", EXIT_VIOLATION
    elif done:
        verdict, exit_code = "ok", EXIT_OK
    else:  # max_segments pause: journal closes valid, resume continues
        verdict, exit_code = "interrupted", EXIT_OK
    emit("final", verdict=verdict, generated=result.generated,
         distinct=result.distinct, depth=result.depth,
         queue=result.queue_left, wall_s=wall,
         interrupted=not (done or result.violation != 0))
    if jr is not None:
        jr.close()
    return PodResult(
        result=result, exit_code=exit_code, host=host, hosts=hosts,
        segments=segments, resumed=resumed, resharded=resharded,
        checkpoint=last_ckpt,
        spilled=(store.count if store is not None else 0),
        spill_flushes=(rt.flushes if rt is not None else 0),
        collectives=mesh.collectives, timing=dict(mesh.timing))
