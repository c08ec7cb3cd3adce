"""Content-addressed verdict + reachable-set artifact cache (port of
jaxtlc/struct/artifacts.py).

Re-running a check on a spec that has not changed, or whose only change is
an invariant, need not pay for the BFS again.  Two on-disk tiers under
``~/.cache/torchtlc/artifacts`` (``TORCHTLC_ARTIFACT_CACHE=DIR``
overrides, ``=off`` disables; CLI ``-artifact-cache`` /
``-no-artifact-cache`` / ``-recheck``):

* **Verdict tier** - keyed on the SEMANTIC digest of a check: module
  source digest, canonical constants, invariant selection, property
  selection, the deadlock flag, and :data:`ENGINE_SEMVER`.  The key
  deliberately EXCLUDES engine geometry (chunk / queue / fp capacity),
  pipeline, sort_free, obs and narrowing: verdict and counters are
  pinned geometry-invariant by the parity tests, so one artifact answers
  every geometry.  An unchanged spec returns its cached result without
  building an engine or a kernel.

* **Reachable-set tier** - keyed on the BEHAVIOR digest (Init + Next +
  the definitions they transitively reference + constants + deadlock
  flag) so an invariant-only edit KEEPS the key while the verdict key
  changes.  The artifact stores the packed reachable states plus the
  run's counters; a re-check then skips BFS entirely and evaluates just
  the request's invariants over every stored state in one launch of
  kernel K31 ``struct_recheck`` (``run_recheck``; its plain version on a
  CPU device).

Where the reachable states come from: the engines never materialize
them - but the 64-bit Rabin fingerprint is GF(2)-affine in the packed
state bits (engine.fingerprint.affine_basis) and, for codecs of
``nbits <= 64``, provably INJECTIVE (an irreducible degree-64
polynomial cannot divide a nonzero message of lower degree), so the
final fingerprint table IS the reachable set: unmix the stored table
words (engine.fpset.unmix_host), solve the affine system once by GF(2)
elimination, and recover every packed state exactly.  A round-trip
re-fingerprint verifies the recovery before anything is written; wider
codecs simply skip the reach tier (the verdict tier still applies).

The on-disk format is the reference's (the same keys, file layout, CRCs,
``FORMAT_VERSION`` and ``ENGINE_SEMVER``), so a store directory written
by one package answers the other's checks through ``-artifact-cache
DIR``.  Every artifact carries a CRC32 of its payload and is published
with fsync-before-rename, so a torn write is either invisible or
detected at load - corrupted or version-skewed artifacts are
loud-warning MISSES, never wrong answers.  Artifacts are written only on
clean final verdicts: error, violation, exhausted, interrupted and
certificate-tripped runs never cache.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

# Bump whenever engine semantics change in a way that can alter a
# verdict or the reachable set (violation codes, fingerprint algebra,
# invariant evaluation order...).  Part of every key: a bump invalidates
# the whole cache at once instead of serving stale answers.
ENGINE_SEMVER = 1

FORMAT_VERSION = 1

_DEFAULT_ROOT = os.path.join(
    os.path.expanduser("~"), ".cache", "torchtlc", "artifacts"
)
ENV = "TORCHTLC_ARTIFACT_CACHE"

VERDICT_DIR = "verdict"
REACH_DIR = "reach"

def _fsync_replace(tmp: str, path: str, f=None) -> None:
    """The durable-publish idiom (engine.checkpoint's), re-stated here so
    the store stays importable without torch: fsync the
    tmp file BEFORE the rename (rename alone only orders metadata),
    rename, then fsync the directory so the rename itself is durable."""
    if f is not None:
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    dirfd = os.open(os.path.dirname(os.path.abspath(path)) or ".",
                    os.O_RDONLY)
    try:
        os.fsync(dirfd)
    finally:
        os.close(dirfd)


# ---------------------------------------------------------------------------
# Keys
# ---------------------------------------------------------------------------


def _canonical_constants(model) -> dict:
    """struct.backend.canonical_constants without the torch import chain
    (the key functions work without a device)."""
    out = {}
    for k in sorted(model.constants):
        v = model.constants[k]
        out[k] = (sorted(map(repr, v)) if isinstance(v, frozenset)
                  else repr(v))
    return out


def verdict_key(model, check_deadlock: bool = True,
                properties: Tuple[str, ...] = ()) -> str:
    """The semantic digest of one check: spec text digest (constant
    overrides included - the loader folds them in), canonical
    constants, invariant + property selection, deadlock flag, engine
    semver.  Geometry/pipeline/sort-free/obs/narrowing are deliberately
    absent: verdict and counters are geometry-invariant (pinned by the
    engine parity tests), so one artifact answers every geometry."""
    blob = json.dumps([
        ENGINE_SEMVER,
        model.source_digest,
        _canonical_constants(model),
        sorted(model.invariants),
        bool(check_deadlock),
        sorted(properties or ()),
    ], sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()


def behavior_digest(model) -> str:
    """Digest of what shapes the REACHABLE SET: variables, constants,
    Init and Next ASTs, and every definition transitively referenced
    from them (by name, over-approximated: any AST string that names a
    module definition counts - over-inclusion can only make the key
    more conservative, never wrong).  Invariant/property definitions
    that the behavior does not reference drop out, which is exactly
    what lets an invariant-only edit keep its reachable-set artifact."""
    defs = model.module.defs
    seen: set = set()
    queue: List[str] = []

    def scan(ast):
        if isinstance(ast, (tuple, list)):
            for x in ast:
                scan(x)
        elif isinstance(ast, str) and ast in defs and ast not in seen:
            seen.add(ast)
            queue.append(ast)

    sys_ = model.system
    scan(sys_.init_ast)
    scan(sys_.next_ast)
    while queue:
        d = defs[queue.pop()]
        scan(d.body)
    parts = [
        repr(tuple(sys_.variables)),
        json.dumps(_canonical_constants(model), sort_keys=True),
        repr(sys_.init_ast),
        repr(sys_.next_ast),
    ]
    for n in sorted(seen):
        d = defs[n]
        parts.append(f"{n}{tuple(d.params)!r}={d.body!r}")
    h = hashlib.sha256()
    for p in parts:
        h.update(p.encode())
        h.update(b"\x00")
    return h.hexdigest()


def reach_key(model, check_deadlock: bool = True) -> str:
    """The verdict key MINUS the invariant/property selection: keyed on
    the behavior digest so an invariant-only edit still hits."""
    blob = json.dumps([
        ENGINE_SEMVER,
        behavior_digest(model),
        bool(check_deadlock),
    ], sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()


def codec_digest(cdc, bounds=None) -> str:
    """Layout digest of a StructCodec (+ the narrowing bound digest):
    the reach artifact records the layout its packed words were encoded
    under, and a recheck whose model infers a DIFFERENT layout (e.g. a
    TypeOK hint edit reshaped a field) is a miss, never a misdecode."""
    blob = json.dumps([
        list(cdc.variables),
        list(int(w) for w in cdc.widths),
        int(cdc.nbits),
        bounds.digest() if bounds is not None else "",
    ])
    return hashlib.sha256(blob.encode()).hexdigest()


# ---------------------------------------------------------------------------
# Fingerprint inversion (table words -> packed states)
# ---------------------------------------------------------------------------

_SOLVE_MEMO: Dict[tuple, Optional[tuple]] = {}


def _solve_basis(nbits: int, fp_index: int, seed: int):
    """Left-inverse of the affine fingerprint map for nbits <= 64.

    fp = const ^ XOR_{i: bit i set} basis[i]; the Rabin algebra makes
    the map injective below the polynomial degree, so GF(2) Gauss-
    Jordan elimination of the 64 x nbits system yields, per message
    bit i, a 64-bit mask M[i] with  bit_i = parity(M[i] & (fp ^ const)).
    Returns (const64, masks [nbits] uint64) - or None if elimination
    finds a rank deficiency (cannot happen for a correct basis; kept
    as a defensive skip, not an assert)."""
    key = (nbits, fp_index, seed)
    if key in _SOLVE_MEMO:
        return _SOLVE_MEMO[key]
    if nbits > 64:
        _SOLVE_MEMO[key] = None
        return None
    from ..engine.fingerprint import affine_basis

    const, basis = affine_basis(nbits, fp_index, seed)
    const64 = int(const[0]) | (int(const[1]) << 32)
    b64 = [int(basis[i, 0]) | (int(basis[i, 1]) << 32)
           for i in range(nbits)]
    # rows: 64 equations over the nbits unknowns; (a, m) = unknown
    # mask, fp-bit combination mask
    rows = [(0, 1 << j) for j in range(64)]
    for j in range(64):
        a = 0
        for i in range(nbits):
            if (b64[i] >> j) & 1:
                a |= 1 << i
        rows[j] = (a, 1 << j)
    pivot = [-1] * nbits
    used = [False] * 64
    for i in range(nbits):
        p = next((j for j in range(64)
                  if not used[j] and (rows[j][0] >> i) & 1), None)
        if p is None:
            _SOLVE_MEMO[key] = None
            return None
        used[p] = True
        pivot[i] = p
        pa, pm = rows[p]
        for j in range(64):
            if j != p and (rows[j][0] >> i) & 1:
                rows[j] = (rows[j][0] ^ pa, rows[j][1] ^ pm)
    masks = np.array([rows[pivot[i]][1] for i in range(nbits)],
                     dtype=np.uint64)
    out = (np.uint64(const64), masks, np.array(b64, dtype=np.uint64))
    _SOLVE_MEMO[key] = out
    return out


def invert_fps(lo: np.ndarray, hi: np.ndarray, nbits: int,
               fp_index: int, seed: int) -> Optional[np.ndarray]:
    """Recover packed state words [N, W] uint32 from RAW (unmixed)
    fingerprints.  Returns None when the codec is too wide (> 64 bits)
    or any recovered state fails the round-trip re-fingerprint (the
    2^-64 empty-marker remap class, or a corrupt table) - the caller
    must then skip the reach tier rather than store a wrong state."""
    solved = _solve_basis(nbits, fp_index, seed)
    if solved is None:
        return None
    const64, masks, b64 = solved
    y = ((lo.astype(np.uint64) | (hi.astype(np.uint64) << np.uint64(32)))
         ^ const64)
    # bit i of each message = parity of the masked fp bits
    bits = (np.bitwise_count(masks[None, :] & y[:, None])
            & np.uint64(1)).astype(np.uint32)  # [N, nbits]
    # round-trip: the affine map applied to the recovered bits must
    # reproduce the fingerprint exactly (catches out-of-image inputs)
    y2 = np.bitwise_xor.reduce(
        bits.astype(np.uint64) * b64[None, :], axis=1
    )
    if not np.array_equal(y2, y):
        return None
    W = (nbits + 31) // 32
    words = np.zeros((bits.shape[0], W), dtype=np.uint32)
    for i in range(nbits):
        words[:, i // 32] |= bits[:, i] << np.uint32(i % 32)
    return words


def states_from_table(table: np.ndarray, nbits: int, fp_index: int,
                      seed: int) -> Optional[np.ndarray]:
    """Packed reachable states from a final fpset TABLE ([nb, 2*B]
    interleaved uint32 bucket rows): occupied slots -> unmix -> affine
    inversion, rows sorted for a canonical (CRC-stable) artifact."""
    from ..engine.fpset import unmix_host

    t = np.asarray(table, np.uint32)
    lo = t[:, 0::2].reshape(-1)
    hi = t[:, 1::2].reshape(-1)
    occ = (lo != 0) | (hi != 0)
    rlo, rhi = unmix_host(lo[occ], hi[occ])
    words = invert_fps(rlo, rhi, nbits, fp_index, seed)
    if words is None:
        return None
    order = np.lexsort(tuple(words[:, w] for w in range(words.shape[1])))
    return np.ascontiguousarray(words[order])


# ---------------------------------------------------------------------------
# The store
# ---------------------------------------------------------------------------


class ArtifactStore:
    """Crash-consistent content-addressed artifact directory.

    Layout: ``<root>/verdict/<key>.json`` and ``<root>/reach/<key>.npz``
    - key is the full hex digest, file content carries format version,
    engine semver, a CRC32 of the payload, and the key echoed back
    (a renamed/misplaced file can never answer for another key).
    Reads that fail any of those checks are counted ``corrupt`` and
    reported through the caller's warn hook; version skew is a plain
    miss."""

    def __init__(self, root: str):
        self.root = root
        self._lock = threading.Lock()
        self.verdict_hits = 0
        self.verdict_misses = 0
        self.reach_hits = 0
        self.reach_misses = 0
        self.writes = 0
        self.corrupt = 0
        self.bypasses = 0

    # -- paths -------------------------------------------------------------

    def _path(self, tier: str, key: str) -> str:
        suffix = ".json" if tier == VERDICT_DIR else ".npz"
        return os.path.join(self.root, tier, key + suffix)

    def _count(self, field: str, n: int = 1) -> None:
        with self._lock:
            setattr(self, field, getattr(self, field) + n)

    @staticmethod
    def _unlink(path: str) -> None:
        try:
            os.remove(path)
        except OSError:
            pass  # best-effort: a stuck file stays a loud miss

    # -- verdict tier ------------------------------------------------------

    def put_verdict(self, key: str, payload: dict) -> str:
        path = self._path(VERDICT_DIR, key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        body = json.dumps(payload, sort_keys=True)
        doc = {
            "format": FORMAT_VERSION,
            "engine_semver": ENGINE_SEMVER,
            "key": key,
            "crc": zlib.crc32(body.encode()),
            "payload": payload,
        }
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            f.write(json.dumps(doc, sort_keys=True))
            _fsync_replace(tmp, path, f=f)
        self._count("writes")
        return path

    def lookup_verdict(self, key: str, warn=None) -> Optional[dict]:
        path = self._path(VERDICT_DIR, key)
        if not os.path.exists(path):
            self._count("verdict_misses")
            return None
        try:
            with open(path, encoding="utf-8") as f:
                doc = json.load(f)
            payload = doc["payload"]
            if doc.get("key") != key:
                raise ValueError("key echo mismatch")
            crc = zlib.crc32(
                json.dumps(payload, sort_keys=True).encode()
            )
            if crc != doc.get("crc"):
                raise ValueError(f"CRC mismatch ({crc} != {doc.get('crc')})")
        except (OSError, ValueError, KeyError, json.JSONDecodeError) as e:
            self._count("corrupt")
            self._count("verdict_misses")
            if warn is not None:
                warn(f"artifact cache: corrupt verdict artifact "
                     f"{path} ({e}) - treated as a miss")
            self._unlink(path)  # self-heal: the next clean run rewrites
            return None
        if (doc.get("format") != FORMAT_VERSION
                or doc.get("engine_semver") != ENGINE_SEMVER):
            self._count("verdict_misses")  # version skew: a plain miss
            return None
        self._count("verdict_hits")
        return payload

    # -- reach tier --------------------------------------------------------

    def put_reach(self, key: str, states: np.ndarray,
                  meta: dict) -> str:
        path = self._path(REACH_DIR, key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        states = np.ascontiguousarray(np.asarray(states, np.uint32))
        meta = {
            **meta,
            "format": FORMAT_VERSION,
            "engine_semver": ENGINE_SEMVER,
            "key": key,
            "n_states": int(states.shape[0]),
            "states_crc": zlib.crc32(states.tobytes()),
        }
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez_compressed(f, __meta__=json.dumps(meta),
                                states=states)
            _fsync_replace(tmp, path, f=f)
        self._count("writes")
        return path

    def has_reach(self, key: str) -> bool:
        return os.path.exists(self._path(REACH_DIR, key))

    def lookup_reach(self, key: str, warn=None
                     ) -> Optional[Tuple[np.ndarray, dict]]:
        path = self._path(REACH_DIR, key)
        if not os.path.exists(path):
            self._count("reach_misses")
            return None
        try:
            with np.load(path, allow_pickle=False) as z:
                meta = json.loads(str(z["__meta__"]))
                states = np.asarray(z["states"], np.uint32)
            if meta.get("key") != key:
                raise ValueError("key echo mismatch")
            crc = zlib.crc32(np.ascontiguousarray(states).tobytes())
            if crc != meta.get("states_crc"):
                raise ValueError(
                    f"states CRC mismatch ({crc} != "
                    f"{meta.get('states_crc')})"
                )
            if meta.get("n_states") != states.shape[0]:
                raise ValueError("state count mismatch")
        except (Exception) as e:  # zipfile/zlib/json/KeyError/Value...
            self._count("corrupt")
            self._count("reach_misses")
            if warn is not None:
                warn(f"artifact cache: corrupt reachable-set artifact "
                     f"{path} ({e}) - treated as a miss")
            self._unlink(path)  # self-heal: the next clean run rewrites
            return None
        if (meta.get("format") != FORMAT_VERSION
                or meta.get("engine_semver") != ENGINE_SEMVER):
            self._count("reach_misses")
            return None
        self._count("reach_hits")
        return states, meta

    # -- maintenance -------------------------------------------------------

    def _files(self) -> List[Tuple[str, str, str]]:
        out = []
        for tier, suffix in ((VERDICT_DIR, ".json"), (REACH_DIR, ".npz")):
            d = os.path.join(self.root, tier)
            if not os.path.isdir(d):
                continue
            for name in sorted(os.listdir(d)):
                if name.endswith(suffix) and not name.endswith(".tmp"):
                    out.append((tier, name[: -len(suffix)],
                                os.path.join(d, name)))
        return out

    def ls(self) -> List[dict]:
        """One row per artifact (newest first): tier, key, size, age,
        and the workload name when the file is readable."""
        rows = []
        for tier, key, path in self._files():
            try:
                st = os.stat(path)
            except OSError:
                continue
            row = dict(tier=tier, key=key, bytes=st.st_size,
                       mtime=st.st_mtime, workload=None)
            try:
                if tier == VERDICT_DIR:
                    with open(path, encoding="utf-8") as f:
                        row["workload"] = json.load(f)["payload"].get(
                            "workload")
                else:
                    with np.load(path, allow_pickle=False) as z:
                        row["workload"] = json.loads(
                            str(z["__meta__"])).get("workload")
            except Exception:
                row["workload"] = "<unreadable>"
            rows.append(row)
        rows.sort(key=lambda r: r["mtime"], reverse=True)
        return rows

    def verify(self) -> List[dict]:
        """Full integrity pass: re-run every artifact through its
        loading checks (CRC, key echo, version).  Returns one row per
        artifact with ok/reason - corrupt files are reported, never
        deleted (that is gc's job, on the operator's say-so)."""
        rows = []
        for tier, key, path in self._files():
            reason = ""
            if tier == VERDICT_DIR:
                ok = self._verify_verdict(key, path)
            else:
                ok = self._verify_reach(key, path)
            if not ok:
                reason = "CRC/format/key verification failed"
            rows.append(dict(tier=tier, key=key, path=path, ok=ok,
                             reason=reason))
        return rows

    def _verify_verdict(self, key: str, path: str) -> bool:
        try:
            with open(path, encoding="utf-8") as f:
                doc = json.load(f)
            body = json.dumps(doc["payload"], sort_keys=True)
            return (doc.get("key") == key
                    and doc.get("format") == FORMAT_VERSION
                    and zlib.crc32(body.encode()) == doc.get("crc"))
        except Exception:
            return False

    def _verify_reach(self, key: str, path: str) -> bool:
        try:
            with np.load(path, allow_pickle=False) as z:
                meta = json.loads(str(z["__meta__"]))
                states = np.ascontiguousarray(
                    np.asarray(z["states"], np.uint32))
            return (meta.get("key") == key
                    and meta.get("format") == FORMAT_VERSION
                    and zlib.crc32(states.tobytes())
                    == meta.get("states_crc"))
        except Exception:
            return False

    def gc(self, max_bytes: int) -> dict:
        """Prune least-recently-written artifacts until the store fits
        `max_bytes`.  Returns {kept, deleted, bytes}."""
        rows = []
        for tier, key, path in self._files():
            try:
                st = os.stat(path)
            except OSError:
                continue
            rows.append((st.st_mtime, st.st_size, path))
        rows.sort(reverse=True)  # newest first: keep from the top
        total, kept, deleted = 0, 0, 0
        for mtime, size, path in rows:
            if total + size <= max_bytes:
                total += size
                kept += 1
            else:
                try:
                    os.remove(path)
                    deleted += 1
                except OSError:
                    kept += 1
        return dict(kept=kept, deleted=deleted, bytes=total)

    def stats(self) -> dict:
        with self._lock:
            return dict(
                root=self.root,
                verdict_hits=self.verdict_hits,
                verdict_misses=self.verdict_misses,
                reach_hits=self.reach_hits,
                reach_misses=self.reach_misses,
                writes=self.writes,
                corrupt=self.corrupt,
                bypasses=self.bypasses,
            )


# ---------------------------------------------------------------------------
# Process-global store resolution
# ---------------------------------------------------------------------------

_STORE: Optional[ArtifactStore] = None
_STORE_ROOT: Optional[str] = None  # what _STORE was resolved against


def get_store() -> Optional[ArtifactStore]:
    """The process store per ``TORCHTLC_ARTIFACT_CACHE`` (default
    ``~/.cache/torchtlc/artifacts``; ``off``/``0``/``none`` disables ->
    None).  Singleton per resolved root, so counters accumulate across
    the checks of one process."""
    global _STORE, _STORE_ROOT
    env = os.environ.get(ENV, "")
    if env.lower() in ("off", "0", "none"):
        return None
    root = env or _DEFAULT_ROOT
    if _STORE is None or _STORE_ROOT != root:
        _STORE = ArtifactStore(root)
        _STORE_ROOT = root
    return _STORE


def store_for(args) -> Optional[ArtifactStore]:
    """Resolve the store a run's parsed flags want: ``-no-artifact-cache``
    wins, ``-artifact-cache DIR`` overrides the env/default root (a
    fresh store instance - explicit dirs do not hijack the process
    singleton), else the process store (None when the env disables
    it)."""
    if getattr(args, "noartifactcache", False):
        return None
    explicit = getattr(args, "artifactcache", "") or ""
    if explicit:
        return ArtifactStore(explicit)
    return get_store()


# ---------------------------------------------------------------------------
# Payload <-> CheckResult
# ---------------------------------------------------------------------------


def verdict_payload(model, result, n_init: int, properties=(),
                    action_order=None) -> dict:
    """The cached-verdict payload: everything the transcript/journal
    replay needs, no geometry-dependent fields (occupancy is recomputed
    against the requesting run's fp_capacity)."""
    return dict(
        workload=model.root_name,
        verdict="ok",
        generated=int(result.generated),
        distinct=int(result.distinct),
        depth=int(result.depth),
        queue=int(result.queue_left),
        n_init=int(n_init),
        action_generated={k: int(v) for k, v in
                          result.action_generated.items()},
        action_distinct={k: int(v) for k, v in
                         result.action_distinct.items()},
        action_order=list(action_order or ()),
        # plain floats: outdegree tuples carry numpy scalars json
        # cannot serialize (values are preserved exactly)
        outdegree=([float(v) for v in result.outdegree]
                   if result.outdegree is not None else None),
        properties=sorted(properties or ()),
        wall_s=round(float(result.wall_s), 6),
        created_t=round(time.time(), 3),
    )


def result_from_payload(payload: dict, fp_capacity: int = 0,
                        wall_s: float = 0.0):
    """A CheckResult materialized from a verdict payload (the O(HTTP)
    answer).  wall_s is the LOOKUP wall, not the original run's - the
    transcript reports what this invocation actually took."""
    from ..engine.bfs import CheckResult

    distinct = int(payload["distinct"])
    return CheckResult(
        generated=int(payload["generated"]),
        distinct=distinct,
        depth=int(payload["depth"]),
        queue_left=int(payload["queue"]),
        violation=0,
        violation_name="none",
        violation_state=np.zeros(0, np.int32),
        violation_action=-1,
        action_generated=dict(payload["action_generated"]),
        action_distinct=dict(payload["action_distinct"]),
        wall_s=wall_s,
        iterations=-1,
        outdegree=(tuple(payload["outdegree"])
                   if payload.get("outdegree") else None),
        fp_occupancy=(distinct / fp_capacity if fp_capacity else None),
    )


# ---------------------------------------------------------------------------
# The invariant-delta recheck
# ---------------------------------------------------------------------------

def run_recheck(model, backend, states: np.ndarray, device=None):
    """Evaluate the model's CURRENT invariants over a stored reachable
    set - the BFS-free half of an invariant-only edit: one launch of
    kernel K31 ``struct_recheck`` over every stored row on the card
    (``backend.kernels.recheck``; the plain version on a CPU device),
    which also finds the first failing row there; the host reads that
    one index, then that row's bits and fields.

    Returns (violation_code, violation_fields | None): 0 = every state
    (initial states included - they are in the set) satisfies every
    invariant; otherwise the first violating state in artifact order
    with the LOWEST violated invariant's code (the trace renderer
    re-finds the minimal counterexample on the host interpreter,
    exactly as a full run does)."""
    import torch

    from ..engine.bfs import resolve_device

    n_inv = len(backend.inv_codes)
    if n_inv == 0 or states.shape[0] == 0:
        return 0, None
    n = states.shape[0]
    words = torch.from_numpy(np.ascontiguousarray(
        states, np.uint32).view(np.int32)).to(resolve_device(device))
    bits, first = backend.kernels.recheck(words)
    i = int(first)
    if i >= n:
        return 0, None
    b = int(bits[i])
    k = 0
    while (b >> k) & 1:
        k += 1
    fields = backend.cdc.unpack(words[i:i + 1]).cpu().numpy()[0]
    return int(backend.inv_codes[k]), np.asarray(fields, np.int32)


def recheck_result(meta: dict, viol_code: int, viol_fields,
                   viol_name: str, wall_s: float,
                   fp_capacity: int = 0):
    """CheckResult of an invariant-delta recheck: clean rechecks carry
    the stored run's full counters (the reachable set IS that run's);
    a violated recheck reports the violation - counters still the
    stored exhaustive ones, clearly a superset of what a violating
    fresh run would have explored before halting."""
    from ..engine.bfs import CheckResult

    distinct = int(meta["distinct"])
    return CheckResult(
        generated=int(meta["generated"]),
        distinct=distinct,
        depth=int(meta["depth"]),
        queue_left=0,
        violation=int(viol_code),
        violation_name=viol_name,
        violation_state=(np.asarray(viol_fields, np.int32)
                         if viol_fields is not None
                         else np.zeros(0, np.int32)),
        violation_action=-1,
        action_generated=dict(meta["action_generated"]),
        action_distinct=dict(meta["action_distinct"]),
        wall_s=wall_s,
        iterations=-1,
        outdegree=(tuple(meta["outdegree"])
                   if meta.get("outdegree") else None),
        fp_occupancy=(distinct / fp_capacity if fp_capacity else None),
    )


# ---------------------------------------------------------------------------
# The api-side plan
# ---------------------------------------------------------------------------


class _PropertyHolds:
    """Stand-in temporal-check result on a verdict-tier hit: the cached
    clean verdict attests every selected property held."""

    holds = True
    lasso_prefix = ()
    lasso_cycle = ()


class ArtifactPlan:
    """One check's view of the artifact cache (api._run_check_struct
    wires it into the struct path).  Owns key computation, the two-tier
    lookup, the replacement check functions, and the clean-verdict
    write.  A re-check runs on `device` (None = the card)."""

    def __init__(self, store: ArtifactStore, model, check_deadlock: bool,
                 properties=(), fp_capacity: int = 0, bounds=None,
                 fp_index: int = None, seed: int = None,
                 bypass_read: bool = False, device=None):
        from ..engine.fingerprint import DEFAULT_FP_INDEX, DEFAULT_SEED

        self.store = store
        self.model = model
        self.check_deadlock = bool(check_deadlock)
        self.properties = tuple(properties or ())
        self.fp_capacity = int(fp_capacity)
        self.bounds = bounds
        self.fp_index = (fp_index if fp_index is not None
                         else DEFAULT_FP_INDEX)
        self.seed = seed if seed is not None else DEFAULT_SEED
        self.bypass_read = bool(bypass_read)
        self.device = device
        self.vkey = verdict_key(model, check_deadlock, self.properties)
        self.rkey = reach_key(model, check_deadlock)
        self.verdict_hit = False
        self.reach_hit = False

    # -- helpers -----------------------------------------------------------

    def _backend(self):
        from .cache import get_backend

        return get_backend(self.model, self.check_deadlock,
                           bounds=self.bounds)

    def _journal(self, journal, tier: str, outcome: str, key: str,
                 log=None, **extra) -> None:
        """Journal one cache decision (the single source of truth);
        hits additionally render their TLC-style banner as a derived
        view of that same event (obs.views), like every other
        supervisor banner."""
        if journal is not None:
            ev = journal.event("cache", tier=tier, outcome=outcome,
                               key=key, **extra)
        else:
            from ..obs.schema import SCHEMA_VERSION

            ev = {"v": SCHEMA_VERSION, "t": time.time(),
                  "event": "cache", "tier": tier, "outcome": outcome,
                  "key": key, **extra}
        if log is not None and outcome == "hit":
            from ..obs.views import render_tlc_event

            render_tlc_event(log, ev)

    # -- lookup ------------------------------------------------------------

    def fast_check(self, journal, log):
        """Try both tiers BEFORE any engine build.  Returns None (run
        normally) or (tier, check_fn, n_init): check_fn replaces the
        kit's engine dispatch and returns (CheckResult, None)."""

        def warn_for(tier, key):
            # a corrupt artifact is LOUD in both surfaces: a transcript
            # warning and a schema-v1 `cache` event with outcome
            # "corrupt" (the miss event still follows - corruption IS
            # a miss, the extra event says why)
            def warn(msg):
                log.msg(1000, f"Warning: {msg}", severity=1)
                self._journal(journal, tier, "corrupt", key)

            return warn

        if self.bypass_read:
            self.store._count("bypasses")
            self._journal(journal, "verdict", "bypass", self.vkey)
            return None
        payload = self.store.lookup_verdict(
            self.vkey, warn=warn_for("verdict", self.vkey))
        if payload is not None:
            self.verdict_hit = True
            self._journal(journal, "verdict", "hit", self.vkey,
                          log=log, workload=payload.get("workload"))
            t0 = time.time()

            def check():
                return (result_from_payload(
                    payload, fp_capacity=self.fp_capacity,
                    wall_s=time.time() - t0,
                ), None)

            return "verdict", check, int(payload["n_init"])
        self._journal(journal, "verdict", "miss", self.vkey)
        if self.properties:
            return None  # the reach tier cannot attest liveness
        reach = self.store.lookup_reach(
            self.rkey, warn=warn_for("reach", self.rkey))
        if reach is None:
            self._journal(journal, "reach", "miss", self.rkey)
            return None
        states, meta = reach
        backend = self._backend()
        if codec_digest(backend.cdc, self.bounds) != meta.get(
                "codec_digest"):
            # the new model infers a different packed layout (e.g. a
            # TypeOK hint reshaped a field): decoding would be garbage
            self._journal(journal, "reach", "miss", self.rkey,
                          detail="codec layout changed")
            self.store._count("reach_hits", -1)
            self.store._count("reach_misses")
            return None
        self.reach_hit = True
        self._journal(journal, "reach", "hit", self.rkey, log=log,
                      workload=meta.get("workload"),
                      states=int(states.shape[0]))

        def check():
            from .backend import struct_viol_names

            t0 = time.time()
            code, fields = run_recheck(self.model, backend, states,
                                       self.device)
            name = struct_viol_names(self.model).get(code, "none")
            return (recheck_result(
                meta, code, fields, name, time.time() - t0,
                fp_capacity=self.fp_capacity,
            ), None)

        return "reach", check, int(meta["n_init"])

    # -- write -------------------------------------------------------------

    def record(self, result, n_init: int, journal=None,
               action_order=None) -> None:
        """Write both tiers after a CLEAN final verdict (the only write
        point: error/violation/exhausted/interrupted/cert runs never
        reach here with violation == 0).  The reach tier additionally
        needs the captured fpset table and an invertible (<= 64 bit)
        codec that passes the round-trip re-fingerprint."""
        if result is None or int(result.violation) != 0:
            return
        if getattr(result, "cert_violated", None):
            return
        backend = self._backend()
        if not self.verdict_hit:
            if action_order is None:
                action_order = backend.labels
            self.store.put_verdict(self.vkey, verdict_payload(
                self.model, result, n_init,
                properties=self.properties, action_order=action_order,
            ))
            self._journal(journal, "verdict", "write", self.vkey)
        table = getattr(result, "fp_table", None)
        if table is None or self.reach_hit or self.store.has_reach(
                self.rkey):
            return
        states = states_from_table(table, backend.cdc.nbits,
                                   self.fp_index, self.seed)
        if states is None or states.shape[0] != int(result.distinct):
            # > 64-bit codec, a failed round-trip, or a table whose
            # occupancy disagrees with the distinct counter: skip the
            # tier rather than store anything unverified
            self._journal(journal, "reach", "skip", self.rkey,
                          detail="codec not invertible")
            return
        self.store.put_reach(self.rkey, states, dict(
            workload=self.model.root_name,
            codec_digest=codec_digest(backend.cdc, self.bounds),
            nbits=int(backend.cdc.nbits),
            generated=int(result.generated),
            distinct=int(result.distinct),
            depth=int(result.depth),
            n_init=int(n_init),
            action_generated={k: int(v) for k, v in
                              result.action_generated.items()},
            action_distinct={k: int(v) for k, v in
                             result.action_distinct.items()},
            outdegree=([float(v) for v in result.outdegree]
                       if result.outdegree is not None else None),
            created_t=round(time.time(), 3),
        ))
        self._journal(journal, "reach", "write", self.rkey)
