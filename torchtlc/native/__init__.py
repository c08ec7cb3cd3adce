"""Native (C++) host tier: disk-backed fingerprint store + state queue
(port of jaxtlc/native/__init__.py).

The runtime analog of TLC's OffHeapDiskFPSet / DiskStateQueue (MC.out:5):
C++ behind a C ABI, loaded with ctypes.  ``fpstore.cpp`` and
``squeue.cpp`` are the reference's sources, so the file formats are the
reference's - the store's ``JAXTLCFP`` header, its slot hash and growth
rule, the queue's raw int32 records - and either package opens the
other's files.  g++ builds them once per source digest into
``torchtlc/kernels/_build/native/`` at first use (never into a cache of
the reference's, and the reference's library is never loaded).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile

import numpy as np

from ..kernels.build import meter

_SRC_DIR = os.path.dirname(os.path.abspath(__file__))
_SOURCES = ["fpstore.cpp", "squeue.cpp"]
BUILD_DIR = os.path.join(os.path.dirname(_SRC_DIR), "kernels", "_build",
                         "native")


def _build() -> str:
    srcs = [os.path.join(_SRC_DIR, s) for s in _SOURCES]
    digest = hashlib.sha256()
    for p in srcs:
        with open(p, "rb") as f:
            digest.update(f.read())
    os.makedirs(BUILD_DIR, exist_ok=True)
    so = os.path.join(BUILD_DIR,
                      f"torchtlc_native_{digest.hexdigest()[:16]}.so")
    if not os.path.exists(so):
        tmp = so + f".build{os.getpid()}"
        meter("builds")
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-o", tmp]
            + srcs,
            check=True,
            capture_output=True,
        )
        os.replace(tmp, so)
    return so


_lib = None


def lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(_build())
        meter("loads")
        _lib.fps_open.restype = ctypes.c_void_p
        _lib.fps_open.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
        _lib.fps_insert_batch.restype = ctypes.c_int
        _lib.fps_insert_batch.argtypes = [
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_int64,
        ]
        _lib.fps_count.restype = ctypes.c_uint64
        _lib.fps_count.argtypes = [ctypes.c_void_p]
        _lib.fps_capacity.restype = ctypes.c_uint64
        _lib.fps_capacity.argtypes = [ctypes.c_void_p]
        _lib.fps_sync.restype = ctypes.c_int
        _lib.fps_sync.argtypes = [ctypes.c_void_p]
        _lib.fps_close.argtypes = [ctypes.c_void_p]
        _lib.sq_open.restype = ctypes.c_void_p
        _lib.sq_open.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
        _lib.sq_push.restype = ctypes.c_int
        _lib.sq_push.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
        _lib.sq_pop.restype = ctypes.c_int64
        _lib.sq_pop.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
        _lib.sq_len.restype = ctypes.c_uint64
        _lib.sq_len.argtypes = [ctypes.c_void_p]
        _lib.sq_tail.restype = ctypes.c_uint64
        _lib.sq_tail.argtypes = [ctypes.c_void_p]
        _lib.sq_open_at.restype = ctypes.c_void_p
        _lib.sq_open_at.argtypes = [
            ctypes.c_char_p,
            ctypes.c_uint64,
            ctypes.c_uint64,
            ctypes.c_uint64,
        ]
        _lib.sq_sync.restype = ctypes.c_int
        _lib.sq_sync.argtypes = [ctypes.c_void_p]
        _lib.sq_head.restype = ctypes.c_uint64
        _lib.sq_head.argtypes = [ctypes.c_void_p]
        _lib.sq_close.argtypes = [ctypes.c_void_p, ctypes.c_int]
    return _lib


class HostFPStore:
    """Disk-backed (mmap) authoritative fingerprint set.

    fresh=True (the default) removes any existing file at `path` first: a
    store opened for a new run must start empty, or the recovered contents
    silently dedup the new run's states away.  Pass fresh=False to recover
    a previous run's set (the TLC -recover analog)."""

    def __init__(
        self,
        path: str = None,
        initial_capacity: int = 1 << 20,
        fresh: bool = True,
    ):
        self._own_tmp = path is None
        if path is None:
            fd, path = tempfile.mkstemp(suffix=".fps")
            os.close(fd)
            os.unlink(path)
        elif fresh and os.path.exists(path):
            os.unlink(path)
        self.path = path
        self._h = lib().fps_open(path.encode(), initial_capacity)
        if not self._h:
            raise OSError(f"fps_open failed for {path!r}")

    def insert(self, lo: np.ndarray, hi: np.ndarray, mask: np.ndarray):
        """lo/hi uint32 [n], mask bool [n] -> is_new bool [n]."""
        lo = np.ascontiguousarray(lo, dtype=np.uint32)
        hi = np.ascontiguousarray(hi, dtype=np.uint32)
        m = np.ascontiguousarray(mask, dtype=np.uint8)
        rc = lib().fps_insert_batch(
            self._h,
            lo.ctypes.data_as(ctypes.c_void_p),
            hi.ctypes.data_as(ctypes.c_void_p),
            m.ctypes.data_as(ctypes.c_void_p),
            len(lo),
        )
        if rc != 0:
            raise MemoryError("fingerprint store grow failed")
        return m.astype(bool)

    def __len__(self) -> int:
        return int(lib().fps_count(self._h))

    @property
    def capacity(self) -> int:
        return int(lib().fps_capacity(self._h))

    def sync(self) -> None:
        if lib().fps_sync(self._h) != 0:
            raise OSError("fps_sync failed")

    def close(self) -> None:
        if self._h:
            lib().fps_close(self._h)
            self._h = None
            if self._own_tmp and os.path.exists(self.path):
                os.unlink(self.path)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class HostStateQueue:
    """Disk-backed FIFO of fixed-size encoded-state records.

    The backing file is scratch space: it is truncated on open, and removed
    on close only when the library created it (no `path` given) - a
    caller-supplied path is left in place."""

    def __init__(self, record_fields: int, path: str = None,
                 resume_head: int = None, resume_tail: int = None):
        self._own_tmp = path is None
        if path is None:
            fd, path = tempfile.mkstemp(suffix=".sq")
            os.close(fd)
        self.path = path
        self.record_fields = record_fields
        self._rb = record_fields * 4
        if resume_head is not None:
            # reopen without truncation at checkpointed cursors
            self._h = lib().sq_open_at(
                path.encode(), self._rb, resume_head, resume_tail
            )
        else:
            self._h = lib().sq_open(path.encode(), self._rb)
        if not self._h:
            raise OSError(f"sq_open failed for {path!r}")

    def push(self, records: np.ndarray) -> None:
        """records: int32 [n, record_fields]."""
        r = np.ascontiguousarray(records, dtype=np.int32)
        assert r.ndim == 2 and r.shape[1] == self.record_fields
        if lib().sq_push(self._h, r.ctypes.data_as(ctypes.c_void_p), r.shape[0]):
            raise OSError("sq_push failed")

    def pop(self, max_n: int) -> np.ndarray:
        out = np.empty((max_n, self.record_fields), dtype=np.int32)
        n = lib().sq_pop(self._h, out.ctypes.data_as(ctypes.c_void_p), max_n)
        if n < 0:
            raise OSError("sq_pop failed")
        return out[:n]

    def pop_into(self, out: np.ndarray) -> int:
        """Pop up to len(out) records into `out` (int32 [m, record_fields],
        C-contiguous, e.g. a pinned staging buffer) -> the count popped."""
        assert out.dtype == np.int32 and out.flags.c_contiguous
        assert out.ndim == 2 and out.shape[1] == self.record_fields
        n = lib().sq_pop(self._h, out.ctypes.data_as(ctypes.c_void_p),
                         out.shape[0])
        if n < 0:
            raise OSError("sq_pop failed")
        return int(n)

    def __len__(self) -> int:
        return int(lib().sq_len(self._h))

    @property
    def total_pushed(self) -> int:
        return int(lib().sq_tail(self._h))

    @property
    def head(self) -> int:
        return int(lib().sq_head(self._h))

    def sync(self) -> None:
        if lib().sq_sync(self._h) != 0:
            raise OSError("sq_sync failed")

    def close(self) -> None:
        if self._h:
            lib().sq_close(self._h, 1 if self._own_tmp else 0)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
