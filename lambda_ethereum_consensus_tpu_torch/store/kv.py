"""Ordered key-value store: ctypes binding over the native engine.

The native engine (``native/kvstore/kvstore.cpp``) is an in-memory ordered
map + write-ahead log — the role Exleveldb/LevelDB plays for the reference
(ref: lib/.../store/db.ex:16-41).  A pure-Python engine speaks the *same WAL
format*, so data files are interchangeable between backends (and between
this package and the JAX package).

WAL format v2 (round 20): the log is crash-consistent, not just
append-only.  An 8-byte file header (``KVWL`` magic + version byte) is
followed by framed records::

    op(u8) | klen(u32 LE) | vlen(u32 LE) | crc32c(u32 LE) | key | value

where the CRC32C (Castagnoli) covers ``op || klen || vlen || key ||
value`` — a torn write or bit flip anywhere in a record is detected, the
damaged tail is TRUNCATED at the last verified frame (never replayed,
never raised over), and the drop is reported through
:attr:`KvStore.recovery` + the ``storage_wal_*`` counters.  Legacy
unframed logs (the pre-round-20 format: bare ``op|klen|vlen|key|value``)
are detected by the missing magic and migrated in place on open through
the same durable-rename discipline compaction uses.

Durability seam: ``flush()`` drains the userspace buffer (what the old
code called durability), ``sync()`` adds the ``fsync`` the kernel needs
for power-loss safety, and ``barrier()`` is the policy-aware combination
the node's finalization hook calls — batched at finality, not per put
(``durability``: ``finality`` default, ``always``, ``never``).
Compaction and migration fsync the rewritten FILE and its parent
DIRECTORY around ``os.replace`` (:func:`fsync_replace`; POSIX orders
neither the data nor the dirent with the rename on its own).

The port's copy of the JAX package's ``store/kv.py``, the WAL byte for byte
the same.  It differs in where the native engine comes from and in what
picks it:

- ``KvStore(native=None)`` (or ``True``) opens the native engine that
  :func:`..ops._build.build_host` compiles from ``native/kvstore/kvstore.cpp``
  with ``g++`` into the package's ``_build/`` at first use.  It never loads
  ``native/build/libkvstore.so``, and a failed build raises: there is no
  quiet switch to the Python engine.  ``native=False`` opens the Python
  engine.
- The default durability policy is the module constant
  :data:`DEFAULT_DURABILITY`, not the ``KV_FSYNC`` environment variable;
  ``durability=`` stays a constructor argument.
"""

from __future__ import annotations

import ctypes
import logging
import os
import struct
import threading
from typing import Iterator

from ..ops import _build
from ..telemetry import get_metrics

log = logging.getLogger("kvstore")

# ------------------------------------------------------------ WAL framing

WAL_MAGIC = b"KVWL"
WAL_VERSION = 2
WAL_HEADER = WAL_MAGIC + bytes([WAL_VERSION, 0, 0, 0])
_FRAME = struct.Struct("<BIII")  # op, klen, vlen, crc32c

_CRC32C_POLY = 0x82F63B78  # Castagnoli, reflected


def _make_crc_table() -> tuple:
    table = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ _CRC32C_POLY if crc & 1 else crc >> 1
        table.append(crc)
    return tuple(table)


_CRC_TABLE = _make_crc_table()


def crc32c(data: bytes, crc: int = 0) -> int:
    """CRC32C (Castagnoli) — the WAL frame checksum, implemented here and
    in ``kvstore.cpp`` from the same table recipe so the two backends
    verify each other's files byte for byte."""
    crc ^= 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ _CRC_TABLE[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def _frame(op: int, key: bytes, val: bytes) -> bytes:
    body = bytes([op]) + struct.pack("<II", len(key), len(val)) + key + val
    return _FRAME.pack(op, len(key), len(val), crc32c(body)) + key + val


def fsync_replace(tmp_path: str, dst_path: str) -> None:
    """The durable-rename step: the caller has already fsynced the
    written tmp FILE; this renames it over the destination and fsyncs
    the parent DIRECTORY, because POSIX does not order the dirent update
    with anything — a crash after a bare ``os.replace`` can resurrect the
    old file or leave neither."""
    os.replace(tmp_path, dst_path)
    dirfd = os.open(os.path.dirname(os.path.abspath(dst_path)), os.O_RDONLY)
    try:
        os.fsync(dirfd)
    finally:
        os.close(dirfd)


def _fresh_recovery() -> dict:
    return {
        "records": 0,
        "dropped_bytes": 0,
        "truncated": False,
        "migrated": False,
    }


_NATIVE = None
_NATIVE_LOCK = threading.Lock()


def _native_lib():
    """The native engine's library, built with ``g++`` into ``_build/`` and
    bound on first use; raises if the build or the binding fails."""
    global _NATIVE
    with _NATIVE_LOCK:
        if _NATIVE is None:
            _NATIVE = _bind(ctypes.CDLL(str(_build.build_host("kvstore"))))
        return _NATIVE


def _bind(lib):
    try:
        lib.kv_open.restype = ctypes.c_void_p
        lib.kv_open.argtypes = [ctypes.c_char_p]
        lib.kv_put.restype = ctypes.c_int
        lib.kv_put.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32,
            ctypes.c_char_p, ctypes.c_uint32,
        ]
        lib.kv_delete.restype = ctypes.c_int
        lib.kv_delete.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32]
        lib.kv_get.restype = ctypes.c_void_p
        lib.kv_get.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32,
            ctypes.POINTER(ctypes.c_uint32),
        ]
        lib.kv_free.argtypes = [ctypes.c_void_p]
        lib.kv_flush.argtypes = [ctypes.c_void_p]
        lib.kv_count.restype = ctypes.c_uint64
        lib.kv_count.argtypes = [ctypes.c_void_p]
        lib.kv_compact.restype = ctypes.c_int
        lib.kv_compact.argtypes = [ctypes.c_void_p]
        lib.kv_close.argtypes = [ctypes.c_void_p]
        lib.kv_iter_range.restype = ctypes.c_void_p
        lib.kv_iter_range.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32,
            ctypes.c_char_p, ctypes.c_uint32, ctypes.c_int,
        ]
        lib.kv_iter_next.restype = ctypes.c_int
        lib.kv_iter_next.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_uint32),
        ]
        lib.kv_iter_free.argtypes = [ctypes.c_void_p]
        lib.kv_sync.restype = ctypes.c_int
        lib.kv_sync.argtypes = [ctypes.c_void_p]
        lib.kv_recovery.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ]
    except AttributeError as e:
        raise KvError(f"the native kvstore library lacks an entry point: {e}") from e
    return lib


class KvError(RuntimeError):
    pass


class _NativeEngine:
    def __init__(self, path: str):
        self._lib = _native_lib()
        self._h = self._lib.kv_open(path.encode())
        if not self._h:
            raise KvError(f"cannot open kv store at {path}")
        records = ctypes.c_uint64()
        dropped = ctypes.c_uint64()
        truncated = ctypes.c_int()
        migrated = ctypes.c_int()
        self._lib.kv_recovery(
            self._h, ctypes.byref(records), ctypes.byref(dropped),
            ctypes.byref(truncated), ctypes.byref(migrated),
        )
        self.recovery = {
            "records": int(records.value),
            "dropped_bytes": int(dropped.value),
            "truncated": bool(truncated.value),
            "migrated": bool(migrated.value),
        }

    def put(self, key: bytes, val: bytes) -> None:
        if self._lib.kv_put(self._h, key, len(key), val, len(val)) != 0:
            raise KvError("put failed")

    def get(self, key: bytes) -> bytes | None:
        vlen = ctypes.c_uint32()
        ptr = self._lib.kv_get(self._h, key, len(key), ctypes.byref(vlen))
        if not ptr:
            return None
        try:
            return ctypes.string_at(ptr, vlen.value)
        finally:
            self._lib.kv_free(ptr)

    def delete(self, key: bytes) -> None:
        if self._lib.kv_delete(self._h, key, len(key)) != 0:
            raise KvError("delete failed")

    def iterate(
        self, start: bytes, end: bytes, descending: bool
    ) -> Iterator[tuple[bytes, bytes]]:
        it = self._lib.kv_iter_range(
            self._h, start, len(start), end, len(end), int(descending)
        )
        try:
            kp = ctypes.c_void_p()
            kl = ctypes.c_uint32()
            vp = ctypes.c_void_p()
            vl = ctypes.c_uint32()
            while self._lib.kv_iter_next(
                it, ctypes.byref(kp), ctypes.byref(kl), ctypes.byref(vp), ctypes.byref(vl)
            ):
                yield (
                    ctypes.string_at(kp.value, kl.value),
                    ctypes.string_at(vp.value, vl.value),
                )
        finally:
            self._lib.kv_iter_free(it)

    def flush(self) -> None:
        self._lib.kv_flush(self._h)

    def sync(self) -> None:
        if self._lib.kv_sync(self._h) != 0:
            raise KvError("fsync failed")

    def compact(self) -> None:
        if self._lib.kv_compact(self._h) != 0:
            raise KvError("compact failed")

    def count(self) -> int:
        return int(self._lib.kv_count(self._h))

    def close(self) -> None:
        if self._h:
            self._lib.kv_close(self._h)
            self._h = None


class _PyEngine:
    """Pure-Python engine speaking the same framed WAL as the C++ engine."""

    def __init__(self, path: str):
        self._path = path
        self._table: dict[bytes, bytes] = {}
        self._lock = threading.Lock()
        self.recovery = _fresh_recovery()
        if os.path.exists(path) and os.path.getsize(path) > 0:
            self._open_existing()
        else:
            # a fresh (or zero-length — e.g. created-then-crashed) log
            # starts with the framed header, synced so the format byte
            # itself survives the next power cut
            with open(path, "wb") as f:
                f.write(WAL_HEADER)
                f.flush()
                os.fsync(f.fileno())
        self._log = open(path, "ab")

    # ------------------------------------------------------------ recovery

    def _open_existing(self) -> None:
        with open(self._path, "rb") as f:
            head = f.read(len(WAL_HEADER))
        # a SHORT header (crash during file creation, before any record
        # could exist) is not framed: it falls through to the legacy
        # path, which drops the unparseable bytes and migrates to a
        # fresh framed file — the same treatment the C++ engine gives
        # the identical bytes, so the backends never diverge on them
        if len(head) == len(WAL_HEADER) and head[: len(WAL_MAGIC)] == WAL_MAGIC:
            if head[len(WAL_MAGIC)] != WAL_VERSION:
                raise KvError(
                    f"unsupported WAL version {head[len(WAL_MAGIC)]} "
                    f"in {self._path}"
                )
            self._replay_framed()
        else:
            # pre-round-20 unframed log: replay with the legacy tail rule
            # (a short read ends replay) and migrate the snapshot to the
            # framed format in place
            self._replay_legacy()
            self._migrate()

    def _replay_framed(self) -> None:
        size = os.path.getsize(self._path)
        good_end = len(WAL_HEADER)
        with open(self._path, "rb") as f:
            f.seek(good_end)
            while True:
                head = f.read(_FRAME.size)
                if len(head) < _FRAME.size:
                    break
                op, klen, vlen, crc = _FRAME.unpack(head)
                key = f.read(klen)
                val = f.read(vlen)
                if len(key) < klen or len(val) < vlen:
                    break  # torn tail
                body = bytes([op]) + struct.pack("<II", klen, vlen) + key + val
                if op not in (1, 2) or crc32c(body) != crc:
                    break  # corrupt frame: everything from here is suspect
                if op == 1:
                    self._table[key] = val
                else:
                    self._table.pop(key, None)
                self.recovery["records"] += 1
                good_end = f.tell()
        if good_end < size:
            # truncate, don't raise: the damage is by construction past
            # the last record anyone observed as durable
            self.recovery["dropped_bytes"] = size - good_end
            self.recovery["truncated"] = True
            os.truncate(self._path, good_end)

    def _replay_legacy(self) -> None:
        size = os.path.getsize(self._path)
        good_end = 0
        with open(self._path, "rb") as f:
            while True:
                head = f.read(9)
                if len(head) < 9:
                    break
                op = head[0]
                klen, vlen = struct.unpack("<II", head[1:9])
                if op not in (1, 2):
                    break
                key = f.read(klen)
                val = f.read(vlen)
                if len(key) < klen or len(val) < vlen:
                    break  # torn tail
                if op == 1:
                    self._table[key] = val
                else:
                    self._table.pop(key, None)
                self.recovery["records"] += 1
                good_end = f.tell()
        if good_end < size:
            self.recovery["dropped_bytes"] = size - good_end
            self.recovery["truncated"] = True

    def _migrate(self) -> None:
        """Rewrite a legacy log as a framed snapshot (durable-rename
        discipline; the overwrite/tombstone history collapses, exactly
        like a compaction)."""
        self._write_snapshot(self._path + ".migrate")
        self.recovery["migrated"] = True

    def _write_snapshot(self, tmp: str) -> None:
        with open(tmp, "wb") as f:
            f.write(WAL_HEADER)
            for k in sorted(self._table):
                f.write(_frame(1, k, self._table[k]))
            f.flush()
            os.fsync(f.fileno())
        fsync_replace(tmp, self._path)

    # ------------------------------------------------------------- surface

    def _append(self, op: int, key: bytes, val: bytes) -> None:
        self._log.write(_frame(op, key, val))

    def put(self, key: bytes, val: bytes) -> None:
        with self._lock:
            self._append(1, key, val)
            self._table[key] = val

    def get(self, key: bytes) -> bytes | None:
        with self._lock:
            return self._table.get(key)

    def delete(self, key: bytes) -> None:
        with self._lock:
            self._append(2, key, b"")
            self._table.pop(key, None)

    def iterate(self, start: bytes, end: bytes, descending: bool):
        with self._lock:
            keys = sorted(
                k for k in self._table if k >= start and (not end or k < end)
            )
        if descending:
            keys.reverse()
        for k in keys:
            v = self._table.get(k)
            if v is not None:
                yield k, v

    def flush(self) -> None:
        with self._lock:
            self._log.flush()

    def sync(self) -> None:
        with self._lock:
            self._log.flush()
            os.fsync(self._log.fileno())

    def compact(self) -> None:
        with self._lock:
            self._log.close()
            self._write_snapshot(self._path + ".compact")
            self._log = open(self._path, "ab")

    def count(self) -> int:
        with self._lock:
            return len(self._table)

    def close(self) -> None:
        self._log.close()


#: durability policies: when does a barrier actually reach the platter.
DURABILITY_MODES = ("finality", "always", "never")
#: the policy a store opened without ``durability=`` keeps
DEFAULT_DURABILITY = "finality"


class KvStore:
    """The store handle used across the framework (ref: store/db.ex API:
    put/get/iterate, plus range cursors).

    ``recovery`` reports what open found: replayed record count, torn/
    corrupt bytes truncated, whether a legacy log was migrated.
    ``native``: ``None`` or ``True`` opens the native engine (built into
    ``_build/`` on first use; a failed build raises), ``False`` the Python
    engine.  ``durability`` is the policy (default
    :data:`DEFAULT_DURABILITY`): ``finality`` fsyncs only at
    :meth:`barrier` — the node's finalization hook; ``always`` fsyncs
    every put (measurably slow, for tooling that wants zero-window loss);
    ``never`` keeps barriers as buffered flushes (throwaway dirs, CI
    fixtures)."""

    def __init__(
        self, path: str, native: bool | None = None,
        durability: str | None = None,
    ):
        use_native = native is None or bool(native)
        if durability is None:
            durability = DEFAULT_DURABILITY
        if durability not in DURABILITY_MODES:
            raise KvError(
                f"durability must be one of {DURABILITY_MODES}, got {durability!r}"
            )
        self.durability = durability
        self._engine = _NativeEngine(path) if use_native else _PyEngine(path)
        self.native = use_native
        self.recovery = dict(self._engine.recovery)
        self._emit_recovery_metrics(path)

    def _emit_recovery_metrics(self, path: str) -> None:
        rec = self.recovery
        m = get_metrics()
        if rec["truncated"]:
            m.inc("storage_wal_truncated_total")
            m.inc("storage_wal_dropped_bytes_total", value=rec["dropped_bytes"])
            log.warning(
                "WAL %s: torn/corrupt tail truncated (%d bytes dropped, "
                "%d records kept)", path, rec["dropped_bytes"], rec["records"],
            )
        if rec["migrated"]:
            m.inc("storage_wal_migrated_total")
            log.info(
                "WAL %s: legacy unframed log migrated to the framed format "
                "(%d records)", path, rec["records"],
            )

    def put(self, key: bytes, value: bytes) -> None:
        self._engine.put(key, value)
        if self.durability == "always":
            self._engine.sync()
            get_metrics().inc("storage_fsync_total", reason="always")

    def get(self, key: bytes) -> bytes | None:
        return self._engine.get(key)

    def delete(self, key: bytes) -> None:
        self._engine.delete(key)
        if self.durability == "always":
            self._engine.sync()
            get_metrics().inc("storage_fsync_total", reason="always")

    def iterate(
        self,
        start: bytes = b"",
        end: bytes = b"",
        descending: bool = False,
    ) -> Iterator[tuple[bytes, bytes]]:
        """Snapshot cursor over [start, end); empty end = to the end."""
        return self._engine.iterate(start, end, descending)

    def iterate_prefix(self, prefix: bytes, descending: bool = False):
        end = _prefix_end(prefix)
        return self._engine.iterate(prefix, end, descending)

    def last_under_prefix(self, prefix: bytes) -> tuple[bytes, bytes] | None:
        """Highest key with ``prefix`` (the resume seek — state_store.ex:36)."""
        for kv in self.iterate_prefix(prefix, descending=True):
            return kv
        return None

    def flush(self) -> None:
        """Drain the userspace buffer (NOT a power-loss barrier)."""
        self._engine.flush()

    def sync(self) -> None:
        """flush + fsync, unconditionally."""
        self._engine.sync()

    def barrier(self, reason: str = "finality") -> None:
        """The durability-policy barrier the node's finalization hook
        calls: always a buffered flush; an fsync unless the policy is
        ``never``.  Counted per reason so the fsync cadence is a
        dashboard fact, not a hope."""
        self._engine.flush()
        if self.durability != "never":
            self._engine.sync()
            get_metrics().inc("storage_fsync_total", reason=reason)

    def compact(self) -> None:
        self._engine.compact()

    def count(self) -> int:
        return self._engine.count()

    def close(self) -> None:
        self._engine.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _prefix_end(prefix: bytes) -> bytes:
    """Smallest byte string greater than every string with ``prefix``."""
    out = bytearray(prefix)
    while out:
        if out[-1] != 0xFF:
            out[-1] += 1
            return bytes(out)
        out.pop()
    return b""  # prefix of all 0xff: no upper bound
