"""Durable ingest: write-ahead log + atomic engine snapshots.

The serving contract: **an acknowledged write survives process death**.
Every mutating op (insert / delete / compact) is appended to the WAL —
framed, checksummed, fsync'd — *before* the engine acknowledges it;
:meth:`repro_torch.serve.engine.NKSEngine.recover` replays the log on top of
the latest snapshot into a state whose answers are bit-identical to an
uninterrupted run over the same acknowledged op sequence.

Crash semantics fall out of the framing:

  * crash *before* the append completes → the tail record is torn (short or
    checksum-mismatched); replay stops cleanly at the last whole record. The
    op was never acknowledged, so losing it is allowed.
  * crash *after* the fsync, before the ack → the record is durable and
    replay applies it. The client never saw an ack, so applying it is also
    allowed (at-least-once on unacknowledged tails, exactly-once on acks).

Record framing: ``<u32 payload_len><u32 crc32(payload)><payload>`` where the
payload is UTF-8 JSON; numpy arrays ride as ``{"__nd__": dtype, shape, b64}``.
The format is the reference package's byte for byte, so a log (and a WAL
root) written by either package replays in the other.

Snapshots roll the log. A snapshot captures the *frozen* engine state — the
bulk dataset + both index flavours + the external-id map and ingest
counters — written to a temp dir, fsync'd, and atomically renamed; the root
``MANIFEST.json`` (also atomically replaced) names the live epoch. A dirty
engine compacts first (folding the delta), so a snapshot is always a clean
generation boundary and the fresh WAL segment starts empty:

    <root>/MANIFEST.json      {"epoch": E}
    <root>/snap-<E>/          snapshot for epoch E (meta.json + .npy leaves,
                              per-leaf sha256 in the meta manifest)
    <root>/wal-<E>.log        ops acknowledged since snapshot E

The leaf serialisation lives in :mod:`repro_torch.core.store`, shared
between snapshots here and the out-of-core bulk store.

**Group commit**: ``append(record, sync=False)`` defers the fsync so a run
of ops acknowledged together pays one barrier — :meth:`WriteAheadLog.sync`
— instead of one fsync per op. The fsync-before-ack contract is unchanged:
the caller must not ack any deferred record until ``sync()`` returns.
"""
from __future__ import annotations

import base64
import dataclasses
import json
import os
import shutil
import struct
import tempfile
import zlib
from typing import Iterator

import numpy as np

from repro_torch.core.index import PromishIndex
from repro_torch.core.store import fsync_dir as _fsync_dir
from repro_torch.core.store import (load_dataset, load_index, save_dataset,
                                    save_index)
from repro_torch.core.types import KeywordDataset
from repro_torch.serve.faults import NO_FAULTS, FaultPlan

_FRAME = struct.Struct("<II")          # (payload_len, crc32)


# --------------------------------------------------------------------- arrays
def encode_array(arr: np.ndarray) -> dict:
    """JSON-safe numpy array: dtype string + shape + base64 payload."""
    arr = np.ascontiguousarray(arr)
    return {"__nd__": arr.dtype.str, "shape": list(arr.shape),
            "b64": base64.b64encode(arr.tobytes()).decode("ascii")}


def decode_array(obj: dict) -> np.ndarray:
    raw = base64.b64decode(obj["b64"])
    return np.frombuffer(raw, dtype=np.dtype(obj["__nd__"])) \
        .reshape(obj["shape"]).copy()


# ------------------------------------------------------------------------ WAL
class TornRecordError(ValueError):
    """A WAL record failed its length/CRC check mid-stream (not at the tail)."""


@dataclasses.dataclass
class WalStats:
    appends: int = 0
    bytes: int = 0
    replayed: int = 0
    torn_tail: bool = False     # last replay ended on a torn record
    valid_bytes: int = 0        # byte offset just past the last whole record
    fsyncs: int = 0             # durability barriers actually issued
    group_commits: int = 0      # sync() barriers covering >= 1 deferred record
    group_committed: int = 0    # records made durable by those barriers

    @property
    def group_commit_batch(self) -> float | None:
        """Mean records per group-commit barrier (None before the first)."""
        if not self.group_commits:
            return None
        return self.group_committed / self.group_commits


class WriteAheadLog:
    """Append-only framed record log with fsync-before-ack durability.

    ``faults`` injects the ``wal_ack`` crash point *after* the record is
    durable but before the caller could ack it — in :meth:`append` on the
    per-op path, in :meth:`sync` on the group-commit path (the deferred
    records become durable there). Either way the kill window the recovery
    suite exercises sits between durability and ack.
    """

    def __init__(self, path: str, faults: FaultPlan | None = None):
        self.path = path
        self._faults = faults or NO_FAULTS
        self._f = open(path, "ab")
        self._pending = 0           # records written but not yet fsync'd
        self.stats = WalStats()

    def append(self, record: dict, *, sync: bool = True) -> int:
        """Frame + write one record; make it durable unless ``sync=False``.

        ``sync=False`` is the group-commit half: the record is buffered (and
        flushed to the OS) but the fsync barrier is deferred to the next
        :meth:`sync`. The caller owns the contract that no deferred record is
        acknowledged before that barrier returns.
        """
        payload = json.dumps(record, separators=(",", ":")).encode("utf-8")
        frame = _FRAME.pack(len(payload), zlib.crc32(payload)) + payload
        self._f.write(frame)
        self._f.flush()
        self.stats.appends += 1
        self.stats.bytes += len(frame)
        if sync:
            os.fsync(self._f.fileno())
            self.stats.fsyncs += 1
            # The record is durable from here on; a crash in this window
            # loses the ack but never the write.
            self._faults.check("wal_ack")
        else:
            self._pending += 1
        return len(frame)

    def sync(self) -> int:
        """Group-commit barrier: one fsync covering every deferred append.
        Returns the number of records it made durable (0 = nothing pending,
        no fsync issued)."""
        pending, self._pending = self._pending, 0
        if not pending:
            return 0
        os.fsync(self._f.fileno())
        self.stats.fsyncs += 1
        self.stats.group_commits += 1
        self.stats.group_committed += pending
        # Durable now — same kill-between-durability-and-ack window as the
        # per-op path, covering the whole group's acks at once.
        self._faults.check("wal_ack")
        return pending

    def close(self) -> None:
        if not self._f.closed:
            if self._pending:
                # Defensive: a close with deferred records must not leave
                # them page-cache-only (e.g. snapshot() rolling the segment).
                self.sync()
            self._f.close()

    # ------------------------------------------------------------- replay
    @staticmethod
    def replay(path: str, stats: WalStats | None = None) -> Iterator[dict]:
        """Yield whole records in append order; stop cleanly at a torn tail.

        A short or checksum-mismatched record that is *not* the last one in
        the file raises :class:`TornRecordError` — mid-file corruption is
        data loss of acknowledged writes and must never be silently skipped.
        """
        if not os.path.exists(path):
            return
        with open(path, "rb") as f:
            data = f.read()
        off, n = 0, len(data)
        while off < n:
            if off + _FRAME.size > n:
                if stats is not None:
                    stats.torn_tail = True
                return
            length, crc = _FRAME.unpack_from(data, off)
            payload = data[off + _FRAME.size: off + _FRAME.size + length]
            if len(payload) < length or zlib.crc32(payload) != crc:
                if off + _FRAME.size + length >= n:
                    if stats is not None:
                        stats.torn_tail = True
                    return
                raise TornRecordError(
                    f"corrupt WAL record at byte {off} of {path} "
                    f"(not at tail — acknowledged data is damaged)")
            if stats is not None:
                stats.replayed += 1
            yield json.loads(payload.decode("utf-8"))
            off += _FRAME.size + length
            if stats is not None:
                # Only advanced after the consumer fully processed the
                # record: recovery truncates a torn tail to this offset.
                stats.valid_bytes = off


# ------------------------------------------------------------------ snapshots
def save_snapshot(directory: str, *, dataset: KeywordDataset,
                  index_e: PromishIndex | None,
                  index_a: PromishIndex | None,
                  build_params: dict, engine_meta: dict) -> str:
    """Atomically write a full engine snapshot to ``directory``.

    Write-to-temp + fsync + rename: a crash mid-snapshot can never leave a
    half snapshot that recovery would pick up. ``engine_meta`` carries the
    streaming counters (external-id map, generation, ingest totals) so a
    recovered engine continues the id sequence exactly.
    """
    parent = os.path.dirname(os.path.abspath(directory)) or "."
    os.makedirs(parent, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=".tmp-snap-", dir=parent)
    try:
        manifest: dict = {}
        meta = {
            "format": 1,
            "dataset": save_dataset(tmp, dataset, manifest),
            "index_e": (save_index(tmp, "e", index_e, manifest)
                        if index_e is not None else None),
            "index_a": (save_index(tmp, "a", index_a, manifest)
                        if index_a is not None else None),
            "build_params": build_params,
            "engine": engine_meta,
            "leaves": manifest,
        }
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
            f.flush()
            os.fsync(f.fileno())
        _fsync_dir(tmp)
        if os.path.exists(directory):
            shutil.rmtree(directory)
        os.rename(tmp, directory)
        _fsync_dir(parent)
        return directory
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def load_snapshot(directory: str, *, mmap: bool = False,
                  verify: bool = True) -> dict:
    """Load a snapshot dir -> {dataset, index_e, index_a, build_params,
    engine} (indices None when the engine was built without that flavour)."""
    with open(os.path.join(directory, "meta.json")) as f:
        meta = json.load(f)
    manifest = meta["leaves"]
    out = {
        "dataset": load_dataset(directory, meta["dataset"], manifest,
                                mmap=mmap, verify=verify),
        "index_e": None, "index_a": None,
        "build_params": meta["build_params"],
        "engine": meta["engine"],
    }
    for flavour in ("e", "a"):
        imeta = meta[f"index_{flavour}"]
        if imeta is not None:
            out[f"index_{flavour}"] = load_index(
                directory, flavour, imeta, manifest, mmap=mmap, verify=verify)
    return out


# ----------------------------------------------------------------- WAL roots
def manifest_path(root: str) -> str:
    return os.path.join(root, "MANIFEST.json")


def snap_dir(root: str, epoch: int) -> str:
    return os.path.join(root, f"snap-{epoch:05d}")


def wal_path(root: str, epoch: int) -> str:
    return os.path.join(root, f"wal-{epoch:05d}.log")


def read_manifest(root: str) -> dict:
    with open(manifest_path(root)) as f:
        return json.load(f)


def write_manifest(root: str, epoch: int) -> None:
    """Atomically point the root at ``epoch`` (tmp file + rename)."""
    fd, tmp = tempfile.mkstemp(prefix=".tmp-manifest-", dir=root)
    try:
        with os.fdopen(fd, "w") as f:
            json.dump({"epoch": epoch}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, manifest_path(root))
        _fsync_dir(root)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def gc_epochs(root: str, keep_epoch: int) -> None:
    """Drop snapshot dirs / WAL segments older than ``keep_epoch`` (run
    after the manifest swap; a crash before this leaves stale-but-harmless
    files that the next snapshot sweeps)."""
    for name in os.listdir(root):
        for prefix, strip in (("snap-", len("snap-")),
                              ("wal-", len("wal-"))):
            if name.startswith(prefix):
                try:
                    epoch = int(name[strip:].split(".")[0])
                except ValueError:
                    continue
                if epoch < keep_epoch:
                    full = os.path.join(root, name)
                    if os.path.isdir(full):
                        shutil.rmtree(full, ignore_errors=True)
                    else:
                        os.unlink(full)
