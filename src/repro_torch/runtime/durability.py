"""Durable tenant state: write-ahead ingest log and surplus snapshots.

Port of ``repro.runtime.durability`` with the same bytes on disk: a store
written by either package restores in the other, and equal appends at
equal clocks give equal WAL segments.  The state machine (per tenant, per
host)::

    admitted ──journal──> journaled ──device──> acked ──interval──> snapshotted

    restart ──> restore (newest intact snapshot) ──> replay (WAL entries
    newer than the snapshot, through the normal ingest path) ──> rejoin

* **Journal at admission.**  ``CTEngine.submit_ingest`` appends the
  payload to the tenant's write-ahead log (seq-numbered by the engine's
  per-tenant ingest watermark, checksummed per record, fsync-batched)
  before the request is queued, so every acked ingest is on disk.  A
  tensor on the card is copied to the host here, on the submitter's
  thread.
* **Snapshot on watermark advance.**  Every ``snapshot_interval`` acked
  ingests the engine snapshots the tenant's served surplus through the
  atomic manifest layout of ``repro_torch.checkpoint`` (per-array crc32
  verified on restore: a torn payload raises ``CheckpointCorrupt`` and the
  loader falls back to the previous intact snapshot).  Snapshots rotate
  the WAL: a fresh segment opens and segments fully covered by the
  snapshot are pruned; snapshots themselves are kept.
* **Restore and replay.**  ``CTEngine.restore(store)`` rebuilds each
  tenant from its newest intact snapshot, then replays the newer WAL
  entries through the normal ingest executable: full-dict ingests are
  last-writer-wins, so the restored surplus is bitwise that of an engine
  that never crashed.
* **Torn tails are tolerated, torn middles are not.**  A record cut short
  at the end of a segment is a crash mid-append (never admitted); a
  checksum mismatch with valid data after it raises ``WALCorrupt``.

Record format: a ``<4sBQqII`` header (magic ``CTWL``, kind, seq, tag — -1
for none —, the payload's crc32, its length), then the payload, an npz of
the grids under the keys ``g_<l0>_<l1>...``.

``RetryPolicy`` (bounded attempts, exponential backoff, jitter from an
explicit RNG) is the retry loop of the engine's ingest commit.  The
store's lock is an ``RLock`` of class ``store``
(``repro_torch.analysis.invariants``), under the engine's: the engine
calls in holding its own lock, the store never calls out.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import re
import shutil
import struct
import time
import zlib
from dataclasses import dataclass, field
from typing import (Any, Callable, Dict, Iterable, List, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from repro_torch.analysis import lockdep as _lockdep
from repro_torch.checkpoint.checkpoint import (CheckpointCorrupt, list_steps,
                                               restore_checkpoint,
                                               save_checkpoint)
from repro_torch.core.levels import (CombinationScheme, GeneralScheme,
                                     SchemeLike)

__all__ = ["DurableStore", "WALEntry", "TenantState", "RetryPolicy",
           "WALError", "WALCorrupt", "WALTorn", "SnapshotCrashed",
           "scheme_to_json", "scheme_from_json"]


class WALError(RuntimeError):
    """Base class of write-ahead-log failures."""


class WALCorrupt(WALError):
    """A WAL record failed its checksum with valid records after it:
    mid-log corruption, not a crash-torn tail.  Replay refuses to skip it
    (a silently wrong state is worse than a loud failure)."""


class WALTorn(WALError):
    """The injected crash-mid-append seam: the record was cut short, the
    admission failed, the ingest was never acknowledged.  Replay tolerates
    the torn tail this leaves behind."""


class SnapshotCrashed(RuntimeError):
    """The injected crash-mid-snapshot seam: the snapshot died after
    writing a partial temp directory but before the atomic ``os.replace``,
    the window the manifest layout makes invisible to restore."""


# ---------------------------------------------------------------------------
# Retry policy
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class RetryPolicy:
    """Bounded retries with exponential backoff and deterministic jitter.

    ``delays(rng)`` yields one delay per attempt (the first is always 0.0:
    the initial try is free); ``run(fn)`` retries ``fn`` on ``retry_on``
    exceptions.  Jitter comes from an explicit numpy RNG, so schedules
    replay exactly."""

    attempts: int = 5
    base_delay_s: float = 0.0
    max_delay_s: float = 0.25
    multiplier: float = 2.0
    jitter: float = 0.5          # +/- fraction of the delay

    def __post_init__(self):
        if self.attempts < 1:
            raise ValueError(f"attempts must be >= 1, got {self.attempts}")

    def delays(self, rng: Optional[np.random.Generator] = None
               ) -> Iterable[float]:
        d = self.base_delay_s
        for attempt in range(self.attempts):
            if attempt == 0:
                yield 0.0
                continue
            delay = min(d, self.max_delay_s)
            if self.jitter and delay > 0:
                r = rng if rng is not None else np.random.default_rng(attempt)
                delay *= 1.0 + self.jitter * (2.0 * float(r.random()) - 1.0)
            yield max(0.0, delay)
            d = d * self.multiplier if d > 0 else self.base_delay_s

    def run(self, fn: Callable[[], Any], *,
            retry_on: Tuple[type, ...] = (Exception,),
            rng: Optional[np.random.Generator] = None,
            sleep: bool = True,
            on_retry: Optional[Callable[[BaseException], None]] = None):
        """Call ``fn`` up to ``attempts`` times; re-raise the last failure.
        ``sleep=False`` retries at once (for callers that must not
        block)."""
        last: Optional[BaseException] = None
        for delay in self.delays(rng):
            if delay > 0 and sleep:
                time.sleep(delay)
            try:
                return fn()
            except retry_on as exc:        # noqa: PERF203
                last = exc
                if on_retry is not None:
                    on_retry(exc)
        assert last is not None
        raise last


# ---------------------------------------------------------------------------
# Scheme (de)serialization
# ---------------------------------------------------------------------------

def scheme_to_json(scheme: SchemeLike) -> Dict[str, Any]:
    """JSON-serializable identity of a combination scheme."""
    if isinstance(scheme, CombinationScheme):
        return {"kind": "combination", "dim": scheme.dim,
                "level": scheme.level}
    if isinstance(scheme, GeneralScheme):
        return {"kind": "general", "dim": scheme.dim,
                "index_set": [list(ell) for ell in scheme.index_set]}
    raise TypeError(f"cannot serialize scheme of type "
                    f"{type(scheme).__name__}")


def scheme_from_json(obj: Dict[str, Any]) -> SchemeLike:
    if obj["kind"] == "combination":
        return CombinationScheme(int(obj["dim"]), int(obj["level"]))
    if obj["kind"] == "general":
        return GeneralScheme(dim=int(obj["dim"]),
                             index_set=tuple(tuple(int(l) for l in ell)
                                             for ell in obj["index_set"]))
    raise ValueError(f"unknown scheme kind {obj.get('kind')!r}")


# ---------------------------------------------------------------------------
# WAL record encoding
# ---------------------------------------------------------------------------

_MAGIC = b"CTWL"
#: magic | kind | seq | tag | payload crc32 | payload length
_HEADER = struct.Struct("<4sBQqII")
_KIND_INGEST = 1


def _host(v) -> np.ndarray:
    """A grid or surplus as a host array.  A tensor is copied, on the CPU
    too: ``.numpy()`` on a tensor marks its storage as not resizable for
    good, which would keep the engine from releasing a donated grid."""
    if isinstance(v, torch.Tensor):
        v = v.detach()
        return (v.clone() if v.device.type == "cpu" else v.cpu()).numpy()
    return np.asarray(v)


def _encode_grids(grids: Dict[Tuple[int, ...], Any]) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **{"g_" + "_".join(str(int(x)) for x in ell): _host(v)
                     for ell, v in grids.items()})
    return buf.getvalue()


def _decode_grids(payload: bytes) -> Dict[Tuple[int, ...], np.ndarray]:
    with np.load(io.BytesIO(payload)) as z:
        return {tuple(int(x) for x in k[2:].split("_")): np.array(z[k])
                for k in z.files}


@dataclass(frozen=True)
class WALEntry:
    """One journaled admitted ingest."""

    seq: int                     # engine per-tenant ingest watermark
    tag: int                     # caller ordering tag; -1 none
    grids: Dict[Tuple[int, ...], np.ndarray]


@dataclass
class TenantState:
    """Everything ``DurableStore.load`` recovered for one tenant."""

    name: str
    scheme: SchemeLike
    full_levels: Optional[Tuple[int, ...]]
    snapshot_seq: int = 0
    snapshot_tag: int = -1
    surplus: Optional[np.ndarray] = None
    entries: List[WALEntry] = field(default_factory=list)
    events: List[str] = field(default_factory=list)
    deadline_ms: Optional[float] = None
    priority: int = 0

    @property
    def max_seq(self) -> int:
        return self.entries[-1].seq if self.entries else self.snapshot_seq

    @property
    def max_tag(self) -> int:
        tags = [e.tag for e in self.entries if e.tag >= 0]
        return max(tags) if tags else self.snapshot_tag


def _tenant_key(name: str) -> str:
    """Filesystem-safe tenant directory name (a readable slug and a short
    stable hash, so distinct names never collide after slugging)."""
    slug = re.sub(r"[^A-Za-z0-9._-]", "_", name)[:48]
    h = hashlib.blake2b(name.encode(), digest_size=4).hexdigest()
    return f"{slug}-{h}"


@dataclass
class _TenantLog:
    """Open-append state of one tenant's WAL (store lock held)."""

    directory: str
    fh: Optional[Any] = None
    path: str = ""
    epoch: int = 0
    appends_since_fsync: int = 0
    seg_max_seq: Dict[str, int] = field(default_factory=dict)


class DurableStore:
    """Per-host durable tenant store: ``<root>/<host_id>/<tenant>/`` with
    ``meta.json`` (scheme identity, atomic via ``os.replace``),
    ``wal-<epoch>.log`` segments, and ``snap/step_<seq>/`` surplus
    snapshots in the ``repro_torch.checkpoint`` manifest layout.

    Thread-safe behind one store lock (a leaf).  ``fsync_every`` batches
    the journal's fsyncs (group commit): every N-th append, and every
    snapshot and rotation, syncs the segment."""

    def __init__(self, root: str, host_id: str = "host", *,
                 fsync_every: int = 8):
        if fsync_every < 1:
            raise ValueError(f"fsync_every must be >= 1, got {fsync_every}")
        self.root = os.path.join(root, host_id)
        self.host_id = host_id
        self.fsync_every = fsync_every
        os.makedirs(self.root, exist_ok=True)
        self._lock = _lockdep.make_rlock("store")
        self._logs: Dict[str, _TenantLog] = {}
        self._counters = {"appends": 0, "fsyncs": 0, "snapshots": 0,
                          "rotations": 0, "replayed": 0,
                          "snapshot_failures": 0}
        self.events: List[str] = []
        # chaos seams (tests): arm the NEXT operation
        self._fail_next_snapshot = False
        self._tear_next_append = False

    # -- construction helpers -----------------------------------------------

    def _dir(self, name: str) -> str:
        return os.path.join(self.root, _tenant_key(name))

    def _log(self, name: str) -> _TenantLog:
        log = self._logs.get(name)
        if log is None:
            log = _TenantLog(directory=self._dir(name))
            os.makedirs(log.directory, exist_ok=True)
            existing = self._segments(log.directory)
            log.epoch = (max(e for e, _ in existing) + 1) if existing else 0
            self._logs[name] = log
        return log

    @staticmethod
    def _segments(directory: str) -> List[Tuple[int, str]]:
        out = []
        if os.path.isdir(directory):
            for fn in os.listdir(directory):
                m = re.fullmatch(r"wal-(\d+)\.log", fn)
                if m:
                    out.append((int(m.group(1)),
                                os.path.join(directory, fn)))
        return sorted(out)

    def _open_segment(self, log: _TenantLog) -> None:
        if log.fh is not None:
            return
        log.path = os.path.join(log.directory, f"wal-{log.epoch:06d}.log")
        log.fh = open(log.path, "ab")

    # -- registration metadata ----------------------------------------------

    def register(self, name: str, scheme: SchemeLike, *,
                 full_levels: Optional[Sequence[int]] = None,
                 deadline_ms: Optional[float] = None,
                 priority: int = 0) -> None:
        """Write or refresh the tenant's ``meta.json`` atomically (at
        engine register and at refit / drop_grid: the scheme identity the
        WAL entries after it are replayed against)."""
        with self._lock:
            d = self._dir(name)
            os.makedirs(d, exist_ok=True)
            meta = {"name": name, "scheme": scheme_to_json(scheme),
                    "full_levels": (None if full_levels is None
                                    else [int(x) for x in full_levels]),
                    "deadline_ms": deadline_ms, "priority": priority}
            tmp = os.path.join(d, ".meta.tmp")
            with open(tmp, "w") as f:
                json.dump(meta, f, indent=1)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, os.path.join(d, "meta.json"))

    def tenants(self) -> Tuple[str, ...]:
        """Names of every tenant with registration metadata on disk."""
        out = []
        for key in sorted(os.listdir(self.root)) \
                if os.path.isdir(self.root) else []:
            mp = os.path.join(self.root, key, "meta.json")
            if os.path.isfile(mp):
                with open(mp) as f:
                    out.append(json.load(f)["name"])
        return tuple(out)

    def discard(self, name: str) -> None:
        """Drop a tenant's durable state (unregister)."""
        with self._lock:
            log = self._logs.pop(name, None)
            if log is not None and log.fh is not None:
                log.fh.close()
            d = self._dir(name)
            if os.path.isdir(d):
                shutil.rmtree(d)

    # -- journal -------------------------------------------------------------

    def append(self, name: str, seq: int, grids, tag: Optional[int] = None
               ) -> None:
        """Journal one admitted ingest (the engine calls this at admission,
        before the request is queued).  Raises ``WALTorn`` from the
        injected crash-mid-append seam: the caller must then fail the
        admission, as a real crash would have."""
        payload = _encode_grids(grids)
        header = _HEADER.pack(_MAGIC, _KIND_INGEST, int(seq),
                              -1 if tag is None else int(tag),
                              zlib.crc32(payload), len(payload))
        with self._lock:
            log = self._log(name)
            self._open_segment(log)
            if self._tear_next_append:
                self._tear_next_append = False
                log.fh.write(header + payload[:max(0, len(payload) // 2)])
                log.fh.flush()
                # a real crash kills the writer and the restarted process
                # opens a fresh epoch, leaving the torn record as a
                # tolerated tail: roll the segment so later appends through
                # this instance do not bury the tear mid-log
                log.fh.close()
                log.fh = None
                log.epoch += 1
                log.appends_since_fsync = 0
                self.events.append(f"{name}: torn WAL append at seq {seq}")
                raise WALTorn(
                    f"store[{self.host_id}]: WAL append for tenant "
                    f"{name!r} seq {seq} was torn mid-record (injected "
                    f"crash) — the ingest was NOT admitted")
            log.fh.write(header + payload)
            log.fh.flush()
            log.seg_max_seq[log.path] = int(seq)
            log.appends_since_fsync += 1
            self._counters["appends"] += 1
            if log.appends_since_fsync >= self.fsync_every:
                os.fsync(log.fh.fileno())
                log.appends_since_fsync = 0
                self._counters["fsyncs"] += 1

    def flush(self, name: Optional[str] = None) -> None:
        """Force-fsync open segments (every tenant's when ``name=None``)."""
        with self._lock:
            for n, log in self._logs.items():
                if name is not None and n != name:
                    continue
                if log.fh is not None:
                    log.fh.flush()
                    os.fsync(log.fh.fileno())
                    log.appends_since_fsync = 0
                    self._counters["fsyncs"] += 1

    # -- snapshots -----------------------------------------------------------

    def snapshot(self, name: str, seq: int, surplus, *,
                 tag: Optional[int] = None,
                 scheme: Optional[SchemeLike] = None,
                 full_levels: Optional[Sequence[int]] = None) -> str:
        """Atomic surplus snapshot at watermark ``seq`` (the checkpoint
        manifest layout, per-array crc32 included), then rotate the WAL: a
        fresh segment opens and every closed segment fully covered by
        ``seq`` is pruned.  A surplus on the card is copied to the host."""
        with self._lock:
            log = self._log(name)
            snap_dir = os.path.join(log.directory, "snap")
            if self._fail_next_snapshot:
                self._fail_next_snapshot = False
                self._counters["snapshot_failures"] += 1
                # die after partial temp state exists but before the
                # atomic rename: the window restore must never see
                tmp = os.path.join(snap_dir, f".tmp.{int(seq)}")
                os.makedirs(tmp, exist_ok=True)
                with open(os.path.join(tmp, "arrays.npz"), "wb") as f:
                    f.write(b"partial snapshot payload")
                self.events.append(f"{name}: snapshot at seq {seq} "
                                   f"crashed mid-write (injected)")
                raise SnapshotCrashed(
                    f"store[{self.host_id}]: snapshot for tenant {name!r} "
                    f"at seq {seq} crashed before the atomic rename "
                    f"(injected)")
            meta: Dict[str, Any] = {
                "name": name, "seq": int(seq),
                "tag": -1 if tag is None else int(tag)}
            if scheme is not None:
                meta["scheme"] = scheme_to_json(scheme)
            if full_levels is not None:
                meta["full_levels"] = [int(x) for x in full_levels]
            path = save_checkpoint(snap_dir, int(seq),
                                   {"surplus": _host(surplus)},
                                   metadata=meta)
            self._counters["snapshots"] += 1
            # rotate: a new segment; prune segments fully <= seq
            if log.fh is not None:
                os.fsync(log.fh.fileno())
                log.fh.close()
                log.fh = None
                self._counters["fsyncs"] += 1
            log.epoch += 1
            self._counters["rotations"] += 1
            for seg_path, seg_max in list(log.seg_max_seq.items()):
                if seg_max <= int(seq) and os.path.exists(seg_path):
                    os.remove(seg_path)
                    del log.seg_max_seq[seg_path]
            return path

    # -- restore -------------------------------------------------------------

    def load(self, name: str) -> TenantState:
        """Recover one tenant: the newest intact snapshot (corrupt ones are
        skipped with an event, falling back to older snapshots or to
        WAL-only replay) and every WAL entry newer than it, in seq order.
        Torn segment tails are tolerated; mid-log corruption raises
        ``WALCorrupt``."""
        d = self._dir(name)
        meta_path = os.path.join(d, "meta.json")
        if not os.path.isfile(meta_path):
            raise KeyError(f"store[{self.host_id}]: no durable state for "
                           f"tenant {name!r}")
        with open(meta_path) as f:
            meta = json.load(f)
        state = TenantState(
            name=name, scheme=scheme_from_json(meta["scheme"]),
            full_levels=(None if meta.get("full_levels") is None
                         else tuple(meta["full_levels"])),
            deadline_ms=meta.get("deadline_ms"),
            priority=int(meta.get("priority") or 0))
        snap_dir = os.path.join(d, "snap")
        for step in sorted(list_steps(snap_dir), reverse=True):
            try:
                tree, smeta = restore_checkpoint(snap_dir, step)
            except (CheckpointCorrupt, OSError, KeyError, ValueError) as e:
                state.events.append(
                    f"snapshot step {step} unreadable ({e!r}); falling "
                    f"back to the previous snapshot / WAL-only replay")
                continue
            state.surplus = tree["surplus"]
            state.snapshot_seq = int(smeta.get("seq", step))
            state.snapshot_tag = int(smeta.get("tag", -1))
            if smeta.get("scheme") is not None:
                state.scheme = scheme_from_json(smeta["scheme"])
            if smeta.get("full_levels") is not None:
                state.full_levels = tuple(smeta["full_levels"])
            break
        entries: List[WALEntry] = []
        for _, seg_path in self._segments(d):
            entries.extend(self._read_segment(seg_path, state.events))
        entries.sort(key=lambda e: e.seq)
        state.entries = [e for e in entries if e.seq > state.snapshot_seq]
        return state

    def _read_segment(self, path: str,
                      events: List[str]) -> List[WALEntry]:
        out: List[WALEntry] = []
        with open(path, "rb") as f:
            data = f.read()
        off, n = 0, len(data)
        while off < n:
            if off + _HEADER.size > n:
                events.append(f"{os.path.basename(path)}: torn header at "
                              f"byte {off} (tolerated tail)")
                break
            magic, kind, seq, tag, crc, length = _HEADER.unpack_from(
                data, off)
            body = data[off + _HEADER.size: off + _HEADER.size + length]
            if magic != _MAGIC:
                raise WALCorrupt(
                    f"{path}: bad record magic at byte {off}")
            if len(body) < length:
                events.append(f"{os.path.basename(path)}: torn record "
                              f"seq {seq} at byte {off} (tolerated tail)")
                break
            if zlib.crc32(body) != crc:
                raise WALCorrupt(
                    f"{path}: checksum mismatch on record seq {seq} at "
                    f"byte {off} — mid-log corruption, refusing to "
                    f"replay past it")
            if kind == _KIND_INGEST:
                out.append(WALEntry(seq=int(seq), tag=int(tag),
                                    grids=_decode_grids(body)))
            off += _HEADER.size + length
        return out

    def pending_after(self, name: str, tag: int) -> List[WALEntry]:
        """WAL entries journaled with ``entry.tag > tag``, in seq order: the
        admitted ingests a failover must replay onto the new owner.  Reads
        through the open segment (flushed on every append).

        Only the WAL segments are read.  The reference goes through
        ``load``, which also reads and verifies the newest snapshot
        (1.07 GB at ``prod_3d``, seconds, under the cluster's lock) only to
        drop the entries it covers; a snapshot is taken after its seq's
        ack, so what it covers the cluster has committed, and an entry it
        covers that is still in flight is replayed rather than lost."""
        d = self._dir(name)
        if not os.path.isfile(os.path.join(d, "meta.json")):
            return []
        events: List[str] = []
        entries: List[WALEntry] = []
        for _, seg_path in self._segments(d):
            entries.extend(self._read_segment(seg_path, events))
        entries.sort(key=lambda e: e.seq)
        return [e for e in entries if e.tag > tag]

    # -- chaos seams / accounting -------------------------------------------

    def fail_next_snapshot(self) -> None:
        """Arm the crash-mid-snapshot seam (one shot, any tenant)."""
        with self._lock:
            self._fail_next_snapshot = True

    def tear_next_append(self) -> None:
        """Arm the torn-WAL-record seam (one shot, any tenant)."""
        with self._lock:
            self._tear_next_append = True

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {"host_id": self.host_id, "root": self.root,
                    **{k: int(v) for k, v in self._counters.items()},
                    "events": list(self.events)}

    def close(self) -> None:
        with self._lock:
            for log in self._logs.values():
                if log.fh is not None:
                    log.fh.flush()
                    os.fsync(log.fh.fileno())
                    log.fh.close()
                    log.fh = None
