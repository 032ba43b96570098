"""Write-ahead event log + snapshot packing for the serving runtime
(DESIGN.md §12).

The serving loop is virtual-time and fully seeded, so its entire execution
is a *deterministic function of its inputs*: the config/pool/cache shape,
the submitted jobs, the injected failure/slowdown schedules, and the seeded
mutation stream. The WAL records exactly those inputs (``init``/``submit``/
``inject``/``slowdown``/``mutations`` records), plus one ``event`` record
per processed heap event — so recovery
is deterministic *re-execution*: rebuild the runtime from the inputs,
replay to the crash position, and verify every replayed event against the
log (a divergence means the replay is not the run that crashed, and raises
rather than silently serving different answers).

Periodic ``snapshot`` records point at full-state checkpoints written
through :mod:`repro_torch.checkpoint.store` (atomic tmp-rename) — the compaction
points replay starts from instead of event 0. :func:`pack_state` turns the
runtime's nested state dict into the flat leaf list the store consumes:
numpy arrays become leaves, everything else rides in a JSON blob leaf
(Python's shortest-round-trip float repr keeps the virtual clock and all
statistics bit-exact through the trip).

Records are JSONL, one per line, versioned (``v``), fsync'd by default so
an acknowledged append survives the process. Reads are
truncation-tolerant: a torn *tail* line (writer killed mid-append) is
dropped; a torn line in the middle of the file is corruption and raises.

A copy of ``repro.serving.wal`` (host only).
"""

from __future__ import annotations

import json
import os
import shutil
from dataclasses import dataclass
from pathlib import Path
from typing import Any

import numpy as np

WAL_VERSION = 1
WAL_FILE = "events.wal"
SNAP_SUBDIR = "snapshots"


class WriteAheadLog:
    """Append-only fsync'd JSONL record log under ``wal_dir``."""

    def __init__(self, wal_dir: str | Path, *, fsync: bool = True):
        self.dir = Path(wal_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.fsync = fsync
        self._f = open(self.path, "a", encoding="utf-8")

    @property
    def path(self) -> Path:
        return self.dir / WAL_FILE

    @property
    def snapshot_dir(self) -> Path:
        return self.dir / SNAP_SUBDIR

    def append(self, record: dict) -> None:
        """Write one record; returns only after flush (+fsync by default),
        so an acknowledged append is durable at the crash points the chaos
        harness exercises."""
        rec = dict(record)
        rec.setdefault("v", WAL_VERSION)
        self._f.write(json.dumps(rec, separators=(",", ":")) + "\n")
        self._f.flush()
        if self.fsync:
            os.fsync(self._f.fileno())

    def close(self) -> None:
        self._f.close()

    def compact(self, keep: int = 1) -> dict:
        """Truncate the log prefix covered by retained snapshots and delete
        superseded snapshot directories.

        Retains the newest ``keep`` *restorable* snapshots (manifest present
        on disk); the oldest retained step becomes the cover point: event
        records at or before it are dropped, input records (init/submit/
        inject/slowdown/mutations) are always kept (recovery rebuilds the
        runtime from them), and a ``compact`` marker records how far the prefix was
        truncated so recovery can refuse a replay-from-zero it can no longer
        perform. The rewrite is atomic (tmp + rename, same as checkpoint
        dirs); snapshot directories are deleted only *after* the shortened
        log is durable, so a crash mid-compaction leaves either the old log
        with all snapshots or the new log with at worst orphan snapshot
        dirs (removed by the next compaction).

        Returns ``{"covered", "dropped_events", "dropped_snapshots"}``.
        """
        records = self.read(self.dir)
        restorable: list[int] = []
        for r in records:
            if r["type"] == "snapshot":
                step = int(r["step"])
                if step not in restorable and \
                        (self.snapshot_dir / f"step_{step:08d}" /
                         "manifest.json").exists():
                    restorable.append(step)
        stats = {"covered": 0, "dropped_events": 0, "dropped_snapshots": 0}
        if keep < 1 or not restorable:
            return stats
        retained = sorted(restorable)[-keep:]
        cutoff = retained[0]
        prior = max((int(r.get("covered", 0)) for r in records
                     if r["type"] == "compact"), default=0)
        covered = max(cutoff, prior)
        # file position of the cover-point snapshot record: note/recover
        # records before it describe the dropped prefix and go with it
        cut_pos = next(i for i, r in enumerate(records)
                       if r["type"] == "snapshot"
                       and int(r["step"]) == cutoff)
        kept: list[dict] = []
        for i, r in enumerate(records):
            t = r["type"]
            if t == "init":
                kept.append(r)
                kept.append({"type": "compact", "covered": covered,
                             "v": WAL_VERSION})
            elif t == "compact":
                continue                      # superseded by the new marker
            elif t in ("submit", "inject", "slowdown", "mutations"):
                kept.append(r)
            elif t == "snapshot":
                if int(r["step"]) in retained:
                    kept.append(r)
                else:
                    stats["dropped_snapshots"] += 1
            elif t == "event":
                if int(r["n"]) > covered:
                    kept.append(r)
                else:
                    stats["dropped_events"] += 1
            elif i > cut_pos:
                kept.append(r)                # note/recover past the cover
        stats["covered"] = covered
        tmp = self.dir / (WAL_FILE + ".tmp")
        with open(tmp, "w", encoding="utf-8") as f:
            for r in kept:
                f.write(json.dumps(r, separators=(",", ":")) + "\n")
            f.flush()
            os.fsync(f.fileno())
        self._f.close()
        os.replace(tmp, self.path)
        dir_fd = os.open(self.dir, os.O_RDONLY)
        try:
            os.fsync(dir_fd)
        finally:
            os.close(dir_fd)
        self._f = open(self.path, "a", encoding="utf-8")
        # snapshots not retained are now unreferenced — including any the
        # checkpoint store's own keep-GC would have aged out later
        if self.snapshot_dir.is_dir():
            for d in sorted(self.snapshot_dir.glob("step_*")):
                if int(d.name.split("_")[1]) not in retained:
                    shutil.rmtree(d, ignore_errors=True)
        return stats

    @staticmethod
    def read(wal_dir: str | Path) -> list[dict]:
        """All records in file order. A torn tail line is dropped (killed
        writer mid-append); torn records elsewhere raise ValueError."""
        p = Path(wal_dir) / WAL_FILE
        if not p.exists():
            return []
        lines = p.read_text(encoding="utf-8").split("\n")
        records: list[dict] = []
        for i, line in enumerate(lines):
            if not line.strip():
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                if not any(rest.strip() for rest in lines[i + 1:]):
                    break                      # torn tail: tolerated
                raise ValueError(
                    f"corrupt WAL record at {p}:{i + 1}") from e
            if rec.get("v") != WAL_VERSION:
                raise ValueError(f"unsupported WAL record version "
                                 f"{rec.get('v')!r} at {p}:{i + 1}")
            records.append(rec)
        return records


@dataclass(frozen=True)
class RecoveryInfo:
    """What :meth:`ServingRuntime.recover` reconstructed: the snapshot it
    resumed from (None = replay from event 0) and how much of the logged
    event stream is replayed before execution goes live again."""

    snapshot_step: int | None
    replayed_events: int
    logged_events: int


# -- snapshot packing --------------------------------------------------------
def pack_state(state: dict) -> list[np.ndarray]:
    """Nested state dict -> flat leaf list for ``checkpoint.store.save``:
    leaf 0 is the JSON blob (uint8) with ``{"__nd__": i}`` placeholders,
    leaves 1.. are the numpy arrays the placeholders index."""
    arrays: list[np.ndarray] = []
    blob = json.dumps(_encode(state, arrays)).encode("utf-8")
    return [np.frombuffer(blob, dtype=np.uint8)] + arrays


def unpack_state(leaves: list[np.ndarray]) -> dict:
    """Inverse of :func:`pack_state` over ``store.restore_list`` leaves."""
    blob = np.ascontiguousarray(np.asarray(leaves[0], dtype=np.uint8))
    return _decode(json.loads(blob.tobytes().decode("utf-8")), leaves[1:])


def _encode(obj: Any, arrays: list[np.ndarray]) -> Any:
    if isinstance(obj, np.ndarray):
        arrays.append(np.asarray(obj))
        return {"__nd__": len(arrays) - 1}
    if isinstance(obj, dict):
        out = {}
        for k, v in obj.items():
            if not isinstance(k, str):
                raise TypeError(f"state dict keys must be str, got {k!r} "
                                "(encode int-keyed maps as pair lists)")
            out[k] = _encode(v, arrays)
        return out
    if isinstance(obj, (list, tuple)):
        return [_encode(v, arrays) for v in obj]
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    return obj


def _decode(obj: Any, arrays: Any) -> Any:
    if isinstance(obj, dict):
        if set(obj) == {"__nd__"}:
            return np.asarray(arrays[obj["__nd__"]])
        return {k: _decode(v, arrays) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_decode(v, arrays) for v in obj]
    return obj
