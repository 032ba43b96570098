"""Structured run-metrics sink for the serving loop (DESIGN.md §16).

The runtime already keeps rich in-memory telemetry (controller event lists,
per-job logs, cache stats) but none of it leaves the process until a report
prints at the end. This module adds a wandblog-style *pluggable sink*: the
runtime and the :class:`repro_torch.ft.elastic.ElasticController` emit kind-tagged
metric rows as they happen — pool occupancy, lane utilisation, cache
hit-rate, mutation-apply lag, pending-refresh backlog — and the sink decides
where they go. Locally that is stdout or a JSONL file
(``serve.py --metrics PATH``); a real deployment implements the same
two-method interface against its logging service.

Sinks are **pure observers**: they must never feed back into the event loop
(no draws, no clocks — every row carries the VIRTUAL time of the event that
produced it), so attaching or detaching a sink cannot perturb a replay.
Emission is suppressed during WAL replay by the callers, not here — a
recovered run re-emits nothing it already emitted.

Rows are flat JSON objects ``{"kind": ..., **fields}``, one per line in the
JSONL sink — trivially greppable and loadable with ``json.loads`` per line.

A copy of ``repro.serving.metrics`` (host only).
"""

from __future__ import annotations

import json
import sys
from pathlib import Path
from typing import Any, IO


class MetricsSink:
    """Interface: ``emit`` one kind-tagged row; ``close`` flushes/releases.

    Subclass for a real backend; the no-op default makes ``emit`` safe to
    call unconditionally (``NullSink`` is the detached state).
    """

    def emit(self, kind: str, **fields: Any) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass

    # context-manager sugar so `with open_sink(spec) as m:` cleans up
    def __enter__(self) -> "MetricsSink":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()


class NullSink(MetricsSink):
    """Detached sink: every emit is a no-op (the default everywhere)."""

    def emit(self, kind: str, **fields: Any) -> None:
        pass


class _StreamSink(MetricsSink):
    """One JSON object per line onto a text stream."""

    def __init__(self, stream: IO[str], *, close_stream: bool):
        self._stream = stream
        self._close_stream = close_stream
        self.rows_emitted = 0

    def emit(self, kind: str, **fields: Any) -> None:
        row = {"kind": kind, **fields}
        self._stream.write(json.dumps(row, separators=(",", ":"),
                                      sort_keys=True) + "\n")
        self._stream.flush()
        self.rows_emitted += 1

    def close(self) -> None:
        if self._close_stream:
            self._stream.close()


class StdoutSink(_StreamSink):
    """Metric rows interleaved with normal output (``--metrics -``)."""

    def __init__(self) -> None:
        super().__init__(sys.stdout, close_stream=False)


class JsonlSink(_StreamSink):
    """Append-mode JSONL file sink (``--metrics PATH``). Flushed per row so
    a killed daemon loses at most the in-flight line; parent directories are
    created on open."""

    def __init__(self, path: str | Path):
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        super().__init__(open(p, "a", encoding="utf-8"), close_stream=True)
        self.path = p


def open_sink(spec: str | None) -> MetricsSink:
    """Resolve a ``--metrics`` spec: empty/None -> :class:`NullSink`,
    ``"-"`` -> :class:`StdoutSink`, anything else -> :class:`JsonlSink`
    at that path."""
    if not spec:
        return NullSink()
    if spec == "-":
        return StdoutSink()
    return JsonlSink(spec)
