"""Structured run traces: spans, JSONL event log, Chrome-trace export.

The flight recorder wraps the engine's HOST-side phases -- warmup,
execute, host-side slicing -- in :func:`span` context managers.  Each
completed span becomes one event dict with the Chrome ``trace_event``
keys (``name``, ``cat``, ``ph``, ``ts``, ``dur``, ``pid``, ``tid``,
``args``), so the JSONL log is the structured schema and, wrapped in
``{"traceEvents": [...]}``, a file Perfetto opens as it is.  Timestamps
are microseconds on the recorder's monotonic clock; the wall-clock
epoch rides a metadata event.

Recording is per call, never per tick, and adds no device
synchronisation: the engine's results are the same bit for bit with
the recorder on or off.  A configured JSONL path is written through
event by event, so a process killed mid-run leaves whole lines.

The recorder reads no environment variable: ``enabled`` and
``profile`` are arguments of :class:`Recorder` and :func:`configure`.
``profile=True`` also opens a ``torch.profiler.record_function`` range
around every span, so spans line up with a ``torch.profiler`` trace.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from pathlib import Path
from typing import Iterator, List, Optional

SCHEMA_VERSION = 1

# the event keys a valid trace carries; everything else is optional
REQUIRED_KEYS = ("name", "cat", "ph", "ts", "pid", "tid")
PHASES = ("X", "i", "M")  # complete span, instant, metadata


class Recorder:
    """Append-only span recorder with an optional JSONL write-through
    sink.  One process-global instance (:data:`RECORDER`) serves the
    engine; tests build private ones."""

    def __init__(self, enabled: bool = True, profile: bool = False):
        self._lock = threading.Lock()
        self.events: List[dict] = []
        self.path: Optional[Path] = None
        self.enabled = enabled
        self.profile = profile
        self._epoch_perf = time.perf_counter()
        self._epoch_wall = time.time()

    # -- configuration ----------------------------------------------------
    def configure(
        self,
        path=None,
        enabled: Optional[bool] = None,
        profile: Optional[bool] = None,
        fresh: bool = False,
    ) -> None:
        """Point the recorder at a JSONL sink (and optionally reset).

        ``fresh=True`` clears buffered events and truncates the sink:
        one trace file per artifact."""
        with self._lock:
            if enabled is not None:
                self.enabled = enabled
            if profile is not None:
                self.profile = profile
            if fresh:
                self.events.clear()
                self._epoch_perf = time.perf_counter()
                self._epoch_wall = time.time()
            if path is not None:
                self.path = Path(path)
                self.path.parent.mkdir(parents=True, exist_ok=True)
                if fresh or not self.path.exists():
                    self.path.write_text("")
        if self.enabled:
            self._record(self._meta_event())

    def _meta_event(self) -> dict:
        return {
            "v": SCHEMA_VERSION,
            "name": "recorder",
            "cat": "meta",
            "ph": "M",
            "ts": 0.0,
            "pid": os.getpid(),
            "tid": threading.get_ident() & 0xFFFF,
            "args": {
                "epoch_unix": round(self._epoch_wall, 6),
                "schema": SCHEMA_VERSION,
            },
        }

    # -- event emission ---------------------------------------------------
    def _now_us(self) -> float:
        return (time.perf_counter() - self._epoch_perf) * 1e6

    def _record(self, ev: dict) -> None:
        with self._lock:
            self.events.append(ev)
            if self.path is not None:
                with self.path.open("a") as f:
                    f.write(json.dumps(ev) + "\n")

    @contextlib.contextmanager
    def span(self, name: str, cat: str = "phase", **args) -> Iterator[dict]:
        """Record one complete (``ph="X"``) event around a code block.

        ``cat`` buckets the phase (``warmup`` / ``execute`` / ``host``);
        keyword args land in the event's ``args`` and must be
        JSON-serializable.  Yields the args dict, which the block may
        extend with facts known only afterwards.  A span left by an
        exception is still recorded, with the exception's type in
        ``args.error``."""
        args = dict(args)
        if not self.enabled:
            yield args
            return
        ctx = contextlib.nullcontext()
        if self.profile:
            import torch

            ctx = torch.profiler.record_function(name)
        t0 = self._now_us()
        err = None
        try:
            with ctx:
                yield args
        except BaseException as e:
            err = type(e).__name__
            raise
        finally:
            t1 = self._now_us()
            if err is not None:
                args["error"] = err
            self._record(
                {
                    "v": SCHEMA_VERSION,
                    "name": name,
                    "cat": cat,
                    "ph": "X",
                    "ts": round(t0, 3),
                    "dur": round(t1 - t0, 3),
                    "pid": os.getpid(),
                    "tid": threading.get_ident() & 0xFFFF,
                    "args": args,
                }
            )

    def instant(self, name: str, cat: str = "mark", **args) -> None:
        """Record one instantaneous (``ph="i"``) event."""
        if not self.enabled:
            return
        self._record(
            {
                "v": SCHEMA_VERSION,
                "name": name,
                "cat": cat,
                "ph": "i",
                "ts": round(self._now_us(), 3),
                "s": "p",
                "pid": os.getpid(),
                "tid": threading.get_ident() & 0xFFFF,
                "args": args,
            }
        )

    # -- export -----------------------------------------------------------
    def write_chrome(self, path) -> Path:
        """Write the buffered events as one Chrome-trace JSON document
        (``{"traceEvents": [...]}``) that Perfetto opens directly."""
        path = Path(path)
        with self._lock:
            doc = {
                "traceEvents": list(self.events),
                "displayTimeUnit": "ms",
            }
        path.write_text(json.dumps(doc))
        return path


# The process-global recorder the engine shares.
RECORDER = Recorder()


def configure(**kw) -> None:
    RECORDER.configure(**kw)


def span(name: str, cat: str = "phase", **args):
    return RECORDER.span(name, cat=cat, **args)


def instant(name: str, cat: str = "mark", **args) -> None:
    RECORDER.instant(name, cat=cat, **args)


# ---------------------------------------------------------------------------
# Reading and validation
# ---------------------------------------------------------------------------


def read_trace(path) -> List[dict]:
    """Parse a JSONL trace.  A torn FINAL line (the process was killed
    mid-write) is dropped; a malformed line anywhere else raises
    ``ValueError``."""
    lines = Path(path).read_text().splitlines()
    events = []
    for i, line in enumerate(lines):
        if not line.strip():
            continue
        try:
            events.append(json.loads(line))
        except json.JSONDecodeError:
            if i == len(lines) - 1:
                break  # torn final line: drop it
            raise ValueError(
                f"{path}: malformed JSONL at line {i + 1}"
            ) from None
    return events


def validate_events(events: List[dict]) -> List[str]:
    """Schema problems in a parsed event list (empty list = valid)."""
    problems = []
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            problems.append(f"event {i}: not an object")
            continue
        missing = [k for k in REQUIRED_KEYS if k not in ev]
        if missing:
            problems.append(f"event {i}: missing keys {', '.join(missing)}")
            continue
        if ev["ph"] not in PHASES:
            problems.append(f"event {i}: unknown phase {ev['ph']!r}")
        if not isinstance(ev["ts"], (int, float)) or ev["ts"] < 0:
            problems.append(f"event {i}: bad ts {ev['ts']!r}")
        if ev["ph"] == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(f"event {i}: bad dur {dur!r}")
    return problems
