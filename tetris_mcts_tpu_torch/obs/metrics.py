"""Structured metrics of a self-play run: an append-only JSONL event log
(counterpart of the reference package's `obs/metrics.py` `MetricsWriter`
and `MetricsReader`; its live-state memmaps, `StatusPublisher`, are not
ported).

Event kinds the online driver writes: `episode`, `throughput`,
`train_session`, `benchmark` and `zero_storage_warning`. Every event
carries `t` (wall time), `kind` and `run`, a per-launch attempt id one
above the largest `run` already in the file.
"""

from __future__ import annotations

import json
import math
import os
import time


def _next_run_id(path: str) -> int:
    """One more than the largest `run` in the file at path (1 when the
    file is new)."""
    run = 0
    try:
        with open(path) as f:
            for line in f:
                i = line.find('"run": ')
                if i < 0:
                    continue
                tail = line[i + 7:]
                j = 0
                while j < len(tail) and tail[j].isdigit():
                    j += 1
                if j:
                    run = max(run, int(tail[:j]))
    except OSError:
        pass
    return run + 1


class MetricsWriter:
    """Append-only JSONL event log at `path`. Non-finite floats are
    written as null, so every line stays valid JSON."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.run = _next_run_id(path)
        self._f = open(path, "a", buffering=1)
        self.path = path

    def write(self, kind: str, **fields):
        rec = {"t": time.time(), "kind": kind, "run": self.run}
        for k, v in fields.items():
            if isinstance(v, float) and not math.isfinite(v):
                fields[k] = None
        rec.update(fields)
        self._f.write(json.dumps(rec, allow_nan=False) + "\n")

    def close(self):
        self._f.close()


class MetricsReader:
    """Incremental reader of a MetricsWriter's file."""

    def __init__(self, path: str):
        self.path = path
        self._pos = 0
        self.events: list[dict] = []

    def poll(self) -> list[dict]:
        """The events appended since the last poll."""
        if not os.path.exists(self.path):
            return []
        new = []
        with open(self.path) as f:
            f.seek(self._pos)
            for line in f:
                if not line.endswith("\n"):
                    break  # a partial write; read again at the next poll
                self._pos += len(line)
                try:
                    new.append(json.loads(line))
                except json.JSONDecodeError:
                    continue
        self.events.extend(new)
        return new

    def of_kind(self, kind: str) -> list[dict]:
        return [e for e in self.events if e.get("kind") == kind]
