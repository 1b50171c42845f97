"""Structured metrics of a self-play run (counterpart of the reference
package's `obs/metrics.py`): an append-only JSONL event log
(`MetricsWriter`, `MetricsReader`) and the live-state memmaps
(`StatusPublisher`, `StatusReader`).

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
from typing import Optional

import numpy as np


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


# the live-state files: name -> (dtype, shape for a batch of B games); the
# reference's layout, so a reader of either package reads the other's
_STATUS_FILES = {
    "board": (np.int8, lambda b: (20, 10)),
    "combo": (np.int32, lambda b: (b,)),
    "score": (np.int64, lambda b: (b,)),
    "lines": (np.int32, lambda b: (b,)),
    "line_stats": (np.int32, lambda b: (b, 4)),
}


class StatusPublisher:
    """Live-state memmaps in `tmp_dir`: game 0's board and every game's
    combo, score, lines and line_stats, rewritten and flushed on every
    `publish`."""

    def __init__(self, tmp_dir: str = "./tmp", batch: int = 1):
        os.makedirs(tmp_dir, exist_ok=True)
        self.batch = batch
        self._m = {name: np.memmap(os.path.join(tmp_dir, name), dt, "w+", shape=shape(batch))
                   for name, (dt, shape) in _STATUS_FILES.items()}

    def publish(self, board0, combo, score, lines, line_stats):
        for name, x in (("board", board0), ("combo", combo), ("score", score),
                        ("lines", lines), ("line_stats", line_stats)):
            self._m[name][:] = np.asarray(x, _STATUS_FILES[name][0])
        for m in self._m.values():
            m.flush()


class StatusReader:
    """A poller of a StatusPublisher's files; `read` gives None while they
    are missing or short."""

    def __init__(self, tmp_dir: str = "./tmp", batch: int = 1):
        self.tmp_dir = tmp_dir
        self.batch = batch

    def read(self) -> Optional[dict]:
        try:
            return {name: np.array(np.memmap(os.path.join(self.tmp_dir, name), dt, "r",
                                             shape=shape(self.batch)))
                    for name, (dt, shape) in _STATUS_FILES.items()}
        except (FileNotFoundError, ValueError):
            return None
