"""Stall watchdog for long self-play runs (counterpart of the reference
package's `runtime/watchdog.py`, without its tunnel-socket check, which
watches a remote TPU's connection that a local card does not have).

A process blocked inside a device call cannot unblock itself, so the
recovery unit is the process: a monitor thread watches a heartbeat that
the host loop touches on every move and every log line, and when nothing
advances for `stall_timeout` seconds it logs a diagnostic and hard-exits
with `EXIT_CODE` (86), so a supervisor can relaunch from the last
checkpoint.

Known long but healthy silences (the first move's kernel build and
autotune, a training session, the benchmark twin's first move) are
covered by a grace state: the heartbeat starts in one that allows
`startup_timeout`, and `grace()` re-arms a one-shot window of that length
until the next beat.

`os._exit`, not `sys.exit`: the blocked thread may hold locks that would
deadlock the interpreter's teardown. The metrics JSONL is line-buffered
and an online run checkpoints after every session, so a hard exit loses at
most the episodes since the last session.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Callable, Optional

EXIT_CODE = 86  # distinct from timeout(1)'s 124 and SIGTERM's 143

_active: Optional["StallWatchdog"] = None


def get_active() -> Optional["StallWatchdog"]:
    return _active


def install(wd: Optional["StallWatchdog"]):
    """Register the process-wide watchdog that the self-play drivers beat."""
    global _active
    _active = wd
    return wd


class StallWatchdog:
    """Monitor thread: hard-exit (or call `on_stall`) when the heartbeat
    stops advancing.

    beat()   -- the host loop made progress (a move finished, a log line).
    grace(s) -- a known long silence starts: allow up to `s` seconds
                (default startup_timeout) until the next beat, then fall
                back to stall_timeout.
    """

    def __init__(self, stall_timeout: float, startup_timeout: float = 0.0,
                 log: Callable[[str], None] = lambda s: print(s, file=sys.stderr, flush=True),
                 on_stall: Optional[Callable[[], None]] = None, poll_s: float = 5.0):
        self.stall_timeout = float(stall_timeout)
        self.startup_timeout = float(startup_timeout or stall_timeout)
        self.log = log
        self.on_stall = on_stall
        self.poll_s = poll_s
        self._lock = threading.Lock()
        self._last = time.monotonic()
        self._allow = self.startup_timeout  # the first beat ends the startup
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.fired = False

    # ------------------------------------------------------------ heartbeat
    def beat(self):
        with self._lock:
            self._last = time.monotonic()
            self._allow = self.stall_timeout

    def grace(self, seconds: float = 0.0):
        with self._lock:
            self._last = time.monotonic()
            self._allow = max(seconds or self.startup_timeout, self.stall_timeout)

    def wrap_log(self, log: Callable[[str], None]):
        """A log function that beats: every episode, throughput and
        validation line is proof that the host loop is alive."""
        def beat_log(s):
            self.beat()
            log(s)
        return beat_log

    # -------------------------------------------------------------- monitor
    def start(self):
        self._thread = threading.Thread(target=self._run, name="stall-watchdog", daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()

    def _run(self):
        while not self._stop.wait(self.poll_s):
            with self._lock:
                gap = time.monotonic() - self._last
                allow = self._allow
            if gap <= allow:
                continue
            self.fired = True
            try:
                self.log(f"STALL WATCHDOG: no progress for {gap:.0f}s (limit {allow:.0f}s) "
                         f"-- assuming a blocked device call; exiting {EXIT_CODE} so a "
                         "supervisor relaunches from the last checkpoint")
            except Exception:  # noqa: BLE001 -- exit anyway
                pass
            if self.on_stall is not None:
                self.on_stall()
                return
            os._exit(EXIT_CODE)
