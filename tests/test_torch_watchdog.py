"""The port's stall watchdog (`runtime/watchdog.py`) against the JAX
package's, on the cases of tests/test_watchdog.py but its three
tunnel-socket ones (the port has no tunnel check): each behaviour case
runs on both packages' watchdogs with the same timings. A hang in a
subprocess exits with code 86, and the port's self-play driver beats an
installed watchdog on every move and gives it a grace window at a
training session and before the benchmark twin's first move."""

import pathlib
import subprocess
import sys
import threading
import time

import pytest
import torch

from tetris_mcts_tpu.runtime import watchdog as jax_watchdog
from tetris_mcts_tpu_torch.runtime import watchdog

torch.set_num_threads(1)

MODULES = {"port": watchdog, "jax": jax_watchdog}


def _make(mod, stall, startup=None):
    fired = threading.Event()
    wd = mod.StallWatchdog(stall_timeout=stall, startup_timeout=startup or stall,
                           on_stall=fired.set, poll_s=0.05, log=lambda s: None).start()
    return wd, fired


@pytest.mark.parametrize("pkg", MODULES)
def test_fires_on_stall(pkg):
    wd, fired = _make(MODULES[pkg], 0.2)
    assert fired.wait(2.0)
    assert wd.fired


@pytest.mark.parametrize("pkg", MODULES)
def test_beats_keep_it_quiet_then_stall_fires(pkg):
    wd, fired = _make(MODULES[pkg], 0.4)
    for _ in range(8):
        wd.beat()
        time.sleep(0.1)
    assert not fired.is_set()  # 0.8 s, never more than 0.4 s between beats
    assert fired.wait(2.0)


@pytest.mark.parametrize("pkg", MODULES)
def test_startup_allowance_exceeds_stall_timeout(pkg):
    wd, fired = _make(MODULES[pkg], 0.2, startup=1.0)
    time.sleep(0.5)
    assert not fired.is_set()
    wd.beat()  # the startup is over; stall_timeout governs
    assert fired.wait(2.0)


@pytest.mark.parametrize("pkg", MODULES)
def test_grace_rearms_a_long_window(pkg):
    wd, fired = _make(MODULES[pkg], 0.2, startup=1.0)
    wd.beat()
    time.sleep(0.1)
    wd.grace()
    time.sleep(0.5)
    assert not fired.is_set()
    assert fired.wait(2.0)  # one window a grace


@pytest.mark.parametrize("pkg", MODULES)
def test_wrapped_log_beats(pkg):
    wd, fired = _make(MODULES[pkg], 0.3)
    lines = []
    log = wd.wrap_log(lines.append)
    for _ in range(6):
        log("progress")
        time.sleep(0.1)
    assert not fired.is_set()
    assert lines == ["progress"] * 6
    wd.stop()


@pytest.mark.parametrize("pkg", MODULES)
def test_stop_disarms(pkg):
    wd, fired = _make(MODULES[pkg], 0.2)
    wd.stop()
    assert not fired.wait(0.6)


def test_install_and_get_active():
    assert watchdog.get_active() is None
    wd = watchdog.StallWatchdog(stall_timeout=60)
    assert watchdog.install(wd) is wd and watchdog.get_active() is wd
    watchdog.install(None)
    assert watchdog.get_active() is None


_HANG_SCRIPT = """
import sys, time
sys.path.insert(0, {repo!r})
from tetris_mcts_tpu_torch.runtime import watchdog
watchdog.install(watchdog.StallWatchdog(
    stall_timeout=1.0, poll_s=0.1, log=lambda s: print(s, file=sys.stderr),
)).start()
print("armed", flush=True)
time.sleep(60)   # the injected hang: a blocked device call
print("never reached", flush=True)
"""


def test_injected_hang_exits_process_with_code_86():
    repo = str(pathlib.Path(__file__).resolve().parent.parent)
    t0 = time.time()
    proc = subprocess.run([sys.executable, "-c", _HANG_SCRIPT.format(repo=repo)],
                          capture_output=True, text=True, timeout=30)
    assert proc.returncode == watchdog.EXIT_CODE == jax_watchdog.EXIT_CODE == 86
    assert time.time() - t0 < 20
    assert "STALL WATCHDOG" in proc.stderr and "armed" in proc.stdout
    assert "never reached" not in proc.stdout


class RecordingWatchdog:
    """Stands in for an installed watchdog: records beats and graces, and
    the log lines that follow them."""

    def __init__(self):
        self.events = []

    def beat(self):
        self.events.append("beat")

    def grace(self, seconds=0.0):
        self.events.append("grace")

    def wrap_log(self, log):
        def beat_log(s):
            self.beat()
            self.events.append(s)
            log(s)
        return beat_log


def test_driver_beats_and_graces_an_installed_watchdog():
    """Every move beats; a training session starts with a grace, and so
    does every benchmark round, before the twin's first move."""
    from tetris_mcts_tpu_torch.runtime.selfplay import SelfPlayConfig, SelfPlayDriver

    wd = RecordingWatchdog()
    watchdog.install(wd)
    try:
        cfg = SelfPlayConfig(batch=2, sims=2, max_nodes=64, max_obs=64, table_size=128,
                             max_depth=6, min_visits_store=1, memory_size=512,
                             memory_growth=64, train_rows_trigger=48, train_batch=16,
                             train_iters_per_val=5, train_max_iters=10, acc_policy=0,
                             episodes_per_train=1, benchmark_every=1, benchmark_games=1,
                             benchmark_sims=2, benchmark_batch=1, benchmark_max_moves=200,
                             benchmark_max_nodes=64, seed=3)
        d = SelfPlayDriver(cfg, device="cpu", log=lambda s: None)
        assert d._watchdog is wd
        moves = 0
        while not (d.n_trains and d._bench_round) and moves < 400:
            n = wd.events.count("beat")
            d.step()
            moves += 1
            assert wd.events.count("beat") > n  # the move beat
    finally:
        watchdog.install(None)
    ev = wd.events
    assert d.n_trains and d._bench_round, "no session or no benchmark round"
    session = next(i for i, e in enumerate(ev) if str(e).startswith("Training session"))
    assert "grace" in ev[session - 3:session]
    twin = next(i for i, e in enumerate(ev) if str(e).startswith("Benchmark channel"))
    after = ev[twin:]
    assert after.index("grace") < after.index("beat", after.index("grace"))
    assert d._bench._watchdog is wd  # the twin's moves beat it too
