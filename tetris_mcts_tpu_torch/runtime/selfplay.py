"""Self-play drivers, online (storage and training) or in benchmark mode
(counterpart of the reference package's `runtime/selfplay.py`
`_OnlineDriverBase`, `SelfPlayDriver` and `VPSelfPlayDriver`):
`SelfPlayDriver` with the lp, leaf or rollout evaluator on the VV net, or a
policy playout (hybrid, finite, full) on the VP net
(`SelfPlayConfig.evaluator`); `VPSelfPlayDriver` the ApproxPolicyIter
search (`search/vp.py`) with the VP net; `DistSelfPlayDriver` the
DistValueSim search (`search/distributional.py`) with the distributional
net; `S2SelfPlayDriver` the ValueSim2 search (`search/stochastic.py`) with
the VV net.

B games play MCTS moves in lockstep; each move is one call of the move
program (`search/mcts.make_move_fn`), which stays on the device and, in
online mode, appends the harvested trees' training rows to the replay ring
on the device. The host reads back one small tensor per move (done, score
and lines of every game, the ring's `total` and `cand` counters) for the
episode bookkeeping and the training trigger, and logs episodes in the
reference's format:

    Episode:     N  Score:         S  Lines Cleared:    L  lines(min/max/mean):...

Online training follows the reference:

- acc_policy -1 (default): a session fires once `train_rows_trigger` rows
  have been harvested since the last one; the n-th session trains on the
  newest min(n * memory_growth, memory_size) rows, rounded down to a
  power-of-two multiple of train_batch (or the memory's cap);
- acc_policy 0-3: the C++ agent's accumulation policies (an episode gate
  with a stochastic store drop and a random trim on overflow; the same
  gate with a weighted trim; the episode gate or a full memory; a growth
  gate on the rows accumulated), each clearing the ring after a session,
  with sessions rounded up to the next bucket by duplicating the oldest
  rows at the front.

The model is shared with the search: a session updates the net's params in
place (and the VV model rescales `ubound`), and the next move's forward
reads them. A session trains on the model's own columns of the ring:
[states, value, variance, weight] for VV, [states, value, policy (7),
weight] for VP, [states, target distribution (atoms), weight] for dist. A
benchmark channel (`benchmark_every`) plays rounds of games on a twin
driver in benchmark mode that shares the model. Metrics go to an optional
`obs.metrics.MetricsWriter`.

Per-move channels, fed from the env state BEFORE the move (the board the
policy, action and value were computed from): a `utils.data.DataSaver`
(`saver`, one row a game a move, tagged with the game's episode id) and a
`obs.metrics.StatusPublisher` (`status`). Their columns ride on the move's
one host read. `save_nodes` dumps every tree's searched observations.

A stall watchdog installed process-wide (`runtime/watchdog.install`) is
beaten on every move and every log line, and given a grace window at the
start of a training session and before the benchmark twin's first move.
"""

from __future__ import annotations

import os
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from tetris_mcts_tpu_torch.env import engine
from tetris_mcts_tpu_torch.env.engine import EnvConfig
from tetris_mcts_tpu_torch.ops import env_packed as EP
from tetris_mcts_tpu_torch.runtime import watchdog
from tetris_mcts_tpu_torch.search import distributional as DD
from tetris_mcts_tpu_torch.search import mcts
from tetris_mcts_tpu_torch.search import stochastic as ST
from tetris_mcts_tpu_torch.search import tree as T
from tetris_mcts_tpu_torch.search import vp as VP
from tetris_mcts_tpu_torch.search.mcts import SearchConfig
from tetris_mcts_tpu_torch.search.tree import TreeConfig
from tetris_mcts_tpu_torch.train.trainer import DistModel, VPModel, VVModel


class SelfPlayConfig(NamedTuple):
    batch: int = 64
    sims: int = 100
    evaluator: str = "lp"  # mcts.EVALUATORS, "vp" (VPSelfPlayDriver), "dist"
                           # (DistSelfPlayDriver) or "s2" (S2SelfPlayDriver)
    max_nodes: int = 4096
    max_obs: int = 4096
    table_size: int = 8192
    max_depth: int = 96
    gamma: float = 0.999
    policy: str = "clt"
    low: int = 1
    min_visits_store: int = 25     # min visits of a stored obs
    memory_size: int = 100_000     # replay ring capacity
    memory_growth: int = 5_000     # per-session growth gate
    train_rows_trigger: int = 5_000  # new rows between sessions
    train_batch: int = 128
    train_iters_per_val: int = 100
    train_max_iters: int = 50_000
    benchmark: bool = False        # no training, no storage
    acc_policy: int = -1           # -1 growth-gated ring; 0-3 C++ policies
    episodes_per_train: int = 25   # episode gate of policies 0-2
    trim_fraction: float = 0.01    # overflow trim percentile / fraction
    benchmark_every: int = 0       # benchmark round every N episodes; 0 off
    benchmark_games: int = 8
    benchmark_sims: int = 0        # 0 = 2x the training sims
    benchmark_batch: int = 0       # 0 = min(benchmark_games, batch)
    benchmark_max_moves: int = 5000
    benchmark_max_nodes: int = 0   # 0 = auto-scale for benchmark_sims
    episode_reuse: bool = False    # done lanes re-root in their own pool
    rollout_depth: int = 0         # policy-playout depth; 0 = the agent's
                                   # (HybridSim 30, FiniteSim 50, FullSim to the end)
    bf16: bool = False             # bfloat16 body in the search's forward
    allow_clamp: bool = False      # accept pools too small for one move
    select_kernel: bool = True     # False: the plain select walk (--select_kernel 0)
    insert_kernel: bool = True     # False: the plain insert (--insert_kernel 0)
    checkpoint_each_train: bool = False  # save the model after each session
    dump_dir: str = ""             # write dump.npz of each session's set
    seed: int = 0
    actions_per_drop: int = 1
    scoring: int = 0
    randomizer: int = 0


class EpisodeTracker:
    """`ScoreTracker`: running min/max/mean/std over episodes."""

    def __init__(self):
        self.n = 0
        self._sum = 0.0
        self._sumsq = 0.0
        self.min = float("inf")
        self.max = float("-inf")

    def add(self, v: float):
        self.n += 1
        self._sum += v
        self._sumsq += v * v
        self.min = min(self.min, v)
        self.max = max(self.max, v)

    @property
    def mean(self):
        return self._sum / self.n if self.n else 0.0

    @property
    def std(self):
        if self.n < 2:
            return 0.0
        return max(self._sumsq / self.n - self.mean**2, 0.0) ** 0.5


class _OnlineDriverBase:
    """The host loop: episode bookkeeping, the training triggers
    (`_maybe_train` for acc_policy -1, `_acc_policy_step` for 0-3), the
    sessions, the benchmark channel and the throughput reports. A subclass
    owns the move program, the model, the trees and the replay ring
    (`self.model`, `self.trees`, `self.replay`) and provides `step`,
    `_training_columns(order)` and `_reinit_games(seed)`, and
    `_saver_extras(stats)` where its search keeps variance statistics."""

    _TP_REPORT_EVERY = 50    # moves per throughput report, or a window of
    _TP_REPORT_SECONDS = 25  # >= 4 moves older than this (sessions restart it)

    def _init_bookkeeping(self, cfg: SelfPlayConfig, log, metrics, saver=None, status=None,
                          device="cpu"):
        self.cfg = cfg
        self.device = torch.device(device)
        self._trim_gen = torch.Generator(device=self.device)
        self._trim_gen.manual_seed(cfg.seed)
        # an installed stall watchdog is beaten by every log line; the
        # benchmark twin inherits the wrapped log
        self._watchdog = watchdog.get_active()
        if self._watchdog is not None:
            log = self._watchdog.wrap_log(log)
        self.log = log
        self.metrics = metrics
        self.saver = saver
        self.status = status
        # per-lane episode ids of the saver's rows; a finished lane takes
        # the next id
        self._ep_id = np.arange(cfg.batch, dtype=np.int64)
        self._next_ep = cfg.batch
        self.episodes = 0
        self.moves = 0
        self.score_tracker = EpisodeTracker()
        self.line_tracker = EpisodeTracker()
        self.last_stats = None
        self._live_lines = None
        # training bookkeeping
        self.n_trains = 0
        self._rows_at_last_train = 0
        self._prev_total = 0
        self._storage_warned = False
        self.train_history: list = []
        # accumulation-policy bookkeeping (cfg.acc_policy >= 0)
        self._mem_rows = 0             # rows since the last clear
        self._last_train_episode = 0
        self._ep_window: list = []     # (episodes, candidates) pairs
        self._cand_prev = 0
        self._last_ep_seen = 0
        self._drop_prob_host = 0.0
        self.trims = 0
        # benchmark channel
        self._bench = None
        self._bench_broken = False
        self._eps_at_last_bench = 0
        self._bench_round = 0
        # throughput window, restarted after every report, session and
        # benchmark round, so it measures search time only
        self._tp_t0 = time.perf_counter()
        self._tp_moves = 0

    def _restart_throughput(self):
        self._tp_t0 = time.perf_counter()
        self._tp_moves = 0

    def _report_throughput(self, force: bool = False):
        """One `throughput` report per window of 50 moves (or of >= 4 moves
        older than 25 s): moves/s and sims/s = moves/s x B x sims.
        `force=True` flushes a pending window of >= 4 moves without
        counting a move (before a session or a benchmark round)."""
        if force:
            if self._tp_moves < 4:
                return
        else:
            self._tp_moves += 1
            if self._tp_moves < self._TP_REPORT_EVERY and not (
                    self._tp_moves >= 4
                    and time.perf_counter() - self._tp_t0 > self._TP_REPORT_SECONDS):
                return
        dt = time.perf_counter() - self._tp_t0
        if dt > 0:
            moves_per_s = self._tp_moves / dt
            sims_per_s = moves_per_s * self.cfg.batch * self.cfg.sims
            ll = self._live_lines
            live = "" if ll is None else (f"  live lines mean/max {float(np.mean(ll)):.2f}/"
                                          f"{int(np.max(ll))}")
            self.log(f"Throughput: {moves_per_s:8.2f} moves/s  {sims_per_s:12.1f} "
                     f"sims/s  (window {self._tp_moves} moves, batch "
                     f"{self.cfg.batch}, {self.cfg.sims} sims)" + live)
            if self.metrics is not None:
                self.metrics.write(
                    "throughput", moves=self.moves, sims=self.cfg.sims,
                    batch=self.cfg.batch, max_nodes=self.cfg.max_nodes,
                    moves_per_s=round(moves_per_s, 3), sims_per_s=round(sims_per_s, 1),
                    live_lines_mean=None if ll is None else round(float(np.mean(ll)), 3),
                    live_lines_max=None if ll is None else int(np.max(ll)))
        self._restart_throughput()

    def _after_move(self, stats, envs_prev):
        """Host bookkeeping of one move, on ONE read from the device: the
        games' done/score/lines and the ring's total and cand counters, and
        the saver's and status's columns when either is set."""
        self.moves += 1
        if self._watchdog is not None:
            self._watchdog.beat()
        self.last_stats = stats
        B = stats.done.shape[0]
        rep = self.replay
        parts = [torch.cat([
            torch.stack([stats.done.to(torch.int64), stats.score.to(torch.int64),
                         stats.lines.to(torch.int64)]).reshape(-1),
            torch.stack([rep.total, rep.cand]).to(torch.int64)])]
        publish = self.saver is not None or self.status is not None
        if publish:
            parts += self._publish_columns(stats, envs_prev)
        fetched = _host_read(parts)
        host = fetched[0]
        done, score, lines = host[:B] != 0, host[B:2 * B], host[2 * B:3 * B]
        total, cand = int(host[3 * B]), int(host[3 * B + 1])
        self._live_lines = lines
        if publish:
            self._publish(*fetched[1:])
        self._report_throughput()
        self._finish_episodes(done, score, lines)
        if not self.cfg.benchmark:
            if self.cfg.acc_policy < 0:
                self._maybe_train(total)
            else:
                self._acc_policy_step(total, cand)
            self._maybe_benchmark()
        return stats

    def _publish_columns(self, stats, envs):
        """The saver's and status's columns on the device: the pre-move
        packed states envs (B, 44) int32 (unpacked on the host, where a
        few dozen small ops cost less than their launches), float32 (B, 30)
        policy, child_stats, value and variance, and int32 (B,) action."""
        cs, var = self._saver_extras(stats)
        floats = torch.cat([stats.probs, cs.reshape(cs.shape[0], -1),
                            stats.root_value[:, None], var[:, None]], 1).to(torch.float32)
        return [envs, floats, stats.action.to(torch.int32)]

    def _saver_extras(self, stats):
        """(child_stats (B, 3, 7), root variance (B,)): the saver's
        search-statistics columns; zeros for the searches that keep no
        variance statistics (the reference saves zeros too)."""
        B = stats.action.shape[0]
        return (torch.zeros(B, 3, T.N_ACTIONS, device=self.device),
                torch.zeros(B, device=self.device))

    def _publish(self, envs, floats, action):
        """Hand one move's rows to the saver and game 0's board with every
        game's counters to the status channel (host arrays of
        `_publish_columns`)."""
        envs = torch.from_numpy(envs)
        c = {k: v.numpy() for k, v in EP.unpack_columns(envs).items()}
        boards = engine.unpack_obs(EP.packed_obs(envs)).numpy()
        if self.saver is not None:
            B = floats.shape[0]
            self.saver.add_batch(
                episode=self._ep_id.copy(), board=boards, policy=floats[:, :7],
                action=action, combo=c["combo"], lines=c["lines"],
                line_stats=c["line_stats"], score=c["score"],
                child_stats=floats[:, 7:28].reshape(B, 3, 7), value=floats[:, 28],
                variance=floats[:, 29])
        if self.status is not None:
            self.status.publish(boards[0], c["combo"], c["score"], c["lines"],
                                c["line_stats"])

    def _finish_episodes(self, done, score, lines):
        for i in np.nonzero(done)[0]:
            self.episodes += 1
            self._ep_id[i] = self._next_ep
            self._next_ep += 1
            self.score_tracker.add(float(score[i]))
            self.line_tracker.add(float(lines[i]))
            self.log(
                f"Episode:{self.episodes:6d}  "
                f"Score:{int(score[i]):10d}  Lines Cleared:{int(lines[i]):5d}  "
                f"lines(min/max/mean):{self.line_tracker.min:.0f}/"
                f"{self.line_tracker.max:.0f}/{self.line_tracker.mean:.2f}  "
                f"score(mean±std):{self.score_tracker.mean:.1f}"
                f"±{self.score_tracker.std:.1f}"
            )
            if self.metrics is not None:
                self.metrics.write("episode", n=self.episodes, lines=int(lines[i]),
                                   score=int(score[i]), benchmark=self.cfg.benchmark)

    # ------------------------------------------------------ acc_policy -1
    def _maybe_train(self, total_rows: int):
        # a driver that has finished episodes yet stored no row is broken
        # (min_visits too high, or a wrong search): say so once
        if (total_rows == 0 and not self._storage_warned
                and (self.episodes >= self.cfg.batch
                     or (self.episodes > 0 and self.moves >= 1000))):
            self._storage_warned = True
            self.log(f"WARNING: {self.episodes} episodes / {self.moves} moves "
                     "finished but the replay ring holds ZERO rows — the search "
                     "is likely broken (or min_visits too high). Training will "
                     "never trigger.")
            if self.metrics is not None:
                self.metrics.write("zero_storage_warning", episodes=self.episodes,
                                   moves=self.moves)
        if total_rows - self._prev_total > self.cfg.memory_size:
            self.log("warning: one move harvested more rows than memory_size; "
                     "the ring overwrote itself and the excess was lost")
        self._prev_total = total_rows
        if total_rows - self._rows_at_last_train < self.cfg.train_rows_trigger:
            return
        self._report_throughput(force=True)
        if self.train():
            self._rows_at_last_train = total_rows
            self._restart_throughput()
        # on a skip the trigger stays armed and retries next move

    def train(self):
        """One session on the newest min((n + 1) * memory_growth,
        memory_size) rows (at least one minibatch). False when skipped."""
        m_size = min((self.n_trains + 1) * self.cfg.memory_growth, self.cfg.memory_size)
        m_size = max(m_size, self.cfg.train_batch)
        return self._run_training_session(min(m_size, int(self.replay.count)))

    def _run_training_session(self, use):
        """Train on the newest `use` ring rows, bucketed to a power-of-two
        multiple of train_batch or the memory's cap (rounded down; under
        acc_policy >= 0 rounded up, the oldest rows duplicated at the
        front). Returns False when there is not one minibatch."""
        if self._watchdog is not None:
            # a session holds the host loop for its whole length; its
            # validation lines beat from the first window on
            self._watchdog.grace()
        cfg = self.cfg
        count = int(self.replay.count)
        cap = cfg.memory_size - cfg.memory_size % cfg.train_batch
        use = min(use, count)
        use -= use % cfg.train_batch
        if use < cfg.train_batch:
            self.log(f"Training session {self.n_trains + 1}: only {count} rows, skipped")
            return False
        pad = 0
        if use < cap:
            bucket = cfg.train_batch
            while bucket * 2 <= use:
                bucket *= 2
            if cfg.acc_policy >= 0 and use > bucket:
                # the ring is cleared after this session: round up, so no
                # fresh row goes untrained; the validation tail stays the
                # newest rows
                pad = min(bucket * 2, cap) - use
            else:
                use = min(bucket, cap)
        self.n_trains += 1

        idx = int(self.replay.idx)
        order = (np.arange(idx - use, idx) % cfg.memory_size).astype(np.int64)
        if pad:
            order = np.concatenate([order[:pad], order])
            use += pad
        data = self._training_columns(order)

        self.log(f"Training session {self.n_trains}: {use} rows "
                 f"(memory {count}/{cfg.memory_size})")
        self._dump_training_data(data)
        t0 = time.time()
        hist = self.model.train_data(
            data, batch_size=cfg.train_batch, iters_per_val=cfg.train_iters_per_val,
            max_iters=cfg.train_max_iters, shuffle=True, log=self.log)
        seconds = time.time() - t0
        self.train_history.append(hist)
        self.log(f"Training session {self.n_trains} done in {seconds:.1f}s")
        if cfg.checkpoint_each_train:
            self.model.save()
        if self.metrics is not None:
            last = hist[-1] if hist else (0, float("nan"), float("nan"), 0.0)
            self.metrics.write("train_session", n=self.n_trains, rows=use,
                               seconds=seconds, iters=last[0], loss_train=last[1],
                               loss_val=last[2], grad_norm=last[4] if len(last) > 4 else None)
        return True

    def _dump_training_data(self, data):
        if not self.cfg.dump_dir:
            return
        os.makedirs(self.cfg.dump_dir, exist_ok=True)
        states, value, var, weight = (torch.as_tensor(x).cpu().numpy() for x in data)
        np.savez(os.path.join(self.cfg.dump_dir, "dump"), states=states, values=value,
                 variance=var, weights=weight)

    # ------------------------------------------------------ acc_policy 0-3
    def _acc_policy_step(self, total: int, cand: int):
        """One move of the C++ agent's accumulation logic: the memory's
        fill (`_mem_rows`, clamped at capacity), policy 0's drop
        probability from the candidate rate of the last episodes_per_train
        episodes, the trims on overflow (0 random, 1 weighted), the
        policy's training gate, and the clear after a session."""
        cfg = self.cfg
        self._mem_rows = min(self._mem_rows + total - self._prev_total, cfg.memory_size)
        self._prev_total = total

        if cfg.acc_policy == 0 and self.episodes > self._last_ep_seen:
            self._ep_window.append((self.episodes - self._last_ep_seen,
                                    cand - self._cand_prev))
            self._cand_prev = cand
            self._last_ep_seen = self.episodes
            while sum(e for e, _ in self._ep_window[1:]) >= cfg.episodes_per_train:
                self._ep_window.pop(0)
            sum_e = sum(e for e, _ in self._ep_window)
            sum_c = sum(c for _, c in self._ep_window)
            est = sum_c * (cfg.episodes_per_train / max(sum_e, 1))
            p_drop = max(0.0, 1.0 - cfg.memory_size / max(est, 1.0))
            if abs(p_drop - self._drop_prob_host) > 1e-3:
                self.replay.drop_prob.fill_(p_drop)
                self._drop_prob_host = p_drop
                self.log(f"Average nodes stored per episode: "
                         f"{sum_c / max(sum_e, 1):.0f}    "
                         f"Memory dropping probability: {p_drop:.4f}")

        diff = self.episodes - self._last_train_episode
        full = self._mem_rows >= cfg.memory_size
        p = cfg.acc_policy
        if p in (0, 1):
            do_train = diff >= cfg.episodes_per_train
            if not do_train and full:
                if p == 0:
                    dropped = mcts.replay_trim_random(
                        self.replay, cfg.trim_fraction, self._trim_uniforms(cfg.memory_size))
                else:
                    dropped = mcts.replay_trim_weighted(self.replay, cfg.trim_fraction)
                dropped = int(dropped)
                self.trims += 1
                self._mem_rows = max(self._mem_rows - dropped, 0)
                self.log("Memory limit exceeded, trimming memory "
                         f"({'random' if p == 0 else 'weighted'}: {dropped} rows; "
                         f"memory {self._mem_rows}/{cfg.memory_size})")
        elif p == 2:
            do_train = diff >= cfg.episodes_per_train or full
        elif p == 3:
            m_size = min(self.n_trains * cfg.memory_growth, cfg.memory_size)
            do_train = self._mem_rows >= max(m_size, cfg.train_batch)
        else:
            raise ValueError(f"acc_policy {p} not in -1..3")

        if do_train:
            self._report_throughput(force=True)
        if do_train and self._run_training_session(min(self._mem_rows, cfg.memory_size)):
            mcts.replay_clear(self.replay)
            self._mem_rows = 0
            self._last_train_episode = self.episodes
            self._restart_throughput()

    # --------------------------------------------------- benchmark channel
    def reset_games(self, seed: int):
        """Fresh games and episode bookkeeping (a benchmark round starts
        clean)."""
        self._reinit_games(seed)
        self._ep_id = np.arange(self.cfg.batch, dtype=np.int64)
        self._next_ep = self.cfg.batch
        self.episodes = 0
        self.score_tracker = EpisodeTracker()
        self.line_tracker = EpisodeTracker()

    def _maybe_benchmark(self):
        """Every benchmark_every finished episodes, play benchmark_games
        finished games at benchmark_sims on the twin driver (training and
        storage off, the same model) and write one `benchmark` event."""
        cfg = self.cfg
        if cfg.benchmark_every <= 0 or self._bench_broken:
            return
        if self.episodes - self._eps_at_last_bench < cfg.benchmark_every:
            return
        self._report_throughput(force=True)
        self._eps_at_last_bench = self.episodes
        self._bench_round += 1
        try:
            self._run_benchmark_round()
        except Exception as e:  # noqa: BLE001 — a broken twin must not end the run
            self._bench_broken = True
            self._bench = None
            self.log(f"Benchmark channel DISABLED after error: {e!r}")
            self._restart_throughput()

    def _run_benchmark_round(self):
        cfg = self.cfg
        if self._bench is None:
            bsims = cfg.benchmark_sims or 2 * cfg.sims
            bbatch = cfg.benchmark_batch or min(cfg.benchmark_games, cfg.batch)
            auto_nodes = max(cfg.max_nodes, 1 << (8 * bsims - 1).bit_length())
            bnodes = cfg.benchmark_max_nodes or auto_nodes
            bobs = max(cfg.max_obs, bnodes)
            bcfg = cfg._replace(
                batch=bbatch, sims=bsims, benchmark=True, max_nodes=bnodes,
                max_obs=bobs,
                table_size=max(cfg.table_size, 1 << (2 * bobs - 1).bit_length()),
                memory_size=max(cfg.train_batch, 1024), benchmark_every=0)
            self.log(f"Benchmark channel: building twin driver (batch {bbatch}, "
                     f"{bsims} sims, {bnodes} nodes)")
            self._bench = type(self)(bcfg, model=self.model, device=self.device,
                                     log=self.log, metrics=self.metrics)
        bench = self._bench
        bench.reset_games(cfg.seed + 7777 * self._bench_round)
        if self._watchdog is not None:
            # the twin's first move builds its trees and runs the
            # benchmark width for the first time
            self._watchdog.grace()
        t0 = time.time()
        bench.run_episodes(cfg.benchmark_games, max_moves=cfg.benchmark_max_moves)
        lt, st = bench.line_tracker, bench.score_tracker
        if lt.n == 0:
            self.log(f"Benchmark round {self._bench_round}: no game finished within "
                     f"{cfg.benchmark_max_moves} moves [{time.time() - t0:.1f}s]")
            self._restart_throughput()
            return
        self.log(f"Benchmark round {self._bench_round} ({lt.n} games, "
                 f"{bench.cfg.sims} sims): lines {lt.mean:.2f}±{lt.std:.2f} "
                 f"(min {lt.min:.0f} max {lt.max:.0f})  score {st.mean:.1f}"
                 f"±{st.std:.1f}  [{time.time() - t0:.1f}s]")
        if self.metrics is not None:
            # a snapshot of the net this round measured, named in the event
            snap_name = None
            if cfg.checkpoint_each_train:
                root, ext = os.path.splitext(self.model.checkpoint_path)
                snap = f"{root}.bench{self.metrics.run}_{self._bench_round}{ext}"
                try:
                    self.model.save(snap)
                    snap_name = os.path.basename(snap)
                except OSError as e:
                    self.log(f"benchmark snapshot failed ({e!r})")
            self.metrics.write(
                "benchmark", round=self._bench_round, episode=self.episodes,
                games=lt.n, sims=bench.cfg.sims, lines_mean=round(lt.mean, 3),
                lines_std=round(lt.std, 3), lines_min=lt.min, lines_max=lt.max,
                score_mean=round(st.mean, 2), score_std=round(st.std, 2),
                snapshot=snap_name)
        self._restart_throughput()

    def _trim_uniforms(self, n: int):
        """Uniform draws (n,) of the random trim."""
        return torch.rand(n, generator=self._trim_gen, device=self.device)

    def run(self, n_moves: int):
        for _ in range(n_moves):
            self.step()

    def run_episodes(self, n_episodes: int, max_moves: int = 10_000_000):
        target = self.episodes + n_episodes
        moves = 0
        while self.episodes < target and moves < max_moves:
            self.step()
            moves += 1

    def save_nodes(self, path: str, min_visits: int = 1):
        """Write every tree's searched observations (each obs slot in use,
        not terminal, with at least `min_visits` visits) to `path` with
        `np.savez`: board (n, 20, 10) int8, value, variance, visit (n,)
        float32 and game (n,) int64, the tree's lane, in lane-major order."""
        packed, val, var, w, mask = T.harvest(self.trees, min_visits)
        lanes = torch.arange(mask.shape[0], device=mask.device)[:, None].expand_as(mask)
        cols = dict(board=engine.unpack_obs(packed[mask]), value=val[mask],
                    variance=var[mask], visit=w[mask], game=lanes[mask].to(torch.int64))
        np.savez(path, **{k: v.cpu().numpy() for k, v in cols.items()})
        self.log(f"saved {int(cols['game'].shape[0])} nodes to {path}")


def tree_config(cfg: SelfPlayConfig) -> TreeConfig:
    """The search's tree configuration of a self-play configuration."""
    return TreeConfig(
        max_nodes=cfg.max_nodes, max_obs=cfg.max_obs, table_size=cfg.table_size,
        max_depth=cfg.max_depth, gamma=cfg.gamma, policy=cfg.policy, low=cfg.low,
        env=EnvConfig(actions_per_drop=cfg.actions_per_drop, scoring=cfg.scoring,
                      randomizer=cfg.randomizer),
        select_kernel=cfg.select_kernel, insert_kernel=cfg.insert_kernel)


def search_config(cfg: SelfPlayConfig, evaluator: str | None = None) -> SearchConfig:
    """The search configuration of a self-play configuration."""
    return SearchConfig(tree=tree_config(cfg), sims=cfg.sims,
                        evaluator=evaluator or cfg.evaluator, allow_clamp=cfg.allow_clamp)


class SelfPlayDriver(_OnlineDriverBase):
    """Owns the model (weights made from cfg.seed unless one is given), the
    batched (trees, envs) device state, the replay ring and the move
    program, whose randomness comes from a `mcts.TorchPlanes` on the device
    seeded from cfg.seed. `run(n_moves)` / `run_episodes(n)` advance
    self-play; in online mode training sessions fire from the gates."""

    def __init__(self, cfg: SelfPlayConfig, model: VVModel | VPModel | None = None,
                 device="cuda", log=lambda s: print(s, file=sys.stderr, flush=True),
                 metrics=None, saver=None, status=None):
        """`saver`: a `utils.data.DataSaver` (per-move rows); `status`: an
        `obs.metrics.StatusPublisher` (live-state memmaps). The policy
        playouts (hybrid, finite, full) run on a `VPModel`, the other
        evaluators on a `VVModel`."""
        self._init_bookkeeping(cfg, log, metrics, saver, status, device)
        playout = cfg.evaluator in mcts.POLICY_PLAYOUTS
        if model is None:
            model = (VPModel if playout else VVModel)(cfg.seed, self.device)
        self.model = model
        self.search_cfg = search_config(cfg)
        mcts.log_plain_walks(self.log, self.search_cfg.tree)
        self.planes = mcts.TorchPlanes(cfg.seed, self.device, cfg.policy)
        apply_fn = self.model.apply_fn(torch.bfloat16 if cfg.bf16 else None)
        if cfg.evaluator == "lp":
            evaluator = mcts.nn_child_evaluator(apply_fn)
        elif cfg.evaluator == "leaf":
            evaluator = mcts.nn_leaf_evaluator(apply_fn)
        elif cfg.evaluator == "rollout":
            evaluator = mcts.rollout_evaluator(self.search_cfg, self.planes.actions)
        elif playout:
            evaluator = mcts.policy_rollout_evaluator(
                apply_fn, self.search_cfg,
                mcts.playout_depth(self.search_cfg, cfg.rollout_depth),
                bootstrap=mcts.POLICY_PLAYOUTS[cfg.evaluator][1], draw=self.planes.gumbels)
        else:
            raise ValueError(f"unknown or unported evaluator {cfg.evaluator!r}")
        self.evaluator = evaluator
        self._move = mcts.make_move_fn(
            evaluator, self.search_cfg, self.planes,
            min_visits_store=cfg.min_visits_store, store=not cfg.benchmark,
            store_drop=cfg.acc_policy == 0, episode_reuse=cfg.episode_reuse)
        self.trees, self.envs = mcts.init_batch(cfg.seed, cfg.batch,
                                                self.search_cfg, self.device)
        self.replay = mcts.init_replay(cfg.memory_size, self.device)

    def _reinit_games(self, seed: int):
        self.trees, self.envs = mcts.init_batch(seed, self.cfg.batch,
                                                self.search_cfg, self.device)
        self.planes.gen.manual_seed(seed)

    def step(self):
        """One batched move (B games advance one action each)."""
        envs_prev = self.envs  # the move returns new env tensors
        self.envs, stats = self._move(self.trees, self.envs, self.replay)
        return self._after_move(stats, envs_prev)

    def _saver_extras(self, stats):
        return stats.child_stats, stats.root_var

    def _training_columns(self, order):
        """[states int8 (n, 20, 10), value, var, weight] of the ring rows
        `order`, on the device; the boards are unpacked here."""
        o = torch.as_tensor(order, device=self.device)
        rep = self.replay
        return [engine.unpack_obs(rep.boards[o]), rep.value[o], rep.var[o],
                rep.weight[o]]


class VPSelfPlayDriver(_OnlineDriverBase):
    """The ApproxPolicyIter driver (the reference `VPSelfPlayDriver`):
    policy-sampled selection, value + improvement-policy backup, and online
    training of the VP net, on the same host loop as `SelfPlayDriver`. Its
    randomness is a `mcts.TorchPlanes` on the device seeded from cfg.seed."""

    def __init__(self, cfg: SelfPlayConfig, model: VPModel | None = None,
                 device="cuda", log=lambda s: print(s, file=sys.stderr, flush=True),
                 metrics=None, saver=None, status=None):
        self._init_bookkeeping(cfg, log, metrics, saver, status, device)
        self.model = model if model is not None else VPModel(cfg.seed, self.device)
        self.search_cfg = search_config(cfg, "vp")
        mcts.log_plain_walks(self.log, self.search_cfg.tree, ("insert",))
        self.planes = mcts.TorchPlanes(cfg.seed, self.device, cfg.policy)
        self._move = VP.make_vp_move_fn(
            self.model.apply_fn(torch.bfloat16 if cfg.bf16 else None), self.search_cfg,
            self.planes, min_visits_store=cfg.min_visits_store, store=not cfg.benchmark)
        self.vtrees, self.envs = VP.init_vp_batch(cfg.seed, cfg.batch, self.search_cfg,
                                                  self.device)
        self.replay = VP.init_vp_replay(cfg.memory_size, self.device)

    @property
    def trees(self):
        """The search trees without the priors and counts (`save_nodes`)."""
        return self.vtrees.base

    def _reinit_games(self, seed: int):
        self.vtrees, self.envs = VP.init_vp_batch(seed, self.cfg.batch, self.search_cfg,
                                                  self.device)
        self.planes.gen.manual_seed(seed)

    def step(self):
        """One batched move (B games advance one action each)."""
        envs_prev = self.envs
        self.envs, stats = self._move(self.vtrees, self.envs, self.replay)
        return self._after_move(stats, envs_prev)

    def _training_columns(self, order):
        """[states int8 (n, 20, 10), value, policy (n, 7), weight] of the
        ring rows `order`, on the device."""
        o = torch.as_tensor(order, device=self.device)
        rep = self.replay
        return [engine.unpack_obs(rep.boards[o]), rep.value[o], rep.policy[o],
                rep.weight[o]]

    def _dump_training_data(self, data):
        """No training-set dump for the VP model (the reference dumps the VV
        model's only)."""


class DistSelfPlayDriver(_OnlineDriverBase):
    """The DistValueSim driver (the reference `DistSelfPlayDriver`): the C51
    distributional search with online training of the distributional net
    on the harvested target distributions, on the same host loop as
    `SelfPlayDriver`. The support is [0, vmax] in `atoms` bins; the search's
    low-visit threshold is cfg.low. Its randomness is a `mcts.TorchPlanes`
    on the device seeded from cfg.seed."""

    def __init__(self, cfg: SelfPlayConfig, model: DistModel | None = None,
                 device="cuda", log=lambda s: print(s, file=sys.stderr, flush=True),
                 metrics=None, saver=None, status=None):
        self._init_bookkeeping(cfg, log, metrics, saver, status, device)
        self.model = model if model is not None else DistModel(seed=cfg.seed, device=self.device)
        self.dcfg = DD.DistConfig(atoms=self.model.atoms, low=cfg.low)
        self.search_cfg = search_config(cfg, "dist")
        mcts.log_plain_walks(self.log, self.search_cfg.tree, ("insert",))
        self.planes = mcts.TorchPlanes(cfg.seed, self.device, cfg.policy)
        self._move = DD.make_dist_move_fn(
            self.model.apply_fn(torch.bfloat16 if cfg.bf16 else None), self.search_cfg,
            self.dcfg, self.planes, min_visits_store=cfg.min_visits_store,
            store=not cfg.benchmark)
        self.dtrees, self.envs = DD.init_dist_batch(cfg.seed, cfg.batch, self.search_cfg,
                                                    self.dcfg, self.device)
        self.replay = DD.init_dist_replay(cfg.memory_size, self.dcfg.atoms, self.device)

    @property
    def trees(self):
        """The search trees without the distributions (`save_nodes`)."""
        return self.dtrees.base

    def _reinit_games(self, seed: int):
        self.dtrees, self.envs = DD.init_dist_batch(seed, self.cfg.batch, self.search_cfg,
                                                    self.dcfg, self.device)
        self.planes.gen.manual_seed(seed)

    def step(self):
        """One batched move (B games advance one action each)."""
        envs_prev = self.envs
        self.envs, stats = self._move(self.dtrees, self.envs, self.replay)
        return self._after_move(stats, envs_prev)

    def _training_columns(self, order):
        """[states int8 (n, 20, 10), target distribution (n, atoms), weight]
        of the ring rows `order`, on the device."""
        o = torch.as_tensor(order, device=self.device)
        rep = self.replay
        return [engine.unpack_obs(rep.boards[o]), rep.dist[o], rep.weight[o]]

    def _dump_training_data(self, data):
        """No training-set dump for the distributional model (the reference
        dumps the VV model's only)."""


class S2SelfPlayDriver(_OnlineDriverBase):
    """The ValueSim2 driver (the reference `S2SelfPlayDriver`): the
    stochastic-transition search (`search/stochastic.py`) with single-leaf
    evaluation on the VV net, on the same host loop as `SelfPlayDriver`.
    The search draws nothing. The reference agent never trains, and `play`
    runs it in benchmark mode; it keeps no node dump (no `save_nodes`)."""

    save_nodes = None

    def __init__(self, cfg: SelfPlayConfig, model: VVModel | None = None,
                 device="cuda", log=lambda s: print(s, file=sys.stderr, flush=True),
                 metrics=None, saver=None, status=None):
        self._init_bookkeeping(cfg, log, metrics, saver, status, device)
        self.model = model if model is not None else VVModel(cfg.seed, self.device)
        self.search_cfg = search_config(cfg, "s2")
        mcts.log_plain_walks(self.log, self.search_cfg.tree, ("insert",))
        self._move = ST.make_s2_move_fn(
            self.model.apply_fn(torch.bfloat16 if cfg.bf16 else None), self.search_cfg,
            min_visits_store=cfg.min_visits_store, store=not cfg.benchmark)
        self.s2trees, self.envs = ST.init_s2_batch(cfg.seed, cfg.batch, self.search_cfg,
                                                   self.device)
        self.replay = mcts.init_replay(cfg.memory_size, self.device)

    def _reinit_games(self, seed: int):
        self.s2trees, self.envs = ST.init_s2_batch(seed, self.cfg.batch, self.search_cfg,
                                                   self.device)

    def step(self):
        """One batched move (B games advance one action each)."""
        envs_prev = self.envs
        self.envs, stats = self._move(self.s2trees, self.envs, self.replay)
        return self._after_move(stats, envs_prev)

    _training_columns = SelfPlayDriver._training_columns


def _host_read(parts):
    """ONE device-to-host copy of several tensors: their bytes are joined on
    the device, copied once and split on the host into numpy arrays of
    their own dtypes and shapes (order the parts by falling element size,
    so every host view is aligned)."""
    if len(parts) == 1:
        return [parts[0].cpu().numpy()]
    buf = torch.cat([p.contiguous().reshape(-1).view(torch.uint8) for p in parts])
    buf = buf.cpu().numpy()
    out, off = [], 0
    for p in parts:
        n = p.numel() * p.element_size()
        dt = torch.empty(0, dtype=p.dtype).numpy().dtype
        out.append(buf[off:off + n].view(dt).reshape(tuple(p.shape)))
        off += n
    return out
