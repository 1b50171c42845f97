"""Frozen-net self-play driver (the reference `runtime/selfplay.py`
`SelfPlayDriver` in benchmark mode: no replay store, no training), with
the lp, leaf or rollout evaluator (`SelfPlayConfig.evaluator`).

B games play MCTS moves in lockstep; each move is one call of the move
program (`search/mcts.make_move_fn`), which stays on the device. The host
reads back one small tensor per move (done, score, lines) for the episode
bookkeeping, and logs episodes in the reference's format:

    Episode:     N  Score:         S  Lines Cleared:    L  lines(min/max/mean):...
"""

from __future__ import annotations

import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from tetris_mcts_tpu_torch.env.engine import EnvConfig
from tetris_mcts_tpu_torch.search import mcts
from tetris_mcts_tpu_torch.search.mcts import SearchConfig
from tetris_mcts_tpu_torch.search.tree import TreeConfig
from tetris_mcts_tpu_torch.train.trainer import VVModel


class SelfPlayConfig(NamedTuple):
    batch: int = 64
    sims: int = 100
    evaluator: str = "lp"  # "lp" | "leaf" | "rollout" (mcts.EVALUATORS)
    max_nodes: int = 4096
    max_obs: int = 4096
    table_size: int = 8192
    max_depth: int = 96
    gamma: float = 0.999
    policy: str = "clt"
    low: int = 1
    bf16: bool = False
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


class SelfPlayDriver:
    """Owns the frozen model (weights made from cfg.seed), the batched
    (trees, envs) device state and the move program, whose select walk
    (and rollout) draws its randomness from a `mcts.TorchPlanes` on the
    device seeded from cfg.seed. `run(n_moves)` / `run_episodes(n)` advance
    self-play."""

    _TP_REPORT_EVERY = 50  # moves per throughput line

    def __init__(self, cfg: SelfPlayConfig, device="cuda",
                 log=lambda s: print(s, file=sys.stderr, flush=True)):
        self.cfg = cfg
        self.device = torch.device(device)
        self.log = log
        self.model = VVModel(cfg.seed, self.device)
        tree_cfg = TreeConfig(
            max_nodes=cfg.max_nodes, max_obs=cfg.max_obs,
            table_size=cfg.table_size, max_depth=cfg.max_depth,
            gamma=cfg.gamma, policy=cfg.policy, low=cfg.low,
            env=EnvConfig(actions_per_drop=cfg.actions_per_drop,
                          scoring=cfg.scoring, randomizer=cfg.randomizer),
        )
        self.search_cfg = SearchConfig(tree=tree_cfg, sims=cfg.sims,
                                       evaluator=cfg.evaluator)
        planes = mcts.TorchPlanes(cfg.seed, self.device, cfg.policy)
        apply_fn = self.model.apply_fn(torch.bfloat16 if cfg.bf16 else None)
        if cfg.evaluator == "lp":
            evaluator = mcts.nn_child_evaluator(apply_fn)
        elif cfg.evaluator == "leaf":
            evaluator = mcts.nn_leaf_evaluator(apply_fn)
        elif cfg.evaluator == "rollout":
            evaluator = mcts.rollout_evaluator(self.search_cfg, planes.actions)
        else:
            raise ValueError(f"unknown or unported evaluator {cfg.evaluator!r}")
        self.evaluator = evaluator
        self._move = mcts.make_move_fn(evaluator, self.search_cfg, planes)
        self.trees, self.envs = mcts.init_batch(cfg.seed, cfg.batch,
                                                self.search_cfg, self.device)
        self.episodes = 0
        self.moves = 0
        self.score_tracker = EpisodeTracker()
        self.line_tracker = EpisodeTracker()
        self.last_stats = None
        self._tp_t0 = time.perf_counter()
        self._tp_moves = 0

    def step(self):
        """One batched move (B games advance one action each)."""
        self.envs, stats = self._move(self.trees, self.envs)
        self.moves += 1
        self.last_stats = stats
        # the one host read of the move
        host = torch.stack([stats.done.to(torch.int64), stats.score.to(torch.int64),
                            stats.lines.to(torch.int64)]).cpu().numpy()
        done, score, lines = host[0] != 0, host[1], host[2]
        self._report_throughput()
        self._finish_episodes(done, score, lines)
        return stats

    def run(self, n_moves: int):
        for _ in range(n_moves):
            self.step()

    def run_episodes(self, n_episodes: int, max_moves: int = 10_000_000):
        target = self.episodes + n_episodes
        moves = 0
        while self.episodes < target and moves < max_moves:
            self.step()
            moves += 1

    def _report_throughput(self):
        self._tp_moves += 1
        if self._tp_moves < self._TP_REPORT_EVERY:
            return
        dt = time.perf_counter() - self._tp_t0
        moves_per_s = self._tp_moves / dt
        sims_per_s = moves_per_s * self.cfg.batch * self.cfg.sims
        self.log(f"Throughput: {moves_per_s:8.2f} moves/s  {sims_per_s:12.1f} "
                 f"sims/s  (window {self._tp_moves} moves, batch "
                 f"{self.cfg.batch}, {self.cfg.sims} sims)")
        self._tp_t0 = time.perf_counter()
        self._tp_moves = 0

    def _finish_episodes(self, done, score, lines):
        for i in np.nonzero(done)[0]:
            self.episodes += 1
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
