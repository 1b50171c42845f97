"""`play` entry point of the port: MCTS self-play, online (storage and
training) or in benchmark mode.

Mirrors the reference `cli/play.py` for all of its agent types
(`AGENT_TYPES`, the reference's agent -> (evaluator, trains) map):

- ValueSimLP, ValueSimC: the lp evaluator (the net on the leaf's 7
  children), train;
- ValueSim, ValueSimOnline: the leaf evaluator (the net on the leaf),
  train; ValueSimBayes: the leaf evaluator under `--policy bayes`, no
  training;
- Vanilla, VanillaC, Random: the rollout evaluator (uniform-random
  playouts), no training; Random searches with one simulation;
- ApproxPolicyIter: the VP search (`search/vp.py`) on the VP net, trains;
- HybridSim, FiniteSim, FullSim: playouts guided by the VP net's policy,
  30 and 50 steps and to the game's end (`--rollout_depth` overrides), no
  training;
- DistValueSim: the distributional (C51) search
  (`search/distributional.py`) on the distributional net (50 bins on [0,
  1000]), trains;
- ValueSim2: the stochastic-transition search (`search/stochastic.py`) on
  the VV net, no training;
- DQN, DistDQN: the DQN agent (`runtime/dqn.py`, no tree) with the
  standard or the C51 head (50 bins on [0, 2500]); it trains every move
  unless `--benchmark` is given (`--online` is not read), saves its nets
  at the end (default `train/trainer.DQN_DEFAULT_CKPT`), and stores no
  rows: `--save` and `--status_dir` are ignored with a message.

Training runs as in the reference: when the agent trains and `--online`
is given and `--benchmark` is not. It then saves the model after every
session and at the end (`--checkpoint`, the port's own format; its
default is the VV net's `train/trainer.DEFAULT_CKPT`, redirected to
`VP_DEFAULT_CKPT` for the VP-net agents and `DIST_DEFAULT_CKPT` for
DistValueSim, `cli.resolve_ckpt`); `--load_model` reads it first, a
checkpoint of the JAX package too. `--low` defaults as in the reference:
10 under bayes, 5 for Vanilla/VanillaC and DistValueSim, else 1. A
reference flag this port does not read is refused with a message that
names it.

The search's walks: `--select_kernel 0` and `--insert_kernel 0` run that
step's plain walk on the card in place of its kernel (both default to 1,
the kernels); `--policy max` runs the plain select walk and backups, which
keep its `vmax` statistic, as the reference runs its XLA walks for it.
`--allow_clamp` accepts pools too small for one move (a degraded search,
with a warning) instead of refusing them.

Channels: `--save` writes one row a game a move to
`{save_dir}/{save_file}{cycle}.rec` (`utils/data.DataSaver`),
`--save_tree` the trees' searched observations to
`{save_dir}/tree{cycle}.npz` at the end (not for ValueSim2, as in the
reference), `--status_dir` the live-state
memmaps, `--printboard` game 0's board each move, `--metrics` a JSONL
event log. `--endless` plays until interrupted (SIGINT or SIGTERM; the
final saves run). A stall watchdog (`--stall_timeout`, on by default)
exits with code 86 when the host loop makes no progress. `--trace DIR`
profiles `--trace_moves` moves after 2 warm-up moves into a Chrome trace
and saves no checkpoint. `--interactive` plays one game from actions
typed on stdin.

    python -m tetris_mcts_tpu_torch play --agent_type ValueSimLP --online
"""

from __future__ import annotations

import argparse
import contextlib
import os
import signal
import sys

import torch

from tetris_mcts_tpu_torch.cli import resolve_ckpt
from tetris_mcts_tpu_torch.ops.tree_walk import POLICIES
from tetris_mcts_tpu_torch.train.trainer import DEFAULT_CKPT

# the JAX CLI's defaults: --batch 64, --mcts_sims 100, --max_nodes/--max_obs
# 4096, --max_depth 96, clt policy, gamma 0.999

# agent type -> (evaluator, trains), for the agents the port runs
AGENT_TYPES = {
    "ValueSimLP": ("lp", True), "ValueSimC": ("lp", True),
    "ValueSim": ("leaf", True), "ValueSimOnline": ("leaf", True),
    "ValueSimBayes": ("leaf", False),
    "Vanilla": ("rollout", False), "VanillaC": ("rollout", False),
    "Random": ("rollout", False),
    "ApproxPolicyIter": ("vp", True),
    "HybridSim": ("hybrid", False), "FiniteSim": ("finite", False),
    "FullSim": ("full", False),
    "DistValueSim": ("dist", True),
    "ValueSim2": ("s2", False),
    "DQN": ("dqn", True), "DistDQN": ("dqn", True),
}
# the evaluators that run on the VP net
VP_EVALUATORS = ("vp", "hybrid", "finite", "full")
# the selection rules of --policy: the select kernel's (ops/tree_walk.POLICIES)
# and max, which runs the plain walks
POLICY_CHOICES = POLICIES + ("max",)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m tetris_mcts_tpu_torch play",
        description="Batched MCTS Tetris self-play with online VV-net "
                    "training (PyTorch/CUDA port)",
    )
    p.add_argument("--agent_type", default="ValueSimLP", choices=tuple(AGENT_TYPES))
    p.add_argument("--mcts_sims", type=int, default=100)
    p.add_argument("--ngames", type=int, default=50)
    p.add_argument("--endless", action="store_true",
                   help="play until interrupted (the final saves run)")
    p.add_argument("--benchmark", action="store_true",
                   help="no training, no storage")
    p.add_argument("--online", action="store_true",
                   help="online training (for the agents that train)")
    p.add_argument("--save", action="store_true",
                   help="save one row a game a move to save_dir/save_file<cycle>.rec")
    p.add_argument("--save_tree", action="store_true",
                   help="dump the trees' searched observations to "
                        "save_dir/tree<cycle>.npz at the end")
    p.add_argument("--printboard", action="store_true",
                   help="print game 0's board each move")
    p.add_argument("--interactive", action="store_true",
                   help="play one game from actions 0-6 typed on stdin (no agent)")
    p.add_argument("--save_dir", default="./data")
    p.add_argument("--save_file", default="data")
    p.add_argument("--cycle", type=int, default=0)
    p.add_argument("--app", type=int, default=1)
    p.add_argument("--scoring", type=int, default=0, choices=(0, 1))
    p.add_argument("--randomizer", type=int, default=0, choices=(0, 1))
    p.add_argument("--gamma", type=float, default=0.999)
    p.add_argument("--policy", default="clt", choices=POLICY_CHOICES,
                   help="selection rule; max runs the plain select walk and backups")
    p.add_argument("--low", type=int, default=None,
                   help="visits under which children are chosen first, before the "
                        "policy (default: 10 under bayes, 5 for Vanilla/VanillaC and "
                        "DistValueSim, else 1)")
    p.add_argument("--dump_dir", default="",
                   help="write dump.npz of each session's training set here "
                        "('' = off)")
    p.add_argument("--min_visits", type=int, default=25)
    p.add_argument("--acc_policy", type=int, default=-1, choices=(-1, 0, 1, 2, 3),
                   help="-1: growth-gated ring; 0-3: the C++ agent's "
                        "accumulation policies")
    p.add_argument("--episodes_per_train", type=int, default=25)
    p.add_argument("--trim_fraction", type=float, default=0.01)
    p.add_argument("--benchmark_every", type=int, default=0,
                   help="play benchmark games every N episodes (0 = off)")
    p.add_argument("--benchmark_games", type=int, default=8)
    p.add_argument("--benchmark_sims", type=int, default=0,
                   help="sims a move in benchmark games (0 = 2x --mcts_sims)")
    p.add_argument("--benchmark_batch", type=int, default=0)
    p.add_argument("--benchmark_max_moves", type=int, default=5000)
    p.add_argument("--benchmark_max_nodes", type=int, default=0)
    p.add_argument("--allow_clamp", action="store_true",
                   help="accept max_nodes/max_obs too small for one move (a degraded "
                        "search: the sims past the pool expand nothing) instead of "
                        "refusing them")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--load_model", action="store_true",
                   help="load --checkpoint before playing")
    p.add_argument("--checkpoint", default=DEFAULT_CKPT,
                   help="the port's checkpoint (torch.save of params, optimizer "
                        "state and bounds); the default is redirected to "
                        "model_vp_torch.pt for the VP-net agents")
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--max_nodes", type=int, default=4096)
    p.add_argument("--max_obs", type=int, default=4096)
    p.add_argument("--episode_reuse", type=int, nargs="?", const=1, default=0,
                   help="1: done lanes re-root in their own pool; only pool "
                        "exhaustion resets a tree")
    p.add_argument("--max_depth", type=int, default=96)
    p.add_argument("--rollout_depth", type=int, default=0,
                   help="policy-playout depth for HybridSim/FiniteSim/FullSim "
                        "(0 = the agents' 30/50/to the end)")
    p.add_argument("--memory_size", type=int, default=100000)
    p.add_argument("--memory_growth", type=int, default=5000)
    p.add_argument("--train_rows", type=int, default=5000)
    p.add_argument("--train_batch", type=int, default=128)
    p.add_argument("--train_iters_per_val", type=int, default=100)
    p.add_argument("--train_max_iters", type=int, default=50000)
    p.add_argument("--max_moves", type=int, default=10_000_000)
    p.add_argument("--metrics", default="", help="JSONL metrics path ('' = off)")
    p.add_argument("--status_dir", default="",
                   help="publish the live-state memmaps here ('' = off)")
    p.add_argument("--trace", default="",
                   help="profile --trace_moves moves after 2 warm-up moves into a Chrome "
                        "trace in this directory, then stop ('' = off)")
    p.add_argument("--trace_moves", type=int, default=4)
    p.add_argument("--stall_timeout", type=float, default=900,
                   help="seconds without host-loop progress before the stall watchdog "
                        "exits with code 86 (0 = off)")
    p.add_argument("--stall_startup", type=float, default=3600,
                   help="the watchdog's allowance at startup, at a training session and "
                        "at the benchmark twin's first move")
    p.add_argument("--select_kernel", type=int, nargs="?", const=1, default=1,
                   choices=(0, 1),
                   help="1: the select kernel (default); 0: the plain select walk")
    p.add_argument("--insert_kernel", type=int, nargs="?", const=1, default=1,
                   choices=(0, 1),
                   help="1: the insert kernel (default); 0: the plain insert")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 conv/fc body in the search forward")
    p.add_argument("--device", default="cuda")
    return p


def interactive_loop(args) -> int:
    """One game (and more on request) from actions 0-6 typed on stdin,
    with the board printed before each; no agent."""
    from tetris_mcts_tpu_torch.cli.replay import render
    from tetris_mcts_tpu_torch.env import engine

    cfg = engine.EnvConfig(actions_per_drop=args.app, scoring=args.scoring,
                           randomizer=args.randomizer)
    envs = engine.reset_batch(args.seed, 1, cfg, device=args.device)
    names = "0 noop  1 left  2 right  3 soft  4 ccw  5 cw  6 hard"
    games = 0

    def show(s):
        print(render(engine.get_state(s)[0].cpu().numpy(), int(s.score[0]),
                     int(s.lines[0]), int(s.combo[0])))

    while True:
        show(envs)
        try:
            action = int(input(f"Play ({names}): "))
        except (ValueError, EOFError):
            return 0
        if not 0 <= action <= 6:
            continue
        envs = engine.step_batch(envs, torch.full((1,), action, device=args.device), cfg)
        if bool(envs.end[0]):
            show(envs)
            print(f"Game over — score {int(envs.score[0])}, lines {int(envs.lines[0])}")
            try:
                if input("Play more? (y/n): ").strip() != "y":
                    return 0
            except EOFError:
                return 0
            games += 1
            envs = engine.reset_batch(args.seed + games, 1, cfg, device=args.device)


class _PrintBoard:
    """--printboard: a status channel that prints game 0's pre-move board
    and passes the publish on to an optional inner StatusPublisher."""

    def __init__(self, inner=None):
        self.inner = inner

    def publish(self, board, combo, score, lines, line_stats):
        if self.inner is not None:
            self.inner.publish(board, combo, score, lines, line_stats)
        from tetris_mcts_tpu_torch.cli.replay import render

        print(render(board, int(score[0]), int(lines[0]), int(combo[0])), flush=True)


def capture_trace(driver, directory: str, moves: int, device):
    """2 warm-up moves, then `moves` moves under torch.profiler (the card's
    kernels too on a card), written as a Chrome trace into `directory`."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        driver.step()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=acts) as prof:
        for _ in range(moves):
            driver.step()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, "trace.json")
    prof.export_chrome_trace(path)
    print(f"Trace of {moves} moves written to {path}", file=sys.stderr)


def _interrupt_on_sigterm(finally_):
    """SIGTERM takes the interrupt path, so the final steps run; the
    previous handler comes back with them."""

    def _term(signum, frame):
        raise KeyboardInterrupt

    finally_.callback(signal.signal, signal.SIGTERM, signal.signal(signal.SIGTERM, _term))


def play_dqn(args, finally_):
    """The DQN and DistDQN agents (the reference CLI's DQN branch): play until
    --ngames episodes have ended (or --endless) within --max_moves moves,
    training every move unless --benchmark; the final save (not after
    --benchmark or --trace) is one of `finally_`'s steps."""
    from tetris_mcts_tpu_torch.runtime.dqn import DQNConfig, DQNDriver

    if args.save or args.status_dir:
        print("--save/--status_dir are not supported for DQN agents (no tree statistics "
              "to store)", file=sys.stderr)
    metrics = None
    if args.metrics:
        from tetris_mcts_tpu_torch.obs.metrics import MetricsWriter
        metrics = MetricsWriter(args.metrics)
        finally_.callback(metrics.close)
    driver = DQNDriver(
        DQNConfig(batch=args.batch, memory_size=args.memory_size,
                  distributional=args.agent_type == "DistDQN", benchmark=args.benchmark,
                  seed=args.seed, actions_per_drop=args.app, scoring=args.scoring,
                  randomizer=args.randomizer),
        device=args.device, metrics=metrics,
        checkpoint_path=resolve_ckpt(args.checkpoint, "dqn"))
    if args.load_model:
        driver.load()
    if not args.benchmark and not args.trace:
        finally_.callback(driver.save, verbose=True)
    _interrupt_on_sigterm(finally_)
    try:
        if args.trace:
            capture_trace(driver, args.trace, args.trace_moves, driver.device)
            return driver
        moves = 0
        while (args.endless or driver.episodes < args.ngames) and moves < args.max_moves:
            driver.step()
            moves += 1
    except KeyboardInterrupt:
        print("interrupted", file=sys.stderr)
    return driver


def main(argv=None):
    from tetris_mcts_tpu_torch.runtime import watchdog
    from tetris_mcts_tpu_torch.runtime.selfplay import (DistSelfPlayDriver, S2SelfPlayDriver,
                                                        SelfPlayConfig, SelfPlayDriver,
                                                        VPSelfPlayDriver)
    from tetris_mcts_tpu_torch.train.trainer import DistModel, VPModel, VVModel

    argv = sys.argv[1:] if argv is None else list(argv)
    parser = build_parser()
    args, unknown = parser.parse_known_args(argv)
    if unknown:
        parser.error(f"not supported by the port yet: {' '.join(unknown)} (see "
                     "README.md)")
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        parser.error(f"--device {args.device}: no CUDA device is available "
                     "(pass --device cpu to run the plain versions)")
    if args.interactive:
        return interactive_loop(args)
    evaluator, trains = AGENT_TYPES[args.agent_type]
    if args.agent_type == "ValueSimBayes":
        args.policy = "bayes"  # the agent is the policy choice
    if args.low is not None:
        low = args.low
    elif args.policy == "bayes":
        low = 10  # select_index_bayes min_n
    elif args.agent_type in ("Vanilla", "VanillaC", "DistValueSim"):
        low = 5   # Vanilla.py low=5, select_trace_distributional low=5
    else:
        low = 1
    # online training iff the agent trains, --online is set, and not
    # --benchmark (the reference's gating)
    benchmark = args.benchmark or not (trains and args.online)
    # a --trace run is a profiling probe: it never writes a checkpoint
    saves_model = trains and not benchmark and not args.trace
    cfg = SelfPlayConfig(
        batch=args.batch, sims=1 if args.agent_type == "Random" else args.mcts_sims,
        evaluator=evaluator,
        max_nodes=args.max_nodes, max_obs=args.max_obs,
        # power of two and >= 2x max_obs, as the reference CLI sizes it
        table_size=max(1 << (2 * args.max_obs - 1).bit_length(), 16),
        max_depth=args.max_depth, gamma=args.gamma, policy=args.policy,
        low=low, min_visits_store=args.min_visits,
        memory_size=args.memory_size, memory_growth=args.memory_growth,
        train_rows_trigger=args.train_rows, train_batch=args.train_batch,
        train_iters_per_val=args.train_iters_per_val,
        train_max_iters=args.train_max_iters, benchmark=benchmark,
        acc_policy=args.acc_policy, episodes_per_train=args.episodes_per_train,
        trim_fraction=args.trim_fraction,
        benchmark_every=0 if benchmark else args.benchmark_every,
        benchmark_games=args.benchmark_games, benchmark_sims=args.benchmark_sims,
        benchmark_batch=args.benchmark_batch,
        benchmark_max_moves=args.benchmark_max_moves,
        benchmark_max_nodes=args.benchmark_max_nodes,
        episode_reuse=bool(args.episode_reuse), rollout_depth=args.rollout_depth,
        bf16=args.bf16, allow_clamp=args.allow_clamp,
        select_kernel=bool(args.select_kernel), insert_kernel=bool(args.insert_kernel),
        checkpoint_each_train=saves_model,
        dump_dir=args.dump_dir, seed=args.seed, actions_per_drop=args.app,
        scoring=args.scoring, randomizer=args.randomizer,
    )
    # the final steps run last-registered first, each whatever the ones
    # before it did: restore SIGTERM, dump the trees, save the model, close
    # the saver, then the metrics, stop the watchdog
    with contextlib.ExitStack() as finally_:
        if args.stall_timeout > 0:
            wd = watchdog.install(watchdog.StallWatchdog(
                stall_timeout=args.stall_timeout, startup_timeout=args.stall_startup))
            finally_.callback(watchdog.install, None)
            finally_.callback(wd.stop)
            wd.start()
        if evaluator == "dqn":
            return play_dqn(args, finally_)
        if evaluator in VP_EVALUATORS:
            model = VPModel(args.seed, args.device,
                            checkpoint_path=resolve_ckpt(args.checkpoint, "vp"))
        elif evaluator == "dist":
            model = DistModel(seed=args.seed, device=args.device,
                              checkpoint_path=resolve_ckpt(args.checkpoint, "dist"))
        else:
            model = VVModel(args.seed, args.device, checkpoint_path=args.checkpoint)
        if args.load_model:
            model.load()
        saver = metrics = status = None
        if args.metrics:
            from tetris_mcts_tpu_torch.obs.metrics import MetricsWriter
            metrics = MetricsWriter(args.metrics)
            finally_.callback(metrics.close)
        if args.save:
            from tetris_mcts_tpu_torch.utils.data import DataSaver
            saver = DataSaver(args.save_dir, args.save_file, cycle=args.cycle)
            finally_.callback(saver.close)
        if args.status_dir:
            from tetris_mcts_tpu_torch.obs.metrics import StatusPublisher
            status = StatusPublisher(args.status_dir, batch=args.batch)
        if args.printboard:
            status = _PrintBoard(status)
        driver_cls = {"vp": VPSelfPlayDriver, "dist": DistSelfPlayDriver,
                      "s2": S2SelfPlayDriver}.get(evaluator, SelfPlayDriver)
        driver = driver_cls(cfg, model=model, device=args.device, metrics=metrics,
                            saver=saver, status=status)
        if saves_model:
            finally_.callback(model.save, verbose=True)
        if args.save_tree and driver.save_nodes is None:
            print("--save_tree: only VV-tree agents store (value, variance) per "
                  "observation; ignored", file=sys.stderr)
        elif args.save_tree:
            os.makedirs(args.save_dir, exist_ok=True)
            finally_.callback(driver.save_nodes,
                              os.path.join(args.save_dir, f"tree{args.cycle}.npz"))
        _interrupt_on_sigterm(finally_)
        try:
            if args.trace:
                capture_trace(driver, args.trace, args.trace_moves, driver.device)
            elif args.endless:
                while True:
                    driver.step()
            else:
                driver.run_episodes(args.ngames, max_moves=args.max_moves)
        except KeyboardInterrupt:
            print("interrupted", file=sys.stderr)
    return driver


if __name__ == "__main__":
    main()
