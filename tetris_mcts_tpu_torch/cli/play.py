"""`play` entry point of the port: MCTS self-play, online (storage and
training) or in benchmark mode.

Mirrors the reference `cli/play.py` for the agent types whose evaluator
is ported (`AGENT_TYPES`, the reference's agent -> (evaluator, trains)
map):

- ValueSimLP: the lp evaluator (the net on the leaf's 7 children), trains;
- ValueSim, ValueSimOnline: the leaf evaluator (the net on the leaf),
  train; ValueSimBayes: the leaf evaluator under `--policy bayes`, no
  training;
- Vanilla, VanillaC, Random: the rollout evaluator (uniform-random
  playouts), no training; Random searches with one simulation.

Training runs as in the reference: when the agent trains and `--online`
is given and `--benchmark` is not. It then saves the model after every
session and at the end (`--checkpoint`, default
`train/trainer.DEFAULT_CKPT`, the port's own format); `--load_model`
reads it first. `low` follows the reference: 10 under bayes, 5 for
Vanilla/VanillaC, else 1. The reference's other agent types, and any
reference flag this port does not read, are refused with a message that
names them.

    python -m tetris_mcts_tpu_torch play --agent_type ValueSimLP --online
"""

from __future__ import annotations

import argparse
import signal
import sys

import torch

from tetris_mcts_tpu_torch.ops.tree_walk import POLICIES
from tetris_mcts_tpu_torch.train.trainer import DEFAULT_CKPT

# the JAX CLI's defaults: --batch 64, --mcts_sims 100, --max_nodes/--max_obs
# 4096, --max_depth 96, clt policy, gamma 0.999

# agent type -> (evaluator, trains), for the agents the port runs
AGENT_TYPES = {
    "ValueSimLP": ("lp", True),
    "ValueSim": ("leaf", True), "ValueSimOnline": ("leaf", True),
    "ValueSimBayes": ("leaf", False),
    "Vanilla": ("rollout", False), "VanillaC": ("rollout", False),
    "Random": ("rollout", False),
}
# the reference CLI's other agent types, not ported yet
UNPORTED_AGENT_TYPES = ("ValueSimC", "ApproxPolicyIter", "DistValueSim",
                        "HybridSim", "FiniteSim", "FullSim", "ValueSim2",
                        "DQN", "DistDQN")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m tetris_mcts_tpu_torch play",
        description="Batched MCTS Tetris self-play with online VV-net "
                    "training (PyTorch/CUDA port)",
    )
    p.add_argument("--agent_type", default="ValueSimLP",
                   choices=tuple(AGENT_TYPES) + UNPORTED_AGENT_TYPES)
    p.add_argument("--mcts_sims", type=int, default=100)
    p.add_argument("--ngames", type=int, default=50)
    p.add_argument("--benchmark", action="store_true",
                   help="no training, no storage")
    p.add_argument("--online", action="store_true",
                   help="online training (for the agents that train)")
    p.add_argument("--app", type=int, default=1)
    p.add_argument("--scoring", type=int, default=0, choices=(0, 1))
    p.add_argument("--randomizer", type=int, default=0, choices=(0, 1))
    p.add_argument("--gamma", type=float, default=0.999)
    p.add_argument("--policy", default="clt", choices=POLICIES)
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
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--load_model", action="store_true",
                   help="load --checkpoint before playing")
    p.add_argument("--checkpoint", default=DEFAULT_CKPT,
                   help="the port's checkpoint (torch.save of params, Yogi "
                        "state and bounds)")
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--max_nodes", type=int, default=4096)
    p.add_argument("--max_obs", type=int, default=4096)
    p.add_argument("--episode_reuse", type=int, nargs="?", const=1, default=0,
                   help="1: done lanes re-root in their own pool; only pool "
                        "exhaustion resets a tree")
    p.add_argument("--max_depth", type=int, default=96)
    p.add_argument("--memory_size", type=int, default=100000)
    p.add_argument("--memory_growth", type=int, default=5000)
    p.add_argument("--train_rows", type=int, default=5000)
    p.add_argument("--train_batch", type=int, default=128)
    p.add_argument("--train_iters_per_val", type=int, default=100)
    p.add_argument("--train_max_iters", type=int, default=50000)
    p.add_argument("--max_moves", type=int, default=10_000_000)
    p.add_argument("--metrics", default="", help="JSONL metrics path ('' = off)")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 conv/fc body in the search forward")
    p.add_argument("--device", default="cuda")
    return p


def main(argv=None):
    from tetris_mcts_tpu_torch.runtime.selfplay import SelfPlayConfig, SelfPlayDriver
    from tetris_mcts_tpu_torch.train.trainer import VVModel

    argv = sys.argv[1:] if argv is None else list(argv)
    parser = build_parser()
    args, unknown = parser.parse_known_args(argv)
    if unknown:
        parser.error(f"not supported by the port yet: {' '.join(unknown)} (see "
                     "README.md)")
    if args.agent_type in UNPORTED_AGENT_TYPES:
        parser.error(
            f"--agent_type {args.agent_type} is not ported yet (the port runs "
            f"{', '.join(AGENT_TYPES)})")
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        parser.error(f"--device {args.device}: no CUDA device is available "
                     "(pass --device cpu to run the plain versions)")
    evaluator, trains = AGENT_TYPES[args.agent_type]
    if args.agent_type == "ValueSimBayes":
        args.policy = "bayes"  # the agent is the policy choice
    if args.policy == "bayes":
        low = 10  # select_index_bayes min_n
    elif args.agent_type in ("Vanilla", "VanillaC"):
        low = 5   # Vanilla.py low=5
    else:
        low = 1
    # online training iff the agent trains, --online is set, and not
    # --benchmark (the reference's gating)
    benchmark = args.benchmark or not (trains and args.online)
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
        episode_reuse=bool(args.episode_reuse), bf16=args.bf16,
        checkpoint_each_train=trains and not benchmark,
        dump_dir=args.dump_dir, seed=args.seed, actions_per_drop=args.app,
        scoring=args.scoring, randomizer=args.randomizer,
    )
    model = VVModel(args.seed, args.device, checkpoint_path=args.checkpoint)
    if args.load_model:
        model.load()
    metrics = None
    if args.metrics:
        from tetris_mcts_tpu_torch.obs.metrics import MetricsWriter
        metrics = MetricsWriter(args.metrics)
    driver = SelfPlayDriver(cfg, model=model, device=args.device, metrics=metrics)

    # SIGTERM takes the interrupt path, so the final save runs
    def _term(signum, frame):
        raise KeyboardInterrupt

    prev_term = signal.signal(signal.SIGTERM, _term)
    try:
        driver.run_episodes(args.ngames, max_moves=args.max_moves)
    except KeyboardInterrupt:
        print("interrupted", file=sys.stderr)
    finally:
        signal.signal(signal.SIGTERM, prev_term)
        if trains and not benchmark:
            model.save(verbose=True)
        if metrics is not None:
            metrics.close()
    return driver


if __name__ == "__main__":
    main()
