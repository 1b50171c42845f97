"""`play` entry point of the port: frozen-net MCTS self-play.

Mirrors the reference `cli/play.py` without `--online` (benchmark mode: no
training, no storage), with the VV net's weights made from `--seed`, for
the agent types whose evaluator is ported (`AGENT_TYPES`, the reference's
agent -> evaluator map):

- ValueSimLP: the lp evaluator (the net on the leaf's 7 children);
- ValueSim, ValueSimOnline, ValueSimBayes: the leaf evaluator (the net on
  the leaf); ValueSimBayes forces `--policy bayes`;
- Vanilla, VanillaC, Random: the rollout evaluator (uniform-random
  playouts); Random searches with one simulation.

`low` follows the reference: 10 under bayes, 5 for Vanilla/VanillaC, else
1. The reference's other agent types, and any reference flag this path does
not read, are refused with a message that names them.

    python -m tetris_mcts_tpu_torch play --agent_type ValueSim --ngames 4
"""

from __future__ import annotations

import argparse
import sys

import torch

from tetris_mcts_tpu_torch.ops.tree_walk import POLICIES

# the JAX CLI's defaults: --batch 64, --mcts_sims 100, --max_nodes/--max_obs
# 4096, --max_depth 96, clt policy, gamma 0.999

# agent type -> evaluator, for the agents the port runs
AGENT_TYPES = {
    "ValueSimLP": "lp",
    "ValueSim": "leaf", "ValueSimOnline": "leaf", "ValueSimBayes": "leaf",
    "Vanilla": "rollout", "VanillaC": "rollout", "Random": "rollout",
}
# the reference CLI's other agent types, not ported yet
UNPORTED_AGENT_TYPES = ("ValueSimC", "ApproxPolicyIter", "DistValueSim",
                        "HybridSim", "FiniteSim", "FullSim", "ValueSim2",
                        "DQN", "DistDQN")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m tetris_mcts_tpu_torch play",
        description="Batched MCTS Tetris self-play with a frozen VV net "
                    "(PyTorch/CUDA port)",
    )
    p.add_argument("--agent_type", default="ValueSimLP",
                   choices=tuple(AGENT_TYPES) + UNPORTED_AGENT_TYPES)
    p.add_argument("--mcts_sims", type=int, default=100)
    p.add_argument("--ngames", type=int, default=50)
    p.add_argument("--benchmark", action="store_true",
                   help="accepted for parity: the port always runs in "
                        "benchmark mode (no training, no storage)")
    p.add_argument("--app", type=int, default=1)
    p.add_argument("--scoring", type=int, default=0, choices=(0, 1))
    p.add_argument("--randomizer", type=int, default=0, choices=(0, 1))
    p.add_argument("--gamma", type=float, default=0.999)
    p.add_argument("--policy", default="clt", choices=POLICIES)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--max_nodes", type=int, default=4096)
    p.add_argument("--max_obs", type=int, default=4096)
    p.add_argument("--max_depth", type=int, default=96)
    p.add_argument("--max_moves", type=int, default=10_000_000)
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 conv/fc body in the search forward")
    p.add_argument("--device", default="cuda")
    return p


def main(argv=None):
    from tetris_mcts_tpu_torch.runtime.selfplay import SelfPlayConfig, SelfPlayDriver

    argv = sys.argv[1:] if argv is None else list(argv)
    parser = build_parser()
    args, unknown = parser.parse_known_args(argv)
    if unknown:
        parser.error(
            f"not supported by the port yet: {' '.join(unknown)} (the port "
            "runs frozen-net self-play; see README.md)")
    if args.agent_type in UNPORTED_AGENT_TYPES:
        parser.error(
            f"--agent_type {args.agent_type} is not ported yet (the port runs "
            f"{', '.join(AGENT_TYPES)})")
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        parser.error(f"--device {args.device}: no CUDA device is available "
                     "(pass --device cpu to run the plain versions)")
    if args.agent_type == "ValueSimBayes":
        args.policy = "bayes"  # the agent is the policy choice
    if args.policy == "bayes":
        low = 10  # select_index_bayes min_n
    elif args.agent_type in ("Vanilla", "VanillaC"):
        low = 5   # Vanilla.py low=5
    else:
        low = 1
    cfg = SelfPlayConfig(
        batch=args.batch, sims=1 if args.agent_type == "Random" else args.mcts_sims,
        evaluator=AGENT_TYPES[args.agent_type],
        max_nodes=args.max_nodes, max_obs=args.max_obs,
        # power of two and >= 2x max_obs, as the reference CLI sizes it
        table_size=max(1 << (2 * args.max_obs - 1).bit_length(), 16),
        max_depth=args.max_depth, gamma=args.gamma, policy=args.policy,
        low=low, bf16=args.bf16,
        seed=args.seed, actions_per_drop=args.app, scoring=args.scoring,
        randomizer=args.randomizer,
    )
    driver = SelfPlayDriver(cfg, device=args.device)
    try:
        driver.run_episodes(args.ngames, max_moves=args.max_moves)
    except KeyboardInterrupt:
        print("interrupted", file=sys.stderr)
    return driver


if __name__ == "__main__":
    main()
