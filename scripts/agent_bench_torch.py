"""Per-agent throughput rows of the PyTorch/CUDA port, the counterpart of
`scripts/agent_bench.py` (which measures the JAX package): the sims/s
(steps/s for DQN) that each capability tier's driver reaches on the card.

One JSON line per agent:
  {"agent": "...", "batch": B, "sims": S, "nodes": N, "ms_per_move": ...,
   "moves_per_s": N, "sims_per_s": N, "device": "<name>, <power limit>"}
  (DQN rows: "ms_per_step" and "env_steps_per_s" in place of the move keys)

The configs are agent_bench.py's: `--batch` 256 games, `--sims` 100, pools
of `--nodes` 2048 (table the next power of two >= 2 x nodes), depth 64,
min_visits_store 25, a ring of 100000, no training session
(train_rows_trigger 10**9), a bfloat16 body, seed 0; DQN and DistDQN at
batch 1024 for 64 steps. A row times `--moves` driver steps after one
untimed step, with the device synchronised before and after the timed loop.
Each driver step reads its games back to the host once, as the JAX
drivers' steps do.

    python scripts/agent_bench_torch.py --agents vv,dqn              # on the card
    python scripts/agent_bench_torch.py --device cpu --agents vv \\
        --batch 2 --sims 2 --nodes 64 --moves 1                       # the plain versions

The DistValueSim, ValueSim2 and ApproxPolicyIter moves run their walks in
plain torch (PERF.md: seconds a move at the CLI's B=64), so their rows at
B=256 x 8 moves take minutes on the card: run them one agent at a time.
This script imports nothing of JAX or of the JAX package.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench_torch  # noqa: E402
from tetris_mcts_tpu_torch.obs.card import device_label  # noqa: E402

# agent_bench.py's sizes: games, sims, pools and timed steps of a search
# agent's row; games and timed steps of a DQN row
BATCH, SIMS, NODES, MOVES = 256, 100, 2048, 8
DQN_BATCH, DQN_STEPS = 1024, 64


def _time_steps(driver, n, dev):
    """Seconds a driver step over n steps, the first step excluded."""
    driver.step()
    bench_torch.sync(dev)
    t0 = time.perf_counter()
    for _ in range(n):
        driver.step()
    bench_torch.sync(dev)
    return (time.perf_counter() - t0) / n


def mcts_config(batch, sims, nodes, **kw):
    """agent_bench.py's `SelfPlayConfig` for a search agent."""
    from tetris_mcts_tpu_torch.runtime.selfplay import SelfPlayConfig

    return SelfPlayConfig(
        batch=batch, sims=sims, max_nodes=nodes, max_obs=nodes,
        table_size=max(1 << (2 * nodes - 1).bit_length(), 16),
        max_depth=64, min_visits_store=25, memory_size=100_000,
        train_rows_trigger=10**9, bf16=True, seed=0, **kw,
    )


def dqn_config(batch, distributional):
    """agent_bench.py's `DQNConfig`."""
    from tetris_mcts_tpu_torch.runtime.dqn import DQNConfig

    return DQNConfig(batch=batch, seed=0, distributional=distributional,
                     memory_size=100_000)


def bench_mcts_driver(name, cls, batch, sims, nodes, n_moves, dev, **kw):
    d = cls(mcts_config(batch, sims, nodes, **kw), device=dev, log=lambda s: None)
    dt = _time_steps(d, n_moves, dev)
    return {
        "agent": name, "batch": batch, "sims": sims, "nodes": nodes,
        "ms_per_move": round(dt * 1e3, 1),
        "moves_per_s": round(batch / dt, 1),
        "sims_per_s": round(batch * sims / dt, 1),
        "device": device_label(dev),
    }


def bench_dqn(name, distributional, batch, n_moves, dev):
    from tetris_mcts_tpu_torch.runtime.dqn import DQNDriver

    d = DQNDriver(dqn_config(batch, distributional), device=dev, log=lambda s: None)
    dt = _time_steps(d, n_moves, dev)
    return {
        "agent": name, "batch": batch,
        "ms_per_step": round(dt * 1e3, 2),
        "env_steps_per_s": round(batch / dt, 1),
        "device": device_label(dev),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python scripts/agent_bench_torch.py")
    ap.add_argument("--agents", default="vv,vp,dist,s2,dqn,distdqn")
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--sims", type=int, default=SIMS)
    ap.add_argument("--nodes", type=int, default=NODES)
    ap.add_argument("--moves", type=int, default=MOVES)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the card, its kernels) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    dev = bench_torch.device_arg(ap, args.device)
    want = set(args.agents.split(","))

    from tetris_mcts_tpu_torch.runtime import selfplay as sp

    b, s, n, m = args.batch, args.sims, args.nodes, args.moves
    rows = []

    def emit(row):
        rows.append(row)
        print(json.dumps(row), flush=True)

    if "vv" in want:  # the flagship (bench_torch.py's path), for context
        emit(bench_mcts_driver("ValueSimLP", sp.SelfPlayDriver, b, s, n, m, dev,
                               evaluator="lp"))
    if "vp" in want:
        emit(bench_mcts_driver("ApproxPolicyIter", sp.VPSelfPlayDriver, b, s, n, m, dev))
    if "dist" in want:
        emit(bench_mcts_driver("DistValueSim", sp.DistSelfPlayDriver, b, s, n, m, dev))
    if "s2" in want:
        emit(bench_mcts_driver("ValueSim2", sp.S2SelfPlayDriver, b, s, n, m, dev))
    if "dqn" in want:
        emit(bench_dqn("DQN", False, DQN_BATCH, DQN_STEPS, dev))
    if "distdqn" in want:
        emit(bench_dqn("DistDQN", True, DQN_BATCH, DQN_STEPS, dev))
    return rows


if __name__ == "__main__":
    main()
