"""`cycle` entry point of the port: the offline alternation of training and
self-play (counterpart of the reference package's `cli/cycle.py`).

Each iteration: (1) train on every saved row (`cli.train`, once a data
file exists), (2) `--n_workers` self-play runs with `--save` into
`{data_dir}/self{w}/data{cycle}.rec` (`cli.play --benchmark`: the net is
frozen while it plays), (3) one benchmark run that writes its episodes to
`{data_dir}/bench_metrics.jsonl`. The workers run one after another: one
batched run already plays `--batch` games at once on the card.
`--clear` deletes the data directory first, `--resume` starts after the
last cycle found in it, and `--dry_run` prints the commands without
running them. `--train_args` and `--play_args` append flags to the train
and to every play command (for example smaller pools). `--model` (the
net trained each cycle) defaults to vp for the VP-net agents
(ApproxPolicyIter, HybridSim, FiniteSim, FullSim), dist for DistValueSim,
else vv. DQN and DistDQN are refused with code 2, as the reference refuses
them: they train every move and save no rows.

    python -m tetris_mcts_tpu_torch cycle --iters 10 --data_dir ./data
"""

from __future__ import annotations

import argparse
import glob
import os
import re
import shlex
import shutil
import subprocess
import sys

import torch

from tetris_mcts_tpu_torch.train.trainer import DEFAULT_CKPT


def build_parser():
    p = argparse.ArgumentParser(prog="python -m tetris_mcts_tpu_torch cycle")
    p.add_argument("--iters", type=int, default=200)
    p.add_argument("--data_dir", default="./data")
    p.add_argument("--n_workers", type=int, default=1, help="self-play runs a cycle")
    p.add_argument("--ngames", type=int, default=100)
    p.add_argument("--train_sims", type=int, default=300)
    p.add_argument("--bench_sims", type=int, default=1000)
    p.add_argument("--bench_games", type=int, default=4)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--agent_type", default="ValueSimLP")
    p.add_argument("--model", default="", choices=("", "vv", "vp", "dist"),
                   help="the net trained each cycle (default: vp for the VP-net "
                        "agents, dist for DistValueSim, else vv)")
    p.add_argument("--clear", "-c", action="store_true")
    p.add_argument("--resume", "-r", action="store_true")
    p.add_argument("--checkpoint", default=DEFAULT_CKPT)
    p.add_argument("--device", default="cuda")
    p.add_argument("--train_args", default="", help="flags appended to the train command")
    p.add_argument("--play_args", default="", help="flags appended to every play command")
    p.add_argument("--dry_run", action="store_true",
                   help="print the commands without running them")
    return p


def last_cycle(data_dir: str) -> int:
    """The largest cycle number of the self-play files in data_dir (-1 when
    there is none)."""
    best = -1
    for f in glob.glob(os.path.join(data_dir, "self*/data*.rec")):
        m = re.search(r"data(\d+)\.rec$", f)
        if m:
            best = max(best, int(m.group(1)))
    return best


def run(cmd, dry):
    print("+", " ".join(shlex.quote(c) for c in cmd), flush=True)
    if not dry:
        subprocess.run(cmd, check=True)


def main(argv=None):
    from tetris_mcts_tpu_torch.cli.play import AGENT_TYPES, VP_EVALUATORS

    parser = build_parser()
    args = parser.parse_args(argv)
    if args.agent_type not in AGENT_TYPES:
        parser.error(f"--agent_type {args.agent_type}: not an agent type of play "
                     f"({', '.join(AGENT_TYPES)})")
    ev = AGENT_TYPES[args.agent_type][0]
    if ev == "dqn":
        # DQN trains per env step inside its own driver and saves no rows:
        # a cycle would self-play forever while the offline train never fires
        print("cycle: DQN agents train online per step and produce no self-play HDF5; "
              "use `play --agent_type DQN --online` instead", file=sys.stderr)
        return 2
    if not args.model:
        args.model = "vp" if ev in VP_EVALUATORS else "dist" if ev == "dist" else "vv"
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        parser.error(f"--device {args.device}: no CUDA device is available "
                     "(pass --device cpu to run the plain versions)")
    py = sys.executable
    if args.clear and os.path.isdir(args.data_dir) and not args.dry_run:
        shutil.rmtree(args.data_dir)
    os.makedirs(args.data_dir, exist_ok=True)
    start = last_cycle(args.data_dir) + 1 if args.resume else 0
    data_glob = os.path.join(args.data_dir, "self*/data*.rec")
    dev = ["--device", args.device]
    train_extra, play_extra = shlex.split(args.train_args), shlex.split(args.play_args)

    for cycle in range(start, args.iters):
        print(f"=== cycle {cycle} ===", flush=True)
        if glob.glob(data_glob):
            run([py, "-m", "tetris_mcts_tpu_torch.cli.train", "--data", data_glob,
                 "--td", "--weighted", "--weighted_mode", "1", "--model", args.model,
                 "--early_stopping", "--validation", "--cycle", str(cycle),
                 "--save_loss", os.path.join(args.data_dir, "loss"),
                 "--checkpoint", args.checkpoint, "--load_model", *dev, *train_extra],
                args.dry_run)
        for w in range(args.n_workers):
            run([py, "-m", "tetris_mcts_tpu_torch.cli.play", "--agent_type", args.agent_type,
                 "--mcts_sims", str(args.train_sims), "--ngames", str(args.ngames),
                 "--batch", str(args.batch), "--save",
                 "--save_dir", os.path.join(args.data_dir, f"self{w}"),
                 "--cycle", str(cycle), "--checkpoint", args.checkpoint, "--load_model",
                 "--benchmark", *dev, *play_extra], args.dry_run)
        run([py, "-m", "tetris_mcts_tpu_torch.cli.play", "--agent_type", args.agent_type,
             "--mcts_sims", str(args.bench_sims), "--ngames", str(args.bench_games),
             "--batch", str(max(args.bench_games, 1)), "--benchmark",
             "--checkpoint", args.checkpoint, "--load_model",
             "--metrics", os.path.join(args.data_dir, "bench_metrics.jsonl"),
             *dev, *play_extra], args.dry_run)
    return 0


if __name__ == "__main__":
    sys.exit(main())
