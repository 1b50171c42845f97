"""Weak scaling of the port's env-steps/s, MCTS sims/s and training rows/s
over ranks, the counterpart of `scripts/scaling_bench.py` (which measures
the JAX package over `jax.sharding.Mesh` sizes).

For each size n, n ranks are spawned (`runtime/distributed.spawn`: one
process a card, NCCL on the cards, gloo on the CPU) and joined in one mesh
(`parallel/mesh.make_mesh`); the batch per rank is fixed, so the global
batch grows with n:

- env: `bench_torch.bench_env` at n x 8192 boards (CPU: 512), 512 steps
  (CPU: 64), each rank stepping its rows with its rows of the global draws;
- mcts: `bench_torch.bench_mcts` at n x 256 games (CPU: 16), 100 sims (CPU:
  8), 8 moves (CPU: 2) a run, bench_torch's program (pools 2048, table
  4096, depth 64, the insert kernel, a bfloat16 body, the store on): each
  rank runs the lp move on its rows (`parallel/mesh.sharded_move_fn`) and
  the replicated ring takes every rank's rows;
- train: `parallel/mesh.make_sharded_learner` steps at a global minibatch
  of n x 512 (CPU: 64) rows, 64 steps (CPU: 8) a run, on max(4 x 512, n x
  512) random rows, the gradients summed over the ranks.

Each rate is the best of --reps runs after a warm-up run, each run ended by
a synchronisation and a barrier of every rank. Sizes above the cards
present (`torch.cuda.device_count()`) are dropped, as scaling_bench.py
drops sizes above its devices: on a machine with one card only size 1
runs. `--device cpu --virtual N` stands in for scaling_bench.py's
`--virtual N` (N virtual CPU devices): up to N gloo ranks on the CPU, at the
CPU sizes; the rows then say "virtual": true, and their rates say how the
sharded program behaves, not what hardware does.

    python scripts/scaling_bench_torch.py --sizes 1,2,4            # the cards present
    python scripts/scaling_bench_torch.py --device cpu --virtual 2 --sizes 1,2

Prints one JSON line per size and a summary line with the weak-scaling
efficiency rate(n) / (n x rate(1)), with scaling_bench.py's keys. This
script imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import bench_torch  # noqa: E402
from tetris_mcts_tpu_torch.obs.card import device_label  # noqa: E402
from tetris_mcts_tpu_torch.parallel import mesh as M  # noqa: E402
from tetris_mcts_tpu_torch.runtime import distributed as D  # noqa: E402
from tetris_mcts_tpu_torch.train.trainer import VVModel  # noqa: E402

# the per-rank sizes on a card and on the CPU (scaling_bench.py's TPU and CPU sizes)
SIZES = {
    "cuda": dict(batch_per_device=256, env_batch_per_device=8192, sims=100, moves=8,
                 env_steps=512, train_batch=512, train_steps=64),
    "cpu": dict(batch_per_device=16, env_batch_per_device=512, sims=8, moves=2,
                env_steps=64, train_batch=64, train_steps=8),
}
SPAWN_TIMEOUT_S = 1800


def parser():
    p = argparse.ArgumentParser(prog="python scripts/scaling_bench_torch.py")
    p.add_argument("--sizes", default="1,2,4,8", help="comma-separated rank counts to measure")
    p.add_argument("--virtual", type=int, default=0,
                   help="with --device cpu: up to N gloo ranks on the CPU (0 = one)")
    p.add_argument("--batch_per_device", type=int, default=0,
                   help="games per rank (0 = auto: 256 card / 16 CPU)")
    p.add_argument("--env_batch_per_device", type=int, default=0,
                   help="env-bench boards per rank (0 = auto)")
    p.add_argument("--sims", type=int, default=0, help="sims per move (0 = auto: 100 / 8)")
    p.add_argument("--moves", type=int, default=0, help="moves per timed rep (0 = auto)")
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--out", default="", help="also append JSONL here")
    p.add_argument("--device", default="cuda",
                   help="cuda (default: one rank a card) or cpu (gloo ranks)")
    return p


def bench_train(mesh, rows: int, batch_size: int, steps: int, reps: int, dev, seed: int = 0):
    """Data-parallel training rows/s: `steps` learner steps a run at the
    global minibatch `batch_size` of random rows (scaling_bench.py's data),
    the same indices on every rank."""
    model = VVModel(seed=seed, device=dev)
    rng = np.random.RandomState(seed)
    data = (torch.as_tensor(np.moveaxis(rng.randint(0, 2, (rows, 20, 10, 1)), 3, 1),
                            dtype=torch.float32, device=dev),
            torch.as_tensor(rng.uniform(0, 50, rows), dtype=torch.float32, device=dev),
            torch.as_tensor(rng.uniform(1, 10, rows), dtype=torch.float32, device=dev),
            torch.ones(rows, device=dev))
    state, step = M.make_sharded_learner(model, mesh)
    gen = torch.Generator(device=dev)

    def run():
        nonlocal state
        gen.manual_seed(seed)
        for _ in range(steps):
            idx = torch.randint(0, rows, (batch_size,), generator=gen, device=dev)
            state, _, _ = step(state, model.ubound, data, idx)

    secs = bench_torch.timed_runs(run, reps, dev, mesh)
    return batch_size * steps / min(secs)


def _rank(rank, n, device, sizes, reps):
    dev = D.rank_device(device)
    mesh = M.make_mesh()
    if mesh.world != n:
        raise RuntimeError(f"a mesh of {mesh.world} ranks, want {n}")
    s = sizes
    env_rate, envs = bench_torch.bench_env(n * s["env_batch_per_device"], s["env_steps"],
                                           reps, device=dev, mesh=mesh)
    seen = {"env": envs.shape[0]}
    sims_rate, _ = bench_torch.bench_mcts(
        n * s["batch_per_device"], s["sims"], s["moves"], reps, device=dev, mesh=mesh,
        on_move=lambda envs, stats, rep: seen.__setitem__("mcts", envs.shape[0]))
    train_bs = s["train_batch"]
    train_rate = bench_train(mesh, max(4 * train_bs, n * train_bs), n * train_bs,
                             s["train_steps"], reps, dev)
    mesh.close()
    # weak scaling: every rank ran one rank's share of each batch
    if seen != {"env": s["env_batch_per_device"], "mcts": s["batch_per_device"]}:
        raise RuntimeError(f"rank {rank} ran {seen} lanes, want a rank's share")
    return {"env": env_rate, "sims": sims_rate, "train": train_rate}


def main(argv=None):
    p = parser()
    args = p.parse_args(argv)
    dev = bench_torch.device_arg(p, args.device)
    if args.virtual and dev.type != "cpu":
        p.error("--virtual N runs N gloo ranks on the CPU: pass --device cpu")
    on_card = dev.type == "cuda"
    n_dev = torch.cuda.device_count() if on_card else max(args.virtual, 1)
    sizes = dict(SIZES[dev.type])
    for k in ("batch_per_device", "env_batch_per_device", "sims", "moves"):
        sizes[k] = getattr(args, k) or sizes[k]

    want = [int(s) for s in args.sizes.split(",") if s]
    want = [n for n in want if n <= n_dev]
    if not want:
        print(json.dumps({"error": "no mesh size fits device count", "devices": n_dev}))
        return 1
    kind = device_label(dev)

    rows = []
    for n in want:
        r = D.spawn(_rank, n, (n, args.device, sizes, args.reps), device=args.device,
                    timeout=SPAWN_TIMEOUT_S,
                    threads=0 if on_card else 1)[0]
        row = {
            "devices": n,
            "platform": dev.type,
            "device_kind": kind,
            "virtual": bool(args.virtual),
            "batch": n * sizes["batch_per_device"],
            "sims_per_s": round(r["sims"], 1),
            "sims_per_s_per_device": round(r["sims"] / n, 1),
            "env_steps_per_s": round(r["env"], 1),
            "env_steps_per_s_per_device": round(r["env"] / n, 1),
            "train_rows_per_s": round(r["train"], 1),
            "train_rows_per_s_per_device": round(r["train"] / n, 1),
        }
        rows.append(row)
        print(json.dumps(row), flush=True)

    base = rows[0]
    scale = base["devices"]

    def eff(key):
        return [round(r[key] * scale / (base[key] * r["devices"]), 3) for r in rows]

    summary = {
        "metric": "weak_scaling_efficiency",
        "sizes": [r["devices"] for r in rows],
        "sims_efficiency": eff("sims_per_s"),
        "env_efficiency": eff("env_steps_per_s"),
        "train_efficiency": eff("train_rows_per_s"),
    }
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            for r in rows + [summary]:
                f.write(json.dumps(r) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
