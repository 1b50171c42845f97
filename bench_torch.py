"""Benchmark of the PyTorch/CUDA port: batched env throughput and the MCTS
move's simulation throughput, the counterpart of `bench.py` (which measures
the JAX package).

    python3 bench_torch.py                 # on the card
    python3 bench_torch.py --device cpu    # the kernels' plain versions, CPU sizes

Prints ONE JSON line:
  {"metric": "mcts_sims_per_s", "value": N, "unit": "sims/s/chip",
   "sims_per_s_reps": [...], "sims_per_s_mean": N, "sims_per_s_spread": N,
   "env_steps_per_s": N, "device": "<name>, <power limit>",
   "insert_kernel": ..., "table_size": ..., "nn_dtype": ...}

The workloads are bench.py's:

- env (`bench_env`): B=8192 games, 512 steps of uniform random actions in
  [0, 7) through the port's packed step, every game that ended soft-reset
  in the same step; one warm-up run, then the best of 3. Each run replays
  the same draws: a torch.Generator seeded from `seed` at the start of every
  run, as bench.py restarts its key.
- mcts (`bench_mcts`): the lp move (the VV net on the leaf's 7 children;
  the select, insert and LP backup kernels) at B=256, 100 sims, pools
  2048/2048, table TMT_TABLE_SIZE (default 4096), depth 64, the insert
  kernel unless TMT_INSERT_KERNEL=0, a bfloat16 body unless TMT_NN_F32=1,
  the store on (min_visits_store 25, a ring of 100000); a run is 8 moves,
  one run warms up, then 3 are timed. The value is the best run's rate, and
  every run's is listed. bench.py scans the moves in one program; here they
  are a host loop, and since an lp move reads nothing back to the host, a
  run synchronises once, at its end.

Left out of bench.py's line, and why: `vs_baseline` and `env_vs_target`
divide by BASELINE.md's targets, which were set for a TPU; the CPU fallback
(`_device`, `tpu_fallback`, `last_tpu`, runs/bench_tpu_last.json) would
hide which device ran or carry a TPU's number, so without a card and
without `--device cpu` this exits with an error; `parity_sims_per_s` and
`endless_sims_per_s` read the JAX campaigns' metric streams under runs/.

`--device cpu` runs bench.py's CPU sizes (env 512 x 64 steps, 2 reps; mcts
B=16, 16 sims, 2 moves, 2 reps) on the kernels' plain versions. Both
benches also take a `parallel/mesh.Mesh` (`scripts/scaling_bench_torch.py`):
each rank then runs its rows of the global batch, with its rows of the
global draws. This module imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch
import torch.distributed as dist

from tetris_mcts_tpu_torch.env import engine
from tetris_mcts_tpu_torch.obs.card import device_label
from tetris_mcts_tpu_torch.ops import env_packed as EP
from tetris_mcts_tpu_torch.parallel import mesh as M
from tetris_mcts_tpu_torch.search import mcts
from tetris_mcts_tpu_torch.search.tree import TreeConfig
from tetris_mcts_tpu_torch.train.trainer import VVModel

# bench.py's A/B knobs, read once so the printed line describes the run
INSERT_KERNEL = os.environ.get("TMT_INSERT_KERNEL", "1") == "1"
TABLE_SIZE = int(os.environ.get("TMT_TABLE_SIZE", "4096"))
POOL = 2048            # max_nodes = max_obs
DEPTH = 64
RING = 100_000
MIN_VISITS_STORE = 25
# keys of bench.py's line that this one leaves out (see the docstring)
LEFT_OUT = ("vs_baseline", "env_vs_target", "tpu_fallback", "last_tpu",
            "parity_sims_per_s", "endless_sims_per_s")
SIZES = {  # bench.py's sizes on its chip and on the CPU
    "cuda": {"env": dict(batch=8192, steps=512, reps=3),
             "mcts": dict(batch=256, sims=100, moves=8, reps=3)},
    "cpu": {"env": dict(batch=512, steps=64, reps=2),
            "mcts": dict(batch=16, sims=16, moves=2, reps=2)},
}


def nn_dtype_name() -> str:
    return "float32" if os.environ.get("TMT_NN_F32") == "1" else "bfloat16"


def device_arg(parser: argparse.ArgumentParser, name: str) -> torch.device:
    """The `--device` of an entry point: a CUDA device must exist (the
    parser exits with an error otherwise; nothing falls back to the CPU)."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        parser.error(f"--device {name}: no CUDA device is available (pass --device cpu "
                     "for the kernels' plain versions on the CPU)")
    if dev.type not in ("cuda", "cpu"):
        parser.error(f"--device {name}: want cuda or cpu")
    return dev


def sync(dev: torch.device, mesh: M.Mesh | None = None):
    """Wait for the device's queued work (and, on several ranks, for every
    rank)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    if mesh is not None and mesh.world > 1:
        dist.barrier()


def _rows(mesh: M.Mesh | None, x):
    """This rank's rows of a global batch (all of them without a mesh)."""
    return x if mesh is None else M.shard_batch(mesh, x)


def timed_runs(run, reps: int, dev: torch.device, mesh: M.Mesh | None = None):
    """One warm-up call of run(), then the seconds of each of `reps` calls,
    each ended by a synchronisation."""
    run()
    sync(dev, mesh)
    secs = []
    for _ in range(reps):
        t0 = time.perf_counter()
        run()
        sync(dev, mesh)
        secs.append(time.perf_counter() - t0)
    return secs


def bench_env(batch: int = 8192, steps: int = 512, reps: int = 3, seed: int = 0,
              device="cuda", actions=None, mesh: M.Mesh | None = None):
    """Random-action env stepping with auto-reset. `actions(step)` gives the
    (batch,) actions of a run's step `step` (default: uniform in [0, 7) from
    a generator seeded from `seed` at the start of each run). Returns (env
    steps/s of the best timed run, the final packed envs (B, 44): this
    rank's rows under a mesh, where batch is the global batch)."""
    dev = torch.device(device)
    cfg = engine.EnvConfig()
    kw = dict(actions_per_drop=cfg.actions_per_drop, scoring=cfg.scoring,
              randomizer=cfg.randomizer)
    state = {"envs": _rows(mesh, engine.pack_state(engine.reset_batch(seed, batch, cfg, dev)))}
    gen = torch.Generator(device=dev)
    if actions is None:
        def actions(step):
            return torch.randint(0, 7, (batch,), generator=gen, device=dev)

    def run():
        gen.manual_seed(seed)
        envs = state["envs"]
        for i in range(steps):
            s = EP.packed_step(envs, _rows(mesh, actions(i)), **kw)
            fresh = engine.pack_state(engine.soft_reset(engine.unpack_state(s), cfg))
            envs = torch.where(s[:, 43:44] != 0, fresh, s)
        state["envs"] = envs

    secs = timed_runs(run, reps, dev, mesh)
    return batch * steps / min(secs), state["envs"]


def mcts_program(batch: int, sims: int, moves: int, seed: int = 0, device="cuda",
                 planes=None, model=None, on_move=None, mesh: M.Mesh | None = None):
    """bench.py's move program: `run()` plays `moves` lp moves on B games
    (this rank's rows of them under a mesh), the trees and the ring updated
    in place, and returns the last move's `MoveStats`. The table size, the
    insert kernel and the body's type are TABLE_SIZE, INSERT_KERNEL and
    `nn_dtype_name()` (TMT_NN_F32, read at each call). `planes` replaces
    the randomness source (default a `search/mcts.TorchPlanes` reseeded
    from `seed` at the start of each run, as bench.py restarts its key),
    `model` the VV model (default `VVModel(seed)`); `on_move(envs, stats,
    replay)` is called after every move."""
    dev = torch.device(device)
    f32 = nn_dtype_name() == "float32"
    cfg = mcts.SearchConfig(
        tree=TreeConfig(max_nodes=POOL, max_obs=POOL, table_size=TABLE_SIZE,
                        max_depth=DEPTH, insert_kernel=INSERT_KERNEL),
        sims=sims, evaluator="lp")
    model = model or VVModel(seed=seed, device=dev)
    own = planes is None
    planes = planes or mcts.TorchPlanes(seed, dev)
    move_planes = planes if mesh is None else M.ShardedPlanes(planes, mesh)
    move = mcts.make_move_fn(
        mcts.nn_child_evaluator(model.apply_fn(None if f32 else torch.bfloat16)), cfg,
        move_planes, min_visits_store=MIN_VISITS_STORE, store=True)
    trees, envs = mcts.init_batch(seed, batch, cfg, dev)
    if mesh is not None:
        trees, envs = M.shard_batch(mesh, (trees, envs))
        move = M.sharded_move_fn(move, mesh)
    replay = mcts.init_replay(RING, dev)
    state = {"envs": envs}

    def run():
        if own:
            planes.gen.manual_seed(seed)
        envs = state["envs"]
        for _ in range(moves):
            envs, stats = move(trees, envs, replay)
            if on_move is not None:
                on_move(envs, stats, replay)
        state["envs"] = envs
        return stats

    return run


def bench_mcts(batch: int = 256, sims: int = 100, moves: int = 8, reps: int = 3,
               seed: int = 0, device="cuda", planes=None, model=None, on_move=None,
               mesh: M.Mesh | None = None):
    """Full NN-evaluated MCTS moves (select, expand, net, backup, the env
    step, the harvest and the store) of `mcts_program`. Returns (the best
    run's sims/s, every timed run's sims/s); under a mesh batch is the
    global batch."""
    dev = torch.device(device)
    run = mcts_program(batch, sims, moves, seed, dev, planes=planes, model=model,
                       on_move=on_move, mesh=mesh)
    rates = [batch * sims * moves / s for s in timed_runs(run, reps, dev, mesh)]
    return max(rates), rates


def bench_line(env_rate: float, sims_rate: float, sims_reps, dev: torch.device) -> dict:
    """The one line of `main`: bench.py's keys but those of LEFT_OUT."""
    return {
        "metric": "mcts_sims_per_s",
        "value": round(sims_rate, 1),
        "unit": "sims/s/chip",
        "sims_per_s_reps": [round(r, 1) for r in sims_reps],
        "sims_per_s_mean": round(sum(sims_reps) / len(sims_reps), 1),
        "sims_per_s_spread": round(max(sims_reps) - min(sims_reps), 1),
        "env_steps_per_s": round(env_rate, 1),
        "device": device_label(dev),
        "insert_kernel": INSERT_KERNEL,
        "table_size": TABLE_SIZE,
        "nn_dtype": nn_dtype_name(),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 bench_torch.py", description=__doc__.split(
        "\n\n")[0], formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default="cuda",
                   help="cuda (default: the card, its kernels) or cpu (the plain versions "
                        "at bench.py's CPU sizes)")
    args = p.parse_args(argv)
    dev = device_arg(p, args.device)
    sizes = SIZES[dev.type]
    env_rate, _ = bench_env(device=dev, **sizes["env"])
    sims_rate, sims_reps = bench_mcts(device=dev, **sizes["mcts"])
    print(json.dumps(bench_line(env_rate, sims_rate, sims_reps, dev)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
