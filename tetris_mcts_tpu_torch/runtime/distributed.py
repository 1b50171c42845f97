"""Several ranks: the process group, the global mesh, per-rank seeds, the
multi-rank self-play driver and a launcher (counterpart of the reference
package's `runtime/distributed.py`).

- `init_distributed()` joins `torch.distributed`'s default group: from its
  arguments, or from torchrun's `RANK`, `WORLD_SIZE`, `MASTER_ADDR` and
  `MASTER_PORT`; one process without them needs no group. The backend is
  NCCL on a card and gloo on the CPU; another is taken only when named.
  NCCL refuses two ranks on one GPU, so several ranks on one card name
  gloo.
- `global_mesh()` is `parallel/mesh.make_mesh` over every rank.
- `host_seed(seed)` is a rank's own seed of its games, seed + 7919 x rank,
  the reference's per-host fold in the port's seeds.
- `DistributedSelfPlay` runs the self-play driver of `runtime/selfplay.py`
  with each rank stepping its own B / W games (`parallel/mesh.
  sharded_move_fn`), the replay ring and the net replicated, and every rank
  running the same episode bookkeeping on the gathered per-lane reads.
- `spawn(fn, world, ...)` starts `world` ranks in fresh processes (the
  `spawn` start method, which CUDA needs), each joined to a group through a
  file under a temporary directory, runs `fn(rank, *args)` on each and
  returns their results; a rank that fails or outlasts the timeout fails
  the call.

    python -m tetris_mcts_tpu_torch.runtime.distributed --nproc 2 --device cpu \\
        --batch 8 --mcts_sims 3 --max_nodes 128 --max_obs 128 --max_depth 8 --moves 3

runs `DistributedSelfPlay` on 2 ranks (under torchrun, without --nproc, on
torchrun's ranks).
"""

from __future__ import annotations

import argparse
import datetime
import multiprocessing.connection
import os
import sys
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from tetris_mcts_tpu_torch.parallel import mesh as M
from tetris_mcts_tpu_torch.search import distributional as DD
from tetris_mcts_tpu_torch.search import mcts
from tetris_mcts_tpu_torch.search import stochastic as ST
from tetris_mcts_tpu_torch.search import vp as VP

HOST_SEED_STRIDE = 7919
COLLECTIVE_TIMEOUT_S = 300


def rank_device(device, rank: int | None = None) -> torch.device:
    """A rank's device: "cpu" stays, a bare "cuda" becomes cuda:(rank mod
    the cards), so ranks spread over the cards and share them past that."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    if rank is None:
        rank = dist.get_rank() if dist.is_initialized() else 0
    return torch.device("cuda", rank % torch.cuda.device_count())


def init_distributed(init_method: str | None = None, world_size: int | None = None,
                     rank: int | None = None, backend: str | None = None,
                     device="cuda") -> int:
    """Join the default process group; returns this rank. Arguments win,
    then torchrun's environment; one process with neither is rank 0 without
    a group. On a card the rank's device becomes the current one."""
    env = os.environ
    if world_size is None and "WORLD_SIZE" in env:
        world_size = int(env["WORLD_SIZE"])
    if rank is None and "RANK" in env:
        rank = int(env["RANK"])
    if init_method is None and "MASTER_ADDR" in env and "MASTER_PORT" in env:
        init_method = "env://"
    if init_method is None and world_size in (None, 1):
        return 0  # one process: nothing to join
    if dist.is_initialized():
        return dist.get_rank()
    dev = rank_device(device, rank or 0)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend or ("nccl" if dev.type == "cuda" else "gloo"),
                            init_method=init_method, world_size=world_size or 1,
                            rank=rank or 0,
                            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    return dist.get_rank()


def global_mesh(model_parallel: int = 1) -> M.Mesh:
    """The mesh over every rank of the process group."""
    return M.make_mesh(model_parallel=model_parallel)


def world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def host_seed(seed: int, rank: int | None = None) -> int:
    """The seed of a rank's own games (default: this rank's)."""
    if rank is None:
        rank = dist.get_rank() if dist.is_initialized() else 0
    return seed + HOST_SEED_STRIDE * rank


def local_batch(global_batch: int, n: int | None = None) -> int:
    """Games a rank owns under even sharding over n ranks (default every
    rank of the group)."""
    n = n or world()
    if global_batch % n:
        raise ValueError(f"a global batch of {global_batch} does not split over {n} ranks")
    return global_batch // n


def _drivers():
    from tetris_mcts_tpu_torch.runtime import selfplay as SP

    # evaluator -> (driver, the attribute holding its trees, their init)
    return {"vp": (SP.VPSelfPlayDriver, "vtrees", VP.init_vp_batch),
            "dist": (SP.DistSelfPlayDriver, "dtrees", None),
            "s2": (SP.S2SelfPlayDriver, "s2trees", ST.init_s2_batch),
            **{ev: (SP.SelfPlayDriver, "trees", mcts.init_batch) for ev in mcts.EVALUATORS}}


class DistributedSelfPlay:
    """The self-play driver over the global mesh: each rank builds its own
    B / W games from `host_seed` (W the data axis's length) and steps them
    with the sharded move; the replay ring and the net are replicated, and
    every rank keeps the same bookkeeping (moves, episodes, logs, training
    gates) on the gathered reads. `planes` is the global randomness source
    (default a `search/mcts.TorchPlanes` seeded from cfg.seed, the same on
    every rank), of which each rank draws its rows. The rollout and the
    policy playouts stop their loop when every rank's lanes have ended
    (`parallel/mesh.Mesh.all_ended`), so each rank makes one process's draws.
    A session runs on every rank on the same rows and ends with every rank's
    model set to rank 0's (cuDNN's backward may differ between ranks), so
    the nets stay bit-equal.

    Every evaluator is sharded. `saver` and `status` are refused:
    single-process channels (every rank would write the same rows to the
    same file)."""

    def __init__(self, cfg, model=None, model_parallel: int = 1, device="cuda", planes=None,
                 **driver_kw):
        for name in ("saver", "status"):
            if driver_kw.get(name) is not None:
                raise ValueError(f"{name} is a single-process channel: every rank would "
                                 "write the same rows to the same file")
        drivers = _drivers()
        if cfg.evaluator not in drivers:
            raise ValueError(f"unknown evaluator {cfg.evaluator!r} (known: {', '.join(drivers)})")
        cls, attr, init = drivers[cfg.evaluator]
        self.device = rank_device(device)
        self.mesh = global_mesh(model_parallel)
        if cfg.evaluator != "s2":
            driver_kw["planes"] = M.ShardedPlanes(
                planes or mcts.TorchPlanes(cfg.seed, self.device, cfg.policy), self.mesh)
        if cfg.evaluator in mcts.EVALUATORS:
            driver_kw["all_ended"] = self.mesh.all_ended
        self.driver = cls(cfg, model=model, device=self.device, **driver_kw)
        d = self.driver
        local = local_batch(cfg.batch, self.mesh.data_size)
        seed = host_seed(cfg.seed, self.mesh.data_index)
        if init is None:
            trees, envs = DD.init_dist_batch(seed, local, d.search_cfg, d.dcfg, self.device)
        else:
            trees, envs = init(seed, local, d.search_cfg, self.device)
        setattr(d, attr, M.shard_batch_from_local(self.mesh, trees, cfg.batch))
        d.envs = M.shard_batch_from_local(self.mesh, envs, cfg.batch)
        M.replicate(self.mesh, d.replay)
        M.replicate_model(self.mesh, d.model)
        d.mesh = self.mesh
        d._move = M.sharded_move_fn(d._move, self.mesh)

    def close(self):
        """Destroy the mesh's groups."""
        self.mesh.close()

    def step(self):
        return self.driver.step()

    def run(self, n_moves: int):
        self.driver.run(n_moves)

    def run_episodes(self, n: int, **kw):
        self.driver.run_episodes(n, **kw)


# ---------------------------------------------------------------------------
# launcher
# ---------------------------------------------------------------------------

def _rank_main(rank, fn, world_size, args, init_method, backend, device, out_dir, threads):
    if threads:
        torch.set_num_threads(threads)
    init_distributed(init_method, world_size, rank, backend, device)
    try:
        result = fn(rank, *args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(fn, world_size: int, args=(), device="cpu", backend: str | None = None,
          timeout: float = 600.0, workdir: str | None = None, threads: int = 1):
    """Run fn(rank, *args) on `world_size` fresh processes joined in one
    group (`init_distributed` with a file under `workdir`, a temporary
    directory by default); returns the ranks' results in rank order (each
    a `torch.save`-able value). `fn` must be importable by name. A rank
    that exits with an error, or a call past `timeout` seconds, ends every
    rank and raises. `threads` sets each rank's torch CPU threads."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(dir=workdir) as d:
        init = "file://" + os.path.join(d, "group")
        procs = [ctx.Process(target=_rank_main, daemon=False,
                             args=(r, fn, world_size, tuple(args), init, backend, device, d,
                                   threads))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        failed = None
        try:
            while any(p.is_alive() for p in procs):
                left = deadline - time.monotonic()
                if left <= 0:
                    failed = f"ranks still running after {timeout:.0f}s"
                    break
                multiprocessing.connection.wait([p.sentinel for p in procs if p.is_alive()],
                                                timeout=min(left, 1.0))
                bad = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
                if bad:
                    failed = f"rank(s) {bad} failed (exit codes {[procs[r].exitcode for r in bad]})"
                    break
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                p.join()
        bad = [r for r, p in enumerate(procs) if p.exitcode != 0]
        if failed or bad:
            raise RuntimeError(failed or f"rank(s) {bad} failed")
        return [torch.load(os.path.join(d, f"rank{r}.pt"), weights_only=False)
                for r in range(world_size)]


def _selfplay_rank(rank, cfg, device, moves):
    lines = []
    sp = DistributedSelfPlay(cfg, device=device, log=lines.append)
    sp.run(moves)
    d = sp.driver
    out = {"rank": rank, "moves": d.moves, "episodes": d.episodes,
           "ring_total": int(d.replay.total), "log": lines}
    sp.close()
    return out


def main(argv=None):
    from tetris_mcts_tpu_torch.runtime.selfplay import SelfPlayConfig

    p = argparse.ArgumentParser(prog="python -m tetris_mcts_tpu_torch.runtime.distributed",
                                description="frozen ValueSimLP self-play "
                                "(DistributedSelfPlay) on several ranks")
    p.add_argument("--nproc", type=int, default=0,
                   help="ranks to spawn here (0: this process is a torchrun rank)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--backend", default=None, help="nccl on a card, gloo on the CPU")
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--mcts_sims", type=int, default=100)
    p.add_argument("--max_nodes", type=int, default=4096)
    p.add_argument("--max_obs", type=int, default=4096)
    p.add_argument("--max_depth", type=int, default=96)
    p.add_argument("--moves", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        p.error(f"--device {args.device}: no CUDA device is available "
                "(pass --device cpu for the plain versions on gloo)")
    cfg = SelfPlayConfig(batch=args.batch, sims=args.mcts_sims,
                         max_nodes=args.max_nodes, max_obs=args.max_obs,
                         table_size=2 * max(args.max_nodes, args.max_obs),
                         max_depth=args.max_depth, benchmark=True, seed=args.seed)
    run_args = (cfg, args.device, args.moves)
    if args.nproc:
        outs = spawn(_selfplay_rank, args.nproc, run_args, device=args.device,
                     backend=args.backend, threads=0 if args.device != "cpu" else 1)
    else:
        rank = init_distributed(backend=args.backend, device=args.device)
        outs = [_selfplay_rank(rank, *run_args)]
        if dist.is_initialized():
            dist.destroy_process_group()
    for o in outs:
        if o["rank"] == 0:
            for line in o["log"]:
                print(line, file=sys.stderr)
        print(f"rank {o['rank']}: {o['moves']} moves, {o['episodes']} episodes, "
              f"ring total {o['ring_total']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
