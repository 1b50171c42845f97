"""The multi-rank dry run (counterpart of the reference package's
`__graft_entry__.dryrun_multichip`): n ranks play sharded lp moves on tiny
pools until the replicated ring holds 2n rows, train the VV net on them for
two steps with the learner (data x model 2 when n is even), play one more
move with the updated params, and take one `sharded_train_step`.

    python -m tetris_mcts_tpu_torch.parallel.dryrun 2 --device cpu
    python -m tetris_mcts_tpu_torch.parallel.dryrun 2 --backend gloo   # 2 ranks, one card

A rank's kernels run on its own device (`ops/build.launch`). NCCL refuses
two ranks on one card: with fewer cards than ranks the caller names gloo.
"""

from __future__ import annotations

import argparse
import math
import sys

import torch

from tetris_mcts_tpu_torch.env import engine
from tetris_mcts_tpu_torch.parallel import mesh as M
from tetris_mcts_tpu_torch.runtime import distributed as D
from tetris_mcts_tpu_torch.search import mcts
from tetris_mcts_tpu_torch.search.tree import TreeConfig
from tetris_mcts_tpu_torch.train.trainer import VVModel


def _rank(rank, n, device):
    dev = D.rank_device(device)
    cfg = mcts.SearchConfig(tree=TreeConfig(max_nodes=128, max_obs=128, table_size=256,
                                            max_depth=8), sims=2, evaluator="lp")
    model = VVModel(seed=0, device=dev)
    mesh = M.make_mesh()
    planes = M.ShardedPlanes(mcts.TorchPlanes(0, dev, "clt"), mesh)
    move = M.sharded_move_fn(mcts.make_move_fn(mcts.nn_child_evaluator(model.apply_fn()), cfg,
                                               planes, min_visits_store=1, store=True), mesh)
    trees, envs = M.shard_batch(mesh, mcts.init_batch(0, 2 * n, cfg, dev))
    replay = mcts.init_replay(128, dev)

    # actors: sharded moves, harvesting into the replicated ring
    moves = 0
    while moves < 40:
        envs, stats = move(trees, envs, replay)
        moves += 1
        if stats.action.shape != (2,):
            raise AssertionError(f"rank {rank}: a move of {stats.action.shape[0]} lanes")
        if int(replay.total) >= 2 * n:
            break
    rows = 2 * n
    if int(replay.total) < rows:
        raise AssertionError("the dry run harvested no training rows")

    # learner: two steps on the harvested rows, data x model 2 when n is even
    mp = 2 if n % 2 == 0 else 1
    lmesh = M.make_mesh(model_parallel=mp)
    state, step = M.make_sharded_learner(model, lmesh)
    data = (engine.unpack_obs(replay.boards[:rows])[:, None].float(), replay.value[:rows],
            torch.clamp_min(replay.var[:rows], 1e-1), torch.clamp_min(replay.weight[:rows], 1.0))
    gen = torch.Generator(device=dev).manual_seed(1)  # the same indices on every rank
    losses = []
    for _ in range(2):
        idx = torch.randint(0, rows, (rows,), generator=gen, device=dev)
        state, metrics, _ = step(state, model.ubound, data, idx, 0.0)
        losses.append(float(metrics["loss"]))
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite learner loss {losses}")

    # the actors read the updated params
    model.net.load_state_dict(M.gather_params(lmesh, state))
    envs, stats = move(trees, envs, replay)
    moves += 1

    # the whole-state step
    idx = torch.randint(0, rows, (rows,), generator=gen, device=dev)
    params = dict(model.net.named_parameters())
    _, _, metrics, _ = M.sharded_train_step(model, lmesh)(
        params, model.opt.state(), model.ubound, data, idx, model.fisher, model.p0)
    losses.append(float(metrics["loss"]))
    lmesh.close()
    mesh.close()
    return {"rank": rank, "moves": moves, "ring_total": int(replay.total),
            "model_parallel": mp, "losses": losses,
            "params": {k: v.detach().cpu() for k, v in model.net.state_dict().items()}}


def dryrun_multigpu(n: int, device="cuda", backend: str | None = None, timeout: float = 600.0,
                    workdir: str | None = None):
    """Spawn n ranks on `device` and run the dry run; returns the ranks'
    results (moves, ring total, the learner's losses, the params the last
    move played with). The params must be equal on every rank."""
    if (torch.device(device).type == "cuda" and backend is None
            and torch.cuda.device_count() < n):
        raise ValueError(f"{n} ranks on {torch.cuda.device_count()} card(s): NCCL refuses two "
                         "ranks on one GPU; name backend='gloo'")
    outs = D.spawn(_rank, n, (n, device), device=device, backend=backend, timeout=timeout,
                   workdir=workdir, threads=1 if torch.device(device).type == "cpu" else 0)
    for o in outs[1:]:
        for k, v in o["params"].items():
            if not torch.equal(v, outs[0]["params"][k]):
                raise AssertionError(f"rank {o['rank']}'s {k} differs from rank 0's")
    return outs


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m tetris_mcts_tpu_torch.parallel.dryrun")
    p.add_argument("n", type=int, nargs="?", default=2)
    p.add_argument("--device", default="cuda")
    p.add_argument("--backend", default=None)
    args = p.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        p.error(f"--device {args.device}: no CUDA device is available (pass --device cpu)")
    for o in dryrun_multigpu(args.n, args.device, args.backend):
        print(f"rank {o['rank']}: {o['moves']} moves, ring total {o['ring_total']}, learner "
              f"(model {o['model_parallel']}) losses {', '.join(f'{x:.4f}' for x in o['losses'])}")
    print("dryrun_multigpu ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
