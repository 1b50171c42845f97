"""The port's multi-rank runtime (`runtime/distributed.py`) and dry run
(`parallel/dryrun.py`) on the CPU, ranks as gloo processes
(`runtime/distributed.spawn`, tests/torch_ranks.py).

- `init_distributed` joins nothing at world size 1; `local_batch` and
  `host_seed` (seed + 7919 x rank).
- `DistributedSelfPlay` on 2 ranks, global B=8, 3 lp moves on a VV net
  carried from the JAX package (`params_from_jax`), against the JAX move
  program run in one process on the concatenation of `init_batch(seed +
  7919 r, 4)` for r = 0, 1, which is what the reference's two-controller
  run computes (tests/test_multiprocess.py), fed the same key schedule:
  each rank's trees and envs are the JAX lanes [4r, 4r + 4) in every
  integer, the statistics within the VV net's bounds of
  tests/test_torch_search.py (rtol 1e-4 / atol 1e-3); the ring the JAX
  ring on both ranks, bit-equal across ranks; the bookkeeping (moves,
  episodes, the log) the same on both. Then an online run whose sessions
  fire leaves the params bit-equal across ranks.
- In one process (no group), `DistributedSelfPlay` is `SelfPlayDriver`
  bit for bit, and it refuses the single-process channels (the playout
  evaluators on ranks: tests/test_torch_sharded_playouts.py).
- `dryrun_multigpu(2)` and `dryrun_multigpu(4)` on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tetris_mcts_tpu.env import engine as JE
from tetris_mcts_tpu.search import mcts as JM
from tetris_mcts_tpu.search import tree as JT
from tetris_mcts_tpu.train.trainer import VVModel as JVVModel
from tetris_mcts_tpu_torch.parallel.dryrun import dryrun_multigpu
from tetris_mcts_tpu_torch.runtime import distributed as D
from tetris_mcts_tpu_torch.runtime.selfplay import SelfPlayConfig, SelfPlayDriver
from tetris_mcts_tpu_torch.train.trainer import opt_state_from_jax, params_from_jax
from torch_parity import JaxXlaWalkKeyPlanes, as_i32, assert_tree_equal
from torch_ranks import selfplay

torch.set_num_threads(1)

B, SIMS, MOVES, SEED = 8, 3, 3, 5
POOLS = dict(max_nodes=64, max_obs=64, table_size=128, max_depth=8)
NET_TOL = dict(rtol=1e-4, atol=1e-3)
CFG = SelfPlayConfig(batch=B, sims=SIMS, min_visits_store=1, memory_size=256,
                     train_rows_trigger=10**9, seed=SEED, **POOLS)
ONLINE = SelfPlayConfig(batch=B, sims=SIMS, min_visits_store=1, memory_size=512,
                        memory_growth=64, train_rows_trigger=32, train_batch=16,
                        train_iters_per_val=5, train_max_iters=10, seed=9, **POOLS)


def test_init_distributed_is_a_noop_at_world_size_1(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert D.init_distributed(device="cpu") == 0
    assert not torch.distributed.is_initialized()
    assert D.init_distributed(world_size=1, device="cpu") == 0


def test_local_batch_and_host_seed():
    assert D.local_batch(64) == 64  # one process
    assert D.local_batch(64, 2) == 32
    with pytest.raises(ValueError):
        D.local_batch(6, 4)
    assert D.host_seed(5) == 5
    assert [D.host_seed(5, r) for r in range(3)] == [5, 5 + 7919, 5 + 2 * 7919]


def test_one_rank_is_the_driver_bit_for_bit():
    cfg = CFG._replace(batch=4)
    sp = D.DistributedSelfPlay(cfg, device="cpu", log=lambda s: None)
    one = SelfPlayDriver(cfg, device="cpu", log=lambda s: None)
    sp.run(3)
    one.run(3)
    for f in ("obs_bits", "visits", "values", "vars_", "cbase", "tbl_obs"):
        assert torch.equal(getattr(sp.driver.trees, f), getattr(one.trees, f)), f
    assert torch.equal(sp.driver.envs, one.envs)
    for a, b in zip(sp.driver.replay.rows(), one.replay.rows()):
        assert torch.equal(a, b)
    sp.close()


@pytest.mark.parametrize("kw,match", [
    (dict(cfg=CFG, saver=object()), "single-process channel"),
    (dict(cfg=CFG, status=object()), "single-process channel"),
])
def test_refuses_unsharded_evaluators_and_channels(kw, match):
    with pytest.raises(ValueError, match=match):
        D.DistributedSelfPlay(device="cpu", **kw)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    jm = JVVModel(seed=3)
    jcfg = JM.SearchConfig(tree=JT.TreeConfig(**POOLS), sims=SIMS, evaluator="lp")
    move = jax.jit(JM.make_move_fn(JM.nn_child_evaluator(jm.apply_fn()), jcfg,
                                   min_visits_store=1))
    halves = [JM.init_batch(SEED + 7919 * r, B // 2, jcfg) for r in (0, 1)]
    trees, envs = jax.tree.map(lambda a, b: jnp.concatenate([a, b]), *halves)
    ring = JM.init_replay(CFG.memory_size)
    planes, draws = JaxXlaWalkKeyPlanes(SEED), []
    for _ in range(MOVES):
        sub = planes.next_move()
        draws += [planes(B, POOLS["max_depth"]) for _ in range(SIMS)]
        trees, envs, ring, st = move(jm.params, jm.ubound, trees, envs, ring, sub)
    state = (*params_from_jax(jax.tree.map(np.asarray, jm.params), jm.ubound, jm.lbound),
             opt_state_from_jax(jax.tree.map(np.asarray, jm.opt_state)))
    outs = D.spawn(selfplay, 2, (CFG, state, draws, MOVES, ONLINE, 4), device="cpu",
                   timeout=300, workdir=str(tmp_path_factory.mktemp("ranks")))
    return outs, (trees, envs, ring, st)


def test_distributed_selfplay_matches_the_jax_two_controller_run(two_ranks):
    outs, (jtrees, jenvs, jring, jst) = two_ranks
    for r, o in enumerate(outs):
        rows = jax.tree.map(lambda x: x[4 * r:4 * r + 4], (jtrees, jenvs, jst.action))
        np.testing.assert_array_equal(o["actions"].numpy(), np.asarray(rows[2]))
        np.testing.assert_array_equal(o["envs"].numpy(), as_i32(JE.pack_state(rows[1])))
        assert_tree_equal(o["trees"], rows[0], stats_tol=NET_TOL, msg=f"rank {r}")
        n = int(jring.count)
        assert o["ring"].total.item() == int(jring.total) and n > 0
        np.testing.assert_array_equal(o["ring"].boards[:n].numpy(), as_i32(jring.boards[:n]))
        np.testing.assert_array_equal(o["ring"].weight[:n].numpy(), np.asarray(jring.weight[:n]))
        for c in ("value", "var"):
            np.testing.assert_allclose(getattr(o["ring"], c)[:n].numpy(),
                                       np.asarray(getattr(jring, c)[:n]), **NET_TOL)


def test_distributed_selfplay_ranks_agree(two_ranks):
    a, b = two_ranks[0]
    assert (a["moves"], a["episodes"], a["lines"], a["log"]) == \
        (b["moves"], b["episodes"], b["lines"], b["log"])
    assert a["moves"] == MOVES
    for x, y in zip(a["ring"].rows(), b["ring"].rows()):
        assert torch.equal(x, y)
    # the online run trained, and its sessions left the nets bit-equal
    assert a["online"]["sessions"] >= 1
    assert a["online"]["sessions"] == b["online"]["sessions"]
    assert torch.equal(a["online"]["ubound"], b["online"]["ubound"])
    for k, v in a["online"]["params"].items():
        assert torch.equal(v, b["online"]["params"][k]), k


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multigpu_on_the_cpu(n, tmp_path):
    outs = dryrun_multigpu(n, device="cpu", timeout=300, workdir=str(tmp_path))
    assert [o["rank"] for o in outs] == list(range(n))
    assert all(o["ring_total"] >= 2 * n and o["model_parallel"] == 2 for o in outs)
    assert all(o["losses"] == outs[0]["losses"] for o in outs)
    assert all(np.isfinite(o["losses"]).all() for o in outs)
