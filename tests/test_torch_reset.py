"""The harvest-and-reset path of the port's move program against the JAX
package's, on the CPU.

A move ends by wiping and re-rooting every tree whose game ended (`done`),
whose pools cannot hold another move (`full`: n_nodes or n_obs + the
capacity guard over the pool), or whose root could not be allocated
(`root == 0`). Here pools of 128 nodes and obs with 6 sims (guard 51 nodes,
about 43 allocated a move) fill within a few moves, and two lanes are set
up before the first move:

- lane GAME_END starts on a stack built from a seeded NumPy board: rows 3-19
  full but for one hole each, so the spawned piece locks on its first
  action (every action drops it one row) and the next one cannot spawn;
- lane POOL_DRY starts with its node pool used up (n_nodes = max_nodes).
  Its root cannot be expanded, so the move's real step has no child node to
  move to and `advance_root` cannot allocate one: the root becomes 0. Under
  the capacity guard a tree never gets there from a fresh start (expansion
  stops 7 nodes short of the pool and `full` resets 51 short), so the slice
  starts it there.

Both programs run the same trees with the linspace stub evaluator and the
same key schedule (tests/torch_parity.py); the JAX program runs its Pallas
kernels interpreted. Every move: actions, env states, the reset lanes,
node counts and the trees' integer arrays equal; statistics within rtol
1e-6 / atol 1e-5.
"""

import jax
import numpy as np
import pytest
import torch

from tetris_mcts_tpu.env import engine as JE
from tetris_mcts_tpu.ops import tree_walk as JW
from tetris_mcts_tpu.search import mcts as JM
from tetris_mcts_tpu.search import tree as JT
from tetris_mcts_tpu_torch.search import mcts as M
from tetris_mcts_tpu_torch.search import tree as T
from torch_parity import (STAT_TOL, JaxKeyPlanes, as_i32, jax_move_program, run_slice,
                          stub_apply, torch_stub)

torch.set_num_threads(1)

B, SIMS, MOVES = 8, 6, 4
JCFG = JT.TreeConfig(max_nodes=128, max_obs=128, table_size=256, max_depth=32)
TCFG = T.TreeConfig(max_nodes=128, max_obs=128, table_size=256, max_depth=32)
GAME_END, POOL_DRY = 1, 2


def near_top_board(seed):
    """uint32 rows: 0-2 empty (the spawned piece's rows are 1-2), 3-19 full
    but for one hole each, at a seeded column."""
    rng = np.random.RandomState(seed)
    rows = (0x3FF & ~(1 << rng.randint(0, 10, 20))).astype(np.uint32)
    rows[:3] = 0
    return rows


def start_state():
    jenvs = JE.reset_batch(11, B, JCFG.env)
    jenvs = jenvs._replace(rows=jenvs.rows.at[GAME_END].set(near_top_board(4)))
    assert not bool(np.asarray(jenvs.end).any())
    jtrees = jax.vmap(JT.init_tree, in_axes=(0, None))(jenvs, JCFG)
    tenvs = torch.as_tensor(as_i32(JE.pack_state(jenvs)))
    ttrees = T.init_tree(tenvs, TCFG)
    jtrees = jtrees._replace(n_nodes=jtrees.n_nodes.at[POOL_DRY].set(JCFG.max_nodes))
    ttrees.n_nodes[POOL_DRY] = TCFG.max_nodes
    return jtrees, jenvs, ttrees, tenvs


def test_harvest_and_reset_matches_jax(monkeypatch):
    monkeypatch.setattr(JW, "use_walk_kernels", lambda: True)
    move_j = jax_move_program(JM.nn_child_evaluator(stub_apply), JCFG, SIMS, "lp")
    planes = JaxKeyPlanes(2)
    move_t = M.make_move_fn(M.nn_child_evaluator(torch_stub),
                            M.SearchConfig(tree=TCFG, sims=SIMS), planes)
    stats = []
    run_slice(move_j, {}, None, move_t, planes, JCFG, TCFG, B, MOVES, STAT_TOL,
              start=start_state(), record=stats)

    guard = M.capacity_guard_for(SIMS, TCFG)
    reset = torch.stack([s.reset for s in stats])
    done = torch.stack([s.done for s in stats])
    full = torch.stack([s.n_nodes for s in stats]) + guard > TCFG.max_nodes
    # game end: the near-top lane ends and is reset on the same move
    assert bool(done[:, GAME_END].any())
    assert bool((reset[done]).all())
    # root == 0: the dry lane's root never expanded (no child visits), its
    # pool stayed at max_nodes, and the move reset it
    first = stats[0]
    assert int(first.n_nodes[POOL_DRY]) == TCFG.max_nodes
    assert float(first.child_stats[POOL_DRY, 0].sum()) == 0.0
    assert bool(first.reset[POOL_DRY])
    # pool full: lanes that started fresh fill their pools and are reset
    fresh_lanes = [b for b in range(B) if b not in (GAME_END, POOL_DRY)]
    assert bool(full[1:, fresh_lanes].any())
    assert bool((reset[full]).all())
    # and a reset lane's tree starts over: one root node after the move
    assert bool((reset == (done | full | (reset & ~done & ~full))).all())
